// LAMB parameter update in two passes over (w, g, m, v).
//
// Replaces paddle_tpu/ops/kernels/lamb_pallas.py `_lamb_call` (:78; kernel
// bodies `_moments_kernel` :37 and `_apply_kernel` :53). Per element, in f32:
//   m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * (g * g)
//   r = (m * inv_bc1) / (sqrt(v * inv_bc2) + eps) + wd * w
// and per tensor trust = ||w|| / ||r|| (1 where either norm is 0), then
//   w = w - (lr * trust) * r.
// The trust ratio needs both whole-tensor norms before any weight moves, so
// no single pass finishes the update:
//   pass A reads w, g, m, v, writes m and v, and each block writes its f32
//     partial sums of w^2 and r^2 (one pair per block);
//   pass B sums the partials (every block the same way, in a fixed order:
//     no atomics, the same bits every run), forms lr * trust on the device
//     and recomputes r from (w, m, v) in registers (cheaper than a round trip
//     of r through memory), writing w - lr * trust * r.
// Every elementwise operation is rounded on its own (the _rn intrinsics keep
// nvcc from contracting a multiply and an add), in the plain PyTorch
// version's order, so m and v match it bit for bit; the norms are summed in
// another order than torch.sum, so trust and w agree to f32 rounding. lr,
// 1/bias_corr1 and 1/bias_corr2 are read from a small f32 device tensor (the
// TPU kernel's (1, 4) operand): a scheduler's new rate or the step count never
// leaves the device. lr is multiplied by a per-parameter factor.
//
// Three parameter forms, as in adamw.cu: an f32 parameter updated in place;
// an f32 master with a bf16 copy written from it; a bf16 parameter read and
// written in place with f32 math (the f32 result write is skipped, the TPU
// kernel's emit_w32=False). g is bf16 or f32.
//
// Bound on the H100: bytes — with a master, 22 bytes an element in pass A
// (w32, m, v read, a bf16 g read, m, v written) and 18 in pass B (w32, m, v
// read, w32 and the bf16 copy written). Design: grid-stride loops of 4
// elements a thread (16-byte f32 vectors, 8-byte bf16 vectors) over at most
// 8 blocks an SM, the ragged tail (n % 4) in block 0.
#include "common.cuh"

using ptt::bf16;
using ptt::to_f;
using ptt::block_sum;
using ptt::load4;
using ptt::store4;

namespace {

enum Mode { kF32Param = 0, kMaster = 1, kBf16Param = 2 };

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd, lr_mult;
};

__device__ __forceinline__ float lamb_r(float w, float m, float v, float ibc1, float ibc2,
                                        const Hyper& hp) {
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, ibc2)), hp.eps);
  return __fadd_rn(__fdiv_rn(__fmul_rn(m, ibc1), den), __fmul_rn(hp.wd, w));
}

// one element of pass A: m, v in place; adds w^2 and r^2 to the sums
__device__ __forceinline__ void moments_one(float w, float g, float& m, float& v, float ibc1,
                                            float ibc2, const Hyper& hp, float& sw, float& sr) {
  m = __fadd_rn(__fmul_rn(hp.b1, m), __fmul_rn(hp.omb1, g));
  v = __fadd_rn(__fmul_rn(hp.b2, v), __fmul_rn(hp.omb2, __fmul_rn(g, g)));
  const float r = lamb_r(w, m, v, ibc1, ibc2, hp);
  sw += w * w;
  sr += r * r;
}

template <typename GT, int MODE>
__global__ void __launch_bounds__(kThreads)
lamb_moments_kernel(const float* __restrict__ w32, const bf16* __restrict__ p,
                    const GT* __restrict__ g, float* __restrict__ m, float* __restrict__ v,
                    const float* __restrict__ scal, long long n, Hyper hp,
                    float* __restrict__ part) {
  __shared__ float scratch[32];
  const float ibc1 = scal[1], ibc2 = scal[2];
  float sw = 0.f, sr = 0.f;
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    const long long o = i * 4;
    float wv[4], gv[4], mv[4], vv[4];
    if (MODE == kBf16Param) load4(p + o, wv); else load4(w32 + o, wv);
    load4(g + o, gv);
    load4(m + o, mv);
    load4(v + o, vv);
#pragma unroll
    for (int j = 0; j < 4; ++j) moments_one(wv[j], gv[j], mv[j], vv[j], ibc1, ibc2, hp, sw, sr);
    store4(m + o, mv);
    store4(v + o, vv);
  }
  if (blockIdx.x == 0) {
    const long long o = n4 * 4 + threadIdx.x;
    if (o < n) {
      const float w = MODE == kBf16Param ? __bfloat162float(p[o]) : w32[o];
      float mv = m[o], vv = v[o];
      moments_one(w, to_f(g[o]), mv, vv, ibc1, ibc2, hp, sw, sr);
      m[o] = mv;
      v[o] = vv;
    }
  }
  sw = block_sum(sw, scratch);
  __syncthreads();  // scratch is read by every thread of the first sum
  sr = block_sum(sr, scratch);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = sw;
    part[gridDim.x + blockIdx.x] = sr;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
lamb_apply_kernel(float* __restrict__ w32, bf16* __restrict__ p, const float* __restrict__ m,
                  const float* __restrict__ v, const float* __restrict__ scal, long long n,
                  Hyper hp, const float* __restrict__ part, float* __restrict__ trust_out) {
  __shared__ float scratch[32];
  // every block sums pass A's partials the same way: the same trust in all
  const int n_part = gridDim.x;
  float sw = 0.f, sr = 0.f;
  for (int i = threadIdx.x; i < n_part; i += blockDim.x) {
    sw += part[i];
    sr += part[n_part + i];
  }
  sw = block_sum(sw, scratch);
  __syncthreads();
  sr = block_sum(sr, scratch);
  const float wn = __fsqrt_rn(sw), rn = __fsqrt_rn(sr);
  const float trust = (wn > 0.f && rn > 0.f) ? __fdiv_rn(wn, rn) : 1.f;
  const float lt = __fmul_rn(__fmul_rn(scal[0], hp.lr_mult), trust);
  if (blockIdx.x == 0 && threadIdx.x == 0) trust_out[0] = trust;
  const float ibc1 = scal[1], ibc2 = scal[2];
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    const long long o = i * 4;
    float wv[4], mv[4], vv[4];
    if (MODE == kBf16Param) load4(p + o, wv); else load4(w32 + o, wv);
    load4(m + o, mv);
    load4(v + o, vv);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wv[j] = __fsub_rn(wv[j], __fmul_rn(lt, lamb_r(wv[j], mv[j], vv[j], ibc1, ibc2, hp)));
    if (MODE != kBf16Param) store4(w32 + o, wv);
    if (MODE != kF32Param) store4(p + o, wv);
  }
  if (blockIdx.x == 0) {
    const long long o = n4 * 4 + threadIdx.x;
    if (o < n) {
      float w = MODE == kBf16Param ? __bfloat162float(p[o]) : w32[o];
      w = __fsub_rn(w, __fmul_rn(lt, lamb_r(w, m[o], v[o], ibc1, ibc2, hp)));
      if (MODE != kBf16Param) w32[o] = w;
      if (MODE != kF32Param) p[o] = __float2bfloat16_rn(w);
    }
  }
}

template <typename GT, int MODE>
int launch(void* w32, void* p, const void* g, void* m, void* v, const void* scal, long long n,
           const Hyper& hp, float* part, float* trust, cudaStream_t s) {
  long long blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const unsigned nb = (unsigned)blocks;
  float* w = static_cast<float*>(w32);
  bf16* pp = static_cast<bf16*>(p);
  float* mm = static_cast<float*>(m);
  float* vv = static_cast<float*>(v);
  const float* sc = static_cast<const float*>(scal);
  lamb_moments_kernel<GT, MODE><<<nb, kThreads, 0, s>>>(w, pp, static_cast<const GT*>(g), mm, vv,
                                                        sc, n, hp, part);
  int err = (int)cudaGetLastError();
  if (err) return err;
  lamb_apply_kernel<MODE><<<nb, kThreads, 0, s>>>(w, pp, mm, vv, sc, n, hp, part, trust);
  return (int)cudaGetLastError();
}

template <typename GT>
int dispatch(int mode, void* w32, void* p, const void* g, void* m, void* v, const void* scal,
             long long n, const Hyper& hp, float* part, float* trust, cudaStream_t s) {
  switch (mode) {
    case kF32Param: return launch<GT, kF32Param>(w32, p, g, m, v, scal, n, hp, part, trust, s);
    case kMaster: return launch<GT, kMaster>(w32, p, g, m, v, scal, n, hp, part, trust, s);
    case kBf16Param: return launch<GT, kBf16Param>(w32, p, g, m, v, scal, n, hp, part, trust, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The most partial pairs pass A writes: the wrapper's scratch holds
// 2 * ptt_lamb_max_blocks() floats.
PTT_EXPORT int ptt_lamb_max_blocks() { return kMaxBlocks; }

// mode 0: w32 [n] f32 is the parameter (p null); 1: w32 the f32 master and p
// [n] bf16 its copy; 2: p [n] bf16 is the parameter (w32 null). g [n] bf16
// (g_bf16 != 0) or f32; m, v [n] f32, updated in place; scal [>= 3] f32 =
// (lr, 1/bias_corr1, 1/bias_corr2); part [2 * ptt_lamb_max_blocks()] f32
// scratch; trust [1] f32 receives the trust ratio. Every pointer 16-byte
// aligned.
PTT_EXPORT int ptt_lamb(int mode, void* w32, void* p, const void* g, int g_bf16, void* m,
                        void* v, const void* scal, long long n, float b1, float omb1, float b2,
                        float omb2, float eps, float wd, float lr_mult, void* part, void* trust,
                        void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const Hyper hp{b1, omb1, b2, omb2, eps, wd, lr_mult};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part);
  float* tr = static_cast<float*>(trust);
  if (g_bf16) return dispatch<bf16>(mode, w32, p, g, m, v, scal, n, hp, pa, tr, s);
  return dispatch<float>(mode, w32, p, g, m, v, scal, n, hp, pa, tr, s);
}
