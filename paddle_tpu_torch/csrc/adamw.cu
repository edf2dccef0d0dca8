// Fused Adam / AdamW parameter update: one pass over (w, g, m, v).
//
// Replaces paddle_tpu/ops/kernels/adamw_pallas.py `_adamw_call` (kernel body
// `_adamw_kernel`), reached through `adamw_update`. Per element, in f32:
//   m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * (g * g)
//   mhat = m * inv_bc1;  vhat = v * inv_bc2
//   w = w - (w * lr) * wd;  w = w - (mhat / (sqrt(vhat) + eps)) * lr
// in that order, each operation rounded on its own (the _rn intrinsics keep
// nvcc from contracting a multiply and an add into one fma), so the plain
// PyTorch version, one operation per tensor op, gives the same bits. lr,
// 1/bias_corr1 and 1/bias_corr2 are read from a small f32 device tensor (the
// TPU kernel's (1, 4) operand), so a learning-rate change or the step count
// never leaves the device; lr is multiplied by a per-parameter factor.
//
// Three parameter forms: an f32 parameter updated in place (w32 only); an
// f32 master w32 with a bf16 parameter copy written from it (multi
// precision); a bf16 parameter read and written in place with f32 math (no
// master). g is bf16 or f32.
//
// Bound on the H100: bytes — with a master, 28 bytes an element (w32, m, v
// read and written, g read, the bf16 copy written), a dozen operations.
// Design: a grid-stride loop of 4 elements a thread (16-byte f32 vectors,
// 8-byte bf16 vectors), enough blocks to cover every SM several times; the
// ragged tail (n % 4) element by element.
#include "common.cuh"

using ptt::bf16;
using ptt::to_f;
using ptt::load4;
using ptt::store4;

namespace {

enum Mode { kF32Param = 0, kMaster = 1, kBf16Param = 2 };

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd, lr_mult;
};

// one element; w, m, v updated in place
__device__ __forceinline__ void adamw_one(float& w, float g, float& m, float& v, float lr,
                                          float ibc1, float ibc2, const Hyper& hp) {
  m = __fadd_rn(__fmul_rn(hp.b1, m), __fmul_rn(hp.omb1, g));
  v = __fadd_rn(__fmul_rn(hp.b2, v), __fmul_rn(hp.omb2, __fmul_rn(g, g)));
  const float mhat = __fmul_rn(m, ibc1);
  const float vhat = __fmul_rn(v, ibc2);
  w = __fsub_rn(w, __fmul_rn(__fmul_rn(w, lr), hp.wd));
  w = __fsub_rn(w, __fmul_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), hp.eps)), lr));
}

template <typename GT, int MODE>
__global__ void adamw_kernel(float* __restrict__ w32, bf16* __restrict__ p,
                             const GT* __restrict__ g, float* __restrict__ m,
                             float* __restrict__ v, const float* __restrict__ scal, long long n,
                             Hyper hp) {
  const float lr = __fmul_rn(scal[0], hp.lr_mult);
  const float ibc1 = scal[1], ibc2 = scal[2];
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
    for (int j = 0; j < 4; ++j) adamw_one(wv[j], gv[j], mv[j], vv[j], lr, ibc1, ibc2, hp);
    if (MODE != kBf16Param) store4(w32 + o, wv);
    if (MODE != kF32Param) store4(p + o, wv);
    store4(m + o, mv);
    store4(v + o, vv);
  }
  if (blockIdx.x == 0) {
    const long long o = n4 * 4 + threadIdx.x;
    if (o < n) {
      float wv = MODE == kBf16Param ? __bfloat162float(p[o]) : w32[o];
      float mv = m[o], vv = v[o];
      adamw_one(wv, to_f(g[o]), mv, vv, lr, ibc1, ibc2, hp);
      if (MODE != kBf16Param) w32[o] = wv;
      if (MODE != kF32Param) p[o] = __float2bfloat16_rn(wv);
      m[o] = mv;
      v[o] = vv;
    }
  }
}

template <typename GT>
int launch(int mode, void* w32, void* p, const void* g, void* m, void* v, const void* scal,
           long long n, const Hyper& hp, cudaStream_t s) {
  const int threads = 256;
  long long blocks = (n / 4 + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 8) blocks = 132 * 8;
  const unsigned nb = (unsigned)blocks;
  float* w = static_cast<float*>(w32);
  bf16* pp = static_cast<bf16*>(p);
  const GT* gg = static_cast<const GT*>(g);
  float* mm = static_cast<float*>(m);
  float* vv = static_cast<float*>(v);
  const float* sc = static_cast<const float*>(scal);
  switch (mode) {
    case kF32Param: adamw_kernel<GT, kF32Param><<<nb, threads, 0, s>>>(w, pp, gg, mm, vv, sc, n, hp); break;
    case kMaster: adamw_kernel<GT, kMaster><<<nb, threads, 0, s>>>(w, pp, gg, mm, vv, sc, n, hp); break;
    case kBf16Param: adamw_kernel<GT, kBf16Param><<<nb, threads, 0, s>>>(w, pp, gg, mm, vv, sc, n, hp); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0: w32 [n] f32 is the parameter (p null); 1: w32 the f32 master and p
// [n] bf16 its copy; 2: p [n] bf16 is the parameter (w32 null). g [n] bf16
// (g_bf16 != 0) or f32; m, v [n] f32; scal [>= 3] f32 = (lr, 1/bias_corr1,
// 1/bias_corr2). Every pointer 16-byte aligned.
PTT_EXPORT int ptt_adamw(int mode, void* w32, void* p, const void* g, int g_bf16, void* m,
                         void* v, const void* scal, long long n, float b1, float omb1, float b2,
                         float omb2, float eps, float wd, float lr_mult, void* stream) {
  if (n == 0) return 0;
  const Hyper hp{b1, omb1, b2, omb2, eps, wd, lr_mult};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_bf16) return launch<bf16>(mode, w32, p, g, m, v, scal, n, hp, s);
  return launch<float>(mode, w32, p, g, m, v, scal, n, hp, s);
}
