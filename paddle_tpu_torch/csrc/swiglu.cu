// SwiGLU gate: y = silu(g) * u, bf16 in and out, f32 inside, and its
// backward, on two operands or on one packed [N, 2I] row.
//
// Forward: replaces paddle_tpu/ops/kernels/swiglu_pallas.py `_fused_fwd`
// (kernel body `_fwd_kernel`). Backward: replaces `_fused_bwd` (kernel body
// `_bwd_kernel`): with sig = sigmoid(g) and s = g * sig,
//   dg = dy * u * sig * (1 + g - s),  du = dy * s,
// the sigmoid recomputed from g rather than saved.
// Packed: replaces `_fused_fwd_packed` and `_fused_bwd_packed` (kernel
// bodies `_fwd_packed_kernel`, `_bwd_packed_kernel`): x is one [N, 2I] row
// per token, gate half first; both halves are read in place (no split
// copies), y is [N, I], and the backward writes dx = [dg | du] packed the
// same way.
//
// Bound on the H100: bytes. Two inputs read once, one output written once,
// a handful of operations per element. Forward design: a grid-stride loop
// over 16-byte vectors whose launch (threads a block, vectors a thread
// requests at once, blocks) comes from the wrapper's plan: blocks of 128
// threads, one vector a thread a step, and past 2^22 vectors a grid the
// card holds at once with four vectors of g and of u in flight a thread;
// the sigmoid from the fast exponential and the fast reciprocal (the
// accurate expf and IEEE division cost ~0.2 us a decode-width launch);
// the ragged tail (n % 8) by the one thread whose next vector it would be,
// not by block 0 after its loop. The backward reads three tensors and
// writes two in a grid-stride loop of 256-thread blocks (8 elements a
// thread a step), the tail element by element. The packed kernels need
// I % 8 == 0, so that every vector lies inside one half.
#include "common.cuh"

using ptt::bf16;

namespace {

constexpr int kMaxThreads = 256;   // threads of a forward block at most
constexpr int kMaxUnroll = 4;      // vectors a forward thread requests at once at most

// The forward's launch (paddle_tpu_torch/ops/kernels/swiglu.py `plan`,
// decided from the element count alone), one 64-bit word: bits 0-10 the
// threads of a block (at most kMaxThreads), 12-14 the vectors a thread
// requests at once (1 or 4), 16-46 the blocks.
struct FwdLaunch {
  int threads, unroll;
  long long blocks;
};

inline FwdLaunch fwd_decode(long long word) {
  FwdLaunch l;
  l.threads = (int)(word & 0x7ff);
  l.unroll = (int)((word >> 12) & 0x7);
  l.blocks = (word >> 16) & 0x7fffffffLL;
  return l;
}

// whole warps within a block's limit, an unroll the kernel has, a grid
inline bool fwd_valid(const FwdLaunch& l) {
  if (l.threads < 32 || l.threads > kMaxThreads || l.threads % 32) return false;
  if (l.unroll != 1 && l.unroll != kMaxUnroll) return false;
  return l.blocks >= 1;
}

// 1 / x to one f32 ulp (rcp.approx without .ftz: subnormal results kept)
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// silu(a) * b in f32: the sigmoid from the fast exponential and the fast
// reciprocal, each within two f32 ulps, far inside a bf16 ulp. For a below
// about -88, exp(-a) passes 2^126 (or is inf) and the reciprocal keeps the
// subnormal (or 0) that sigmoid is there, where a fast division
// (__fdividef) would return 0 early.
__device__ __forceinline__ float silu_mul(float a, float b) {
  return a * rcp_approx(1.f + __expf(-a)) * b;
}

__device__ __forceinline__ uint4 swiglu8(const uint4& gv, const uint4& uv) {
  float a[8], b[8];
  ptt::unpack8(gv, a);
  ptt::unpack8(uv, b);
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j] = silu_mul(a[j], b[j]);
  return ptt::pack8(a);
}

}  // namespace

// A grid-stride loop over 16-byte vectors: thread t of the grid's T takes
// vectors t, t + T, t + 2 T, ..., U of them at a time with all 2 U loads
// issued before any arithmetic; the thread whose next vector would be the
// partial one past n / 8 takes the last n % 8 elements one by one.
template <int U>
__global__ void __launch_bounds__(kMaxThreads)
    swiglu_kernel(const bf16* __restrict__ g, const bf16* __restrict__ u, bf16* __restrict__ y,
                  long long n) {
  const long long n8 = n / 8;
  const long long T = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* gv = reinterpret_cast<const uint4*>(g);
  const uint4* uv = reinterpret_cast<const uint4*>(u);
  uint4* yv = reinterpret_cast<uint4*>(y);
  if constexpr (U > 1) {
    for (; i + (U - 1) * T < n8; i += U * T) {
      uint4 a[U], b[U];
#pragma unroll
      for (int k = 0; k < U; ++k) a[k] = gv[i + k * T];
#pragma unroll
      for (int k = 0; k < U; ++k) b[k] = uv[i + k * T];
#pragma unroll
      for (int k = 0; k < U; ++k) yv[i + k * T] = swiglu8(a[k], b[k]);
    }
  }
  for (; i < n8; i += T) yv[i] = swiglu8(gv[i], uv[i]);
  if (i == n8) {
    for (long long t = n8 * 8; t < n; ++t)
      y[t] = __float2bfloat16(silu_mul(__bfloat162float(g[t]), __bfloat162float(u[t])));
  }
}

// g, u, y: n bf16 elements each. `plan`: the launch word of swiglu.plan; a
// launch the kernel does not have is refused.
PTT_EXPORT int ptt_swiglu(const void* g, const void* u, void* y, long long n, long long plan,
                          void* stream) {
  const FwdLaunch l = fwd_decode(plan);
  if (!fwd_valid(l)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* gp = static_cast<const bf16*>(g);
  const bf16* up = static_cast<const bf16*>(u);
  bf16* yp = static_cast<bf16*>(y);
  const unsigned blocks = (unsigned)l.blocks;
  if (l.unroll == 1)
    swiglu_kernel<1><<<blocks, l.threads, 0, s>>>(gp, up, yp, n);
  else
    swiglu_kernel<kMaxUnroll><<<blocks, l.threads, 0, s>>>(gp, up, yp, n);
  return (int)cudaGetLastError();
}

namespace {

__device__ __forceinline__ void swiglu_grad(float a, float b, float d, float& dg, float& du) {
  const float sig = 1.f / (1.f + expf(-a));
  const float s = a * sig;
  dg = d * b * sig * (1.f + a - s);
  du = d * s;
}

__global__ void swiglu_bwd_kernel(const bf16* __restrict__ g, const bf16* __restrict__ u,
                                  const bf16* __restrict__ dy, bf16* __restrict__ dg,
                                  bf16* __restrict__ du, long long n) {
  const long long n8 = n / 8;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n8; i += stride) {
    float a[8], b[8], d[8], og[8], ou[8];
    ptt::load8(g + i * 8, a);
    ptt::load8(u + i * 8, b);
    ptt::load8(dy + i * 8, d);
#pragma unroll
    for (int j = 0; j < 8; ++j) swiglu_grad(a[j], b[j], d[j], og[j], ou[j]);
    ptt::store8(dg + i * 8, og);
    ptt::store8(du + i * 8, ou);
  }
  if (blockIdx.x == 0) {
    const long long t = n8 * 8 + threadIdx.x;
    if (t < n) {
      float og, ou;
      swiglu_grad(__bfloat162float(g[t]), __bfloat162float(u[t]), __bfloat162float(dy[t]), og, ou);
      dg[t] = __float2bfloat16(og);
      du[t] = __float2bfloat16(ou);
    }
  }
}

}  // namespace

// g, u, dy, dg, du: n bf16 elements each.
PTT_EXPORT int ptt_swiglu_bwd(const void* g, const void* u, const void* dy, void* dg, void* du,
                              long long n, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n / 8 + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  swiglu_bwd_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(u), static_cast<const bf16*>(dy),
      static_cast<bf16*>(dg), static_cast<bf16*>(du), n);
  return (int)cudaGetLastError();
}

namespace {

__global__ void swiglu_packed_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                                     long long rows, int inter) {
  const long long iv = inter / 8;
  const long long n8 = rows * iv;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n8; v += stride) {
    const long long r = v / iv;
    const long long c = (v - r * iv) * 8;
    const bf16* row = x + r * 2 * inter;
    float a[8], b[8], o[8];
    ptt::load8(row + c, a);
    ptt::load8(row + inter + c, b);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = a[j] / (1.f + expf(-a[j])) * b[j];
    ptt::store8(y + r * inter + c, o);
  }
}

__global__ void swiglu_packed_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                                         bf16* __restrict__ dx, long long rows, int inter) {
  const long long iv = inter / 8;
  const long long n8 = rows * iv;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n8; v += stride) {
    const long long r = v / iv;
    const long long c = (v - r * iv) * 8;
    const long long xrow = r * 2 * inter;
    float a[8], b[8], d[8], og[8], ou[8];
    ptt::load8(x + xrow + c, a);
    ptt::load8(x + xrow + inter + c, b);
    ptt::load8(dy + r * inter + c, d);
#pragma unroll
    for (int j = 0; j < 8; ++j) swiglu_grad(a[j], b[j], d[j], og[j], ou[j]);
    ptt::store8(dx + xrow + c, og);
    ptt::store8(dx + xrow + inter + c, ou);
  }
}

unsigned packed_blocks(long long rows, int inter, int threads) {
  long long blocks = (rows * (inter / 8) + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return (unsigned)blocks;
}

}  // namespace

// x: [rows, 2 * inter] bf16 (gate half first), y: [rows, inter] bf16;
// inter % 8 == 0.
PTT_EXPORT int ptt_swiglu_packed(const void* x, void* y, long long rows, int inter, void* stream) {
  if (rows == 0 || inter == 0) return 0;
  const int threads = 256;
  swiglu_packed_kernel<<<packed_blocks(rows, inter, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(static_cast<const bf16*>(x),
                                                              static_cast<bf16*>(y), rows, inter);
  return (int)cudaGetLastError();
}

// x, dx: [rows, 2 * inter] bf16; dy: [rows, inter] bf16; inter % 8 == 0.
PTT_EXPORT int ptt_swiglu_packed_bwd(const void* x, const void* dy, void* dx, long long rows,
                                     int inter, void* stream) {
  if (rows == 0 || inter == 0) return 0;
  const int threads = 256;
  swiglu_packed_bwd_kernel<<<packed_blocks(rows, inter, threads), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<bf16*>(dx), rows,
      inter);
  return (int)cudaGetLastError();
}
