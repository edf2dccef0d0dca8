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
// a handful of operations per element. Design: a grid-stride loop over
// 16-byte vectors (8 elements a thread per step), enough blocks to cover
// every SM several times; the ragged tail (n % 8) is done element by element.
// The backward reads three tensors and writes two the same way. The packed
// kernels need I % 8 == 0, so that every vector lies inside one half.
#include "common.cuh"

using ptt::bf16;

__global__ void swiglu_kernel(const bf16* __restrict__ g, const bf16* __restrict__ u,
                              bf16* __restrict__ y, long long n) {
  const long long n8 = n / 8;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n8; i += stride) {
    float a[8], b[8], o[8];
    ptt::load8(g + i * 8, a);
    ptt::load8(u + i * 8, b);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = a[j] / (1.f + expf(-a[j])) * b[j];
    ptt::store8(y + i * 8, o);
  }
  if (blockIdx.x == 0) {
    const long long t = n8 * 8 + threadIdx.x;
    if (t < n) {
      const float a = __bfloat162float(g[t]);
      y[t] = __float2bfloat16(a / (1.f + expf(-a)) * __bfloat162float(u[t]));
    }
  }
}

// g, u, y: n bf16 elements each.
PTT_EXPORT int ptt_swiglu(const void* g, const void* u, void* y, long long n, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n / 8 + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  swiglu_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(u), static_cast<bf16*>(y), n);
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
