// SwiGLU gate: y = silu(g) * u, bf16 in and out, f32 inside, and its
// backward.
//
// Forward: replaces paddle_tpu/ops/kernels/swiglu_pallas.py `_fused_fwd`
// (kernel body `_fwd_kernel`). Backward: replaces `_fused_bwd` (kernel body
// `_bwd_kernel`): with sig = sigmoid(g) and s = g * sig,
//   dg = dy * u * sig * (1 + g - s),  du = dy * s,
// the sigmoid recomputed from g rather than saved.
//
// Bound on the H100: bytes. Two inputs read once, one output written once,
// a handful of operations per element. Design: a grid-stride loop over
// 16-byte vectors (8 elements a thread per step), enough blocks to cover
// every SM several times; the ragged tail (n % 8) is done element by element.
// The backward reads three tensors and writes two the same way.
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
