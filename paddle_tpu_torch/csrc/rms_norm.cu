// RMSNorm with an optional residual add, bf16 in and out, f32 inside.
//
// Replaces paddle_tpu/ops/kernels/rms_norm_pallas.py `_fused_fwd` (kernel
// bodies `_fwd_plain_kernel` / `_fwd_res_kernel`). Computes
//   h = x (+ res);  y = h * rsqrt(mean(h^2) + eps) * w
// with h kept in f32 and y cast once, and writes h (cast) when a residual
// is given.
//
// Bound on the H100: bytes. Each row is read once (x, res) and written once
// (y, h); the work is a few operations per element. Design: one block per
// row; each thread moves 16-byte vectors, keeps its f32 h in shared memory
// for the second pass, so no input is read twice from device memory.
#include "common.cuh"

using ptt::bf16;

template <bool RES>
__global__ void rms_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
                                const bf16* __restrict__ w, bf16* __restrict__ y,
                                bf16* __restrict__ h_out, int hidden, float eps) {
  extern __shared__ float row[];  // [hidden] f32 pre-norm values
  __shared__ float scratch[32];
  const size_t base = (size_t)blockIdx.x * hidden;
  const int step = blockDim.x * 8;

  float ss = 0.f;
  for (int i = threadIdx.x * 8; i < hidden; i += step) {
    float a[8];
    ptt::load8(x + base + i, a);
    if (RES) {
      float r[8];
      ptt::load8(res + base + i, r);
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] += r[j];
      ptt::store8(h_out + base + i, a);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      row[i + j] = a[j];
      ss += a[j] * a[j];
    }
  }
  const float rstd = rsqrtf(ptt::block_sum(ss, scratch) / (float)hidden + eps);
  // each thread reads back only the entries it wrote itself
  for (int i = threadIdx.x * 8; i < hidden; i += step) {
    float wv[8], o[8];
    ptt::load8(w + i, wv);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = row[i + j] * rstd * wv[j];
    ptt::store8(y + base + i, o);
  }
}

// x, res, y, h: [rows, hidden] bf16 (res and h may be null together);
// w: [hidden] bf16; hidden % 8 == 0.
PTT_EXPORT int ptt_rms_norm(const void* x, const void* res, const void* w, void* y, void* h,
                            int rows, int hidden, float eps, void* stream) {
  if (rows == 0) return 0;
  const int vecs = hidden / 8;
  int threads = ((vecs + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const size_t smem = (size_t)hidden * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // above 48 KB in all (the static reduction scratch included) only after
  // opting in
  const bool big = smem + sizeof(float) * 32 > 48 * 1024;
  if (res != nullptr) {
    if (big)
      cudaFuncSetAttribute(rms_norm_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    rms_norm_kernel<true><<<rows, threads, smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(res), static_cast<const bf16*>(w),
        static_cast<bf16*>(y), static_cast<bf16*>(h), hidden, eps);
  } else {
    if (big)
      cudaFuncSetAttribute(rms_norm_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    rms_norm_kernel<false><<<rows, threads, smem, s>>>(
        static_cast<const bf16*>(x), nullptr, static_cast<const bf16*>(w), static_cast<bf16*>(y),
        nullptr, hidden, eps);
  }
  return (int)cudaGetLastError();
}
