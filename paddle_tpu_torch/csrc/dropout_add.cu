// Counter-hash dropout + residual add, and its backward, bf16 or f32 in and
// out, f32 inside.
//
// Replaces paddle_tpu/ops/kernels/dropout_add_pallas.py `_fwd` (kernel body
// `_fwd_kernel`) and `_bwd` (kernel body `_bwd_kernel`). Over the flat
// tensor, element idx (its uint32 flat index, wrapping as jnp.uint32 does):
//   keep = fmix32(idx ^ seed * 0x9E3779B9) >= threshold   (ptt::fmix32)
//   forward:  y  = (keep ? x * scale : 0) + residual
//   backward: dx = keep ? dy * scale : 0        (dresidual = dy, no kernel)
// computed in f32 and rounded once to the tensor's type (the product is
// __fmul_rn, never contracted into an FMA with the add, so the kernel gives
// the plain version's bits). The mask is a
// function of (seed, idx) alone: it never exists in device memory, the
// backward regenerates the forward's from the seed, and this kernel, the
// plain version and the TPU kernel drop the same elements bit for bit.
//
// Bound on the H100: bytes (x, residual read and y written once; dy read and
// dx written once); the hash is ~10 integer operations an element. Design:
// a grid-stride loop over 8-element chunks, one 16-byte access per bf16
// chunk (two for f32), over the grid the wrapper gives
// (paddle_tpu_torch/ops/kernels/dropout_add.py `grid`: 132 SMs x 8 blocks of
// 256 threads, fewer for a small tensor); the last numel % 8 elements go one
// at a time. (Several chunks a thread in flight, their hashes computed while
// they load, were no faster: this loop already moves the bytes at a copy's
// speed, PERF.md §6.)
#include "common.cuh"

using ptt::bf16;

namespace {

// RES: the forward (adds the residual); otherwise the backward (x is dy)
template <typename T, bool RES>
__global__ void dropout_add_kernel(const T* __restrict__ x, const T* __restrict__ res,
                                   T* __restrict__ y, size_t n, uint32_t key, uint32_t threshold,
                                   float scale) {
  const size_t chunks = n / 8;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t c = (size_t)blockIdx.x * blockDim.x + threadIdx.x; c < chunks; c += stride) {
    const size_t i = c * 8;
    float v[8];
    ptt::load8(x + i, v);
    const uint32_t idx0 = (uint32_t)i;  // wraps as uint32
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t bits = ptt::fmix32((idx0 + (uint32_t)j) ^ key);
      v[j] = bits >= threshold ? __fmul_rn(v[j], scale) : 0.f;
    }
    if (RES) {
      float r[8];
      ptt::load8(res + i, r);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += r[j];
    }
    ptt::store8(y + i, v);
  }
  // the tail: fewer than 8 elements, one thread each
  const size_t t = chunks * 8 + (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n && blockIdx.x * (size_t)blockDim.x + threadIdx.x < 8) {
    const uint32_t bits = ptt::fmix32((uint32_t)t ^ key);
    float v = bits >= threshold ? __fmul_rn(ptt::to_f(x[t]), scale) : 0.f;
    if (RES) v += ptt::to_f(res[t]);
    ptt::from_f(y + t, v);
  }
}

constexpr int kThreads = 256;

template <typename T, bool RES>
int launch(const void* x, const void* res, void* y, size_t n, unsigned int seed,
           unsigned int threshold, float scale, int blocks, cudaStream_t s) {
  dropout_add_kernel<T, RES><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<T*>(y), n,
      (uint32_t)seed * ptt::kGolden, threshold, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// x, res, y: n contiguous elements of one type (is_f32: float, else bf16),
// 16-byte aligned. res null runs the backward (x is dy, y is dx). `seed` is
// the int32 seed's bits; `threshold` and `scale` are dropout_add_pallas
// `_params(p)` (scale as f32). `blocks` of kThreads threads, any number
// from 1: the grid-stride loop reaches every chunk.
PTT_EXPORT int ptt_dropout_add(const void* x, const void* res, void* y, long long n, int is_f32,
                               unsigned int seed, unsigned int threshold, float scale, int blocks,
                               void* stream) {
  if (n <= 0) return 0;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t m = (size_t)n;
  if (is_f32)
    return res ? launch<float, true>(x, res, y, m, seed, threshold, scale, blocks, s)
               : launch<float, false>(x, res, y, m, seed, threshold, scale, blocks, s);
  return res ? launch<bf16, true>(x, res, y, m, seed, threshold, scale, blocks, s)
             : launch<bf16, false>(x, res, y, m, seed, threshold, scale, blocks, s);
}
