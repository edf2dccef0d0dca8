// Bias + dropout + residual add + layer norm, and its backward, bf16 or f32
// rows, f32 vectors and mask, f32 inside.
//
// Forward: replaces paddle_tpu/ops/kernels/bias_dropout_ln_pallas.py
// `_fused_fwd` (kernel body `_fwd_kernel`). Per row of [N, H]:
//   h = (x + bias) * mask + residual       (mask null: no product)
//   mu = mean(h);  var = mean((h - mu)^2);  rstd = rsqrt(var + eps)
//   y = (h - mu) * rstd * gamma + beta
// with y and h each rounded once to the row type. The mask is the f32
// dropout mask (values keep / (1 - p)) drawn outside the kernel, as the
// reference op's `dropout_mask_out`.
//
// Backward: replaces `_fused_bwd` (kernel body `_bwd_kernel`). Per row, from
// the saved h (rounded: the statistics are recomputed from it, as the TPU
// kernel does), the mask and the cotangent dy:
//   u = dy * gamma;  dh = (u - mean(u) - xhat * mean(u * xhat)) * rstd
//   dx = dh * mask;  dres = dh
//   dgamma = sum_rows dy * xhat,  dbeta = sum_rows dy,  dbias = sum_rows dh * mask
// The TPU kernel carries per-grid-step partial sums; here blocks run in no
// order, so each block walks a strip of rows and keeps its f32 partial rows
// in registers, written once as [3][n_blocks][H]; a second small kernel sums
// them over the blocks in a fixed order (no atomics: the same sums every
// run). One C call launches both.
//
// Bound on the H100: bytes. Each input row is read once and each output row
// written once; the work is a few dozen operations per element. Design: a
// block's threads cover the row with one 8-element vector each (H <= 8192,
// so at most 1024 threads), held in registers between the statistics and
// the output pass, 16-byte accesses; the vectors (bias, gamma, beta) come
// in as f32.
#include "common.cuh"

using ptt::bf16;

namespace {

constexpr int kMaxHidden = 8192;

// Sums of N values over the block; every thread receives the totals.
// `scratch` is N x 32 floats; the barriers on both sides let the caller
// reuse it at once.
template <int N>
__device__ __forceinline__ void block_sums(float* v, float (*scratch)[32]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = ptt::warp_sum(v[k]);
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) scratch[k][warp] = v[k];
  }
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = ptt::warp_sum(lane < n_warps ? scratch[k][lane] : 0.f);
}

template <typename T, bool MASK>
__global__ void bias_dropout_ln_kernel(const T* __restrict__ x, const float* __restrict__ bias,
                                       const T* __restrict__ res, const float* __restrict__ mask,
                                       const float* __restrict__ gamma,
                                       const float* __restrict__ beta, T* __restrict__ y,
                                       T* __restrict__ h_out, int hidden, float eps) {
  __shared__ float scratch[1][32];
  const size_t base = (size_t)blockIdx.x * hidden;
  const int i = threadIdx.x * 8;
  const bool mine = i < hidden;
  const float inv_n = 1.f / (float)hidden;
  float h[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float s[1] = {0.f};
  if (mine) {
    float xv[8], bv[8], rv[8];
    ptt::load8(x + base + i, xv);
    ptt::load8(bias + i, bv);
    ptt::load8(res + base + i, rv);
    float mv[8];
    if (MASK) ptt::load8(mask + base + i, mv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = xv[j] + bv[j];
      if (MASK) v *= mv[j];
      h[j] = v + rv[j];
      s[0] += h[j];
    }
    ptt::store8(h_out + base + i, h);
  }
  block_sums<1>(s, scratch);
  const float mu = s[0] * inv_n;
  float d2[1] = {0.f};
  if (mine) {
#pragma unroll
    for (int j = 0; j < 8; ++j) d2[0] += (h[j] - mu) * (h[j] - mu);
  }
  block_sums<1>(d2, scratch);
  const float rstd = rsqrtf(d2[0] * inv_n + eps);
  if (mine) {
    float gv[8], be[8], o[8];
    ptt::load8(gamma + i, gv);
    ptt::load8(beta + i, be);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = (h[j] - mu) * rstd * gv[j] + be[j];
    ptt::store8(y + base + i, o);
  }
}

template <typename T, bool MASK>
__global__ void __launch_bounds__(1024)
    bias_dropout_ln_bwd_kernel(const T* __restrict__ h, const float* __restrict__ mask,
                               const float* __restrict__ gamma, const T* __restrict__ dy,
                               T* __restrict__ dx, T* __restrict__ dres, float* __restrict__ part,
                               int rows, int rows_per_block, int hidden, float eps) {
  __shared__ float scratch[3][32];
  const int i = threadIdx.x * 8;
  const bool mine = i < hidden;
  const float inv_n = 1.f / (float)hidden;
  float adg[8], adb[8], adbias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) adg[j] = adb[j] = adbias[j] = 0.f;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int r = r0; r < r1; ++r) {
    const size_t base = (size_t)r * hidden;
    float hv[8], dv[8], mv[8];
    float s[2] = {0.f, 0.f};
    if (mine) {
      ptt::load8(h + base + i, hv);
      ptt::load8(dy + base + i, dv);
      if (MASK) ptt::load8(mask + base + i, mv);
#pragma unroll
      for (int j = 0; j < 8; ++j) s[0] += hv[j];
    }
    block_sums<1>(s, scratch);
    const float mu = s[0] * inv_n;
    // sum (h - mu)^2, sum u, sum u (h - mu)
    float t[3] = {0.f, 0.f, 0.f};
    float gv[8];
    if (mine) {
      ptt::load8(gamma + i, gv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = hv[j] - mu;
        const float u = dv[j] * gv[j];
        t[0] += d * d;
        t[1] += u;
        t[2] += u * d;
      }
    }
    block_sums<3>(t, scratch);
    const float rstd = rsqrtf(t[0] * inv_n + eps);
    const float c1 = t[1] * inv_n;
    const float c2 = t[2] * rstd * inv_n;  // mean(u * xhat)
    if (mine) {
      float o[8], p[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float xhat = (hv[j] - mu) * rstd;
        const float dh = (dv[j] * gv[j] - c1 - xhat * c2) * rstd;
        const float dm = MASK ? dh * mv[j] : dh;
        o[j] = dh;
        p[j] = dm;
        adg[j] += dv[j] * xhat;
        adb[j] += dv[j];
        adbias[j] += dm;
      }
      ptt::store8(dres + base + i, o);
      ptt::store8(dx + base + i, p);
    }
  }
  if (mine) {
    const size_t stride = (size_t)gridDim.x * hidden;
    const size_t pb = (size_t)blockIdx.x * hidden + i;
    ptt::store8(part + pb, adg);
    ptt::store8(part + stride + pb, adb);
    ptt::store8(part + 2 * stride + pb, adbias);
  }
}

// out[c] = sum over b of part[b][c] for c < cols (cols = 3 * H of the
// [3][n_blocks][H] partials, read as 3 stacked [n_blocks][H] arrays), in a
// fixed order: thread (ty, tx) sums blocks ty, ty + 8, ... of one column,
// then the 8 partial sums are added in order of ty.
__global__ void bdl_partial_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                       int n_blocks, int hidden) {
  __shared__ float acc[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  float s = 0.f;
  if (c < 3 * hidden) {
    const int a = c / hidden, col = c % hidden;
    const float* p = part + (size_t)a * n_blocks * hidden + col;
    for (int b = ty; b < n_blocks; b += 8) s += p[(size_t)b * hidden];
  }
  acc[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && c < 3 * hidden) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += acc[k][tx];
    out[c] = t;
  }
}

int threads_for(int hidden) {
  int t = ((hidden / 8 + 31) / 32) * 32;
  return t < 32 ? 32 : t;
}

template <typename T, bool MASK>
int launch_fwd(const void* x, const void* bias, const void* res, const void* mask,
               const void* gamma, const void* beta, void* y, void* h, int rows, int hidden,
               float eps, cudaStream_t s) {
  bias_dropout_ln_kernel<T, MASK><<<rows, threads_for(hidden), 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(bias), static_cast<const T*>(res),
      static_cast<const float*>(mask), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(y), static_cast<T*>(h), hidden, eps);
  return (int)cudaGetLastError();
}

template <typename T, bool MASK>
int launch_bwd(const void* h, const void* mask, const void* gamma, const void* dy, void* dx,
               void* dres, void* part, void* out, int rows, int rows_per_block, int hidden,
               float eps, cudaStream_t s) {
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  bias_dropout_ln_bwd_kernel<T, MASK><<<blocks, threads_for(hidden), 0, s>>>(
      static_cast<const T*>(h), static_cast<const float*>(mask), static_cast<const float*>(gamma),
      static_cast<const T*>(dy), static_cast<T*>(dx), static_cast<T*>(dres),
      static_cast<float*>(part), rows, rows_per_block, hidden, eps);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  bdl_partial_sum_kernel<<<(3 * hidden + 31) / 32, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), blocks, hidden);
  return (int)cudaGetLastError();
}

}  // namespace

// x, res, y, h: [rows, hidden] contiguous, f32 (is_f32) or bf16; bias,
// gamma, beta: [hidden] f32; mask: [rows, hidden] f32 or null (the maskless
// variant). hidden % 8 == 0, hidden <= 8192, 16-byte aligned.
PTT_EXPORT int ptt_bias_dropout_ln(const void* x, const void* bias, const void* res,
                                   const void* mask, const void* gamma, const void* beta, void* y,
                                   void* h, int rows, int hidden, float eps, int is_f32,
                                   void* stream) {
  if (rows == 0) return 0;
  if (hidden % 8 || hidden > kMaxHidden) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f32)
    return mask ? launch_fwd<float, true>(x, bias, res, mask, gamma, beta, y, h, rows, hidden,
                                          eps, s)
                : launch_fwd<float, false>(x, bias, res, mask, gamma, beta, y, h, rows, hidden,
                                           eps, s);
  return mask ? launch_fwd<bf16, true>(x, bias, res, mask, gamma, beta, y, h, rows, hidden, eps,
                                       s)
              : launch_fwd<bf16, false>(x, bias, res, mask, gamma, beta, y, h, rows, hidden, eps,
                                        s);
}

// The backward. h, dy, dx, dres: [rows, hidden] (f32 if is_f32, else bf16);
// mask: [rows, hidden] f32 or null; gamma: [hidden] f32; part: scratch of
// [3][ceil(rows / rows_per_block)][hidden] f32; out: [3][hidden] f32, the
// sums of dgamma, dbeta and dbias. hidden % 8 == 0, hidden <= 8192.
PTT_EXPORT int ptt_bias_dropout_ln_bwd(const void* h, const void* mask, const void* gamma,
                                       const void* dy, void* dx, void* dres, void* part,
                                       void* out, int rows, int rows_per_block, int hidden,
                                       float eps, int is_f32, void* stream) {
  if (rows == 0) return 0;
  if (hidden % 8 || hidden > kMaxHidden || rows_per_block < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f32)
    return mask ? launch_bwd<float, true>(h, mask, gamma, dy, dx, dres, part, out, rows,
                                          rows_per_block, hidden, eps, s)
                : launch_bwd<float, false>(h, mask, gamma, dy, dx, dres, part, out, rows,
                                           rows_per_block, hidden, eps, s);
  return mask ? launch_bwd<bf16, true>(h, mask, gamma, dy, dx, dres, part, out, rows,
                                       rows_per_block, hidden, eps, s)
              : launch_bwd<bf16, false>(h, mask, gamma, dy, dx, dres, part, out, rows,
                                        rows_per_block, hidden, eps, s);
}
