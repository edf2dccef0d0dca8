// Masked row softmax (additive mask, or the causal triangle made in the
// kernel) and its backward, bf16 or f32 in and out, f32 inside.
//
// Replaces paddle_tpu/ops/kernels/softmax_mask_pallas.py `_fused_fwd`
// (kernel body `_fwd_kernel`), `_fused_fwd_tri` (`_fwd_tri_kernel`) and
// `_fused_bwd` (`_bwd_kernel`). For x [B, H, Sq, Sk], per row (b, h, q):
//   masked: y = softmax(x + mask)       mask read through its strides
//   causal: y = softmax(x with col > q set to -inf)   (the triangle's
//           corner is the top left, col <= q, also when Sq != Sk)
//   backward: dx = (dy - sum(dy * y)) * y
// in f32, each output rounded once. A row masked wholly to -inf gives NaN,
// as the TPU kernel does: there is no guard.
//
// The mask is any tensor that broadcasts to x: the wrapper passes the
// strides of its broadcast view, 0 on every broadcast axis, so the head
// axis (and any other) is folded by the strides and never materialised,
// as the TPU kernel folds the head axis in its index map (i // heads).
//
// Bound on the H100: bytes (x read and y written once, the mask's distinct
// bytes read once and served from L2 to the other heads; y and dy read and
// dx written once); ~10 operations an element. Design: one block per row,
// 16-byte accesses of x, y and dy; the f32 row stays in shared memory
// between the max, the sum and the output pass (and y, dy between the dot
// and the output pass), so nothing is read twice from device memory; the
// max and the sums are warp shuffles, then one value a warp.
#include <math.h>

#include "common.cuh"

using ptt::bf16;

namespace {

// Max over the whole block; every thread receives it. `scratch` is 32
// floats; the leading barrier lets the caller reuse it back to back.
__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  float m = lane < n_warps ? scratch[lane] : -INFINITY;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

__device__ __forceinline__ float block_sum(float v, float* scratch) {
  __syncthreads();
  return ptt::block_sum(v, scratch);
}

// CAUSAL: the triangle instead of a mask (M unused)
template <typename T, typename M, bool CAUSAL>
__global__ void softmax_mask_kernel(const T* __restrict__ x, const M* __restrict__ mask,
                                    T* __restrict__ y, int heads, int sq, int sk, long long ms_b,
                                    long long ms_h, long long ms_q, long long ms_k) {
  extern __shared__ float row[];  // [sk] f32
  __shared__ float scratch[32];
  const size_t r = blockIdx.x;
  const size_t base = r * (size_t)sk;
  const int q = (int)(r % (size_t)sq);
  const int step = blockDim.x * 8;

  long long mbase = 0;
  if (!CAUSAL) {
    const size_t bh = r / (size_t)sq;
    mbase = (long long)(bh / heads) * ms_b + (long long)(bh % heads) * ms_h + (long long)q * ms_q;
  }
  float mx = -INFINITY;
  for (int i = threadIdx.x * 8; i < sk; i += step) {
    float v[8];
    ptt::load8(x + base + i, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (CAUSAL) {
        if (i + j > q) v[j] = -INFINITY;
      } else {
        v[j] += ptt::to_f(mask[mbase + (long long)(i + j) * ms_k]);
      }
      row[i + j] = v[j];
      mx = fmaxf(mx, v[j]);
    }
  }
  mx = block_max(mx, scratch);
  // each thread reads back only the entries it wrote itself
  float s = 0.f;
  for (int i = threadIdx.x * 8; i < sk; i += step) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float e = expf(row[i + j] - mx);
      row[i + j] = e;
      s += e;
    }
  }
  s = block_sum(s, scratch);
  for (int i = threadIdx.x * 8; i < sk; i += step) {
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = row[i + j] / s;
    ptt::store8(y + base + i, o);
  }
}

template <typename T>
__global__ void softmax_mask_bwd_kernel(const T* __restrict__ y, const T* __restrict__ dy,
                                        T* __restrict__ dx, int sk) {
  extern __shared__ float buf[];  // [2][sk] f32: y, dy
  __shared__ float scratch[32];
  float* ys = buf;
  float* gs = buf + sk;
  const size_t base = (size_t)blockIdx.x * sk;
  const int step = blockDim.x * 8;
  float dot = 0.f;
  for (int i = threadIdx.x * 8; i < sk; i += step) {
    float a[8], g[8];
    ptt::load8(y + base + i, a);
    ptt::load8(dy + base + i, g);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ys[i + j] = a[j];
      gs[i + j] = g[j];
      dot += g[j] * a[j];
    }
  }
  dot = block_sum(dot, scratch);
  for (int i = threadIdx.x * 8; i < sk; i += step) {
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = (gs[i + j] - dot) * ys[i + j];
    ptt::store8(dx + base + i, o);
  }
}

int threads_for(int sk) {
  int t = ((sk / 8 + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

template <typename K>
void opt_in(K kern, size_t smem) {
  // above 48 KB in all (the static reduction scratch included) only after
  // opting in
  if (smem + sizeof(float) * 32 > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, typename M, bool CAUSAL>
int launch(const void* x, const void* mask, void* y, long long rows, int heads, int sq, int sk,
           long long ms_b, long long ms_h, long long ms_q, long long ms_k, cudaStream_t s) {
  const size_t smem = (size_t)sk * sizeof(float);
  auto kern = softmax_mask_kernel<T, M, CAUSAL>;
  opt_in(kern, smem);
  kern<<<(unsigned)rows, threads_for(sk), smem, s>>>(static_cast<const T*>(x),
                                                      static_cast<const M*>(mask),
                                                      static_cast<T*>(y), heads, sq, sk, ms_b,
                                                      ms_h, ms_q, ms_k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_x(const void* x, const void* mask, void* y, long long rows, int heads, int sq, int sk,
             long long ms_b, long long ms_h, long long ms_q, long long ms_k, int mask_f32,
             int causal, cudaStream_t s) {
  if (causal) return launch<T, float, true>(x, nullptr, y, rows, heads, sq, sk, 0, 0, 0, 0, s);
  if (mask_f32)
    return launch<T, float, false>(x, mask, y, rows, heads, sq, sk, ms_b, ms_h, ms_q, ms_k, s);
  return launch<T, bf16, false>(x, mask, y, rows, heads, sq, sk, ms_b, ms_h, ms_q, ms_k, s);
}

template <typename T>
int launch_bwd(const void* y, const void* dy, void* dx, long long rows, int sk, cudaStream_t s) {
  const size_t smem = 2 * (size_t)sk * sizeof(float);
  auto kern = softmax_mask_bwd_kernel<T>;
  opt_in(kern, smem);
  kern<<<(unsigned)rows, threads_for(sk), smem, s>>>(
      static_cast<const T*>(y), static_cast<const T*>(dy), static_cast<T*>(dx), sk);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: [rows = B * H * Sq, Sk] contiguous, f32 (x_f32) or bf16; Sk % 8 == 0,
// 16-byte aligned. causal != 0: the triangle, mask unused (null). Otherwise
// mask (f32 if mask_f32, else bf16) element (b, h, q, k) is at
// b * ms_b + h * ms_h + q * ms_q + k * ms_k (strides in elements, 0 where
// the mask broadcasts). Sk * 4 bytes of shared memory a block.
PTT_EXPORT int ptt_softmax_mask(const void* x, const void* mask, void* y, long long rows,
                                int heads, int sq, int sk, long long ms_b, long long ms_h,
                                long long ms_q, long long ms_k, int x_f32, int mask_f32,
                                int causal, void* stream) {
  if (rows == 0 || sk == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return launch_x<float>(x, mask, y, rows, heads, sq, sk, ms_b, ms_h, ms_q, ms_k, mask_f32,
                           causal, s);
  return launch_x<bf16>(x, mask, y, rows, heads, sq, sk, ms_b, ms_h, ms_q, ms_k, mask_f32, causal,
                        s);
}

// y, dy, dx: [rows, Sk] contiguous, f32 (is_f32) or bf16; Sk % 8 == 0,
// 16-byte aligned; 2 * Sk * 4 bytes of shared memory a block.
PTT_EXPORT int ptt_softmax_mask_bwd(const void* y, const void* dy, void* dx, long long rows,
                                    int sk, int is_f32, void* stream) {
  if (rows == 0 || sk == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f32 ? launch_bwd<float>(y, dy, dx, rows, sk, s)
                : launch_bwd<bf16>(y, dy, dx, rows, sk, s);
}
