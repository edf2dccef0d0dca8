// Softmax cross-entropy row statistics: one pass over each row of logits.
//
// Replaces paddle_tpu/ops/kernels/ce_pallas.py `_row_stats` (:66; kernel
// body `_stats_kernel` :43). For each row of logits [N, V] (bf16 or f32, read
// as f32) and its label, three f32 values:
//   mx = max_j x_j;  se = sum_j exp(x_j - mx);
//   tg = x[label - vocab_start] if that index lies in [0, V), else -1e30
// (the TPU kernel's stand-in for -inf: it loses every max and, combined over
// vocab shards, leaves the shard that holds the label). The caller forms the
// loss log(se) + mx - tg and masks ignored rows (ops/kernels/parallel_ce.py).
//
// Bound on the H100: bytes — one read of the logits (2 bytes an element in
// bf16), a dozen operations an element. Design: one 256-thread block per row
// walks the vocab with 16-byte loads (8 bf16 or 4 f32 values; element by
// element where a row is not a whole number of 16-byte vectors), each thread
// keeping a running max and a sum rescaled whenever the max rises (online
// softmax), so the row is read once; a warp-shuffle and then a cross-warp
// merge of the (max, sum) pairs in a fixed order finish the row. The target
// is the one element at label - vocab_start, read directly by thread 0.
#include "common.cuh"

using ptt::bf16;
using ptt::to_f;

namespace {

constexpr int kThreads = 256;
constexpr float kMissing = -1e30f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// values of one 16-byte vector
template <typename T>
struct Vec;
template <>
struct Vec<bf16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const bf16* p, float* o) { ptt::load8(p, o); }
};
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float* o) { ptt::load4(p, o); }
};

// (m, s) <- the merge of two running (max, rescaled sum) pairs
__device__ __forceinline__ void merge(float& m, float& s, float om, float os) {
  if (om > m) {
    s = os + s * __expf(m - om);
    m = om;
  } else if (om > neg_inf()) {
    s += os * __expf(om - m);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
ce_row_stats_kernel(const T* __restrict__ logits, const long long* __restrict__ labels, int v,
                    long long vocab_start, float* __restrict__ mx, float* __restrict__ se,
                    float* __restrict__ tg) {
  __shared__ float sm[32], ss[32];
  const long long row = blockIdx.x;
  const T* x = logits + row * (long long)v;
  float m = neg_inf(), s = 0.f;
  int done = 0;
  if (VEC) {
    constexpr int kN = Vec<T>::kN;
    const int nvec = v / kN;
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      float vals[kN];
      Vec<T>::load(x + (long long)i * kN, vals);
      float lm = vals[0];
#pragma unroll
      for (int j = 1; j < kN; ++j) lm = fmaxf(lm, vals[j]);
      if (lm > m) {
        s *= __expf(m - lm);
        m = lm;
      }
#pragma unroll
      for (int j = 0; j < kN; ++j) s += __expf(vals[j] - m);
    }
    done = nvec * kN;
  }
  for (int j = done + threadIdx.x; j < v; j += blockDim.x) merge(m, s, to_f(x[j]), 1.f);
  // the block's (max, sum): within each warp, then across the warps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, o);
    const float os = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, om, os);
  }
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = sm[0];
    s = ss[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) merge(m, s, sm[w], ss[w]);
    mx[row] = m;
    se[row] = s;
    const long long local = labels[row] - vocab_start;
    tg[row] = (local >= 0 && local < v) ? to_f(x[local]) : kMissing;
  }
}

template <typename T>
int launch(const void* logits, const long long* labels, long long n, int v, long long vocab_start,
           float* mx, float* se, float* tg, int vec, cudaStream_t s) {
  const T* x = static_cast<const T*>(logits);
  const unsigned nb = (unsigned)n;
  if (vec)
    ce_row_stats_kernel<T, true><<<nb, kThreads, 0, s>>>(x, labels, v, vocab_start, mx, se, tg);
  else
    ce_row_stats_kernel<T, false><<<nb, kThreads, 0, s>>>(x, labels, v, vocab_start, mx, se, tg);
  return (int)cudaGetLastError();
}

}  // namespace

// logits [n, v] row-major, bf16 (is_bf16 != 0) or f32, 16-byte aligned;
// labels [n] int64 (global ids); mx, se, tg [n] f32. vec != 0 when every row
// is a whole number of 16-byte vectors (v * element size % 16 == 0).
PTT_EXPORT int ptt_ce_row_stats(const void* logits, int is_bf16, const void* labels, long long n,
                                int v, long long vocab_start, void* mx, void* se, void* tg,
                                int vec, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || v <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* lb = static_cast<const long long*>(labels);
  float* a = static_cast<float*>(mx);
  float* b = static_cast<float*>(se);
  float* c = static_cast<float*>(tg);
  if (is_bf16) return launch<bf16>(logits, lb, n, v, vocab_start, a, b, c, vec, s);
  return launch<float>(logits, lb, n, v, vocab_start, a, b, c, vec, s);
}
