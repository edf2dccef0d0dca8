// Transformer-block epilogue: act -> counter-hash dropout -> + residual ->
// rms/layer norm, bf16 in and out, f32 inside.
//
// Replaces paddle_tpu/ops/kernels/block_fused_pallas.py `_fwd` (kernel body
// `_fwd_kernel`). Per row of the [N, H] output:
//   z = act(x)            act: none | gelu (tanh form) | swiglu (x is [N, 2H])
//   z = keep ? z * scale : 0      keep = fmix32(idx ^ seed * 0x9E3779B9) >= threshold
//   h = z + residual
//   y = norm(h) * w (+ b) norm: rms | layer; statistics in f32
// and writes y and h (cast once). The dropout mask is murmur3's finalizer
// over the global flat index idx = row * H + col of the [N, H] output, in
// uint32 arithmetic that wraps as jnp.uint32 does
// (dropout_add_pallas.py `_keep_bits`), so kernel, plain version and the
// TPU kernel drop exactly the same elements.
//
// Bound on the H100: bytes. Each row of x and residual is read once and y
// and h are written once; the work is a few dozen operations per element.
// Design: one block per row, 16-byte vectors per thread; the f32 pre-norm
// row stays in shared memory between the statistics pass and the output
// pass, so nothing is read twice from device memory.
#include "common.cuh"

using ptt::bf16;

namespace {

constexpr float kGeluK = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluC = 0.044715f;
constexpr uint32_t kGolden = 0x9E3779B9u;

enum Act { kNone = 0, kGelu = 1, kSwiglu = 2 };

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Block-wide sum; every thread receives the total. A __syncthreads()
// before the scratch write lets the function be called back to back.
__device__ __forceinline__ float block_sum2(float v, float* scratch) {
  __syncthreads();
  return ptt::block_sum(v, scratch);
}

template <int ACT, bool LAYER, bool BIAS, bool DROP>
__global__ void block_epilogue_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
                                      const bf16* __restrict__ w, const bf16* __restrict__ b,
                                      bf16* __restrict__ y, bf16* __restrict__ h_out, int hidden,
                                      float eps, uint32_t key, uint32_t threshold, float scale) {
  extern __shared__ float row[];  // [hidden] f32 pre-norm values
  __shared__ float scratch[32];
  const uint32_t r = blockIdx.x;
  const size_t base = (size_t)r * hidden;
  const size_t xbase = (size_t)r * hidden * (ACT == kSwiglu ? 2 : 1);
  const int step = blockDim.x * 8;

  float s1 = 0.f;
  for (int i = threadIdx.x * 8; i < hidden; i += step) {
    float z[8], rv[8];
    ptt::load8(x + xbase + i, z);
    if (ACT == kGelu) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = z[j];
        const float u = kGeluK * (v + kGeluC * v * v * v);
        z[j] = 0.5f * v * (1.f + tanhf(u));
      }
    } else if (ACT == kSwiglu) {
      float up[8];
      ptt::load8(x + xbase + hidden + i, up);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float g = z[j];
        z[j] = g * (1.f / (1.f + expf(-g))) * up[j];
      }
    }
    if (DROP) {
      const uint32_t idx0 = r * (uint32_t)hidden + (uint32_t)i;  // wraps as uint32
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t bits = fmix32((idx0 + (uint32_t)j) ^ key);
        z[j] = bits >= threshold ? z[j] * scale : 0.f;
      }
    }
    ptt::load8(res + base + i, rv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float hv = z[j] + rv[j];
      z[j] = hv;
      row[i + j] = hv;
      s1 += LAYER ? hv : hv * hv;
    }
    ptt::store8(h_out + base + i, z);
  }
  const float inv_n = 1.f / (float)hidden;
  float mu = 0.f, rstd;
  if (LAYER) {
    mu = block_sum2(s1, scratch) * inv_n;
    float s2 = 0.f;
    // each thread reads back only the entries it wrote itself
    for (int i = threadIdx.x * 8; i < hidden; i += step) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = row[i + j] - mu;
        s2 += d * d;
      }
    }
    rstd = rsqrtf(block_sum2(s2, scratch) * inv_n + eps);
  } else {
    rstd = rsqrtf(block_sum2(s1, scratch) * inv_n + eps);
  }
  for (int i = threadIdx.x * 8; i < hidden; i += step) {
    float wv[8], o[8];
    ptt::load8(w + i, wv);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = (LAYER ? row[i + j] - mu : row[i + j]) * rstd * wv[j];
    if (BIAS) {
      float bv[8];
      ptt::load8(b + i, bv);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] += bv[j];
    }
    ptt::store8(y + base + i, o);
  }
}

template <int ACT, bool LAYER, bool BIAS, bool DROP>
int launch(const void* x, const void* res, const void* w, const void* b, void* y, void* h, int rows,
           int hidden, float eps, uint32_t key, uint32_t threshold, float scale,
           cudaStream_t s) {
  const int vecs = hidden / 8;
  int threads = ((vecs + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const size_t smem = (size_t)hidden * sizeof(float);
  auto kern = block_epilogue_kernel<ACT, LAYER, BIAS, DROP>;
  // above 48 KB in all (the static reduction scratch included) only
  // after opting in
  if (smem + sizeof(float) * 32 > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kern<<<rows, threads, smem, s>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(res),
                                   static_cast<const bf16*>(w), static_cast<const bf16*>(b),
                                   static_cast<bf16*>(y), static_cast<bf16*>(h), hidden, eps,
                                   key, threshold, scale);
  return (int)cudaGetLastError();
}

template <int ACT, bool LAYER, bool BIAS>
int pick_drop(bool drop, const void* x, const void* res, const void* w, const void* b, void* y,
              void* h, int rows, int hidden, float eps, uint32_t key, uint32_t threshold,
              float scale, cudaStream_t s) {
  return drop ? launch<ACT, LAYER, BIAS, true>(x, res, w, b, y, h, rows, hidden, eps, key,
                                               threshold, scale, s)
              : launch<ACT, LAYER, BIAS, false>(x, res, w, b, y, h, rows, hidden, eps, key,
                                                threshold, scale, s);
}

template <int ACT>
int pick_norm(int layer, bool drop, const void* x, const void* res, const void* w, const void* b,
              void* y, void* h, int rows, int hidden, float eps, uint32_t key,
              uint32_t threshold, float scale, cudaStream_t s) {
  if (!layer)
    return pick_drop<ACT, false, false>(drop, x, res, w, b, y, h, rows, hidden, eps, key,
                                        threshold, scale, s);
  if (b == nullptr)
    return pick_drop<ACT, true, false>(drop, x, res, w, b, y, h, rows, hidden, eps, key,
                                       threshold, scale, s);
  return pick_drop<ACT, true, true>(drop, x, res, w, b, y, h, rows, hidden, eps, key, threshold,
                                    scale, s);
}

}  // namespace

// x: [rows, hidden] bf16, or [rows, 2 * hidden] for act 2 (swiglu, gate
// half first); res, y, h: [rows, hidden] bf16; w, b: [hidden] bf16 (b may be
// null, and is null for rms); hidden % 8 == 0. act: 0 none, 1 gelu, 2
// swiglu; layer: 0 rms, 1 layer norm. drop != 0 applies the counter-hash
// mask with `seed` (the int32 seed's bits), `threshold` and `scale`.
PTT_EXPORT int ptt_block_epilogue(const void* x, const void* res, const void* w, const void* b,
                                  void* y, void* h, int rows, int hidden, int act, int layer,
                                  int drop, float eps, unsigned int seed, unsigned int threshold,
                                  float scale, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t key = (uint32_t)seed * kGolden;
  switch (act) {
    case kGelu:
      return pick_norm<kGelu>(layer, drop != 0, x, res, w, b, y, h, rows, hidden, eps, key,
                              threshold, scale, s);
    case kSwiglu:
      return pick_norm<kSwiglu>(layer, drop != 0, x, res, w, b, y, h, rows, hidden, eps, key,
                                threshold, scale, s);
    default:
      return pick_norm<kNone>(layer, drop != 0, x, res, w, b, y, h, rows, hidden, eps, key,
                              threshold, scale, s);
  }
}
