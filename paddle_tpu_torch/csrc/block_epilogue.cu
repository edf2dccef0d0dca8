// Transformer-block epilogue: act -> counter-hash dropout -> + residual ->
// rms/layer norm, bf16 in and out, f32 inside, and its one-pass backward.
//
// Forward: replaces paddle_tpu/ops/kernels/block_fused_pallas.py `_fwd`
// (kernel body `_fwd_kernel`). Per row of the [N, H] output:
//   z = act(x)            act: none | gelu (tanh form) | swiglu (x is [N, 2H])
//   z = keep ? z * scale : 0      keep = fmix32(idx ^ seed * 0x9E3779B9) >= threshold
//                                  (ptt::fmix32, common.cuh, shared with dropout_add.cu)
//   h = z + residual
//   y = norm(h) * w (+ b) norm: rms | layer; statistics in f32
// and writes y and h (cast once). The dropout mask is murmur3's finalizer
// over the global flat index idx = row * H + col of the [N, H] output, in
// uint32 arithmetic that wraps as jnp.uint32 does
// (dropout_add_pallas.py `_keep_bits`), so kernel, plain version and the
// TPU kernel drop exactly the same elements.
//
// Backward: replaces `_bwd` (kernel body `_bwd_kernel`). Per row, from the
// saved h and the cotangents gy (of y) and gh (of h, optional):
//   u = gy * w;  rstd and xhat recomputed from h in f32
//   rms:   dh = rstd * u - h * rstd^3 * mean(h * u)
//   layer: dh = (u - mean(u) - xhat * mean(u * xhat)) * rstd
//   dh += gh;  dres = dh;  dz = keep ? dh * scale : 0 (the same mask)
//   dx = act'(x) * dz      (swiglu: [dz u sig (1 + g - s), dz s], s = g sig)
//   dw = sum_rows gy * xhat,  db = sum_rows gy
// The TPU kernel carries per-grid-step partial dw/db; here blocks run in
// no order, so each block walks a strip of rows and keeps its own f32
// partial dw/db in shared memory, written once as one [n_blocks, H] row
// each; the wrapper sums the partials (no atomics: the same sums every
// run).
//
// Bound on the H100: bytes. Each row of x and residual (forward), or of h,
// gy, gh and x (backward), is read once and each output written once; the
// work is a few dozen operations per element. Design: one block per row
// (forward) or per strip of rows (backward), 16-byte vectors per thread;
// the f32 row (h, and gy in the backward) stays in shared memory between
// the statistics pass and the output pass, so nothing is read twice from
// device memory.
#include "common.cuh"

using ptt::bf16;

namespace {

constexpr float kGeluK = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluC = 0.044715f;
using ptt::fmix32;
using ptt::kGolden;

enum Act { kNone = 0, kGelu = 1, kSwiglu = 2 };

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

// Sums of N values over the block; every thread receives the totals.
// `scratch` is N x 32 floats of shared memory; the trailing barrier lets the
// caller reuse it at once.
template <int N>
__device__ __forceinline__ void block_sums(float* v, float (*scratch)[32]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    v[k] = ptt::warp_sum(v[k]);
    if (lane == 0) scratch[k][warp] = v[k];
  }
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = ptt::warp_sum(lane < n_warps ? scratch[k][lane] : 0.f);
  __syncthreads();
}

__device__ __forceinline__ float gelu_tanh_grad(float v) {
  const float u = kGeluK * (v + kGeluC * v * v * v);
  const float t = tanhf(u);
  const float du = kGeluK * (1.f + 3.f * kGeluC * v * v);
  return 0.5f * (1.f + t) + 0.5f * v * (1.f - t * t) * du;
}

// Dynamic shared memory: [hidden] f32 each of h, gy and the partial dw, and
// of the partial db when BIAS. Each thread reads and writes only the
// entries of its own vectors, so the rows need no barrier besides the
// reductions'.
template <int ACT, bool LAYER, bool BIAS, bool DROP>
__global__ void block_epilogue_bwd_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ x, const bf16* __restrict__ w,
    const bf16* __restrict__ gy, const bf16* __restrict__ gh, bf16* __restrict__ dx,
    bf16* __restrict__ dres, float* __restrict__ dw_part, float* __restrict__ db_part, int rows,
    int rows_per_block, int hidden, float eps, uint32_t key, uint32_t threshold, float scale) {
  extern __shared__ float smem[];
  __shared__ float scratch[3][32];
  float* sh_h = smem;
  float* sh_g = smem + hidden;
  float* sh_dw = smem + 2 * hidden;
  float* sh_db = smem + 3 * hidden;
  const int step = blockDim.x * 8;
  const float inv_n = 1.f / (float)hidden;
  for (int i = threadIdx.x * 8; i < hidden; i += step) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sh_dw[i + j] = 0.f;
      if (BIAS) sh_db[i + j] = 0.f;
    }
  }
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int r = r0; r < r1; ++r) {
    const size_t base = (size_t)r * hidden;
    // statistics: rms needs sum h^2 and sum h u; layer needs the mean
    // first, then sum (h - mu)^2, sum u and sum u (h - mu)
    float s[3] = {0.f, 0.f, 0.f};
    for (int i = threadIdx.x * 8; i < hidden; i += step) {
      float hv[8], gv[8], wv[8];
      ptt::load8(h + base + i, hv);
      ptt::load8(gy + base + i, gv);
      if (!LAYER) ptt::load8(w + i, wv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sh_h[i + j] = hv[j];
        sh_g[i + j] = gv[j];
        if (LAYER) {
          s[0] += hv[j];
        } else {
          s[0] += hv[j] * hv[j];
          s[1] += hv[j] * (gv[j] * wv[j]);
        }
      }
    }
    float mu = 0.f, rstd, c1 = 0.f, c2;
    if (LAYER) {
      block_sums<1>(s, scratch);
      mu = s[0] * inv_n;
      float t[3] = {0.f, 0.f, 0.f};
      for (int i = threadIdx.x * 8; i < hidden; i += step) {
        float wv[8];
        ptt::load8(w + i, wv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = sh_h[i + j] - mu;
          const float u = sh_g[i + j] * wv[j];
          t[0] += d * d;
          t[1] += u;
          t[2] += u * d;
        }
      }
      block_sums<3>(t, scratch);
      rstd = rsqrtf(t[0] * inv_n + eps);
      c1 = t[1] * inv_n;
      c2 = t[2] * rstd * inv_n;  // mean(u * xhat)
    } else {
      block_sums<2>(s, scratch);
      rstd = rsqrtf(s[0] * inv_n + eps);
      c2 = rstd * rstd * rstd * (s[1] * inv_n);
    }
    const size_t xbase = base * (ACT == kSwiglu ? 2 : 1);
    const uint32_t idx_row = (uint32_t)r * (uint32_t)hidden;  // wraps as uint32
    for (int i = threadIdx.x * 8; i < hidden; i += step) {
      float wv[8], d[8];
      ptt::load8(w + i, wv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float hv = sh_h[i + j], gv = sh_g[i + j];
        const float u = gv * wv[j];
        const float xhat = LAYER ? (hv - mu) * rstd : hv * rstd;
        d[j] = LAYER ? (u - c1 - xhat * c2) * rstd : rstd * u - hv * c2;
        sh_dw[i + j] += gv * xhat;
        if (BIAS) sh_db[i + j] += gv;
      }
      if (gh != nullptr) {
        float gr[8];
        ptt::load8(gh + base + i, gr);
#pragma unroll
        for (int j = 0; j < 8; ++j) d[j] += gr[j];
      }
      ptt::store8(dres + base + i, d);
      if (DROP) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t bits = fmix32((idx_row + (uint32_t)(i + j)) ^ key);
          d[j] = bits >= threshold ? d[j] * scale : 0.f;
        }
      }
      if (ACT == kGelu) {
        float xv[8];
        ptt::load8(x + xbase + i, xv);
#pragma unroll
        for (int j = 0; j < 8; ++j) d[j] *= gelu_tanh_grad(xv[j]);
        ptt::store8(dx + xbase + i, d);
      } else if (ACT == kSwiglu) {
        float g[8], up[8], dg[8], du[8];
        ptt::load8(x + xbase + i, g);
        ptt::load8(x + xbase + hidden + i, up);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float sig = 1.f / (1.f + expf(-g[j]));
          const float sv = g[j] * sig;
          dg[j] = d[j] * up[j] * sig * (1.f + g[j] - sv);
          du[j] = d[j] * sv;
        }
        ptt::store8(dx + xbase + i, dg);
        ptt::store8(dx + xbase + hidden + i, du);
      } else {
        ptt::store8(dx + base + i, d);
      }
    }
  }
  const size_t pbase = (size_t)blockIdx.x * hidden;
  for (int i = threadIdx.x * 8; i < hidden; i += step) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dw_part[pbase + i + j] = sh_dw[i + j];
      if (BIAS) db_part[pbase + i + j] = sh_db[i + j];
    }
  }
}

struct BwdArgs {
  const void *h, *x, *w, *gy, *gh;
  void *dx, *dres, *dw_part, *db_part;
  int rows, rows_per_block, hidden;
  float eps;
  uint32_t key, threshold;
  float scale;
};

template <int ACT, bool LAYER, bool BIAS, bool DROP>
int launch_bwd(const BwdArgs& a, cudaStream_t s) {
  const int vecs = a.hidden / 8;
  int threads = ((vecs + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const size_t smem = (size_t)(BIAS ? 4 : 3) * a.hidden * sizeof(float);
  auto kern = block_epilogue_bwd_kernel<ACT, LAYER, BIAS, DROP>;
  if (smem + sizeof(float) * 3 * 32 > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int blocks = (a.rows + a.rows_per_block - 1) / a.rows_per_block;
  kern<<<blocks, threads, smem, s>>>(
      static_cast<const bf16*>(a.h), static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.w),
      static_cast<const bf16*>(a.gy), static_cast<const bf16*>(a.gh), static_cast<bf16*>(a.dx),
      static_cast<bf16*>(a.dres), static_cast<float*>(a.dw_part), static_cast<float*>(a.db_part),
      a.rows, a.rows_per_block, a.hidden, a.eps, a.key, a.threshold, a.scale);
  return (int)cudaGetLastError();
}

template <int ACT, bool LAYER, bool BIAS>
int bwd_pick_drop(bool drop, const BwdArgs& a, cudaStream_t s) {
  return drop ? launch_bwd<ACT, LAYER, BIAS, true>(a, s) : launch_bwd<ACT, LAYER, BIAS, false>(a, s);
}

template <int ACT>
int bwd_pick_norm(int layer, bool bias, bool drop, const BwdArgs& a, cudaStream_t s) {
  if (!layer) return bwd_pick_drop<ACT, false, false>(drop, a, s);
  if (!bias) return bwd_pick_drop<ACT, true, false>(drop, a, s);
  return bwd_pick_drop<ACT, true, true>(drop, a, s);
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

// The backward. h, gy, dres: [rows, hidden] bf16; gh: the same or null;
// x: [rows, hidden] (act 1) or [rows, 2 * hidden] (act 2) bf16, null for
// act 0; dx: x's shape ([rows, hidden] for act 0); w: [hidden] bf16;
// dw_part and db_part (db_part only with has_bias, layer norm):
// [ceil(rows / rows_per_block), hidden] f32, one row per block.
// hidden % 8 == 0 and (3 + has_bias) * hidden * 4 bytes of shared memory.
PTT_EXPORT int ptt_block_epilogue_bwd(const void* h, const void* x, const void* w, const void* gy,
                                      const void* gh, void* dx, void* dres, void* dw_part,
                                      void* db_part, int rows, int rows_per_block, int hidden,
                                      int act, int layer, int has_bias, int drop, float eps,
                                      unsigned int seed, unsigned int threshold, float scale,
                                      void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs a{h,    x,     w,      gy,  gh,  dx, dres, dw_part, db_part, rows, rows_per_block,
                  hidden, eps, (uint32_t)seed * kGolden, threshold, scale};
  const bool bias = layer && has_bias;
  switch (act) {
    case kGelu:
      return bwd_pick_norm<kGelu>(layer, bias, drop != 0, a, s);
    case kSwiglu:
      return bwd_pick_norm<kSwiglu>(layer, bias, drop != 0, a, s);
    default:
      return bwd_pick_norm<kNone>(layer, bias, drop != 0, a, s);
  }
}
