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
// no order, so each block writes one f32 partial row of dw (and db) and a
// second kernel adds the rows in a fixed order (no atomics: the same sums
// every run).
//
// Bound on the H100: bytes. Each row of x and residual (forward), or of h,
// gy, gh and x (backward), is read once and each output written once; the
// work is a few dozen operations per element. Forward (csrc/norm_rows.cuh,
// shared with the RMSNorm forward; the plan is paddle_tpu_torch/ops/kernels/
// block_epilogue.py `plan`): a row in the registers of its block, one
// 8-element vector a thread; w, b, x (both halves for swiglu) and the
// residual are all requested before the first reduction, so a row costs one
// memory round trip, and layer norm's two-pass variance runs over the values
// in registers. Rows past 8192, and the variants with an activation or
// dropout (which took 45-64 registers in that form and ran slower), keep
// the f32 row in shared memory between the passes, w read after them.
//
// Backward (block_epilogue_bwd_rows_kernel): a group of ceil(hidden / 512)
// warps owns a row through hidden 8192 (two 16-byte vectors a lane; a block
// holds 8 / group warps groups, or one), above it a group of ceil(hidden /
// 2048) warps (eight vectors a lane). Every group walks a strip of
// consecutive rows. A narrow group (hidden <= 8192) keeps three rows of h,
// gy and gh in shared memory: one lane brings row i + 2 in by bulk copies
// (cp.async.bulk, signalled on the stage's mbarrier) while the group works
// on row i, and asks L2 for row i + 3 and its x (bulk prefetches), so the
// bytes are in flight without holding registers; the lanes read their
// vectors from the stage in the statistics pass and again in the output
// pass, and x from device memory. A wide group reads its vectors from
// device memory in each pass (the second time from L1). The norm statistics
// are reduced by warp shuffles and, in a group of several warps, through
// shared memory behind the group's own named barrier (never the whole
// block); w is read from L1 a row. dw and db build up in registers across
// the strip (a wide group: in the block's shared row), the block's groups
// add theirs in group order, and the block writes one partial row: the grid
// fills the card once (as many blocks an SM as shared memory and 128
// registers a thread allow), 256 partial rows at [8192, 768] (1.6 MB with
// db). block_epilogue_bwd_sum_kernel then adds the rows column by column in
// a fixed order.
#include <algorithm>

#include "norm_rows.cuh"

using ptt::bf16;
namespace hp = ptt::hopper;
namespace rw = ptt::rows;

namespace {

constexpr float kGeluK = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluC = 0.044715f;
using ptt::fmix32;
using ptt::kGolden;

enum Act { kNone = 0, kGelu = 1, kSwiglu = 2 };

// kRow, the variants held in registers (no activation, no dropout): block b
// takes row b, thread t its vector t.
template <bool LAYER, bool BIAS>
__device__ __forceinline__ void epilogue_row(const bf16* __restrict__ x,
                                             const bf16* __restrict__ res,
                                             const bf16* __restrict__ w,
                                             const bf16* __restrict__ b, bf16* __restrict__ y,
                                             bf16* __restrict__ h_out, int hidden, float eps) {
  __shared__ float red[2][32];
  const int col = threadIdx.x * 8;
  const bool mine = col < hidden;
  const float inv_n = 1.f / (float)hidden;
  const size_t base = (size_t)blockIdx.x * hidden + col;
  uint4 wv = {}, bv = {}, xv = {}, rv = {};
  if (mine) {
    wv = rw::ld16(w + col);
    if (BIAS) bv = rw::ld16(b + col);
    xv = rw::ld16(x + base);
    rv = rw::ld16(res + base);
  }
  float h[8], rf[8];
  rw::unpack8(xv, h);
  rw::unpack8(rv, rf);
  float s1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    h[j] += rf[j];
    s1 += LAYER ? h[j] : h[j] * h[j];
  }
  if (mine) ptt::store8(h_out + base, h);
  int buf = 0;
  s1 = rw::block_total(s1, red, buf);
  float mu = 0.f, rstd;
  if (LAYER) {
    mu = s1 * inv_n;
    float s2 = 0.f;
    if (mine) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s2 += (h[j] - mu) * (h[j] - mu);
    }
    rstd = rsqrtf(rw::block_total(s2, red, buf) * inv_n + eps);
  } else {
    rstd = rsqrtf(s1 * inv_n + eps);
  }
  if (mine) {
    float wf[8], bf[8];
    rw::unpack8(wv, wf);
    if (BIAS) rw::unpack8(bv, bf);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      h[j] = (LAYER ? h[j] - mu : h[j]) * rstd * wf[j];
      if (BIAS) h[j] += bf[j];
    }
    ptt::store8(y + base, h);
  }
}

// kWide, rows past kRegHidden and the variants with an activation or
// dropout: a block a row, each thread striding over it in 16-byte vectors,
// the f32 pre-norm row in dynamic shared memory between the statistics pass
// and the output pass, so nothing is read twice from device memory.
template <int ACT, bool LAYER, bool BIAS, bool DROP>
__device__ __forceinline__ void epilogue_wide(const bf16* __restrict__ x,
                                              const bf16* __restrict__ res,
                                              const bf16* __restrict__ w,
                                              const bf16* __restrict__ b, bf16* __restrict__ y,
                                              bf16* __restrict__ h_out, int hidden, float eps,
                                              uint32_t key, uint32_t threshold, float scale) {
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
      // the up half 4 values at a time: all 8 at once spilled under the
      // arm's 32 registers
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float up[4];
        ptt::load4(x + xbase + hidden + i + 4 * hf, up);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float g = z[4 * hf + j];
          z[4 * hf + j] = g * (1.f / (1.f + expf(-g))) * up[j];
        }
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
  // each sum behind a barrier of its own, so a second sum never meets a warp
  // still reading the first's scratch
  if (LAYER) {
    __syncthreads();
    mu = ptt::block_sum(s1, scratch) * inv_n;
    float s2 = 0.f;
    // each thread reads back only the entries it wrote itself
    for (int i = threadIdx.x * 8; i < hidden; i += step) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = row[i + j] - mu;
        s2 += d * d;
      }
    }
    __syncthreads();
    rstd = rsqrtf(ptt::block_sum(s2, scratch) * inv_n + eps);
  } else {
    __syncthreads();
    rstd = rsqrtf(ptt::block_sum(s1, scratch) * inv_n + eps);
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

// The variants a block a row holds in registers: no activation, no dropout.
// The others (gelu's tanh, swiglu's second half, the dropout hash) took
// 45-64 registers there, half the blocks an SM of the shared-memory arm, and
// were slower at every shape above a decode batch: they keep that arm.
template <int ACT, bool DROP>
constexpr bool kInRegisters = ACT == kNone && !DROP;

// ARM: rw::kRow or kWide. Both keep to 32 registers (four blocks of 512
// threads, H 4096, an SM: the shared-memory arm free to take more took
// 42-56 and ran slower) but a block a row of layer norm, which takes up to
// 40 (a 32 cap spilled its bias and second statistic).
template <int ACT, bool LAYER, bool BIAS, bool DROP, int ARM>
__global__ void __launch_bounds__(rw::kMaxThreads, ARM == rw::kRow && LAYER ? 1 : 2)
    block_epilogue_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
                          const bf16* __restrict__ w, const bf16* __restrict__ b,
                          bf16* __restrict__ y, bf16* __restrict__ h_out, int hidden, float eps,
                          uint32_t key, uint32_t threshold, float scale) {
  if constexpr (ARM == rw::kWide) {
    epilogue_wide<ACT, LAYER, BIAS, DROP>(x, res, w, b, y, h_out, hidden, eps, key, threshold,
                                          scale);
  } else {
    static_assert(kInRegisters<ACT, DROP>, "a block a row holds only these variants");
    epilogue_row<LAYER, BIAS>(x, res, w, b, y, h_out, hidden, eps);
  }
}

struct FwdArgs {
  const void *x, *res, *w, *b;
  void *y, *h;
  int hidden;
  float eps;
  uint32_t key, threshold;
  float scale;
};

template <int ACT, bool LAYER, bool BIAS, bool DROP, int ARM>
int launch_arm(const rw::Launch& l, const FwdArgs& a, cudaStream_t s) {
  size_t smem = 0;
  if (ARM == rw::kWide) {
    smem = (size_t)a.hidden * sizeof(float);
    // above 48 KB in all (the static scratch included) only after opting in
    if (smem + rw::kWideStatic > 48 * 1024) {
      const cudaError_t err =
          hp::allow_smem<block_epilogue_kernel<ACT, LAYER, BIAS, DROP, rw::kWide>>(
              rw::kWideSmem);
      if (err != cudaSuccess) return (int)err;
    }
  }
  return rw::launch<block_epilogue_kernel<ACT, LAYER, BIAS, DROP, ARM>>(
      l, smem, s, static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.res),
      static_cast<const bf16*>(a.w), static_cast<const bf16*>(a.b), static_cast<bf16*>(a.y),
      static_cast<bf16*>(a.h), a.hidden, a.eps, a.key, a.threshold, a.scale);
}

// a block a row only for the variants held in registers (kInRegisters)
template <int ACT, bool LAYER, bool BIAS, bool DROP>
int launch(const rw::Launch& l, const FwdArgs& a, cudaStream_t s) {
  if (l.arm == rw::kWide) return launch_arm<ACT, LAYER, BIAS, DROP, rw::kWide>(l, a, s);
  if constexpr (kInRegisters<ACT, DROP>)
    return launch_arm<ACT, LAYER, BIAS, DROP, rw::kRow>(l, a, s);
  return (int)cudaErrorInvalidValue;
}

template <int ACT, bool LAYER, bool BIAS>
int pick_drop(bool drop, const rw::Launch& l, const FwdArgs& a, cudaStream_t s) {
  return drop ? launch<ACT, LAYER, BIAS, true>(l, a, s) : launch<ACT, LAYER, BIAS, false>(l, a, s);
}

template <int ACT>
int pick_norm(int layer, bool drop, const rw::Launch& l, const FwdArgs& a, cudaStream_t s) {
  if (!layer) return pick_drop<ACT, false, false>(drop, l, a, s);
  if (a.b == nullptr) return pick_drop<ACT, true, false>(drop, l, a, s);
  return pick_drop<ACT, true, true>(drop, l, a, s);
}

__device__ __forceinline__ float gelu_tanh_grad(float v) {
  const float u = kGeluK * (v + kGeluC * v * v * v);
  const float t = tanhf(u);
  const float du = kGeluK * (1.f + 3.f * kGeluC * v * v);
  return 0.5f * (1.f + t) + 0.5f * v * (1.f - t * t) * du;
}

// -- the backward ----------------------------------------------------------------

constexpr int kSms = 132;         // the H100's multiprocessors
constexpr int kSmemSm = 233472;   // shared memory an SM holds (1 KB of it reserved a block)
constexpr int kMaxThreads = 512;  // threads of a rows block at most (128 registers a thread)
constexpr int kBlockWarps = 8;    // warps of a block of several narrow groups
constexpr int kNarrowVecs = 2;    // 16-byte vectors of a row a lane owns: hidden <= 8192
constexpr int kWideVecs = 8;      // above that
constexpr int kMaxGroupWarps = 16;  // warps of a group at most: hidden <= 32768
constexpr int kStages = 3;        // a narrow group's rows in shared memory: this one and two more
constexpr int kSumRows = 8;       // partial rows a column's threads split in the sum kernel
constexpr int kBwdSmemMax = 227 * 1024 - 1024;  // dynamic shared memory a rows block may take

// The launch plan (paddle_tpu_torch/ops/kernels/block_epilogue.py `_bwd_plan`
// declares the same): a group of `group_warps` warps owns a row, each lane
// `vecs` 16-byte vectors of it (vector j = (v * group_warps + warp) * 32 +
// lane); `groups` groups a block (8 / group_warps of them, or one); every
// group walks a strip of `rows_per_group` consecutive rows; the grid fills
// the card once at `blocks_sm` blocks an SM (as many as shared memory and
// 128 registers a thread allow). A narrow group stages its rows in shared
// memory, kStages of its rows of h, gy and (when given) gh, with a
// mbarrier a stage; the block's groups combine their dw (and db) there at
// the end. A wide group accumulates dw (and db) in the block's shared row.
struct BwdPlan {
  int vecs, group_warps, groups, threads, smem, blocks_sm, rows_per_group, blocks;
};

inline BwdPlan bwd_plan(int rows, int hidden, bool bias, bool has_gh) {
  const int vecs = hidden / 8;
  const bool narrow = vecs <= kNarrowVecs * 32 * kMaxGroupWarps;
  const int v = narrow ? kNarrowVecs : kWideVecs;
  const int g = std::max(1, (vecs + 32 * v - 1) / (32 * v));
  const int ng = std::max(1, kBlockWarps / g);
  const int threads = ng * g * 32;
  const int na = 2 + (has_gh ? 1 : 0);
  const int smem = narrow ? ng * kStages * (na * hidden * 2 + 8) : (bias ? 2 : 1) * hidden * 4;
  const int bsm = std::max(1, std::min(kSmemSm / (smem + 1024), 65536 / (128 * threads)));
  const int slots = kSms * bsm * ng;
  const int rpg = std::max(1, (rows + slots - 1) / slots);
  const int blocks = std::max(1, (rows + rpg * ng - 1) / (rpg * ng));
  return BwdPlan{v, g, ng, threads, smem, bsm, rpg, blocks};
}

// A group's sums: norm_rows.cuh (shared with the RMSNorm backward).
using rw::group_sums;

// The backward's rows, as the header says: a narrow group (V ==
// kNarrowVecs) reads h, gy and gh from its shared-memory stages, filled by
// one lane's bulk copies two rows ahead; a wide group reads them from device
// memory. dw and db: registers for a narrow group, the block's shared row
// for a wide one. Each block writes one f32 partial row of dw (and db) to
// part, its groups' partials added in group order.
template <int ACT, bool LAYER, bool BIAS, bool DROP, int V>
__global__ void __launch_bounds__(kMaxThreads, 1)
    block_epilogue_bwd_rows_kernel(const bf16* __restrict__ h, const bf16* __restrict__ x,
                                   const bf16* __restrict__ w, const bf16* __restrict__ gy,
                                   const bf16* __restrict__ gh, bf16* __restrict__ dx,
                                   bf16* __restrict__ dres, float* __restrict__ part, int rows,
                                   int rows_per_group, int hidden, int group_warps, float eps,
                                   uint32_t key, uint32_t threshold, float scale) {
  constexpr bool kNarrow = V == kNarrowVecs;
  constexpr int kAcc = kNarrow ? V * 8 : 1;
  constexpr int kXN = ACT == kSwiglu ? 2 : ACT == kGelu ? 1 : 0;  // rows of x a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[2][3][kMaxGroupWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = group_warps, grp = warp / g, wig = warp % g;
  const int ng = blockDim.x / (32 * g);
  const int vecs = hidden / 8;
  const int gi = blockIdx.x * ng + grp;
  const int r_begin = gi * rows_per_group;
  const int n_rows = max(0, min(rows, r_begin + rows_per_group) - r_begin);
  const float inv_n = 1.f / (float)hidden;
  const size_t xw = (size_t)hidden * (kXN ? kXN : 1);
  const bool leader = wig == 0 && lane == 0;
  float* acc_s = reinterpret_cast<float*>(smem_raw);  // wide: [(1 + BIAS) * hidden]

  // narrow: this group's stages (h, gy, gh) and their mbarriers
  const int na = 2 + (gh != nullptr);
  const size_t stage = (size_t)na * hidden;  // bf16 elements
  bf16* ring = reinterpret_cast<bf16*>(smem_raw) + (size_t)grp * kStages * stage;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + (size_t)ng * kStages * stage * 2) +
                   grp * kStages;
  auto issue = [&](int r, int st) {
    bf16* dst = ring + st * stage;
    const uint32_t rb = (uint32_t)hidden * 2;
    hp::mbar_arrive_expect_tx(&full[st], (uint32_t)na * rb);
    hp::bulk_load(dst, h + (size_t)r * hidden, rb, &full[st]);
    hp::bulk_load(dst + hidden, gy + (size_t)r * hidden, rb, &full[st]);
    if (gh != nullptr) hp::bulk_load(dst + 2 * hidden, gh + (size_t)r * hidden, rb, &full[st]);
  };
  auto prefetch = [&](int r) {
    const uint32_t rb = (uint32_t)hidden * 2;
    hp::prefetch_l2(h + (size_t)r * hidden, rb);
    hp::prefetch_l2(gy + (size_t)r * hidden, rb);
    if (gh != nullptr) hp::prefetch_l2(gh + (size_t)r * hidden, rb);
    if (kXN) hp::prefetch_l2(x + (size_t)r * xw, kXN * rb);
  };

  float dw[kAcc], db[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dw[i] = db[i] = 0.f;
  if constexpr (kNarrow) {
    if (leader)
      for (int s = 0; s < kStages; ++s) hp::mbar_init(&full[s], 1);
    hp::mbar_fence_init();
    __syncthreads();
    if (leader)
      for (int s = 0; s < kStages - 1 && s < n_rows; ++s) issue(r_begin + s, s);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int j = (v * g + wig) * 32 + lane;
      if (j < vecs)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          acc_s[8 * j + e] = 0.f;
          if (BIAS) acc_s[hidden + 8 * j + e] = 0.f;
        }
    }
  }

  int buf = 0;
  for (int i = 0; i < n_rows; ++i) {
    const int r = r_begin + i;
    const size_t base = (size_t)r * hidden;
    // where this row's vectors are: the stage (narrow) or device memory
    const bf16 *rh = h + base, *rgy = gy + base, *rgh = gh == nullptr ? nullptr : gh + base,
               *rx = x == nullptr ? nullptr : x + (size_t)r * xw;
    // row i + kStages - 1 goes into the stage row i - 1 held, once every
    // warp of the group is past row i - 1: here for a one-warp group, after
    // the first barrier of the row for a larger one (next())
    const int ahead = i + kStages - 1;
    if constexpr (kNarrow) {
      if (g == 1) {
        __syncwarp();
        if (lane == 0 && ahead < n_rows) issue(r_begin + ahead, ahead % kStages);
      }
      if (leader && ahead + 1 < n_rows) prefetch(r_begin + ahead + 1);
      hp::mbar_wait(&full[i % kStages], (i / kStages) & 1);
      const bf16* sh = ring + (i % kStages) * stage;
      rh = sh;
      rgy = sh + hidden;
      if (gh != nullptr) rgh = sh + 2 * hidden;
    } else {
      if (leader && i + 1 < n_rows) prefetch(r + 1);
    }
    auto next = [&]() {
      if constexpr (kNarrow) {
        if (g > 1 && leader && ahead < n_rows) issue(r_begin + ahead, ahead % kStages);
      }
    };
    // statistics: rms needs sum h^2 and sum h u; layer needs the mean
    // first, then sum (h - mu)^2, sum u and sum u (h - mu)
    float mu = 0.f, rstd, c1 = 0.f, c2;
    if (LAYER) {
      float s[1] = {0.f};
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int j = (v * g + wig) * 32 + lane;
        if (j < vecs) {
          float hf[8];
          ptt::load8(rh + 8 * j, hf);
#pragma unroll
          for (int e = 0; e < 8; ++e) s[0] += hf[e];
        }
      }
      group_sums<1>(s, red, buf, grp, g, wig, lane);
      next();
      mu = s[0] * inv_n;
      float t[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int j = (v * g + wig) * 32 + lane;
        if (j < vecs) {
          float hf[8], gf[8], wf[8];
          ptt::load8(rh + 8 * j, hf);
          ptt::load8(rgy + 8 * j, gf);
          ptt::load8(w + 8 * j, wf);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float d = hf[e] - mu;
            const float u = gf[e] * wf[e];
            t[0] += d * d;
            t[1] += u;
            t[2] += u * d;
          }
        }
      }
      group_sums<3>(t, red, buf, grp, g, wig, lane);
      rstd = rsqrtf(t[0] * inv_n + eps);
      c1 = t[1] * inv_n;
      c2 = t[2] * rstd * inv_n;  // mean(u * xhat)
    } else {
      float s[2] = {0.f, 0.f};
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int j = (v * g + wig) * 32 + lane;
        if (j < vecs) {
          float hf[8], gf[8], wf[8];
          ptt::load8(rh + 8 * j, hf);
          ptt::load8(rgy + 8 * j, gf);
          ptt::load8(w + 8 * j, wf);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            s[0] += hf[e] * hf[e];
            s[1] += hf[e] * (gf[e] * wf[e]);
          }
        }
      }
      group_sums<2>(s, red, buf, grp, g, wig, lane);
      next();
      rstd = rsqrtf(s[0] * inv_n + eps);
      c2 = rstd * rstd * rstd * (s[1] * inv_n);
    }
    const size_t xbase = (size_t)r * xw;
    const uint32_t idx_row = (uint32_t)r * (uint32_t)hidden;  // wraps as uint32
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int j = (v * g + wig) * 32 + lane;
      if (j >= vecs) continue;
      const int i8 = 8 * j;
      float hf[8], gf[8], wf[8], d[8];
      ptt::load8(rh + i8, hf);
      ptt::load8(rgy + i8, gf);
      ptt::load8(w + i8, wf);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float u = gf[e] * wf[e];
        const float xhat = LAYER ? (hf[e] - mu) * rstd : hf[e] * rstd;
        d[e] = LAYER ? (u - c1 - xhat * c2) * rstd : rstd * u - hf[e] * c2;
        if constexpr (kNarrow) {
          dw[8 * v + e] += gf[e] * xhat;
          if (BIAS) db[8 * v + e] += gf[e];
        } else {
          acc_s[i8 + e] += gf[e] * xhat;
          if (BIAS) acc_s[hidden + i8 + e] += gf[e];
        }
      }
      if (rgh != nullptr) {
        float gr[8];
        ptt::load8(rgh + i8, gr);
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] += gr[e];
      }
      ptt::store8(dres + base + i8, d);
      if (DROP) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t bits = fmix32((idx_row + (uint32_t)(i8 + e)) ^ key);
          d[e] = bits >= threshold ? d[e] * scale : 0.f;
        }
      }
      if (ACT == kGelu) {
        float xv[8];
        ptt::load8(rx + i8, xv);
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] *= gelu_tanh_grad(xv[e]);
        ptt::store8(dx + xbase + i8, d);
      } else if (ACT == kSwiglu) {
        float gg[8], up[8], dg[8], du[8];
        ptt::load8(rx + i8, gg);
        ptt::load8(rx + hidden + i8, up);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float sig = 1.f / (1.f + expf(-gg[e]));
          const float sv = gg[e] * sig;
          dg[e] = d[e] * up[e] * sig * (1.f + gg[e] - sv);
          du[e] = d[e] * sv;
        }
        ptt::store8(dx + xbase + i8, dg);
        ptt::store8(dx + xbase + hidden + i8, du);
      } else {
        ptt::store8(dx + base + i8, d);
      }
    }
  }

  // one partial row a block: [(1 + BIAS)][gridDim.x][hidden]
  float* pw = part + (size_t)blockIdx.x * hidden;
  float* pb = part + ((size_t)gridDim.x + blockIdx.x) * hidden;
  if constexpr (kNarrow) {
    if (ng > 1) {
      // the groups' register partials into the shared row (over the
      // stages, which every group has finished with), in group order
      __syncthreads();
      for (int k = 0; k < ng; ++k) {
        if (grp == k) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int j = (v * g + wig) * 32 + lane;
            if (j < vecs)
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                acc_s[8 * j + e] = (k ? acc_s[8 * j + e] : 0.f) + dw[8 * v + e];
                if (BIAS) acc_s[hidden + 8 * j + e] = (k ? acc_s[hidden + 8 * j + e] : 0.f) + db[8 * v + e];
              }
          }
        }
        __syncthreads();
      }
      for (int j = threadIdx.x; j < vecs; j += blockDim.x) {
        float o[8];
        ptt::load8(acc_s + 8 * j, o);
        ptt::store8(pw + 8 * j, o);
        if (BIAS) {
          ptt::load8(acc_s + hidden + 8 * j, o);
          ptt::store8(pb + 8 * j, o);
        }
      }
      return;
    }
  }
  // one group a block: each lane writes its own columns
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = (v * g + wig) * 32 + lane;
    if (j >= vecs) continue;
    if constexpr (kNarrow) {
      ptt::store8(pw + 8 * j, &dw[8 * v]);
      if (BIAS) ptt::store8(pb + 8 * j, &db[8 * v]);
    } else {
      float o[8];
      ptt::load8(acc_s + 8 * j, o);
      ptt::store8(pw + 8 * j, o);
      if (BIAS) {
        ptt::load8(acc_s + hidden + 8 * j, o);
        ptt::store8(pb + 8 * j, o);
      }
    }
  }
}

// out[c] = sum over b of part[a][b][col] for c = a * hidden + col < cols, in
// a fixed order (norm_rows.cuh `sum_partial_rows`, shared with the RMSNorm
// backward). No atomics: two calls give the same bits.
__global__ void __launch_bounds__(32 * kSumRows)
    block_epilogue_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  int n_blocks, int hidden, int cols) {
  rw::sum_partial_rows<kSumRows>(part, out, n_blocks, hidden, cols);
}

struct BwdArgs {
  const void *h, *x, *w, *gy, *gh;
  void *dx, *dres, *part, *out;
  int rows, hidden;
  float eps;
  uint32_t key, threshold;
  float scale;
};

template <int ACT, bool LAYER, bool BIAS, bool DROP, int V>
int launch_rows(const BwdArgs& a, const BwdPlan& p, cudaStream_t s) {
  auto kern = block_epilogue_bwd_rows_kernel<ACT, LAYER, BIAS, DROP, V>;
  // above 48 KB in all (the static reduction scratch included) only after
  // opting in, once a kernel and device
  if (p.smem + (int)sizeof(float) * 2 * 3 * kMaxGroupWarps > 48 * 1024) {
    const cudaError_t err =
        hp::allow_smem<block_epilogue_bwd_rows_kernel<ACT, LAYER, BIAS, DROP, V>>(kBwdSmemMax);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<p.blocks, p.threads, p.smem, s>>>(
      static_cast<const bf16*>(a.h), static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.w),
      static_cast<const bf16*>(a.gy), static_cast<const bf16*>(a.gh), static_cast<bf16*>(a.dx),
      static_cast<bf16*>(a.dres), static_cast<float*>(a.part), a.rows, p.rows_per_group, a.hidden,
      p.group_warps, a.eps, a.key, a.threshold, a.scale);
  return (int)cudaGetLastError();
}

template <int ACT, bool LAYER, bool BIAS, bool DROP>
int launch_bwd(const BwdArgs& a, const BwdPlan& p, cudaStream_t s) {
  const int err = p.vecs == kNarrowVecs ? launch_rows<ACT, LAYER, BIAS, DROP, kNarrowVecs>(a, p, s)
                                        : launch_rows<ACT, LAYER, BIAS, DROP, kWideVecs>(a, p, s);
  if (err) return err;
  const int cols = (BIAS ? 2 : 1) * a.hidden;
  block_epilogue_bwd_sum_kernel<<<(cols + 31) / 32, 32 * kSumRows, 0, s>>>(
      static_cast<const float*>(a.part), static_cast<float*>(a.out), p.blocks, a.hidden, cols);
  return (int)cudaGetLastError();
}

template <int ACT, bool LAYER, bool BIAS>
int bwd_pick_drop(bool drop, const BwdArgs& a, const BwdPlan& p, cudaStream_t s) {
  return drop ? launch_bwd<ACT, LAYER, BIAS, true>(a, p, s)
              : launch_bwd<ACT, LAYER, BIAS, false>(a, p, s);
}

template <int ACT>
int bwd_pick_norm(int layer, bool bias, bool drop, const BwdArgs& a, const BwdPlan& p,
                  cudaStream_t s) {
  if (!layer) return bwd_pick_drop<ACT, false, false>(drop, a, p, s);
  if (!bias) return bwd_pick_drop<ACT, true, false>(drop, a, p, s);
  return bwd_pick_drop<ACT, true, true>(drop, a, p, s);
}

}  // namespace

// x: [rows, hidden] bf16, or [rows, 2 * hidden] for act 2 (swiglu, gate
// half first); res, y, h: [rows, hidden] bf16; w, b: [hidden] bf16 (b may be
// null, and is null for rms); hidden % 8 == 0, at most rw::kWideHidden. act:
// 0 none, 1 gelu, 2 swiglu; layer: 0 rms, 1 layer norm. drop != 0 applies
// the counter-hash mask with `seed` (the int32 seed's bits), `threshold`
// and `scale`. `plan`: the launch word of block_epilogue.plan
// (norm_rows.cuh); a launch that does not cover every (row, vector) is
// refused.
PTT_EXPORT int ptt_block_epilogue(const void* x, const void* res, const void* w, const void* b,
                                  void* y, void* h, int rows, int hidden, int act, int layer,
                                  int drop, float eps, unsigned int seed, unsigned int threshold,
                                  float scale, long long plan, void* stream) {
  if (rows == 0) return 0;
  const rw::Launch l = rw::decode(plan);
  if (!rw::valid(l, rows, hidden)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FwdArgs a{x, res, w, b, y, h, hidden, eps, (uint32_t)seed * kGolden, threshold, scale};
  switch (act) {
    case kGelu:
      return pick_norm<kGelu>(layer, drop != 0, l, a, s);
    case kSwiglu:
      return pick_norm<kSwiglu>(layer, drop != 0, l, a, s);
    default:
      return pick_norm<kNone>(layer, drop != 0, l, a, s);
  }
}

// The backward: the rows kernel, then the partial-sum kernel. h, gy, dres:
// [rows, hidden] bf16; gh: the same or null; x: [rows, hidden] (act 1) or
// [rows, 2 * hidden] (act 2) bf16, null for act 0; dx: x's shape ([rows,
// hidden] for act 0); w: [hidden] bf16; part: [1 + bias][n_part][hidden] f32
// scratch, n_part the plan's blocks (bwd_plan; anything else is refused);
// out: [1 + bias][hidden] f32, dw then db (db only with has_bias, layer
// norm). hidden % 8 == 0, at most kWideVecs * 256 * kMaxGroupWarps; every
// pointer 16-byte aligned.
PTT_EXPORT int ptt_block_epilogue_bwd(const void* h, const void* x, const void* w, const void* gy,
                                      const void* gh, void* dx, void* dres, void* part, void* out,
                                      int rows, int n_part, int hidden, int act, int layer,
                                      int has_bias, int drop, float eps, unsigned int seed,
                                      unsigned int threshold, float scale, void* stream) {
  if (rows == 0) return 0;
  const bool bias = layer && has_bias;
  const BwdPlan p = bwd_plan(rows, hidden, bias, gh != nullptr);
  if (hidden % 8 || p.group_warps > kMaxGroupWarps || n_part != p.blocks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs a{h,      x,   w,  gy, gh, dx, dres, part, out,
                  rows, hidden, eps, (uint32_t)seed * kGolden, threshold, scale};
  switch (act) {
    case kGelu:
      return bwd_pick_norm<kGelu>(layer, bias, drop != 0, a, p, s);
    case kSwiglu:
      return bwd_pick_norm<kSwiglu>(layer, bias, drop != 0, a, p, s);
    default:
      return bwd_pick_norm<kNone>(layer, bias, drop != 0, a, p, s);
  }
}
