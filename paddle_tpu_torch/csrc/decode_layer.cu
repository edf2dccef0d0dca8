// One whole Llama decode layer after QKV/RoPE/KV-write, in one launch.
//
// Replaces paddle_tpu/ops/kernels/decode_layer_pallas.py `_fwd` (kernel body
// `_decode_layer_kernel`). Per batch row b, with every intermediate in f32:
//   o   = attention of q[b] over positions 0..pos[b] of the paged pool
//   h1  = o @ Wo^T + hres[b]
//   y1  = rmsnorm(h1) * w_post
//   z   = silu(y1 @ Wg^T) * (y1 @ Wu^T)       (block_i column chunks)
//   h2  = z @ Wd^T + h1
//   y   = rmsnorm(h2) * w_next                 -> y, h2 cast to bf16 once
// Weights are nn.Linear's [out, in]; nothing is transposed or copied.
//
// Bound on the H100: bytes. At batch 8 a Llama-3-8B layer reads 386 MB of
// bf16 weights (o, gate, up, down) and ~25 MB of keys and values, ~8 flops
// per weight byte read, far below the card's ridge: CUDA-core FMAs suffice.
// The TPU kernel's grid is (row, page) and runs the whole layer tail in one
// grid step per row with the weights resident in VMEM; done that way here,
// each row's block would stream all 386 MB through one SM. Instead one
// persistent cooperative launch, one block per SM, spreads every phase over
// all SMs and separates the phases with grid-wide barriers:
//   1. attention, one (row, query head) unit per block at a time; f32 out
//   2. o_proj + residual -> h1 (32 weight rows per block tile), with each
//      tile's partial sums of h1^2
//   3. the row norms of h1 from those partials (every block, in a fixed
//      order: no float atomics), then gate/up + SiLU*up -> z; block_i
//      columns per work item, the items dealt to the blocks in turn
//   4. down + residual -> h2, with partial sums of h2^2
//   5. the second norm, one row per block, writing y and h.
// Blocks are 16 warps, so that memory loads and arithmetic overlap across
// warps. The matrix-vector phases give each warp 2 weight rows at a time and
// stream them in 16-byte loads (a row is contiguous in [out, in]) against
// up to 8 activation rows staged in shared memory (4096 columns at a time),
// so each weight byte is read from device memory once per 8 batch rows and
// every staged activation is reused by the block's rows. A warp keeps the
// next step's weight loads in flight while it computes the current one,
// across row and tile boundaries too. Every sum is taken in a fixed order
// (per-lane chunks, a shuffle tree, warps in index order), so two calls on
// the same inputs give identical bits.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using ptt::bf16;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2;                      // weight rows a warp streams at once
constexpr int kTileRows = kWarps * kRows;     // weight rows of an o_proj / down tile
constexpr int kGroupB = 8;                    // batch rows per pass of phases 2-4
constexpr int kKT = 4096;                     // activation columns staged at a time
constexpr int kStageFloats = kGroupB * kKT;   // 128 KB of shared memory
constexpr int kChunks = 2;                    // 8-element chunks per lane per step
constexpr int kStep = 32 * kChunks;           // chunks a warp covers per step
constexpr int kStageBatch = 8;                // staging loads in flight per thread
constexpr int kLanesPerPos = 8;               // attention: lanes sharing one position
constexpr int kGroups = kThreads / kLanesPerPos;  // attention: position streams per block
constexpr int kPosPerIter = 2;                // attention: positions per stream per iteration
constexpr int kTableOffset = 4096;            // attention: page ids after the merge area
constexpr int kMaxBatch = 16;
constexpr int kMaxDevices = 16;
constexpr float kNegInf = -1e30f;

struct Params {
  const bf16* q;       // [B, H, D]
  const bf16* k;       // [P, Hkv, ps, D] one layer's pool slice
  const bf16* v;
  const int* tables;   // [B, max_pages]
  const int* pos;      // [B]
  const bf16* hres;    // [B, hidden]
  const bf16* wo;      // [hidden, H*D]
  const bf16* w_post;  // [hidden]
  const bf16* wg;      // [inter, hidden]
  const bf16* wu;      // [inter, hidden]
  const bf16* wd;      // [hidden, inter]
  const bf16* w_next;  // [hidden]
  bf16* y;             // [B, hidden]
  bf16* h;             // [B, hidden]
  float* attn;         // [B, H*D]   f32 scratch
  float* h1;           // [B, hidden]
  float* z;            // [B, inter]
  float* h2;           // [B, hidden]
  float* ss1;          // [tiles, B] partial sums of h1^2 (tiles = hidden / 32)
  float* ss2;          // [tiles, B] partial sums of h2^2
  unsigned long long* stamps;  // nullptr, or 6 globaltimer readings (ns)
  int batch, h_kv, rep, page_size, max_pages, hidden, inter, block_i;
  float eps_post, eps_next, scale;
};

__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void stamp(const Params& p, int i) {
  if (p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.stamps[i] = t;
  }
}

// ---- phase 1: attention of one (row b, query head hh) ----------------------
// Groups of 8 lanes own key positions, each lane D / 8 elements of them; the
// 64 groups stride over positions 0..pos[b], each taking kPosPerIter
// positions per iteration (all their loads issued before any arithmetic),
// with an f32 online softmax each, merged by shuffles within a warp and
// through shared memory across warps (mmha.cu's scheme, one query row per
// unit). The row's page ids are read into shared memory first, so no key
// load waits on a table load.
template <int D>
__device__ void attend_unit(const Params& p, int b, int hh, float* sm) {
  constexpr int E = D / kLanesPerPos;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % kLanesPerPos;
  const int grp = threadIdx.x / kLanesPerPos;
  const int heads = p.h_kv * p.rep;
  const int g = hh / p.rep;
  const int p_last = p.pos[b];
  const int t_cap = p.max_pages * p.page_size;

  int* table = reinterpret_cast<int*>(sm + kTableOffset);
  const int n_tab = min(p_last / p.page_size + 1, p.max_pages);
  for (int i = threadIdx.x; i < n_tab; i += kThreads)
    table[i] = p.tables[(size_t)b * p.max_pages + i];
  __syncthreads();

  float qr[E];
#pragma unroll
  for (int c = 0; c < E / 8; ++c)
    ptt::load8(p.q + ((size_t)b * heads + hh) * D + sub * E + 8 * c, qr + 8 * c);
#pragma unroll
  for (int e = 0; e < E; ++e) qr[e] *= p.scale;

  float m = kNegInf, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  // the trip count is uniform over the block (the shuffles need every lane)
  constexpr int kPerIter = kGroups * kPosPerIter;
  const int n_iter = (p_last + kPerIter) / kPerIter;
  for (int it = 0; it < n_iter; ++it) {
    uint4 kraw[kPosPerIter][E / 8], vraw[kPosPerIter][E / 8];
    bool valid[kPosPerIter];
#pragma unroll
    for (int j = 0; j < kPosPerIter; ++j) {
      const int t = (it * kPosPerIter + j) * kGroups + grp;
      valid[j] = t <= p_last && t < t_cap;
      const size_t off =
          valid[j] ? (((size_t)table[t / p.page_size] * p.h_kv + g) * p.page_size +
                      (t % p.page_size)) * D + sub * E
                   : 0;
#pragma unroll
      for (int c = 0; c < E / 8; ++c) {
        kraw[j][c] = valid[j] ? *reinterpret_cast<const uint4*>(p.k + off + 8 * c)
                              : make_uint4(0u, 0u, 0u, 0u);
        vraw[j][c] = valid[j] ? *reinterpret_cast<const uint4*>(p.v + off + 8 * c)
                              : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int j = 0; j < kPosPerIter; ++j) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < E / 8; ++c) {
        float kf[8];
        unpack8(kraw[j][c], kf);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += qr[8 * c + e] * kf[e];
      }
#pragma unroll
      for (int o = 1; o < kLanesPerPos; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (valid[j]) {
        const float m_new = fmaxf(m, s);
        const float alpha = __expf(m - m_new);
        const float pr = __expf(s - m_new);
        l = l * alpha + pr;
#pragma unroll
        for (int c = 0; c < E / 8; ++c) {
          float vf[8];
          unpack8(vraw[j][c], vf);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[8 * c + e] = acc[8 * c + e] * alpha + pr * vf[e];
        }
        m = m_new;
      }
    }
  }
  // merge the 4 groups of each warp (lanes with the same `sub` hold the
  // same D slice)
#pragma unroll
  for (int o = kLanesPerPos; o < 32; o <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, o);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, o);
    const float m_new = fmaxf(m, m_o);
    const float a = __expf(m - m_new);
    const float c = __expf(m_o - m_new);
    l = l * a + l_o * c;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float acc_o = __shfl_xor_sync(0xffffffffu, acc[e], o);
      acc[e] = acc[e] * a + acc_o * c;
    }
    m = m_new;
  }
  // merge the warps through shared memory: sm = m[kWarps], l[kWarps],
  // acc[kWarps][D]
  float* sm_m = sm;
  float* sm_l = sm + kWarps;
  float* sm_acc = sm + 2 * kWarps;
  if (lane < kLanesPerPos) {
    if (lane == 0) {
      sm_m[warp] = m;
      sm_l[warp] = l;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp * D + sub * E + e] = acc[e];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
    float l_sum = 0.f, a_sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = __expf(sm_m[w] - mx);
      l_sum += sm_l[w] * c;
      a_sum += sm_acc[w * D + d] * c;
    }
    p.attn[((size_t)b * heads + hh) * D + d] = a_sum / fmaxf(l_sum, 1e-30f);
  }
  __syncthreads();  // the next unit reuses the shared memory
}

// ---- phases 2-4: weight rows times up to 8 activation rows -----------------
// The activation tile holds kKT columns of each staged batch row, each row
// split in halves: element 8c + e (e < 4) of the tile at [c * 4 + e],
// element 8c + 4 + e at [kKT / 2 + c * 4 + e]. A lane reading chunk c then
// loads two float4 at a 16-byte stride across the warp, free of bank
// conflicts.
using Step = uint4[kChunks][kRows];

__device__ __forceinline__ void load_step(const bf16* const (&w)[kRows], int k, int K, Step& s) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int kc = k + 256 * c;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      s[c][r] = (w[r] != nullptr && kc < K) ? __ldg(reinterpret_cast<const uint4*>(w[r] + kc))
                                            : make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void fma_step(const Step& s, const float* xs, int chunk, int nb,
                                         float (&acc)[kRows][kGroupB]) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int cs = chunk + 32 * c;
    float wf[kRows][8];
#pragma unroll
    for (int r = 0; r < kRows; ++r) unpack8(s[c][r], wf[r]);
#pragma unroll
    for (int b = 0; b < kGroupB; ++b) {
      if (b < nb) {
        const float4 x0 = ld4(xs + b * kKT + cs * 4);
        const float4 x1 = ld4(xs + b * kKT + kKT / 2 + cs * 4);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float a = acc[r][b];
          a = fmaf(wf[r][0], x0.x, a);
          a = fmaf(wf[r][1], x0.y, a);
          a = fmaf(wf[r][2], x0.z, a);
          a = fmaf(wf[r][3], x0.w, a);
          a = fmaf(wf[r][4], x1.x, a);
          a = fmaf(wf[r][5], x1.y, a);
          a = fmaf(wf[r][6], x1.z, a);
          a = fmaf(wf[r][7], x1.w, a);
          acc[r][b] = a;
        }
      }
    }
  }
}

// Stage columns [k0, k0 + kKT) of nb activation rows into xs: src(b, k)
// returns X[b][k..k+3] as a float4 (zeros past K); kStageBatch loads in
// flight per thread before their stores.
template <class Src>
__device__ void stage_tile(int k0, int K, int nb, float* xs, Src src) {
  const int total = nb * (kKT / 4);
  for (int i0 = threadIdx.x; i0 < total; i0 += kThreads * kStageBatch) {
    float4 v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * kThreads;
      const int k = k0 + 4 * (i % (kKT / 4));
      v[u] = i < total && k < K ? src(i / (kKT / 4), k) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * kThreads;
      const int b = i / (kKT / 4);
      const int j = i % (kKT / 4);  // float4 index within the row's tile
      if (i < total)
        *reinterpret_cast<float4*>(xs + b * kKT + (j & 1) * (kKT / 2) + (j >> 1) * 4) = v[u];
    }
  }
}

// A warp's sequence of n_units units of kRows weight rows, each dotted with
// the nb staged activation rows over K columns. rows(u, w) names unit u's
// rows (nullptr past the end); finish(u, acc) takes the sums (every lane
// holds them). Units run in lockstep over the block's warps: every warp
// calls this with the same n_units, K and nb, since staging a new column
// tile holds block barriers (`staged` is the staged tile's first column,
// -1 for none; it is skipped when K fits one tile already staged). The
// next step's weight loads are issued before the current step's
// arithmetic, also across unit and tile boundaries.
template <class Rows, class Src, class Finish>
__device__ void stream_units(int n_units, int K, int nb, float* xs, int& staged, Rows rows,
                             Src src, Finish finish) {
  const int lane = threadIdx.x & 31;
  const int n_kt = (K + kKT - 1) / kKT;
  const int n_seg = n_units * n_kt;
  if (n_seg == 0) return;
  const bf16* w[kRows];
  rows(0, w);
  float acc[kRows][kGroupB];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int b = 0; b < kGroupB; ++b) acc[r][b] = 0.f;
  Step cur, nxt;
  load_step(w, lane * 8, K, cur);
  for (int sg = 0; sg < n_seg; ++sg) {
    const int unit = sg / n_kt;
    const int k0 = (sg % n_kt) * kKT;
    if (staged != k0) {
      __syncthreads();  // every warp is done reading the previous tile
      stage_tile(k0, K, nb, xs, src);
      __syncthreads();
      staged = k0;
    }
    const bool more = sg + 1 < n_seg;
    const int unit_n = (sg + 1) / n_kt;
    const int k0_n = ((sg + 1) % n_kt) * kKT;
    const bf16* wn[kRows];
    if (more && unit_n != unit) {
      rows(unit_n, wn);
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) wn[r] = w[r];
    }
    const int n_steps = (min(kKT, K - k0) / 8 + kStep - 1) / kStep;
#pragma unroll 1
    for (int st = 0; st < n_steps; ++st) {
      if (st + 1 < n_steps)
        load_step(w, k0 + ((st + 1) * kStep + lane) * 8, K, nxt);
      else if (more)
        load_step(wn, k0_n + lane * 8, K, nxt);
      fma_step(cur, xs, st * kStep + lane, nb, acc);
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int r = 0; r < kRows; ++r) cur[c][r] = nxt[c][r];
    }
    if (!more || unit_n != unit) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int b = 0; b < kGroupB; ++b) {
          acc[r][b] = ptt::warp_sum(acc[r][b]);
        }
      finish(unit, acc);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int b = 0; b < kGroupB; ++b) acc[r][b] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) w[r] = wn[r];
  }
}

// Epilogue of an o_proj / down tile for batch rows b0.. (nb of them):
// out[b][n] = acc[r][b] + res(i) for the warp's rows n0.., and the tile's
// partial sums of out^2 per batch row into ss[tile * batch + b] (warps
// added in index order; no atomics). Holds a block barrier.
template <class Res>
__device__ void tile_epilogue(const float (&acc)[kRows][kGroupB], int n0, int n_rows, int b0,
                              int nb, int batch, int tile, float* out, Res res, float* ss,
                              float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float sq[kGroupB];
#pragma unroll
  for (int b = 0; b < kGroupB; ++b) {
    sq[b] = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (b < nb && n0 + r < n_rows) {
        const size_t i = (size_t)(b0 + b) * n_rows + n0 + r;
        const float v = acc[r][b] + res(i);
        if (lane == 0) out[i] = v;
        sq[b] = fmaf(v, v, sq[b]);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int b = 0; b < kGroupB; ++b) red[warp * kGroupB + b] = sq[b];
  }
  __syncthreads();
  if (threadIdx.x < nb) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w * kGroupB + threadIdx.x];
    ss[(size_t)tile * batch + b0 + threadIdx.x] = t;
  }
  __syncthreads();
}

// rstd[j] = 1 / sqrt(sum of the n_tiles partials of row b0 + j / K + eps)
// for j < n: a fixed order (a thread per tile, a shuffle tree, warps in
// index order). `red` holds kWarps * kMaxBatch floats.
__device__ void rstd_from_partials(const float* ss, int n_tiles, int batch, int b0, int n, int K,
                                   float eps, float* red, float* rstd) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float part[kMaxBatch];
#pragma unroll
  for (int j = 0; j < kMaxBatch; ++j) part[j] = 0.f;
  for (int t = threadIdx.x; t < n_tiles; t += kThreads) {
#pragma unroll
    for (int j = 0; j < kMaxBatch; ++j)
      if (j < n) part[j] += ss[(size_t)t * batch + b0 + j];
  }
#pragma unroll
  for (int j = 0; j < kMaxBatch; ++j) {
    const float v = ptt::warp_sum(part[j]);
    if (lane == 0 && j < n) red[warp * kMaxBatch + j] = v;
  }
  __syncthreads();
  if (threadIdx.x < n) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w * kMaxBatch + threadIdx.x];
    rstd[threadIdx.x] = rsqrtf(t / (float)K + eps);
  }
  __syncthreads();
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) decode_layer_kernel(const Params p) {
  extern __shared__ float4 smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [kGroupB * kKT] activation tile
  float* red = xs + kStageFloats;                  // [kWarps * kMaxBatch]
  float* rstd = red + kWarps * kMaxBatch;          // [kMaxBatch]
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5;
  const int batch = p.batch;
  const int heads = p.h_kv * p.rep;
  const int hd_in = heads * D;  // o_proj's input width
  const int hidden = p.hidden;
  const int inter = p.inter;
  const int n_tiles = (hidden + kTileRows - 1) / kTileRows;  // o_proj / down tiles
  // this block's o_proj / down tiles: blockIdx.x, + gridDim.x, ...
  const int my_tiles = blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto tile_rows = [&](const bf16* w, int K) {
    return [=](int u, const bf16* (&rows)[kRows]) {
      const int n0 = (blockIdx.x + u * gridDim.x) * kTileRows + warp * kRows;
#pragma unroll
      for (int r = 0; r < kRows; ++r) rows[r] = n0 + r < hidden ? w + (size_t)(n0 + r) * K : nullptr;
    };
  };

  // 1. attention -> attn [B, H*D]
  stamp(p, 0);
  for (int u = blockIdx.x; u < batch * heads; u += gridDim.x)
    attend_unit<D>(p, u / heads, u % heads, xs);
  grid.sync();
  stamp(p, 1);

  // 2. o_proj + residual -> h1, in passes of up to 8 batch rows
  for (int b0 = 0; b0 < batch; b0 += kGroupB) {
    const int nb = min(kGroupB, batch - b0);
    int staged = -1;
    stream_units(
        my_tiles, hd_in, nb, xs, staged, tile_rows(p.wo, hd_in),
        [&](int b, int k) { return ld4(p.attn + (size_t)(b0 + b) * hd_in + k); },
        [&](int u, const float(&acc)[kRows][kGroupB]) {
          const int tile = blockIdx.x + u * gridDim.x;
          tile_epilogue(acc, tile * kTileRows + warp * kRows, hidden, b0, nb, batch, tile, p.h1,
                        [&](size_t i) { return __bfloat162float(p.hres[i]); }, p.ss1, red);
        });
  }
  grid.sync();
  stamp(p, 2);

  // 3. y1 = rmsnorm(h1) * w_post, then z = silu(y1 Wg^T) * (y1 Wu^T). Work
  //    items of block_i columns go to the blocks in turn; in an item, the
  //    warps take kCols columns (their gate and up rows) in turn.
  rstd_from_partials(p.ss1, n_tiles, batch, 0, batch, hidden, p.eps_post, red, rstd);
  {
    constexpr int kCols = kRows / 2;
    const int n_chunks = inter / p.block_i;
    const int my_chunks =
        blockIdx.x < n_chunks ? (n_chunks - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    const int groups = p.block_i / kCols;                 // column groups per item
    const int slots = (groups + kWarps - 1) / kWarps;     // groups per warp per item
    auto col = [&](int u) {  // first column of unit u, or -1
      const int chunk = blockIdx.x + (u / slots) * gridDim.x;
      const int grp = (u % slots) * kWarps + warp;
      return grp < groups ? chunk * p.block_i + kCols * grp : -1;
    };
    for (int b0 = 0; b0 < batch; b0 += kGroupB) {
      const int nb = min(kGroupB, batch - b0);
      int staged = -1;
      stream_units(
          my_chunks * slots, hidden, nb, xs, staged,
          [&](int u, const bf16* (&rows)[kRows]) {
            const int c = col(u);
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
              rows[j] = c >= 0 ? p.wg + (size_t)(c + j) * hidden : nullptr;
              rows[kCols + j] = c >= 0 ? p.wu + (size_t)(c + j) * hidden : nullptr;
            }
          },
          [&](int b, int k) {
            const float4 x = ld4(p.h1 + (size_t)(b0 + b) * hidden + k);
            const uint2 raw = *reinterpret_cast<const uint2*>(p.w_post + k);
            const float2 w01 =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
            const float2 w23 =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
            const float r = rstd[b0 + b];
            return make_float4(x.x * r * w01.x, x.y * r * w01.y, x.z * r * w23.x,
                               x.w * r * w23.y);
          },
          [&](int u, const float(&acc)[kRows][kGroupB]) {
            const int c = col(u);
            if (c < 0 || (threadIdx.x & 31) != 0) return;
#pragma unroll
            for (int j = 0; j < kCols; ++j)
#pragma unroll
              for (int b = 0; b < kGroupB; ++b)
                if (b < nb) {
                  const float gt = acc[j][b];
                  p.z[(size_t)(b0 + b) * inter + c + j] =
                      gt / (1.f + expf(-gt)) * acc[kCols + j][b];
                }
          });
    }
  }
  grid.sync();
  stamp(p, 3);

  // 4. down + residual -> h2
  for (int b0 = 0; b0 < batch; b0 += kGroupB) {
    const int nb = min(kGroupB, batch - b0);
    int staged = -1;
    stream_units(
        my_tiles, inter, nb, xs, staged, tile_rows(p.wd, inter),
        [&](int b, int k) { return ld4(p.z + (size_t)(b0 + b) * inter + k); },
        [&](int u, const float(&acc)[kRows][kGroupB]) {
          const int tile = blockIdx.x + u * gridDim.x;
          tile_epilogue(acc, tile * kTileRows + warp * kRows, hidden, b0, nb, batch, tile, p.h2,
                        [&](size_t i) { return p.h1[i]; }, p.ss2, red);
        });
  }
  grid.sync();
  stamp(p, 4);

  // 5. y = rmsnorm(h2) * w_next, h = h2, cast once
  for (int b = blockIdx.x; b < batch; b += gridDim.x) {
    rstd_from_partials(p.ss2, n_tiles, batch, b, 1, hidden, p.eps_next, red, rstd);
    const float r = rstd[0];
    const size_t base = (size_t)b * hidden;
    for (int k = threadIdx.x; k < hidden; k += kThreads) {
      const float v = p.h2[base + k];
      p.y[base + k] = __float2bfloat16(v * r * __bfloat162float(p.w_next[k]));
      p.h[base + k] = __float2bfloat16(v);
    }
  }
  stamp(p, 5);
}

template <int D>
int launch(const Params& p, cudaStream_t stream) {
  static_assert(kWarps * (2 + D) <= kTableOffset, "attention merge must fit below the page ids");
  auto kern = decode_layer_kernel<D>;
  const size_t smem = (kStageFloats + kWarps * kMaxBatch + kMaxBatch) * sizeof(float);
  static int grid_of[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int grid = dev < kMaxDevices ? grid_of[dev] : 0;
  if (grid == 0) {
    // the dynamic-shared-memory attribute must be set before the
    // occupancy query, or the query reads the 48 KB default
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    // one block per SM (the 128 KB activation tile allows no second one)
    grid = sms;
    if (dev < kMaxDevices) grid_of[dev] = grid;
  }
  Params args = p;
  void* argv[] = {&args};
  // a grid larger than what can be co-resident is refused here with an
  // error (never a hang); the caller raises on it
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(grid), dim3(kThreads),
                                  argv, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// q: [batch, h_kv * rep, head_dim] bf16 (after RoPE); k, v: one layer's pool
// [pages, h_kv, page_size, head_dim] bf16 with the current token written;
// tables: [batch, max_pages] int32; pos: [batch] int32; hres: [batch,
// hidden] bf16; wo: [hidden, h_kv * rep * head_dim]; w_post, w_next:
// [hidden]; wg, wu: [inter, hidden]; wd: [hidden, inter]; all bf16. y, h:
// [batch, hidden] bf16 outputs. scratch: f32, ptt_decode_layer_scratch()
// floats. head_dim in {64, 128}; batch in 1..16; hidden, inter and block_i
// multiples of 8 with inter % block_i == 0.
// stamps: nullptr, or 6 uint64 that receive the device clock (ns) at the
// start, after each of the four grid barriers and at the end of block 0's
// last phase (the phase breakdown of a call).
PTT_EXPORT int ptt_decode_layer(const void* q, const void* k, const void* v, const void* tables,
                                const void* pos, const void* hres, const void* wo,
                                const void* w_post, const void* wg, const void* wu,
                                const void* wd, const void* w_next, void* y, void* h,
                                void* scratch, int batch, int h_kv, int rep, int head_dim,
                                int page_size, int max_pages, int hidden, int inter, int block_i,
                                float eps_post, float eps_next, void* stamps, void* stream) {
  if (batch == 0) return 0;
  if (batch < 0 || batch > kMaxBatch || hidden % 8 || inter % 8 || block_i <= 0 ||
      block_i % 8 || inter % block_i || (h_kv * rep * head_dim) % 8 ||
      max_pages > kStageFloats - kTableOffset)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.tables = static_cast<const int*>(tables);
  p.pos = static_cast<const int*>(pos);
  p.hres = static_cast<const bf16*>(hres);
  p.wo = static_cast<const bf16*>(wo);
  p.w_post = static_cast<const bf16*>(w_post);
  p.wg = static_cast<const bf16*>(wg);
  p.wu = static_cast<const bf16*>(wu);
  p.wd = static_cast<const bf16*>(wd);
  p.w_next = static_cast<const bf16*>(w_next);
  p.y = static_cast<bf16*>(y);
  p.h = static_cast<bf16*>(h);
  const size_t hd_in = (size_t)h_kv * rep * head_dim;
  const size_t n_tiles = (hidden + kTileRows - 1) / kTileRows;
  p.attn = static_cast<float*>(scratch);
  p.h1 = p.attn + batch * hd_in;
  p.z = p.h1 + (size_t)batch * hidden;
  p.h2 = p.z + (size_t)batch * inter;
  p.ss1 = p.h2 + (size_t)batch * hidden;
  p.ss2 = p.ss1 + n_tiles * batch;
  p.stamps = static_cast<unsigned long long*>(stamps);
  p.batch = batch;
  p.h_kv = h_kv;
  p.rep = rep;
  p.page_size = page_size;
  p.max_pages = max_pages;
  p.hidden = hidden;
  p.inter = inter;
  p.block_i = block_i;
  p.eps_post = eps_post;
  p.eps_next = eps_next;
  p.scale = 1.f / sqrtf((float)head_dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch<64>(p, s);
    case 128: return launch<128>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Floats of f32 scratch ptt_decode_layer needs: the attention output, h1,
// z, h2 and two [hidden / 32, batch] partial-sum arrays.
PTT_EXPORT int ptt_decode_layer_scratch(int batch, int hd_in, int hidden, int inter) {
  const int n_tiles = (hidden + kTileRows - 1) / kTileRows;
  return batch * (hd_in + 2 * hidden + inter + 2 * n_tiles);
}
