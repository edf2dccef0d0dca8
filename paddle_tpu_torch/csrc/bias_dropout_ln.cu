// Bias + dropout + residual add + layer norm, and its backward, bf16 or f32
// rows, bf16 or f32 vectors, f32 mask, f32 inside.
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
// The TPU kernel carries the sums from one grid step to the next; here
// blocks run in no order, so each block writes one f32 partial row of each
// sum ([3][blocks][H]) and a second small kernel adds them over the blocks
// in a fixed order (no atomics: two calls give the same bits). One C call
// launches both.
//
// Bound on the H100: bytes. Each input row is read once and each output row
// written once; the work is a few dozen operations per element. The plan
// (paddle_tpu_torch/ops/kernels/bias_dropout_ln.py `plan`) picks each launch
// from the shapes alone; the C entries launch exactly that and refuse a plan
// short of what the kernels address. Both kernels read the vectors (bias,
// gamma, beta forward, gamma backward) in their own type, bf16 or f32; the
// wrapper casts none.
//
// * Forward: a block a row, one 8-element vector a thread (H <= 8192, so at
//   most 1024 threads), held in registers between the statistics and the
//   output pass; 16-byte accesses; two block sums. Up to 21 blocks an SM
//   keep ~50-63 warps of rows in flight: as fast as a copy of the same
//   bytes. (A persistent kernel that held the vectors in registers and fed
//   its rows through a ring of bulk copies was slower at every shape timed,
//   from memory and from L2: PERF.md §6.)
// * Backward: a row belongs to a group, 1-32 lanes of one warp (H <= 256,
//   several rows a warp) or whole warps. Lane q of a group of n lanes holds
//   the row's 8-element vectors q (and q + n where V is 2): one vector a
//   lane up to H 6144 (H 768: 3 warps), two past it (H 8192: 16 warps).
//   Mean and the three row sums are shuffles, and a group of several warps
//   adds one partial a warp through shared memory behind a named barrier of
//   its own, never the whole block's. A block of up to 768 threads (512 at
//   two vectors a lane: 80 or 128 registers a thread), one an SM, fills the
//   card once. Group g of the grid's G walks rows g, g + G, g + 2G, ...,
//   with gamma in registers for every row.
// * Its rows arrive by bulk copies: the group's first lane copies the h,
//   dy and mask rows of the group's next row whole (cp.async.bulk, one per
//   operand, on the stage's mbarrier) into the other stage of a ring of
//   two in shared memory, so the next row is in flight while one is
//   reduced and stored, its bytes hold no registers and every copy is one
//   contiguous stream. A stage is copied into again once every warp of the
//   group has passed the first reduction of the row after the one it held.
//   Lanes read their vectors from the stage in each of the three passes
//   (f32 vectors with the words of every other 4 lanes swapped, so no two
//   lanes meet in a bank).
// * dgamma, dbeta and dbias build up in registers across the group's rows;
//   the groups of a warp add theirs by shuffles, the warps (or groups of
//   several warps) of a block in their order through shared memory, and
//   the block writes one partial row of each: 132 rows, 1.2 MB at H 768.
#include "hopper.cuh"

using ptt::bf16;
namespace hp = ptt::hopper;

namespace {

constexpr int kMaxHidden = 8192;
constexpr int kStages = 2;            // rows a backward group has in its ring
constexpr int kSmemMax = 227 * 1024 - 1024;  // dynamic shared memory a block may take
// backward threads a block at most: 768 at one vector a lane (80
// registers), 512 at two (128 registers); one block an SM
template <int V>
constexpr int kMaxThreads = V == 1 ? 768 : 512;
constexpr int kMaxWarps = 24;

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

// one 16-byte word of shared memory, read at this point of the program (so a
// row read in several passes is read again, not held in registers)
__device__ __forceinline__ uint4 lds(const void* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(hp::smem_u32(p)));
  return v;
}

__device__ __forceinline__ void lo_hi(unsigned w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

// vector j of a row of bf16 or f32 values staged in shared memory, as 8 floats
__device__ __forceinline__ void read8(const bf16* row, int j, float* o) {
  const uint4 a = lds(row + 8 * j);
  lo_hi(a.x, o[0], o[1]);
  lo_hi(a.y, o[2], o[3]);
  lo_hi(a.z, o[4], o[5]);
  lo_hi(a.w, o[6], o[7]);
}

// An f32 vector is two 16-byte words, and a warp's lanes 32 bytes apart
// would meet two to a bank: lanes 4-7 of every 8 read their high word first
__device__ __forceinline__ void read8(const float* row, int j, float* o) {
  const bool sw = (j >> 2) & 1;
  const uint4 a = lds(row + 8 * j + (sw ? 4 : 0)), b = lds(row + 8 * j + (sw ? 0 : 4));
  const uint4 lo = sw ? b : a, hi = sw ? a : b;
  o[0] = __uint_as_float(lo.x); o[1] = __uint_as_float(lo.y);
  o[2] = __uint_as_float(lo.z); o[3] = __uint_as_float(lo.w);
  o[4] = __uint_as_float(hi.x); o[5] = __uint_as_float(hi.y);
  o[6] = __uint_as_float(hi.z); o[7] = __uint_as_float(hi.w);
}

// half hf (elements 4 hf .. 4 hf + 3) of vector j of an f32 row in shared
// memory
__device__ __forceinline__ void read4(const float* row, int j, int hf, float* o) {
  const uint4 a = lds(row + 8 * j + 4 * hf);
  o[0] = __uint_as_float(a.x); o[1] = __uint_as_float(a.y);
  o[2] = __uint_as_float(a.z); o[3] = __uint_as_float(a.w);
}

// vector j of a bf16 or f32 vector in device memory, as 8 floats
__device__ __forceinline__ void load_vec(const void* src, bool f32, int j, float* o) {
  if (f32)
    ptt::load8(static_cast<const float*>(src) + 8 * j, o);
  else
    ptt::load8(static_cast<const bf16*>(src) + 8 * j, o);
}

// vectors `bias`, `gamma`, `beta`: f32 (vec_f32) or bf16
template <typename T, bool MASK>
__global__ void bias_dropout_ln_kernel(const T* __restrict__ x, const void* __restrict__ bias,
                                       const T* __restrict__ res, const float* __restrict__ mask,
                                       const void* __restrict__ gamma,
                                       const void* __restrict__ beta, T* __restrict__ y,
                                       T* __restrict__ h_out, int hidden, float eps,
                                       int vec_f32) {
  __shared__ float scratch[1][32];
  const size_t base = (size_t)blockIdx.x * hidden;
  const int j = threadIdx.x;  // this thread's vector
  const int i = j * 8;
  const bool mine = i < hidden;
  const float inv_n = 1.f / (float)hidden;
  float h[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float s[1] = {0.f};
  if (mine) {
    float xv[8], bv[8], rv[8];
    ptt::load8(x + base + i, xv);
    load_vec(bias, vec_f32, j, bv);
    ptt::load8(res + base + i, rv);
    float mv[8];
    if (MASK) ptt::load8(mask + base + i, mv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float v = __fadd_rn(xv[e], bv[e]);
      if (MASK) v = __fmul_rn(v, mv[e]);
      h[e] = __fadd_rn(v, rv[e]);
      s[0] += h[e];
    }
    ptt::store8(h_out + base + i, h);
  }
  block_sums<1>(s, scratch);
  const float mu = s[0] * inv_n;
  float d2[1] = {0.f};
  if (mine) {
#pragma unroll
    for (int e = 0; e < 8; ++e) d2[0] += (h[e] - mu) * (h[e] - mu);
  }
  block_sums<1>(d2, scratch);
  const float rstd = rsqrtf(d2[0] * inv_n + eps);
  if (mine) {
    float gv[8], be[8], o[8];
    load_vec(gamma, vec_f32, j, gv);
    load_vec(beta, vec_f32, j, be);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = (h[e] - mu) * rstd * gv[e] + be[e];
    ptt::store8(y + base + i, o);
  }
}

// This thread's row group: `lanes` lanes of one warp (a power of two) or
// `warps` whole warps; q its lane in the group of n lanes, whose vectors of
// the row are q, q + n, ...
struct Group {
  int lanes, warps, grp, q, n, per_block;
  unsigned mask;
};

__device__ __forceinline__ Group group_of(int lanes, int warps) {
  Group g;
  g.lanes = lanes;
  g.warps = warps;
  g.n = lanes * warps;
  g.per_block = blockDim.x / g.n;
  g.grp = threadIdx.x / g.n;
  g.q = threadIdx.x % g.n;
  const int lane = threadIdx.x & 31;
  g.mask = lanes == 32 ? 0xffffffffu : ((1u << lanes) - 1u) << (lane & ~(lanes - 1));
  return g;
}

// Sums of N values over the group; every lane of it receives the totals.
// A group of several warps adds one partial a warp through `red` behind its
// named barrier (1 + its index). Two buffers are used in turn, so no second
// barrier: a buffer is written again only after every warp of the group has
// passed the next round's barrier, so after it read this round's.
template <int N>
__device__ __forceinline__ void group_sums(float* v, const Group& g, float (*red)[3][kMaxWarps],
                                           int& buf) {
  // the N sums step by step together, so their shuffles overlap
#pragma unroll 1
  for (int o = g.lanes >> 1; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] += __shfl_xor_sync(g.mask, v[k], o);
  if (g.warps == 1) return;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[buf][k][warp] = v[k];
  }
  hp::bar_sync(1 + g.grp, 32 * g.warps);
  const int w0 = g.grp * g.warps;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float t = 0.f;
    for (int i = 0; i < g.warps; ++i) t += red[buf][k][w0 + i];
    v[k] = t;
  }
  buf ^= 1;
}

// The group's rows gi, gi + G, ... below `rows` (G the groups of the grid),
// and its ring: kStages stages of the row operands a and b (type T) and the
// f32 mask, each copied whole by the group's first lane on the stage's
// mbarrier.
template <typename T, bool MASK>
struct Rows {
  int gi, stride, n, hidden;
  unsigned char* ring;  // this group's stages
  uint64_t* bars;       // this group's mbarriers
  const T *a, *b;
  const float* mask;

  __device__ __forceinline__ size_t base(int k) const {
    return (size_t)(gi + (long long)k * stride) * hidden;
  }
  __device__ __forceinline__ unsigned stage_bytes() const {
    return (unsigned)hidden * (2 * sizeof(T) + (MASK ? sizeof(float) : 0));
  }
  __device__ __forceinline__ const T* row_a(int k) const {
    return reinterpret_cast<const T*>(ring + (size_t)(k % kStages) * stage_bytes());
  }
  __device__ __forceinline__ const T* row_b(int k) const { return row_a(k) + hidden; }
  __device__ __forceinline__ const float* row_mask(int k) const {
    return reinterpret_cast<const float*>(row_b(k) + hidden);
  }
  // the group's first lane: row k into its stage
  __device__ __forceinline__ void issue(int k) const {
    uint64_t* bar = bars + k % kStages;
    const size_t at = base(k);
    const unsigned rb = (unsigned)(hidden * sizeof(T));
    hp::mbar_arrive_expect_tx(bar, stage_bytes());
    hp::bulk_load(const_cast<T*>(row_a(k)), a + at, rb, bar);
    hp::bulk_load(const_cast<T*>(row_b(k)), b + at, rb, bar);
    if (MASK) hp::bulk_load(const_cast<float*>(row_mask(k)), mask + at, 4u * hidden, bar);
  }
  __device__ __forceinline__ void wait(int k) const {
    hp::mbar_wait(bars + k % kStages, (unsigned)(k / kStages) & 1u);
  }
};

// The group's rows and ring in `ring_base` (groups x kStages stages) with
// its mbarriers in `bar_base`. The group's first lane initialises them and
// copies the first row; a __syncthreads must follow before any other lane
// waits.
template <typename T, bool MASK>
__device__ __forceinline__ Rows<T, MASK> rows_of(const Group& g, int rows, int hidden,
                                                 unsigned char* ring_base, uint64_t* bar_base,
                                                 const T* a, const T* b, const float* mask) {
  Rows<T, MASK> r;
  r.gi = blockIdx.x * g.per_block + g.grp;
  r.stride = gridDim.x * g.per_block;
  r.n = r.gi < rows ? (rows - 1 - r.gi) / r.stride + 1 : 0;
  r.hidden = hidden;
  r.a = a;
  r.b = b;
  r.mask = mask;
  r.ring = ring_base + (size_t)g.grp * kStages * r.stage_bytes();
  r.bars = bar_base + g.grp * kStages;
  if (g.q == 0) {
    for (int s = 0; s < kStages; ++s) hp::mbar_init(r.bars + s, 1);
    hp::mbar_fence_init();
    if (r.n > 0) r.issue(0);
  }
  return r;
}

// After row k's first reduction (every warp of the group past row k - 1),
// the group's first lane copies row k + 1 into the stage row k - 1 held.
template <typename R>
__device__ __forceinline__ void after_first_sum(const R& rs, const Group& g, int k) {
  if (k + 1 >= rs.n) return;
  if (g.warps == 1) __syncwarp(g.mask);
  if (g.q == 0) rs.issue(k + 1);
}

template <typename T, bool MASK, int V>
__global__ void __launch_bounds__(kMaxThreads<V>, 1)
    bias_dropout_ln_bwd_kernel(const T* __restrict__ h, const float* __restrict__ mask,
                               const void* __restrict__ gamma, const T* __restrict__ dy,
                               T* __restrict__ dx, T* __restrict__ dres, float* __restrict__ part,
                               int rows, int hidden, float eps, int vec_f32, int lanes, int warps,
                               int ring_bytes) {
  // the ring, which the block's three combined partial rows take over at
  // the end, then the ring's mbarriers
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][3][kMaxWarps];
  const int vecs = hidden / 8;
  const Group g = group_of(lanes, warps);
  const Rows<T, MASK> rs = rows_of<T, MASK>(g, rows, hidden, smem,
                                            reinterpret_cast<uint64_t*>(smem + ring_bytes), h, dy,
                                            mask);
  const float inv_n = 1.f / (float)hidden;
  float gv[V][8];  // this lane's gamma, for every row
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = v * g.n + g.q;
    if (j < vecs) load_vec(gamma, vec_f32, j, gv[v]);
  }
  float adg[V][8], adb[V][8], adm[V][8];
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int e = 0; e < 8; ++e) adg[v][e] = adb[v][e] = adm[v][e] = 0.f;
  __syncthreads();  // the mbarriers are initialised
  int buf = 0;
#pragma unroll 1
  for (int k = 0; k < rs.n; ++k) {
    rs.wait(k);
    float s[1] = {0.f};
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int j = v * g.n + g.q;
      if (j < vecs) {
        float hv[8];
        read8(rs.row_a(k), j, hv);
#pragma unroll
        for (int e = 0; e < 8; ++e) s[0] += hv[e];
      }
    }
    group_sums<1>(s, g, red, buf);
    after_first_sum(rs, g, k);
    const float mu = s[0] * inv_n;
    // sum (h - mu)^2, sum u, sum u (h - mu)
    float t[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int j = v * g.n + g.q;
      if (j < vecs) {
        float hv[8], dv[8];
        read8(rs.row_a(k), j, hv);
        read8(rs.row_b(k), j, dv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = hv[e] - mu;
          const float u = dv[e] * gv[v][e];
          t[0] += d * d;
          t[1] += u;
          t[2] += u * d;
        }
      }
    }
    group_sums<3>(t, g, red, buf);
    const float rstd = rsqrtf(t[0] * inv_n + eps);
    const float c1 = t[1] * inv_n;
    const float c2 = t[2] * rstd * inv_n;  // mean(u * xhat)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int j = v * g.n + g.q;
      if (j >= vecs) continue;
      const size_t at = rs.base(k) + 8 * j;
      if constexpr (sizeof(T) == 4) {
        // f32 rows in two halves of 4, so fewer values are live at once
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float hv[4], dv[4], mv[4], o[4], p[4];
          read4(rs.row_a(k), j, hf, hv);
          read4(rs.row_b(k), j, hf, dv);
          if (MASK) read4(rs.row_mask(k), j, hf, mv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float xhat = (hv[e] - mu) * rstd;
            const float dh = (dv[e] * gv[v][4 * hf + e] - c1 - xhat * c2) * rstd;
            const float dm = MASK ? dh * mv[e] : dh;
            o[e] = dh;
            p[e] = dm;
            adg[v][4 * hf + e] += dv[e] * xhat;
            adb[v][4 * hf + e] += dv[e];
            adm[v][4 * hf + e] += dm;
          }
          ptt::store4(dres + at + 4 * hf, o);
          ptt::store4(dx + at + 4 * hf, p);
        }
      } else {
        float hv[8], dv[8], mv[8], o[8], p[8];
        read8(rs.row_a(k), j, hv);
        read8(rs.row_b(k), j, dv);
        if (MASK) read8(rs.row_mask(k), j, mv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xhat = (hv[e] - mu) * rstd;
          const float dh = (dv[e] * gv[v][e] - c1 - xhat * c2) * rstd;
          const float dm = MASK ? dh * mv[e] : dh;
          o[e] = dh;
          p[e] = dm;
          adg[v][e] += dv[e] * xhat;
          adb[v][e] += dv[e];
          adm[v][e] += dm;
        }
        ptt::store8(dres + at, o);
        ptt::store8(dx + at, p);
      }
    }
  }

  // The block's one partial row of each sum. The groups of a warp (lanes <
  // 32) hold the same columns: a butterfly adds them, the same tree each
  // call. Then the units that hold whole rows of columns (a warp, or a group
  // of several warps) add theirs in their order through shared memory.
  if (lanes < 32) {
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        for (int o = lanes; o < 32; o <<= 1) {
          adg[v][e] += __shfl_xor_sync(0xffffffffu, adg[v][e], o);
          adb[v][e] += __shfl_xor_sync(0xffffffffu, adb[v][e], o);
          adm[v][e] += __shfl_xor_sync(0xffffffffu, adm[v][e], o);
        }
  }
  const int unit_threads = warps > 1 ? 32 * warps : 32;
  const int units = blockDim.x / unit_threads;
  const int unit = threadIdx.x / unit_threads;
  // one copy of each column: the first group of a warp of lane groups
  const bool writer = lanes == 32 || (threadIdx.x & 31) < lanes;
  const size_t pstride = (size_t)gridDim.x * hidden;
  float* prow = part + (size_t)blockIdx.x * hidden;
  if (units == 1) {
    if (writer) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int j = v * g.n + g.q;
        if (j < vecs) {
          ptt::store8(prow + 8 * j, adg[v]);
          ptt::store8(prow + pstride + 8 * j, adb[v]);
          ptt::store8(prow + 2 * pstride + 8 * j, adm[v]);
        }
      }
    }
    return;
  }
  float* comb = reinterpret_cast<float*>(smem);  // [3][hidden], over the ring
  __syncthreads();  // every group is done with the ring (every copy waited for)
  for (int u = 0; u < units; ++u) {
    if (unit == u && writer) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int j = v * g.n + g.q;
        if (j < vecs)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float* c = comb + 8 * j + e;
            c[0] = (u ? c[0] : 0.f) + adg[v][e];
            c[hidden] = (u ? c[hidden] : 0.f) + adb[v][e];
            c[2 * hidden] = (u ? c[2 * hidden] : 0.f) + adm[v][e];
          }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 3 * vecs; i += blockDim.x) {
    const int a = i / vecs, j = i % vecs;
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = comb[a * hidden + 8 * j + e];
    ptt::store8(prow + a * pstride + 8 * j, o);
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
#pragma unroll 4
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

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// The forward's block: one vector a thread covering the row, whole warps.
bool valid_fwd(int hidden, int threads) {
  return hidden % 8 == 0 && hidden > 0 && hidden <= kMaxHidden && threads % 32 == 0 &&
         threads <= 1024 && threads * 8 >= hidden;
}

// The backward plan's group holds the row at V vectors a lane (2 only past
// 768 vectors); the threads hold whole groups; a block of groups of several
// warps has a named barrier for each.
bool valid_plan(int hidden, int lanes, int warps, int vpl, int threads, int blocks) {
  if (!pow2(lanes) || lanes > 32 || warps < 1 || (warps > 1 && lanes != 32)) return false;
  if ((vpl != 1 && vpl != 2) || (vpl == 2 && hidden <= 8 * 768)) return false;
  if (blocks < 1 || threads < 32 ||
      threads > (vpl == 1 ? kMaxThreads<1> : kMaxThreads<2>) || threads % 32 ||
      threads % (lanes * warps))
    return false;
  if (warps > 1 && threads / (32 * warps) > 15) return false;
  return lanes * warps * vpl * 8 >= hidden;
}

// the ring's bytes: groups x kStages stages of two rows of the row type and
// the f32 mask
size_t ring_bytes(int hidden, bool f32, bool masked, int groups) {
  return (size_t)groups * kStages * hidden * (2 * (f32 ? 4 : 2) + (masked ? 4 : 0));
}

// above 48 KB in all (the static part included) only after opting in, for
// the largest plan, once a kernel and device
template <auto Kernel>
int opt_in(int smem) {
  if (smem + (int)sizeof(float) * 2 * 3 * kMaxWarps <= 48 * 1024) return 0;
  return (int)hp::allow_smem<Kernel>(kSmemMax);
}

struct Launch {
  int lanes, warps, vpl, threads, blocks, smem, ring;
};

// The backward plan's launch, refused (0 lanes) where it is short of the
// row or of the shared memory the kernel addresses: the ring, or the
// block's three combined rows where they are larger and the block holds
// more than one warp (or group of several warps), then 8 bytes of mbarrier
// a stage.
Launch checked(int rows, int hidden, bool f32, bool masked, int lanes, int warps, int vpl,
               int threads, int blocks, int smem) {
  if (rows < 0 || hidden % 8 || hidden <= 0 || hidden > kMaxHidden || smem > kSmemMax ||
      !valid_plan(hidden, lanes, warps, vpl, threads, blocks))
    return Launch{};
  const int groups = threads / (lanes * warps);
  const size_t ring = ring_bytes(hidden, f32, masked, groups);
  const size_t comb = threads > (warps > 1 ? 32 * warps : 32) ? (size_t)12 * hidden : 0;
  const size_t body = ring > comb ? ring : comb;
  if ((size_t)smem < body + (size_t)groups * kStages * sizeof(uint64_t)) return Launch{};
  return Launch{lanes, warps, vpl, threads, blocks, smem, (int)body};
}

template <typename T, bool MASK>
int fwd(const void* x, const void* bias, const void* res, const void* mask, const void* gamma,
        const void* beta, void* y, void* h, int rows, int hidden, float eps, int vec_f32,
        int threads, cudaStream_t s) {
  bias_dropout_ln_kernel<T, MASK><<<rows, threads, 0, s>>>(
      static_cast<const T*>(x), bias, static_cast<const T*>(res), static_cast<const float*>(mask),
      gamma, beta, static_cast<T*>(y), static_cast<T*>(h), hidden, eps, vec_f32);
  return (int)cudaGetLastError();
}

template <typename T, bool MASK, int V>
int bwd_v(const void* h, const void* mask, const void* gamma, const void* dy, void* dx,
          void* dres, void* part, void* out, int rows, int hidden, float eps, int vec_f32,
          const Launch& l, cudaStream_t s) {
  const int err = opt_in<bias_dropout_ln_bwd_kernel<T, MASK, V>>(l.smem);
  if (err) return err;
  bias_dropout_ln_bwd_kernel<T, MASK, V><<<l.blocks, l.threads, l.smem, s>>>(
      static_cast<const T*>(h), static_cast<const float*>(mask), gamma,
      static_cast<const T*>(dy), static_cast<T*>(dx), static_cast<T*>(dres),
      static_cast<float*>(part), rows, hidden, eps, vec_f32, l.lanes, l.warps, l.ring);
  const int e2 = (int)cudaGetLastError();
  if (e2) return e2;
  bdl_partial_sum_kernel<<<(3 * hidden + 31) / 32, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), l.blocks, hidden);
  return (int)cudaGetLastError();
}

template <typename T, bool MASK>
int bwd(const void* h, const void* mask, const void* gamma, const void* dy, void* dx, void* dres,
        void* part, void* out, int rows, int hidden, float eps, int vec_f32, const Launch& l,
        cudaStream_t s) {
  return l.vpl == 1 ? bwd_v<T, MASK, 1>(h, mask, gamma, dy, dx, dres, part, out, rows, hidden,
                                        eps, vec_f32, l, s)
                    : bwd_v<T, MASK, 2>(h, mask, gamma, dy, dx, dres, part, out, rows, hidden,
                                        eps, vec_f32, l, s);
}

}  // namespace

// x, res, y, h: [rows, hidden] contiguous, f32 (is_f32) or bf16; bias,
// gamma, beta: [hidden], all f32 (vec_f32) or all bf16; mask: [rows,
// hidden] f32 or null (the maskless variant). hidden % 8 == 0, hidden <=
// 8192, 16-byte aligned. The plan (bias_dropout_ln.plan): a block a row of
// `threads` threads, one vector each.
PTT_EXPORT int ptt_bias_dropout_ln(const void* x, const void* bias, const void* res,
                                   const void* mask, const void* gamma, const void* beta, void* y,
                                   void* h, int rows, int hidden, float eps, int is_f32,
                                   int vec_f32, int threads, void* stream) {
  if (rows == 0) return 0;
  if (rows < 0 || !valid_fwd(hidden, threads)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f32)
    return mask ? fwd<float, true>(x, bias, res, mask, gamma, beta, y, h, rows, hidden, eps,
                                   vec_f32, threads, s)
                : fwd<float, false>(x, bias, res, mask, gamma, beta, y, h, rows, hidden, eps,
                                    vec_f32, threads, s);
  return mask ? fwd<bf16, true>(x, bias, res, mask, gamma, beta, y, h, rows, hidden, eps, vec_f32,
                                threads, s)
              : fwd<bf16, false>(x, bias, res, mask, gamma, beta, y, h, rows, hidden, eps,
                                 vec_f32, threads, s);
}

// The backward. h, dy, dx, dres: [rows, hidden] (f32 if is_f32, else bf16);
// mask: [rows, hidden] f32 or null; gamma: [hidden] f32 (vec_f32) or bf16;
// part: scratch of [3][blocks][hidden] f32, one row of each sum a block;
// out: [3][hidden] f32, the sums of dgamma, dbeta and dbias. hidden % 8 ==
// 0, hidden <= 8192. The plan (bias_dropout_ln.plan): a group's lanes and
// warps, vectors a lane, the block's threads, blocks and dynamic shared
// memory.
PTT_EXPORT int ptt_bias_dropout_ln_bwd(const void* h, const void* mask, const void* gamma,
                                       const void* dy, void* dx, void* dres, void* part,
                                       void* out, int rows, int hidden, float eps, int is_f32,
                                       int vec_f32, int lanes, int warps, int vpl, int threads,
                                       int blocks, int smem, void* stream) {
  if (rows == 0) return 0;
  const Launch l = checked(rows, hidden, is_f32, mask != nullptr, lanes, warps, vpl, threads,
                           blocks, smem);
  if (l.lanes == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f32)
    return mask ? bwd<float, true>(h, mask, gamma, dy, dx, dres, part, out, rows, hidden, eps,
                                   vec_f32, l, s)
                : bwd<float, false>(h, mask, gamma, dy, dx, dres, part, out, rows, hidden, eps,
                                    vec_f32, l, s);
  return mask ? bwd<bf16, true>(h, mask, gamma, dy, dx, dres, part, out, rows, hidden, eps,
                                vec_f32, l, s)
              : bwd<bf16, false>(h, mask, gamma, dy, dx, dres, part, out, rows, hidden, eps,
                                 vec_f32, l, s);
}
