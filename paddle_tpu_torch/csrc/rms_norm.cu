// RMSNorm with an optional residual add, bf16 in and out, f32 inside, and
// its backward.
//
// Forward: replaces paddle_tpu/ops/kernels/rms_norm_pallas.py `_fused_fwd`
// (kernel bodies `_fwd_plain_kernel` / `_fwd_res_kernel`). Computes
//   h = x (+ res);  y = h * rsqrt(mean(h^2) + eps) * w
// with h kept in f32 and y cast once, and writes h (cast) when a residual
// is given.
//
// Bound on the H100: bytes. Each row is read once (x, res) and written once
// (y, h); the work is a few operations per element. Design (csrc/
// norm_rows.cuh, shared with the block epilogue's forward; the plan is
// paddle_tpu_torch/ops/kernels/rms_norm.py `plan`): a row in the registers
// of its block, one 8-element vector a thread, w, x and res all requested
// before the one reduction, so a row costs one memory round trip (w read
// after the block-wide sum would put a second one in each row's chain).
// Rows past 8192 keep the f32 row in shared memory between the two passes.
//
// Backward: replaces rms_norm_pallas.py `_fused_bwd` (kernel body
// `_bwd_kernel`). From the saved pre-norm h (x when there was no residual)
// and the output cotangent g it recomputes rstd and writes
//   u = g * w;  dx = rstd * u - h * rstd^3 * (sum(h * u) / H)  (+ g_h)
// where g_h, the cotangent of the returned residual sum, joins dx in f32
// before the one rounding to bf16; and
//   dw = sum over rows of g * h * rstd
// in w's dtype. Bound on the H100: bytes — h and g (and g_h) read once, dx
// written once. Design (csrc/norm_rows.cuh's group sums and partial-row
// sum, shared with the block-epilogue backward): a group of warps owns a
// row, two 16-byte vectors a lane, and walks a strip of consecutive rows;
// w stays in registers across the strip, and the row's h, g and g_h are
// all requested before its one reduction (sum h^2 and sum h * u, by
// shuffles and the group's named barrier), so a row costs one memory round
// trip and none of it waits on the row before: a bulk-copy ring keeps the
// group's next rows landing in shared memory while one is reduced, one
// block an SM. dw builds up in registers
// across the strip; each block writes one f32 partial row and
// rms_norm_bwd_sum_kernel adds the rows column by column in a fixed order
// and writes dw in bf16: no atomics, the same bits every call, and no
// library launch after the kernels.
#include "norm_rows.cuh"

using ptt::bf16;
namespace hp = ptt::hopper;
namespace rw = ptt::rows;

// kRow: block b takes row b, thread t its vector t.
template <bool RES>
__device__ __forceinline__ void rms_row(const bf16* __restrict__ x, const bf16* __restrict__ res,
                                        const bf16* __restrict__ w, bf16* __restrict__ y,
                                        bf16* __restrict__ h_out, int hidden, float eps) {
  __shared__ float red[2][32];
  const int col = threadIdx.x * 8;
  const bool mine = col < hidden;
  const size_t base = (size_t)blockIdx.x * hidden + col;
  uint4 wv = {}, xv = {}, rv = {};
  if (mine) {
    wv = rw::ld16(w + col);
    xv = rw::ld16(x + base);
    if (RES) rv = rw::ld16(res + base);
  }
  float h[8];
  rw::unpack8(xv, h);
  if (RES) {
    float rf[8];
    rw::unpack8(rv, rf);
#pragma unroll
    for (int e = 0; e < 8; ++e) h[e] += rf[e];
    if (mine) ptt::store8(h_out + base, h);
  }
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) ss += h[e] * h[e];
  int buf = 0;
  const float rstd = rsqrtf(rw::block_total(ss, red, buf) / (float)hidden + eps);
  if (mine) {
    float wf[8];
    rw::unpack8(wv, wf);
#pragma unroll
    for (int e = 0; e < 8; ++e) h[e] = h[e] * rstd * wf[e];
    ptt::store8(y + base, h);
  }
}

// kWide, rows past kRegHidden: a block a row, each thread striding over it
// in 16-byte vectors, the f32 row in dynamic shared memory for the second
// pass, so no input is read twice from device memory.
template <bool RES>
__device__ __forceinline__ void rms_wide(const bf16* __restrict__ x, const bf16* __restrict__ res,
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

// ARM: rw::kRow or kWide. Both keep to 32 registers, so four blocks of 512
// threads (H 4096) share an SM.
template <bool RES, int ARM>
__global__ void __launch_bounds__(rw::kMaxThreads, 2)
    rms_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
                    const bf16* __restrict__ w, bf16* __restrict__ y, bf16* __restrict__ h_out,
                    int hidden, float eps) {
  if constexpr (ARM == rw::kWide)
    rms_wide<RES>(x, res, w, y, h_out, hidden, eps);
  else
    rms_row<RES>(x, res, w, y, h_out, hidden, eps);
}

namespace {

template <bool RES, int ARM>
int launch_arm(const rw::Launch& l, const void* x, const void* res, const void* w, void* y,
               void* h, int hidden, float eps, cudaStream_t s) {
  size_t smem = 0;
  if (ARM == rw::kWide) {
    smem = (size_t)hidden * sizeof(float);
    // above 48 KB in all (the static scratch included) only after opting in
    if (smem + rw::kWideStatic > 48 * 1024) {
      const cudaError_t err =
          ptt::hopper::allow_smem<rms_norm_kernel<RES, rw::kWide>>(rw::kWideSmem);
      if (err != cudaSuccess) return (int)err;
    }
  }
  return rw::launch<rms_norm_kernel<RES, ARM>>(
      l, smem, s, static_cast<const bf16*>(x), static_cast<const bf16*>(res),
      static_cast<const bf16*>(w), static_cast<bf16*>(y), static_cast<bf16*>(h), hidden, eps);
}

template <bool RES>
int launch_fwd(const rw::Launch& l, const void* x, const void* res, const void* w, void* y,
               void* h, int hidden, float eps, cudaStream_t s) {
  return l.arm == rw::kWide ? launch_arm<RES, rw::kWide>(l, x, res, w, y, h, hidden, eps, s)
                            : launch_arm<RES, rw::kRow>(l, x, res, w, y, h, hidden, eps, s);
}

}  // namespace

// x, res, y, h: [rows, hidden] bf16 (res and h may be null together);
// w: [hidden] bf16; hidden % 8 == 0, at most rw::kWideHidden (the wide
// arm's f32 row in shared memory). `plan`: the launch word of rms_norm.plan
// (norm_rows.cuh); a launch that does not cover every (row, vector) is
// refused.
PTT_EXPORT int ptt_rms_norm(const void* x, const void* res, const void* w, void* y, void* h,
                            int rows, int hidden, float eps, long long plan, void* stream) {
  if (rows == 0) return 0;
  const rw::Launch l = rw::decode(plan);
  if (!rw::valid(l, rows, hidden))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return res != nullptr ? launch_fwd<true>(l, x, res, w, y, h, hidden, eps, s)
                        : launch_fwd<false>(l, x, nullptr, w, y, nullptr, hidden, eps, s);
}

// -- the backward ----------------------------------------------------------------

namespace {

constexpr int kBwdVecs = 2;            // 16-byte vectors of a row a lane owns
constexpr int kBwdMaxGroupWarps = 16;  // warps of a group at most
constexpr int kBwdMaxHidden = 8 * kBwdVecs * 32 * kBwdMaxGroupWarps;  // 8192
constexpr int kBwdBlockWarps = 8;      // warps of a block of several groups
constexpr int kBwdMaxThreads = 512;    // threads of a block at most (128 registers a thread)
constexpr int kBwdStages = 3;          // rows of the ring a group holds in shared memory
constexpr int kBwdSmemMax = 227 * 1024 - 1024;  // dynamic shared memory a block may take
constexpr int kSumRows = 8;            // partial rows a column's threads split in the sum kernel

// The launch (paddle_tpu_torch/ops/kernels/rms_norm.py `bwd_plan`, decided
// from the shapes alone), one 64-bit word: bits 0-4 the warps of a group,
// 8-11 the groups of a block, 12-31 the rows of a group's strip, 32-62 the
// blocks. Group q of block b walks rows [(b * groups + q) * strip, ... +
// strip); lane l of warp w of a group owns the row's 16-byte vectors (k *
// warps + w) * 32 + l, k < kBwdVecs.
struct BwdLaunch {
  int group_warps, groups, strip;
  long long blocks;
};

inline BwdLaunch bwd_decode(long long word) {
  BwdLaunch l;
  l.group_warps = (int)(word & 0x1f);
  l.groups = (int)((word >> 8) & 0xf);
  l.strip = (int)((word >> 12) & 0xfffff);
  l.blocks = (word >> 32) & 0x7fffffffLL;
  return l;
}

// dynamic shared memory of a launch: each group's ring of h, g (and gh)
// and its mbarriers (a block of several groups adds their dw over it)
inline size_t bwd_smem(const BwdLaunch& l, int hidden, bool has_gh) {
  return (size_t)l.groups * kBwdStages * ((2 + has_gh) * (size_t)hidden * 2 + 8);
}

// The launch covers every (row, vector) the kernel addresses and nothing
// past them: a group's lanes cover the row, whole warps within a block's
// limit, the strips cover the rows and every block has one, and the
// shared memory fits.
inline bool bwd_valid(const BwdLaunch& l, long long rows, int hidden, bool has_gh) {
  if (hidden <= 0 || hidden % 8 || hidden > kBwdMaxHidden || rows < 0) return false;
  if (l.group_warps < 1 || l.group_warps > kBwdMaxGroupWarps) return false;
  if (8LL * kBwdVecs * 32 * l.group_warps < hidden) return false;
  if (l.groups < 1 || 32 * l.group_warps * l.groups > kBwdMaxThreads) return false;
  if (l.strip < 1) return false;
  const long long per_block = (long long)l.groups * l.strip;
  if (l.blocks != (rows + per_block - 1) / per_block) return false;
  return bwd_smem(l, hidden, has_gh) <= (size_t)kBwdSmemMax;
}

// The rows: each group walks its strip and writes dx, keeping its lanes'
// columns of dw in registers; every block then writes one f32 partial row
// of dw, its groups' partials added in group order. The group's first lane
// keeps kBwdStages rows of h, g (and gh) coming into shared memory by bulk
// copies, one mbarrier a stage; a row's stage is copied into registers
// before the row's one reduction, and the row kBwdStages further on is
// asked into it once every warp of the group is past that reduction, so up
// to three rows are in flight while one is reduced. (Loads into registers
// a row ahead, with or without an L2 prefetch of the row after, and two or
// three blocks an SM were probed: no faster; PERF.md §6.)
template <bool GH>
__global__ void __launch_bounds__(kBwdMaxThreads, 1)
    rms_norm_bwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                        const bf16* __restrict__ g, const bf16* __restrict__ gh,
                        bf16* __restrict__ dx, float* __restrict__ part, int rows, int strip,
                        int hidden, int group_warps, float eps) {
  constexpr int V = kBwdVecs;
  constexpr int kNa = GH ? 3 : 2;  // rows of operands a row: h, g (and gh)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[2][2][kBwdMaxGroupWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = group_warps, grp = warp / gw, wig = warp % gw;
  const int ng = blockDim.x / (32 * gw);
  const int vecs = hidden / 8;
  const int r_begin = (blockIdx.x * ng + grp) * strip;
  const int n_rows = max(0, min(rows - r_begin, strip));
  const float inv_h = 1.f / (float)hidden;
  const bool leader = wig == 0 && lane == 0;

  int col[V];
  bool mine[V];
  uint4 wv[V];  // w's vectors, unpacked where used (registers are the limit)
  float dw[V][8];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = (k * gw + wig) * 32 + lane;
    mine[k] = j < vecs;
    col[k] = 8 * j;
    wv[k] = {};
    if (mine[k]) wv[k] = rw::ld16(w + col[k]);
#pragma unroll
    for (int e = 0; e < 8; ++e) dw[k][e] = 0.f;
  }

  // this group's stages and their mbarriers
  bf16* ring = reinterpret_cast<bf16*>(smem_raw) + (size_t)grp * kBwdStages * kNa * hidden;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + (size_t)ng * kBwdStages * kNa * hidden * 2) +
                   grp * kBwdStages;
  auto issue = [&](int r, int st) {
    bf16* dst = ring + (size_t)st * kNa * hidden;
    const uint32_t rb = (uint32_t)hidden * 2;
    const size_t base = (size_t)r * hidden;
    hp::mbar_arrive_expect_tx(&full[st], kNa * rb);
    hp::bulk_load(dst, h + base, rb, &full[st]);
    hp::bulk_load(dst + hidden, g + base, rb, &full[st]);
    if constexpr (GH) hp::bulk_load(dst + 2 * hidden, gh + base, rb, &full[st]);
  };
  if (leader)
    for (int s = 0; s < kBwdStages; ++s) hp::mbar_init(&full[s], 1);
  hp::mbar_fence_init();
  __syncthreads();
  if (leader)
    for (int s = 0; s < kBwdStages && s < n_rows; ++s) issue(r_begin + s, s);

  int buf = 0;
  for (int i = 0; i < n_rows; ++i) {
    const int r = r_begin + i;
    const int st = i % kBwdStages;
    hp::mbar_wait(&full[st], (i / kBwdStages) & 1);
    // the row's vectors, packed in registers; each pass unpacks them
    const bf16* sh = ring + (size_t)st * kNa * hidden;
    uint4 raw[kNa][V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
#pragma unroll
      for (int a = 0; a < kNa; ++a) raw[a][k] = {};
      if (mine[k]) {
#pragma unroll
        for (int a = 0; a < kNa; ++a) raw[a][k] = rw::ld16(sh + (size_t)a * hidden + col[k]);
      }
    }
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float hf[8], gf[8], wf[8];
      rw::unpack8(raw[0][k], hf);
      rw::unpack8(raw[1][k], gf);
      rw::unpack8(wv[k], wf);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s[0] += hf[e] * hf[e];
        s[1] += hf[e] * (gf[e] * wf[e]);
      }
    }
    rw::group_sums<2>(s, red, buf, grp, gw, wig, lane);
    // every warp of the group has its vectors of this stage: the stage
    // takes the row kBwdStages further on
    if (gw == 1) __syncwarp();
    if (leader && i + kBwdStages < n_rows) issue(r + kBwdStages, st);
    const float rstd = rsqrtf(s[0] * inv_h + eps);
    const float c = rstd * rstd * rstd * (s[1] * inv_h);
    const size_t base = (size_t)r * hidden;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (!mine[k]) continue;
      float hf[8], gf[8], wf[8], o[8], ghf[8] = {};
      rw::unpack8(raw[0][k], hf);
      rw::unpack8(raw[1][k], gf);
      rw::unpack8(wv[k], wf);
      if constexpr (GH) rw::unpack8(raw[2][k], ghf);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        o[e] = rstd * (gf[e] * wf[e]) - hf[e] * c;
        if constexpr (GH) o[e] += ghf[e];
        dw[k][e] += (gf[e] * hf[e]) * rstd;
      }
      ptt::store8(dx + base + col[k], o);
    }
  }

  // one partial row a block
  float* pw = part + (size_t)blockIdx.x * hidden;
  if (ng > 1) {
    // the groups' partials into a row of shared memory (over the rings,
    // which every group has finished with), in group order
    float* acc = reinterpret_cast<float*>(smem_raw);
    __syncthreads();
    for (int q = 0; q < ng; ++q) {
      if (grp == q) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          if (!mine[k]) continue;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[col[k] + e] = (q ? acc[col[k] + e] : 0.f) + dw[k][e];
        }
      }
      __syncthreads();
    }
    for (int j = threadIdx.x; j < vecs; j += blockDim.x) {
      float o[8];
      ptt::load8(acc + 8 * j, o);
      ptt::store8(pw + 8 * j, o);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < V; ++k)
    if (mine[k]) ptt::store8(pw + col[k], dw[k]);
}

// dw[c] = sum over b of part[b][c], in a fixed order, rounded once to bf16
__global__ void __launch_bounds__(32 * kSumRows)
    rms_norm_bwd_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dw, int n_blocks,
                            int hidden) {
  rw::sum_partial_rows<kSumRows>(part, dw, n_blocks, hidden, hidden);
}

template <bool GH>
int launch_bwd_rows(const BwdLaunch& l, const void* h, const void* w, const void* g,
                    const void* gh, void* dx, void* part, int rows, int hidden, float eps,
                    cudaStream_t s) {
  const size_t smem = bwd_smem(l, hidden, GH);
  // above 48 KB in all (the static reduction scratch included) only after
  // opting in, once a kernel and device
  if (smem + sizeof(float) * 2 * 2 * kBwdMaxGroupWarps > 48 * 1024) {
    const cudaError_t err = hp::allow_smem<rms_norm_bwd_kernel<GH>>(kBwdSmemMax);
    if (err != cudaSuccess) return (int)err;
  }
  rms_norm_bwd_kernel<GH><<<(unsigned)l.blocks, 32 * l.group_warps * l.groups, smem, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w), static_cast<const bf16*>(g),
      static_cast<const bf16*>(gh), static_cast<bf16*>(dx), static_cast<float*>(part), rows,
      l.strip, hidden, l.group_warps, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// The backward: the rows kernel, then the sum kernel. h, g, dx: [rows,
// hidden] bf16; gh: the same or null; w: [hidden] bf16; part: [blocks,
// hidden] f32 scratch (the plan's blocks); dw: [hidden] bf16, written by the
// sum kernel (zeros when rows is 0). hidden % 8 == 0, at most
// kBwdMaxHidden; every pointer 16-byte aligned. `plan`: the launch word of
// rms_norm.bwd_plan; a launch that does not cover every (row, vector), or
// whose shared memory does not fit, is refused.
PTT_EXPORT int ptt_rms_norm_bwd(const void* h, const void* w, const void* g, const void* gh,
                                void* dx, void* part, void* dw, int rows, int hidden, float eps,
                                long long plan, void* stream) {
  const BwdLaunch l = bwd_decode(plan);
  if (!bwd_valid(l, rows, hidden, gh != nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    const int err =
        gh != nullptr ? launch_bwd_rows<true>(l, h, w, g, gh, dx, part, rows, hidden, eps, s)
                      : launch_bwd_rows<false>(l, h, w, g, gh, dx, part, rows, hidden, eps, s);
    if (err) return err;
  }
  rms_norm_bwd_sum_kernel<<<(hidden + 31) / 32, 32 * kSumRows, 0, s>>>(
      static_cast<const float*>(part), static_cast<bf16*>(dw), (int)l.blocks, hidden);
  return (int)cudaGetLastError();
}
