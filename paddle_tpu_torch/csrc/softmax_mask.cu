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
// bytes read once; y and dy read and dx written once; the causal forward
// needs only x's lower triangle). Design (softmax_mask.plan in the wrapper
// picks the shape of the launch from the shapes alone):
//
// * Register path (Sk <= 8192). A row belongs to a group of lanes: 1-32
//   lanes of one warp (several rows a warp below Sk 256), or 2-8 whole
//   warps. Lane t of a group holds the 8-element vectors t, t + n, t + 2n,
//   ... of its row (n the group's lanes, at most 4 a lane) in registers
//   while it reduces them. Max and sum are shuffles within the group; a
//   group of several warps adds one partial a warp through shared memory
//   (two barriers a row). bf16 rows reach the registers through a ring of
//   the lane's own in shared memory (cp.async, 16 bytes a copy, a commit
//   group a row), so bytes in flight cost no registers, and a lane reads
//   back only what it copied itself. Where a group takes more than one row
//   (a sweep, a causal pair) the ring has two stages and the next row is in
//   flight while one is reduced and stored; a mask copied with each row and
//   the backward take one row a group and a one-stage ring, so nothing is
//   prefetched there (two or more rows a group were no faster); f32 rows
//   load straight into registers and are not prefetched either.
// * Mask mode, mask constant over heads (every padding mask [B, 1, Sq,
//   Sk]): a block takes (b, q) for all H heads. Its groups issue their
//   first rows' copies, the block stages the mask row once into shared
//   memory as f32 (one barrier), then the groups sweep the heads. A mask
//   that varies over heads but not over batches ([1, H, Sq, Sk], a bias
//   a head) is swept the same way over the batches; any other mask is
//   copied with each row.
// * Causal mode: row q copies only its first min(q + 1, Sk) columns (whole
//   vectors), reduces over them, and writes the rest of the row without
//   reading it: exp(-inf - max) / sum, which is +0 unless the live part
//   made the row NaN (as the reference's where then softmax does). A group
//   takes pairs of rows q and Sq - 1 - q of one (b, h), so every pair is
//   about one full row of work.
// * Backward: y and dy both copied through the ring, the dot a shuffle
//   sum, then each vector read again from the ring for dx.
// * Shared-memory path (8192 < Sk, up to the wrapper's limit): a block a
//   row, the f32 row (and dy) in shared memory, block reductions; causal
//   rows skip the vectors past the diagonal there too.
#include <math.h>

#include "common.cuh"

using ptt::bf16;

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// 8 elements' bits: one 16-byte access for bf16, two for f32
template <typename T>
struct Raw8;
template <>
struct Raw8<bf16> {
  uint4 a;
};
template <>
struct Raw8<float> {
  uint4 a, b;
};

__device__ __forceinline__ void load_vec(Raw8<bf16>& r, const bf16* p) {
  r.a = __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void load_vec(Raw8<float>& r, const float* p) {
  r.a = __ldg(reinterpret_cast<const uint4*>(p));
  r.b = __ldg(reinterpret_cast<const uint4*>(p + 4));
}

// element k at p[k * s]: a mask read through an arbitrary stride
__device__ __forceinline__ void load_strided(Raw8<bf16>& r, const bf16* p, long long s) {
  unsigned h[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) h[k] = __bfloat16_as_ushort(p[k * s]);
  r.a = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                   h[6] | (h[7] << 16));
}

__device__ __forceinline__ void load_strided(Raw8<float>& r, const float* p, long long s) {
  r.a = make_uint4(__float_as_uint(p[0]), __float_as_uint(p[s]), __float_as_uint(p[2 * s]),
                   __float_as_uint(p[3 * s]));
  r.b = make_uint4(__float_as_uint(p[4 * s]), __float_as_uint(p[5 * s]),
                   __float_as_uint(p[6 * s]), __float_as_uint(p[7 * s]));
}

__device__ __forceinline__ void lo_hi(unsigned w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void unpack(const Raw8<bf16>& r, float* o) {
  lo_hi(r.a.x, o[0], o[1]);
  lo_hi(r.a.y, o[2], o[3]);
  lo_hi(r.a.z, o[4], o[5]);
  lo_hi(r.a.w, o[6], o[7]);
}

__device__ __forceinline__ void unpack(const Raw8<float>& r, float* o) {
  o[0] = __uint_as_float(r.a.x); o[1] = __uint_as_float(r.a.y);
  o[2] = __uint_as_float(r.a.z); o[3] = __uint_as_float(r.a.w);
  o[4] = __uint_as_float(r.b.x); o[5] = __uint_as_float(r.b.y);
  o[6] = __uint_as_float(r.b.z); o[7] = __uint_as_float(r.b.w);
}

// A row's group: `lanes` lanes of one warp (a power of two) or `warps`
// whole warps; `mask` holds the group's lanes of the warp.
struct Group {
  int lanes, warps;
  unsigned mask;
  float* red;  // [2][8] shared: one partial a warp (max, then sum)

  // A group of several warps reads its partials after one barrier and
  // writes the next ones without another: this is safe because a group
  // calls max and sum in turn (a forward row), or sum once (the backward
  // takes one row a group), so a slot is written again only after a
  // barrier that every warp reaches after reading it.

  __device__ __forceinline__ float max(float v) const {
#pragma unroll 1
    for (int o = lanes >> 1; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(mask, v, o));
    if (warps > 1) {
      if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
      __syncthreads();
      v = red[0];
      for (int w = 1; w < warps; ++w) v = fmaxf(v, red[w]);
    }
    return v;
  }

  __device__ __forceinline__ float sum(float v) const {
#pragma unroll 1
    for (int o = lanes >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
    if (warps > 1) {
      if ((threadIdx.x & 31) == 0) red[8 + (threadIdx.x >> 5)] = v;
      __syncthreads();
      v = red[8];
      for (int w = 1; w < warps; ++w) v += red[8 + w];
    }
    return v;
  }
};

// The group of this thread: its index within the block, its lane within
// the group, the groups a block.
struct Place {
  Group g;
  int grp, t, per_block;
};

__device__ __forceinline__ Place place_of(int lanes, int warps, float* red) {
  Place p;
  p.g.lanes = lanes;
  p.g.warps = warps;
  p.g.red = red;
  if (warps > 1) {
    p.grp = 0;
    p.t = threadIdx.x;
    p.per_block = 1;
    p.g.mask = 0xffffffffu;
  } else {
    p.grp = threadIdx.x / lanes;
    p.t = threadIdx.x % lanes;
    p.per_block = blockDim.x / lanes;
    p.g.mask = lanes == 32 ? 0xffffffffu
                           : ((1u << lanes) - 1u) << ((threadIdx.x & 31) & ~(lanes - 1));
  }
  return p;
}

enum { kSweep = 0, kMask = 1, kCausal = 2 };

// 16 bytes from global to shared memory, cached in L2 only; the thread's
// copies complete in the order of its commit groups
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// every group but the newest `pending` (0 or 1) has landed
__device__ __forceinline__ void cp_wait(int pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 16-byte words of one 8-element vector
template <typename T>
constexpr int kWords = sizeof(T) / 2;

template <typename T>
__device__ __forceinline__ void copy_vec(uint4* dst, const T* src) {
#pragma unroll
  for (int w = 0; w < kWords<T>; ++w) cp16(dst + w, src + 8 / kWords<T> * w);
}

__device__ __forceinline__ void read_vec(Raw8<bf16>& r, const uint4* p) { r.a = p[0]; }
__device__ __forceinline__ void read_vec(Raw8<float>& r, const uint4* p) {
  r.a = p[0];
  r.b = p[1];
}

// A group's ring in shared memory: `stages` rows of `streams` operands,
// each lane's V vectors in slots of its own (consecutive lanes on
// consecutive words, so a warp's reads meet no bank conflict). A lane
// reads back only the words it copied itself, so no barrier guards a slot.
template <typename T, int V>
struct Ring {
  uint4* base;
  int stages, threads;

  __device__ __forceinline__ uint4* slot(int stream, int stage, int i) const {
    return base + ((((long long)stream * stages + stage) * V + i) * threads + threadIdx.x) *
                      kWords<T>;
  }
};

struct FwdArgs {
  long long rows;  // B * H * Sq, below 2**31 (the wrapper checks)
  int heads, sq, sk;
  long long ms_b, ms_h, ms_q, ms_k;
  int mvec;   // the mask's rows are contiguous and 16-byte aligned
  int lanes, warps, stages;
  int batch_sweep;  // kSweep over batches (ms_b == 0), not over heads
};

// The rows of one group: sweep, rows r0 + k * step (the heads of (b, q),
// or the batches of (h, q)); mask and backward, the one row r0; causal,
// pair `first` of (b, h) (pair i: rows i and Sq - 1 - i). -1: no row (a
// pair's middle). Row indices are below 2**31.
struct Seq {
  int mode;
  long long r0, step;
  int n;
  int first, pairs, sq;

  __device__ __forceinline__ long long row(int k) const {
    if (mode != kCausal) return r0 + k * step;
    const int bh = first / pairs, i = first % pairs;
    if ((k & 1) && sq - 1 - i == i) return -1;
    return (long long)bh * sq + ((k & 1) ? sq - 1 - i : i);
  }
};

template <typename T, typename M, int MODE, int V>
struct FwdRow {
  static constexpr bool kDirect = sizeof(T) == 4;
  const T* __restrict__ x;
  const M* __restrict__ mask;
  T* __restrict__ y;
  const float4* lo;  // kSweep: the mask row, elements 0-3 of each vector
  const float4* hi;  //         and 4-7
  Ring<T, V> ring;   // x
  Ring<M, V> mring;  // kMask: the mask's vectors
  FwdArgs a;
  Place p;
  int nl, vecs;

  // vectors of row r that are read: all of them, or the causal row's live
  // ones (its first min(q + 1, Sk) columns)
  __device__ __forceinline__ int live(long long r) const {
    if (MODE != kCausal) return vecs;
    const int q = (int)r % a.sq;
    return min(vecs, (min(q + 1, a.sk) + 7) >> 3);
  }

  __device__ __forceinline__ long long mask_off(long long r) const {
    const int bh = (int)r / a.sq;
    return (long long)(bh / a.heads) * a.ms_b + (long long)(bh % a.heads) * a.ms_h +
           (long long)((int)r % a.sq) * a.ms_q;
  }

  // a row held in registers straight from device memory (no ring)
  struct Regs {
    Raw8<T> x[V];
    Raw8<M> m[MODE == kMask ? V : 1];
  };

  __device__ __forceinline__ void load(Regs& g, long long r) const {
    const int n = live(r);
    const T* xr = x + r * (long long)a.sk;
    const M* mr = mask + (MODE == kMask ? mask_off(r) : 0);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int j = p.t + i * nl;
      if (j < n) {
        load_vec(g.x[i], xr + 8 * j);
        if constexpr (MODE == kMask)
          if (a.mvec) load_vec(g.m[i], mr + 8 * j);
      }
    }
  }

  __device__ __forceinline__ void finish(const Regs& g, long long r) const {
    reduce([&](int i, Raw8<T>& xv, Raw8<M>& mv) {
      xv = g.x[i];
      if constexpr (MODE == kMask) mv = g.m[i];
    }, r);
  }

  __device__ __forceinline__ void finish(int stage, long long r) const {
    reduce([&](int i, Raw8<T>& xv, Raw8<M>& mv) {
      read_vec(xv, ring.slot(0, stage, i));
      if constexpr (MODE == kMask)
        if (a.mvec) read_vec(mv, mring.slot(0, stage, i));
    }, r);
  }

  __device__ __forceinline__ void issue(int stage, long long r) const {
    const int n = live(r);
    const T* xr = x + r * (long long)a.sk;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int j = p.t + i * nl;
      if (j < n) copy_vec(ring.slot(0, stage, i), xr + 8 * j);
    }
    if (MODE == kMask && a.mvec) {
      const M* mr = mask + mask_off(r);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int j = p.t + i * nl;
        if (j < n) copy_vec(mring.slot(0, stage, i), mr + 8 * j);
      }
    }
  }

  // `get(i, x, mask)` gives vector i of the row (and of a mask that
  // comes with it)
  template <typename Get>
  __device__ __forceinline__ void reduce(Get get, long long r) const {
    const int n = live(r);
    const int q = (int)r % a.sq;
    float v[V][8];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int j = p.t + i * nl;
      if (j < n) {
        Raw8<T> raw;
        Raw8<M> mr;
        get(i, raw, mr);
        unpack(raw, v[i]);
        if (MODE == kMask) {
          if (!a.mvec) load_strided(mr, mask + mask_off(r) + 8 * j * a.ms_k, a.ms_k);
          float m[8];
          unpack(mr, m);
#pragma unroll
          for (int k = 0; k < 8; ++k) v[i][k] += m[k];
        } else if (MODE == kSweep) {
          const float4 l = lo[j], h = hi[j];
          v[i][0] += l.x; v[i][1] += l.y; v[i][2] += l.z; v[i][3] += l.w;
          v[i][4] += h.x; v[i][5] += h.y; v[i][6] += h.z; v[i][7] += h.w;
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (8 * j + k > q) v[i][k] = -INFINITY;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) mx = fmaxf(mx, v[i][k]);
      }
    }
    mx = p.g.max(mx);
    const float mxl = mx * kLog2e;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int j = p.t + i * nl;
      if (j < n) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          v[i][k] = exp2f(fmaf(v[i][k], kLog2e, -mxl));
          s += v[i][k];
        }
      }
    }
    s = p.g.sum(s);
    const float inv = 1.f / s;
    // a column past the diagonal: exp(-inf - max) / sum, +0 unless the
    // row is NaN
    const float dead = exp2f(-INFINITY - mxl) * inv;
    T* yr = y + r * (long long)a.sk;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int j = p.t + i * nl;
      if (j < vecs) {
        float o[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) o[k] = j < n ? v[i][k] * inv : dead;
        ptt::store8(yr + 8 * j, o);
      }
    }
  }
};

// The rows of `seq` through the ring (1 or 2 stages): with 2, the next
// row's copies are in flight while a row is reduced and stored. f32 rows (Row::kDirect)
// are loaded straight into registers instead: their ring would take twice
// the shared memory for the same rows, and the SM's warps keep as many
// bytes in flight. `prologue` runs once the first row's loads are issued
// (every thread of the block calls it). Every thread commits one group a
// row slot, so the count of groups in flight is the same for all.
template <typename Row, typename Prologue>
__device__ __forceinline__ void run_rows(const Row& row, const Seq& seq, int stages,
                                         Prologue prologue) {
  if constexpr (Row::kDirect) {
    typename Row::Regs g;
    long long r = seq.n > 0 ? seq.row(0) : -1;
    if (r >= 0) row.load(g, r);
    prologue();
#pragma unroll 1
    for (int k = 0; k < seq.n; ++k) {
      if (k > 0) {
        r = seq.row(k);
        if (r >= 0) row.load(g, r);
      }
      if (r >= 0) row.finish(g, r);
    }
  } else {
    for (int k = 0; k < stages - 1; ++k) {
      if (k < seq.n) {
        const long long r = seq.row(k);
        if (r >= 0) row.issue(k, r);
      }
      cp_commit();
    }
    prologue();
#pragma unroll 1
    for (int k = 0; k < seq.n; ++k) {
      const int ahead = k + stages - 1;
      if (ahead < seq.n) {
        const long long r = seq.row(ahead);
        if (r >= 0) row.issue(ahead % stages, r);
      }
      cp_commit();
      cp_wait(stages - 1);
      const long long r = seq.row(k);
      if (r >= 0) row.finish(k % stages, r);
    }
  }
}

// MODE: kSweep (a block a (b, q), the mask row staged once for the
// heads; or a block an (h, q) for the batches), kMask (the mask copied
// with each row), kCausal (no mask; M unused). V: vectors a lane.
template <typename T, typename M, int MODE, int V>
__global__ void __launch_bounds__(256)
    softmax_mask_kernel(const T* __restrict__ x, const M* __restrict__ mask, T* __restrict__ y,
                        FwdArgs a) {
  extern __shared__ uint4 smem[];  // kSweep: the mask row ([2][Sk / 8] float4); the ring
  __shared__ float red[16];
  FwdRow<T, M, MODE, V> row;
  row.x = x;
  row.mask = mask;
  row.y = y;
  row.a = a;
  row.p = place_of(a.lanes, a.warps, red);
  row.nl = a.lanes * a.warps;
  row.vecs = a.sk >> 3;
  const float4* mrow = reinterpret_cast<const float4*>(smem);
  row.lo = mrow;
  row.hi = mrow + row.vecs;
  row.ring.base = smem + (MODE == kSweep ? 2 * row.vecs : 0);
  row.ring.stages = row.mring.stages = a.stages;
  row.ring.threads = row.mring.threads = blockDim.x;
  row.mring.base = row.ring.base + (long long)a.stages * V * blockDim.x * kWords<T>;
  const Place& p = row.p;

  Seq seq;
  seq.mode = MODE;
  seq.sq = a.sq;
  seq.step = 1;
  if (MODE == kSweep) {
    // the block's (o, q): o is b when the heads are swept, h when the
    // batches are; its groups take the swept index grp, grp + per_block, ...
    const int o = blockIdx.x / a.sq, q = blockIdx.x % a.sq;
    const int batches = (int)(a.rows / ((long long)a.heads * a.sq));
    if (o >= (a.batch_sweep ? a.heads : batches)) return;  // past the work
    const int count = a.batch_sweep ? batches : a.heads;
    seq.r0 = (a.batch_sweep ? (long long)p.grp * a.heads + o : (long long)o * a.heads + p.grp) *
                 a.sq + q;
    seq.step = (long long)p.per_block * a.sq * (a.batch_sweep ? a.heads : 1);
    seq.n = p.grp < count ? (count - p.grp + p.per_block - 1) / p.per_block : 0;
    // the mask row, staged while the first rows of x are in flight
    const long long off = o * (a.batch_sweep ? a.ms_h : a.ms_b) + q * a.ms_q;
    float4* out = reinterpret_cast<float4*>(smem);
    run_rows(row, seq, a.stages, [&] {
      for (int j = threadIdx.x; j < row.vecs; j += blockDim.x) {
        Raw8<M> raw;
        if (a.mvec)
          load_vec(raw, mask + off + 8 * j);
        else
          load_strided(raw, mask + off + 8 * j * a.ms_k, a.ms_k);
        float f[8];
        unpack(raw, f);
        out[j] = make_float4(f[0], f[1], f[2], f[3]);
        out[row.vecs + j] = make_float4(f[4], f[5], f[6], f[7]);
      }
      __syncthreads();
    });
    return;
  }
  const long long item = (long long)blockIdx.x * p.per_block + p.grp;
  if (MODE == kCausal) {
    // a pair: rows i and Sq - 1 - i of one (b, h)
    seq.pairs = (a.sq + 1) / 2;
    seq.first = (int)item;
    seq.n = item < (a.rows / a.sq) * seq.pairs ? 2 : 0;
  } else {
    seq.r0 = item;
    seq.n = item < a.rows ? 1 : 0;
  }
  run_rows(row, seq, a.stages, [] {});
}

struct BwdArgs {
  long long rows;
  int sk, lanes, warps;
};

template <typename T, int V>
struct BwdRow {
  static constexpr bool kDirect = sizeof(T) == 4;
  const T* __restrict__ y;
  const T* __restrict__ dy;
  T* __restrict__ dx;
  Ring<T, V> ring;  // y, dy
  BwdArgs a;
  Place p;
  int nl, vecs;

  __device__ __forceinline__ void issue(int stage, long long r) const {
    const long long base = r * (long long)a.sk;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int j = p.t + i * nl;
      if (j < vecs) {
        copy_vec(ring.slot(0, stage, i), y + base + 8 * j);
        copy_vec(ring.slot(1, stage, i), dy + base + 8 * j);
      }
    }
  }

  // a row held in registers straight from device memory (no ring)
  struct Regs {
    Raw8<T> y[V], g[V];
  };

  __device__ __forceinline__ void load(Regs& g, long long r) const {
    const long long base = r * (long long)a.sk;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (p.t + i * nl < vecs) {
        load_vec(g.y[i], y + base + 8 * (p.t + i * nl));
        load_vec(g.g[i], dy + base + 8 * (p.t + i * nl));
      }
    }
  }

  __device__ __forceinline__ void finish(const Regs& g, long long r) const {
    reduce([&](int i, float* u, float* d) {
      unpack(g.y[i], u);
      unpack(g.g[i], d);
    }, r);
  }

  // from the ring, y and dy are read twice (for the dot, then for dx),
  // which keeps them out of registers in between
  __device__ __forceinline__ void finish(int stage, long long r) const {
    reduce([&](int i, float* u, float* d) {
      Raw8<T> ry, rg;
      read_vec(ry, ring.slot(0, stage, i));
      read_vec(rg, ring.slot(1, stage, i));
      unpack(ry, u);
      unpack(rg, d);
    }, r);
  }

  template <typename Get>
  __device__ __forceinline__ void reduce(Get pair, long long r) const {
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (p.t + i * nl < vecs) {
        float u[8], g[8];
        pair(i, u, g);
#pragma unroll
        for (int k = 0; k < 8; ++k) dot += g[k] * u[k];
      }
    }
    dot = p.g.sum(dot);
    T* out = dx + r * (long long)a.sk;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int j = p.t + i * nl;
      if (j < vecs) {
        float u[8], g[8], o[8];
        pair(i, u, g);
#pragma unroll
        for (int k = 0; k < 8; ++k) o[k] = (g[k] - dot) * u[k];
        ptt::store8(out + 8 * j, o);
      }
    }
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(256)
    softmax_mask_bwd_kernel(const T* __restrict__ y, const T* __restrict__ dy,
                            T* __restrict__ dx, BwdArgs a) {
  extern __shared__ uint4 smem[];  // the ring, one stage
  __shared__ float red[16];
  BwdRow<T, V> row;
  row.y = y;
  row.dy = dy;
  row.dx = dx;
  row.a = a;
  row.p = place_of(a.lanes, a.warps, red);
  row.nl = a.lanes * a.warps;
  row.vecs = a.sk >> 3;
  row.ring.base = smem;
  row.ring.stages = 1;
  row.ring.threads = blockDim.x;
  // one row a group
  Seq seq;
  seq.mode = kMask;
  seq.r0 = (long long)blockIdx.x * row.p.per_block + row.p.grp;
  seq.step = 1;
  seq.n = seq.r0 < a.rows ? 1 : 0;
  run_rows(row, seq, 1, [] {});
}

// -- the shared-memory path (rows past the register path's 8192) -----------

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

// a block a row; CAUSAL: the triangle instead of a mask (M unused), the
// vectors past the diagonal not read
template <typename T, typename M, bool CAUSAL>
__global__ void softmax_mask_smem_kernel(const T* __restrict__ x, const M* __restrict__ mask,
                                         T* __restrict__ y, int heads, int sq, int sk,
                                         long long ms_b, long long ms_h, long long ms_q,
                                         long long ms_k) {
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
    if (CAUSAL && i > q) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = -INFINITY;
    } else {
      ptt::load8(x + base + i, v);
    }
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
__global__ void softmax_mask_bwd_smem_kernel(const T* __restrict__ y, const T* __restrict__ dy,
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

// -- launches ----------------------------------------------------------------
//
// softmax_mask.plan decides every launch's shape (threads, blocks, shared
// memory) from the shapes alone; the C entries launch what it gives. They
// refuse a plan whose lanes do not cover the row or whose shared memory is
// short of what the kernel addresses. A register-path block past the work
// returns; the shared-memory path takes exactly a block a row.

template <typename K>
void opt_in(K kern, size_t smem) {
  // above 48 KB in all (the static part included) only after opting in
  if (smem + 256 > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// lanes x warps x vectors a lane cover the row; the threads hold whole
// groups (a group of several warps is the block)
bool valid_plan(int sk, int lanes, int warps, int vpl, int threads, int stages) {
  if (!pow2(lanes) || lanes > 32 || warps < 1 || warps > 8) return false;
  if (vpl != 1 && vpl != 2 && vpl != 4) return false;
  if (stages != 1 && stages != 2) return false;
  if (warps > 1 ? (lanes != 32 || threads != 32 * warps)
                : (threads % 32 || threads < 32 || threads > 256))
    return false;
  return (long long)lanes * warps * vpl * 8 >= sk;
}

// Shared memory the register kernels address: a sweep's f32 mask row
// (Sk * 4 bytes), then the ring of bf16 rows, `stages` x V 16-byte words
// a thread of x and of each operand copied with it (`words` in all).
size_t reg_smem(bool sweep, int sk, bool bf16_rows, int stages, int vpl, int threads,
                int words) {
  return (sweep ? (size_t)sk * sizeof(float) : 0) +
         (bf16_rows ? (size_t)stages * vpl * threads * 16 * words : 0);
}

bool valid_smem_plan(int threads, int blocks, long long rows) {
  return threads % 32 == 0 && threads >= 32 && threads <= 1024 && blocks == rows;
}

template <typename T, typename M, int MODE, int V>
int launch_regs(const void* x, const void* mask, void* y, const FwdArgs& a, int threads,
                int blocks, int smem, cudaStream_t s) {
  auto kern = softmax_mask_kernel<T, M, MODE, V>;
  opt_in(kern, smem);
  kern<<<(unsigned)blocks, threads, smem, s>>>(static_cast<const T*>(x),
                                               static_cast<const M*>(mask), static_cast<T*>(y),
                                               a);
  return (int)cudaGetLastError();
}

template <typename T, typename M, int MODE>
int launch_v(const void* x, const void* mask, void* y, const FwdArgs& a, int vpl, int threads,
             int blocks, int smem, cudaStream_t s) {
  if (vpl == 1) return launch_regs<T, M, MODE, 1>(x, mask, y, a, threads, blocks, smem, s);
  if (vpl == 2) return launch_regs<T, M, MODE, 2>(x, mask, y, a, threads, blocks, smem, s);
  return launch_regs<T, M, MODE, 4>(x, mask, y, a, threads, blocks, smem, s);
}

template <typename T, typename M, bool CAUSAL>
int launch_smem(const void* x, const void* mask, void* y, const FwdArgs& a, int threads,
                int blocks, int smem, cudaStream_t s) {
  auto kern = softmax_mask_smem_kernel<T, M, CAUSAL>;
  opt_in(kern, smem);
  kern<<<(unsigned)blocks, threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const M*>(mask), static_cast<T*>(y), a.heads, a.sq,
      a.sk, a.ms_b, a.ms_h, a.ms_q, a.ms_k);
  return (int)cudaGetLastError();
}

template <typename T, typename M>
int launch_mask(const void* x, const void* mask, void* y, const FwdArgs& a, int mode, int vpl,
                int threads, int blocks, int smem, cudaStream_t s) {
  if (a.lanes == 0) return launch_smem<T, M, false>(x, mask, y, a, threads, blocks, smem, s);
  if (mode == kSweep)
    return launch_v<T, M, kSweep>(x, mask, y, a, vpl, threads, blocks, smem, s);
  return launch_v<T, M, kMask>(x, mask, y, a, vpl, threads, blocks, smem, s);
}

template <typename T>
int launch_x(const void* x, const void* mask, void* y, const FwdArgs& a, int mask_f32, int mode,
             int vpl, int threads, int blocks, int smem, cudaStream_t s) {
  if (mode == kCausal) {
    if (a.lanes == 0)
      return launch_smem<T, float, true>(x, nullptr, y, a, threads, blocks, smem, s);
    return launch_v<T, float, kCausal>(x, nullptr, y, a, vpl, threads, blocks, smem, s);
  }
  if (mask_f32)
    return launch_mask<T, float>(x, mask, y, a, mode, vpl, threads, blocks, smem, s);
  return launch_mask<T, bf16>(x, mask, y, a, mode, vpl, threads, blocks, smem, s);
}

template <typename T, int V>
int launch_bwd_regs(const void* y, const void* dy, void* dx, const BwdArgs& a, int threads,
                    int blocks, int smem, cudaStream_t s) {
  auto kern = softmax_mask_bwd_kernel<T, V>;
  opt_in(kern, smem);
  kern<<<(unsigned)blocks, threads, smem, s>>>(static_cast<const T*>(y),
                                               static_cast<const T*>(dy), static_cast<T*>(dx), a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* y, const void* dy, void* dx, const BwdArgs& a, int vpl, int threads,
               int blocks, int smem, cudaStream_t s) {
  if (a.lanes == 0) {
    auto kern = softmax_mask_bwd_smem_kernel<T>;
    opt_in(kern, smem);
    kern<<<(unsigned)blocks, threads, smem, s>>>(static_cast<const T*>(y),
                                                 static_cast<const T*>(dy),
                                                 static_cast<T*>(dx), a.sk);
    return (int)cudaGetLastError();
  }
  if (vpl == 1) return launch_bwd_regs<T, 1>(y, dy, dx, a, threads, blocks, smem, s);
  if (vpl == 2) return launch_bwd_regs<T, 2>(y, dy, dx, a, threads, blocks, smem, s);
  return launch_bwd_regs<T, 4>(y, dy, dx, a, threads, blocks, smem, s);
}

}  // namespace

// x, y: [rows = B * H * Sq, Sk] contiguous, f32 (x_f32) or bf16; Sk % 8 == 0,
// 16-byte aligned. mode 2: the causal triangle, mask unused (null).
// Otherwise mask (f32 if mask_f32, else bf16) element (b, h, q, k) is at
// b * ms_b + h * ms_h + q * ms_q + k * ms_k (strides in elements, 0 where
// the mask broadcasts); mode 0 (a block sweeps the heads) needs ms_h == 0,
// mode 3 (a block sweeps the batches) ms_b == 0; mvec != 0: ms_k == 1 and
// every row 16-byte aligned. The plan (softmax_mask.plan): lanes 0 takes
// the shared-memory path (a block a row, Sk * 4 bytes); else the register
// path's lanes, warps, vectors a lane and ring stages (1 or 2); both, the
// launch's threads, blocks and dynamic shared memory.
PTT_EXPORT int ptt_softmax_mask(const void* x, const void* mask, void* y, long long rows,
                                int heads, int sq, int sk, long long ms_b, long long ms_h,
                                long long ms_q, long long ms_k, int x_f32, int mask_f32, int mode,
                                int mvec, int lanes, int warps, int vpl, int threads, int stages,
                                int blocks, int smem, void* stream) {
  if (rows == 0 || sk == 0) return 0;
  const int batch_sweep = mode == 3;
  if (mode < 0 || mode > 3 || (mode == kSweep && ms_h != 0) || (batch_sweep && ms_b != 0))
    return (int)cudaErrorInvalidValue;
  if (batch_sweep) mode = kSweep;
  const int words = 1 + (mode == kMask ? (mask_f32 ? 2 : 1) : 0);  // x's, the mask's
  const bool fits =
      lanes == 0 ? valid_smem_plan(threads, blocks, rows) &&
                       (size_t)smem >= (size_t)sk * sizeof(float)
                 : blocks > 0 && valid_plan(sk, lanes, warps, vpl, threads, stages) &&
                       (size_t)smem >=
                           reg_smem(mode == kSweep, sk, !x_f32, stages, vpl, threads, words);
  if (!fits) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FwdArgs a{rows, heads, sq, sk, ms_b, ms_h, ms_q, ms_k, mvec, lanes, warps, stages,
                  batch_sweep};
  if (x_f32) return launch_x<float>(x, mask, y, a, mask_f32, mode, vpl, threads, blocks, smem, s);
  return launch_x<bf16>(x, mask, y, a, mask_f32, mode, vpl, threads, blocks, smem, s);
}

// y, dy, dx: [rows, Sk] contiguous, f32 (is_f32) or bf16; Sk % 8 == 0,
// 16-byte aligned. The plan as for the forward (one row a group, a
// one-stage ring): lanes 0 takes the shared-memory path (2 * Sk * 4 bytes
// a block).
PTT_EXPORT int ptt_softmax_mask_bwd(const void* y, const void* dy, void* dx, long long rows,
                                    int sk, int is_f32, int lanes, int warps, int vpl,
                                    int threads, int blocks, int smem, void* stream) {
  if (rows == 0 || sk == 0) return 0;
  const bool fits =
      lanes == 0 ? valid_smem_plan(threads, blocks, rows) &&
                       (size_t)smem >= 2 * (size_t)sk * sizeof(float)
                 : blocks > 0 && valid_plan(sk, lanes, warps, vpl, threads, 1) &&
                       (size_t)smem >= reg_smem(false, sk, !is_f32, 1, vpl, threads, 2);
  if (!fits) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs a{rows, sk, lanes, warps};
  return is_f32 ? launch_bwd<float>(y, dy, dx, a, vpl, threads, blocks, smem, s)
                : launch_bwd<bf16>(y, dy, dx, a, vpl, threads, blocks, smem, s);
}
