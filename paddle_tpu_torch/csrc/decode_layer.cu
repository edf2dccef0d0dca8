// One whole Llama decode layer after QKV/RoPE/KV-write, in one launch.
//
// Replaces paddle_tpu/ops/kernels/decode_layer_pallas.py `_fwd` (kernel body
// `_decode_layer_kernel`). Per batch row b, with every intermediate in f32:
//   o   = attention of q[b] over positions 0..pos[b] of the paged pool
//   h1  = o @ Wo^T + hres[b]
//   y1  = rmsnorm(h1) * w_post
//   z   = silu(y1 @ Wg^T) * (y1 @ Wu^T)
//   h2  = z @ Wd^T + h1
//   y   = rmsnorm(h2) * w_next                 -> y, h2 cast to bf16 once
// Weights are nn.Linear's [out, in]; nothing is transposed or copied.
//
// Bound on the H100: bytes. At batch 8 a Llama-3-8B layer reads 386 MB of
// bf16 weights (o, gate, up, down) and ~20 MB of keys and values, ~8 flops
// per weight byte read, far below the card's ridge. The TPU kernel's grid is
// (row, page) and runs the whole layer tail in one grid step per row with
// the weights resident in VMEM; done that way here, each row's block would
// stream all 386 MB through one SM. Instead one persistent cooperative
// launch, one block of 288 threads per SM (two consumer warpgroups, then one
// producer warp), spreads every phase over all SMs:
//   1. attention: the flattened list of (row, kv head, 64-position
//      sub-chunk) is cut into one contiguous range a block. All rep query
//      heads of a GQA group share a sub-chunk, so its keys and values are
//      read once; a long row spreads over several SMs. Keys and values come
//      in by cp.async into a double buffer (a row's page entries read a step
//      ahead); the scores split D, and the products with V split the
//      positions, over adjacent lanes where rep is small, so a step's chain
//      stays short; an f32 online softmax runs per head. A range that holds
//      a (row, kv head) whole writes its output; otherwise each piece writes
//      (m, l, acc) and the last piece to finish (a counter) merges the
//      pieces in range order.
//   2. o_proj, 3. gate/up, 4. down: y^T = W x^T on the tensor cores with
//      the weight as A and the activations as B. The f32 activations go to
//      the tensor cores as three bf16 terms, hi = bf16(v), mid = bf16(v -
//      hi), lo = bf16(v - hi - mid), which hold v exactly (save for an
//      underflow of lo): the 3 NB rows of terms (NB = 8 batch rows, or 16
//      past batch 8: each weight byte is read once at any batch) are one
//      wgmma m64nNk16's N = 24 or 48, whose three sums of a batch row are
//      added in the epilogue (lo + mid + hi). A stage of the ring is 128
//      weight rows by 64 k (two [64, 64] TMA boxes with the 128-byte
//      swizzle: Wo or Wd rows r and r + 64, or the same 64 rows of Wg and
//      Wu) and the activations' [3 terms, NB rows, 64 k] box. A phase's
//      (tile, k box) stages are cut into one contiguous range a block, so
//      every SM streams the same bytes; the producer issues the weight boxes
//      four stages at a time (consecutive k of the same rows reach the
//      memory together: 512 bytes a row). A block writes its f32 partial of
//      each tile it touches (128 rows by NB); the last block to finish a
//      tile (a counter) adds the tile's partials in block order and runs the
//      tile's epilogue:
//      o_proj: h1 = sum + hres, its sum of squares, and the next phase's
//      terms of h1 * w_post (the norm's rsqrt is a per-row scale, applied
//      after gate/up's product); gate/up: z = silu(r g) * (r u) with r the
//      row's rsqrt and z's terms; down: h2 = sum + h1 and its sum of squares.
//   5. the second norm, y and h written as bf16.
// Every sum is taken in a fixed order (partials in block order, squares in
// warp order), never with float atomics, so two calls give the same bits.
//
// The producer thread streams the weight boxes of phases 2-4 into the ring
// (11 stages at NB 8, 10 at 16: 160-176 KB of weights) from the kernel's
// start: the weights do not depend on the activations, so the ring is full
// when the consumers arrive, attention and the barriers included. The
// attention's buffers lie in the ring's last stages: the producer fills the
// others once the attention's first keys and values are in (their loads go
// ahead of the weights'), the rest once attention is done. An activation
// box is issued once the barrier that ends the previous phase has passed.
// The barriers are the kernel's own (consumer warps only, so the producer
// may run ahead): a counter per barrier in the scratch, zeroed by the C
// entry before the launch, that each block's consumers raise with a release
// and wait on with an acquire; the producer reads the same counters.
// Writers of data a later TMA load reads fence the async proxy first. The
// launch is cooperative, so all blocks are co-resident (a grid that is not
// is refused with an error, never a hang).
//
// Stamps (block 0's device clock, ns): the start, the four barriers (after
// attention, o_proj, gate/up, down: each marks when block 0's consumers
// pass it, with the next phase's weights already streaming) and the end.
#include "hopper.cuh"

using ptt::bf16;
namespace hp = ptt::hopper;

namespace {

constexpr int kThreads = 288;   // two consumer warpgroups, then one producer warp
constexpr int kCons = 256;      // consumer threads
constexpr int kBK = 64;         // k of a weight box: one 128-byte swizzled row
constexpr int kBoxRows = 64;    // weight rows of a box (a wgmma's M)
constexpr int kTileRows = 2 * kBoxRows;  // o_proj / down rows of a tile
constexpr int kTerms = 3;       // bf16 terms of an f32 activation
constexpr int kSub = 64;        // attention positions of a sub-chunk
constexpr int kIssue = 4;       // weight stages the producer issues together
constexpr int kMaxRep = 8;
constexpr int kMaxBatch = 16;
constexpr int kMaxDevices = 16;
constexpr int kBarriers = 4;
constexpr unsigned kSpinLimit = 1u << 26;  // polls (seconds) before a wait is taken as lost
constexpr float kNegInf = -1e30f;
constexpr int kWBox = kBoxRows * kBK * 2;  // 8 KB

// The counters (ctrl, uint32): the barriers, the end count, the pieces of
// each (row, kv head), the tiles of o_proj, gate/up and down.
__host__ __device__ inline int ctrl_words(int batch, int h_kv, int hidden, int inter) {
  const int t2 = (hidden + kTileRows - 1) / kTileRows;
  const int t3 = (inter + kBoxRows - 1) / kBoxRows;
  return kBarriers + 1 + batch * h_kv + 2 * t2 + t3;
}

// ring stages: as many as shared memory holds (a stage is 19 KB at NB 8,
// 22 KB at NB 16)
template <int NB>
constexpr int kStagesOf = NB == 8 ? 11 : 10;

// The attention's buffers lie in the ring's last stages: the producer fills
// only the first kEarly stages until attention is done.
template <int D, int NB>
struct Layout {
  static constexpr int kStages = kStagesOf<NB>;
  static constexpr int kAct = kTerms * NB * kBK * 2;      // activation box
  static constexpr int kStage = 2 * kWBox + kAct;          // a multiple of 1024
  static constexpr int kRow = D + 8;                       // bf16 stride of a K / V row
  static constexpr int kBuf = (2 * kSub + kMaxRep) * kRow;  // bf16: K, V, the query rows
  static constexpr int kAttn = 2 * kBuf * 2 + kMaxRep * D * 4 + kMaxRep * kSub * 4 +
                               3 * kMaxRep * 4;
  static constexpr int kEarly = kStages - (kAttn + kStage - 1) / kStage;
  static constexpr int ring = 0;
  static constexpr int kv = kEarly * kStage;               // [2 buffers]
  static constexpr int q = kv + 2 * kBuf * 2;              // [rep][D] f32: q * scale
  static constexpr int s = q + kMaxRep * D * 4;            // [rep][kSub] f32
  static constexpr int m = s + kMaxRep * kSub * 4;         // [rep] running max
  static constexpr int l = m + kMaxRep * 4;                // [rep] running sum
  static constexpr int alpha = l + kMaxRep * 4;            // [rep] rescale
  static constexpr int red = kStages * kStage;             // [8 warps][16] f32
  static constexpr int rstd = red + 8 * kMaxBatch * 4;     // [16] f32
  static constexpr int flag = rstd + kMaxBatch * 4;        // int; then the attention's state
  static constexpr int idx = flag + 16;                    // attention: ints, see there
  static constexpr int bars = idx + (3 * kMaxBatch + 1 + 2 * kSub + 1) * 4 / 8 * 8;  // full, empty
  static constexpr int bytes = bars + 2 * kStages * 8;
  static constexpr int smem = 1024 + bytes;                // with the alignment pad
  static_assert(kStage % 1024 == 0, "ring stages start on 1024-byte boundaries");
  static_assert(alpha + kMaxRep * 4 <= red, "the attention's buffers fit the ring's last stages");
  static_assert(smem <= 232448, "shared memory of one block");
};

struct Params {
  const bf16* q;       // [B, H, D]
  const bf16* k;       // [P, Hkv, ps, D] one layer's pool slice
  const bf16* v;
  const int* tables;   // [B, max_pages]
  const int* pos;      // [B]
  const bf16* hres;    // [B, hidden]
  const bf16* w_post;  // [hidden]
  const bf16* w_next;  // [hidden]
  bf16* y;             // [B, hidden]
  bf16* h;             // [B, hidden]
  unsigned* ctrl;      // barrier, pair and tile counters: zero at the start, left zero
  float* att;          // attention pieces: (G + B Hkv) slots of rep (D + 2)
  bf16* o_terms;       // [3, B, H D]
  float* h1;           // [B, hidden]
  bf16* a_terms;       // [3, B, hidden]: h1 * w_post
  float* ss1;          // [T2, B] sums of h1^2 a tile
  float* part;         // (G + max T) slots of [NB][128] f32 partial tiles
  bf16* z_terms;       // [3, B, inter]
  float* h2;           // [B, hidden]
  float* ss2;          // [T4, B]
  unsigned long long* stamps;  // nullptr, or 6 globaltimer readings (ns)
  int batch, h_kv, rep, page_size, max_pages, hidden, inter;
  float eps_post, eps_next, scale;
};

__device__ __forceinline__ void stamp(const Params& p, int i) {
  if (p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.stamps[i] = t;
  }
}

// atomic add with release (and acquire) semantics at gpu scope: the
// block's writes before it (ordered by a block barrier) are seen by
// whoever reads the counter with acquire
__device__ __forceinline__ unsigned add_acq_rel(unsigned* p) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n" : "=r"(old) : "l"(p) : "memory");
  return old;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// first item of block w when W items are cut into G contiguous ranges
__device__ __forceinline__ int range_start(int w, int W, int G) {
  const unsigned long long n = (unsigned long long)W * w;
  return (int)(n >> 32 ? n / G : (unsigned)n / (unsigned)G);  // 32-bit division when it fits
}

// the block whose range holds item x
__device__ __forceinline__ int owner(int x, int W, int G) {
  const unsigned long long n = (unsigned long long)(x + 1) * G + W - 1;
  return (int)(n >> 32 ? n / W : (unsigned)n / (unsigned)W) - 1;
}

// whether block w's range holds an item (always when W >= G: no division)
__device__ __forceinline__ bool has_range(int w, int W, int G) {
  return W >= G || range_start(w, W, G) < range_start(w + 1, W, G);
}

// blocks lo..hi with an item: the pieces of a tile or a (row, kv head)
__device__ __forceinline__ int count_parts(int lo, int hi, int W, int G) {
  if (W >= G) return hi - lo + 1;
  int n = 0;
  for (int w = lo; w <= hi; ++w) n += has_range(w, W, G);
  return n;
}

// 16 bytes from global to shared memory, asynchronously; `ok` false writes
// 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hp::smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v as hi + mid + lo, three bf16 terms (exact save for an underflow of lo),
// stored at terms[t * plane + i]
__device__ __forceinline__ void store_terms(bf16* terms, size_t plane, size_t i, float v) {
  const bf16 hi = __float2bfloat16_rn(v);
  const float r1 = v - __bfloat162float(hi);
  const bf16 mid = __float2bfloat16_rn(r1);
  const float r2 = r1 - __bfloat162float(mid);
  terms[i] = hi;
  terms[plane + i] = mid;
  terms[2 * plane + i] = __float2bfloat16_rn(r2);
}

// the same for two neighbouring values, as bf16 pairs
__device__ __forceinline__ void store_terms2(bf16* terms, size_t plane, size_t i, float v0,
                                             float v1) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(hi);
  const float r0 = v0 - hf.x, r1 = v1 - hf.y;
  const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(mid);
  *reinterpret_cast<__nv_bfloat162*>(terms + i) = hi;
  *reinterpret_cast<__nv_bfloat162*>(terms + plane + i) = mid;
  *reinterpret_cast<__nv_bfloat162*>(terms + 2 * plane + i) =
      __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
}

// The consumers' grid barrier `i`: every consumer thread's writes before it
// (fenced for the async proxy too) are seen by every block after it.
__device__ __forceinline__ void grid_barrier(const Params& p, int i) {
  hp::fence_proxy_async_global();
  hp::bar_sync(1, kCons);
  if (threadIdx.x == 0) {
    add_acq_rel(p.ctrl + i);
    // spin without sleeping: a sleeping poller wakes microseconds late
    for (unsigned n = 0; ld_acquire(p.ctrl + i) < gridDim.x; ++n)
      if (n > kSpinLimit) __trap();  // a lost block: fail loudly, never hang
  }
  hp::bar_sync(1, kCons);
}

// The tile-completion handshake after a block wrote its partial of a tile
// (or an attention piece) with `parts` pieces in all: true in every
// consumer thread of the block that finished last, which then sees every
// other piece.
__device__ __forceinline__ bool last_piece(unsigned* ctr, int parts, int* flag) {
  hp::bar_sync(1, kCons);
  if (threadIdx.x == 0) {
    *flag = parts <= 1 || add_acq_rel(ctr) == (unsigned)(parts - 1);
  }
  hp::bar_sync(1, kCons);
  return *flag != 0;
}

// rstd[b] = rsqrt(sum over n_tiles of ss[t * batch + b] / K + eps), in tile
// order, for every row; ends with a consumer barrier
__device__ __forceinline__ void rstd_rows(const float* ss, int n_tiles, int batch, int K, float eps,
                                          float* rstd) {
  if (threadIdx.x < batch) {
    float t = 0.f;
    for (int i = 0; i < n_tiles; ++i) t += __ldcg(ss + (size_t)i * batch + threadIdx.x);
    rstd[threadIdx.x] = rsqrtf(t / (float)K + eps);
  }
  hp::bar_sync(1, kCons);
}

// ---- phase 1: attention --------------------------------------------------------

// Work is cut so that a step's chains stay short whatever rep: the scores of
// (head, position) split their D over spl adjacent lanes (rep * kSub < 256),
// and the products with V split a (head, column pair)'s positions over spv
// adjacent lanes (rep * D / 2 < 256), each lane keeping its partial sums
// until the piece ends.
template <int D, int NB>
__device__ void attention(const Params& p, unsigned char* smem) {
  using L = Layout<D, NB>;
  constexpr int CPR = D / 8;            // 16-byte chunks of a K / V / q row
  constexpr int kRowsPass = kCons / CPR;  // rows a pass of the copies covers
  constexpr int kItems = 2;             // PV items a thread: rep * D / 2 * spv <= 512
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, w = blockIdx.x;
  const int rep = p.rep, h_kv = p.h_kv, heads = h_kv * rep;
  const int hd_in = heads * D;
  const int t_cap = p.max_pages * p.page_size;
  bf16* kv = reinterpret_cast<bf16*>(smem + L::kv);
  float* sq = reinterpret_cast<float*>(smem + L::q);
  float* ssc = reinterpret_cast<float*>(smem + L::s);
  float* sm = reinterpret_cast<float*>(smem + L::m);
  float* sl = reinterpret_cast<float*>(smem + L::l);
  float* sa = reinterpret_cast<float*>(smem + L::alpha);
  int* flag = reinterpret_cast<int*>(smem + L::flag);
  unsigned* pair_ctr = p.ctrl + kBarriers + 1;
  const size_t plane = (size_t)p.batch * hd_in;
  const int n_sc = rep * kSub, spl = n_sc >= kCons ? 1 : kCons / n_sc;
  const int n_pv = rep * D / 2, spv = n_pv >= kCons ? 1 : kCons / n_pv;

  // each row's positions and sub-chunks (at least one: an empty row writes
  // zeros), the flattened list's offsets, and two steps' page entries
  int* npos = reinterpret_cast<int*>(smem + L::idx);
  int* nsub = npos + kMaxBatch;
  int* off = nsub + kMaxBatch;
  int* pg = off + kMaxBatch + 1;  // [2][kSub]
  if (tid < kMaxBatch) {
    const int n = tid < p.batch ? min(max(p.pos[tid] + 1, 0), t_cap) : 0;
    npos[tid] = n;
    nsub[tid] = tid < p.batch ? max(1, (n + kSub - 1) / kSub) : 0;
  }
  hp::bar_sync(1, kCons);
  if (tid == 0) {
    off[0] = 0;
    for (int b = 0; b < kMaxBatch; ++b) off[b + 1] = off[b] + nsub[b] * h_kv;
  }
  hp::bar_sync(1, kCons);
  const int total = off[kMaxBatch];
  const int s0 = range_start(w, total, G), n_steps = range_start(w + 1, total, G) - s0;

  // (row, kv head, sub-chunk) of list item x; `next` steps it by one
  struct Cursor {
    int b, g, c;
  };
  auto locate = [&](int x) {
    Cursor u{0, 0, 0};
    for (int i = 1; i < p.batch; ++i)
      if (x >= off[i]) u.b = i;
    const int r = x - off[u.b];
    u.g = r / nsub[u.b];
    u.c = r % nsub[u.b];
    return u;
  };
  auto next = [&](Cursor u) {
    if (++u.c == nsub[u.b]) {
      u.c = 0;
      if (++u.g == h_kv) {
        u.g = 0;
        ++u.b;
      }
    }
    return u;
  };
  // step i's page entry of position row tid (tid < kSub; -1 past the row's
  // positions), read a step before its copies are issued
  auto page_of = [&](int i, Cursor u) {
    int page = -1;
    if (i < n_steps && tid < kSub) {
      const int t = u.c * kSub + tid;
      if (t < npos[u.b]) page = __ldg(p.tables + (size_t)u.b * p.max_pages + t / p.page_size);
    }
    return page;
  };
  // step i's keys, values and rep query rows into buffer i % 2, its page
  // entries already in pg[i % 2]: CPR lanes copy a row, so a warp's copies
  // cover whole rows
  auto issue = [&](int i, Cursor u) {
    if (i < n_steps) {
      const int b = u.b, g = u.g, c = u.c;
      bf16* buf = kv + (i & 1) * L::kBuf;
      const int* pgi = pg + (i & 1) * kSub;
      const int ch = tid % CPR;
#pragma unroll
      for (int pass = 0; pass < kSub / kRowsPass; ++pass) {
        const int r = pass * kRowsPass + tid / CPR;
        const int page = pgi[r];
        const bool ok = page >= 0;
        const size_t src =
            ok ? (((size_t)page * h_kv + g) * p.page_size + (c * kSub + r) % p.page_size) * D : 0;
        cp_async16(buf + r * L::kRow + ch * 8, p.k + src + ch * 8, ok);
        cp_async16(buf + (kSub + r) * L::kRow + ch * 8, p.v + src + ch * 8, ok);
      }
      const bf16* q = p.q + ((size_t)b * heads + g * rep) * D;
      for (int it = tid; it < rep * CPR; it += kCons)
        cp_async16(buf + (2 * kSub + it / CPR) * L::kRow + (it % CPR) * 8,
                   q + (it / CPR) * D + (it % CPR) * 8, true);
    }
    cp_async_commit();
  };

  float o[kItems][2];
  volatile int* state = flag + 1;  // the producer's gate (see producer)
  Cursor cur = locate(s0), cur1 = next(cur);  // steps i and i + 1
  {
    const int p0 = page_of(0, cur), p1 = page_of(1, cur1);
    if (tid < kSub) {
      pg[tid] = p0;
      pg[kSub + tid] = p1;
    }
    hp::bar_sync(1, kCons);
  }
  issue(0, cur);
  issue(1, cur1);
  if (n_steps == 0 && tid == 0) *state = 1;
  int seg_start = 0;  // step at which the current (row, kv head) piece began
  for (int i = 0; i < n_steps; ++i) {
    const int b = cur.b, g = cur.g, c = cur.c;
    const int n_pos = npos[b];
    const bf16* kb = kv + (i & 1) * L::kBuf;
    const bf16* vb = kb + kSub * L::kRow;
    const bf16* qb = vb + kSub * L::kRow;
    const Cursor cur2 = next(cur1);
    const int next_page = page_of(i + 2, cur2);  // in flight while this step computes
    if (i == 0 || c == 0) {
      // a new piece: a fresh softmax state
      seg_start = i;
      if (tid < rep) {
        sm[tid] = kNegInf;
        sl[tid] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) o[j][0] = o[j][1] = 0.f;
    }
    cp_async_wait<1>();
    hp::bar_sync(1, kCons);
    // the first keys and values are in: the producer may start the weights
    if (i == 0 && tid == 0) *state = 1;
    if (i == seg_start) {
      // the piece's queries, scaled, in f32 once
      for (int it = tid; it < rep * D; it += kCons)
        sq[it] = __bfloat162float(qb[(it / D) * L::kRow + it % D]) * p.scale;
      hp::bar_sync(1, kCons);
    }
    // scores of (head, position): q * scale (f32) dotted with the key, D
    // split over spl adjacent lanes
    for (int base = 0; base < n_sc * spl; base += kCons) {
      const int it = (base + tid) / spl, part = (base + tid) % spl;
      const int hh = it / kSub, r = it % kSub;
      float s0 = 0.f, s1 = 0.f;
      const float4* q4 = reinterpret_cast<const float4*>(sq + hh * D);
      // chunks part, part + spl, ...: the spl lanes read neighbouring chunks
      const bf16* kr0 = kb + r * L::kRow;
#pragma unroll 2
      for (int d8 = part; d8 < D / 8; d8 += spl) {
        const uint4 kr = *reinterpret_cast<const uint4*>(kr0 + d8 * 8);
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kr);
        const float4 qa = q4[2 * d8], qc = q4[2 * d8 + 1];
        float2 f = __bfloat1622float2(k2[0]);
        s0 = fmaf(qa.x, f.x, s0);
        s1 = fmaf(qa.y, f.y, s1);
        f = __bfloat1622float2(k2[1]);
        s0 = fmaf(qa.z, f.x, s0);
        s1 = fmaf(qa.w, f.y, s1);
        f = __bfloat1622float2(k2[2]);
        s0 = fmaf(qc.x, f.x, s0);
        s1 = fmaf(qc.y, f.y, s1);
        f = __bfloat1622float2(k2[3]);
        s0 = fmaf(qc.z, f.x, s0);
        s1 = fmaf(qc.w, f.y, s1);
      }
      float s = s0 + s1;
      for (int o2 = 1; o2 < spl; o2 <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o2);
      if (part == 0) ssc[it] = c * kSub + r < n_pos ? s : kNegInf;
    }
    hp::bar_sync(1, kCons);
    // online softmax: warp h updates head h's state and turns scores into
    // probabilities
    if (warp < rep) {
      const int valid = min(n_pos - c * kSub, kSub);
      const float s_a = ssc[warp * kSub + lane];
      const float s_b = kSub > 32 ? ssc[warp * kSub + 32 + lane] : kNegInf;
      float mx = fmaxf(s_a, s_b);
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
      const float m_old = sm[warp];
      const float m_new = fmaxf(m_old, mx);
      const float p_a = lane < valid ? __expf(s_a - m_new) : 0.f;
      const float p_b = 32 + lane < valid ? __expf(s_b - m_new) : 0.f;
      ssc[warp * kSub + lane] = p_a;
      if (kSub > 32) ssc[warp * kSub + 32 + lane] = p_b;
      const float sum = ptt::warp_sum(p_a + p_b);
      if (lane == 0) {
        const float a = __expf(m_old - m_new);
        sa[warp] = a;
        sl[warp] = sl[warp] * a + sum;
        sm[warp] = m_new;
      }
    }
    hp::bar_sync(1, kCons);
    // the products with V: (head, column pair) items, their positions split
    // over spv adjacent lanes (partial sums kept per lane)
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int t = j * kCons + tid;
      if (t < n_pv * spv) {
        const int it = t / spv, qtr = t % spv;
        const int hh = it / (D / 2), dp = it % (D / 2);
        const float a = sa[hh];
        // two interleaved chains: positions r and r + spv (kSub / spv is even)
        float o0a = o[j][0] * a, o1a = o[j][1] * a, o0b = 0.f, o1b = 0.f;
        const float* pr = ssc + hh * kSub;
        const bf16* vc = vb + 2 * dp;
#pragma unroll 2
        for (int r = qtr; r < kSub; r += 2 * spv) {
          const float2 va = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vc + r * L::kRow));
          const float2 vv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vc + (r + spv) * L::kRow));
          o0a = fmaf(pr[r], va.x, o0a);
          o1a = fmaf(pr[r], va.y, o1a);
          o0b = fmaf(pr[r + spv], vv.x, o0b);
          o1b = fmaf(pr[r + spv], vv.y, o1b);
        }
        o[j][0] = o0a + o0b;
        o[j][1] = o1a + o1b;
      }
    }
    if (i == n_steps - 1 || c == nsub[b] - 1) {
      // the piece ends: the lanes of an item add their partial sums; whole,
      // the piece writes its output; else its state, and the last piece of
      // (b, g) to finish merges them in range order
      float ot[kItems][2];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        ot[j][0] = o[j][0];
        ot[j][1] = o[j][1];
        for (int o2 = 1; o2 < spv; o2 <<= 1) {
          ot[j][0] += __shfl_xor_sync(0xffffffffu, ot[j][0], o2);
          ot[j][1] += __shfl_xor_sync(0xffffffffu, ot[j][1], o2);
        }
      }
      const int q_idx = b * h_kv + g;
      const int first = off[b] + g * nsub[b];
      const bool whole = c == nsub[b] - 1 && c == i - seg_start;
      const int w_lo = owner(first, total, G);
      const int w_hi = owner(first + nsub[b] - 1, total, G);
      const int slot_floats = rep * (D + 2);
      bool write_out = whole;
      if (!whole) {
        float* slot = p.att + (size_t)(w + q_idx) * slot_floats;
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const int t = j * kCons + tid;
          if (t < n_pv * spv && t % spv == 0) {
            const int it = t / spv, hh = it / (D / 2), dp = it % (D / 2);
            __stcg(reinterpret_cast<float2*>(slot + hh * D + 2 * dp),
                   make_float2(ot[j][0], ot[j][1]));
          }
        }
        if (tid < rep) {
          slot[rep * D + tid] = sm[tid];
          slot[rep * D + rep + tid] = sl[tid];
        }
        write_out = last_piece(pair_ctr + q_idx, count_parts(w_lo, w_hi, total, G), flag);
      }
      if (write_out) {
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const int t = j * kCons + tid;
          if (t < n_pv * spv && t % spv == 0) {
            const int it = t / spv, hh = it / (D / 2), dp = it % (D / 2);
            float o0, o1, lsum;
            if (whole) {
              o0 = ot[j][0];
              o1 = ot[j][1];
              lsum = sl[hh];
            } else {
              // eight pieces' loads at a time, merged in range order
              // (an online rescale: one pass over the pieces)
              float mx = kNegInf;
              o0 = o1 = lsum = 0.f;
              for (int w0 = w_lo; w0 <= w_hi; w0 += 8) {
                float m8[8], l8[8];
                float2 a8[8];
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                  const bool on = w0 + u <= w_hi && has_range(w0 + u, total, G);
                  const float* sl2 = p.att + (size_t)(w0 + u + q_idx) * slot_floats;
                  m8[u] = on ? __ldcg(sl2 + rep * D + hh) : kNegInf;
                  l8[u] = on ? __ldcg(sl2 + rep * D + rep + hh) : 0.f;
                  a8[u] = on ? __ldcg(reinterpret_cast<const float2*>(sl2 + hh * D + 2 * dp))
                             : make_float2(0.f, 0.f);
                }
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                  const float m_new = fmaxf(mx, m8[u]);
                  const float cf = __expf(mx - m_new), e = __expf(m8[u] - m_new);
                  lsum = lsum * cf + l8[u] * e;
                  o0 = o0 * cf + a8[u].x * e;
                  o1 = o1 * cf + a8[u].y * e;
                  mx = m_new;
                }
              }
            }
            const float inv = 1.f / fmaxf(lsum, 1e-30f);
            store_terms2(p.o_terms, plane, (size_t)b * hd_in + (g * rep + hh) * D + 2 * dp,
                         o0 * inv, o1 * inv);
          }
        }
      }
    }
    if (tid < kSub) pg[(i & 1) * kSub + tid] = next_page;
    hp::bar_sync(1, kCons);  // the buffer, the probabilities, the state and pg are ready
    issue(i + 2, cur2);
    cur = cur1;
    cur1 = cur2;
  }
  cp_async_wait<0>();
  // the buffers go back to the ring: this thread's reads of them come
  // before the producer's TMA writes
  hp::fence_proxy_async();
  hp::bar_sync(1, kCons);
  if (tid == 0) *state = 2;
}

// ---- phases 2-4: the matrix-vector products on the tensor cores ---------------

// A phase's geometry: k boxes a tile, stages in all, and this block's range
// of them.
struct Phase {
  int kb, W;  // W = tiles * kb
  int s0, n;
};

__device__ __forceinline__ Phase make_phase(int tiles, int K) {
  Phase ph;
  ph.kb = (K + kBK - 1) / kBK;
  ph.W = tiles * ph.kb;
  ph.s0 = range_start(blockIdx.x, ph.W, gridDim.x);
  ph.n = range_start(blockIdx.x + 1, ph.W, gridDim.x) - ph.s0;
  return ph;
}

struct Maps {
  CUtensorMap wo, wg, wu, wd, o_terms, a_terms, z_terms;
};

// the producer thread: every weight box of phases 2-4 as soon as its ring
// stage is free, and each stage's activation box once the barrier before
// its phase has passed
template <int D, int NB>
__device__ void producer(const Params& p, const Maps* mp, unsigned char* smem, uint64_t* full,
                         uint64_t* empty, const Phase (&ph)[3]) {
  using L = Layout<D, NB>;
  constexpr int kStages = L::kStages;
  const int total = ph[0].n + ph[1].n + ph[2].n;
  const unsigned G = gridDim.x;
  // the attention's state: 0 until its first copies are issued (their
  // loads go ahead of the weights'), 1 while its buffers hold the ring's
  // last stages, 2 once they are free
  const volatile int* state = reinterpret_cast<const volatile int*>(smem + L::flag + 4);
  unsigned passed = 0;  // bit f: the barrier before phase f has passed
  // stage j's phase f, its item x and the phase's k boxes a tile (selects,
  // not an indexed array, so nothing goes to local memory)
  auto locate = [&](int j, int& f, int& x, int& kb) {
    f = j < ph[0].n ? 0 : j < ph[0].n + ph[1].n ? 1 : 2;
    x = f == 0 ? ph[0].s0 + j : f == 1 ? ph[1].s0 + j - ph[0].n : ph[2].s0 + j - ph[0].n - ph[1].n;
    kb = f == 0 ? ph[0].kb : f == 1 ? ph[1].kb : ph[2].kb;
  };
  auto issue_w = [&](int j) {
    int f, x, kb;
    locate(j, f, x, kb);
    const int t = x / kb, k0 = (x % kb) * kBK;
    unsigned char* st = smem + L::ring + (j % kStages) * L::kStage;
    uint64_t* bar = &full[j % kStages];
    if (f == 1) {
      hp::mbar_arrive_expect_tx(bar, 2 * kWBox);
      hp::tma_load_2d(st, &mp->wg, bar, k0, t * kBoxRows);
      hp::tma_load_2d(st + kWBox, &mp->wu, bar, k0, t * kBoxRows);
    } else {
      const CUtensorMap* m = f == 0 ? &mp->wo : &mp->wd;
      const int r0 = t * kTileRows;
      const bool second = r0 + kBoxRows < p.hidden;  // else wholly past the rows: never stored
      hp::mbar_arrive_expect_tx(bar, second ? 2 * kWBox : kWBox);
      hp::tma_load_2d(st, m, bar, k0, r0);
      if (second) hp::tma_load_2d(st + kWBox, m, bar, k0, r0 + kBoxRows);
    }
  };
  auto issue_a = [&](int j) {
    int f, x, kb;
    locate(j, f, x, kb);
    const int k0 = (x % kb) * kBK;
    unsigned char* st = smem + L::ring + (j % kStages) * L::kStage;
    uint64_t* bar = &full[j % kStages];
    const CUtensorMap* m = f == 0 ? &mp->o_terms : f == 1 ? &mp->a_terms : &mp->z_terms;
    hp::mbar_arrive_expect_tx(bar, L::kAct);
    hp::tma_load_3d(st + 2 * kWBox, m, bar, k0, 0, 0);
  };
  int jw = 0, ja = 0;
  unsigned idle = 0;
  while (ja < total) {
    // weights kIssue stages at a time (consecutive k boxes of the same rows
    // reach the memory together)
    for (;;) {
      const int st_now = *state;
      const int cap = st_now >= 2 ? total : st_now == 1 ? min(total, L::kEarly) : 0;
      const int last = min(jw + kIssue, cap) - 1;
      if (jw >= cap || (last >= kStages &&
                        !hp::mbar_test(&empty[last % kStages], ((last / kStages) - 1) & 1)))
        break;
      for (; jw <= last; ++jw) issue_w(jw);
    }
    if (ja < jw) {
      int f, x, kb;
      locate(ja, f, x, kb);
      if (!(passed >> f & 1u)) {
        // the barrier before phase f: poll it (and the ring, above) without
        // sleeping, a sleeping poller wakes microseconds late
        if (ld_acquire(p.ctrl + f) < G) {
          if (++idle > kSpinLimit) __trap();  // as grid_barrier
          continue;
        }
        passed |= 1u << f;
        hp::fence_proxy_async_global();
      }
      issue_a(ja++);
      idle = 0;
      continue;
    }
    // every issued stage has its activations: wait for the next free stage
    // (the wait wakes as the consumers release it)
    if (jw == total) continue;
    const int last = min(jw + kIssue, total) - 1;
    if (last >= kStages) hp::mbar_wait(&empty[last % kStages], ((last / kStages) - 1) & 1);
  }
}

// Phase f's stages on the consumers (`pre(t)` prefetches tile t's epilogue
// inputs into L2 while the block learns whether it is the last of the
// tile): warpgroup cw multiplies box cw of each
// stage by the activation box, whose 3 NB rows (hi, mid, lo of each batch
// row) are one wgmma's N, one group in flight behind the current one; at
// the end of a tile (or of the range) the block's partial, hi + mid + lo,
// goes to its slot (block + tile) and the last block of the tile runs
// `epi(t, first, last, W)` over the tile's partials (blocks first..last
// that hold an item of the W).
template <int NB, class Pre, class Epi>
__device__ void consume(const Phase& ph, unsigned char* ring, int stage_bytes, uint64_t* full,
                        uint64_t* empty, int& j, float* part, unsigned* tile_ctr, int* flag,
                        Pre pre, Epi epi) {
  constexpr int N = kTerms * NB;
  constexpr int kStages = kStagesOf<NB>;
  const int tid = threadIdx.x, cw = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int G = gridDim.x, w = blockIdx.x;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < ph.n;) {
    // the stages of one tile: the range's or the tile's end
    const int x0 = ph.s0 + i, t = x0 / ph.kb;
    const int len = min(ph.kb - x0 % ph.kb, ph.n - i);
    int prev = 0;
    for (int s = 0; s < len; ++s, ++j) {
      const int st = j % kStages;
      hp::mbar_wait(&full[st], (j / kStages) & 1);
      const uint32_t wa = hp::smem_u32(ring + st * stage_bytes + cw * kWBox);
      const uint32_t xa = hp::smem_u32(ring + st * stage_bytes + 2 * kWBox);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        hp::Wgmma<N>::template ss<0>(acc, hp::desc_kmajor(wa + kk * 32),
                                     hp::desc_kmajor(xa + kk * 32), s > 0 || kk > 0);
      hp::wgmma_commit();
      hp::fence_acc<N / 2>(acc);
      hp::wgmma_wait<1>();  // the previous stage's products are done: it goes back
      hp::fence_acc<N / 2>(acc);
      __syncwarp();
      if (lane == 0 && s > 0) hp::mbar_arrive(&empty[prev]);
      prev = st;
    }
    hp::fence_acc<N / 2>(acc);
    hp::wgmma_wait<0>();
    hp::fence_acc<N / 2>(acc);
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[prev]);
    // element e of a thread: weight row 16 (warp % 4) + lane / 4 +
    // 8 ((e / 2) % 2) of the box, column 8 (e / 4) + 2 (lane % 4) + e % 2:
    // term column / NB of batch row column % NB
    float* slot = part + (size_t)(w + t) * (NB * kTileRows);
    const int row = cw * kBoxRows + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
    for (int e = 0; e < NB / 2; ++e) {
      const int b = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
      __stcg(slot + b * kTileRows + row + 8 * ((e >> 1) & 1),
             (acc[e + NB] + acc[e + NB / 2]) + acc[e]);
    }
    const int lo = owner(t * ph.kb, ph.W, G), hi = owner(t * ph.kb + ph.kb - 1, ph.W, G);
    const int parts = count_parts(lo, hi, ph.W, G);
    if (parts > 1) pre(t);
    if (last_piece(tile_ctr + t, parts, flag)) epi(t, lo, hi, ph.W);
    i += len;
  }
}

// Tile t's sums over blocks lo..hi (those with an item of the W), in block
// order, of elements (b0 + step k, row) for k < K (K2 = K / 2 and rows row,
// row + row2 when row2 > 0): out[k] (rows of batch past `batch` are left 0);
// four or eight blocks' loads are issued together
template <int NB, int K>
__device__ __forceinline__ void tile_sums(const float* part, int t, int lo, int hi, int W, int b0,
                                          int step, int batch, int row, float (&out)[K],
                                          int row2 = 0) {
  const int G = gridDim.x;
  const int KB = row2 > 0 ? K / 2 : K;  // batch rows
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = 0.f;
  constexpr int U = K >= 8 ? 4 : 8;  // blocks a round
  for (int w0 = lo; w0 <= hi; w0 += U) {
    float v[U][K];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool on = w0 + u <= hi && has_range(w0 + u, W, G);
      const float* slot = part + (size_t)(w0 + u + t) * (NB * kTileRows) + row;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int kb = k < KB ? k : k - KB;
        const int off = (b0 + step * kb) * kTileRows + (k < KB ? 0 : row2);
        v[u][k] = on && b0 + step * kb < batch ? __ldcg(slot + off) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < K; ++k) out[k] += v[u][k];
  }
}

// o_proj / down epilogue of tile t: out = sum + res for the tile's rows,
// the tile's sums of out^2 a batch row into ss[t * batch + b] (rows of a
// warp by a shuffle tree, the 4 warps of a row parity in order), and, for
// o_proj, the terms of out * w_post (extra(b, n, out * extra_w(n)))
template <int NB, class Res, class ExtraW, class Extra>
__device__ void residual_epilogue(const Params& p, const float* part, int t, int lo, int hi,
                                  int W, float* out, Res res, float* ss, float* red,
                                  ExtraW extra_w, Extra extra) {
  constexpr int K = NB / 2;  // batch rows a thread: par, par + 2, ...
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = tid & (kTileRows - 1), par = tid >> 7;
  const int n = t * kTileRows + r;
  // the residual first: its loads need no other block and fly with the
  // partials'
  float rv[K], sum[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int b = par + 2 * k;
    rv[k] = b < p.batch && n < p.hidden ? res((size_t)b * p.hidden + n) : 0.f;
  }
  const float wn = n < p.hidden ? extra_w(n) : 0.f;
  tile_sums<NB, K>(part, t, lo, hi, W, par, 2, n < p.hidden ? p.batch : 0, r, sum);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int b = par + 2 * k;
    float sq = 0.f;
    if (b < p.batch && n < p.hidden) {
      const size_t i = (size_t)b * p.hidden + n;
      const float v = sum[k] + rv[k];
      out[i] = v;
      extra(b, n, v * wn);
      sq = v * v;
    }
    sq = ptt::warp_sum(sq);
    if (lane == 0) red[warp * kMaxBatch + k] = sq;
  }
  hp::bar_sync(1, kCons);
  if (tid < p.batch) {
    const int b = tid, k = b >> 1, w0 = (b & 1) * 4;
    float s = 0.f;
#pragma unroll
    for (int ww = 0; ww < 4; ++ww) s += red[(w0 + ww) * kMaxBatch + k];
    ss[(size_t)t * p.batch + b] = s;
  }
  hp::bar_sync(1, kCons);
}

template <int D, int NB>
__global__ void __launch_bounds__(kThreads, 1)
    decode_layer_wgmma_kernel(const Params p, const __grid_constant__ Maps maps) {
  using L = Layout<D, NB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (hp::smem_u32(smem_raw) & 1023u)) & 1023u);
  constexpr int kStages = L::kStages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + kStages;
  float* red = reinterpret_cast<float*>(smem + L::red);
  float* rstd = reinterpret_cast<float*>(smem + L::rstd);
  int* flag = reinterpret_cast<int*>(smem + L::flag);
  const int tid = threadIdx.x;
  const int hd_in = p.h_kv * p.rep * D;
  const int t2 = (p.hidden + kTileRows - 1) / kTileRows;
  const int t3 = (p.inter + kBoxRows - 1) / kBoxRows;
  const Phase ph[3] = {make_phase(t2, hd_in), make_phase(t3, p.hidden), make_phase(t2, p.inter)};
  unsigned* tile_ctr2 = p.ctrl + kBarriers + 1 + p.batch * p.h_kv;
  unsigned* tile_ctr3 = tile_ctr2 + t2;
  unsigned* tile_ctr4 = tile_ctr3 + t3;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 2);   // the weight's and the activations' arrivals
      hp::mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    hp::mbar_fence_init();
    flag[1] = 0;  // the attention's state (see producer)
  }
  __syncthreads();
  if (tid >= kCons) {
    if (tid == kCons) {
      hp::prefetch_tensormap(&maps.wo);
      hp::prefetch_tensormap(&maps.wg);
      hp::prefetch_tensormap(&maps.wu);
      hp::prefetch_tensormap(&maps.wd);
      producer<D, NB>(p, &maps, smem, full, empty, ph);
    }
    return;
  }

  stamp(p, 0);
  attention<D, NB>(p, smem);
  grid_barrier(p, 0);
  stamp(p, 1);

  const size_t plane_h = (size_t)p.batch * p.hidden;
  int j = 0;  // the ring's sequence
  // 2. o_proj + residual -> h1, its squares, the terms of h1 * w_post
  // a thread's rows of a residual epilogue: r = tid % 128, batch rows par + 2k
  auto pre_rows = [&](const void* base, int elem, int t) {
    const int n = t * kTileRows + (tid & (kTileRows - 1));
    if (n < p.hidden)
      for (int b = tid >> 7; b < p.batch; b += 2)
        prefetch_l2(static_cast<const char*>(base) + ((size_t)b * p.hidden + n) * elem);
  };
  consume<NB>(ph[0], smem + L::ring, L::kStage, full, empty, j, p.part, tile_ctr2, flag,
              [&](int t) {
                pre_rows(p.hres, 2, t);
                const int n = t * kTileRows + (tid & (kTileRows - 1));
                if (n < p.hidden && tid < kTileRows) prefetch_l2(p.w_post + n);
              },
              [&](int t, int lo, int hi, int W) {
                residual_epilogue<NB>(
                    p, p.part, t, lo, hi, W, p.h1,
                    [&](size_t i) { return __bfloat162float(p.hres[i]); }, p.ss1, red,
                    [&](int n) { return __bfloat162float(__ldg(p.w_post + n)); },
                    [&](int b, int n, float v) {
                      store_terms(p.a_terms, plane_h, (size_t)b * p.hidden + n, v);
                    });
              });
  grid_barrier(p, 1);
  stamp(p, 2);

  // 3. gate/up: g and u of tile t's 64 columns (rows 0-63 and 64-127 of its
  //    partials), scaled by the row's rsqrt; z = silu(g) u as terms
  rstd_rows(p.ss1, t2, p.batch, p.hidden, p.eps_post, rstd);
  {
    const size_t plane_z = (size_t)p.batch * p.inter;
    consume<NB>(ph[1], smem + L::ring, L::kStage, full, empty, j, p.part, tile_ctr3, flag,
                [](int) {},
                [&](int t, int lo, int hi, int W) {
                  constexpr int K = NB / 4;  // batch rows a thread: bg, bg + 4, ...
                  const int r = tid & (kBoxRows - 1), bg = tid >> 6;
                  const int n = t * kBoxRows + r;
                  const int nb = n < p.inter ? p.batch : 0;
                  float gu[2 * K];  // rows r (g) and 64 + r (u), one round of loads
                  tile_sums<NB, 2 * K>(p.part, t, lo, hi, W, bg, 4, nb, r, gu, kBoxRows);
                  const float* g = gu;
                  const float* u = gu + K;
#pragma unroll
                  for (int k = 0; k < K; ++k) {
                    const int b = bg + 4 * k;
                    if (b < nb) {
                      const float gs = rstd[b] * g[k], us = rstd[b] * u[k];
                      store_terms(p.z_terms, plane_z, (size_t)b * p.inter + n,
                                  gs / (1.f + expf(-gs)) * us);
                    }
                  }
                });
  }
  grid_barrier(p, 2);
  stamp(p, 3);

  // 4. down + residual -> h2 and its squares
  consume<NB>(ph[2], smem + L::ring, L::kStage, full, empty, j, p.part, tile_ctr4, flag,
              [&](int t) { pre_rows(p.h1, 4, t); },
              [&](int t, int lo, int hi, int W) {
                residual_epilogue<NB>(
                    p, p.part, t, lo, hi, W, p.h2, [&](size_t i) { return __ldcg(p.h1 + i); },
                    p.ss2, red, [](int) { return 0.f; }, [](int, int, float) {});
              });
  grid_barrier(p, 3);
  stamp(p, 4);

  // 5. y = rmsnorm(h2) * w_next, h = h2, cast once
  rstd_rows(p.ss2, t2, p.batch, p.hidden, p.eps_next, rstd);
  for (size_t i = (size_t)blockIdx.x * kCons + tid; i < plane_h; i += (size_t)gridDim.x * kCons) {
    const int b = (int)(i / p.hidden), n = (int)(i % p.hidden);
    const float v = __ldcg(p.h2 + i);
    p.y[i] = __float2bfloat16(v * rstd[b] * __bfloat162float(p.w_next[n]));
    p.h[i] = __float2bfloat16(v);
  }
  stamp(p, 5);
  // the last block to finish leaves every counter zero for the next call
  // (nothing reads them any more: every block is past the last barrier,
  // every producer done)
  hp::bar_sync(1, kCons);
  if (tid == 0) {
    unsigned* end = p.ctrl + kBarriers;
    *flag = add_acq_rel(end) == gridDim.x - 1;
  }
  hp::bar_sync(1, kCons);
  if (*flag) {
    const int n = ctrl_words(p.batch, p.h_kv, p.hidden, p.inter);
    for (int i = tid; i < n; i += kCons) p.ctrl[i] = 0u;
  }
}

// The scratch's regions, in floats from its start, each on a 256-byte
// boundary (TMA bases and 16-byte accesses).
struct Scratch {
  size_t att, o_terms, h1, a_terms, ss1, part, z_terms, h2, ss2, total;
};

inline size_t up64(size_t n) { return (n + 63) / 64 * 64; }

inline Scratch scratch_layout(int G, int batch, int h_kv, int rep, int head_dim, int hidden,
                              int inter) {
  const int nb = batch <= 8 ? 8 : 16;
  const size_t hd_in = (size_t)h_kv * rep * head_dim;
  const size_t t2 = (hidden + kTileRows - 1) / kTileRows;
  const size_t t3 = (inter + kBoxRows - 1) / kBoxRows;
  Scratch s;
  size_t at = 0;
  auto take = [&](size_t floats) {
    const size_t here = at;
    at += up64(floats);
    return here;
  };
  s.att = take((size_t)(G + batch * h_kv) * rep * (head_dim + 2));
  s.o_terms = take(kTerms * batch * hd_in / 2);
  s.h1 = take((size_t)batch * hidden);
  s.a_terms = take((size_t)kTerms * batch * hidden / 2);
  s.ss1 = take(t2 * batch);
  s.part = take((size_t)(G + (t3 > t2 ? t3 : t2)) * nb * kTileRows);
  s.z_terms = take((size_t)kTerms * batch * inter / 2);
  s.h2 = take((size_t)batch * hidden);
  s.ss2 = take(t2 * batch);
  s.total = at;
  return s;
}

inline int device_sms(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

template <int D, int NB>
int launch(Params p, const bf16* wo, const bf16* wg, const bf16* wu, const bf16* wd,
           float* scratch, unsigned* ctrl, cudaStream_t stream) {
  using L = Layout<D, NB>;
  auto kern = decode_layer_wgmma_kernel<D, NB>;
  static int grid_of[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int grid = dev < kMaxDevices ? grid_of[dev] : 0;
  if (grid == 0) {
    // the dynamic-shared-memory attribute must be set before the
    // occupancy query, or the query reads the 48 KB default
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::smem);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, L::smem);
    if (e != cudaSuccess) return (int)e;
    const int err = device_sms(&sms);
    if (err != 0) return err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    // one block per SM (the ring and the attention buffers allow no second)
    grid = sms;
    if (dev < kMaxDevices) grid_of[dev] = grid;
  }
  const int hd_in = p.h_kv * p.rep * D;
  const Scratch s = scratch_layout(grid, p.batch, p.h_kv, p.rep, D, p.hidden, p.inter);
  p.ctrl = ctrl;
  p.att = scratch + s.att;
  p.o_terms = reinterpret_cast<bf16*>(scratch + s.o_terms);
  p.h1 = scratch + s.h1;
  p.a_terms = reinterpret_cast<bf16*>(scratch + s.a_terms);
  p.ss1 = scratch + s.ss1;
  p.part = scratch + s.part;
  p.z_terms = reinterpret_cast<bf16*>(scratch + s.z_terms);
  p.h2 = scratch + s.h2;
  p.ss2 = scratch + s.ss2;
  Maps maps;
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  int err = hp::make_2d_map(&maps.wo, wo, bf, 2, p.hidden, hd_in, kBoxRows, kBK, sw);
  if (err == 0) err = hp::make_2d_map(&maps.wg, wg, bf, 2, p.inter, p.hidden, kBoxRows, kBK, sw);
  if (err == 0) err = hp::make_2d_map(&maps.wu, wu, bf, 2, p.inter, p.hidden, kBoxRows, kBK, sw);
  if (err == 0) err = hp::make_2d_map(&maps.wd, wd, bf, 2, p.hidden, p.inter, kBoxRows, kBK, sw);
  if (err == 0) err = hp::make_3d_map(&maps.o_terms, p.o_terms, kTerms, p.batch, hd_in, kTerms, NB, kBK);
  if (err == 0) err = hp::make_3d_map(&maps.a_terms, p.a_terms, kTerms, p.batch, p.hidden, kTerms, NB, kBK);
  if (err == 0) err = hp::make_3d_map(&maps.z_terms, p.z_terms, kTerms, p.batch, p.inter, kTerms, NB, kBK);
  if (err != 0) return err;
  void* argv[] = {&p, &maps};
  // a grid larger than what can be co-resident is refused here with an
  // error (never a hang); the caller raises on it
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(grid), dim3(kThreads),
                                  argv, L::smem, stream);
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
// floats. ctrl: ptt_decode_layer_ctrl() uint32 counters, zero on entry and
// left zero on exit (the last block to finish clears them), so the caller
// zeroes a buffer once and keeps it for its stream. head_dim in {64, 128}; rep 1..8; batch in 1..16; hidden, inter
// and block_i multiples of 8 with inter % block_i == 0 (block_i is checked
// and no longer shapes the work: gate/up's unit is 64 columns).
// stamps: nullptr, or 6 uint64 that receive the device clock (ns) at the
// start, after each of the four grid barriers and at the end of block 0's
// last phase (the phase breakdown of a call).
PTT_EXPORT int ptt_decode_layer(const void* q, const void* k, const void* v, const void* tables,
                                const void* pos, const void* hres, const void* wo,
                                const void* w_post, const void* wg, const void* wu,
                                const void* wd, const void* w_next, void* y, void* h,
                                void* scratch, void* ctrl, int batch, int h_kv, int rep,
                                int head_dim,
                                int page_size, int max_pages, int hidden, int inter, int block_i,
                                float eps_post, float eps_next, void* stamps, void* stream) {
  if (batch == 0) return 0;
  if (batch < 0 || batch > kMaxBatch || rep < 1 || rep > kMaxRep || hidden % 8 || inter % 8 ||
      block_i <= 0 || block_i % 8 || inter % block_i || page_size < 1 || max_pages < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.tables = static_cast<const int*>(tables);
  p.pos = static_cast<const int*>(pos);
  p.hres = static_cast<const bf16*>(hres);
  p.w_post = static_cast<const bf16*>(w_post);
  p.w_next = static_cast<const bf16*>(w_next);
  p.y = static_cast<bf16*>(y);
  p.h = static_cast<bf16*>(h);
  p.stamps = static_cast<unsigned long long*>(stamps);
  p.batch = batch;
  p.h_kv = h_kv;
  p.rep = rep;
  p.page_size = page_size;
  p.max_pages = max_pages;
  p.hidden = hidden;
  p.inter = inter;
  p.eps_post = eps_post;
  p.eps_next = eps_next;
  p.scale = 1.f / sqrtf((float)head_dim);
  const auto* bwo = static_cast<const bf16*>(wo);
  const auto* bwg = static_cast<const bf16*>(wg);
  const auto* bwu = static_cast<const bf16*>(wu);
  const auto* bwd = static_cast<const bf16*>(wd);
  auto* sc = static_cast<float*>(scratch);
  auto* ct = static_cast<unsigned*>(ctrl);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = batch > 8;
  switch (head_dim) {
    case 64:
      return wide ? launch<64, 16>(p, bwo, bwg, bwu, bwd, sc, ct, s)
                  : launch<64, 8>(p, bwo, bwg, bwu, bwd, sc, ct, s);
    case 128:
      return wide ? launch<128, 16>(p, bwo, bwg, bwu, bwd, sc, ct, s)
                  : launch<128, 8>(p, bwo, bwg, bwu, bwd, sc, ct, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Counters (uint32) ptt_decode_layer needs.
PTT_EXPORT int ptt_decode_layer_ctrl(int batch, int h_kv, int hidden, int inter) {
  return ctrl_words(batch, h_kv, hidden, inter);
}

// Floats of f32 scratch ptt_decode_layer needs on the current device (its
// grid is one block an SM): the attention pieces, the three
// activation-term buffers, h1, h2, the partial tiles and the sums of
// squares. -1 if the device cannot be queried or the count passes int.
PTT_EXPORT int ptt_decode_layer_scratch(int batch, int h_kv, int rep, int head_dim, int hidden,
                                        int inter) {
  int sms = 0;
  if (device_sms(&sms) != 0) return -1;
  const size_t n = scratch_layout(sms, batch, h_kv, rep, head_dim, hidden, inter).total;
  return n > 0x7fffffff ? -1 : (int)n;
}
