// One-token decode attention over the paged KV pool, GQA-native, split over
// positions (flash-decoding).
//
// Replaces paddle_tpu/ops/kernels/mmha_pallas.py `mmha_decode` (kernel body
// `_mmha_kernel`). For each (batch row b, kv head g) the rep = H / Hkv query
// heads that share the kv head attend over positions 0..pos[b] with an f32
// online softmax; positions past pos[b] are never read, and the denominator
// is clamped at 1e-30 as there.
//
// Every rep that divides H is taken, as the TPU kernel pads its query group
// to a multiple of 8. A block holds REP (1, 2, 4 or 8) query rows of one kv
// head. At rep 1, 2, 4 and 8 the launch is mmha_paged_kernel<D, rep, true>,
// whose every row is live: the code of a kernel for that rep alone. Any other
// rep runs <D, REP, false>, which takes the true rep at run time: rep < 8
// takes the next power of two and one block a (kv head, row, chunk), rows r
// >= rep loading no q and writing no output (their scores of zero are formed
// and dropped); rep > 8 takes REP 8 and ceil(rep / 8) blocks a kv head, each
// its own rows over the same pages.
//
// The TPU path first gathers each layer's pages into a contiguous
// [B, Hkv, T, D] copy. This kernel reads the pages through the page table
// itself (tables[b, t / page_size]), so the only bytes it moves are the
// keys and values the row can see. Page `page_id` of kv head g starts at
// element page_id * page_stride + g * head_stride: the paged pool
// [P, Hkv, ps, D] passes (Hkv * ps * D, ps * D); a contiguous [B, Hkv, T,
// D] cache passes (ps * D, T * D) with table entry b * Hkv * (T / ps) + j
// for page j of row b, so the kernel reads a caller's cache in place.
//
// Bound on the H100: bytes (the keys and values; about 4 * REP flops per
// byte, far below the card's ridge). Design: a row's positions fall into
// chunks of `chunk_pages` whole pages, 32 KB of K and V (ops/kernels/mmha.py
// `plan`: from host-known shapes alone; pos stays on the device), and the
// grid (Hkv, B, chunks) gives block (g, b, c) chunk c of row b, kv head g;
// a block whose chunk starts past pos[b] exits at once. In one kv head's
// [page_size, D] slice of a page the rows are contiguous, so warp 0 brings
// each page's visible rows of K and of V into shared memory as one bulk
// asynchronous copy each, on a mbarrier each, all issued before the first
// score; the query rows, the table entries and pos are loaded before
// that, all at once. Then, page by page as they land: the scores (a group
// of D / 8 lanes a position, 16 bytes a lane, summed by a shuffle
// reduce-scatter; each warp keeps its largest score a query row); the
// softmax numerators exp(s - max), a thread a score; P V and the softmax
// sums (a thread a query head and four columns, the positions split over
// thread groups when REP * D / 4 < 256), all from shared memory. A row of
// one chunk writes its output there. Otherwise each block writes its (max,
// sum, accumulator) to its own slot of `part`, and the last block of the
// (row, kv head) to arrive (a counter in `ctrl`, which it clears again)
// merges the slots in chunk order: no float atomics, so two calls give the
// same bits, and no host sync.
#include "hopper.cuh"

using ptt::bf16;
namespace hp = ptt::hopper;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPages = 16;  // pages a chunk (one K and one V mbarrier each)
constexpr float kNegInf = -1e30f;
// the most dynamic shared memory a block may ask for (the wrapper's plan
// keeps a chunk's K and V within 32 KB unless one page is larger)
constexpr int kMaxSmem = 200 * 1024;

// dynamic shared memory of a chunk of n positions: K and V [n, D] bf16,
// the scores / probabilities [REP, n] f32
__host__ __device__ constexpr int smem_bytes(int d, int rep, int n) {
  return 4 * n * d + 4 * rep * n;
}

// Sum of v[r] over the LP lanes of a group, scattered: the sums of all REP
// query rows in log2(LP) shuffle steps, each step handing half the rows
// still held to the partner lane (REP - 1 + log2(LP / REP) shuffles in all,
// not REP log2(LP)). Returns the total of row r = sub / (LP / REP), which
// every lane of the group whose index has those high bits holds.
template <int LP, int REP>
__device__ __forceinline__ float group_sum_scatter(float (&v)[REP], int sub) {
  int held = REP;
#pragma unroll
  for (int o = LP / 2; o >= 1; o >>= 1) {
    if (held > 1) {
      const int half = held / 2;
      const bool upper = (sub & o) != 0;
#pragma unroll
      for (int i = 0; i < REP / 2; ++i) {
        if (i < half) {
          const float send = upper ? v[i] : v[i + half];
          const float keep = upper ? v[i + half] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      held = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
  return v[0];
}

// the old value of *p, p += 1, with acquire-release order at device scope
// (a block's partials, ordered before the add by its barrier, are released
// with it; the last block acquires every other block's)
__device__ __forceinline__ unsigned count_in(unsigned* p) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n" : "=r"(old) : "l"(p) : "memory");
  return old;
}

template <int D, int REP, bool EXACT>
__global__ void __launch_bounds__(kThreads)
    mmha_paged_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
                      const bf16* __restrict__ v_pool, const int* __restrict__ tables,
                      const int* __restrict__ pos, bf16* __restrict__ out,
                      float* __restrict__ part, unsigned* __restrict__ ctrl, int page_size,
                      int max_pages, int chunk_pages, long long page_stride,
                      long long head_stride, float scale, int rep, int n_sub) {
  constexpr int LP = D / 8;          // lanes a position in the scores (8 elements each)
  constexpr int PPW = 32 / LP;       // positions a warp scores at once
  constexpr int QUAD = D / 4;        // column quads of a head
  constexpr int ITEMS = REP * QUAD;  // (query head, column quad) outputs
  constexpr int GROUPS = ITEMS >= kThreads ? 1 : kThreads / ITEMS;  // position groups in P V
  constexpr int PER = ITEMS >= kThreads ? ITEMS / kThreads : 1;     // outputs a thread
  static_assert(REP <= LP && kWarps >= REP, "a lane group holds every query row");
  // block x: kv head g, and of its rep query rows the REP from r0 on (with
  // EXACT, rep == REP: block x is kv head x, every row live)
  const int gs = blockIdx.x, b = blockIdx.y, c = blockIdx.z;
  const int g = EXACT ? gs : gs / n_sub;
  const int r0 = EXACT ? 0 : (gs % n_sub) * REP;
  const int live = EXACT ? REP : min(REP, rep - r0);  // query rows of this block
  const int n_rep = EXACT ? REP : rep;
  const int groups = gridDim.x, batch = gridDim.y, n_chunks = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = chunk_pages * page_size;  // positions a chunk
  const int sub = lane % LP, pw = lane / LP;
  const int heads = EXACT ? groups * REP : (groups / n_sub) * rep;

  // every load that needs no position goes out first: this lane's 8
  // columns of each query row, the chunk's table entries, then pos
  uint4 q_raw[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r)
    q_raw[r] = r < live ? *reinterpret_cast<const uint4*>(
                              q + ((size_t)b * heads + g * n_rep + r0 + r) * D + sub * 8)
                        : make_uint4(0u, 0u, 0u, 0u);
  int page_id = 0;
  if (warp == 0 && lane < chunk_pages && c * chunk_pages + lane < max_pages)
    page_id = tables[(size_t)b * max_pages + c * chunk_pages + lane];
  const int last = min(pos[b], max_pages * page_size - 1);
  const int first = c * chunk;
  if (first > last) return;                    // a chunk past the row's position
  const int n = min(chunk, last + 1 - first);  // positions of this chunk
  const int n_live = last / chunk + 1;         // chunks of the row
  const int n_pages = (n + page_size - 1) / page_size;
  const int bg = b * groups + gs;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_k = reinterpret_cast<bf16*>(smem);
  bf16* s_v = s_k + (size_t)chunk * D;
  float* s_p = reinterpret_cast<float*>(s_v + (size_t)chunk * D);  // [REP, chunk]
  __shared__ __align__(8) uint64_t bars[2][kMaxPages];  // K, V of page p
  __shared__ float s_wmax[kWarps][REP];                 // each warp's largest scores
  __shared__ float4 s_red[GROUPS > 1 ? kThreads : 1];   // the position groups' partials
  __shared__ float s_red_sum[GROUPS > 1 ? kThreads : 1];
  __shared__ int s_last;

  if (warp == 0 && lane < n_pages) {
    // a page's visible rows of K and of V: one bulk copy each, K first
    hp::mbar_init(&bars[0][lane], 1);
    hp::mbar_init(&bars[1][lane], 1);
    hp::mbar_fence_init();
    const int rows = min(page_size, n - lane * page_size);
    const uint32_t nb = (uint32_t)rows * D * 2;
    const size_t src = (size_t)page_id * page_stride + (size_t)g * head_stride;
    hp::mbar_arrive_expect_tx(&bars[0][lane], nb);
    hp::bulk_load(s_k + (size_t)lane * page_size * D, k_pool + src, nb, &bars[0][lane]);
    hp::mbar_arrive_expect_tx(&bars[1][lane], nb);
    hp::bulk_load(s_v + (size_t)lane * page_size * D, v_pool + src, nb, &bars[1][lane]);
  }
  float qv[REP][8];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&q_raw[r]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      qv[r][2 * i] = f.x * scale;
      qv[r][2 * i + 1] = f.y * scale;
    }
  }
  __syncthreads();  // the barriers are initialised

  // scores, page by page as the pages land: a group of LP lanes a
  // position, 16 contiguous bytes a lane; each lane keeps the largest
  // score of its query row
  float wmax = kNegInf;
  for (int p = 0; p < n_pages; ++p) {
    hp::mbar_wait(&bars[0][p], 0);
    const int end = min(n, (p + 1) * page_size);
    for (int t0 = p * page_size + warp * PPW; t0 < end; t0 += kWarps * PPW) {  // warp-uniform
      const int t = t0 + pw;
      float kr[8];
      if (t < end) {
        ptt::load8(s_k + (size_t)t * D + sub * 8, kr);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kr[e] = 0.f;
      }
      float sc[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) a = fmaf(qv[r][e], kr[e], a);
        sc[r] = a;
      }
      const float total = group_sum_scatter<LP, REP>(sc, sub);
      if (t < end) {
        wmax = fmaxf(wmax, total);
        if (sub % (LP / REP) == 0) s_p[(sub / (LP / REP)) * chunk + t] = total;
      }
    }
  }
  // the warp's largest score of each query row: across its position groups
#pragma unroll
  for (int o = LP; o < 32; o <<= 1) wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));
  if (pw == 0 && sub % (LP / REP) == 0) s_wmax[warp][sub / (LP / REP)] = wmax;
  __syncthreads();

  // the chunk's softmax numerators: exp(s - max), a thread a score
  float row_max[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_wmax[w][r]);
    row_max[r] = mx;
  }
#pragma unroll
  for (int r = 0; r < REP; ++r)
    for (int t = tid; t < n; t += kThreads) s_p[r * chunk + t] = __expf(s_p[r * chunk + t] - row_max[r]);
  __syncthreads();

  // P V and the softmax's sums, page by page: a thread a (query head,
  // column quad), positions split over GROUPS
  const int grp = GROUPS > 1 ? tid / ITEMS : 0;
  float4 acc[PER];
  float sum[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    sum[k] = 0.f;
  }
  for (int p = 0; p < n_pages; ++p) {
    hp::mbar_wait(&bars[1][p], 0);
    const int end = min(n, (p + 1) * page_size);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int item = GROUPS > 1 ? tid % ITEMS : tid + k * kThreads;
      const float* prow = s_p + (item / QUAD) * chunk;
      const uint2* vcol = reinterpret_cast<const uint2*>(s_v) + item % QUAD;
      float4 a = acc[k];
      float l = sum[k];
#pragma unroll 4
      for (int t = p * page_size + grp; t < end; t += GROUPS) {
        const float w = prow[t];
        const uint2 raw = vcol[(size_t)t * QUAD];
        const float2 v01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 v23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        a.x = fmaf(w, v01.x, a.x);
        a.y = fmaf(w, v01.y, a.y);
        a.z = fmaf(w, v23.x, a.z);
        a.w = fmaf(w, v23.y, a.w);
        l += w;
      }
      acc[k] = a;
      sum[k] = l;
    }
  }
  if constexpr (GROUPS > 1) {
    // the groups' partials, added in group order
    s_red[tid] = acc[0];
    s_red_sum[tid] = sum[0];
    __syncthreads();
    if (grp == 0) {
      for (int i = 1; i < GROUPS; ++i) {
        const float4 o = s_red[i * ITEMS + tid];
        acc[0].x += o.x;
        acc[0].y += o.y;
        acc[0].z += o.z;
        acc[0].w += o.w;
        sum[0] += s_red_sum[i * ITEMS + tid];
      }
    }
  }

  const size_t row_out = ((size_t)b * heads + g * n_rep + r0) * D;
  if (n_live == 1) {
    if (grp == 0) {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int item = GROUPS > 1 ? tid : tid + k * kThreads;
        if (!EXACT && item / QUAD >= live) continue;
        const float inv = 1.f / fmaxf(sum[k], 1e-30f);
        const float o[4] = {acc[k].x * inv, acc[k].y * inv, acc[k].z * inv, acc[k].w * inv};
        ptt::store4(out + row_out + 4 * item, o);
      }
    }
    return;
  }

  // partials: accumulators [B, Hkv, chunks, REP, D] then (max, sum) [B, Hkv, chunks, REP]
  float4* part_acc = reinterpret_cast<float4*>(part);
  float2* part_ml = reinterpret_cast<float2*>(part_acc + (size_t)batch * groups * n_chunks * ITEMS);
  const size_t slot = (size_t)bg * n_chunks;
  if (grp == 0) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int item = GROUPS > 1 ? tid : tid + k * kThreads;
      part_acc[(slot + c) * ITEMS + item] = acc[k];
      if (item % QUAD == 0) {
        float mx = row_max[0];
#pragma unroll
        for (int r = 1; r < REP; ++r) mx = item / QUAD == r ? row_max[r] : mx;
        part_ml[(slot + c) * REP + item / QUAD] = make_float2(mx, sum[k]);
      }
    }
  }
  // the block's partials, ordered before thread 0's release of them with
  // the count
  __syncthreads();
  if (tid == 0) s_last = count_in(&ctrl[bg]) == (unsigned)(n_live - 1);
  __syncthreads();
  if (!s_last) return;

  // the last block merges the row's chunks in chunk order: an online
  // rescale of the running max, sum and accumulator
  if (grp == 0) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int item = GROUPS > 1 ? tid : tid + k * kThreads;
      if (!EXACT && item / QUAD >= live) continue;
      const float2* ml = part_ml + slot * REP + item / QUAD;
      const float4* pa = part_acc + slot * ITEMS + item;
      float mx = kNegInf, l = 0.f;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int j = 0; j < n_live; ++j) {
        const float2 m_l = __ldcg(ml + (size_t)j * REP);
        const float4 aj = __ldcg(pa + (size_t)j * ITEMS);
        const float m_new = fmaxf(mx, m_l.x);
        const float w_old = __expf(mx - m_new), w = __expf(m_l.x - m_new);
        l = l * w_old + m_l.y * w;
        a.x = a.x * w_old + aj.x * w;
        a.y = a.y * w_old + aj.y * w;
        a.z = a.z * w_old + aj.z * w;
        a.w = a.w * w_old + aj.w * w;
        mx = m_new;
      }
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const float o[4] = {a.x * inv, a.y * inv, a.z * inv, a.w * inv};
      ptt::store4(out + row_out + 4 * item, o);
    }
  }
  if (tid == 0) ctrl[bg] = 0u;  // ready for the next call on this stream
}

template <int D, int REP, bool EXACT>
int launch(const void* q, const void* k, const void* v, const void* tables, const void* pos,
           void* out, void* part, void* ctrl, int batch, int h_kv, int rep, int page_size,
           int max_pages, int chunk_pages, long long page_stride, long long head_stride,
           cudaStream_t s) {
  const int chunk = chunk_pages * page_size;
  const int smem = smem_bytes(D, REP, chunk);
  const int n_chunks = (max_pages + chunk_pages - 1) / chunk_pages;
  const int n_sub = (rep + REP - 1) / REP;  // blocks a kv head
  if (smem > kMaxSmem || chunk_pages > kMaxPages || n_chunks > 65535 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = hp::allow_smem<mmha_paged_kernel<D, REP, EXACT>>(kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(h_kv * n_sub, batch, n_chunks);
  mmha_paged_kernel<D, REP, EXACT><<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(tables), static_cast<const int*>(pos), static_cast<bf16*>(out),
      static_cast<float*>(part), static_cast<unsigned*>(ctrl), page_size, max_pages, chunk_pages,
      page_stride, head_stride, 1.f / sqrtf((float)D), rep, n_sub);
  return (int)cudaGetLastError();
}

// the instantiated query-group size a rep takes: the next power of two up
// to 8, then 8 (ops/kernels/mmha.py `rep_block`)
inline int rep_block(int rep) { return rep <= 1 ? 1 : rep <= 2 ? 2 : rep <= 4 ? 4 : 8; }

template <int D>
int launch_rep(int rep, const void* q, const void* k, const void* v, const void* tables,
               const void* pos, void* out, void* part, void* ctrl, int batch, int h_kv,
               int page_size, int max_pages, int chunk_pages, long long page_stride,
               long long head_stride, cudaStream_t s) {
  if (rep < 1) return (int)cudaErrorInvalidValue;
  const bool exact = rep == rep_block(rep);
  switch (rep_block(rep)) {
#define PTT_MMHA_REP(R)                                                                     \
  case R:                                                                                   \
    return exact ? launch<D, R, true>(q, k, v, tables, pos, out, part, ctrl, batch, h_kv,   \
                                      rep, page_size, max_pages, chunk_pages, page_stride,  \
                                      head_stride, s)                                       \
                 : launch<D, R, false>(q, k, v, tables, pos, out, part, ctrl, batch, h_kv,  \
                                       rep, page_size, max_pages, chunk_pages, page_stride, \
                                       head_stride, s);
    PTT_MMHA_REP(1)
    PTT_MMHA_REP(2)
    PTT_MMHA_REP(4)
    PTT_MMHA_REP(8)
#undef PTT_MMHA_REP
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: [batch, h_kv * rep, head_dim] bf16; k, v: one layer's pool
// [pages, h_kv, page_size, head_dim] bf16 (page_stride h_kv * page_size *
// head_dim, head_stride page_size * head_dim) or a contiguous cache
// [batch, h_kv, T, head_dim] (page_stride page_size * head_dim, head_stride
// T * head_dim), both strides in elements and multiples of 8 (16 bytes, the
// bulk copy's alignment); tables: [batch, max_pages] int32;
// pos: [batch] int32, the last visible position of each row. A chunk is
// chunk_pages pages (a block); part: f32 scratch of batch * h_kv * n_sub *
// chunks * REP * (head_dim + 2) floats, chunks = ceil(max_pages /
// chunk_pages), REP = rep_block(rep), n_sub = ceil(rep / REP); ctrl: batch *
// h_kv * n_sub uint32 counters, zero on entry and left zero. head_dim in
// {64, 128}, any rep >= 1.
PTT_EXPORT int ptt_mmha_paged(const void* q, const void* k, const void* v, const void* tables,
                              const void* pos, void* out, void* part, void* ctrl, int batch,
                              int h_kv, int rep, int head_dim, int page_size, int max_pages,
                              int chunk_pages, long long page_stride, long long head_stride,
                              void* stream) {
  if (batch == 0) return 0;
  if (chunk_pages < 1 || page_size < 1 || max_pages < 1 || h_kv < 1 || page_stride < 1 ||
      head_stride < 1 || page_stride % 8 || head_stride % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_rep<64>(rep, q, k, v, tables, pos, out, part, ctrl, batch, h_kv, page_size,
                            max_pages, chunk_pages, page_stride, head_stride, s);
    case 128:
      return launch_rep<128>(rep, q, k, v, tables, pos, out, part, ctrl, batch, h_kv, page_size,
                             max_pages, chunk_pages, page_stride, head_stride, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
