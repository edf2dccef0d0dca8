// Weight-only int8 / int4 matrix products: y = x @ dequant(w), bf16
// activations in and out, f32 accumulation on the bf16 tensor cores.
//
// Replaces paddle_tpu/ops/kernels/wo_matmul_pallas.py:
//   `_wo_kernel`   (:33, via `wo_int8_matmul` :70)  per-channel int8,
//   `_wo_g_kernel` (:41, via :70)                   grouped int8,
//   `_wo4_kernel`  (:176, via `wo_int4_matmul` :213) packed int4 halves.
// x is [M, K] bf16 row-major; w is [K, N] int8 (int8 modes) or [K, N/2]
// packed bytes (int4); scales are [N] f32 (per-channel, int4) or [K/G, N]
// f32 (grouped); y is [M, N] bf16.
//
// Numerics kept from the TPU kernels:
//   per-channel: y = bf16(acc_f32 * s[n]), one rounding;
//   grouped:     the weight is dequantized first, wd = bf16(f32(w) * s[k/G, n])
//                (rounded to the activation dtype BEFORE the contraction),
//                then y = bf16(acc_f32);
//   int4:        byte j of a row holds column j in its low nibble and column
//                j + N/2 in its high nibble, both sign-extended 4-bit values;
//                y[:, j] = bf16(acc_lo * s[j]), y[:, j + N/2] = bf16(acc_hi * s[j + N/2]).
// Products of bf16 values are exact in f32; the int8 and nibble values
// convert to bf16 exactly (|q| <= 127 fits bf16's 8 significant bits). The
// conversion avoids the quarter-rate int-to-float instruction: a byte
// permute places the biased value u = q + 128 (a nibble: q + 8) in the low
// mantissa of 2^23, one f32 subtraction leaves q, and the top half of its
// f32 bits is its bf16. A grouped weight multiplies that f32 by its scale
// and rounds the pair to bf16 with cvt.rn.bf16x2.f32.
//
// Bound on the H100: bytes in decode (M = 1..16 rows: the weight is read
// once, 58.7 MB for gate_proj at int8, 0.018 ms at 3.35 TB/s), operations in
// prefill (M = 64..2048: 120 GFLOP for gate_proj at M 1024, 0.12 ms on the
// bf16 tensor cores).
//
// All three modes run two kernels built from csrc/hopper.cuh:
//
// - Prefill (M > 16), wo_prefill_kernel<MODE, BM>: a BM x 128 output tile
//   (BM 256 unless the 128-row grid fills the card a wave sooner), 288
//   threads: two consumer warpgroups of BM / 2 rows, then one producer
//   warp. One producer thread keeps TMA loads in flight into a ring of up
//   to six stages, each signalled by a `full` mbarrier (transaction bytes)
//   and released by an `empty` one: x's [BM, 64] bf16 tile (K-major,
//   128-byte swizzle), the int8 weight's [64 k, 128 n] tile (128-byte
//   swizzle) and, grouped, the scale rows the 64 k span. Packed int4: the
//   weight's box is [64 k, 64 bytes] of the [K, N/2] bytes, unswizzled: its
//   low nibbles are the tile's columns 0-63 (columns n0/2 .. of y), its
//   high ones columns 64-127 (N/2 + n0/2 ..), so it fills the same bf16
//   tile of two 64-column sub-tiles, and the epilogue maps the tile's two
//   halves onto the two slabs of y and their scales. The consumers
//   dequantise the int8 tile into a bf16 MN-major tile with the 128-byte
//   swizzle (one 128-byte row holds 64 n of one k), fence the async proxy,
//   meet at a named barrier, and run wgmma m64n128k16 with both operands in
//   shared memory (B transposed). Three converted tiles rotate: tile j + 1
//   is converted while tile j's wgmma runs. One converted [64, 128] tile
//   serves BM rows, so conversion is 1 / BM of the tensor work. The
//   per-channel epilogue applies s[n] in f32 and rounds once; the tile
//   leaves through shared memory as 16-byte row pieces.
// - Decode (M <= 16), wo_decode_kernel<MODE, TG, NC>: the weight streams through
//   a ring of up to eight 64 x 128-byte TMA stages a block (three blocks an
//   SM at 8 tokens), x's 64 k of each stage beside it as one bulk copy a
//   token row (no tensor map for an activation). Four consumer warps take
//   one 16-deep k-step of each stage; each thread reads 16 n of four k rows
//   as 16-byte vectors (conflict-free through the swizzle), converts them
//   into the A operand of mma.sync m16n8k16 (the weight as A, so 8 tokens
//   fill n 8: TG groups of 8 tokens). K is split across the blocks of a
//   cluster so that the blocks fill the card's slots once (k_proj's 8
//   column tiles of 128 become 64 blocks); each block sums its warps'
//   partials in shared memory, and block r of the cluster adds the blocks'
//   partials for its columns through distributed shared memory in rank
//   order. No atomics: two calls return the same bits. Packed int4: a
//   block takes 128 columns from a [64 k, 64 bytes] box (each thread 8
//   bytes of a row: 8 columns of each half, an odd t reading its k pairs
//   in the other order so that no load meets a bank twice), or 256 columns
//   from a [64 k, 128 bytes] box read as the int8 weight is (16 bytes: 16
//   columns of each half, sixteen mma tiles a warp, two blocks an SM);
//   int4_dec_cols takes 256 where that grid's K split is not capped.
#include <algorithm>

#include "hopper.cuh"

using ptt::bf16;
using ptt::ld32;
using ptt::mma_bf16;
namespace hp = ptt::hopper;

namespace {

enum Mode { kInt8 = 0, kInt8Grouped = 1, kInt4 = 2 };

// two f32 values -> one bf16x2 word, `lo` in the low half (rounded to nearest)
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Byte jj (0..3) of v, an unsigned biased value u, as the f32 u - bias + 2^23
// - 2^23: exact. With bias 128, u = q ^ 0x80 of a signed byte q gives q;
// with bias 8, u = n ^ 0x8 of a signed nibble n gives n (the same as
// (int8)(b << 4) >> 4 for the low nibble of a signed byte b, b >> 4 for the
// high one).
__device__ __forceinline__ float biased_byte(uint32_t v, int jj, float bias) {
  return __int_as_float((int)__byte_perm(v, 0x4B000000u, 0x7540u + jj)) - (8388608.0f + bias);
}

// two f32 values that are exact in bf16 -> one bf16x2 word, `lo` in the low
// half: the top halves of their bits, no rounding needed
__device__ __forceinline__ uint32_t pack2_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// -- the Hopper kernels ----------------------------------------------------------

constexpr int kSmemMax = 232448;  // dynamic shared memory a block may opt into
constexpr int kBK = 64;           // k rows a ring stage (both tilings)
constexpr int kBN = 128;          // output columns a block: one 128-byte box of int8 weight
// prefill
constexpr int kPreThreads = 288;  // two consumer warpgroups, then one producer warp
constexpr int kPreStages = 6;     // ring stages at most (fewer where the tiles need room)
constexpr int kPreConv = 3;       // converted bf16 weight tiles: j - 1 and j read, j + 1 written
constexpr int kConvTile = kBK * kBN * 2;  // bytes of one: two 64-column sub-tiles
constexpr int kOutRow = 136;      // bf16 stride of the output tile staged in shared memory
// decode
constexpr int kDecThreads = 160;  // four consumer warps, then one producer warp
constexpr int kDecStages = 8;     // ring stages at most
constexpr int kDecSplit = 8;      // blocks a cluster at most (the portable cluster size)
constexpr int kXRow = 72;         // bf16 stride of a stage's x rows, kBK + 8: B reads without conflict
constexpr int kSms = 132;         // the H100's multiprocessors
constexpr int kSmemSm = 233472;   // shared memory an SM holds (1 KB of it reserved a block)
constexpr int kDecBlocks8 = 3;    // blocks an SM of 8 tokens (up to 136 registers a thread)
constexpr int kDecBlocks16 = 2;   // of 16 tokens

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// bytes of one weight row of a block's tile of `nc` columns: nc int8 values,
// or nc / 2 bytes of packed int4 (a byte holds a column of each half)
__host__ __device__ constexpr int w_row(int mode, int nc) { return mode == kInt4 ? nc / 2 : nc; }

// bytes of one weight stage (64 k rows) of a block's tile of `nc` columns
__host__ __device__ constexpr int w_tile(int mode, int nc = kBN) { return kBK * w_row(mode, nc); }

// output column of column c (even) of the block tile of `nc` columns that
// starts at column n0 (int4: n0 / 2 is the tile's first byte column; its
// first nc / 2 columns are low nibbles, columns n0 / 2 + c of y, the rest
// high nibbles, columns N / 2 + n0 / 2 + c - nc / 2), and whether it exists
template <int MODE, int NC>
__device__ __forceinline__ int out_col(int n0, int c, int N) {
  return MODE == kInt4 ? (c < NC / 2 ? n0 / 2 + c : N / 2 + n0 / 2 + c - NC / 2) : n0 + c;
}
template <int MODE, int NC>
__device__ __forceinline__ bool col_ok(int n0, int c, int N) {
  return MODE == kInt4 ? n0 / 2 + c % (NC / 2) < N / 2 : n0 + c < N;
}

// scale rows of [K/G, N] a stage of 64 k rows (starting on a multiple of 64)
// can span: one where G is a multiple of 64, 64 / G where G divides 64, else
// at most 63 / G + 2
__host__ __device__ constexpr int scale_rows(int G) {
  return G % kBK == 0 ? 1 : kBK % G == 0 ? kBK / G : ((kBK - 1) / G + 2 < kBK ? (kBK - 1) / G + 2 : kBK);
}

// shared-memory bytes of a stage's scale rows (a 1024-byte multiple, so that
// every stage's tiles keep the swizzle's alignment)
__host__ __device__ constexpr int scale_bytes(int mode, int srows) {
  return mode == kInt8Grouped ? round_up(srows * kBN * 4, 1024) : 0;
}

// dequantise 8 bytes (one k row, 8 consecutive n) to 8 bf16: per-channel
// exactly, grouped times its 8 scales and rounded
template <int MODE>
__device__ __forceinline__ uint4 dequant8(uint2 q, const float* sc) {
  const uint32_t u0 = q.x ^ 0x80808080u, u1 = q.y ^ 0x80808080u;
  float f[8];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    f[jj] = biased_byte(u0, jj, 128.f);
    f[4 + jj] = biased_byte(u1, jj, 128.f);
  }
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = MODE == kInt8Grouped ? pack2(f[2 * i] * sc[2 * i], f[2 * i + 1] * sc[2 * i + 1])
                                : pack2_exact(f[2 * i], f[2 * i + 1]);
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// dequantise 8 packed int4 bytes (one k row) to 8 bf16 of the low nibbles
// and 8 of the high ones, exactly
__device__ __forceinline__ void dequant_int4(uint2 q, uint4& lo, uint4& hi) {
  const uint32_t u[2] = {q.x ^ 0x88888888u, q.y ^ 0x88888888u};
  uint32_t o[2][4];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const uint32_t l = u[w] & 0x0F0F0F0Fu, h = (u[w] >> 4) & 0x0F0F0F0Fu;
    o[0][2 * w] = pack2_exact(biased_byte(l, 0, 8.f), biased_byte(l, 1, 8.f));
    o[0][2 * w + 1] = pack2_exact(biased_byte(l, 2, 8.f), biased_byte(l, 3, 8.f));
    o[1][2 * w] = pack2_exact(biased_byte(h, 0, 8.f), biased_byte(h, 1, 8.f));
    o[1][2 * w + 1] = pack2_exact(biased_byte(h, 2, 8.f), biased_byte(h, 3, 8.f));
  }
  lo = make_uint4(o[0][0], o[0][1], o[0][2], o[0][3]);
  hi = make_uint4(o[1][0], o[1][1], o[1][2], o[1][3]);
}

template <int MODE, int BM>
__global__ void __launch_bounds__(kPreThreads, 1)
    wo_prefill_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                      const __grid_constant__ CUtensorMap ts, const float* __restrict__ scales,
                      bf16* __restrict__ y, int M, int N, int K, int G, int stages, int srows) {
  constexpr int XB = BM * kBK * 2;  // x tile bytes
  constexpr int MI = BM / 128;      // m64 tiles a consumer warpgroup
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (hp::smem_u32(smem_raw) & 1023u)) & 1023u);
  constexpr int WT = w_tile(MODE);  // weight bytes a stage
  const int stage_bytes = XB + WT + scale_bytes(MODE, srows);
  unsigned char* conv = smem + stages * stage_bytes;  // [kPreConv][2][64 k][64 n] bf16
  uint64_t* full = reinterpret_cast<uint64_t*>(conv + kPreConv * kConvTile);
  uint64_t* empty = full + kPreStages;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const int n_kt = (K + kBK - 1) / kBK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {
    // producer warp: one thread issues every copy
    if (tid == 256) {
      const uint32_t tx_bytes = XB + WT + (MODE == kInt8Grouped ? srows * kBN * 4 : 0);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % stages;
        if (kt >= stages) hp::mbar_wait(&empty[st], ((kt / stages) - 1) & 1);
        unsigned char* s = smem + st * stage_bytes;
        const int k0 = kt * kBK;
        hp::mbar_arrive_expect_tx(&full[st], tx_bytes);
        hp::tma_load_4d(s, &tx, &full[st], k0, 0, m0, 0);
        hp::tma_load_2d(s + XB, &tw, &full[st], MODE == kInt4 ? n0 / 2 : n0, k0);
        if (MODE == kInt8Grouped) hp::tma_load_2d(s + XB + WT, &ts, &full[st], n0, k0 / G);
      }
    }
    return;
  }

  // consumer warpgroups: cw owns rows cw * BM / 2 .. of the tile
  const int cw = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const uint32_t conv_addr = hp::smem_u32(conv);

  // the int8 tile of k-tile kt -> converted tile kt % kPreConv; warp w takes
  // rows 2 (w + 8 u) and the next (one a half-warp), 8 n a thread: the
  // half-warp reads a swizzled 128-byte row without conflict and each
  // quarter-warp writes one swizzled row of a sub-tile. The packed int4
  // tile ([64 k][64 bytes], unswizzled): thread t takes 8 bytes of rows
  // t / 8 and t / 8 + 32, the warp 256 consecutive bytes; their low
  // nibbles are one 16-byte chunk of sub-tile 0, the high ones of sub-tile
  // 1, each quarter-warp writing one swizzled row of each
  auto convert = [&](int kt) {
    hp::mbar_wait(&full[kt % stages], (kt / stages) & 1);
    __syncwarp();
    const unsigned char* s = smem + (kt % stages) * stage_bytes;
    const unsigned char* wt = s + XB;
    unsigned char* dst = conv + (kt % kPreConv) * kConvTile;
    if constexpr (MODE == kInt4) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = (tid >> 3) + 32 * u, j = tid & 7;
        uint4 lo, hi;
        dequant_int4(*reinterpret_cast<const uint2*>(wt + r * 64 + 8 * j), lo, hi);
        const int at = r * 128 + ((j ^ (r & 7)) << 4);
        *reinterpret_cast<uint4*>(dst + at) = lo;
        *reinterpret_cast<uint4*>(dst + kBK * 128 + at) = hi;
      }
      hp::fence_proxy_async();
      return;
    }
    const float* st_scales = reinterpret_cast<const float*>(s + XB + WT);
    const int j = lane & 15;  // 8-byte group of the row: n 8j .. 8j + 7
    const int k0 = kt * kBK;
    float sc[8];
    if (MODE == kInt8Grouped && G % kBK == 0) ptt::load8(st_scales + 8 * j, sc);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = 2 * (warp + 8 * u) + (lane >> 4);
      const uint2 q = *reinterpret_cast<const uint2*>(wt + r * 128 + (((j >> 1) ^ (r & 7)) << 4) +
                                                      ((j & 1) << 3));
      if (MODE == kInt8Grouped && G % kBK != 0)
        ptt::load8(st_scales + ((k0 + r) / G - k0 / G) * kBN + 8 * j, sc);
      *reinterpret_cast<uint4*>(dst + (j >> 3) * (kBK * 128) + r * 128 +
                                (((j & 7) ^ (r & 7)) << 4)) = dequant8<MODE>(q, sc);
    }
    hp::fence_proxy_async();
  };

  float acc[MI][64];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[i][e] = 0.f;

  convert(0);
  hp::bar_sync(1, 256);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % stages;
    const uint32_t xa = hp::smem_u32(smem + st * stage_bytes) + cw * (BM / 2) * 128;
    const uint32_t ba = conv_addr + (kt % kPreConv) * kConvTile;
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t db = hp::desc_mnmajor(ba + kk * 2048, kBK * 128);
#pragma unroll
      for (int i = 0; i < MI; ++i)
        hp::Wgmma<kBN>::template ss<1>(acc[i], hp::desc_kmajor(xa + i * 64 * 128 + kk * 32), db, 1);
    }
    hp::wgmma_commit();
    if (kt > 0) {
      // k-tile kt - 1's products are done: its stage goes back to the producer
#pragma unroll
      for (int i = 0; i < MI; ++i) hp::fence_acc<64>(acc[i]);
      hp::wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < MI; ++i) hp::fence_acc<64>(acc[i]);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty[(kt - 1) % stages]);
    }
    // tile kt + 1 is converted while kt's products run (its buffer was last
    // read by kt - 2's, done in both warpgroups before the last barrier)
    if (kt + 1 < n_kt) convert(kt + 1);
    hp::bar_sync(1, 256);
  }
#pragma unroll
  for (int i = 0; i < MI; ++i) hp::fence_acc<64>(acc[i]);
  hp::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < MI; ++i) hp::fence_acc<64>(acc[i]);

  // The tile goes out through shared memory (the ring is free once both
  // warpgroups' products are done): accumulator element e of a thread is
  // row 16 (warp % 4) + lane / 4 + 8 ((e / 2) % 2), column 8 (e / 4) +
  // 2 (lane % 4) + e % 2 of its m64 tile, written as bf16 pairs into rows
  // kOutRow apart (conflict-free), then read back as 16-byte row pieces
  // and stored coalesced.
  hp::bar_sync(1, 256);
  bf16* out = reinterpret_cast<bf16*>(smem);
  const int r0 = cw * (BM / 2) + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
  for (int c = 0; c < kBN / 8; ++c) {
    const int col = 8 * c + 2 * (lane & 3);
    float s0 = 1.f, s1 = 1.f;
    if (MODE != kInt8Grouped && col_ok<MODE, kBN>(n0, col, N)) {
      const int oc = out_col<MODE, kBN>(n0, col, N);
      s0 = scales[oc];
      s1 = scales[oc + 1];
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<__nv_bfloat162*>(out + (r0 + 64 * i + 8 * hf) * kOutRow + col) =
            __floats2bfloat162_rn(acc[i][4 * c + 2 * hf] * s0, acc[i][4 * c + 2 * hf + 1] * s1);
  }
  hp::bar_sync(1, 256);
  for (int e = tid; e < BM * (kBN / 8); e += 256) {
    const int r = e / (kBN / 8), c = 8 * (e % (kBN / 8));
    if (m0 + r < M && col_ok<MODE, kBN>(n0, c, N))
      *reinterpret_cast<uint4*>(y + (size_t)(m0 + r) * N + out_col<MODE, kBN>(n0, c, N)) =
          *reinterpret_cast<const uint4*>(out + r * kOutRow + c);
  }
}

// blocks of wo_decode_kernel an SM holds: three of 8 tokens over 128
// columns, else two (a 256-column int4 tile keeps twice the sums)
__host__ __device__ constexpr int dec_blocks(int tg, int nc = kBN) {
  return tg == 1 && nc == kBN ? kDecBlocks8 : kDecBlocks16;
}

// NC: output columns a block (128; packed int4 also 256, a 128-byte box)
template <int MODE, int TG, int NC>
__global__ void __launch_bounds__(kDecThreads, TG == 1 && NC == kBN ? kDecBlocks8 : kDecBlocks16)
    wo_decode_kernel(const bf16* __restrict__ x, const __grid_constant__ CUtensorMap tw,
                     const __grid_constant__ CUtensorMap ts, const float* __restrict__ scales,
                     bf16* __restrict__ y, int M, int N, int K, int G, int kslice, int stages,
                     int srows) {
  constexpr int TOK = 8 * TG;          // token rows a block holds (rows past M are zeros)
  constexpr int PART = TOK * NC * 4;   // bytes of one warp's (or the block's) partial sums
  constexpr int WROW = w_row(MODE, NC);  // bytes of a weight row of a stage: 64 or 128
  constexpr int MMAS = NC / 16;        // mma.sync tiles a warp covers: 8, or 16
  // int4: the MMAS / 2 tiles of each nibble half; a lane group g holds SPAN
  // columns of each half (int8: of the one)
  constexpr int HALVES = MODE == kInt4 ? 2 : 1, MH = MMAS / HALVES, SPAN = NC / HALVES / 8;
  static_assert(MODE == kInt4 ? (NC == 128 || NC == 256) : NC == kBN, "tile widths");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (hp::smem_u32(smem_raw) & 1023u)) & 1023u);
  const int stage_bytes = kBK * WROW + scale_bytes(MODE, srows);
  const int ring = max(stages * stage_bytes, 5 * PART);  // the ring, later the partial sums
  unsigned char* xring = smem + ring;  // [stage][TOK][kXRow] bf16: x's 64 k of each stage
  uint64_t* full = reinterpret_cast<uint64_t*>(xring + stages * TOK * kXRow * 2);
  uint64_t* empty = full + kDecStages;

  const int split = gridDim.x;  // the cluster: the K slices of one column tile
  const int rank = (int)hp::cluster_rank();
  const int kbeg = blockIdx.x * kslice;
  const int nst = (min(K, kbeg + kslice) - kbeg + kBK - 1) / kBK;
  const int n0 = blockIdx.y * NC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // x rows past M are never copied (and only they are written here, so no
  // thread's store meets a copy): they stay zero
  for (int e = tid; e < stages * TOK * (kXRow / 8); e += kDecThreads)
    if ((e / (kXRow / 8)) % TOK >= M) reinterpret_cast<uint4*>(xring)[e] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 4);  // one arrival a consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {
    // producer warp: one thread issues every copy; x's rows enter each
    // stage as bulk copies of the row's 64 k (no tensor map for x, a fresh
    // activation on every call)
    if (tid == 128) {
      const uint32_t w_bytes = kBK * WROW + (MODE == kInt8Grouped ? srows * kBN * 4 : 0);
      for (int i = 0; i < nst; ++i) {
        const int st = i % stages;
        if (i >= stages) hp::mbar_wait(&empty[st], ((i / stages) - 1) & 1);
        unsigned char* s = smem + st * stage_bytes;
        const int k0 = kbeg + i * kBK;
        const uint32_t x_bytes = min(kBK, K - k0) * 2;
        hp::mbar_arrive_expect_tx(&full[st], w_bytes + M * x_bytes);
        hp::tma_load_2d(s, &tw, &full[st], MODE == kInt4 ? n0 / 2 : n0, k0);
        if (MODE == kInt8Grouped) hp::tma_load_2d(s + kBK * WROW, &ts, &full[st], n0, k0 / G);
        for (int r = 0; r < M; ++r)
          hp::bulk_load(xring + (st * TOK + r) * kXRow * 2, x + (size_t)r * K + k0, x_bytes,
                        &full[st]);
      }
    }
    __syncwarp();  // the warp meets __syncthreads together
  } else {
    // consumer warps: warp w takes the k-step 16 w .. 16 w + 15 of every
    // stage. Thread (g, t) reads k rows 2t, 2t + 1, 2t + 8, 2t + 9 of it at
    // n 16 g .. 16 g + 15; A row g of mma m is n 16 g + 2 m, row g + 8 is
    // n 16 g + 2 m + 1. Packed int4: the thread's bytes of a row hold SPAN
    // columns of each half, so A row g of mma m of half h = m / MH is
    // column SPAN g + 2 (m % MH) of that half, row g + 8 the next; with
    // 64-byte rows (8 bytes a thread, unswizzled) an odd t reads the rows of
    // each k pair in the other order, so that each load's four rows meet
    // both halves of the banks, and its x pairs swap to match.
    const int g = lane >> 2, t = lane & 3;
    float acc[TG][MMAS][4];
#pragma unroll
    for (int a = 0; a < TG; ++a)
#pragma unroll
      for (int m = 0; m < MMAS; ++m) acc[a][m][0] = acc[a][m][1] = acc[a][m][2] = acc[a][m][3] = 0.f;

    for (int i = 0; i < nst; ++i) {
      const int st = i % stages;
      hp::mbar_wait(&full[st], (i / stages) & 1);
      __syncwarp();  // the lanes leave the wait apart; mma.sync needs them together
      const unsigned char* wt = smem + st * stage_bytes;
      const float* st_scales = reinterpret_cast<const float*>(wt + kBK * WROW);
      const int rr = 16 * warp + 2 * t;
      uint4 q[4];  // k rows rr, rr + 1, rr + 8, rr + 9
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        if constexpr (WROW == 128) {
          const int r = rr + (h & 1) + 8 * (h >> 1);
          q[h] = *reinterpret_cast<const uint4*>(wt + r * 128 + ((g ^ (r & 7)) << 4));
        } else {
          const int r = rr + ((h & 1) ^ (t & 1)) + 8 * (h >> 1);
          const uint2 v = *reinterpret_cast<const uint2*>(wt + r * 64 + 8 * g);
          q[h] = make_uint4(v.x, v.y, 0u, 0u);
        }
      }
      // x's B operand: token 8 tg + g, k rr, rr + 1 and rr + 8, rr + 9; the
      // last stage's columns past K hold an older stage's x (the weight's
      // rows there are zeros, but the x there need not be finite)
      const int k0 = kbeg + i * kBK;
      uint32_t b[TG][2];
#pragma unroll
      for (int tg = 0; tg < TG; ++tg) {
        const bf16* xp = reinterpret_cast<const bf16*>(xring) + (st * TOK + 8 * tg + g) * kXRow + rr;
        b[tg][0] = k0 + rr < K ? ld32(xp) : 0u;
        b[tg][1] = k0 + rr + 8 < K ? ld32(xp + 8) : 0u;
        if (WROW == 64 && (t & 1)) {
          b[tg][0] = __byte_perm(b[tg][0], 0u, 0x1032u);
          b[tg][1] = __byte_perm(b[tg][1], 0u, 0x1032u);
        }
      }
      if constexpr (MODE == kInt4) {
        // mma m, A row g + 8 e: byte 2 (m % MH) + e of the thread's bytes,
        // nibble half m / MH; four tiles at a time
#pragma unroll
        for (int grp = 0; grp < MMAS / 4; ++grp) {
          uint32_t a[4][4];
#pragma unroll
          for (int mm = 0; mm < 4; ++mm) {
            const int m = 4 * grp + mm, sh = 4 * (m / MH);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int bt = 2 * (m % MH) + e;
              float f[4];
#pragma unroll
              for (int h = 0; h < 4; ++h)
                f[h] = biased_byte(((word_of(q[h], bt >> 2) ^ 0x88888888u) >> sh) & 0x0F0F0F0Fu,
                                   bt & 3, 8.f);
              a[mm][e] = pack2_exact(f[0], f[1]);
              a[mm][2 + e] = pack2_exact(f[2], f[3]);
            }
          }
#pragma unroll
          for (int tg = 0; tg < TG; ++tg)
#pragma unroll
            for (int mm = 0; mm < 4; ++mm)
              mma_bf16(acc[tg][4 * grp + mm], a[mm], b[tg][0], b[tg][1]);
        }
        __syncwarp();
        if (lane == 0) hp::mbar_arrive(&empty[st]);  // the stage is read
        continue;
      }
      // the A operands of mma m = 4 mh .. 4 mh + 3 (n 16 g + 8 mh ..
      // + 7), in two halves to keep fewer registers live: a[mm][e] (e =
      // 0, 1: n 16 g + 2 m + e) from k rows (rr, rr + 1), a[mm][2 + e]
      // from (rr + 8, rr + 9); grouped, each value times the scale of its
      // own k row
#pragma unroll
      for (int mh = 0; mh < 2; ++mh) {
        uint32_t a[4][4];
        auto pairs = [&](const uint4& ql, const uint4& qh, const float* sl, const float* sh,
                         int slot) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * mh + jj;
            const float fl = biased_byte(word_of(ql, j >> 2) ^ 0x80808080u, j & 3, 128.f);
            const float fh = biased_byte(word_of(qh, j >> 2) ^ 0x80808080u, j & 3, 128.f);
            a[jj >> 1][slot + (jj & 1)] =
                MODE == kInt8Grouped ? pack2(fl * sl[jj], fh * sh[jj]) : pack2_exact(fl, fh);
          }
        };
        if (MODE == kInt8Grouped) {
          // n 16 g + 8 mh .. + 7 of k row kr's scales
          auto row = [&](int kr, float* sc) {
            ptt::load8(st_scales + (kr / G - k0 / G) * kBN + 16 * g + 8 * mh, sc);
          };
          if (G % 16 == 0) {  // one scale row for the whole k-step
            float sc[8];
            row(k0 + rr, sc);
            pairs(q[0], q[1], sc, sc, 0);
            pairs(q[2], q[3], sc, sc, 2);
          } else {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float sl[8], sh[8];
              row(k0 + rr + 8 * h, sl);
              row(k0 + rr + 8 * h + 1, sh);
              pairs(q[2 * h], q[2 * h + 1], sl, sh, 2 * h);
            }
          }
        } else {
          pairs(q[0], q[1], nullptr, nullptr, 0);
          pairs(q[2], q[3], nullptr, nullptr, 2);
        }
#pragma unroll
        for (int tg = 0; tg < TG; ++tg)
#pragma unroll
          for (int mm = 0; mm < 4; ++mm) mma_bf16(acc[tg][4 * mh + mm], a[mm], b[tg][0], b[tg][1]);
      }
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty[st]);  // the stage is read
    }

    // this warp's partial sums: red[warp][token][n]; c0, c2 of mma m are
    // (token 2t, n 16 g + 2 m and + 1), c1, c3 token 2t + 1 (int4: n of
    // half m / MH as above)
    __syncwarp();
    hp::bar_sync(1, 128);  // every warp is done reading the ring
    float* red = reinterpret_cast<float*>(smem) + warp * TOK * NC;
#pragma unroll
    for (int tg = 0; tg < TG; ++tg)
#pragma unroll
      for (int m = 0; m < MMAS; ++m) {
        const int tok = 8 * tg + 2 * t, n = (m / MH) * (NC / HALVES) + SPAN * g + 2 * (m % MH);
        *reinterpret_cast<float2*>(red + tok * NC + n) = make_float2(acc[tg][m][0], acc[tg][m][2]);
        *reinterpret_cast<float2*>(red + (tok + 1) * NC + n) =
            make_float2(acc[tg][m][1], acc[tg][m][3]);
      }
  }
  __syncthreads();
  // the block's partial sums, warps added in order
  float* part = reinterpret_cast<float*>(smem) + 4 * TOK * NC;
  if (tid < 128) {
    const float* red = reinterpret_cast<const float*>(smem);
#pragma unroll
    for (int e4 = tid; e4 < TOK * NC / 4; e4 += 128) {
      float4 v = reinterpret_cast<const float4*>(red)[e4];
#pragma unroll
      for (int w = 1; w < 4; ++w) {
        const float4 o = reinterpret_cast<const float4*>(red + w * TOK * NC)[e4];
        v.x += o.x;
        v.y += o.y;
        v.z += o.z;
        v.w += o.w;
      }
      reinterpret_cast<float4*>(part)[e4] = v;
    }
  }
  hp::cluster_sync();
  // block `rank` of the cluster finishes the 16-column chunks c = rank,
  // rank + split, ..., adding the blocks' partials in rank order
  const uint32_t part_addr = hp::smem_u32(part);
  for (int c = rank; c < NC / 16; c += split) {
    for (int e4 = tid; e4 < TOK * 4; e4 += kDecThreads) {
      const int tok = e4 >> 2, n = 16 * c + 4 * (e4 & 3);
      const uint32_t off = part_addr + (tok * NC + n) * 4;
      float4 v = hp::ld_cluster_f4(hp::map_rank(off, 0));
      for (int q = 1; q < split; ++q) {
        const float4 o = hp::ld_cluster_f4(hp::map_rank(off, q));
        v.x += o.x;
        v.y += o.y;
        v.z += o.z;
        v.w += o.w;
      }
      const int col = out_col<MODE, NC>(n0, n, N);
      if (tok < M && col_ok<MODE, NC>(n0, n, N)) {
        if (MODE != kInt8Grouped) {
          const float4 s = *reinterpret_cast<const float4*>(scales + col);
          v.x *= s.x;
          v.y *= s.y;
          v.z *= s.z;
          v.w *= s.w;
        }
        __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
        uint2 out;
        out.x = *reinterpret_cast<uint32_t*>(&lo);
        out.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(y + (size_t)tok * N + col) = out;
      }
    }
  }
  hp::cluster_sync();  // no block leaves while another reads its partials
}

// The launch plans (paddle_tpu_torch/ops/kernels/wo_matmul.py declares the
// same ones for the kernel analyzer).
struct PrefillPlan {
  int bm, stages, smem;
};

inline PrefillPlan prefill_plan(int mode, int M, int N, int srows) {
  const int sb = scale_bytes(mode, srows);
  auto plan = [&](int bm) {
    const int stage = bm * kBK * 2 + w_tile(mode) + sb;
    const int fixed = 1024 + kPreConv * kConvTile + 16 * kPreStages;
    const int stages = std::min(kPreStages, (kSmemMax - fixed) / stage);
    return PrefillPlan{bm, stages, fixed + stages * stage};
  };
  // a 256-row block does twice a 128-row block's products in about 4/3 of
  // its time: the tall tile wins unless it leaves the card emptier by a
  // wave (k_proj's 48 tall tiles at 1531 rows against 96 short ones)
  const int cols = (N + kBN - 1) / kBN;
  const int waves256 = ((M + 255) / 256 * cols + kSms - 1) / kSms;
  const int waves128 = ((M + 127) / 128 * cols + kSms - 1) / kSms;
  const PrefillPlan tall = plan(256);
  return 4 * waves256 <= 3 * waves128 && tall.stages >= 3 ? tall : plan(128);
}

struct DecodePlan {
  int tg, split, kslice, stages, smem;
};

// The K split fills the card's block slots once (no second round); the
// ring takes what shared memory those blocks leave. `nc`: output columns
// a block.
inline DecodePlan decode_plan(int mode, int M, int N, int K, int srows, int nc = kBN) {
  const int tiles = (N + nc - 1) / nc;
  const int tg = M > 8 ? 2 : 1;
  const int blocks = dec_blocks(tg, nc);
  const int want = std::max(1, std::min(kDecSplit, blocks * kSms / tiles));
  const int kslice = round_up((K + want - 1) / want, kBK);
  const int stage = w_tile(mode, nc) + scale_bytes(mode, srows), x_stage = 8 * tg * kXRow * 2;
  const int fixed = 1024 + 16 * kDecStages;
  const int budget = kSmemSm / blocks - 1024;
  const int stages = std::max(2, std::min(kDecStages, (budget - fixed) / (stage + x_stage)));
  const int ring = std::max(stages * stage, 5 * 8 * tg * nc * 4);
  return DecodePlan{tg, (K + kslice - 1) / kslice, kslice, stages,
                    fixed + ring + stages * x_stage};
}

template <int MODE, int BM>
int launch_prefill(const CUtensorMap& tw, const CUtensorMap& ts, const void* x, const void* s,
                   void* y, int M, int N, int K, int G, int srows, const PrefillPlan& p,
                   cudaStream_t stream) {
  CUtensorMap tx;
  const int err = hp::make_bshd_map(&tx, x, 1, M, 1, K, BM);
  if (err != 0) return err;
  const cudaError_t attr = hp::allow_smem<wo_prefill_kernel<MODE, BM>>(kSmemMax);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((M + BM - 1) / BM, (N + kBN - 1) / kBN);
  wo_prefill_kernel<MODE, BM><<<grid, kPreThreads, p.smem, stream>>>(
      tx, tw, ts, static_cast<const float*>(s), static_cast<bf16*>(y), M, N, K, G, p.stages,
      srows);
  return (int)cudaGetLastError();
}

template <int MODE, int TG, int NC>
int launch_decode(const CUtensorMap& tw, const CUtensorMap& ts, const void* x, const void* s,
                  void* y, int M, int N, int K, int G, int srows, const DecodePlan& p,
                  cudaStream_t stream) {
  const cudaError_t attr = hp::allow_smem<wo_decode_kernel<MODE, TG, NC>>(kSmemMax);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.split, (N + NC - 1) / NC);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = p.split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, wo_decode_kernel<MODE, TG, NC>, static_cast<const bf16*>(x), tw, ts,
      static_cast<const float*>(s), static_cast<bf16*>(y), M, N, K, G, p.kslice, p.stages, srows);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Decode columns a block of packed int4: 256 (a 128-byte box of packed
// bytes a stage row, swizzled as the int8 weight's) where that grid's K split
// is set by the card's slots, not capped at kDecSplit (its tiles times the
// cap exceed its block slots), else 128 (a 64-byte box, unswizzled). What the
// rule models is what PERF.md's row 12c measured: where both widths fill the
// slots alike the wider box streams faster (gate/up: 256 columns split 4),
// and where the cap holds 256's split the grid leaves slots empty (down, q/o
// and k/v: split 8 on 16 or 4 tiles, at most 128 of 264 slots).
inline int int4_dec_cols(int M, int N) {
  const int tiles = (N + 2 * kBN - 1) / (2 * kBN);
  return (long long)tiles * kDecSplit > (long long)dec_blocks(M > 8 ? 2 : 1, 2 * kBN) * kSms
             ? 2 * kBN
             : kBN;
}

// `nc`: decode columns a block (int4 only; the other modes and prefill
// take kBN)
template <int MODE>
int launch_wo(const void* x, const void* w, const void* s, void* y, int M, int N, int K, int G,
              int nc, cudaStream_t stream) {
  if (K == 0) return (int)cudaMemsetAsync(y, 0, (size_t)M * N * sizeof(bf16), stream);
  const int srows = MODE == kInt8Grouped ? scale_rows(G) : 0;
  if (MODE != kInt4 || M > 16) nc = kBN;
  const int wrow = w_row(MODE, nc);
  CUtensorMap tw, ts;
  int err = hp::make_2d_map(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K,
                            MODE == kInt4 ? N / 2 : N, kBK, wrow,
                            wrow == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == 0 && MODE == kInt8Grouped)
    err = hp::make_2d_map(&ts, s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K / G, N, srows, kBN,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  if (MODE != kInt8Grouped) ts = tw;  // not read
  if (M > 16) {
    const PrefillPlan p = prefill_plan(MODE, M, N, srows);
    return p.bm == 256 ? launch_prefill<MODE, 256>(tw, ts, x, s, y, M, N, K, G, srows, p, stream)
                       : launch_prefill<MODE, 128>(tw, ts, x, s, y, M, N, K, G, srows, p, stream);
  }
  const DecodePlan p = decode_plan(MODE, M, N, K, srows, nc);
  if constexpr (MODE == kInt4) {
    if (nc == 256)
      return p.tg == 2
                 ? launch_decode<MODE, 2, 256>(tw, ts, x, s, y, M, N, K, G, srows, p, stream)
                 : launch_decode<MODE, 1, 256>(tw, ts, x, s, y, M, N, K, G, srows, p, stream);
  }
  return p.tg == 2 ? launch_decode<MODE, 2, kBN>(tw, ts, x, s, y, M, N, K, G, srows, p, stream)
                   : launch_decode<MODE, 1, kBN>(tw, ts, x, s, y, M, N, K, G, srows, p, stream);
}

}  // namespace

// x: [M, K] bf16; w: [K, N] int8; s: [N] f32; y: [M, N] bf16.
// K % 8 == 0, N % 16 == 0, every pointer 16-byte aligned (the wrapper checks).
PTT_EXPORT int ptt_wo_int8(const void* x, const void* w, const void* s, void* y, int M, int N,
                           int K, void* stream) {
  if (M == 0 || N == 0) return 0;
  return launch_wo<kInt8>(x, w, s, y, M, N, K, 1, kBN, static_cast<cudaStream_t>(stream));
}

// x: [M, K] bf16; w: [K, N] int8; s: [K/G, N] f32; y: [M, N] bf16.
PTT_EXPORT int ptt_wo_int8_grouped(const void* x, const void* w, const void* s, void* y, int M,
                                   int N, int K, int G, void* stream) {
  if (M == 0 || N == 0) return 0;
  return launch_wo<kInt8Grouped>(x, w, s, y, M, N, K, G, kBN, static_cast<cudaStream_t>(stream));
}

// x: [M, K] bf16; w: [K, N/2] packed bytes (halves layout); s: [N] f32;
// y: [M, N] bf16. K % 8 == 0, N % 32 == 0 (packed rows of 16-byte multiples).
PTT_EXPORT int ptt_wo_int4(const void* x, const void* w, const void* s, void* y, int M, int N,
                           int K, void* stream) {
  if (M == 0 || N == 0) return 0;
  return launch_wo<kInt4>(x, w, s, y, M, N, K, 1, M > 16 ? kBN : int4_dec_cols(M, N),
                          static_cast<cudaStream_t>(stream));
}
