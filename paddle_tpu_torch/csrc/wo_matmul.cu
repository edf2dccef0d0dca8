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
// convert to bf16 exactly (|q| <= 127 fits bf16's 8 significant bits).
//
// Bound on the H100: bytes in decode (M = 1..8 rows: the weight read once,
// 58.7 MB for gate_proj at int8, 0.018 ms at 3.35 TB/s), operations in
// prefill (M = 64..2048: 120 GFLOP for gate_proj at M 1024, 0.12 ms on the
// bf16 tensor cores). Design: one kernel template, two tilings. Each k-tile
// of x (bf16) and of w (int8 or packed bytes) is read from device memory
// into registers while the previous tile's products run, then converted to
// bf16 into shared memory with the weight TRANSPOSED ([n][k], k contiguous),
// so that mma.sync m16n8k16 reads its B fragments with 32-bit loads, as
// flash_attention.cu does. Two consecutive k rows are converted together
// and stored as one bf16x2 word; the threads of a warp take consecutive
// k-row pairs, so those stores hit 32 distinct banks. The conversion is
// exact and avoids the quarter-rate int-to-float instruction: a byte
// permute places the biased value u = q + 128 (a nibble: q + 8) in the low
// mantissa of 2^23, one f32 subtraction leaves q, and the top half of its
// f32 bits is its bf16 (|q| <= 128 has at most 8 significant bits). The
// first version of this kernel converted with I2F and ran the 1024-row
// prefill product at 7x its bound, limited by the conversion.
//   decode  (M <= 16): a 16-row output tile 16 columns wide (int8; 32 for
//           int4, whose 16-byte chunks hold 32 columns), k-tile 256; the
//           four warps split each k-tile and their partial sums are added in
//           a fixed order through shared memory (deterministic, no atomics).
//           16 columns a block gives 64-896 blocks at Llama-3-8B's widths.
//   prefill (M > 16): 128 x 128 output tile, k-tile 64, 8 warps as 4 x 2 of
//           32 x 64: each converted weight tile serves 128 rows.
// Blocks along x walk the row tiles of one column tile, so a weight tile
// is read from device memory once and served to the other row tiles from L2.
#include "common.cuh"

using ptt::bf16;
using ptt::ld32;
using ptt::mma_bf16;

namespace {

enum Mode { kInt8 = 0, kInt8Grouped = 1, kInt4 = 2 };

// two f32 values -> one bf16x2 word, `lo` in the low half (the smaller k)
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

template <int MODE, int BM, int BN, int BK, int WM, int WN, int WK>
__global__ void __launch_bounds__(WM * WN * WK * 32)
    wo_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ scales, bf16* __restrict__ y, int M, int N,
                     int K, int G) {
  constexpr int T = WM * WN * WK * 32;              // threads
  constexpr int XST = BK + 8;                       // bf16 row stride of both smem tiles
  constexpr int WB = MODE == kInt4 ? BN / 2 : BN;   // weight bytes per k row of a tile
  constexpr int XCH = BM * BK / 8;                  // 16-byte x chunks of a tile
  constexpr int WCH = (BK / 2) * (WB / 16);         // (2 k rows x 16 bytes) chunks of a tile
  constexpr int XL = (XCH + T - 1) / T, WP = (WCH + T - 1) / T;  // per thread
  static_assert(WB % 16 == 0 && BK % 32 == 0, "16-byte weight chunks, k16 steps per warp");
  constexpr int MT = BM / WM / 16, NT = BN / WN / 8;
  constexpr int TILE_BYTES = (BM + BN) * XST * 2;
  constexpr int RED_BYTES = (WK - 1) * BM * BN * 4;
  constexpr int SMEM = TILE_BYTES > RED_BYTES ? TILE_BYTES : RED_BYTES;
  __shared__ __align__(16) unsigned char smem[SMEM];
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* Ws = Xs + BM * XST;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wk = warp % WK, wn = (warp / WK) % WN, wm = warp / (WK * WN);
  const int m0 = blockIdx.x * BM;
  const int NB = MODE == kInt4 ? N / 2 : N;  // bytes per row of w
  const int c0 = blockIdx.y * WB;            // first byte column of this tile

  uint4 xr[XL], wr[WP][2];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int e = tid + i * T;
      const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
      xr[i] = ((XCH % T == 0 || e < XCH) && m0 + r < M && k0 + c < K)
                  ? *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + c)
                  : zero;
    }
#pragma unroll
    for (int i = 0; i < WP; ++i) {
      const int e = tid + i * T;
      const int kp = e % (BK / 2), cc = (e / (BK / 2)) * 16;
      const int k = k0 + 2 * kp, col = c0 + cc;
      const bool ok = (WCH % T == 0 || e < WCH) && col < NB;
      wr[i][0] = ok && k < K ? *reinterpret_cast<const uint4*>(w + (size_t)k * NB + col) : zero;
      wr[i][1] = ok && k + 1 < K ? *reinterpret_cast<const uint4*>(w + (size_t)(k + 1) * NB + col)
                                 : zero;
    }
  };

  auto store = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int e = tid + i * T;
      const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
      if (XCH % T == 0 || e < XCH) *reinterpret_cast<uint4*>(&Xs[r * XST + c]) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < WP; ++i) {
      const int e = tid + i * T;
      if (WCH % T != 0 && e >= WCH) continue;
      const int kp = e % (BK / 2), cc = (e / (BK / 2)) * 16;
      uint32_t* dst = reinterpret_cast<uint32_t*>(Ws) + (cc * XST) / 2 + kp;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t w0 = word_of(wr[i][0], q), w1 = word_of(wr[i][1], q);
        if constexpr (MODE == kInt4) {
          // low nibbles -> columns j, high nibbles -> columns j + N/2
          const uint32_t l0 = (w0 ^ 0x88888888u) & 0x0F0F0F0Fu;
          const uint32_t l1 = (w1 ^ 0x88888888u) & 0x0F0F0F0Fu;
          const uint32_t h0 = ((w0 ^ 0x88888888u) >> 4) & 0x0F0F0F0Fu;
          const uint32_t h1 = ((w1 ^ 0x88888888u) >> 4) & 0x0F0F0F0Fu;
          uint32_t* dst_hi = dst + (BN / 2) * XST / 2;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = 4 * q + jj;
            dst[j * XST / 2] = pack2_exact(biased_byte(l0, jj, 8.f), biased_byte(l1, jj, 8.f));
            dst_hi[j * XST / 2] =
                pack2_exact(biased_byte(h0, jj, 8.f), biased_byte(h1, jj, 8.f));
          }
        } else {
          const uint32_t u0 = w0 ^ 0x80808080u, u1 = w1 ^ 0x80808080u;
          if constexpr (MODE == kInt8Grouped) {
            const int k = k0 + 2 * kp, col = c0 + cc;
            const bool ok = col < N && k < K;
            const float* s0 = scales + (size_t)(k / G) * N + col;
            const float* s1 = scales + (size_t)((k + 1) / G) * N + col;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int j = 4 * q + jj;
              dst[j * XST / 2] =
                  ok ? pack2(biased_byte(u0, jj, 128.f) * s0[j], biased_byte(u1, jj, 128.f) * s1[j])
                     : 0u;
            }
          } else {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              dst[(4 * q + jj) * XST / 2] =
                  pack2_exact(biased_byte(u0, jj, 128.f), biased_byte(u1, jj, 128.f));
          }
        }
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int n_kt = (K + BK - 1) / BK;
  load(0);
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // the previous tile is fully read
    store(kt * BK);
    __syncthreads();
    if (kt + 1 < n_kt) load((kt + 1) * BK);  // in flight during this tile's products
#pragma unroll
    for (int ks = wk; ks < BK / 16; ks += WK) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bf16* xp = &Xs[(wm * (BM / WM) + mt * 16 + g) * XST + ks * 16 + 2 * t];
        a[mt][0] = ld32(xp);
        a[mt][1] = ld32(xp + 8 * XST);
        a[mt][2] = ld32(xp + 8);
        a[mt][3] = ld32(xp + 8 * XST + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* wp = &Ws[(wn * (BN / WN) + nt * 8 + g) * XST + ks * 16 + 2 * t];
        const uint32_t b0 = ld32(wp), b1 = ld32(wp + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }

  if constexpr (WK > 1) {
    // warps 1..WK-1 hand their partial sums to warp 0 of the same output
    // tile, which adds them in a fixed order
    constexpr int FR = MT * NT * 4;
    float* red = reinterpret_cast<float*>(smem);
    const int wt = wm * WN + wn;
    __syncthreads();
    if (wk > 0) {
      float* mine = red + ((wk - 1) * WM * WN + wt) * FR * 32 + lane;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) mine[((mt * NT + nt) * 4 + e) * 32] = acc[mt][nt][e];
    }
    __syncthreads();
    if (wk > 0) return;
#pragma unroll
    for (int o = 1; o < WK; ++o) {
      const float* theirs = red + ((o - 1) * WM * WN + wt) * FR * 32 + lane;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += theirs[((mt * NT + nt) * 4 + e) * 32];
    }
  }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int lc = wn * (BN / WN) + nt * 8 + 2 * t;  // even column of the tile
    int col;
    bool ok;
    if constexpr (MODE == kInt4) {
      const int j = c0 + (lc < BN / 2 ? lc : lc - BN / 2);
      ok = j < NB;
      col = lc < BN / 2 ? j : NB + j;
    } else {
      col = c0 + lc;
      ok = col < N;
    }
    if (!ok) continue;
    float s0 = 1.f, s1 = 1.f;
    if constexpr (MODE != kInt8Grouped) {
      s0 = scales[col];
      s1 = scales[col + 1];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = m0 + wm * (BM / WM) + mt * 16 + g + hf * 8;
        if (r >= M) continue;
        const float v0 = acc[mt][nt][2 * hf], v1 = acc[mt][nt][2 * hf + 1];
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)r * N + col) =
            MODE == kInt8Grouped ? __floats2bfloat162_rn(v0, v1)
                                 : __floats2bfloat162_rn(v0 * s0, v1 * s1);
      }
    }
  }
}

template <int MODE, int BM, int BN, int BK, int WM, int WN, int WK>
void launch_tiled(const void* x, const void* w, const void* s, void* y, int M, int N, int K,
                  int G, cudaStream_t stream) {
  constexpr int WB = MODE == kInt4 ? BN / 2 : BN;  // byte columns of w a block takes
  const int cols = MODE == kInt4 ? N / 2 : N;
  const dim3 grid((M + BM - 1) / BM, (cols + WB - 1) / WB);
  wo_matmul_kernel<MODE, BM, BN, BK, WM, WN, WK><<<grid, WM * WN * WK * 32, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(s),
      static_cast<bf16*>(y), M, N, K, G);
}

template <int MODE>
int launch(const void* x, const void* w, const void* s, void* y, int M, int N, int K, int G,
           cudaStream_t stream) {
  if (M > 16) {
    launch_tiled<MODE, 128, 128, 64, 4, 2, 1>(x, w, s, y, M, N, K, G, stream);
  } else {
    // a 16-byte chunk of packed int4 bytes holds 32 columns
    if constexpr (MODE == kInt4)
      launch_tiled<MODE, 16, 32, 256, 1, 1, 4>(x, w, s, y, M, N, K, G, stream);
    else
      launch_tiled<MODE, 16, 16, 256, 1, 1, 4>(x, w, s, y, M, N, K, G, stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: [M, K] bf16; w: [K, N] int8; s: [N] f32; y: [M, N] bf16.
// K % 8 == 0, N % 16 == 0 (the wrapper checks).
PTT_EXPORT int ptt_wo_int8(const void* x, const void* w, const void* s, void* y, int M, int N,
                           int K, void* stream) {
  if (M == 0 || N == 0) return 0;
  return launch<kInt8>(x, w, s, y, M, N, K, 1, static_cast<cudaStream_t>(stream));
}

// x: [M, K] bf16; w: [K, N] int8; s: [K/G, N] f32; y: [M, N] bf16.
PTT_EXPORT int ptt_wo_int8_grouped(const void* x, const void* w, const void* s, void* y, int M,
                                   int N, int K, int G, void* stream) {
  if (M == 0 || N == 0) return 0;
  return launch<kInt8Grouped>(x, w, s, y, M, N, K, G, static_cast<cudaStream_t>(stream));
}

// x: [M, K] bf16; w: [K, N/2] packed bytes (halves layout); s: [N] f32;
// y: [M, N] bf16. K % 8 == 0, N % 32 == 0.
PTT_EXPORT int ptt_wo_int4(const void* x, const void* w, const void* s, void* y, int M, int N,
                           int K, void* stream) {
  if (M == 0 || N == 0) return 0;
  return launch<kInt4>(x, w, s, y, M, N, K, 1, static_cast<cudaStream_t>(stream));
}
