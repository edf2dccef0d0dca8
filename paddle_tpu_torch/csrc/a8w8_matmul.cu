// A8W8 matrix product: per-row dynamic int8 quantization of the
// activations, an int8 x int8 -> int32 contraction on the tensor cores, and
// the dequant epilogue. bf16 activations in and out.
//
// Replaces paddle_tpu/ops/kernels/a8w8_matmul_pallas.py `_kernel` (:50),
// reached through `a8w8_matmul` (:75), which `nn.quant.llm_int8_linear`
// calls at prefill shapes. x is [M, K] bf16; w is [K, N] int8 ("kn") or
// [N, K] int8 ("nk", llm_int8_linear's out-feature-major layout); ws [N]
// f32; y [M, N] bf16.
//
// Numerics kept from the TPU kernel, bit for bit:
//   s[m] = max(rowmax(|f32(x[m, :])|), 1e-6) / 127        (IEEE f32 division)
//   q    = clip(round_half_even(x / s), -127, 127) as int8 (IEEE f32 division,
//                                                          never a reciprocal)
//   acc  = q . w in int32 (exact, whatever the order)
//   y    = bf16((f32(acc) * s[m]) * ws[n])
// The library is built without fast-math, so `/` and __fdiv_rn are the
// correctly rounded division; rintf rounds half to even as jnp.round does.
//
// Bound on the H100: operations, at the int8 tensor-core rate (1979 TOPS:
// 0.061 ms for [1024, 4096] x [4096, 14336]). Design: two launches. The row
// max needs the whole K row, which the TPU kernel recomputes for every
// column block; here a first pass, one block per row, writes s [M] f32 and
// q [M, K] int8 (4 MB at M 1024, K 4096). The second pass is an int8 GEMM
// with mma.sync m16n8k32 s8 x s8 -> s32: a 64 x 128 output tile per block,
// 2 x 2 warps of 32 x 64, k-tiles of 64 bytes read into registers while the
// previous tile's products run. The weight tile sits in shared memory as
// [n][k] (k contiguous), which is the "nk" layout as it is; a "kn" weight
// is transposed on the way in, four k rows at a time into one 32-bit word.
#include "common.cuh"

using ptt::bf16;

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// byte j (0..15) of a 16-byte vector, by shifts: with j known at compile
// time this stays in registers
__device__ __forceinline__ unsigned byte_of(const uint4& v, int j) {
  const unsigned w = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
  return (w >> (8 * (j & 3))) & 0xFFu;
}

// One block per row: s[row] and q[row, :].
__global__ void __launch_bounds__(256)
    a8w8_quantize_kernel(const bf16* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ s, int K) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const bf16* xr = x + row * K;
  float mx = 0.f;
  for (int i = threadIdx.x * 8; i < K; i += blockDim.x * 8) {
    float v[8];
    ptt::load8(xr + i, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fabsf(v[j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const float sc = __fdiv_rn(fmaxf(mx, 1e-6f), 127.0f);
  if (threadIdx.x == 0) s[row] = sc;
  int8_t* qr = q + row * K;
  for (int i = threadIdx.x * 8; i < K; i += blockDim.x * 8) {
    float v[8];
    ptt::load8(xr + i, v);
    uint32_t lo = 0u, hi = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float r = fminf(fmaxf(rintf(__fdiv_rn(v[j], sc)), -127.f), 127.f);
      const uint32_t b = (uint32_t)(uint8_t)(int8_t)(int)r;
      if (j < 4) lo |= b << (8 * j);
      else hi |= b << (8 * (j - 4));
    }
    *reinterpret_cast<uint2*>(qr + i) = make_uint2(lo, hi);
  }
}

template <bool NK>
__global__ void __launch_bounds__(kThreads)
    a8w8_gemm_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ w,
                     const float* __restrict__ srow, const float* __restrict__ ws,
                     bf16* __restrict__ y, int M, int N, int K) {
  constexpr int BM = 64, BN = 128, BK = 64;
  constexpr int ST = BK + 16;  // bytes per smem row: 20 words, conflict-free fragments
  constexpr int XL = BM * BK / 16 / kThreads;  // 16-byte chunks of the q tile per thread
  constexpr int WL = BN * BK / 16 / kThreads;  // 16-byte chunks of the w tile per thread
  constexpr int MT = 2, NT = 8;                // warp tile 32 x 64
  __shared__ __align__(16) int8_t Xs[BM * ST];
  __shared__ __align__(16) int8_t Ws[BN * ST];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 xr[XL], wr[WL];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / (BK / 16), c = (e % (BK / 16)) * 16;
      xr[i] = m0 + r < M && k0 + c < K
                  ? *reinterpret_cast<const uint4*>(q + (size_t)(m0 + r) * K + k0 + c)
                  : zero;
    }
    if constexpr (NK) {
#pragma unroll
      for (int i = 0; i < WL; ++i) {
        const int e = tid + i * kThreads;
        const int r = e / (BK / 16), c = (e % (BK / 16)) * 16;
        wr[i] = n0 + r < N && k0 + c < K
                    ? *reinterpret_cast<const uint4*>(w + (size_t)(n0 + r) * K + k0 + c)
                    : zero;
      }
    } else {
      // one quad of k rows x 16 columns per thread: WL == 4 rows
      const int kq = tid % (BK / 4), cc = (tid / (BK / 4)) * 16;
#pragma unroll
      for (int i = 0; i < WL; ++i) {
        const int k = k0 + 4 * kq + i;
        wr[i] = n0 + cc < N && k < K
                    ? *reinterpret_cast<const uint4*>(w + (size_t)k * N + n0 + cc)
                    : zero;
      }
    }
  };

  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / (BK / 16), c = (e % (BK / 16)) * 16;
      *reinterpret_cast<uint4*>(&Xs[r * ST + c]) = xr[i];
    }
    if constexpr (NK) {
#pragma unroll
      for (int i = 0; i < WL; ++i) {
        const int e = tid + i * kThreads;
        const int r = e / (BK / 16), c = (e % (BK / 16)) * 16;
        *reinterpret_cast<uint4*>(&Ws[r * ST + c]) = wr[i];
      }
    } else {
      const int kq = tid % (BK / 4), cc = (tid / (BK / 4)) * 16;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<uint32_t*>(&Ws[(cc + j) * ST + 4 * kq]) =
            byte_of(wr[0], j) | (byte_of(wr[1], j) << 8) |
            (byte_of(wr[2], j) << 16) | (byte_of(wr[3], j) << 24);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

  const int n_kt = (K + BK - 1) / BK;
  load(0);
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    store();
    __syncthreads();
    if (kt + 1 < n_kt) load((kt + 1) * BK);
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int8_t* xp = &Xs[(wm * 32 + mt * 16 + g) * ST + ks * 32 + 4 * t];
        a[mt][0] = ld32(xp);
        a[mt][1] = ld32(xp + 8 * ST);
        a[mt][2] = ld32(xp + 16);
        a[mt][3] = ld32(xp + 8 * ST + 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int8_t* wp = &Ws[(wn * 64 + nt * 8 + g) * ST + ks * 32 + 4 * t];
        const uint32_t b0 = ld32(wp), b1 = ld32(wp + 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = m0 + wm * 32 + mt * 16 + g + hf * 8;
      if (r >= M) continue;
      const float sr = srow[r];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * 64 + nt * 8 + 2 * t + e;
          if (col >= N) continue;
          const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * hf + e]), sr), ws[col]);
          y[(size_t)r * N + col] = __float2bfloat16_rn(v);
        }
      }
    }
  }
}

}  // namespace

// x: [M, K] bf16 -> q: [M, K] int8, s: [M] f32. K % 8 == 0.
PTT_EXPORT int ptt_a8w8_quantize(const void* x, void* q, void* s, int M, int K, void* stream) {
  if (M == 0) return 0;
  a8w8_quantize_kernel<<<M, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<int8_t*>(q), static_cast<float*>(s), K);
  return (int)cudaGetLastError();
}

// q: [M, K] int8; s: [M] f32; w: [N, K] (nk != 0) or [K, N] int8; ws: [N]
// f32; y: [M, N] bf16. K % 16 == 0, and N % 16 == 0 for "kn".
PTT_EXPORT int ptt_a8w8_gemm(const void* q, const void* s, const void* w, const void* ws, void* y,
                             int M, int N, int K, int nk, void* stream) {
  if (M == 0 || N == 0) return 0;
  const dim3 grid((M + 63) / 64, (N + 127) / 128);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nk)
    a8w8_gemm_kernel<true><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(w), static_cast<const float*>(s),
        static_cast<const float*>(ws), static_cast<bf16*>(y), M, N, K);
  else
    a8w8_gemm_kernel<false><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(w), static_cast<const float*>(s),
        static_cast<const float*>(ws), static_cast<bf16*>(y), M, N, K);
  return (int)cudaGetLastError();
}
