// Grouped expert product (the MoE grouped GEMM), bf16 in and out, f32
// accumulation on the bf16 tensor cores:
//   out[e, c, :] = x[e, c, :] @ B_e   for c < counts[e],
//   out[e, c, :] = 0                  for c >= counts[e].
//
// Replaces paddle_tpu/ops/kernels/moe_gemm_pallas.py `_grouped_call` (:74),
// kernel body `_kernel` (:34); the backward's dx (:112) is the same kernel
// on the transposed weight. x is [E, C, K] bf16 row-major; counts is [E]
// int32 on the device; out is [E, C, N] bf16. The weight B_e comes in one of
// two layouts, chosen by `w_nk`:
//   w_nk = 0: w is [E, K, N] (the forward's [E, H, F]);
//   w_nk = 1: w is [E, N, K], i.e. B_e = w[e]^T (dx = g @ w[e]^T reads the
//             forward's [E, H, F] weight as it lies, without a transposed
//             copy).
// K % 8 == 0 and N % 8 == 0 (16-byte rows; the wrapper checks); C is any
// size.
//
// Numerics kept from the TPU kernel: products of bf16 values are exact in
// f32 and summed in f32; each output is rounded to bf16 once; rows at or
// past counts[e] are written as zeros whatever x holds there (:46-49).
//
// Bound on the H100: bytes at Qwen1.5-MoE's widths (one [60, 2048, 1408]
// weight stack is 346 MB, read once per call: 0.103 ms at 3.35 TB/s,
// against 0.048 ms for the live rows' products on the tensor cores).
// Design: one block of 4 warps per (64-row capacity tile, 128-column output
// tile, expert); blocks along x walk the capacity tiles of one weight tile,
// so a weight tile is read from device memory once and served to the other
// capacity tiles from L2. Each block reads counts[e] itself (nothing waits
// on the host): a tile wholly at or past the count writes its zeros and
// returns without loading or multiplying; a live tile loads only its live
// rows (cp.async with a zero source size fills the rest with zeros), and a
// warp whose 32 rows are all past the count skips its products. Tiles of
// x and of the weight go through a 3-stage cp.async ring in shared memory
// (46 KB). mma.sync m16n8k16 reads the x fragments with 32-bit loads; the
// weight's B fragments come from a [k][n] tile through ldmatrix.trans
// (w_nk = 0) or from an [n][k] tile with 32-bit loads (w_nk = 1). Every row
// stride is padded by 16 bytes, so neither read conflicts on a bank.
#include "common.cuh"

using ptt::bf16;
using ptt::ld32;
using ptt::mma_bf16;

namespace {

constexpr int BM = 64;       // capacity rows per block (2 warps x 32)
constexpr int BN = 128;      // output columns per block (2 warps x 64)
constexpr int BK = 32;       // contraction depth of one stage
constexpr int STAGES = 3;
constexpr int THREADS = 128;
constexpr int AST = BK + 8;        // row stride of the x tile [BM][BK]
constexpr int BST_KN = BN + 8;     // row stride of a [BK][BN] weight tile
constexpr int BST_NK = BK + 8;     // row stride of a [BN][BK] weight tile
constexpr int A_ELEMS = BM * AST;
constexpr int B_ELEMS = BN * BST_NK > BK * BST_KN ? BN * BST_NK : BK * BST_KN;
constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
static_assert(BM * (BK / 8) % THREADS == 0 && BN * (BK / 8) % THREADS == 0,
              "every thread copies the same number of 16-byte chunks a stage");

// 16 bytes from global to shared memory, asynchronously; `ok` false writes
// 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 bf16 matrices of shared memory, transposed: lanes 8i..8i+7 give
// the row addresses of matrix i, and register i receives this lane's pair
// of matrix i's transpose (rows 2(lane%4) and 2(lane%4)+1 of column lane/4)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

template <bool NK>
__global__ void __launch_bounds__(THREADS)
    moe_gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const int* __restrict__ counts, bf16* __restrict__ out, int C, int K, int N) {
  __shared__ __align__(16) bf16 smem[STAGES * STAGE_ELEMS];
  const int e = blockIdx.z;
  const int c0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int count = min(max(__ldg(counts + e), 0), C);
  bf16* o = out + (size_t)e * C * N;
  const int tid = threadIdx.x;

  if (c0 >= count) {
    // the whole tile lies past the count: zeros, never multiplied
    const int rows = min(BM, C - c0);
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < rows * (BN / 8); i += THREADS) {
      const int r = i / (BN / 8), cc = n0 + (i % (BN / 8)) * 8;
      if (cc < N) *reinterpret_cast<uint4*>(o + (size_t)(c0 + r) * N + cc) = zero;
    }
    return;
  }

  const bf16* xe = x + (size_t)e * C * K;
  const bf16* we = w + (size_t)e * K * N;
  const int live = count - c0;  // rows of this tile below the count
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;  // 32-row, 64-column warp tile
  const bool warp_live = wm * 32 < live;

  auto load_tile = [&](int stage, int k0) {
    bf16* As = smem + stage * STAGE_ELEMS;
    bf16* Bs = As + A_ELEMS;
#pragma unroll
    for (int j = 0; j < BM * (BK / 8) / THREADS; ++j) {
      const int i = tid + j * THREADS, r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = r < live && k0 + c < K;
      cp_async16(As + r * AST + c, ok ? xe + (size_t)(c0 + r) * K + k0 + c : xe, ok);
    }
    if constexpr (NK) {
#pragma unroll
      for (int j = 0; j < BN * (BK / 8) / THREADS; ++j) {
        const int i = tid + j * THREADS, r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        const bool ok = n0 + r < N && k0 + c < K;
        cp_async16(Bs + r * BST_NK + c, ok ? we + (size_t)(n0 + r) * K + k0 + c : we, ok);
      }
    } else {
#pragma unroll
      for (int j = 0; j < BK * (BN / 8) / THREADS; ++j) {
        const int i = tid + j * THREADS, r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        const bool ok = k0 + r < K && n0 + c < N;
        cp_async16(Bs + r * BST_KN + c, ok ? we + (size_t)(k0 + r) * N + n0 + c : we, ok);
      }
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int n_kt = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_kt) load_tile(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's part)
    __syncthreads();              // ... every thread's part; tile kt-1 is fully read
    const int nxt = kt + STAGES - 1;
    if (nxt < n_kt) load_tile(nxt % STAGES, nxt * BK);
    cp_async_commit();
    if (!warp_live) continue;
    const bf16* As = smem + (kt % STAGES) * STAGE_ELEMS;
    const bf16* Bs = As + A_ELEMS;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* ap = As + (wm * 32 + mt * 16 + g) * AST + ks * 16 + 2 * t;
        a[mt][0] = ld32(ap);
        a[mt][1] = ld32(ap + 8 * AST);
        a[mt][2] = ld32(ap + 8);
        a[mt][3] = ld32(ap + 8 * AST + 8);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // two n8 tiles at a time
        uint32_t b[4];
        if constexpr (NK) {
          const bf16* bp = Bs + (wn * 64 + np * 16 + g) * BST_NK + ks * 16 + 2 * t;
          b[0] = ld32(bp);
          b[1] = ld32(bp + 8);
          b[2] = ld32(bp + 8 * BST_NK);
          b[3] = ld32(bp + 8 * BST_NK + 8);
        } else {
          const int kr = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int nc = wn * 64 + np * 16 + (lane >> 4) * 8;
          ldmatrix_x4_trans(b, Bs + kr * BST_KN + nc);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = n0 + wn * 64 + nt * 8 + 2 * t;  // even; N % 8 == 0 keeps col + 1 < N
    if (col >= N) continue;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = c0 + wm * 32 + mt * 16 + g + hf * 8;
        if (r >= C) continue;
        const bool keep = r < count;
        *reinterpret_cast<__nv_bfloat162*>(o + (size_t)r * N + col) = __floats2bfloat162_rn(
            keep ? acc[mt][nt][2 * hf] : 0.f, keep ? acc[mt][nt][2 * hf + 1] : 0.f);
      }
    }
  }
}

}  // namespace

// x: [E, C, K] bf16; w: [E, K, N] (w_nk = 0) or [E, N, K] (w_nk = 1) bf16;
// counts: [E] int32; out: [E, C, N] bf16. K % 8 == 0, N % 8 == 0, every
// pointer 16-byte aligned (the wrapper checks).
PTT_EXPORT int ptt_moe_gemm(const void* x, const void* w, const void* counts, void* out, int E,
                            int C, int K, int N, int w_nk, void* stream) {
  if (E == 0 || C == 0 || N == 0) return 0;
  const dim3 grid((C + BM - 1) / BM, (N + BN - 1) / BN, E);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const bf16*>(x);
  const auto* wp = static_cast<const bf16*>(w);
  const auto* cp = static_cast<const int*>(counts);
  auto* op = static_cast<bf16*>(out);
  if (w_nk)
    moe_gemm_kernel<true><<<grid, THREADS, 0, s>>>(xp, wp, cp, op, C, K, N);
  else
    moe_gemm_kernel<false><<<grid, THREADS, 0, s>>>(xp, wp, cp, op, C, K, N);
  return (int)cudaGetLastError();
}
