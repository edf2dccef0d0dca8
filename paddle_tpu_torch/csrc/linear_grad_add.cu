// Linear weight-gradient accumulation, bf16 operands on the tensor cores
// with f32 sums, the accumulator updated in place:
//   acc[K, N] += x[M, K]^T @ dy[M, N]
//
// Replaces paddle_tpu/ops/kernels/linear_grad_add_pallas.py `_grad_acc`
// (kernel body `_kernel`): the products of bf16 values are exact in f32 and
// summed in f32; the accumulator (f32 `main_grad`, or bf16) is read once,
// carried in f32 registers over the whole M sweep, and written once in its
// own type. The TPU kernel keeps its [256, 256] f32 tile in VMEM scratch
// across its sequential M grid axis; here one block owns its output tile for
// the whole sweep, a loop inside the block.
//
// Bound on the H100: operations at GPT-2's and Llama's widths (2 M K N on
// the bf16 tensor cores: 38.65 GFLOP for x [8192, 768], dy [8192, 3072]).
// Design: one block of 8 warps per 128 (K) x 128 (N) output tile, each warp
// 32 x 64; M walked in steps of 32 rows, the x and dy tiles ([32][128]
// each) through a 2-stage cp.async double buffer in shared memory, tail rows
// zero-filled with a source size of 0. mma.sync m16n8k16: the A fragments
// (x^T) come from the [m][k] x tile through ldmatrix.trans, the B fragments
// (dy as [k = m][n]) from the [m][n] dy tile through ldmatrix.trans, as
// moe_gemm.cu reads its [K, N] weight. Row strides are padded by 16 bytes,
// so neither read conflicts on a bank. K % 8 == 0 and N % 8 == 0; M is any
// size.
#include "common.cuh"

using ptt::bf16;
using ptt::mma_bf16;

namespace {

constexpr int BK = 128;      // output rows (x's columns) per block
constexpr int BN = 128;      // output columns (dy's columns) per block
constexpr int BM = 32;       // rows of x and dy per stage
constexpr int THREADS = 256;
constexpr int ST = BK + 8;   // row stride of a [BM][128] tile (BK == BN)
constexpr int TILE = BM * ST;
static_assert(BK == BN, "x and dy tiles share one layout");
static_assert(BM * (BK / 8) % THREADS == 0, "every thread copies the same chunks");

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ float acc_load(const float* p) { return *p; }
__device__ __forceinline__ float acc_load(const bf16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void acc_store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void acc_store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename A>
__global__ void __launch_bounds__(THREADS)
    linear_grad_add_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                           A* __restrict__ acc, int M, int K, int N) {
  __shared__ __align__(16) bf16 smem[2 * 2 * TILE];  // [stage][x | dy][BM][ST]
  const int k0 = blockIdx.y * BK, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wk = warp >> 1, wn = warp & 1;  // 32-row, 64-column warp tile

  auto load_tile = [&](int stage, int m0) {
    bf16* xs = smem + stage * 2 * TILE;
    bf16* ds = xs + TILE;
#pragma unroll
    for (int j = 0; j < BM * (BK / 8) / THREADS; ++j) {
      const int i = tid + j * THREADS, r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool row_ok = m0 + r < M;
      const bool okx = row_ok && k0 + c < K;
      const bool okd = row_ok && n0 + c < N;
      cp_async16(xs + r * ST + c, okx ? x + (size_t)(m0 + r) * K + k0 + c : x, okx);
      cp_async16(ds + r * ST + c, okd ? dy + (size_t)(m0 + r) * N + n0 + c : dy, okd);
    }
  };

  // f32 accumulators, initialised from the accumulator itself
  float c[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = k0 + wk * 32 + mt * 16 + g + hf * 8;
        const int col = n0 + wn * 64 + nt * 8 + 2 * t;
        const bool ok = row < K && col < N;  // N % 8 == 0 keeps col + 1 < N
        const A* p = acc + (size_t)row * N + col;
        c[mt][nt][2 * hf] = ok ? acc_load(p) : 0.f;
        c[mt][nt][2 * hf + 1] = ok ? acc_load(p + 1) : 0.f;
      }

  const int n_mt = (M + BM - 1) / BM;
  if (n_mt > 0) load_tile(0, 0);
  cp_async_commit();
  for (int it = 0; it < n_mt; ++it) {
    cp_async_wait_all();  // tile it has landed (this thread's part)
    __syncthreads();      // ... every thread's part; tile it-1 is fully read
    if (it + 1 < n_mt) load_tile((it + 1) & 1, (it + 1) * BM);
    cp_async_commit();
    const bf16* xs = smem + (it & 1) * 2 * TILE;
    const bf16* ds = xs + TILE;
#pragma unroll
    for (int ks = 0; ks < BM / 16; ++ks) {
      // A = x^T: rows k, columns m. Matrix q of the x4 load: m + 8 (q >> 1),
      // k + 8 (q & 1), giving the row-major A fragment's four registers.
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int q = lane >> 3;
        const int mr = ks * 16 + (lane & 7) + (q >> 1) * 8;
        const int kc = wk * 32 + mt * 16 + (q & 1) * 8;
        ldmatrix_x4_trans(a[mt], xs + mr * ST + kc);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // two n8 tiles at a time
        uint32_t b[4];
        const int mr = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int nc = wn * 64 + np * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(b, ds + mr * ST + nc);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(c[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(c[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = k0 + wk * 32 + mt * 16 + g + hf * 8;
        const int col = n0 + wn * 64 + nt * 8 + 2 * t;
        if (row < K && col < N)
          acc_store2(acc + (size_t)row * N + col, c[mt][nt][2 * hf], c[mt][nt][2 * hf + 1]);
      }
}

}  // namespace

// x: [M, K] bf16; dy: [M, N] bf16; acc: [K, N], f32 (acc_f32) or bf16,
// updated in place. All contiguous, 16-byte aligned; K % 8 == 0,
// N % 8 == 0; M any size (M == 0 leaves acc as it is).
PTT_EXPORT int ptt_linear_grad_add(const void* x, const void* dy, void* acc, int M, int K, int N,
                                   int acc_f32, void* stream) {
  if (K == 0 || N == 0 || M == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (K + BK - 1) / BK);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const bf16*>(x);
  const auto* dp = static_cast<const bf16*>(dy);
  if (acc_f32)
    linear_grad_add_kernel<float><<<grid, THREADS, 0, s>>>(xp, dp, static_cast<float*>(acc), M, K,
                                                           N);
  else
    linear_grad_add_kernel<bf16><<<grid, THREADS, 0, s>>>(xp, dp, static_cast<bf16*>(acc), M, K,
                                                          N);
  return (int)cudaGetLastError();
}
