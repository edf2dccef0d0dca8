// One-tile checks of paddle_tpu_torch/csrc/hopper.cuh on the card, built and
// called by tests/test_torch_cuda.py (`test_hopper_*`) and held against
// torch.matmul: a TMA copy into the 128-byte swizzle signalled by an
// mbarrier, then one warpgroup's wgmma chain.
//   ss: C [64, N] = A [64, K] B [N, K]^T, both K-major through descriptors
//       (K = 128: two 64-column sub-tiles, eight 16-deep steps);
//   rs: C [64, N] = A [64, 64] B [64, N], A from registers (laid out as an
//       f32 accumulator, then pack_a, as the flash kernels form P), B
//       MN-major through its descriptor.
#include "hopper.cuh"

using ptt::bf16;
namespace hp = ptt::hopper;

namespace {

constexpr int kK = 128;   // ss reduction depth
constexpr int kRK = 64;   // rs reduction depth

template <int N>
__device__ void store_acc(const float* acc, float* c) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int row = 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    c[row * N + col] = acc[i];
  }
}

template <int N>
__global__ void __launch_bounds__(128) check_ss_kernel(const __grid_constant__ CUtensorMap ta,
                                                       const __grid_constant__ CUtensorMap tb,
                                                       float* c) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (hp::smem_u32(smem_raw) & 1023u)) & 1023u);
  bf16* sA = reinterpret_cast<bf16*>(smem);               // [2][64][64]
  bf16* sB = reinterpret_cast<bf16*>(smem + 64 * kK * 2);  // [2][N][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 64 * kK * 2 + N * kK * 2);
  if (threadIdx.x == 0) {
    hp::mbar_init(bar, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hp::mbar_arrive_expect_tx(bar, (64 + N) * kK * 2);
    for (int h = 0; h < 2; ++h) {
      hp::tma_load_4d(sA + h * 64 * 64, &ta, bar, h * 64, 0, 0, 0);
      hp::tma_load_4d(sB + h * N * 64, &tb, bar, h * 64, 0, 0, 0);
    }
  }
  hp::mbar_wait(bar, 0);
  float acc[N / 2];
  const uint32_t a = hp::smem_u32(sA), b = hp::smem_u32(sB);
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    hp::Wgmma<N>::template ss<0>(acc, hp::desc_kmajor(a + (kk >> 2) * (64 * 128) + off),
                                 hp::desc_kmajor(b + (kk >> 2) * (N * 128) + off),
                                 kk > 0 ? 1 : 0);
  }
  hp::wgmma_commit();
  hp::fence_acc<N / 2>(acc);
  hp::wgmma_wait<0>();
  hp::fence_acc<N / 2>(acc);
  store_acc<N>(acc, c);
}

template <int N>
__global__ void __launch_bounds__(128) check_rs_kernel(const float* __restrict__ a,
                                                       const __grid_constant__ CUtensorMap tb,
                                                       float* c) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (hp::smem_u32(smem_raw) & 1023u)) & 1023u);
  bf16* sB = reinterpret_cast<bf16*>(smem);  // [N / 64][64 rows][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kRK * N * 2);
  if (threadIdx.x == 0) {
    hp::mbar_init(bar, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hp::mbar_arrive_expect_tx(bar, kRK * N * 2);
    for (int h = 0; h < N / 64; ++h) hp::tma_load_4d(sB + h * kRK * 64, &tb, bar, h * 64, 0, 0, 0);
  }
  // A [64, 64] as an m64n64 accumulator, then the k-steps' register operands
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  float af[kRK / 2];
#pragma unroll
  for (int i = 0; i < kRK / 2; ++i) {
    const int row = 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    af[i] = a[row * kRK + col];
  }
  uint32_t ar[kRK / 16][4];
#pragma unroll
  for (int j = 0; j < kRK / 16; ++j) hp::pack_a(&af[8 * j], ar[j]);
  hp::mbar_wait(bar, 0);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const uint32_t b = hp::smem_u32(sB);
  hp::wgmma_fence();
#pragma unroll
  for (int j = 0; j < kRK / 16; ++j)
    hp::Wgmma<N>::template rs<1>(acc, ar[j], hp::desc_mnmajor(b + j * 2048, kRK * 128), 1);
  hp::wgmma_commit();
  hp::fence_acc<N / 2>(acc);
  hp::wgmma_wait<0>();
  hp::fence_acc<N / 2>(acc);
  store_acc<N>(acc, c);
}

template <int N>
int run_ss(const void* a, const void* b, void* c, cudaStream_t s) {
  CUtensorMap ta, tb;
  int err = hp::make_bshd_map(&ta, a, 1, 64, 1, kK, 64);
  if (err == 0) err = hp::make_bshd_map(&tb, b, 1, N, 1, kK, N);
  if (err != 0) return err;
  const int smem = 1024 + (64 + N) * kK * 2 + 8;
  const cudaError_t e =
      cudaFuncSetAttribute(check_ss_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  check_ss_kernel<N><<<1, 128, smem, s>>>(ta, tb, static_cast<float*>(c));
  return (int)cudaGetLastError();
}

template <int N>
int run_rs(const void* a, const void* b, void* c, cudaStream_t s) {
  CUtensorMap tb;
  const int err = hp::make_bshd_map(&tb, b, 1, kRK, 1, N, kRK);
  if (err != 0) return err;
  const int smem = 1024 + kRK * N * 2 + 8;
  const cudaError_t e =
      cudaFuncSetAttribute(check_rs_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  check_rs_kernel<N><<<1, 128, smem, s>>>(static_cast<const float*>(a), tb,
                                          static_cast<float*>(c));
  return (int)cudaGetLastError();
}

}  // namespace

// a [64, 128] bf16, b [n, 128] bf16, c [64, n] f32; n in {32, 64, 128}
PTT_EXPORT int ptt_check_ss(const void* a, const void* b, void* c, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 32) return run_ss<32>(a, b, c, s);
  if (n == 64) return run_ss<64>(a, b, c, s);
  if (n == 128) return run_ss<128>(a, b, c, s);
  return (int)cudaErrorInvalidValue;
}

// a [64, 64] f32 (rounded to bf16 in registers), b [64, n] bf16, c [64, n]
// f32; n in {64, 128}
PTT_EXPORT int ptt_check_rs(const void* a, const void* b, void* c, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 64) return run_rs<64>(a, b, c, s);
  if (n == 128) return run_rs<128>(a, b, c, s);
  return (int)cudaErrorInvalidValue;
}
