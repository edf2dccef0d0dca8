// One-tile checks of paddle_tpu_torch/csrc/hopper.cuh on the card, built and
// called by tests/test_torch_cuda.py (`test_hopper_*`) and held against
// torch.matmul: a TMA copy into the 128-byte swizzle signalled by an
// mbarrier, then one warpgroup's wgmma chain.
//   ss: C [64, N] = A [64, K] B [N, K]^T, both K-major through descriptors
//       (K = 128: two 64-column sub-tiles, eight 16-deep steps; N 24 and
//       48 are three and six 8-row swizzle groups, as the decode layer's
//       three bf16 terms of 8 or 16 batch rows);
//   rs: C [64, N] = A [64, 64] B [64, N], A from registers (laid out as an
//       f32 accumulator, then pack_a, as the flash kernels form P), B
//       MN-major through its descriptor;
//   ss_t: C [64, N] = A^T B with A stored [64 k, 64 m] and B [64 k, N], both
//       MN-major (the reduction is the row dimension of both, as tokens are
//       in the weight-gradient product x^T dy): A's transpose bit set;
//   mn_store: C [64, N] = A [64, 64] (B_0 + B_1 + B_2 + B_3), each B_r
//       [64, N] written by the threads into ONE MN-major swizzled tile (as
//       the weight-only kernels write their dequantised tile), then
//       fence_proxy_async, a barrier and the wgmma that reads it: a missing
//       fence shows as a stale B_r now and then;
//   tma_2d: one box of a 2-D tensor map (int8 with the 128-byte swizzle, or
//       f32 unswizzled) copied out element by element, the swizzle undone,
//       at coordinates that may pass the tensor's edges (zeros there);
//   bulk: rows of a global tensor brought in by bulk copies (no tensor
//       map), each signalled on one mbarrier, copied out;
//   s8: C [64, 256] s32 = A [64, K] B [256, K]^T for int8 A and B, both
//       K-major, each brought in by 2-D TMA boxes of 128 bytes a row with
//       the 128-byte swizzle (as the A8W8 product loads q and the weight),
//       then WgmmaS8<256>: K = 256 is two sub-tiles of four 32-deep steps,
//       each step 32 bytes further, the next sub-tile the next box.
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

template <int N>
__global__ void __launch_bounds__(128) check_ss_t_kernel(const __grid_constant__ CUtensorMap ta,
                                                         const __grid_constant__ CUtensorMap tb,
                                                         float* c) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (hp::smem_u32(smem_raw) & 1023u)) & 1023u);
  bf16* sA = reinterpret_cast<bf16*>(smem);              // [64 k][64 m]
  bf16* sB = reinterpret_cast<bf16*>(smem + kRK * 64 * 2);  // [N / 64][64 k][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kRK * 64 * 2 + kRK * N * 2);
  if (threadIdx.x == 0) {
    hp::mbar_init(bar, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hp::mbar_arrive_expect_tx(bar, kRK * (64 + N) * 2);
    hp::tma_load_4d(sA, &ta, bar, 0, 0, 0, 0);
    for (int h = 0; h < N / 64; ++h) hp::tma_load_4d(sB + h * kRK * 64, &tb, bar, h * 64, 0, 0, 0);
  }
  hp::mbar_wait(bar, 0);
  float acc[N / 2];
  const uint32_t a = hp::smem_u32(sA), b = hp::smem_u32(sB);
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kRK / 16; ++kk)
    hp::Wgmma<N>::template ss<1, 1>(acc, hp::desc_mnmajor(a + kk * 2048, kRK * 128),
                                    hp::desc_mnmajor(b + kk * 2048, kRK * 128), kk > 0 ? 1 : 0);
  hp::wgmma_commit();
  hp::fence_acc<N / 2>(acc);
  hp::wgmma_wait<0>();
  hp::fence_acc<N / 2>(acc);
  store_acc<N>(acc, c);
}

template <int N>
int run_ss_t(const void* a, const void* b, void* c, cudaStream_t s) {
  CUtensorMap ta, tb;
  int err = hp::make_bshd_map(&ta, a, 1, kRK, 1, 64, kRK);
  if (err == 0) err = hp::make_bshd_map(&tb, b, 1, kRK, 1, N, kRK);
  if (err != 0) return err;
  const int smem = 1024 + kRK * (64 + N) * 2 + 8;
  const cudaError_t e =
      cudaFuncSetAttribute(check_ss_t_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  check_ss_t_kernel<N><<<1, 128, smem, s>>>(ta, tb, static_cast<float*>(c));
  return (int)cudaGetLastError();
}

constexpr int kReps = 4;  // mn_store: tiles written into the same buffer

template <int N>
__global__ void __launch_bounds__(128) check_mn_store_kernel(const __grid_constant__ CUtensorMap ta,
                                                             const bf16* __restrict__ b,
                                                             float* c) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (hp::smem_u32(smem_raw) & 1023u)) & 1023u);
  bf16* sA = reinterpret_cast<bf16*>(smem);                   // [64][64] K-major
  unsigned char* sB = smem + 64 * kRK * 2;                     // [N / 64][64 k][128 B]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sB + kRK * N * 2);
  if (threadIdx.x == 0) {
    hp::mbar_init(bar, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hp::mbar_arrive_expect_tx(bar, 64 * kRK * 2);
    hp::tma_load_4d(sA, &ta, bar, 0, 0, 0, 0);
  }
  hp::mbar_wait(bar, 0);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int rep = 0; rep < kReps; ++rep) {
    // row k, 16-byte chunk j of B_rep -> sub-tile j / 8, chunk (j % 8) ^ (k % 8)
    const bf16* src = b + (size_t)rep * kRK * N;
    for (int e = threadIdx.x; e < kRK * N / 8; e += 128) {
      const int k = e / (N / 8), j = e % (N / 8);
      *reinterpret_cast<uint4*>(sB + (j >> 3) * (kRK * 128) + k * 128 + (((j & 7) ^ (k & 7)) << 4)) =
          *reinterpret_cast<const uint4*>(src + k * N + 8 * j);
    }
    hp::fence_proxy_async();
    __syncthreads();
    const uint32_t a = hp::smem_u32(sA), bb = hp::smem_u32(sB);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRK / 16; ++kk)
      hp::Wgmma<N>::template ss<1>(acc, hp::desc_kmajor(a + kk * 32),
                                   hp::desc_mnmajor(bb + kk * 2048, kRK * 128), 1);
    hp::wgmma_commit();
    hp::fence_acc<N / 2>(acc);
    hp::wgmma_wait<0>();
    hp::fence_acc<N / 2>(acc);
    __syncthreads();  // the tile is read before the next one is written
  }
  store_acc<N>(acc, c);
}

template <int N>
int run_mn_store(const void* a, const void* b, void* c, cudaStream_t s) {
  CUtensorMap ta;
  const int err = hp::make_bshd_map(&ta, a, 1, 64, 1, kRK, 64);
  if (err != 0) return err;
  const int smem = 1024 + 64 * kRK * 2 + kRK * N * 2 + 8;
  const cudaError_t e = cudaFuncSetAttribute(check_mn_store_kernel<N>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  check_mn_store_kernel<N><<<1, 128, smem, s>>>(ta, static_cast<const bf16*>(b),
                                                static_cast<float*>(c));
  return (int)cudaGetLastError();
}

// one box of `tm` at (c0, r0) -> out [box_rows][box_cols] elements of
// `elem` bytes; a 128-byte swizzled box (int8) has its chunks put back
__global__ void __launch_bounds__(128) check_tma_2d_kernel(const __grid_constant__ CUtensorMap tm,
                                                           unsigned char* out, int elem,
                                                           int box_rows, int box_cols, int c0,
                                                           int r0, int swizzled) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (hp::smem_u32(smem_raw) & 1023u)) & 1023u);
  const int row_bytes = box_cols * elem, bytes = box_rows * row_bytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + ((bytes + 1023) & ~1023));
  if (threadIdx.x == 0) {
    hp::mbar_init(bar, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hp::mbar_arrive_expect_tx(bar, bytes);
    hp::tma_load_2d(smem, &tm, bar, c0, r0);
  }
  hp::mbar_wait(bar, 0);
  for (int i = threadIdx.x; i < bytes; i += 128) {
    const int r = i / row_bytes, b = i % row_bytes;
    const int src = swizzled ? r * row_bytes + ((((b >> 4) ^ (r & 7))) << 4) + (b & 15) : i;
    out[i] = smem[src];
  }
}

// `rows` bulk copies of `bytes` each, row r from src + r * stride bytes into
// shared row r (stride `bytes`), then out
__global__ void __launch_bounds__(128) check_bulk_kernel(const unsigned char* src, unsigned char* out,
                                                         int rows, int bytes, int stride) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (hp::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + ((rows * bytes + 1023) & ~1023));
  if (threadIdx.x == 0) {
    hp::mbar_init(bar, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hp::mbar_arrive_expect_tx(bar, rows * bytes);
    for (int r = 0; r < rows; ++r) hp::bulk_load(smem + r * bytes, src + (size_t)r * stride, bytes, bar);
  }
  hp::mbar_wait(bar, 0);
  for (int i = threadIdx.x; i < rows * bytes; i += 128) out[i] = smem[i];
}

constexpr int kS8K = 256;  // s8 reduction depth: two 128-byte sub-tiles

__global__ void __launch_bounds__(128) check_s8_kernel(const __grid_constant__ CUtensorMap ta,
                                                       const __grid_constant__ CUtensorMap tb,
                                                       int* c) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (hp::smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* sA = smem;                       // [2][64 rows][128 bytes]
  unsigned char* sB = smem + 2 * 64 * 128;        // [2][256 rows][128 bytes]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sB + 2 * 256 * 128);
  if (threadIdx.x == 0) {
    hp::mbar_init(bar, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hp::mbar_arrive_expect_tx(bar, (64 + 256) * kS8K);
    for (int h = 0; h < 2; ++h) {
      hp::tma_load_2d(sA + h * 64 * 128, &ta, bar, h * 128, 0);
      hp::tma_load_2d(sB + h * 256 * 128, &tb, bar, h * 128, 0);
    }
  }
  hp::mbar_wait(bar, 0);
  int acc[128];
  const uint32_t a = hp::smem_u32(sA), b = hp::smem_u32(sB);
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kS8K / 32; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    hp::WgmmaS8<256>::ss(acc, hp::desc_kmajor(a + (kk >> 2) * (64 * 128) + off),
                         hp::desc_kmajor(b + (kk >> 2) * (256 * 128) + off), kk > 0 ? 1 : 0);
  }
  hp::wgmma_commit();
  hp::fence_acc<128>(acc);
  hp::wgmma_wait<0>();
  hp::fence_acc<128>(acc);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
#pragma unroll
  for (int i = 0; i < 128; ++i) {
    const int row = 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    c[row * 256 + col] = acc[i];
  }
}

}  // namespace

// rows x bytes (a multiple of 16) from src rows `stride` bytes apart (16-byte
// aligned) into out [rows, bytes]
PTT_EXPORT int ptt_check_bulk(const void* src, void* out, int rows, int bytes, int stride,
                              void* stream) {
  const int smem = 1024 + ((rows * bytes + 1023) & ~1023) + 8;
  const cudaError_t e = cudaFuncSetAttribute(check_bulk_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  check_bulk_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(out), rows, bytes, stride);
  return (int)cudaGetLastError();
}

// a [64, 64] bf16, b [4][64, n] bf16, c [64, n] f32 = a (b_0 + .. + b_3);
// n in {64, 128}
PTT_EXPORT int ptt_check_mn_store(const void* a, const void* b, void* c, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 64) return run_mn_store<64>(a, b, c, s);
  if (n == 128) return run_mn_store<128>(a, b, c, s);
  return (int)cudaErrorInvalidValue;
}

// src [rows, cols] of int8 (elem 1: box 64 x 128 bytes, 128-byte swizzle) or
// f32 (elem 4: box box_rows x 128, unswizzled); out [box_rows, 128]
// elements: the box at column c0, row r0
PTT_EXPORT int ptt_check_tma_2d(const void* src, void* out, int rows, int cols, int elem,
                                int box_rows, int c0, int r0, void* stream) {
  const bool i8 = elem == 1;
  CUtensorMap tm;
  const int err = hp::encode_2d_map(
      &tm, src, i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, elem, rows,
      cols, box_rows, 128, i8 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  const int smem = 1024 + ((box_rows * 128 * elem + 1023) & ~1023) + 8;
  const cudaError_t e = cudaFuncSetAttribute(check_tma_2d_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  check_tma_2d_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      tm, static_cast<unsigned char*>(out), elem, box_rows, 128, c0, r0, i8 ? 1 : 0);
  return (int)cudaGetLastError();
}

// a [64, 128] bf16, b [n, 128] bf16, c [64, n] f32; n in {24, 32, 48, 64,
// 128} (24 and 48: the decode layer's batch columns)
PTT_EXPORT int ptt_check_ss(const void* a, const void* b, void* c, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 24) return run_ss<24>(a, b, c, s);
  if (n == 48) return run_ss<48>(a, b, c, s);
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

// a [64 k, 64 m] bf16, b [64 k, n] bf16, c [64 m, n] f32 = a^T b; n in {64, 128}
PTT_EXPORT int ptt_check_ss_t(const void* a, const void* b, void* c, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 64) return run_ss_t<64>(a, b, c, s);
  if (n == 128) return run_ss_t<128>(a, b, c, s);
  return (int)cudaErrorInvalidValue;
}

// a [64, 256] int8, b [256, 256] int8, c [64, 256] int32 = a b^T
PTT_EXPORT int ptt_check_s8(const void* a, const void* b, void* c, void* stream) {
  CUtensorMap ta, tb;
  int err = hp::encode_2d_map(&ta, a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 64, kS8K, 64, 128,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = hp::encode_2d_map(&tb, b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 256, kS8K, 256, 128,
                            CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  const int smem = 1024 + (64 + 256) * kS8K + 8;
  const cudaError_t e =
      cudaFuncSetAttribute(check_s8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  check_s8_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(ta, tb,
                                                                      static_cast<int*>(c));
  return (int)cudaGetLastError();
}
