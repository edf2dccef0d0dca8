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
// column block; here a first pass writes s [M] f32 and q [M, K] int8 (4 MB
// at M 1024, K 4096): a 128-thread block a row, the row read once into
// registers (K <= 8192; a longer row reads its tail vectors again), 8-byte
// stores of q.
// The second pass, a8w8_wgmma_kernel, is a TMA and wgmma kernel built from
// csrc/hopper.cuh: a 128 x 256 output tile a block, 288 threads (two
// consumer warpgroups of 64 rows, then one producer warp). One producer
// thread keeps a ring of four stages in flight, each q's [128, 128 k] box
// and the weight's [256, 128 k] box, both K-major with the 128-byte
// swizzle, signalled by a `full` mbarrier (transaction bytes) and released
// by an `empty` one. Each consumer warpgroup runs four wgmma m64n256k32
// s8.s8 -> s32 a stage with both operands in shared memory (8-bit operands
// have no transpose bits, so both must be K-major: the "nk" weight and q
// are), one group in flight. Rows past M and k past K arrive as zeros. The
// f32 epilogue applies s[m], then ws[n], as above, stages the bf16 tile in
// the freed ring and stores 16-byte row pieces. 128 x 256 tiles make 448
// blocks at [1024, 14336] (3.39 waves on 132 SMs) and read each k-step's
// 48 KB from L2 for 8.4 M products; 128 x 128 would make 6.79 waves but
// read a third more from L2 for the same products. A "kn" weight [K, N]
// (no path of the port passes one) is first transposed into a K-major copy
// [N, K] in caller-given scratch by a8w8_transpose_kernel, then takes the
// same product.
#include "hopper.cuh"

using ptt::bf16;
namespace hp = ptt::hopper;

namespace {

// row quantization
constexpr int kQuantThreads = 128;  // threads a row (a block)
constexpr int kQuantVecs = 8;       // 16-byte vectors of x a thread keeps: K <= 8192 read once
// the product
constexpr int kBM = 128;        // output rows a block: two consumer warpgroups of 64
constexpr int kBN = 256;        // output columns a block: the wgmma's N
constexpr int kBK = 128;        // k (bytes) a ring stage: one 128-byte swizzled row
constexpr int kThreads = 288;   // two consumer warpgroups, then one producer warp
constexpr int kStages = 4;      // ring stages
constexpr int kStageBytes = (kBM + kBN) * kBK;
constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
constexpr int kOutRow = kBN + 8;  // bf16 stride of the output tile staged in shared memory
// the "kn" transpose
constexpr int kTile = 64;       // a block transposes a 64 x 64 byte tile

__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float absmax8(const uint4& raw, float mx) {
  float v[8];
  unpack8(raw, v);
#pragma unroll
  for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fabsf(v[j]));
  return mx;
}

// 8 values -> 8 int8 bytes: clip(rint(v / sc), -127, 127)
__device__ __forceinline__ uint2 quant8(const uint4& raw, float sc) {
  float v[8];
  unpack8(raw, v);
  uint32_t lo = 0u, hi = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(v[j], sc)), -127.f), 127.f);
    const uint32_t b = (uint32_t)(uint8_t)(int8_t)(int)r;
    if (j < 4) lo |= b << (8 * j);
    else hi |= b << (8 * (j - 4));
  }
  return make_uint2(lo, hi);
}

// A block a row: s[row] and q[row, :]. Each thread keeps its vectors of the
// row (up to kQuantVecs, K <= 8192) in registers between the max and the
// quantisation; a longer row reads the rest again.
__global__ void __launch_bounds__(kQuantThreads)
    a8w8_quantize_kernel(const bf16* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ s, int K) {
  __shared__ float red[kQuantThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t row = blockIdx.x;
  const bf16* xr = x + row * K;
  const int vecs = K / 8;
  uint4 v[kQuantVecs];
  float mx = 0.f;
#pragma unroll
  for (int i = 0; i < kQuantVecs; ++i) {
    const int j = i * kQuantThreads + tid;
    if (j < vecs) {
      v[i] = *reinterpret_cast<const uint4*>(xr + 8 * j);
      mx = absmax8(v[i], mx);
    }
  }
  for (int j = kQuantVecs * kQuantThreads + tid; j < vecs; j += kQuantThreads)
    mx = absmax8(*reinterpret_cast<const uint4*>(xr + 8 * j), mx);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) red[tid >> 5] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kQuantThreads / 32; ++w) mx = fmaxf(mx, red[w]);
  const float sc = __fdiv_rn(fmaxf(mx, 1e-6f), 127.0f);
  if (tid == 0) s[row] = sc;
  int8_t* qr = q + row * K;
#pragma unroll
  for (int i = 0; i < kQuantVecs; ++i) {
    const int j = i * kQuantThreads + tid;
    if (j < vecs) *reinterpret_cast<uint2*>(qr + 8 * j) = quant8(v[i], sc);
  }
  for (int j = kQuantVecs * kQuantThreads + tid; j < vecs; j += kQuantThreads)
    *reinterpret_cast<uint2*>(qr + 8 * j) = quant8(*reinterpret_cast<const uint4*>(xr + 8 * j), sc);
}

// w [K, N] -> wt [N, K], a 64 x 64 byte tile a block through shared memory
// (words of 4 n bytes, rows padded to 17 words). K % 16 == 0, N % 16 == 0.
__global__ void __launch_bounds__(256)
    a8w8_transpose_kernel(const int8_t* __restrict__ w, int8_t* __restrict__ wt, int K, int N) {
  __shared__ uint32_t t[kTile][kTile / 4 + 1];
  const int k0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile, tid = threadIdx.x;
  {
    const int r = tid >> 2, c = (tid & 3) * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + r < K && n0 + c < N)
      v = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * N + n0 + c);
    t[r][c / 4] = v.x;
    t[r][c / 4 + 1] = v.y;
    t[r][c / 4 + 2] = v.z;
    t[r][c / 4 + 3] = v.w;
  }
  __syncthreads();
  const int n = tid >> 2, kc = (tid & 3) * 16;
  if (n0 + n >= N || k0 + kc >= K) return;
  const int sh = 8 * (n & 3);
  uint32_t o[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    uint32_t word = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) word |= ((t[kc + 4 * u + b][n >> 2] >> sh) & 0xFFu) << (8 * b);
    o[u] = word;
  }
  *reinterpret_cast<uint4*>(wt + (size_t)(n0 + n) * K + k0 + kc) = make_uint4(o[0], o[1], o[2], o[3]);
}

// The product: y tile (blockIdx.x, blockIdx.y) of kBM x kBN, as the header
// says. tq: q [M, K] int8, box [kBM, kBK]; tw: the K-major weight [N, K],
// box [kBN, kBK]; both 128-byte swizzled.
__global__ void __launch_bounds__(kThreads, 1)
    a8w8_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tw,
                      const float* __restrict__ srow, const float* __restrict__ ws,
                      bf16* __restrict__ y, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (hp::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int n_kt = (K + kBK - 1) / kBK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {
    // producer warp: one thread issues every copy
    if (tid == 256) {
      hp::prefetch_tensormap(&tq);
      hp::prefetch_tensormap(&tw);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        if (kt >= kStages) hp::mbar_wait(&empty[st], ((kt / kStages) - 1) & 1);
        unsigned char* s = smem + st * kStageBytes;
        hp::mbar_arrive_expect_tx(&full[st], kStageBytes);
        hp::tma_load_2d(s, &tq, &full[st], kt * kBK, m0);
        hp::tma_load_2d(s + kBM * kBK, &tw, &full[st], kt * kBK, n0);
      }
    }
    return;
  }

  // consumer warpgroup cw owns rows 64 cw .. 64 cw + 63 of the tile
  const int cw = tid >> 7, warp = tid >> 5, lane = tid & 31;
  int acc[kBN / 2];
#pragma unroll
  for (int e = 0; e < kBN / 2; ++e) acc[e] = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages;
    hp::mbar_wait(&full[st], (kt / kStages) & 1);
    const uint32_t qa = hp::smem_u32(smem + st * kStageBytes) + cw * 64 * kBK;
    const uint32_t wa = hp::smem_u32(smem + st * kStageBytes + kBM * kBK);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      hp::WgmmaS8<kBN>::ss(acc, hp::desc_kmajor(qa + kk * 32), hp::desc_kmajor(wa + kk * 32), 1);
    hp::wgmma_commit();
    if (kt > 0) {
      // k-tile kt - 1's products are done: its stage goes back to the producer
      hp::fence_acc<kBN / 2>(acc);
      hp::wgmma_wait<1>();
      hp::fence_acc<kBN / 2>(acc);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty[(kt - 1) % kStages]);
    }
  }
  hp::fence_acc<kBN / 2>(acc);
  hp::wgmma_wait<0>();
  hp::fence_acc<kBN / 2>(acc);

  // The tile goes out through shared memory (the ring is free once both
  // warpgroups' products are done): accumulator element e of a thread is
  // row 16 (warp % 4) + lane / 4 + 8 ((e / 2) % 2), column 8 (e / 4) +
  // 2 (lane % 4) + e % 2 of its m64 tile, written as bf16 pairs into rows
  // kOutRow apart (conflict-free), then read back as 16-byte row pieces.
  hp::bar_sync(1, 256);
  bf16* out = reinterpret_cast<bf16*>(smem);
  const int r0 = cw * 64 + 16 * (warp & 3) + (lane >> 2);
  float sr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) sr[hf] = m0 + r0 + 8 * hf < M ? srow[m0 + r0 + 8 * hf] : 0.f;
#pragma unroll
  for (int c = 0; c < kBN / 8; ++c) {
    const int col = 8 * c + 2 * (lane & 3);
    const float w0 = n0 + col < N ? ws[n0 + col] : 0.f;
    const float w1 = n0 + col + 1 < N ? ws[n0 + col + 1] : 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int e = 4 * c + 2 * hf;
      const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[e]), sr[hf]), w0);
      const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[e + 1]), sr[hf]), w1);
      *reinterpret_cast<__nv_bfloat162*>(out + (r0 + 8 * hf) * kOutRow + col) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  hp::bar_sync(1, 256);
  if (N % 8 == 0) {
    for (int e = tid; e < kBM * (kBN / 8); e += 256) {
      const int r = e / (kBN / 8), c = 8 * (e % (kBN / 8));
      if (m0 + r < M && n0 + c < N)
        *reinterpret_cast<uint4*>(y + (size_t)(m0 + r) * N + n0 + c) =
            *reinterpret_cast<const uint4*>(out + r * kOutRow + c);
    }
  } else {
    for (int e = tid; e < kBM * kBN; e += 256) {
      const int r = e / kBN, c = e % kBN;
      if (m0 + r < M && n0 + c < N) y[(size_t)(m0 + r) * N + n0 + c] = out[r * kOutRow + c];
    }
  }
}

}  // namespace

// x: [M, K] bf16 -> q: [M, K] int8, s: [M] f32. K % 8 == 0.
PTT_EXPORT int ptt_a8w8_quantize(const void* x, void* q, void* s, int M, int K, void* stream) {
  if (M == 0) return 0;
  a8w8_quantize_kernel<<<M, kQuantThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<int8_t*>(q), static_cast<float*>(s), K);
  return (int)cudaGetLastError();
}

// q: [M, K] int8; s: [M] f32; w: [N, K] (nk != 0) or [K, N] int8; ws: [N]
// f32; y: [M, N] bf16; wt: [N, K] int8 scratch for "kn" (null for "nk").
// K % 16 == 0, and N % 16 == 0 for "kn"; every pointer 16-byte aligned.
PTT_EXPORT int ptt_a8w8_gemm(const void* q, const void* s, const void* w, const void* ws, void* y,
                             int M, int N, int K, int nk, void* wt, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == 0) return (int)cudaMemsetAsync(y, 0, (size_t)M * N * sizeof(bf16), st);
  const void* wk = w;
  if (!nk) {
    if (wt == nullptr) return (int)cudaErrorInvalidValue;
    a8w8_transpose_kernel<<<dim3((N + kTile - 1) / kTile, (K + kTile - 1) / kTile), 256, 0, st>>>(
        static_cast<const int8_t*>(w), static_cast<int8_t*>(wt), K, N);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    wk = wt;
  }
  CUtensorMap tq, tw;
  int err = hp::make_2d_map(&tq, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K, kBM, kBK,
                            CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = hp::make_2d_map(&tw, wk, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K, kBN, kBK,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  const cudaError_t attr = hp::allow_smem<a8w8_wgmma_kernel>(kSmem);
  if (attr != cudaSuccess) return (int)attr;
  a8w8_wgmma_kernel<<<dim3((M + kBM - 1) / kBM, (N + kBN - 1) / kBN), kThreads, kSmem, st>>>(
      tq, tw, static_cast<const float*>(s), static_cast<const float*>(ws), static_cast<bf16*>(y), M,
      N, K);
  return (int)cudaGetLastError();
}
