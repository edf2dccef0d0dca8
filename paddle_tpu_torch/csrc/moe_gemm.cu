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
// Design: a TMA and wgmma kernel built from csrc/hopper.cuh. A block is one
// work item: (expert, 128-column output tile, group of 128 capacity rows);
// the grid (N / 128, C / 128, E) runs an expert's column tiles next to each
// other, so its x rows and, for the later row groups of a full expert, its
// weight tiles come from L2. At Qwen's counts (65 live rows a live expert on
// average at capacity 274) nearly every expert is one group, so each weight
// box crosses from device memory once and feeds every live row of its
// expert. 288 threads: two consumer warpgroups, one a 64-row tile of the
// group (with one live tile both multiply it), then one producer warp whose
// one thread keeps a 3-stage ring in flight; a stage is k 64 deep: the live 64-row x tiles ([64 rows, 64 k]
// boxes of a 3-D map over [E, C, K], so no box reads the next expert's
// rows) and the weight's [128 n, 64 k] box (w_nk = 1: K-major, as x) or its
// two [64 k, 64 n] boxes (w_nk = 0: MN-major, the wgmma's transpose bit
// set), all with the 128-byte swizzle, signalled by a `full` mbarrier
// (transaction bytes) and released by an `empty` one. Each consumer
// warpgroup runs four wgmma m64n128k16 a stage with both operands in shared
// memory, one group in flight. Each block reads counts[e] itself (nothing
// waits on the host): a group wholly past the count writes its zeros and
// returns without loading anything (an empty expert reads no weight); a
// group loads only its live 64-row tiles, and rows past the count inside a
// live tile are written as zeros by the epilogue, whatever x held there.
// Two blocks an SM (99,376 B of shared memory each): four to six stages,
// 96-192 KB, in flight an SM.
#include "hopper.cuh"

using ptt::bf16;
namespace hp = ptt::hopper;

namespace {

constexpr int kBM = 128;      // capacity rows a block: two consumer warpgroups of 64
constexpr int kBN = 128;      // output columns a block: the wgmma's N
constexpr int kBK = 64;       // k a ring stage: one 128-byte swizzled row of bf16
constexpr int kStages = 3;    // ring stages
constexpr int kThreads = 288; // two consumer warpgroups, then one producer warp
constexpr int kXBytes = 64 * kBK * 2;                  // one 64-row x box
constexpr int kWBytes = kBN * kBK * 2;                 // the weight's boxes
constexpr int kStageBytes = 2 * kXBytes + kWBytes;
constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;

// Block (blockIdx.x, blockIdx.y, blockIdx.z) = (column tile, row group,
// expert), as the header says. tx: x [E, C, K], box [64 k, 64 rows]; tw: w
// [E, N, K] box [64 k, 128 n] (NK) or [E, K, N] box [64 n, 64 k].
template <bool NK>
__global__ void __launch_bounds__(kThreads, 2)
    moe_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                     const int* __restrict__ counts, bf16* __restrict__ out, int C, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (hp::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int n0 = blockIdx.x * kBN, c0 = blockIdx.y * kBM, e = blockIdx.z;
  const int count = min(max(__ldg(counts + e), 0), C);
  bf16* o = out + (size_t)e * C * N;
  const int tid = threadIdx.x;

  if (c0 >= count) {
    // the whole group lies past the count: zeros, nothing loaded
    const int rows = min(kBM, C - c0);
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < rows * (kBN / 8); i += kThreads) {
      const int r = i / (kBN / 8), cc = n0 + (i % (kBN / 8)) * 8;
      if (cc < N) *reinterpret_cast<uint4*>(o + (size_t)(c0 + r) * N + cc) = zero;
    }
    return;
  }
  const int tiles = count - c0 > 64 ? 2 : 1;  // 64-row tiles with a live row
  const int n_kt = (K + kBK - 1) / kBK;
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
      hp::prefetch_tensormap(&tx);
      hp::prefetch_tensormap(&tw);
      // an MN-major weight's second box lies wholly past N at a narrow last
      // tile: it is not loaded (its columns are never stored)
      const bool second = NK || n0 + 64 < N;
      const uint32_t bytes = tiles * kXBytes + (second ? kWBytes : kWBytes / 2);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        if (kt >= kStages) hp::mbar_wait(&empty[st], ((kt / kStages) - 1) & 1);
        unsigned char* s = smem + st * kStageBytes;
        hp::mbar_arrive_expect_tx(&full[st], bytes);
        for (int t = 0; t < tiles; ++t)
          hp::tma_load_3d(s + t * kXBytes, &tx, &full[st], kt * kBK, c0 + 64 * t, e);
        unsigned char* ws = s + 2 * kXBytes;
        if constexpr (NK) {
          hp::tma_load_3d(ws, &tw, &full[st], kt * kBK, n0, e);
        } else {
          hp::tma_load_3d(ws, &tw, &full[st], n0, kt * kBK, e);
          if (second) hp::tma_load_3d(ws + kWBytes / 2, &tw, &full[st], n0 + 64, kt * kBK, e);
        }
      }
    }
    return;
  }

  // consumer warpgroup cw owns rows c0 + 64 cw .. c0 + 64 cw + 63; with one
  // live tile both warpgroups multiply it (the second's products are
  // dropped), so no wgmma sits on a divergent path
  const int cw = tid >> 7, warp = tid >> 5, lane = tid & 31;
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages;
    hp::mbar_wait(&full[st], (kt / kStages) & 1);
    const uint32_t xa = hp::smem_u32(smem + st * kStageBytes + min(cw, tiles - 1) * kXBytes);
    const uint32_t wa = hp::smem_u32(smem + st * kStageBytes + 2 * kXBytes);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if constexpr (NK)
        hp::Wgmma<kBN>::template ss<0>(acc, hp::desc_kmajor(xa + kk * 32),
                                       hp::desc_kmajor(wa + kk * 32), 1);
      else
        hp::Wgmma<kBN>::template ss<1>(acc, hp::desc_kmajor(xa + kk * 32),
                                       hp::desc_mnmajor(wa + kk * 2048, kWBytes / 2), 1);
    }
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

  // accumulator element i of a thread is row 16 (warp % 4) + lane / 4 +
  // 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2 of its m64
  // tile; rows at or past the count (all of a dead tile's) are zeros
  const int r0 = c0 + 64 * cw + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
  for (int c = 0; c < kBN / 8; ++c) {
    const int col = n0 + 8 * c + 2 * (lane & 3);  // even; N % 8 == 0 keeps col + 1 < N
    if (col >= N) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + 8 * hf;
      if (r >= C) continue;
      const bool keep = r < count;
      const int i = 4 * c + 2 * hf;
      *reinterpret_cast<__nv_bfloat162*>(o + (size_t)r * N + col) =
          __floats2bfloat162_rn(keep ? acc[i] : 0.f, keep ? acc[i + 1] : 0.f);
    }
  }
}

template <bool NK>
int launch(const void* x, const void* w, const int* counts, bf16* out, int E, int C, int K, int N,
           cudaStream_t s) {
  CUtensorMap tx, tw;
  int err = hp::make_3d_map(&tx, x, E, C, K, 1, 64, kBK);
  if (err == 0)
    err = NK ? hp::make_3d_map(&tw, w, E, N, K, 1, kBN, kBK)
             : hp::make_3d_map(&tw, w, E, K, N, 1, kBK, 64);
  if (err != 0) return err;
  const cudaError_t attr = hp::allow_smem<moe_wgmma_kernel<NK>>(kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((N + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  moe_wgmma_kernel<NK><<<grid, kThreads, kSmem, s>>>(tx, tw, counts, out, C, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [E, C, K] bf16; w: [E, K, N] (w_nk = 0) or [E, N, K] (w_nk = 1) bf16;
// counts: [E] int32; out: [E, C, N] bf16. K % 8 == 0, N % 8 == 0, every
// pointer 16-byte aligned (the wrapper checks).
PTT_EXPORT int ptt_moe_gemm(const void* x, const void* w, const void* counts, void* out, int E,
                            int C, int K, int N, int w_nk, void* stream) {
  if (E == 0 || C == 0 || N == 0) return 0;
  if (K % 8 || N % 8 || C > 65535 * kBM || E > 65535) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* cp = static_cast<const int*>(counts);
  auto* op = static_cast<bf16*>(out);
  if (K == 0) return (int)cudaMemsetAsync(out, 0, (size_t)E * C * N * sizeof(bf16), s);
  return w_nk ? launch<true>(x, w, cp, op, E, C, K, N, s)
              : launch<false>(x, w, cp, op, E, C, K, N, s);
}
