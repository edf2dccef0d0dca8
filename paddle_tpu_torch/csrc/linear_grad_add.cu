// Linear weight-gradient accumulation, bf16 operands on the tensor cores
// with f32 sums, the accumulator updated in place:
//   acc[K, N] += x[M, K]^T @ dy[M, N]
//
// Replaces paddle_tpu/ops/kernels/linear_grad_add_pallas.py `_grad_acc`
// (kernel body `_kernel`): the products of bf16 values are exact in f32 and
// summed in f32; the accumulator (f32 `main_grad`, or bf16) is read once,
// added in f32 and written once in its own type. The TPU kernel keeps its
// [256, 256] f32 tile in VMEM scratch across its sequential M grid axis;
// here the M sweep is a loop inside a block, and where the output tiles
// alone would leave the card idle, M is split over the blocks of a cluster.
//
// Bound on the H100: operations at GPT-2's and Llama's widths (2 M K N on
// the bf16 tensor cores: 38.65 GFLOP for x [8192, 768], dy [8192, 3072],
// 0.039 ms at 989 TFLOP/s). Design (csrc/hopper.cuh):
//
// - A block owns a 256 (K) x 128 (N) output tile: 288 threads, two consumer
//   warpgroups of 128 output rows each, then one producer warp. One
//   producer thread keeps TMA loads in flight into a ring of four stages of
//   64 tokens, each signalled by a `full` mbarrier (transaction bytes) and
//   released by an `empty` one: x's [64 tokens, 256 k] tile and dy's [64
//   tokens, 128 n] tile, both as 64-column boxes with the 128-byte swizzle.
//   The reduction (tokens) is the row dimension of both, so A = x^T and B =
//   dy are both MN-major: wgmma m64n128k16 with both transpose bits set,
//   two m64 tiles a warpgroup, f32 accumulators in registers over the
//   block's token range, one group of products in flight.
// - The grid is (split, K tiles, N tiles), K tiles fastest, so that the
//   blocks in flight share dy's columns and the whole of x stays in L2 at
//   Llama's widths. The `split` blocks of one output tile form a cluster
//   and take consecutive ranges of 64-token steps. The split (1, 2, 4 or
//   8) is the one whose waves of blocks times the steps a block takes,
//   plus a fixed cost of 18 steps a block, are fewest (`grad_split`). The
//   fixed cost is measured: a step takes 0.7-0.8 us, and a block spends
//   11-12 us more on its first stage's arrival, the partial tile, the
//   cluster's meetings and the accumulator's read and write (PERF.md, row
//   21). The incubate path's products at M 4096 take 2 (qkv), 4 (out) and
//   1 (fc, proj), GPT-2's mlp.fc at M 8192 and Llama's gate 1.
// - After the sweep every block stages its f32 partial tile in shared
//   memory (the ring is free by then), the cluster meets, and block r adds
//   the blocks' partials for rows r (256 / split) .. of the tile through
//   distributed shared memory in rank order, then the accumulator (its
//   rows brought into L2 by the producer warp kPrefetchSteps before the
//   sweep ends), and writes those rows once as 16-byte row pieces. An
//   unsplit tile into an f32 accumulator skips all that: it is staged as
//   four 128-byte-swizzled boxes and added into acc by TMA
//   (cp.reduce.async.bulk .add: the L2 reads, adds and writes acc, one f32
//   add an element, as the epilogue would), so no block waits on acc's
//   read. Every element of acc has exactly one contributor: one add by
//   its block's epilogue, or one reduce-add in L2 for an unsplit f32 tile;
//   the partials of a split are summed in rank order before it. So two
//   calls return the same bits.
// - Edges: boxes past M, K or N arrive as zeros (boxes wholly past K or N
//   are not loaded: they feed only rows and columns that are never
//   written); the epilogue masks rows past K and columns past N.
// K % 8 == 0 and N % 8 == 0 (16-byte row strides for the tensor maps);
// M is any size.
#include <algorithm>

#include "hopper.cuh"

using ptt::bf16;
namespace hp = ptt::hopper;

namespace {

constexpr int kTK = 256;           // output rows (x's columns) a block
constexpr int kTN = 128;           // output columns (dy's columns) a block
constexpr int kTM = 64;            // tokens a ring stage
constexpr int kThreads = 288;      // two consumer warpgroups, then one producer warp
constexpr int kStages = 4;         // ring stages
constexpr int kSplit = 8;          // blocks a cluster at most (the portable cluster size)
constexpr int kSms = 132;          // the H100's multiprocessors
constexpr int kFixedSteps = 18;    // a block's fixed cost (fill, epilogue), in 64-token steps
constexpr int kPrefetchSteps = 8;  // steps before the sweep's end that acc's strip enters L2
constexpr int kBatch = 8;          // accumulator pieces a thread loads at once in the epilogue
constexpr int kSub = kTM * 128;    // bytes of one 64-column sub-tile of a stage
constexpr int kStageBytes = (kTK / 64 + kTN / 64) * kSub;  // x's four sub-tiles, dy's two
constexpr int kPartRow = kTN + 8;  // f32 stride of the partial tile: conflict-free float2 writes
constexpr int kAccBox = kTK * 128;  // bytes of one [256 rows, 32 f32 columns] box of acc
constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
static_assert(kTK * kPartRow * 4 <= kStages * kStageBytes, "the partial tile fits in the ring");
static_assert(kTN / 32 * kAccBox <= kStages * kStageBytes, "so do the four boxes of acc");

__host__ __device__ constexpr int cdiv(int a, int b) { return a / b + (a % b != 0); }

__device__ __forceinline__ float4 acc_load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 acc_load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void acc_store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void acc_store4(bf16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename A>
__global__ void __launch_bounds__(kThreads, 1)
    grad_acc_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
                    const __grid_constant__ CUtensorMap tacc, A* __restrict__ acc, int M, int K,
                    int N, int msteps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (hp::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int split = gridDim.x;  // the cluster: the token ranges of one output tile
  const int rank = (int)hp::cluster_rank();
  // an unsplit tile into an f32 accumulator is added into acc by TMA (the
  // L2 reads, adds and writes acc: one f32 add of the tile's sum, as the
  // epilogue below does); a bf16 accumulator would round the sum first
  const bool direct = sizeof(A) == 4 && split == 1;
  const int k0 = blockIdx.y * kTK, n0 = blockIdx.z * kTN;
  const int sbeg = blockIdx.x * msteps;
  const int n_it = max(0, min(cdiv(M, kTM), sbeg + msteps) - sbeg);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  const int R = kTK / split;  // rows of the tile this block finishes: rank R ..
  if (tid >= 256) {
    // producer warp: lane 0 issues every copy (boxes wholly past K or N are
    // left out, and out of the transaction count); kPrefetchSteps before the
    // sweep ends, the warp brings this block's rows of acc into L2, so that
    // the epilogue's reads of them do not wait on device memory
    const int lane = tid & 31;
    const int xboxes = min(kTK / 64, cdiv(K - k0, 64));
    const int dboxes = min(kTN / 64, cdiv(N - n0, 64));
    const uint32_t bytes = (xboxes + dboxes) * kSub;
    const int prow = k0 + rank * R, prows = max(0, min(R, K - prow));
    auto prefetch = [&]() {
      for (int r = lane; r < prows; r += 32)
        hp::prefetch_l2(acc + (size_t)(prow + r) * N + n0, min(kTN, N - n0) * (int)sizeof(A));
    };
    if (lane == 0) {
      hp::prefetch_tensormap(&tx);
      hp::prefetch_tensormap(&tdy);
      if (direct) hp::prefetch_tensormap(&tacc);
    }
    const int pf = max(0, n_it - kPrefetchSteps);
    if (n_it == 0) prefetch();
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      // every lane waits, so that the prefetch comes at step pf
      if (it >= kStages) hp::mbar_wait(&empty[st], ((it / kStages) - 1) & 1);
      if (it == pf) prefetch();
      if (lane != 0) continue;
      unsigned char* s = smem + st * kStageBytes;
      const int m0 = (sbeg + it) * kTM;
      hp::mbar_arrive_expect_tx(&full[st], bytes);
      for (int j = 0; j < xboxes; ++j) hp::tma_load_2d(s + j * kSub, &tx, &full[st], k0 + 64 * j, m0);
      for (int j = 0; j < dboxes; ++j)
        hp::tma_load_2d(s + (kTK / 64 + j) * kSub, &tdy, &full[st], n0 + 64 * j, m0);
    }
    __syncwarp();
  } else {
    // consumer warpgroup cw: output rows 128 cw .. 128 cw + 127 of the tile,
    // x's sub-tiles 2 cw and 2 cw + 1 (A, MN-major: 64 rows of the output in
    // one 128-byte row of a token)
    const int cw = tid >> 7, warp = tid >> 5, lane = tid & 31;
    float c[2][64];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 64; ++e) c[i][e] = 0.f;

    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      hp::mbar_wait(&full[st], (it / kStages) & 1);
      __syncwarp();  // the lanes leave the wait apart; wgmma needs them together
      const uint32_t xa = hp::smem_u32(smem + st * kStageBytes) + 2 * cw * kSub;
      const uint32_t da = hp::smem_u32(smem + st * kStageBytes) + (kTK / 64) * kSub;
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTM / 16; ++kk) {
        const uint64_t db = hp::desc_mnmajor(da + kk * 2048, kSub);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          hp::Wgmma<kTN>::template ss<1, 1>(c[i], hp::desc_mnmajor(xa + i * kSub + kk * 2048, kSub),
                                            db, 1);
      }
      hp::wgmma_commit();
      if (it > 0) {
        // step it - 1's products are done: its stage goes back to the producer
#pragma unroll
        for (int i = 0; i < 2; ++i) hp::fence_acc<64>(c[i]);
        hp::wgmma_wait<1>();
#pragma unroll
        for (int i = 0; i < 2; ++i) hp::fence_acc<64>(c[i]);
        __syncwarp();
        if (lane == 0) hp::mbar_arrive(&empty[(it - 1) % kStages]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) hp::fence_acc<64>(c[i]);
    hp::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 2; ++i) hp::fence_acc<64>(c[i]);

    // the partial tile [256][kPartRow] f32 over the ring, once both
    // warpgroups' products are done: element e of m64 tile i is row
    // 128 cw + 64 i + 16 (warp % 4) + lane / 4 + 8 ((e / 2) % 2), column
    // 8 (e / 4) + 2 (lane % 4) + e % 2
    hp::bar_sync(1, 256);
    const int r0 = 128 * cw + 16 * (warp & 3) + (lane >> 2);
    if (direct) {
      // four [256 rows, 32 columns] boxes with the 128-byte swizzle (16-byte
      // chunk q of row r at q ^ (r % 8)), added into acc by TMA; rows past K
      // and columns past N are dropped by the map
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 64; e += 2) {
          const int row = r0 + 64 * i + 8 * ((e >> 1) & 1);
          const int col = 8 * (e >> 2) + 2 * (lane & 3);
          *reinterpret_cast<float2*>(smem + (col >> 5) * kAccBox + row * 128 +
                                     ((((col & 31) >> 2) ^ (row & 7)) << 4) + (col & 3) * 4) =
              make_float2(c[i][e], c[i][e + 1]);
        }
      hp::fence_proxy_async();
      hp::bar_sync(1, 256);
      if (tid == 0) {
        for (int b = 0; b < kTN / 32 && n0 + 32 * b < N; ++b)
          hp::tma_reduce_add_2d(&tacc, smem + b * kAccBox, n0 + 32 * b, k0);
        hp::bulk_commit();
        hp::bulk_wait_read<0>();  // the block's shared memory stays until it is read
      }
    } else {
      float* part = reinterpret_cast<float*>(smem);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 64; e += 2) {
          const int row = r0 + 64 * i + 8 * ((e >> 1) & 1);
          const int col = 8 * (e >> 2) + 2 * (lane & 3);
          *reinterpret_cast<float2*>(part + row * kPartRow + col) =
              make_float2(c[i][e], c[i][e + 1]);
        }
    }
  }
  if (direct) return;
  hp::cluster_sync();  // every block's partial tile is written

  // block `rank` finishes rows rank * R .. rank * R + R - 1 of the tile,
  // adding the blocks' partials in rank order, then the accumulator. A
  // thread takes kBatch 16-byte pieces at a time and loads their
  // accumulator values first, so that those loads are in flight together;
  // the blocks' partials of one piece are loaded together too.
  const uint32_t part_addr = hp::smem_u32(smem);
  const float* part = reinterpret_cast<const float*>(smem);
  const int total = R * (kTN / 4);
  // piece e of this block's rows: row rank R + e / 32 of the tile, columns
  // 4 (e % 32) ..
  auto piece_ok = [&](int e) {
    return e < total && k0 + rank * R + e / (kTN / 4) < K && n0 + 4 * (e % (kTN / 4)) < N;
  };
  auto piece = [&](int e) {
    return acc + (size_t)(k0 + rank * R + e / (kTN / 4)) * N + n0 + 4 * (e % (kTN / 4));
  };
  for (int base = tid; base < total; base += kBatch * kThreads) {
    float4 a[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (piece_ok(base + u * kThreads)) a[u] = acc_load4(piece(base + u * kThreads));
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * kThreads;
      if (!piece_ok(e)) continue;
      const int off = (rank * R + e / (kTN / 4)) * kPartRow + 4 * (e % (kTN / 4));
      float4 v;
      if (split == 1) {
        v = *reinterpret_cast<const float4*>(part + off);
      } else {
        float4 o[kSplit];
#pragma unroll
        for (int q = 0; q < kSplit; ++q)
          if (q < split) o[q] = hp::ld_cluster_f4(hp::map_rank(part_addr + off * 4, q));
        v = o[0];
#pragma unroll
        for (int q = 1; q < kSplit; ++q)
          if (q < split) {
            v.x += o[q].x;
            v.y += o[q].y;
            v.z += o[q].z;
            v.w += o[q].w;
          }
      }
      v.x = a[u].x + v.x;
      v.y = a[u].y + v.y;
      v.z = a[u].z + v.z;
      v.w = a[u].w + v.w;
      acc_store4(piece(e), v);
    }
  }
  hp::cluster_sync();  // no block leaves while another reads its partials
}

// The cluster split of the token sweep (paddle_tpu_torch/ops/kernels/
// linear_grad_add.py declares the same plan for the kernel analyzer): the
// fewest waves of blocks times the steps a block takes plus its fixed cost;
// the smaller split on a tie.
inline int grad_split(int M, int K, int N) {
  const long long tiles = (long long)cdiv(K, kTK) * cdiv(N, kTN);
  const int steps = cdiv(M, kTM);
  int best = 1;
  long long best_cost = -1;
  for (int s = 1; s <= kSplit; s *= 2) {
    const long long cost = (tiles * s + kSms - 1) / kSms * (cdiv(steps, s) + kFixedSteps);
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

template <typename A>
int launch(const void* x, const void* dy, void* acc, int M, int K, int N, int split,
           cudaStream_t stream) {
  CUtensorMap tx, tdy, tacc;
  int err = hp::make_2d_map(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, kTM, 64,
                            CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = hp::make_2d_map(&tdy, dy, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, N, kTM, 64,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  tacc = tx;  // not read unless the kernel adds an unsplit f32 tile by TMA
  if (err == 0 && sizeof(A) == 4 && split == 1)
    err = hp::make_2d_map(&tacc, acc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K, N, kTK, 32,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  const cudaError_t attr = hp::allow_smem<grad_acc_kernel<A>>(kSmem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, cdiv(K, kTK), cdiv(N, kTN));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const int msteps = cdiv(cdiv(M, kTM), split);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, grad_acc_kernel<A>, tx, tdy, tacc,
                                           static_cast<A*>(acc), M, K, N, msteps);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// x: [M, K] bf16; dy: [M, N] bf16; acc: [K, N], f32 (acc_f32) or bf16,
// updated in place. All contiguous, 16-byte aligned; K % 8 == 0,
// N % 8 == 0; M any size (M == 0 leaves acc as it is).
PTT_EXPORT int ptt_linear_grad_add(const void* x, const void* dy, void* acc, int M, int K, int N,
                                   int acc_f32, void* stream) {
  if (K == 0 || N == 0 || M == 0) return 0;
  const int split = grad_split(M, K, N);
  const auto s = static_cast<cudaStream_t>(stream);
  return acc_f32 ? launch<float>(x, dy, acc, M, K, N, split, s)
                 : launch<bf16>(x, dy, acc, M, K, N, split, s);
}
