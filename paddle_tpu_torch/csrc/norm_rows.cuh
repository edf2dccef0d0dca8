// The row machinery of the two forward kernels that add into a residual row
// and normalise it: RMSNorm (csrc/rms_norm.cu `rms_norm_kernel`) and the
// block epilogue (csrc/block_epilogue.cu `block_epilogue_kernel`); and, at
// the end, what the two backward kernels share (`rms_norm_bwd_kernel` and
// `block_epilogue_bwd_rows_kernel`): a group's sums behind its named barrier
// and the fixed-order sum of the blocks' partial rows.
//
// A row belongs to one block, and thread t of it holds the row's 8-element
// vector t in registers (kRow), so a row is at most 8 * 1024 wide. Every load
// of a row, its operands and the weight vectors, is issued before its first
// reduction, so a row costs one memory round trip. A statistic is summed by
// warp shuffles, then over the block's warps through shared memory behind
// one __syncthreads (the block is the row's group, so the block barrier is
// the group's), each warp adding the warps' partials by the same shuffles,
// so two calls give the same bits. Rows past 8192, and the epilogue's
// variants that would not keep to 32 registers that way, take kWide: a
// block a row whose threads stride over it, the f32 row in dynamic shared
// memory between the statistics and the output pass, w read after them.
//
// The launch (the wrappers' `plan`, decided from the shapes alone) comes as
// one 64-bit word, so a call passes one argument for it: bits 0-10 threads
// a block, 16-17 the arm, 20-50 blocks. The kernels take the arm as a
// template argument.
#pragma once

#include "hopper.cuh"

namespace ptt {
namespace rows {

constexpr int kMaxThreads = 1024;  // threads of a block at most
constexpr int kRegHidden = 8 * kMaxThreads;  // widest row held in registers
// the wide arm: the f32 row in dynamic shared memory beside 32 floats of
// static reduction scratch, within the 232448 bytes a block may opt into
constexpr int kWideStatic = 128;
constexpr int kWideSmem = 232448 - kWideStatic;
constexpr int kWideHidden = kWideSmem / 4 / 8 * 8;
enum Arm { kRow = 0, kWide = 1 };

struct Launch {
  int threads, arm;
  long long blocks;
};

inline Launch decode(long long word) {
  Launch l;
  l.threads = (int)(word & 0x7ff);
  l.arm = (int)((word >> 16) & 0x3);
  l.blocks = (word >> 20) & 0x7fffffffLL;
  return l;
}

// The launch covers every (row, vector) the kernels address: a block a row
// of whole warps within a block's limit; kRow a thread a vector covering the
// row, kWide threads that stride over it.
inline bool valid(const Launch& l, long long rows, int hidden) {
  if (hidden <= 0 || hidden % 8 || rows <= 0 || l.blocks != rows) return false;
  if (l.threads < 32 || l.threads > kMaxThreads || l.threads % 32) return false;
  if (l.arm == kRow) return hidden <= kRegHidden && 8LL * l.threads >= hidden;
  return l.arm == kWide && hidden <= kWideHidden;
}

// Launches `Kernel` as `l` says on `stream`.
template <auto Kernel, typename... Args>
int launch(const Launch& l, size_t smem, cudaStream_t stream, Args... args) {
  Kernel<<<(unsigned)l.blocks, l.threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// 16 bytes of device memory as one word
__device__ __forceinline__ uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// 8 bf16 values of a 16-byte word as floats (common.cuh)
using ptt::unpack8;

// The block's sum of `v` (every thread passes its own; every thread gets
// the total): each warp's sum into shared memory, one barrier, then every
// warp adds the partials by the same shuffles. Two scratch rows are used in
// turn, so one barrier a sum: a row is written again only after every
// thread has passed the barrier of the sum after the one that read it.
__device__ __forceinline__ float block_total(float v, float (*red)[32], int& buf) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[buf][threadIdx.x >> 5] = v;
  __syncthreads();
  const float t = warp_sum(lane < (int)(blockDim.x >> 5) ? red[buf][lane] : 0.f);
  buf ^= 1;
  return t;
}

// -- the backward kernels' row groups -------------------------------------------

// Sums of N values over the lane's group of g warps (group grp; the lane's
// warp is wig of it); every thread of the group receives the totals in the
// same order. A group of one warp reduces by shuffles; a larger one also
// adds its warps' sums through `red` (two buffers used in turn, so no
// trailing barrier: a buffer is written again only after every warp has
// passed the next round's barrier, i.e. read this one) behind the group's
// named barrier 1 + grp.
template <int N, int K, int W>
__device__ __forceinline__ void group_sums(float* v, float (*red)[K][W], int& buf, int grp, int g,
                                           int wig, int lane) {
  static_assert(N <= K, "a buffer holds K sums");
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = warp_sum(v[k]);
  if (g == 1) return;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[buf][k][grp * g + wig] = v[k];
  }
  hopper::bar_sync(1 + grp, g * 32);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float t = 0.f;
    for (int i = 0; i < g; ++i) t += red[buf][k][grp * g + i];
    v[k] = t;
  }
  buf ^= 1;
}

// out[c] = sum over b of part[a][b][col] for c = a * hidden + col < cols, in
// a fixed order, stored as T (f32 or bf16, rounded once): the calling
// kernel's blocks of 32 * R threads take 32 columns each; thread (ty, tx)
// adds blocks ty, ty + R, ... of one column, then the R partial sums are
// added in order of ty. No atomics: two calls give the same bits.
template <int R, typename T>
__device__ __forceinline__ void sum_partial_rows(const float* __restrict__ part, T* __restrict__ out,
                                                 int n_blocks, int hidden, int cols) {
  __shared__ float acc[R][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  float s = 0.f;
  if (c < cols) {
    const int a = c / hidden, col = c % hidden;
    const float* p = part + (size_t)a * n_blocks * hidden + col;
#pragma unroll 8
    for (int b = ty; b < n_blocks; b += R) s += p[(size_t)b * hidden];
  }
  acc[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && c < cols) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < R; ++k) t += acc[k][tx];
    from_f(out + c, t);
  }
}

}  // namespace rows
}  // namespace ptt
