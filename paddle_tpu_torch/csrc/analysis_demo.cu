// The kernel analyzer's planted-fault fixtures, as CUDA kernels.
//
// Replaces paddle_tpu/analysis/kernels/demo.py (`vmem_overflow` :38,
// `overlapping_writes` :48, `coverage_gap` :60, `oob_read` :72,
// `vmem_scalar_mulf` :89, `missing_x64_off` :103): each kernel computes what
// its Pallas body computes (x + x, a copy, x * (x[0, 0] * 2)) at the JAX
// example's shapes, and keeps its one planted fault in CUDA terms. The
// declarations that the analyzer checks, and the plain versions, are in
// paddle_tpu_torch/analysis/kernels/demo.py. Nothing here is on a model's
// path; the analysis phase of chip_smoke.py launches every runnable plant
// once inside guard bands.
//
// Bound on the H100: bytes (a copy or one multiply an element). The copy
// plants move [64, cols] f32 tiles, one tile a block of 256 threads.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;

// x + x with the whole operand staged in dynamic shared memory: the
// `vmem_overflow` plant launches it on a 32 MiB operand, which no block can
// hold (the opt-in limit is 227 KB).
__global__ void demo_double_kernel(const float* __restrict__ x, float* __restrict__ o, int n) {
  extern __shared__ float tile[];
  for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = x[i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) o[i] = tile[i] + tile[i];
}

__device__ __forceinline__ void copy_tile(const float* __restrict__ x, float* __restrict__ o,
                                          int src, int dst, int cols) {
  const float* s = x + (size_t)src * kTileRows * cols;
  float* d = o + (size_t)dst * kTileRows * cols;
  for (int i = threadIdx.x; i < kTileRows * cols; i += blockDim.x) d[i] = s[i];
}

// grid (2, 2): block (i, j) copies input tile j into output tile j, so two
// blocks write every output tile (the values agree; the writes race).
__global__ void demo_overlap_kernel(const float* __restrict__ x, float* __restrict__ o, int cols) {
  copy_tile(x, o, blockIdx.y, blockIdx.y, cols);
}

// grid (2): block i copies input tile i into output tile i of an output of
// four tiles; tiles 2 and 3 are never written.
__global__ void demo_gap_kernel(const float* __restrict__ x, float* __restrict__ o, int cols) {
  copy_tile(x, o, blockIdx.x, blockIdx.x, cols);
}

// grid (4): block i copies input tile i into output tile i, but the input
// has two tiles; blocks 2 and 3 read past its end.
__global__ void demo_oob_kernel(const float* __restrict__ x, float* __restrict__ o, int cols) {
  copy_tile(x, o, blockIdx.x, blockIdx.x, cols);
}

// o = x * (x[0, 0] * 2), one [64, cols] tile a block: correct (Mosaic's
// scalar-multiply miscompile has no nvcc counterpart).
__global__ void demo_scalar_kernel(const float* __restrict__ x, float* __restrict__ o, int cols) {
  const float s = x[0] * 2.0f;
  const size_t base = (size_t)blockIdx.x * kTileRows * cols;
  for (int i = threadIdx.x; i < kTileRows * cols; i += blockDim.x) o[base + i] = x[base + i] * s;
}

}  // namespace

// x, o: [n] f32, the whole of x in one block's dynamic shared memory. The
// first error is returned: a refused opt-in is reported here, and cleared,
// so that no later call reports it.
PTT_EXPORT int ptt_demo_double(const void* x, void* o, int n, void* stream) {
  const size_t smem = (size_t)n * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        demo_double_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
  }
  demo_double_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), n);
  return (int)cudaGetLastError();
}

// plant: 0 overlapping writes, 1 coverage gap, 2 out-of-bounds read,
// 3 the scalar multiply; grid as the plant declares it, [64, cols] tiles.
PTT_EXPORT int ptt_demo_tiles(int plant, const void* x, void* o, int gx, int gy, int cols,
                              void* stream) {
  const dim3 grid(gx, gy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  float* oo = static_cast<float*>(o);
  switch (plant) {
    case 0: demo_overlap_kernel<<<grid, kThreads, 0, s>>>(xi, oo, cols); break;
    case 1: demo_gap_kernel<<<grid, kThreads, 0, s>>>(xi, oo, cols); break;
    case 2: demo_oob_kernel<<<grid, kThreads, 0, s>>>(xi, oo, cols); break;
    case 3: demo_scalar_kernel<<<grid, kThreads, 0, s>>>(xi, oo, cols); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
