// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel library is built on its own with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and exposes plain C entry points that take device pointers and a stream
// and return cudaGetLastError() (0 on success), so Python binds them with
// ctypes (paddle_tpu_torch/ops/kernels/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PTT_EXPORT extern "C" __attribute__((visibility("default")))

namespace ptt {

using bf16 = __nv_bfloat16;

// 8 bf16 values of a 16-byte word as floats
__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// 8 floats as the 16-byte word of their bf16 values (rounded to nearest)
__device__ __forceinline__ uint4 pack8(const float* in) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  return raw;
}

// 8 bf16 values <-> 8 floats through one 16-byte access (callers keep the
// pointer 16-byte aligned: the Python wrappers check it).
__device__ __forceinline__ void load8(const bf16* p, float* out) {
  unpack8(*reinterpret_cast<const uint4*>(p), out);
}

__device__ __forceinline__ void store8(bf16* p, const float* in) {
  *reinterpret_cast<uint4*>(p) = pack8(in);
}

// 8 floats through two 16-byte accesses (the f32 counterparts of the above)
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(in[4], in[5], in[6], in[7]);
}

// one value of either element type as f32
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// one f32 value stored as either element type (rounded to nearest)
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// 4 values <-> 4 floats: one 16-byte access for f32, one 8-byte access for
// bf16 (callers keep the pointer aligned to the access)
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}

__device__ __forceinline__ void store4(float* p, const float* o) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ void load4(const bf16* p, float* o) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

__device__ __forceinline__ void store4(bf16* p, const float* o) {
  uint2 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
  h[0] = __floats2bfloat162_rn(o[0], o[1]);
  h[1] = __floats2bfloat162_rn(o[2], o[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

// D += A B for one m16n8k16 tile on the bf16 tensor cores, f32 accumulators
// (A row-major, B column-major fragments, as mma.sync lays them out)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two neighbouring bf16 values of shared memory as one fragment register
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The counter-hash dropout's bits: murmur3's 32-bit finalizer (public
// domain, Austin Appleby), as paddle_tpu/ops/kernels/dropout_add_pallas.py
// `_fmix32`. An element is kept where fmix32(idx ^ seed * kGolden) >=
// threshold, idx its uint32 flat index (wrapping as jnp.uint32 does).
constexpr uint32_t kGolden = 0x9E3779B9u;  // 2^32 / phi

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the whole block; every thread receives the total.
// `scratch` is 32 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  return warp_sum(lane < n_warps ? scratch[lane] : 0.f);
}

}  // namespace ptt
