// RMSNorm with an optional residual add, bf16 in and out, f32 inside, and
// its backward.
//
// Forward: replaces paddle_tpu/ops/kernels/rms_norm_pallas.py `_fused_fwd`
// (kernel bodies `_fwd_plain_kernel` / `_fwd_res_kernel`). Computes
//   h = x (+ res);  y = h * rsqrt(mean(h^2) + eps) * w
// with h kept in f32 and y cast once, and writes h (cast) when a residual
// is given.
//
// Bound on the H100: bytes. Each row is read once (x, res) and written once
// (y, h); the work is a few operations per element. Design (csrc/
// norm_rows.cuh, shared with the block epilogue's forward; the plan is
// paddle_tpu_torch/ops/kernels/rms_norm.py `plan`): a row in the registers
// of its block, one 8-element vector a thread, w, x and res all requested
// before the one reduction, so a row costs one memory round trip (w read
// after the block-wide sum would put a second one in each row's chain).
// Rows past 8192 keep the f32 row in shared memory between the two passes.
//
// Backward: replaces rms_norm_pallas.py `_fused_bwd` (kernel body
// `_bwd_kernel`). From the saved pre-norm h (x when there was no residual)
// and the output cotangent g it recomputes rstd and writes
//   u = g * w;  dx = rstd * u - h * rstd^3 * (sum(h * u) / H)  (+ g_h)
// where g_h, the cotangent of the returned residual sum, joins dx in f32
// before the one rounding to bf16; and one f32 partial row of
//   dw = sum over rows of g * h * rstd
// per block, which the wrapper sums (the TPU kernel leaves that sum to XLA
// the same way). Bound on the H100: bytes — h and g (and g_h) read once, dx
// written once; the partial rows are 1/rows_per_block of that. Design: a
// block of up to 256 threads walks a group of rows; each thread owns the
// same 8-column vectors of every row (at most 4), so its share of dw stays in
// registers across the group, and its h and g stay in registers between the
// one combined reduction of (sum h^2, sum h*u) and the dx pass: each input
// is read once.
#include "norm_rows.cuh"

using ptt::bf16;
namespace rw = ptt::rows;

// kRow: block b takes row b, thread t its vector t.
template <bool RES>
__device__ __forceinline__ void rms_row(const bf16* __restrict__ x, const bf16* __restrict__ res,
                                        const bf16* __restrict__ w, bf16* __restrict__ y,
                                        bf16* __restrict__ h_out, int hidden, float eps) {
  __shared__ float red[2][32];
  const int col = threadIdx.x * 8;
  const bool mine = col < hidden;
  const size_t base = (size_t)blockIdx.x * hidden + col;
  uint4 wv = {}, xv = {}, rv = {};
  if (mine) {
    wv = rw::ld16(w + col);
    xv = rw::ld16(x + base);
    if (RES) rv = rw::ld16(res + base);
  }
  float h[8];
  rw::unpack8(xv, h);
  if (RES) {
    float rf[8];
    rw::unpack8(rv, rf);
#pragma unroll
    for (int e = 0; e < 8; ++e) h[e] += rf[e];
    if (mine) ptt::store8(h_out + base, h);
  }
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) ss += h[e] * h[e];
  int buf = 0;
  const float rstd = rsqrtf(rw::block_total(ss, red, buf) / (float)hidden + eps);
  if (mine) {
    float wf[8];
    rw::unpack8(wv, wf);
#pragma unroll
    for (int e = 0; e < 8; ++e) h[e] = h[e] * rstd * wf[e];
    ptt::store8(y + base, h);
  }
}

// kWide, rows past kRegHidden: a block a row, each thread striding over it
// in 16-byte vectors, the f32 row in dynamic shared memory for the second
// pass, so no input is read twice from device memory.
template <bool RES>
__device__ __forceinline__ void rms_wide(const bf16* __restrict__ x, const bf16* __restrict__ res,
                                         const bf16* __restrict__ w, bf16* __restrict__ y,
                                         bf16* __restrict__ h_out, int hidden, float eps) {
  extern __shared__ float row[];  // [hidden] f32 pre-norm values
  __shared__ float scratch[32];
  const size_t base = (size_t)blockIdx.x * hidden;
  const int step = blockDim.x * 8;
  float ss = 0.f;
  for (int i = threadIdx.x * 8; i < hidden; i += step) {
    float a[8];
    ptt::load8(x + base + i, a);
    if (RES) {
      float r[8];
      ptt::load8(res + base + i, r);
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] += r[j];
      ptt::store8(h_out + base + i, a);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      row[i + j] = a[j];
      ss += a[j] * a[j];
    }
  }
  const float rstd = rsqrtf(ptt::block_sum(ss, scratch) / (float)hidden + eps);
  // each thread reads back only the entries it wrote itself
  for (int i = threadIdx.x * 8; i < hidden; i += step) {
    float wv[8], o[8];
    ptt::load8(w + i, wv);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = row[i + j] * rstd * wv[j];
    ptt::store8(y + base + i, o);
  }
}

// ARM: rw::kRow or kWide. Both keep to 32 registers, so four blocks of 512
// threads (H 4096) share an SM.
template <bool RES, int ARM>
__global__ void __launch_bounds__(rw::kMaxThreads, 2)
    rms_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
                    const bf16* __restrict__ w, bf16* __restrict__ y, bf16* __restrict__ h_out,
                    int hidden, float eps) {
  if constexpr (ARM == rw::kWide)
    rms_wide<RES>(x, res, w, y, h_out, hidden, eps);
  else
    rms_row<RES>(x, res, w, y, h_out, hidden, eps);
}

namespace {

template <bool RES, int ARM>
int launch_arm(const rw::Launch& l, const void* x, const void* res, const void* w, void* y,
               void* h, int hidden, float eps, cudaStream_t s) {
  size_t smem = 0;
  if (ARM == rw::kWide) {
    smem = (size_t)hidden * sizeof(float);
    // above 48 KB in all (the static scratch included) only after opting in
    if (smem + rw::kWideStatic > 48 * 1024) {
      const cudaError_t err =
          ptt::hopper::allow_smem<rms_norm_kernel<RES, rw::kWide>>(rw::kWideSmem);
      if (err != cudaSuccess) return (int)err;
    }
  }
  return rw::launch<rms_norm_kernel<RES, ARM>>(
      l, smem, s, static_cast<const bf16*>(x), static_cast<const bf16*>(res),
      static_cast<const bf16*>(w), static_cast<bf16*>(y), static_cast<bf16*>(h), hidden, eps);
}

template <bool RES>
int launch_fwd(const rw::Launch& l, const void* x, const void* res, const void* w, void* y,
               void* h, int hidden, float eps, cudaStream_t s) {
  return l.arm == rw::kWide ? launch_arm<RES, rw::kWide>(l, x, res, w, y, h, hidden, eps, s)
                            : launch_arm<RES, rw::kRow>(l, x, res, w, y, h, hidden, eps, s);
}

}  // namespace

// x, res, y, h: [rows, hidden] bf16 (res and h may be null together);
// w: [hidden] bf16; hidden % 8 == 0, at most rw::kWideHidden (the wide
// arm's f32 row in shared memory). `plan`: the launch word of rms_norm.plan
// (norm_rows.cuh); a launch that does not cover every (row, vector) is
// refused.
PTT_EXPORT int ptt_rms_norm(const void* x, const void* res, const void* w, void* y, void* h,
                            int rows, int hidden, float eps, long long plan, void* stream) {
  if (rows == 0) return 0;
  const rw::Launch l = rw::decode(plan);
  if (!rw::valid(l, rows, hidden))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return res != nullptr ? launch_fwd<true>(l, x, res, w, y, h, hidden, eps, s)
                        : launch_fwd<false>(l, x, nullptr, w, y, nullptr, hidden, eps, s);
}

namespace {

constexpr int kBwdThreads = 256;

// sums of two values over the block; every thread receives both totals.
// `scratch` is 2 x 32 floats of shared memory; the trailing barrier lets the
// caller reuse it at once.
__device__ __forceinline__ float2 block_sum2(float a, float b, float (*scratch)[32]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a = ptt::warp_sum(a);
  b = ptt::warp_sum(b);
  if (lane == 0) {
    scratch[0][warp] = a;
    scratch[1][warp] = b;
  }
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  const float2 r = make_float2(ptt::warp_sum(lane < n_warps ? scratch[0][lane] : 0.f),
                               ptt::warp_sum(lane < n_warps ? scratch[1][lane] : 0.f));
  __syncthreads();
  return r;
}

// V: 8-element vectors per thread and row (hidden <= V * 8 * blockDim.x)
template <int V>
__global__ void __launch_bounds__(kBwdThreads)
    rms_norm_bwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                        const bf16* __restrict__ g, const bf16* __restrict__ gh,
                        bf16* __restrict__ dx, float* __restrict__ dw_part, int rows,
                        int rows_per_block, int hidden, float eps) {
  __shared__ float scratch[2][32];
  const int step = blockDim.x * 8;
  const float inv_h = 1.f / (float)hidden;
  float wv[V][8], acc[V][8];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int i = threadIdx.x * 8 + k * step;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[k][j] = 0.f;
    if (i < hidden) ptt::load8(w + i, wv[k]);
  }
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int r = r0; r < r1; ++r) {
    const size_t base = (size_t)r * hidden;
    float hv[V][8], gv[V][8];
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = threadIdx.x * 8 + k * step;
      if (i < hidden) {
        ptt::load8(h + base + i, hv[k]);
        ptt::load8(g + base + i, gv[k]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          ss += hv[k][j] * hv[k][j];
          dot += hv[k][j] * (gv[k][j] * wv[k][j]);
        }
      }
    }
    const float2 tot = block_sum2(ss, dot, scratch);
    const float rstd = rsqrtf(tot.x * inv_h + eps);
    const float c = rstd * rstd * rstd * (tot.y * inv_h);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = threadIdx.x * 8 + k * step;
      if (i < hidden) {
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[j] = rstd * (gv[k][j] * wv[k][j]) - hv[k][j] * c;
          acc[k][j] += (gv[k][j] * hv[k][j]) * rstd;
        }
        if (gh != nullptr) {
          float gr[8];
          ptt::load8(gh + base + i, gr);
#pragma unroll
          for (int j = 0; j < 8; ++j) o[j] += gr[j];
        }
        ptt::store8(dx + base + i, o);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int i = threadIdx.x * 8 + k * step;
    if (i < hidden) {
      float4* out = reinterpret_cast<float4*>(dw_part + (size_t)blockIdx.x * hidden + i);
      out[0] = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
      out[1] = make_float4(acc[k][4], acc[k][5], acc[k][6], acc[k][7]);
    }
  }
}

template <int V>
void launch_bwd(const void* h, const void* w, const void* g, const void* gh, void* dx,
                void* dw_part, int rows, int rows_per_block, int hidden, float eps, int threads,
                cudaStream_t s) {
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  rms_norm_bwd_kernel<V><<<blocks, threads, 0, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w), static_cast<const bf16*>(g),
      static_cast<const bf16*>(gh), static_cast<bf16*>(dx), static_cast<float*>(dw_part), rows,
      rows_per_block, hidden, eps);
}

}  // namespace

// h, g, dx: [rows, hidden] bf16; gh: the same or null; w: [hidden] bf16;
// dw_part: [ceil(rows / rows_per_block), hidden] f32; hidden % 8 == 0 and
// hidden <= 8192 (4 vectors a thread in registers, 256 threads).
PTT_EXPORT int ptt_rms_norm_bwd(const void* h, const void* w, const void* g, const void* gh,
                                void* dx, void* dw_part, int rows, int rows_per_block, int hidden,
                                float eps, void* stream) {
  if (rows == 0) return 0;
  const int vecs = hidden / 8;
  int threads = ((vecs + 31) / 32) * 32;
  threads = threads > kBwdThreads ? kBwdThreads : threads;
  const int v = (vecs + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 1: launch_bwd<1>(h, w, g, gh, dx, dw_part, rows, rows_per_block, hidden, eps, threads, s); break;
    case 2: launch_bwd<2>(h, w, g, gh, dx, dw_part, rows, rows_per_block, hidden, eps, threads, s); break;
    case 3: launch_bwd<3>(h, w, g, gh, dx, dw_part, rows, rows_per_block, hidden, eps, threads, s); break;
    case 4: launch_bwd<4>(h, w, g, gh, dx, dw_part, rows, rows_per_block, hidden, eps, threads, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
