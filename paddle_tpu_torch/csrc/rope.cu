// Rotate-half rotary position embedding of q and k in one launch, bf16 in
// and out, f32 inside.
//
// Replaces paddle_tpu/ops/kernels/rope_pallas.py `_rope_call` (kernel body
// `_rope_kernel`), which the JAX F.rope (paddle_tpu/nn/functional/
// __init__.py:505) calls once for q and once for k: out = x * cos +
// rotate_half(x) * sin, rotate_half(x) = [-x2, x1] for the two halves of
// the head dimension. The adjoint is the rotation by -theta: the same
// launch with sign -1, which flips sin in registers (exact), so a backward
// builds no -sin table.
//
// Bound on the H100: bytes. q and k are read once and written once; each
// token's f32 cos / sin rows come from DRAM once and from L1 / L2 for the
// token's other heads. Design: one thread per (token, head, VEC-wide chunk
// of the first half of the head dimension), over the token's q heads and
// then its k heads, so a decode step of 8 tokens at 32 + 8 heads spreads
// over 20 blocks instead of one block a token and a launch a tensor. A
// thread issues all its loads (x's chunk in both halves, cos and sin at
// both) before its first product. VEC is 8 (16-byte accesses) where the
// half width is a multiple of 8, else 2 (4-byte bf16x2 accesses).
#include "common.cuh"

using ptt::bf16;

namespace {

constexpr int kThreads = 128;

template <int VEC>
__device__ __forceinline__ void load_x(const bf16* p, float* o) {
  if constexpr (VEC == 8) {
    ptt::load8(p, o);
  } else {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = f.x;
    o[1] = f.y;
  }
}

template <int VEC>
__device__ __forceinline__ void load_t(const float* p, float* o) {
  if constexpr (VEC == 8) {
    ptt::load8(p, o);
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    o[0] = f.x;
    o[1] = f.y;
  }
}

template <int VEC>
__device__ __forceinline__ void store_x(bf16* p, const float* o) {
  if constexpr (VEC == 8) {
    ptt::store8(p, o);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(o[0], o[1]);
  }
}

// q, q_out: [tokens, hq, dim]; k, k_out: [tokens, hk, dim] (hk may be 0);
// cos, sin: [rows, dim] f32 where the table row of token t is t when
// per_token, else t % seq (one row per position, shared by the batch).
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    rope_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                bf16* __restrict__ q_out, bf16* __restrict__ k_out, int tokens, int hq, int hk,
                int dim, int seq, int per_token, float sign) {
  const int half = dim / 2;
  const int chunks = half / VEC;
  const int heads = hq + hk;
  const int idx = blockIdx.x * kThreads + threadIdx.x;  // the host keeps the work under 2^31
  if (idx >= tokens * heads * chunks) return;
  const int c = idx % chunks;
  const int rest = idx / chunks;
  const int h = rest % heads;
  const int t = rest / heads;
  const int row = per_token ? t : t % seq;
  const int i = c * VEC;
  const bool is_q = h < hq;
  const size_t off = is_q ? ((size_t)t * hq + h) * dim + i : ((size_t)t * hk + (h - hq)) * dim + i;
  const bf16* x = is_q ? q : k;
  bf16* out = is_q ? q_out : k_out;
  const float* cr = cos_t + (size_t)row * dim + i;
  const float* sr = sin_t + (size_t)row * dim + i;

  float x1[VEC], x2[VEC], c1[VEC], c2[VEC], s1[VEC], s2[VEC];
  load_x<VEC>(x + off, x1);
  load_x<VEC>(x + off + half, x2);
  load_t<VEC>(cr, c1);
  load_t<VEC>(cr + half, c2);
  load_t<VEC>(sr, s1);
  load_t<VEC>(sr + half, s2);
  float o1[VEC], o2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    o1[j] = x1[j] * c1[j] - x2[j] * (sign * s1[j]);
    o2[j] = x2[j] * c2[j] + x1[j] * (sign * s2[j]);
  }
  store_x<VEC>(out + off, o1);
  store_x<VEC>(out + off + half, o2);
}

template <int VEC>
int launch(const void* q, const void* k, const void* cos_t, const void* sin_t, void* q_out,
           void* k_out, int tokens, int hq, int hk, int dim, int seq, int per_token, float sign,
           cudaStream_t s) {
  const long long work = (long long)tokens * (hq + hk) * (dim / 2 / VEC);
  if (work > 0x7fffffffLL - kThreads) return (int)cudaErrorInvalidValue;
  const long long blocks = (work + kThreads - 1) / kThreads;
  rope_kernel<VEC><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<bf16*>(q_out), static_cast<bf16*>(k_out),
      tokens, hq, hk, dim, seq, per_token, sign);
  return (int)cudaGetLastError();
}

}  // namespace

// dim % 4 == 0; rows of the tables = tokens (per_token) or seq; sign +1
// rotates by theta, -1 by -theta (the adjoint). k and k_out may be null
// with hk = 0.
PTT_EXPORT int ptt_rope(const void* q, const void* k, const void* cos_t, const void* sin_t,
                        void* q_out, void* k_out, int tokens, int hq, int hk, int dim, int seq,
                        int per_token, float sign, void* stream) {
  if (tokens == 0 || hq + hk == 0) return 0;
  if (dim % 4 || (hk && (!k || !k_out))) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dim / 2) % 8 == 0)
    return launch<8>(q, k, cos_t, sin_t, q_out, k_out, tokens, hq, hk, dim, seq, per_token, sign,
                     s);
  return launch<2>(q, k, cos_t, sin_t, q_out, k_out, tokens, hq, hk, dim, seq, per_token, sign, s);
}
