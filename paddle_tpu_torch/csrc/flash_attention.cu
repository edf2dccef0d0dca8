// Flash-attention forward (FlashAttention-2 online softmax), bf16 in and
// out, f32 logits, probabilities and accumulator.
//
// Replaces paddle_tpu/ops/kernels/flash_attention_pallas.py `_fwd_common`
// (kernel body `_attn_kernel`), reached through `flash_attention_forward`
// and `flash_attention_forward_lse`. Layout [B, S, H, D]; k and v carry
// Hkv heads with H % Hkv == 0 and are read by the shared head's index, never
// repeated. Options: causal or full, segment ids [B, S] (a query sees only
// keys of its own segment), and the log-sum-exp [B*H, S] f32.
//
// Numerics kept from the TPU kernel: logits in f32 scaled by 1/sqrt(D);
// masked logits are -1e30, not -inf; a masked probability is exactly 0, so
// a query row with no visible key gives 0; the denominator is clamped at
// 1e-30; the output is cast to bf16 once. Unlike the TPU kernel, S need not
// be a multiple of the tile: keys past S are masked and queries past S are
// not stored.
//
// Bound on the H100: operations (bf16 tensor cores) at the serving path's
// lengths. Design: one block of 4 warps per (b*h, 64-query tile); each warp
// owns 16 query rows. Q stays in registers as mma.sync A fragments; a loop
// walks 64-key tiles (up to the diagonal when causal) through shared memory,
// K row-major and V transposed, so both products read their B fragments
// with 32-bit loads. Q K^T is mma.sync m16n8k16 bf16 with f32 accumulation:
// products of bf16 values are exact in f32. For P V, the f32 probabilities
// are split as P = hi + lo, two bf16 values, and both halves go through the
// tensor cores, so P keeps 16 significant bits instead of bf16's 8. The
// heaviest causal tiles are scheduled first.
#include "common.cuh"

using ptt::bf16;
using ptt::ld32;
using ptt::mma_bf16;

namespace {

constexpr int kBQ = 64;  // query rows per block (4 warps x 16)
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// (hi, lo) bf16 halves of two f32 values: x ~= hi + lo to 16 bits.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const bf16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  hi = pack2(h0, h1);
  lo = pack2(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
             __float2bfloat16_rn(x1 - __bfloat162float(h1)));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const int* __restrict__ seg,
                           bf16* __restrict__ out, float* __restrict__ lse, int S, int H, int Hkv,
                           int causal, float scale) {
  constexpr int KST = D + 8;    // row stride of the K (and Q staging) tile
  constexpr int VST = kBK + 8;  // row stride of the transposed V tile
  constexpr int VPR = D / 8;    // 16-byte vectors per row
  constexpr int NT = kBK / 8;   // 8-key n-tiles of S per warp
  constexpr int DT = D / 8;     // 8-wide n-tiles of the output
  __shared__ __align__(16) bf16 Ks[kBK * KST];
  __shared__ __align__(16) bf16 Vt[D * VST];
  __shared__ int qseg[kBQ];
  __shared__ int kseg[kBK];

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, hq = bh % H, hk = hq / (H / Hkv);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qs_row = (size_t)H * D, kv_row = (size_t)Hkv * D;
  const bf16* qb = q + (size_t)b * S * qs_row + (size_t)hq * D;
  const bf16* kb = k + (size_t)b * S * kv_row + (size_t)hk * D;
  const bf16* vb = v + (size_t)b * S * kv_row + (size_t)hk * D;
  const int* sb = seg == nullptr ? nullptr : seg + (size_t)b * S;

  // stage the Q tile in Ks (zeros past S), then keep it as A fragments
  for (int e = tid; e < kBQ * VPR; e += kThreads) {
    const int r = e / VPR, c = (e % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < S) val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * qs_row + c);
    *reinterpret_cast<uint4*>(&Ks[r * KST + c]) = val;
  }
  if (sb != nullptr && tid < kBQ) qseg[tid] = q0 + tid < S ? sb[q0 + tid] : 0;
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8 of the tile
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = ld32(&Ks[r0 * KST + c]);
    qa[kk][1] = ld32(&Ks[(r0 + 8) * KST + c]);
    qa[kk][2] = ld32(&Ks[r0 * KST + c + 8]);
    qa[kk][3] = ld32(&Ks[(r0 + 8) * KST + c + 8]);
  }
  const int qrow0 = q0 + r0, qrow1 = q0 + r0 + 8;
  const int qsg0 = sb != nullptr ? qseg[r0] : 0, qsg1 = sb != nullptr ? qseg[r0 + 8] : 0;

  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int n_kt = (S + kBK - 1) / kBK;
  const int kt_end = causal ? min(n_kt, (q0 + kBQ - 1) / kBK + 1) : n_kt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile (or the Q staging) is fully read
    for (int e = tid; e < kBK * VPR; e += kThreads) {
      const int r = e / VPR, c = (e % VPR) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < S) val = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * kv_row + c);
      *reinterpret_cast<uint4*>(&Ks[r * KST + c]) = val;
    }
    for (int e = tid; e < kBK * VPR; e += kThreads) {
      const int r = e % kBK, c = (e / kBK) * 8;  // neighbouring threads, neighbouring keys
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < S) val = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * kv_row + c);
      const bf16* pv = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c + j) * VST + r] = pv[j];
    }
    if (sb != nullptr && tid < kBK) kseg[tid] = k0 + tid < S ? sb[k0 + tid] : 0;
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* kr = &Ks[(n * 8 + g) * KST + kk * 16 + 2 * t];
        mma_bf16(s[n], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // scale and mask; element e of n-tile n sits at row (e < 2 ? r0 : r0 + 8),
    // key k0 + n * 8 + 2t + (e & 1)
    unsigned valid = 0u;  // bit n * 4 + e
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = n * 8 + 2 * t + (e & 1);
        const int key = k0 + kc;
        const int qrow = e < 2 ? qrow0 : qrow1;
        bool ok = key < S;
        if (causal) ok = ok && key <= qrow;
        if (sb != nullptr) ok = ok && kseg[kc] == (e < 2 ? qsg0 : qsg1);
        const float x = ok ? s[n][e] * scale : kNegInf;
        s[n][e] = x;
        valid |= (unsigned)ok << (n * 4 + e);
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = expf(m0 - mx0), a1 = expf(m1 - mx1);
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = (valid >> (n * 4 + e)) & 1u;
        const float p = ok ? expf(s[n][e] - (e < 2 ? mx0 : mx1)) : 0.f;
        s[n][e] = p;
        if (e < 2) ls0 += p; else ls1 += p;
      }
    }
    l0 = a0 * l0 + ls0;  // per-thread partial sums; the quad adds them at the end
    l1 = a1 * l1 + ls1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
    // O += P V: the S accumulators of n-tiles 2j, 2j+1 are the A fragment
    // of the j-th 16-key step
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t ph[4], pl[4];
      split2(s[2 * j][0], s[2 * j][1], ph[0], pl[0]);
      split2(s[2 * j][2], s[2 * j][3], ph[1], pl[1]);
      split2(s[2 * j + 1][0], s[2 * j + 1][1], ph[2], pl[2]);
      split2(s[2 * j + 1][2], s[2 * j + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const bf16* vr = &Vt[(n * 8 + g) * VST + j * 16 + 2 * t];
        const uint32_t b0 = ld32(vr), b1 = ld32(vr + 8);
        mma_bf16(o[n], ph, b0, b1);
        mma_bf16(o[n], pl, b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int c = n * 8 + 2 * t;
    if (qrow0 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * S + qrow0) * qs_row +
                                         (size_t)hq * D + c) =
          __floats2bfloat162_rn(o[n][0] / d0, o[n][1] / d0);
    if (qrow1 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * S + qrow1) * qs_row +
                                         (size_t)hq * D + c) =
          __floats2bfloat162_rn(o[n][2] / d1, o[n][3] / d1);
  }
  if (lse != nullptr && t == 0) {
    if (qrow0 < S) lse[(size_t)bh * S + qrow0] = m0 + logf(d0);
    if (qrow1 < S) lse[(size_t)bh * S + qrow1] = m1 + logf(d1);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* seg, void* out, void* lse,
           int B, int S, int H, int Hkv, int causal, float scale, cudaStream_t s) {
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<D><<<grid, kThreads, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<bf16*>(out), static_cast<float*>(lse), S, H, Hkv,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: [B, S, H, D] bf16; k, v: [B, S, Hkv, D] bf16, H % Hkv == 0;
// seg: [B, S] int32 or null; lse: [B*H, S] f32 or null; D in {64, 128}.
PTT_EXPORT int ptt_flash_attention(const void* q, const void* k, const void* v, const void* seg,
                                   void* out, void* lse, int B, int S, int H, int Hkv, int D,
                                   int causal, float scale, void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(q, k, v, seg, out, lse, B, S, H, Hkv, causal, scale, s);
  if (D == 128) return launch<128>(q, k, v, seg, out, lse, B, S, H, Hkv, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
