// Flash-attention backward (FlashAttention-2 style), bf16 q/k/v/out/dO in,
// bf16 dq/dk/dv out, f32 logits, probabilities and accumulators.
//
// Replaces paddle_tpu/ops/kernels/flash_attention_pallas.py
// `flash_attention_backward` (the `_dq_kernel` and `_dkv_kernel` calls, with
// delta = rowsum(dO * O) beside them). Layout [B, S, H, D]; k and v carry Hkv
// heads with H % Hkv == 0. It takes the forward's log-sum-exp [B*H, S] f32
// (csrc/flash_attention.cu) and recomputes, per (query, key) tile,
//   P = exp(scale * Q K^T - lse),  dP = dO V^T,  dS = P * (dP - delta),
//   dQ = scale * dS K,  dV = P^T dO,  dK = scale * dS^T Q.
// Masking matches the forward: causal and/or segment ids [B, S]; a masked
// probability is exactly 0; keys and queries past S are masked; any S.
//
// Three launches: delta (one warp per query row), dQ, and dK/dV.
// - dQ: one block of 4 warps per (b*h, 64-query tile), heaviest causal tiles
//   first; Q and dO stay in registers as mma.sync A fragments; a loop walks
//   32-key tiles (up to the diagonal when causal) through shared memory.
// - dK/dV: one block of 4 warps per (b*hkv, 64-key tile); K and V stay in
//   shared memory; a loop walks the 32-query tiles of EVERY query head of the
//   kv head's group, so the GQA group sum is made in f32 registers and dk, dv
//   are written once in bf16. (The TPU version writes per-query-head f32
//   partials [B*H, S, D] and sums them afterwards; those buffers are 2 x 67
//   MB at q [2, 2048, 32, 128].)
// Products are mma.sync m16n8k16 bf16 with f32 accumulation. A product whose
// A operand is a probability or a dS tile takes it as two bf16 terms (hi +
// lo, 16 significant bits), as the forward does for P V. B fragments that
// pair two neighbouring rows of a row-major tile are built from two 16-bit
// shared-memory loads (conflict-free with the 8-element row padding), so no
// tile is stored twice.
//
// Bound on the H100: operations (bf16 tensor cores), 2.5x the forward's
// 4 * B * H * S^2 * D (halved when causal). The dK/dV block holds two
// [64 x D] f32 accumulators (16 rows a warp: 2 x D/2 registers a thread);
// its 32-query step keeps the S and dP tiles at 16 registers each so the
// whole block fits in registers at D = 128.
#include "common.cuh"

using ptt::bf16;
using ptt::ld32;
using ptt::mma_bf16;

namespace {

constexpr int kThreads = 128;
constexpr int kDqBQ = 64;   // dQ kernel: queries per block (4 warps x 16)
constexpr int kDqBK = 32;   // dQ kernel: keys per step
constexpr int kKvBK = 64;   // dK/dV kernel: keys per block (4 warps x 16)
constexpr int kKvBQ = 32;   // dK/dV kernel: queries per step

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

// B fragments (b0, b1) of a 16 (k) x 8 (n) operand stored row-major with k
// along rows: b0 pairs rows 2t, 2t+1 and b1 rows 2t+8, 2t+9, at column g.
// `p` points at row 2t, column g of the 16-row step.
__device__ __forceinline__ void b_rows(const bf16* p, int stride, uint32_t& b0, uint32_t& b1) {
  b0 = pack2(p[0], p[stride]);
  b1 = pack2(p[8 * stride], p[9 * stride]);
}

// A fragments of the 16 x 16 step j taken from f32 accumulators of n-tiles
// 2j and 2j+1 (the m16n8 C layout is the m16k16 A layout), split hi + lo.
__device__ __forceinline__ void a_split(const float* c0, const float* c1, uint32_t* hi,
                                        uint32_t* lo) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// rows [row0, row0 + n) of a bf16 matrix with row stride `ld` elements (D
// contiguous values a row) into a shared tile of row stride ST; rows at or
// past S are zeros.
template <int D>
__device__ __forceinline__ void stage(bf16* dst, int ST, const bf16* src, size_t ld, int row0,
                                      int n, int S) {
  constexpr int VPR = D / 8;
  for (int e = threadIdx.x; e < n * VPR; e += kThreads) {
    const int r = e / VPR, c = (e % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * ST + c) = val;
  }
}

// delta[(b*H + h)*S + s] = sum_d dO * O, in f32; one warp per (b, s, h).
template <int D>
__global__ void flash_bwd_delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                                       float* __restrict__ delta, int rows, int S, int H) {
  constexpr int LANES = D / 8;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  if (lane < LANES) {
    float o[8], d[8];
    ptt::load8(out + (size_t)row * D + lane * 8, o);
    ptt::load8(dout + (size_t)row * D + lane * 8, d);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += o[j] * d[j];
  }
  acc = ptt::warp_sum(acc);
  if (lane == 0) {
    const int h = row % H, s = (row / H) % S, b = row / (H * S);
    delta[((size_t)b * H + h) * S + s] = acc;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ seg, bf16* __restrict__ dq, int S, int H, int Hkv,
                        int causal, float scale) {
  constexpr int ST = D + 8;       // row stride of every shared tile
  constexpr int NT = kDqBK / 8;   // 8-key n-tiles of S and dP per warp
  constexpr int DT = D / 8;       // 8-wide n-tiles of dQ
  constexpr int KS = D / 16;      // 16-deep k-steps over D
  __shared__ __align__(16) bf16 Ks[kDqBQ * ST];  // Q staging, then K tiles
  __shared__ __align__(16) bf16 Vs[kDqBQ * ST];  // dO staging, then V tiles
  __shared__ int qseg[kDqBQ];
  __shared__ int kseg[kDqBK];

  const int n_qt = (S + kDqBQ - 1) / kDqBQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, hq = bh % H, hk = hq / (H / Hkv);
  const int q0 = qt * kDqBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qs_row = (size_t)H * D, kv_row = (size_t)Hkv * D;
  const bf16* qb = q + (size_t)b * S * qs_row + (size_t)hq * D;
  const bf16* ob = dout + (size_t)b * S * qs_row + (size_t)hq * D;
  const bf16* kb = k + (size_t)b * S * kv_row + (size_t)hk * D;
  const bf16* vb = v + (size_t)b * S * kv_row + (size_t)hk * D;
  const int* sb = seg == nullptr ? nullptr : seg + (size_t)b * S;

  stage<D>(Ks, ST, qb, qs_row, q0, kDqBQ, S);
  stage<D>(Vs, ST, ob, qs_row, q0, kDqBQ, S);
  if (sb != nullptr && tid < kDqBQ) qseg[tid] = q0 + tid < S ? sb[q0 + tid] : 0;
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8 of the tile
  uint32_t qa[KS][4], da[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = ld32(&Ks[r0 * ST + c]);
    qa[kk][1] = ld32(&Ks[(r0 + 8) * ST + c]);
    qa[kk][2] = ld32(&Ks[r0 * ST + c + 8]);
    qa[kk][3] = ld32(&Ks[(r0 + 8) * ST + c + 8]);
    da[kk][0] = ld32(&Vs[r0 * ST + c]);
    da[kk][1] = ld32(&Vs[(r0 + 8) * ST + c]);
    da[kk][2] = ld32(&Vs[r0 * ST + c + 8]);
    da[kk][3] = ld32(&Vs[(r0 + 8) * ST + c + 8]);
  }
  const int qrow0 = q0 + r0, qrow1 = q0 + r0 + 8;
  const size_t lrow = (size_t)bh * S;
  const float lse0 = qrow0 < S ? lse[lrow + qrow0] : 0.f;
  const float lse1 = qrow1 < S ? lse[lrow + qrow1] : 0.f;
  const float dl0 = qrow0 < S ? delta[lrow + qrow0] : 0.f;
  const float dl1 = qrow1 < S ? delta[lrow + qrow1] : 0.f;
  const int qsg0 = sb != nullptr ? qseg[r0] : 0, qsg1 = sb != nullptr ? qseg[r0 + 8] : 0;

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_kt = (S + kDqBK - 1) / kDqBK;
  const int kt_end = causal ? min(n_kt, (q0 + kDqBQ - 1) / kDqBK + 1) : n_kt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kDqBK;
    __syncthreads();  // the previous tile (or the Q / dO staging) is fully read
    stage<D>(Ks, ST, kb, kv_row, k0, kDqBK, S);
    stage<D>(Vs, ST, vb, kv_row, k0, kDqBK, S);
    if (sb != nullptr && tid < kDqBK) kseg[tid] = k0 + tid < S ? sb[k0 + tid] : 0;
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* kr = &Ks[(n * 8 + g) * ST + kk * 16 + 2 * t];
        mma_bf16(s[n], qa[kk], ld32(kr), ld32(kr + 8));
        const bf16* vr = &Vs[(n * 8 + g) * ST + kk * 16 + 2 * t];
        mma_bf16(dp[n], da[kk], ld32(vr), ld32(vr + 8));
      }
    }
    // element e of n-tile n: row (e < 2 ? r0 : r0 + 8), key k0 + n*8 + 2t + (e & 1)
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
        const float p = ok ? expf(s[n][e] * scale - (e < 2 ? lse0 : lse1)) : 0.f;
        s[n][e] = p * (dp[n][e] - (e < 2 ? dl0 : dl1));  // dS
      }
    }
    // dQ += dS K: K rows are the k dimension, D the n dimension
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t hi[4], lo[4];
      a_split(s[2 * j], s[2 * j + 1], hi, lo);
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        uint32_t b0, b1;
        b_rows(&Ks[(j * 16 + 2 * t) * ST + n * 8 + g], ST, b0, b1);
        mma_bf16(acc[n], hi, b0, b1);
        mma_bf16(acc[n], lo, b0, b1);
      }
    }
  }

  bf16* dqb = dq + (size_t)b * S * qs_row + (size_t)hq * D;
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int c = n * 8 + 2 * t;
    if (qrow0 < S)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)qrow0 * qs_row + c) =
          __floats2bfloat162_rn(acc[n][0] * scale, acc[n][1] * scale);
    if (qrow1 < S)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)qrow1 * qs_row + c) =
          __floats2bfloat162_rn(acc[n][2] * scale, acc[n][3] * scale);
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(2 * kKvBK + 2 * kKvBQ) * (D + 8) * sizeof(bf16) +
         (size_t)(3 * kKvBQ + kKvBK) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ seg, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int S, int H, int Hkv, int causal, float scale) {
  constexpr int ST = D + 8;
  constexpr int NT = kKvBQ / 8;   // 8-query n-tiles of S^T and dP^T per warp
  constexpr int DT = D / 8;
  constexpr int KS = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [kKvBK][ST]
  bf16* Vs = Ks + kKvBK * ST;                 // [kKvBK][ST]
  bf16* Qs = Vs + kKvBK * ST;                 // [kKvBQ][ST]
  bf16* Os = Qs + kKvBQ * ST;                 // [kKvBQ][ST]  dO
  float* lse_s = reinterpret_cast<float*>(Os + kKvBQ * ST);  // [kKvBQ]
  float* dlt_s = lse_s + kKvBQ;                               // [kKvBQ]
  int* qseg = reinterpret_cast<int*>(dlt_s + kKvBQ);          // [kKvBQ]
  int* kseg = qseg + kKvBQ;                                   // [kKvBK]

  const int k0 = blockIdx.x * kKvBK;  // heaviest causal tiles (small k0) first
  const int bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk % Hkv, rep = H / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qs_row = (size_t)H * D, kv_row = (size_t)Hkv * D;
  const int* sb = seg == nullptr ? nullptr : seg + (size_t)b * S;

  stage<D>(Ks, ST, k + (size_t)b * S * kv_row + (size_t)hk * D, kv_row, k0, kKvBK, S);
  stage<D>(Vs, ST, v + (size_t)b * S * kv_row + (size_t)hk * D, kv_row, k0, kKvBK, S);
  if (sb != nullptr && tid < kKvBK) kseg[tid] = k0 + tid < S ? sb[k0 + tid] : 0;
  const int r0 = warp * 16 + g;  // this thread's keys: r0 and r0 + 8 of the tile
  const int key0 = k0 + r0, key1 = k0 + r0 + 8;

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = dva[n][0] = dva[n][1] = dva[n][2] =
        dva[n][3] = 0.f;

  const int n_qt = (S + kKvBQ - 1) / kKvBQ;
  const int qt_begin = causal ? k0 / kKvBQ : 0;
  for (int hq = hk * rep; hq < (hk + 1) * rep; ++hq) {
    const bf16* qb = q + (size_t)b * S * qs_row + (size_t)hq * D;
    const bf16* ob = dout + (size_t)b * S * qs_row + (size_t)hq * D;
    const size_t lrow = ((size_t)b * H + hq) * S;
    for (int qt = qt_begin; qt < n_qt; ++qt) {
      const int q0 = qt * kKvBQ;
      __syncthreads();  // the previous query tile is fully read
      stage<D>(Qs, ST, qb, qs_row, q0, kKvBQ, S);
      stage<D>(Os, ST, ob, qs_row, q0, kKvBQ, S);
      if (tid < kKvBQ) {
        const bool in = q0 + tid < S;
        lse_s[tid] = in ? lse[lrow + q0 + tid] : 0.f;
        dlt_s[tid] = in ? delta[lrow + q0 + tid] : 0.f;
        if (sb != nullptr) qseg[tid] = in ? sb[q0 + tid] : 0;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: keys are rows, queries the n dimension
      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        st[n][0] = st[n][1] = st[n][2] = st[n][3] = dpt[n][0] = dpt[n][1] = dpt[n][2] =
            dpt[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int c = kk * 16 + 2 * t;
        uint32_t ka[4], va[4];
        ka[0] = ld32(&Ks[r0 * ST + c]);
        ka[1] = ld32(&Ks[(r0 + 8) * ST + c]);
        ka[2] = ld32(&Ks[r0 * ST + c + 8]);
        ka[3] = ld32(&Ks[(r0 + 8) * ST + c + 8]);
        va[0] = ld32(&Vs[r0 * ST + c]);
        va[1] = ld32(&Vs[(r0 + 8) * ST + c]);
        va[2] = ld32(&Vs[r0 * ST + c + 8]);
        va[3] = ld32(&Vs[(r0 + 8) * ST + c + 8]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const bf16* qr = &Qs[(n * 8 + g) * ST + c];
          mma_bf16(st[n], ka, ld32(qr), ld32(qr + 8));
          const bf16* orow = &Os[(n * 8 + g) * ST + c];
          mma_bf16(dpt[n], va, ld32(orow), ld32(orow + 8));
        }
      }
      // element e of n-tile n: key (e < 2 ? key0 : key1), query q0 + n*8 + 2t + (e & 1)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = n * 8 + 2 * t + (e & 1);
          const int qrow = q0 + qc;
          const int key = e < 2 ? key0 : key1;
          bool ok = qrow < S && key < S;
          if (causal) ok = ok && key <= qrow;
          if (sb != nullptr) ok = ok && qseg[qc] == kseg[e < 2 ? r0 : r0 + 8];
          const float p = ok ? expf(st[n][e] * scale - lse_s[qc]) : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dlt_s[qc]);  // dS^T
        }
      }
      // dV += P^T dO and dK += dS^T Q: queries are the k dimension, D the n one
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t ph[4], pl[4], sh[4], sl[4];
        a_split(st[2 * j], st[2 * j + 1], ph, pl);
        a_split(dpt[2 * j], dpt[2 * j + 1], sh, sl);
#pragma unroll
        for (int n = 0; n < DT; ++n) {
          uint32_t b0, b1;
          b_rows(&Os[(j * 16 + 2 * t) * ST + n * 8 + g], ST, b0, b1);
          mma_bf16(dva[n], ph, b0, b1);
          mma_bf16(dva[n], pl, b0, b1);
          b_rows(&Qs[(j * 16 + 2 * t) * ST + n * 8 + g], ST, b0, b1);
          mma_bf16(dka[n], sh, b0, b1);
          mma_bf16(dka[n], sl, b0, b1);
        }
      }
    }
  }

  bf16* dkb = dk + (size_t)b * S * kv_row + (size_t)hk * D;
  bf16* dvb = dv + (size_t)b * S * kv_row + (size_t)hk * D;
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int c = n * 8 + 2 * t;
    if (key0 < S) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)key0 * kv_row + c) =
          __floats2bfloat162_rn(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)key0 * kv_row + c) =
          __floats2bfloat162_rn(dva[n][0], dva[n][1]);
    }
    if (key1 < S) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)key1 * kv_row + c) =
          __floats2bfloat162_rn(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)key1 * kv_row + c) =
          __floats2bfloat162_rn(dva[n][2], dva[n][3]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const void* lse, const void* seg, void* delta, void* dq, void* dk, void* dv, int B,
           int S, int H, int Hkv, int causal, float scale, cudaStream_t s) {
  const int rows = B * S * H;
  const int warps = kThreads / 32;
  flash_bwd_delta_kernel<D><<<(rows + warps - 1) / warps, kThreads, 0, s>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), static_cast<float*>(delta),
      rows, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((S + kDqBQ - 1) / kDqBQ, B * H);
  flash_bwd_dq_kernel<D><<<grid_q, kThreads, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg), static_cast<bf16*>(dq), S,
      H, Hkv, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr size_t smem = dkv_smem_bytes<D>();
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid_kv((S + kKvBK - 1) / kKvBK, B * Hkv);
  flash_bwd_dkv_kernel<D><<<grid_kv, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, H, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out, dout, dq: [B, S, H, D] bf16; k, v, dk, dv: [B, S, Hkv, D] bf16,
// H % Hkv == 0; lse: [B*H, S] f32 from the forward; delta: [B*H, S] f32
// scratch (written here); seg: [B, S] int32 or null; D in {64, 128}.
PTT_EXPORT int ptt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, const void* lse,
                                       const void* seg, void* delta, void* dq, void* dk, void* dv,
                                       int B, int S, int H, int Hkv, int D, int causal,
                                       float scale, void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, out, dout, lse, seg, delta, dq, dk, dv, B, S, H, Hkv, causal,
                      scale, s);
  if (D == 128)
    return launch<128>(q, k, v, out, dout, lse, seg, delta, dq, dk, dv, B, S, H, Hkv, causal,
                       scale, s);
  return (int)cudaErrorInvalidValue;
}
