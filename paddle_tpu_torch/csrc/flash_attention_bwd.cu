// Flash-attention backward (FlashAttention-2 style), bf16 q/k/v/out/dO in,
// bf16 dq/dk/dv out, f32 logits, probabilities and accumulators, designed
// for the H100 (sm_90a).
//
// Replaces paddle_tpu/ops/kernels/flash_attention_pallas.py
// `flash_attention_backward` (the `_dq_kernel` and `_dkv_kernel` calls, with
// delta = rowsum(dO * O) beside them). Layout [B, S, H, D]; k and v carry Hkv
// heads with H % Hkv == 0. It takes the forward's log-sum-exp [B*H, S] f32
// (csrc/flash_attention.cu) and recomputes, per (query, key) tile,
//   P = exp(scale * Q K^T - lse),  dP = dO V^T,  dS = P * (dP - delta),
//   dQ = scale * dS K,  dV = P^T dO,  dK = scale * dS^T Q.
// Masking matches the forward: causal and/or segment ids [B, S]; a masked
// probability is exactly 0; keys and queries past S are masked; any S. P
// and dS are rounded to bf16 once before the products that take them (the
// tensor cores take bf16), as the forward rounds P before P V.
//
// Three launches, deterministic (no atomics; every output tile is written
// by one block): delta (one warp per query row), dQ, and dK/dV. Both product
// kernels are built from csrc/hopper.cuh: a producer warpgroup issues TMA
// copies into rings of shared-memory stages signalled by mbarriers, and
// consumer warpgroups run wgmma on them.
// - dQ: one block of three warpgroups per (b*h, 128-query tile), heaviest
//   causal tiles first. Q and dO stay in shared memory; 64-key K and V tiles
//   stream through three stages. Per tile, S = Q K^T and dP = dO V^T are wgmma
//   chains from shared memory (m64n64k16); dS is formed in registers, and
//   dQ += dS K is a register-A wgmma with K MN-major. 168 registers at
//   launch; setmaxnreg 24 (producer) / 240 (two consumers).
// - dK/dV: one block of two warpgroups per (b*hkv, 64-key tile), two blocks
//   an SM, so that even q [1, 1024, 32, 64] over 8 kv heads (128 blocks)
//   covers the card once. K and V stay in shared memory; tiles of BQ queries
//   (32 at D 128, 64 at D 64) of Q and dO, with their lse and delta, stream
//   through three stages, over EVERY query head of the kv head's group, so
//   the GQA group sum is made in f32 registers and dk, dv are written once
//   in bf16. S^T = K Q^T and dP^T = V dO^T are shared-memory wgmma
//   (m64nBQk16); dV += P^T dO and dK += dS^T Q are register-A wgmma with dO
//   and Q MN-major. 128 registers at launch; setmaxnreg 24 (producer) / 232
//   (consumer). (The TPU version writes per-query-head f32 partials
//   [B*H, S, D] and sums them afterwards.)
// In both product kernels a consumer issues a tile's shared-memory products
// with the previous tile's register-A products and forms dS while those run
// (FlashAttention-3's overlap inside a warpgroup). The first and last tiles
// are peeled out of the loop: a wgmma issued under a condition made every
// kernel slower. (The forward gained nothing from it and keeps the plain
// order.)
//
// Bound on the H100: operations (bf16 tensor cores), 2.5x the forward's
// 4 * B * H * S^2 * D (halved when causal).
#include "hopper.cuh"

using ptt::bf16;
namespace hp = ptt::hopper;

namespace {

constexpr int kDeltaThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// delta[(b*H + h)*S + s] = sum_d dO * O, in f32; one warp per (b, s, h).
template <int D>
__global__ void flash_bwd_delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                                       float* __restrict__ delta, int rows, int S, int H) {
  constexpr int LANES = D / 8;
  const int row = blockIdx.x * (kDeltaThreads / 32) + (threadIdx.x >> 5);
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

// -- dQ ---------------------------------------------------------------------

constexpr int kDqBQ = 128;   // queries a block: two consumer warpgroups of 64
constexpr int kDqBK = 64;    // keys a tile
constexpr int kDqStages = 3;
constexpr int kDqThreads = 384;

template <int D>
struct DqSmem {
  static constexpr int kQ = kDqBQ * D * 2;   // Q or dO
  static constexpr int kKV = kDqBK * D * 2;  // one K or V tile
  static constexpr int kBars = 2 * kQ + 2 * kDqStages * kKV;
  static constexpr int kBytes = 1024 + kBars + 8 * (1 + 2 * kDqStages);
};

template <int D>
__global__ void __launch_bounds__(kDqThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse,
                        const float* __restrict__ delta, const int* __restrict__ seg,
                        bf16* __restrict__ dq, int S, int H, int Hkv, int causal, float scale,
                        float scale_log2) {
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (hp::smem_u32(smem_raw) & 1023u)) & 1023u);
  bf16* sQ = reinterpret_cast<bf16*>(smem);              // [D / 64][kDqBQ][64]
  bf16* sO = reinterpret_cast<bf16*>(smem + L::kQ);       // dO, the same
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * L::kQ);   // [stage][D / 64][kDqBK][64]
  bf16* sV = sK + kDqStages * kDqBK * D;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kDqStages;

  const int n_qt = (S + kDqBQ - 1) / kDqBQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, hq = bh % H, hk = hq / (H / Hkv);
  const int q0 = qt * kDqBQ;
  const int n_kt = (S + kDqBK - 1) / kDqBK;
  const int kt_end = causal ? min(n_kt, (q0 + kDqBQ - 1) / kDqBK + 1) : n_kt;
  const int tid = threadIdx.x;

  if (tid == 0) {
    hp::mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 8);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    hp::reg_dealloc<24>();
    if (tid == 0) {
      hp::mbar_arrive_expect_tx(q_full, 2 * L::kQ);
#pragma unroll
      for (int h = 0; h < D / 64; ++h) {
        hp::tma_load_4d(sQ + h * kDqBQ * 64, &tq, q_full, h * 64, hq, q0, b);
        hp::tma_load_4d(sO + h * kDqBQ * 64, &tdo, q_full, h * 64, hq, q0, b);
      }
      for (int kt = 0; kt < kt_end; ++kt) {
        const int st = kt % kDqStages;
        if (kt >= kDqStages) hp::mbar_wait(&empty[st], ((kt / kDqStages) - 1) & 1);
        hp::mbar_arrive_expect_tx(&full[st], 2 * L::kKV);
        bf16* kd = sK + st * kDqBK * D;
        bf16* vd = sV + st * kDqBK * D;
#pragma unroll
        for (int h = 0; h < D / 64; ++h) {
          hp::tma_load_4d(kd + h * kDqBK * 64, &tk, &full[st], h * 64, hk, kt * kDqBK, b);
          hp::tma_load_4d(vd + h * kDqBK * 64, &tv, &full[st], h * 64, hk, kt * kDqBK, b);
        }
      }
    }
  } else {
    hp::reg_alloc<240>();
    const int cw = (tid >> 7) - 1;
    const int t = tid & 127, warp = t >> 5, lane = t & 31;
    const int q0w = q0 + cw * 64;
    const int row0 = q0w + warp * 16 + (lane >> 2), row1 = row0 + 8;
    const size_t lrow = (size_t)bh * S;
    // rows past S: lse +inf makes every probability 0
    const float lse0 = row0 < S ? lse[lrow + row0] * kLog2e : pos_inf();
    const float lse1 = row1 < S ? lse[lrow + row1] * kLog2e : pos_inf();
    const float dl0 = row0 < S ? delta[lrow + row0] : 0.f;
    const float dl1 = row1 < S ? delta[lrow + row1] : 0.f;
    const int* sb = seg == nullptr ? nullptr : seg + (size_t)b * S;
    const int qs0 = sb != nullptr && row0 < S ? sb[row0] : 0;
    const int qs1 = sb != nullptr && row1 < S ? sb[row1] : 0;
    const uint32_t q_addr = hp::smem_u32(sQ) + cw * 64 * 128;
    const uint32_t o_addr = hp::smem_u32(sO) + cw * 64 * 128;
    const uint32_t k_addr = hp::smem_u32(sK), v_addr = hp::smem_u32(sV);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    // Tile kt's S and dP are issued with tile kt - 1's dS K, and its dS is
    // formed while that product runs (first and last tiles peeled)
    float s[kDqBK / 2], dp[kDqBK / 2];
    uint32_t da[kDqBK / 16][4];  // dS of the previous tile
    auto issue_s = [&](int kt) {
      const int st = kt % kDqStages;
      const uint32_t ka = k_addr + st * L::kKV, va = v_addr + st * L::kKV;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        hp::Wgmma<kDqBK>::template ss<0>(
            s, hp::desc_kmajor(q_addr + (kk >> 2) * (kDqBQ * 128) + off),
            hp::desc_kmajor(ka + (kk >> 2) * (kDqBK * 128) + off), kk > 0 ? 1 : 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        hp::Wgmma<kDqBK>::template ss<0>(
            dp, hp::desc_kmajor(o_addr + (kk >> 2) * (kDqBQ * 128) + off),
            hp::desc_kmajor(va + (kk >> 2) * (kDqBK * 128) + off), kk > 0 ? 1 : 0);
      }
    };
    auto issue_dq = [&](int kt) {
      // dQ += dS K: K's rows are the reduction (MN-major)
      const uint32_t ka = k_addr + (kt % kDqStages) * L::kKV;
#pragma unroll
      for (int j = 0; j < kDqBK / 16; ++j)
        hp::Wgmma<D>::template rs<1>(acc, da[j], hp::desc_mnmajor(ka + j * 2048, kDqBK * 128), 1);
    };
    auto form_ds = [&](int kt) {
      // element i: row (i & 2 ? row1 : row0), key k0 + 8 (i / 4) + 2 (lane % 4) + i % 2
      const int k0 = kt * kDqBK;
      const bool masked = sb != nullptr || k0 + kDqBK > S || (causal && k0 + kDqBK - 1 > q0w);
#pragma unroll
      for (int i = 0; i < kDqBK / 2; ++i) {
        float p = hp::exp2_approx(s[i] * scale_log2 - ((i & 2) ? lse1 : lse0));
        if (masked) {
          const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          bool ok = key < S;
          if (causal) ok = ok && key <= ((i & 2) ? row1 : row0);
          if (sb != nullptr) ok = ok && sb[min(key, S - 1)] == ((i & 2) ? qs1 : qs0);
          p = ok ? p : 0.f;
        }
        s[i] = p * (dp[i] - ((i & 2) ? dl1 : dl0));  // dS
      }
    };
    auto pack = [&]() {
#pragma unroll
      for (int j = 0; j < kDqBK / 16; ++j) hp::pack_a(&s[8 * j], da[j]);
    };
    auto release = [&](int kt) {
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty[kt % kDqStages]);
    };

    hp::mbar_wait(q_full, 0);
    hp::mbar_wait(&full[0], 0);
    hp::wgmma_fence();
    issue_s(0);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_acc<kDqBK / 2>(s);
    hp::fence_acc<kDqBK / 2>(dp);
    form_ds(0);
    pack();
    for (int kt = 1; kt < kt_end; ++kt) {
      hp::mbar_wait(&full[kt % kDqStages], (kt / kDqStages) & 1);
      hp::wgmma_fence();
      issue_s(kt);
      hp::wgmma_commit();
      issue_dq(kt - 1);
      hp::wgmma_commit();
      hp::wgmma_wait<1>();  // S and dP have landed; the previous dS K may still run
      hp::fence_acc<kDqBK / 2>(s);
      hp::fence_acc<kDqBK / 2>(dp);
      form_ds(kt);
      hp::wgmma_wait<0>();  // the previous dS K is done: its stage and dS are free
      hp::fence_acc<D / 2>(acc);
      hp::fence_regs<kDqBK / 4>(&da[0][0]);
      release(kt - 1);
      pack();
    }
    hp::wgmma_fence();
    issue_dq(kt_end - 1);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_acc<D / 2>(acc);
    release(kt_end - 1);

    const size_t qs_row = (size_t)H * D;
    bf16* dqb = dq + (size_t)b * S * qs_row + (size_t)hq * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * (lane & 3);
      if (row0 < S)
        *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)row0 * qs_row + c) =
            __floats2bfloat162_rn(acc[4 * n] * scale, acc[4 * n + 1] * scale);
      if (row1 < S)
        *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)row1 * qs_row + c) =
            __floats2bfloat162_rn(acc[4 * n + 2] * scale, acc[4 * n + 3] * scale);
    }
  }
}

// -- dK / dV ------------------------------------------------------------------

constexpr int kKvBK = 64;    // keys a block: one consumer warpgroup
constexpr int kKvStages = 3;
constexpr int kKvThreads = 256;

template <int D>
struct DkvSmem {
  static constexpr int kBQ = D == 128 ? 32 : 64;  // queries a step
  static constexpr int kK = kKvBK * D * 2;         // K or V
  static constexpr int kQ = kBQ * D * 2;           // one Q or dO tile
  static constexpr int kVecs = 2 * kK + 2 * kKvStages * kQ;  // [stage][lse2, delta][kBQ] f32
  static constexpr int kBars = kVecs + kKvStages * 2 * kBQ * 4;
  static constexpr int kBytes = 1024 + kBars + 8 * (1 + 2 * kKvStages);
};

template <int D>
__global__ void __launch_bounds__(kKvThreads, 2)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                         const float* __restrict__ delta, const int* __restrict__ seg,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int Hkv,
                         int causal, float scale, float scale_log2) {
  using L = DkvSmem<D>;
  constexpr int BQ = L::kBQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (hp::smem_u32(smem_raw) & 1023u)) & 1023u);
  bf16* sK = reinterpret_cast<bf16*>(smem);                // [D / 64][kKvBK][64]
  bf16* sV = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* sQ = reinterpret_cast<bf16*>(smem + 2 * L::kK);    // [stage][D / 64][BQ][64]
  bf16* sO = sQ + kKvStages * BQ * D;                       // dO, the same
  float* vecs = reinterpret_cast<float*>(smem + L::kVecs);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kKvStages;

  const int k0 = blockIdx.x * kKvBK;  // heaviest causal tiles (small k0) first
  const int bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk % Hkv, rep = H / Hkv;
  const int n_qt = (S + BQ - 1) / BQ;
  const int qt_begin = causal ? k0 / BQ : 0;
  const int per_head = n_qt - qt_begin;
  const int steps = rep * per_head;
  const int tid = threadIdx.x;

  if (tid == 0) {
    hp::mbar_init(kv_full, 1);
    for (int s = 0; s < kKvStages; ++s) {
      hp::mbar_init(&full[s], 32);  // the producer warp's lanes (lse and delta) and the copies
      hp::mbar_init(&empty[s], 4);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    hp::reg_dealloc<24>();
    if (tid < 32) {
      const int lane = tid;
      if (lane == 0) {
        hp::mbar_arrive_expect_tx(kv_full, 2 * L::kK);
#pragma unroll
        for (int h = 0; h < D / 64; ++h) {
          hp::tma_load_4d(sK + h * kKvBK * 64, &tk, kv_full, h * 64, hk, k0, b);
          hp::tma_load_4d(sV + h * kKvBK * 64, &tv, kv_full, h * 64, hk, k0, b);
        }
      }
      for (int step = 0; step < steps; ++step) {
        const int hq = hk * rep + step / per_head;
        const int q0 = (qt_begin + step % per_head) * BQ;
        const int st = step % kKvStages;
        if (step >= kKvStages) hp::mbar_wait(&empty[st], ((step / kKvStages) - 1) & 1);
        float* lv = vecs + st * 2 * BQ;
        const size_t lrow = ((size_t)b * H + hq) * S;
        for (int c = lane; c < BQ; c += 32) {
          const bool in = q0 + c < S;
          lv[c] = in ? lse[lrow + q0 + c] * kLog2e : pos_inf();  // rows past S: P = 0
          lv[BQ + c] = in ? delta[lrow + q0 + c] : 0.f;
        }
        if (lane == 0) {
          hp::mbar_arrive_expect_tx(&full[st], 2 * L::kQ);
          bf16* qd = sQ + st * BQ * D;
          bf16* od = sO + st * BQ * D;
#pragma unroll
          for (int h = 0; h < D / 64; ++h) {
            hp::tma_load_4d(qd + h * BQ * 64, &tq, &full[st], h * 64, hq, q0, b);
            hp::tma_load_4d(od + h * BQ * 64, &tdo, &full[st], h * 64, hq, q0, b);
          }
        } else {
          hp::mbar_arrive(&full[st]);
        }
      }
    }
  } else {
    hp::reg_alloc<232>();
    const int t = tid - 128, warp = t >> 5, lane = t & 31;
    const int key0 = k0 + warp * 16 + (lane >> 2), key1 = key0 + 8;
    const int* sb = seg == nullptr ? nullptr : seg + (size_t)b * S;
    const int ks0 = sb != nullptr && key0 < S ? sb[key0] : 0;
    const int ks1 = sb != nullptr && key1 < S ? sb[key1] : 0;
    const uint32_t k_addr = hp::smem_u32(sK), v_addr = hp::smem_u32(sV);
    const uint32_t q_addr = hp::smem_u32(sQ), o_addr = hp::smem_u32(sO);

    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

    // Step j's S^T and dP^T are issued with step j - 1's dV and dK, and its
    // P^T and dS^T are formed while those run (first and last steps peeled)
    float sT[BQ / 2], dpT[BQ / 2];
    uint32_t pa[BQ / 16][4], sa[BQ / 16][4];  // P^T and dS^T of the previous step
    auto issue_s = [&](int step) {
      // S^T = K Q^T and dP^T = V dO^T: keys are the rows, queries the columns
      const int st = step % kKvStages;
      const uint32_t qa = q_addr + st * L::kQ, oa = o_addr + st * L::kQ;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        hp::Wgmma<BQ>::template ss<0>(
            sT, hp::desc_kmajor(k_addr + (kk >> 2) * (kKvBK * 128) + off),
            hp::desc_kmajor(qa + (kk >> 2) * (BQ * 128) + off), kk > 0 ? 1 : 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        hp::Wgmma<BQ>::template ss<0>(
            dpT, hp::desc_kmajor(v_addr + (kk >> 2) * (kKvBK * 128) + off),
            hp::desc_kmajor(oa + (kk >> 2) * (BQ * 128) + off), kk > 0 ? 1 : 0);
      }
    };
    auto issue_dkv = [&](int step) {
      // dV += P^T dO and dK += dS^T Q: queries are the reduction (MN-major)
      const int st = step % kKvStages;
      const uint32_t qa = q_addr + st * L::kQ, oa = o_addr + st * L::kQ;
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j)
        hp::Wgmma<D>::template rs<1>(dva, pa[j], hp::desc_mnmajor(oa + j * 2048, BQ * 128), 1);
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j)
        hp::Wgmma<D>::template rs<1>(dka, sa[j], hp::desc_mnmajor(qa + j * 2048, BQ * 128), 1);
    };
    auto form_ds = [&](int step) {
      // element i: key (i & 2 ? key1 : key0), query q0 + 8 (i / 4) + 2 (lane % 4) + i % 2
      const int q0 = (qt_begin + step % per_head) * BQ;
      const float* lv = vecs + (step % kKvStages) * 2 * BQ;
      const bool masked = sb != nullptr || (causal && q0 < k0 + kKvBK - 1);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int qc = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        float p = hp::exp2_approx(sT[i] * scale_log2 - lv[qc]);
        if (masked) {
          const int qrow = q0 + qc;
          bool ok = true;
          if (causal) ok = ((i & 2) ? key1 : key0) <= qrow;
          if (sb != nullptr) ok = ok && sb[min(qrow, S - 1)] == ((i & 2) ? ks1 : ks0);
          p = ok ? p : 0.f;
        }
        sT[i] = p;
        dpT[i] = p * (dpT[i] - lv[BQ + qc]);  // dS^T
      }
    };
    auto pack = [&]() {
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j) {
        hp::pack_a(&sT[8 * j], pa[j]);
        hp::pack_a(&dpT[8 * j], sa[j]);
      }
    };
    auto release = [&](int step) {
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty[step % kKvStages]);
    };

    hp::mbar_wait(kv_full, 0);
    hp::mbar_wait(&full[0], 0);
    hp::wgmma_fence();
    issue_s(0);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_acc<BQ / 2>(sT);
    hp::fence_acc<BQ / 2>(dpT);
    form_ds(0);
    pack();
    for (int step = 1; step < steps; ++step) {
      hp::mbar_wait(&full[step % kKvStages], (step / kKvStages) & 1);
      hp::wgmma_fence();
      issue_s(step);
      hp::wgmma_commit();
      issue_dkv(step - 1);
      hp::wgmma_commit();
      hp::wgmma_wait<1>();  // S^T and dP^T have landed; the previous dV, dK may still run
      hp::fence_acc<BQ / 2>(sT);
      hp::fence_acc<BQ / 2>(dpT);
      form_ds(step);
      hp::wgmma_wait<0>();  // the previous dV, dK are done: its stage and operands are free
      hp::fence_acc<D / 2>(dva);
      hp::fence_acc<D / 2>(dka);
      hp::fence_regs<BQ / 4>(&pa[0][0]);
      hp::fence_regs<BQ / 4>(&sa[0][0]);
      release(step - 1);
      pack();
    }
    hp::wgmma_fence();
    issue_dkv(steps - 1);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_acc<D / 2>(dva);
    hp::fence_acc<D / 2>(dka);
    release(steps - 1);

    const size_t kv_row = (size_t)Hkv * D;
    bf16* dkb = dk + (size_t)b * S * kv_row + (size_t)hk * D;
    bf16* dvb = dv + (size_t)b * S * kv_row + (size_t)hk * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * (lane & 3);
      if (key0 < S) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)key0 * kv_row + c) =
            __floats2bfloat162_rn(dka[4 * n] * scale, dka[4 * n + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)key0 * kv_row + c) =
            __floats2bfloat162_rn(dva[4 * n], dva[4 * n + 1]);
      }
      if (key1 < S) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)key1 * kv_row + c) =
            __floats2bfloat162_rn(dka[4 * n + 2] * scale, dka[4 * n + 3] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)key1 * kv_row + c) =
            __floats2bfloat162_rn(dva[4 * n + 2], dva[4 * n + 3]);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const void* lse, const void* seg, void* delta, void* dq, void* dk, void* dv, int B,
           int S, int H, int Hkv, int causal, float scale, cudaStream_t s) {
  constexpr int BQ = DkvSmem<D>::kBQ;
  CUtensorMap q_dq, o_dq, k_dq, v_dq, k_kv, v_kv, q_kv, o_kv;
  int err = hp::make_bshd_map(&q_dq, q, B, S, H, D, kDqBQ);
  if (err == 0) err = hp::make_bshd_map(&o_dq, dout, B, S, H, D, kDqBQ);
  if (err == 0) err = hp::make_bshd_map(&k_dq, k, B, S, Hkv, D, kDqBK);
  if (err == 0) err = hp::make_bshd_map(&v_dq, v, B, S, Hkv, D, kDqBK);
  if (err == 0) err = hp::make_bshd_map(&k_kv, k, B, S, Hkv, D, kKvBK);
  if (err == 0) err = hp::make_bshd_map(&v_kv, v, B, S, Hkv, D, kKvBK);
  if (err == 0) err = hp::make_bshd_map(&q_kv, q, B, S, H, D, BQ);
  if (err == 0) err = hp::make_bshd_map(&o_kv, dout, B, S, H, D, BQ);
  if (err != 0) return err;

  const int rows = B * S * H;
  const int warps = kDeltaThreads / 32;
  flash_bwd_delta_kernel<D><<<(rows + warps - 1) / warps, kDeltaThreads, 0, s>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), static_cast<float*>(delta),
      rows, S, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  constexpr int dq_smem = DqSmem<D>::kBytes;
  e = hp::allow_smem<flash_bwd_dq_kernel<D>>(dq_smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_q((S + kDqBQ - 1) / kDqBQ, B * H);
  flash_bwd_dq_kernel<D><<<grid_q, kDqThreads, dq_smem, s>>>(
      q_dq, o_dq, k_dq, v_dq, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(seg), static_cast<bf16*>(dq), S, H, Hkv, causal, scale,
      scale * kLog2e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  constexpr int kv_smem = DkvSmem<D>::kBytes;
  e = hp::allow_smem<flash_bwd_dkv_kernel<D>>(kv_smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_kv((S + kKvBK - 1) / kKvBK, B * Hkv);
  flash_bwd_dkv_kernel<D><<<grid_kv, kKvThreads, kv_smem, s>>>(
      k_kv, v_kv, q_kv, o_kv, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(seg), static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, Hkv,
      causal, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out, dout, dq: [B, S, H, D] bf16; k, v, dk, dv: [B, S, Hkv, D] bf16,
// H % Hkv == 0; lse: [B*H, S] f32 from the forward; delta: [B*H, S] f32
// scratch (written here); seg: [B, S] int32 or null; D in {64, 128}; every
// pointer 16-byte aligned (the TMA copies need it).
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
