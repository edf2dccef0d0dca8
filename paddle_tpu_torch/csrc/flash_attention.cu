// Flash-attention forward (online softmax), bf16 in and out, f32 logits,
// probabilities and accumulator, designed for the H100 (sm_90a).
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
// 1e-30; the output is cast to bf16 once. The TPU kernel multiplies f32
// probabilities by V; the tensor cores take bf16, so P enters P V as two
// bf16 terms (hi + lo, 16 significant bits), two register-A wgmma into one
// sum. (Rounding P to bf16 once, as the JAX package's composite does,
// failed the serving parity gate at Llama-3-8B's depth.) The exponentials
// are 2^x with log2(e) folded into the scale. Unlike the TPU kernel, S need
// not be a multiple of the tile: the copies fill rows past S with zeros,
// keys past S are masked and queries past S are not stored.
//
// Bound on the H100: operations (bf16 tensor cores, 4 * B * H * S^2 * D
// over two when causal) at the serving and training lengths. Design (the
// building blocks are csrc/hopper.cuh): one block of three warpgroups per
// (b*h, 128-query tile), the heaviest causal tiles first.
// - Warpgroup 0, the producer, gives up registers (setmaxnreg 24) and one
//   thread issues TMA copies: the Q tile once, then 128-key K and V tiles
//   into a ring of two stages, each stage signalled by a `full` mbarrier
//   (transaction bytes) and released by an `empty` one.
// - Warpgroups 1 and 2, the consumers, take 240 registers each and own 64
//   query rows. Per key tile: S = Q K^T is one wgmma chain from shared
//   memory (m64n128k16, Q and K K-major); the online softmax runs on the
//   accumulator registers; P is split into bf16 hi + lo in registers and
//   O += P V is two register-A wgmma (m64nDk16) with V read MN-major
//   through its descriptor, so no tile is transposed.
// - Causal: tiles past the diagonal are never loaded; only tiles that cross
//   it (or hold keys past S, or with segment ids) are masked per element.
// ptxas gives the launch 168 registers a thread (384 threads, one block an
// SM); the split after setmaxnreg is 24 (producer) and 240 (consumers):
// 24 x 128 + 240 x 256 = 168 x 384.
#include "hopper.cuh"

using ptt::bf16;
namespace hp = ptt::hopper;

namespace {

constexpr int kBQ = 128;      // query rows a block: two consumer warpgroups of 64
constexpr int kBK = 128;      // keys a tile
constexpr int kStages = 2;    // K/V tiles in flight
constexpr int kThreads = 384;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// dynamic shared memory: 1024 bytes of alignment slack, the Q tile, the K
// and V rings, the barriers
template <int D>
struct FwdSmem {
  static constexpr int kQ = kBQ * D * 2;
  static constexpr int kKV = kBK * D * 2;  // one K or V tile
  static constexpr int kBars = kQ + 2 * kStages * kKV;
  static constexpr int kBytes = 1024 + kBars + 8 * (1 + 2 * kStages);
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const int* __restrict__ seg,
                           bf16* __restrict__ out, float* __restrict__ lse, int S, int H, int Hkv,
                           int causal, float scale_log2) {
  using L = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (hp::smem_u32(smem_raw) & 1023u)) & 1023u);
  bf16* sQ = reinterpret_cast<bf16*>(smem);             // [D / 64][kBQ][64]
  bf16* sK = reinterpret_cast<bf16*>(smem + L::kQ);      // [stage][D / 64][kBK][64]
  bf16* sV = sK + kStages * kBK * D;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, hq = bh % H, hk = hq / (H / Hkv);
  const int q0 = qt * kBQ;
  const int n_kt = (S + kBK - 1) / kBK;
  const int kt_end = causal ? min(n_kt, (q0 + kBQ - 1) / kBK + 1) : n_kt;
  const int tid = threadIdx.x;

  if (tid == 0) {
    hp::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // producer warpgroup: one thread issues every copy
    hp::reg_dealloc<24>();
    if (tid == 0) {
      hp::mbar_arrive_expect_tx(q_full, L::kQ);
#pragma unroll
      for (int h = 0; h < D / 64; ++h)
        hp::tma_load_4d(sQ + h * kBQ * 64, &tq, q_full, h * 64, hq, q0, b);
      for (int kt = 0; kt < kt_end; ++kt) {
        const int st = kt % kStages;
        if (kt >= kStages) hp::mbar_wait(&empty[st], ((kt / kStages) - 1) & 1);
        hp::mbar_arrive_expect_tx(&full[st], 2 * L::kKV);
        bf16* kd = sK + st * kBK * D;
        bf16* vd = sV + st * kBK * D;
#pragma unroll
        for (int h = 0; h < D / 64; ++h) {
          hp::tma_load_4d(kd + h * kBK * 64, &tk, &full[st], h * 64, hk, kt * kBK, b);
          hp::tma_load_4d(vd + h * kBK * 64, &tv, &full[st], h * 64, hk, kt * kBK, b);
        }
      }
    }
  } else {
    // consumer warpgroups: 64 query rows each
    hp::reg_alloc<240>();
    const int cw = (tid >> 7) - 1;
    const int t = tid & 127, warp = t >> 5, lane = t & 31;
    const int q0w = q0 + cw * 64;
    const int row0 = q0w + warp * 16 + (lane >> 2), row1 = row0 + 8;
    const int* sb = seg == nullptr ? nullptr : seg + (size_t)b * S;
    const int qs0 = sb != nullptr && row0 < S ? sb[row0] : 0;
    const int qs1 = sb != nullptr && row1 < S ? sb[row1] : 0;
    const uint32_t q_addr = hp::smem_u32(sQ) + cw * 64 * 128;
    const uint32_t k_addr = hp::smem_u32(sK), v_addr = hp::smem_u32(sV);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    hp::mbar_wait(q_full, 0);
    for (int kt = 0; kt < kt_end; ++kt) {
      const int st = kt % kStages;
      const int k0 = kt * kBK;
      const uint32_t ka = k_addr + st * L::kKV, va = v_addr + st * L::kKV;
      hp::mbar_wait(&full[st], (kt / kStages) & 1);

      // S = Q K^T: D / 16 k-steps, each 32 bytes along a 128-byte row
      float s[kBK / 2];
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        hp::Wgmma<kBK>::template ss<0>(
            s, hp::desc_kmajor(q_addr + (kk >> 2) * (kBQ * 128) + off),
            hp::desc_kmajor(ka + (kk >> 2) * (kBK * 128) + off), kk > 0 ? 1 : 0);
      }
      hp::wgmma_commit();
      hp::fence_acc<kBK / 2>(s);
      hp::wgmma_wait<0>();
      hp::fence_acc<kBK / 2>(s);

      // scale (log2 units) and mask; element i: row (i & 2 ? row1 : row0),
      // key k0 + 8 (i / 4) + 2 (lane % 4) + i % 2
      const bool masked =
          sb != nullptr || k0 + kBK > S || (causal && k0 + kBK - 1 > q0w);
      if (masked) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          bool ok = key < S;
          if (causal) ok = ok && key <= ((i & 2) ? row1 : row0);
          if (sb != nullptr) ok = ok && sb[min(key, S - 1)] == ((i & 2) ? qs1 : qs0);
          s[i] = ok ? s[i] * scale_log2 : kNegInf;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) s[i] *= scale_log2;
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        if (i & 2) mx1 = fmaxf(mx1, s[i]);
        else mx0 = fmaxf(mx0, s[i]);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // a row that has seen no visible key keeps every probability at 0
      const float ref0 = mx0 == kNegInf ? 0.f : mx0, ref1 = mx1 == kNegInf ? 0.f : mx1;
      const float a0 = hp::exp2_approx(m0 - mx0), a1 = hp::exp2_approx(m1 - mx1);
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const float p = hp::exp2_approx(s[i] - ((i & 2) ? ref1 : ref0));
        s[i] = p;
        if (i & 2) ls1 += p;
        else ls0 += p;
      }
      l0 = a0 * l0 + ls0;  // per-thread partial sums; the quad adds them at the end
      l1 = a1 * l1 + ls1;
      m0 = mx0;
      m1 = mx1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? a1 : a0;

      // O += P V: P from registers as hi + lo (two bf16 terms), V's rows
      // are the reduction (MN-major)
      uint32_t ph[kBK / 16][4], pl[kBK / 16][4];
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) hp::pack_a_split(&s[8 * j], ph[j], pl[j]);
      hp::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        const uint64_t dv = hp::desc_mnmajor(va + j * 2048, kBK * 128);
        hp::Wgmma<D>::template rs<1>(o, ph[j], dv, 1);
        hp::Wgmma<D>::template rs<1>(o, pl[j], dv, 1);
      }
      hp::wgmma_commit();
      hp::fence_acc<D / 2>(o);
      hp::wgmma_wait<0>();
      hp::fence_acc<D / 2>(o);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty[st]);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const size_t qs_row = (size_t)H * D;
    bf16* ob = out + (size_t)b * S * qs_row + (size_t)hq * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * (lane & 3);
      if (row0 < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * qs_row + c) =
            __floats2bfloat162_rn(o[4 * n] / d0, o[4 * n + 1] / d0);
      if (row1 < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * qs_row + c) =
            __floats2bfloat162_rn(o[4 * n + 2] / d1, o[4 * n + 3] / d1);
    }
    if (lse != nullptr && (lane & 3) == 0) {
      if (row0 < S) lse[(size_t)bh * S + row0] = m0 * kLn2 + logf(d0);
      if (row1 < S) lse[(size_t)bh * S + row1] = m1 * kLn2 + logf(d1);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* seg, void* out, void* lse,
           int B, int S, int H, int Hkv, int causal, float scale, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  int err = hp::make_bshd_map(&tq, q, B, S, H, D, kBQ);
  if (err == 0) err = hp::make_bshd_map(&tk, k, B, S, Hkv, D, kBK);
  if (err == 0) err = hp::make_bshd_map(&tv, v, B, S, Hkv, D, kBK);
  if (err != 0) return err;
  constexpr int smem = FwdSmem<D>::kBytes;
  const cudaError_t attr = hp::allow_smem<flash_attention_kernel<D>>(smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<D><<<grid, kThreads, smem, s>>>(
      tq, tk, tv, static_cast<const int*>(seg), static_cast<bf16*>(out),
      static_cast<float*>(lse), S, H, Hkv, causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: [B, S, H, D] bf16; k, v: [B, S, Hkv, D] bf16, H % Hkv == 0;
// seg: [B, S] int32 or null; lse: [B*H, S] f32 or null; D in {64, 128};
// every pointer 16-byte aligned (the TMA copies need it).
PTT_EXPORT int ptt_flash_attention(const void* q, const void* k, const void* v, const void* seg,
                                   void* out, void* lse, int B, int S, int H, int Hkv, int D,
                                   int causal, float scale, void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(q, k, v, seg, out, lse, B, S, H, Hkv, causal, scale, s);
  if (D == 128) return launch<128>(q, k, v, seg, out, lse, B, S, H, Hkv, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
