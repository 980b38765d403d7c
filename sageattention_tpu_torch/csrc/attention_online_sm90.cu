// The online forward on a fused Q, redesigned for Hopper: B5-fp8-fusedq
// (`sageattn(pv_dtype="fp8")`: an e4m3 P and e4m3 V, the reference's fp8-PV
// mode), B2 (`sageattn`'s online rerun when the static cap underflows: a
// bf16 P over the int8 V codes) and the fused-Q B-pvbf16-online (the rerun
// of `sageattn(pv_dtype="bf16")`: a bf16 P over the caller's bf16 V), on
// attention_q8_sm90.cu's online loop behind attention_sm90.cu's Q step.
//
// Replaces the Pallas kernel `_attn_kernel` (sageattention_tpu/ops/
// attention.py:251, launched by `attention_call`, pl.pallas_call at :1067)
// in its fuse_q_quant, fold_k_scale, online-softmax configurations (the
// bf16 P branch :545-556, the e4m3 P branch :569-585, the epilogue
// :663-677) with a bf16 Q at head dims 64 and 128, a bf16 output and no
// mask, window, segments or per-column K scales; every other configuration
// of those bases stays on attention.cuh's body.  What it computes, as the
// plain version (ops/attention.py `attention_plain`):
//   qf = q * fold (fold = sm_scale * log2(e)); per row, qs = amax|qf| / 127
//   (1 for a zero row), q8 = clip(rint(qf * (1 / qs)), -127, 127) and qse =
//   qs * k_head_scale[head]; s = float(q8 . k8) * qse, the kv tail past
//   kv_len and, under causal, col > row masked.  Over 64-column kv tiles
//   (the plain version's KV_TILE) a running max m floored at M_CLAMP, alpha
//   = exp2(m - m') rescaling O and l; bf16 P: p = exp2(s - m'), l summing
//   the unrounded p, O += bf16(p) V with f32 sums; e4m3 P: P = e4m3(exp2((s
//   - m') + log2 448)), l summing those codes, O = O * alpha + (P V over the
//   tile, in f32) with V the e4m3 codes.  out = O * (1 / l) * v_scale[c] +
//   v_mean[c] (the bf16 V form: O * (1 / l)) in bf16, and the base-2 lse m +
//   log2(l) (e4m3: less log2 448).
//
// What bounds it on the H100: the tensor cores (2 S^2 D int8 operations for
// QK^T at 1979 TOP/s, 2 S^2 D for PV at 989 TFLOP/s in bf16 or 1979 in
// e4m3) and, at D = 64, the exp2 of the softmax on the SFUs.  The design:
//   Q         attention_sm90.cu's: one TMA load of the bf16 tile; each warp
//             quantizes its 16 rows into an int8 region in the swizzled
//             K-major layout its warpgroup's descriptor reads, keeping qse
//             only (the online forms need no code norm and no cap: kn_max
//             is not an input).
//   the loop  attention_q8_sm90.cu's online form: int8 wgmma m64n64k32 for
//             S over 64-column kv tiles, a ring of 4 K/V stages refilled by
//             the last warp done with one, the softmax of one tile under
//             the PV product of the one before, warpgroups taking turns;
//             three warpgroups at D = 64 (192 rows), two at D = 128.
//   V         bf16 P: bf16 rows by TMA (B2: the int8 codes widened once per
//             call by the wrapper, `widen_v_codes`; the bf16 V form: the
//             caller's V), an MN-major B operand of a bf16 wgmma from P in
//             registers.  e4m3 P: the wrapper's V^T (`transpose_v_codes`),
//             an e4m3 wgmma m64nDk32 from P registers into a fresh f32
//             accumulator added into O (two-level accumulation), P packed
//             after the previous product's wait through an XOR with a zero
//             the compiler cannot fold.
#include <stdio.h>

#include "sm90.cuh"

namespace onl90 {

using namespace sm90;

constexpr float M_CLAMP = -1e20f;  // floor of the running max
constexpr float FP8_OFFSET_LOG2 = 8.807354922057604f;  // log2(448): e4m3 P fills its range

// The C entry's modes: B2 (bf16 P, int8 V codes widened to bf16, v_scale
// and v_mean), B5-fp8-fusedq (e4m3 P and V) and B-pvbf16-online (bf16 P
// over the caller's bf16 V, no scale, no mean).
enum Mode { B2 = 0, FP8 = 1, PVBF16 = 2 };

template <int D, bool F8>
struct Cfg {
  static constexpr int NWG = D == 64 ? 3 : 2;  // warpgroups, 64 query rows each
  static constexpr int BM = 64 * NWG;          // query rows per block
  static constexpr int THREADS = 128 * NWG;
  static constexpr int BN = 64;                // kv rows per tile
  static constexpr int STAGES = 4;
  static constexpr int CH = D / 64;            // 128-byte bf16 column boxes per row
  static constexpr int QB_BYTES = BM * D * 2;  // the bf16 Q tile
  static constexpr int Q8_BYTES = BM * D;      // its int8 codes
  static constexpr int K_BYTES = BN * D;       // one int8 K stage
  // one V stage: bf16 rows of D, or F8 the e4m3 V^T, D rows of BN bytes
  static constexpr int V_BYTES = F8 ? D * BN : BN * D * 2;
  static constexpr int SMEM = QB_BYTES + Q8_BYTES + STAGES * (K_BYTES + V_BYTES) + 1024;
};

struct Params {
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_ss;
  const float* k_head_scale;  // [B*Hk]
  const float* v_scale;       // [B*Hk*D], or null (the bf16 V form)
  const float* v_mean;        // [B*Hk*D], or null
  float* lse;                 // [B*Hq*Sq] base 2, or null
  int Hq, Hk, Sq, kv_len, causal;
  float fold;                 // sm_scale * log2(e)
};

// The byte of row r (of a 64-row warpgroup region), column k of the int8 Q
// codes in the swizzled K-major layout: 128-byte rows, chunk (k / 16) ^ (r %
// 8) at D = 128; 64-byte rows, chunk (k / 16) ^ ((r / 2) % 4) at D = 64.
template <int D>
__device__ __forceinline__ int q8_offset(int r, int k) {
  if constexpr (D == 128) return r * 128 + ((((k >> 4) ^ (r & 7))) << 4) + (k & 15);
  return r * 64 + ((((k >> 4) ^ ((r >> 1) & 3))) << 4) + (k & 15);
}

template <int D>
__device__ __forceinline__ uint64_t kdesc(uint32_t lo) {
  if constexpr (D == 128) return desc(lo);
  return desc64(lo);
}

// S = Q8 K8^T for one warpgroup: D/32 k32 steps of 32 bytes along the rows.
template <int D, int BN>
__device__ __forceinline__ void qk_issue(int (&si)[BN / 2], uint32_t qlo, uint32_t klo) {
#pragma unroll
  for (int ks = 0; ks < D / 32; ++ks)
    wgmma_s8(si, kdesc<D>(qlo + ks * 2), kdesc<D>(klo + ks * 2), ks > 0);
  wg_commit();
}

// O += P V: BN/16 k16 steps, A (P) from registers, B (the V stage)
// MN-major from shared memory.
template <int D, int BN>
__device__ __forceinline__ void pv_issue(float (&o)[D / 2], const uint32_t (&pf)[BN / 16][4],
                                         uint32_t vlo) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs(o, pf[kk], desc(vlo + kk * (16 * 128 / 16)), 1);
  wg_commit();
}

// The e4m3 PV product of one tile into a fresh f32 accumulator t (the
// caller adds it into O): BN/32 k32 steps, A (the e4m3 P) from registers,
// B (the stage's e4m3 V^T, D rows of BN bytes, 64-byte swizzled) K-major.
template <int D, int BN>
__device__ __forceinline__ void pv_issue_f8(float (&t)[D / 2], const uint32_t (&pf)[BN / 32][4],
                                            uint32_t vlo) {
#pragma unroll
  for (int kk = 0; kk < BN / 32; ++kk) wgmma_f8(t, pf[kk], desc64(vlo + kk * 2), kk > 0);
  wg_commit();
}

// The scores of one S tile whose first column is k0: s = float(s32) * qse,
// -inf where col >= kv_len or, causal, col > row (rA, rB; row0 the
// warpgroup's first).  A thread holds rows rA and rA + 8 and, of
// accumulator element i, column 8 (i / 4) + 2 (lane % 4) + i % 2 (+8 rows
// for i % 4 >= 2).
template <int BN>
__device__ __forceinline__ void scores(const int (&si)[BN / 2], float (&sc)[BN / 2], int k0,
                                       int kv_len, int causal, int row0, int rA, int rB, int q4,
                                       float qA, float qB) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    sc[4 * j] = __fmul_rn((float)si[4 * j], qA);
    sc[4 * j + 1] = __fmul_rn((float)si[4 * j + 1], qA);
    sc[4 * j + 2] = __fmul_rn((float)si[4 * j + 2], qB);
    sc[4 * j + 3] = __fmul_rn((float)si[4 * j + 3], qB);
  }
  if (k0 + BN > kv_len || (causal && k0 + BN - 1 > row0)) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * q4 + (e & 1);
        if (col >= kv_len || (causal && col > (e < 2 ? rA : rB))) sc[4 * j + e] = -INFINITY;
      }
  }
}

// The running maxima of one tile's scores (the 4 lanes of a quad share a
// row), floored at M_CLAMP, and their alphas.
template <int BN>
__device__ __forceinline__ void new_max(const float (&sc)[BN / 2], float& mA, float& mB,
                                        float& aA, float& aB) {
  float xA = -INFINITY, xB = -INFINITY;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    xA = fmaxf(xA, fmaxf(sc[4 * j], sc[4 * j + 1]));
    xB = fmaxf(xB, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, 1));
  xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, 2));
  xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, 1));
  xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, 2));
  const float nA = fmaxf(fmaxf(mA, xA), M_CLAMP), nB = fmaxf(fmaxf(mB, xB), M_CLAMP);
  aA = ex2(__fsub_rn(mA, nA));
  aB = ex2(__fsub_rn(mB, nB));
  mA = nA;
  mB = nB;
}

// The bf16-P online softmax of one tile, in place: P = exp2(s - m') in f32
// (in the bits of the s32 sums) and l = alpha l + the sum of that unrounded P.
template <int BN>
__device__ __forceinline__ void softmax_online(int (&si)[BN / 2], int k0, int kv_len, int causal,
                                               int row0, int rA, int rB, int q4, float qA,
                                               float qB, float& mA, float& mB, float& lA,
                                               float& lB, float& aA, float& aB) {
  float sc[BN / 2];
  scores<BN>(si, sc, k0, kv_len, causal, row0, rA, rB, q4, qA, qB);
  new_max<BN>(sc, mA, mB, aA, aB);
  float sA = 0.f, sB = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    sc[4 * j] = ex2(__fsub_rn(sc[4 * j], mA));
    sc[4 * j + 1] = ex2(__fsub_rn(sc[4 * j + 1], mA));
    sc[4 * j + 2] = ex2(__fsub_rn(sc[4 * j + 2], mB));
    sc[4 * j + 3] = ex2(__fsub_rn(sc[4 * j + 3], mB));
    sA += sc[4 * j] + sc[4 * j + 1];
    sB += sc[4 * j + 2] + sc[4 * j + 3];
  }
  lA = __fadd_rn(__fmul_rn(aA, lA), sA);
  lB = __fadd_rn(__fmul_rn(aB, lB), sB);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) si[i] = __float_as_int(sc[i]);
}

// Four f32 P as one register of e4m3 codes, byte i from x_i (round to
// nearest even, saturating at 448).
__device__ __forceinline__ uint32_t e4m3x4(float x0, float x1, float x2, float x3) {
  uint32_t w;
  asm("{\n.reg .b16 lo, hi;\n"
      "cvt.rn.satfinite.e4m3x2.f32 lo, %2, %1;\n"
      "cvt.rn.satfinite.e4m3x2.f32 hi, %4, %3;\n"
      "mov.b32 %0, {lo, hi};\n}\n"
      : "=r"(w)
      : "f"(x0), "f"(x1), "f"(x2), "f"(x3));
  return w;
}

// The sum of the four e4m3 values in w, times 2^-120 (a code's bits but the
// sign, shifted into an f32's exponent and top mantissa bits; exact).
__device__ __forceinline__ float e4m3x4_sum_2m120(uint32_t w) {
  const float a = __uint_as_float((w << 20) & 0x07F00000u);
  const float b = __uint_as_float((w << 12) & 0x07F00000u);
  const float c = __uint_as_float((w << 4) & 0x07F00000u);
  const float d = __uint_as_float((w >> 4) & 0x07F00000u);
  return __fadd_rn(__fadd_rn(a, b), __fadd_rn(c, d));
}

// The e4m3 online softmax of one tile: P = e4m3(exp2((s - m') + log2 448)),
// packed into si[0 .. BN/4) in the A fragments' order (register 2 (h % 2)
// (+1 for row B) of k32 step h / 2 holds this thread's columns {2 q4, 2 q4
// + 1, 8 + 2 q4, 9 + 2 q4} of 16 h .., the order `transpose_v_codes` gives
// V^T), and l = alpha l + the sum of those codes' values.
template <int BN>
__device__ __forceinline__ void softmax_fp8(int (&si)[BN / 2], int k0, int kv_len, int causal,
                                            int row0, int rA, int rB, int q4, float qA, float qB,
                                            float& mA, float& mB, float& lA, float& lB,
                                            float& aA, float& aB) {
  float sc[BN / 2];
  scores<BN>(si, sc, k0, kv_len, causal, row0, rA, rB, q4, qA, qB);
  new_max<BN>(sc, mA, mB, aA, aB);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    sc[4 * j] = ex2(__fadd_rn(__fsub_rn(sc[4 * j], mA), FP8_OFFSET_LOG2));
    sc[4 * j + 1] = ex2(__fadd_rn(__fsub_rn(sc[4 * j + 1], mA), FP8_OFFSET_LOG2));
    sc[4 * j + 2] = ex2(__fadd_rn(__fsub_rn(sc[4 * j + 2], mB), FP8_OFFSET_LOG2));
    sc[4 * j + 3] = ex2(__fadd_rn(__fsub_rn(sc[4 * j + 3], mB), FP8_OFFSET_LOG2));
  }
  float sA = 0.f, sB = 0.f;
#pragma unroll
  for (int h = 0; h < BN / 16; ++h) {
    const int j = 2 * h;
    const uint32_t wa = e4m3x4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 4], sc[4 * j + 5]);
    const uint32_t wb = e4m3x4(sc[4 * j + 2], sc[4 * j + 3], sc[4 * j + 6], sc[4 * j + 7]);
    sA = __fadd_rn(sA, e4m3x4_sum_2m120(wa));
    sB = __fadd_rn(sB, e4m3x4_sum_2m120(wb));
    si[4 * (h >> 1) + 2 * (h & 1)] = (int)wa;
    si[4 * (h >> 1) + 2 * (h & 1) + 1] = (int)wb;
  }
  lA = __fadd_rn(__fmul_rn(aA, lA), __fmul_rn(sA, 0x1p120f));
  lB = __fadd_rn(__fmul_rn(aB, lB), __fmul_rn(sB, 0x1p120f));
}

// P in bf16, packed straight into the A fragments of the PV product: k16
// step kk takes the tile's columns 16 kk .. 16 kk + 15.
template <int BN>
__device__ __forceinline__ void pack_p(const int (&si)[BN / 2], uint32_t (&pf)[BN / 16][4]) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    pf[j >> 1][(j & 1) * 2] = pack_bf16(__int_as_float(si[4 * j]), __int_as_float(si[4 * j + 1]));
    pf[j >> 1][(j & 1) * 2 + 1] =
        pack_bf16(__int_as_float(si[4 * j + 2]), __int_as_float(si[4 * j + 3]));
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], float aA, float aB) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] = __fmul_rn(o[4 * j], aA);
    o[4 * j + 1] = __fmul_rn(o[4 * j + 1], aA);
    o[4 * j + 2] = __fmul_rn(o[4 * j + 2], aB);
    o[4 * j + 3] = __fmul_rn(o[4 * j + 3], aB);
  }
}

// Grid (ceil(Sq / BM), Hq, B), Cfg<D, MODE == FP8>::THREADS threads.
template <int D, int MODE>
__global__ void __launch_bounds__(Cfg<D, MODE == FP8>::THREADS, 1)
    attn_online_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, const Params p) {
  constexpr bool F8 = MODE == FP8, VB = MODE == PVBF16;
  using C = Cfg<D, F8>;
  constexpr int BM = C::BM, BN = C::BN, CH = C::CH, STAGES = C::STAGES, NWG = C::NWG;
  constexpr int E = D / 32;  // Q columns per lane in the quantization
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // q full, then per stage: k full, v full
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  __shared__ int freed[STAGES];  // per stage: warps done with its tile
  __shared__ float s_qse[BM];
  const uint32_t sQb = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle wants 1 KB
  const uint32_t sQ8 = sQb + C::QB_BYTES;          // warpgroup w's codes at + w * 64 * D
  const uint32_t sK = sQ8 + C::Q8_BYTES;           // stage s at sK + s * K_BYTES
  const uint32_t sV = sK + STAGES * C::K_BYTES;    // stage s at sV + s * V_BYTES
  uint8_t* const gQb = smem_raw + (sQb - smem_u32(smem_raw));  // generic pointers
  uint8_t* const gQ8 = gQb + C::QB_BYTES;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_k = smem_u32(&bars[1]);       // stage s at + 8 * s
  const uint32_t bar_v = smem_u32(&bars[1 + STAGES]);

  const int n_qt = (p.Sq + BM - 1) / BM;
  // causal: the longest q tiles first, so the tail of the grid is short work
  const int qt = p.causal ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (p.Hq / p.Hk);
  const int q0 = qt * BM;
  int n_kt = (p.kv_len + BN - 1) / BN;
  if (p.causal) n_kt = min(n_kt, (min(q0 + BM, p.Sq) - 1) / BN + 1);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // K (one box of D bytes) and V (CH boxes of 64 bf16 columns, or F8 one box
  // of V^T's BN bytes x D rows) of tile kt into stage kt % STAGES, each
  // completing on its full barrier
  auto load_tile = [&](int kt) {
    const int s = kt % STAGES;
    mbar_expect_tx(bar_k + 8 * s, C::K_BYTES);
    tma_load4(sK + s * C::K_BYTES, &tm_k, bar_k + 8 * s, 0, kt * BN, hk, b);
    mbar_expect_tx(bar_v + 8 * s, C::V_BYTES);
    if constexpr (F8) {
      tma_load4(sV + s * C::V_BYTES, &tm_v, bar_v + 8 * s, kt * BN, 0, hk, b);
    } else {
#pragma unroll
      for (int c = 0; c < CH; ++c)
        tma_load4(sV + s * C::V_BYTES + c * (BN * 128), &tm_v, bar_v + 8 * s, c * 64, kt * BN,
                  hk, b);
    }
  };
  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      freed[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, C::QB_BYTES);
#pragma unroll
    for (int c = 0; c < CH; ++c) tma_load4(sQb + c * (BM * 128), &tm_q, bar_q, c * 64, q0, hq, b);
    for (int kt = 0; kt < min(n_kt, STAGES); ++kt) load_tile(kt);
  }
  __syncthreads();

  // ---------------- Q: int8 codes and row scales (no cap) ----------------
  mbar_wait(bar_q, 0);
  {
    const float ksh = p.k_head_scale[b * p.Hk + hk];
    const int k = lane * E;  // this lane's first column
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;  // the block's row; rows past Sq are zero-filled
      // bf16 column k of row r in the 128-byte swizzled 64-column box k / 64
      const int kc = k & 63;
      const uint8_t* src = gQb + (k >> 6) * (BM * 128) + r * 128 +
                           ((((kc >> 3) ^ (r & 7))) << 4) + (kc & 7) * 2;
      float qf[E], a = 0.f;
#pragma unroll
      for (int i = 0; i < E; i += 2) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + 2 * i));
        qf[i] = __fmul_rn(f.x, p.fold);
        qf[i + 1] = __fmul_rn(f.y, p.fold);
        a = fmaxf(a, fmaxf(fabsf(qf[i]), fabsf(qf[i + 1])));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
      const float qs = a > 0.f ? __fmul_rn(a, (float)(1.0 / 127.0)) : 1.f;
      const float inv = __fdiv_rn(1.f, qs);
      uint32_t packed = 0;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const float c = fminf(fmaxf(rintf(__fmul_rn(qf[i], inv)), -127.f), 127.f);
        packed |= (uint32_t)(uint8_t)(int8_t)c << (8 * i);
      }
      uint8_t* dst = gQ8 + (r >> 6) * (64 * D) + q8_offset<D>(r & 63, k);
      if constexpr (E == 4) *reinterpret_cast<uint32_t*>(dst) = packed;
      else *reinterpret_cast<uint16_t*>(dst) = (uint16_t)packed;
      if (lane == 0) s_qse[r] = __fmul_rn(qs, ksh);
    }
    fence_async_smem();  // the codes are read by wgmma (the async proxy)
  }
  __syncthreads();

  const int cw = tid / 128;  // the warpgroup: 64 query rows each
  const int q4 = lane & 3;
  const int row0 = q0 + 64 * cw;
  const int lA = 64 * cw + 16 * (warp & 3) + (lane >> 2);  // this thread's rows, in the block
  const int rA = q0 + lA, rB = rA + 8;
  const float qA = s_qse[lA], qB = s_qse[lA + 8];
  // the warpgroups take turns, in order, to issue their products (named
  // barrier 1 + w is warpgroup w's turn, handed over by w - 1 after
  // issuing); every warpgroup walks all n_kt tiles, so all take n_kt + 1
  // turns, and a block with no tile takes none
  auto take_turn = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory"); };
  auto hand_over = [&]() {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (cw + 1) % NWG) : "memory");
  };
  if (cw == NWG - 1 && n_kt > 0) hand_over();  // warpgroup 0 goes first
  const uint32_t q_lo = desc_lo(sQ8 + cw * (64 * D), 16);
  // this warp is done with tile kt's stage: the last of the block's warps
  // to say so refills it with tile kt + STAGES
  auto release = [&](int kt) {
    __syncwarp();
    if (lane == 0) {
      const int s = kt % STAGES;
      __threadfence_block();
      if (atomicAdd(&freed[s], 1) == 4 * NWG - 1) {
        freed[s] = 0;
        __threadfence_block();
        if (kt + STAGES < n_kt) load_tile(kt + STAGES);
      }
    }
  };
  float mA = M_CLAMP, mB = M_CLAMP, lsA = 0.f, lsB = 0.f, aA = 1.f, aB = 1.f;
  // the softmax of tile kt, in place
  auto softmax = [&](int (&si)[BN / 2], int kt) {
    if constexpr (F8)
      softmax_fp8<BN>(si, kt * BN, p.kv_len, p.causal, row0, rA, rB, q4, qA, qB, mA, mB, lsA,
                      lsB, aA, aB);
    else
      softmax_online<BN>(si, kt * BN, p.kv_len, p.causal, row0, rA, rB, q4, qA, qB, mA, mB, lsA,
                         lsB, aA, aB);
  };
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // F8: the PV product of one tile, added into O in f32 once it completes
  // (two-level accumulation: the tensor cores keep fewer bits of an fp8 sum)
  float t[F8 ? D / 2 : 1];
#pragma unroll
  for (int i = 0; i < (F8 ? D / 2 : 1); ++i) t[i] = 0.f;
  uint32_t pf[F8 ? BN / 32 : BN / 16][4];  // P of the tile whose PV product is next
  // P (kt) into the A fragments, once the product of P(kt - 1) has read them
  // F8: the codes move into pf through an operation with a zero the
  // compiler cannot fold (Sq >= 0): given a plain copy, ptxas let pf and
  // the softmax's words share registers, and serialized every wgmma
  const uint32_t zero = (uint32_t)p.Sq >> 31;
  auto pack = [&](const int (&si)[BN / 2]) {
    if constexpr (F8) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) pf[i >> 2][i & 3] = (uint32_t)si[i] ^ zero;
    } else {
      pack_p<BN>(si, pf);
    }
  };
  // O += P(kt - 1) V(kt - 1) on stage s (F8: into t), issued
  auto pv = [&](int s) {
    if constexpr (F8)
      pv_issue_f8<D, BN>(t, pf, opaque(desc_lo(sV + s * C::V_BYTES, 16)));
    else
      pv_issue<D, BN>(o, pf, opaque(desc_lo(sV + s * C::V_BYTES, BN * 128)));
  };
  // F8: the completed tile's product into O
  auto add_t = [&]() {
    if constexpr (F8) {
      reg_fence(t);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = __fadd_rn(o[i], t[i]);
    }
  };

  if (n_kt > 0) {  // tile 0: S, then its softmax
    int si[BN / 2];
    mbar_wait(bar_k, 0);
    take_turn();
    wg_fence();
    qk_issue<D, BN>(si, opaque(q_lo), opaque(desc_lo(sK, 16)));
    hand_over();
    wg_wait<0>();
    reg_fence(si);
    softmax(si, 0);
    pack(si);
  }
  // tile kt: S(kt) and O += P(kt-1) V(kt-1) in flight together; the
  // softmax of S(kt) runs under the PV product, then (F8) the product is
  // added into O, O takes alpha(kt), and P(kt) is packed only once the
  // product has read P(kt-1)
  for (int kt = 1; kt < n_kt; ++kt) {
    const int s = kt % STAGES, ps = (kt - 1) % STAGES;
    int si[BN / 2];
    mbar_wait(bar_k + 8 * s, (kt / STAGES) & 1);
    mbar_wait(bar_v + 8 * ps, ((kt - 1) / STAGES) & 1);
    reg_fence(o);
    reg_fence_u(pf);
    take_turn();
    wg_fence();
    qk_issue<D, BN>(si, opaque(q_lo), opaque(desc_lo(sK + s * C::K_BYTES, 16)));
    wg_fence();
    pv(ps);
    hand_over();
    wg_wait<1>();
    reg_fence(si);
    softmax(si, kt);
    wg_wait<0>();
    reg_fence(o);
    reg_fence_u(pf);
    reg_fence(si);
    release(kt - 1);
    add_t();
    rescale<D>(o, aA, aB);
    pack(si);
  }
  if (n_kt > 0) {  // the last PV product
    const int ls = (n_kt - 1) % STAGES;
    mbar_wait(bar_v + 8 * ls, ((n_kt - 1) / STAGES) & 1);
    reg_fence(o);
    reg_fence_u(pf);
    take_turn();
    wg_fence();
    pv(ls);
    if (cw < NWG - 1) hand_over();  // the next warpgroups' last turns come after this one
    wg_wait<0>();
    reg_fence(o);
    release(n_kt - 1);
    add_t();
  }

  // ------- epilogue: O / l * v_scale + v_mean (VB: O / l), the base-2 lse -------
  lsA += __shfl_xor_sync(0xffffffffu, lsA, 1);
  lsA += __shfl_xor_sync(0xffffffffu, lsA, 2);
  lsB += __shfl_xor_sync(0xffffffffu, lsB, 1);
  lsB += __shfl_xor_sync(0xffffffffu, lsB, 2);
  const float iA = __fdiv_rn(1.f, lsA == 0.f ? 1.f : lsA);
  const float iB = __fdiv_rn(1.f, lsB == 0.f ? 1.f : lsB);
  __nv_bfloat16* ob = p.o + b * p.o_sb + hq * p.o_sh;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * q4;
    float v0 = __fmul_rn(o[4 * j], iA), v1 = __fmul_rn(o[4 * j + 1], iA);
    float v2 = __fmul_rn(o[4 * j + 2], iB), v3 = __fmul_rn(o[4 * j + 3], iB);
    if constexpr (!VB) {
      const float2 sv =
          *reinterpret_cast<const float2*>(p.v_scale + (long long)(b * p.Hk + hk) * D + c);
      v0 = __fmul_rn(v0, sv.x);
      v1 = __fmul_rn(v1, sv.y);
      v2 = __fmul_rn(v2, sv.x);
      v3 = __fmul_rn(v3, sv.y);
      if (p.v_mean) {
        const float2 mv =
            *reinterpret_cast<const float2*>(p.v_mean + (long long)(b * p.Hk + hk) * D + c);
        v0 = __fadd_rn(v0, mv.x);
        v1 = __fadd_rn(v1, mv.y);
        v2 = __fadd_rn(v2, mv.x);
        v3 = __fadd_rn(v3, mv.y);
      }
    }
    if (rA < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + rA * p.o_ss + c) = __floats2bfloat162_rn(v0, v1);
    if (rB < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + rB * p.o_ss + c) = __floats2bfloat162_rn(v2, v3);
  }
  if (p.lse && q4 == 0) {
    // F8: the exp offset rides in l and comes off here
    const float off = F8 ? FP8_OFFSET_LOG2 : 0.f;
    float* lse = p.lse + (long long)(b * p.Hq + hq) * p.Sq;
    if (rA < p.Sq) lse[rA] = __fsub_rn(__fadd_rn(mA, log2f(fmaxf(lsA, 1e-37f))), off);
    if (rB < p.Sq) lse[rB] = __fsub_rn(__fadd_rn(mB, log2f(fmaxf(lsB, 1e-37f))), off);
  }
}

}  // namespace onl90

// ------------------------------------------------------------------ host --

namespace {

using namespace onl90;

template <int D, int MODE>
int launch(const void* q, const void* k, const void* v, const long long* st, const Params& p,
           int B, int Sk, cudaStream_t stream) {
  using C = Cfg<D, MODE == FP8>;
  CUtensorMap mq, mk, mv;
  const int kv_rows = p.kv_len > 0 ? p.kv_len : 1;  // n_kt = 0 loads nothing
  if (!make_map(&mq, q, D, p.Sq, p.Hq, B, st[2], st[1], st[0], C::BM) ||
      !make_map_t(&mk, k, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, kv_rows, p.Hk, B, st[5], st[4],
                  st[3], D, C::BN,
                  D == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B))
    return -2;
  if constexpr (MODE == FP8) {
    // V^T (Sk padded to 16, D, Hk, B) in boxes of BN kv bytes x D rows; the
    // map spans every padded column (the kv order is permuted within each
    // 16, so a column past kv_len may hold an earlier row), P masks them
    if (!make_map_t(&mv, v, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, (Sk + 15) / 16 * 16, D, p.Hk, B,
                    st[8], st[7], st[6], C::BN, D, CU_TENSOR_MAP_SWIZZLE_64B))
      return -2;
  } else if (!make_map(&mv, v, D, kv_rows, p.Hk, B, st[8], st[7], st[6], C::BN)) {
    return -2;
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_online_sm90_kernel<D, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((p.Sq + C::BM - 1) / C::BM, p.Hq, B);
  attn_online_sm90_kernel<D, MODE><<<grid, C::THREADS, C::SMEM, stream>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int mode, const void* q, const void* k, const void* v, const long long* st,
             const Params& p, int B, int Sk, cudaStream_t s) {
  if (mode == FP8) return launch<D, FP8>(q, k, v, st, p, B, Sk, s);
  if (mode == PVBF16) return launch<D, PVBF16>(q, k, v, st, p, B, Sk, s);
  return launch<D, B2>(q, k, v, st, p, B, Sk, s);
}

}  // namespace

extern "C" {

const char* sage_attn_online_sm90_error_string(int e) {
  if (e == -1)
    return "unsupported B2 / B5-fp8-fusedq / B-pvbf16-online configuration (head_dim, GQA, "
           "strides or pointers)";
  if (e == -2) {
    static char msg[128];
    snprintf(msg, sizeof msg,
             "cuTensorMapEncodeTiled failed (result %d; -1: not found in the driver)",
             g_encode_result);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)e);
}

// The online forward on bf16 q [B, Hq, Sq, D] quantized here, int8 K codes
// k [B, Hk, Sk, D] and bf16 o [B, Hq, Sq, D]; `mode` 0 B2 (v the int8 V
// codes widened to bf16 [B, Hk, Sk, D]), 1 B5-fp8-fusedq (v the e4m3 V^T
// [B, Hk, D, Sk padded to 16] of ops/attention.py `transpose_v_codes`), 2
// B-pvbf16-online (v the caller's bf16 V [B, Hk, Sk, D], null v_scale and
// v_mean); each with its own element strides (batch, head, row; unit
// column stride, 16-byte aligned base and outer strides); k_head_scale
// [B*Hk], v_scale and v_mean (or null) [B*Hk*D] f32 (modes 0 and 1), lse
// [B*Hq*Sq] (or null) f32 output; fold = sm_scale * log2(e) > 0.
int sage_attn_fwd_online_sm90(int D, int mode, const void* q, const void* k, const void* v,
                              void* o, long long q_sb, long long q_sh, long long q_ss,
                              long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                              long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                              long long o_ss, const float* k_head_scale, const float* v_scale,
                              const float* v_mean, float* lse, int B, int Hq, int Hk, int Sq,
                              int Sk, int kv_len, int causal, float fold, void* stream) {
  const long long st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  const int ve = mode == FP8 ? 1 : 2;
  const int esize[9] = {2, 2, 2, 1, 1, 1, ve, ve, ve};
  for (int i = 0; i < 9; ++i)
    if (st[i] < 0 || (st[i] * esize[i]) % 16) return -1;
  const bool vb = mode == PVBF16;
  if (mode < B2 || mode > PVBF16 || B < 1 || Hk < 1 || Hq % Hk || kv_len < 0 || kv_len > Sk ||
      !(fold > 0.f) || !k_head_scale || (vb ? (v_scale || v_mean) : !v_scale) ||
      (mode == FP8 && (Sk < 1 || v_ss < (Sk + 15) / 16 * 16)))
    return -1;
  if (Sq == 0) return 0;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.k_head_scale = k_head_scale; p.v_scale = v_scale; p.v_mean = v_mean; p.lse = lse;
  p.Hq = Hq; p.Hk = Hk; p.Sq = Sq; p.kv_len = kv_len; p.causal = causal;
  p.fold = fold;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_d<64>(mode, q, k, v, st, p, B, Sk, s);
  if (D == 128) return launch_d<128>(mode, q, k, v, st, p, B, Sk, s);
  return -1;
}

}  // extern "C"
