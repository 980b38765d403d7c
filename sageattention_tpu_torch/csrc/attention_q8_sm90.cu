// B6, the forward on a pre-quantized Q, B5-fp8 (the same with an e4m3 P
// and e4m3 V: the reference's H100 mode), B-pvbf16 (the same with V in
// bf16 as given: the reference's most robust mode), the ring's B10 forms
// of all three, and B5-int8 (an int8 P and int8 V under the online
// softmax, not its B10 forms),
// redesigned for Hopper on attention_sm90.cu's skeleton: TMA loads
// completing on mbarriers (Q's int8 codes included), a ring of K/V stages
// refilled by the last warp done with one, int8 wgmma for S = QK^T, the
// softmax of one tile under the PV product of the one before, and
// warpgroups taking turns at the tensor cores.
//
// Replaces the Pallas kernel `_attn_kernel` (sageattention_tpu/ops/
// attention.py:251, launched by `attention_call`) in B6's configuration (a
// pre-quantized Q: int8 codes with per-row f32 scales; the K scale folded
// into those scales or given per column; int8 V under a bf16 P), static
// and online, in B5-fp8's (its e4m3 branch, attention.py:569-585, epilogue
// :667-677), in B-pvbf16's (pv_dtype "bf16": V in bf16 with no scale and
// no mean, `AttnConfig.p_bf16`, attention.py:213), static and online, and
// in the ring's B10 forms of all three (parallel/ring.py:234-248: device
// causal offsets and a device true length), at head dims 64 and 128 with
// a bf16 output (B-pvbf16 also fp16, its `_fp16` aliases'); D = 256, an
// f32 output, bf16 compute and every other configuration stay on
// attention.cuh's body (the fused-Q online forms: attention_online_sm90.cu).  What it computes, as the plain version
// (ops/attention.py `attention_plain`, the pre-quantized branch of
// `_prepare_q`, `_dynamic`):
//   s = (float(q8 . k8) * q_scale[row]) * k_scale[col] (the second factor
//   only with per-column scales); the kv columns from kv_len on (kv_len cut
//   at the device true length) and, under causal, col > row + shift (shift
//   = q_start - kv_start of the device offsets, 0 without them) masked.
//   static: the cap C = (q_scale * ||q8||) * (kn_max * (1 + 1e-5)) bounds
//   every score, p = exp2(s - C) with no running max; online: over 64-column
//   kv tiles (the plain version's KV_TILE) a running max m floored at
//   M_CLAMP, alpha = exp2(m - m') rescaling O and l, p = exp2(s - m').  l
//   sums the unrounded p; O += bf16(p) V with f32 sums over the int8 V codes;
//   out = O * (1 / l) * v_scale[c] + v_mean[c] in bf16 and the base-2 lse,
//   C + log2(l) (static) or m + log2(l) (online).  No lmin: B6's safety
//   check is the predictive one, made before the launch.  B5-fp8: the
//   online softmax with P = e4m3(exp2((s - m') + log2 448)) and l summing
//   those rounded P, O = O * alpha + (P V over the tile, in f32) with V the
//   e4m3 codes, and the lse less log2 448.  B-pvbf16: B6's softmax and
//   product with V the caller's bf16 values, out = O * (1 / l).  B5-int8
//   (attention.py:557-567): P = rint(exp2((s - m') + log2 127)), codes 0 ..
//   127, l = alpha l + (their sum) / 127, O = O * alpha + (P V over the
//   tile) with V the int8 codes, out = O * (1 / l) * (v_scale / 127) +
//   v_mean.
//
// What bounds it on the H100: the tensor cores (2 S^2 D int8 operations at
// 1979 TOP/s and 2 S^2 D bf16 ones at 989 TFLOP/s; B5-fp8's PV at the fp8
// rate) and, at D = 64, the exp2 of the softmax on the SFUs.  The design, attention_sm90.cu's with
// these changes:
//   Q         the int8 codes by one TMA box of D bytes x BM rows, swizzled
//             as K's (128-byte at D = 128, 64-byte at D = 64): the layout
//             the wgmma descriptor reads, so no thread touches them.  Each
//             thread reads its two rows' q_scale from global memory and,
//             static, their code norms from shared memory: a quad's four
//             lanes sum a quarter of each row with dp4a (an exact integer
//             sum, in any order of the swizzled chunks).  Rows past Sq are
//             zero-filled.  Q is loaded even by a block that sees no kv
//             tile: its static lse needs the cap.
//   K scales  per column: a BN-float slice of k_scale [B, Hk, Sk] rides in
//             each K stage on K's barrier, one TMA box of a rank-4 map
//             (Sk, 1, Hk, B) whose zero fill covers the last tile's columns
//             past Sk (the wrapper pads a copy whose rows are not 16-byte
//             multiples apart); each thread reads its columns as float2.
//             Folded: no map, no copy.
//   tiles     static: BN = 128 as B1 (the static softmax does not depend
//             on the tile); online: BN = 64, the plain version's tile, so
//             bf16 P rounds against the same running maxima (wgmma
//             m64n64k32 for S).
//   B10       offsets and the true length read once per block from the
//             device; the last kv tile is the one whose first column some
//             row sees, (min(q0 + BM, Sq) - 1 + shift) / BN; the tensor
//             maps end at the host's kv_len, and the true length and the
//             shifted diagonal are masked in the softmax.  A block that
//             sees no tile (a later shard's chunk) loads no K/V, waits on
//             no stage and takes no turn; it writes O = v_mean (0 without
//             it) and lse = C + log2(1e-37) (static) or M_CLAMP + log2(1e-37)
//             (online), as the plain version does.
//   V         the int8 codes widened once per call to bf16 by the wrapper
//             (`widen_v_codes`), B1's path: TMA, 128-byte swizzled 64-column
//             boxes, an MN-major B operand of the PV wgmma.  B-pvbf16 (the
//             VB instantiations of the static and online forms) reads the
//             caller's bf16 V the same way, with no widening pass, and its
//             epilogue has no v_scale multiply and no v_mean add (B6's and
//             B5-fp8's instantiations are unchanged: VB only selects the
//             epilogue).
//   block     three warpgroups at D = 64 (192 rows), two at D = 128 (128
//             rows), no producer warp; 4 / 3 stages (static) or 4 (online).
//   B5-fp8    the S side and the online softmax as B6's, on 64-column kv
//             tiles (the plain version's, whose maxima the e4m3 P is
//             rounded against).  The PV product is an e4m3 wgmma
//             (m64nDk32, f32 sums): P from registers, four codes a
//             register, converted from f32 in pairs (cvt.rn.satfinite
//             .e4m3x2); V the B operand, which 8-bit wgmma takes K-major
//             only, so the wrapper writes V^T [B, Hk, D, Sk padded to 16]
//             once per call (per ring step for B10) with each 16 kv rows in
//             the order of the P fragments' k (`transpose_v_codes`); one
//             TMA box of 64 kv bytes x D rows a stage, 64-byte swizzled.
//             Each tile's product lands in a fresh f32 accumulator that is
//             then added into O (two-level accumulation: the tensor cores
//             keep fewer mantissa bits of an fp8 sum than f32, as the
//             reference does in qk_int_sv_f8_cuda_sm90.cu), which costs D/2
//             registers a thread (152 / 216 a thread at D = 64 / 128, no
//             spill).  The softmax packs the codes once, into the S
//             registers, and sums l from the packed bytes' bits (a code's
//             bits shifted into an f32 are its value times 2^-120, exact);
//             after the previous product's wait they move into the A
//             fragments through an XOR with a zero the compiler cannot
//             fold: with a plain copy ptxas gave the fragments and the
//             softmax's words the same registers and serialized every
//             wgmma.
//   B5-int8   B5-fp8's structure with s8 in place of e4m3: the P codes
//             rounded by a magic-number add and packed four to a register in
//             the e4m3 fragments' order, V^T the same byte-wise copy of the
//             int8 codes, an s8 wgmma m64nDk32 into a fresh s32 accumulator
//             whose sum is exact (127 x 127 x 64 < 2^24), added into O after
//             O * alpha, and l from dp4a sums of the codes.
#include <stdio.h>

#include <cuda_fp16.h>

#include "sm90.cuh"

namespace q8sm90 {

using namespace sm90;

constexpr float M_CLAMP = -1e20f;  // floor of the running max
constexpr float FP8_OFFSET_LOG2 = 8.807354922057604f;  // log2(448): e4m3 P fills its range
constexpr float INT8_P_OFFSET_LOG2 = 6.988684686772166f;  // log2(127): the int8 P scale

// The softmax and PV forms: B6-static, B6-online (int8 V widened to bf16
// under a bf16 P) and B5-fp8 (the online softmax with e4m3 P and V).  The
// C entry's modes 3 and 4 are B-pvbf16's static and online forms: STATIC
// and ONLINE with V in bf16 as given (the VB instantiations).
// Mode 5, B5-int8, is B5-fp8's loop with an int8 P and int8 V (an s8 wgmma PV).
enum Mode { STATIC = 0, ONLINE = 1, FP8 = 2, PVBF16_STATIC = 3, PVBF16_ONLINE = 4, I8P = 5 };

template <int D, int MODE>
struct Cfg {
  static constexpr int NWG = D == 64 ? 3 : 2;  // warpgroups, 64 query rows each
  static constexpr int BM = 64 * NWG;          // query rows per block
  static constexpr int THREADS = 128 * NWG;
  static constexpr int BN = MODE == STATIC ? 128 : 64;  // kv rows per tile
  static constexpr int STAGES = MODE != STATIC || D == 64 ? 4 : 3;
  static constexpr int CH = D / 64;            // 128-byte bf16 column boxes of a V row
  static constexpr int Q_BYTES = BM * D;       // the int8 Q codes
  static constexpr int K_BYTES = BN * D;       // one int8 K stage
  // one V stage: bf16 rows of D, or FP8 / I8P the 8-bit V^T, D rows of BN bytes
  static constexpr int V_BYTES = MODE == FP8 || MODE == I8P ? D * BN : BN * D * 2;
  static constexpr int KS_BYTES = BN * 4;      // one stage's per-column K scales
  static constexpr int SMEM = Q_BYTES + STAGES * (K_BYTES + V_BYTES + KS_BYTES) + 1024;
};

struct Params {
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_ss;
  const float* q_scale;  // [B*Hq*Sq] per row
  const float* kn_max;   // [B*Hq] (static)
  const float* v_scale;  // [B*Hk*D]
  const float* v_mean;   // [B*Hk*D], or null
  float* lse;            // [B*Hq*Sq] base 2, or null
  const int* offsets;    // [2] (q_start, kv_start) on the device, or null
  const int* kv_true;    // [1] the true kv length on the device, or null
  int Hq, Hk, Sq, kv_len, causal;
  int out_f16;           // VB: 1 writes o as fp16, 0 as bf16
};

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

// The scores of one S tile whose first column is k0: s = float(s32) * qs
// (* ks[col] with per-column scales), -inf where col >= kv_len or, causal,
// col > pos (pA, pB: the rows' positions shifted into the chunk's columns,
// p0 the warpgroup's first).  A thread holds rows rA and rA + 8 and, of
// accumulator element i, column 8 (i / 4) + 2 (lane % 4) + i % 2 (+8 rows
// for i % 4 >= 2).
template <int BN, bool COLK>
__device__ __forceinline__ void scores(const int (&si)[BN / 2], float (&sc)[BN / 2],
                                       const float* ks, int k0, int kv_len, int causal, int p0,
                                       int pA, int pB, int q4, float qA, float qB) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    sc[4 * j] = __fmul_rn((float)si[4 * j], qA);
    sc[4 * j + 1] = __fmul_rn((float)si[4 * j + 1], qA);
    sc[4 * j + 2] = __fmul_rn((float)si[4 * j + 2], qB);
    sc[4 * j + 3] = __fmul_rn((float)si[4 * j + 3], qB);
    if constexpr (COLK) {
      const float2 c = *reinterpret_cast<const float2*>(ks + 8 * j + 2 * q4);
      sc[4 * j] = __fmul_rn(sc[4 * j], c.x);
      sc[4 * j + 1] = __fmul_rn(sc[4 * j + 1], c.y);
      sc[4 * j + 2] = __fmul_rn(sc[4 * j + 2], c.x);
      sc[4 * j + 3] = __fmul_rn(sc[4 * j + 3], c.y);
    }
  }
  if (k0 + BN > kv_len || (causal && k0 + BN - 1 > p0)) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * q4 + (e & 1);
        if (col >= kv_len || (causal && col > (e < 2 ? pA : pB))) sc[4 * j + e] = -INFINITY;
      }
  }
}

// The static softmax of one tile, in place (the f32 P in the bits of the
// s32 sums): P = exp2(s - C) in f32 and l summing that unrounded P.
template <int BN, bool COLK>
__device__ __forceinline__ void softmax_static(int (&si)[BN / 2], const float* ks, int k0,
                                               int kv_len, int causal, int p0, int pA, int pB,
                                               int q4, float qA, float qB, float cA, float cB,
                                               float& lA, float& lB) {
  float sc[BN / 2];
  scores<BN, COLK>(si, sc, ks, k0, kv_len, causal, p0, pA, pB, q4, qA, qB);
  float sA = 0.f, sB = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    sc[4 * j] = ex2(__fsub_rn(sc[4 * j], cA));
    sc[4 * j + 1] = ex2(__fsub_rn(sc[4 * j + 1], cA));
    sc[4 * j + 2] = ex2(__fsub_rn(sc[4 * j + 2], cB));
    sc[4 * j + 3] = ex2(__fsub_rn(sc[4 * j + 3], cB));
    sA += sc[4 * j] + sc[4 * j + 1];
    sB += sc[4 * j + 2] + sc[4 * j + 3];
  }
  lA = __fadd_rn(lA, sA);
  lB = __fadd_rn(lB, sB);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) si[i] = __float_as_int(sc[i]);
}

// The online softmax of one tile, in place: the new running maxima (the 4
// lanes of a quad share a row) floored at M_CLAMP, their alphas, P =
// exp2(s - m') in f32 and l = alpha l + the sum of that unrounded P.
template <int BN, bool COLK>
__device__ __forceinline__ void softmax_online(int (&si)[BN / 2], const float* ks, int k0,
                                               int kv_len, int causal, int p0, int pA, int pB,
                                               int q4, float qA, float qB, float& mA, float& mB,
                                               float& lA, float& lB, float& aA, float& aB) {
  float sc[BN / 2];
  scores<BN, COLK>(si, sc, ks, k0, kv_len, causal, p0, pA, pB, q4, qA, qB);
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
  float sA = 0.f, sB = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    sc[4 * j] = ex2(__fsub_rn(sc[4 * j], nA));
    sc[4 * j + 1] = ex2(__fsub_rn(sc[4 * j + 1], nA));
    sc[4 * j + 2] = ex2(__fsub_rn(sc[4 * j + 2], nB));
    sc[4 * j + 3] = ex2(__fsub_rn(sc[4 * j + 3], nB));
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

// The sum of the four e4m3 values in w, times 2^-120: a code's bits but the
// sign, shifted into an f32's exponent and top mantissa bits, are that value
// times 2^-120 as an f32 (normal codes as normals, subnormal codes as f32
// subnormals), and these sums are exact.
__device__ __forceinline__ float e4m3x4_sum_2m120(uint32_t w) {
  const float a = __uint_as_float((w << 20) & 0x07F00000u);
  const float b = __uint_as_float((w << 12) & 0x07F00000u);
  const float c = __uint_as_float((w << 4) & 0x07F00000u);
  const float d = __uint_as_float((w >> 4) & 0x07F00000u);
  return __fadd_rn(__fadd_rn(a, b), __fadd_rn(c, d));
}

// The A fragments of B5-fp8's e4m3 PV product from one tile's f32 P (in
// the accumulator layout): fragment register 2 (h % 2) (+1 for row B) of
// k32 step h / 2 holds four codes of columns 16 h .. 16 h + 15, this
// thread's {2 q4, 2 q4 + 1, 8 + 2 q4, 9 + 2 q4} in that order; the
// fragment's k order wants columns {4 q4 .. 4 q4 + 3}, so V^T holds each
// 16 kv rows in the matching order (ops/attention.py `transpose_v_codes`)
// and the product sums the same pairs.
template <int BN>
__device__ __forceinline__ void pack_e4m3(const float (&pv)[BN / 2], uint32_t (&pf)[BN / 32][4]) {
#pragma unroll
  for (int h = 0; h < BN / 16; ++h) {
    const int j = 2 * h;
    pf[h >> 1][2 * (h & 1)] = e4m3x4(pv[4 * j], pv[4 * j + 1], pv[4 * j + 4], pv[4 * j + 5]);
    pf[h >> 1][2 * (h & 1) + 1] = e4m3x4(pv[4 * j + 2], pv[4 * j + 3], pv[4 * j + 6], pv[4 * j + 7]);
  }
}

// B5-fp8's online softmax of one tile: the running maxima and alphas as
// softmax_online's, P = exp2((s - m') + log2 448) rounded to e4m3 (round
// to nearest even, saturating), packed into si[0 .. BN/4) as pack_e4m3
// packs them, and l = alpha l + the sum of those codes' values, read back
// from the packed bytes (exact in f32: at most 64 codes of 4 significant
// bits from 2^-9 to 448).
template <int BN, bool COLK>
__device__ __forceinline__ void softmax_fp8(int (&si)[BN / 2], const float* ks, int k0,
                                            int kv_len, int causal, int p0, int pA, int pB,
                                            int q4, float qA, float qB, float& mA, float& mB,
                                            float& lA, float& lB, float& aA, float& aB) {
  float sc[BN / 2];
  scores<BN, COLK>(si, sc, ks, k0, kv_len, causal, p0, pA, pB, q4, qA, qB);
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
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    sc[4 * j] = ex2(__fadd_rn(__fsub_rn(sc[4 * j], nA), FP8_OFFSET_LOG2));
    sc[4 * j + 1] = ex2(__fadd_rn(__fsub_rn(sc[4 * j + 1], nA), FP8_OFFSET_LOG2));
    sc[4 * j + 2] = ex2(__fadd_rn(__fsub_rn(sc[4 * j + 2], nB), FP8_OFFSET_LOG2));
    sc[4 * j + 3] = ex2(__fadd_rn(__fsub_rn(sc[4 * j + 3], nB), FP8_OFFSET_LOG2));
  }
  uint32_t w[BN / 32][4];
  pack_e4m3<BN>(sc, w);
  float sA = 0.f, sB = 0.f;
#pragma unroll
  for (int kk = 0; kk < BN / 32; ++kk) {
    sA = __fadd_rn(sA, __fadd_rn(e4m3x4_sum_2m120(w[kk][0]), e4m3x4_sum_2m120(w[kk][2])));
    sB = __fadd_rn(sB, __fadd_rn(e4m3x4_sum_2m120(w[kk][1]), e4m3x4_sum_2m120(w[kk][3])));
#pragma unroll
    for (int r = 0; r < 4; ++r) si[4 * kk + r] = (int)w[kk][r];
  }
  lA = __fadd_rn(__fmul_rn(aA, lA), __fmul_rn(sA, 0x1p120f));
  lB = __fadd_rn(__fmul_rn(aB, lB), __fmul_rn(sB, 0x1p120f));
}

// B5-fp8's PV product of one tile into a fresh f32 accumulator t (the
// caller adds it into O): BN/32 k32 steps, A (the e4m3 P) from registers,
// B (the stage's e4m3 V^T, D rows of BN bytes, 64-byte swizzled) K-major.
template <int D, int BN>
__device__ __forceinline__ void pv_issue_f8(float (&t)[D / 2], const uint32_t (&pf)[BN / 32][4],
                                            uint32_t vlo) {
#pragma unroll
  for (int kk = 0; kk < BN / 32; ++kk) wgmma_f8(t, pf[kk], desc64(vlo + kk * 2), kk > 0);
  wg_commit();
}

// Four int8 P codes (each an f32 holding an integer 0 .. 127) as one
// register, byte i from x_i: x + 1.5 * 2^23 rounds x to an integer in the
// low mantissa bits (to nearest even, as rintf).
__device__ __forceinline__ uint32_t s8x4(float x0, float x1, float x2, float x3) {
  const uint32_t a = __float_as_uint(__fadd_rn(x0, 0x1.8p23f));
  const uint32_t b = __float_as_uint(__fadd_rn(x1, 0x1.8p23f));
  const uint32_t c = __float_as_uint(__fadd_rn(x2, 0x1.8p23f));
  const uint32_t d = __float_as_uint(__fadd_rn(x3, 0x1.8p23f));
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// B5-int8's online softmax of one tile: the running maxima and alphas as
// softmax_online's, P = rint(exp2((s - m') + log2 127)), codes 0 .. 127
// packed into si[0 .. BN/4) in pack_e4m3's order, and l = alpha l + (the
// codes' exact integer sum) / 127.
template <int BN, bool COLK>
__device__ __forceinline__ void softmax_i8(int (&si)[BN / 2], const float* ks, int k0,
                                           int kv_len, int causal, int p0, int pA, int pB,
                                           int q4, float qA, float qB, float& mA, float& mB,
                                           float& lA, float& lB, float& aA, float& aB) {
  float sc[BN / 2];
  scores<BN, COLK>(si, sc, ks, k0, kv_len, causal, p0, pA, pB, q4, qA, qB);
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
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    sc[4 * j] = ex2(__fadd_rn(__fsub_rn(sc[4 * j], nA), INT8_P_OFFSET_LOG2));
    sc[4 * j + 1] = ex2(__fadd_rn(__fsub_rn(sc[4 * j + 1], nA), INT8_P_OFFSET_LOG2));
    sc[4 * j + 2] = ex2(__fadd_rn(__fsub_rn(sc[4 * j + 2], nB), INT8_P_OFFSET_LOG2));
    sc[4 * j + 3] = ex2(__fadd_rn(__fsub_rn(sc[4 * j + 3], nB), INT8_P_OFFSET_LOG2));
  }
  int cA = 0, cB = 0;
#pragma unroll
  for (int h = 0; h < BN / 16; ++h) {
    const int j = 2 * h;
    const uint32_t wa = s8x4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 4], sc[4 * j + 5]);
    const uint32_t wb = s8x4(sc[4 * j + 2], sc[4 * j + 3], sc[4 * j + 6], sc[4 * j + 7]);
    cA = __dp4a((int)wa, 0x01010101, cA);
    cB = __dp4a((int)wb, 0x01010101, cB);
    si[4 * (h >> 1) + 2 * (h & 1)] = (int)wa;
    si[4 * (h >> 1) + 2 * (h & 1) + 1] = (int)wb;
  }
  constexpr float INV127 = (float)(1.0 / 127.0);
  lA = __fadd_rn(__fmul_rn(aA, lA), __fmul_rn((float)cA, INV127));
  lB = __fadd_rn(__fmul_rn(aB, lB), __fmul_rn((float)cB, INV127));
}

// B5-int8's PV product of one tile into a fresh s32 accumulator t (exact:
// 127 x 127 x 64 < 2^24, so float(t) is the plain version's f32 product):
// BN/32 k32 steps, A (the P codes) from registers, B (the stage's int8
// V^T, as B5-fp8's) K-major.
template <int D, int BN>
__device__ __forceinline__ void pv_issue_s8(int (&t)[D / 2], const uint32_t (&pf)[BN / 32][4],
                                            uint32_t vlo) {
#pragma unroll
  for (int kk = 0; kk < BN / 32; ++kk) wgmma_s8_rs(t, pf[kk], desc64(vlo + kk * 2), kk > 0);
  wg_commit();
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

// ||q8||^2 of block row r, exact: this quad lane's quarter of the row's
// 16-byte chunks by dp4a, then the quad's sum.
template <int D>
__device__ __forceinline__ int code_norm2(const uint8_t* q8, int r, int q4) {
  int n = 0;
#pragma unroll
  for (int i = 0; i < D / 64; ++i) {
    const int4 c = *reinterpret_cast<const int4*>(q8 + r * D + (q4 * (D / 64) + i) * 16);
    n = __dp4a(c.x, c.x, n);
    n = __dp4a(c.y, c.y, n);
    n = __dp4a(c.z, c.z, n);
    n = __dp4a(c.w, c.w, n);
  }
  n += __shfl_xor_sync(0xffffffffu, n, 1);
  return n + __shfl_xor_sync(0xffffffffu, n, 2);
}

// Grid (ceil(Sq / BM), Hq, B), Cfg<D, MODE>::THREADS threads; tm_ks (the
// per-column K scales) is read by the COLK instantiations only.  VB (with
// MODE STATIC or ONLINE): V in bf16 as given, out = O / l.
template <int D, int MODE, bool COLK, bool VB>
__global__ void __launch_bounds__(Cfg<D, MODE>::THREADS, 1)
    attn_q8_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_ks, const Params p) {
  using C = Cfg<D, MODE>;
  constexpr int BM = C::BM, BN = C::BN, CH = C::CH, STAGES = C::STAGES, NWG = C::NWG;
  constexpr bool F8 = MODE == FP8, I8 = MODE == I8P;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // q full, then per stage: k full (with its K scales), v full
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  __shared__ int freed[STAGES];  // per stage: warps done with its tile
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle wants 1 KB
  const uint32_t sK = sQ + C::Q_BYTES;             // stage s at sK + s * K_BYTES
  const uint32_t sV = sK + STAGES * C::K_BYTES;    // stage s at sV + s * V_BYTES
  const uint32_t sKS = sV + STAGES * C::V_BYTES;   // stage s at sKS + s * KS_BYTES
  const uint8_t* const gQ = smem_raw + (sQ - smem_u32(smem_raw));  // generic pointers
  const float* const gKS = reinterpret_cast<const float*>(smem_raw + (sKS - smem_u32(smem_raw)));
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_k = smem_u32(&bars[1]);       // stage s at + 8 * s
  const uint32_t bar_v = smem_u32(&bars[1 + STAGES]);

  const int n_qt = (p.Sq + BM - 1) / BM;
  // causal: the longest q tiles first, so the tail of the grid is short work
  // (a later q tile sees at least as many kv tiles under any shift)
  const int qt = p.causal ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (p.Hq / p.Hk);
  const int q0 = qt * BM;
  // B10: the causal shift q_start - kv_start and the true kv length
  const int shift = p.offsets ? p.offsets[0] - p.offsets[1] : 0;
  const int kv_len = p.kv_true ? min(p.kv_len, max(0, p.kv_true[0])) : p.kv_len;
  int n_kt = (kv_len + BN - 1) / BN;
  if (p.causal) {  // the kv tiles whose first column some row of the block sees
    const int last = min(q0 + BM, p.Sq) - 1 + shift;
    n_kt = last < 0 ? 0 : min(n_kt, last / BN + 1);
  }

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // K (one box of D bytes, and COLK its BN scales) and V (CH boxes of 64
  // bf16 columns, or F8 one box of V^T's BN bytes x D rows) of tile kt into
  // stage kt % STAGES, each completing on its full barrier
  auto load_tile = [&](int kt) {
    const int s = kt % STAGES;
    mbar_expect_tx(bar_k + 8 * s, C::K_BYTES + (COLK ? C::KS_BYTES : 0));
    tma_load4(sK + s * C::K_BYTES, &tm_k, bar_k + 8 * s, 0, kt * BN, hk, b);
    if constexpr (COLK) tma_load4(sKS + s * C::KS_BYTES, &tm_ks, bar_k + 8 * s, kt * BN, 0, hk, b);
    mbar_expect_tx(bar_v + 8 * s, C::V_BYTES);
    if constexpr (F8 || I8) {
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
    mbar_expect_tx(bar_q, C::Q_BYTES);
    tma_load4(sQ, &tm_q, bar_q, 0, q0, hq, b);
    for (int kt = 0; kt < min(n_kt, STAGES); ++kt) load_tile(kt);
  }
  __syncthreads();

  const int cw = tid / 128;  // the warpgroup: 64 query rows each
  const int q4 = lane & 3;
  const int lA = 64 * cw + 16 * (warp & 3) + (lane >> 2);  // this thread's rows, in the block
  const int rA = q0 + lA, rB = rA + 8;
  const int row0 = q0 + 64 * cw;
  // positions in the chunk's columns: row r sees col iff col <= r + shift
  const int p0 = row0 + shift, pA = rA + shift, pB = rB + shift;
  const float* qsr = p.q_scale + (long long)(b * p.Hq + hq) * p.Sq;
  const float qA = rA < p.Sq ? qsr[rA] : 1.f, qB = rB < p.Sq ? qsr[rB] : 1.f;
  mbar_wait(bar_q, 0);
  float cA = 0.f, cB = 0.f;  // static: the rows' caps
  if constexpr (MODE == STATIC) {
    const float kcap = __fmul_rn(p.kn_max[b * p.Hq + hq], (float)(1.0 + 1e-5));
    cA = __fmul_rn(__fmul_rn(qA, sqrtf((float)code_norm2<D>(gQ, lA, q4))), kcap);
    cB = __fmul_rn(__fmul_rn(qB, sqrtf((float)code_norm2<D>(gQ, lA + 8, q4))), kcap);
  }

  // the warpgroups take turns, in order, to issue their products (named
  // barrier 1 + w is warpgroup w's turn, handed over by w - 1 after
  // issuing); every warpgroup walks all n_kt tiles, so all take n_kt + 1
  // turns, and a block with no tile takes none
  auto take_turn = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory"); };
  auto hand_over = [&]() {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (cw + 1) % NWG) : "memory");
  };
  if (cw == NWG - 1 && n_kt > 0) hand_over();  // warpgroup 0 goes first
  const uint32_t q_lo = desc_lo(sQ + cw * (64 * D), 16);
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
  // the softmax of tile kt (stage s), in place
  float mA = M_CLAMP, mB = M_CLAMP, lsA = 0.f, lsB = 0.f, aA = 1.f, aB = 1.f;
  auto softmax = [&](int (&si)[BN / 2], int kt, int s) {
    const float* ks = gKS + s * BN;
    if constexpr (F8)
      softmax_fp8<BN, COLK>(si, ks, kt * BN, kv_len, p.causal, p0, pA, pB, q4, qA, qB, mA, mB,
                            lsA, lsB, aA, aB);
    else if constexpr (I8)
      softmax_i8<BN, COLK>(si, ks, kt * BN, kv_len, p.causal, p0, pA, pB, q4, qA, qB, mA, mB,
                           lsA, lsB, aA, aB);
    else if constexpr (MODE == ONLINE)
      softmax_online<BN, COLK>(si, ks, kt * BN, kv_len, p.causal, p0, pA, pB, q4, qA, qB, mA,
                               mB, lsA, lsB, aA, aB);
    else
      softmax_static<BN, COLK>(si, ks, kt * BN, kv_len, p.causal, p0, pA, pB, q4, qA, qB, cA,
                               cB, lsA, lsB);
  };
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // F8: the PV product of one tile, added into O in f32 once it completes
  // (two-level accumulation: the tensor cores keep fewer bits of an fp8 sum)
  float t[F8 ? D / 2 : 1];
#pragma unroll
  for (int i = 0; i < (F8 ? D / 2 : 1); ++i) t[i] = 0.f;
  // I8: the same in s32, exact
  int ti[I8 ? D / 2 : 1];
#pragma unroll
  for (int i = 0; i < (I8 ? D / 2 : 1); ++i) ti[i] = 0;
  uint32_t pf[F8 || I8 ? BN / 32 : BN / 16][4];  // P of the tile whose PV product is next
  // P (kt) into the A fragments, once the product of P(kt - 1) has read them
  // F8: the codes move into pf through an operation with a zero the
  // compiler cannot fold (Sq >= 0): given a plain copy, ptxas let pf and
  // the softmax's words share registers, and serialized every wgmma
  const uint32_t zero = (uint32_t)p.Sq >> 31;
  auto pack = [&](const int (&si)[BN / 2]) {
    if constexpr (F8 || I8) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) pf[i >> 2][i & 3] = (uint32_t)si[i] ^ zero;
    } else {
      pack_p<BN>(si, pf);
    }
  };
  // O += P(kt - 1) V(kt - 1) on stage s, issued
  auto pv = [&](int s) {
    if constexpr (F8)
      pv_issue_f8<D, BN>(t, pf, opaque(desc_lo(sV + s * C::V_BYTES, 16)));
    else if constexpr (I8)
      pv_issue_s8<D, BN>(ti, pf, opaque(desc_lo(sV + s * C::V_BYTES, 16)));
    else
      pv_issue<D, BN>(o, pf, opaque(desc_lo(sV + s * C::V_BYTES, BN * 128)));
  };
  // F8, I8: the completed tile's product into O (I8: O * alpha and this
  // exact sum added apart, as the plain version's acc * alpha + pv)
  auto add_t = [&]() {
    if constexpr (F8) {
      reg_fence(t);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = __fadd_rn(o[i], t[i]);
    } else if constexpr (I8) {
      reg_fence(ti);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = __fadd_rn(o[i], (float)ti[i]);
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
    softmax(si, 0, 0);
    pack(si);
  }
  // tile kt: S(kt) and O += P(kt-1) V(kt-1) in flight together; the
  // softmax of S(kt) runs under the PV product, then (F8) the product is
  // added into O, (online) O takes alpha(kt), and P(kt) is packed only once
  // the product has read P(kt-1)
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
    softmax(si, kt, s);
    wg_wait<0>();
    reg_fence(o);
    reg_fence_u(pf);
    reg_fence(si);
    release(kt - 1);
    add_t();
    if constexpr (MODE != STATIC) rescale<D>(o, aA, aB);
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
  const float* vs = p.v_scale + (long long)(b * p.Hk + hk) * D;
  const float* vm = p.v_mean ? p.v_mean + (long long)(b * p.Hk + hk) * D : nullptr;
  if constexpr (VB) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * q4;
      const float v0 = __fmul_rn(o[4 * j], iA), v1 = __fmul_rn(o[4 * j + 1], iA);
      const float v2 = __fmul_rn(o[4 * j + 2], iB), v3 = __fmul_rn(o[4 * j + 3], iB);
      if (p.out_f16) {
        __half* oh = reinterpret_cast<__half*>(ob);
        if (rA < p.Sq)
          *reinterpret_cast<__half2*>(oh + rA * p.o_ss + c) = __floats2half2_rn(v0, v1);
        if (rB < p.Sq)
          *reinterpret_cast<__half2*>(oh + rB * p.o_ss + c) = __floats2half2_rn(v2, v3);
      } else {
        if (rA < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + rA * p.o_ss + c) = __floats2bfloat162_rn(v0, v1);
        if (rB < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + rB * p.o_ss + c) = __floats2bfloat162_rn(v2, v3);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * q4;
      float2 sv = *reinterpret_cast<const float2*>(vs + c);
      if constexpr (I8) {  // the P codes' scale, 1/127, rides with v_scale
        sv.x = __fmul_rn(sv.x, (float)(1.0 / 127.0));
        sv.y = __fmul_rn(sv.y, (float)(1.0 / 127.0));
      }
      float v0 = __fmul_rn(__fmul_rn(o[4 * j], iA), sv.x);
      float v1 = __fmul_rn(__fmul_rn(o[4 * j + 1], iA), sv.y);
      float v2 = __fmul_rn(__fmul_rn(o[4 * j + 2], iB), sv.x);
      float v3 = __fmul_rn(__fmul_rn(o[4 * j + 3], iB), sv.y);
      if (vm) {
        const float2 mv = *reinterpret_cast<const float2*>(vm + c);
        v0 = __fadd_rn(v0, mv.x);
        v1 = __fadd_rn(v1, mv.y);
        v2 = __fadd_rn(v2, mv.x);
        v3 = __fadd_rn(v3, mv.y);
      }
      if (rA < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + rA * p.o_ss + c) = __floats2bfloat162_rn(v0, v1);
      if (rB < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + rB * p.o_ss + c) = __floats2bfloat162_rn(v2, v3);
    }
  }
  if (p.lse && q4 == 0) {
    // static: the cap is the max the P were taken against; F8: the exp
    // offset rides in l and comes off here
    const float bA = MODE == STATIC ? cA : mA, bB = MODE == STATIC ? cB : mB;
    const float off = F8 ? FP8_OFFSET_LOG2 : 0.f;
    float* lse = p.lse + (long long)(b * p.Hq + hq) * p.Sq;
    if (rA < p.Sq) lse[rA] = __fsub_rn(__fadd_rn(bA, log2f(fmaxf(lsA, 1e-37f))), off);
    if (rB < p.Sq) lse[rB] = __fsub_rn(__fadd_rn(bB, log2f(fmaxf(lsB, 1e-37f))), off);
  }
}

}  // namespace q8sm90

// ------------------------------------------------------------------ host --

namespace {

using namespace q8sm90;

// The per-column K scales (COLK): base, element strides (batch, head) and
// column count.
struct KScale {
  const float* ptr;
  long long sb, sh;
  int cols;
};

template <int D, int MODE, bool COLK, bool VB>
int launch(const void* q, const void* k, const void* v, const long long* st, const KScale& ks,
           const Params& p, int B, int Sk, cudaStream_t stream) {
  using C = Cfg<D, MODE>;
  CUtensorMap mq, mk, mv, mks;
  const int kv_rows = p.kv_len > 0 ? p.kv_len : 1;  // n_kt = 0 loads nothing
  const CUtensorMapSwizzle swz = D == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  if (!make_map_t(&mq, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, p.Sq, p.Hq, B, st[2], st[1], st[0],
                  D, C::BM, swz) ||
      !make_map_t(&mk, k, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, kv_rows, p.Hk, B, st[5], st[4],
                  st[3], D, C::BN, swz))
    return -2;
  if constexpr (MODE == FP8 || MODE == I8P) {
    // V^T (Sk padded to 16, D, Hk, B) in boxes of BN kv bytes x D rows; the
    // map spans every padded column (the kv order is permuted within each
    // 16, so a column past kv_len may hold an earlier row), P masks them
    if (!make_map_t(&mv, v, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, (Sk + 15) / 16 * 16, D, p.Hk, B,
                    st[8], st[7], st[6], C::BN, D, CU_TENSOR_MAP_SWIZZLE_64B))
      return -2;
  } else if (!make_map(&mv, v, D, kv_rows, p.Hk, B, st[8], st[7], st[6], C::BN)) {
    return -2;
  }
  mks = mq;  // read only by the COLK instantiations
  if constexpr (COLK) {
    if (!make_map_t(&mks, ks.ptr, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ks.cols, 1, p.Hk, B, 0,
                    ks.sh, ks.sb, C::BN, 1, CU_TENSOR_MAP_SWIZZLE_NONE))
      return -2;
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_q8_sm90_kernel<D, MODE, COLK, VB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((p.Sq + C::BM - 1) / C::BM, p.Hq, B);
  attn_q8_sm90_kernel<D, MODE, COLK, VB><<<grid, C::THREADS, C::SMEM, stream>>>(mq, mk, mv, mks,
                                                                                p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int mode, const void* q, const void* k, const void* v, const long long* st,
             const KScale& ks, const Params& p, int B, int Sk, cudaStream_t s) {
  const bool colk = ks.ptr != nullptr;
  if (mode == PVBF16_ONLINE)
    return colk ? launch<D, ONLINE, true, true>(q, k, v, st, ks, p, B, Sk, s)
                : launch<D, ONLINE, false, true>(q, k, v, st, ks, p, B, Sk, s);
  if (mode == PVBF16_STATIC)
    return colk ? launch<D, STATIC, true, true>(q, k, v, st, ks, p, B, Sk, s)
                : launch<D, STATIC, false, true>(q, k, v, st, ks, p, B, Sk, s);
  if (mode == FP8)
    return colk ? launch<D, FP8, true, false>(q, k, v, st, ks, p, B, Sk, s)
                : launch<D, FP8, false, false>(q, k, v, st, ks, p, B, Sk, s);
  if (mode == I8P)
    return colk ? launch<D, I8P, true, false>(q, k, v, st, ks, p, B, Sk, s)
                : launch<D, I8P, false, false>(q, k, v, st, ks, p, B, Sk, s);
  if (mode == ONLINE)
    return colk ? launch<D, ONLINE, true, false>(q, k, v, st, ks, p, B, Sk, s)
                : launch<D, ONLINE, false, false>(q, k, v, st, ks, p, B, Sk, s);
  return colk ? launch<D, STATIC, true, false>(q, k, v, st, ks, p, B, Sk, s)
              : launch<D, STATIC, false, false>(q, k, v, st, ks, p, B, Sk, s);
}

}  // namespace

extern "C" {

const char* sage_attn_q8_sm90_error_string(int e) {
  if (e == -1)
    return "unsupported B6 / B5-fp8 / B-pvbf16 / B5-int8 configuration (head_dim, GQA, "
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

// B6, B5-fp8 and their B10 forms on int8 Q codes q [B, Hq, Sq, D] with
// per-row scales q_scale [B*Hq*Sq], int8 K codes k [B, Hk, Sk, D] and bf16
// o [B, Hq, Sq, D]; `mode` 0 static, 1 online (B6: V codes widened to bf16
// v [B, Hk, Sk, D]), 2 B5-fp8 (v the e4m3 V^T [B, Hk, D, Sk padded to 16]
// of ops/attention.py `transpose_v_codes`, kv permuted within each 16), 3
// static and 4 online B-pvbf16 (v the caller's bf16 V [B, Hk, Sk, D], null
// v_scale and v_mean; out_f16 1 writes o as fp16, else bf16), 5 B5-int8
// (v the int8 V^T, as mode 2's);
// each with its own element strides (batch, head, row; unit column stride,
// 16-byte aligned base and outer strides); per-column K scales k_scale f32
// [B, Hk, ks_cols] with element strides (ks_sb, ks_sh), 16-byte aligned
// base and strides, or null when folded into q_scale; kn_max [B*Hq]
// (static), v_scale and v_mean (or null) [B*Hk*D] f32 (modes 0-2, 5), lse [B*Hq*Sq] (or
// null) f32 output; offsets [2] (q_start, kv_start) and kv_true [1], int32
// on the device, or null.
int sage_attn_fwd_q8_sm90(int D, int mode, const void* q, const void* k, const void* v,
                          void* o, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                          long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                          long long v_ss, long long o_sb, long long o_sh, long long o_ss,
                          const float* q_scale, const float* k_scale, long long ks_sb,
                          long long ks_sh, int ks_cols, const float* kn_max,
                          const float* v_scale, const float* v_mean, float* lse,
                          const int* offsets, const int* kv_true, int B, int Hq, int Hk, int Sq,
                          int Sk, int kv_len, int causal, int out_f16, void* stream) {
  const long long st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  const int ve = mode == FP8 || mode == I8P ? 1 : 2;
  const bool vb = mode == PVBF16_STATIC || mode == PVBF16_ONLINE;
  const int esize[9] = {1, 1, 1, 1, 1, 1, ve, ve, ve};
  for (int i = 0; i < 9; ++i)
    if (st[i] < 0 || (st[i] * esize[i]) % 16) return -1;
  if (mode < STATIC || mode > I8P || B < 1 || Hk < 1 || Hq % Hk || kv_len < 0 ||
      kv_len > Sk || !q_scale || (vb ? (v_scale || v_mean) : (!v_scale || out_f16)) ||
      ((mode == STATIC || mode == PVBF16_STATIC) && !kn_max) || (offsets && !causal) ||
      ((mode == FP8 || mode == I8P) && (Sk < 1 || v_ss < (Sk + 15) / 16 * 16)))
    return -1;
  if (k_scale && (reinterpret_cast<uintptr_t>(k_scale) % 16 || ks_sb < 0 || ks_sh < 0 ||
                  ks_cols < 1 || (B > 1 && (ks_sb * 4) % 16) || (Hk > 1 && (ks_sh * 4) % 16)))
    return -1;
  if (Sq == 0) return 0;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.q_scale = q_scale; p.kn_max = kn_max; p.v_scale = v_scale; p.v_mean = v_mean;
  p.lse = lse; p.offsets = offsets; p.kv_true = kv_true;
  p.Hq = Hq; p.Hk = Hk; p.Sq = Sq; p.kv_len = kv_len; p.causal = causal;
  p.out_f16 = out_f16;
  const KScale ks = {k_scale, ks_sb, ks_sh, ks_cols};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_d<64>(mode, q, k, v, st, ks, p, B, Sk, s);
  if (D == 128) return launch_d<128>(mode, q, k, v, st, ks, p, B, Sk, s);
  return -1;
}

}  // extern "C"
