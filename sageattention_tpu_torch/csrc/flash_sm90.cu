// B4, the bf16 flash forward, redesigned for Hopper: TMA loads completing
// on mbarriers, a ring of K/V stages, wgmma products, the softmax of one
// tile under the PV product of the one before, and warpgroups taking turns
// at the tensor cores.  Unmasked (B4) at head dims 64, 128 and 256, with
// an additive float bias (B4-float, the BIASED instantiations) at 64 and
// 128, and with P rounded to e2m1 (B4-fp4, SageAttention3's simulation of
// ops/lowbit.py; the FP4 instantiations) at 64, 128 and 256.
//
// Replaces the Pallas kernel `_attn_kernel` (sageattention_tpu/ops/
// attention.py:251, launched by `attention_call` with quantized=False) in
// the configurations with no mask, window, segments or ring offsets, and
// no bias, only a float one, or `p_sim_fp4` (its `_round_e2m1_tile`,
// attention.py:235, applied at :547); the others stay on attention.cuh's
// body (attention_ext.cu), as does the bias at D = 256, whose stages do
// not fit.  What it computes, as the plain version (ops/attention.py
// `attention_plain` at `flash_kv_tile(D)` columns, KV_TILE = 64 with a
// bias or FP4):
//   s = (q . k) * sm_scale * log2(e) in f32; the kv tail past kv_len and,
//   under causal, col > row (top-left) masked; with a bias, each score
//   s * fold rounded, then + bias * log2(e) rounded (the JAX kernel's
//   attention.py:519-521, after the masks; a masked score stays -inf, and a
//   bias of -inf gives P = 0); an online softmax in base 2
//   over BN-column kv tiles with the running max floored at M_CLAMP; P
//   rounded to bf16 per tile against the tile's running max while l sums
//   the unrounded f32 P (FP4: P first rounded onto the e2m1 grid at (its
//   row's tile max P) / 6, l summing the rounded P; see e2m1_fast); O +=
//   P V with f32 sums; out = O / l in bf16 and the base-2 lse m + log2(l)
//   in f32.  GQA maps head hq to hq / (Hq/Hk).
//
// What bounds it on the H100: the tensor cores (4 S^2 D flops, 989 TFLOP/s
// in bf16) and, at D = 64, nearly as much the exp2 of the softmax on the
// SFUs (S^2 of them at 16 per clock per SM).  The design:
//   block     NWG warpgroups of 64 query rows each, no producer warp: three
//             at D = 64 (192 rows, 384 threads), two at D = 128 and 256
//             (128 rows, 256 threads), one block per SM (shared memory).
//             ptxas caps a block of more than 256 threads at 168 registers
//             a thread, and a producer warpgroup's setmaxnreg (24/240) did
//             not raise the consumers' share enough in the build tried: at
//             D = 128 and 256 the accumulators spilled and every wgmma was
//             serialized.  Without one, the warpgroups hold 156 / 186 /
//             203 registers at D = 64 / 128 / 256 and nothing spills (the
//             smoke prints ptxas's report); at D = 64 the third warpgroup
//             hides the softmax's latencies and reads each K/V tile for 192
//             rows.
//   loads     Q once (its own mbarrier); K and V tiles of BN rows into a
//             ring of STAGES stages with a full barrier each for K and V.
//             The block's first thread issues Q and the first STAGES
//             tiles; afterwards the last of the block's warps to finish
//             with a stage (a shared counter per stage) issues the load of
//             the tile STAGES ahead into it, so loads run STAGES - 1 tiles
//             ahead of the products.  Tensor maps of rank 4 (D, S, H, B)
//             are built from the strides, so HND and NHD both load, and a
//             tile past Sq or kv_len is zero-filled instead of reading the
//             next head (the K/V maps end at kv_len).  Rows are 64-column
//             boxes of 128 bytes, 128-byte swizzled.
//   S = QK^T  wgmma m64nBNk16, A (Q) and B (K) from shared memory, K-major.
//   softmax   on the accumulator layout: a thread holds two rows, a quad
//             shares a row, maxima and sums by quad shuffles; the scale
//             rides in the FMA before each exp2.  P is packed to bf16
//             straight into the A fragments of the PV product.
//   O += PV   wgmma m64nDk16 with A (P) from registers and B = V from
//             shared memory as an MN-major operand (the transpose bit), so
//             V needs no transpose.
//   overlap   per warpgroup, S(kt) and O += P(kt-1) V(kt-1) are issued
//             together and the softmax of S(kt) runs under the PV product;
//             the warpgroups take turns to issue (named barriers), so that
//             one's softmax runs under another's products.
//   causal    the longest q tiles launch first; tiles past the block's last
//             row are never loaded, and only tiles that cross the diagonal
//             or the kv tail are masked.
//   tiles     BN = 128 at D = 64 and 128, 64 at D = 256, with 4 / 3 / 2
//             stages: Q and the stages take 152 / 224 / 192 KB of shared
//             memory.  At D = 256 the 64 x 256 f32 O accumulator alone is
//             128 registers a thread.
//   bias      the f32 bias [B, 1|Hq, Sq, Sk] is the byte stream that sets
//             the time (1 GiB at MPT-7B's (2, 32, 2048, 128); causal reads
//             the tiles on and below the diagonal, about half).  Its tile
//             of BM rows x 64 columns rides in each K stage, on K's
//             barrier, as two boxes of 32 columns (128-byte rows, 128-byte
//             swizzled), so its loads run STAGES - 1 tiles ahead of the
//             products like K's and V's, and each thread reads its scores'
//             bias as float2 in the accumulator layout without bank
//             conflicts.  To make room the kv tile is 64 columns with 3
//             stages at D = 64 and 128 (216 / 224 KB); a batch or head
//             stride of 0 (a broadcast bias) maps that dimension at size 1,
//             so nothing is copied.  The fold trick of the unbiased softmax
//             does not hold with a bias: the maxima are taken over the
//             biased scores.
//   fp4       64-column tiles, the plain version's KV_TILE (the rounding
//             scale is each tile's row max), 4 stages at D = 64 and 128,
//             2 at 256.  The rounding is the design problem: its plain form
//             (an IEEE division and seven compare-selects an element) costs
//             several times the exp2's issue slots on the FP32 pipes.  The
//             kernel takes one reciprocal per row and tile and the grid
//             index from the bits of x (e2m1_fast: a multiply, an add, two
//             integer ops and a product an element, three more for the
//             check), and redoes by the plain rule only the 16-element
//             steps where some lane's quotient lands near a midpoint, so
//             no rounded value differs from the plain rule's on the
//             kernel's own P.
// An exp2 split between the SFUs and the FMA pipes, stores through shared
// memory, and a persistent grid are later work.
#include <stdio.h>

#include "sm90.cuh"

namespace flash90 {

using namespace sm90;

constexpr float M_CLAMP = -1e20f;   // floor of the running max
constexpr float LOG2E_F = 1.4426950408889634f;  // natural-log bias -> base 2

// The instantiations: B4, B4-float (an additive bias) and B4-fp4 (P
// rounded to e2m1).
enum Mode { PLAIN = 0, BIASED = 1, FP4 = 2 };

template <int D, int MODE = PLAIN>
struct Cfg {
  static constexpr bool BIAS = MODE == BIASED;
  static constexpr int NWG = D == 64 ? 3 : 2;     // warpgroups, 64 query rows each
  static constexpr int BM = 64 * NWG;             // query rows per block
  static constexpr int THREADS = 128 * NWG;
  // kv rows per tile (flash_kv_tile; KV_TILE = 64 with a bias or FP4)
  static constexpr int BN = MODE != PLAIN ? 64 : D <= 128 ? 128 : 64;
  static constexpr int STAGES = BIAS ? 3 : D == 256 ? 2 : D == 64 || MODE == FP4 ? 4 : 3;  // K/V ring depth
  static constexpr int CH = D / 64;               // 128-byte column boxes per row
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;     // one K or V stage
  static constexpr int BIAS_BYTES = BIAS ? BM * BN * 4 : 0;  // BN / 32 boxes of BM x 128 bytes
  static constexpr int SMEM = Q_BYTES + STAGES * (2 * KV_BYTES + BIAS_BYTES) + 1024;  // + slack
};

struct Params {
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_ss;
  float* lse;  // [B*Hq*Sq] base 2, or null
  int Hq, Hk, Sq, kv_len, causal;
  float fold;  // sm_scale * log2(e)
  int bias_b, bias_h;  // 1 where the bias steps over the batch / the heads, else 0
};

// --------------------------------------------------------------- kernel --

// The thread holding accumulator element i of a 64 x N wgmma tile owns row
// 16 * warp + lane / 4 (+8 for i % 4 >= 2) and column 8 * (i / 4) +
// 2 * (lane % 4) + i % 2.

// Issues S = Q K^T for one warpgroup: D/16 k16 steps, A (its 64 Q rows) and
// B (the K stage) from shared memory.
template <int D, int BM, int BN>
__device__ __forceinline__ void qk_issue(float (&sc)[BN / 2], uint32_t qlo, uint32_t klo) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss(sc, desc(qlo + (ks >> 2) * (BM * 128 / 16) + (ks & 3) * 2),
             desc(klo + (ks >> 2) * (BN * 128 / 16) + (ks & 3) * 2), ks > 0);
  wg_commit();
}

// Issues O += P V: BN/16 k16 steps, A (P) from registers, B (the V stage)
// MN-major from shared memory.
template <int D, int BN>
__device__ __forceinline__ void pv_issue(float (&o)[D / 2], const uint32_t (&pf)[BN / 16][4],
                                         uint32_t vlo) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs(o, pf[kk], desc(vlo + kk * (16 * 128 / 16)), 1);
  wg_commit();
}

// B4-fp4's e2m1 rounding of P at a row's scale s = (its tile max P) / 6,
// by the plain version's rule (ops/attention.py `_round_e2m1_tile`): x =
// p / s in IEEE f32, the grid {0, .5, 1, 1.5, 2, 3, 4, 6} with a strict >
// at each midpoint .25, .75, 1.25, 1.75, 2.5, 3.5, 5 (a tie rounds down),
// then q * s.  The plain form (a division, seven compare-selects) would
// cost several times the exp2's issue slots, so the kernel rounds from the
// bits of x instead: with z = x + 1 below 1 (the grid's spacing of .5
// there is that of one mantissa bit on [1, 2)) and z = x above, q is z
// rounded to one mantissa bit, a tie down, minus that 1: (bits + 0x1FFFFF)
// & 0xFFC00000.  Every midpoint is such a tie, and x comes from one
// reciprocal per row and tile (x = p * r, r = 1 / s), which is within 2
// ulps of z of the quotient.  So the fast rounding equals the plain rule
// except where z lies within 16 ulps of a tie; `near` (the minimum over
// the elements of a masked remainder) reaches 0 exactly there, and the
// caller redoes those elements by the plain rule.
constexpr float E2M1_INV_MAX = (float)(1.0 / 6.0);
constexpr uint32_t TIE_DOWN = 0x1FFFFFu;     // rounds the mantissa to its top bit, a tie down
constexpr uint32_t TOP_BIT = 0xFFC00000u;    // sign, exponent and that bit
constexpr uint32_t NEAR_ADD = TIE_DOWN + 16u;
constexpr uint32_t NEAR_MASK = 0x3FFFE0u;    // 0 iff z is within -15 .. +16 ulps of a tie

__device__ __forceinline__ float e2m1_fast(float p, float s, float r, uint32_t& near) {
  const float x = __fmul_rn(p, r);
  const float c = x < 1.f ? 1.f : 0.f;
  const uint32_t u = __float_as_uint(__fadd_rn(x, c));
  near = min(near, (u + NEAR_ADD) & NEAR_MASK);
  return __fmul_rn(__fsub_rn(__uint_as_float((u + TIE_DOWN) & TOP_BIT), c), s);
}

__device__ __forceinline__ float e2m1_exact(float p, float s) {
  const float x = __fdiv_rn(p, s);
  const float q = x > 5.f ? 6.f : x > 3.5f ? 4.f : x > 2.5f ? 3.f : x > 1.75f ? 2.f
                : x > 1.25f ? 1.5f : x > 0.75f ? 1.f : x > 0.25f ? 0.5f : 0.f;
  return __fmul_rn(q, s);
}

// The online softmax of one S tile whose first column is k0, in place: the
// kv tail and causal masks where the tile crosses them, the new running
// maxima (the 4 lanes of a quad share a row) and their alphas, P =
// exp2(s * fold - m) in f32, and l summing that unrounded P.  With fold > 0
// the row max of the raw products, times fold, is the max of the scaled
// scores exactly (rounding is monotone), so the scale rides in one FMA with
// the max's subtraction; a masked score is -inf, whose P is 0.  With a bias
// (BIASED), the scores become s * fold + bias * log2(e) first, each product
// and the sum rounded as the plain version rounds them, read from the
// tile's bias stage `bt` (BM rows of two 32-column boxes, 128-byte
// swizzled: this thread's float2 of row r, column 8j + 2 q4 lies at
// `boff` + box (j / 4) + 16 * ((2 (j % 4)) ^ hr), with boff = 128 r + 8 (q4
// % 2) and hr = (q4 / 2) ^ (r % 8)), and the maxima are those of the
// biased scores.  FP4: P rounded onto the e2m1 grid at (the row's tile max
// P) / 6, that max taken against the new running max m' (floored at
// M_CLAMP), and l summing the rounded P, as `_p_tile` rounds it; 16
// elements a step, redone by the plain rule when any lane of the warp has
// one near a midpoint.
template <int BN, int MODE = PLAIN, int BM = 0>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], const Params& p, int k0,
                                             int row0, int rA, int rB, int q4, float& mA,
                                             float& mB, float& lA, float& lB, float& aA,
                                             float& aB, const uint8_t* bt = nullptr,
                                             int boff = 0, int hr = 0) {
  constexpr bool BIAS = MODE == BIASED;
  if constexpr (BIAS) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const uint8_t* at = bt + (j >> 2) * (BM * 128) + boff + (((2 * (j & 3)) ^ hr) << 4);
      const float2 bA = *reinterpret_cast<const float2*>(at);
      const float2 bB = *reinterpret_cast<const float2*>(at + 8 * 128);
      sc[4 * j] = __fadd_rn(__fmul_rn(sc[4 * j], p.fold), __fmul_rn(bA.x, LOG2E_F));
      sc[4 * j + 1] = __fadd_rn(__fmul_rn(sc[4 * j + 1], p.fold), __fmul_rn(bA.y, LOG2E_F));
      sc[4 * j + 2] = __fadd_rn(__fmul_rn(sc[4 * j + 2], p.fold), __fmul_rn(bB.x, LOG2E_F));
      sc[4 * j + 3] = __fadd_rn(__fmul_rn(sc[4 * j + 3], p.fold), __fmul_rn(bB.y, LOG2E_F));
    }
  }
  if (k0 + BN > p.kv_len || (p.causal && k0 + BN - 1 > row0)) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * q4 + (e & 1);
        if (col >= p.kv_len || (p.causal && col > (e < 2 ? rA : rB))) sc[4 * j + e] = -INFINITY;
      }
  }
  float cA = -INFINITY, cB = -INFINITY;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    cA = fmaxf(cA, fmaxf(sc[4 * j], sc[4 * j + 1]));
    cB = fmaxf(cB, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  cA = fmaxf(cA, __shfl_xor_sync(0xffffffffu, cA, 1));
  cA = fmaxf(cA, __shfl_xor_sync(0xffffffffu, cA, 2));
  cB = fmaxf(cB, __shfl_xor_sync(0xffffffffu, cB, 1));
  cB = fmaxf(cB, __shfl_xor_sync(0xffffffffu, cB, 2));
  if constexpr (!BIAS) {   // the tile maxima of the scaled scores
    cA = __fmul_rn(cA, p.fold);
    cB = __fmul_rn(cB, p.fold);
  }
  const float nA = fmaxf(fmaxf(mA, cA), M_CLAMP);
  const float nB = fmaxf(fmaxf(mB, cB), M_CLAMP);
  aA = ex2(__fsub_rn(mA, nA));
  aB = ex2(__fsub_rn(mB, nB));
  mA = nA;
  mB = nB;
  float pA = 0.f, pB = 0.f;
  if constexpr (MODE == FP4) {
    const float sA = __fmul_rn(fmaxf(ex2(__fsub_rn(cA, nA)), 1e-30f), E2M1_INV_MAX);
    const float sB = __fmul_rn(fmaxf(ex2(__fsub_rn(cB, nB)), 1e-30f), E2M1_INV_MAX);
    const float iA = __frcp_rn(sA), iB = __frcp_rn(sB);
#pragma unroll
    for (int g = 0; g < BN / 32; ++g) {
      float r[16];
      uint32_t near = NEAR_MASK;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float& x = sc[16 * g + i];
        const bool a = (i & 3) < 2;
        x = ex2(__fmaf_rn(x, p.fold, a ? -nA : -nB));
        r[i] = e2m1_fast(x, a ? sA : sB, a ? iA : iB, near);
      }
      if (__any_sync(0xffffffffu, near == 0)) {
#pragma unroll
        for (int i = 0; i < 16; ++i) r[i] = e2m1_exact(sc[16 * g + i], (i & 3) < 2 ? sA : sB);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        sc[16 * g + i] = r[i];
        if ((i & 3) < 2) pA += r[i];
        else pB += r[i];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if constexpr (BIAS) {
        sc[4 * j] = ex2(__fsub_rn(sc[4 * j], nA));
        sc[4 * j + 1] = ex2(__fsub_rn(sc[4 * j + 1], nA));
        sc[4 * j + 2] = ex2(__fsub_rn(sc[4 * j + 2], nB));
        sc[4 * j + 3] = ex2(__fsub_rn(sc[4 * j + 3], nB));
      } else {
        sc[4 * j] = ex2(__fmaf_rn(sc[4 * j], p.fold, -nA));
        sc[4 * j + 1] = ex2(__fmaf_rn(sc[4 * j + 1], p.fold, -nA));
        sc[4 * j + 2] = ex2(__fmaf_rn(sc[4 * j + 2], p.fold, -nB));
        sc[4 * j + 3] = ex2(__fmaf_rn(sc[4 * j + 3], p.fold, -nB));
      }
      pA += sc[4 * j] + sc[4 * j + 1];
      pB += sc[4 * j + 2] + sc[4 * j + 3];
    }
  }
  lA = __fadd_rn(__fmul_rn(aA, lA), pA);
  lB = __fadd_rn(__fmul_rn(aB, lB), pB);
}

// P in bf16, packed straight into the A fragments of the PV product: k16
// step kk takes the tile's columns 16 kk .. 16 kk + 15.
template <int BN>
__device__ __forceinline__ void pack_p(const float (&sc)[BN / 2], uint32_t (&pf)[BN / 16][4]) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    pf[j >> 1][(j & 1) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
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

// Grid (ceil(Sq / BM), Hq, B), Cfg<D, MODE>::THREADS threads; tm_b (the
// bias, BIASED only) is read by no other instantiation.
template <int D, int MODE>
__global__ void __launch_bounds__(Cfg<D, MODE>::THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_b, const Params p) {
  using C = Cfg<D, MODE>;
  constexpr int BM = C::BM, BN = C::BN, CH = C::CH, STAGES = C::STAGES, NWG = C::NWG;
  constexpr bool BIAS = C::BIAS;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // q full, then per stage: k full, v full
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  __shared__ int freed[STAGES];  // per stage: warps done with its tile
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle wants 1 KB
  const uint32_t sK = sQ + C::Q_BYTES;             // stage s at sK + s * KV_BYTES
  const uint32_t sV = sK + STAGES * C::KV_BYTES;
  const uint32_t sB = sV + STAGES * C::KV_BYTES;  // BIAS: stage s at sB + s * BIAS_BYTES
  const uint8_t* const gB = smem_raw + (sB - smem_u32(smem_raw));  // the same, generic
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

  const int tid = threadIdx.x;
  // K and V of tile kt into stage kt % STAGES, each completing on its full
  // barrier
  auto load_tile = [&](int kt) {
    const int s = kt % STAGES;
    mbar_expect_tx(bar_k + 8 * s, C::KV_BYTES + C::BIAS_BYTES);
#pragma unroll
    for (int c = 0; c < CH; ++c)
      tma_load4(sK + s * C::KV_BYTES + c * (BN * 128), &tm_k, bar_k + 8 * s, c * 64, kt * BN, hk,
                b);
    if constexpr (BIAS) {  // the bias tile rides on K's barrier
#pragma unroll
      for (int c = 0; c < BN / 32; ++c)
        tma_load4(sB + s * C::BIAS_BYTES + c * (BM * 128), &tm_b, bar_k + 8 * s, kt * BN + c * 32,
                  q0, hq * p.bias_h, b * p.bias_b);
    }
    mbar_expect_tx(bar_v + 8 * s, C::KV_BYTES);
#pragma unroll
    for (int c = 0; c < CH; ++c)
      tma_load4(sV + s * C::KV_BYTES + c * (BN * 128), &tm_v, bar_v + 8 * s, c * 64, kt * BN, hk,
                b);
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
#pragma unroll
    for (int c = 0; c < CH; ++c) tma_load4(sQ + c * (BM * 128), &tm_q, bar_q, c * 64, q0, hq, b);
    for (int kt = 0; kt < min(n_kt, STAGES); ++kt) load_tile(kt);
  }
  __syncthreads();

  {
    const int cw = tid / 128;  // the warpgroup: 64 query rows each
    const int lane = tid % 32, q4 = lane & 3;
    const int row0 = q0 + 64 * cw;
    const int rA = row0 + 16 * ((tid % 128) / 32) + (lane >> 2), rB = rA + 8;  // this thread's rows
    // BIAS: row rA's offset in a bias box and its swizzle bits (softmax_tile)
    const int boff = (rA - q0) * 128 + 8 * (q4 & 1), hr = (q4 >> 1) ^ (lane >> 2);
    // the warpgroups take turns, in order, to issue their products, so that
    // one's softmax runs under another's: named barrier 1 + w is warpgroup
    // w's turn, which warpgroup w - 1 hands over after issuing.  Every
    // warpgroup walks all n_kt tiles (a tile past its last row holds only
    // masked scores, an exact no-op), so all take n_kt + 1 turns.
    auto take_turn = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory"); };
    auto hand_over = [&]() {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (cw + 1) % NWG) : "memory");
    };
    if (cw == NWG - 1 && n_kt > 0) hand_over();  // warpgroup 0 goes first
    const uint32_t q_lo = desc_lo(sQ + cw * (64 * 128), 16);
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
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float mA = M_CLAMP, mB = M_CLAMP, lA = 0.f, lB = 0.f, aA, aB;
    uint32_t pf[BN / 16][4];  // P of the tile whose PV product is next
    mbar_wait(bar_q, 0);

    if (n_kt > 0) {  // tile 0: S, then its softmax
      float sc[BN / 2];
      mbar_wait(bar_k, 0);
      take_turn();
      wg_fence();
      qk_issue<D, BM, BN>(sc, opaque(q_lo), opaque(desc_lo(sK, 16)));
      hand_over();
      wg_wait<0>();
      reg_fence(sc);
      softmax_tile<BN, MODE, BM>(sc, p, 0, row0, rA, rB, q4, mA, mB, lA, lB, aA, aB, gB, boff,
                                 hr);
      pack_p<BN>(sc, pf);
    }
    // tile kt: S(kt) and O += P(kt-1) V(kt-1) in flight together; the
    // softmax of S(kt) runs under the PV product, then O takes alpha(kt)
    // and P(kt) is packed (the PV product's registers are not written
    // while it runs)
    for (int kt = 1; kt < n_kt; ++kt) {
      const int s = kt % STAGES, ps = (kt - 1) % STAGES;
      float sc[BN / 2];
      mbar_wait(bar_k + 8 * s, (kt / STAGES) & 1);
      mbar_wait(bar_v + 8 * ps, ((kt - 1) / STAGES) & 1);
      reg_fence(o);
      reg_fence_u(pf);
      take_turn();
      wg_fence();
      qk_issue<D, BM, BN>(sc, opaque(q_lo), opaque(desc_lo(sK + s * C::KV_BYTES, 16)));
      wg_fence();
      pv_issue<D, BN>(o, pf, opaque(desc_lo(sV + ps * C::KV_BYTES, BN * 128)));
      hand_over();
      wg_wait<1>();
      reg_fence(sc);
      softmax_tile<BN, MODE, BM>(sc, p, kt * BN, row0, rA, rB, q4, mA, mB, lA, lB, aA, aB,
                                 gB + s * C::BIAS_BYTES, boff, hr);
      wg_wait<0>();
      reg_fence(o);
      reg_fence_u(pf);
      reg_fence(sc);  // P is packed only now, into the registers the product has freed
      release(kt - 1);
      rescale<D>(o, aA, aB);
      pack_p<BN>(sc, pf);
    }
    if (n_kt > 0) {  // the last PV product
      const int ls = (n_kt - 1) % STAGES;
      mbar_wait(bar_v + 8 * ls, ((n_kt - 1) / STAGES) & 1);
      reg_fence(o);
      reg_fence_u(pf);
      take_turn();
      wg_fence();
      pv_issue<D, BN>(o, pf, opaque(desc_lo(sV + ls * C::KV_BYTES, BN * 128)));
      if (cw < NWG - 1) hand_over();  // the next warpgroups' last turns come after this one
      wg_wait<0>();
      reg_fence(o);
      release(n_kt - 1);
    }

    // ---------------- epilogue: O / l and the base-2 lse ----------------
    lA += __shfl_xor_sync(0xffffffffu, lA, 1);
    lA += __shfl_xor_sync(0xffffffffu, lA, 2);
    lB += __shfl_xor_sync(0xffffffffu, lB, 1);
    lB += __shfl_xor_sync(0xffffffffu, lB, 2);
    const float iA = __fdiv_rn(1.f, lA == 0.f ? 1.f : lA);
    const float iB = __fdiv_rn(1.f, lB == 0.f ? 1.f : lB);
    __nv_bfloat16* ob = p.o + b * p.o_sb + hq * p.o_sh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * q4;
      if (rA < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + rA * p.o_ss + c) =
            __floats2bfloat162_rn(__fmul_rn(o[4 * j], iA), __fmul_rn(o[4 * j + 1], iA));
      if (rB < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + rB * p.o_ss + c) =
            __floats2bfloat162_rn(__fmul_rn(o[4 * j + 2], iB), __fmul_rn(o[4 * j + 3], iB));
    }
    if (p.lse && q4 == 0) {
      float* lse = p.lse + (long long)(b * p.Hq + hq) * p.Sq;
      if (rA < p.Sq) lse[rA] = __fadd_rn(mA, log2f(fmaxf(lA, 1e-37f)));
      if (rB < p.Sq) lse[rB] = __fadd_rn(mB, log2f(fmaxf(lB, 1e-37f)));
    }
  }
}

}  // namespace flash90

// ------------------------------------------------------------------ host --

namespace {

using namespace flash90;

// The bias operand (BIAS): base, element strides (batch, head, row), its
// head count Hm (1 or Hq) and kv extent Sk.
struct Bias {
  const float* ptr;
  long long sb, sh, ss;
  int Hm, Sk;
};

template <int D, int MODE>
int launch(const void* q, const void* k, const void* v, const long long* st, const Bias& bias,
           Params p, int B, cudaStream_t stream) {
  using C = Cfg<D, MODE>;
  CUtensorMap mq, mk, mv, mb;
  const int kv_rows = p.kv_len > 0 ? p.kv_len : 1;  // n_kt = 0 loads nothing
  if (!make_map(&mq, q, D, p.Sq, p.Hq, B, st[2], st[1], st[0], C::BM) ||
      !make_map(&mk, k, D, kv_rows, p.Hk, B, st[5], st[4], st[3], C::BN) ||
      !make_map(&mv, v, D, kv_rows, p.Hk, B, st[8], st[7], st[6], C::BN))
    return -2;
  mb = mq;  // read only by the BIASED instantiations
  p.bias_b = p.bias_h = 0;
  if constexpr (C::BIAS) {
    // a dimension the bias does not step over maps at size 1, at coordinate 0
    p.bias_b = B > 1 && bias.sb != 0;
    p.bias_h = bias.Hm > 1 && bias.sh != 0;
    if (!make_map_t(&mb, bias.ptr, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, bias.Sk, p.Sq,
                    p.bias_h ? bias.Hm : 1, p.bias_b ? B : 1, bias.ss, bias.sh, bias.sb, 32,
                    C::BM, CU_TENSOR_MAP_SWIZZLE_128B))
      return -2;
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((p.Sq + C::BM - 1) / C::BM, p.Hq, B);
  flash_fwd_kernel<D, MODE><<<grid, C::THREADS, C::SMEM, stream>>>(mq, mk, mv, mb, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sage_flash_error_string(int e) {
  if (e == -1) return "unsupported flash configuration (head_dim, kv tile, GQA or strides)";
  if (e == -2) {
    static char msg[128];
    snprintf(msg, sizeof msg,
             "cuTensorMapEncodeTiled failed (result %d; -1: not found in the driver)",
             g_encode_result);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)e);
}

// B4 on bf16 q [B, Hq, Sq, D], k and v [B, Hk, Sk, D] and o [B, Hq, Sq, D],
// each with its own element strides (batch, head, row; unit column stride,
// 16-byte aligned base and outer strides).  `bn` must be the kv tile that
// the plain version walks (ops/attention.py `flash_kv_tile`, KV_TILE = 64
// with a bias or FP4).  `mode`: 0 B4, or B4-float when `bias` is given (f32
// [B, Hm, Sq, Sk], Hm 1 or Hq, with element strides (batch, head, row), a
// 16-byte aligned base and 16-byte multiples for every stride stepped over,
// which may be 0 but the row stride; null for none), 2 B4-fp4 (P rounded
// to e2m1; no bias).
int sage_flash_fwd(int D, int bn, int mode, const void* q, const void* k, const void* v, void* o,
                   long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                   long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                   long long v_ss, long long o_sb, long long o_sh, long long o_ss,
                   const float* bias, long long b_sb, long long b_sh, long long b_ss, int Hm,
                   float* lse, int B, int Hq, int Hk, int Sq, int Sk, int kv_len, int causal,
                   float fold, void* stream) {
  const long long st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  for (int i = 0; i < 9; ++i)
    if (st[i] < 0 || (st[i] * 2) % 16) return -1;
  if (B < 1 || Hk < 1 || Hq % Hk || kv_len < 0 || kv_len > Sk || !(fold > 0.f)) return -1;
  if ((mode != PLAIN && mode != FP4) || (mode == FP4 && bias)) return -1;
  const Bias bs = {bias, b_sb, b_sh, b_ss, Hm, Sk};
  if (bias && (reinterpret_cast<uintptr_t>(bias) % 16 || (Hm != 1 && Hm != Hq) ||
               b_sb < 0 || b_sh < 0 || (B > 1 && (b_sb * 4) % 16) ||
               (Hm > 1 && (b_sh * 4) % 16) || (Sq > 1 && ((b_ss * 4) % 16 || b_ss < Sk))))
    return -1;
  if (Sq == 0) return 0;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.lse = lse;
  p.Hq = Hq; p.Hk = Hk; p.Sq = Sq; p.kv_len = kv_len; p.causal = causal;
  p.fold = fold;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias) {
    if (D == 64 && bn == Cfg<64, BIASED>::BN) return launch<64, BIASED>(q, k, v, st, bs, p, B, s);
    if (D == 128 && bn == Cfg<128, BIASED>::BN)
      return launch<128, BIASED>(q, k, v, st, bs, p, B, s);
    return -1;
  }
  if (mode == FP4) {
    if (D == 64 && bn == Cfg<64, FP4>::BN) return launch<64, FP4>(q, k, v, st, bs, p, B, s);
    if (D == 128 && bn == Cfg<128, FP4>::BN) return launch<128, FP4>(q, k, v, st, bs, p, B, s);
    if (D == 256 && bn == Cfg<256, FP4>::BN) return launch<256, FP4>(q, k, v, st, bs, p, B, s);
    return -1;
  }
  if (D == 64 && bn == Cfg<64>::BN) return launch<64, PLAIN>(q, k, v, st, bs, p, B, s);
  if (D == 128 && bn == Cfg<128>::BN) return launch<128, PLAIN>(q, k, v, st, bs, p, B, s);
  if (D == 256 && bn == Cfg<256>::BN) return launch<256, PLAIN>(q, k, v, st, bs, p, B, s);
  return -1;
}

}  // extern "C"
