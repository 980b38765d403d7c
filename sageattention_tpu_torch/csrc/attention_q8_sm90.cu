// B6, the forward on a pre-quantized Q, and the ring's B10 forms of it,
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
// and online, and in the ring's B10 forms of it (parallel/ring.py:234-248:
// device causal offsets and a device true length), at head dims 64 and 128
// with a bf16 output; D = 256, an f32 output and every other configuration
// stay on attention.cuh's body.  What it computes, as the plain version
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
//   check is the predictive one, made before the launch.
//
// What bounds it on the H100: the tensor cores (2 S^2 D int8 operations at
// 1979 TOP/s and 2 S^2 D bf16 ones at 989 TFLOP/s) and, at D = 64, the
// exp2 of the softmax on the SFUs.  The design, attention_sm90.cu's with
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
//             boxes, an MN-major B operand of the PV wgmma.
//   block     three warpgroups at D = 64 (192 rows), two at D = 128 (128
//             rows), no producer warp; 4 / 3 stages (static) or 4 (online).
#include <stdio.h>

#include "sm90.cuh"

namespace q8sm90 {

using namespace sm90;

constexpr float M_CLAMP = -1e20f;  // floor of the running max

template <int D, bool ONLINE>
struct Cfg {
  static constexpr int NWG = D == 64 ? 3 : 2;  // warpgroups, 64 query rows each
  static constexpr int BM = 64 * NWG;          // query rows per block
  static constexpr int THREADS = 128 * NWG;
  static constexpr int BN = ONLINE ? 64 : 128; // kv rows per tile
  static constexpr int STAGES = ONLINE || D == 64 ? 4 : 3;
  static constexpr int CH = D / 64;            // 128-byte bf16 column boxes of a V row
  static constexpr int Q_BYTES = BM * D;       // the int8 Q codes
  static constexpr int K_BYTES = BN * D;       // one int8 K stage
  static constexpr int V_BYTES = BN * D * 2;   // one bf16 V stage
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

// Grid (ceil(Sq / BM), Hq, B), Cfg<D, ONLINE>::THREADS threads; tm_ks (the
// per-column K scales) is read by the COLK instantiations only.
template <int D, bool ONLINE, bool COLK>
__global__ void __launch_bounds__(Cfg<D, ONLINE>::THREADS, 1)
    attn_q8_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_ks, const Params p) {
  using C = Cfg<D, ONLINE>;
  constexpr int BM = C::BM, BN = C::BN, CH = C::CH, STAGES = C::STAGES, NWG = C::NWG;
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
  // bf16 columns) of tile kt into stage kt % STAGES, each completing on its
  // full barrier
  auto load_tile = [&](int kt) {
    const int s = kt % STAGES;
    mbar_expect_tx(bar_k + 8 * s, C::K_BYTES + (COLK ? C::KS_BYTES : 0));
    tma_load4(sK + s * C::K_BYTES, &tm_k, bar_k + 8 * s, 0, kt * BN, hk, b);
    if constexpr (COLK) tma_load4(sKS + s * C::KS_BYTES, &tm_ks, bar_k + 8 * s, kt * BN, 0, hk, b);
    mbar_expect_tx(bar_v + 8 * s, C::V_BYTES);
#pragma unroll
    for (int c = 0; c < CH; ++c)
      tma_load4(sV + s * C::V_BYTES + c * (BN * 128), &tm_v, bar_v + 8 * s, c * 64, kt * BN, hk,
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
  if constexpr (!ONLINE) {
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
    if constexpr (ONLINE)
      softmax_online<BN, COLK>(si, ks, kt * BN, kv_len, p.causal, p0, pA, pB, q4, qA, qB, mA,
                               mB, lsA, lsB, aA, aB);
    else
      softmax_static<BN, COLK>(si, ks, kt * BN, kv_len, p.causal, p0, pA, pB, q4, qA, qB, cA,
                               cB, lsA, lsB);
  };
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  uint32_t pf[BN / 16][4];  // P of the tile whose PV product is next

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
    pack_p<BN>(si, pf);
  }
  // tile kt: S(kt) and O += P(kt-1) V(kt-1) in flight together; the
  // softmax of S(kt) runs under the PV product, then (online) O takes
  // alpha(kt), and P(kt) is packed only once the product has read P(kt-1)
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
    pv_issue<D, BN>(o, pf, opaque(desc_lo(sV + ps * C::V_BYTES, BN * 128)));
    hand_over();
    wg_wait<1>();
    reg_fence(si);
    softmax(si, kt, s);
    wg_wait<0>();
    reg_fence(o);
    reg_fence_u(pf);
    reg_fence(si);
    release(kt - 1);
    if constexpr (ONLINE) rescale<D>(o, aA, aB);
    pack_p<BN>(si, pf);
  }
  if (n_kt > 0) {  // the last PV product
    const int ls = (n_kt - 1) % STAGES;
    mbar_wait(bar_v + 8 * ls, ((n_kt - 1) / STAGES) & 1);
    reg_fence(o);
    reg_fence_u(pf);
    take_turn();
    wg_fence();
    pv_issue<D, BN>(o, pf, opaque(desc_lo(sV + ls * C::V_BYTES, BN * 128)));
    if (cw < NWG - 1) hand_over();  // the next warpgroups' last turns come after this one
    wg_wait<0>();
    reg_fence(o);
    release(n_kt - 1);
  }

  // ------------- epilogue: O / l * v_scale + v_mean, the base-2 lse -------------
  lsA += __shfl_xor_sync(0xffffffffu, lsA, 1);
  lsA += __shfl_xor_sync(0xffffffffu, lsA, 2);
  lsB += __shfl_xor_sync(0xffffffffu, lsB, 1);
  lsB += __shfl_xor_sync(0xffffffffu, lsB, 2);
  const float iA = __fdiv_rn(1.f, lsA == 0.f ? 1.f : lsA);
  const float iB = __fdiv_rn(1.f, lsB == 0.f ? 1.f : lsB);
  __nv_bfloat16* ob = p.o + b * p.o_sb + hq * p.o_sh;
  const float* vs = p.v_scale + (long long)(b * p.Hk + hk) * D;
  const float* vm = p.v_mean ? p.v_mean + (long long)(b * p.Hk + hk) * D : nullptr;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * q4;
    const float2 sv = *reinterpret_cast<const float2*>(vs + c);
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
  if (p.lse && q4 == 0) {
    // static: the cap is the max the P were taken against
    const float bA = ONLINE ? mA : cA, bB = ONLINE ? mB : cB;
    float* lse = p.lse + (long long)(b * p.Hq + hq) * p.Sq;
    if (rA < p.Sq) lse[rA] = __fadd_rn(bA, log2f(fmaxf(lsA, 1e-37f)));
    if (rB < p.Sq) lse[rB] = __fadd_rn(bB, log2f(fmaxf(lsB, 1e-37f)));
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

template <int D, bool ONLINE, bool COLK>
int launch(const void* q, const void* k, const void* v, const long long* st, const KScale& ks,
           const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<D, ONLINE>;
  CUtensorMap mq, mk, mv, mks;
  const int kv_rows = p.kv_len > 0 ? p.kv_len : 1;  // n_kt = 0 loads nothing
  const CUtensorMapSwizzle swz = D == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  if (!make_map_t(&mq, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, p.Sq, p.Hq, B, st[2], st[1], st[0],
                  D, C::BM, swz) ||
      !make_map_t(&mk, k, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, kv_rows, p.Hk, B, st[5], st[4],
                  st[3], D, C::BN, swz) ||
      !make_map(&mv, v, D, kv_rows, p.Hk, B, st[8], st[7], st[6], C::BN))
    return -2;
  mks = mq;  // read only by the COLK instantiations
  if constexpr (COLK) {
    if (!make_map_t(&mks, ks.ptr, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ks.cols, 1, p.Hk, B, 0,
                    ks.sh, ks.sb, C::BN, 1, CU_TENSOR_MAP_SWIZZLE_NONE))
      return -2;
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_q8_sm90_kernel<D, ONLINE, COLK>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((p.Sq + C::BM - 1) / C::BM, p.Hq, B);
  attn_q8_sm90_kernel<D, ONLINE, COLK><<<grid, C::THREADS, C::SMEM, stream>>>(mq, mk, mv, mks, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int online, const void* q, const void* k, const void* v, const long long* st,
             const KScale& ks, const Params& p, int B, cudaStream_t s) {
  if (online)
    return ks.ptr ? launch<D, true, true>(q, k, v, st, ks, p, B, s)
                  : launch<D, true, false>(q, k, v, st, ks, p, B, s);
  return ks.ptr ? launch<D, false, true>(q, k, v, st, ks, p, B, s)
                : launch<D, false, false>(q, k, v, st, ks, p, B, s);
}

}  // namespace

extern "C" {

const char* sage_attn_q8_sm90_error_string(int e) {
  if (e == -1) return "unsupported B6 configuration (head_dim, GQA, strides or pointers)";
  if (e == -2) {
    static char msg[128];
    snprintf(msg, sizeof msg,
             "cuTensorMapEncodeTiled failed (result %d; -1: not found in the driver)",
             g_encode_result);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)e);
}

// B6 and B10-B6 on int8 Q codes q [B, Hq, Sq, D] with per-row scales
// q_scale [B*Hq*Sq], int8 K codes k [B, Hk, Sk, D], V codes widened to
// bf16 v [B, Hk, Sk, D] and bf16 o [B, Hq, Sq, D], each with its own
// element strides (batch, head, row; unit column stride, 16-byte aligned
// base and outer strides); per-column K scales k_scale f32 [B, Hk, ks_cols]
// with element strides (ks_sb, ks_sh), 16-byte aligned base and strides, or
// null when folded into q_scale; kn_max [B*Hq] (static), v_scale and v_mean
// (or null) [B*Hk*D] f32, lse [B*Hq*Sq] (or null) f32 output; offsets [2]
// (q_start, kv_start) and kv_true [1], int32 on the device, or null.
int sage_attn_fwd_q8_sm90(int D, int online, const void* q, const void* k, const void* v,
                          void* o, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                          long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                          long long v_ss, long long o_sb, long long o_sh, long long o_ss,
                          const float* q_scale, const float* k_scale, long long ks_sb,
                          long long ks_sh, int ks_cols, const float* kn_max,
                          const float* v_scale, const float* v_mean, float* lse,
                          const int* offsets, const int* kv_true, int B, int Hq, int Hk, int Sq,
                          int Sk, int kv_len, int causal, void* stream) {
  const long long st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  const int esize[9] = {1, 1, 1, 1, 1, 1, 2, 2, 2};
  for (int i = 0; i < 9; ++i)
    if (st[i] < 0 || (st[i] * esize[i]) % 16) return -1;
  if (B < 1 || Hk < 1 || Hq % Hk || kv_len < 0 || kv_len > Sk || !q_scale || !v_scale ||
      (!online && !kn_max) || (offsets && !causal))
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
  const KScale ks = {k_scale, ks_sb, ks_sh, ks_cols};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_d<64>(online, q, k, v, st, ks, p, B, s);
  if (D == 128) return launch_d<128>(online, q, k, v, st, ks, p, B, s);
  return -1;
}

}  // extern "C"
