// B1, the static fused-Q int8 forward of `sageattn`'s main path, and its
// bf16-V twin B-pvbf16 (`sageattn(pv_dtype="bf16")` on a fused Q), redesigned
// for Hopper on flash_sm90.cu's skeleton: TMA loads completing on
// mbarriers, a ring of K/V stages, int8 wgmma for S = QK^T, the softmax of
// one tile under the PV product of the one before, and warpgroups taking
// turns at the tensor cores.
//
// Replaces the Pallas kernel `_attn_kernel` (sageattention_tpu/ops/
// attention.py:251, launched by `attention_call`) in B1's configuration
// (fuse_q_quant, fold_k_scale, the static softmax, int8 V under a bf16 P)
// with a bf16 Q at head dims 64 and 128 and no mask, window, segments or
// ring offsets, and in B-pvbf16's (the same with V in bf16 as given: no
// v_scale, no v_mean, out = O / l; the VB instantiations, selected by a
// null v_scale, whose only change is the epilogue); B1 at D = 256 or with
// an f32/f16 Q, B-pvbf16's online rerun, and every other configuration,
// stay on attention.cuh's body.  What it computes, as the
// plain version (ops/attention.py `attention_plain`):
//   qf = q * fold (fold = sm_scale * log2(e)); per row, qs = amax|qf| / 127
//   (1 for a zero row) and the codes q8 = clip(rint(qf * (1 / qs)), -127,
//   127); qse = qs * k_scale[head] and the cap C = (qse * ||q8||) * (kn_max
//   * (1 + 1e-5)); s = float(q8 . k8) * qse with the kv tail past kv_len
//   and, under causal, col > row masked; p = exp2(s - C) in f32 with no
//   running max (C bounds every score); l sums the unrounded p; O += bf16(p)
//   V with f32 sums over the int8 V codes; out = O * (1 / l) * v_scale[c] +
//   v_mean[c] in bf16, the base-2 lse C + log2(l), and lmin, the least l of
//   each 64-row query tile, which the pipeline reads once: a tile below
//   2^-100 makes it rerun the call online (B2, attention.cuh).
//
// What bounds it on the H100: the tensor cores (2 S^2 D int8 operations at
// 1979 TOP/s and 2 S^2 D bf16 ones at 989 TFLOP/s) and, at D = 64, the exp2
// of the softmax on the SFUs (S^2 of them at 16 per clock per SM).  The
// design, flash_sm90.cu's with these changes:
//   Q         one TMA load of the bf16 tile; each warp quantizes its 16
//             rows (a lane per D/32 columns, maxima and sums by warp
//             shuffles) into an int8 region in the swizzled K-major layout
//             its warpgroup's descriptor reads (128-byte rows at D = 128,
//             64-byte rows with the 64-byte swizzle at D = 64), with the
//             rows' qse and cap; a proxy fence and a block barrier make the
//             codes visible to wgmma.
//   K         int8 codes by TMA, one box of D bytes x BN rows per stage,
//             swizzled like Q's codes.
//   S = QK^T  wgmma m64n128k32 s32 += s8 x s8, both operands K-major from
//             shared memory (the only layout 8-bit wgmma takes); the s32
//             sums are exact (at most 127^2 x 256 < 2^24), so float(s32) *
//             qse equals the plain version's f32 product of the codes.
//   softmax   static: a multiply, an exp2 and a sum per score, no
//             maxima, alphas or rescale of O; P stays in the S registers
//             until the PV product has read the previous P (at D = 64 a
//             second P array spilled).
//   V         the int8 codes widened once per call to bf16 by the wrapper
//             (exact; v_scale stays in the epilogue), so V's path is B4's:
//             TMA, 128-byte swizzled 64-column boxes, an MN-major B operand
//             of the PV wgmma with P packed from the accumulators.
//   block     three warpgroups at D = 64 (192 rows), two at D = 128 (128
//             rows), no producer warp, kv tiles of 128 rows, 4 / 3 stages
//             (132 / 192 KB of shared memory); each warpgroup holds 64
//             query rows, one lmin tile.
//   causal    the longest q tiles first; tiles past the block's last row
//             are never loaded.
#include <stdio.h>

#include "sm90.cuh"

namespace attn90 {

using namespace sm90;

template <int D>
struct Cfg {
  static constexpr int NWG = D == 64 ? 3 : 2;  // warpgroups, 64 query rows each
  static constexpr int BM = 64 * NWG;          // query rows per block
  static constexpr int THREADS = 128 * NWG;
  static constexpr int BN = 128;               // kv rows per tile
  static constexpr int STAGES = D == 64 ? 4 : 3;
  static constexpr int CH = D / 64;            // 128-byte bf16 column boxes per row
  static constexpr int QB_BYTES = BM * D * 2;  // the bf16 Q tile
  static constexpr int Q8_BYTES = BM * D;      // its int8 codes
  static constexpr int K_BYTES = BN * D;       // one int8 K stage
  static constexpr int V_BYTES = BN * D * 2;   // one bf16 V stage
  static constexpr int SMEM = QB_BYTES + Q8_BYTES + STAGES * (K_BYTES + V_BYTES) + 1024;
};

struct Params {
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_ss;
  const float* k_head_scale;  // [B*Hk]
  const float* kn_max;        // [B*Hq]
  const float* v_scale;       // [B*Hk*D]
  const float* v_mean;        // [B*Hk*D], or null
  float* lse;                 // [B*Hq*Sq] base 2, or null
  float* lmin;                // [B*Hq*ceil(Sq/64)]
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
template <int D>
__device__ __forceinline__ void qk_issue(int (&si)[64], uint32_t qlo, uint32_t klo) {
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

// The static softmax of one S tile whose first column is k0, in place (the
// f32 P in the bits of the s32 sums): s = float(s32) * qse, the kv tail and
// causal masks where the tile crosses them (P = 0), P = exp2(s - C) in
// f32, and l summing that unrounded P.  A thread holds rows rA and rB = rA
// + 8 and, of accumulator element i, column 8 (i / 4) + 2 (lane % 4) + i %
// 2 (+8 rows for i % 4 >= 2).
template <int BN>
__device__ __forceinline__ void softmax_static(int (&si)[BN / 2], const Params& p, int k0,
                                               int row0, int rA, int rB, int q4, float qA,
                                               float qB, float cA, float cB, float& lA,
                                               float& lB) {
  float sc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    sc[4 * j] = __fmul_rn((float)si[4 * j], qA);
    sc[4 * j + 1] = __fmul_rn((float)si[4 * j + 1], qA);
    sc[4 * j + 2] = __fmul_rn((float)si[4 * j + 2], qB);
    sc[4 * j + 3] = __fmul_rn((float)si[4 * j + 3], qB);
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
  float pA = 0.f, pB = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    sc[4 * j] = ex2(__fsub_rn(sc[4 * j], cA));
    sc[4 * j + 1] = ex2(__fsub_rn(sc[4 * j + 1], cA));
    sc[4 * j + 2] = ex2(__fsub_rn(sc[4 * j + 2], cB));
    sc[4 * j + 3] = ex2(__fsub_rn(sc[4 * j + 3], cB));
    pA += sc[4 * j] + sc[4 * j + 1];
    pB += sc[4 * j + 2] + sc[4 * j + 3];
  }
  lA = __fadd_rn(lA, pA);
  lB = __fadd_rn(lB, pB);
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

// Grid (ceil(Sq / BM), Hq, B), Cfg<D>::THREADS threads.  VB: V in bf16 as
// given (B-pvbf16), out = O / l.
template <int D, bool VB>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
    attn_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using C = Cfg<D>;
  constexpr int BM = C::BM, BN = C::BN, CH = C::CH, STAGES = C::STAGES, NWG = C::NWG;
  constexpr int E = D / 32;  // Q columns per lane in the quantization
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // q full, then per stage: k full, v full
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  __shared__ int freed[STAGES];  // per stage: warps done with its tile
  __shared__ float s_qse[BM], s_cap[BM];
  __shared__ float s_lmin[4 * NWG];
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
  // K (one box of D bytes) and V (CH boxes of 64 bf16 columns) of tile kt
  // into stage kt % STAGES, each completing on its full barrier
  auto load_tile = [&](int kt) {
    const int s = kt % STAGES;
    mbar_expect_tx(bar_k + 8 * s, C::K_BYTES);
    tma_load4(sK + s * C::K_BYTES, &tm_k, bar_k + 8 * s, 0, kt * BN, hk, b);
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
    mbar_expect_tx(bar_q, C::QB_BYTES);
#pragma unroll
    for (int c = 0; c < CH; ++c) tma_load4(sQb + c * (BM * 128), &tm_q, bar_q, c * 64, q0, hq, b);
    for (int kt = 0; kt < min(n_kt, STAGES); ++kt) load_tile(kt);
  }
  __syncthreads();

  // ---------------- Q: int8 codes, row scales and caps ----------------
  mbar_wait(bar_q, 0);
  {
    const float ksh = p.k_head_scale[b * p.Hk + hk];
    const float kcap = __fmul_rn(p.kn_max[b * p.Hq + hq], (float)(1.0 + 1e-5));
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
      float n2 = 0.f;
      uint32_t packed = 0;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const float c = fminf(fmaxf(rintf(__fmul_rn(qf[i], inv)), -127.f), 127.f);
        n2 += c * c;  // exact integer sum
        packed |= (uint32_t)(uint8_t)(int8_t)c << (8 * i);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) n2 += __shfl_xor_sync(0xffffffffu, n2, o);
      uint8_t* dst = gQ8 + (r >> 6) * (64 * D) + q8_offset<D>(r & 63, k);
      if constexpr (E == 4) *reinterpret_cast<uint32_t*>(dst) = packed;
      else *reinterpret_cast<uint16_t*>(dst) = (uint16_t)packed;
      if (lane == 0) {
        const float qse = __fmul_rn(qs, ksh);
        s_qse[r] = qse;
        s_cap[r] = __fmul_rn(__fmul_rn(qse, sqrtf(n2)), kcap);
      }
    }
    fence_async_smem();  // the codes are read by wgmma (the async proxy)
  }
  __syncthreads();

  {
    const int cw = tid / 128;  // the warpgroup: 64 query rows each
    const int q4 = lane & 3;
    const int row0 = q0 + 64 * cw;
    const int lA = 64 * cw + 16 * (warp & 3) + (lane >> 2);  // this thread's rows, in the block
    const int rA = q0 + lA, rB = rA + 8;
    const float qA = s_qse[lA], qB = s_qse[lA + 8], cA = s_cap[lA], cB = s_cap[lA + 8];
    // the warpgroups take turns, in order, to issue their products (named
    // barrier 1 + w is warpgroup w's turn, handed over by w - 1 after
    // issuing); every warpgroup walks all n_kt tiles, so all take n_kt + 1
    // turns
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
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float lsA = 0.f, lsB = 0.f;
    uint32_t pf[BN / 16][4];  // P of the tile whose PV product is next

    if (n_kt > 0) {  // tile 0: S, then its softmax
      int si[BN / 2];
      mbar_wait(bar_k, 0);
      take_turn();
      wg_fence();
      qk_issue<D>(si, opaque(q_lo), opaque(desc_lo(sK, 16)));
      hand_over();
      wg_wait<0>();
      reg_fence(si);
      softmax_static<BN>(si, p, 0, row0, rA, rB, q4, qA, qB, cA, cB, lsA, lsB);
      pack_p<BN>(si, pf);
    }
    // tile kt: S(kt) and O += P(kt-1) V(kt-1) in flight together; the
    // softmax of S(kt) runs under the PV product, and P(kt) is packed only
    // once the product has read P(kt-1) (the PV product's registers are not
    // written while it runs)
    for (int kt = 1; kt < n_kt; ++kt) {
      const int s = kt % STAGES, ps = (kt - 1) % STAGES;
      int si[BN / 2];
      mbar_wait(bar_k + 8 * s, (kt / STAGES) & 1);
      mbar_wait(bar_v + 8 * ps, ((kt - 1) / STAGES) & 1);
      reg_fence(o);
      reg_fence_u(pf);
      take_turn();
      wg_fence();
      qk_issue<D>(si, opaque(q_lo), opaque(desc_lo(sK + s * C::K_BYTES, 16)));
      wg_fence();
      pv_issue<D, BN>(o, pf, opaque(desc_lo(sV + ps * C::V_BYTES, BN * 128)));
      hand_over();
      wg_wait<1>();
      reg_fence(si);
      softmax_static<BN>(si, p, kt * BN, row0, rA, rB, q4, qA, qB, cA, cB, lsA, lsB);
      wg_wait<0>();
      reg_fence(o);
      reg_fence_u(pf);
      reg_fence(si);
      release(kt - 1);
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

    // ---- epilogue: O / l * v_scale + v_mean (VB: O / l), the base-2 lse, lmin ----
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
        if (rA < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + rA * p.o_ss + c) =
              __floats2bfloat162_rn(__fmul_rn(o[4 * j], iA), __fmul_rn(o[4 * j + 1], iA));
        if (rB < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + rB * p.o_ss + c) =
              __floats2bfloat162_rn(__fmul_rn(o[4 * j + 2], iB), __fmul_rn(o[4 * j + 3], iB));
      }
    } else {
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
    }
    if (p.lse && q4 == 0) {
      float* lse = p.lse + (long long)(b * p.Hq + hq) * p.Sq;
      if (rA < p.Sq) lse[rA] = __fadd_rn(cA, log2f(fmaxf(lsA, 1e-37f)));
      if (rB < p.Sq) lse[rB] = __fadd_rn(cB, log2f(fmaxf(lsB, 1e-37f)));
    }
    // lmin of this warpgroup's 64 rows (one lmin tile: q0 is a multiple of 64)
    float lm = fminf(rA < p.Sq ? lsA : 3e38f, rB < p.Sq ? lsB : 3e38f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) lm = fminf(lm, __shfl_xor_sync(0xffffffffu, lm, off));
    if (lane == 0) s_lmin[warp] = lm;
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + NWG + cw) : "memory");
    if (tid % 128 == 0 && row0 < p.Sq) {
      const float m = fminf(fminf(s_lmin[4 * cw], s_lmin[4 * cw + 1]),
                            fminf(s_lmin[4 * cw + 2], s_lmin[4 * cw + 3]));
      p.lmin[(long long)(b * p.Hq + hq) * ((p.Sq + 63) / 64) + row0 / 64] = m;
    }
  }
}

}  // namespace attn90

// ------------------------------------------------------------------ host --

namespace {

using namespace attn90;

template <int D, bool VB>
int launch(const void* q, const void* k, const void* v, const long long* st, const Params& p,
           int B, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap mq, mk, mv;
  const int kv_rows = p.kv_len > 0 ? p.kv_len : 1;  // n_kt = 0 loads nothing
  if (!make_map(&mq, q, D, p.Sq, p.Hq, B, st[2], st[1], st[0], C::BM) ||
      !make_map_t(&mk, k, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, kv_rows, p.Hk, B, st[5], st[4],
                  st[3], D, C::BN,
                  D == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map(&mv, v, D, kv_rows, p.Hk, B, st[8], st[7], st[6], C::BN))
    return -2;
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_sm90_kernel<D, VB>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((p.Sq + C::BM - 1) / C::BM, p.Hq, B);
  attn_sm90_kernel<D, VB><<<grid, C::THREADS, C::SMEM, stream>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sage_attn_sm90_error_string(int e) {
  if (e == -1)
    return "unsupported B1 / B-pvbf16 configuration (head_dim, GQA, strides or pointers)";
  if (e == -2) {
    static char msg[128];
    snprintf(msg, sizeof msg,
             "cuTensorMapEncodeTiled failed (result %d; -1: not found in the driver)",
             g_encode_result);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)e);
}

// B1 on bf16 q [B, Hq, Sq, D], int8 K codes k [B, Hk, Sk, D], V codes
// widened to bf16 v [B, Hk, Sk, D] and bf16 o [B, Hq, Sq, D], each with its
// own element strides (batch, head, row; unit column stride, 16-byte
// aligned base and outer strides); k_head_scale [B*Hk], kn_max [B*Hq],
// v_scale and v_mean (or null) [B*Hk*D] f32, lse [B*Hq*Sq] (or null) and
// lmin [B*Hq*ceil(Sq/64)] f32 outputs.  A null v_scale runs B-pvbf16: v the
// caller's bf16 V, no v_scale or v_mean (v_mean must be null too).
int sage_attn_fwd_sm90(int D, const void* q, const void* k, const void* v, void* o,
                       long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                       long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                       long long v_ss, long long o_sb, long long o_sh, long long o_ss,
                       const float* k_head_scale, const float* kn_max, const float* v_scale,
                       const float* v_mean, float* lse, float* lmin, int B, int Hq, int Hk,
                       int Sq, int Sk, int kv_len, int causal, float fold, void* stream) {
  const long long st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  const int esize[9] = {2, 2, 2, 1, 1, 1, 2, 2, 2};
  for (int i = 0; i < 9; ++i)
    if (st[i] < 0 || (st[i] * esize[i]) % 16) return -1;
  if (B < 1 || Hk < 1 || Hq % Hk || kv_len < 0 || kv_len > Sk || !(fold > 0.f) ||
      !k_head_scale || !kn_max || (!v_scale && v_mean) || !lmin)
    return -1;
  if (Sq == 0) return 0;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.k_head_scale = k_head_scale; p.kn_max = kn_max; p.v_scale = v_scale; p.v_mean = v_mean;
  p.lse = lse; p.lmin = lmin;
  p.Hq = Hq; p.Hk = Hk; p.Sq = Sq; p.kv_len = kv_len; p.causal = causal;
  p.fold = fold;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vb = v_scale == nullptr;
  if (D == 64)
    return vb ? launch<64, true>(q, k, v, st, p, B, s) : launch<64, false>(q, k, v, st, p, B, s);
  if (D == 128)
    return vb ? launch<128, true>(q, k, v, st, p, B, s) : launch<128, false>(q, k, v, st, p, B, s);
  return -1;
}

}  // extern "C"
