// SageAttention forward for Hopper: one kernel templated on the
// configuration, included by attention.cu (Q quantized in the kernel, and
// the bf16 flash baseline) and attention_q8.cu (Q quantized beforehand),
// which build in parallel.
//
// Replaces the Pallas kernel `_attn_kernel` (sageattention_tpu/ops/
// attention.py, launched by `attention_call`) in these configurations:
//   Q source  fused: float Q, quantized per row here (int8, x sm_scale*log2e)
//                    or scaled to bf16 (bf16 compute); the per-head K scale
//                    folds into the row scale.
//             pre-quantized: int8 Q codes with a per-row f32 scale
//                    (q_scale), dequantized to bf16 under bf16 compute.
//   K scale   folded (per head, in the row scale) or per column (k_scale,
//             the fine granularities): s = (s32 * qs_row) * ks_col.
//   softmax   static: p = exp2(s - C_i) under the Cauchy-Schwarz cap C_i;
//             online: running max m, rescale by alpha = exp2(m - m').
//   P and V   bf16 P with int8 V (scale in the epilogue) or bf16 V;
//             int8 P = rint(exp2(s - m + log2 127)) with int8 V, l summing
//             the codes / 127; e4m3 P = e4m3(exp2(s - m + log2 448)) with
//             e4m3 V, l summing the rounded P (online softmax only).
// Shared rules: causal with above-diagonal tiles skipped, the kv tail
// masked beyond kv_len, GQA through h / (Hq/Hk), head dim 64 or 128.
//
// The EXT instantiations (built by attention_ext.cu / attention_q8_ext.cu)
// add the options of the Pallas kernel's B7-B9 configurations, every one a
// runtime switch; the plain instantiations compile none of this code:
//   bool mask   keep-mask [B, 1|Hq, Sq, Sk] with a 64x64 tile table (0 dead,
//               1 partly live, 2 fully live): a dead tile skips its loads
//               and compute (JAX remaps the dead block's DMA instead, a TPU
//               tactic), and only a partly live one reads the mask;
//   float bias  additive, natural-log units, times log2(e) here;
//   segments    q/kv segment ids must match (q pads -1, kv pads -2); the
//               ids' range over each 64-row tile (a table) lets a tile whose
//               rows and columns share no id be skipped, and one whose rows
//               and columns all carry the same id go unmasked;
//   window      causal band [r - W + 1, r] plus sink columns (global
//               positions < sinks, or per segment through kv_segpos with a
//               tile table): tiles below the band that hold no sink are
//               skipped, so the work is O(S (W + sinks));
//   row K scale fuse_k_rows: a per-query-row K scale (varlen's per-segment
//               scale) in place of the per-head one.
// The masks apply after the scale and before the softmax, in the Pallas
// kernel's order (tail, causal and band, segments, bool, then the bias),
// and only on the tiles that need them.  A skipped tile holds only masked
// scores, which change no running sum, so skipping is exact.
//
// What bounds it on the H100: tensor-core issue rate and the exp2 of the
// softmax (S^2 work against S*D bytes).  This version is simple: 4 warps
// own 64 query rows (16 each), K/V tiles of 64 rows are staged in shared
// memory with plain loads, and the products run on mma.sync (m16n8k32 s8
// for the int8 QK^T, m16n8k16 bf16 for the rest and for every PV).  The Q
// tile goes once into registers; the P tile goes from the QK^T accumulators
// straight into the PV A-fragments; V is staged as bf16 and read with
// ldmatrix.trans.  Quantized P and e4m3 V are exact in bf16, so their PV
// product is the bf16 mma of the codes with f32 sums, accumulated straight
// into the rescaled running sum (the Pallas kernel adds a per-tile dot; the
// two differ in f32 rounding only).  The staging and PV loops keep one
// order for every configuration, with K and V loads in flight together.
// A native e4m3 wgmma PV (V transposed in memory, two-level accumulation)
// is later work.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace sage_attn {

constexpr int BQ = 64;        // query rows per block (16 per warp)
constexpr int BK = 64;        // kv rows per tile
constexpr int kThreads = 128;
constexpr float MASK_NEG = -1e30f;  // added to masked scores
constexpr float M_CLAMP = -1e20f;   // floor of the running max
constexpr float FP8_OFFSET_LOG2 = 8.807354922057604f;    // log2(448)
constexpr float INT8_P_OFFSET_LOG2 = 6.988684686772166f; // log2(127)
constexpr float LOG2E_F = 1.4426950408889634f;          // natural-log bias -> base 2

enum QMode { Q_INT8 = 0, Q_BF16 = 1, Q_FLASH = 2 };
// P and V of the PV product
enum PVMode { PV_BF16P_I8V = 0, PV_BF16P_BF16V = 1, PV_I8P = 2, PV_F8P = 3 };

struct Params {
  const void* q; const void* k; const void* v; void* o;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  const float* q_scale;       // [B*Hq*Sq]   per row (pre-quantized Q), or null
  const float* k_scale;       // [B*Hk*Sk]   per column (fine K scales), or null
  const float* k_head_scale;  // [B*Hk]      (fused Q)
  const float* kn_max;        // [B*Hq]      (static)
  const float* v_scale;       // [B*Hk*D]    (int8 / e4m3 V)
  const float* v_mean;        // [B*Hk*D] or null
  float* lse;                 // [B*Hq*Sq] base 2, or null
  float* lmin;                // [B*Hq*n_qt] (static, fused Q), or null
  int Hq, Hk, Sq, Sk, kv_len, causal;
  float fold;                 // sm_scale * log2(e)
  // read by the EXT instantiations only
  const int8_t* mask;         // [B, Hm, Sq, Sk] bool keep-mask, or null
  const float* bias;          // [B, Hm, Sq, Sk] additive bias (natural log), or null
  long long m_sb, m_sh, m_ss; // mask / bias strides, unit column stride
  int Hm;
  const uint8_t* live;        // [B, Hm, n_qt, n_kt] bool-mask tiles: 0 dead, 1 partly, 2 fully live
  const int* q_seg;           // [B, Sq] segment ids, or null
  const int* kv_seg;          // [B, Sk]
  const int* kv_segpos;       // [B, Sk] position in its segment (per-segment sinks), or null
  const int* qseg_rng;        // [B, n_qt, 2] min and max q segment id per 64-row tile
  const int* kvseg_rng;       // [B, n_kt, 2] the same per 64-column kv tile
  const uint8_t* sinkblk;     // [B, n_kt] the kv tile holds a per-segment sink
  const float* k_row_scale;   // [B*Hq*Sq] per-row K scale (fuse_k_rows), or null
  int window, sinks;
};

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// E consecutive elements of a Q row as f32 (E = D/32: 2 or 4).
template <int E>
__device__ __forceinline__ void load_row_part(const __nv_bfloat16* p, float* x) {
#pragma unroll
  for (int i = 0; i < E; i += 2) {
    float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
    x[i] = f.x;
    x[i + 1] = f.y;
  }
}
template <int E>
__device__ __forceinline__ void load_row_part(const float* p, float* x) {
#pragma unroll
  for (int i = 0; i < E; i += 2) {
    float2 f = *reinterpret_cast<const float2*>(p + i);
    x[i] = f.x;
    x[i + 1] = f.y;
  }
}
template <int E>
__device__ __forceinline__ void load_row_part(const int8_t* p, float* x) {
  if constexpr (E == 2) {
    const char2 c = *reinterpret_cast<const char2*>(p);
    x[0] = c.x; x[1] = c.y;
  } else {
    const char4 c = *reinterpret_cast<const char4*>(p);
    x[0] = c.x; x[1] = c.y; x[2] = c.z; x[3] = c.w;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// T: the Q operand in global memory (bf16 / f32 float Q, int8 codes when
// pre-quantized); O: the output.
// The kernel body; attn_fwd_kernel (plain) and attn_fwd_ext_kernel (EXT)
// below are its two entry points.
template <int QM, bool STATIC, int PV, int D, bool EXT, typename T, typename O>
__device__ __forceinline__ void attn_fwd_body(const Params p) {
  constexpr bool KI8 = (QM == Q_INT8);          // K stays int8 in smem
  constexpr bool QPRE = std::is_same<T, int8_t>::value;
  constexpr int I8_STRIDE = D + 16;              // bytes per int8 row (padded)
  constexpr int BF_STRIDE = D + 8;               // elems per bf16 row (padded)
  constexpr int ROW_BYTES = KI8 ? I8_STRIDE : BF_STRIDE * 2;
  constexpr int KSTEPS = KI8 ? D / 32 : D / 16;  // mma k-steps over D
  constexpr int NT_D = D / 8;                    // 8-wide n-tiles over D
  constexpr int E = D / 32;                      // Q elems per lane per row
  constexpr int K_ELEM = (QM == Q_FLASH) ? 2 : 1;                        // bytes per K elem
  constexpr int V_ELEM = (QM == Q_FLASH || PV == PV_BF16P_BF16V) ? 2 : 1;  // bytes per V elem

  // sQK holds the Q tile until its fragments are in registers, then K tiles
  __shared__ __align__(16) uint8_t sQK[BQ * ROW_BYTES];
  __shared__ __align__(16) __nv_bfloat16 sV[BK * BF_STRIDE];
  __shared__ float s_qscale[BQ];
  __shared__ float s_cap[BQ];
  __shared__ float s_ks[BK];
  __shared__ float s_lmin[kThreads / 32];
  __shared__ __align__(8) int s_kvseg[EXT ? BK : 2];
  __shared__ int s_segpos[EXT ? BK : 1];

  const int n_qt = (p.Sq + BQ - 1) / BQ;
  // causal: the longest q tiles first, so the tail of the grid is short work
  const int qt = p.causal ? (n_qt - 1 - (int)blockIdx.x) : (int)blockIdx.x;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (p.Hq / p.Hk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * BQ;

  // ---------------- Q tile ----------------
  {
    const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + hq * p.q_sh;
    // per-head K scale, or 1 when per-column scales ride k_scale
    const float ksh = (QM != Q_FLASH && !QPRE && p.k_head_scale)
                          ? p.k_head_scale[b * p.Hk + hk] : 1.f;
    const float* ksr = (EXT && QM != Q_FLASH && !QPRE && p.k_row_scale)
                           ? p.k_row_scale + (long long)(b * p.Hq + hq) * p.Sq : nullptr;
    const float knmax = STATIC ? p.kn_max[b * p.Hq + hq] : 0.f;
    const float* qsr = QPRE ? p.q_scale + (long long)(b * p.Hq + hq) * p.Sq : nullptr;
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr, gr = q0 + r;
      const float kshr = (EXT && ksr && gr < p.Sq) ? ksr[gr] : ksh;
      float x[E];
      if (gr < p.Sq) {
        load_row_part<E>(qb + gr * p.q_ss + lane * E, x);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) x[i] = 0.f;
      }
      if (QM == Q_FLASH) {
        __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(sQK + r * ROW_BYTES) + lane * E;
#pragma unroll
        for (int i = 0; i < E; i += 2) store2(dst + i, x[i], x[i + 1]);
      } else if (QPRE) {
        // pre-quantized: x holds int8 codes, the row scale comes in
        const float qs = gr < p.Sq ? qsr[gr] : 1.f;
        float n2 = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) n2 += x[i] * x[i];  // exact integer sum
        if (KI8) {
          int8_t* dst = reinterpret_cast<int8_t*>(sQK + r * ROW_BYTES) + lane * E;
#pragma unroll
          for (int i = 0; i < E; ++i) dst[i] = (int8_t)x[i];
        } else {  // bf16 compute: Q dequantized once, (q8 * qs) rounded to bf16
          __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(sQK + r * ROW_BYTES) + lane * E;
#pragma unroll
          for (int i = 0; i < E; i += 2)
            store2(dst + i, __fmul_rn(x[i], qs), __fmul_rn(x[i + 1], qs));
        }
        n2 = sage::warp_sum(n2);
        if (lane == 0) {
          s_qscale[r] = qs;
          if (STATIC)
            s_cap[r] = __fmul_rn(__fmul_rn(qs, sqrtf(n2)), __fmul_rn(knmax, (float)(1.0 + 1e-5)));
        }
      } else if (QM == Q_INT8) {
        float qf[E], a = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) {
          qf[i] = __fmul_rn(x[i], p.fold);
          a = fmaxf(a, fabsf(qf[i]));
        }
        a = sage::warp_max(a);
        const float qs = a > 0.f ? __fmul_rn(a, (float)(1.0 / 127.0)) : 1.f;
        const float inv = __fdiv_rn(1.f, qs);
        float n2 = 0.f;
        int8_t* dst = reinterpret_cast<int8_t*>(sQK + r * ROW_BYTES) + lane * E;
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const float c = sage::code_i8(__fmul_rn(qf[i], inv));
          n2 += c * c;  // exact integer sum
          dst[i] = (int8_t)c;
        }
        n2 = sage::warp_sum(n2);
        if (lane == 0) {
          const float qse = __fmul_rn(qs, kshr);
          s_qscale[r] = qse;
          if (STATIC)
            s_cap[r] = __fmul_rn(__fmul_rn(qse, sqrtf(n2)),
                                 __fmul_rn(knmax, (float)(1.0 + 1e-5)));
        }
      } else {  // Q_BF16, fused: qe = q * fold * ks, rounded to bf16, never quantized
        float qe[E], n2 = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) {
          qe[i] = __fmul_rn(__fmul_rn(x[i], p.fold), kshr);
          n2 += qe[i] * qe[i];
        }
        __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(sQK + r * ROW_BYTES) + lane * E;
#pragma unroll
        for (int i = 0; i < E; i += 2) store2(dst + i, qe[i], qe[i + 1]);
        n2 = sage::warp_sum(n2);
        if (lane == 0 && STATIC)
          s_cap[r] = __fmul_rn(sqrtf(n2), __fmul_rn(knmax, (float)(1.0 + 1.0 / 128.0)));
      }
    }
  }
  __syncthreads();

  // this thread's two rows inside the warp's 16-row slab
  const int rA = warp * 16 + g, rB = rA + 8;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const uint8_t* base = KI8 ? sQK + ks * 32 + 4 * t : sQK + (ks * 16 + 2 * t) * 2;
    qa[ks][0] = *reinterpret_cast<const uint32_t*>(base + rA * ROW_BYTES);
    qa[ks][1] = *reinterpret_cast<const uint32_t*>(base + rB * ROW_BYTES);
    qa[ks][2] = *reinterpret_cast<const uint32_t*>(base + rA * ROW_BYTES + 16);
    qa[ks][3] = *reinterpret_cast<const uint32_t*>(base + rB * ROW_BYTES + 16);
  }
  const float qseA = KI8 ? s_qscale[rA] : 1.f, qseB = KI8 ? s_qscale[rB] : 1.f;
  float mA = STATIC ? s_cap[rA] : M_CLAMP, mB = STATIC ? s_cap[rB] : M_CLAMP;
  float lA = 0.f, lB = 0.f;
  float acc[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int n_kt = (p.kv_len + BK - 1) / BK;
  if (p.causal) n_kt = min(n_kt, (min(q0 + BQ, p.Sq) - 1) / BK + 1);
  const uint8_t* kbase = static_cast<const uint8_t*>(p.k);
  const uint8_t* vbase = static_cast<const uint8_t*>(p.v);
  const bool col_scale = p.k_scale != nullptr;
  const float* ksb = col_scale ? p.k_scale + (long long)(b * p.Hk + hk) * p.Sk : nullptr;
  // EXT: the rows' segment ids, the mask rows, and the tile tables' bases
  const int n_kt_all = (p.Sk + BK - 1) / BK;
  const int qsegA = (EXT && p.q_seg && q0 + rA < p.Sq) ? p.q_seg[(long long)b * p.Sq + q0 + rA] : -1;
  const int qsegB = (EXT && p.q_seg && q0 + rB < p.Sq) ? p.q_seg[(long long)b * p.Sq + q0 + rB] : -1;
  // the mask / bias rows of this thread's two query rows (null past Sq)
  const long long moff = EXT ? b * p.m_sb + (p.Hm == 1 ? 0 : hq) * p.m_sh : 0;
  const long long mrowA = moff + (long long)(q0 + rA) * p.m_ss;
  const long long mrowB = moff + (long long)(q0 + rB) * p.m_ss;
  const bool rowA_in = q0 + rA < p.Sq, rowB_in = q0 + rB < p.Sq;
  const uint8_t* live = (EXT && p.live)
      ? p.live + ((long long)(b * p.Hm + (p.Hm == 1 ? 0 : hq)) * n_qt + qt) * n_kt_all : nullptr;
  const int qlo = (EXT && p.q_seg) ? p.qseg_rng[((long long)b * n_qt + qt) * 2] : 0;
  const int qhi = (EXT && p.q_seg) ? p.qseg_rng[((long long)b * n_qt + qt) * 2 + 1] : 0;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    bool seg_cut = false;  // EXT: the tile needs the segment mask
    if (EXT) {  // block-uniform: a dead tile is skipped by every thread
      if (p.q_seg) {
        const int* kr = p.kvseg_rng + ((long long)b * n_kt_all + kt) * 2;
        if (qhi < kr[0] || qlo > kr[1]) continue;  // no row shares a column's segment
        seg_cut = !(qlo == qhi && kr[0] == kr[1] && qlo == kr[0]);
      }
      if (p.window) {
        bool in_band = k0 + BK - 1 >= q0 - (p.window - 1);
        if (p.sinks)
          in_band = in_band || (p.kv_segpos ? p.sinkblk[(long long)b * n_kt_all + kt] != 0
                                            : k0 < p.sinks);
        if (!in_band) continue;
      }
      if (live && !live[kt]) continue;
    }
    const bool mask_cut = EXT && p.mask && live[kt] == 1;  // a partly live tile
    __syncthreads();  // the previous tile (or the Q tile) has been consumed
    // ---- stage K and V (and the K column scales): 16 bytes of global
    // memory per tensor per thread per step, both loads in flight together;
    // a V row has at least as many 16-byte chunks as a K row ----
    constexpr int CHK = D * K_ELEM / 16, CHV = D * V_ELEM / 16;
    for (int idx = tid; idx < BK * CHV; idx += kThreads) {
      const int r = idx / CHV, c = idx % CHV, gr = k0 + r;
      const bool has_k = CHK == CHV || c < CHK;
      uint4 kq = make_uint4(0, 0, 0, 0), vq = make_uint4(0, 0, 0, 0);
      if (gr < p.kv_len) {
        if (has_k)
          kq = *reinterpret_cast<const uint4*>(
              kbase + (b * p.k_sb + hk * p.k_sh + gr * p.k_ss) * K_ELEM + c * 16);
        vq = *reinterpret_cast<const uint4*>(
            vbase + (b * p.v_sb + hk * p.v_sh + gr * p.v_ss) * V_ELEM + c * 16);
      }
      if (has_k) {
        if (KI8 || QM == Q_FLASH) {
          *reinterpret_cast<uint4*>(sQK + r * ROW_BYTES + c * 16) = kq;
        } else {  // int8 codes -> bf16 (exact)
          const int8_t* kc = reinterpret_cast<const int8_t*>(&kq);
          __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(sQK + r * ROW_BYTES) + c * 16;
#pragma unroll
          for (int i = 0; i < 16; i += 2) store2(dst + i, (float)kc[i], (float)kc[i + 1]);
        }
      }
      if (V_ELEM == 2) {
        *reinterpret_cast<uint4*>(sV + r * BF_STRIDE + c * 8) = vq;
      } else if (PV == PV_F8P) {  // e4m3 codes -> bf16 (exact, subnormals too)
        const __nv_fp8_e4m3* vc = reinterpret_cast<const __nv_fp8_e4m3*>(&vq);
        __nv_bfloat16* vd = sV + r * BF_STRIDE + c * 16;
#pragma unroll
        for (int i = 0; i < 16; i += 2)
          store2(vd + i, static_cast<float>(vc[i]), static_cast<float>(vc[i + 1]));
      } else {  // int8 codes -> bf16 (exact)
        const int8_t* vc = reinterpret_cast<const int8_t*>(&vq);
        __nv_bfloat16* vd = sV + r * BF_STRIDE + c * 16;
#pragma unroll
        for (int i = 0; i < 16; i += 2) store2(vd + i, (float)vc[i], (float)vc[i + 1]);
      }
    }
    if (col_scale && tid < BK) s_ks[tid] = k0 + tid < p.kv_len ? ksb[k0 + tid] : 0.f;
    if (EXT && p.kv_seg && tid < BK) {
      const int c = k0 + tid;
      s_kvseg[tid] = c < p.Sk ? p.kv_seg[(long long)b * p.Sk + c] : -3;
      if (p.kv_segpos) s_segpos[tid] = c < p.Sk ? p.kv_segpos[(long long)b * p.Sk + c] : (1 << 30);
    }
    __syncthreads();

    // ---- S = Q K^T for the warp's 16 rows x 64 columns ----
    float s[8][4];
    if (KI8) {
      int si[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) si[n][0] = si[n][1] = si[n][2] = si[n][3] = 0;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const uint8_t* kr = sQK + (n * 8 + g) * ROW_BYTES + ks * 32 + 4 * t;
          mma_s8(si[n], qa[ks], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 16));
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        s[n][0] = __fmul_rn((float)si[n][0], qseA);
        s[n][1] = __fmul_rn((float)si[n][1], qseA);
        s[n][2] = __fmul_rn((float)si[n][2], qseB);
        s[n][3] = __fmul_rn((float)si[n][3], qseB);
      }
      if (col_scale) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[n][i] = __fmul_rn(s[n][i], s_ks[n * 8 + 2 * t + (i & 1)]);
      }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const uint8_t* kr = sQK + (n * 8 + g) * ROW_BYTES + (ks * 16 + 2 * t) * 2;
          mma_bf16(s[n], qa[ks], *reinterpret_cast<const uint32_t*>(kr),
                   *reinterpret_cast<const uint32_t*>(kr + 16));
        }
      }
      if (QM == Q_FLASH) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[n][i] = __fmul_rn(s[n][i], p.fold);
      }
    }

    // ---- masks: kv tail and causal, only on tiles that straddle them ----
    const bool tail = k0 + BK > p.kv_len;
    const bool diag = p.causal && (k0 + BK - 1 > q0);
    if (tail || diag) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = k0 + n * 8 + 2 * t + (i & 1);
          const int row = q0 + (i < 2 ? rA : rB);
          if (col >= p.kv_len || (p.causal && col > row)) s[n][i] = MASK_NEG;
        }
    }
    if (EXT) {
      // the band's lower edge (tiles fully inside every row's band, or fully
      // among the dense sinks, need no band mask), segments, bool mask, bias;
      // one uniform pass each, on the tiles that need it
      const bool band_cut = p.window && k0 < q0 + BQ - 1 - (p.window - 1) &&
                            !(p.sinks && !p.kv_segpos && k0 + BK - 1 < p.sinks);
      if (band_cut) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int cc = n * 8 + 2 * t + (i & 1), col = k0 + cc;
            const int row = q0 + (i < 2 ? rA : rB);
            bool keep = col >= row - (p.window - 1);
            if (p.sinks) keep = keep || (p.kv_segpos ? s_segpos[cc] < p.sinks : col < p.sinks);
            if (!keep) s[n][i] = MASK_NEG;
          }
      }
      if (seg_cut) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int2 ks2 = *reinterpret_cast<const int2*>(s_kvseg + n * 8 + 2 * t);
          if (qsegA != ks2.x) s[n][0] = MASK_NEG;
          if (qsegA != ks2.y) s[n][1] = MASK_NEG;
          if (qsegB != ks2.x) s[n][2] = MASK_NEG;
          if (qsegB != ks2.y) s[n][3] = MASK_NEG;
        }
      }
      if (mask_cut) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = k0 + n * 8 + 2 * t + (i & 1);
            const bool in_row = i < 2 ? rowA_in : rowB_in;
            if (!in_row || col >= p.Sk || p.mask[(i < 2 ? mrowA : mrowB) + col] == 0)
              s[n][i] = MASK_NEG;
          }
      }
      if (p.bias) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = k0 + n * 8 + 2 * t + (i & 1);
            if ((i < 2 ? rowA_in : rowB_in) && col < p.Sk)
              s[n][i] = __fadd_rn(s[n][i],
                                  __fmul_rn(p.bias[(i < 2 ? mrowA : mrowB) + col], LOG2E_F));
          }
      }
    }

    // ---- softmax ----
    if (STATIC) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        s[n][0] = exp2f(__fsub_rn(s[n][0], mA));
        s[n][1] = exp2f(__fsub_rn(s[n][1], mA));
        s[n][2] = exp2f(__fsub_rn(s[n][2], mB));
        s[n][3] = exp2f(__fsub_rn(s[n][3], mB));
        lA += s[n][0] + s[n][1];
        lB += s[n][2] + s[n][3];
      }
    } else {
      float cA = -3e38f, cB = -3e38f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        cA = fmaxf(cA, fmaxf(s[n][0], s[n][1]));
        cB = fmaxf(cB, fmaxf(s[n][2], s[n][3]));
      }
      cA = sage::warp_max(cA, 4);  // the 4 lanes of a quad share a row
      cB = sage::warp_max(cB, 4);
      const float nA = fmaxf(fmaxf(mA, cA), M_CLAMP), nB = fmaxf(fmaxf(mB, cB), M_CLAMP);
      const float aA = exp2f(__fsub_rn(mA, nA)), aB = exp2f(__fsub_rn(mB, nB));
      mA = nA;
      mB = nB;
      float pA = 0.f, pB = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float e = __fsub_rn(s[n][i], i < 2 ? mA : mB);
          if (PV == PV_I8P) e = __fadd_rn(e, INT8_P_OFFSET_LOG2);
          if (PV == PV_F8P) e = __fadd_rn(e, FP8_OFFSET_LOG2);
          float pv = exp2f(e);
          if (PV == PV_I8P) pv = rintf(pv);                              // a code <= 127
          if (PV == PV_F8P) pv = static_cast<float>(__nv_fp8_e4m3(pv));  // e4m3, RNE
          s[n][i] = pv;
        }
        pA += s[n][0] + s[n][1];
        pB += s[n][2] + s[n][3];
      }
      if (PV == PV_I8P) {  // l sums the codes / 127 (exact integer partials)
        pA = __fmul_rn(pA, (float)(1.0 / 127.0));
        pB = __fmul_rn(pB, (float)(1.0 / 127.0));
      }
      lA = __fadd_rn(__fmul_rn(aA, lA), pA);
      lB = __fadd_rn(__fmul_rn(aB, lB), pB);
#pragma unroll
      for (int n = 0; n < NT_D; ++n) {
        acc[n][0] = __fmul_rn(acc[n][0], aA);
        acc[n][1] = __fmul_rn(acc[n][1], aA);
        acc[n][2] = __fmul_rn(acc[n][2], aB);
        acc[n][3] = __fmul_rn(acc[n][3], aB);
      }
    }

    // ---- O += P @ V (bf16 operands, f32 sums) ----
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, sV + (kk * 16 + (lane & 15)) * BF_STRIDE + nd * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * nd], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * nd + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // ---------------- epilogue ----------------
  lA += __shfl_xor_sync(0xffffffffu, lA, 1);
  lA += __shfl_xor_sync(0xffffffffu, lA, 2);
  lB += __shfl_xor_sync(0xffffffffu, lB, 1);
  lB += __shfl_xor_sync(0xffffffffu, lB, 2);
  const float invA = __fdiv_rn(1.f, lA == 0.f ? 1.f : lA);
  const float invB = __fdiv_rn(1.f, lB == 0.f ? 1.f : lB);
  const int growA = q0 + rA, growB = q0 + rB;
  O* ob = static_cast<O*>(p.o) + b * p.o_sb + hq * p.o_sh;
  constexpr bool VSCALE = QM != Q_FLASH && PV != PV_BF16P_BF16V;
  const float* vs = VSCALE ? p.v_scale + (long long)(b * p.Hk + hk) * D : nullptr;
  const float* vm = p.v_mean ? p.v_mean + (long long)(b * p.Hk + hk) * D : nullptr;
#pragma unroll
  for (int n = 0; n < NT_D; ++n) {
    const int c = n * 8 + 2 * t;
    float o[4] = {__fmul_rn(acc[n][0], invA), __fmul_rn(acc[n][1], invA),
                  __fmul_rn(acc[n][2], invB), __fmul_rn(acc[n][3], invB)};
    if (VSCALE) {
      float v0 = vs[c], v1 = vs[c + 1];
      if (PV == PV_I8P) {  // the static 1/127 of the int8 P codes
        v0 = __fmul_rn(v0, (float)(1.0 / 127.0));
        v1 = __fmul_rn(v1, (float)(1.0 / 127.0));
      }
      o[0] = __fmul_rn(o[0], v0);
      o[1] = __fmul_rn(o[1], v1);
      o[2] = __fmul_rn(o[2], v0);
      o[3] = __fmul_rn(o[3], v1);
    }
    if (vm) {
      o[0] = __fadd_rn(o[0], vm[c]);
      o[1] = __fadd_rn(o[1], vm[c + 1]);
      o[2] = __fadd_rn(o[2], vm[c]);
      o[3] = __fadd_rn(o[3], vm[c + 1]);
    }
    if (growA < p.Sq) store2(ob + growA * p.o_ss + c, o[0], o[1]);
    if (growB < p.Sq) store2(ob + growB * p.o_ss + c, o[2], o[3]);
  }
  if (p.lse && t == 0) {
    // base 2; the e4m3 exp offset rides in l and comes off here
    const float off = PV == PV_F8P ? FP8_OFFSET_LOG2 : 0.f;
    float* lse = p.lse + (long long)(b * p.Hq + hq) * p.Sq;
    if (growA < p.Sq) lse[growA] = __fsub_rn(__fadd_rn(mA, log2f(fmaxf(lA, 1e-37f))), off);
    if (growB < p.Sq) lse[growB] = __fsub_rn(__fadd_rn(mB, log2f(fmaxf(lB, 1e-37f))), off);
  }
  if (STATIC && p.lmin) {
    float lm = fminf(growA < p.Sq ? lA : 3e38f, growB < p.Sq ? lB : 3e38f);
    lm = sage::warp_min(lm);
    if (lane == 0) s_lmin[warp] = lm;
    __syncthreads();
    if (tid == 0) {
      float m = s_lmin[0];
      for (int w = 1; w < kThreads / 32; ++w) m = fminf(m, s_lmin[w]);
      p.lmin[(long long)(b * p.Hq + hq) * n_qt + qt] = m;
    }
  }
}

template <int QM, bool STATIC, int PV, int D, typename T, typename O>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(Params p) {
  attn_fwd_body<QM, STATIC, PV, D, false, T, O>(p);
}

// The EXT entry keeps the plain one's occupancy (3 blocks per SM at D = 128,
// 4 at D = 64): its extra state would otherwise push some instantiations
// past the register count that allows it.  The plain entry keeps the bare
// bound: any minimum-blocks hint changes how ptxas allocates its registers.
template <int QM, bool STATIC, int PV, int D, typename T, typename O>
__global__ void __launch_bounds__(kThreads, (D == 64 ? 4 : 3)) attn_fwd_ext_kernel(Params p) {
  attn_fwd_body<QM, STATIC, PV, D, true, T, O>(p);
}

// Runs the kernel for (qmode, static, pv, D) with Q operand T and output O,
// in the plain (EXT false) or the B7-B9 (EXT true) instantiation.
template <typename T, typename O, bool EXT>
struct Launcher {
  const Params& p;
  dim3 grid;
  cudaStream_t st;

  template <int QM, bool STATIC, int PV, int D>
  void launch() const {
    if constexpr (EXT)
      attn_fwd_ext_kernel<QM, STATIC, PV, D, T, O><<<grid, kThreads, 0, st>>>(p);
    else
      attn_fwd_kernel<QM, STATIC, PV, D, T, O><<<grid, kThreads, 0, st>>>(p);
  }

  template <int QM, bool STATIC, int PV>
  int d(int D) const {
    if (D == 64)
      launch<QM, STATIC, PV, 64>();
    else if (D == 128)
      launch<QM, STATIC, PV, 128>();
    else
      return -1;
    return (int)cudaGetLastError();
  }

  template <int QM>
  int pv(int pv_mode, int static_sm, int D) const {
    switch (pv_mode) {
      case PV_BF16P_I8V:
        return static_sm ? d<QM, true, PV_BF16P_I8V>(D) : d<QM, false, PV_BF16P_I8V>(D);
      case PV_BF16P_BF16V:
        return static_sm ? d<QM, true, PV_BF16P_BF16V>(D) : d<QM, false, PV_BF16P_BF16V>(D);
      case PV_I8P:
        if constexpr (QM == Q_INT8) return static_sm ? -1 : d<QM, false, PV_I8P>(D);
        return -1;
      case PV_F8P:
        if constexpr (QM == Q_INT8) return static_sm ? -1 : d<QM, false, PV_F8P>(D);
        return -1;
    }
    return -1;
  }

  int run(int qmode, int pv_mode, int static_sm, int D) const {
    if (qmode == Q_INT8) return pv<Q_INT8>(pv_mode, static_sm, D);
    if (qmode == Q_BF16) return pv<Q_BF16>(pv_mode, static_sm, D);
    return -1;
  }
};

inline Params make_params(const void* q, const void* k, const void* v, void* o,
                          const long long* st, const float* q_scale, const float* k_scale,
                          const float* k_head_scale, const float* kn_max, const float* v_scale,
                          const float* v_mean, float* lse, float* lmin, int Hq, int Hk, int Sq,
                          int Sk, int kv_len, int causal, float fold) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_sb = st[0]; p.q_sh = st[1]; p.q_ss = st[2];
  p.k_sb = st[3]; p.k_sh = st[4]; p.k_ss = st[5];
  p.v_sb = st[6]; p.v_sh = st[7]; p.v_ss = st[8];
  p.o_sb = st[9]; p.o_sh = st[10]; p.o_ss = st[11];
  p.q_scale = q_scale; p.k_scale = k_scale; p.k_head_scale = k_head_scale;
  p.kn_max = kn_max; p.v_scale = v_scale; p.v_mean = v_mean; p.lse = lse; p.lmin = lmin;
  p.Hq = Hq; p.Hk = Hk; p.Sq = Sq; p.Sk = Sk; p.kv_len = kv_len; p.causal = causal;
  p.fold = fold;
  p.mask = nullptr; p.bias = nullptr; p.m_sb = p.m_sh = p.m_ss = 0; p.Hm = 1;
  p.live = nullptr; p.q_seg = p.kv_seg = p.kv_segpos = nullptr; p.sinkblk = nullptr;
  p.qseg_rng = p.kvseg_rng = nullptr;
  p.k_row_scale = nullptr; p.window = p.sinks = 0;
  return p;
}

// The B7-B9 arguments of the *_ext entries.
inline void set_ext(Params& p, const int8_t* mask, const float* bias, long long m_sb,
                    long long m_sh, long long m_ss, int Hm, const uint8_t* live,
                    const int* q_seg, const int* kv_seg, const int* kv_segpos,
                    const int* qseg_rng, const int* kvseg_rng, const uint8_t* sinkblk,
                    const float* k_row_scale, int window, int sinks) {
  p.mask = mask; p.bias = bias; p.m_sb = m_sb; p.m_sh = m_sh; p.m_ss = m_ss; p.Hm = Hm;
  p.live = live; p.q_seg = q_seg; p.kv_seg = kv_seg; p.kv_segpos = kv_segpos;
  p.qseg_rng = qseg_rng; p.kvseg_rng = kvseg_rng;
  p.sinkblk = sinkblk; p.k_row_scale = k_row_scale; p.window = window; p.sinks = sinks;
}

// Checks the B7-B9 arguments: -1 for a combination the kernel cannot run.
inline int check_ext(const Params& p) {
  if ((p.mask && p.bias) || (p.mask && !p.live) || (p.Hm != 1 && p.Hm != p.Hq)) return -1;
  if ((p.q_seg == nullptr) != (p.kv_seg == nullptr)) return -1;
  if (p.q_seg && !(p.qseg_rng && p.kvseg_rng)) return -1;
  if (p.window && (!p.causal || p.mask || p.bias || p.window < 1)) return -1;
  if (p.sinks && (!p.window || (p.kv_segpos && (!p.sinkblk || !p.kv_seg)))) return -1;
  return 0;
}

}  // namespace sage_attn
