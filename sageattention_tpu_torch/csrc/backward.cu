// Attention backward for Hopper: kernel C1 (dK, dV) and kernel C2 (dQ).
//
// Replaces the Pallas kernels of sageattention_tpu/ops/backward_pallas.py,
// launched by `attention_backward_pallas`:
//   C1  `_dkv_kernel`: one block per (kv tile, q head, batch) walks the q
//       tiles; dV += P^T dO and dK += dS^T Q in f32.
//   C2  `_dq_kernel`: one block per (q tile, q head, batch) walks the kv
//       tiles; dQ += dS K in f32.
// Both recompute the base-2 scores from the saved tensors, P = exp2(s -
// lse2) with lse2 = lse * log2(e), and dS = P * (dO V^T - D_i) with D_i =
// rowsum(dO * O) (computed by the wrapper).  The Pallas grid's sequential
// inner axis is the loop inside the block here.  Options, as in JAX:
//   quantized  s = (s32 * qs_row) * ks_col from per-row int8 codes (the q
//              codes carry sm_scale * log2(e)); the dK and dQ products take
//              q and k dequantized to bf16 (bf16(code * row scale)); dK's
//              epilogue multiplies by 1/log2(e) instead of sm_scale;
//   causal     tiles above the diagonal are skipped;
//   window     the causal band [r - W + 1, r] plus sink columns < sinks;
//              tiles outside every row's band that hold no sink are
//              skipped, so the work is O(S (W + sinks));
//   bool mask  keep-mask [B, 1|Hq, Sq, Sk] (int8) with the forward's 64x64
//              tile table: a dead tile is skipped, a fully live one reads
//              no mask.
// A pair outside the kept set gets P = 0 by a select, never a product: a
// row with no live key (a left-pad row under a mask) has lse2 = -inf or a
// huge negative value, where exp2 overflows, and inf * 0 would be NaN.
// The rounding points are JAX's: P is f32 for dS and bf16 for the dV
// product, dS is bf16 for the dK/dQ products, dO V^T is an f32 sum of bf16
// products, and every accumulator is f32.  The wrapper pads the sequences
// to 64 rows (padded q rows carry lse2 = 3e38, so their P is 0) and the
// head dim to 64, 128 or 256, and sums the GQA group's per-head dK/dV.
//
// What bounds it on the H100: the tensor cores and the exp2s (C1 runs four
// S^2 D products and C2 three, against S D bytes).  This first version is
// simple: 4 warps each own 16 rows of the block's 64-row tile, the tiles are
// staged in shared memory with plain 16-byte loads, and every product is an
// mma.sync (m16n8k32 s8 for the int8 S, m16n8k16 bf16 otherwise).  The
// score accumulators turn straight into the A fragments of the next
// product (P -> dV, dS -> dK/dQ), and the tiles on the other side of those
// products are read with ldmatrix.trans.  Only C1 keeps two D-wide
// accumulators; at D = 256 they would take 256 registers a thread, so C1
// runs 8 warps there, each pair of warps sharing 16 rows and splitting the
// D columns (the scores are computed by both).  wgmma, TMA and a persistent
// schedule are later work.
#include "common.cuh"

namespace {

constexpr int BT = 64;   // rows of every q tile and kv tile

struct BwdParams {
  const void* q;             // [B, Hq, Sqp, D] bf16, or int8 codes (quantized)
  const void* k;             // [B, Hk, Skp, D] bf16, or int8 codes
  const __nv_bfloat16* v;    // [B, Hk, Skp, D]
  const __nv_bfloat16* dO;   // [B, Hq, Sqp, D]
  const float* lse2;         // [B, Hq, Sqp] base-2 lse (3e38 on padded rows)
  const float* di;           // [B, Hq, Sqp] rowsum(dO * O)
  const float* qs;           // [B, Hq, Sqp] q row scales (quantized), or null
  const float* ks;           // [B, Hk, Skp] k row scales (quantized), or null
  const int8_t* mask;        // [B, Hm, Sqp, Skp] keep-mask, or null
  long long m_sb, m_sh, m_ss;
  int Hm;
  const uint8_t* live;       // [B, Hm, Sqp/64, Skp/64]: 0 dead, 1 partly, 2 fully live
  void* dk;                  // [B, Hq, Skp, D] per q head
  void* dv;
  void* dq;                  // [B, Hq, Sqp, D]
  int out_f32;               // outputs: 0 bf16, 1 f32
  int Hq, Hk, Sqp, Skp, causal, window, sinks;
  float fold;                // sm_scale * log2(e): the bf16 scores' scale
  float dk_fin, dq_fin;      // epilogue factors of dK and dQ
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

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copies BT rows of `row_bytes` (a multiple of 16) from contiguous global
// rows to shared rows `stride` bytes apart.
template <int NTH>
__device__ __forceinline__ void stage(uint8_t* dst, int stride, const uint8_t* src, int row_bytes) {
  const int ch = row_bytes / 16;
  for (int idx = threadIdx.x; idx < BT * ch; idx += NTH) {
    const int r = idx / ch, c = idx % ch;
    *reinterpret_cast<uint4*>(dst + r * stride + c * 16) =
        *reinterpret_cast<const uint4*>(src + (long long)r * row_bytes + c * 16);
  }
}

// BT rows of int8 codes -> bf16(code * scale[row]) at `stride` bytes a row.
template <int NTH, int D>
__device__ __forceinline__ void stage_dequant(uint8_t* dst, int stride, const int8_t* src,
                                              const float* scale) {
  constexpr int ch = D / 16;
  for (int idx = threadIdx.x; idx < BT * ch; idx += NTH) {
    const int r = idx / ch, c = idx % ch;
    const uint4 u = *reinterpret_cast<const uint4*>(src + (long long)r * D + c * 16);
    const int8_t* x = reinterpret_cast<const int8_t*>(&u);
    const float s = scale[r];
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(dst + r * stride + c * 32);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o[i] = __floats2bfloat162_rn(__fmul_rn((float)x[2 * i], s), __fmul_rn((float)x[2 * i + 1], s));
  }
}

// The 16 x 64 scores of rows (ra, ra + 8) of tile `sa` against the 64 rows
// of tile `sb` (both row-major along D): s[n][i] for column n * 8 + 2t + (i & 1),
// rows ra (i < 2) and ra + 8.  int8: exact s32 sums, returned as floats.
template <int D, bool I8>
__device__ __forceinline__ void scores(float (&s)[8][4], const uint8_t* sa, const uint8_t* sb,
                                       int stride, int ra, int g, int t) {
  if constexpr (I8) {
    int si[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) si[n][0] = si[n][1] = si[n][2] = si[n][3] = 0;
#pragma unroll
    for (int ks = 0; ks < D / 32; ++ks) {
      const uint8_t* ab = sa + ks * 32 + 4 * t;
      const uint32_t a[4] = {ld32(ab + ra * stride), ld32(ab + (ra + 8) * stride),
                             ld32(ab + ra * stride + 16), ld32(ab + (ra + 8) * stride + 16)};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint8_t* br = sb + (n * 8 + g) * stride + ks * 32 + 4 * t;
        mma_s8(si[n], a, ld32(br), ld32(br + 16));
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = (float)si[n][i];
  } else {
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint8_t* ab = sa + (ks * 16 + 2 * t) * 2;
      const uint32_t a[4] = {ld32(ab + ra * stride), ld32(ab + (ra + 8) * stride),
                             ld32(ab + ra * stride + 16), ld32(ab + (ra + 8) * stride + 16)};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint8_t* br = sb + (n * 8 + g) * stride + (ks * 16 + 2 * t) * 2;
        mma_bf16(s[n], a, ld32(br), ld32(br + 16));
      }
    }
  }
}

// The 16 x 8 block n of (rows ra, ra + 8 of bf16 tile `sa`) x (tile `sb`)^T.
template <int D>
__device__ __forceinline__ void dot_block(float (&c)[4], const uint8_t* sa, const uint8_t* sb,
                                          int stride, int ra, int n, int g, int t) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint8_t* ab = sa + (ks * 16 + 2 * t) * 2;
    const uint32_t a[4] = {ld32(ab + ra * stride), ld32(ab + (ra + 8) * stride),
                           ld32(ab + ra * stride + 16), ld32(ab + (ra + 8) * stride + 16)};
    const uint8_t* br = sb + (n * 8 + g) * stride + (ks * 16 + 2 * t) * 2;
    mma_bf16(c, a, ld32(br), ld32(br + 16));
  }
}

// acc[16 x NTD*8] += A (16 x 16: the bf16 fragment a of k-step kk) x rows
// [16 kk, 16 kk + 16) of tile `sy` [64][D], columns [c0, c0 + NTD * 8),
// read with ldmatrix.trans.
template <int NTD>
__device__ __forceinline__ void acc_product(float (&acc)[NTD][4], const uint32_t (&a)[4],
                                            const __nv_bfloat16* sy, int stride_el, int kk,
                                            int c0, int lane) {
#pragma unroll
  for (int nd = 0; nd < NTD / 2; ++nd) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, sy + (kk * 16 + (lane & 15)) * stride_el + c0 + nd * 16 + (lane >> 4) * 8);
    mma_bf16(acc[2 * nd], a, b[0], b[1]);
    mma_bf16(acc[2 * nd + 1], a, b[2], b[3]);
  }
}

// Is the pair (q row, kv col) kept by the causal band and the mask?
__device__ __forceinline__ bool kept(const BwdParams& p, int row, int col, bool mask_cut,
                                     long long mrow) {
  if (p.causal) {
    if (col > row) return false;
    if (p.window && col < row - (p.window - 1) && col >= p.sinks) return false;
  }
  if (mask_cut && p.mask[mrow + col] == 0) return false;
  return true;
}

// Is the (q tile, kv tile) pair live under causality and the window band?
__device__ __forceinline__ bool tile_live(const BwdParams& p, int q0, int k0) {
  if (!p.causal) return true;
  if (k0 > q0 + BT - 1) return false;
  if (p.window && k0 + BT - 1 < q0 - p.window + 1 && !(p.sinks && k0 < p.sinks)) return false;
  return true;
}

__device__ __forceinline__ void store_pair(void* base, long long off, bool f32, float a, float b) {
  if (f32) *reinterpret_cast<float2*>(static_cast<float*>(base) + off) = make_float2(a, b);
  else *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(base) + off) =
      __floats2bfloat162_rn(a, b);
}

template <int D, bool QUANT>
constexpr int dkv_smem() {
  return BT * (QUANT ? D + 16 : 2 * (D + 8)) * 2      // K, Q (score operands)
         + BT * 2 * (D + 8) * (QUANT ? 3 : 2)          // V, dO (and the bf16 Q)
         + 3 * BT * 4;                                 // lse2, D_i, q scales
}

// ---------------------------------------------------------------- C1 ----
// DS warp groups split the D columns of the dK/dV accumulators.
template <int D, bool QUANT, int DS>
__global__ void __launch_bounds__(128 * DS) bwd_dkv_kernel(const BwdParams p) {
  constexpr int NTH = 128 * DS;
  constexpr int BFS = D + 8;                          // bf16 row (elements)
  constexpr int SROW = QUANT ? D + 16 : 2 * BFS;      // score operand row (bytes)
  constexpr int DW = D / DS, NTD = DW / 8;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sK = smem;
  uint8_t* sQ = sK + BT * SROW;
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(sQ + BT * SROW);
  __nv_bfloat16* sdO = sV + BT * BFS;
  __nv_bfloat16* sQd = QUANT ? sdO + BT * BFS : reinterpret_cast<__nv_bfloat16*>(sQ);
  float* sLse = reinterpret_cast<float*>(sdO + BT * BFS * (QUANT ? 2 : 1));
  float* sDi = sLse + BT;
  float* sQs = sDi + BT;

  const int j = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (p.Hq / p.Hk);
  const int k0 = j * BT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = (warp & 3) * 16 + g, dh = warp >> 2;
  constexpr int EB = QUANT ? 1 : 2;   // bytes per element of q and k

  const long long kvrow0 = ((long long)b * p.Hk + hk) * p.Skp + k0;
  stage<NTH>(sK, SROW, static_cast<const uint8_t*>(p.k) + kvrow0 * D * EB, D * EB);
  stage<NTH>(reinterpret_cast<uint8_t*>(sV), 2 * BFS,
             reinterpret_cast<const uint8_t*>(p.v + kvrow0 * D), 2 * D);
  const float ksA = QUANT ? p.ks[kvrow0 + ra] : 0.f;
  const float ksB = QUANT ? p.ks[kvrow0 + ra + 8] : 0.f;

  float dv[NTD][4], dk[NTD][4];
#pragma unroll
  for (int n = 0; n < NTD; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dv[n][i] = dk[n][i] = 0.f;

  const int n_qt = p.Sqp / BT, n_kt = p.Skp / BT;
  const long long qhead = ((long long)b * p.Hq + hq) * p.Sqp;
  const long long moff = p.mask ? b * p.m_sb + (p.Hm == 1 ? 0 : hq) * p.m_sh : 0;
  const uint8_t* live = p.live
      ? p.live + ((long long)b * p.Hm + (p.Hm == 1 ? 0 : hq)) * n_qt * n_kt : nullptr;

  for (int i = p.causal ? j : 0; i < n_qt; ++i) {
    const int q0 = i * BT;
    if (!tile_live(p, q0, k0)) {
      if (p.window && !(p.sinks && k0 < p.sinks)) break;   // every later tile is below the band
      continue;
    }
    const int lv = live ? live[i * n_kt + j] : 2;
    if (lv == 0) continue;
    __syncthreads();   // the previous q tile has been consumed
    const long long qrow0 = qhead + q0;
    stage<NTH>(sQ, SROW, static_cast<const uint8_t*>(p.q) + qrow0 * D * EB, D * EB);
    stage<NTH>(reinterpret_cast<uint8_t*>(sdO), 2 * BFS,
               reinterpret_cast<const uint8_t*>(p.dO + qrow0 * D), 2 * D);
    if (tid < BT) {
      sLse[tid] = p.lse2[qrow0 + tid];
      sDi[tid] = p.di[qrow0 + tid];
      if (QUANT) sQs[tid] = p.qs[qrow0 + tid];
    }
    __syncthreads();
    if (QUANT) {
      stage_dequant<NTH, D>(reinterpret_cast<uint8_t*>(sQd), 2 * BFS,
                            static_cast<const int8_t*>(p.q) + qrow0 * D, sQs);
      __syncthreads();
    }

    // P^T: rows = kv (ra, ra + 8), columns = the tile's 64 q rows
    float pt[8][4];
    scores<D, QUANT>(pt, sK, sQ, SROW, ra, g, t);
    const bool mask_cut = lv == 1;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        const float s = QUANT ? __fmul_rn(__fmul_rn(pt[n][e], sQs[c]), e < 2 ? ksA : ksB)
                              : __fmul_rn(pt[n][e], p.fold);
        const int kv = k0 + ra + (e < 2 ? 0 : 8);
        const bool keep = kept(p, q0 + c, kv, mask_cut, moff + (long long)(q0 + c) * p.m_ss);
        pt[n][e] = keep ? exp2f(__fsub_rn(s, sLse[c])) : 0.f;
      }
    // dS^T = P^T (V dO^T - D_i), one 8-column block of dP^T at a time; each
    // 16-column step of P^T and dS^T goes into the dV and dK products as
    // soon as it is complete
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4], dsa[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 2 * kk + h;
        float dp[4];
        dot_block<D>(dp, reinterpret_cast<const uint8_t*>(sV),
                     reinterpret_cast<const uint8_t*>(sdO), 2 * BFS, ra, n, g, t);
        const int c = n * 8 + 2 * t;
        const float d0 = sDi[c], d1 = sDi[c + 1];
        dsa[2 * h] = pack_bf16(__fmul_rn(pt[n][0], __fsub_rn(dp[0], d0)),
                               __fmul_rn(pt[n][1], __fsub_rn(dp[1], d1)));
        dsa[2 * h + 1] = pack_bf16(__fmul_rn(pt[n][2], __fsub_rn(dp[2], d0)),
                                   __fmul_rn(pt[n][3], __fsub_rn(dp[3], d1)));
        pa[2 * h] = pack_bf16(pt[n][0], pt[n][1]);
        pa[2 * h + 1] = pack_bf16(pt[n][2], pt[n][3]);
      }
      acc_product<NTD>(dv, pa, sdO, BFS, kk, dh * DW, lane);
      acc_product<NTD>(dk, dsa, sQd, BFS, kk, dh * DW, lane);
    }
  }

  const long long orow = ((long long)b * p.Hq + hq) * p.Skp + k0;
#pragma unroll
  for (int n = 0; n < NTD; ++n) {
    const int c = dh * DW + n * 8 + 2 * t;
    const long long oa = (orow + ra) * D + c, ob = (orow + ra + 8) * D + c;
    store_pair(p.dv, oa, p.out_f32, dv[n][0], dv[n][1]);
    store_pair(p.dv, ob, p.out_f32, dv[n][2], dv[n][3]);
    store_pair(p.dk, oa, p.out_f32, __fmul_rn(dk[n][0], p.dk_fin), __fmul_rn(dk[n][1], p.dk_fin));
    store_pair(p.dk, ob, p.out_f32, __fmul_rn(dk[n][2], p.dk_fin), __fmul_rn(dk[n][3], p.dk_fin));
  }
}

template <int D, bool QUANT>
constexpr int dq_smem() {
  return BT * (QUANT ? D + 16 : 2 * (D + 8)) * 2      // Q, K (score operands)
         + BT * 2 * (D + 8) * (QUANT ? 3 : 2)          // dO, V (and the bf16 K)
         + BT * 4;                                     // k scales
}

// ---------------------------------------------------------------- C2 ----
template <int D, bool QUANT>
__global__ void __launch_bounds__(128) bwd_dq_kernel(const BwdParams p) {
  constexpr int NTH = 128;
  constexpr int BFS = D + 8;
  constexpr int SROW = QUANT ? D + 16 : 2 * BFS;
  constexpr int NTD = D / 8;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sQ = smem;
  uint8_t* sK = sQ + BT * SROW;
  __nv_bfloat16* sdO = reinterpret_cast<__nv_bfloat16*>(sK + BT * SROW);
  __nv_bfloat16* sV = sdO + BT * BFS;
  __nv_bfloat16* sKd = QUANT ? sV + BT * BFS : reinterpret_cast<__nv_bfloat16*>(sK);
  float* sKs = reinterpret_cast<float*>(sV + BT * BFS * (QUANT ? 2 : 1));

  const int n_qt = p.Sqp / BT, n_kt = p.Skp / BT;
  // causal: the longest q tiles first, so the tail of the grid is short work
  const int i = p.causal ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (p.Hq / p.Hk);
  const int q0 = i * BT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = warp * 16 + g;
  constexpr int EB = QUANT ? 1 : 2;

  const long long qrow0 = ((long long)b * p.Hq + hq) * p.Sqp + q0;
  stage<NTH>(sQ, SROW, static_cast<const uint8_t*>(p.q) + qrow0 * D * EB, D * EB);
  stage<NTH>(reinterpret_cast<uint8_t*>(sdO), 2 * BFS,
             reinterpret_cast<const uint8_t*>(p.dO + qrow0 * D), 2 * D);
  const float lA = p.lse2[qrow0 + ra], lB = p.lse2[qrow0 + ra + 8];
  const float dA = p.di[qrow0 + ra], dB = p.di[qrow0 + ra + 8];
  const float qsA = QUANT ? p.qs[qrow0 + ra] : 0.f, qsB = QUANT ? p.qs[qrow0 + ra + 8] : 0.f;

  float dq[NTD][4];
#pragma unroll
  for (int n = 0; n < NTD; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  const long long khead = ((long long)b * p.Hk + hk) * p.Skp;
  const long long moff = p.mask ? b * p.m_sb + (p.Hm == 1 ? 0 : hq) * p.m_sh : 0;
  const uint8_t* live = p.live
      ? p.live + (((long long)b * p.Hm + (p.Hm == 1 ? 0 : hq)) * n_qt + i) * n_kt : nullptr;
  const int j_end = p.causal ? i + 1 : n_kt;

  for (int j = 0; j < j_end; ++j) {
    const int k0 = j * BT;
    if (!tile_live(p, q0, k0)) continue;   // below the band, no sink
    const int lv = live ? live[j] : 2;
    if (lv == 0) continue;
    __syncthreads();   // the previous kv tile has been consumed
    const long long kvrow0 = khead + k0;
    stage<NTH>(sK, SROW, static_cast<const uint8_t*>(p.k) + kvrow0 * D * EB, D * EB);
    stage<NTH>(reinterpret_cast<uint8_t*>(sV), 2 * BFS,
               reinterpret_cast<const uint8_t*>(p.v + kvrow0 * D), 2 * D);
    if (QUANT && tid < BT) sKs[tid] = p.ks[kvrow0 + tid];
    __syncthreads();
    if (QUANT) {
      stage_dequant<NTH, D>(reinterpret_cast<uint8_t*>(sKd), 2 * BFS,
                            static_cast<const int8_t*>(p.k) + kvrow0 * D, sKs);
      __syncthreads();
    }

    float pr[8][4];
    scores<D, QUANT>(pr, sQ, sK, SROW, ra, g, t);
    const bool mask_cut = lv == 1;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        const int row = q0 + ra + (e < 2 ? 0 : 8);
        const float s = QUANT ? __fmul_rn(__fmul_rn(pr[n][e], e < 2 ? qsA : qsB), sKs[c])
                              : __fmul_rn(pr[n][e], p.fold);
        const bool keep = kept(p, row, k0 + c, mask_cut, moff + (long long)row * p.m_ss);
        pr[n][e] = keep ? exp2f(__fsub_rn(s, e < 2 ? lA : lB)) : 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t dsa[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 2 * kk + h;
        float dp[4];
        dot_block<D>(dp, reinterpret_cast<const uint8_t*>(sdO),
                     reinterpret_cast<const uint8_t*>(sV), 2 * BFS, ra, n, g, t);
        dsa[2 * h] = pack_bf16(__fmul_rn(pr[n][0], __fsub_rn(dp[0], dA)),
                               __fmul_rn(pr[n][1], __fsub_rn(dp[1], dA)));
        dsa[2 * h + 1] = pack_bf16(__fmul_rn(pr[n][2], __fsub_rn(dp[2], dB)),
                                   __fmul_rn(pr[n][3], __fsub_rn(dp[3], dB)));
      }
      acc_product<NTD>(dq, dsa, sKd, BFS, kk, 0, lane);
    }
  }

#pragma unroll
  for (int n = 0; n < NTD; ++n) {
    const int c = n * 8 + 2 * t;
    store_pair(p.dq, (qrow0 + ra) * D + c, p.out_f32, __fmul_rn(dq[n][0], p.dq_fin),
                     __fmul_rn(dq[n][1], p.dq_fin));
    store_pair(p.dq, (qrow0 + ra + 8) * D + c, p.out_f32, __fmul_rn(dq[n][2], p.dq_fin),
                     __fmul_rn(dq[n][3], p.dq_fin));
  }
}

// Launches with the dynamic shared memory each instantiation needs (above
// the 48 KB default: opted in per kernel first).
template <typename K>
int launch(K kernel, dim3 grid, int threads, int smem, const BwdParams& p, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int D, bool QUANT>
int run(int which, const BwdParams& p, int B, cudaStream_t s) {
  if (which == 1) {
    constexpr int DS = D > 128 ? 2 : 1;
    return launch(bwd_dkv_kernel<D, QUANT, DS>, dim3(p.Skp / BT, p.Hq, B), 128 * DS,
                  dkv_smem<D, QUANT>(), p, s);
  }
  return launch(bwd_dq_kernel<D, QUANT>, dim3(p.Sqp / BT, p.Hq, B), 128, dq_smem<D, QUANT>(), p, s);
}

template <int D>
int run_q(int which, int quant, const BwdParams& p, int B, cudaStream_t s) {
  return quant ? run<D, true>(which, p, B, s) : run<D, false>(which, p, B, s);
}

}  // namespace

extern "C" {

const char* sage_bwd_error_string(int e) {
  if (e == -1) return "unsupported backward configuration (kernel, head_dim, lengths or mask)";
  return cudaGetErrorString((cudaError_t)e);
}

// which: 1 = C1 (dk, dv), 2 = C2 (dq).  Every tensor is contiguous, with the
// sequences padded to multiples of 64 (Sqp, Skp) and D in {64, 128, 256};
// mask strides in elements; out_f32: 0 bf16, 1 f32 outputs.
int sage_attn_bwd(int which, int quant, int D, const void* q, const void* k, const void* v,
                  const void* dO, const float* lse2, const float* di, const float* qs,
                  const float* ks, const int8_t* mask, long long m_sb, long long m_sh,
                  long long m_ss, int Hm, const uint8_t* live, void* dk, void* dv, void* dq,
                  int out_f32, int B, int Hq, int Hk, int Sqp, int Skp, int causal, int window,
                  int sinks, float fold, float dk_fin, float dq_fin, void* stream) {
  if ((which != 1 && which != 2) || Sqp % BT || Skp % BT || Hq % Hk) return -1;
  if ((mask != nullptr) != (live != nullptr) || (quant && !(qs && ks))) return -1;
  if (window && !causal) return -1;
  BwdParams p{q, k, static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dO),
              lse2, di, qs, ks, mask, m_sb, m_sh, m_ss, Hm, live, dk, dv, dq, out_f32,
              Hq, Hk, Sqp, Skp, causal, window, sinks, fold, dk_fin, dq_fin};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return run_q<64>(which, quant, p, B, s);
  if (D == 128) return run_q<128>(which, quant, p, B, s);
  if (D == 256) return run_q<256>(which, quant, p, B, s);
  return -1;
}

}  // extern "C"
