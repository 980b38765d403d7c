// Decode attention over an int8 KV cache: a few fresh query rows against a
// long cache, dense (B11) or paged (D1), split along the cache.  Since the
// Hopper redesigns it runs B11 and D1 on e4m3 and bf16 V, at head dim 256
// and (B11) with an f32 output: B11 on an int8 V at head dims 64 and 128
// with a bf16 output (every `B11-int8` key) runs decode_sm90.cu, D1 on
// int8 pools at 64 and 128 paged_decode_sm90.cu.
//
// Replaces two Pallas kernels of the JAX package:
//   B11  `_attn_kernel` (sageattention_tpu/ops/attention.py) in the decode
//        configuration that `sageattn_decode` (decode.py) builds: Q
//        quantized per row in the kernel (int8, x sm_scale*log2e), an int8 K
//        cache with per-token scales, s = (s32 * qs_row) * ks_token, the
//        online softmax with the quantized P of the V format (int8 P =
//        rint(exp2(s - m + log2 127)) for an int8 V, e4m3 P =
//        e4m3(exp2(s - m + log2 448)) for an e4m3 V, bf16 P for a bf16 V),
//        the true length and the causal offsets of a verify window read from
//        device memory, folded GQA rows whose position is q_start +
//        (row_base + r) % T (row_base: the launch's first row among the
//        folded rows, when they take more than one 32-row launch).
//   D1   `_paged_kernel` (sageattention_tpu/ops/paged_decode.py): a bf16 Q
//        pre-scaled by sm_scale*log2e on the host, K codes upcast and dotted
//        in f32 times the per-token scale, a bf16 P against V codes upcast
//        (int8, e4m3 or bf16), l summing the f32 p; pages found through an
//        effective table (slot -> physical page) and a logical-page table
//        (slot -> position); masks: the tail, T > 1 causal windows (row r at
//        len - T + r), a sliding window [lo, len) and sink slots [0, sinks).
// Both end in 1/l, the per-channel V scale (x 1/127 for an int8 P), + the V
// mean, and optionally the base-2 lse.
//
// What bounds it on the H100: device memory.  Each step streams the live K,
// V and K scales once past at most 32 query rows (~2 operations per byte).
// The design is split-KV (flash-decoding): one block per (split, head,
// sequence) walks a contiguous share of the sequence's live 64-token tiles,
// computed on the device from its length, so a short sequence keeps every
// split busy and a decode step makes no host read; at batch 1 the 8 KV
// heads of Llama-3-8B still fill the card.  Dead tiles (past the length,
// outside a window) are skipped, which is exact: they hold only masked
// scores.  A second launch merges the splits' (m, l, acc) exactly and
// applies the epilogue.  Head dims 64, 128 and 256; at 256 a thread owns two
// channels of the PV product and the tiles live in dynamic shared memory
// (above the 48 KB of static shared memory).  This first version stages each K/V tile in shared
// memory with plain 16-byte loads; cp.async/TMA staging is later work.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NT = 128;        // threads per block
constexpr int TILE = 64;       // cache tokens per tile
constexpr int MAXR = 32;       // query rows per block (the JAX kernels' q tile)
constexpr float MASK_NEG = -1e30f;
constexpr float M_CLAMP = -1e20f;
constexpr float FP8_OFFSET_LOG2 = 8.807354922057604f;     // log2(448)
constexpr float INT8_P_OFFSET_LOG2 = 6.988684686772166f;  // log2(127)

enum VKind { V_I8 = 0, V_F8 = 1, V_BF16 = 2 };
enum PMode { P_BF16 = 0, P_I8 = 1, P_F8 = 2 };

struct Params {
  const float* q;        // [B, Hg, R, D] f32 (bf16 values for D1)
  const int8_t* k;       // dense [B, Hk, S, D] / pool [P, Hk, page, D]
  const void* v;
  const float* ks;       // dense [B, Hk, S] / pool [P, Hk, page], unit token stride
  long long k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, ks_sb, ks_sh;
  const int* lens;       // dense: [1] true length; paged: [B]
  const int* offsets;    // dense causal: (q_start, kv_start)
  const int* table;      // paged: [B, n_slots] physical page of each stream slot
  const int* lpage;      // paged: [B, n_slots] logical page of each stream slot
  const int* win_lo;     // paged sliding: [B]
  int Hg, Hk, R, n_units, n_slots, page, S;
  int causal, row_mod, row_base, window_T, sliding, sinks, sink_pages;
  float fold;
  float* pm;             // [B*Hg, n_split, R]
  float* pl;
  float* pacc;           // [B*Hg, n_split, R, D]
};

template <int VK>
__device__ __forceinline__ float vval(const unsigned char* row, int d) {
  if (VK == V_I8) return (float)reinterpret_cast<const int8_t*>(row)[d];
  if (VK == V_F8) return static_cast<float>(reinterpret_cast<const __nv_fp8_e4m3*>(row)[d]);
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[d]);
}

template <int D, int VK, bool PAGED, int RB>
__global__ void __launch_bounds__(NT) decode_split_kernel(Params p) {
  constexpr int ES = VK == V_BF16 ? 2 : 1;
  constexpr int KSTR = D + 16;                 // padded K row (bytes): no bank conflicts
  constexpr int PM = PAGED ? P_BF16 : (VK == V_I8 ? P_I8 : VK == V_F8 ? P_F8 : P_BF16);
  constexpr int CPT = D > NT ? D / NT : 1;     // channels per thread of the PV product
  constexpr int DC = D / CPT;                  // threads per row of the PV product
  constexpr int NG = NT / DC;                  // row groups of the PV product
  constexpr int MAXJ = (RB + NG - 1) / NG;
  // D = 256: the K, V and Q tiles in dynamic shared memory (dyn_bytes)
  constexpr bool DYN = D > 128;
  __shared__ __align__(16) unsigned char sk_st[DYN ? 16 : TILE * KSTR];
  __shared__ __align__(16) unsigned char sv_st[DYN ? 16 : TILE * D * ES];
  __shared__ __align__(16) unsigned char sq_st[DYN ? 16 : RB * D * 2];   // int8 codes (B11) or bf16 (D1)
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  unsigned char* const sk = DYN ? dyn_smem : sk_st;
  unsigned char* const sv = DYN ? dyn_smem + TILE * KSTR : sv_st;
  unsigned char* const sq = DYN ? dyn_smem + TILE * KSTR + TILE * D * ES : sq_st;
  __shared__ float sks[TILE];
  __shared__ float ss[RB][TILE + 1];
  __shared__ float sqs[RB], sm[RB], sl[RB], sa[RB];

  const int split = blockIdx.x, hg = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = p.R, bh = b * p.Hg + hg;
  const int hk = hg / (p.Hg / p.Hk);

  // ---- Q rows: int8 per-row codes (B11) or the pre-scaled bf16 (D1) ----
  for (int r = warp; r < R; r += NT / 32) {
    const float* qr = p.q + ((long long)bh * R + r) * D;
    constexpr int E = D / 32;
    float x[E];
#pragma unroll
    for (int i = 0; i < E; ++i) x[i] = qr[lane * E + i];
    if (PAGED) {
      __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(sq) + r * D + lane * E;
#pragma unroll
      for (int i = 0; i < E; ++i) dst[i] = __float2bfloat16_rn(x[i]);
    } else {
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        x[i] = __fmul_rn(x[i], p.fold);
        a = fmaxf(a, fabsf(x[i]));
      }
      a = sage::warp_max(a);
      const float qs = a > 0.f ? __fmul_rn(a, (float)(1.0 / 127.0)) : 1.f;
      const float inv = __fdiv_rn(1.f, qs);
      int8_t* dst = reinterpret_cast<int8_t*>(sq) + r * D + lane * E;
#pragma unroll
      for (int i = 0; i < E; ++i) dst[i] = (int8_t)sage::code_i8(__fmul_rn(x[i], inv));
      if (lane == 0) sqs[r] = qs;
    }
  }
  if (tid < RB) { sm[tid] = M_CLAMP; sl[tid] = 0.f; }

  // ---- this split's share of the live tiles ----
  const int len = PAGED ? p.lens[b] : min(p.lens[0], p.S);
  int hi = p.n_units;
  if (!(PAGED && p.sliding)) hi = min(hi, (max(len, 0) + TILE - 1) / TILE);
  const int per = (hi + n_split - 1) / n_split;
  const int u0 = split * per, u1 = min(u0 + per, hi);
  int q_start = 0, kv_start = 0, lo = 0;
  if (!PAGED && p.causal) { q_start = p.offsets[0]; kv_start = p.offsets[1]; }
  if (PAGED && p.sliding) lo = p.win_lo[b];
  const int spp = PAGED ? p.page / TILE : 1;

  const int dcol = tid % DC, g = tid / DC;   // channels dcol + c * DC, c < CPT
  float acc[CPT][MAXJ];
#pragma unroll
  for (int c = 0; c < CPT; ++c)
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) acc[c][j] = 0.f;
  __syncthreads();

  for (int u = u0; u < u1; ++u) {
    int tok0, nrows;
    bool is_sink = false;
    const int8_t* kb;
    const unsigned char* vb;
    const float* ksb;
    if (PAGED) {
      const int slot = u / spp, sub = u % spp;
      tok0 = p.lpage[(long long)b * p.n_slots + slot] * p.page + sub * TILE;
      is_sink = slot < p.sink_pages;
      bool live = tok0 < len;
      if (p.sliding) live = live && (is_sink ? tok0 < p.sinks : tok0 + TILE > lo);
      if (!live) continue;   // block-uniform
      const long long phys = p.table[(long long)b * p.n_slots + slot];
      kb = p.k + phys * p.k_sb + hk * p.k_sh + (long long)sub * TILE * p.k_ss;
      vb = static_cast<const unsigned char*>(p.v) +
           (phys * p.v_sb + hk * p.v_sh + (long long)sub * TILE * p.v_ss) * ES;
      ksb = p.ks + phys * p.ks_sb + hk * p.ks_sh + sub * TILE;
      nrows = TILE;
    } else {
      tok0 = u * TILE;
      kb = p.k + b * p.k_sb + hk * p.k_sh + (long long)tok0 * p.k_ss;
      vb = static_cast<const unsigned char*>(p.v) +
           (b * p.v_sb + hk * p.v_sh + (long long)tok0 * p.v_ss) * ES;
      ksb = p.ks + b * p.ks_sb + hk * p.ks_sh + tok0;
      nrows = min(TILE, len - tok0);
    }
    // ---- stage the tile: K codes, V, K scales (rows past nrows read 0) ----
    constexpr int KCH = D / 16;
    for (int c = tid; c < TILE * KCH; c += NT) {
      const int row = c / KCH, ch = c % KCH;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row < nrows) val = *reinterpret_cast<const uint4*>(kb + row * p.k_ss + ch * 16);
      *reinterpret_cast<uint4*>(sk + row * KSTR + ch * 16) = val;
    }
    constexpr int VCH = D * ES / 16;
    for (int c = tid; c < TILE * VCH; c += NT) {
      const int row = c / VCH, ch = c % VCH;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row < nrows) val = *reinterpret_cast<const uint4*>(vb + row * p.v_ss * ES + ch * 16);
      *reinterpret_cast<uint4*>(sv + (row * D * ES) + ch * 16) = val;
    }
    if (tid < TILE) sks[tid] = tid < nrows ? ksb[tid] : 1.f;
    __syncthreads();

    // ---- scores: thread = one token, rows rg, rg + 2, ... ----
    {
      const int col = tid & (TILE - 1), rg = tid >> 6;
      const int tok = tok0 + col;
      int kw[D / 4];
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        const uint4 w = *reinterpret_cast<const uint4*>(sk + col * KSTR + i * 16);
        kw[4 * i] = w.x; kw[4 * i + 1] = w.y; kw[4 * i + 2] = w.z; kw[4 * i + 3] = w.w;
      }
      const float ksc = sks[col];
      for (int r = rg; r < R; r += 2) {
        float s;
        if (PAGED) {
          const __nv_bfloat162* qr = reinterpret_cast<const __nv_bfloat162*>(sq) + r * (D / 2);
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < D / 4; ++i) {
            const char4 c4 = *reinterpret_cast<const char4*>(&kw[i]);
            const float2 q0 = __bfloat1622float2(qr[2 * i]);
            const float2 q1 = __bfloat1622float2(qr[2 * i + 1]);
            a = fmaf(q0.x, (float)c4.x, a);
            a = fmaf(q0.y, (float)c4.y, a);
            a = fmaf(q1.x, (float)c4.z, a);
            a = fmaf(q1.y, (float)c4.w, a);
          }
          s = __fmul_rn(a, ksc);
          bool keep;
          if (p.window_T > 1) {
            keep = tok <= len - p.window_T + r;
          } else {
            keep = tok < len;
            if (p.sliding) keep = keep && (p.sinks ? (is_sink ? tok < p.sinks : tok >= lo) : tok >= lo);
          }
          if (!keep) s = MASK_NEG;
        } else {
          const int* qw = reinterpret_cast<const int*>(sq + r * D);
          int a = 0;
#pragma unroll
          for (int i = 0; i < D / 4; ++i) a = __dp4a(kw[i], qw[i], a);
          s = __fmul_rn(__fmul_rn((float)a, sqs[r]), ksc);
          bool keep = tok < len;
          if (p.causal) {
            const int pos = q_start + (p.row_mod ? (p.row_base + r) % p.row_mod : r);
            keep = keep && tok + kv_start <= pos;
          }
          if (!keep) s = MASK_NEG;
        }
        ss[r][col] = s;
      }
    }
    __syncthreads();

    // ---- online softmax, one warp per row ----
    for (int r = warp; r < R; r += NT / 32) {
      float sv2[2] = {ss[r][lane], ss[r][lane + 32]};
      const float mc = sage::warp_max(fmaxf(sv2[0], sv2[1]));
      const float mp = sm[r];
      const float mn = fmaxf(fmaxf(mp, mc), M_CLAMP);
      const float al = exp2f(__fsub_rn(mp, mn));
      float c = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float e = __fsub_rn(sv2[i], mn);
        if (PM == P_I8) e = __fadd_rn(e, INT8_P_OFFSET_LOG2);
        if (PM == P_F8) e = __fadd_rn(e, FP8_OFFSET_LOG2);
        float pv = exp2f(e);
        if (PM == P_I8) pv = rintf(pv);
        if (PM == P_F8) pv = static_cast<float>(__nv_fp8_e4m3(pv));
        c += pv;   // l sums the unrounded p (bf16 P) or the codes
        if (PM == P_BF16) pv = __bfloat162float(__float2bfloat16_rn(pv));
        sv2[i] = pv;
      }
      c = sage::warp_sum(c);
      if (PM == P_I8) c = __fmul_rn(c, (float)(1.0 / 127.0));
      ss[r][lane] = sv2[0];
      ss[r][lane + 32] = sv2[1];
      if (lane == 0) {
        sl[r] = __fadd_rn(__fmul_rn(al, sl[r]), c);
        sm[r] = mn;
        sa[r] = al;
      }
    }
    __syncthreads();

    // ---- PV: thread = CPT channels of rows g, g + NG, ... ----
#pragma unroll
    for (int ci = 0; ci < CPT; ++ci) {
      float t[MAXJ];
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) t[j] = 0.f;
      for (int c = 0; c < TILE; ++c) {
        const float vv = vval<VK>(sv + c * D * ES, dcol + ci * DC);
#pragma unroll
        for (int j = 0; j < MAXJ; ++j) {
          const int r = g + j * NG;
          if (r < R) t[j] = fmaf(ss[r][c], vv, t[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        const int r = g + j * NG;
        if (r < R) acc[ci][j] = __fadd_rn(__fmul_rn(acc[ci][j], sa[r]), t[j]);
      }
    }
    __syncthreads();
  }

  // ---- this split's partial state ----
  const long long base = ((long long)bh * n_split + split) * R;
#pragma unroll
  for (int ci = 0; ci < CPT; ++ci)
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int r = g + j * NG;
      if (r < R) p.pacc[(base + r) * D + dcol + ci * DC] = acc[ci][j];
    }
  if (tid < R) {
    p.pm[base + tid] = sm[tid];
    p.pl[base + tid] = sl[tid];
  }
}

// Exact merge of the splits and the epilogue: out = acc / l * (v_scale *
// vs_mul) + v_mean; lse_mode 1: m + log2(max(l, 1e-37)) - lse_off (B11),
// 2: m + log2(l), -1e30 where l = 0 (D1).
template <typename OutT>
__global__ void __launch_bounds__(NT)
decode_combine_kernel(const float* __restrict__ pm, const float* __restrict__ pl,
                      const float* __restrict__ pacc, int n_split, int R, int D, int Hg, int Hk,
                      const float* v_scale, const float* v_mean, long long vs_sb, float vs_mul,
                      OutT* out, float* lse, int lse_mode, float lse_off) {
  const int bh = blockIdx.x;
  const int b = bh / Hg, hk = (bh % Hg) / (Hg / Hk);
  for (int idx = threadIdx.x; idx < R * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    float mg = M_CLAMP;
    for (int s = 0; s < n_split; ++s) mg = fmaxf(mg, pm[((long long)bh * n_split + s) * R + r]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const long long o = ((long long)bh * n_split + s) * R + r;
      const float w = exp2f(__fsub_rn(pm[o], mg));
      l = __fadd_rn(l, __fmul_rn(w, pl[o]));
      a = __fadd_rn(a, __fmul_rn(w, pacc[o * D + d]));
    }
    const float inv = __fdiv_rn(1.f, l == 0.f ? 1.f : l);
    float o = __fmul_rn(a, inv);
    const long long c = b * vs_sb + (long long)hk * D + d;
    if (v_scale) o = __fmul_rn(o, __fmul_rn(v_scale[c], vs_mul));
    if (v_mean) o = __fadd_rn(o, v_mean[c]);
    const long long oi = ((long long)bh * R + r) * D + d;
    if (std::is_same<OutT, float>::value) reinterpret_cast<float*>(out)[oi] = o;
    else reinterpret_cast<__nv_bfloat16*>(out)[oi] = __float2bfloat16_rn(o);
    if (lse && d == 0) {
      float v;
      if (lse_mode == 1) v = __fsub_rn(__fadd_rn(mg, log2f(fmaxf(l, 1e-37f))), lse_off);
      else v = l > 0.f ? __fadd_rn(mg, log2f(l)) : -1e30f;
      lse[(long long)bh * R + r] = v;
    }
  }
}

template <int D, int VK, bool PAGED, int RB>
void launch_split(const Params& p, dim3 grid, cudaStream_t s) {
  if constexpr (D > 128) {   // the tiles in dynamic shared memory, opted in first
    constexpr int ES = VK == V_BF16 ? 2 : 1;
    constexpr int smem = TILE * (D + 16) + TILE * D * ES + RB * D * 2;
    cudaFuncSetAttribute(decode_split_kernel<D, VK, PAGED, RB>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    decode_split_kernel<D, VK, PAGED, RB><<<grid, NT, smem, s>>>(p);
  } else {
    decode_split_kernel<D, VK, PAGED, RB><<<grid, NT, 0, s>>>(p);
  }
}

template <int D, int VK, bool PAGED>
cudaError_t launch_rb(const Params& p, dim3 grid, cudaStream_t s) {
  if (p.R <= 4) launch_split<D, VK, PAGED, 4>(p, grid, s);
  else if (p.R <= 8) launch_split<D, VK, PAGED, 8>(p, grid, s);
  else if (p.R <= 16) launch_split<D, VK, PAGED, 16>(p, grid, s);
  else launch_split<D, VK, PAGED, 32>(p, grid, s);
  return cudaGetLastError();
}


template <int D, bool PAGED>
cudaError_t launch_v(int vkind, const Params& p, dim3 grid, cudaStream_t s) {
  if (vkind == V_I8) return launch_rb<D, V_I8, PAGED>(p, grid, s);
  if (vkind == V_F8) return launch_rb<D, V_F8, PAGED>(p, grid, s);
  return launch_rb<D, V_BF16, PAGED>(p, grid, s);
}

template <bool PAGED>
cudaError_t launch_d(int D, int vkind, const Params& p, dim3 grid, cudaStream_t s) {
  if (D == 64) return launch_v<64, PAGED>(vkind, p, grid, s);
  if (D == 128) return launch_v<128, PAGED>(vkind, p, grid, s);
  return launch_v<256, PAGED>(vkind, p, grid, s);
}

}  // namespace

extern "C" {

const char* sage_decode_error_string(int e) {
  if (e == -1) return "unsupported decode configuration (head_dim, rows, page or V format)";
  return cudaGetErrorString((cudaError_t)e);
}

// paged: 0 = B11 over a dense cache, 1 = D1 over a page pool.  vkind: 0 int8,
// 1 e4m3, 2 bf16 V.  q: f32 [B, Hg, R, D] contiguous.  Strides in elements.
// pm/pl/pacc: scratch of n_split partial states.  out_f32: 0 bf16, 1 f32.
int sage_decode(int paged, int vkind, int D, const float* q, const void* k, const void* v,
                const float* ks, long long k_sb, long long k_sh, long long k_ss,
                long long v_sb, long long v_sh, long long v_ss, long long ks_sb,
                long long ks_sh, const int* lens, const int* offsets, const int* table,
                const int* lpage, const int* win_lo, int B, int Hg, int Hk, int R, int n_units,
                int n_slots, int page, int S, int causal, int row_mod, int row_base, int window_T,
                int sliding, int sinks, int sink_pages, int n_split, float fold,
                const float* v_scale, const float* v_mean, long long vs_sb, float vs_mul,
                float* pm, float* pl, float* pacc, void* out, int out_f32, float* lse,
                int lse_mode, float lse_off, void* stream) {
  if ((D != 64 && D != 128 && D != 256) || R < 1 || R > MAXR || n_split < 1 || vkind < 0 ||
      vkind > 2)
    return -1;
  if (paged && (page % TILE || page < TILE)) return -1;
  Params p{q, static_cast<const int8_t*>(k), v, ks, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           ks_sb, ks_sh, lens, offsets, table, lpage, win_lo, Hg, Hk, R, n_units, n_slots,
           page, S, causal, row_mod, row_base, window_T, sliding, sinks, sink_pages, fold, pm, pl,
           pacc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_split, Hg, B);
  cudaError_t e;
  if (paged) e = launch_d<true>(D, vkind, p, grid, s);
  else e = launch_d<false>(D, vkind, p, grid, s);
  if (e != cudaSuccess) return (int)e;
  if (out_f32)
    decode_combine_kernel<float><<<B * Hg, NT, 0, s>>>(pm, pl, pacc, n_split, R, D, Hg, Hk,
                                                       v_scale, v_mean, vs_sb, vs_mul,
                                                       static_cast<float*>(out), lse, lse_mode,
                                                       lse_off);
  else
    decode_combine_kernel<__nv_bfloat16><<<B * Hg, NT, 0, s>>>(
        pm, pl, pacc, n_split, R, D, Hg, Hk, v_scale, v_mean, vs_sb, vs_mul,
        static_cast<__nv_bfloat16*>(out), lse, lse_mode, lse_off);
  return (int)cudaGetLastError();
}

}  // extern "C"
