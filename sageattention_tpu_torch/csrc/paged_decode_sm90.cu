// D1-int8, the paged int8 decode, redesigned for Hopper: each block walks a
// share of one sequence's live 64-token tiles for the query heads of one KV
// head, its K and V codes brought by TMA into a ring of stages that one
// thread keeps full, the scores and the PV product on mma.sync tensor
// cores, then an exact merge of the shares.
//
// Replaces the Pallas kernel `_paged_kernel` (sageattention_tpu/ops/
// paged_decode.py:49, launched by `paged_decode_call`) with int8 V codes
// at head dims 64 and 128 (every D1-int8 launch key: `D1-int8`, `-causal`,
// `-sliding`, `-sinks`, each with `-state`); e4m3 and bf16 V, D = 256 and
// all of B11 stay on decode.cu.  What it computes, as the plain version
// (ops/paged_decode.py `paged_decode_plain`):
//   q [B, Hg, R, D] bf16, pre-scaled by sm_scale * log2(e); the pools k8
//   [P, Hk, page, D] int8 with per-token scales ks [P, Hk, 1, page] f32 and
//   v8 [P, Hk, page, D] int8 with pool-global v_scale / v_mean [Hk, D];
//   stream slot i of sequence b is physical page table[b, i] at logical
//   page lpage[b, i].  s = (q . k8) * ks in f32 (bf16 q times the codes,
//   exact products); masked to -1e30 past the length, outside a T > 1
//   causal window (row r sees positions <= len - T + r), outside the
//   sliding window [lo, len) and its sink slots [0, sinks).  The online
//   softmax over 64-token tiles, the running max floored at -1e20; P in
//   bf16 against the V codes with f32 sums, l summing the unrounded p.  A
//   sequence's live tiles are cut into shares of `per` = max(4, ceil(live /
//   n_split)) tiles, one block each; the merge takes the shares in order,
//   then out = acc / l * v_scale + v_mean in bf16 and, optionally, the
//   base-2 lse m + log2(l) (-1e30 where l = 0).
//
// What bounds it on the H100: device memory.  A step reads the live K and
// V codes and K scales once (64 D + 64 D + 256 bytes a tile and KV head)
// past at most 64 query rows: ~2 operations a byte.  decode.cu's first
// version staged each tile with plain loads behind a barrier, one tile in
// flight a block, scalar FMAs, and a split count set by B * Hk alone, so a
// long sequence's blocks walked 13 tiles where a short one's walked 1.  The
// design:
//   shares    the split count comes from the stream's length (n_units
//             tiles: up to 16 shares, more when B * Hk is small) and each
//             sequence cuts its own live tiles into shares of at least 4,
//             so every block walks about the same bytes; a block whose
//             share starts past the live tiles exits at once, and the
//             merge reads only the live shares.  No host read: lengths,
//             tables and windows are read on the device.
//   staging   a ring of 4 stages; a tile's K box (64 rows x D bytes) and V
//             box by TMA from a rank-4 map of each pool (128-byte swizzle
//             at D = 128, 64-byte at D = 64: conflict-free fragment reads)
//             and its 256 bytes of K scales by a bulk copy, all completing
//             on the stage's mbarrier.  The block reads its share's
//             logical and physical pages once, all threads at once, into
//             shared memory, so that no table read sits between a tile
//             and the request for it; then thread 0 requests the first
//             four live tiles before any math and refills a stage as soon
//             as every warp is done with it; dead tiles (past the length,
//             below the window) are never requested.  A block keeps up to
//             64 KB in flight at D = 128 (three blocks an SM).
//   heads     the query heads of one KV head share a block (up to 64 rows:
//             a T = 4 window of 4 GQA heads is 16), so K and V are read
//             once for all of them.
//   S = QK^T  mma.sync m16n8k16 (bf16 in, f32 sums): warp w takes the
//             tile's tokens 16 w .. 16 w + 15, Q as the A operand from
//             shared memory, K codes widened to bf16 in registers (exact:
//             byte permutes onto 2^23 and one subtract).  A thread's two
//             n8 fragments cover tokens 4 q .. 4 q + 3 (q = lane % 4):
//             the permutation that lets its P go out as one 8-byte store.
//   softmax   each warp's row maxima meet in shared memory (one barrier),
//             every warp takes the same running max, writes its P in bf16
//             and keeps its share of l; O is rescaled in registers.
//   PV        after a second barrier each warp multiplies all 64 tokens of
//             P (from shared memory) by its D / 4 columns of V: four V
//             words from four token rows, transposed by byte permutes,
//             give the B fragments of four columns at once.
//   merge     a second launch: per (sequence, head) the live shares'
//             (m, l, acc) merged exactly, then the epilogue; a thread takes
//             four channels of a row and one of four groups of the shares
//             (every fourth), so that a long sequence's shares are read
//             with many loads in flight.
#include <stdio.h>

#include "sm90.cuh"

namespace pd90 {

using namespace sm90;

constexpr int NT = 128;          // threads per block: four warps
constexpr int TILE = 64;         // cache tokens per tile
constexpr int STAGES = 4;
constexpr int MIN_PER = 4;       // tiles per share, at least
constexpr int MAX_SLOTS = 4096;  // stream slots a share may span
constexpr int CG = 4;            // split groups of the merge's block
constexpr float MASK_NEG = -1e30f;
constexpr float M_CLAMP = -1e20f;

struct Params {
  const __nv_bfloat16* q;  // [B, Hg, R, D], contiguous
  const float* ks;         // [P, Hk, page] f32 (unit token stride)
  long long ks_sb, ks_sh;
  const int* lens;         // [B]
  const int* table;        // [B, n_slots] physical page of each stream slot
  const int* lpage;        // [B, n_slots] logical page of each stream slot
  const int* win_lo;       // [B], or null (no sliding window)
  int Hg, Hk, R, hpb;      // hpb: query heads (of one KV head) per block
  int n_units, n_slots, page, window_T, sinks, sink_pages, n_split;
  int max_slots;           // stream slots a share spans, at most
  float* pm;               // [B*Hg, n_split, R]
  float* pl;
  float* pacc;             // [B*Hg, n_split, R, D]
};

// The live tiles of sequence b and the tiles per share: every slot of a
// sliding-window stream (dead ones are skipped one by one), else those up
// to the length.
__device__ __forceinline__ void shares(const Params& p, int b, int& hi, int& per) {
  const int len = p.lens[b];
  hi = p.n_units;
  if (!p.win_lo) hi = min(hi, (max(len, 0) + TILE - 1) / TILE);
  per = max(MIN_PER, (hi + p.n_split - 1) / p.n_split);
}

// Tile u of a stream: its first position, physical page and 64-row block
// within the page, whether it holds sink slots, and whether any of its
// positions can be seen; the logical and physical pages of the share's
// slots (from slot0 on) are in shared memory.
struct Tile {
  int tok0, phys, sub;
  bool sink, live;
};

__device__ __forceinline__ Tile tile_of(const Params& p, const int* lp, const int* tb, int slot0,
                                        int u, int len, int lo) {
  const int spp = p.page / TILE;
  const int slot = u / spp;
  Tile t;
  t.sub = u % spp;
  t.tok0 = lp[slot - slot0] * p.page + t.sub * TILE;
  t.sink = slot < p.sink_pages;
  t.live = t.tok0 < len;
  if (p.win_lo) t.live = t.live && (t.sink ? t.tok0 < p.sinks : t.tok0 + TILE > lo);
  t.phys = tb[slot - slot0];
  return t;
}

// Byte (row r, column byte c) of a TMA-swizzled int8 tile of D-byte rows:
// 128-byte swizzle at D = 128 (chunk c / 16 ^ r % 8), 64-byte at D = 64
// (chunk c / 16 ^ (r / 2) % 4).
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (D == 128) return r * 128 + ((((c >> 4) ^ (r & 7))) << 4) + (c & 15);
  return r * 64 + ((((c >> 4) ^ ((r >> 1) & 3))) << 4) + (c & 15);
}

// Four int8 codes (the bytes of w) as bf16 pairs: lo = codes 0, 1 and hi =
// codes 2, 3, exact: each biased code placed in the mantissa of 2^23, less
// 2^23 + 128, is the code as an f32 whose top half is its bf16.
__device__ __forceinline__ void i8x4_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t x = w ^ 0x80808080u;
  const float f0 = __fsub_rn(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540)), 8388736.f);
  const float f1 = __fsub_rn(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7541)), 8388736.f);
  const float f2 = __fsub_rn(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7542)), 8388736.f);
  const float f3 = __fsub_rn(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7543)), 8388736.f);
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// d += a b: mma.sync m16n8k16, bf16 in, f32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows 16 mt + g and + 8 from a row-major bf16 array of
// `stride` bytes a row, at logical k16 step columns {2 q, 2 q + 1, 2 q + 8,
// 2 q + 9} = physical columns c0 + 4 q .. + 3 (c0 in elements): one 8-byte
// load a row.
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const uint8_t* base, int stride,
                                       int row, int c0, int q4) {
  const uint2 x = *reinterpret_cast<const uint2*>(base + row * stride + (c0 + 4 * q4) * 2);
  const uint2 y = *reinterpret_cast<const uint2*>(base + (row + 8) * stride + (c0 + 4 * q4) * 2);
  a[0] = x.x;
  a[2] = x.y;
  a[1] = y.x;
  a[3] = y.y;
}

template <int D, int MT>
struct Cfg {
  static constexpr int ROWS = 16 * MT;                // query rows a block, padded
  static constexpr int K_BYTES = TILE * D;
  static constexpr int V_BYTES = TILE * D;
  static constexpr int KS_BYTES = TILE * 4;
  static constexpr int QS = 2 * D + 32;               // Q row stride (bytes): no bank conflicts
  static constexpr int PS = 2 * TILE + 32;            // P row stride
  static constexpr int OFF_V = STAGES * K_BYTES;
  static constexpr int OFF_KS = OFF_V + STAGES * V_BYTES;
  static constexpr int OFF_Q = OFF_KS + STAGES * KS_BYTES;
  static constexpr int OFF_P = OFF_Q + ROWS * QS;
  static constexpr int OFF_MAX = OFF_P + ROWS * PS;   // [4 warps][ROWS] f32
  static constexpr int OFF_SLOT = OFF_MAX + 4 * ROWS * 4;  // the share's slots, 2 ints each
  static constexpr int SMEM = OFF_SLOT + 1024;        // + 8 bytes a slot, set at launch
  static constexpr int NCW = D / 32;                  // n8 column groups of a warp's D / 4
};

// Grid (n_split, Hg / hpb, B), NT threads.
template <int D, int MT>
__global__ void __launch_bounds__(NT) paged_decode_sm90_split_kernel(
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const Params p) {
  using C = Cfg<D, MT>;
  constexpr int ROWS = C::ROWS, NCW = C::NCW;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[STAGES];
  const int split = blockIdx.x, hb = blockIdx.y, b = blockIdx.z;
  int hi, per;
  shares(p, b, hi, per);
  const int u0 = split * per;
  if (u0 >= hi) return;  // the merge reads only the live shares
  const int u1 = min(u0 + per, hi);
  const int len = p.lens[b];
  const int lo = p.win_lo ? p.win_lo[b] : 0;
  const int hk = hb * p.hpb / (p.Hg / p.Hk);

  uint8_t* const sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_u32(sm);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int nrows = p.hpb * p.R;  // real rows: head (hb hpb + r / R), row r % R

  // the share's logical and physical pages, read once (no table read on the
  // way to a tile's loads)
  const int slot0 = u0 / (p.page / TILE);
  int* const sLp = reinterpret_cast<int*>(sm + C::OFF_SLOT);
  int* const sTb = sLp + p.max_slots;
  for (int i = tid, n = (u1 - 1) / (p.page / TILE) - slot0 + 1; i < n; i += NT) {
    sLp[i] = p.lpage[(long long)b * p.n_slots + slot0 + i];
    sTb[i] = p.table[(long long)b * p.n_slots + slot0 + i];
  }

  // the next live tile of this share into the next stage (thread 0)
  int issue_u = u0, n_issued = 0;
  auto issue_next = [&]() {
    while (issue_u < u1) {
      const Tile t = tile_of(p, sLp, sTb, slot0, issue_u++, len, lo);
      if (!t.live) continue;
      const int s = n_issued++ % STAGES;
      const uint32_t bar = smem_u32(&bars[s]);
      mbar_expect_tx(bar, C::K_BYTES + C::V_BYTES + C::KS_BYTES);
      tma_load4(s0 + s * C::K_BYTES, &tm_k, bar, 0, t.sub * TILE, hk, t.phys);
      tma_load4(s0 + C::OFF_V + s * C::V_BYTES, &tm_v, bar, 0, t.sub * TILE, hk, t.phys);
      bulk_load(s0 + C::OFF_KS + s * C::KS_BYTES,
                p.ks + t.phys * p.ks_sb + hk * p.ks_sh + t.sub * TILE, C::KS_BYTES, bar);
      return;
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Q rows into shared memory (zero past the real rows), 16 bytes a thread
  uint8_t* const sQ = sm + C::OFF_Q;
  for (int c = tid; c < ROWS * (D / 8); c += NT) {
    const int r = c / (D / 8), ch = c % (D / 8);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < nrows) {
      const int head = hb * p.hpb + r / p.R;
      val = *reinterpret_cast<const uint4*>(
          p.q + ((long long)(b * p.Hg + head) * p.R + r % p.R) * D + ch * 8);
    }
    *reinterpret_cast<uint4*>(sQ + r * C::QS + ch * 16) = val;
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < STAGES; ++s) issue_next();

  uint8_t* const sP = sm + C::OFF_P;
  float* const sMax = reinterpret_cast<float*>(sm + C::OFF_MAX);
  // this thread's rows: 16 mt + g + 8 h (h = 0, 1); their position in the
  // head's R rows for the T > 1 window
  int rr[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) rr[mt][h] = (16 * mt + g + 8 * h) % p.R;
  float m[MT][2], l[MT][2], o[MT][NCW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mt][h] = M_CLAMP;
      l[mt][h] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NCW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
  }

  int i = 0;  // live tiles done
  for (int u = u0; u < u1; ++u) {
    const Tile t = tile_of(p, sLp, sTb, slot0, u, len, lo);
    if (!t.live) continue;  // block-uniform
    const int s = i % STAGES;
    mbar_wait(smem_u32(&bars[s]), (i / STAGES) & 1);
    const uint8_t* const sK = sm + s * C::K_BYTES;
    const uint8_t* const sV = sm + C::OFF_V + s * C::V_BYTES;
    const float* const sKS = reinterpret_cast<const float*>(sm + C::OFF_KS + s * C::KS_BYTES);

    // ---- S for this warp's 16 tokens: n8 group j holds tokens 4 q + 2 j + {0, 1} ----
    float sc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t kb[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = 16 * w + 4 * (g >> 1) + 2 * j + (g & 1);
        i8x4_bf16(*reinterpret_cast<const uint32_t*>(sK + swz<D>(row, 16 * ks + 4 * q4)),
                  kb[j][0], kb[j][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        a_frag(a, sQ, C::QS, 16 * mt + g, 16 * ks, q4);
#pragma unroll
        for (int j = 0; j < 2; ++j) mma(sc[mt][j], a, kb[j][0], kb[j][1]);
      }
    }
    // scale by the K scales, mask, and this warp's row maxima
    const float4 kv = *reinterpret_cast<const float4*>(sKS + 16 * w + 4 * q4);
    const float ksc[4] = {kv.x, kv.y, kv.z, kv.w};
    const int tq = t.tok0 + 16 * w + 4 * q4;  // this thread's first token
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = -INFINITY;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int tok = tq + 2 * j + e;
            float v = __fmul_rn(sc[mt][j][2 * h + e], ksc[2 * j + e]);
            bool keep;
            if (p.window_T > 1) {
              keep = tok <= len - p.window_T + rr[mt][h];
            } else {
              keep = tok < len;
              if (p.win_lo) keep = keep && (p.sinks && t.sink ? tok < p.sinks : tok >= lo);
            }
            v = keep ? v : MASK_NEG;
            sc[mt][j][2 * h + e] = v;
            x = fmaxf(x, v);
          }
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        if (q4 == 0) sMax[w * ROWS + 16 * mt + g + 8 * h] = x;
      }
    __syncthreads();  // the row maxima; every warp is done with the last tile's P and V
    if (tid == 0 && i > 0) issue_next();  // the last tile's stage is free

    // ---- the running max, P in bf16 (this warp's tokens), l, O's rescale ----
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * mt + g + 8 * h;
        const float x = fmaxf(fmaxf(sMax[row], sMax[ROWS + row]),
                              fmaxf(sMax[2 * ROWS + row], sMax[3 * ROWS + row]));
        const float mn = fmaxf(fmaxf(m[mt][h], x), M_CLAMP);
        const float al = ex2(__fsub_rn(m[mt][h], mn));
        m[mt][h] = mn;
        float pv[4], sum = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            pv[2 * j + e] = ex2(__fsub_rn(sc[mt][j][2 * h + e], mn));
            sum += pv[2 * j + e];
          }
        l[mt][h] = __fadd_rn(__fmul_rn(al, l[mt][h]), sum);
        *reinterpret_cast<uint2*>(sP + row * C::PS + (16 * w + 4 * q4) * 2) =
            make_uint2(pack_bf16(pv[0], pv[1]), pack_bf16(pv[2], pv[3]));
#pragma unroll
        for (int n = 0; n < NCW; ++n) {
          o[mt][n][2 * h] = __fmul_rn(o[mt][n][2 * h], al);
          o[mt][n][2 * h + 1] = __fmul_rn(o[mt][n][2 * h + 1], al);
        }
      }
    __syncthreads();  // P

    // ---- O[:, this warp's D / 4 columns] += P V over the tile's 64 tokens ----
    // k16 step kk: logical k {2 q, 2 q + 1 | 2 q + 8, 2 q + 9} are tokens
    // 16 kk + 4 q + {0, 1 | 2, 3}; logical column g of n8 group n is column
    // D / 4 w + 4 g + n (D = 128) or D / 4 w + 2 g + n (D = 64)
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      const int c = D == 128 ? 32 * w + 4 * g : 16 * w + 4 * (g >> 1);
      uint32_t wv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        wv[r] = *reinterpret_cast<const uint32_t*>(sV + swz<D>(16 * kk + 4 * q4 + r, c));
      // 4 x 4 byte transpose: tc[n] = column c + n of the four tokens
      uint32_t x01 = __byte_perm(wv[0], wv[1], 0x5140), y01 = __byte_perm(wv[0], wv[1], 0x7362);
      uint32_t x23 = __byte_perm(wv[2], wv[3], 0x5140), y23 = __byte_perm(wv[2], wv[3], 0x7362);
      uint32_t tc[NCW];
      if constexpr (D == 128) {
        tc[0] = __byte_perm(x01, x23, 0x5410);
        tc[1] = __byte_perm(x01, x23, 0x7632);
        tc[2] = __byte_perm(y01, y23, 0x5410);
        tc[3] = __byte_perm(y01, y23, 0x7632);
      } else {  // this thread's two columns are bytes 2 (g % 2) and + 1 of the words
        const uint32_t a01 = (g & 1) ? y01 : x01, a23 = (g & 1) ? y23 : x23;
        tc[0] = __byte_perm(a01, a23, 0x5410);
        tc[1] = __byte_perm(a01, a23, 0x7632);
      }
      uint32_t vb[NCW][2];
#pragma unroll
      for (int n = 0; n < NCW; ++n) i8x4_bf16(tc[n], vb[n][0], vb[n][1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        a_frag(a, sP, C::PS, 16 * mt + g, 16 * kk, q4);
#pragma unroll
        for (int n = 0; n < NCW; ++n) mma(o[mt][n], a, vb[n][0], vb[n][1]);
      }
    }
    ++i;
  }

  // ---- this share's (m, l, acc): l summed over the quad and the warps ----
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = l[mt][h];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      l[mt][h] = x;
    }
  __syncthreads();  // sMax is free
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (q4 == 0) sMax[w * ROWS + 16 * mt + g + 8 * h] = l[mt][h];
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * mt + g + 8 * h;
      if (row >= nrows) continue;
      const int head = hb * p.hpb + row / p.R;
      const long long base =
          ((long long)(b * p.Hg + head) * p.n_split + split) * p.R + row % p.R;
      if (w == 0 && q4 == 0) {
        p.pm[base] = m[mt][h];
        p.pl[base] = __fadd_rn(__fadd_rn(sMax[row], sMax[ROWS + row]),
                               __fadd_rn(sMax[2 * ROWS + row], sMax[3 * ROWS + row]));
      }
      float* acc = p.pacc + base * D;
#pragma unroll
      for (int n = 0; n < NCW; ++n) {
        // logical columns 2 q and 2 q + 1 of n8 group n
        const int c0 = D == 128 ? 32 * w + 8 * q4 + n : 16 * w + 4 * q4 + n;
        const int c1 = D == 128 ? c0 + 4 : c0 + 2;
        acc[c0] = o[mt][n][2 * h];
        acc[c1] = o[mt][n][2 * h + 1];
      }
    }
}

// The exact merge of the live shares and the epilogue: out = acc / l *
// v_scale + v_mean; lse (or null) m + log2(l), -1e30 where l = 0.  A block
// per (sequence, head) of CG * NT threads: each takes 4 channels of a row,
// its group every CG-th share, the groups' sums then added in order.
__global__ void __launch_bounds__(NT * CG) paged_decode_sm90_combine_kernel(
    const Params p, int D, const float* v_scale, const float* v_mean, __nv_bfloat16* out,
    float* lse) {
  __shared__ float4 s_a[CG][NT];
  __shared__ float s_l[CG][NT];
  const int bh = blockIdx.x;
  const int b = bh / p.Hg, hk = (bh % p.Hg) / (p.Hg / p.Hk);
  const int grp = threadIdx.x / NT, t = threadIdx.x % NT;
  int hi, per;
  shares(p, b, hi, per);
  const int n_live = (hi + per - 1) / per;
  const float* pm = p.pm + (long long)bh * p.n_split * p.R;
  const float* pl = p.pl + (long long)bh * p.n_split * p.R;
  const float4* pacc =
      reinterpret_cast<const float4*>(p.pacc + (long long)bh * p.n_split * p.R * D);
  const int D4 = D / 4, n4 = p.R * D4;
  for (int i0 = 0; i0 < n4; i0 += NT) {
    const int idx = i0 + t;
    const bool on = idx < n4;
    const int r = on ? idx / D4 : 0, c4 = idx % D4;
    float mg = M_CLAMP;
#pragma unroll 8
    for (int s = 0; s < n_live; ++s) mg = fmaxf(mg, pm[s * p.R + r]);
    float l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (on) {
#pragma unroll 4
      for (int s = grp; s < n_live; s += CG) {
        const float wgt = exp2f(__fsub_rn(pm[s * p.R + r], mg));
        const float4 x = pacc[(long long)s * n4 + idx];
        l = __fadd_rn(l, __fmul_rn(wgt, pl[s * p.R + r]));
        a.x = __fadd_rn(a.x, __fmul_rn(wgt, x.x));
        a.y = __fadd_rn(a.y, __fmul_rn(wgt, x.y));
        a.z = __fadd_rn(a.z, __fmul_rn(wgt, x.z));
        a.w = __fadd_rn(a.w, __fmul_rn(wgt, x.w));
      }
    }
    s_a[grp][t] = a;
    s_l[grp][t] = l;
    __syncthreads();
    if (grp == 0 && on) {
#pragma unroll
      for (int k = 1; k < CG; ++k) {
        l = __fadd_rn(l, s_l[k][t]);
        a.x = __fadd_rn(a.x, s_a[k][t].x);
        a.y = __fadd_rn(a.y, s_a[k][t].y);
        a.z = __fadd_rn(a.z, s_a[k][t].z);
        a.w = __fadd_rn(a.w, s_a[k][t].w);
      }
      const float inv = __fdiv_rn(1.f, l == 0.f ? 1.f : l);
      const float4 vs = reinterpret_cast<const float4*>(v_scale + hk * D)[c4];
      const float4 vm = reinterpret_cast<const float4*>(v_mean + hk * D)[c4];
      const uint2 o = make_uint2(
          pack_bf16(__fadd_rn(__fmul_rn(__fmul_rn(a.x, inv), vs.x), vm.x),
                    __fadd_rn(__fmul_rn(__fmul_rn(a.y, inv), vs.y), vm.y)),
          pack_bf16(__fadd_rn(__fmul_rn(__fmul_rn(a.z, inv), vs.z), vm.z),
                    __fadd_rn(__fmul_rn(__fmul_rn(a.w, inv), vs.w), vm.w)));
      reinterpret_cast<uint2*>(out + ((long long)bh * p.R + r) * D)[c4] = o;
      if (lse && c4 == 0)
        lse[(long long)bh * p.R + r] = l > 0.f ? __fadd_rn(mg, log2f(l)) : -1e30f;
    }
    __syncthreads();
  }
}

}  // namespace pd90

// ------------------------------------------------------------------ host --

namespace {

using namespace pd90;

template <int D, int MT>
int launch(const void* k, const void* v, const long long* st, int P, const Params& p, int B,
           cudaStream_t stream) {
  using C = Cfg<D, MT>;
  CUtensorMap mk, mv;
  const CUtensorMapSwizzle swz = D == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  if (!make_map_t(&mk, k, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, p.page, p.Hk, P, st[2], st[1],
                  st[0], D, TILE, swz) ||
      !make_map_t(&mv, v, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, p.page, p.Hk, P, st[5], st[4],
                  st[3], D, TILE, swz))
    return -2;
  static const cudaError_t attr =
      cudaFuncSetAttribute(paged_decode_sm90_split_kernel<D, MT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM + 8 * MAX_SLOTS);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(p.n_split, p.Hg / p.hpb, B);
  paged_decode_sm90_split_kernel<D, MT><<<grid, NT, C::SMEM + 8 * p.max_slots, stream>>>(mk, mv,
                                                                                       p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mt(const void* k, const void* v, const long long* st, int P, const Params& p, int B,
              cudaStream_t s) {
  const int rows = p.hpb * p.R;
  if (rows <= 16) return launch<D, 1>(k, v, st, P, p, B, s);
  if (rows <= 32) return launch<D, 2>(k, v, st, P, p, B, s);
  return launch<D, 4>(k, v, st, P, p, B, s);
}

}  // namespace

extern "C" {

const char* sage_paged_decode_sm90_error_string(int e) {
  if (e == -1)
    return "unsupported D1-int8 configuration (head_dim, rows, page, strides or pointers)";
  if (e == -2) {
    static char msg[128];
    snprintf(msg, sizeof msg,
             "cuTensorMapEncodeTiled failed (result %d; -1: not found in the driver)",
             g_encode_result);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)e);
}

// D1-int8 on q [B, Hg, R, D] bf16 (contiguous, pre-scaled), the pools k8
// and v8 [P, Hk, page, D] int8 with element strides (batch, head, row; unit
// column stride, 16-byte aligned base and strides), ks [P, Hk, page] f32
// with element strides (ks_sb, ks_sh) (multiples of 4, 16-byte aligned
// base); lens [B], table and lpage [B, n_slots], win_lo [B] (or null) int32;
// hpb query heads a block (hpb R <= 64, Hg / Hk a multiple of it); v_scale
// and v_mean [Hk, D] f32; scratch pm, pl [B*Hg, n_split, R] and pacc [...,
// D] f32; out [B, Hg, R, D] bf16 and lse [B, Hg, R] (or null) f32.
int sage_paged_decode_sm90(int D, int hpb, const void* q, const void* k, const void* v,
                           const float* ks, long long k_sb, long long k_sh, long long k_ss,
                           long long v_sb, long long v_sh, long long v_ss, long long ks_sb,
                           long long ks_sh, const int* lens, const int* table, const int* lpage,
                           const int* win_lo, int B, int P, int Hg, int Hk, int R, int n_units,
                           int n_slots, int page, int window_T, int sinks, int sink_pages,
                           int n_split, const float* v_scale, const float* v_mean, float* pm,
                           float* pl, float* pacc, void* out, float* lse, void* stream) {
  const long long st[6] = {k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  for (int i = 0; i < 6; ++i)
    if (st[i] < 0 || st[i] % 16) return -1;
  if ((D != 64 && D != 128) || R < 1 || R > 32 || hpb < 1 || hpb * R > 64 || Hk < 1 ||
      Hg % Hk || (Hg / Hk) % hpb || page < TILE || page % TILE || n_split < 1 || B < 1 ||
      P < 1 || !q || !ks || !lens || !table || !lpage || !v_scale || !v_mean ||
      ks_sb % 4 || ks_sh % 4 || reinterpret_cast<uintptr_t>(ks) % 16 ||
      reinterpret_cast<uintptr_t>(q) % 16 || n_units > n_slots * (page / TILE))
    return -1;
  // the most slots a share spans: ceil(per / tiles a page) + 1, per at most
  // max(MIN_PER, ceil(n_units / n_split))
  const int per_max = max(MIN_PER, (n_units + n_split - 1) / n_split);
  const int max_slots = (per_max + page / TILE - 1) / (page / TILE) + 1;
  if (max_slots > MAX_SLOTS) return -1;
  Params p{static_cast<const __nv_bfloat16*>(q), ks, ks_sb, ks_sh, lens, table, lpage, win_lo,
           Hg, Hk, R, hpb, n_units, n_slots, page, window_T, sinks, sink_pages, n_split,
           max_slots, pm, pl, pacc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e =
      D == 64 ? launch_mt<64>(k, v, st, P, p, B, s) : launch_mt<128>(k, v, st, P, p, B, s);
  if (e != 0) return e;
  paged_decode_sm90_combine_kernel<<<B * Hg, NT * CG, 0, s>>>(
      p, D, v_scale, v_mean, static_cast<__nv_bfloat16*>(out), lse);
  return (int)cudaGetLastError();
}

}  // extern "C"
