// B11 on an int8 V cache, the dense decode and its verify windows,
// redesigned for Hopper: each block walks a share of the cache's live
// 64-token tiles for the query rows of one KV head, its K and V codes
// brought by TMA into a ring of stages that one thread keeps full, the
// scores and the PV product on int8 mma.sync tensor cores, then an exact
// merge of the shares.
//
// Replaces the Pallas kernel `_attn_kernel` (sageattention_tpu/ops/
// attention.py:251, launched by `attention_call`) in the decode
// configuration that `sageattn_decode` (sageattention_tpu/decode.py)
// builds, with int8 V codes at head dims 64 and 128 and a bf16 output:
// every launch key of it, `B11-int8`, `B11-int8-causal` and
// `B11-int8-causal-mod`.  e4m3 and bf16 V, D = 256 and an f32 output stay
// on decode.cu.  What it computes, as the plain version (ops/attention.py
// `decode_plain`):
//   q [B, Hg, R, D] bf16 (or f32), times sm_scale * log2(e) in f32 and
//   quantized to int8 per row (qs = max|x| / 127); the cache k8 [B, Hk, S,
//   D] int8 with per-token scales ks [B, Hk, S] f32, v8 [B, Hk, S, D] int8
//   with per-sequence v_scale / v_mean [B|1, Hk, D].  s = (s32 * qs) * ks,
//   masked to -1e30 at and past the device length min(kv_true, S) and, in a
//   verify window, where kv_start + token > q_start + row (row: r, or r %
//   T for folded GQA rows), both offsets read from device memory.  The
//   online softmax over 64-token tiles, the running max floored at -1e20;
//   P = rint(exp2(s - m + log2 127)) as int8 codes against the V codes with
//   exact integer sums, l summing the rounded P / 127.  A sequence's live
//   tiles are cut into shares of `per` = max(4, ceil(live / n_split))
//   tiles, one block each; the merge takes the shares in order, then out =
//   acc / l * v_scale / 127 + v_mean in bf16 and, optionally, the base-2
//   lse m + log2(max(l, 1e-37)).
//
// What bounds it on the H100: device memory.  A step reads the live K and
// V codes and K scales once (64 D + 64 D + 256 bytes a tile and KV head)
// past at most 64 query rows: ~2 operations a byte.  decode.cu's first
// version staged each tile with plain 16-byte loads behind a barrier, one
// tile in flight a block, scalar dp4a and FMAs in 128 threads, a split
// count set by B * Hk alone, and at most 32 rows a block, so a folded
// T = 9 window over 4 GQA heads (36 rows) took two launches that each read
// the whole cache.  The design (after paged_decode_sm90.cu):
//   shares    the split count comes from the stream's length (n_units
//             tiles: up to 16 shares, more when B * Hk is small) and the
//             live tiles are cut into shares of at least 4, so every block
//             walks about the same bytes; a block whose share starts past
//             the live tiles exits at once, and the merge reads only the
//             live shares.  The count depends neither on R nor on the fold.
//             No host read: the length and the offsets are read on the
//             device.
//   staging   a ring of 4 stages (3 at 48 rows, so that three blocks fit
//             an SM); a tile's K box (64 rows x D bytes) and V box by TMA
//             from a rank-4 map over the cache's (strided) view (128-byte
//             swizzle at D = 128, 64-byte at D = 64) and its 256 bytes of K
//             scales by a bulk copy, all completing on the stage's
//             mbarrier.  Thread 0 requests the first tiles before any math
//             and refills a stage as soon as every warp is done with it; no
//             tile past the length is requested.
//   rows      the query rows of one KV head share a block, up to 64 in
//             16-row steps (a folded T = 9 window of 4 GQA heads is 36, a
//             48-row block: one launch reads the cache once); more rows
//             take more blocks of the same launch.
//   S = QK^T  mma.sync m16n8k32 (s8 in, s32 sums): warp w takes the tile's
//             tokens 16 w .. 16 w + 15; Q codes (quantized by the block into
//             a swizzled region) as A, K rows as the column-major B.  A k32
//             step takes 8 bytes a thread from chunks ks and ks + D / 32 of
//             a row, a permutation of D that both operands share, so that
//             the four rows a half-warp reads fall on distinct banks.
//   softmax   each warp's row maxima meet in shared memory (one barrier),
//             every warp takes the same running max, writes its P codes and
//             keeps its share of l.
//   PV        after a second barrier each warp multiplies all 64 tokens of
//             P (int8, from shared memory) by its D / 4 columns of V
//             (m16n8k32, s32 sums, exact): eight V words from eight token
//             rows, transposed by byte permutes, give the B fragments of
//             four columns; P is stored in the order those fragments take
//             their tokens (2 q, 2 q + 1, 8 + 2 q, ... of each 32), which
//             spreads a warp's eight rows over the banks.  O = O * alpha +
//             the tile's exact sum, in the plain version's order.
//   merge     a second launch: per (sequence, head, 128 four-channel
//             groups of its rows) the live shares' (m, l, acc) merged
//             exactly, then the epilogue; a thread takes four channels of a
//             row and one of four groups of the shares.
#include <stdio.h>

#include "sm90.cuh"

namespace d90 {

using namespace sm90;

constexpr int NT = 128;         // threads per block: four warps
constexpr int TILE = 64;        // cache tokens per tile
constexpr int MAX_STAGES = 4;
constexpr int MIN_PER = 4;      // tiles per share, at least
constexpr int MAX_ROWS = 64;    // query rows a block
constexpr int CG = 4;           // split groups of the merge's block
constexpr float MASK_NEG = -1e30f;
constexpr float M_CLAMP = -1e20f;
constexpr float P_OFFSET_LOG2 = 6.988684686772166f;  // log2(127)

struct Params {
  const void* q;          // [B, Hg, R, D] bf16 (q_f32: f32), contiguous
  const float* ks;        // [B, Hk, >= n_units * 64] f32 (unit token stride)
  long long ks_sb, ks_sh;
  const int* kv_true;     // [1] the device length
  const int* offsets;     // [2] (q_start, kv_start), or null: no window
  int q_f32, Hg, Hk, R, hpb, n_rt;  // hpb query heads a block; n_rt row tiles of a head
  int S, n_units, n_split, row_mod;
  float fold;             // sm_scale * log2(e)
  float* pm;              // [B*Hg, n_split, R]
  float* pl;
  float* pacc;            // [B*Hg, n_split, R, D]
};

// The live length, the live tiles and the tiles a share.
__device__ __forceinline__ void shares(const Params& p, int& len, int& hi, int& per) {
  len = max(0, min(p.kv_true[0], p.S));
  hi = min(p.n_units, (len + TILE - 1) / TILE);
  per = max(MIN_PER, (hi + p.n_split - 1) / p.n_split);
}

// Byte (row r, column byte c) of a TMA-swizzled int8 tile of D-byte rows:
// 128-byte swizzle at D = 128 (chunk c / 16 ^ r % 8), 64-byte at D = 64
// (chunk c / 16 ^ (r / 2) % 4).
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (D == 128) return r * 128 + ((((c >> 4) ^ (r & 7))) << 4) + (c & 15);
  return r * 64 + ((((c >> 4) ^ ((r >> 1) & 3))) << 4) + (c & 15);
}

// d += a b: mma.sync m16n8k32, s8 in, s32 sums.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D, int MT>
struct Cfg {
  static constexpr int ROWS = 16 * MT;                // query rows a block, padded
  // three stages at 48 rows, so that three blocks fit an SM's shared memory
  // (and registers: the launch bound); four otherwise
  static constexpr int STAGES = MT == 3 ? 3 : MAX_STAGES;
  static constexpr int MIN_BLOCKS = MT == 3 ? 3 : 1;
  static constexpr int K_BYTES = TILE * D;
  static constexpr int V_BYTES = TILE * D;
  static constexpr int KS_BYTES = TILE * 4;
  static constexpr int PS = TILE + 32;                // P row stride (bytes): no bank conflicts
  static constexpr int OFF_V = STAGES * K_BYTES;
  static constexpr int OFF_KS = OFF_V + STAGES * V_BYTES;
  static constexpr int OFF_Q = OFF_KS + STAGES * KS_BYTES;   // 128-aligned
  static constexpr int OFF_P = OFF_Q + ROWS * D;
  static constexpr int OFF_MAX = OFF_P + ROWS * PS;   // [4 warps][ROWS] f32
  static constexpr int OFF_QS = OFF_MAX + 4 * ROWS * 4;
  static constexpr int SMEM = OFF_QS + ROWS * 4 + 1024;  // + the base's alignment
  static constexpr int NCW = D / 32;                  // n8 column groups of a warp's D / 4
};

// Grid (n_split, Hg / hpb * n_rt, B), NT threads.
template <int D, int MT>
__global__ void __launch_bounds__(NT, Cfg<D, MT>::MIN_BLOCKS) decode_sm90_split_kernel(
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const Params p) {
  using C = Cfg<D, MT>;
  constexpr int ROWS = C::ROWS, NCW = C::NCW, STAGES = C::STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[STAGES];
  const int split = blockIdx.x, b = blockIdx.z;
  const int hb = blockIdx.y / p.n_rt, rt = blockIdx.y % p.n_rt;
  int len, hi, per;
  shares(p, len, hi, per);
  const int u0 = split * per;
  if (u0 >= hi) return;  // the merge reads only the live shares
  const int u1 = min(u0 + per, hi);
  const int hk = hb * p.hpb / (p.Hg / p.Hk);

  uint8_t* const sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_u32(sm);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  // this block's rows: row i is query head hb hpb + i / rb, row rt rb + i % rb
  // of its R (rb = R, or 64 when a head's rows take several blocks)
  const int rb = p.n_rt > 1 ? MAX_ROWS : p.R;
  const int nrows = p.n_rt > 1 ? min(MAX_ROWS, p.R - rt * MAX_ROWS) : p.hpb * p.R;

  // the next tile of this share into the next stage (thread 0)
  int issue_u = u0;
  auto issue_next = [&]() {
    if (issue_u >= u1) return;
    const int s = (issue_u - u0) % STAGES;
    const uint32_t bar = smem_u32(&bars[s]);
    mbar_expect_tx(bar, C::K_BYTES + C::V_BYTES + C::KS_BYTES);
    tma_load4(s0 + s * C::K_BYTES, &tm_k, bar, 0, issue_u * TILE, hk, b);
    tma_load4(s0 + C::OFF_V + s * C::V_BYTES, &tm_v, bar, 0, issue_u * TILE, hk, b);
    bulk_load(s0 + C::OFF_KS + s * C::KS_BYTES,
              p.ks + b * p.ks_sb + hk * p.ks_sh + (long long)issue_u * TILE, C::KS_BYTES, bar);
    ++issue_u;
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < STAGES; ++s) issue_next();
  }

  // ---- Q rows: x = q * fold, int8 codes per row into the swizzled region ----
  uint8_t* const sQ = sm + C::OFF_Q;
  float* const sQS = reinterpret_cast<float*>(sm + C::OFF_QS);
  for (int r = w; r < ROWS; r += NT / 32) {
    constexpr int E = D / 32;
    float x[E];
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] = 0.f;
    if (r < nrows) {
      const int head = hb * p.hpb + r / rb;
      const long long row = (long long)(b * p.Hg + head) * p.R + rt * rb + r % rb;
      if (p.q_f32) {
        const float* src = static_cast<const float*>(p.q) + row * D + lane * E;
#pragma unroll
        for (int e = 0; e < E; ++e) x[e] = src[e];
      } else {
        const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(p.q) + row * D + lane * E;
#pragma unroll
        for (int e = 0; e < E; ++e) x[e] = __bfloat162float(src[e]);
      }
    }
    float a = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      x[e] = __fmul_rn(x[e], p.fold);
      a = fmaxf(a, fabsf(x[e]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    const float qs = a > 0.f ? __fmul_rn(a, (float)(1.0 / 127.0)) : 1.f;
    const float inv = __fdiv_rn(1.f, qs);
    uint32_t packed = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = (int)fminf(fmaxf(rintf(__fmul_rn(x[e], inv)), -127.f), 127.f);
      packed |= (uint32_t)(c & 0xff) << (8 * e);
    }
    uint8_t* dst = sQ + swz<D>(r, lane * E);
    if constexpr (E == 4) *reinterpret_cast<uint32_t*>(dst) = packed;
    else *reinterpret_cast<uint16_t*>(dst) = (uint16_t)packed;
    if (lane == 0) sQS[r] = qs;
  }
  __syncthreads();

  uint8_t* const sP = sm + C::OFF_P;
  float* const sMax = reinterpret_cast<float*>(sm + C::OFF_MAX);
  // this thread's rows 16 mt + g + 8 h: their Q scale and the last token
  // they may see (the verify window; INT_MAX without one)
  int lim[MT][2];
  float qsr[MT][2];
  {
    int q_start = 0, kv_start = 0;
    if (p.offsets) {
      q_start = p.offsets[0];
      kv_start = p.offsets[1];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * mt + g + 8 * h;
        const int rr = rt * rb + r % rb;
        lim[mt][h] = p.offsets ? q_start + (p.row_mod ? rr % p.row_mod : rr) - kv_start
                               : 0x7fffffff;
        qsr[mt][h] = sQS[r];
      }
  }
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

  for (int u = u0; u < u1; ++u) {
    const int i = u - u0;
    const int s = i % STAGES;
    mbar_wait(smem_u32(&bars[s]), (i / STAGES) & 1);
    const uint8_t* const sK = sm + s * C::K_BYTES;
    const uint8_t* const sV = sm + C::OFF_V + s * C::V_BYTES;
    const float* const sKS = reinterpret_cast<const float*>(sm + C::OFF_KS + s * C::KS_BYTES);

    // ---- S for this warp's 16 tokens: n8 group j holds tokens 16 w + 8 j + n ----
    int sc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][j][e] = 0;
#pragma unroll
    for (int ks = 0; ks < D / 32; ++ks) {
      // this thread's 8 bytes of the step: chunk ks + D / 32 * (q / 2), half q % 2
      const int cb = 16 * (ks + (D / 32) * (q4 >> 1)) + 8 * (q4 & 1);
      uint2 kb[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kb[j] = *reinterpret_cast<const uint2*>(sK + swz<D>(16 * w + 8 * j + g, cb));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint2 x = *reinterpret_cast<const uint2*>(sQ + swz<D>(16 * mt + g, cb));
        const uint2 y = *reinterpret_cast<const uint2*>(sQ + swz<D>(16 * mt + g + 8, cb));
        const uint32_t a[4] = {x.x, y.x, x.y, y.y};
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_s8(sc[mt][j], a, kb[j].x, kb[j].y);
      }
    }
    // scale by the row's Q scale and the token's K scale, mask, row maxima
    float sf[MT][2][4];
    const int tq = u * TILE + 16 * w + 2 * q4;  // this thread's first token (j = e = 0)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = -INFINITY;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 kv = *reinterpret_cast<const float2*>(sKS + 16 * w + 8 * j + 2 * q4);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int tok = tq + 8 * j + e;
            float v = __fmul_rn(__fmul_rn((float)sc[mt][j][2 * h + e], qsr[mt][h]),
                                e ? kv.y : kv.x);
            v = (tok < len && tok <= lim[mt][h]) ? v : MASK_NEG;
            sf[mt][j][2 * h + e] = v;
            x = fmaxf(x, v);
          }
        }
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        if (q4 == 0) sMax[w * ROWS + 16 * mt + g + 8 * h] = x;
      }
    __syncthreads();  // the row maxima; every warp is done with the last tile's P and V
    if (tid == 0 && i > 0) issue_next();  // the last tile's stage is free

    // ---- the running max, P codes (this warp's tokens), l ----
    float al[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * mt + g + 8 * h;
        const float x = fmaxf(fmaxf(sMax[row], sMax[ROWS + row]),
                              fmaxf(sMax[2 * ROWS + row], sMax[3 * ROWS + row]));
        const float mn = fmaxf(fmaxf(m[mt][h], x), M_CLAMP);
        al[mt][h] = ex2(__fsub_rn(m[mt][h], mn));
        m[mt][h] = mn;
        uint32_t word = 0;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pv =
                rintf(ex2(__fadd_rn(__fsub_rn(sf[mt][j][2 * h + e], mn), P_OFFSET_LOG2)));
            sum += pv;  // integers: exact
            word |= (uint32_t)pv << (8 * (2 * j + e));
          }
        l[mt][h] = __fadd_rn(__fmul_rn(al[mt][h], l[mt][h]), sum);
        // token 16 w + 8 j + 2 q + e sits at byte 32 (w / 2) + 8 q + 4 (w % 2) + 2 j + e
        *reinterpret_cast<uint32_t*>(sP + row * C::PS + 32 * (w >> 1) + 8 * q4 + 4 * (w & 1)) =
            word;
      }
    __syncthreads();  // P

    // ---- O[:, this warp's D / 4 columns] = O * alpha + P V over the tile ----
    // k32 step kk: byte i of a thread's 8 is token 32 kk + 8 (i / 2) + 2 q +
    // i % 2; logical column g of n8 group n is column D / 4 w + 4 g + n
    // (D = 128) or D / 4 w + 2 g + n (D = 64)
    uint32_t vb[2][NCW][2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int c = D == 128 ? 32 * w + 4 * g : 16 * w + 4 * (g >> 1);
      uint32_t wv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        wv[i] = *reinterpret_cast<const uint32_t*>(
            sV + swz<D>(32 * kk + 8 * (i >> 1) + 2 * q4 + (i & 1), c));
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        // 4 x 4 byte transpose of token rows 4 hf .. 4 hf + 3: column c + n
        const uint32_t* const r4 = wv + 4 * hf;
        const uint32_t x01 = __byte_perm(r4[0], r4[1], 0x5140), y01 = __byte_perm(r4[0], r4[1], 0x7362);
        const uint32_t x23 = __byte_perm(r4[2], r4[3], 0x5140), y23 = __byte_perm(r4[2], r4[3], 0x7362);
        if constexpr (D == 128) {
          vb[kk][0][hf] = __byte_perm(x01, x23, 0x5410);
          vb[kk][1][hf] = __byte_perm(x01, x23, 0x7632);
          vb[kk][2][hf] = __byte_perm(y01, y23, 0x5410);
          vb[kk][3][hf] = __byte_perm(y01, y23, 0x7632);
        } else {  // this thread's two columns are bytes 2 (g % 2) and + 1 of the words
          const uint32_t a01 = (g & 1) ? y01 : x01, a23 = (g & 1) ? y23 : x23;
          vb[kk][0][hf] = __byte_perm(a01, a23, 0x5410);
          vb[kk][1][hf] = __byte_perm(a01, a23, 0x7632);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint2 x = *reinterpret_cast<const uint2*>(sP + (16 * mt + g) * C::PS + 32 * kk + 8 * q4);
        const uint2 y =
            *reinterpret_cast<const uint2*>(sP + (16 * mt + g + 8) * C::PS + 32 * kk + 8 * q4);
        a[kk][0] = x.x;
        a[kk][1] = y.x;
        a[kk][2] = x.y;
        a[kk][3] = y.y;
      }
#pragma unroll
      for (int n = 0; n < NCW; ++n) {
        int t[4] = {0, 0, 0, 0};
        mma_s8(t, a[0], vb[0][n][0], vb[0][n][1]);
        mma_s8(t, a[1], vb[1][n][0], vb[1][n][1]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[mt][n][e] = __fadd_rn(__fmul_rn(o[mt][n][e], al[mt][e >> 1]), (float)t[e]);
      }
    }
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
      const int head = hb * p.hpb + row / rb;
      const long long base =
          ((long long)(b * p.Hg + head) * p.n_split + split) * p.R + rt * rb + row % rb;
      if (w == 0 && q4 == 0) {
        p.pm[base] = m[mt][h];
        p.pl[base] = __fmul_rn(__fadd_rn(__fadd_rn(sMax[row], sMax[ROWS + row]),
                                         __fadd_rn(sMax[2 * ROWS + row], sMax[3 * ROWS + row])),
                               (float)(1.0 / 127.0));
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
// (v_scale / 127) + v_mean (null: none); lse (or null) m + log2(max(l,
// 1e-37)).  A block per (sequence, head, NT four-channel groups of its
// rows) of CG * NT threads: each takes 4 channels of a row, its group every
// CG-th share, the groups' sums then added in order.
__global__ void __launch_bounds__(NT * CG) decode_sm90_combine_kernel(
    const Params p, int D, const float* v_scale, long long vs_sb, const float* v_mean,
    long long vm_sb, __nv_bfloat16* out, float* lse) {
  __shared__ float4 s_a[CG][NT];
  __shared__ float s_l[CG][NT];
  const int bh = blockIdx.y;
  const int b = bh / p.Hg, hk = (bh % p.Hg) / (p.Hg / p.Hk);
  const int grp = threadIdx.x / NT, t = threadIdx.x % NT;
  int len, hi, per;
  shares(p, len, hi, per);
  const int n_live = (hi + per - 1) / per;
  const float* pm = p.pm + (long long)bh * p.n_split * p.R;
  const float* pl = p.pl + (long long)bh * p.n_split * p.R;
  const float4* pacc =
      reinterpret_cast<const float4*>(p.pacc + (long long)bh * p.n_split * p.R * D);
  const float4* vs4 = reinterpret_cast<const float4*>(v_scale + b * vs_sb + hk * D);
  const float4* vm4 = v_mean ? reinterpret_cast<const float4*>(v_mean + b * vm_sb + hk * D)
                             : nullptr;
  const float vs_mul = (float)(1.0 / 127.0);
  const int D4 = D / 4, n4 = p.R * D4;
  for (int i0 = blockIdx.x * NT; i0 < n4; i0 += gridDim.x * NT) {
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
        const float wgt = ex2(__fsub_rn(pm[s * p.R + r], mg));
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
      const float4 vs = vs4[c4];
      const float4 vm = vm4 ? vm4[c4] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float o0 = __fmul_rn(__fmul_rn(a.x, inv), __fmul_rn(vs.x, vs_mul));
      const float o1 = __fmul_rn(__fmul_rn(a.y, inv), __fmul_rn(vs.y, vs_mul));
      const float o2 = __fmul_rn(__fmul_rn(a.z, inv), __fmul_rn(vs.z, vs_mul));
      const float o3 = __fmul_rn(__fmul_rn(a.w, inv), __fmul_rn(vs.w, vs_mul));
      const uint2 o = vm4 ? make_uint2(pack_bf16(__fadd_rn(o0, vm.x), __fadd_rn(o1, vm.y)),
                                       pack_bf16(__fadd_rn(o2, vm.z), __fadd_rn(o3, vm.w)))
                          : make_uint2(pack_bf16(o0, o1), pack_bf16(o2, o3));
      reinterpret_cast<uint2*>(out + ((long long)bh * p.R + r) * D)[c4] = o;
      if (lse && c4 == 0)
        lse[(long long)bh * p.R + r] = __fadd_rn(mg, log2f(fmaxf(l, 1e-37f)));
    }
    __syncthreads();
  }
}

}  // namespace d90

// ------------------------------------------------------------------ host --

namespace {

using namespace d90;

template <int D, int MT>
int launch(const void* k, const void* v, const long long* st, int B, const Params& p,
           cudaStream_t stream) {
  using C = Cfg<D, MT>;
  CUtensorMap mk, mv;
  const CUtensorMapSwizzle swz = D == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  if (!make_map_t(&mk, k, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, p.S, p.Hk, B, st[2], st[1],
                  st[0], D, TILE, swz) ||
      !make_map_t(&mv, v, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, p.S, p.Hk, B, st[5], st[4],
                  st[3], D, TILE, swz))
    return -2;
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_sm90_split_kernel<D, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(p.n_split, p.Hg / p.hpb * p.n_rt, B);
  decode_sm90_split_kernel<D, MT><<<grid, NT, C::SMEM, stream>>>(mk, mv, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mt(const void* k, const void* v, const long long* st, int B, const Params& p,
              cudaStream_t s) {
  const int rows = p.n_rt > 1 ? MAX_ROWS : p.hpb * p.R;
  if (rows <= 16) return launch<D, 1>(k, v, st, B, p, s);
  if (rows <= 32) return launch<D, 2>(k, v, st, B, p, s);
  if (rows <= 48) return launch<D, 3>(k, v, st, B, p, s);
  return launch<D, 4>(k, v, st, B, p, s);
}

}  // namespace

extern "C" {

const char* sage_decode_sm90_error_string(int e) {
  if (e == -1)
    return "unsupported B11-int8 configuration (head_dim, rows, heads, strides or pointers)";
  if (e == -2) {
    static char msg[128];
    snprintf(msg, sizeof msg,
             "cuTensorMapEncodeTiled failed (result %d; -1: not found in the driver)",
             g_encode_result);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)e);
}

// B11-int8 on q [B, Hg, R, D] bf16 (q_f32: f32; contiguous, 16-byte aligned),
// the cache k8 and v8 [B, Hk, S, D] int8 with element strides (batch, head,
// token; unit column stride, 16-byte aligned base and strides), ks [B, Hk,
// >= n_units * 64] f32 with element strides (ks_sb, ks_sh) (multiples of 4,
// 16-byte aligned base); kv_true [1] and offsets [2] (or null: no window)
// int32 on the device; hpb query heads a block (hpb R <= 64, Hg / Hk a
// multiple of it; R > 64 only with hpb = 1: 64-row blocks); row_mod the
// window's T when its rows are folded GQA heads (0: none); v_scale [B|1,
// Hk, D] and v_mean (or null) f32 with batch strides vs_sb / vm_sb (0: one
// for all); scratch pm, pl [B*Hg, n_split, R] and pacc [..., D] f32; out
// [B, Hg, R, D] bf16 and lse [B, Hg, R] (or null) f32.
int sage_decode_sm90(int D, int hpb, int q_f32, const void* q, const void* k, const void* v,
                     const float* ks, long long k_sb, long long k_sh, long long k_ss,
                     long long v_sb, long long v_sh, long long v_ss, long long ks_sb,
                     long long ks_sh, const int* kv_true, const int* offsets, int B, int Hg,
                     int Hk, int R, int S, int n_units, int n_split, int row_mod, float fold,
                     const float* v_scale, long long vs_sb, const float* v_mean, long long vm_sb,
                     float* pm, float* pl, float* pacc, void* out, float* lse, void* stream) {
  const long long st[6] = {k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  for (int i = 0; i < 6; ++i)
    if (st[i] < 0 || st[i] % 16) return -1;
  const int n_rt = R > MAX_ROWS ? (R + MAX_ROWS - 1) / MAX_ROWS : 1;
  if ((D != 64 && D != 128) || R < 1 || hpb < 1 || (n_rt > 1 ? hpb != 1 : hpb * R > MAX_ROWS) ||
      Hk < 1 || Hg % Hk || (Hg / Hk) % hpb || S < 1 || n_units != (S + TILE - 1) / TILE ||
      n_split < 1 || B < 1 || !q || !k || !v || !ks || !kv_true || !v_scale || row_mod < 0 ||
      ks_sb % 4 || ks_sh % 4 || reinterpret_cast<uintptr_t>(ks) % 16 ||
      reinterpret_cast<uintptr_t>(q) % 16 || (long long)Hg / hpb * n_rt > 65535)
    return -1;
  Params p{q, ks, ks_sb, ks_sh, kv_true, offsets, q_f32, Hg, Hk, R, hpb, n_rt,
           S, n_units, n_split, row_mod, fold, pm, pl, pacc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = D == 64 ? launch_mt<64>(k, v, st, B, p, s) : launch_mt<128>(k, v, st, B, p, s);
  if (e != 0) return e;
  const dim3 merge_grid((R * D / 4 + NT - 1) / NT, B * Hg);
  decode_sm90_combine_kernel<<<merge_grid, NT * CG, 0, s>>>(
      p, D, v_scale, vs_sb, v_mean, vm_sb, static_cast<__nv_bfloat16*>(out), lse);
  return (int)cudaGetLastError();
}

}  // extern "C"
