// C1 (dK, dV) and C2 (dQ), the bf16 attention backward, redesigned for
// Hopper: TMA loads completing on mbarriers, a ring of stages, wgmma
// products and warpgroups taking turns at the tensor cores.  With no mask
// and no window (bwd_dkv_sm90, bwd_dq_sm90), and, in kernels of their own
// (bwd_dkv_sm90_masked, bwd_dq_sm90_masked), under a causal sliding window
// with or without sinks or a bool keep-mask.
//
// Replaces the Pallas kernels of sageattention_tpu/ops/backward_pallas.py
// in their bf16 form at head dims 64 and 128: `_dkv_kernel` (:85, launched
// at :377) and `_dq_kernel` (:164, launched at :416), with their band
// (`_band` :60, `_band_run` :76, the index maps :297-320) and mask
// (`mask_ref` :132-135, :207-208).  The int8 S-recompute and head dim 256
// run elsewhere (backward_q8_sm90.cu, backward.cu).  What it computes,
// exactly as the plain version (ops/backward.py `attention_backward_plain`)
// at JAX's rounding points:
//   P  = exp2(s * fold - lse2) in f32, fold = sm_scale * log2(e), s the f32
//        sum of bf16 products; a pair outside the kept set (causal: col >
//        row; the band [row - W + 1, row] plus the sink columns < sinks; the
//        mask's zeros) gets P = 0 by a select, never by a product: a
//        left-padded row with no live key has lse2 = -inf or hugely
//        negative, where exp2 overflows;
//   dS = P * (dO V^T - D_i), dO V^T an f32 sum of bf16 products;
//   dV = sum P^T dO with P rounded to bf16, dK = dk_fin * sum dS^T Q and
//   dQ = dq_fin * sum dS K with dS rounded to bf16; f32 accumulators.
// There is no running max and no per-tile rounding, so the plain version
// does not depend on this kernel's tile sizes.  The wrapper pads the
// sequences to 64-row multiples (padded q rows carry lse2 = 3e38: P = 0),
// builds D_i and sums the GQA group's per-head dK/dV in f32.
//
// What bounds it on the H100: the tensor cores, C1 four S^2 D products (S,
// dP, dV, dK) and C2 three (S, dP, dQ), at 989 TFLOP/s in bf16, and, at
// D = 64, nearly as much the exp2 of P on the SFUs (16 per clock per SM).
// dQ by atomics inside C1 (FlashAttention-2/3's way) would save two of the
// seven products, but its f32 sums would change order from run to run;
// JAX's two kernels and this pair are deterministic.  The design:
//   block     NWG warpgroups of 64 rows each and no producer warp: three at
//             D = 64 (192 rows, 384 threads), two at D = 128 (128 rows,
//             256 threads).  C1: a block owns those kv rows of one q head
//             and walks the q tiles; C2: it owns q rows and walks the kv
//             tiles.  ptxas gives a block of more than 256 threads 168
//             registers a thread, and C1's dK and dV alone take 128 at
//             D = 128, so D = 128 keeps two; at D = 64 the third hides more
//             of the exp2 (faster in a trial at CogVideoX1.5, both kernels).
//             Registers C1 168 / 234, C2 141 / 170 at D = 64 / 128, no
//             spill (the smoke prints the report).
//   loads     the block's own rows (K, V in C1; Q, dO in C2) once by TMA;
//             the streamed 64-row tiles (Q, dO, lse2 and D_i in C1; K and
//             V in C2) through a ring of STAGES stages with a full barrier
//             each, refilled by the last of the block's warps done with a
//             stage.  Tensor maps of rank 4 (D, S, H, B), 64-column boxes
//             of 128 bytes, 128-byte swizzled; rows past Skp or Sqp
//             zero-fill.  lse2 and D_i come by a plain bulk copy.
//   C1        per q tile, each warpgroup issues S^T = K Q^T and dP^T = V dO^T
//             (A and B from shared memory, both K-major), forms P^T and
//             dS^T on the accumulator layout (lse2 and D_i per column from
//             shared memory), packs them to bf16 A fragments and issues
//             dV += P^T dO and dK += dS^T Q (A from registers, dO and Q as
//             MN-major B operands: no transpose in shared memory).  Two
//             turns a tile.  Issuing tile i + 1's S^T and dP^T with tile
//             i's dV/dK products, as C2 does, was slower in a trial at D =
//             64 (with two warpgroups, and with three, where it spilled),
//             and at D = 128 the registers do not hold it.
//   C2        S = Q K^T and dP = dO V^T (SS), dS in registers, dQ += dS K
//             (RS, K MN-major); the S and dP of tile j are issued with the
//             dQ product of tile j - 1, and dS(j) is formed under it.
//   overlap   the warpgroups take turns to issue (named barriers), so that
//             one's exp2 and dS run under the other's products.
//   causal    C1: q tiles before the block's first kv row are never loaded
//             and the longest kv blocks launch first (block 0 has the most
//             q tiles); C2: kv tiles past the block's last row are never
//             loaded and the longest q blocks launch first.  Only tiles
//             that cross the diagonal are masked; a warpgroup's tile that
//             lies wholly above it is an exact no-op (P = 0, dS = 0).
//   tails     a zero-filled K or V row past Skp only touches its own dK/dV
//             row in C1, never stored; in C2 it adds nothing to dQ: its dS
//             times a zero K row is 0 (its P may not be 0, but its K is).
//             q rows past Sqp (C2's last warpgroups in the last block)
//             read lse2 as 3e38 and D_i as 0, and are never stored.
//   tiles     STAGES = 4 at D = 64 and 3 at D = 128: 115 / 163 KB (C1) and
//             113 / 161 KB (C2) of shared memory, one block per SM.  Four
//             stages at D = 128 were no faster in a trial, and three
//             warpgroups for C2 there (168 registers a thread) slower.
//   masked    the wrapper's tile lists (ops/backward.py `bwd_tile_lists`,
//             built on the device from the forward's tile classes) give
//             each block the streamed tiles in which some pair of its rows
//             is kept, one list a block so that the warpgroups' turns stay
//             in step, each entry with a class per 64-row slice (dead,
//             full, or partly live: cut by positions alone, or by the mask's
//             bytes), and the blocks launch longest list first (`order`).
//             Every warpgroup runs its products on every tile of the list
//             (a wgmma under a data-dependent branch serializes every wgmma
//             of the kernel, C7518): a dead slice keeps no pair, a full one
//             every pair, and a partly live one builds its keep bits before
//             the tile's products are issued (mask_sm90.cuh: keep_bits for
//             C2's S, keep_bits_t for C1's S^T; both read the mask in
//             place).  The unmasked kernels' registers do not move.
// An exp2 split between the SFUs and the FMA pipes and a persistent grid
// are later work.
#include <stdio.h>

#include "mask_sm90.cuh"
#include "sm90.cuh"

namespace bwd90 {

using namespace sm90;

constexpr float LSE_PAD = 3e38f;   // lse2 of a q row past Sqp: P = 0

// W: 1 for C1, 2 for C2
template <int D, int W>
struct Cfg {
  static constexpr int NWG = D == 64 ? 3 : 2;     // warpgroups, 64 rows each
  static constexpr int THREADS = 128 * NWG;
  static constexpr int BR = 64 * NWG;             // rows a block owns
  static constexpr int BT = 64;                   // rows of a streamed tile
  static constexpr int STAGES = D == 64 ? 4 : 3;
  static constexpr int CH = D / 64;               // 128-byte column boxes per row
  static constexpr int OWN_BYTES = BR * D * 2;    // one of the block's own tensors
  static constexpr int TILE_BYTES = BT * D * 2;   // one streamed tensor of a stage
  static constexpr int VEC_BYTES = W == 1 ? 2 * BT * 4 : 0;   // lse2 and D_i of a q tile (C1)
  static constexpr int SMEM = 2 * OWN_BYTES + STAGES * (2 * TILE_BYTES + VEC_BYTES) + 1024;
};

struct Params {
  const float* lse2;   // [B, Hq, Sqp] base-2 lse (3e38 on padded rows)
  const float* di;     // [B, Hq, Sqp] rowsum(dO * O)
  void* dk;            // [B, Hq, Skp, D] per q head
  void* dv;
  void* dq;            // [B, Hq, Sqp, D]
  int out_f32, Hq, Hk, Sqp, Skp, causal;
  float fold, dk_fin, dq_fin;
};

// Issues acc = A B^T for one warpgroup: D/16 k16 steps, A (64 of the
// block's own rows, in boxes of BR rows) and B (a streamed tile of 64 rows)
// from shared memory, both K-major.
template <int D, int BR>
__device__ __forceinline__ void ss_issue(float (&acc)[32], uint32_t alo, uint32_t blo) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss(acc, desc(alo + (ks >> 2) * (BR * 128 / 16) + (ks & 3) * 2),
             desc(blo + (ks >> 2) * (64 * 128 / 16) + (ks & 3) * 2), ks > 0);
  wg_commit();
}

// Issues acc += A Y: 4 k16 steps over a 64-row tile Y in shared memory,
// MN-major (its boxes 64 rows apart), A from registers.
template <int D>
__device__ __forceinline__ void rs_issue(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                         uint32_t ylo) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, a[kk], desc(ylo + kk * (16 * 128 / 16)), 1);
}

// Accumulator element i of a 64 x 64 tile (thread `lane` of warp w of its
// warpgroup): row 16 w + lane / 4 (+8 for i % 4 >= 2), column 8 (i / 4) +
// 2 (lane % 4) + i % 2.  pack() turns the tile into the bf16 A fragments
// of a product over its columns: k16 step kk takes columns 16 kk .. +15.
__device__ __forceinline__ void pack(const float (&x)[32], uint32_t (&f)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    f[j >> 1][(j & 1) * 2] = pack_bf16(x[4 * j], x[4 * j + 1]);
    f[j >> 1][(j & 1) * 2 + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

template <int D>
__device__ __forceinline__ void store_rows(void* base, int out_f32, long long row0, int r, int rows,
                                           int q4, const float (&acc)[D / 2], float fin) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * q4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row >= rows) continue;
      const long long off = (row0 + row) * D + c;
      const float a = __fmul_rn(acc[4 * j + 2 * h], fin);
      const float b = __fmul_rn(acc[4 * j + 2 * h + 1], fin);
      if (out_f32) *reinterpret_cast<float2*>(static_cast<float*>(base) + off) = make_float2(a, b);
      else *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(base) + off) =
          __floats2bfloat162_rn(a, b);
    }
  }
}

// The turns, in order: named barrier 1 + w is warpgroup w's turn, which
// warpgroup w - 1 hands over after issuing.
__device__ __forceinline__ void take_turn(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
}
template <int NWG>
__device__ __forceinline__ void hand_over(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (cw + 1) % NWG) : "memory");
}

// This warp is done with stage `it % STAGES`: the last of the block's warps
// to say so loads tile it + STAGES into it (`load(it + STAGES)`).
template <int STAGES, int NWG, typename L>
__device__ __forceinline__ void release(int* freed, int it, int n, int lane, L load) {
  __syncwarp();
  if (lane == 0) {
    const int s = it % STAGES;
    __threadfence_block();
    if (atomicAdd(&freed[s], 1) == 4 * NWG - 1) {
      freed[s] = 0;
      __threadfence_block();
      if (it + STAGES < n) load(it + STAGES);
    }
  }
}

// ---------------------------------------------------------------- C1 ----
// Grid (ceil(Skp / BR), Hq, B).
template <int D>
__global__ void __launch_bounds__(Cfg<D, 1>::THREADS, 1)
    bwd_dkv_sm90(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do, const Params p) {
  using C = Cfg<D, 1>;
  constexpr int CH = C::CH, STAGES = C::STAGES, NWG = C::NWG;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];   // K and V, then per stage: the q tile
  __shared__ int freed[STAGES];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sK = (base + 1023u) & ~1023u;
  const uint32_t sV = sK + C::OWN_BYTES;
  const uint32_t sQ = sV + C::OWN_BYTES;                 // stage s at + s * TILE_BYTES
  const uint32_t sdO = sQ + STAGES * C::TILE_BYTES;
  const uint32_t sVec = sdO + STAGES * C::TILE_BYTES;    // stage s: lse2[64], D_i[64]
  const float* vec = reinterpret_cast<const float*>(smem_raw + (sVec - base));
  const uint32_t bar_kv = smem_u32(&bars[0]);
  const uint32_t bar_q = smem_u32(&bars[1]);             // stage s at + 8 * s

  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (p.Hq / p.Hk);
  const int k0 = blockIdx.x * C::BR;
  // causal: q tiles that end before the block's first kv row see none of it
  const int first = p.causal ? k0 / C::BT : 0;
  const int n_it = max(p.Sqp / C::BT - first, 0);
  const long long vrow0 = ((long long)b * p.Hq + hq) * p.Sqp;
  const int tid = threadIdx.x;

  // Q, dO, lse2 and D_i of q tile first + it into stage it % STAGES
  auto load_tile = [&](int it) {
    const int s = it % STAGES, q0 = (first + it) * C::BT;
    const uint32_t bar = bar_q + 8 * s;
    mbar_expect_tx(bar, 2 * C::TILE_BYTES + C::VEC_BYTES);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      tma_load4(sQ + s * C::TILE_BYTES + c * (C::BT * 128), &tm_q, bar, c * 64, q0, hq, b);
      tma_load4(sdO + s * C::TILE_BYTES + c * (C::BT * 128), &tm_do, bar, c * 64, q0, hq, b);
    }
    bulk_load(sVec + s * C::VEC_BYTES, p.lse2 + vrow0 + q0, C::BT * 4, bar);
    bulk_load(sVec + s * C::VEC_BYTES + C::BT * 4, p.di + vrow0 + q0, C::BT * 4, bar);
  };
  if (tid == 0) {
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_q + 8 * s, 1);
      freed[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_it > 0) {
      mbar_expect_tx(bar_kv, 2 * C::OWN_BYTES);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        tma_load4(sK + c * (C::BR * 128), &tm_k, bar_kv, c * 64, k0, hk, b);
        tma_load4(sV + c * (C::BR * 128), &tm_v, bar_kv, c * 64, k0, hk, b);
      }
      for (int it = 0; it < min(n_it, STAGES); ++it) load_tile(it);
    }
  }
  __syncthreads();

  const int cw = tid / 128;   // the warpgroup: 64 kv rows each
  const int lane = tid % 32, q4 = lane & 3;
  const int kw0 = k0 + 64 * cw;
  // this thread's kv rows
  const int rA = kw0 + 16 * ((tid % 128) / 32) + (lane >> 2), rB = rA + 8;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  // P^T and dS^T of q tile first + it in place (st: S^T -> P^T, dpt: dP^T
  // -> dS^T), with lse2 and D_i of its stage
  auto pds_tile = [&](float (&st)[32], float (&dpt)[32], int it) {
    const int q0 = (first + it) * C::BT;
    const float* lse = vec + (it % STAGES) * (2 * C::BT);
    const float* dI = lse + C::BT;
    // the tile crosses the diagonal: some kv row of the warpgroup lies past
    // some q row of the tile
    const bool cut = p.causal && kw0 + 63 > q0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * q4 + (e & 1);
        float pe = ex2(__fmaf_rn(st[4 * j + e], p.fold, -lse[c]));
        if (cut && (e < 2 ? rA : rB) > q0 + c) pe = 0.f;
        st[4 * j + e] = pe;
        dpt[4 * j + e] = __fmul_rn(pe, __fsub_rn(dpt[4 * j + e], dI[c]));
      }
  };
  auto q_at = [&](int it) { return sQ + (it % STAGES) * C::TILE_BYTES; };
  auto do_at = [&](int it) { return sdO + (it % STAGES) * C::TILE_BYTES; };

  if (n_it > 0) {
    if (cw == NWG - 1) hand_over<NWG>(cw);   // warpgroup 0 goes first
    const uint32_t k_lo = desc_lo(sK + cw * (64 * 128), 16);
    const uint32_t v_lo = desc_lo(sV + cw * (64 * 128), 16);
    mbar_wait(bar_kv, 0);
    uint32_t pf[4][4], sf[4][4];   // P^T and dS^T in bf16, the dV/dK products' A
    // two turns a tile: S^T and dP^T, then, after P^T and dS^T, the dV/dK
    // products
    for (int it = 0; it < n_it; ++it) {
      float st[32], dpt[32];
      mbar_wait(bar_q + 8 * (it % STAGES), (it / STAGES) & 1);
      take_turn(cw);
      wg_fence();
      ss_issue<D, C::BR>(st, opaque(k_lo), opaque(desc_lo(q_at(it), 16)));
      ss_issue<D, C::BR>(dpt, opaque(v_lo), opaque(desc_lo(do_at(it), 16)));
      hand_over<NWG>(cw);
      wg_wait<0>();
      reg_fence(st);
      reg_fence(dpt);
      pds_tile(st, dpt, it);
      pack(st, pf);
      pack(dpt, sf);
      reg_fence(dk);
      reg_fence(dv);
      take_turn(cw);
      wg_fence();
      rs_issue<D>(dv, pf, opaque(desc_lo(do_at(it), C::BT * 128)));
      rs_issue<D>(dk, sf, opaque(desc_lo(q_at(it), C::BT * 128)));
      wg_commit();
      if (it < n_it - 1 || cw < NWG - 1) hand_over<NWG>(cw);   // no turn follows the last
      wg_wait<0>();
      reg_fence(dk);
      reg_fence(dv);
      reg_fence_u(pf);
      reg_fence_u(sf);
      release<STAGES, NWG>(freed, it, n_it, lane, load_tile);
    }
  }

  const long long orow = ((long long)b * p.Hq + hq) * p.Skp;
  store_rows<D>(p.dv, p.out_f32, orow, rA, p.Skp, q4, dv, 1.f);
  store_rows<D>(p.dk, p.out_f32, orow, rA, p.Skp, q4, dk, p.dk_fin);
}

// ---------------------------------------------------------------- C2 ----
// Grid (ceil(Sqp / BR), Hq, B).
template <int D>
__global__ void __launch_bounds__(Cfg<D, 2>::THREADS, 1)
    bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do, const Params p) {
  using C = Cfg<D, 2>;
  constexpr int CH = C::CH, STAGES = C::STAGES, NWG = C::NWG;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];   // Q and dO, then per stage: the kv tile
  __shared__ int freed[STAGES];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdO = sQ + C::OWN_BYTES;
  const uint32_t sK = sdO + C::OWN_BYTES;                // stage s at + s * TILE_BYTES
  const uint32_t sV = sK + STAGES * C::TILE_BYTES;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_kv = smem_u32(&bars[1]);            // stage s at + 8 * s

  const int n_qb = (p.Sqp + C::BR - 1) / C::BR;
  // causal: the longest q blocks first, so the tail of the grid is short work
  const int qb = p.causal ? n_qb - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (p.Hq / p.Hk);
  const int q0 = qb * C::BR;
  int n_kt = p.Skp / C::BT;
  if (p.causal) n_kt = min(n_kt, (min(q0 + C::BR, p.Sqp) - 1) / C::BT + 1);
  const int tid = threadIdx.x;

  auto load_tile = [&](int kt) {
    const int s = kt % STAGES;
    const uint32_t bar = bar_kv + 8 * s;
    mbar_expect_tx(bar, 2 * C::TILE_BYTES);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      tma_load4(sK + s * C::TILE_BYTES + c * (C::BT * 128), &tm_k, bar, c * 64, kt * C::BT, hk, b);
      tma_load4(sV + s * C::TILE_BYTES + c * (C::BT * 128), &tm_v, bar, c * 64, kt * C::BT, hk, b);
    }
  };
  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_kv + 8 * s, 1);
      freed[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, 2 * C::OWN_BYTES);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      tma_load4(sQ + c * (C::BR * 128), &tm_q, bar_q, c * 64, q0, hq, b);
      tma_load4(sdO + c * (C::BR * 128), &tm_do, bar_q, c * 64, q0, hq, b);
    }
    for (int kt = 0; kt < min(n_kt, STAGES); ++kt) load_tile(kt);
  }
  __syncthreads();

  const int cw = tid / 128;   // the warpgroup: 64 q rows each
  const int lane = tid % 32, q4 = lane & 3;
  const int rw0 = q0 + 64 * cw;
  // this thread's q rows
  const int rA = rw0 + 16 * ((tid % 128) / 32) + (lane >> 2), rB = rA + 8;
  const long long vrow0 = ((long long)b * p.Hq + hq) * p.Sqp;
  const float lA = rA < p.Sqp ? p.lse2[vrow0 + rA] : LSE_PAD;
  const float lB = rB < p.Sqp ? p.lse2[vrow0 + rB] : LSE_PAD;
  const float dA = rA < p.Sqp ? p.di[vrow0 + rA] : 0.f;
  const float dB = rB < p.Sqp ? p.di[vrow0 + rB] : 0.f;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  uint32_t sf[4][4];   // dS of the tile whose dQ product is next
  const uint32_t q_lo = desc_lo(sQ + cw * (64 * 128), 16);
  const uint32_t do_lo = desc_lo(sdO + cw * (64 * 128), 16);

  // P and dS of kv tile kt in place (sc: S -> P, dp: dP -> dS)
  auto ds_tile = [&](float (&sc)[32], float (&dp)[32], int kt) {
    const int k0 = kt * C::BT;
    const bool cut = p.causal && k0 + 63 > rw0;   // the tile crosses the diagonal
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * q4 + (e & 1);
        float pe = ex2(__fmaf_rn(sc[4 * j + e], p.fold, -(e < 2 ? lA : lB)));
        if (cut && col > (e < 2 ? rA : rB)) pe = 0.f;
        dp[4 * j + e] = __fmul_rn(pe, __fsub_rn(dp[4 * j + e], e < 2 ? dA : dB));
      }
  };
  auto release_kt = [&](int kt) { release<STAGES, NWG>(freed, kt, n_kt, lane, load_tile); };

  mbar_wait(bar_q, 0);
  if (n_kt > 0) {
    if (cw == NWG - 1) hand_over<NWG>(cw);   // warpgroup 0 goes first
    float sc[32], dp[32];
    mbar_wait(bar_kv, 0);
    take_turn(cw);
    wg_fence();
    ss_issue<D, C::BR>(sc, opaque(q_lo), opaque(desc_lo(sK, 16)));
    ss_issue<D, C::BR>(dp, opaque(do_lo), opaque(desc_lo(sV, 16)));
    hand_over<NWG>(cw);
    wg_wait<0>();
    reg_fence(sc);
    reg_fence(dp);
    ds_tile(sc, dp, 0);
    pack(dp, sf);
  }
  // tile kt: its S and dP go out with the dQ product of tile kt - 1, and
  // its dS is formed under that product; dS(kt) is packed only after the
  // product's wait (the product reads its A registers while it runs)
  for (int kt = 1; kt < n_kt; ++kt) {
    const int s = kt % STAGES, ps = (kt - 1) % STAGES;
    float sc[32], dp[32];
    mbar_wait(bar_kv + 8 * s, (kt / STAGES) & 1);
    reg_fence(dq);
    reg_fence_u(sf);
    take_turn(cw);
    wg_fence();
    ss_issue<D, C::BR>(sc, opaque(q_lo), opaque(desc_lo(sK + s * C::TILE_BYTES, 16)));
    ss_issue<D, C::BR>(dp, opaque(do_lo), opaque(desc_lo(sV + s * C::TILE_BYTES, 16)));
    rs_issue<D>(dq, sf, opaque(desc_lo(sK + ps * C::TILE_BYTES, C::BT * 128)));
    wg_commit();
    hand_over<NWG>(cw);
    wg_wait<1>();
    reg_fence(sc);
    reg_fence(dp);
    ds_tile(sc, dp, kt);
    wg_wait<0>();
    reg_fence(dq);
    reg_fence_u(sf);
    reg_fence(dp);
    release_kt(kt - 1);
    pack(dp, sf);
  }
  if (n_kt > 0) {   // the last dQ product
    const int ls = (n_kt - 1) % STAGES;
    reg_fence(dq);
    reg_fence_u(sf);
    take_turn(cw);
    wg_fence();
    rs_issue<D>(dq, sf, opaque(desc_lo(sK + ls * C::TILE_BYTES, C::BT * 128)));
    wg_commit();
    if (cw < NWG - 1) hand_over<NWG>(cw);   // the next warpgroups' last turns follow
    wg_wait<0>();
    reg_fence(dq);
    release_kt(n_kt - 1);
  }

  store_rows<D>(p.dq, p.out_f32, vrow0, rA, p.Sqp, q4, dq, p.dq_fin);
}

// ----------------------------------------------------- masked forms ----

// The masked walks' parameters: the unmasked kernels', the blocks' tile
// lists and the mask (mask_sm90.cuh), and the order in which the blocks
// launch: block x of the grid owns row block order[x].
struct MParams {
  Params p;
  mask90::Masks mk;
  const int* order;
};

// C1 under a causal band (sinks too) or a bool mask: bwd_dkv_sm90 walking
// the block's list of q tiles in place of first .. n_it, each entry with a
// class per 64-row kv slice (warpgroup).  Every warpgroup runs its products
// on every tile of the list; a dead slice keeps no pair and a partly live
// one builds its keep bits (keep_bits_t) before the tile's products are
// issued.  Grid (ceil(Skp / BR), Hq, B).
template <int D>
__global__ void __launch_bounds__(Cfg<D, 1>::THREADS, 1)
    bwd_dkv_sm90_masked(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do, const MParams mp) {
  using C = Cfg<D, 1>;
  constexpr int CH = C::CH, STAGES = C::STAGES, NWG = C::NWG;
  const Params& p = mp.p;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];   // K and V, then per stage: the q tile
  __shared__ int freed[STAGES];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sK = (base + 1023u) & ~1023u;
  const uint32_t sV = sK + C::OWN_BYTES;
  const uint32_t sQ = sV + C::OWN_BYTES;                 // stage s at + s * TILE_BYTES
  const uint32_t sdO = sQ + STAGES * C::TILE_BYTES;
  const uint32_t sVec = sdO + STAGES * C::TILE_BYTES;    // stage s: lse2[64], D_i[64]
  const float* vec = reinterpret_cast<const float*>(smem_raw + (sVec - base));
  const uint32_t bar_kv = smem_u32(&bars[0]);
  const uint32_t bar_q = smem_u32(&bars[1]);             // stage s at + 8 * s

  const int n_kb = (p.Skp + C::BR - 1) / C::BR;
  const int kb = mp.order[blockIdx.x];
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (p.Hq / p.Hk);
  const int k0 = kb * C::BR;
  int n = 0;   // the walk's length
  const int* lst = mask90::block_list(mp.mk, b, hq, p.Hq, n_kb, kb, n);
  const long long vrow0 = ((long long)b * p.Hq + hq) * p.Sqp;
  const int tid = threadIdx.x;

  // Q, dO, lse2 and D_i of the walk's q tile it into stage it % STAGES
  auto load_tile = [&](int it) {
    const int s = it % STAGES, q0 = mask90::tile_of((uint32_t)lst[it]) * C::BT;
    const uint32_t bar = bar_q + 8 * s;
    mbar_expect_tx(bar, 2 * C::TILE_BYTES + C::VEC_BYTES);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      tma_load4(sQ + s * C::TILE_BYTES + c * (C::BT * 128), &tm_q, bar, c * 64, q0, hq, b);
      tma_load4(sdO + s * C::TILE_BYTES + c * (C::BT * 128), &tm_do, bar, c * 64, q0, hq, b);
    }
    bulk_load(sVec + s * C::VEC_BYTES, p.lse2 + vrow0 + q0, C::BT * 4, bar);
    bulk_load(sVec + s * C::VEC_BYTES + C::BT * 4, p.di + vrow0 + q0, C::BT * 4, bar);
  };
  if (tid == 0) {
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_q + 8 * s, 1);
      freed[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n > 0) {
      mbar_expect_tx(bar_kv, 2 * C::OWN_BYTES);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        tma_load4(sK + c * (C::BR * 128), &tm_k, bar_kv, c * 64, k0, hk, b);
        tma_load4(sV + c * (C::BR * 128), &tm_v, bar_kv, c * 64, k0, hk, b);
      }
      for (int it = 0; it < min(n, STAGES); ++it) load_tile(it);
    }
  }
  __syncthreads();

  const int cw = tid / 128;   // the warpgroup: 64 kv rows each
  const int lane = tid % 32, q4 = lane & 3;
  // this thread's kv rows
  const int rA = k0 + 64 * cw + 16 * ((tid % 128) / 32) + (lane >> 2), rB = rA + 8;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  // this slice's keep bits of the walk's q tile in entry e: none where it
  // is dead, all where it is full, else built per element.  Returns whether
  // the tile is cut at all.
  auto classify = [&](uint32_t e, uint32_t& kA, uint32_t& kB) {
    const int cls = mask90::class_of(e, cw);
    kA = kB = cls == 2 ? ~0u : 0u;
    if (cls & 1)
      mask90::keep_bits_t(mp.mk, b, hq, mask90::tile_of(e) * C::BT, p.causal, rA, rB, q4,
                          cls == 1, kA, kB);
    return cls != 2;
  };
  // P^T and dS^T of the walk's tile it in place, with lse2 and D_i of its
  // stage; a pair the keep bits drop gets P = 0 by a select, before dS
  auto pds_tile = [&](float (&st)[32], float (&dpt)[32], int it, bool cut, uint32_t kA,
                      uint32_t kB) {
    const float* lse = vec + (it % STAGES) * (2 * C::BT);
    const float* dI = lse + C::BT;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * q4 + (e & 1);
        float pe = ex2(__fmaf_rn(st[4 * j + e], p.fold, -lse[c]));
        if (cut && !(((e < 2 ? kA : kB) >> (2 * j + (e & 1))) & 1u)) pe = 0.f;
        st[4 * j + e] = pe;
        dpt[4 * j + e] = __fmul_rn(pe, __fsub_rn(dpt[4 * j + e], dI[c]));
      }
  };
  auto q_at = [&](int it) { return sQ + (it % STAGES) * C::TILE_BYTES; };
  auto do_at = [&](int it) { return sdO + (it % STAGES) * C::TILE_BYTES; };

  if (n > 0) {
    if (cw == NWG - 1) hand_over<NWG>(cw);   // warpgroup 0 goes first
    const uint32_t k_lo = desc_lo(sK + cw * (64 * 128), 16);
    const uint32_t v_lo = desc_lo(sV + cw * (64 * 128), 16);
    mbar_wait(bar_kv, 0);
    uint32_t pf[4][4], sf[4][4];   // P^T and dS^T in bf16, the dV/dK products' A
    uint32_t e = (uint32_t)__ldg(lst);   // the walk's entry it, read a tile ahead
    for (int it = 0; it < n; ++it) {
      float st[32], dpt[32];
      uint32_t kA, kB;
      const bool cut = classify(e, kA, kB);
      mbar_wait(bar_q + 8 * (it % STAGES), (it / STAGES) & 1);
      take_turn(cw);
      wg_fence();
      ss_issue<D, C::BR>(st, opaque(k_lo), opaque(desc_lo(q_at(it), 16)));
      ss_issue<D, C::BR>(dpt, opaque(v_lo), opaque(desc_lo(do_at(it), 16)));
      hand_over<NWG>(cw);
      if (it + 1 < n) e = (uint32_t)__ldg(lst + it + 1);
      wg_wait<0>();
      reg_fence(st);
      reg_fence(dpt);
      pds_tile(st, dpt, it, cut, kA, kB);
      pack(st, pf);
      pack(dpt, sf);
      reg_fence(dk);
      reg_fence(dv);
      take_turn(cw);
      wg_fence();
      rs_issue<D>(dv, pf, opaque(desc_lo(do_at(it), C::BT * 128)));
      rs_issue<D>(dk, sf, opaque(desc_lo(q_at(it), C::BT * 128)));
      wg_commit();
      if (it < n - 1 || cw < NWG - 1) hand_over<NWG>(cw);   // no turn follows the last
      wg_wait<0>();
      reg_fence(dk);
      reg_fence(dv);
      reg_fence_u(pf);
      reg_fence_u(sf);
      release<STAGES, NWG>(freed, it, n, lane, load_tile);
    }
  }

  const long long orow = ((long long)b * p.Hq + hq) * p.Skp;
  store_rows<D>(p.dv, p.out_f32, orow, rA, p.Skp, q4, dv, 1.f);
  store_rows<D>(p.dk, p.out_f32, orow, rA, p.Skp, q4, dk, p.dk_fin);
}

// C2 under a causal band (sinks too) or a bool mask: bwd_dq_sm90 walking
// the block's list of kv tiles in place of 0 .. n_kt, each entry with a
// class per 64-row q slice (warpgroup), keep bits from keep_bits<64> as the
// forward's masked kernels build them.  The S and dP of tile i still go out
// with the dQ product of tile i - 1.  Grid (ceil(Sqp / BR), Hq, B).
template <int D>
__global__ void __launch_bounds__(Cfg<D, 2>::THREADS, 1)
    bwd_dq_sm90_masked(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do, const MParams mp) {
  using C = Cfg<D, 2>;
  constexpr int CH = C::CH, STAGES = C::STAGES, NWG = C::NWG;
  const Params& p = mp.p;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];   // Q and dO, then per stage: the kv tile
  __shared__ int freed[STAGES];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdO = sQ + C::OWN_BYTES;
  const uint32_t sK = sdO + C::OWN_BYTES;                // stage s at + s * TILE_BYTES
  const uint32_t sV = sK + STAGES * C::TILE_BYTES;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_kv = smem_u32(&bars[1]);            // stage s at + 8 * s

  const int n_qb = (p.Sqp + C::BR - 1) / C::BR;
  const int qb = mp.order[blockIdx.x];
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (p.Hq / p.Hk);
  const int q0 = qb * C::BR;
  int n = 0;   // the walk's length
  const int* lst = mask90::block_list(mp.mk, b, hq, p.Hq, n_qb, qb, n);
  const int tid = threadIdx.x;

  // K and V of the walk's kv tile i into stage i % STAGES
  auto load_tile = [&](int i) {
    const int s = i % STAGES, kt = mask90::tile_of((uint32_t)lst[i]);
    const uint32_t bar = bar_kv + 8 * s;
    mbar_expect_tx(bar, 2 * C::TILE_BYTES);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      tma_load4(sK + s * C::TILE_BYTES + c * (C::BT * 128), &tm_k, bar, c * 64, kt * C::BT, hk, b);
      tma_load4(sV + s * C::TILE_BYTES + c * (C::BT * 128), &tm_v, bar, c * 64, kt * C::BT, hk, b);
    }
  };
  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_kv + 8 * s, 1);
      freed[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n > 0) {
      mbar_expect_tx(bar_q, 2 * C::OWN_BYTES);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        tma_load4(sQ + c * (C::BR * 128), &tm_q, bar_q, c * 64, q0, hq, b);
        tma_load4(sdO + c * (C::BR * 128), &tm_do, bar_q, c * 64, q0, hq, b);
      }
      for (int i = 0; i < min(n, STAGES); ++i) load_tile(i);
    }
  }
  __syncthreads();

  const int cw = tid / 128;   // the warpgroup: 64 q rows each
  const int lane = tid % 32, q4 = lane & 3;
  // this thread's q rows
  const int rA = q0 + 64 * cw + 16 * ((tid % 128) / 32) + (lane >> 2), rB = rA + 8;
  const long long vrow0 = ((long long)b * p.Hq + hq) * p.Sqp;
  const float lA = rA < p.Sqp ? p.lse2[vrow0 + rA] : LSE_PAD;
  const float lB = rB < p.Sqp ? p.lse2[vrow0 + rB] : LSE_PAD;
  const float dA = rA < p.Sqp ? p.di[vrow0 + rA] : 0.f;
  const float dB = rB < p.Sqp ? p.di[vrow0 + rB] : 0.f;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  uint32_t sf[4][4];   // dS of the tile whose dQ product is next
  const uint32_t q_lo = desc_lo(sQ + cw * (64 * 128), 16);
  const uint32_t do_lo = desc_lo(sdO + cw * (64 * 128), 16);

  // this slice's keep bits of the walk's kv tile in entry e (see C1's)
  auto classify = [&](uint32_t e, uint32_t& kA, uint32_t& kB) {
    const int cls = mask90::class_of(e, cw);
    kA = kB = cls == 2 ? ~0u : 0u;
    if (cls & 1)
      mask90::keep_bits<C::BT>(mp.mk, b, hq, mask90::tile_of(e) * C::BT, p.Skp, p.causal, p.Sqp,
                               rA, rB, q4, cls == 1, kA, kB);
    return cls != 2;
  };
  // P and dS of a tile in place (sc: S -> P, dp: dP -> dS); a pair the keep
  // bits drop gets P = 0 by a select, before dS
  auto ds_tile = [&](float (&sc)[32], float (&dp)[32], bool cut, uint32_t kA, uint32_t kB) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = ex2(__fmaf_rn(sc[4 * j + e], p.fold, -(e < 2 ? lA : lB)));
        if (cut && !(((e < 2 ? kA : kB) >> (2 * j + (e & 1))) & 1u)) pe = 0.f;
        dp[4 * j + e] = __fmul_rn(pe, __fsub_rn(dp[4 * j + e], e < 2 ? dA : dB));
      }
  };
  auto release_kt = [&](int i) { release<STAGES, NWG>(freed, i, n, lane, load_tile); };

  uint32_t e = 0u;   // the walk's entry i, read a tile ahead
  if (n > 0) {
    mbar_wait(bar_q, 0);
    if (cw == NWG - 1) hand_over<NWG>(cw);   // warpgroup 0 goes first
    float sc[32], dp[32];
    uint32_t kA, kB;
    e = (uint32_t)__ldg(lst);
    const bool cut = classify(e, kA, kB);
    mbar_wait(bar_kv, 0);
    take_turn(cw);
    wg_fence();
    ss_issue<D, C::BR>(sc, opaque(q_lo), opaque(desc_lo(sK, 16)));
    ss_issue<D, C::BR>(dp, opaque(do_lo), opaque(desc_lo(sV, 16)));
    hand_over<NWG>(cw);
    if (n > 1) e = (uint32_t)__ldg(lst + 1);
    wg_wait<0>();
    reg_fence(sc);
    reg_fence(dp);
    ds_tile(sc, dp, cut, kA, kB);
    pack(dp, sf);
  }
  // tile i: its S and dP go out with the dQ product of tile i - 1, and its
  // dS is formed under that product
  for (int i = 1; i < n; ++i) {
    const int s = i % STAGES, ps = (i - 1) % STAGES;
    float sc[32], dp[32];
    uint32_t kA, kB;
    const bool cut = classify(e, kA, kB);
    mbar_wait(bar_kv + 8 * s, (i / STAGES) & 1);
    reg_fence(dq);
    reg_fence_u(sf);
    take_turn(cw);
    wg_fence();
    ss_issue<D, C::BR>(sc, opaque(q_lo), opaque(desc_lo(sK + s * C::TILE_BYTES, 16)));
    ss_issue<D, C::BR>(dp, opaque(do_lo), opaque(desc_lo(sV + s * C::TILE_BYTES, 16)));
    rs_issue<D>(dq, sf, opaque(desc_lo(sK + ps * C::TILE_BYTES, C::BT * 128)));
    wg_commit();
    hand_over<NWG>(cw);
    if (i + 1 < n) e = (uint32_t)__ldg(lst + i + 1);
    wg_wait<1>();
    reg_fence(sc);
    reg_fence(dp);
    ds_tile(sc, dp, cut, kA, kB);
    wg_wait<0>();
    reg_fence(dq);
    reg_fence_u(sf);
    reg_fence(dp);
    release_kt(i - 1);
    pack(dp, sf);
  }
  if (n > 0) {   // the last dQ product
    const int ls = (n - 1) % STAGES;
    reg_fence(dq);
    reg_fence_u(sf);
    take_turn(cw);
    wg_fence();
    rs_issue<D>(dq, sf, opaque(desc_lo(sK + ls * C::TILE_BYTES, C::BT * 128)));
    wg_commit();
    if (cw < NWG - 1) hand_over<NWG>(cw);   // the next warpgroups' last turns follow
    wg_wait<0>();
    reg_fence(dq);
    release_kt(n - 1);
  }

  store_rows<D>(p.dq, p.out_f32, vrow0, rA, p.Sqp, q4, dq, p.dq_fin);
}

}  // namespace bwd90

// ------------------------------------------------------------------ host --

namespace {

using namespace bwd90;

// The tensor maps of q, k, v and dO for kernel W (1: C1, 2: C2): the
// block's own rows load in boxes of BR rows, the streamed tiles in BT.
template <int D, int W>
bool make_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v, const void* dO,
               const Params& p, int B) {
  using C = Cfg<D, W>;
  const int q_rows = W == 1 ? C::BT : C::BR, kv_rows = W == 1 ? C::BR : C::BT;
  const long long qh = (long long)p.Sqp * D, kh = (long long)p.Skp * D;
  return make_map(&m[0], q, D, p.Sqp, p.Hq, B, D, qh, p.Hq * qh, q_rows) &&
         make_map(&m[1], k, D, p.Skp, p.Hk, B, D, kh, p.Hk * kh, kv_rows) &&
         make_map(&m[2], v, D, p.Skp, p.Hk, B, D, kh, p.Hk * kh, kv_rows) &&
         make_map(&m[3], dO, D, p.Sqp, p.Hq, B, D, qh, p.Hq * qh, q_rows);
}

template <int D, int W>
int launch(const void* q, const void* k, const void* v, const void* dO, const Params& p, int B,
           cudaStream_t stream) {
  using C = Cfg<D, W>;
  CUtensorMap m[4];
  if (!make_maps<D, W>(m, q, k, v, dO, p, B)) return -2;
  const auto kernel = W == 1 ? bwd_dkv_sm90<D> : bwd_dq_sm90<D>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(((W == 1 ? p.Skp : p.Sqp) + C::BR - 1) / C::BR, p.Hq, B);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(m[0], m[1], m[2], m[3], p);
  return (int)cudaGetLastError();
}

template <int D, int W>
int launch_masked(const void* q, const void* k, const void* v, const void* dO,
                  const MParams& mp, int B, cudaStream_t stream) {
  using C = Cfg<D, W>;
  CUtensorMap m[4];
  if (!make_maps<D, W>(m, q, k, v, dO, mp.p, B)) return -2;
  const auto kernel = W == 1 ? bwd_dkv_sm90_masked<D> : bwd_dq_sm90_masked<D>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(((W == 1 ? mp.p.Skp : mp.p.Sqp) + C::BR - 1) / C::BR, mp.p.Hq, B);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(m[0], m[1], m[2], m[3], mp);
  return (int)cudaGetLastError();
}

bool aligned16(const void* x) { return (reinterpret_cast<uintptr_t>(x) & 15) == 0; }

// The checks both entries share.
bool valid(int which, int D, const void* const (&in)[6], int B, int Hq, int Hk, int Sqp,
           int Skp) {
  if ((which != 1 && which != 2) || (D != 64 && D != 128) || B < 1 || Hk < 1 || Hq % Hk ||
      Sqp < 64 || Skp < 64 || Sqp % 64 || Skp % 64)
    return false;
  for (const void* x : in)
    if (!aligned16(x)) return false;
  return true;
}

}  // namespace

extern "C" {

const char* sage_bwd_sm90_error_string(int e) {
  if (e == -1) return "unsupported sm90 backward configuration (kernel, head_dim, lengths, "
                      "GQA, alignment, tile lists or window)";
  if (e == -2) {
    static char msg[128];
    snprintf(msg, sizeof msg,
             "cuTensorMapEncodeTiled failed (result %d; -1: not found in the driver)",
             g_encode_result);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)e);
}

// which: 1 = C1 (dk, dv), 2 = C2 (dq).  q, dO [B, Hq, Sqp, D] and k, v
// [B, Hk, Skp, D] bf16, lse2 and di [B, Hq, Sqp] f32, all contiguous with
// 16-byte aligned bases; Sqp and Skp multiples of 64 (at least 64); D 64 or
// 128.  Outputs per q head, bf16 (out_f32 0) or f32.
int sage_bwd_sm90(int which, int D, const void* q, const void* k, const void* v, const void* dO,
                  const float* lse2, const float* di, void* dk, void* dv, void* dq, int out_f32,
                  int B, int Hq, int Hk, int Sqp, int Skp, int causal, float fold, float dk_fin,
                  float dq_fin, void* stream) {
  if (!valid(which, D, {q, k, v, dO, lse2, di}, B, Hq, Hk, Sqp, Skp)) return -1;
  Params p{lse2, di, dk, dv, dq, out_f32, Hq, Hk, Sqp, Skp, causal, fold, dk_fin, dq_fin};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return which == 1 ? launch<64, 1>(q, k, v, dO, p, B, s)
                                  : launch<64, 2>(q, k, v, dO, p, B, s);
  return which == 1 ? launch<128, 1>(q, k, v, dO, p, B, s) : launch<128, 2>(q, k, v, dO, p, B, s);
}

// The masked forms: sage_bwd_sm90's arguments, then the kernel's walks
// (ops/backward.py `bwd_tile_lists`): `tiles` [LB, LH, n_blocks, nkt] int32
// and `ntiles` [LB, LH, n_blocks] (C1: q tiles of each block of kv rows,
// with a class per kv slice; C2: kv tiles of each block of q rows), `lb` /
// `lh` 1 where they step over batch / q head, `order` [n_blocks] the row
// blocks by launch; the bool keep-mask [B, Hm, Sqp, Skp] as int8 with its
// element strides (unit column stride) and `mh` 1 where it steps over q
// heads, or null; the causal band's `window` and `sinks` (window 0: none).
int sage_bwd_sm90_masked(int which, int D, const void* q, const void* k, const void* v,
                         const void* dO, const float* lse2, const float* di, void* dk, void* dv,
                         void* dq, int out_f32, int B, int Hq, int Hk, int Sqp, int Skp,
                         int causal, float fold, float dk_fin, float dq_fin, const int* tiles,
                         const int* ntiles, int nkt, int lb, int lh, const int* order,
                         const void* mask, long long m_sb, long long m_sh, long long m_ss, int mh,
                         int window, int sinks, void* stream) {
  if (!valid(which, D, {q, k, v, dO, lse2, di}, B, Hq, Hk, Sqp, Skp) || !tiles || !ntiles ||
      !order || nkt != (which == 1 ? Sqp : Skp) / 64 || window < 0 || sinks < 0 ||
      (window && !causal) || (sinks && !window))
    return -1;
  const MParams mp{{lse2, di, dk, dv, dq, out_f32, Hq, Hk, Sqp, Skp, causal, fold, dk_fin, dq_fin},
                   {tiles, ntiles, nkt, lb, lh, static_cast<const int8_t*>(mask), m_sb, m_sh,
                    m_ss, mh, nullptr, nullptr, nullptr, window, sinks, Skp},
                   order};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return which == 1 ? launch_masked<64, 1>(q, k, v, dO, mp, B, s)
                                  : launch_masked<64, 2>(q, k, v, dO, mp, B, s);
  return which == 1 ? launch_masked<128, 1>(q, k, v, dO, mp, B, s)
                    : launch_masked<128, 2>(q, k, v, dO, mp, B, s);
}

}  // extern "C"
