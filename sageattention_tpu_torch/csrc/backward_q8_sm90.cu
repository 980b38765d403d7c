// C1 (dK, dV) and C2 (dQ) in their int8 S-recompute form, with no mask and
// no window, redesigned for Hopper: TMA loads completing on mbarriers (the
// int8 codes included), a ring of stages, int8 wgmma for the scores, bf16
// wgmma for the other products and warpgroups taking turns at the tensor
// cores.
//
// Replaces the Pallas kernels of sageattention_tpu/ops/backward_pallas.py
// in their `quantized=True` form with no mask and no window, causal or not,
// at head dims 64 and 128: `_dkv_kernel` (:85, launched at :377) and
// `_dq_kernel` (:164, launched at :416).  The window, the bool mask and head
// dim 256 stay on backward.cu.  What it computes, exactly as the plain
// version (ops/backward.py `attention_backward_plain` with `qs`/`ks`) at
// JAX's rounding points (backward_pallas.py:119-124, :145-149, :196-217):
//   s  = (f32(s32) * qs[q row]) * ks[kv row], two rounded products, s32 the
//        int8 product of the per-row codes (the q codes carry sm_scale *
//        log2(e); f32(s32) is exact, |s32| <= 127^2 * 128 < 2^24);
//   P  = exp2(s - lse2) in f32; under causal a pair with col > row gets
//        P = 0 by a select, never by a product;
//   dS = P * (dO V^T - D_i), dO V^T an f32 sum of bf16 products;
//   dV = sum P^T dO with P rounded to bf16, dK = dk_fin * sum dS^T Qd and
//   dQ = dq_fin * sum dS Kd with dS rounded to bf16, Qd and Kd the codes
//   dequantized to bf16, bf16(f32(code) * row scale); f32 accumulators.
// The wrapper quantizes q and k, makes the dequantized copies (one
// elementwise pass each, the plain version's own rounding), pads the
// sequences to 64-row multiples (padded q rows carry lse2 = 3e38: P = 0),
// builds D_i and sums the GQA group's per-head dK/dV in f32.
//
// What bounds it on the H100: the tensor cores, the S product at the int8
// rate (1979 TOP/s) and the others (C1: dP, dV, dK; C2: dP, dQ) at the bf16
// rate (989 TFLOP/s), and, at D = 64, as much the exp2 of P on the SFUs.
// The design is backward_sm90.cu's (the bf16 form): its blocks, turns,
// causal order, tails and stages, with these changes:
//   S         int8 wgmma m64n64k32 on K-major codes (C1: S^T = K8 Q8^T, C2:
//             S = Q8 K8^T): the codes are rows along D, the only layout
//             8-bit wgmma takes, so nothing is transposed.  They come by
//             TMA in one box of D bytes a row, swizzled as the descriptor
//             reads them (128-byte at D = 128, 64-byte at D = 64).
//   own rows  the block's own codes (K in C1, Q in C2) are loaded once and
//             serve only the S product, so they need no bf16 copy; the
//             other own tensor (V in C1, dO in C2) as in the bf16 form.
//   stages    the streamed tile is used twice: its codes for S and its
//             dequantized bf16 rows (Qd in C1, Kd in C2) as the MN-major B
//             operand of the dK or dQ product; both ride in the stage with
//             dO (C1) or V (C2).  The row scales of the tile (qs in C1, ks in
//             C2) come by a plain bulk copy, with lse2 and D_i in C1; each
//             thread reads the scales of its own two rows from global memory.
//   block     three warpgroups at D = 64 (192 rows), two at D = 128 (128
//             rows), no producer warp; 4 / 3 stages.  Shared memory: C1
//             120 / 171 KB, C2 118 / 170 KB at D = 64 / 128 (dynamic, with the
//             1 KB of alignment slack).
#include <stdio.h>

#include "sm90.cuh"

namespace bwdq8 {

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
  static constexpr int CH = D / 64;               // 128-byte bf16 column boxes per row
  static constexpr int OWN8 = BR * D;             // the block's own int8 codes
  static constexpr int OWN16 = BR * D * 2;        // the block's own bf16 tensor
  static constexpr int CODES = BT * D;            // a stage's int8 codes
  static constexpr int TILE = BT * D * 2;         // one bf16 tensor of a stage
  // C1: lse2, D_i and the q scales of a q tile; C2: the k scales of a kv tile
  static constexpr int VEC = (W == 1 ? 3 : 1) * BT * 4;
  static constexpr int SMEM = OWN8 + OWN16 + STAGES * (CODES + 2 * TILE + VEC) + 1024;
};

struct Params {
  const float* lse2;   // [B, Hq, Sqp] base-2 lse (3e38 on padded rows)
  const float* di;     // [B, Hq, Sqp] rowsum(dO * O)
  const float* qs;     // [B, Hq, Sqp] q row scales
  const float* ks;     // [B, Hk, Skp] k row scales
  void* dk;            // [B, Hq, Skp, D] per q head
  void* dv;
  void* dq;            // [B, Hq, Sqp, D]
  int out_f32, Hq, Hk, Sqp, Skp, causal;
  float dk_fin, dq_fin;
};

// The descriptor of a K-major int8 operand: rows of D bytes, swizzled as the
// tensor map loads them.
template <int D>
__device__ __forceinline__ uint64_t cdesc(uint32_t lo) {
  if constexpr (D == 128) return desc(lo);
  return desc64(lo);
}

// Issues acc = A8 B8^T for one warpgroup: D/32 k32 steps of 32 bytes along
// the rows, A (64 of the block's own rows) and B (a streamed tile) int8
// codes in shared memory.
template <int D>
__device__ __forceinline__ void s8_issue(int (&acc)[32], uint32_t alo, uint32_t blo) {
#pragma unroll
  for (int ks = 0; ks < D / 32; ++ks) wgmma_s8(acc, cdesc<D>(alo + ks * 2), cdesc<D>(blo + ks * 2), ks > 0);
  wg_commit();
}

// Issues acc = A B^T for one warpgroup: D/16 k16 steps, A (64 of the
// block's own bf16 rows, in boxes of BR rows) and B (a streamed bf16 tile of
// 64 rows) from shared memory, both K-major.
template <int D, int BR>
__device__ __forceinline__ void ss_issue(float (&acc)[32], uint32_t alo, uint32_t blo) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss(acc, desc(alo + (ks >> 2) * (BR * 128 / 16) + (ks & 3) * 2),
             desc(blo + (ks >> 2) * (64 * 128 / 16) + (ks & 3) * 2), ks > 0);
  wg_commit();
}

// Issues acc += A Y: 4 k16 steps over a 64-row bf16 tile Y in shared
// memory, MN-major (its boxes 64 rows apart), A from registers.
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
// Grid (ceil(Skp / BR), Hq, B).  tm_deq: the dequantized q rows (Qd).
template <int D>
__global__ void __launch_bounds__(Cfg<D, 1>::THREADS, 1)
    bwd_q8_dkv_sm90(const __grid_constant__ CUtensorMap tm_q8,
                    const __grid_constant__ CUtensorMap tm_k8,
                    const __grid_constant__ CUtensorMap tm_deq,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const Params p) {
  using C = Cfg<D, 1>;
  constexpr int CH = C::CH, STAGES = C::STAGES, NWG = C::NWG, BT = C::BT;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];   // K codes and V, then per stage: the q tile
  __shared__ int freed[STAGES];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sK8 = (base + 1023u) & ~1023u;
  const uint32_t sV = sK8 + C::OWN8;
  const uint32_t sQ8 = sV + C::OWN16;                    // stage s at + s * CODES
  const uint32_t sQd = sQ8 + STAGES * C::CODES;          // stage s at + s * TILE
  const uint32_t sdO = sQd + STAGES * C::TILE;
  const uint32_t sVec = sdO + STAGES * C::TILE;          // stage s: lse2[64], D_i[64], qs[64]
  const float* vec = reinterpret_cast<const float*>(smem_raw + (sVec - base));
  const uint32_t bar_kv = smem_u32(&bars[0]);
  const uint32_t bar_q = smem_u32(&bars[1]);             // stage s at + 8 * s

  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (p.Hq / p.Hk);
  const int k0 = blockIdx.x * C::BR;
  // causal: q tiles that end before the block's first kv row see none of it
  const int first = p.causal ? k0 / BT : 0;
  const int n_it = max(p.Sqp / BT - first, 0);
  const long long vrow0 = ((long long)b * p.Hq + hq) * p.Sqp;
  const int tid = threadIdx.x;

  // the q codes, Qd, dO, lse2, D_i and qs of q tile first + it into stage
  // it % STAGES
  auto load_tile = [&](int it) {
    const int s = it % STAGES, q0 = (first + it) * BT;
    const uint32_t bar = bar_q + 8 * s;
    mbar_expect_tx(bar, C::CODES + 2 * C::TILE + C::VEC);
    tma_load4(sQ8 + s * C::CODES, &tm_q8, bar, 0, q0, hq, b);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      tma_load4(sQd + s * C::TILE + c * (BT * 128), &tm_deq, bar, c * 64, q0, hq, b);
      tma_load4(sdO + s * C::TILE + c * (BT * 128), &tm_do, bar, c * 64, q0, hq, b);
    }
    const uint32_t v0 = sVec + s * C::VEC;
    bulk_load(v0, p.lse2 + vrow0 + q0, BT * 4, bar);
    bulk_load(v0 + BT * 4, p.di + vrow0 + q0, BT * 4, bar);
    bulk_load(v0 + 2 * BT * 4, p.qs + vrow0 + q0, BT * 4, bar);
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
      mbar_expect_tx(bar_kv, C::OWN8 + C::OWN16);
      tma_load4(sK8, &tm_k8, bar_kv, 0, k0, hk, b);
#pragma unroll
      for (int c = 0; c < CH; ++c) tma_load4(sV + c * (C::BR * 128), &tm_v, bar_kv, c * 64, k0, hk, b);
      for (int it = 0; it < min(n_it, STAGES); ++it) load_tile(it);
    }
  }
  __syncthreads();

  const int cw = tid / 128;   // the warpgroup: 64 kv rows each
  const int lane = tid % 32, q4 = lane & 3;
  const int kw0 = k0 + 64 * cw;
  // this thread's kv rows and their k scales (rows past Skp are zero-filled
  // codes, never stored)
  const int rA = kw0 + 16 * ((tid % 128) / 32) + (lane >> 2), rB = rA + 8;
  const float* ksr = p.ks + ((long long)b * p.Hk + hk) * p.Skp;
  const float kA = rA < p.Skp ? ksr[rA] : 0.f, kB = rB < p.Skp ? ksr[rB] : 0.f;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  // P^T and dS^T of q tile first + it (si: S^T's int8 sums -> pt: P^T;
  // dpt: dP^T -> dS^T in place), with lse2, D_i and qs of its stage
  auto pds_tile = [&](const int (&si)[32], float (&pt)[32], float (&dpt)[32], int it) {
    const int q0 = (first + it) * BT;
    const float* lse = vec + (it % STAGES) * (3 * BT);
    const float* dI = lse + BT;
    const float* qsc = lse + 2 * BT;
    // the tile crosses the diagonal: some kv row of the warpgroup lies past
    // some q row of the tile
    const bool cut = p.causal && kw0 + 63 > q0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * q4 + (e & 1);
        const float s = __fmul_rn(__fmul_rn((float)si[4 * j + e], qsc[c]), e < 2 ? kA : kB);
        float pe = ex2(__fsub_rn(s, lse[c]));
        if (cut && (e < 2 ? rA : rB) > q0 + c) pe = 0.f;
        pt[4 * j + e] = pe;
        dpt[4 * j + e] = __fmul_rn(pe, __fsub_rn(dpt[4 * j + e], dI[c]));
      }
  };
  auto q8_at = [&](int it) { return sQ8 + (it % STAGES) * C::CODES; };
  auto qd_at = [&](int it) { return sQd + (it % STAGES) * C::TILE; };
  auto do_at = [&](int it) { return sdO + (it % STAGES) * C::TILE; };

  if (n_it > 0) {
    if (cw == NWG - 1) hand_over<NWG>(cw);   // warpgroup 0 goes first
    const uint32_t k_lo = desc_lo(sK8 + cw * (64 * D), 16);
    const uint32_t v_lo = desc_lo(sV + cw * (64 * 128), 16);
    mbar_wait(bar_kv, 0);
    uint32_t pf[4][4], sf[4][4];   // P^T and dS^T in bf16, the dV/dK products' A
    // two turns a tile: S^T and dP^T, then, after P^T and dS^T, the dV/dK
    // products
    for (int it = 0; it < n_it; ++it) {
      int si[32];
      float pt[32], dpt[32];
      mbar_wait(bar_q + 8 * (it % STAGES), (it / STAGES) & 1);
      take_turn(cw);
      wg_fence();
      s8_issue<D>(si, opaque(k_lo), opaque(desc_lo(q8_at(it), 16)));
      ss_issue<D, C::BR>(dpt, opaque(v_lo), opaque(desc_lo(do_at(it), 16)));
      hand_over<NWG>(cw);
      wg_wait<0>();
      reg_fence(si);
      reg_fence(dpt);
      pds_tile(si, pt, dpt, it);
      pack(pt, pf);
      pack(dpt, sf);
      reg_fence(dk);
      reg_fence(dv);
      take_turn(cw);
      wg_fence();
      rs_issue<D>(dv, pf, opaque(desc_lo(do_at(it), BT * 128)));
      rs_issue<D>(dk, sf, opaque(desc_lo(qd_at(it), BT * 128)));
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
// Grid (ceil(Sqp / BR), Hq, B).  tm_deq: the dequantized k rows (Kd).
template <int D>
__global__ void __launch_bounds__(Cfg<D, 2>::THREADS, 1)
    bwd_q8_dq_sm90(const __grid_constant__ CUtensorMap tm_q8,
                   const __grid_constant__ CUtensorMap tm_k8,
                   const __grid_constant__ CUtensorMap tm_deq,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do, const Params p) {
  using C = Cfg<D, 2>;
  constexpr int CH = C::CH, STAGES = C::STAGES, NWG = C::NWG, BT = C::BT;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];   // Q codes and dO, then per stage: the kv tile
  __shared__ int freed[STAGES];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sQ8 = (base + 1023u) & ~1023u;
  const uint32_t sdO = sQ8 + C::OWN8;
  const uint32_t sK8 = sdO + C::OWN16;                   // stage s at + s * CODES
  const uint32_t sKd = sK8 + STAGES * C::CODES;          // stage s at + s * TILE
  const uint32_t sV = sKd + STAGES * C::TILE;
  const uint32_t sVec = sV + STAGES * C::TILE;           // stage s: ks[64]
  const float* vec = reinterpret_cast<const float*>(smem_raw + (sVec - base));
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_kv = smem_u32(&bars[1]);            // stage s at + 8 * s

  const int n_qb = (p.Sqp + C::BR - 1) / C::BR;
  // causal: the longest q blocks first, so the tail of the grid is short work
  const int qb = p.causal ? n_qb - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (p.Hq / p.Hk);
  const int q0 = qb * C::BR;
  int n_kt = p.Skp / BT;
  if (p.causal) n_kt = min(n_kt, (min(q0 + C::BR, p.Sqp) - 1) / BT + 1);
  const long long krow0 = ((long long)b * p.Hk + hk) * p.Skp;
  const int tid = threadIdx.x;

  // the k codes, Kd, V and ks of kv tile kt into stage kt % STAGES
  auto load_tile = [&](int kt) {
    const int s = kt % STAGES;
    const uint32_t bar = bar_kv + 8 * s;
    mbar_expect_tx(bar, C::CODES + 2 * C::TILE + C::VEC);
    tma_load4(sK8 + s * C::CODES, &tm_k8, bar, 0, kt * BT, hk, b);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      tma_load4(sKd + s * C::TILE + c * (BT * 128), &tm_deq, bar, c * 64, kt * BT, hk, b);
      tma_load4(sV + s * C::TILE + c * (BT * 128), &tm_v, bar, c * 64, kt * BT, hk, b);
    }
    bulk_load(sVec + s * C::VEC, p.ks + krow0 + kt * BT, BT * 4, bar);
  };
  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_kv + 8 * s, 1);
      freed[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, C::OWN8 + C::OWN16);
    tma_load4(sQ8, &tm_q8, bar_q, 0, q0, hq, b);
#pragma unroll
    for (int c = 0; c < CH; ++c) tma_load4(sdO + c * (C::BR * 128), &tm_do, bar_q, c * 64, q0, hq, b);
    for (int kt = 0; kt < min(n_kt, STAGES); ++kt) load_tile(kt);
  }
  __syncthreads();

  const int cw = tid / 128;   // the warpgroup: 64 q rows each
  const int lane = tid % 32, q4 = lane & 3;
  const int rw0 = q0 + 64 * cw;
  // this thread's q rows: their lse2, D_i and q scales (rows past Sqp have
  // zero-filled codes, P = 0, and are never stored)
  const int rA = rw0 + 16 * ((tid % 128) / 32) + (lane >> 2), rB = rA + 8;
  const long long vrow0 = ((long long)b * p.Hq + hq) * p.Sqp;
  const float lA = rA < p.Sqp ? p.lse2[vrow0 + rA] : LSE_PAD;
  const float lB = rB < p.Sqp ? p.lse2[vrow0 + rB] : LSE_PAD;
  const float dA = rA < p.Sqp ? p.di[vrow0 + rA] : 0.f;
  const float dB = rB < p.Sqp ? p.di[vrow0 + rB] : 0.f;
  const float qA = rA < p.Sqp ? p.qs[vrow0 + rA] : 0.f;
  const float qB = rB < p.Sqp ? p.qs[vrow0 + rB] : 0.f;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  uint32_t sf[4][4];   // dS of the tile whose dQ product is next
  const uint32_t q_lo = desc_lo(sQ8 + cw * (64 * D), 16);
  const uint32_t do_lo = desc_lo(sdO + cw * (64 * 128), 16);

  // dS of kv tile kt (si: S's int8 sums; dp: dP -> dS in place), with the
  // k scales of its stage
  auto ds_tile = [&](const int (&si)[32], float (&dp)[32], int kt) {
    const int k0 = kt * BT;
    const float* ksc = vec + (kt % STAGES) * BT;
    const bool cut = p.causal && k0 + 63 > rw0;   // the tile crosses the diagonal
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * q4 + (e & 1);
        const float s = __fmul_rn(__fmul_rn((float)si[4 * j + e], e < 2 ? qA : qB), ksc[c]);
        float pe = ex2(__fsub_rn(s, e < 2 ? lA : lB));
        if (cut && k0 + c > (e < 2 ? rA : rB)) pe = 0.f;
        dp[4 * j + e] = __fmul_rn(pe, __fsub_rn(dp[4 * j + e], e < 2 ? dA : dB));
      }
  };
  auto release_kt = [&](int kt) { release<STAGES, NWG>(freed, kt, n_kt, lane, load_tile); };
  auto k8_at = [&](int kt) { return sK8 + (kt % STAGES) * C::CODES; };
  auto kd_at = [&](int kt) { return sKd + (kt % STAGES) * C::TILE; };
  auto v_at = [&](int kt) { return sV + (kt % STAGES) * C::TILE; };

  mbar_wait(bar_q, 0);
  if (n_kt > 0) {
    if (cw == NWG - 1) hand_over<NWG>(cw);   // warpgroup 0 goes first
    int si[32];
    float dp[32];
    mbar_wait(bar_kv, 0);
    take_turn(cw);
    wg_fence();
    s8_issue<D>(si, opaque(q_lo), opaque(desc_lo(k8_at(0), 16)));
    ss_issue<D, C::BR>(dp, opaque(do_lo), opaque(desc_lo(v_at(0), 16)));
    hand_over<NWG>(cw);
    wg_wait<0>();
    reg_fence(si);
    reg_fence(dp);
    ds_tile(si, dp, 0);
    pack(dp, sf);
  }
  // tile kt: its S and dP go out with the dQ product of tile kt - 1, and
  // its dS is formed under that product; dS(kt) is packed only after the
  // product's wait (the product reads its A registers while it runs)
  for (int kt = 1; kt < n_kt; ++kt) {
    int si[32];
    float dp[32];
    mbar_wait(bar_kv + 8 * (kt % STAGES), (kt / STAGES) & 1);
    reg_fence(dq);
    reg_fence_u(sf);
    take_turn(cw);
    wg_fence();
    s8_issue<D>(si, opaque(q_lo), opaque(desc_lo(k8_at(kt), 16)));
    ss_issue<D, C::BR>(dp, opaque(do_lo), opaque(desc_lo(v_at(kt), 16)));
    rs_issue<D>(dq, sf, opaque(desc_lo(kd_at(kt - 1), BT * 128)));
    wg_commit();
    hand_over<NWG>(cw);
    wg_wait<1>();
    reg_fence(si);
    reg_fence(dp);
    ds_tile(si, dp, kt);
    wg_wait<0>();
    reg_fence(dq);
    reg_fence_u(sf);
    reg_fence(dp);
    release_kt(kt - 1);
    pack(dp, sf);
  }
  if (n_kt > 0) {   // the last dQ product
    reg_fence(dq);
    reg_fence_u(sf);
    take_turn(cw);
    wg_fence();
    rs_issue<D>(dq, sf, opaque(desc_lo(kd_at(n_kt - 1), BT * 128)));
    wg_commit();
    if (cw < NWG - 1) hand_over<NWG>(cw);   // the next warpgroups' last turns follow
    wg_wait<0>();
    reg_fence(dq);
    release_kt(n_kt - 1);
  }

  store_rows<D>(p.dq, p.out_f32, vrow0, rA, p.Sqp, q4, dq, p.dq_fin);
}

}  // namespace bwdq8

// ------------------------------------------------------------------ host --

namespace {

using namespace bwdq8;

// deq: Qd (C1) or Kd (C2)
template <int D, int W>
int launch(const void* q8, const void* k8, const void* deq, const void* v, const void* dO,
           const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<D, W>;
  // the block's own rows load in boxes of BR rows, the streamed tiles in BT
  const int q_rows = W == 1 ? C::BT : C::BR, kv_rows = W == 1 ? C::BR : C::BT;
  const long long qh = (long long)p.Sqp * D, kh = (long long)p.Skp * D;
  const CUtensorMapSwizzle swz = D == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap mq8, mk8, mdeq, mv, mdo;
  const bool deq_ok = W == 1 ? make_map(&mdeq, deq, D, p.Sqp, p.Hq, B, D, qh, p.Hq * qh, q_rows)
                             : make_map(&mdeq, deq, D, p.Skp, p.Hk, B, D, kh, p.Hk * kh, kv_rows);
  if (!deq_ok ||
      !make_map_t(&mq8, q8, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, p.Sqp, p.Hq, B, D, qh, p.Hq * qh,
                  D, q_rows, swz) ||
      !make_map_t(&mk8, k8, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, p.Skp, p.Hk, B, D, kh, p.Hk * kh,
                  D, kv_rows, swz) ||
      !make_map(&mdo, dO, D, p.Sqp, p.Hq, B, D, qh, p.Hq * qh, q_rows) ||
      !make_map(&mv, v, D, p.Skp, p.Hk, B, D, kh, p.Hk * kh, kv_rows))
    return -2;
  const auto kernel = W == 1 ? bwd_q8_dkv_sm90<D> : bwd_q8_dq_sm90<D>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(((W == 1 ? p.Skp : p.Sqp) + C::BR - 1) / C::BR, p.Hq, B);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(mq8, mk8, mdeq, mv, mdo, p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* x) { return (reinterpret_cast<uintptr_t>(x) & 15) == 0; }

}  // namespace

extern "C" {

const char* sage_bwd_q8_sm90_error_string(int e) {
  if (e == -1) return "unsupported int8 sm90 backward configuration (kernel, head_dim, lengths, "
                      "GQA, pointers or alignment)";
  if (e == -2) {
    static char msg[128];
    snprintf(msg, sizeof msg,
             "cuTensorMapEncodeTiled failed (result %d; -1: not found in the driver)",
             g_encode_result);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)e);
}

// which: 1 = C1 (dk, dv), 2 = C2 (dq).  q8 [B, Hq, Sqp, D] and k8 [B, Hk,
// Skp, D] int8 codes with row scales qs [B, Hq, Sqp] and ks [B, Hk, Skp] f32
// (the q scales carry sm_scale * log2(e)); qd and kd their copies
// dequantized to bf16 (C1 reads qd, C2 kd; the other may be null); v [B, Hk,
// Skp, D] and dO [B, Hq, Sqp, D] bf16; lse2 and di [B, Hq, Sqp] f32; all
// contiguous with 16-byte aligned bases; Sqp and Skp multiples of 64 (at
// least 64); D 64 or 128.  Outputs per q head, bf16 (out_f32 0) or f32.
// fold is the scores' scale, sm_scale * log2(e): the q scales carry it
// here, so it is taken to keep the entry's factors those of
// sage_bwd_sm90 and is not read.
int sage_bwd_q8_sm90(int which, int D, const void* q8, const void* qd, const void* k8,
                     const void* kd, const void* v, const void* dO, const float* lse2,
                     const float* di, const float* qs, const float* ks, void* dk, void* dv,
                     void* dq, int out_f32, int B, int Hq, int Hk, int Sqp, int Skp, int causal,
                     float fold, float dk_fin, float dq_fin, void* stream) {
  (void)fold;
  if ((which != 1 && which != 2) || B < 1 || Hk < 1 || Hq % Hk || Sqp < 64 || Skp < 64 ||
      Sqp % 64 || Skp % 64)
    return -1;
  const void* deq = which == 1 ? qd : kd;
  const void* in[10] = {q8, k8, deq, v, dO, lse2, di, qs, ks, which == 1 ? dk : dq};
  for (const void* x : in)
    if (!x || !aligned16(x)) return -1;
  if (which == 1 && !dv) return -1;
  Params p{lse2, di, qs, ks, dk, dv, dq, out_f32, Hq, Hk, Sqp, Skp, causal, dk_fin, dq_fin};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return which == 1 ? launch<64, 1>(q8, k8, deq, v, dO, p, B, s)
                                  : launch<64, 2>(q8, k8, deq, v, dO, p, B, s);
  if (D == 128) return which == 1 ? launch<128, 1>(q8, k8, deq, v, dO, p, B, s)
                                   : launch<128, 2>(q8, k8, deq, v, dO, p, B, s);
  return -1;
}

}  // extern "C"
