// The masked forms of the Hopper forwards (flash_sm90.cu's MASKED mode:
// B4-window and B4-bool; attention_sm90.cu's MASKED instantiations: B1's
// window, bool-mask and segment forms): the block's list of kv tiles and the
// per-element masks of a partly live tile.
//
// The wrapper (ops/attention.py `tile_classes`, `tile_list`) gives each
// block of BM query rows the kv tiles of BN columns in which some score
// survives the masks, in order, as one int32 an entry: the tile's index in
// the low 24 bits and, for each 64-row slice w of the block (its warpgroup
// w), a class in bits 24 + 2 w: 0 dead (every score masked), 2 full (none
// masked), 1 or 3 partly live (3: cut only by the rows' and columns'
// positions).  The load ring issues the tiles of that list and
// no other.  Every warpgroup runs its products and its softmax on every
// tile of the list, as the unmasked kernels do (under a data-dependent
// branch ptxas serializes every wgmma of the kernel, C7518, and an early
// exit from the softmax made the D = 64 kernels spill): a dead slice keeps
// no score (P = 0, alpha = 1), a full one every score, and only a partly
// live slice evaluates the masks per element, in the plain version's order: the kv tail, causal and the
// window band with its sinks (global positions below `sinks`, or per
// segment through kv_segpos), segments, the bool mask.  A tile left out of
// a block's list holds only masked scores, which change no running sum.
#pragma once

#include <math.h>
#include <stdint.h>

namespace mask90 {

struct Masks {
  const int* tiles;         // [LB, LH, n_qt, nkt] the blocks' tile lists, packed
  const int* ntiles;        // [LB, LH, n_qt] their lengths
  int nkt, lb, lh;          // list row length; 1 where the lists step over batch / q head
  const int8_t* mask;       // [B, Hm, Sq, Sk] bool keep-mask (element strides), or null
  long long m_sb, m_sh, m_ss;
  int mh;                   // 1 where the mask steps over q heads
  const int* q_seg;         // [B, Sq] segment ids (q pads -1), or null
  const int* kv_seg;        // [B, Sk] (kv pads -2)
  const int* kv_segpos;     // [B, Sk] position in its segment (per-segment sinks), or null
  int window, sinks, Sk;
};

constexpr uint32_t TILE_MASK = (1u << 24) - 1;

__device__ __forceinline__ int tile_of(uint32_t e) { return (int)(e & TILE_MASK); }

// The class of warpgroup w's slice in entry e.
__device__ __forceinline__ int class_of(uint32_t e, int w) { return (int)(e >> (24 + 2 * w)) & 3; }

// The block's list and its length.
__device__ __forceinline__ const int* block_list(const Masks& m, int b, int hq, int Hq, int n_qt,
                                                 int qt, int& n) {
  const long long blk =
      ((long long)(m.lb ? b : 0) * (m.lh ? Hq : 1) + (m.lh ? hq : 0)) * n_qt + qt;
  n = m.ntiles[blk];
  return m.tiles + blk * m.nkt;
}

// The bits t < BN / 4 whose column 8 (t / 2) + 2 q4 + t % 2 (of a 64 x BN
// accumulator, relative to the tile) lies below x.
template <int BN>
__device__ __forceinline__ uint32_t below(int x, int q4) {
  const int y = x - 2 * q4;
  const int n = y <= 0 ? 0 : min(2 * (y >> 3) + min(y & 7, 2), BN / 4);
  return n >= 32 ? ~0u : (1u << n) - 1u;
}

// This thread's keep bits of a partly live tile whose first column is k0,
// every mask in the plain version's order: bit 2 j + h of kA (kB) keeps
// row rA (rB = rA + 8) at column k0 + 8 j + 2 q4 + h, the columns a thread
// holds of a 64 x BN wgmma accumulator.  The kv tail, causal, the band and
// global sinks keep a row's columns in at most two runs, built from their
// ends; with `data` (class 1) a loop over the columns, two a step so that
// few loads are in flight beside the accumulators, then adds per-segment
// sinks and cuts by segment ids and the mask's bytes.  Rows past Sq keep
// nothing of a mask or segment.
template <int BN>
__device__ __forceinline__ void keep_bits(const Masks& m, int b, int hq, int k0, int kv_len,
                                          int causal, int Sq, int rA, int rB, int q4, bool data,
                                          uint32_t& kA, uint32_t& kB) {
  // the kv tail and causal: columns up to hi; the band from the row's lower edge
  auto runs = [&](int r, uint32_t& upto) {
    upto = below<BN>((causal ? min(kv_len - 1, r) : kv_len - 1) - k0 + 1, q4);
    if (!m.window) return upto;
    uint32_t keep = upto & ~below<BN>(r - (m.window - 1) - k0, q4);
    if (m.sinks > 0 && !m.kv_segpos) keep |= upto & below<BN>(m.sinks - k0, q4);
    return keep;
  };
  uint32_t uA, uB;
  kA = runs(rA, uA);
  kB = runs(rB, uB);
  if (!data) return;
  const int8_t* mA = nullptr;
  const int8_t* mB = nullptr;
  if (m.mask) {
    const int8_t* base = m.mask + b * m.m_sb + (m.mh ? hq : 0) * m.m_sh;
    if (rA < Sq) mA = base + rA * m.m_ss;
    if (rB < Sq) mB = base + rB * m.m_ss;
  }
  const int* ks = m.kv_seg ? m.kv_seg + (long long)b * m.Sk : nullptr;
  const int* kp = m.window && m.sinks > 0 && m.kv_segpos ? m.kv_segpos + (long long)b * m.Sk
                                                         : nullptr;
  const int sA = m.q_seg && rA < Sq ? m.q_seg[(long long)b * Sq + rA] : -1;
  const int sB = m.q_seg && rB < Sq ? m.q_seg[(long long)b * Sq + rB] : -1;
#pragma unroll 2
  for (int t = 0; t < BN / 4; ++t) {
    const uint32_t bit = 1u << t;
    const int col = k0 + 8 * (t >> 1) + 2 * q4 + (t & 1);
    if (kp && ((uA | uB) & bit) && kp[col] < m.sinks) {   // a sink of its own segment
      kA |= uA & bit;
      kB |= uB & bit;
    }
    if (ks && ((kA | kB) & bit)) {
      const int kseg = ks[col];
      if (sA != kseg) kA &= ~bit;
      if (sB != kseg) kB &= ~bit;
    }
    if (m.mask && ((kA | kB) & bit)) {
      if (mA == nullptr || mA[col] == 0) kA &= ~bit;
      if (mB == nullptr || mB[col] == 0) kB &= ~bit;
    }
  }
}

// -inf on this thread's scores that the keep bits drop.
template <int BN>
__device__ __forceinline__ void apply_bits(float (&sc)[BN / 2], uint32_t kA, uint32_t kB) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!(((e < 2 ? kA : kB) >> (2 * j + (e & 1))) & 1u)) sc[4 * j + e] = -INFINITY;
}

}  // namespace mask90
