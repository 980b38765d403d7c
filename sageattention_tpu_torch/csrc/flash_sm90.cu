// B4, the unmasked bf16 flash forward, redesigned for Hopper: TMA loads
// completing on mbarriers, a ring of K/V stages, wgmma products, the
// softmax of one tile under the PV product of the one before, and
// warpgroups taking turns at the tensor cores.
//
// Replaces the Pallas kernel `_attn_kernel` (sageattention_tpu/ops/
// attention.py:251, launched by `attention_call` with quantized=False) in
// the configuration with no mask, bias, window, segments, FP4 rounding or
// ring offsets; those stay on attention.cuh's body (attention_ext.cu,
// attention_lowbit.cu).  What it computes, as the plain version
// (ops/attention.py `attention_plain` at `flash_kv_tile(D)` columns):
//   s = (q . k) * sm_scale * log2(e) in f32; the kv tail past kv_len and,
//   under causal, col > row (top-left) masked; an online softmax in base 2
//   over BN-column kv tiles with the running max floored at M_CLAMP; P
//   rounded to bf16 per tile against the tile's running max while l sums
//   the unrounded f32 P; O += P V with f32 sums; out = O / l in bf16 and
//   the base-2 lse m + log2(l) in f32.  GQA maps head hq to hq / (Hq/Hk).
//
// What bounds it on the H100: the tensor cores (4 S^2 D flops, 989 TFLOP/s
// in bf16) and, at D = 64, nearly as much the exp2 of the softmax on the
// SFUs (S^2 of them at 16 per clock per SM).  The design:
//   block     NWG warpgroups of 64 query rows each, no producer warp: three
//             at D = 64 (192 rows, 384 threads), two at D = 128 and 256
//             (128 rows, 256 threads), one block per SM (shared memory).
//             ptxas caps a block of more than 256 threads at 168 registers
//             a thread, and a producer warpgroup's setmaxnreg (24/240) did
//             not raise the consumers' share enough in the build tried: at
//             D = 128 and 256 the accumulators spilled and every wgmma was
//             serialized.  Without one, the warpgroups hold 156 / 186 /
//             203 registers at D = 64 / 128 / 256 and nothing spills (the
//             smoke prints ptxas's report); at D = 64 the third warpgroup
//             hides the softmax's latencies and reads each K/V tile for 192
//             rows.
//   loads     Q once (its own mbarrier); K and V tiles of BN rows into a
//             ring of STAGES stages with a full barrier each for K and V.
//             The block's first thread issues Q and the first STAGES
//             tiles; afterwards the last of the block's warps to finish
//             with a stage (a shared counter per stage) issues the load of
//             the tile STAGES ahead into it, so loads run STAGES - 1 tiles
//             ahead of the products.  Tensor maps of rank 4 (D, S, H, B)
//             are built from the strides, so HND and NHD both load, and a
//             tile past Sq or kv_len is zero-filled instead of reading the
//             next head (the K/V maps end at kv_len).  Rows are 64-column
//             boxes of 128 bytes, 128-byte swizzled.
//   S = QK^T  wgmma m64nBNk16, A (Q) and B (K) from shared memory, K-major.
//   softmax   on the accumulator layout: a thread holds two rows, a quad
//             shares a row, maxima and sums by quad shuffles; the scale
//             rides in the FMA before each exp2.  P is packed to bf16
//             straight into the A fragments of the PV product.
//   O += PV   wgmma m64nDk16 with A (P) from registers and B = V from
//             shared memory as an MN-major operand (the transpose bit), so
//             V needs no transpose.
//   overlap   per warpgroup, S(kt) and O += P(kt-1) V(kt-1) are issued
//             together and the softmax of S(kt) runs under the PV product;
//             the warpgroups take turns to issue (named barriers), so that
//             one's softmax runs under another's products.
//   causal    the longest q tiles launch first; tiles past the block's last
//             row are never loaded, and only tiles that cross the diagonal
//             or the kv tail are masked.
//   tiles     BN = 128 at D = 64 and 128, 64 at D = 256, with 4 / 3 / 2
//             stages: Q and the stages take 152 / 224 / 192 KB of shared
//             memory.  At D = 256 the 64 x 256 f32 O accumulator alone is
//             128 registers a thread.
// An exp2 split between the SFUs and the FMA pipes, stores through shared
// memory, and a persistent grid are later work.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace flash90 {

constexpr float M_CLAMP = -1e20f;   // floor of the running max

template <int D>
struct Cfg {
  static constexpr int NWG = D == 64 ? 3 : 2;     // warpgroups, 64 query rows each
  static constexpr int BM = 64 * NWG;             // query rows per block
  static constexpr int THREADS = 128 * NWG;
  static constexpr int BN = D <= 128 ? 128 : 64;  // kv rows per tile (flash_kv_tile)
  static constexpr int STAGES = D == 64 ? 4 : D == 128 ? 3 : 2;  // K/V ring depth
  static constexpr int CH = D / 64;               // 128-byte column boxes per row
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;     // one K or V stage
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;  // + alignment slack
};

struct Params {
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_ss;
  float* lse;  // [B*Hq*Sq] base 2, or null
  int Hq, Hk, Sq, kv_len, causal;
  float fold;  // sm_scale * log2(e)
};

// ------------------------------------------------------------ PTX helpers --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.  A wait that
// never ends (a parity or count mistake) traps after ~2^33 clocks (a few
// seconds; a tile's loads take microseconds) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (uint32_t i = 1;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((i & 1023) == 0) {
      const long long now = clock64();
      if (t0 == 0) t0 = now;
      else if (now - t0 > (1ll << 33)) __trap();
    }
  }
}

// One box of a rank-4 tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from touching accumulator registers across the
// asynchronous wgmma (its reads must come after the wait).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptors of 128-byte-swizzled operands.  The low
// word holds the start address and the leading byte offset (16-byte units),
// the high word the stride byte offset, 1024 bytes (8 rows of 128 bytes)
// for every operand here, and the layout, SWIZZLE_128B.  K-major (Q, K):
// rows of 128 bytes; a k16 step advances the start by 32 bytes inside the
// row.  MN-major (V): a k16 step is 16 kv rows (2048 bytes); the next 64
// columns of D lie one box (BN * 128 bytes) further, the leading offset.
constexpr uint32_t DESC_HI = (1024 >> 4) | (1u << 30);

__device__ __forceinline__ uint32_t desc_lo(uint32_t addr, uint32_t lbo) {
  return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16);
}

__device__ __forceinline__ uint64_t desc(uint32_t lo) {
  return (static_cast<uint64_t>(DESC_HI) << 32) | lo;
}

// A value the compiler cannot see through: per-step descriptors built from
// it are recomputed in the loop (an add each) instead of being hoisted out
// of it into registers that the accumulators need.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// wgmma m64nNk16, f32 += bf16 x bf16.  _ss: A and B from shared memory,
// both K-major.  _rs: A from registers, B MN-major (transposed).  scale_d 0
// overwrites the accumulator, 1 adds to it.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void reg_fence_u(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// --------------------------------------------------------------- kernel --

// The thread holding accumulator element i of a 64 x N wgmma tile owns row
// 16 * warp + lane / 4 (+8 for i % 4 >= 2) and column 8 * (i / 4) +
// 2 * (lane % 4) + i % 2.

// Issues S = Q K^T for one warpgroup: D/16 k16 steps, A (its 64 Q rows) and
// B (the K stage) from shared memory.
template <int D, int BM, int BN>
__device__ __forceinline__ void qk_issue(float (&sc)[BN / 2], uint32_t qlo, uint32_t klo) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss(sc, desc(qlo + (ks >> 2) * (BM * 128 / 16) + (ks & 3) * 2),
             desc(klo + (ks >> 2) * (BN * 128 / 16) + (ks & 3) * 2), ks > 0);
  wg_commit();
}

// Issues O += P V: BN/16 k16 steps, A (P) from registers, B (the V stage)
// MN-major from shared memory.
template <int D, int BN>
__device__ __forceinline__ void pv_issue(float (&o)[D / 2], const uint32_t (&pf)[BN / 16][4],
                                         uint32_t vlo) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs(o, pf[kk], desc(vlo + kk * (16 * 128 / 16)), 1);
  wg_commit();
}

// The online softmax of one S tile whose first column is k0, in place: the
// kv tail and causal masks where the tile crosses them, the new running
// maxima (the 4 lanes of a quad share a row) and their alphas, P =
// exp2(s * fold - m) in f32, and l summing that unrounded P.  With fold > 0
// the row max of the raw products, times fold, is the max of the scaled
// scores exactly (rounding is monotone), so the scale rides in one FMA with
// the max's subtraction; a masked score is -inf, whose P is 0.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], const Params& p, int k0,
                                             int row0, int rA, int rB, int q4, float& mA,
                                             float& mB, float& lA, float& lB, float& aA,
                                             float& aB) {
  if (k0 + BN > p.kv_len || (p.causal && k0 + BN - 1 > row0)) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * q4 + (e & 1);
        if (col >= p.kv_len || (p.causal && col > (e < 2 ? rA : rB))) sc[4 * j + e] = -INFINITY;
      }
  }
  float cA = -INFINITY, cB = -INFINITY;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    cA = fmaxf(cA, fmaxf(sc[4 * j], sc[4 * j + 1]));
    cB = fmaxf(cB, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  cA = fmaxf(cA, __shfl_xor_sync(0xffffffffu, cA, 1));
  cA = fmaxf(cA, __shfl_xor_sync(0xffffffffu, cA, 2));
  cB = fmaxf(cB, __shfl_xor_sync(0xffffffffu, cB, 1));
  cB = fmaxf(cB, __shfl_xor_sync(0xffffffffu, cB, 2));
  const float nA = fmaxf(fmaxf(mA, __fmul_rn(cA, p.fold)), M_CLAMP);
  const float nB = fmaxf(fmaxf(mB, __fmul_rn(cB, p.fold)), M_CLAMP);
  aA = ex2(__fsub_rn(mA, nA));
  aB = ex2(__fsub_rn(mB, nB));
  mA = nA;
  mB = nB;
  float pA = 0.f, pB = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    sc[4 * j] = ex2(__fmaf_rn(sc[4 * j], p.fold, -nA));
    sc[4 * j + 1] = ex2(__fmaf_rn(sc[4 * j + 1], p.fold, -nA));
    sc[4 * j + 2] = ex2(__fmaf_rn(sc[4 * j + 2], p.fold, -nB));
    sc[4 * j + 3] = ex2(__fmaf_rn(sc[4 * j + 3], p.fold, -nB));
    pA += sc[4 * j] + sc[4 * j + 1];
    pB += sc[4 * j + 2] + sc[4 * j + 3];
  }
  lA = __fadd_rn(__fmul_rn(aA, lA), pA);
  lB = __fadd_rn(__fmul_rn(aB, lB), pB);
}

// P in bf16, packed straight into the A fragments of the PV product: k16
// step kk takes the tile's columns 16 kk .. 16 kk + 15.
template <int BN>
__device__ __forceinline__ void pack_p(const float (&sc)[BN / 2], uint32_t (&pf)[BN / 16][4]) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    pf[j >> 1][(j & 1) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
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

// Grid (ceil(Sq / BM), Hq, B), Cfg<D>::THREADS threads.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using C = Cfg<D>;
  constexpr int BM = C::BM, BN = C::BN, CH = C::CH, STAGES = C::STAGES, NWG = C::NWG;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // q full, then per stage: k full, v full
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  __shared__ int freed[STAGES];  // per stage: warps done with its tile
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle wants 1 KB
  const uint32_t sK = sQ + C::Q_BYTES;             // stage s at sK + s * KV_BYTES
  const uint32_t sV = sK + STAGES * C::KV_BYTES;
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

  const int tid = threadIdx.x;
  // K and V of tile kt into stage kt % STAGES, each completing on its full
  // barrier
  auto load_tile = [&](int kt) {
    const int s = kt % STAGES;
    mbar_expect_tx(bar_k + 8 * s, C::KV_BYTES);
#pragma unroll
    for (int c = 0; c < CH; ++c)
      tma_load4(sK + s * C::KV_BYTES + c * (BN * 128), &tm_k, bar_k + 8 * s, c * 64, kt * BN, hk,
                b);
    mbar_expect_tx(bar_v + 8 * s, C::KV_BYTES);
#pragma unroll
    for (int c = 0; c < CH; ++c)
      tma_load4(sV + s * C::KV_BYTES + c * (BN * 128), &tm_v, bar_v + 8 * s, c * 64, kt * BN, hk,
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
#pragma unroll
    for (int c = 0; c < CH; ++c) tma_load4(sQ + c * (BM * 128), &tm_q, bar_q, c * 64, q0, hq, b);
    for (int kt = 0; kt < min(n_kt, STAGES); ++kt) load_tile(kt);
  }
  __syncthreads();

  {
    const int cw = tid / 128;  // the warpgroup: 64 query rows each
    const int lane = tid % 32, q4 = lane & 3;
    const int row0 = q0 + 64 * cw;
    const int rA = row0 + 16 * ((tid % 128) / 32) + (lane >> 2), rB = rA + 8;  // this thread's rows
    // the warpgroups take turns, in order, to issue their products, so that
    // one's softmax runs under another's: named barrier 1 + w is warpgroup
    // w's turn, which warpgroup w - 1 hands over after issuing.  Every
    // warpgroup walks all n_kt tiles (a tile past its last row holds only
    // masked scores, an exact no-op), so all take n_kt + 1 turns.
    auto take_turn = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory"); };
    auto hand_over = [&]() {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (cw + 1) % NWG) : "memory");
    };
    if (cw == NWG - 1 && n_kt > 0) hand_over();  // warpgroup 0 goes first
    const uint32_t q_lo = desc_lo(sQ + cw * (64 * 128), 16);
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
    float mA = M_CLAMP, mB = M_CLAMP, lA = 0.f, lB = 0.f, aA, aB;
    uint32_t pf[BN / 16][4];  // P of the tile whose PV product is next
    mbar_wait(bar_q, 0);

    if (n_kt > 0) {  // tile 0: S, then its softmax
      float sc[BN / 2];
      mbar_wait(bar_k, 0);
      take_turn();
      wg_fence();
      qk_issue<D, BM, BN>(sc, opaque(q_lo), opaque(desc_lo(sK, 16)));
      hand_over();
      wg_wait<0>();
      reg_fence(sc);
      softmax_tile<BN>(sc, p, 0, row0, rA, rB, q4, mA, mB, lA, lB, aA, aB);
      pack_p<BN>(sc, pf);
    }
    // tile kt: S(kt) and O += P(kt-1) V(kt-1) in flight together; the
    // softmax of S(kt) runs under the PV product, then O takes alpha(kt)
    // and P(kt) is packed (the PV product's registers are not written
    // while it runs)
    for (int kt = 1; kt < n_kt; ++kt) {
      const int s = kt % STAGES, ps = (kt - 1) % STAGES;
      float sc[BN / 2];
      mbar_wait(bar_k + 8 * s, (kt / STAGES) & 1);
      mbar_wait(bar_v + 8 * ps, ((kt - 1) / STAGES) & 1);
      reg_fence(o);
      reg_fence_u(pf);
      take_turn();
      wg_fence();
      qk_issue<D, BM, BN>(sc, opaque(q_lo), opaque(desc_lo(sK + s * C::KV_BYTES, 16)));
      wg_fence();
      pv_issue<D, BN>(o, pf, opaque(desc_lo(sV + ps * C::KV_BYTES, BN * 128)));
      hand_over();
      wg_wait<1>();
      reg_fence(sc);
      softmax_tile<BN>(sc, p, kt * BN, row0, rA, rB, q4, mA, mB, lA, lB, aA, aB);
      wg_wait<0>();
      reg_fence(o);
      reg_fence_u(pf);
      reg_fence(sc);  // P is packed only now, into the registers the product has freed
      release(kt - 1);
      rescale<D>(o, aA, aB);
      pack_p<BN>(sc, pf);
    }
    if (n_kt > 0) {  // the last PV product
      const int ls = (n_kt - 1) % STAGES;
      mbar_wait(bar_v + 8 * ls, ((n_kt - 1) / STAGES) & 1);
      reg_fence(o);
      reg_fence_u(pf);
      take_turn();
      wg_fence();
      pv_issue<D, BN>(o, pf, opaque(desc_lo(sV + ls * C::KV_BYTES, BN * 128)));
      if (cw < NWG - 1) hand_over();  // the next warpgroups' last turns come after this one
      wg_wait<0>();
      reg_fence(o);
      release(n_kt - 1);
    }

    // ---------------- epilogue: O / l and the base-2 lse ----------------
    lA += __shfl_xor_sync(0xffffffffu, lA, 1);
    lA += __shfl_xor_sync(0xffffffffu, lA, 2);
    lB += __shfl_xor_sync(0xffffffffu, lB, 1);
    lB += __shfl_xor_sync(0xffffffffu, lB, 2);
    const float iA = __fdiv_rn(1.f, lA == 0.f ? 1.f : lA);
    const float iB = __fdiv_rn(1.f, lB == 0.f ? 1.f : lB);
    __nv_bfloat16* ob = p.o + b * p.o_sb + hq * p.o_sh;
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
    if (p.lse && q4 == 0) {
      float* lse = p.lse + (long long)(b * p.Hq + hq) * p.Sq;
      if (rA < p.Sq) lse[rA] = __fadd_rn(mA, log2f(fmaxf(lA, 1e-37f)));
      if (rB < p.Sq) lse[rB] = __fadd_rn(mB, log2f(fmaxf(lB, 1e-37f)));
    }
  }
}

}  // namespace flash90

// ------------------------------------------------------------------ host --

namespace {

using namespace flash90;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

int g_encode_result = 0;  // the last cuTensorMapEncodeTiled result, for the message

// The driver's cuTensorMapEncodeTiled through the runtime, so that the
// library links against the runtime alone.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(ptr) : nullptr;
  }();
  return fn;
}

// The rank-4 map (D, S, H, B) of a bf16 tensor with element strides (ss,
// sh, sb) and boxes of 64 columns x `rows` rows, 128-byte swizzled; reads
// past S zero-fill.  A dimension of size 1 is never stepped over, so it
// takes a stride the encoder accepts whatever the tensor's (0 when
// expanded).
bool make_map(CUtensorMap* map, const void* base, int D, int S, int H, int B, long long ss,
              long long sh, long long sb, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) {
    g_encode_result = -1;
    return false;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const long long st[3] = {S == 1 ? D : ss, H == 1 ? D : sh, B == 1 ? D : sb};
  const cuuint64_t strides[3] = {(cuuint64_t)st[0] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[2] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  g_encode_result = (int)r;
  return r == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const long long* st, const Params& p,
           int B, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap mq, mk, mv;
  const int kv_rows = p.kv_len > 0 ? p.kv_len : 1;  // n_kt = 0 loads nothing
  if (!make_map(&mq, q, D, p.Sq, p.Hq, B, st[2], st[1], st[0], C::BM) ||
      !make_map(&mk, k, D, kv_rows, p.Hk, B, st[5], st[4], st[3], C::BN) ||
      !make_map(&mv, v, D, kv_rows, p.Hk, B, st[8], st[7], st[6], C::BN))
    return -2;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((p.Sq + C::BM - 1) / C::BM, p.Hq, B);
  flash_fwd_kernel<D><<<grid, C::THREADS, C::SMEM, stream>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sage_flash_error_string(int e) {
  if (e == -1) return "unsupported flash configuration (head_dim, kv tile, GQA or strides)";
  if (e == -2) {
    static char msg[128];
    snprintf(msg, sizeof msg,
             "cuTensorMapEncodeTiled failed (result %d; -1: not found in the driver)",
             g_encode_result);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)e);
}

// B4 on bf16 q [B, Hq, Sq, D], k and v [B, Hk, Sk, D] and o [B, Hq, Sq, D],
// each with its own element strides (batch, head, row; unit column stride,
// 16-byte aligned base and outer strides).  `bn` must be the kv tile that
// the plain version walks (ops/attention.py `flash_kv_tile`).
int sage_flash_fwd(int D, int bn, const void* q, const void* k, const void* v, void* o,
                   long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                   long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                   long long v_ss, long long o_sb, long long o_sh, long long o_ss, float* lse,
                   int B, int Hq, int Hk, int Sq, int Sk, int kv_len, int causal, float fold,
                   void* stream) {
  const long long st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  for (int i = 0; i < 9; ++i)
    if (st[i] < 0 || (st[i] * 2) % 16) return -1;
  if (B < 1 || Hk < 1 || Hq % Hk || kv_len < 0 || kv_len > Sk || !(fold > 0.f)) return -1;
  if (Sq == 0) return 0;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.lse = lse;
  p.Hq = Hq; p.Hk = Hk; p.Sq = Sq; p.kv_len = kv_len; p.causal = causal;
  p.fold = fold;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && bn == Cfg<64>::BN) return launch<64>(q, k, v, st, p, B, s);
  if (D == 128 && bn == Cfg<128>::BN) return launch<128>(q, k, v, st, p, B, s);
  if (D == 256 && bn == Cfg<256>::BN) return launch<256>(q, k, v, st, p, B, s);
  return -1;
}

}  // extern "C"
