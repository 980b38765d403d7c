// One-pass K and V prep on Hopper (A1, A2): one launch a call, each element
// of K or V read once from device memory.
//
// Replaces the Pallas kernels `_prep_k_kernel` (A1) and `_prep_v_kernel`
// (A2) of sageattention_tpu/ops/quant_pallas.py (:787, :860), which hold a
// whole (S, D) slice in VMEM so that K is read once.  What each computes is
// prep_kv.cu's first version, to the bit: for each (batch, head) slice, over
// the true rows r < s_true,
//   mean[c]   = sum_r x[r, c] * (1 / s_true)
//   amax[c]   = max(max_r x - mean, mean - min_r x)
//   K: one head scale  = max_c amax[c] / 127 (1 if 0)   [A1]
//   V: a scale per channel = amax[c] / 127 (1 if 0)      [A2]
//   code      = clip(rint((x - mean) * (1 / scale)), -127, 127), every row
//   K only:   capmax = max over true rows of ||code_row||_2
//
// What bounds it on the H100: memory (S*D elements read, S*D int8 written a
// slice, a handful of flops each).  A slice of 2-9 MB does not fit in one
// block's 227 KB, but its 256-row chunks fit in the shared memory of many
// blocks at once, so the slice is held there while its statistics are
// finished:
//   - a persistent grid takes work items (slice, chunk) in order from an
//     atomic ticket; a block copies its chunk into shared memory with bulk
//     asynchronous copies (cp.async.bulk on an mbarrier: one copy for rows
//     that lie back to back, one a row for strided views);
//   - it reduces the chunk's per-channel sum / max / min exactly as
//     sage::stats_partial_body does (same threads, same order), publishes
//     the partial and counts itself in the slice's arrivals;
//   - the block that arrives last finishes the slice's statistics once (the
//     partials summed in chunk order, mean = sum * (1 / s_true), as
//     sage::stats_finish does, so the two-pass prep A3 + A4 gives the same
//     codes bit for bit), writes mean, amax and the head amax and raises the
//     slice's flag; every other block of the slice waits on the flag;
//   - each block then quantizes its chunk from shared memory, stores 16
//     codes a thread with one 16-byte store, and folds its row norms into
//     capmax with the order-free integer atomicMax;
//   - where two chunk buffers a block let an SM hold more chunks than one
//     (bf16 at D = 64), the block loads its next item and counts its
//     arrival before it waits on the current one's slice; the next ticket
//     is taken during the quantization.
// Forward progress: a waiting block holds its chunks, and the ticket order
// completes the earliest unfinished slice as long as every chunk of a slice
// can be held at once, so the grid (launched cooperatively: all its blocks
// resident, or the launch is refused) has at least as many blocks as a
// slice has chunks.  The workspace's ticket and arrival counters are zero
// before a launch and are put back to zero by the launch itself (the last
// arrival of a slice, the last block to leave), and a slice's flag is up
// when it holds this launch's number on the workspace, so no memset is
// launched.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int NT = sage::kStatThreads;   // 256 threads a block
constexpr int ROWS = sage::kStatRows;    // 256 rows a chunk (A3's partials)
constexpr int RED = 2048;                // floats of the reduction buffer: rows a pass x D
constexpr int QC = 16;                   // channels a thread quantizes: one 16-byte store
constexpr int SMEM_SM = 233472;          // shared memory of an SM
constexpr int SMEM_BLOCK = 232448;       // the most one block may take
constexpr int SMEM_RESERVED = 1024;      // reserved by the runtime for each block
constexpr int MAX_BPS = 4;               // blocks an SM at most: 64 registers a thread

template <typename T, int D, int BUFS>
struct Layout {
  static constexpr int CHUNK = ROWS * D * (int)sizeof(T);
  static constexpr int OFF_RED = BUFS * CHUNK;
  static constexpr int OFF_MEAN = OFF_RED + RED * 4;
  static constexpr int OFF_INV = OFF_MEAN + 256 * 4;
  static constexpr int OFF_MISC = OFF_INV + 256 * 4;   // mbarriers, ticket, last, warp maxima
  static constexpr int SMEM = OFF_MISC + 64;
  static constexpr int FIT = SMEM <= SMEM_BLOCK ? SMEM_SM / (SMEM + SMEM_RESERVED) : 0;
  static constexpr int BPS = FIT < MAX_BPS ? FIT : MAX_BPS;
};

// Two chunk buffers a block where they let an SM hold more chunks than one
// does (bf16 at D = 64: 3 blocks of 2 against 4 of 1); the blocks an SM
// holds.  ops/quant_fused.py's prep_sm90_layout mirrors this.
template <typename T, int D>
struct Cfg : Layout<T, D, (2 * Layout<T, D, 2>::BPS > Layout<T, D, 1>::BPS ? 2 : 1)> {
  static constexpr int BUFS = 2 * Layout<T, D, 2>::BPS > Layout<T, D, 1>::BPS ? 2 : 1;
};

struct Params {
  const void* x;
  long long sb, sh, ss;       // element strides of batch, head, row
  int H, S, s_true;
  int ns, nq;                 // chunks with true rows, chunks in all, a slice
  int n_items;
  float inv_s;
  float *psum, *pmax, *pmin;  // partials [B*H, ns, D] each
  int* ws;                    // ticket, exits, launch count, then (arrivals, flag) a slice
  int8_t* out;                // [B*H, S, D]
  float *mean_out, *amax_out, *cap_out;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Adds 1 with release (the block's writes, ordered before by a barrier, are
// published) and acquire (every earlier arrival's writes are seen).
__device__ __forceinline__ int arrive(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n" : "=r"(old) : "l"(p) : "memory");
  return old;
}

// 1 / scale of an amax, as prep_kv.cu rounds it.
__device__ __forceinline__ float inv_scale(float amax) {
  const float scale = amax > 0.f ? __fmul_rn(amax, (float)(1.0 / 127.0)) : 1.f;
  return __fdiv_rn(1.f, scale);
}

// sage::code_i8(x) as an int: clip then round (the same for every x, NaN
// included: both give -127).
__device__ __forceinline__ int code_int(float x) {
  return __float2int_rn(fminf(fmaxf(x, -127.f), 127.f));
}

// Four codes in [-127, 127] as the bytes of a word, lowest first.
__device__ __forceinline__ uint32_t pack4(int c0, int c1, int c2, int c3) {
  return __byte_perm(__byte_perm(c0, c1, 0x0040), __byte_perm(c2, c3, 0x0040), 0x5410);
}

// A thread's running sum / max / min of 8 channels over its rows of a
// chunk in shared memory (rows tr, tr + RPI, ... below r1), in
// sage::stats_partial_body's order.  bf16 takes its max and min on pairs.
template <int D, int RPI>
__device__ __forceinline__ void chunk_stats(const float* chunk, int tr, int cg, int r1, float* sm,
                                            float* mx, float* mn) {
#pragma unroll
  for (int i = 0; i < 8; ++i) { sm[i] = 0.f; mx[i] = -3e38f; mn[i] = 3e38f; }
  for (int r = tr; r < r1; r += RPI) {
    float v[8];
    sage::load8(chunk + r * D + cg * 8, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sm[i] += v[i];
      mx[i] = fmaxf(mx[i], v[i]);
      mn[i] = fminf(mn[i], v[i]);
    }
  }
}

template <int D, int RPI>
__device__ __forceinline__ void chunk_stats(const __nv_bfloat16* chunk, int tr, int cg, int r1,
                                            float* sm, float* mx, float* mn) {
  __nv_bfloat162 hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sm[2 * i] = sm[2 * i + 1] = 0.f;
    hi[i] = __float2bfloat162_rn(-3e38f);
    lo[i] = __float2bfloat162_rn(3e38f);
  }
  for (int r = tr; r < r1; r += RPI) {
    const uint4 u = *reinterpret_cast<const uint4*>(chunk + r * D + cg * 8);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      sm[2 * i] += f.x;
      sm[2 * i + 1] += f.y;
      hi[i] = __hmax2(hi[i], h[i]);
      lo[i] = __hmin2(lo[i], h[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(hi[i]), b = __bfloat1622float2(lo[i]);
    mx[2 * i] = a.x;
    mx[2 * i + 1] = a.y;
    mn[2 * i] = b.x;
    mn[2 * i + 1] = b.y;
  }
}

// One of a chunk's three reductions (K: 0 sum, 1 max, 2 min): every
// thread's 8 channels into `red`, then thread c < D folds the row groups
// in order, as sage::stats_partial_body does.
template <int K, int D>
__device__ __forceinline__ float fold_rows(float* red, float* mine, const float (&x)[8],
                                           int tid) {
  reinterpret_cast<float4*>(mine)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(mine)[1] = make_float4(x[4], x[5], x[6], x[7]);
  __syncthreads();
  float a = K == 0 ? 0.f : (K == 1 ? -3e38f : 3e38f);
  if (tid < D) {
#pragma unroll
    for (int g = 0; g < NT / (D / 8); ++g) {
      const float y = red[g * D + tid];
      a = K == 0 ? a + y : (K == 1 ? fmaxf(a, y) : fminf(a, y));
    }
  }
  __syncthreads();
  return a;
}

template <typename T, int D, bool PER_CHANNEL, bool CAPMAX>
__global__ void __launch_bounds__(NT, Cfg<T, D>::BPS) prep_sm90_kernel(const Params p) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + C::OFF_RED);
  float* s_mean = reinterpret_cast<float*>(smem + C::OFF_MEAN);
  float* s_inv = reinterpret_cast<float*>(smem + C::OFF_INV);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + C::OFF_MISC);   // one a buffer
  int* s_int = reinterpret_cast<int*>(smem + C::OFF_MISC + 16);      // ticket, last
  float* s_wmax = reinterpret_cast<float*>(smem + C::OFF_MISC + 24);  // 8 warps' maxima

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* ticket = p.ws;
  int* exits = p.ws + 1;
  // the launches' count on this workspace: a slice's flag is up when it
  // holds this launch's number (read by thread 0, which alone uses it), so
  // no flag is put back
  int* launches = p.ws + 2;
  // slice s's arrival count and flag at ws[3 + 2s] and ws[4 + 2s]: the same
  // words whatever a launch's slice count, so a flag never lands on
  // another launch's count
  int* arrived = p.ws + 3;
  int* flag = p.ws + 4;
  int gen = 0;
  if (tid == 0) {
    for (int i = 0; i < C::BUFS; ++i) sm90::mbar_init(sm90::smem_u32(bar + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const int prev = __ldcg(launches);
    gen = prev == 0x7fffffff ? 1 : prev + 1;
    s_int[0] = atomicAdd(ticket, 1);
  }
  __syncthreads();

  // stats layout (sage::stats_partial_body's): D/8 lanes a row, 8 channels each
  constexpr int CPR = D / 8, RPI = NT / CPR;
  const int tr = tid / CPR, cg = tid % CPR;
  // quantize layout: D/16 lanes a row, 16 channels each
  constexpr int TPR = D / QC, RPP = NT / TPR;
  const int qr = tid / TPR, qc = tid % TPR;
  constexpr uint32_t ROW_BYTES = D * sizeof(T);
  uint32_t parity = 0;   // bit i: buffer i's phase

  // Item t's chunk into buffer `buf`: issued by warp 0, landed by everyone.
  auto stage = [&](int buf, int t) {
    if (warp != 0) return;
    const int s = t / p.nq, j = t - s * p.nq;
    const int b = s / p.H, h = s - b * p.H;
    const int r0 = j * ROWS, rows = min(ROWS, p.S - r0);
    const T* src = static_cast<const T*>(p.x) + b * p.sb + h * p.sh + (long long)r0 * p.ss;
    const uint32_t bar_a = sm90::smem_u32(bar + buf);
    if (lane == 0) sm90::mbar_expect_tx(bar_a, rows * ROW_BYTES);
    __syncwarp();
    const uint32_t dst = sm90::smem_u32(smem + buf * C::CHUNK);
    if (p.ss == D) {
      if (lane == 0) sm90::bulk_load(dst, src, rows * ROW_BYTES, bar_a);
    } else {
      for (int r = lane; r < rows; r += 32)
        sm90::bulk_load(dst + r * ROW_BYTES, src + r * p.ss, ROW_BYTES, bar_a);
    }
  };
  auto land = [&](int buf) {
    sm90::mbar_wait(sm90::smem_u32(bar + buf), (parity >> buf) & 1);
    parity ^= 1u << buf;
  };

  // Item t's partial sum / max / min over its true rows, in
  // stats_partial_body's order, and its arrival; the slice's last arrival
  // finishes the slice's statistics and raises its flag.
  auto arrive_chunk = [&](int buf, int t) {
    const int s = t / p.nq, j = t - s * p.nq;
    if (j >= p.ns) return;   // padding rows only
    const T* chunk = reinterpret_cast<const T*>(smem + buf * C::CHUNK);
    float sm[8], mx[8], mn[8];
    chunk_stats<D, RPI>(chunk, tr, cg, min(ROWS, p.s_true - j * ROWS), sm, mx, mn);
    float* mine = red + tr * D + cg * 8;
    const float a = fold_rows<0, D>(red, mine, sm, tid);
    const float hi = fold_rows<1, D>(red, mine, mx, tid);
    const float lo = fold_rows<2, D>(red, mine, mn, tid);
    if (tid < D) {
      const long long o = ((long long)s * p.ns + j) * D + tid;
      p.psum[o] = a;
      p.pmax[o] = hi;
      p.pmin[o] = lo;
    }
    __syncthreads();
    if (tid == 0) {
      const bool is_last = arrive(arrived + 2 * s) == p.ns - 1;
      if (is_last) atomicExch(arrived + 2 * s, 0);   // the last: zero for the next launch
      s_int[1] = is_last;
    }
    __syncthreads();
    if (s_int[1] == 0) return;
    // the partials in chunk order, RED of them a pass through `red`, the
    // next pass's loads in flight while this one is summed; maxima and
    // minima on the way, thread tid taking channel tid % D
    constexpr int PER = RED / NT;
    const long long base = (long long)s * p.ns * D;
    const int total = p.ns * D;
    float acc = 0.f, hi2 = -3e38f, lo2 = 3e38f;
    float ns_[PER], nx_[PER], nn_[PER];
    auto fetch = [&](int e0) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int e = e0 + tid + i * NT;
        const bool in = e < total;
        ns_[i] = in ? __ldcg(p.psum + base + e) : 0.f;
        nx_[i] = in ? __ldcg(p.pmax + base + e) : -3e38f;
        nn_[i] = in ? __ldcg(p.pmin + base + e) : 3e38f;
      }
    };
    fetch(0);
    for (int e0 = 0; e0 < total; e0 += RED) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        red[tid + i * NT] = ns_[i];
        hi2 = fmaxf(hi2, nx_[i]);
        lo2 = fminf(lo2, nn_[i]);
      }
      __syncthreads();
      if (e0 + RED < total) fetch(e0 + RED);
      const int n = min(RED, total - e0) / D;
      if (tid < D)
        for (int g = 0; g < n; ++g) acc += red[g * D + tid];   // chunk order
      __syncthreads();
    }
    red[tid] = hi2;
    red[NT + tid] = lo2;
    __syncthreads();
    float amax = 0.f;
    if (tid < D) {
#pragma unroll
      for (int g = 0; g < NT / D; ++g) {
        hi2 = fmaxf(hi2, red[g * D + tid]);
        lo2 = fminf(lo2, red[NT + g * D + tid]);
      }
      const float mean = __fmul_rn(acc, p.inv_s);
      amax = fmaxf(__fsub_rn(hi2, mean), __fsub_rn(mean, lo2));
      p.mean_out[(long long)s * D + tid] = mean;
      if (PER_CHANNEL) p.amax_out[(long long)s * D + tid] = amax;
    }
    if (!PER_CHANNEL) {
      __syncthreads();   // every thread has read `red`
      if (tid < D) red[tid] = amax;
      __syncthreads();
      if (warp == 0) {
        float m = 0.f;   // channel amaxes are >= 0
#pragma unroll
        for (int c = lane; c < D; c += 32) m = fmaxf(m, red[c]);
        m = sage::warp_max(m);
        if (lane == 0) p.amax_out[s] = m;
      }
    }
    __syncthreads();
    if (tid == 0) {
      if (CAPMAX) p.cap_out[s] = 0.f;
      st_release(flag + 2 * s, gen);   // publishes the block's writes, ordered by the barrier
    }
  };

  // Item t's codes from buffer `buf`, once its slice's flag holds this
  // launch's number; thread 0 takes the next ticket meanwhile.
  auto quantize = [&](int buf, int t, bool take) {
    const int s = t / p.nq, j = t - s * p.nq;
    const int r0 = j * ROWS, rows = min(ROWS, p.S - r0);
    if (tid == 0) {
      const long long t0 = clock64();
      while (ld_acquire(flag + 2 * s) != gen) {
        __nanosleep(32);
        if (clock64() - t0 > (1ll << 33)) __trap();   // seconds: a lost slice, not a wait
      }
    }
    __syncthreads();
    // a thread reads what it or its slice's finisher wrote: the same thread
    // for the finisher's own block, the flag's release for the others
    if (tid < D) {
      s_mean[tid] = __ldcg(p.mean_out + (long long)s * D + tid);
      if (PER_CHANNEL) s_inv[tid] = inv_scale(__ldcg(p.amax_out + (long long)s * D + tid));
    }
    if (!PER_CHANNEL && tid == 0) s_inv[0] = inv_scale(__ldcg(p.amax_out + s));
    __syncthreads();
    int next = 0;
    if (take && tid == 0) next = atomicAdd(ticket, 1);
    float mean[QC], inv[QC];
#pragma unroll
    for (int i = 0; i < QC; ++i) {
      mean[i] = s_mean[qc * QC + i];
      inv[i] = PER_CHANNEL ? s_inv[qc * QC + i] : s_inv[0];
    }
    const T* chunk = reinterpret_cast<const T*>(smem + buf * C::CHUNK);
    int8_t* obase = p.out + ((long long)s * p.S + r0) * D + qc * QC;
    float cap = 0.f;
    // every lane of a row runs the same trip count (RPP divides ROWS), so
    // the shuffles below see all lanes of the row
    for (int r = qr; r < ROWS; r += RPP) {
      int n2 = 0;
      if (r < rows) {
        float v[QC];
        sage::load8(chunk + r * D + qc * QC, v);
        sage::load8(chunk + r * D + qc * QC + 8, v + 8);
        uint32_t w[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          int c[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            c[i] = code_int(__fmul_rn(__fsub_rn(v[4 * g + i], mean[4 * g + i]), inv[4 * g + i]));
          w[g] = pack4(c[0], c[1], c[2], c[3]);
          if (CAPMAX) n2 = __dp4a(static_cast<int>(w[g]), static_cast<int>(w[g]), n2);
        }
        *reinterpret_cast<uint4*>(obase + (long long)r * D) = make_uint4(w[0], w[1], w[2], w[3]);
      }
      if (CAPMAX) {
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1) n2 += __shfl_xor_sync(0xffffffffu, n2, o);
        // exact: a row's sum of squares is an integer below 2^24
        if (r < rows && r0 + r < p.s_true) cap = fmaxf(cap, sqrtf(static_cast<float>(n2)));
      }
    }
    if (CAPMAX) {
      cap = sage::warp_max(cap);
      if (lane == 0) s_wmax[warp] = cap;
    }
    if (take && tid == 0) s_int[0] = next;
    __syncthreads();   // the buffer, the stats and the ticket's slot are free again
    if (CAPMAX && tid == 0) {
      float m = 0.f;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) m = fmaxf(m, s_wmax[w]);
      sage::atomic_max_nonneg(p.cap_out + s, m);
    }
  };

  // One buffer: load, arrive, quantize, an item at a time.  Two: the next
  // item is loaded and arrives before the block waits on the current one's
  // flag, so the wait overlaps a load; a waiting block then holds two
  // arrived chunks and no other ticket.  (Quantizing the current item
  // while the next one's copy is in flight delays that arrival behind the
  // wait, and every slice then waits on the one before it.)
  int cur = s_int[0], buf = 0;
  if (cur < p.n_items) {
    stage(0, cur);
    land(0);
    arrive_chunk(0, cur);
    if constexpr (C::BUFS == 2) {
      if (tid == 0) s_int[0] = atomicAdd(ticket, 1);
      __syncthreads();
    }
    for (;;) {
      if constexpr (C::BUFS == 2) {
        const int nxt = s_int[0];
        if (nxt < p.n_items) {
          stage(buf ^ 1, nxt);
          land(buf ^ 1);
          arrive_chunk(buf ^ 1, nxt);
        }
        quantize(buf, cur, nxt < p.n_items);
        if (nxt >= p.n_items) break;
        cur = nxt;
        buf ^= 1;
      } else {
        quantize(0, cur, true);
        cur = s_int[0];
        if (cur >= p.n_items) break;
        stage(0, cur);
        land(0);
        arrive_chunk(0, cur);
      }
    }
  }
  // the last block to leave puts the ticket back and counts the launch
  if (tid == 0 && atomicAdd(exits, 1) == (int)gridDim.x - 1) {
    atomicExch(ticket, 0);
    atomicExch(exits, 0);
    atomicExch(launches, gen);
  }
}

template <typename T, int D, bool PER_CHANNEL, bool CAPMAX>
int launch(const Params& p, int grid, cudaStream_t st) {
  using C = Cfg<T, D>;
  auto kernel = prep_sm90_kernel<T, D, PER_CHANNEL, CAPMAX>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  Params arg = p;
  void* args[] = {&arg};
  // cooperative: every block resident at once, or the launch is refused
  const cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                                    dim3(grid), dim3(NT), args, C::SMEM, st);
  if (e != cudaSuccess) {
    cudaGetLastError();   // a refused launch leaves no error behind for later calls
    return (int)e;
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_mode(bool per_channel, bool capmax, const Params& p, int grid, cudaStream_t st) {
  if (per_channel) return launch<T, D, true, false>(p, grid, st);
  if (capmax) return launch<T, D, false, true>(p, grid, st);
  return launch<T, D, false, false>(p, grid, st);
}

}  // namespace

extern "C" {

const char* sage_prep_sm90_error_string(int e) {
  if (e == -1)
    return "unsupported dtype, head_dim, length, strides or grid for prep_sm90 (the grid must "
           "hold every chunk of a slice at once)";
  return cudaGetErrorString((cudaError_t)e);
}

// A1 (per_channel 0, capmax 0/1) or A2 (per_channel 1) on x [B, H, S, D],
// element strides (sb, sh, ss), unit channel stride, 16-byte aligned base
// and strides; dtype 0 = bfloat16 (D 64/128/256), 1 = float32 (D 64/128).
// grid: the persistent blocks, at least the chunks of a slice
// (ceil(S / 256)), at most every block the card holds at once.  part: 3 *
// B*H*ceil(s_true/256)*D floats; ws: 3 + 2*B*H int32, zero before the
// first launch on it and kept between launches (the ticket, exit and
// arrival counts are left zero, the launch count and flags as they are).
// out [B*H, S, D] int8, mean_out [B*H, D], amax_out [B*H, D] (A2) or [B*H]
// (A1), cap_out [B*H] (A1 with capmax, written by the kernel) or null.
int sage_prep_sm90(int per_channel, int capmax, int dtype, const void* x, long long sb,
                   long long sh, long long ss, int B, int H, int S, int s_true, int D,
                   float inv_s, int grid, float* part, int* ws, int8_t* out,
                   float* mean_out, float* amax_out, float* cap_out, void* stream) {
  const int elt = dtype == 0 ? 2 : 4;
  const long long nq = (S + ROWS - 1) / ROWS, ns = (s_true + ROWS - 1) / ROWS;
  const long long n_items = (long long)B * H * nq;
  const bool shape_ok = dtype == 0 ? (D == 64 || D == 128 || D == 256)
                                    : (dtype == 1 && (D == 64 || D == 128));
  if (!shape_ok || B < 1 || H < 1 || s_true < 1 || s_true > S || n_items > 0x7fffffff ||
      grid < nq || grid > n_items || (per_channel && capmax) || (capmax && !cap_out) ||
      !x || !part || !ws || reinterpret_cast<uintptr_t>(x) % 16 || (sb * elt) % 16 ||
      (sh * elt) % 16 || (ss * elt) % 16 || ss < D)
    return -1;
  const long long n = (long long)B * H * ns * D;
  Params p{x, sb, sh, ss, H, S, s_true, (int)ns, (int)nq, (int)n_items, inv_s,
           part, part + n, part + 2 * n, ws, out, mean_out, amax_out, cap_out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pc = per_channel != 0, cap = capmax != 0;
  if (dtype == 0) {
    if (D == 64) return launch_mode<__nv_bfloat16, 64>(pc, cap, p, grid, st);
    if (D == 128) return launch_mode<__nv_bfloat16, 128>(pc, cap, p, grid, st);
    return launch_mode<__nv_bfloat16, 256>(pc, cap, p, grid, st);
  }
  if (D == 64) return launch_mode<float, 64>(pc, cap, p, grid, st);
  return launch_mode<float, 128>(pc, cap, p, grid, st);
}

}  // extern "C"
