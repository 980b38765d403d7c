// One-pass K and V prep for the flagship SageAttention forward (A1, A2).
//
// Replaces the Pallas kernels `_prep_k_kernel` (A1) and `_prep_v_kernel`
// (A2) of sageattention_tpu/ops/quant_pallas.py.  For each (batch, head)
// slice [S, D] of K (or V), over the true rows r < s_true:
//   mean[c]   = sum_r x[r, c] * (1 / s_true)
//   amax[c]   = max(max_r x - mean, mean - min_r x)
//   K: one head scale  = max_c amax[c] / 127 (1 if 0)   [A1]
//   V: a scale per channel = amax[c] / 127 (1 if 0)      [A2]
//   code      = clip(rint((x - mean) * (1 / scale)), -127, 127), every row
//   K only:   capmax = max over true rows of ||code_row||_2
//
// What bounds it on the H100: memory.  It reads S*D bf16 and writes S*D
// int8 per slice, with a handful of flops per element.  The TPU kernel holds
// the whole slice in VMEM (up to 36,864 x 128); an H100 block has 227 KB of
// shared memory and cannot, and one block per slice would leave most of the
// 132 SMs idle at 48 heads.  So the work is split along the rows:
//   1. sage::stats_partial_kernel (common.cuh): every (slice, 256-row chunk) block writes its
//      partial per-channel sum / max / min to a scratch buffer;
//   2. prep_quant_kernel: every block reduces the (few) partials of its
//      slice in a fixed order, so all blocks of a slice agree bit for bit on
//      mean and scale, then quantizes its own chunk and folds its row norms
//      into capmax with an order-free integer atomicMax.
// K is read twice, the second time mostly from the 50 MB L2.
//
// The two-pass prep (A3, A4) replaces `_stats2_kernel` and
// `_quant_kv_kernel` of the same file, which the flagship path takes once a
// padded slice outgrows the one-pass route (ONEPASS_MAX_ELS; HunyuanVideo
// 720p, Llama-3.1-8B at 128K).  There every block of the one-pass quant
// would reduce hundreds of partials, and K no longer stays in the L2; the
// stats are finished once instead:
//   A3  stats2_partial_kernel, one grid over (256-row chunk, B*H, {K, V}),
//       the partials of sage::stats_partial_body; stats2_final_kernel then
//       reduces each slice's partials in a fixed order (two launches, the
//       outputs deterministic), mean = sum * (1 / s_true);
//   A4  quant_kv_kernel, one grid over (256-row chunk, B*H): each block
//       quantizes its K rows at the head scale and its V rows at the channel
//       scales, code = clip(rint((x - mean) * (1 / scale))), every row, and
//       folds its K row norms over rows < s_true into capmax with the
//       order-free integer atomicMax.
// Both are memory-bound passes: A3 reads K and V once, A4 reads them once
// more and writes the int8 codes.
#include "common.cuh"

namespace {

constexpr int kThreads = sage::kStatThreads;
constexpr int kRows = sage::kStatRows;  // rows of one slice handled by one block

template <typename T, bool PER_CHANNEL, bool CAPMAX>
__global__ void __launch_bounds__(kThreads)
prep_quant_kernel(const T* __restrict__ x, long long sb, long long sh, long long ss,
                  int H, int S, int s_true, int D, int nsplit, float inv_s,
                  const float* __restrict__ psum,
                  const float* __restrict__ pmax, const float* __restrict__ pmin,
                  int8_t* __restrict__ out, float* __restrict__ mean_out,
                  float* __restrict__ amax_out, float* __restrict__ cap_out) {
  __shared__ float s_mean[256], s_amax[256], s_inv[256];
  const int bh = blockIdx.y, split = blockIdx.x;
  const int b = bh / H, h = bh % H;
  if (threadIdx.x < D) {
    const int c = threadIdx.x;
    float mean, amax;
    sage::stats_finish(psum, pmax, pmin, bh, nsplit, D, c, inv_s, &mean, &amax);
    s_mean[c] = mean;
    s_amax[c] = amax;
    if (split == 0) {
      mean_out[(long long)bh * D + c] = mean;
      if (PER_CHANNEL) amax_out[(long long)bh * D + c] = amax;
    }
    if (PER_CHANNEL) {
      const float scale = amax > 0.f ? __fmul_rn(amax, (float)(1.0 / 127.0)) : 1.f;
      s_inv[c] = __fdiv_rn(1.f, scale);
    }
  }
  __syncthreads();
  if (!PER_CHANNEL) {
    if (threadIdx.x == 0) {
      float amax = 0.f;  // channel amaxes are >= 0
      for (int c = 0; c < D; ++c) amax = fmaxf(amax, s_amax[c]);
      const float scale = amax > 0.f ? __fmul_rn(amax, (float)(1.0 / 127.0)) : 1.f;
      s_inv[0] = __fdiv_rn(1.f, scale);
      if (split == 0) amax_out[bh] = amax;
    }
    __syncthreads();
  }
  const int cpr = D / 8, rpi = kThreads / cpr;
  const int tr = threadIdx.x / cpr, cg = threadIdx.x % cpr;
  float mean[8], inv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mean[i] = s_mean[cg * 8 + i];
    inv[i] = PER_CHANNEL ? s_inv[cg * 8 + i] : s_inv[0];
  }
  const T* base = x + b * sb + h * sh + cg * 8;
  int8_t* obase = out + (long long)bh * S * D + cg * 8;
  const int r0 = split * kRows;
  const int r1 = min(r0 + kRows, S);
  float capmax = 0.f;
  // every lane of a row group runs the same trip count (rpi divides the
  // block), so the shuffles below see all lanes of the row
  for (int r = r0 + tr; r < r0 + kRows; r += rpi) {
    float n2 = 0.f;
    if (r < r1) {
      float v[8];
      sage::load8(base + r * ss, v);
      char4 lo4, hi4;
      float c[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = sage::code_i8(__fmul_rn(__fsub_rn(v[i], mean[i]), inv[i]));
        n2 += c[i] * c[i];  // exact: integers below 2^24
      }
      lo4 = make_char4((signed char)c[0], (signed char)c[1], (signed char)c[2], (signed char)c[3]);
      hi4 = make_char4((signed char)c[4], (signed char)c[5], (signed char)c[6], (signed char)c[7]);
      char4* dst = reinterpret_cast<char4*>(obase + (long long)r * D);
      dst[0] = lo4;
      dst[1] = hi4;
    }
    if (CAPMAX) {
      n2 = sage::warp_sum(n2, cpr);
      if (r < r1 && r < s_true) capmax = fmaxf(capmax, sqrtf(n2));
    }
  }
  if (CAPMAX && cg == 0) sage::atomic_max_nonneg(cap_out + bh, capmax);
}

template <typename T>
int launch_prep(bool per_channel, bool capmax, const void* x, long long sb, long long sh,
                long long ss, int B, int H, int S, int s_true, int D, float inv_s,
                float* psum, float* pmax, float* pmin, int8_t* out, float* mean_out,
                float* amax_out, float* cap_out, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  dim3 grid_stats((s_true + kRows - 1) / kRows, B * H);
  sage::stats_partial_kernel<T><<<grid_stats, kThreads, 0, st>>>(xt, sb, sh, ss, H, s_true, D, psum,
                                                       pmax, pmin);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int nsplit = (int)grid_stats.x;
  dim3 grid((S + kRows - 1) / kRows, B * H);
  if (per_channel) {
    prep_quant_kernel<T, true, false><<<grid, kThreads, 0, st>>>(
        xt, sb, sh, ss, H, S, s_true, D, nsplit, inv_s, psum, pmax, pmin, out, mean_out, amax_out, cap_out);
  } else if (capmax) {
    prep_quant_kernel<T, false, true><<<grid, kThreads, 0, st>>>(
        xt, sb, sh, ss, H, S, s_true, D, nsplit, inv_s, psum, pmax, pmin, out, mean_out, amax_out, cap_out);
  } else {
    prep_quant_kernel<T, false, false><<<grid, kThreads, 0, st>>>(
        xt, sb, sh, ss, H, S, s_true, D, nsplit, inv_s, psum, pmax, pmin, out, mean_out, amax_out, cap_out);
  }
  return (int)cudaGetLastError();
}

// ---- A3: K and V channel stats ----

// Partials of K (blockIdx.z = 0) or V (1) into part[(z * 3 + {sum, max,
// min}) * n + ...], n = B*H*nsplit*D.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stats2_partial_kernel(const T* __restrict__ k, long long k_sb, long long k_sh, long long k_ss,
                      const T* __restrict__ v, long long v_sb, long long v_sh, long long v_ss,
                      int H, int s_true, int D, float* __restrict__ part) {
  const bool is_v = blockIdx.z != 0;
  const long long n = (long long)gridDim.y * gridDim.x * D;
  float* p = part + (is_v ? 3 : 0) * n;
  sage::stats_partial_body<T>(is_v ? v : k, is_v ? v_sb : k_sb, is_v ? v_sh : k_sh,
                              is_v ? v_ss : k_ss, H, s_true, D, blockIdx.x, gridDim.x,
                              blockIdx.y, p, p + n, p + 2 * n);
}

// Block (bh, z), thread c: channel c's mean and amax of slice bh of K or V.
__global__ void stats2_final_kernel(int nsplit, int D, float inv_s,
                                    const float* __restrict__ part, float* __restrict__ km,
                                    float* __restrict__ ka, float* __restrict__ vm,
                                    float* __restrict__ va) {
  const int bh = blockIdx.x, c = threadIdx.x;
  const bool is_v = blockIdx.y != 0;
  if (c >= D) return;
  const long long n = (long long)gridDim.x * nsplit * D;
  const float* p = part + (is_v ? 3 : 0) * n;
  float mean, amax;
  sage::stats_finish(p, p + n, p + 2 * n, bh, nsplit, D, c, inv_s, &mean, &amax);
  (is_v ? vm : km)[(long long)bh * D + c] = mean;
  (is_v ? va : ka)[(long long)bh * D + c] = amax;
}

// ---- A4: K and V to int8 ----

template <typename T, bool CAPMAX>
__global__ void __launch_bounds__(kThreads)
quant_kv_kernel(const T* __restrict__ k, long long k_sb, long long k_sh, long long k_ss,
                const T* __restrict__ v, long long v_sb, long long v_sh, long long v_ss,
                int H, int S, int s_true, int D, const float* __restrict__ k_scale,
                const float* __restrict__ k_mean, const float* __restrict__ v_scale,
                const float* __restrict__ v_mean, int8_t* __restrict__ k8,
                int8_t* __restrict__ v8, float* __restrict__ cap_out) {
  __shared__ float s_km[256], s_vm[256], s_vinv[256];
  __shared__ float s_kinv;
  const int bh = blockIdx.y, split = blockIdx.x;
  const int b = bh / H, h = bh % H;
  if (threadIdx.x < D) {
    const int c = threadIdx.x;
    s_km[c] = k_mean[(long long)bh * D + c];
    s_vm[c] = v_mean[(long long)bh * D + c];
    s_vinv[c] = __fdiv_rn(1.f, v_scale[(long long)bh * D + c]);
  }
  if (threadIdx.x == 0) s_kinv = __fdiv_rn(1.f, k_scale[bh]);
  __syncthreads();
  const int cpr = D / 8, rpi = kThreads / cpr;
  const int tr = threadIdx.x / cpr, cg = threadIdx.x % cpr;
  float kmean[8], vmean[8], vinv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    kmean[i] = s_km[cg * 8 + i];
    vmean[i] = s_vm[cg * 8 + i];
    vinv[i] = s_vinv[cg * 8 + i];
  }
  const float kinv = s_kinv;
  const T* kb = k + b * k_sb + h * k_sh + cg * 8;
  const T* vb = v + b * v_sb + h * v_sh + cg * 8;
  int8_t* kout = k8 + (long long)bh * S * D + cg * 8;
  int8_t* vout = v8 + (long long)bh * S * D + cg * 8;
  const int r0 = split * kRows;
  const int r1 = min(r0 + kRows, S);
  float capmax = 0.f;
  // every lane of a row group runs the same trip count (rpi divides the
  // block), so the shuffles below see all lanes of the row
  for (int r = r0 + tr; r < r0 + kRows; r += rpi) {
    float n2 = 0.f;
    if (r < r1) {
      float x[8], y[8], ck[8], cv[8];
      sage::load8(kb + r * k_ss, x);
      sage::load8(vb + r * v_ss, y);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ck[i] = sage::code_i8(__fmul_rn(__fsub_rn(x[i], kmean[i]), kinv));
        cv[i] = sage::code_i8(__fmul_rn(__fsub_rn(y[i], vmean[i]), vinv[i]));
        n2 += ck[i] * ck[i];  // exact: integers below 2^24
      }
      char4* kd = reinterpret_cast<char4*>(kout + (long long)r * D);
      char4* vd = reinterpret_cast<char4*>(vout + (long long)r * D);
      kd[0] = make_char4((signed char)ck[0], (signed char)ck[1], (signed char)ck[2], (signed char)ck[3]);
      kd[1] = make_char4((signed char)ck[4], (signed char)ck[5], (signed char)ck[6], (signed char)ck[7]);
      vd[0] = make_char4((signed char)cv[0], (signed char)cv[1], (signed char)cv[2], (signed char)cv[3]);
      vd[1] = make_char4((signed char)cv[4], (signed char)cv[5], (signed char)cv[6], (signed char)cv[7]);
    }
    if (CAPMAX) {
      n2 = sage::warp_sum(n2, cpr);
      if (r < r1 && r < s_true) capmax = fmaxf(capmax, sqrtf(n2));
    }
  }
  if (CAPMAX && cg == 0) sage::atomic_max_nonneg(cap_out + bh, capmax);
}

template <typename T>
int launch_stats2(const void* k, long long k_sb, long long k_sh, long long k_ss, const void* v,
                  long long v_sb, long long v_sh, long long v_ss, int B, int H, int s_true,
                  int D, float inv_s, float* part, float* km, float* ka, float* vm, float* va,
                  cudaStream_t st) {
  const dim3 grid((s_true + kRows - 1) / kRows, B * H, 2);
  stats2_partial_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(k), k_sb, k_sh, k_ss, static_cast<const T*>(v), v_sb, v_sh, v_ss,
      H, s_true, D, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stats2_final_kernel<<<dim3(B * H, 2), 256, 0, st>>>((int)grid.x, D, inv_s, part, km, ka, vm,
                                                       va);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_quant_kv(bool capmax, const void* k, long long k_sb, long long k_sh, long long k_ss,
                    const void* v, long long v_sb, long long v_sh, long long v_ss, int B, int H,
                    int S, int s_true, int D, const float* ks, const float* km,
                    const float* vs, const float* vm, int8_t* k8, int8_t* v8, float* cap,
                    cudaStream_t st) {
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  if (capmax)
    quant_kv_kernel<T, true><<<grid, kThreads, 0, st>>>(kt, k_sb, k_sh, k_ss, vt, v_sb, v_sh,
                                                        v_ss, H, S, s_true, D, ks, km, vs, vm,
                                                        k8, v8, cap);
  else
    quant_kv_kernel<T, false><<<grid, kThreads, 0, st>>>(kt, k_sb, k_sh, k_ss, vt, v_sb, v_sh,
                                                         v_ss, H, S, s_true, D, ks, km, vs, vm,
                                                         k8, v8, cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sage_prep_error_string(int e) {
  if (e == -1) return "unsupported dtype, head_dim or length for the prep kernels";
  return cudaGetErrorString((cudaError_t)e);
}

// dtype: 0 = bfloat16, 1 = float32.  D in {64, 128, 256}.  Scratch psum /
// pmax / pmin hold B*H*ceil(s_true/256)*D floats each; cap_out must be
// zeroed by the caller.  Returns 0 or an error code.
int sage_prep_kv(int per_channel, int capmax, int dtype, const void* x, long long sb,
                 long long sh, long long ss, int B, int H, int S, int s_true, int D,
                 float inv_s, float* psum, float* pmax, float* pmin, int8_t* out,
                 float* mean_out, float* amax_out, float* cap_out, void* stream) {
  if (!(D == 64 || D == 128 || D == 256)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_prep<__nv_bfloat16>(per_channel, capmax, x, sb, sh, ss, B, H, S, s_true, D,
                                      inv_s, psum, pmax, pmin, out, mean_out, amax_out,
                                      cap_out, st);
  if (dtype == 1)
    return launch_prep<float>(per_channel, capmax, x, sb, sh, ss, B, H, S, s_true, D, inv_s,
                              psum, pmax, pmin, out, mean_out, amax_out, cap_out, st);
  return -1;
}

// A3.  dtype: 0 = bfloat16, 1 = float32 (K and V alike).  D in {64, 128,
// 256}.  part holds 6 * B*H*ceil(s_true/256)*D floats; km, ka, vm, va
// [B*H*D] each.
int sage_stats2(int dtype, const void* k, long long k_sb, long long k_sh, long long k_ss,
                const void* v, long long v_sb, long long v_sh, long long v_ss, int B, int H,
                int s_true, int D, float inv_s, float* part, float* km, float* ka, float* vm,
                float* va, void* stream) {
  if (!(D == 64 || D == 128 || D == 256) || s_true <= 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_stats2<__nv_bfloat16>(k, k_sb, k_sh, k_ss, v, v_sb, v_sh, v_ss, B, H, s_true,
                                        D, inv_s, part, km, ka, vm, va, st);
  if (dtype == 1)
    return launch_stats2<float>(k, k_sb, k_sh, k_ss, v, v_sb, v_sh, v_ss, B, H, s_true, D,
                                inv_s, part, km, ka, vm, va, st);
  return -1;
}

// A4.  dtype as above.  ks [B*H]; km, vs, vm [B*H*D]; k8, v8 [B*H*S*D]
// contiguous; cap [B*H], zeroed by the caller, or null without capmax
// (over the rows < s_true).
int sage_quant_kv(int capmax, int dtype, const void* k, long long k_sb, long long k_sh,
                  long long k_ss, const void* v, long long v_sb, long long v_sh, long long v_ss,
                  int B, int H, int S, int s_true, int D, const float* ks, const float* km,
                  const float* vs, const float* vm, int8_t* k8, int8_t* v8, float* cap,
                  void* stream) {
  if (!(D == 64 || D == 128 || D == 256) || (capmax && !cap)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_quant_kv<__nv_bfloat16>(capmax, k, k_sb, k_sh, k_ss, v, v_sb, v_sh, v_ss, B,
                                          H, S, s_true, D, ks, km, vs, vm, k8, v8, cap, st);
  if (dtype == 1)
    return launch_quant_kv<float>(capmax, k, k_sb, k_sh, k_ss, v, v_sb, v_sh, v_ss, B, H, S,
                                  s_true, D, ks, km, vs, vm, k8, v8, cap, st);
  return -1;
}

}  // extern "C"
