// Per-channel statistics (A5) and the int8 quantizer with group, scalar and
// channel scales (A6).
//
// Replace the Pallas kernels `_stats_kernel` (`channel_stats_pallas`) and
// `_quant_kernel` (`_call`, behind `quant_int8_groupwise_pallas` and
// `quant_int8_fixed_pallas`) of sageattention_tpu/ops/quant_pallas.py, and
// their NHD-direct twins (`_stats_kernel_nhd`, `_quant_kernel_nhd`): the
// input is read through (batch, head, row) strides, so an NHD tensor is
// just another view.  Outputs are written HND and contiguous.
//
// A5, over the true rows r < s_true of each [S, D] slice:
//   mean[c] = sum_r x[r, c] * (1 / s_true)
//   amax[c] = max(max_r x - mean, mean - min_r x)
// A6, with y = (x - sub) * fold (sub and fold optional; rows at or past
// the input's length read as x = 0, which pads to the group multiple):
//   group:   scale_g = amax_{rows of g} |y| / 127 (1 if 0), one per group
//   scalar:  one given scale per slice;  channel: one given scale per channel
//   code   = clip(rint(y * (1 / scale)), -127, 127)
//   capmax = max over rows r < lim of scale_row * ||code_row||_2 (group), or
//            ||code_row||_2 (scalar, the scale is folded downstream)
// The order of the operations is the Pallas kernels', with non-contracted
// IEEE intrinsics, so the codes match the plain versions.
//
// What bounds them on the H100: memory.  A5 reads the tensor once (1 byte
// of work per 2 bytes read); A6 reads 2 bytes and writes 1 per element.
// A5 reduces in two launches so that every SM has work at 8 kv heads:
// 256-row partials, then one fixed-order reduce per channel.  A6 gives each
// block 128 rows of one slice (a multiple of every group size), reads them
// twice in group mode (once for the row amaxes, once to quantize; the
// second read comes from L1/L2), and folds capmax across blocks with an
// order-free integer atomicMax.
#include "common.cuh"

namespace {

constexpr int kThreads = sage::kStatThreads;
constexpr int kQRows = 128;  // rows of one slice per quant block

enum Mode { GROUP = 0, SCALAR = 1, CHANNEL = 2 };

__global__ void __launch_bounds__(256)
stats_final_kernel(int nsplit, int D, float inv_s, const float* __restrict__ psum,
                   const float* __restrict__ pmax, const float* __restrict__ pmin,
                   float* __restrict__ mean_out, float* __restrict__ amax_out) {
  const int bh = blockIdx.x, c = threadIdx.x;
  if (c >= D) return;
  float mean, amax;
  sage::stats_finish(psum, pmax, pmin, bh, nsplit, D, c, inv_s, &mean, &amax);
  mean_out[(long long)bh * D + c] = mean;
  amax_out[(long long)bh * D + c] = amax;
}

// 8 consecutive channels of row r as y = (x - sub) * fold; rows r >= S_in
// read as x = 0.
template <typename T>
__device__ __forceinline__ void load_centered(const T* base, long long ss, int r, int S_in,
                                              const float* sub8, bool has_sub, float fold,
                                              bool has_fold, float* y) {
  if (r < S_in) {
    sage::load8(base + r * ss, y);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (has_sub) y[i] = __fsub_rn(y[i], sub8[i]);
    if (has_fold) y[i] = __fmul_rn(y[i], fold);
  }
}

template <typename T, int MODE, bool CAPMAX>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const T* __restrict__ x, long long sb, long long sh, long long ss, int H,
             int S_in, int S_out, int D, int group, float fold, int has_fold,
             const float* __restrict__ sub, const float* __restrict__ scale_in,
             int8_t* __restrict__ out, float* __restrict__ scale_out,
             float* __restrict__ cap_out, int cap_rows) {
  __shared__ float s_ramax[kQRows];
  __shared__ float s_gscale[kQRows];
  __shared__ float s_ginv[kQRows];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int r0 = blockIdx.x * kQRows;
  const int r1 = min(r0 + kQRows, S_out);
  const int cpr = D / 8, rpi = kThreads / cpr;
  const int tr = threadIdx.x / cpr, cg = threadIdx.x % cpr;
  const T* base = x + b * sb + h * sh + cg * 8;
  const bool has_sub = sub != nullptr;
  float sub8[8], inv8[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sub8[i] = has_sub ? sub[(long long)bh * D + cg * 8 + i] : 0.f;
    inv8[i] = 1.f;
  }
  if (MODE == SCALAR) {
    const float inv = __fdiv_rn(1.f, scale_in[bh]);
#pragma unroll
    for (int i = 0; i < 8; ++i) inv8[i] = inv;
  } else if (MODE == CHANNEL) {
#pragma unroll
    for (int i = 0; i < 8; ++i) inv8[i] = __fdiv_rn(1.f, scale_in[(long long)bh * D + cg * 8 + i]);
  }

  if (MODE == GROUP) {
    // pass 1: row amaxes of |y|, then one scale per group
    for (int r = r0 + tr; r < r0 + kQRows; r += rpi) {
      float y[8], a = 0.f;
      load_centered(base, ss, r, S_in, sub8, has_sub, fold, has_fold, y);
#pragma unroll
      for (int i = 0; i < 8; ++i) a = fmaxf(a, fabsf(y[i]));
      a = sage::warp_max(a, cpr);
      if (cg == 0) s_ramax[r - r0] = a;
    }
    __syncthreads();
    const int n_g = kQRows / group;
    if (threadIdx.x < n_g) {
      const int gi = threadIdx.x;
      float a = 0.f;
      for (int j = 0; j < group; ++j) a = fmaxf(a, s_ramax[gi * group + j]);
      const float scale = a > 0.f ? __fmul_rn(a, (float)(1.0 / 127.0)) : 1.f;
      s_gscale[gi] = scale;
      s_ginv[gi] = __fdiv_rn(1.f, scale);
      if (r0 + gi * group < S_out) scale_out[(long long)bh * (S_out / group) + r0 / group + gi] = scale;
    }
    __syncthreads();
  }

  // pass 2 (the only pass for scalar / channel): codes and capmax
  int8_t* obase = out + (long long)bh * S_out * D + cg * 8;
  float capmax = 0.f;
  for (int r = r0 + tr; r < r0 + kQRows; r += rpi) {
    float n2 = 0.f, rs = 1.f;
    if (r < r1) {
      float y[8], c[8];
      load_centered(base, ss, r, S_in, sub8, has_sub, fold, has_fold, y);
      if (MODE == GROUP) {
        const float inv = s_ginv[(r - r0) / group];
        rs = s_gscale[(r - r0) / group];
#pragma unroll
        for (int i = 0; i < 8; ++i) inv8[i] = inv;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = sage::code_i8(__fmul_rn(y[i], inv8[i]));
        n2 += c[i] * c[i];  // exact: integers below 2^24
      }
      char4* dst = reinterpret_cast<char4*>(obase + (long long)r * D);
      dst[0] = make_char4((signed char)c[0], (signed char)c[1], (signed char)c[2], (signed char)c[3]);
      dst[1] = make_char4((signed char)c[4], (signed char)c[5], (signed char)c[6], (signed char)c[7]);
    }
    if (CAPMAX) {
      n2 = sage::warp_sum(n2, cpr);  // every lane of a row runs the same trips
      if (r < r1 && r < cap_rows) capmax = fmaxf(capmax, __fmul_rn(sqrtf(n2), rs));
    }
  }
  if (CAPMAX && cg == 0) sage::atomic_max_nonneg(cap_out + bh, capmax);
}

template <typename T, int MODE>
int launch_mode(bool capmax, dim3 grid, cudaStream_t st, const T* x, long long sb,
                long long sh, long long ss, int H, int S_in, int S_out, int D, int group,
                float fold, int has_fold, const float* sub, const float* scale_in, int8_t* out,
                float* scale_out, float* cap_out, int cap_rows) {
  if (capmax)
    quant_kernel<T, MODE, true><<<grid, kThreads, 0, st>>>(
        x, sb, sh, ss, H, S_in, S_out, D, group, fold, has_fold, sub, scale_in, out,
        scale_out, cap_out, cap_rows);
  else
    quant_kernel<T, MODE, false><<<grid, kThreads, 0, st>>>(
        x, sb, sh, ss, H, S_in, S_out, D, group, fold, has_fold, sub, scale_in, out,
        scale_out, cap_out, cap_rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_quant(int mode, bool capmax, const void* xv, long long sb, long long sh,
                 long long ss, int B, int H, int S_in, int S_out, int D, int group, float fold,
                 int has_fold, const float* sub, const float* scale_in, int8_t* out,
                 float* scale_out, float* cap_out, int cap_rows, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  dim3 grid((S_out + kQRows - 1) / kQRows, B * H);
  if (mode == GROUP)
    return launch_mode<T, GROUP>(capmax, grid, st, x, sb, sh, ss, H, S_in, S_out, D, group,
                                 fold, has_fold, sub, scale_in, out, scale_out, cap_out,
                                 cap_rows);
  if (mode == SCALAR)
    return launch_mode<T, SCALAR>(capmax, grid, st, x, sb, sh, ss, H, S_in, S_out, D, group,
                                  fold, has_fold, sub, scale_in, out, scale_out, cap_out,
                                  cap_rows);
  if (mode == CHANNEL && !capmax)
    return launch_mode<T, CHANNEL>(false, grid, st, x, sb, sh, ss, H, S_in, S_out, D, group,
                                   fold, has_fold, sub, scale_in, out, scale_out, cap_out,
                                   cap_rows);
  return -1;
}

}  // namespace

extern "C" {

const char* sage_quant_error_string(int e) {
  if (e == -1) return "unsupported dtype, head_dim, group or mode for the quant kernels";
  return cudaGetErrorString((cudaError_t)e);
}

// A5.  dtype: 0 = bfloat16, 1 = float32.  D in {64, 128, 256}.  Scratch
// psum / pmax / pmin hold B*H*ceil(s_true/256)*D floats each.
int sage_channel_stats(int dtype, const void* x, long long sb, long long sh, long long ss,
                       int B, int H, int s_true, int D, float inv_s, float* psum, float* pmax,
                       float* pmin, float* mean_out, float* amax_out, void* stream) {
  if (!(D == 64 || D == 128 || D == 256)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((s_true + sage::kStatRows - 1) / sage::kStatRows, B * H);
  if (dtype == 0)
    sage::stats_partial_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), sb, sh, ss, H, s_true, D, psum, pmax, pmin);
  else if (dtype == 1)
    sage::stats_partial_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), sb, sh, ss, H, s_true, D, psum, pmax, pmin);
  else
    return -1;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stats_final_kernel<<<B * H, 256, 0, st>>>((int)grid.x, D, inv_s, psum, pmax, pmin,
                                             mean_out, amax_out);
  return (int)cudaGetLastError();
}

// A6.  mode: 0 = group, 1 = scalar, 2 = channel.  The output holds S_out
// rows (S_in input rows, zero rows after them); group divides 128 and
// S_out.  sub [B*H*D] or null; scale_in [B*H] (scalar) or [B*H*D]
// (channel); scale_out [B*H*S_out/group] (group); cap_out [B*H], zeroed by
// the caller, is the max over rows < cap_rows.
int sage_quant_int8(int mode, int capmax, int dtype, const void* x, long long sb, long long sh,
                    long long ss, int B, int H, int S_in, int S_out, int D, int group,
                    float fold, int has_fold, const float* sub, const float* scale_in,
                    int8_t* out, float* scale_out, float* cap_out, int cap_rows, void* stream) {
  if (!(D == 64 || D == 128 || D == 256)) return -1;
  if (mode == GROUP && (group <= 0 || kQRows % group || S_out % group)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_quant<__nv_bfloat16>(mode, capmax, x, sb, sh, ss, B, H, S_in, S_out, D,
                                       group, fold, has_fold, sub, scale_in, out, scale_out,
                                       cap_out, cap_rows, st);
  if (dtype == 1)
    return launch_quant<float>(mode, capmax, x, sb, sh, ss, B, H, S_in, S_out, D, group, fold,
                               has_fold, sub, scale_in, out, scale_out, cap_out, cap_rows, st);
  return -1;
}

}  // extern "C"
