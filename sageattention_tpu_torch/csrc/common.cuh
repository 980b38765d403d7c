// Shared device helpers for the port's hand-written Hopper kernels.
//
// Built with nvcc for sm_90a into shared libraries with a plain C interface
// (see ops/_build.py).  No fast math: the int8 codes must match the plain
// PyTorch versions, so reciprocals, products and roundings that decide a
// code use the IEEE round-to-nearest intrinsics (__fmul_rn, __fdiv_rn),
// which the compiler never contracts into an FMA.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sage {

// Load 8 consecutive elements (16-byte aligned) as f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// int8 code of x: clip(rint(x), -127, 127); rint rounds half to even.
__device__ __forceinline__ float code_i8(float x) {
  return fminf(fmaxf(rintf(x), -127.f), 127.f);
}

__device__ __forceinline__ float warp_sum(float v, int width = 32) {
  for (int o = width / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v, int width = 32) {
  for (int o = width / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v, int width = 32) {
  for (int o = width / 2; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// max of non-negative floats through their int bit patterns (monotone for
// x >= 0); the order of the atomics cannot change the result.
__device__ __forceinline__ void atomic_max_nonneg(float* addr, float v) {
  atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
}

// ---- per-channel statistics over a [S, D] slice, split along the rows ----
// Thread layout shared by the row-wise kernels: D/8 consecutive lanes cover
// one row (8 channels each), so a block of kStatThreads walks
// kStatThreads / (D/8) rows at a time.
constexpr int kStatThreads = 256;
constexpr int kStatRows = 256;  // rows of one slice per stats block

// Every (slice, kStatRows-row chunk) block writes its partial per-channel
// sum / max / min over the true rows r < s_true to
// p*[(bh * gridDim.x + chunk) * D + c].  A second pass reduces the partials
// of a slice in a fixed order, so every reader agrees bit for bit.
template <typename T>
__global__ void __launch_bounds__(kStatThreads)
stats_partial_kernel(const T* __restrict__ x, long long sb, long long sh, long long ss,
                     int H, int s_true, int D, float* __restrict__ psum,
                     float* __restrict__ pmax, float* __restrict__ pmin) {
  __shared__ float red[3][kStatThreads * 8];
  const int bh = blockIdx.y, split = blockIdx.x, nsplit = gridDim.x;
  const int b = bh / H, h = bh % H;
  const int cpr = D / 8, rpi = kStatThreads / cpr;
  const int tr = threadIdx.x / cpr, cg = threadIdx.x % cpr;
  const T* base = x + b * sb + h * sh + cg * 8;
  const int r0 = split * kStatRows;
  const int r1 = min(r0 + kStatRows, s_true);
  float s[8], mx[8], mn[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) { s[i] = 0.f; mx[i] = -3e38f; mn[i] = 3e38f; }
  for (int r = r0 + tr; r < r1; r += rpi) {
    float v[8];
    load8(base + r * ss, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[i] += v[i];
      mx[i] = fmaxf(mx[i], v[i]);
      mn[i] = fminf(mn[i], v[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    red[0][tr * D + cg * 8 + i] = s[i];
    red[1][tr * D + cg * 8 + i] = mx[i];
    red[2][tr * D + cg * 8 + i] = mn[i];
  }
  __syncthreads();
  if (threadIdx.x < D) {
    const int c = threadIdx.x;
    float a = 0.f, hi = -3e38f, lo = 3e38f;
    for (int j = 0; j < rpi; ++j) {
      a += red[0][j * D + c];
      hi = fmaxf(hi, red[1][j * D + c]);
      lo = fminf(lo, red[2][j * D + c]);
    }
    const long long o = ((long long)bh * nsplit + split) * D + c;
    psum[o] = a;
    pmax[o] = hi;
    pmin[o] = lo;
  }
}

// Channel c of slice bh from its nsplit partials, in a fixed order:
// mean = sum * (1 / s_true), amax = max(max - mean, mean - min).
__device__ __forceinline__ void stats_finish(const float* psum, const float* pmax,
                                             const float* pmin, int bh, int nsplit, int D,
                                             int c, float inv_s, float* mean, float* amax) {
  float a = 0.f, hi = -3e38f, lo = 3e38f;
  for (int j = 0; j < nsplit; ++j) {
    const long long o = ((long long)bh * nsplit + j) * D + c;
    a += psum[o];
    hi = fmaxf(hi, pmax[o]);
    lo = fminf(lo, pmin[o]);
  }
  *mean = __fmul_rn(a, inv_s);
  *amax = fmaxf(__fsub_rn(hi, *mean), __fsub_rn(*mean, lo));
}

}  // namespace sage
