// SageAttention forward in the ring's configuration (B10): a pre-quantized
// Q (int8 codes with per-row scales) against one K/V chunk of the ring,
// with the causal offsets (q_start, kv_start) and the chunk's true length
// read on the device.  The kernel and its design notes are in
// attention.cuh; this file instantiates its DYN form, which the other
// sources never build, so their configurations compile as before.
#include "attention.cuh"

using namespace sage_attn;

extern "C" {

const char* sage_attn_ring_error_string(int e) {
  if (e == -1) return "unsupported ring attention configuration (mode, dtype or head_dim)";
  return cudaGetErrorString((cudaError_t)e);
}

// The arguments of sage_attn_fwd_q8 (attention_q8.cu), then offsets [2]
// (q_start, kv_start) and kv_true [1], int32 on the device (either may be
// null, not both).
int sage_attn_fwd_ring(int qmode, int static_sm, int pv, int in_dtype, int out_dtype, int D,
                       const void* q, const void* k, const void* v, void* o, long long q_sb,
                       long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                       long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                       long long o_sb, long long o_sh, long long o_ss, const float* q_scale,
                       const float* k_scale, const float* k_head_scale, const float* kn_max,
                       const float* v_scale, const float* v_mean, float* lse, float* lmin,
                       int B, int Hq, int Hk, int Sq, int Sk, int kv_len, int causal,
                       float fold, const int* offsets, const int* kv_true, void* stream) {
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  Params p = make_params(q, k, v, o, st, q_scale, k_scale, nullptr, kn_max, v_scale, v_mean,
                         lse, nullptr, Hq, Hk, Sq, Sk, kv_len, causal, fold);
  p.offsets = offsets;
  p.kv_true = kv_true;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype != 2 || !q_scale || qmode == Q_FLASH || !(offsets || kv_true)) return -1;
  if (out_dtype == 0)
    return Launcher<int8_t, __nv_bfloat16, false, true>{p, grid, s}.run(qmode, pv, static_sm, D);
  if (out_dtype == 1)
    return Launcher<int8_t, float, false, true>{p, grid, s}.run(qmode, pv, static_sm, D);
  return -1;
}

}  // extern "C"
