// SageAttention forward with Q quantized inside the kernel (B1-B3, B5 with
// a fused Q) and the bf16 flash baseline (B4).  The kernel itself and its
// design notes are in attention.cuh; attention_q8.cu instantiates it for a
// pre-quantized Q.
#include "attention.cuh"

using namespace sage_attn;

extern "C" {

const char* sage_attn_error_string(int e) {
  if (e == -1) return "unsupported attention configuration (mode, dtype or head_dim)";
  return cudaGetErrorString((cudaError_t)e);
}

// qmode: 0 = int8 Q quantized here, 1 = bf16 compute, 2 = flash.
// pv: 0 = bf16 P / int8 V, 1 = bf16 P / bf16 V, 2 = int8 P / int8 V,
// 3 = e4m3 P / e4m3 V.  in_dtype (of q) = out_dtype: 0 = bfloat16,
// 1 = float32 (flash: bfloat16 only).  Strides are in elements of each
// tensor's own type; K is int8 codes unless qmode == 2.
int sage_attn_fwd(int qmode, int static_sm, int pv, int in_dtype, int out_dtype, int D,
                  const void* q, const void* k, const void* v, void* o, long long q_sb,
                  long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                  long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                  long long o_sb, long long o_sh, long long o_ss, const float* q_scale,
                  const float* k_scale, const float* k_head_scale, const float* kn_max,
                  const float* v_scale, const float* v_mean, float* lse, float* lmin, int B,
                  int Hq, int Hk, int Sq, int Sk, int kv_len, int causal, float fold,
                  void* stream) {
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  const Params p = make_params(q, k, v, o, st, q_scale, k_scale, k_head_scale, kn_max, v_scale,
                               v_mean, lse, lmin, Hq, Hk, Sq, Sk, kv_len, causal, fold);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype != out_dtype || q_scale) return -1;
  if (qmode == Q_FLASH) {
    if (static_sm || in_dtype != 0) return -1;
    return Launcher<__nv_bfloat16, __nv_bfloat16>{p, grid, s}
        .d<Q_FLASH, false, PV_BF16P_BF16V>(D);
  }
  if (in_dtype == 0)
    return Launcher<__nv_bfloat16, __nv_bfloat16>{p, grid, s}.run(qmode, pv, static_sm, D);
  if (in_dtype == 1) return Launcher<float, float>{p, grid, s}.run(qmode, pv, static_sm, D);
  return -1;
}

}  // extern "C"
