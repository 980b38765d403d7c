// SageAttention forward with a pre-quantized Q and the options of B7-B9
// (masks, varlen segments, sliding window with sinks).  The kernel and its
// design notes are in attention.cuh; attention_ext.cu documents the
// arguments.
#include "attention.cuh"

using namespace sage_attn;

extern "C" {

const char* sage_attn_q8_ext_error_string(int e) {
  if (e == -1) return "unsupported attention configuration (mode, dtype, head_dim or mask)";
  return cudaGetErrorString((cudaError_t)e);
}

// The arguments of sage_attn_fwd_ext with in_dtype = 2 (int8 Q codes) and
// q_scale [B*Hq*Sq] given; k_head_scale, k_row_scale, lmin and fold are
// not read.
int sage_attn_fwd_q8_ext(int qmode, int static_sm, int pv, int in_dtype, int out_dtype, int D,
                         const void* q, const void* k, const void* v, void* o, long long q_sb,
                         long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                         long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                         long long o_sb, long long o_sh, long long o_ss, const float* q_scale,
                         const float* k_scale, const float* k_head_scale, const float* kn_max,
                         const float* v_scale, const float* v_mean, float* lse, float* lmin,
                         int B, int Hq, int Hk, int Sq, int Sk, int kv_len, int causal,
                         float fold, const int8_t* mask, const float* bias, long long m_sb,
                         long long m_sh, long long m_ss, int Hm, const uint8_t* live,
                         const int* q_seg, const int* kv_seg, const int* kv_segpos,
                         const int* qseg_rng, const int* kvseg_rng, const uint8_t* sinkblk,
                         const float* k_row_scale, int window, int sinks, void* stream) {
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  Params p = make_params(q, k, v, o, st, q_scale, k_scale, nullptr, kn_max, v_scale, v_mean,
                         lse, nullptr, Hq, Hk, Sq, Sk, kv_len, causal, fold);
  set_ext(p, mask, bias, m_sb, m_sh, m_ss, Hm, live, q_seg, kv_seg, kv_segpos, qseg_rng,
          kvseg_rng, sinkblk, nullptr, window, sinks);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype != 2 || !q_scale || qmode == Q_FLASH || check_ext(p)) return -1;
  if (out_dtype == 0)
    return Launcher<int8_t, __nv_bfloat16, true>{p, grid, s}.run(qmode, pv, static_sm, D);
  if (out_dtype == 1)
    return Launcher<int8_t, float, true>{p, grid, s}.run(qmode, pv, static_sm, D);
  return -1;
}

}  // extern "C"
