// SageAttention forward with the options of B7-B9 (masks, varlen segments,
// sliding window with sinks, per-row K scales): Q quantized inside the
// kernel, and the bf16 flash baseline.  The kernel and its design notes
// are in attention.cuh; this file instantiates its EXT form, which the
// plain sources (attention.cu, attention_q8.cu) never build, so their
// configurations compile exactly as before.
#include "attention.cuh"

using namespace sage_attn;

extern "C" {

const char* sage_attn_ext_error_string(int e) {
  if (e == -1) return "unsupported attention configuration (mode, dtype, head_dim or mask)";
  return cudaGetErrorString((cudaError_t)e);
}

// The arguments of sage_attn_fwd (attention.cu), then: mask (int8 0/1) or
// bias (f32, natural log) [B, Hm, Sq, Sk] with strides m_sb, m_sh, m_ss
// (elements) and Hm in {1, Hq}; live [B, Hm, ceil(Sq/64), ceil(Sk/64)]
// tile liveness (required with mask); q_seg [B, Sq] and kv_seg [B, Sk]
// int32 segment ids with qseg_rng [B, ceil(Sq/64), 2] and kvseg_rng
// [B, ceil(Sk/64), 2] their min and max per 64-row tile; kv_segpos [B, Sk]
// positions in segment with sinkblk [B, ceil(Sk/64)] (per-segment sinks);
// k_row_scale [B*Hq*Sq] (a
// per-row K scale in place of k_head_scale); window and sinks (causal).
int sage_attn_fwd_ext(int qmode, int static_sm, int pv, int in_dtype, int out_dtype, int D,
                      const void* q, const void* k, const void* v, void* o, long long q_sb,
                      long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                      long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                      long long o_sb, long long o_sh, long long o_ss, const float* q_scale,
                      const float* k_scale, const float* k_head_scale, const float* kn_max,
                      const float* v_scale, const float* v_mean, float* lse, float* lmin, int B,
                      int Hq, int Hk, int Sq, int Sk, int kv_len, int causal, float fold,
                      const int8_t* mask, const float* bias, long long m_sb, long long m_sh,
                      long long m_ss, int Hm, const uint8_t* live, const int* q_seg,
                      const int* kv_seg, const int* kv_segpos, const int* qseg_rng,
                      const int* kvseg_rng, const uint8_t* sinkblk,
                      const float* k_row_scale, int window, int sinks, void* stream) {
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  Params p = make_params(q, k, v, o, st, q_scale, k_scale, k_head_scale, kn_max, v_scale,
                         v_mean, lse, lmin, Hq, Hk, Sq, Sk, kv_len, causal, fold);
  set_ext(p, mask, bias, m_sb, m_sh, m_ss, Hm, live, q_seg, kv_seg, kv_segpos, qseg_rng,
          kvseg_rng, sinkblk, k_row_scale, window, sinks);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype != out_dtype || q_scale || check_ext(p)) return -1;
  if (qmode == Q_FLASH) {
    if (static_sm || in_dtype != 0 || k_row_scale) return -1;
    return Launcher<__nv_bfloat16, __nv_bfloat16, true>{p, grid, s}
        .d<Q_FLASH, false, PV_BF16P_BF16V>(D);
  }
  if (in_dtype == 0)
    return Launcher<__nv_bfloat16, __nv_bfloat16, true>{p, grid, s}.run(qmode, pv, static_sm, D);
  if (in_dtype == 1)
    return Launcher<float, float, true>{p, grid, s}.run(qmode, pv, static_sm, D);
  return -1;
}

}  // extern "C"
