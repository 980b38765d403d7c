// SageAttention3's FP4 simulation (B4-fp4): the bf16 flash kernel with each
// P tile rounded onto the e2m1 grid at (its row max) / 6 under the online
// softmax, l summing the rounded P.  Replaces the Pallas kernel
// `_attn_kernel` (sageattention_tpu/ops/attention.py) in its `p_sim_fp4`
// configuration (`_round_e2m1_tile`), which ops/lowbit.sageattn3_tiled
// launches.  The kernel and its design notes are in attention.cuh; this
// file instantiates its FP4 form (flash, online, bf16 P and V, head dim 64,
// 128 or 256), which the other sources never build, so their
// configurations compile as before.  What bounds it is B4's bound (the two
// bf16 products and the exp2s); the rounding adds one division, seven
// compares and a product per P element on the FP32 pipes.
#include "attention.cuh"

using namespace sage_attn;

extern "C" {

const char* sage_attn_lowbit_error_string(int e) {
  if (e == -1) return "unsupported e2m1-P attention configuration (flash, bf16, online only)";
  return cudaGetErrorString((cudaError_t)e);
}

// The arguments of sage_attn_fwd (attention.cu), in its flash form only:
// qmode 2, online, pv 1 (bf16 P and V), bfloat16 in and out.
int sage_attn_fwd_fp4(int qmode, int static_sm, int pv, int in_dtype, int out_dtype, int D,
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
  if (qmode != Q_FLASH || static_sm || pv != PV_BF16P_BF16V || in_dtype != 0 || out_dtype != 0)
    return -1;
  return Launcher<__nv_bfloat16, __nv_bfloat16, false, false, true>{p, grid, s}
      .d<Q_FLASH, false, PV_BF16P_BF16V>(D);
}

}  // extern "C"
