#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``sageattention_tpu_torch``).

Run from the root of a checkout on a machine with one Hopper card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device: needs CUDA; prints the card's name and power limit;
2. build: compiles the port's CUDA kernels from ``sageattention_tpu_torch/csrc``
   and prints ``ptxas``'s registers and spills of ``flash_sm90.cu``,
   ``attention_sm90.cu``, ``attention_q8_sm90.cu``,
   ``paged_decode_sm90.cu``, ``decode_sm90.cu``, ``backward_sm90.cu`` and
   ``prep_sm90.cu`` (a spill fails the run);
3. main path, with every kernel's launch count set to 0 just before and read
   just after.  At the full widths of CogVideoX1.5 joint attention
   (1, 48, 17776, 64) and a Llama-70B GQA causal prefill (64/8 heads, 16,384
   tokens, hd 128): ``sageattn`` (int8 PV, the default), ``sageattn`` with
   ``pv_dtype="fp8"``, the explicit entries ``sageattn_qk_int8_pv_fp8``,
   its alias ``sageattn_qk_int8_pv_fp8_cuda_sm90``,
   ``sageattn_qk_int8_pv_bf16`` and ``sageattn_qk_int8_pv_int8``, and
   ``flash_attention``; at the CogVideoX shape also the int8-P online
   softmax.  A CogVideoX1.5-width DiT forward (hidden 3072, 48 heads,
   13x60x90 latents, patch 2, 226 text tokens: S = 17,776) cut to 2 of its
   42 blocks, random weights from a seed, with int8 attention, with the
   reference's H100 mode (``pv_dtype="fp8", k_scale_mode="fine"``) and with
   flash.  One-frame (S = 1,576) calls: the short-sequence kernels, fp8 on
   native compute, bf16 PV, a separately quantized Q.  Adversarial (x60)
   inputs whose static softmax must rerun online: post hoc for ``sageattn``,
   by the predictive check for the bf16 and int8 entries;
4. kernels: every kernel against its plain PyTorch version at the main
   path's shapes, with both times, the card's bound for the work and, where
   one PyTorch call computes the same function, that call's time (B4's in
   phase 12);
5. edge cases of the kernels against their plain versions: unaligned
   lengths, f32/f16 inputs, NHD storage seen through strided views, GQA,
   head dim 256 in the prep and quantizers;
6. small inputs of every entry against the float32 oracle;
7. the paths of masks, windows and varlen (B7-B9, A6's segmented mode),
   each counted on its own at published widths: a Mistral-7B-v0.1
   sliding-window prefill (32/8 heads, hd 128, window 4096, S = 16,384,
   with and without four sink tokens; also the reference's H100 mode with
   the window, and with the same band as a bool mask); a packed varlen
   prefill at Llama-3-8B width (sequences of 8192 ... 28 tokens, 16,384 in
   all) with the default, fp8 and window-with-sinks modes and with its
   causal mask as a bool ``attn_mask``, each sequence against its own
   flash, and a 246-token pack of chat prompts (bf16 compute, per-sequence
   K scales); an MPT-7B ALiBi float bias (2, 32, 2048, 128); a left-padded
   Llama-3-8B batch whose pad rows see no key (the static call reruns
   online); a ~25%-live block-sparse keep-mask at the CogVideoX1.5 shape;
   the CogVideoX1.5-width DiT at B = 2 with ragged text through
   ``layered_attention`` over ``sage_joint_attention_ragged``; Mochi-1's
   ragged joint attention (24 heads, 256 + 44,520 tokens).  Then every
   configuration these paths launched against its plain version on sampled
   heads at full length, with its time at the path's shape, the bound over
   the pairs its masks keep, and, for masked flash, one
   ``F.scaled_dot_product_attention`` call with the same mask.  The skip
   ratios (windowed over causal B1, block-sparse over dense B1) must stay
   under 0.7 and 0.6;
8. serving (B11, D1), each path counted on its own: Llama-3-8B at full
   width and depth (random bf16 weights, seed 0) with a dense int8 cache
   (an 8,192-token prompt, 32 greedy steps, a T = 4 verify window) and as
   a continuous batch of 8 paged slots (prompts 4096 ... 256, one frozen
   by ``active`` after step 8); its decode steps run with host
   synchronization made an error; logits against the no-cache forwards;
   prefix caching through ``PrefixCachingAllocator`` at its attention
   width (a 2,048-token shared prompt, a request swapped in midway);
   Mistral-7B-v0.1 (4 of 32 blocks) sliding-window decode with and without
   sinks; the int8/fp8/bf16 caches and pools at kernel scale (B = 8,
   32,768 tokens) with the lse hook and the deferred and staged steps;
   then every B11/D1 configuration against its plain version.  The C
   entries each path called are counted too: the int8 B11 launches at head
   dim 128 go to ``csrc/decode_sm90.cu`` (``sage_decode_sm90``) and none to
   ``csrc/decode.cu``'s entry, which the fp8 and bf16 caches take;
9. training (C1, C2) and the repairs of slice 5, outside inference mode,
   each path counted on its own: head dim 256 at Gemma-7B's attention
   widths (16 heads, hd 256, 8,192 tokens, causal: ``sageattn``, the H100
   mode and flash against the f32 oracle; a B = 1 decode over an 8 K dense
   cache and a paged batch); the T = 9 verify window at (B = 8, 32/8
   heads, 32 K), folded as in JAX, against the unfolded call; a
   Llama-3-8B-width fine-tune (2 of 32 blocks, f32 weights and Adam, B = 1,
   S = 8,192, eight Adam steps) with exact attention (one
   ``F.scaled_dot_product_attention`` call, the oracle), with
   ``sage_dot_product_attention`` (the bf16 backward) and with
   ``quant_backward=True`` (the int8 one): ms per step, losses, the step-0
   gradients against the exact run's; a CogVideoX1.5-width DiT diffusion
   step (2 of 42 blocks) with the int8 and bf16 backward and exact
   attention; Mistral-7B-v0.1 window gradients with 0 and 4 sinks and the
   left-padded Llama-3-8B batch's mask gradients against the f32 exact
   gradient; then every C1/C2 configuration these paths launched against
   ``attention_backward_plain`` on sampled heads, with its time, bound
   and, in bf16, the time of one ``torch.autograd.grad`` through
   ``F.scaled_dot_product_attention`` (flash backend);
10. sequence parallelism (B10; slice 6), each path counted on its own.  The
   card's machine has one card and NCCL takes one rank per card, so the
   n-rank ring runs as n virtual ranks in this process: the ring's own
   per-rank phase functions (``parallel/ring.py``), with its collectives
   done by hand.  10a: CogVideoX1.5 joint attention on 4 and 8 ranks
   (padded: the last shards' device true length, on 8 a shard of padding
   only) with int8 PV (static), fp8 PV (online; within 5e-3 of
   single-device ``sageattn_qk_int8_pv_fp8``, one V^T copy per launch) and,
   on 4, bf16 PV against single-device ``sageattn``; a Llama-3.1-8B
   65,536-token causal prefill (32/8 heads, hd 128) on 4 ranks (device
   offsets), static and, with x60 inputs, the online fallback; the ring's
   time split.  10b: the ring
   backward at Llama-3-8B width (32,768 tokens, causal, 4 ranks: the
   per-pair C1/C2 with a given di and f32 outputs) against single-device
   ``sageattn_qk_int8_pv_bf16``'s gradients.  10c: the CogVideoX1.5-width
   DiT (2 of 42 blocks) with the 4-rank ring as its attention.  10d: the
   public entries through a real NCCL process group of world size 1
   (``ring_sageattn``, ``ulysses_sageattn``, the ``parallel_dit_infer``
   example at CogVideoX1.5 width).  Then every kind of B10 launch these
   paths made (visible, diagonal, hidden chunks; all, part, none real)
   against its plain version on sampled heads;
11. the last TPU kernels (A3, A4, B4-fp4; slice 7), each path counted on
   its own with its exact launch counts.  11a, the two-pass K/V prep that
   ``_sage_attention`` takes past ``ONEPASS_MAX_ELS``: HunyuanVideo joint
   attention at 720p x 129 frames (1, 24, 119,056, 128; its published
   transformer: hidden 3072, 24 heads, patch (1, 2, 2), 256 text tokens)
   with ``sageattn`` (A3 = A4 = 1, A1 = A2 = 0), the H100 mode and flash,
   3 trials of 3 calls each; its DiT cut to 2 blocks (random weights from
   the seed) with int8 attention and flash; a Llama-3.1-8B causal prefill
   at its full context (1, 32/8, 131,072, 128), timed once warm; A3 + A4
   against A1 + A2 on the HunyuanVideo K and V (codes equal, both times).
   11b, SageAttention3's FP4 simulation: ``sageattn3_blackwell`` at
   CogVideoX1.5 and the HunyuanVideo shape (its B4-fp4 launch on
   ``csrc/flash_sm90.cu``) against flash, and on a sampled head against the
   S x S ``sageattn3``; the CogVideoX1.5-width DiT with it as its attention
   (NHD -> HND in the smoke only).  Then A3 and A4 against their plain
   versions on every head and the long B1 launches on sampled heads
   (phase 17 holds the B4-fp4 launches to their plain version).  Phase 5 holds
   A3/A4 at unaligned lengths, f32/f16 inputs and strided NHD views, and
   the two-pass route end to end at a GQA shape against the one-pass call;
12. B4 on its Hopper kernel (``csrc/flash_sm90.cu``; slice 8), each shape
   counted on its own: ``flash_attention`` at CogVideoX1.5, Llama-70B GQA
   causal, Gemma-7B (16 heads, hd 256, 8,192 tokens, causal) and
   HunyuanVideo, flash against the f32 oracle on sampled rows, B4 against
   its plain version on sampled heads (HunyuanVideo: the sampled row blocks
   of the first and last head), its time beside its bound and the
   library's flash call;
   then its edge cases at head dims 64, 128 and 256: lengths off the
   tiles, ``kv_len < Sk``, causal with Sq < Sk, NHD strides, a batch of two
   with sliced heads, a kv length of whole tiles and a one-column tail;
13. C1 and C2 bf16 with no mask and no window on their Hopper kernels
   (``csrc/backward_sm90.cu``; slice 9; head dim 256 stays on
   ``csrc/backward.cu``, the window and bool forms are phase 22's), each
   shape counted on its own (``ptxas``'s report for the source is printed
   after the build, and a spill fails the run):
   ``attention_backward`` from the port's flash forward on realistic inputs
   at the Llama-3-8B-width fine-tune's shape (1, 32/8, 8,192, 128, causal)
   and the CogVideoX1.5 DiT's (1, 48, 17,776, 64); the ring's per-pair form
   (a given di, f32 outputs) on a CogVideoX1.5 chunk pair (5,120 x 5,120)
   and a diagonal Llama-3.1-8B pair (16,384 x 16,384, causal); C1 and C2
   launched on all heads and held to ``attention_backward_plain`` on the
   first and the last q heads, their times beside their bounds and the
   library's backward (one ``torch.autograd.grad`` through
   ``F.scaled_dot_product_attention``).  Then the edge cases at head dims
   64 and 128 on every head: lengths that are odd multiples of 64, Sq !=
   Sk, GQA 4, a batch of two, and a one-row tail through
   ``attention_backward`` against the same call on the CPU.  Phases 9f,
   10b and 10d replay what the training and ring paths launched on the
   same route;
14. B1 on a bf16 Q at head dims 64 and 128 on its Hopper kernel
   (``csrc/attention_sm90.cu``; slice 10) and B4-float at 64 and 128 on
   ``csrc/flash_sm90.cu``'s biased instantiations (``ptxas``'s report for
   both sources is printed after the build, and a spill fails the run),
   each path counted on its own: ``sageattn`` at CogVideoX1.5, Llama-70B GQA causal, HunyuanVideo
   and Llama-3.1-8B at 131,072 tokens causal (one B1 launch each), B1 on
   all heads against its plain version on the sampled heads, its time
   beside its bound; the MPT-7B ALiBi flash (2, 32, 2048, 128, causal)
   through ``attention_call`` against the f32 oracle and its plain
   version, its time beside its bound (the bias tiles a causal launch
   reads) and the library's biased call; then the edge cases of both at
   head dims 64 and 128 on every head (tails off the tiles, ``kv_len <
   Sk``, Sq != Sk, GQA 8/2, causal, NHD strides, sliced heads, a one-row
   tail; for B4-float one bias for all heads, a zero-stride broadcast
   bias, a misaligned one, -inf entries and a row with no live key), and
   x60 inputs through ``sageattn`` whose ``lmin`` makes the call rerun
   online (B2).  The skip ratios of phase 7 time dense B1 on
   ``attention.cuh``'s body, which their masked forms run on;
15. B6 on a pre-quantized Q and the ring's B10 forms of it at head dims 64
   and 128 on their Hopper kernel (``csrc/attention_q8_sm90.cu``; slice
   11), each path counted on its own: ``sageattn(k_scale_mode="fine")``
   (per-column K scales) and ``sageattn(fuse_q_quant=False)`` (the scale
   folded into Q's) at CogVideoX1.5 and Llama-70B GQA causal, the fine
   call with its static check refused (B6-online) at CogVideoX1.5, each
   against flash (cosine >= 0.999) and its launch on all heads against the
   plain version on the first and last q heads; the ring over 4 virtual
   ranks at CogVideoX1.5 and at Llama-3.1-8B 65,536 causal, static and
   with x60 inputs (the online fallback), every kind of their B10-B6
   launches against the plain version; then the edge cases on every head
   at 64 and 128 (a hidden pair, a diagonal and a partly hidden pair, a
   padded chunk with fewer than 64 real rows, a chunk of padding only, an
   unaligned Sk with per-column K scales, GQA, Q groups of 4, 32 and 128
   rows, static and online each).  Its rows replace phases 4's and 10's of
   the same keys;
16. C1 and C2 int8 (the S-recompute) with no mask and no window on their
   Hopper kernels (``csrc/backward_q8_sm90.cu``; slice 12; run beside phase
   13, whose shapes, inputs and checks it repeats with ``quantized=True``):
   ``ptxas``'s report (no spill allowed), ``attention_backward`` at the
   Llama-3-8B-width and CogVideoX1.5 shapes and the ring's two per-pair
   forms, each counted on its own, the kernels on all heads against the
   plain version on the first and last q heads, their times beside their
   bounds and the bf16 pair's on the same inputs, then the edge cases at
   head dims 64 and 128 on every head and the one-row tail against the
   CPU call.  Phases 9f and 10 replay what the training and ring paths
   launched on the same route;
17. B4-fp4 on ``csrc/flash_sm90.cu``'s FP4 mode and B5-fp8 with the ring's
   B10-B5-fp8 forms on ``csrc/attention_q8_sm90.cu``'s e4m3 PV (slice 13),
   each against its plain version within ``KERNEL_BAR``: phase 11b's
   B4-fp4 launches (CogVideoX1.5 on heads 0-1, HunyuanVideo on the sampled
   row blocks of head 0; the plain version walks query-row chunks), causal
   at head dims 64, 128 and 256 (8,192 tokens), then its edge cases on
   every head (``kv_len < Sk``, a ragged Sq, a block whose first warpgroup
   walks fully masked tiles, GQA with NHD strides; how many outputs differ
   is printed); B5-fp8 through ``sageattn_qk_int8_pv_fp8`` at CogVideoX1.5
   and Llama-70B GQA causal, each counted on its own (one launch, one V^T
   copy), held to flash and, on the first and last heads, to the plain
   version, with its time, bound, the V^T copy's time and ``sageattn``'s
   (int8 PV) beside it; the fp8 ring over 4 virtual ranks at CogVideoX1.5
   (padded chunks) and Llama-3.1-8B 65,536 causal (hidden, diagonal and
   visible pairs) against single-device ``sageattn_qk_int8_pv_fp8`` and
   flash, every kind of launch against the plain version; and phase 15's
   edge cases in B5-fp8's forms (a chunk with 40 real rows and one with
   none among them).  Its rows replace phases 4's, 10's and 11's of the
   same keys;
18. B-pvbf16 (int8 QK^T, V in bf16 as given) on ``csrc/attention_q8_sm90.cu``
   (pre-quantized Q, static and online; slice 14) and
   ``csrc/attention_sm90.cu`` (fused Q, static), and D1-int8 on
   ``csrc/paged_decode_sm90.cu``: ``sageattn_qk_int8_pv_bf16`` and
   ``sageattn(pv_dtype="bf16", k_scale_mode="head")`` at CogVideoX1.5 and
   Llama-70B GQA causal, and at CogVideoX1.5 the first with its static
   check refused (B-pvbf16-online), each counted on its own, held to flash
   (cosine >= 0.999) and its launch on all heads to the plain version on
   the sampled heads, with its time, bound and the call's time; then, on
   every head, phase 15's edge cases in B-pvbf16's forms, the ring's padded
   CogVideoX1.5 chunks on 8 ranks (2,416 real rows, and none), the fused
   form's edge cases (lmin too), an fp16 call of the ``_fp16`` alias, and
   D1-int8's (lengths 0, 1, at a page boundary and one past, pages out of
   order, ``emit_state`` with a row that sees no key, T = 4 over GQA heads,
   a sliding window with sinks, 64- and 32-row blocks, MHA).  The ring's
   B10-B-pvbf16 launches are phase 10's and D1's times phase 8's, on the
   same routes.  Its B-pvbf16 rows replace phase 4's of the same keys;
19. (run after phase 7) the masked, windowed and segmented forms of B4 and
   B1 on their Hopper kernels (slice 15), each against its plain version
   on every head at head dims 64, 128 (and 256 for B4);
20. B11 on an int8 V cache on ``csrc/decode_sm90.cu`` (slice 16; phases 8
   and 9b time its launches: the Llama-3-8B step, its T = 4 window, the
   T = 25 window at kernel scale and the folded T = 9 window, one launch
   each): its edge cases at head dims 64 and 128, each launch (one for
   every row) against ``decode_plain`` on every head within
   ``KERNEL_BAR``: lengths 0, 1, a tile boundary and one past it, a bucket
   shorter than the cache, B = 3 with per-sequence V scales and the lse, a
   window longer than the length, folded T = 4 and T = 9 windows, an
   unfolded T = 25 window (2 GQA heads a block), 64 folded rows and 65;
22. (run after phase 16) C1 and C2 bf16 under a window (sinks too) or a
   bool mask on ``csrc/backward_sm90.cu``'s masked kernels (slice 18): at
   9e's shapes (Mistral-7B's W = 4096 window with 0 and 4 sinks, the
   left-padded Llama-3-8B batch), ``attention_backward`` counted on its own
   (``sage_bwd_sm90_masked`` called, ``sage_attn_bwd`` never), the kernels
   on all heads against the plain version on the first and last heads,
   each kernel's own time beside its bound, the call's time with the tile
   lists' glue, the glue alone, the library's backward and
   ``backward.cu``'s time on the same inputs; then the edge cases at head
   dims 64 and 128 on every head (windows of 1, 37 and 200, 70 sinks, a
   tail, GQA 4:1, masks with dead rows and tiles, causal and not, per
   head, a 128 x 128 block-sparse mask) and a tail with f32 outputs through
   ``attention_backward`` against the same call on the CPU.  Its rows are
   the masked keys' (9f checks their launches but leaves the times to it);
23. (run last) A1 and A2 on ``csrc/prep_sm90.cu`` (slice 19; one launch a
   call, each element of K or V read once): ``sageattn`` at CogVideoX1.5,
   Llama-70B GQA and Gemma-7B (16 heads, hd 256, 8,192 tokens), each
   counted on its own, its A1 and A2 calls reaching ``sage_prep_sm90`` and
   never ``sage_prep_kv``; A1 (with and without capmax) and A2 on their K
   and V against the plain versions (codes equal in >= 99.9% of places and
   never more than 1 apart, stats to rtol 1e-5 / atol 1e-6) and, bit for
   bit, ``prep_kv.cu``'s first version, each kernel's device time per call
   beside the first version's, the plain version's and the bound; then the
   largest slices on the route (288 chunks at D = 64, 144 at 128, 72 at
   256, f32 at 64, f32 at 128 with a block for every chunk), one chunk,
   s_true < S with chunks of padding rows only, f16 (widened), NHD views
   and a constant slice.  Its A1/A2 rows replace phase 4's.

Each attention kernel is launched once on all heads of its shape and its
outputs on sampled heads are held to its plain version on those heads (the
plain versions' tile loops run on the host): the first q heads of kv head
0 and the last q head with the last kv head.  Each phase prints its
seconds.  The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

SEED = 0
TPU_KERNELS = {
    "A1": "sageattention_tpu/ops/quant_pallas.py:787",
    "A2": "sageattention_tpu/ops/quant_pallas.py:860",
    "A3": "sageattention_tpu/ops/quant_pallas.py:636",
    "A4": "sageattention_tpu/ops/quant_pallas.py:706",
    "A5": "sageattention_tpu/ops/quant_pallas.py:264",
    "A6": "sageattention_tpu/ops/quant_pallas.py:69",
    "B": "sageattention_tpu/ops/attention.py:251",
    "D1": "sageattention_tpu/ops/paged_decode.py:49",
    "C1": "sageattention_tpu/ops/backward_pallas.py:85",
    "C2": "sageattention_tpu/ops/backward_pallas.py:164",
}
SRC_PREP = "sageattention_tpu_torch/csrc/prep_kv.cu"
SRC_QUANT = "sageattention_tpu_torch/csrc/quant.cu"
SRC_ATTN = "sageattention_tpu_torch/csrc/attention.cuh"
SRC_ATTN_SM90 = "sageattention_tpu_torch/csrc/attention_sm90.cu"
SRC_Q8_SM90 = "sageattention_tpu_torch/csrc/attention_q8_sm90.cu"
COS_BAR = 0.999          # cossim of an int8/bf16-PV mode vs the port's flash
FP8_BAR = 5e-3           # calc_diff of an fp8-PV mode vs flash (e4m3 P carries ~2.5e-3)
ORACLE_BAR = 2e-5        # calc_diff of flash vs the f32 oracle (tests/test_attention.py)
SMALL_SAGE_BAR = 1.5e-3  # calc_diff of an int8/bf16 mode vs the oracle at small S
# int8 P under the online softmax (the JAX package's B5-int8 numerics) rounds
# every p below 1/254 of its row's running max to 0, which long diffuse rows
# feel: 1.8e-2 vs flash at S = 8,192 on these inputs (plain path, CPU).  The
# bar catches gross errors only; the kernel is held to its plain version.
INT8P_BAR = 5e-2
KERNEL_BAR = 1e-5        # calc_diff of an attention kernel vs its plain version
# the skips of slice 3 must pay: a W = 4096 window over S = 16,384 keeps ~44%
# of causal's pairs, a ~25%-live block mask ~25% of dense's
WINDOW_RATIO_BAR = 0.7   # windowed B1 over full-causal B1, Mistral-7B shape
SPARSE_RATIO_BAR = 0.6   # block-sparse B1 over dense B1, CogVideoX1.5 shape
SPARSE_LIVE = 0.25
VARLEN_LENS = (8192, 4096, 2048, 1024, 512, 256, 128, 100, 28)   # 16,384 tokens
# a batch of short chat prompts: 246 tokens, few enough for bf16 compute
CHAT_LENS = (97, 61, 43, 28, 17)
LSE_BAR = 1e-3           # base-2 lse of an attention kernel vs its plain version
# the card's peaks (NVIDIA H100 SXM data sheet, dense) for the bound of each kernel
HBM_BYTES_S = 3.35e12
TC_OPS_S = {"bf16": 989e12, "int8": 1979e12, "fp8": 1979e12}
EX2_S = 16 * 132 * 1.98e9   # exp2 on the SFUs: 16 per clock per SM, 132 SMs, 1.98 GHz
# the launch keys of the main path, in the order of the JSON line
KEYS = ("A1", "A2", "A5", "A6-group", "A6-scalar", "A6-channel", "B1", "B2", "B3",
        "B3-online", "B4", "B5-int8", "B5-fp8", "B5-fp8-fusedq", "B6-static", "B6-online",
        "B6-bf16c", "B-pvbf16", "B-pvbf16-online")
FP8_ENTRIES = ("sageattn fp8", "pv_fp8", "pv_fp8_cuda_sm90")
COG, LLAMA = "CogVideoX1.5 joint attn", "Llama-70B GQA prefill"


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str):
    print(("ok   " if ok else "FAIL ") + what, flush=True)
    if not ok:
        raise SmokeFailure(what)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import sageattention_tpu_torch as st
        from sageattention_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    t_start = time.time()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} ({smi})", flush=True)

    t0 = time.time()
    _build.build_all()
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    for source in ("flash_sm90", "attention_sm90", "attention_q8_sm90", "attention_online_sm90",
                   "paged_decode_sm90", "decode_sm90", "backward_sm90", "prep_sm90"):
        sm90_ptxas(source)   # registers; a spill fails the run

    def timed_phase(what, fn, *args):
        t = time.time()
        out = fn(*args)
        torch.cuda.empty_cache()
        print(f"{what}: {time.time() - t:.1f} s", flush=True)
        return out

    with torch.inference_mode():
        kernels, totals = timed_phase("phases 3-6", run, torch, st)
        kernels += timed_phase("phase 7", run_slice3, torch, st, totals)
        kernels += timed_phase("phase 19", run_masked_sm90, torch, st, totals)
        kernels += timed_phase("phase 8", run_serving, torch, st, totals)
    # training needs autograd: phase 9 runs outside inference mode
    kernels += timed_phase("phase 9", run_training, torch, st, totals)
    kernels += timed_phase("phase 10", run_ring, torch, st, totals)
    fp4_recs = {}   # phase 11b's B4-fp4 launches, held to their plain version in phase 17
    with torch.inference_mode():
        kernels += timed_phase("phase 11", run_slice7, torch, st, totals, fp4_recs)
        kernels += timed_phase("phase 12", run_flash, torch, st, totals)
    # the library's backward, timed beside C1/C2, needs tensors made outside
    # inference mode
    with torch.no_grad():
        kernels += timed_phase("phase 13", run_bwd_sm90, torch, st, totals)
        kernels += timed_phase("phase 16", run_bwd_q8_sm90, torch, st, totals)
        kernels += timed_phase("phase 22", run_bwd_masked_sm90, torch, st, totals)
    # phases 14, 15, 17 and 18's rows replace the earlier ones of their keys
    with torch.inference_mode():
        new = timed_phase("phase 14", run_fwd_sm90, torch, st, totals)
        new += timed_phase("phase 15", run_q8_sm90, torch, st, totals)
        new += timed_phase("phase 17", run_fp4_fp8_sm90, torch, st, totals, fp4_recs)
        new += timed_phase("phase 18", run_pvbf16_d1_sm90, torch, st, totals)
        new += timed_phase("phase 20", run_b11_sm90, torch, st, totals)
        new += timed_phase("phase 21", run_online_sm90, torch, st, totals)
        new += timed_phase("phase 23", run_prep_sm90, torch, st, totals)
    kernels = [e for e in kernels if e["name"] not in {n["name"] for n in new}] + new
    for e in kernels:   # launches over every counted path (a form a key shares: its own)
        e["launches"] = totals.get(e["name"], e["launches"])
    print(f"total: {time.time() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


def realistic_qkv(torch, B, Hq, Hk, S, D, seed):
    """Activation-like bf16 tensors (examples/model_scale_parity.py's recipe):
    correlated q/k, per-head scale spread, a biased K channel."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    base = rn(B, Hk, S, D)
    q = base.repeat_interleave(Hq // Hk, dim=1) + 0.7 * rn(B, Hq, S, D)
    q = q * torch.exp(rn(1, Hq, 1, 1) * 0.4)
    k = base + 0.3 * rn(B, Hk, S, D)
    k[..., 7] += 4.0
    v = rn(B, Hk, S, D)
    return tuple(x.to(torch.bfloat16) for x in (q, k, v))


def counters():
    from sageattention_tpu_torch.ops import backward as tbwd
    from sageattention_tpu_torch.ops import quant_fused as qf
    from sageattention_tpu_torch.ops import quant_kernels as qk
    from sageattention_tpu_torch.ops.attention import attention_call
    from sageattention_tpu_torch.ops.paged_decode import paged_decode_call
    return qf, qk, attention_call, paged_decode_call, tbwd.LAUNCHES


def reset_counts():
    qf, qk, att, pd, bwd = counters()
    qf.prep_k_onepass.launches = qf.prep_v_onepass.launches = qk.channel_stats.launches = 0
    qf.channel_stats2.launches = qf.quant_kv.launches = 0
    qk.quant_int8_groupwise.launches = qk.quant_int8_segmented.launches = 0
    for d in (qk.quant_int8_fixed.launches, att.launches, pd.launches, bwd):
        for name in d:
            d[name] = 0


def read_counts():
    qf, qk, att, pd, bwd = counters()
    return {"A1": qf.prep_k_onepass.launches, "A2": qf.prep_v_onepass.launches,
            "A3": qf.channel_stats2.launches, "A4": qf.quant_kv.launches,
            "A5": qk.channel_stats.launches,
            "A6-group": qk.quant_int8_groupwise.launches,
            "A6-scalar": qk.quant_int8_fixed.launches["scalar"],
            "A6-channel": qk.quant_int8_fixed.launches["channel"],
            "A6-seg": qk.quant_int8_segmented.launches, **att.launches, **pd.launches, **bwd}


def entries(st):
    """The main path's public calls, by name: fn(q, k, v, causal)."""
    from sageattention_tpu_torch import core
    return {
        "sageattn": lambda q, k, v, c: st.sageattn(q, k, v, is_causal=c),
        "sageattn fp8": lambda q, k, v, c: st.sageattn(q, k, v, is_causal=c, pv_dtype="fp8"),
        "pv_fp8": lambda q, k, v, c: st.sageattn_qk_int8_pv_fp8(q, k, v, is_causal=c),
        "pv_fp8_cuda_sm90": lambda q, k, v, c: st.sageattn_qk_int8_pv_fp8_cuda_sm90(
            q, k, v, is_causal=c),
        "pv_bf16": lambda q, k, v, c: st.sageattn_qk_int8_pv_bf16(q, k, v, is_causal=c),
        "pv_int8": lambda q, k, v, c: st.sageattn_qk_int8_pv_int8(q, k, v, is_causal=c),
        "int8 P online": lambda q, k, v, c: core._sage_attention(
            q, k, v, is_causal=c, pv_dtype="int8", softmax_mode="online"),
        "flash": lambda q, k, v, c: st.flash_attention(q, k, v, is_causal=c),
    }


def run(torch, st):
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.models import DiT, DiTConfig, sage_dot_product_attention
    from sageattention_tpu_torch.ops.reference import sdpa
    from sageattention_tpu_torch.utils.testing import attention_tflops, calc_diff, time_fn

    sync = torch.cuda.synchronize
    cases = {
        COG: dict(B=1, Hq=48, Hk=48, S=17776, D=64, causal=False),
        LLAMA: dict(B=1, Hq=64, Hk=8, S=16384, D=128, causal=True),
    }
    fns = entries(st)
    inputs, results = {}, {}

    # ---------------- main path: counted ----------------
    reset_counts()
    for i, (name, c) in enumerate(cases.items()):
        q, k, v = realistic_qkv(torch, c["B"], c["Hq"], c["Hk"], c["S"], c["D"], SEED + i)
        inputs[name] = (q, k, v)
        results[name] = {e: fn(q, k, v, c["causal"]) for e, fn in fns.items()
                         if e != "int8 P online" or name == COG}
        sync()

    cfg = DiTConfig(hidden=3072, heads=48, depth=2, patch=2, in_channels=16,
                    text_dim=4096, text_len=226, frames=13, height=60, width=90,
                    zero_init_gates=False)
    model = DiT(cfg).init_weights(SEED)   # the card is the default device
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    lat = torch.randn(1, cfg.frames, cfg.height, cfg.width, cfg.in_channels,
                      generator=g, device="cuda")
    txt = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device="cuda")
    tt = torch.full((1,), 500, device="cuda", dtype=torch.int32)

    def dit_forward(attn_fn):
        """(output, first-call s, second-call s) with ``attn_fn`` in every block."""
        for b in model.blocks:
            b.attn_fn = attn_fn
        walls = []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            out = model(lat, txt, tt)
            sync()
            walls.append(time.perf_counter() - t0)
        return out, walls[0], walls[1]

    dit = {"int8": dit_forward(sage_dot_product_attention),
           "fp8": dit_forward(functools.partial(sage_dot_product_attention, pv_dtype="fp8",
                                                k_scale_mode="fine")),
           "flash": dit_forward(functools.partial(st.flash_attention, tensor_layout="NHD"))}

    # one latent frame (image generation): 226 + 1350 tokens
    short = realistic_qkv(torch, 1, 48, 48, 1576, 64, SEED + 3)
    short_out = {
        "sageattn": st.sageattn(*short),                        # B3 (bf16 compute)
        "pv_fp8_cuda_sm90": st.sageattn_qk_int8_pv_fp8_cuda_sm90(*short),  # B5-fp8, native
        "pv_bf16": st.sageattn_qk_int8_pv_bf16(*short),         # bf16 V, fused Q
        "unfused Q": st.sageattn(*short, fuse_q_quant=False),   # B6-bf16c
        "flash": st.flash_attention(*short),
    }
    # adversarial magnitudes: the static cap underflows, the call reruns online
    adv, adv_x = {}, {}
    for name, (Hq, Hk, S, D) in {"native": (64, 8, 4096, 128), "short": (48, 48, 1576, 64)}.items():
        g = torch.Generator(device="cuda").manual_seed(SEED + 11)
        adv_x[name] = [(torch.randn(1, h, S, D, generator=g, device="cuda") * 60).to(torch.bfloat16)
                       for h in (Hq, Hk, Hk)]
    adv_calls = {"sageattn native": ("native", "sageattn", "B2"),
                 "sageattn short": ("short", "sageattn", "B3-online"),
                 "pv_bf16 native": ("native", "pv_bf16", "B-pvbf16-online"),
                 "pv_int8 native": ("native", "pv_int8", "B6-online")}
    for name, (xname, entry, _) in adv_calls.items():
        before = read_counts()
        out = fns[entry](*adv_x[xname], False)
        sync()
        adv[name] = (out, before, read_counts())
    sync()
    launches = read_counts()
    print("main-path launches: " + ", ".join(f"{k} {n}" for k, n in launches.items() if n),
          flush=True)

    # ---------------- checks of the main path ----------------
    times = {}
    for name, c in cases.items():
        outs = results[name]
        ref = outs["flash"]
        q, k, v = inputs[name]
        for e, out in outs.items():
            if e == "flash":
                continue
            check(bool(torch.isfinite(out).all()) and out.shape == q.shape,
                  f"{name} {e}: finite output of shape {tuple(out.shape)}")
            d = calc_diff(out, ref)
            if e in FP8_ENTRIES:
                check(d < FP8_BAR, f"{name} {e}: calc_diff vs flash {d:.3e} < {FP8_BAR}")
            elif e == "int8 P online":
                check(d < INT8P_BAR, f"{name} {e}: calc_diff vs flash {d:.3e} < {INT8P_BAR}")
            else:
                check(1.0 - d >= COS_BAR, f"{name} {e}: cossim vs flash {1.0 - d:.6f} >= {COS_BAR}")
        check(torch.equal(outs["pv_fp8"], outs["pv_fp8_cuda_sm90"]),
              f"{name}: the sm90 alias equals sageattn_qk_int8_pv_fp8")
        G = c["Hq"] // c["Hk"]
        d_flash, d_modes = [], {e: [] for e in outs if e != "flash"}
        for h in (0, c["Hq"] - 1):
            o_ref = sdpa(q[:, h:h + 1], k[:, h // G:h // G + 1], v[:, h // G:h // G + 1],
                         is_causal=c["causal"])
            d_flash.append(calc_diff(ref[:, h:h + 1], o_ref))
            for e in d_modes:
                d_modes[e].append(calc_diff(outs[e][:, h:h + 1], o_ref))
        check(max(d_flash) < ORACLE_BAR,
              f"{name}: flash vs f32 oracle on heads 0,{c['Hq'] - 1}: {max(d_flash):.3e} < "
              f"{ORACLE_BAR} (" + ", ".join(f"{e} {max(d):.3e}" for e, d in d_modes.items()) + ")")
        causal = c["causal"]
        tflops = lambda t: attention_tflops(c["B"], c["Hq"], c["S"], c["S"], c["D"],  # noqa: E731
                                            causal, t)
        for e, fn in fns.items():
            if e not in outs:
                continue
            t = time_fn(lambda: fn(q, k, v, causal), warmup=2, reps=10)
            times[(name, e)] = t * 1e3
            print(f"     {name} {tuple(q.shape)} Hk={c['Hk']} causal={causal}: {e} "
                  f"{t * 1e3:.3f} ms ({tflops(t):.1f} TFLOPS-equivalent)", flush=True)

    S_dit = cfg.text_len + cfg.video_tokens
    for mode, (out, _, _) in dit.items():
        check(bool(torch.isfinite(out.float()).all()) and out.shape == lat.shape,
              f"DiT {mode} (CogVideoX1.5 width, 2 of 42 blocks, S={S_dit}): finite output "
              f"{tuple(out.shape)}")
    d = calc_diff(dit["int8"][0], dit["flash"][0])
    check(1.0 - d >= COS_BAR, f"DiT int8: sage vs flash cossim {1.0 - d:.6f} >= {COS_BAR}")
    d = calc_diff(dit["fp8"][0], dit["flash"][0])
    check(d < FP8_BAR, f"DiT fp8 (pv fp8, fine K scales): vs flash calc_diff {d:.3e} < {FP8_BAR}")
    for mode, (_, first, second) in dit.items():
        print(f"     DiT forward wall time, {mode} attention: {second * 1e3:.1f} ms "
              f"(first call {first * 1e3:.1f} ms)", flush=True)
    for e, out in short_out.items():
        if e == "flash":
            continue
        d = calc_diff(out, short_out["flash"])
        if e in FP8_ENTRIES:
            check(d < FP8_BAR, f"one-frame S=1576 {e}: calc_diff vs flash {d:.3e} < {FP8_BAR}")
        else:
            check(1.0 - d >= COS_BAR,
                  f"one-frame S=1576 {e}: cossim vs flash {1.0 - d:.6f} >= {COS_BAR}")

    from sageattention_tpu_torch.ops.attention import attention_kernel
    for name, (xname, entry, fallback) in adv_calls.items():
        out, before, after = adv[name]
        check(after[fallback] > before[fallback],
              f"adversarial x60 ({name}): the static softmax was refused, {fallback} ran")
        check(bool(torch.isfinite(out).all()), f"adversarial x60 ({name}): finite output")
        x = adv_x[xname]
        if entry == "sageattn":
            xs, kw = fused_args(torch, *x, static=False)
            online = attention_kernel(*xs, attn_cfg(torch, fallback, x[0].shape[-1], False), **kw)[0]
        else:   # the same call with the predictive check forced to refuse
            real, core._static_safe = core._static_safe, lambda **kw: False
            try:
                online = fns[entry](*x, False)
            finally:
                core._static_safe = real
        check(torch.equal(out, online),
              f"adversarial x60 ({name}): equals the forced-online {fallback} result")
    for kname in KEYS:
        check(launches[kname] > 0, f"main path launched {kname} {launches[kname]} times")
    check(launches["A3"] == launches["A4"] == 0,
          "main path: CogVideoX1.5 and the Llama-70B prefill take the one-pass prep (A3 0, A4 0)")

    # ---------------- kernels against their plain versions ----------------
    kernels = kernel_checks(torch, inputs, short, adv_x["native"], launches)
    edge_checks(torch)

    # ---------------- small inputs against the oracle ----------------
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    q, k, v = (torch.randn(1, h, 300, 64, generator=g, device="cuda") for h in (4, 2, 2))
    for causal in (False, True):
        o_ref = sdpa(q, k, v, is_causal=causal)
        for e, fn in fns.items():
            d = calc_diff(fn(q, k, v, causal), o_ref)
            bar = ORACLE_BAR if e == "flash" else FP8_BAR if e in FP8_ENTRIES else SMALL_SAGE_BAR
            check(d < bar, f"small {e} (causal={causal}) vs oracle {d:.3e} < {bar}")

    print("     sageattn int8 PV vs pv_dtype='fp8' (the dispatch choice): " + "; ".join(
        f"{n}: int8 {times[(n, 'sageattn')]:.3f} ms, fp8 {times[(n, 'sageattn fp8')]:.3f} ms"
        for n in cases), flush=True)
    return kernels, dict(launches)


# ------------------------------------------------------- slice 3 paths ----

class Recorder:
    """Keeps the inputs of the first launch of every attention configuration
    (forward, decode, and the backward entry, whose one call launches C1 and
    C2) while a counted path runs, so that the kernel checks replay exactly
    what the path launched."""

    def __init__(self, seen, entries=None):
        self.seen = seen
        self.entries = {} if entries is None else entries   # C entry -> calls

    def __enter__(self):
        from sageattention_tpu_torch.ops import _build
        from sageattention_tpu_torch.ops import attention as tatt
        from sageattention_tpu_torch.ops import backward as tbwd
        from sageattention_tpu_torch.ops import paged_decode as tpd

        def bwd_keys(a, kw):   # one call of the entry launches C1 and C2
            return [tbwd.config_name(c, kw.get("quantized", False), kw["is_causal"],
                                     kw.get("window", 0), kw.get("attn_mask") is not None)
                    for c in ("C1", "C2")]

        self.patched = [(tatt, "attention_kernel",
                         lambda a, kw: tatt.config_name(a[3], a[0].shape[2])),
                        (tatt, "decode_kernel",
                         lambda a, kw: tatt.config_name(a[3], a[0].shape[2])),
                        (tpd, "paged_decode_kernel", lambda a, kw: tpd.config_name(
                            a[3].dtype, kw["window"], kw.get("win_lo") is not None,
                            kw.get("sinks", 0), kw.get("emit_state", False))),
                        (tbwd, "attention_backward", bwd_keys)]
        self.reals = []
        for mod, attr, key in self.patched:
            real = getattr(mod, attr)
            self.reals.append(real)

            def record(*args, _real=real, _key=key, **kw):
                keys = _key(args, kw)
                for k in keys if isinstance(keys, list) else [keys]:
                    self.seen.setdefault(k, (args, kw))
                return _real(*args, **kw)

            setattr(mod, attr, record)
        self.build, self.real_call = _build, _build.call

        def call(fn, *args, _real=_build.call):   # the C entries the wrappers launch
            self.entries[fn] = self.entries.get(fn, 0) + 1
            return _real(fn, *args)

        _build.call = call
        return self

    def __exit__(self, *exc):
        for (mod, attr, _), real in zip(self.patched, self.reals):
            setattr(mod, attr, real)
        self.build.call = self.real_call


def counted_path(torch, name, expect, seen, totals, fn, entries=None):
    """Runs one path with every launch count set to 0 just before and read
    just after; checks that each kernel of ``expect`` ran and adds the
    counts to ``totals``; ``entries`` maps C entries to whether the path
    must call them or must not.  Returns the path's result and the inputs
    of its launches by configuration (also merged into ``seen``, first
    wins)."""
    reset_counts()
    rec, called = {}, {}
    with Recorder(rec, called):
        out = fn()
        torch.cuda.synchronize()
    counts = read_counts()
    for key, val in rec.items():
        seen.setdefault(key, val)
    print(f"{name} launches: " + ", ".join(f"{k} {n}" for k, n in counts.items() if n),
          flush=True)
    for key in expect:
        check(counts.get(key, 0) > 0, f"{name}: launched {key} {counts.get(key, 0)} times")
    if entries:
        print(f"{name} C entries: " + ", ".join(f"{k} {n}" for k, n in sorted(called.items())),
              flush=True)
        for fn, want in entries.items():
            n = called.get(fn, 0)
            check((n > 0) == want, f"{name}: called {fn} {n} times ({'some' if want else 'none'} "
                                   f"expected)")
    for key, n in counts.items():
        totals[key] = totals.get(key, 0) + n
    return out, rec


def masked_oracle(torch, q, k, v, keep_fn=None, bias=None, chunk=1024):
    """f32 attention of one head ``[S, D]`` on the card (TF32 off) with a
    keep-mask ``keep_fn(r0, r1) -> [rows, Sk]`` and/or a bias ``[S, Sk]``."""
    from sageattention_tpu_torch.ops.reference import _no_tf32
    q, k, v = (x.float() for x in (q, k, v))
    outs = []
    with _no_tf32():
        for r0 in range(0, q.shape[0], chunk):
            r1 = min(q.shape[0], r0 + chunk)
            s = q[r0:r1] @ k.T * q.shape[-1] ** -0.5
            if bias is not None:
                s = s + bias[r0:r1].float()
            if keep_fn is not None:
                s = s.masked_fill(~keep_fn(r0, r1), float("-inf"))
            outs.append(torch.softmax(s, dim=-1) @ v)
    return torch.cat(outs)


def band_keep(torch, window, sinks, Sk):
    def keep(r0, r1):
        r = torch.arange(r0, r1, device="cuda")[:, None]
        c = torch.arange(Sk, device="cuda")[None, :]
        return (c <= r) & ((c >= r - window + 1) | (c < sinks))
    return keep


def flash_cfg(torch, D, causal, **kw):
    from sageattention_tpu_torch.ops.attention import AttnConfig
    return AttnConfig(causal=causal, quantized=False, sm_scale=D ** -0.5, emit_lse=False, **kw)


def check_vs(name, out, ref, kind):
    from sageattention_tpu_torch.utils.testing import calc_diff
    d = calc_diff(out, ref)
    if kind == "fp8":
        check(d < FP8_BAR, f"{name}: calc_diff {d:.3e} < {FP8_BAR}")
    else:
        check(1.0 - d >= COS_BAR, f"{name}: cossim {1.0 - d:.6f} >= {COS_BAR}")


def window_phase(torch, st, seen, totals, ratios):
    """Mistral-7B-v0.1 sliding-window prefill: 32 q / 8 kv heads, hd 128,
    window 4096 (its config.json), S = 16,384, causal; with and without
    StreamingLLM's four sink tokens."""
    from sageattention_tpu_torch.utils.testing import calc_diff, time_fn
    H, Hk, S, D, W = 32, 8, 16384, 128, 4096
    q, k, v = realistic_qkv(torch, 1, H, Hk, S, D, SEED + 21)
    calls = {"sageattn causal": lambda: st.sageattn(q, k, v, is_causal=True),
             "flash causal": lambda: st.flash_attention(q, k, v, is_causal=True)}
    for sinks in (0, 4):
        tag = f"W={W}" + (f" sinks={sinks}" if sinks else "")
        kw = dict(is_causal=True, sliding_window=W, attention_sinks=sinks)
        calls[f"sageattn {tag}"] = functools.partial(st.sageattn, q, k, v, **kw)
        calls[f"sageattn fp8 {tag}"] = functools.partial(st.sageattn, q, k, v, pv_dtype="fp8", **kw)
        calls[f"flash {tag}"] = functools.partial(st.flash_attention, q, k, v, **kw)
    # the reference's H100 mode (pre-quantized Q, fine K scales, e4m3 PV) with
    # the window, and with the same band given as a bool keep-mask
    band = band_keep(torch, W, 0, S)(0, S)[None, None]             # [1, 1, S, S]
    calls[f"sageattn fp8 fine W={W}"] = functools.partial(
        st.sageattn, q, k, v, is_causal=True, sliding_window=W, pv_dtype="fp8",
        k_scale_mode="fine")
    calls[f"pv_fp8 band mask W={W}"] = functools.partial(
        st.sageattn_qk_int8_pv_fp8, q, k, v, is_causal=True, attn_mask=band)
    outs, rec = counted_path(torch, "Mistral-7B window", ("B1-window", "B4-window",
                                                          "B5-fp8-fusedq-window", "B5-fp8-window",
                                                          "B5-fp8-bool"),
                             seen, totals, lambda: {n: f() for n, f in calls.items()})
    for sinks in (0, 4):
        tag = f"W={W}" + (f" sinks={sinks}" if sinks else "")
        ref = outs[f"flash {tag}"]
        for e in ("sageattn", "sageattn fp8") + (("sageattn fp8 fine", "pv_fp8 band mask")
                                                 if not sinks else ()):
            out = outs[f"{e} {tag}"]
            check(bool(torch.isfinite(out).all()) and out.shape == q.shape,
                  f"Mistral-7B {e} {tag}: finite output {tuple(out.shape)}")
            check_vs(f"Mistral-7B {e} {tag} vs windowed flash", out, ref,
                     "fp8" if "fp8" in e else "cos")
        d = max(calc_diff(ref[:, h:h + 1], masked_oracle(
            torch, q[0, h], k[0, h // (H // Hk)], v[0, h // (H // Hk)],
            band_keep(torch, W, sinks, S)))
                for h in (0, H - 1))
        check(d < ORACLE_BAR, f"Mistral-7B windowed flash {tag} vs f32 oracle on heads 0,{H - 1}: "
                              f"{d:.3e} < {ORACLE_BAR}")
    for name, fn in calls.items():
        t = time_fn(fn, warmup=1, reps=5) * 1e3
        print(f"     Mistral-7B (1,{H}/{Hk},{S},{D}) causal: {name} {t:.3f} ms", flush=True)
    del band
    kernel_ratio(torch, rec, "B1-window", "B1", ratios, "window_B1", WINDOW_RATIO_BAR)
    kernel_ratio(torch, rec, "B4-window", "B4", ratios, "window_B4", None)


def kernel_ratio(torch, seen, key, base, ratios, label, bar):
    """Kernel time of ``key`` over ``base`` on the inputs the path gave them,
    timed in turns in one call, each on the kernel its route picks: the
    Hopper kernels for both (``attention_sm90.cu`` for dense B1 and its
    masked forms, ``flash_sm90.cu`` for B4's).  As information,
    dense B1 on ``attention.cuh``'s body (:func:`on_old_body`), the
    baseline of these ratios before the masked forms moved to the Hopper
    kernels."""
    from sageattention_tpu_torch.ops.attention import attention_kernel
    from sageattention_tpu_torch.utils.testing import time_fn
    ts = {}
    runs = [(base, None), (key, None)] + (
        [("B1 on attention.cuh", on_old_body)] if base == "B1" else [])
    for _ in range(2):
        for name, wrap in runs:
            args, kw = seen[name.split()[0]]
            timed = lambda: time_fn(lambda: attention_kernel(*args, **kw),  # noqa: E731
                                    warmup=2, reps=10) * 1e3
            ts.setdefault(name, []).append(wrap(timed) if wrap else timed())
    t = {name: min(v) for name, v in ts.items()}
    a, b = t[key], t[base]
    ratios[label] = dict(t, ratio=a / b)
    print(f"     {key} {a:.3f} ms vs {base} {b:.3f} ms on the same inputs, both on their Hopper "
          f"kernels: ratio {a / b:.3f}", flush=True)
    if base == "B1":
        c = t["B1 on attention.cuh"]
        print(f"     (dense B1 on attention.cuh {c:.3f} ms: {key} over it {a / c:.3f})",
              flush=True)
    if bar is not None:
        check(a / b < bar, f"{key} / {base} (Hopper) = {a / b:.3f} < {bar}")


def on_old_body(fn):
    """``fn()`` with B1 sent to ``attention.cuh``'s body (the route to
    ``attention_sm90.cu`` turned off for the call)."""
    from sageattention_tpu_torch.ops import attention as tatt
    real = tatt.b1_sm90_route
    tatt.b1_sm90_route = lambda *a: False
    try:
        return fn()
    finally:
        tatt.b1_sm90_route = real


def varlen_phase(torch, st, seen, totals):
    """Packed varlen prefill at Llama-3-8B width: 32/8 heads, hd 128,
    causal, nine sequences of 8192 ... 28 tokens (16,384 in all); the same
    pack with its causal mask given as a bool ``attn_mask`` (Q quantized
    apart from the kernel); and a pack of five chat prompts (246 tokens)
    short enough for bf16 compute with per-segment K scales."""
    from sageattention_tpu_torch.utils.testing import calc_diff, time_fn
    H, Hk, D = 32, 8, 128
    lens = VARLEN_LENS
    T = sum(lens)
    q, k, v = (x[0].transpose(0, 1) for x in realistic_qkv(torch, 1, H, Hk, T, D, SEED + 22))
    cu = cu_seqlens(torch, lens)
    tril = torch.ones(T, T, dtype=torch.bool, device="cuda").tril_()[None]   # [1, T, T]
    calls = {"default": dict(is_causal=True), "fp8": dict(is_causal=True, pv_dtype="fp8"),
             "window 4096 sinks 4": dict(is_causal=True, sliding_window=4096,
                                         attention_sinks=4),
             "causal bool attn_mask": dict(attn_mask=tril)}
    outs, _ = counted_path(torch, "Llama-3-8B varlen", ("A5", "A6-seg", "A6-channel", "B1-colk-seg",
                                                     "B5-fp8-fusedq-colk-seg",
                                                     "B1-colk-seg-window", "B5-int8-bool-seg"),
                           seen, totals,
                           lambda: {n: st.sageattn_varlen(q, k, v, cu, cu, **kw)
                                    for n, kw in calls.items()})
    for name, kw in calls.items():
        out = outs[name]
        check(bool(torch.isfinite(out).all()) and out.shape == q.shape,
              f"varlen {name}: finite output {tuple(out.shape)}")
        for i, L in enumerate(lens):
            a, b = cu[i].item(), cu[i + 1].item()
            ref = st.flash_attention(q[None, a:b], k[None, a:b], v[None, a:b], tensor_layout="NHD",
                                     is_causal=True, sliding_window=kw.get("sliding_window", 0),
                                     attention_sinks=kw.get("attention_sinks", 0))
            what = f"varlen {name} segment {i} (length {L}) vs its own flash"
            if "attn_mask" in kw:   # a mask takes the online softmax: int8 P (B5-int8)
                d = calc_diff(out[None, a:b], ref)
                check(d < INT8P_BAR, f"{what}: calc_diff {d:.3e} < {INT8P_BAR}")
            else:
                check_vs(what, out[None, a:b], ref, "fp8" if name == "fp8" else "cos")
    for name, kw in calls.items():
        t = time_fn(lambda: st.sageattn_varlen(q, k, v, cu, cu, **kw), warmup=1, reps=5) * 1e3
        print(f"     Llama-3-8B varlen ({T} tokens, {len(lens)} sequences) {name}: {t:.3f} ms",
              flush=True)
    del tril

    # chat prompts: the pack is too short for native compute (bf16 compute,
    # one K scale per sequence and head folded into its query rows)
    lens = CHAT_LENS
    T = sum(lens)
    q, k, v = (x[0].transpose(0, 1) for x in realistic_qkv(torch, 1, H, Hk, T, D, SEED + 29))
    cu = cu_seqlens(torch, lens)
    out, _ = counted_path(torch, "Llama-3-8B chat pack", ("A5", "B3-rowk-seg"), seen, totals,
                          lambda: st.sageattn_varlen(q, k, v, cu, cu, is_causal=True))
    check(bool(torch.isfinite(out).all()) and out.shape == q.shape,
          f"chat pack ({T} tokens): finite output {tuple(out.shape)}")
    for i, L in enumerate(lens):
        a, b = cu[i].item(), cu[i + 1].item()
        ref = st.flash_attention(q[None, a:b], k[None, a:b], v[None, a:b], tensor_layout="NHD",
                                 is_causal=True)
        check_vs(f"chat pack segment {i} (length {L}) vs its own flash", out[None, a:b], ref,
                 "cos")
    t = time_fn(lambda: st.sageattn_varlen(q, k, v, cu, cu, is_causal=True), warmup=1,
                reps=10) * 1e3
    print(f"     Llama-3-8B chat pack ({T} tokens, {len(lens)} sequences): {t:.3f} ms",
          flush=True)


def cu_seqlens(torch, lens):
    return torch.tensor([0] + [sum(lens[:i + 1]) for i in range(len(lens))],
                        dtype=torch.int32, device="cuda")


def mask_phase(torch, st, seen, totals, ratios):
    """User masks: an MPT-7B ALiBi bias, a left-padded Llama-3-8B batch,
    and a ~25%-live block-sparse mask at the CogVideoX1.5 shape."""
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops.attention import attention_call
    from sageattention_tpu_torch.utils.testing import calc_diff, time_fn

    # MPT-7B: 32 heads, hd 128, ALiBi slopes 2^(-8(h+1)/32), causal, S = 2048
    B, H, S, D = MPT_7B
    q, k, v = realistic_qkv(torch, B, H, H, S, D, SEED + 23)
    bias = alibi_bias(torch, B, H, S)                             # f32, 1 GiB
    calls = {   # S < 4096: the int8 modes take bf16 compute (B3), fp8 stays native
        "sageattn (auto: online)": lambda: st.sageattn(q, k, v, is_causal=True, attn_mask=bias),
        "sageattn static": lambda: core._sage_attention(
            q, k, v, is_causal=True, attn_mask=bias, pv_dtype="int8", k_scale_mode="head",
            softmax_mode="static"),
        "sageattn fp8": lambda: st.sageattn(q, k, v, is_causal=True, attn_mask=bias,
                                            pv_dtype="fp8"),
        "flash": lambda: attention_call(q, k, v, attn_mask=bias,
                                        cfg=flash_cfg(torch, D, True, masked="float"))[0],
    }
    outs, _ = counted_path(torch, "MPT-7B ALiBi", ("B3-online-float", "B3-float", "B4-float",
                                                   "B5-fp8-fusedq-float"), seen, totals,
                           lambda: {n: f() for n, f in calls.items()})
    ref = outs["flash"]
    for name, kind in (("sageattn (auto: online)", "cos"), ("sageattn static", "cos"),
                       ("sageattn fp8", "fp8")):
        check_vs(f"MPT-7B ALiBi {name} vs biased flash", outs[name], ref, kind)
    causal_keep = band_keep(torch, S, 0, S)
    d = max(calc_diff(ref[b, h], masked_oracle(torch, q[b, h], k[b, h], v[b, h], causal_keep,
                                               bias[b, h]))
            for b, h in ((0, 0), (1, H - 1)))
    check(d < ORACLE_BAR, f"MPT-7B biased flash vs f32 oracle on 2 heads: {d:.3e} < {ORACLE_BAR}")
    for name, fn in calls.items():
        t = time_fn(fn, warmup=1, reps=5) * 1e3
        print(f"     MPT-7B ALiBi ({B},{H},{S},{D}) causal: {name} {t:.3f} ms", flush=True)
    del bias

    # a left-padded Llama-3-8B-width batch: its pad query rows see no key
    B, H, Hk, S, D = 4, 32, 8, 4096, 128
    lens = torch.tensor([4096, 3072, 1536, 512], device="cuda")
    q, k, v = realistic_qkv(torch, B, H, Hk, S, D, SEED + 24)
    pad = S - lens
    keep = (torch.arange(S, device="cuda")[None, None, None, :] >= pad[:, None, None, None])
    keep = keep.expand(B, 1, S, S).contiguous()
    calls = {"sageattn": lambda: st.sageattn(q, k, v, is_causal=True, attn_mask=keep),
             "flash": lambda: attention_call(q, k, v, attn_mask=keep,
                                             cfg=flash_cfg(torch, D, True, masked="bool"))[0]}
    outs, _ = counted_path(torch, "Llama-3-8B left-padded batch",
                        ("B1-bool", "B2-bool", "B4-bool"), seen, totals,
                        lambda: {n: f() for n, f in calls.items()})
    check(bool(torch.isfinite(outs["sageattn"]).all()),
          "left-padded batch: finite output, rows without a live key included")
    for b in range(B):
        p0 = int(pad[b])
        check_vs(f"left-padded row {b} (prompt {int(lens[b])}) vs masked flash",
                 outs["sageattn"][b, :, p0:], outs["flash"][b, :, p0:], "cos")
    for name, fn in calls.items():
        t = time_fn(fn, warmup=1, reps=5) * 1e3
        print(f"     Llama-3-8B left-padded ({B},{H}/{Hk},{S},{D}): {name} {t:.3f} ms", flush=True)
    del keep

    # ~25%-live 128x128 block-sparse keep-mask at the CogVideoX1.5 shape
    B, H, S, D = 1, 48, 17776, 64
    q, k, v = realistic_qkv(torch, B, H, H, S, D, SEED + 25)
    nb = -(-S // 128)
    g = torch.Generator(device="cuda").manual_seed(SEED + 26)
    blocks = torch.rand(nb, nb, generator=g, device="cuda") < SPARSE_LIVE
    blocks |= torch.eye(nb, dtype=torch.bool, device="cuda")     # no row without a key
    keep = blocks.repeat_interleave(128, 0).repeat_interleave(128, 1)[:S, :S][None, None]
    live = float(keep.float().mean())
    calls = {"sageattn sparse": lambda: st.sageattn(q, k, v, attn_mask=keep),
             "sageattn dense": lambda: st.sageattn(q, k, v),
             "flash sparse": lambda: attention_call(q, k, v, attn_mask=keep,
                                                    cfg=flash_cfg(torch, D, False, masked="bool"))[0]}
    outs, rec = counted_path(torch, f"CogVideoX1.5 block-sparse ({live:.3f} live)",
                        ("B1-bool", "B1", "B4-bool"), seen, totals,
                        lambda: {n: f() for n, f in calls.items()})
    check_vs("block-sparse sageattn vs masked flash", outs["sageattn sparse"],
             outs["flash sparse"], "cos")
    d = calc_diff(outs["flash sparse"][0, 0], masked_oracle(
        torch, q[0, 0], k[0, 0], v[0, 0], lambda r0, r1: keep[0, 0, r0:r1]))
    check(d < ORACLE_BAR, f"block-sparse flash vs f32 oracle on head 0: {d:.3e} < {ORACLE_BAR}")
    for name, fn in calls.items():
        t = time_fn(fn, warmup=1, reps=5) * 1e3
        print(f"     CogVideoX1.5 (1,48,{S},64) {name}: {t:.3f} ms", flush=True)
    kernel_ratio(torch, rec, "B1-bool", "B1", ratios, "sparse_B1", SPARSE_RATIO_BAR)


def ragged_dit_phase(torch, st, seen, totals):
    """The CogVideoX1.5-width DiT (2 of 42 blocks) at B = 2 with padded
    text prompts of 226 and 77 valid tokens: the first block runs the
    ragged joint attention, the last is skipped to the exact flash."""
    from sageattention_tpu_torch.models import (DiT, DiTConfig, layered_attention,
                                                sage_joint_attention_ragged)
    from sageattention_tpu_torch.utils.testing import calc_diff
    cfg = DiTConfig(hidden=3072, heads=48, depth=2, patch=2, in_channels=16, text_dim=4096,
                    text_len=226, frames=13, height=60, width=90, zero_init_gates=False)
    B, valid = 2, (226, 77)
    tmask = torch.tensor([[i < n for i in range(cfg.text_len)] for n in valid], device="cuda")

    def ragged(q, k, v, *a, **kw):
        return sage_joint_attention_ragged(q, k, v, tmask)

    def exact(q, k, v, *a, **kw):   # flash over each row's real tokens
        out = torch.zeros_like(q)
        for b, n in enumerate(valid):
            idx = torch.cat([torch.arange(n, device="cuda"),
                             torch.arange(cfg.text_len, q.shape[1], device="cuda")])
            out[b, idx] = st.flash_attention(q[b:b + 1, idx], k[b:b + 1, idx], v[b:b + 1, idx],
                                             tensor_layout="NHD")[0].to(q.dtype)
        return out

    model = DiT(cfg, attn_fn=layered_attention(default_fn=ragged,
                                                  skip_layers=(cfg.depth - 1,)),
                device="cuda").init_weights(SEED)
    g = torch.Generator(device="cuda").manual_seed(SEED + 27)
    lat = torch.randn(B, cfg.frames, cfg.height, cfg.width, cfg.in_channels, generator=g,
                      device="cuda")
    txt = torch.randn(B, cfg.text_len, cfg.text_dim, generator=g, device="cuda")
    tt = torch.full((B,), 500, device="cuda", dtype=torch.int32)
    t0 = time.perf_counter()
    out, _ = counted_path(torch, "ragged DiT", ("B1-colk-seg", "A6-seg", "B4"), seen, totals,
                          lambda: model(lat, txt, tt))
    wall = time.perf_counter() - t0
    model.blocks[0].attn_fn = exact
    ref = model(lat, txt, tt)
    check(bool(torch.isfinite(out.float()).all()) and out.shape == lat.shape,
          f"ragged DiT (B=2, valid text 226/77, S={cfg.text_len + cfg.video_tokens}): finite "
          f"output {tuple(out.shape)}")
    d = calc_diff(out, ref)
    check(1.0 - d >= COS_BAR, f"ragged DiT vs per-row exact attention: cossim {1.0 - d:.6f} "
                              f">= {COS_BAR}")
    print(f"     ragged DiT forward wall time (first call): {wall * 1e3:.1f} ms", flush=True)


def mochi_phase(torch, st, seen, totals):
    """Mochi-1 joint attention with ragged text: B = 2, 24 heads, hd 128,
    256 text tokens (256 and 77 valid), 28x30x53 = 44,520 video tokens."""
    from sageattention_tpu_torch.models import sage_joint_attention_ragged
    B, H, D, T, V = 2, 24, 128, 256, 28 * 30 * 53
    S = T + V
    q, k, v = (x.transpose(1, 2) for x in realistic_qkv(torch, B, H, H, S, D, SEED + 28))
    valid = (256, 77)
    tmask = torch.tensor([[i < n for i in range(T)] for n in valid], device="cuda")
    out, _ = counted_path(torch, "Mochi-1 ragged joint attention", ("B1-colk-seg", "A6-seg"),
                          seen, totals, lambda: sage_joint_attention_ragged(q, k, v, tmask))
    for b, n in enumerate(valid):
        idx = torch.cat([torch.arange(n, device="cuda"), torch.arange(T, S, device="cuda")])
        ref = st.flash_attention(q[b:b + 1, idx], k[b:b + 1, idx], v[b:b + 1, idx],
                                 tensor_layout="NHD")
        check_vs(f"Mochi-1 row {b} ({n} valid text tokens) vs flash over its real tokens",
                 out[b:b + 1, idx], ref, "cos")
        check(not bool(out[b, n:T].any()), f"Mochi-1 row {b}: stripped text positions are zero")
    ms = timed_call(torch, lambda: [sage_joint_attention_ragged(q, k, v, tmask)
                                    for _ in range(2)])[1] / 2
    print(f"     Mochi-1 ragged joint attention ({B}x{S} tokens, {H} heads, hd {D}): "
          f"{ms:.1f} ms per call (2 timed calls)", flush=True)


def slice_heads(args, kw, last=False):
    """The launch's inputs for q heads [0, min(G, 2)) and kv head 0 or, with
    ``last``, for the last q head and the last kv head, and the slice of q
    heads they cover: the plain versions' check at full length on sampled
    heads."""
    q, k, v, cfg, khs, knm, vs, vm, qs, ks = args
    Hq, Hk = q.shape[1], k.shape[1]
    hs = slice(Hq - 1, Hq) if last else slice(0, min(Hq // Hk, 2))
    kvs = slice(Hk - 1, Hk) if last else slice(0, 1)
    hq = lambda x: None if x is None else x[:, hs]  # noqa: E731
    hk = lambda x: None if x is None else x[:, kvs]  # noqa: E731
    khs = None if khs is None else (hq(khs) if cfg.fuse_k_rows else hk(khs))
    kw = dict(kw)
    if kw.get("attn_mask") is not None and kw["attn_mask"].shape[1] > 1:
        kw["attn_mask"] = kw["attn_mask"][:, hs]
    return (hq(q), hk(k), hk(v), cfg, khs, hq(knm), hk(vs), hk(vm), hq(qs), hk(ks)), kw, hs


def sampled_heads(args, kw):
    """The heads that hold a launch on all heads to its plain version: the
    first q heads of kv head 0 and, where it is another head, the last q
    head with the last kv head (the highest head offsets and the launch's
    own GQA map).  A list of ``(sub_args, sub_kw, q_head_slice)``."""
    first = slice_heads(args, kw)
    if first[2].stop >= args[0].shape[1]:
        return [first]
    return [first, slice_heads(args, kw, last=True)]


def heads_of(out, hs):
    """A launch's outputs ``(o, lse, ...)`` on the q heads ``hs``."""
    return tuple(None if x is None else x[:, hs] for x in out)


def live_pairs(torch, args, kw):
    """(query, key) pairs the launch's masks keep, over every head."""
    from sageattention_tpu_torch.ops.attention import _col_hi, _keep_mask
    q, k, cfg = args[0], args[1], args[3]
    B, Hq, Sq, _ = q.shape
    Sk = k.shape[2]
    ext = dict(kw, Sk=Sk)
    cols = torch.arange(Sk, device=q.device)
    n = 0
    for r0 in range(0, Sq, 1024):
        r1 = min(Sq, r0 + 1024)
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        hi = _col_hi(cfg, ext, r1)
        keep = _keep_mask(cfg, rows, cols, r0, r1, hi, ext)
        # a mask with no row term (no causal, bool or segment mask) holds one row
        keep = keep.expand(*keep.shape[:2], r1 - r0, keep.shape[-1])
        n += int(keep.sum()) * (Hq // keep.shape[1]) * (B // keep.shape[0])
    return n


def attn_kernel_entry(torch, name, args, kw, launches, label=None):
    """One attention launch ``(args, kw)`` of configuration ``name`` on all
    heads against its plain version on the sampled heads at full length
    (fails the run if they disagree), then its time at the launch's full
    shape, the bound over the pairs its masks keep and, for flash, the
    library call's time.  Returns the JSON entry (named ``label``, ``name``
    by default)."""
    from sageattention_tpu_torch.ops.attention import attention_kernel, attention_plain
    from sageattention_tpu_torch.utils.testing import calc_diff, time_fn
    q, k = args[0], args[1]
    shape = f"{tuple(q.shape)} Hk={k.shape[1]} causal={args[3].causal}"
    full = attention_kernel(*args, **kw)
    plain_ms, err, heads = None, 0.0, []
    for sub, skw, hs in sampled_heads(args, kw):
        a = heads_of(full, hs)
        b, ms = timed_call(torch, lambda: attention_plain(*sub, **skw))
        plain_ms = ms if plain_ms is None else plain_ms
        kept, note = static_kept_rows(torch, a, b, q.shape[2])
        d = calc_diff(a[0][kept], b[0][kept])
        err = max(err, float((a[0][kept].float() - b[0][kept].float()).abs().max()))
        ok = d < KERNEL_BAR
        if a[1] is not None:
            rows = (a[1] > -1e19) & (b[1] > -1e19) & kept
            dl = float((a[1][rows] - b[1][rows]).abs().max()) if bool(rows.any()) else 0.0
            ok = ok and dl < LSE_BAR and bool(torch.equal(rows, (b[1] > -1e19) & kept))
        heads.append(f"{hs.start}-{hs.stop - 1}")
        check(ok, f"{label or name} vs plain on q heads {heads[-1]} of {shape}{note}: "
                  f"calc_diff {d:.3e} < {KERNEL_BAR}, max_abs {err:.3e}")
    ms = time_fn(lambda: attention_kernel(*args, **kw), warmup=2, reps=5) * 1e3
    pairs = live_pairs(torch, args, kw)
    bias = kw.get("attn_mask") if args[3].masked == "float" else None
    moved = nbytes(*(x for x in args if isinstance(x, torch.Tensor)),
                   *(x for n, x in kw.items() if isinstance(x, torch.Tensor) and x is not bias),
                   *(x for x in full if x is not None)) + bias_read_bytes(bias, pairs, q)
    bound = attn_bound_pairs(args[3], pairs, q.shape[-1], moved)
    lib = None
    if name.startswith("B4-"):
        lib = library_masked_ms(torch, args, kw)
    elif name == "B4":
        lib = library_ms(torch, q, k, args[2], args[3].causal)
    return ext_entry(launches, label or name, err, ms, plain_ms, bound, lib,
                     shape + f", {pairs} live pairs; plain on q heads {', '.join(heads)}",
                     src=fwd_source(args[3], q))


def bias_read_bytes(bias, pairs, q):
    """Bytes of a float bias that a launch must read: 4 for each kept
    (query, key) pair of each batch and head the bias holds apart (a zero
    batch or head stride is one slice; a causal launch reads the tiles on
    and below the diagonal only)."""
    if bias is None:
        return 0
    nb = 1 if bias.shape[0] > 1 and bias.stride(0) == 0 else bias.shape[0]
    nh = 1 if bias.shape[1] > 1 and bias.stride(1) == 0 else bias.shape[1]
    return 4 * pairs * nb * nh // (q.shape[0] * q.shape[1])


def fwd_source(cfg, q):
    """The source that runs a forward launch of ``cfg`` on ``q``."""
    from sageattention_tpu_torch.ops import attention as tatt
    Sq, D = q.shape[2], q.shape[-1]
    if tatt.flash_sm90_route(cfg, Sq, D):
        return SRC_FLASH
    if tatt.b1_sm90_route(cfg, Sq, D, q.dtype):
        return SRC_ATTN_SM90
    if tatt.q8_sm90_route(cfg, Sq, D, q.dtype):
        return SRC_Q8_SM90
    if tatt.online_sm90_route(cfg, Sq, D, q.dtype):
        return SRC_ONLINE_SM90
    return SRC_ATTN


def ext_kernel_checks(torch, seen, totals):
    """Every B7-B9 configuration the paths launched, against its plain
    version on sampled heads at full length, with its time at the path's
    full shape; and A6's segmented mode at the varlen K shape."""
    entries, failures = [], []
    for name in sorted(n for n in seen if n not in KEYS):
        try:
            entries.append(attn_kernel_entry(torch, name, *seen[name], totals.get(name, 0)))
        except SmokeFailure as e:
            failures.append(str(e))
    check(not failures, f"{len(failures)} B7-B9 configurations disagree with their plain "
                        "versions: " + "; ".join(failures))
    entries.append(segmented_quant_check(torch, totals))
    return entries


def static_kept_rows(torch, a, b, Sq):
    """Rows ``[B, Hq, Sq]`` to hold a kernel to its plain version.  A static
    call with Q quantized in the kernel returns the minimum row denominator
    of each 64-row tile, and a tile below 2^-100 makes the pipeline rerun
    the call online: its rows sit at the edge of underflow, where P values
    round differently on the tensor cores and in the plain f32 product, so
    only the kept tiles are compared, after both sides made the same
    decision for every tile."""
    if a[2] is None:
        return torch.ones(a[0].shape[:3], dtype=torch.bool, device=a[0].device), ""
    safe = a[2] >= 2.0 ** -100
    check(bool(torch.equal(safe, b[2] >= 2.0 ** -100))
          and bool(torch.allclose(a[2][safe], b[2][safe], rtol=1e-4, atol=0)),
          "static kernel and plain version keep the same tiles, with the same minimum "
          "row denominators")
    kept = safe.repeat_interleave(64, dim=-1)[..., :Sq]
    return kept, f" ({int(safe.sum())} of {safe.numel()} tiles kept by the static check)"


def ext_entry(launches, name, err, ms, plain_ms, bound, lib, shape, src=SRC_QUANT):
    rep = TPU_KERNELS["A6"] if name.startswith("A") else TPU_KERNELS["B"]
    libs = "" if lib is None else f", library {lib:.3f} ms"
    print(f"     {name}: max_abs_err {err:.3e}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bound[0]:.3f} ms ({bound[1]}){libs} at {shape}", flush=True)
    return {"name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": lib, "shape": shape}


def segmented_quant_check(torch, totals):
    """A6's segmented mode on the packed Llama-3-8B K of the varlen phase
    (group 64, the K mean subtracted, capmax), and with row norms and dots
    as the predictive check asks."""
    from sageattention_tpu_torch import varlen
    from sageattention_tpu_torch.ops import quant_kernels as qk
    from sageattention_tpu_torch.utils.testing import time_fn
    lens = VARLEN_LENS
    T = sum(lens)
    k = realistic_qkv(torch, 1, 8, 8, T, 128, SEED + 22)[1]
    cu = cu_seqlens(torch, lens)
    Tg = -(-T // 64) * 64
    seg = torch.where(torch.arange(Tg, device="cuda") < T,
                      varlen.cu_seqlens_to_segment_ids(cu, Tg), -2)
    kp = torch.nn.functional.pad(k, (0, 0, 0, Tg - T))
    km = qk.channel_stats(k, T)[0]
    fk = lambda: qk.quant_int8_segmented(k, seg, 64, sub=km, with_capmax=True, s_true=T)  # noqa: E731
    fp = lambda: qk.quant_int8_plain(kp, "group", 64, 1.0, km, with_capmax=True,  # noqa: E731
                                     s_true=T, segment_ids=seg[None])
    a = fk()
    b, plain_ms = timed_call(torch, fp)
    same, worst = _codes_ok(torch, a[0], b[0])
    ok = (same >= 0.999 and worst <= 1 and torch.allclose(a[1], b[1], rtol=1e-5)
          and torch.allclose(a[2], b[2], rtol=1e-5))
    check(ok, f"A6-seg vs plain: {same:.9f} of codes equal, max code diff {worst}, "
              "per-row scales and capmax within rtol 1e-5")
    w = a[0]
    a2 = qk.quant_int8_segmented(k, seg, 64, fold=0.125, with_norm=True, dot_with=w)
    b2 = qk.quant_int8_plain(kp, "group", 64, 0.125, segment_ids=seg[None], with_norm=True,
                             dot_with=w)
    same2, worst2 = _codes_ok(torch, a2[0], b2[0])
    ok2 = (same2 >= 0.999 and worst2 <= 1 and torch.allclose(a2[2], b2[3], rtol=1e-5)
           and torch.allclose(a2[3], b2[4], rtol=1e-5, atol=1.0))
    check(ok2, f"A6-seg with row norms and dots vs plain: {same2:.9f} of codes equal")
    err = max(float(worst), float((a[1] - b[1]).abs().max()), float((a[2] - b[2]).abs().max()))
    ms = time_fn(fk, warmup=3, reps=20) * 1e3
    return ext_entry(totals.get("A6-seg", 0), "A6-seg", err, ms, plain_ms,
                     bytes_bound(nbytes(k) * 3 // 2), None,
                     f"{tuple(k.shape)} K, group 64, {len(lens)} segments")


def library_masked_ms(torch, args, kw):
    """``F.scaled_dot_product_attention`` with the launch's mask as a bool
    or float ``attn_mask`` (the band for a window): the one PyTorch call
    that computes what a masked B4 computes (timed here, never called by
    the port)."""
    from sageattention_tpu_torch.utils.testing import time_fn
    q, k, v, cfg = args[:4]
    Sq, Sk = q.shape[2], k.shape[2]
    G = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    r = torch.arange(Sq, device="cuda")[:, None]
    c = torch.arange(Sk, device="cuda")[None, :]
    keep = (c <= r) if cfg.causal else torch.ones(Sq, Sk, dtype=torch.bool, device="cuda")
    if cfg.window:
        keep = keep & ((c >= r - cfg.window + 1) | (c < cfg.sinks))
    m = kw.get("attn_mask")
    if cfg.masked == "bool":
        mask = keep & m.bool()
    elif cfg.masked == "float":
        mask = m.float().masked_fill(~keep, float("-inf")).to(q.dtype)
    else:
        mask = keep
    return time_fn(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=cfg.sm_scale), warmup=2, reps=5) * 1e3


def run_slice3(torch, st, totals):
    """The paths of slice 3 (masks, window and sinks, varlen), each counted
    on its own, then the kernel checks of every configuration they
    launched.  Returns the JSON entries and the two skip ratios."""
    seen, ratios = {}, {}
    window_phase(torch, st, seen, totals, ratios)
    varlen_phase(torch, st, seen, totals)
    mask_phase(torch, st, seen, totals, ratios)
    ragged_dit_phase(torch, st, seen, totals)
    mochi_phase(torch, st, seen, totals)
    entries = ext_kernel_checks(torch, seen, totals)
    print("     skip ratios: " + json.dumps(ratios), flush=True)
    return entries


# ------------------------------------------------------- slice 4 paths ----

# Llama-3-8B (config.json of meta-llama/Meta-Llama-3-8B) and Mistral-7B-v0.1
LLAMA3_8B = dict(hidden=4096, heads=32, kv_heads=8, depth=32, vocab=128256, mlp_ratio=3.5,
                 rope_theta=500000.0)
MISTRAL_7B = dict(hidden=4096, heads=32, kv_heads=8, depth=4, vocab=32000, mlp_ratio=3.5,
                  rope_theta=10000.0, sliding_window=4096)
DENSE_BAR = 2e-3     # cached decode vs the no-cache forward (tests/test_llm.py)
PAGED_BAR = 3e-3
# The 32-block Llama-3-8B with random weights does not meet those bars: its
# int8 prefill's error adds up over depth, the JAX package's as the port's
# (tools/decode_witness.py: a 512-wide model with a 4096-wide model's spread
# goes from ~1e-3 at 2 blocks to ~1e-2 at 32, in both packages).  Its steps
# are held to the exact no-cache forward at bars set from sound runs on an
# H100 (worst 1.537e-2 dense, 9.17e-3 paged, the same in every run) with 30%
# room; the distance to the int8 no-cache forward is printed beside the
# tests' bar, which Mistral-7B at 4 blocks meets outright.
LLAMA_DENSE_BAR = 2e-2
LLAMA_PAGED_BAR = 1.2e-2
DECODE_BAR = 1.5e-3  # decode vs the f32 oracle (tests/test_decode.py, tests/test_paged.py)
DECODE_FP8_BAR = 2.5e-3
MERGE_BAR = 5e-4     # deferred / staged steps vs classic steps (tests/test_paged.py)
SRC_DECODE = "sageattention_tpu_torch/csrc/decode.cu"
SRC_DECODE_SM90 = "sageattention_tpu_torch/csrc/decode_sm90.cu"
# int8 B11 at head dim 128 runs decode_sm90.cu's entry and never decode.cu's
B11_SM90_ONLY = {"sage_decode_sm90": True, "sage_decode": False}
# A bf16 V cache stores bf16(v - v_mean), as the JAX package does.  For a
# bf16 v whose channel mean is below its ulp, the rounding returns v itself
# more often than not: the stored V is biased by up to the mean, which a
# long, diffuse softmax (random data at 32 K tokens) does not average away
# (ROADMAP queue 3; tools/decode_witness.py bf16v reads the same distance
# in the JAX package).  So a bf16 cache is held twice: to the V it stores
# at DECODE_BAR, and to the true V at a bar set from sound runs on an H100
# (worst 2.789e-3) with 25% room.
BF16_TRUE_V_BAR = 3.5e-3
SERVE_PROMPTS = (4096, 3072, 2048, 1536, 1024, 768, 512, 256)
# prefix caching: a 2048-token system prompt and each request's own suffix
# (each total leaves room for 32 appends in its last page)
SYS_PROMPT = 2048
SUFFIXES = (520, 700, 300, 900, 130, 1200, 64, 450)
NEW_SUFFIX = 610
PAGED_LENS = (32768, 24576, 16384, 12000, 8192, 4096, 2048, 1000)
SERVE = dict(llama=LLAMA3_8B, mistral=MISTRAL_7B, prompt=8192, steps=32, window_T=4,
             serve=SERVE_PROMPTS, freeze_after=8, page=256, sys=SYS_PROMPT, suffixes=SUFFIXES,
             new_suffix=NEW_SUFFIX, attn=(32, 8, 128), mistral_prompt=12288, mistral_steps=16,
             kernel_B=8, dense_len=32768, paged_lens=PAGED_LENS)


def _llama(torch, cfg, **kw):
    from sageattention_tpu_torch.models import LlamaConfig, LlamaLM
    return LlamaLM(LlamaConfig(**cfg), device="cuda", param_dtype=torch.bfloat16,
                   **kw).init_weights(SEED)


def _tokens(torch, shape, vocab, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, vocab, shape, generator=g, device="cuda")


def _rows_diff(a, b):
    from sageattention_tpu_torch.utils.testing import calc_diff
    return calc_diff(a.float(), b.float())


class no_host_sync:
    """Makes any operation that waits for the card raise (a decode step
    must read nothing back to the host)."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        self.torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode("default")


class attn_of:
    """Runs a model's blocks with another attention callable for a while."""

    def __init__(self, model, fn):
        self.model, self.fn = model, fn

    def __enter__(self):
        self.old = [b.attn_fn for b in self.model.layers]
        for b in self.model.layers:
            b.attn_fn = self.fn

    def __exit__(self, *exc):
        for b, fn in zip(self.model.layers, self.old):
            b.attn_fn = fn


def _device_us(prof):
    """(kernel name, device us) of every CUDA kernel in a profiler trace."""
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us and not ev.key.startswith(("aten::", "cuda", "Memcpy", "Memset")):
            yield ev.key.lower(), us


def decode_device_ms(torch, fn, reps=20):
    """Device time per call of the B11/D1 kernels (split and merge launches)
    that ``fn`` runs, from a ``torch.profiler`` trace of ``reps`` calls: the
    wrapper's host work and its small copies are left out.  A trace that
    records none of them (CUPTI has dropped a whole trace on the card) is
    taken again, up to 3 times; 0 if none records them."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms = sum(us for name, us in _device_us(prof) if "decode_" in name) / 1e3 / reps
        if ms > 0:
            return ms
    return 0.0


def profile_steps(torch, step, caches, step_ms, n=2):
    """Device time of ``n`` decode steps by kind of kernel (``torch.profiler``)
    against the unprofiled step time ``step_ms``: the share of the card that
    the host leaves idle (the profiler's own wall time is printed beside).
    Returns the numbers and the grown caches."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            _, caches = step(caches, i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
    kinds = {"attention (B11/D1)": 0.0, "matmul": 0.0, "other": 0.0}
    for name, us in _device_us(prof):
        kind = ("attention (B11/D1)" if "decode_" in name else
                "matmul" if any(x in name for x in ("gemm", "gemv", "nvjet", "xmma", "cutlass"))
                else "other")
        kinds[kind] += us / 1e3 / n
    dev = sum(kinds.values())
    return {"step_ms": step_ms, "device_ms": dev, "idle_share": 1.0 - dev / step_ms,
            "profiled_wall_ms": wall * 1e3, **{f"{k}_ms": v for k, v in kinds.items()},
            "caches": caches}


def model_check(what, got, exact, int8_ref, bar, test_bar):
    """A cached decode step's logits: finite and within ``bar`` of the exact
    no-cache forward; the distances to the exact and the int8 no-cache
    forwards are printed beside ``test_bar`` (tests/test_llm.py's)."""
    d_exact, d_int8 = _rows_diff(got, exact), _rows_diff(got, int8_ref)
    d_ref = _rows_diff(int8_ref, exact)
    over = [n for n, d in (("exact", d_exact), ("int8", d_int8)) if d >= test_bar]
    check(bool(got.float().isfinite().all()) and d_exact < bar,
          f"{what}: vs the exact no-cache forward {d_exact:.3e} < {bar}; vs the int8 no-cache "
          f"forward {d_int8:.3e} (which is {d_ref:.3e} from the exact one); tests' bar "
          f"{test_bar}: {'over vs ' + ' and '.join(over) if over else 'met'}")


def dense_llm_phase(torch, st, seen, totals, model):
    """8a: Llama-3-8B with a dense int8 cache: an 8,192-token prompt through
    ``sage_dot_product_attention`` (max_len + 64), 32 greedy T=1 steps, one
    T=4 teacher-forced window; logits against the no-cache forward."""
    cfg = model.cfg
    P, n = SERVE["prompt"], SERVE["steps"]
    prompt = _tokens(torch, (1, P), cfg.vocab, SEED + 40)
    window = _tokens(torch, (1, SERVE["window_T"]), cfg.vocab, SEED + 41)
    state = {}

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model(prompt, max_len=P + 64)
        torch.cuda.synchronize()
        state["prefill_s"] = time.perf_counter() - t0
        tok = logits[:, -1:].argmax(-1)
        toks, keep = [tok], {}
        t0 = time.perf_counter()
        with no_host_sync(torch):   # every step: no read back to the host
            for i in range(1, n + 1):
                step, caches = model(tok, caches=caches, pos=P + i - 1)
                if i in (1, n // 2, n):
                    keep[i] = step[:, -1].clone()
                tok = step[:, -1:].argmax(-1)
                toks.append(tok)
        torch.cuda.synchronize()
        state["step_s"] = (time.perf_counter() - t0) / n
        state["profile"] = profile_steps(torch, lambda c, i: model(
            toks[-1], caches=c, pos=P + n + i), caches, state["step_s"] * 1e3)
        caches = state["profile"].pop("caches")
        win, caches = model(window, caches=caches, pos=P + n + 2)
        state.update(toks=torch.cat(toks[:-1], 1), keep=keep, win=win,
                     length=int(caches[0].length), extra=toks[-1].repeat(1, 2))
        return None

    counted_path(torch, "Llama-3-8B dense-cache decode", ("B11-int8", "B11-int8-causal-mod"),
                 seen, totals, run, entries=B11_SM90_ONLY)
    toks = state["toks"]
    T = SERVE["window_T"]
    check(state["length"] == P + n + 2 + T,
          f"dense cache length {state['length']} == {P + n + 2 + T}")
    from sageattention_tpu_torch.models import flash_dot_product_attention
    full = torch.cat([prompt, toks, state["extra"], window], 1)
    with torch.no_grad():
        with attn_of(model, flash_dot_product_attention):
            exact = model(full)      # causal and exact: every position at once
        for i, got in state["keep"].items():
            model_check(f"Llama-3-8B dense step {i} logits", got, exact[:, P + i - 1],
                        model(full[:, :P + i])[:, -1], LLAMA_DENSE_BAR, DENSE_BAR)
        model_check(f"Llama-3-8B dense T={T} window logits", state["win"], exact[:, -T:],
                    model(full)[:, -T:], LLAMA_DENSE_BAR, DENSE_BAR)
    del exact
    print(f"     Llama-3-8B dense: prefill {P} tokens {state['prefill_s'] * 1e3:.1f} ms, decode "
          f"{state['step_s'] * 1e3:.2f} ms per step = {1.0 / state['step_s']:.1f} tokens/s "
          f"(B = 1, {n} steps)", flush=True)
    print("     Llama-3-8B dense decode step, profiled (2 steps): " + json.dumps(
        {k: v for k, v in state["profile"].items()}), flush=True)


def paged_llm_phase(torch, st, seen, totals, model):
    """8b: continuous batching through the model: 8 right-padded prompts
    (4096 ... 256) in one page pool per layer (page 256, one table), 32
    decode steps with ``pos=None``; slot 7 frozen by ``active`` after step 8."""
    cfg, page, n = model.cfg, SERVE["page"], SERVE["steps"]
    lens = list(SERVE["serve"])
    B, S = len(lens), -(-max(lens) // page) * page
    alloc = st.PageAllocator(sum(-(-(L + n) // page) for L in lens) + 4, page)
    rows = [alloc.reserve(-(-(L + n) // page)) for L in lens]
    table = st.build_table(rows, max(len(r) for r in rows))
    prompts = _tokens(torch, (B, S), cfg.vocab, SEED + 42)
    spec = dict(num_pages=alloc.free_pages + sum(len(r) for r in rows), page_table=table,
                lengths=torch.tensor(lens, device="cuda"))
    last = B - 1
    state = {}

    def run():
        logits, caches = model(prompts, paged_spec=spec)
        idx = torch.tensor(lens, device="cuda") - 1
        tok = logits[torch.arange(B, device="cuda"), idx].argmax(-1)[:, None]
        del logits
        toks, keep = [tok], {}
        actives = [torch.tensor([True] * last + [i <= SERVE["freeze_after"]], device="cuda")
                   for i in range(1, n + 1)]
        frozen_pages = torch.tensor(rows[last], device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_host_sync(torch):   # every step: no read back to the host
            for i in range(1, n + 1):
                step, caches = model(tok, caches=caches, pos=None, active=actives[i - 1])
                if i in (1, SERVE["freeze_after"], n):
                    keep[i] = step[:, -1].clone()
                if i == SERVE["freeze_after"]:
                    frozen = [(c.lengths[last].clone(), c.page_table[last].clone(),
                               c.k8_pool[frozen_pages].clone()) for c in (caches[0], caches[-1])]
                tok = step[:, -1:].argmax(-1)
                toks.append(tok)
        torch.cuda.synchronize()
        state.update(step_s=(time.perf_counter() - t0) / n, toks=torch.cat(toks[:-1], 1),
                     keep=keep, frozen=frozen, caches=caches)

    counted_path(torch, "Llama-3-8B paged continuous batching", ("D1-int8",), seen, totals, run)
    caches = state.pop("caches")
    for c, (L, row, pages) in zip((caches[0], caches[-1]), state["frozen"]):
        same = (bool(torch.equal(c.lengths[last], L)) and bool(torch.equal(c.page_table[last], row))
                and bool(torch.equal(c.k8_pool[torch.tensor(rows[last], device="cuda")], pages)))
        check(same, f"frozen slot {last}: length {int(L)}, table row and pages unchanged "
                    f"after step {SERVE['freeze_after']}")
    del caches
    toks = state["toks"]
    from sageattention_tpu_torch.models import flash_dot_product_attention
    with torch.no_grad():
        for b in range(B):
            steps = (1, SERVE["freeze_after"]) if b == last else (1, n)
            seq = torch.cat([prompts[b:b + 1, :lens[b]], toks[b:b + 1, :steps[-1]]], 1)
            with attn_of(model, flash_dot_product_attention):
                exact = model(seq)[0]
            for i in steps:
                model_check(f"paged slot {b} (prompt {lens[b]}) step {i} logits",
                            state["keep"][i][b], exact[lens[b] + i - 1],
                            model(seq[:, :lens[b] + i])[0, -1], LLAMA_PAGED_BAR, PAGED_BAR)
            del exact
    n_act = (B - 1) + SERVE["freeze_after"] / n
    print(f"     Llama-3-8B paged batch of {B}: {state['step_s'] * 1e3:.2f} ms per step = "
          f"{n_act / state['step_s']:.1f} tokens/s", flush=True)


def _oracle_rows(torch, q, k, v):
    """f32 attention of ``q [H, R, D]`` over ``k/v [Hk, L, D]`` (all keys
    visible; TF32 off)."""
    from sageattention_tpu_torch.ops.reference import _no_tf32
    G = q.shape[0] // k.shape[0]
    with _no_tf32():
        s = torch.matmul(q.float(), k.float().repeat_interleave(G, 0).transpose(-1, -2))
        p = torch.softmax(s * q.shape[-1] ** -0.5, -1)
        return torch.matmul(p, v.float().repeat_interleave(G, 0))


def prefix_phase(torch, st, seen, totals):
    """8c: prefix caching at Llama-3-8B attention width: 8 requests share a
    2,048-token system prompt; each admits through PrefixCachingAllocator
    and quantizes only its suffix; 32 steps of paged_append +
    sageattn_decode_paged; midway one request leaves and a new one takes its
    slot."""
    from sageattention_tpu_torch.serving import PrefixCachingAllocator
    H, Hk, D = SERVE["attn"]
    page, n, sysl = SERVE["page"], SERVE["steps"], SERVE["sys"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 43)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    sys_k, sys_v = rn(Hk, sysl, D), rn(Hk, sysl, D)
    sys_k[..., 7] += 3.0

    def request(suffix, rid):
        k = torch.cat([sys_k, rn(Hk, suffix, D)], 1)
        v = torch.cat([sys_v, rn(Hk, suffix, D)], 1)
        k[:, sysl:, 7] += 3.0
        toks = list(range(sysl)) + [100000 * (rid + 1) + j for j in range(suffix)]
        return toks, k.bfloat16(), v.bfloat16()

    B = len(SERVE["suffixes"])
    reqs = [request(s, i) for i, s in enumerate(SERVE["suffixes"])]
    max_pages = -(-(sysl + max(list(SERVE["suffixes"]) + [SERVE["new_suffix"]])) // page)
    alloc = PrefixCachingAllocator(B * max_pages + 8, page_size=page)
    state = {}

    def padded(x, start):
        n_tok = -(-x.shape[1] // page) * page
        return torch.nn.functional.pad(x[:, start:].float(), (0, 0, 0, n_tok - x.shape[1]))

    def run():
        adms, saved = [], 0
        toks0, k0, v0 = reqs[0]
        adm = alloc.admit(toks0)
        table = st.build_table([adm.pages] + [[]] * (B - 1), max_pages)
        kz = torch.zeros((B, Hk, max_pages * page, D), device="cuda")
        vz = torch.zeros_like(kz)
        kz[0, :, :k0.shape[1]], vz[0, :, :v0.shape[1]] = k0.float(), v0.float()
        cache = st.paged_prefill(kz, vz, [k0.shape[1]] + [0] * (B - 1), table,
                                 num_pages=alloc.free_pages + len(adm.pages), page_size=page)
        del kz, vz
        alloc.commit(toks0, adm.pages)
        adms.append(adm)
        for i in range(1, B):
            toks, k, v = reqs[i]
            adm = alloc.admit(toks)
            s0 = adm.n_cached_pages * page
            cache = st.paged_insert(cache, i, padded(k, s0), padded(v, s0), k.shape[1], adm.pages,
                                    start_page=adm.n_cached_pages)
            alloc.commit(toks, adm.pages)
            adms.append(adm)
            saved += adm.n_cached_pages
        kv = [[k.float(), v.float()] for _, k, v in reqs]
        diffs = []
        for i in range(1, n + 1):
            if i == n // 2 + 1:   # request 3 leaves; a new one takes its slot
                alloc.release(adms[3].pages)
                toks, k, v = request(SERVE["new_suffix"], 99)
                adm = alloc.admit(toks)
                s0 = adm.n_cached_pages * page
                cache = st.paged_insert(cache, 3, padded(k, s0), padded(v, s0), k.shape[1],
                                        adm.pages, start_page=adm.n_cached_pages)
                alloc.commit(toks, adm.pages)
                adms[3], saved = adm, saved + adm.n_cached_pages
                kv[3] = [k.float(), v.float()]
            q = rn(B, H, 1, D).bfloat16()
            kn, vn = rn(B, Hk, 1, D).bfloat16(), rn(B, Hk, 1, D).bfloat16()
            cache = st.paged_append(cache, kn, vn)
            out = st.sageattn_decode_paged(q, cache)
            for b in range(B):
                kv[b][0] = torch.cat([kv[b][0], kn[b].float()], 1)
                kv[b][1] = torch.cat([kv[b][1], vn[b].float()], 1)
            if i in (1, n // 2 + 1, n):
                for b in range(B):
                    diffs.append((i, b, _rows_diff(out[b], _oracle_rows(torch, q[b], *kv[b]))))
        state.update(diffs=diffs, saved=saved, lengths=cache.lengths.tolist(),
                     want=[kk.shape[1] for kk, _ in kv])

    counted_path(torch, "prefix-cached serving (Llama-3-8B attention)", ("D1-int8",), seen,
                 totals, run)
    check(state["lengths"] == state["want"], f"prefix serving lengths {state['lengths']}")
    worst = max(state["diffs"], key=lambda x: x[2])
    check(worst[2] < DECODE_BAR, f"prefix-cached decode vs f32 oracle, {len(state['diffs'])} "
                                 f"(step, slot) checks: worst {worst[2]:.3e} (step {worst[0]}, "
                                 f"slot {worst[1]}) < {DECODE_BAR}")
    print(f"     prefix caching: the shared {sysl}-token prompt saved {state['saved']} pages "
          f"({state['saved'] * page} tokens quantized once instead of again)", flush=True)


def mistral_phase(torch, st, seen, totals):
    """8d: Mistral-7B-v0.1 (window 4096), 4 of 32 blocks: a 12,288-token
    paged prompt and 16 sliding-window decode steps, without and with four
    sink tokens; the no-cache forward's prefill is the windowed flash."""
    from sageattention_tpu_torch.models import flash_dot_product_attention
    page, P, n = SERVE["page"], SERVE["mistral_prompt"], SERVE["mistral_steps"]
    for sinks in (0, 4):
        cfg = dict(SERVE["mistral"], attention_sinks=sinks)
        model = _llama(torch, cfg, attn_fn=flash_dot_product_attention if sinks else None)
        tokens = _tokens(torch, (1, P + n), cfg["vocab"], SEED + 44)
        n_pages = -(-(P + n) // page)
        table = st.build_table([list(range(n_pages))], n_pages)
        spec = dict(num_pages=n_pages, page_table=table, lengths=torch.tensor([P], device="cuda"))
        state = {}

        def run():
            _, caches = model(tokens[:, :P], paged_spec=spec)
            keep = {}
            for i in range(1, n + 1):
                cur = P + i - 1
                step, caches = model(tokens[:, cur:cur + 1], caches=caches, pos=cur)
                if i in (1, n):
                    keep[i] = step[:, -1].clone()
            state["keep"] = keep

        key = "D1-int8-sinks" if sinks else "D1-int8-sliding"
        counted_path(torch, f"Mistral-7B sliding-window decode (sinks {sinks})",
                     (key, "B4-window"), seen, totals, run)
        with torch.no_grad():
            exact = model(tokens)      # the windowed flash: every position at once
            for i, got in state["keep"].items():
                with attn_of(model, _sage_nhd()):
                    int8_ref = model(tokens[:, :P + i])[:, -1]
                model_check(f"Mistral-7B window decode (sinks {sinks}) step {i} logits", got,
                            exact[:, P + i - 1], int8_ref, PAGED_BAR, PAGED_BAR)
        del model, exact


def _window_oracle(torch, q, k, v):
    """f32 attention of the ``T`` rows of ``q [T, D]`` at the last T
    positions of ``k/v [L, D]``, causal among them (TF32 off)."""
    from sageattention_tpu_torch.ops.reference import _no_tf32
    T, L = q.shape[0], k.shape[0]
    with _no_tf32():
        s = torch.matmul(q.float(), k.float().T) * q.shape[-1] ** -0.5
        cols = torch.arange(L, device=q.device)[None, :]
        s = s.masked_fill(cols > torch.arange(L - T, L, device=q.device)[:, None], float("-inf"))
        return torch.softmax(s, -1) @ v.float()


def kernel_scale_phase(torch, st, seen, totals):
    """8e: the cache formats and state hooks at kernel scale (B = 8, 32/8
    heads, hd 128, lengths up to 32,768): dense int8/fp8/bf16 caches at
    T = 1, 4 (folded) and 25 (unfolded); ragged pools with return_state; a
    T = 4 paged window; the deferred and staged steps against classic
    steps."""
    H, Hk, D = SERVE["attn"]
    B, L = SERVE["kernel_B"], SERVE["dense_len"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 45)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    k, v = rn(B, Hk, L + 32, D).bfloat16(), rn(B, Hk, L + 32, D).bfloat16()
    k[..., 7] += 3.0
    heads = (0, H - 1)
    G = H // Hk
    res = []

    def oracle_check(what, out, q, kk, vv, T, bar, rows=None):
        """Sampled q heads of every sequence vs f32 attention over its keys,
        causal within a T-row window at the end."""
        for b in range(out.shape[0]):
            Lb = kk[b].shape[1] if rows is None else rows[b]
            for h in heads:
                res.append((what, _rows_diff(out[b, h], _window_oracle(
                    torch, q[b, h], kk[b, h // G, :Lb], vv[b, h // G, :Lb])), bar))

    def run():
        for fmt in ("int8", "fp8", "bf16"):
            bar = DECODE_FP8_BAR if fmt == "fp8" else DECODE_BAR
            cache = st.kv_cache_init(k[:, :, :L], v[:, :, :L], L + 64, v_format=fmt)
            # the last window has too many rows for folding its G heads to save a
            # tile (B11-int8-causal): the shortest such window, as JAX decides it
            t_unfold = next(t for t in range(2, 33) if not st.decode.fold_heads(G, t))
            Ts = (1, 4, t_unfold) if fmt == "int8" else (1, 4)
            pos = L
            for T in Ts:
                cache = st.kv_cache_append(cache, k[:, :, pos:pos + T], v[:, :, pos:pos + T])
                pos += T
                q = rn(B, H, T, D).bfloat16()
                out = st.sageattn_decode(q, cache)
                if fmt == "bf16":   # held to the true V and the stored V (BF16_TRUE_V_BAR)
                    oracle_check(f"dense bf16 T={T} vs the true V", out, q, k[:, :, :pos],
                                 v[:, :, :pos], T, BF16_TRUE_V_BAR)
                    vref = cache.v[:, :, :pos].float() + cache.v_mean
                else:
                    vref = v[:, :, :pos]
                oracle_check(f"dense {fmt} T={T}", out, q, k[:, :, :pos], vref, T, bar)
            del cache
        lens = list(SERVE["paged_lens"])
        page = SERVE["page"]
        per = -(-max(lens) // page) + 1
        table = st.build_table([[b * per + j for j in range(per)] for b in range(B)], per)
        kp = torch.nn.functional.pad(k[:, :, :max(lens)], (0, 0, 0, (per - 1) * page - max(lens)))
        vp = torch.nn.functional.pad(v[:, :, :max(lens)], (0, 0, 0, (per - 1) * page - max(lens)))
        for fmt in ("int8", "fp8", "bf16"):
            bar = DECODE_FP8_BAR if fmt == "fp8" else DECODE_BAR
            cache = st.paged_prefill(kp, vp, lens, table, num_pages=B * per, page_size=page,
                                     v_format=fmt)
            q = rn(B, H, 1, D).bfloat16()
            out, lse = st.sageattn_decode_paged(q, cache, return_state=True)
            vref = vp
            if fmt == "bf16":   # held to the true V and the stored V (BF16_TRUE_V_BAR)
                oracle_check("paged bf16 vs the true V", out, q, kp, vp, 1, BF16_TRUE_V_BAR,
                             rows=lens)
                vref = (vp.float() - cache.v_mean).bfloat16().float() + cache.v_mean
            oracle_check(f"paged {fmt}", out, q, kp, vref, 1, bar, rows=lens)
            for b in range(B):
                s = torch.matmul(q[b, :1].float(), kp[b, :1, :lens[b]].float().transpose(-1, -2))
                ref = torch.logsumexp(s * D ** -0.5, -1)
                res.append((f"paged {fmt} lse", float((lse[b, :1] - ref).abs().max()), 1.5e-1))
            if fmt == "int8":
                T = 4
                kw = st.PagedKVCache(*[x.clone() for x in cache])
                kn, vn = rn(B, Hk, T, D).bfloat16(), rn(B, Hk, T, D).bfloat16()
                kw = st.paged_append(kw, kn, vn)
                q4 = rn(B, H, T, D).bfloat16()
                out = st.sageattn_decode_paged(q4, kw)
                kk = [torch.cat([kp[b, :, :lens[b]], kn[b]], 1) for b in range(B)]
                vv = [torch.cat([vp[b, :, :lens[b]], vn[b]], 1) for b in range(B)]
                for b in range(B):
                    for h in heads:
                        ref = _window_oracle(torch, q4[b, h], kk[b][h // G], vv[b][h // G])
                        res.append(("paged int8 T=4 window", _rows_diff(out[b, h], ref),
                                    DECODE_BAR))
                del kw
                # the deferred and staged steps against classic steps
                qs, kns, vns = rn(T, B, H, 1, D).bfloat16(), rn(T, B, Hk, 1, D).bfloat16(), \
                    rn(T, B, Hk, 1, D).bfloat16()
                classic = st.PagedKVCache(*[x.clone() for x in cache])
                refs = []
                for t in range(T):
                    classic = st.paged_append(classic, kns[t], vns[t])
                    refs.append(st.sageattn_decode_paged(qs[t], classic))
                deferred = st.PagedKVCache(*[x.clone() for x in cache])
                out0, _ = st.paged_decode_step_deferred(qs[0], deferred, kns[0], vns[0])
                res.append(("deferred step vs classic", _rows_diff(out0, refs[0]), MERGE_BAR))
                outs, _ = st.paged_decode_block_staged(qs, cache, kns, vns)
                res.append(("staged block vs classic", _rows_diff(outs, torch.stack(refs)),
                            MERGE_BAR))
                del classic, deferred
            del cache

    counted_path(torch, "decode at kernel scale", (
        "B11-int8", "B11-fp8", "B11-bf16", "B11-int8-causal-mod", "B11-fp8-causal-mod",
        "B11-bf16-causal-mod", "B11-int8-causal", "D1-int8-state", "D1-fp8-state",
        "D1-bf16-state", "D1-int8-causal", "D1-int8"), seen, totals, run,
        entries={"sage_decode_sm90": True, "sage_decode": True})
    worst = {}
    for what, d, bar in res:
        if what not in worst or d > worst[what][0]:
            worst[what] = (d, bar)
    for what, (d, bar) in worst.items():
        check(d < bar, f"kernel-scale {what}: worst {d:.3e} < {bar}")


def decode_live_tokens(torch, name, args, kw):
    """Cache tokens the launch must read (the live length, the window and
    its sinks), over all sequences and KV heads."""
    if name.startswith("B11"):
        k, kv_true = args[1], args[7]
        return k.shape[0] * k.shape[1] * min(int(kv_true.reshape(-1)[0]), k.shape[2])
    Hk = args[1].shape[1]
    lens = args[7].tolist()
    lo = kw.get("win_lo")
    sinks = kw.get("sinks", 0)
    n = 0
    for b, L in enumerate(lens):
        if lo is None:
            n += L
        else:
            lb = int(lo[b])
            n += (L - lb) + min(sinks, lb)
    return n * Hk


def decode_entry(torch, name, args, kw, launches, label=None):
    """One B11 or D1 launch ``(args, kw)`` of configuration ``name`` against
    its plain version on KV head 0 (and its query heads) of every sequence
    (fails the run if they disagree), with its device time at the launch's
    full shape and its bytes bound over the live tokens.  Returns the JSON
    entry (named ``label``, ``name`` by default)."""
    from sageattention_tpu_torch.ops import attention as tatt
    from sageattention_tpu_torch.ops import paged_decode as tpd
    from sageattention_tpu_torch.utils.testing import calc_diff, time_fn
    if name.startswith("B11"):
        q, k, v, cfg, ks, vs, vm, kvt, offs = args
        G = q.shape[1] // k.shape[1] if q.shape[1] != k.shape[1] else 1
        sub = (q[:, :G], k[:, :1], v[:, :1], cfg, ks[:, :1],
               None if vs is None else vs[:, :1], None if vm is None else vm[:, :1], kvt, offs)
        kern, plain = tatt.decode_kernel, tatt.decode_plain
        src_line = TPU_KERNELS["B"]
        skw = {}
    else:
        q, k8, ksp, vp, vs, vm, tab, lens = args
        G = q.shape[1] // k8.shape[1]
        sub = (q[:, :G], k8[:, :1], ksp[:, :1], vp[:, :1], vs[:, :1], vm[:, :1], tab, lens)
        kern, plain = tpd.paged_decode_kernel, tpd.paged_decode_plain
        src_line = TPU_KERNELS["D1"]
        skw = kw
    a = kern(*sub, **skw)
    b, plain_ms = timed_call(torch, lambda: plain(*sub, **skw))
    d = calc_diff(a[0], b[0])
    err = float((a[0].float() - b[0].float()).abs().max())
    ok = d < KERNEL_BAR
    if a[1] is not None:
        live = (b[1] > -1e29)
        dl = float((a[1][live] - b[1][live]).abs().max()) if bool(live.any()) else 0.0
        ok = ok and dl < LSE_BAR and bool(torch.equal(live, a[1] > -1e29))
    check(ok, f"{label or name} vs plain on KV head 0 of {tuple(q.shape)} q, "
              f"{tuple(args[1].shape)} cache: calc_diff {d:.3e} < {KERNEL_BAR}, max_abs {err:.3e}")
    ms = decode_device_ms(torch, lambda: kern(*args, **skw))
    check(ms > 0, f"{label or name}: the profiler saw its kernels run ({ms:.4f} ms per call)")
    wrapper_ms = time_fn(lambda: kern(*args, **skw), warmup=3, reps=20) * 1e3
    out = kern(*args, **skw)
    tokens = decode_live_tokens(torch, name, args, kw)
    vbytes = args[2].element_size() if name.startswith("B11") else args[3].element_size()
    D = q.shape[-1]
    moved = tokens * (D + D * vbytes + 4) + nbytes(q, *(x for x in out if x is not None))
    bound = bytes_bound(moved)
    shape = (f"q {tuple(q.shape)}, cache {tuple(args[1].shape)}, {tokens} live tokens x heads; "
             f"plain on KV head 0")
    print(f"     {label or name}: max_abs_err {err:.3e}, kernel {ms:.4f} ms (device time; the "
          f"wrapper {wrapper_ms:.4f} ms per call), plain {plain_ms:.3f} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]}) at {shape}", flush=True)
    if name.startswith("D1"):
        src = SRC_D1_SM90 if tpd.d1_sm90_route(args[3].dtype, D) else SRC_DECODE
    else:
        src = (SRC_DECODE_SM90 if tatt.b11_sm90_route(cfg, q.shape[2], D, args[2].dtype)
               else SRC_DECODE)
    return {"name": label or name, "route": "cuda", "source": src, "replaces": src_line,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "wrapper_ms": wrapper_ms, "shape": shape}


def decode_kernel_checks(torch, seen, totals):
    """Every B11 and D1 configuration the phase-8 paths launched, against
    its plain version on KV head 0 (and its query heads) of every
    sequence, with its time at the path's full shape and its bytes bound
    over the live tokens."""
    return [decode_entry(torch, name, *seen[name], totals.get(name, 0))
            for name in sorted(n for n in seen if n.startswith(("B11", "D1")))]


def run_serving(torch, st, totals):
    """Phase 8, the serving paths of slice 4, each counted on its own, then
    the kernel checks of every B11/D1 configuration they launched."""
    seen = {}
    t0 = time.time()
    model = _llama(torch, SERVE["llama"], attn_fn=_sage_nhd())
    print(f"     Llama-3-8B: {sum(p.numel() for p in model.parameters()) / 1e9:.2f} B parameters "
          f"in bf16, random (std 0.02, seed {SEED}): {time.time() - t0:.1f} s", flush=True)
    with torch.no_grad():
        dense_llm_phase(torch, st, seen, totals, model)
        paged_llm_phase(torch, st, seen, totals, model)
    del model
    torch.cuda.empty_cache()
    prefix_phase(torch, st, seen, totals)
    with torch.no_grad():
        mistral_phase(torch, st, seen, totals)
    kernel_scale_phase(torch, st, seen, totals)
    return decode_kernel_checks(torch, seen, totals)


def _sage_nhd():
    from sageattention_tpu_torch.models import sage_dot_product_attention
    return sage_dot_product_attention

# ------------------------------------------------------- slice 5 paths ----

# Gemma-7B (config.json of google/gemma-7b): 16 heads of head dim 256, MHA,
# an 8,192-token context
GEMMA_7B = dict(heads=16, kv_heads=16, head_dim=256, context=8192)
GEMMA_PAGED_LENS = (8192, 4096, 2048, 1000)
# Training.  Llama-3-8B cut to 2 of its 32 blocks, so that f32 weights,
# gradients and both Adam moments fit (~1.5 B parameters, ~24 GB), B = 1,
# S = 8,192, eight Adam steps; the CogVideoX1.5-width DiT of phase 3 (2 of 42
# blocks) for three; Mistral-7B-v0.1's window (32/8 heads, hd 128, S =
# 16,384, W = 4096); phase 7's left-padded Llama-3-8B batch; the folded
# verify window of 9 rows at (B = 8, 32/8 heads, hd 128, 32 K).
TRAIN = dict(llama=dict(LLAMA3_8B, depth=2), seq=8192, steps=8, dit_steps=3,
             dit=dict(hidden=3072, heads=48, depth=2, patch=2, in_channels=16, text_dim=4096,
                      text_len=226, frames=13, height=60, width=90, zero_init_gates=False),
             mistral=(32, 8, 128, 16384, 4096), padded=(4, 32, 8, 4096, 128),
             padded_lens=(4096, 3072, 1536, 512), fold=(8, 32, 8, 32768, 128, 9))
# gradients through the quantized forward vs exact attention's: a model's
# step-0 gradients vs the exact run's, an entry's vs the f32 exact gradient
# (tests/test_backward_pallas.py:95-105, tests/test_sliding_window.py)
GRAD_BAR = 6e-2
# A model trained through SageAttention's quantized forward misses that bar:
# its step-0 gradients differ from the exact run's by the int8 forward's
# effect on (o, lse), the same with the bf16 and the int8 backward, while
# the port's exact forward with the same bf16 backward stays well inside it
# (PERF.md, PR 6).  At Llama-3-8B width such runs are held to a bar set
# from sound H100 runs (worst 9.606e-2, the same with either backward) with
# 30% room; the DiT's meet GRAD_BAR (worst 1.010e-2).
SAGE_GRAD_BAR = {"llama": 1.25e-1, "dit": GRAD_BAR}
# C1/C2 from the exact forward's (o, lse) vs the f32 exact gradient
# (tests/test_backward_pallas.py): relative for bf16, cosine distance for int8
BWD_BF16_REL = 3e-2
BWD_INT8_COS = 1.5e-3
FOLD_BAR = 1e-6        # the folded T = 9 window vs the unfolded call
OLD_FOLD_MS = 4.418    # the unfolded T = 9 window's device time before the fold (PERF.md, PR 5)
HD256_BAR = {"sageattn": 1e-3, "H100 mode": FP8_BAR, "flash": ORACLE_BAR}
SRC_BWD = "sageattention_tpu_torch/csrc/backward.cu"


def run_training(torch, st, totals):
    """Phase 9, the paths of slice 5, outside inference mode: head dim 256,
    the folded verify window, then training (each path counted on its own)
    and the kernel checks of every C1/C2 configuration it launched."""
    seen = {}
    entries = hd256_phase(torch, st, totals)
    entries += fold_phase(torch, st, totals)
    torch.cuda.empty_cache()
    llama_train_phase(torch, seen, totals)
    torch.cuda.empty_cache()
    dit_train_phase(torch, seen, totals)
    torch.cuda.empty_cache()
    grad_paths_phase(torch, st, seen, totals)
    torch.cuda.empty_cache()
    with torch.no_grad():
        return entries + backward_kernel_checks(torch, seen, totals)


def _path_counts(before, totals):
    return {k: totals.get(k, 0) - before.get(k, 0) for k in totals}


def hd256_phase(torch, st, totals):
    """9a: head dim 256 at Gemma-7B's attention widths, causal over its
    8,192-token context: ``sageattn``, the H100 mode and flash against the
    f32 oracle on sampled heads; a B = 1 decode over an 8 K dense cache
    (B11) and a paged batch (D1); every launch against its plain version."""
    from sageattention_tpu_torch.ops.reference import sdpa
    from sageattention_tpu_torch.utils.testing import calc_diff
    H, Hk, D, S = (GEMMA_7B[k] for k in ("heads", "kv_heads", "head_dim", "context"))
    q, k, v = realistic_qkv(torch, 1, H, Hk, S, D, SEED + 60)
    calls = {"sageattn": lambda: st.sageattn(q, k, v, is_causal=True),
             "H100 mode": lambda: st.sageattn(q, k, v, is_causal=True, pv_dtype="fp8",
                                              k_scale_mode="fine"),
             "flash": lambda: st.flash_attention(q, k, v, is_causal=True)}
    seen, before = {}, dict(totals)
    outs, _ = counted_path(torch, "Gemma-7B head dim 256 prefill", ("B1", "B5-fp8", "B4"), seen,
                           totals, lambda: {n: f() for n, f in calls.items()})
    counts = _path_counts(before, totals)
    heads = [0, H - 1]
    ref = sdpa(q[:, heads], k[:, heads], v[:, heads], is_causal=True)
    for name, out in outs.items():
        d = calc_diff(out[:, heads].float(), ref.float())
        check(d < HD256_BAR[name], f"Gemma-7B hd 256 {name} vs the f32 oracle on 2 heads: "
                                   f"calc_diff {d:.3e} < {HD256_BAR[name]}")
    entries = []
    for name in sorted(seen):
        entries.append(attn_kernel_entry(torch, name, *seen[name], counts.get(name, 0),
                                         label=f"{name} hd256"))
    # decode: B = 1 over an 8 K dense cache, and a paged batch, same heads
    g = torch.Generator(device="cuda").manual_seed(SEED + 62)
    qd = torch.randn(len(GEMMA_PAGED_LENS), H, 1, D, generator=g, device="cuda").bfloat16()
    cache = st.kv_cache_init(k[:, :, :S - 1], v[:, :, :S - 1], S)
    page = SERVE["page"]
    lens = list(GEMMA_PAGED_LENS)
    per = -(-max(lens) // page) + 1
    table = st.build_table([[b * per + j for j in range(per)] for b in range(len(lens))], per)
    pad = lambda x: torch.nn.functional.pad(  # noqa: E731
        x[:, :, :max(lens)], (0, 0, 0, (per - 1) * page - max(lens))).expand(len(lens), -1, -1, -1)
    kp, vp = pad(k), pad(v)

    def run():
        c = st.kv_cache_append(cache, k[:, :, S - 1:], v[:, :, S - 1:])
        dense = st.sageattn_decode(qd[:1], c)
        pool = st.paged_prefill(kp, vp, lens, table, num_pages=len(lens) * per, page_size=page)
        return dense, st.sageattn_decode_paged(qd, pool)

    seen, before = {}, dict(totals)
    (dense, paged), _ = counted_path(torch, "Gemma-7B head dim 256 decode", ("B11-int8", "D1-int8"),
                                     seen, totals, run,
                                     entries={"sage_decode": True, "sage_decode_sm90": False})
    counts = _path_counts(before, totals)
    for h in heads:
        d = _rows_diff(dense[0, h], _window_oracle(torch, qd[0, h], k[0, h], v[0, h]))
        check(d < DECODE_BAR, f"Gemma-7B hd 256 dense decode head {h} vs the f32 oracle: "
                              f"{d:.3e} < {DECODE_BAR}")
        for b, L in enumerate(lens):
            d = _rows_diff(paged[b, h], _window_oracle(torch, qd[b, h], k[0, h, :L], v[0, h, :L]))
            check(d < DECODE_BAR, f"Gemma-7B hd 256 paged decode, sequence {b} ({L} tokens), "
                                  f"head {h} vs the f32 oracle: {d:.3e} < {DECODE_BAR}")
    for name in sorted(seen):
        entries.append(decode_entry(torch, name, *seen[name], counts.get(name, 0),
                                    label=f"{name} hd256"))
    return entries


def fold_phase(torch, st, totals):
    """9b: a T = 9 verify window at (B = 8, 32/8 heads, 32 K) takes the
    folded path, as in JAX: against the unfolded call, with both device
    times."""
    from sageattention_tpu_torch.ops import attention as tatt
    B, H, Hk, L, D, T = TRAIN["fold"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 63)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda").bfloat16()  # noqa: E731
    k, v = rn(B, Hk, L, D), rn(B, Hk, L, D)
    k[..., 7] += 3.0
    cache = st.kv_cache_init(k[:, :, :L - T], v[:, :, :L - T], L)
    cache = st.kv_cache_append(cache, k[:, :, L - T:], v[:, :, L - T:])
    q = rn(B, H, T, D)
    seen, before = {}, dict(totals)
    folded, _ = counted_path(torch, "folded T = 9 window", ("B11-int8-causal-mod",), seen, totals,
                             lambda: st.sageattn_decode(q, cache), entries=B11_SM90_ONLY)
    counts = _path_counts(before, totals)
    cfg = tatt.AttnConfig(causal=True, causal_dynamic=True, quantized=True, pv_dtype="int8",
                          sm_scale=D ** -0.5, kv_len=cache.max_len, kv_len_dynamic=True,
                          fuse_v_mean=True, emit_lse=False, fuse_q_quant=True)
    offsets = torch.stack([cache.length - T, torch.zeros_like(cache.length)])

    def unfolded():
        return tatt.attention_call(q, cache.k8, cache.v, k_scale=cache.k_scale,
                                   v_scale=cache.v_scale, v_mean=cache.v_mean,
                                   kv_true_dyn=cache.length, offsets=offsets, cfg=cfg)[0]

    d = _rows_diff(folded, unfolded())
    check(d < FOLD_BAR, f"folded T = 9 window vs the unfolded call: calc_diff {d:.3e} < {FOLD_BAR}")
    ms_fold = decode_device_ms(torch, lambda: st.sageattn_decode(q, cache))
    ms_unfold = decode_device_ms(torch, unfolded)
    print(f"     T = 9 window at ({B}, {H}/{Hk} heads, {L} tokens): folded {ms_fold:.4f} ms, "
          f"unfolded {ms_unfold:.4f} ms of device time (unfolded before the fold: "
          f"{OLD_FOLD_MS} ms)", flush=True)
    name = "B11-int8-causal-mod"
    return [decode_entry(torch, name, *seen[name], counts.get(name, 0),
                         label=f"{name} T=9 folded")]


def exact_nhd(q, k, v, bias=None, mask=None, *, scale=None, is_causal=False, **kw):
    """The oracle attention of the training phases, NHD: one
    ``F.scaled_dot_product_attention`` call on the GQA-repeated heads (used
    here only, never by the port)."""
    import torch
    G = q.shape[2] // k.shape[2]
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    if G > 1:
        kh, vh = kh.repeat_interleave(G, dim=1), vh.repeat_interleave(G, dim=1)
    return torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, is_causal=is_causal, scale=scale).transpose(1, 2)


def _grad_rel(model, ref):
    """Per parameter tensor, sorted worst first: the relative max error
    ``max|g - r| / max|r|`` of the model's gradient against ``ref`` (name ->
    gradient), its cosine distance, and the name."""
    from sageattention_tpu_torch.utils.testing import calc_diff
    errs = []
    for name, p in model.named_parameters():
        r = ref[name].float()
        e = float((p.grad.float() - r).abs().max() / r.abs().max().clamp_min(1e-30))
        errs.append((e, calc_diff(p.grad.float(), r), name))
    return sorted(errs, reverse=True)


def train_runs(torch, what, make_model, loss_fn, data, runs, seen, totals):
    """Adam (lr 3e-4) over ``data`` for each run ``name -> (attn_fn, expected
    launch keys, gradient bar)``, from the same initial weights, each
    counted on its own: per-step ms (CUDA events) and loss, the step-0
    gradients of the first (exact) run kept as the reference of the
    others, each held to its bar."""
    results, ref = {}, None
    for name, (attn, expect, _) in runs.items():
        model = make_model(attn)
        opt = torch.optim.Adam(model.parameters(), lr=3e-4)

        def run():
            """The steps; returns the losses, the ms per step and, from step
            0, the gradients (first run) or their worst error against them."""
            losses, ms, g0 = [], [], None
            for i, batch in enumerate(data):
                s, o, e = (torch.cuda.Event(enable_timing=True) for _ in range(3))
                s.record()
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(model, batch)
                loss.backward()
                o.record()
                opt.step()
                e.record()
                torch.cuda.synchronize()
                ms.append((s.elapsed_time(e), o.elapsed_time(e)))
                losses.append(loss.item())
                if i == 0:
                    finite = all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())
                    nonzero = all(bool((p.grad != 0).any()) for p in model.parameters())
                    check(finite and nonzero, f"{what}, {name}: step-0 gradients finite and "
                                              "non-zero in every parameter tensor")
                    g0 = ({n: p.grad.detach().clone() for n, p in model.named_parameters()}
                          if ref is None else _grad_rel(model, ref))
            return losses, ms, g0

        (losses, ms, g0), _ = counted_path(torch, f"{what}, {name}", expect, seen, totals, run)
        if ref is None:
            ref, g0 = g0, None
        results[name] = (losses, ms, g0)
        del model, opt
        torch.cuda.empty_cache()
    exact = results[next(iter(runs))][0]
    for name, (losses, ms, worst) in results.items():
        check(all(map(lambda x: x == x and abs(x) < float("inf"), losses)),
              f"{what}, {name}: every loss finite")
        later = sorted(ms[1:]) or ms
        med, med_opt = later[len(later) // 2]
        drift = max(abs(a - b) for a, b in zip(losses, exact))
        print(f"     {what}, {name}: {med:.1f} ms per step, of which the optimizer step "
              f"{med_opt:.1f} ms (the median of steps 1-{len(ms) - 1}; step 0 {ms[0][0]:.1f}), "
              "loss " + " ".join(f"{x:.4f}" for x in losses)
              + f", max |loss drift| vs exact {drift:.2e}", flush=True)
        if worst is not None:
            print(f"     {what}, {name}: step-0 gradients vs the exact run's, worst relative "
                  "max error (cosine distance): " + ", ".join(
                      f"{n} {e:.3e} ({c:.2e})" for e, c, n in worst[:4]), flush=True)
            bar = runs[name][2]
            check(worst[0][0] < bar, f"{what}, {name}: step-0 gradients vs the exact run's, "
                                     f"worst relative error {worst[0][0]:.3e} ({worst[0][2]}) "
                                     f"< {bar}")
    del ref
    return results


def llama_train_phase(torch, seen, totals):
    """9c: Llama-3-8B width (2 of 32 blocks, f32 weights and Adam), B = 1,
    S = 8,192, eight Adam steps on the example's synthetic stream: exact
    attention, the port's exact attention (its flash forward and the bf16
    C1/C2), ``sage_dot_product_attention`` (causal: the bf16 C1/C2) and
    its ``quant_backward=True`` (the int8 C1/C2)."""
    from sageattention_tpu_torch.examples import train_finetune as tex
    from sageattention_tpu_torch.models import (LlamaConfig, LlamaLM, flash_dot_product_attention,
                                                sage_dot_product_attention)
    cfg = LlamaConfig(**TRAIN["llama"])
    S = TRAIN["seq"]
    data = list(tex.batches(cfg.vocab, 1, S + 1, TRAIN["steps"], seed=SEED + 1, device="cuda"))
    init = LlamaLM(cfg, device="cuda").init_weights(SEED).state_dict()
    n = sum(x.numel() for x in init.values())
    print(f"     Llama-3-8B width, 2 blocks: {n / 1e9:.3f} B parameters in f32, random "
          f"(std 0.02, seed {SEED}); S = {S}", flush=True)

    def make(attn):
        model = LlamaLM(cfg, attn_fn=attn, device="cuda")
        model.load_state_dict(init)
        return model

    bar = SAGE_GRAD_BAR["llama"]
    runs = {"exact": (exact_nhd, (), None),
            "port flash (bf16 backward)": (flash_dot_product_attention,
                                           ("B4", "C1-bf16-causal", "C2-bf16-causal"), GRAD_BAR),
            "sage (bf16 backward)": (sage_dot_product_attention,
                                     ("C1-bf16-causal", "C2-bf16-causal"), bar),
            "sage quant_backward=True": (functools.partial(sage_dot_product_attention,
                                                           quant_backward=True),
                                         ("C1-int8-causal", "C2-int8-causal"), bar)}
    train_runs(torch, "Llama-3-8B 2-block fine-tune", make, tex.lm_loss, data, runs, seen, totals)
    del init


def dit_train_phase(torch, seen, totals):
    """9d: the CogVideoX1.5-width DiT (2 of 42 blocks), ``diffusion_loss``
    and Adam steps with exact attention, the port's exact attention (flash
    and the bf16 C1/C2), and SageAttention with the default backward
    (non-causal: int8) and with ``quant_backward=False``."""
    from sageattention_tpu_torch.models import (DiTConfig, flash_dot_product_attention,
                                                sage_dot_product_attention)
    from sageattention_tpu_torch.models import dit as tdit
    cfg = DiTConfig(**TRAIN["dit"])
    g = torch.Generator(device="cuda").manual_seed(SEED + 64)
    batch = tdit.example_inputs(cfg, 1, generator=g, device="cuda")
    noise = torch.randn(batch[0].shape, generator=g, device="cuda")
    init = tdit.make_dit(cfg, device="cuda").init_weights(SEED).state_dict()

    def make(attn):
        model = tdit.make_dit(cfg, attn_fn=attn, device="cuda")
        model.load_state_dict(init)
        return model

    bar = SAGE_GRAD_BAR["dit"]
    runs = {"exact": (exact_nhd, (), None),
            "port flash (bf16 backward)": (flash_dot_product_attention,
                                           ("B4", "C1-bf16", "C2-bf16"), GRAD_BAR),
            "sage (int8 backward)": (sage_dot_product_attention, ("C1-int8", "C2-int8"), bar),
            "sage quant_backward=False": (functools.partial(sage_dot_product_attention,
                                                            quant_backward=False),
                                          ("C1-bf16", "C2-bf16"), bar)}
    train_runs(torch, "CogVideoX1.5-width DiT diffusion step", make,
               lambda m, b: tdit.diffusion_loss(m, b, noise=noise),
               [batch] * TRAIN["dit_steps"], runs, seen, totals)
    del init


def exact_attn_grads(torch, q, k, v, do, keep_fn, chunk=2048):
    """f32 gradients (TF32 off) of exact attention for the q heads ``q``/``do
    [n, S, D]`` over one KV head ``k``/``v [Sk, D]``: the textbook formulas
    over row chunks; ``keep_fn(r0, r1) -> [rows, Sk]`` bool, and a row with
    no kept key gives 0.  Returns ``(dq, dk, dv)`` and the forward's ``(o,
    lse)`` (natural log; -inf on a row with no kept key)."""
    from sageattention_tpu_torch.ops.reference import _no_tf32
    q, k, v, do = (x.float() for x in (q, k, v, do))
    sc = q.shape[-1] ** -0.5
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    o, lse = torch.zeros_like(q), torch.zeros(q.shape[:2], device=q.device)
    with _no_tf32():
        for h in range(q.shape[0]):
            for r0 in range(0, q.shape[1], chunk):
                r1 = min(q.shape[1], r0 + chunk)
                s = (q[h, r0:r1] @ k.T * sc).masked_fill(~keep_fn(r0, r1), float("-inf"))
                m = s.amax(-1, keepdim=True)
                m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
                p = torch.exp(s - m)
                lsum = p.sum(-1, keepdim=True)
                lse[h, r0:r1] = (m + torch.log(lsum))[:, 0]
                p = p / lsum.clamp_min(1e-30)
                dob = do[h, r0:r1]
                o[h, r0:r1] = p @ v
                di = (dob * o[h, r0:r1]).sum(-1, keepdim=True)
                dv += p.T @ dob
                ds = p * (dob @ v.T - di)
                dq[h, r0:r1] = ds @ k * sc
                dk += ds.T @ q[h, r0:r1] * sc
    return (dq, dk, dv), (o, lse)


def grad_distance(torch, what, got, ref):
    """Prints how far gradients through an entry (its quantized forward)
    are from the f32 exact ones: relative max error and cosine distance."""
    from sageattention_tpu_torch.utils.testing import calc_diff
    check(all(bool(torch.isfinite(a).all()) for a in got), f"{what}: finite gradients")
    print(f"     {what} vs the f32 exact gradient: " + ", ".join(
        f"d{n} relative {float((a.float() - r).abs().max() / r.abs().max()):.3e} "
        f"(cosine distance {calc_diff(a.float(), r):.2e})" for a, r, n in zip(got, ref, "qkv")),
        flush=True)


def grad_check(torch, what, got, ref, quantized):
    """C1/C2's gradients ``got`` from the exact forward against the exact
    ``ref``: relative max error for the bf16 backward, cosine distance for
    the int8 one."""
    from sageattention_tpu_torch.utils.testing import calc_diff
    for a, r, n in zip(got, ref, "qkv"):
        if quantized:
            d = calc_diff(a.float(), r)
            check(d < BWD_INT8_COS, f"{what} d{n} vs the f32 exact gradient: cosine distance "
                                    f"{d:.3e} < {BWD_INT8_COS}")
        else:
            d = float((a.float() - r).abs().max() / r.abs().max().clamp_min(1e-30))
            check(d < BWD_BF16_REL, f"{what} d{n} vs the f32 exact gradient: relative "
                                    f"{d:.3e} < {BWD_BF16_REL}")


def grad_paths_phase(torch, st, seen, totals):
    """9e: window, sinks and mask gradients at published widths:
    Mistral-7B-v0.1's window with 0 and 4 sinks, and phase 7's left-padded
    Llama-3-8B batch with its bool mask; the distance of the q heads of KV
    head 0 from the f32 exact gradient is printed (through the quantized
    forward; 9f holds C1/C2 from the exact forward to the tests' bars)."""
    H, Hk, D, S, W = TRAIN["mistral"]
    G = H // Hk
    q, k, v = realistic_qkv(torch, 1, H, Hk, S, D, SEED + 65)
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(SEED + 66),
                     device="cuda").bfloat16()

    def grads(**kw):
        qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
        out = st.sageattn(qq, kk, vv, is_causal=True, **kw)
        return torch.autograd.grad(out, (qq, kk, vv), do)

    for sinks in (0, 4):
        got, _ = counted_path(torch, f"Mistral-7B window {W}, {sinks} sinks: gradient",
                              ("C1-bf16-window", "C2-bf16-window"), seen, totals,
                              lambda: grads(sliding_window=W, attention_sinks=sinks))
        ref, _ = exact_attn_grads(torch, q[0, :G], k[0, 0], v[0, 0], do[0, :G],
                                  band_keep(torch, W, sinks, S))
        grad_distance(torch, f"Mistral-7B window {W}, {sinks} sinks, sageattn, q heads "
                             f"0-{G - 1}", (got[0][0, :G], got[1][0, 0], got[2][0, 0]), ref)
        del got
    del q, k, v, do
    B, H, Hk, S, D = TRAIN["padded"]
    G = H // Hk
    lens = torch.tensor(TRAIN["padded_lens"], device="cuda")
    q, k, v = realistic_qkv(torch, B, H, Hk, S, D, SEED + 24)
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(SEED + 67),
                     device="cuda").bfloat16()
    pad = S - lens
    keep = (torch.arange(S, device="cuda")[None, None, None, :] >= pad[:, None, None, None])
    keep = keep.expand(B, 1, S, S).contiguous()
    got, _ = counted_path(torch, "Llama-3-8B left-padded batch: gradient",
                          ("C1-bf16-causal-bool", "C2-bf16-causal-bool"), seen, totals,
                          lambda: grads(attn_mask=keep))
    for b in range(B):
        causal = band_keep(torch, S, 0, S)
        ref, _ = exact_attn_grads(torch, q[b, :G], k[b, 0], v[b, 0], do[b, :G],
                                  lambda r0, r1, b=b: causal(r0, r1) & keep[b, 0, r0:r1])
        grad_distance(torch, f"left-padded row {b} (prompt {int(lens[b])}), sageattn, "
                             f"q heads 0-{G - 1}", (got[0][b, :G], got[1][b, 0], got[2][b, 0]),
                      ref)


def bwd_pairs(torch, B, Hq, Sq, Sk, kw):
    """(query, key) pairs the backward's masks keep, over every head."""
    mask, causal = kw.get("attn_mask"), kw["is_causal"]
    W, sinks = kw.get("window", 0), kw.get("sinks", 0)
    if mask is None:
        if not causal:
            return B * Hq * Sq * Sk
        r = torch.arange(Sq, device="cuda", dtype=torch.float64)
        if not W:
            return int(B * Hq * float((r + 1).sum()))
        lo = torch.clamp_min(r - W + 1, 0)
        return int(B * Hq * float((r + 1 - lo + torch.minimum(lo, torch.tensor(float(sinks),
                   device="cuda", dtype=torch.float64))).sum()))
    n = 0
    for r0 in range(0, Sq, 1024):
        r1 = min(Sq, r0 + 1024)
        m = mask[:, :, r0:r1]
        if causal:
            m = m & band_keep(torch, Sq, 0, Sk)(r0, r1)
        n += int(m.sum()) * (Hq // mask.shape[1])
    return n


def bwd_bound(kernel, quantized, pairs, D, moved_bytes):
    """Least time of C1 (four products: S, dP, dV, dK) or C2 (three: S, dP,
    dQ), each 2 x pairs x D operations, the score product at int8 or bf16
    rate and the rest at bf16, against the exp2 of P on the SFUs and the
    bytes each input is read and each output written once."""
    n_bf16 = 3 if kernel == "C1" else 2
    tc = 2 * pairs * D * (1 / TC_OPS_S["int8" if quantized else "bf16"] + n_bf16 / TC_OPS_S["bf16"])
    ops = max(tc, pairs / EX2_S)
    by = moved_bytes / HBM_BYTES_S
    return max(ops, by) * 1e3, "operations" if ops >= by else "bytes"


def library_bwd_ms(torch, q, k, v, do, kw):
    """``torch.autograd.grad`` through one ``F.scaled_dot_product_attention``
    call of the same shape (flash backend; a window or mask goes in as a
    bool ``attn_mask``): the one PyTorch call that computes what a bf16
    C1 + C2 computes (timed here, never called by the port)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from sageattention_tpu_torch.utils.testing import time_fn
    G = q.shape[1] // k.shape[1]
    qq, kk, vv = (x.detach().to(torch.bfloat16).requires_grad_() for x in (q, k, v))
    S, Sk = q.shape[2], k.shape[2]
    mask = kw.get("attn_mask")
    if kw.get("window"):
        mask = band_keep(torch, kw["window"], kw.get("sinks", 0), Sk)(0, S)
    elif mask is not None and kw["is_causal"]:
        mask = mask & band_keep(torch, S, 0, Sk)(0, S)
    with torch.enable_grad():   # the kernel checks run under no_grad
        kr, vr = (x.repeat_interleave(G, dim=1) for x in (kk, vv)) if G > 1 else (kk, vv)
        if mask is None:
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                out = torch.nn.functional.scaled_dot_product_attention(
                    qq, kr, vr, is_causal=kw["is_causal"], scale=kw["sm_scale"])
        else:
            out = torch.nn.functional.scaled_dot_product_attention(qq, kr, vr, attn_mask=mask,
                                                                   scale=kw["sm_scale"])
        dob = do.to(torch.bfloat16)
        return time_fn(lambda: torch.autograd.grad(out, (qq, kk, vv), dob, retain_graph=True),
                       warmup=2, reps=5) * 1e3


def backward_kernel_checks(torch, seen, totals):
    """9f: every C1/C2 configuration the training paths launched, replayed
    from the inputs of its first ``attention_backward`` call: the kernel
    against ``attention_backward_plain`` on 1-2 sampled q heads at full
    length (calc_diff <= KERNEL_BAR per gradient), the gradients of KV
    head 0 against the f32 exact ones, and, for the configurations that
    stay on ``backward.cu``, the kernel's time at the path's full shape,
    its bound and, for bf16, the library's backward (phases 13, 16 and 22
    time those on ``backward_sm90.cu`` and ``backward_q8_sm90.cu``)."""
    from sageattention_tpu_torch.ops import backward as tbwd
    from sageattention_tpu_torch.utils.testing import calc_diff, time_fn
    entries, failures, exact_done = [], [], set()
    seen_bwd = sorted(n for n in seen if n.startswith(("C1-", "C2-")))
    for name in seen_bwd:
        (q, k, v, o, lse, do), kw = seen[name]
        kernel, quant = name[:2], kw.get("quantized", False)
        B, Hq, Sq, D = q.shape
        Hk, Sk = k.shape[1], k.shape[2]
        G = Hq // Hk
        mask = kw.get("attn_mask")
        opts = dict(causal=kw["is_causal"], window=kw.get("window", 0), sinks=kw.get("sinks", 0))

        def sub(n):   # q heads [0, n) and KV head 0
            m = None if mask is None else (mask if mask.shape[1] == 1 else mask[:, :n])
            return (q[:, :n], k[:, :1], v[:, :1], o[:, :n], lse[:, :n], do[:, :n]), m

        head_args, m = sub(min(G, 2))
        pa = tbwd.prepare(*head_args, sm_scale=kw["sm_scale"], quantized=quant, attn_mask=m)
        pa.update(opts, out_dtype=torch.float32)
        got = tbwd.attention_backward_kernel(**pa, kernels=(kernel,))
        plain, plain_ms = timed_call(torch, lambda: tbwd.attention_backward_plain(**pa))
        idx = (1, 2) if kernel == "C1" else (0,)
        diffs = [calc_diff(got[i], plain[i]) for i in idx]
        err = max(float((got[i] - plain[i]).abs().max()) for i in idx)
        shape = (f"q {tuple(q.shape)}, kv {tuple(k.shape)}, causal={opts['causal']}, "
                 f"window={opts['window']}, sinks={opts['sinks']}, mask={mask is not None}")
        what = (f"{name} vs plain on {min(G, 2)} q heads of {shape}: calc_diff "
                + "/".join(f"{d:.3e}" for d in diffs) + f" <= {KERNEL_BAR}, max_abs {err:.3e}")
        ok = all(d <= KERNEL_BAR for d in diffs)
        print(("ok   " if ok else "FAIL ") + what, flush=True)
        if not ok:
            failures.append(what)
            continue
        cfg = name[3:]
        if cfg not in exact_done:   # once per configuration: KV head 0 vs exact
            exact_done.add(cfg)
            for b in range(B):
                keep = band_keep(torch, opts["window"] or Sk, opts["sinks"], Sk) \
                    if opts["causal"] else (lambda r0, r1: torch.ones(r1 - r0, Sk, dtype=torch.bool,
                                                                      device="cuda"))
                mb = None if mask is None else mask[b:b + 1, :1]
                if mb is not None:
                    keep = (lambda r0, r1, kf=keep, mb=mb: kf(r0, r1) & mb[0, 0, r0:r1])
                ref, (oe, lse_e) = exact_attn_grads(torch, q[b, :G], k[b, 0], v[b, 0], do[b, :G],
                                                    keep)
                got_b = tbwd.attention_backward(
                    q[b:b + 1, :G], k[b:b + 1, :1], v[b:b + 1, :1], oe[None], lse_e[None],
                    do[b:b + 1, :G], sm_scale=kw["sm_scale"], is_causal=opts["causal"],
                    attn_mask=mb, quantized=quant, window=opts["window"], sinks=opts["sinks"])
                grad_check(torch, f"{cfg} (C1 + C2) from the exact forward, sequence {b}, "
                                  f"q heads 0-{G - 1}",
                           (got_b[0][0], got_b[1][0, 0], got_b[2][0, 0]), ref, quant)
        if bwd_source(name, D) != SRC_BWD:   # timed, with its JSON entry, in phase 13, 16 or 22
            continue
        pf = tbwd.prepare(q, k, v, o, lse, do, sm_scale=kw["sm_scale"], quantized=quant,
                          attn_mask=mask)
        pf.update(opts, out_dtype=torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32)
        ms = time_fn(lambda: tbwd.attention_backward_kernel(**pf, kernels=(kernel,)), warmup=2,
                     reps=5) * 1e3
        out = tbwd.attention_backward_kernel(**pf, kernels=(kernel,))
        reads = [pf[n] for n in ("q", "k", "v", "do", "lse2", "di", "qs", "ks", "mask") if n in pf]
        moved = nbytes(*reads, *(x for x in out if x is not None))
        pairs = bwd_pairs(torch, B, Hq, Sq, Sk, dict(kw, **opts))
        bound = bwd_bound(kernel, quant, pairs, D, moved)
        lib = None if quant else library_bwd_ms(torch, q, k, v, do, dict(kw, **opts))
        libs = "" if lib is None else f", library (C1 + C2) {lib:.3f} ms"
        print(f"     {name}: max_abs_err {err:.3e}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound[0]:.3f} ms ({bound[1]}){libs} at {shape}, {pairs} kept pairs; "
              f"plain on {min(G, 2)} q heads", flush=True)
        entries.append({"name": name, "route": "cuda", "source": bwd_source(name, D),
                        "replaces": TPU_KERNELS[kernel], "launches": totals.get(name, 0),
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib,
                        "shape": shape})
        del pf, out
    check(not failures, f"{len(failures)} C1/C2 configurations disagree with their plain "
                        "versions: " + "; ".join(failures))
    check(bool(seen_bwd), "the training paths launched C1/C2")
    return entries


# ------------------------------------------------- slice 6: the ring ----

SRC_RING = "sageattention_tpu_torch/parallel/ring.py"
RING_SINGLE_BAR = 5e-4   # bf16-PV ring vs single-device sageattn, padded (tests/test_parallel.py:262)
RING_GRAD_BAR = 1e-4     # ring gradients vs single-device ones (tests/test_parallel.py:152)
# end to end on activation-like inputs: the ring's gradients' distance from
# the f32 exact gradient over a single-device call's, worst of dq/dk/dv.
# Against sageattn_qk_int8_pv_bf16 (one K scale per 16 rows) the bar was set
# from the plain versions on the CPU (1.31-1.33 at (1, 4/1, 4096, 128))
# before the card read 1.477; against sageattn with k_scale_mode="head"
# (one K scale per head, the ring's kind) the card read 1.079, the CPU
# 1.15-1.17.
RING_EXACT_RATIO = {"fine": 1.5, "head": 1.25}
# the online fallback at x60 vs flash: int8 codes of near-one-hot logits put
# single-device sageattn itself 1.5-2.5e-2 from exact there (x60 randn, the
# plain path on the CPU); the bar catches a NaN static run or a broken merge
RING_ADV_BAR = 5e-2
SAGE_BAR = 1e-3          # an int8-PV result vs another one (tests/test_attention.py's int8 bar)
COG_SHAPE = (1, 48, 48, 17776, 64)          # CogVideoX1.5 joint attention: B, Hq, Hk, S, D
LLAMA_LONG = (1, 32, 8, 65536, 128)         # Llama-3.1-8B long-context prefill
LLAMA_BWD = (1, 32, 8, 32768, 128)          # Llama-3-8B width, the ring backward


class ring_recorder:
    """Keeps the inputs of every launch of a B10 configuration (by launch
    key) while a path runs, and with ``timed`` the device time of every
    attention launch (CUDA events around it), for the ring's time split."""

    def __init__(self, torch, timed=False):
        self.torch, self.timed, self.calls, self.events = torch, timed, {}, []
        self.widen = []

    def __enter__(self):
        from sageattention_tpu_torch.ops import attention as tatt
        self.real = real = tatt.attention_kernel
        self.real_widen = widen = tatt.widen_v_codes

        def timed_widen(v):
            s, e = (self.torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = widen(v)
            e.record()
            self.widen.append((s, e))
            return out

        if self.timed:
            tatt.widen_v_codes = timed_widen

        def record(*args, **kw):
            name = tatt.config_name(args[3], args[0].shape[2])
            if name.startswith("B10-") and not self.timed:
                self.calls.setdefault(name, []).append((args, kw))
            if not self.timed:
                return real(*args, **kw)
            s, e = (self.torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = real(*args, **kw)
            e.record()
            self.events.append((s, e))
            return out

        tatt.attention_kernel = record
        return self

    def __exit__(self, *exc):
        from sageattention_tpu_torch.ops import attention as tatt
        tatt.attention_kernel = self.real
        tatt.widen_v_codes = self.real_widen

    def kernel_ms(self):
        self.torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)

    def widen_ms(self):
        """Device ms of the V widening inside the timed launches (part of
        ``kernel_ms``)."""
        self.torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.widen)


class vt_copies(list):
    """While entered, keeps the shape of every V^T copy
    ``ops.attention.transpose_v_codes`` makes: one per B5-fp8 launch on
    ``attention_q8_sm90.cu``."""

    def __enter__(self):
        from sageattention_tpu_torch.ops import attention as tatt
        self.real = real = tatt.transpose_v_codes
        tatt.transpose_v_codes = lambda v: self.append(tuple(v.shape)) or real(v)
        return self

    def __exit__(self, *exc):
        from sageattention_tpu_torch.ops import attention as tatt
        tatt.transpose_v_codes = self.real


def virtual_ring(torch, q, k, v, n, return_lse=False, split=None, **kw):
    """``ring_sageattn`` over ``n`` virtual ranks in one process: the ring's
    per-rank phase functions, with its collectives (the K-mean sum, the cap
    factor's max, the rotation, the output gather) done by hand.  With
    ``split`` (a dict) the host-clock ms of each phase, after a sync."""
    from sageattention_tpu_torch.parallel import ring as R
    S_true, D_og = q.shape[2], q.shape[3]
    plan, q, k, v = R.ring_setup(q, k, v, n, **kw)
    S = plan.S
    shard = lambda x, i: x[:, :, i * S:(i + 1) * S]  # noqa: E731
    clock = [time.perf_counter()]

    def lap(what):
        if split is not None:
            torch.cuda.synchronize()
            t = time.perf_counter()
            split[what] = split.get(what, 0.0) + (t - clock[0]) * 1e3
            clock[0] = t

    km = R.ring_k_mean(sum(R.ring_k_stat(shard(k, i), plan, i) for i in range(n)), plan)
    packs = [R.ring_prep(shard(q, i), shard(k, i), shard(v, i), km, plan, i) for i in range(n)]
    lap("prep")
    safe = [False] * n
    if plan.static_mode:
        g_kfac = torch.stack([R.ring_kfac(c) for _, c in packs]).amax(dim=0)
        safe = [bool(R.ring_static_safe(qp, c, g_kfac, plan)) for qp, c in packs]
    lap("safety (host read)")
    outs, lses = [], []
    for i in range(n):
        offsets, kv_true = R.ring_schedule(plan, i, q.device)
        state = R.ring_init(packs[i][0])
        for step in range(n):
            src = (i - step) % n
            state = R.ring_step(state, packs[i][0], packs[src][1], plan, static_safe=safe[i],
                                offsets=offsets[step], kv_true=kv_true[src])
        lap("steps")
        o, lse = R.ring_finish(state, shard(q, i), km, plan, True)
        outs.append(o)
        lses.append(lse)
        lap("finish")
    out = torch.cat(outs, dim=2)[:, :, :S_true, :D_og]
    if return_lse:
        return out, torch.cat(lses, dim=2)[:, :, :S_true], safe
    return out, safe


def b10_classes(torch, calls):
    """The first launch of each kind among ``calls`` of one B10 key: by the
    shift q_start - kv_start against the chunk length (a fully visible,
    diagonal or hidden chunk) and by the chunk's true length (all, part or
    none of it real)."""
    kinds = {}
    for args, kw in calls:
        S = args[1].shape[2]
        kind = []
        if kw.get("offsets") is not None:
            o = [int(x) for x in kw["offsets"].reshape(-1)[:2]]
            sh = o[0] - o[1]
            kind.append("visible" if sh >= S else "diagonal" if sh == 0 else
                        "hidden" if sh <= -S else "partial")
        if kw.get("kv_true") is not None:
            t = int(kw["kv_true"].reshape(-1)[0])
            kind.append("all real" if t >= S else "none real" if t <= 0 else "part real")
        kinds.setdefault(", ".join(kind), (args, kw))
    return kinds


def b10_checks(torch, rec, totals):
    """Every kind of launch of every B10 key the ring paths made, against its
    plain version on sampled heads (KERNEL_BAR, LSE_BAR); one JSON entry per
    key, from its launch with the most work."""
    entries, failures = [], []
    for name in sorted(rec):
        best = None
        for kind, (args, kw) in b10_classes(torch, rec[name]).items():
            try:
                e = attn_kernel_entry(torch, name, args, kw, totals.get(name, 0),
                                      label=f"{name} [{kind}]")
            except SmokeFailure as err:
                failures.append(str(err))
                continue
            if best is None or e["bound_ms"] > best["bound_ms"]:
                best = dict(e, name=name)
        if best is not None:
            entries.append(best)
    check(not failures, f"{len(failures)} B10 launches disagree with their plain versions: "
                        + "; ".join(failures))
    check(bool(entries), "the ring paths launched B10")
    return entries


def ring_phase(torch, st, totals, rec):
    """10a: B10 at published widths over virtual ranks: CogVideoX1.5 joint
    attention on 4 and 8 ranks (padded: the last shards run the device true
    length; on 8 the last shard is all padding) in the default mode (int8
    PV, static), on 4 in the reference's H100 mode (fp8 PV, online; its
    padding-only chunk is phase 17's edge case) and in bf16 PV, against
    single-device ``sageattn``; a Llama-3.1-8B 65,536-token
    causal prefill on 4 ranks (device offsets: 6 hidden, 4 diagonal and 6
    visible chunk pairs), static and, with x60 inputs, the online fallback."""
    from sageattention_tpu_torch.utils.testing import calc_diff
    B, H, Hk, S, D = COG_SHAPE
    q, k, v = realistic_qkv(torch, B, H, Hk, S, D, SEED + 81)
    flash = st.flash_attention(q, k, v)
    single = {"int8": st.sageattn(q, k, v), "fp8": st.sageattn_qk_int8_pv_fp8(q, k, v),
              "bf16": st.sageattn_qk_int8_pv_bf16(q, k, v)}
    runs = [(4, "int8"), (4, "fp8"), (8, "int8"), (4, "bf16")]
    expect = {"int8": "B10-B6-static-kvtrue", "fp8": "B10-B5-fp8-kvtrue",
              "bf16": "B10-B-pvbf16-kvtrue"}
    for n, pv in runs:
        name = f"10a ring CogVideoX1.5 {tuple(q.shape)} on {n} ranks, pv {pv}"
        with rec, vt_copies() as copies:
            (out, safe), _ = counted_path(torch, name, [expect[pv]], {}, totals,
                                          lambda: virtual_ring(torch, q, k, v, n, pv_dtype=pv))
        if pv == "fp8":   # every fp8 ring step on attention_q8_sm90.cu makes one V^T copy
            launched = read_counts()[expect[pv]]
            check(len(copies) == launched, f"{name}: {len(copies)} V^T copies for {launched} "
                                           f"{expect[pv]} launches")
        check(bool(torch.isfinite(out).all()) and out.shape == q.shape,
              f"{name}: finite output {tuple(out.shape)}")
        d_single = calc_diff(out, single[pv])
        if pv == "bf16":
            check(d_single < RING_SINGLE_BAR,
                  f"{name}: vs single-device sageattn_qk_int8_pv_bf16 calc_diff {d_single:.3e} "
                  f"< {RING_SINGLE_BAR}")
        elif pv == "fp8":
            check(d_single < FP8_BAR,
                  f"{name}: vs single-device sageattn_qk_int8_pv_fp8 calc_diff {d_single:.3e} "
                  f"< {FP8_BAR}")
        check_vs(f"{name} vs flash (single-device sageattn: calc_diff {d_single:.3e})", out,
                 flash, "fp8" if pv == "fp8" else "int8")
    del flash, single
    split = {}
    virtual_ring(torch, q, k, v, 4, split=split)
    with ring_recorder(torch, timed=True) as tr:
        split.clear()
        virtual_ring(torch, q, k, v, 4, split=split)
    split["B10 kernels"] = tr.kernel_ms()
    split["of which V widening"] = tr.widen_ms()
    print("     ring time split, CogVideoX1.5 on 4 virtual ranks (int8 PV, static), ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + " (steps = B10 kernels + V-mean add + merge)", flush=True)
    del q, k, v
    torch.cuda.empty_cache()

    B, H, Hk, S, D = LLAMA_LONG
    q, k, v = realistic_qkv(torch, B, H, Hk, S, D, SEED + 82)
    flash = st.flash_attention(q, k, v, is_causal=True)
    name = f"10a ring Llama-3.1-8B prefill {tuple(q.shape)} Hk={Hk} causal on 4 ranks"
    with rec:
        (out, safe), _ = counted_path(
            torch, name, ["B10-B6-static-offsets"], {}, totals,
            lambda: virtual_ring(torch, q, k, v, 4, is_causal=True))
    check(all(safe), f"{name}: the static softmax is safe on every rank")
    check(bool(torch.isfinite(out).all()), f"{name}: finite output")
    d_single = calc_diff(out, st.sageattn(q, k, v, is_causal=True))
    check_vs(f"{name} vs flash (single-device sageattn: calc_diff {d_single:.3e})", out, flash,
             "int8")
    split = {}
    with ring_recorder(torch, timed=True) as tr:
        virtual_ring(torch, q, k, v, 4, is_causal=True, split=split)
    split["B10 kernels"] = tr.kernel_ms()
    split["of which V widening"] = tr.widen_ms()
    print(f"     ring time split, {name}, ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)
    del q, k, v, flash, out
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(SEED + 83)
    adv = [(torch.randn(B, h, S, D, generator=g, device="cuda") * 60).to(torch.bfloat16)
           for h in (H, Hk, Hk)]
    name = "10a ring Llama-3.1-8B prefill x60 inputs causal on 4 ranks"
    before = dict(totals)
    with rec:
        (out, safe), _ = counted_path(
            torch, name, ["B10-B6-online-offsets"], {}, totals,
            lambda: virtual_ring(torch, *adv, 4, is_causal=True))
    counts = _path_counts(before, totals)
    check(not any(safe) and counts.get("B10-B6-static-offsets", 0) == 0,
          f"{name}: every rank refused the static softmax and ran the online fallback")
    check(bool(torch.isfinite(out).all()), f"{name}: finite output")
    d = calc_diff(out, st.flash_attention(*adv, is_causal=True))
    d_single = calc_diff(st.sageattn(*adv, is_causal=True), st.flash_attention(*adv, is_causal=True))
    check(d < RING_ADV_BAR, f"{name}: vs flash calc_diff {d:.3e} < {RING_ADV_BAR} (single-device "
                            f"sageattn {d_single:.3e})")
    del adv, out
    torch.cuda.empty_cache()


def ring_bwd_grads(torch, q, k, v, w, n, o, lse):
    """The ring backward over ``n`` virtual ranks from the saved forward
    ``(o, lse)``: the q side of each shard (q, dO, lse, di) against every
    home K/V shard (the per-pair C1/C2 with the given di and f32 outputs;
    hidden pairs skipped), dQ summed at the q side's shard and dK/dV at the
    home shard.  Returns the global (dq, dk, dv)."""
    from sageattention_tpu_torch.parallel import ring as R
    plan = R.ring_setup(q, k, v, n, is_causal=True, pv_dtype="bf16")[0]
    Sl = plan.S
    sh = lambda x, i: x[:, :, i * Sl:(i + 1) * Sl]  # noqa: E731
    chunks = [{"q": sh(q, i).contiguous(), "do": sh(w, i).contiguous(),
               "lse": sh(lse, i).contiguous(),
               "di": (sh(w, i).float() * sh(o, i).float()).sum(-1)} for i in range(n)]
    dq = [torch.zeros(sh(q, i).shape, dtype=torch.float32, device="cuda") for i in range(n)]
    dk = [torch.zeros(sh(k, i).shape, dtype=torch.float32, device="cuda") for i in range(n)]
    dv = [torch.zeros_like(x) for x in dk]
    for idx in range(n):   # the home shard of K/V
        kb, vb = sh(k, idx).contiguous(), sh(v, idx).contiguous()
        for step in range(n):
            src = (idx - step) % n
            pair = R.ring_bwd_pair(chunks[src], kb, vb, src, idx, plan, quantized=False)
            if pair is not None:
                dq[src] += pair[0]
                dk[idx] += pair[1]
                dv[idx] += pair[2]
    return [torch.cat(x, dim=2) for x in (dq, dk, dv)]


def ring_bwd_phase(torch, st, totals, rec):
    """10b: the ring backward at Llama-3-8B width, causal, on 4 virtual
    ranks, against single-device ``sageattn_qk_int8_pv_bf16``'s gradients
    (``_SageAttnFn``) at ``RING_GRAD_BAR``: from the single-device
    forward's saved (o, lse), which isolates the backward's decomposition,
    and end to end through the ring's own forward on
    ``tests/test_parallel.py``'s standard normal inputs.

    End to end on activation-like inputs that bar does not hold, and the
    ring is not the cause: every quantized forward's gradients sit a few
    1e-4 from the f32 exact gradient there, each in its own direction.  The
    straight-through backward recomputes P from the exact Q and K with the
    forward's lse and takes di from its output, so in peaked rows the
    forwards' small differences in (o, lse) grow into distances of several
    1e-4 in dQ and dK.  The witness: single-device ``sageattn`` with
    ``k_scale_mode="head"`` (one K scale per head over the sequence; the
    ring's default folds one per head and shard) reads at least as far from
    ``sageattn_qk_int8_pv_bf16`` (one per 16-row group, ``k_scale_mode``'s
    default "fine", ``core.py:226``) as the ring does.  Both distances are
    printed, and the ring's distance from the f32 exact gradient on the
    first KV head's group is held to ``RING_EXACT_RATIO`` times each
    single-device call's."""
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import backward as tbwd
    from sageattention_tpu_torch.utils.testing import calc_diff
    B, H, Hk, S, D = LLAMA_BWD
    n, G = 4, H // Hk
    g = torch.Generator(device="cuda").manual_seed(SEED + 85)
    w = torch.randn(B, H, S, D, generator=g, device="cuda").to(torch.bfloat16)
    inputs = {"activation-like": realistic_qkv(torch, B, H, Hk, S, D, SEED + 84),
              "standard normal": [torch.randn(B, h, S, D, generator=g, device="cuda").to(
                  torch.bfloat16) for h in (H, Hk, Hk)]}

    def single_grads(q, k, v, entry=st.sageattn_qk_int8_pv_bf16, **kw):
        with torch.enable_grad():
            xs = [x.detach().requires_grad_() for x in (q, k, v)]
            return torch.autograd.grad(entry(*xs, is_causal=True, **kw), xs, w)

    def ring_grads(q, k, v):   # end to end: the ring's forward, then its backward
        o, lse, _ = virtual_ring(torch, q, k, v, n, return_lse=True, is_causal=True,
                                 pv_dtype="bf16")
        return ring_bwd_grads(torch, q, k, v, w, n, o, lse)

    def run():
        q, k, v = inputs["activation-like"]
        single = single_grads(q, k, v)
        head = single_grads(q, k, v, st.sageattn, pv_dtype="bf16", smooth_v=False,
                            k_scale_mode="head")
        o, lse = core._sage_attention(q, k, v, is_causal=True, smooth_v=False, pv_dtype="bf16",
                                      return_lse=True)
        saved.extend((o, lse))
        ring = ring_grads(q, k, v)
        res = [("backward from the single-device forward, activation-like",
                ring_bwd_grads(torch, q, k, v, w, n, o, lse), single, RING_GRAD_BAR),
               ("end to end, activation-like (reading)", ring, single, None),
               ("single-device sageattn k_scale_mode=head in the ring's place, activation-like "
                "(reading)", head, single, None)]
        exact = exact_attn_grads(torch, q[0, :G], k[0, 0], v[0, 0], w[0, :G],
                                 band_keep(torch, S, 0, S))[0]
        near = {what: [calc_diff(a[0, :G] if a.shape[1] == H else a[0, 0], r)
                       for a, r in zip(grads, exact)]
                for what, grads in (("ring", ring), ("fine", single), ("head", head))}
        q, k, v = inputs["standard normal"]
        res.append(("end to end, standard normal", ring_grads(q, k, v), single_grads(q, k, v),
                    RING_GRAD_BAR))
        return res, near

    saved = []
    name = f"10b ring backward Llama-3-8B width {(B, H, S, D)} Hk={Hk} causal on {n} ranks"
    with rec:
        (res, near), _ = counted_path(torch, name, ["C1-bf16-causal", "C2-bf16-causal", "C1-bf16",
                                                    "C2-bf16"], {}, totals, run)
    for what, got, single, bar in res:
        ds = [calc_diff(a, b) for a, b in zip(got, single)]
        text = (f"{name}, {what}: dq/dk/dv vs single-device sageattn_qk_int8_pv_bf16 calc_diff "
                + "/".join(f"{d:.3e}" for d in ds))
        check(all(bool(torch.isfinite(a).all()) for a in got), f"{text}: finite")
        if bar is not None:
            check(max(ds) < bar, f"{text} < {bar}")
    print(f"     {name}, activation-like, KV head 0's q heads vs the f32 exact gradient, dq/dk/dv "
          "calc_diff: " + "; ".join(f"{what} " + "/".join(f"{d:.3e}" for d in ds)
                                    for what, ds in near.items()), flush=True)
    for mode, bar in RING_EXACT_RATIO.items():
        ratio = max(r / s for r, s in zip(near["ring"], near[mode]))
        check(ratio <= bar, f"{name}, activation-like: the ring's distance from the f32 exact "
                            f"gradient over single-device {mode} K scales', worst of dq/dk/dv "
                            f"{ratio:.3f} <= {bar}")
    # a diagonal and a visible pair (given di, f32 out) against the plain version,
    # on q heads 0-1 and KV head 0 of the activation-like inputs
    (q, k, v), (o, lse) = inputs["activation-like"], saved
    Sl, nq = S // n, 2
    sh = lambda x, i: x[:, :nq, i * Sl:(i + 1) * Sl]  # noqa: E731
    for what, src, home in (("diagonal", 1, 1), ("visible", 2, 1)):
        di = (sh(w, src).float() * sh(o, src).float()).sum(-1)
        pa = tbwd.prepare(sh(q, src), sh(k, home)[:, :1], sh(v, home)[:, :1], None, sh(lse, src),
                          sh(w, src), sm_scale=D ** -0.5, di=di)
        pa.update(causal=src == home, out_dtype=torch.float32)
        got = tbwd.attention_backward_kernel(**pa)
        plain = tbwd.attention_backward_plain(**pa)
        ds = [calc_diff(a, b) for a, b in zip(got, plain)]
        check(max(ds) <= KERNEL_BAR, f"{name}: a {what} pair (C1 + C2, given di, f32 out) vs "
                                     f"plain on {nq} q heads: calc_diff " + "/".join(
                                         f"{d:.3e}" for d in ds) + f" <= {KERNEL_BAR}")
    del res, saved, inputs
    torch.cuda.empty_cache()


def ring_dit_phase(torch, st, totals, rec):
    """10c: the CogVideoX1.5-width DiT (2 of 42 blocks, random weights from
    the seed) with its attention the 4-rank virtual ring, against the same
    DiT with single-device ``sageattn`` and with flash."""
    from sageattention_tpu_torch.models.dit import DiT, DiTConfig
    from sageattention_tpu_torch.utils.testing import calc_diff
    cfg = DiTConfig(hidden=3072, heads=48, depth=2, patch=2, in_channels=16, text_dim=4096,
                    text_len=226, frames=13, height=60, width=90, zero_init_gates=False)
    model = DiT(cfg, device="cuda").init_weights(SEED)
    g = torch.Generator(device="cuda").manual_seed(SEED + 86)
    lat = torch.randn(1, cfg.frames, cfg.height, cfg.width, cfg.in_channels, generator=g,
                      device="cuda")
    txt = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device="cuda")
    tt = torch.full((1,), 500, dtype=torch.int32, device="cuda")

    def ring_attn(q, k, v, *a, **kw):   # NHD, as the DiT calls it
        out, _ = virtual_ring(torch, *(x.transpose(1, 2) for x in (q, k, v)), 4)
        return out.transpose(1, 2)

    def forward(attn):
        for block in model.blocks:
            block.attn_fn = attn
        return model(lat, txt, tt)

    name = f"10c CogVideoX1.5-width DiT (2 of 42 blocks, S = {cfg.text_len + cfg.video_tokens}) " \
           "with the 4-rank ring"
    with rec:
        out, _ = counted_path(torch, name, ["B10-B6-static-kvtrue"], {}, totals,
                              lambda: forward(ring_attn))
    single = forward(lambda q, k, v, *a, **kw: st.sageattn(q, k, v, tensor_layout="NHD"))
    flash = forward(lambda q, k, v, *a, **kw: st.flash_attention(q, k, v, tensor_layout="NHD"))
    check(bool(torch.isfinite(out.float()).all()) and out.shape == lat.shape,
          f"{name}: finite output {tuple(out.shape)}")
    d = calc_diff(out, single)
    check(d < SAGE_BAR, f"{name}: vs single-device sageattn calc_diff {d:.3e} < {SAGE_BAR}")
    check_vs(f"{name} vs flash", out, flash, "int8")
    del model, out, single, flash
    torch.cuda.empty_cache()


def ring_group_phase(torch, st, totals, rec):
    """10d: the public entries through a real NCCL process group of world
    size 1 (one card: NCCL takes one rank per card), initialised here with a
    localhost TCP store: ``ring_sageattn`` at the CogVideoX1.5 shape (padded,
    so B10 launches), ``ulysses_sageattn``, ``ring_sageattn(differentiable=
    True)`` forward and backward at Llama-3-8B width, and the example
    ``parallel_dit_infer`` at CogVideoX1.5 width, 2 blocks.  The hops of the
    ring run only on several cards (``tools/ring_cards.py``)."""
    import socket
    import torch.distributed as dist
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.examples import parallel_dit_infer
    from sageattention_tpu_torch.parallel import make_mesh, ring_sageattn, ulysses_sageattn
    from sageattention_tpu_torch.utils.testing import calc_diff
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh(dp=1, sp=1, tp=1, device_type="cuda")
        B, H, Hk, S, D = COG_SHAPE
        q, k, v = realistic_qkv(torch, B, H, Hk, S, D, SEED + 87)
        name = f"10d ring_sageattn through NCCL (world size 1) at {tuple(q.shape)}"
        before = dict(totals)
        with rec:   # static or online, as the predictive check decides for these inputs
            out, _ = counted_path(torch, name, [], {}, totals,
                                  lambda: ring_sageattn(q, k, v, mesh))
        b10 = {key: n for key, n in _path_counts(before, totals).items()
               if key.startswith("B10-") and n}
        check(bool(b10), f"{name}: launched B10 ({b10})")
        check_vs(f"{name} vs flash", out, st.flash_attention(q, k, v), "int8")
        d = calc_diff(out, st.sageattn(q, k, v))
        check(d < SAGE_BAR, f"{name}: vs sageattn calc_diff {d:.3e} < {SAGE_BAR}")
        name = f"10d ulysses_sageattn through NCCL (world size 1) at {tuple(q.shape)}"
        out, _ = counted_path(torch, name, ["B6-static"], {}, totals,
                              lambda: ulysses_sageattn(q, k, v, mesh))
        d = calc_diff(out, core._sage_attention(q, k, v, pv_dtype="int8"))
        check(d < 1e-6, f"{name}: the single-device pipeline on the same heads, calc_diff "
                        f"{d:.3e} < 1e-6 (tests/test_parallel.py:74)")
        del q, k, v, out
        ring_grad_group(torch, st, totals, rec, mesh, ring_sageattn)
        name = "10d parallel_dit_infer (ring, CogVideoX1.5 width, 2 blocks, 2 steps)"
        before = dict(totals)
        with rec:
            res, _ = counted_path(torch, name, [], {}, totals,
                                  lambda: parallel_dit_infer.main(["--steps", "2"]))
        check(any(key.startswith("B10-") and n for key, n in _path_counts(before, totals).items()),
              f"{name}: launched B10")
        check(res["finite"] and res["calc_diff"] < SAGE_BAR,
              f"{name}: {res['ms']:.1f} ms per denoise, calc_diff vs the single-device DiT "
              f"{res['calc_diff']:.3e} < {SAGE_BAR}")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()


def ring_grad_group(torch, st, totals, rec, mesh, ring_sageattn):
    """10d: ``ring_sageattn(differentiable=True)`` (``_RingFn``, whose
    backward is ``_ring_bwd_body``) through the one-rank group at Llama-3-8B
    width, causal, on standard normal inputs: its output and gradients
    against the same ring composed over one virtual rank (``KERNEL_BAR``)
    and against single-device ``sageattn_qk_int8_pv_bf16``'s gradients
    (``RING_GRAD_BAR``, as 10b)."""
    from sageattention_tpu_torch.utils.testing import calc_diff
    B, H, Hk, S, D = LLAMA_BWD
    g = torch.Generator(device="cuda").manual_seed(SEED + 88)
    q, k, v, w = (torch.randn(B, h, S, D, generator=g, device="cuda").to(torch.bfloat16)
                  for h in (H, Hk, Hk, H))

    def fwd_bwd(entry, **kw):
        with torch.enable_grad():
            xs = [x.detach().requires_grad_() for x in (q, k, v)]
            out = entry(*xs, is_causal=True, **kw)
            return [out.detach()] + list(torch.autograd.grad(out, xs, w))

    name = (f"10d ring_sageattn(differentiable=True) through NCCL (world size 1) at "
            f"{tuple(q.shape)} Hk={Hk} causal")
    with rec:
        got, _ = counted_path(torch, name, ["B10-B-pvbf16-offsets", "C1-bf16-causal",
                                            "C2-bf16-causal"], {}, totals,
                              lambda: fwd_bwd(ring_sageattn, mesh=mesh, pv_dtype="bf16",
                                              differentiable=True))
    check(all(bool(torch.isfinite(x).all()) for x in got), f"{name}: finite output and gradients")
    o, lse, _ = virtual_ring(torch, q, k, v, 1, return_lse=True, is_causal=True, pv_dtype="bf16")
    ds = [calc_diff(a, b) for a, b in zip(got, [o] + ring_bwd_grads(torch, q, k, v, w, 1, o, lse))]
    check(max(ds) <= KERNEL_BAR, f"{name}: o/dq/dk/dv vs the ring composed over one virtual rank, "
                                 "calc_diff " + "/".join(f"{d:.3e}" for d in ds)
                                 + f" <= {KERNEL_BAR}")
    single = fwd_bwd(st.sageattn_qk_int8_pv_bf16)
    ds = [calc_diff(a, b) for a, b in zip(got[1:], single[1:])]
    check(max(ds) < RING_GRAD_BAR, f"{name}: dq/dk/dv vs single-device sageattn_qk_int8_pv_bf16 "
                                   "calc_diff " + "/".join(f"{d:.3e}" for d in ds)
                                   + f" < {RING_GRAD_BAR}")
    del q, k, v, w, got, o, lse, single
    torch.cuda.empty_cache()


def run_ring(torch, st, totals):
    """Phase 10, the paths of slice 6 (each counted on its own), then every
    B10 launch kind they made against its plain version."""
    rec = ring_recorder(torch)
    with torch.no_grad():
        ring_phase(torch, st, totals, rec)
    ring_bwd_phase(torch, st, totals, rec)
    with torch.no_grad():
        ring_dit_phase(torch, st, totals, rec)
        ring_group_phase(torch, st, totals, rec)
        entries = b10_checks(torch, rec.calls, totals)
    rec.calls.clear()
    torch.cuda.empty_cache()
    return entries


# ----------------------------------------- slice 7: the last TPU kernels ----

SRC_LOWBIT = "sageattention_tpu_torch/csrc/flash_sm90.cu"   # B4-fp4: its FP4 mode
# HunyuanVideo's published transformer (hidden 3072, 24 heads, patch (1, 2, 2),
# 16 latent channels, text_states_dim 4096, text_len 256) at 720 x 1280 and
# 129 frames: 33 x 90 x 160 latents, S = 256 + 33 * 45 * 80 = 119,056 tokens;
# its DiT cut to 2 blocks
HUNYUAN_DIT = dict(hidden=3072, heads=24, depth=2, patch=2, in_channels=16, text_dim=4096,
                   text_len=256, frames=33, height=90, width=160)
HUNYUAN_SHAPE = (1, 24, 24, 119056, 128)     # B, Hq, Hk, S, D
LLAMA_128K = (1, 32, 8, 131072, 128)         # Llama-3.1-8B at its full context
STATS_TOL = 1e-6     # A3's stats vs plain: rtol, with this atol for means that cancel
# sageattn3_blackwell vs the S x S sageattn3 on a sampled head
# (tests/test_lowbit.py: the tiled simulation vs the jnp one)
SA3_BAR = 5e-2
# the CogVideoX1.5-width DiT of phase 3 (2 of 42 blocks), for the FP4 simulation
COG_DIT = dict(hidden=3072, heads=48, depth=2, patch=2, in_channels=16, text_dim=4096,
               text_len=226, frames=13, height=60, width=90)
FP4_CAUSAL_S = 8192   # length of B4-fp4's causal checks, in full


def kernel_ms(fn):
    """Median ms per call of 20 calls (CUDA events), after 3 warm calls."""
    from sageattention_tpu_torch.utils.testing import time_fn
    return time_fn(fn, warmup=3, reps=20) * 1e3


def trials_ms(torch, fn):
    """Median ms per call over 3 trials of 3 calls (CUDA events), after one
    warm call: for calls of about a second."""
    from sageattention_tpu_torch.utils.testing import time_fn
    return time_fn(fn, warmup=1, reps=3) * 1e3


def two_pass_prep(torch, k, v, s_true):
    """The pipeline's two-pass K/V prep: A3, the scales in torch, A4.
    Returns the stats ``(km, k_amax, vm, v_amax)`` and A4's outputs."""
    from sageattention_tpu_torch.core import _scale_of
    from sageattention_tpu_torch.ops import quant_fused as qf
    stats = qf.channel_stats2(k, v, s_true)
    km, ka, vm, va = stats
    ks = _scale_of(ka.amax(dim=3, keepdim=True), qf._INV127)
    return stats, qf.quant_kv(k, ks, km, v, _scale_of(va, qf._INV127), vm, with_capmax=True,
                              s_true=s_true)


def row_blocks(S):
    """Query rows of the sampled 64-row blocks: the first, two middle ones
    and the last (cut by the pad boundary when 64 does not divide S)."""
    last = (S - 1) // 64 * 64
    starts = sorted({0, S // 3 // 64 * 64, 2 * S // 3 // 64 * 64, last})
    return [r for r0 in starts for r in range(r0, min(r0 + 64, S))]


def rows_oracle(torch, q, k, v, rows, causal):
    """f32 attention of one head ``[S, D]`` on the card (TF32 off) for the
    query ``rows`` only, against every key."""
    from sageattention_tpu_torch.ops.reference import _no_tf32
    idx = torch.tensor(rows, device=q.device)
    with _no_tf32():
        s = q[idx].float() @ k.float().T * q.shape[-1] ** -0.5
        if causal:
            s = s.masked_fill(torch.arange(k.shape[0], device=q.device)[None] > idx[:, None],
                              float("-inf"))
        return torch.softmax(s, dim=-1) @ v.float()


def exact_counts(what, counts, want):
    check(all(counts.get(k, 0) == n for k, n in want.items()),
          f"{what}: launches " + ", ".join(f"{k} {counts.get(k, 0)}" for k in want)
          + " (want " + ", ".join(f"{k} {n}" for k, n in want.items()) + ")")


def flash_oracle_check(torch, what, flash, q, k, v, causal):
    """Flash against the f32 oracle on the first and last q head, on the
    sampled row blocks."""
    from sageattention_tpu_torch.utils.testing import calc_diff
    rows = row_blocks(q.shape[2])
    G = q.shape[1] // k.shape[1]
    d = max(calc_diff(flash[0, h, rows], rows_oracle(torch, q[0, h], k[0, h // G], v[0, h // G],
                                                     rows, causal))
            for h in (0, q.shape[1] - 1))
    check(d < ORACLE_BAR, f"{what}: flash vs f32 oracle on heads 0,{q.shape[1] - 1}, "
                          f"{len(rows)} sampled rows: {d:.3e} < {ORACLE_BAR}")


def long_b1_check(torch, what, args, kw, timer=trials_ms):
    """A long B1 launch on all heads against its plain version on the
    sampled heads at full length (the plain version walks query-row chunks:
    no S x S matrix), then its kernel time (by ``timer``: 3 trials of 3
    launches).  Returns (max_abs_err, plain ms, kernel ms, bound)."""
    from sageattention_tpu_torch.ops.attention import attention_kernel, attention_plain
    from sageattention_tpu_torch.utils.testing import calc_diff
    q, k = args[0], args[1]
    out = attention_kernel(*args, **kw)
    plain_ms, heads, errs = None, [], []
    for sub, skw, hs in sampled_heads(args, kw):
        a = heads_of(out, hs)
        b, ms = timed_call(torch, lambda: attention_plain(*sub, **skw))
        plain_ms = ms if plain_ms is None else plain_ms
        kept, note = static_kept_rows(torch, a, b, q.shape[2])
        d = calc_diff(a[0][kept], b[0][kept])
        err = float((a[0][kept].float() - b[0][kept].float()).abs().max())
        errs.append(err)
        heads.append(f"{hs.start}-{hs.stop - 1}")
        check(d < KERNEL_BAR, f"{what} B1 vs plain on q heads {heads[-1]}{note}: calc_diff "
                              f"{d:.3e} < {KERNEL_BAR}, max_abs {err:.3e}")
        del a, b
    ms = timer(torch, lambda: attention_kernel(*args, **kw))
    moved = nbytes(*(x for x in args if isinstance(x, torch.Tensor)),
                   *(x for x in kw.values() if isinstance(x, torch.Tensor)),
                   *(x for x in out if x is not None))
    bound = attn_bound(args[3], q, k, moved)
    print(f"     {what} B1 at {tuple(q.shape)} Hk={k.shape[1]} causal={args[3].causal}: kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms on q heads {heads[0]}, bound "
          f"{bound[0]:.3f} ms ({bound[1]}), {fwd_source(args[3], q)}", flush=True)
    return max(errs), plain_ms, ms, bound


def hunyuan_phase(torch, st, totals):
    """11a: HunyuanVideo 720p x 129 frames joint attention, (1, 24, 119,056,
    128): ``sageattn`` (the two-pass prep: A3, A4, then B1), the H100 mode
    and flash; A3 + A4 against A1 + A2 on its K and V."""
    from sageattention_tpu_torch.ops import quant_fused as qf
    from sageattention_tpu_torch.utils.testing import calc_diff, time_fn
    B, H, Hk, S, D = HUNYUAN_SHAPE
    q, k, v = realistic_qkv(torch, B, H, Hk, S, D, SEED + 41)
    what = f"HunyuanVideo ({B},{H},{S},{D})"
    # name: (call, launch keys it must run, exact launch counts)
    calls = {"sageattn": (lambda: st.sageattn(q, k, v), ("A3", "A4", "B1"),
                          dict(A1=0, A2=0, A3=1, A4=1)),
             "sageattn fp8 fine": (lambda: st.sageattn(q, k, v, pv_dtype="fp8",
                                                       k_scale_mode="fine"),
                                   ("A5", "A6-group", "B5-fp8"), dict(A1=0, A2=0, A3=0, A4=0)),
             "flash": (lambda: st.flash_attention(q, k, v), ("B4",), dict(B4=1))}
    outs, recs = {}, {}
    for name, (fn, expect, want) in calls.items():
        outs[name], recs[name] = counted_path(torch, f"{what} {name}", expect, {}, totals, fn)
        exact_counts(f"{what} {name}", read_counts(), want)
    ref = outs["flash"]
    check(bool(torch.isfinite(outs["sageattn"]).all()) and outs["sageattn"].shape == q.shape,
          f"{what} sageattn: finite output {tuple(outs['sageattn'].shape)}")
    d = calc_diff(outs["sageattn"], ref)
    check(1.0 - d >= COS_BAR, f"{what} sageattn vs flash: cossim {1.0 - d:.6f} >= {COS_BAR}")
    d = calc_diff(outs["sageattn fp8 fine"], ref)
    check(d < FP8_BAR, f"{what} H100 mode (pv fp8, fine K) vs flash: calc_diff {d:.3e} < "
                       f"{FP8_BAR}")
    flash_oracle_check(torch, what, ref, q, k, v, False)
    del outs
    for name, (fn, _, _) in calls.items():
        print(f"     {what}: {name} {trials_ms(torch, fn):.3f} ms (3 trials of 3 calls)",
              flush=True)
    long_b1_check(torch, what, *recs["sageattn"]["B1"])
    del recs

    # A3 + A4 against A1 + A2 on the same K and V: JAX's route's evidence
    (km, ka, vm, va), two = two_pass_prep(torch, k, v, S)
    k1 = qf.prep_k_onepass(k, S, with_capmax=True)
    v1 = qf.prep_v_onepass(v, S)
    bad_k = int((two[0] != k1[0]).sum())
    bad_v = int((two[1] != v1[0]).sum())
    same_stats = (torch.equal(km, k1[1]) and torch.equal(ka.amax(3, keepdim=True), k1[2])
                  and torch.equal(vm, v1[1]) and torch.equal(va, v1[2])
                  and torch.equal(two[2], k1[3]))
    check(bad_k == bad_v == 0 and same_stats,
          f"{what}: A3 + A4 vs A1 + A2: {bad_k} K and {bad_v} V codes differ, stats and capmax "
          f"{'equal' if same_stats else 'DIFFER'}")
    two_pass = lambda: two_pass_prep(torch, k, v, S)  # noqa: E731
    one_pass = lambda: (qf.prep_k_onepass(k, S, with_capmax=True),  # noqa: E731
                        qf.prep_v_onepass(v, S))
    t = {}
    for _ in range(2):   # in turns: one, two, two, one
        for name, fn in (("one", one_pass), ("two", two_pass)) if not t else (
                ("two", two_pass), ("one", one_pass)):
            t.setdefault(name, []).append(time_fn(fn, warmup=2, reps=10) * 1e3)
    print(f"     {what} K/V prep: two-pass (A3 + glue + A4) {min(t['two']):.3f} ms, one-pass "
          f"(A1 + A2) {min(t['one']):.3f} ms (each the best of 2 medians of 10)", flush=True)
    return q, k, v


def hunyuan_dit_phase(torch, st, totals):
    """11a: the HunyuanVideo-width DiT (2 blocks, random weights from the
    seed) at 119,056 tokens, with int8 attention and with flash."""
    from sageattention_tpu_torch.models import DiT, DiTConfig, sage_dot_product_attention
    from sageattention_tpu_torch.utils.testing import calc_diff
    cfg = DiTConfig(**HUNYUAN_DIT, zero_init_gates=False)
    model = DiT(cfg, device="cuda").init_weights(SEED)
    g = torch.Generator(device="cuda").manual_seed(SEED + 42)
    lat = torch.randn(1, cfg.frames, cfg.height, cfg.width, cfg.in_channels, generator=g,
                      device="cuda")
    txt = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device="cuda")
    tt = torch.full((1,), 500, device="cuda", dtype=torch.int32)
    S = cfg.text_len + cfg.video_tokens
    outs, walls = {}, {}
    for mode, fn, expect, want in (
            ("int8", sage_dot_product_attention, ("A3", "A4", "B1"), dict(A1=0, A2=0, A3=2, A4=2)),
            ("flash", functools.partial(st.flash_attention, tensor_layout="NHD"), ("B4",),
             dict(B4=2))):
        for b in model.blocks:
            b.attn_fn = fn
        outs[mode], _ = counted_path(torch, f"HunyuanVideo DiT {mode}", expect, {}, totals,
                                     lambda: model(lat, txt, tt))
        exact_counts(f"HunyuanVideo DiT {mode}", read_counts(), want)
        walls[mode] = time_once(torch, lambda: model(lat, txt, tt))
    for mode, out in outs.items():
        check(bool(torch.isfinite(out.float()).all()) and out.shape == lat.shape,
              f"HunyuanVideo DiT {mode} (2 blocks, S={S}): finite output {tuple(out.shape)}")
    d = calc_diff(outs["int8"], outs["flash"])
    check(1.0 - d >= COS_BAR, f"HunyuanVideo DiT int8 vs flash: cossim {1.0 - d:.6f} >= {COS_BAR}")
    print("     HunyuanVideo DiT forward (2 blocks, warm): " + ", ".join(
        f"{m} {ms:.1f} ms" for m, ms in walls.items()), flush=True)


def llama_128k_phase(torch, st, totals):
    """11a: a Llama-3.1-8B causal prefill at its full context, (1, 32/8,
    131,072, 128): the two-pass prep with GQA, causal, and no pad rows."""
    from sageattention_tpu_torch.utils.testing import calc_diff
    B, H, Hk, S, D = LLAMA_128K
    q, k, v = realistic_qkv(torch, B, H, Hk, S, D, SEED + 43)
    what = f"Llama-3.1-8B ({B},{H}/{Hk},{S},{D}) causal"
    calls = {"sageattn": (lambda: st.sageattn(q, k, v, is_causal=True), ("A3", "A4", "B1"),
                          dict(A1=0, A2=0, A3=1, A4=1)),
             "flash": (lambda: st.flash_attention(q, k, v, is_causal=True), ("B4",), dict(B4=1))}
    outs, recs = {}, {}
    for name, (fn, expect, want) in calls.items():
        outs[name], recs[name] = counted_path(torch, f"{what} {name}", expect, {}, totals, fn)
        exact_counts(f"{what} {name}", read_counts(), want)
    check(bool(torch.isfinite(outs["sageattn"]).all()), f"{what} sageattn: finite output")
    d = calc_diff(outs["sageattn"], outs["flash"])
    check(1.0 - d >= COS_BAR, f"{what} sageattn vs flash: cossim {1.0 - d:.6f} >= {COS_BAR}")
    flash_oracle_check(torch, what, outs["flash"], q, k, v, True)
    del outs
    for name, (fn, _, _) in calls.items():
        print(f"     {what}: {name} {time_once(torch, fn):.3f} ms (one warm call)", flush=True)
    long_b1_check(torch, what, *recs["sageattn"]["B1"], timer=time_once)


def fp4_phase(torch, st, totals):
    """11b: SageAttention3's FP4 simulation, ``sageattn3_blackwell``, at
    CogVideoX1.5 (1, 48, 17,776, 64) and at the HunyuanVideo shape, against
    flash and, on a sampled head, the S x S ``sageattn3``; the CogVideoX1.5-
    width DiT (2 blocks) with it as its attention.  Returns the launches'
    inputs by shape."""
    from sageattention_tpu_torch.models import DiT, DiTConfig
    from sageattention_tpu_torch.utils.testing import calc_diff
    recs = {}
    for label, (B, H, Hk, S, D), seed in (("CogVideoX1.5", COG_SHAPE, SEED + 51),
                                          ("HunyuanVideo", HUNYUAN_SHAPE, SEED + 52)):
        q, k, v = realistic_qkv(torch, B, H, Hk, S, D, seed)
        what = f"{label} ({B},{H},{S},{D}) sageattn3_blackwell"
        out, recs[label] = counted_path(torch, what, ("B4-fp4",), {}, totals,
                                        lambda: st.sageattn3_blackwell(q, k, v))
        exact_counts(what, read_counts(), {"B4-fp4": 1, "B4": 0})
        args = recs[label]["B4-fp4"][0]
        check(fwd_source(args[3], args[0]) == SRC_LOWBIT, f"{what}: B4-fp4 ran on {SRC_LOWBIT}")
        check(bool(torch.isfinite(out).all()) and out.shape == q.shape,
              f"{what}: finite output {tuple(out.shape)}")
        d = calc_diff(out, st.flash_attention(q, k, v))
        print(f"     {what}: calc_diff vs flash {d:.3e}", flush=True)
        if label == "CogVideoX1.5":
            ref = st.sageattn3(q[:, :1], k[:, :1], v[:, :1])
            d = calc_diff(out[:, :1], ref)
            check(d < SA3_BAR, f"{what} vs the S x S sageattn3 on head 0: calc_diff {d:.3e} "
                               f"< {SA3_BAR}")
            del ref
        del out
        call = lambda: st.sageattn3_blackwell(q, k, v)  # noqa: E731
        t, how = ((trials_ms(torch, call), "3 trials of 3 calls") if label == "CogVideoX1.5"
                  else (time_once(torch, call), "one warm call"))
        print(f"     {what}: {t:.3f} ms a call ({how}; the FP4 quantizers in plain torch and "
              "one B4-fp4 launch)", flush=True)
        del q, k, v

    cfg = DiTConfig(**COG_DIT, zero_init_gates=False)
    model = DiT(cfg, device="cuda").init_weights(SEED)
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    lat = torch.randn(1, cfg.frames, cfg.height, cfg.width, cfg.in_channels, generator=g,
                      device="cuda")
    txt = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device="cuda")
    tt = torch.full((1,), 500, device="cuda", dtype=torch.int32)

    def sa3_nhd(q, k, v, *a, **kw):   # the DiT calls NHD; sageattn3 takes HND
        return st.sageattn3_blackwell(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2)).transpose(1, 2)

    outs = {}
    for mode, fn in (("fp4", sa3_nhd),
                     ("flash", functools.partial(st.flash_attention, tensor_layout="NHD"))):
        for b in model.blocks:
            b.attn_fn = fn
        outs[mode], _ = counted_path(torch, f"CogVideoX1.5 DiT {mode}",
                                     ("B4-fp4",) if mode == "fp4" else ("B4",), {}, totals,
                                     lambda: model(lat, txt, tt))
    check(bool(torch.isfinite(outs["fp4"].float()).all()) and outs["fp4"].shape == lat.shape,
          f"CogVideoX1.5 DiT with sageattn3_blackwell: finite output {tuple(lat.shape)}")
    print(f"     CogVideoX1.5 DiT, sageattn3_blackwell vs flash attention: calc_diff "
          f"{calc_diff(outs['fp4'], outs['flash']):.3e}", flush=True)
    return recs


def fp4_kernel_entry(torch, recs, launches):
    """B4-fp4 against its plain version: two heads at CogVideoX1.5 in full
    (the plain version walks query-row chunks), the sampled row blocks of
    one head at the HunyuanVideo shape (the launch's other rows are
    independent of them), and causal at head dims 64, 128 and 256 in full;
    its time at both main-path shapes."""
    from sageattention_tpu_torch.ops.attention import attention_kernel, attention_plain
    from sageattention_tpu_torch.utils.testing import calc_diff, time_fn
    cases, errs = [], []
    args, kw = recs["CogVideoX1.5"]["B4-fp4"]
    cases.append(("CogVideoX1.5, heads 0-1", tuple(x[:, :2] for x in args[:3]) + tuple(args[3:])))
    hargs, _ = recs["HunyuanVideo"]["B4-fp4"]
    idx = torch.tensor(row_blocks(hargs[0].shape[2]), device="cuda")
    sub = (hargs[0][:, :1, idx], hargs[1][:, :1], hargs[2][:, :1])
    cases.append((f"HunyuanVideo, head 0, {len(idx)} sampled rows", sub + tuple(hargs[3:])))
    for D in (64, 128, 256):
        q, k, v = realistic_qkv(torch, 1, 4, 4, FP4_CAUSAL_S, D, SEED + 53 + D)
        cfg = dataclasses.replace(args[3], causal=True, kv_len=FP4_CAUSAL_S, sm_scale=D ** -0.5)
        cases.append((f"causal (1,4,{FP4_CAUSAL_S},{D})", (q, k, v, cfg) + tuple(args[4:])))
    plain_ms = []
    for what, a in cases:
        check(fwd_source(a[3], a[0]) == SRC_LOWBIT, f"B4-fp4, {what}: runs on {SRC_LOWBIT}")
        x = attention_kernel(*a, **kw)
        y, ms = timed_call(torch, lambda: attention_plain(*a, **kw))
        plain_ms.append(ms)
        d = calc_diff(x[0], y[0])
        err = float((x[0].float() - y[0].float()).abs().max())
        check(d < KERNEL_BAR, f"B4-fp4 vs plain, {what}: calc_diff {d:.3e} < {KERNEL_BAR}, "
                              f"max_abs {err:.3e}, {int((x[0] != y[0]).sum())} of "
                              f"{x[0].numel()} outputs differ")
        errs.append(err)
    timed = {}
    for label, timer in (("CogVideoX1.5", lambda fn: time_fn(fn, warmup=2, reps=10) * 1e3),
                         ("HunyuanVideo", lambda fn: time_once(torch, fn))):
        a = recs[label]["B4-fp4"][0]
        ms = timer(lambda: attention_kernel(*a, **kw))
        bound = attn_bound(a[3], a[0], a[1], nbytes(*a[:3], attention_kernel(*a, **kw)[0]))
        timed[label] = ms, bound
        print(f"     B4-fp4 at {label} {tuple(a[0].shape)}: kernel {ms:.3f} ms, bound "
              f"{bound[0]:.3f} ms ({bound[1]})", flush=True)
    ms, bound = timed["CogVideoX1.5"]
    return {"name": "B4-fp4", "route": "cuda", "source": SRC_LOWBIT, "replaces": TPU_KERNELS["B"],
            "launches": launches, "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms[0],
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "shape": f"{tuple(args[0].shape)}; plain on 2 heads"}


def fp4_edges(torch):
    """B4-fp4 on ``flash_sm90.cu`` at head dims 64, 128 and 256, each
    against its plain version on every head: ``kv_len < Sk``, a ragged Sq
    with a one-row tail block, a causal block whose first warpgroup walks
    kv tiles its rows see none of (an all-masked tile's e2m1 scale takes
    the 1e-30 floor and its P is 0), GQA 4/1 in a batch of two with NHD
    strides.  A P that differs from the plain version's by an ulp (the
    kernel's exp2 and FMA) may round to the next e2m1 value where it lies
    at a midpoint: each case prints how many outputs differ and the lse's
    largest move.  Returns the largest max_abs_err."""
    from sageattention_tpu_torch.ops.attention import (AttnConfig, attention_kernel,
                                                       attention_plain)
    from sageattention_tpu_torch.utils.testing import calc_diff
    g = torch.Generator(device="cuda").manual_seed(SEED + 165)
    nhd_view = lambda x: x.transpose(1, 2).contiguous().transpose(1, 2)  # noqa: E731
    errs = []
    for D in (64, 128, 256):
        BM = 64 * (3 if D == 64 else 2)
        # (label, B, Hq, Hk, Sq, Sk, causal, kv_len)
        cases = [("kv_len 777 of Sk 1000 (Sq 700)", 1, 4, 2, 700, 1000, False, 777),
                 (f"ragged Sq {BM + 1}, one-row tail block (Sk 333)", 1, 4, 4, BM + 1, 333,
                  False, 0),
                 ("causal (320), the first warpgroup's fully masked tiles", 1, 2, 2, 320, 320,
                  True, 0),
                 ("GQA 4/1, B = 2, NHD strides", 2, 4, 1, 250, 250, False, 0)]
        for label, B, Hq, Hk, Sq, Sk, causal, kv_len in cases:
            q, k, v = _edge_qkv(torch, g, B, Hq, Hk, Sq, Sk, D)
            if B == 2:
                q, k, v = (nhd_view(x) for x in (q, k, v))
            cfg = AttnConfig(causal=causal, quantized=False, p_sim_fp4=True, kv_len=kv_len,
                             sm_scale=D ** -0.5, emit_lse=True)
            a = attention_kernel(q, k, v, cfg)
            b = attention_plain(q, k, v, cfg)
            d = calc_diff(a[0], b[0])
            e = float((a[0].float() - b[0].float()).abs().max())
            dl = float((a[1] - b[1]).abs().max())
            errs.append(e)
            check(d < KERNEL_BAR and fwd_source(cfg, q) == SRC_LOWBIT,
                  f"B4-fp4 edge {label}, D={D} vs plain on every head: calc_diff {d:.3e} < "
                  f"{KERNEL_BAR}, max_abs {e:.3e}, {int((a[0] != b[0]).sum())} of "
                  f"{a[0].numel()} outputs differ, lse moves {dl:.2e}, on {SRC_LOWBIT}")
    return max(errs)


# B5-fp8's shapes on the main paths (B6's): B, Hq, Hk, S, D, causal
B5_FP8_SHAPES = {"CogVideoX1.5": COG_SHAPE + (False,),
                 "Llama-70B GQA": (1, 64, 8, 16384, 128, True)}


def b5_fp8_phase(torch, st, totals):
    """B5-fp8 through ``sageattn_qk_int8_pv_fp8`` (fine K scales, e4m3 P
    and V: the reference's H100 mode) at each of ``B5_FP8_SHAPES``, each
    call counted on its own (one launch on attention_q8_sm90.cu, one V^T
    copy) and held to flash, its launch on all heads against the plain
    version on the first and last heads, with its time and bound; the V^T
    copy's time; and ``sageattn`` (int8 PV, the default) against it, the
    comparison ``dispatch.py`` waits for.  Returns the JSON entry of
    CogVideoX1.5's launch."""
    from sageattention_tpu_torch.ops import attention as tatt
    from sageattention_tpu_torch.utils.testing import time_fn
    entry = None
    for i, (label, (B, H, Hk, S, D, causal)) in enumerate(B5_FP8_SHAPES.items()):
        q, k, v = realistic_qkv(torch, B, H, Hk, S, D, SEED + 170 + i)
        flash = st.flash_attention(q, k, v, is_causal=causal)
        what = f"{label} ({B},{H}/{Hk},{S},{D}) causal={causal} sageattn_qk_int8_pv_fp8"
        with vt_copies() as copies:
            out, rec = counted_path(torch, what, ("B5-fp8",), {}, totals,
                                    lambda: st.sageattn_qk_int8_pv_fp8(q, k, v, is_causal=causal))
        exact_counts(what, read_counts(), {"B5-fp8": 1})
        check(len(copies) == 1, f"{what}: one V^T copy ({len(copies)})")
        check(bool(torch.isfinite(out).all()) and out.shape == q.shape,
              f"{what}: finite output {tuple(out.shape)}")
        check_vs(f"{what} vs flash", out, flash, "fp8")
        args, akw = rec["B5-fp8"]
        check(fwd_source(args[3], args[0]) == SRC_Q8_SM90, f"{what}: B5-fp8 ran on {SRC_Q8_SM90}")
        e = attn_kernel_entry(torch, "B5-fp8", args, akw, 0, label=f"B5-fp8 ({what})")
        vt_ms = time_fn(lambda: tatt.transpose_v_codes(args[2]), warmup=3, reps=20) * 1e3
        int8_ms = time_fn(lambda: st.sageattn(q, k, v, is_causal=causal), warmup=2, reps=10) * 1e3
        fp8_ms = time_fn(lambda: st.sageattn_qk_int8_pv_fp8(q, k, v, is_causal=causal), warmup=2,
                         reps=10) * 1e3
        print(f"     {what}: V^T copy {vt_ms:.3f} ms; a call of sageattn (int8 PV) {int8_ms:.3f} "
              f"ms, of sageattn_qk_int8_pv_fp8 {fp8_ms:.3f} ms", flush=True)
        if label == "CogVideoX1.5":
            entry = dict(e, name="B5-fp8")
        del out, rec, args, akw, q, k, v, flash
        torch.cuda.empty_cache()
    return [entry]


def b10_fp8_phase(torch, st, totals):
    """The ring's fp8 PV over 4 virtual ranks at CogVideoX1.5 (padded
    chunks: B10-B5-fp8-kvtrue) and at Llama-3.1-8B 65,536 causal (device
    offsets: B10-B5-fp8-offsets, 6 hidden, 4 diagonal and 6 visible chunk
    pairs), each counted on its own and held to single-device
    ``sageattn_qk_int8_pv_fp8`` and to flash; then every kind of their
    launches against the plain version on sampled heads.  Returns one JSON
    entry per key, from its launch with the most work."""
    from sageattention_tpu_torch.utils.testing import calc_diff
    rec = ring_recorder(torch)
    runs = [("CogVideoX1.5", COG_SHAPE, False, "B10-B5-fp8-kvtrue"),
            ("Llama-3.1-8B", LLAMA_LONG, True, "B10-B5-fp8-offsets")]
    for i, (label, (B, H, Hk, S, D), causal, key) in enumerate(runs):
        q, k, v = realistic_qkv(torch, B, H, Hk, S, D, SEED + 180 + i)
        what = f"17 ring {label} ({B},{H}/{Hk},{S},{D}) causal={causal}, pv fp8, on 4 ranks"
        with rec:
            (out, _), _ = counted_path(
                torch, what, [key], {}, totals,
                lambda: virtual_ring(torch, q, k, v, 4, is_causal=causal, pv_dtype="fp8"))
        check(bool(torch.isfinite(out).all()) and out.shape == q.shape,
              f"{what}: finite output {tuple(out.shape)}")
        d = calc_diff(out, st.sageattn_qk_int8_pv_fp8(q, k, v, is_causal=causal))
        check(d < FP8_BAR, f"{what}: vs single-device sageattn_qk_int8_pv_fp8 calc_diff {d:.3e} "
                           f"< {FP8_BAR}")
        check_vs(f"{what} vs flash", out, st.flash_attention(q, k, v, is_causal=causal), "fp8")
        del q, k, v, out
        torch.cuda.empty_cache()
    calls = {n: c for n, c in rec.calls.items() if n.startswith("B10-B5-fp8-")}
    for name, kinds in calls.items():
        args = kinds[0][0]
        check(fwd_source(args[3], args[0]) == SRC_Q8_SM90, f"{name} ran on {SRC_Q8_SM90}")
    entries = b10_checks(torch, calls, totals)
    rec.calls.clear()
    torch.cuda.empty_cache()
    return entries


def run_fp4_fp8_sm90(torch, st, totals, fp4_recs):
    """Phase 17: B4-fp4 on ``csrc/flash_sm90.cu``'s FP4 mode (phase 11b's
    launches, causal at head dims 64, 128 and 256, the edge cases) and
    B5-fp8 with the ring's B10-B5-fp8 forms on ``csrc/attention_q8_sm90.cu``
    (its e4m3 PV), each against its plain version.  Returns their JSON
    entries, which replace phases 4's, 10's and 11's rows of the same
    keys."""
    fp4 = fp4_kernel_entry(torch, fp4_recs, totals.get("B4-fp4", 0))
    fp4_recs.clear()
    torch.cuda.empty_cache()
    fp4["max_abs_err"] = max(fp4["max_abs_err"], fp4_edges(torch))
    entries = b5_fp8_phase(torch, st, totals) + b10_fp8_phase(torch, st, totals)
    edge_err = q8_sm90_edges(torch, ("B5-fp8",))
    for e in entries:
        e["max_abs_err"] = max(e["max_abs_err"], edge_err)
    return [fp4] + entries


def prep2_entries(torch, q, k, v, totals):
    """A3 and A4 against their plain versions on every head at the
    HunyuanVideo shape, with their times and bytes bounds."""
    from sageattention_tpu_torch.ops import quant_fused as qf
    from sageattention_tpu_torch.utils.testing import time_fn
    from sageattention_tpu_torch.core import _scale_of
    S = k.shape[2]
    shape = str(tuple(k.shape))
    a = qf.channel_stats2(k, v, S)
    b, plain3 = timed_call(torch, lambda: qf.channel_stats2_plain(k, v, S))
    ok = all(torch.allclose(x, y, rtol=STATS_TOL, atol=STATS_TOL) for x, y in zip(a, b))
    err3 = max(float((x - y).abs().max()) for x, y in zip(a, b))
    check(ok, f"A3 vs plain at {shape}: stats within rtol {STATS_TOL} (max_abs {err3:.3e})")
    args = (k, _scale_of(a[1].amax(dim=3, keepdim=True), qf._INV127), a[0], v,
            _scale_of(a[3], qf._INV127), a[2])
    x = qf.quant_kv(*args, with_capmax=True, s_true=S)
    y, plain4 = timed_call(torch, lambda: qf.quant_kv_plain(*args, with_capmax=True, s_true=S))
    bad = int((x[0] != y[0]).sum()) + int((x[1] != y[1]).sum())
    cap_ok = torch.allclose(x[2], y[2], rtol=STATS_TOL, atol=0)
    check(bad == 0 and cap_ok, f"A4 vs plain at {shape}: {bad} codes differ, capmax within "
                               f"rtol {STATS_TOL}")
    err4 = float((x[2] - y[2]).abs().max())
    del b, y
    ms3 = time_fn(lambda: qf.channel_stats2(k, v, S), warmup=3, reps=20) * 1e3
    ms4 = time_fn(lambda: qf.quant_kv(*args, with_capmax=True, s_true=S), warmup=3,
                  reps=20) * 1e3
    out = []
    for name, err, ms, pms, moved in (
            ("A3", err3, ms3, plain3, nbytes(k, v, *a)),
            ("A4", err4, ms4, plain4, nbytes(*args, *x))):
        bound = bytes_bound(moved)
        print(f"     {name}: max_abs_err {err:.3e}, kernel {ms:.3f} ms, plain {pms:.3f} ms, "
              f"bound {bound[0]:.3f} ms ({bound[1]}) at {shape} K and V", flush=True)
        out.append({"name": name, "route": "cuda", "source": SRC_PREP,
                    "replaces": TPU_KERNELS[name], "launches": totals.get(name, 0),
                    "max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": bound[0],
                    "bound_by": bound[1], "library_ms": None, "shape": shape + " K and V"})
    return out


def run_slice7(torch, st, totals, fp4_recs):
    """Phase 11, the paths of slice 7 (each counted on its own): 11a the
    long sequences whose K/V prep takes the two-pass kernels (A3, A4), 11b
    SageAttention3's FP4 simulation (B4-fp4, whose launches' inputs go to
    ``fp4_recs`` for phase 17); then A3 and A4 against their plain
    versions."""
    t0 = time.time()
    q, k, v = hunyuan_phase(torch, st, totals)
    entries = prep2_entries(torch, q, k, v, totals)
    del q, k, v
    torch.cuda.empty_cache()
    hunyuan_dit_phase(torch, st, totals)
    torch.cuda.empty_cache()
    llama_128k_phase(torch, st, totals)
    torch.cuda.empty_cache()
    fp4_recs.update(fp4_phase(torch, st, totals))
    torch.cuda.empty_cache()
    print(f"     phase 11: {time.time() - t0:.1f} s", flush=True)
    return entries


# ------------------------------------------------- slice 8: B4 on Hopper ----

SRC_FLASH = "sageattention_tpu_torch/csrc/flash_sm90.cu"
# B4's shapes on the main paths: B, Hq, Hk, S, D, causal
FLASH_SHAPES = {"CogVideoX1.5": COG_SHAPE + (False,),
                "Llama-70B GQA": (1, 64, 8, 16384, 128, True),
                "Gemma-7B hd 256": (1, 16, 16, 8192, 256, True),
                "HunyuanVideo": HUNYUAN_SHAPE + (False,)}


def flash_vs_plain(torch, what, args, sampled=False, plain_rows=None):
    """B4 launched on all of ``args`` (attention_kernel's positional inputs)
    against its plain version on every head or, with ``sampled``, on the
    sampled heads (:func:`sampled_heads`) or, with ``plain_rows``, on those
    query rows of the first and the last q head (non-causal: a row's result
    does not depend on the other rows).  Returns (max_abs_err, plain_ms),
    the plain version's time on the first sample."""
    from sageattention_tpu_torch.ops.attention import attention_kernel, attention_plain
    from sageattention_tpu_torch.utils.testing import calc_diff
    q, k, v, cfg = args
    a = attention_kernel(*args)
    Hq, Hk = q.shape[1], k.shape[1]
    if plain_rows is not None:
        idx = torch.tensor(plain_rows, device="cuda")
        parts = [((slice(h, h + 1), idx), (q[:, h:h + 1, idx], k[:, kh:kh + 1],
                                             v[:, kh:kh + 1], cfg))
                 for h, kh in ((0, 0), (Hq - 1, Hk - 1))]
    elif sampled:
        parts = [((hs,), sub[:4]) for sub, _, hs in sampled_heads(args + (None,) * 6, {})]
    else:
        parts = [((), args)]
    err, plain_ms = 0.0, None
    for sel, sub in parts:
        ka, kl = a[0][(slice(None),) + sel], a[1][(slice(None),) + sel]
        b, ms = timed_call(torch, lambda: attention_plain(*sub))
        plain_ms = ms if plain_ms is None else plain_ms
        d = calc_diff(ka, b[0])
        e = float((ka.float() - b[0].float()).abs().max())
        err = max(err, e)
        dl = float((kl - b[1]).abs().max())
        heads = "" if not sel else f", q heads {sel[0].start}-{sel[0].stop - 1}"
        check(d < KERNEL_BAR and dl < LSE_BAR and ka.dtype == b[0].dtype,
              f"B4 vs plain, {what}{heads}: calc_diff {d:.3e} < {KERNEL_BAR}, max_abs {e:.3e}, "
              f"lse {dl:.2e} < {LSE_BAR}")
    return err, plain_ms


def flash_timing(torch, what, args, timer, lib_reps=20):
    """B4's time on ``args`` by ``timer``, its bound, and the library call's
    time on the same inputs (keys cut at ``kv_len``; none for causal with
    Sq != Sk, which its flash backend refuses).  Returns (ms, bound,
    library_ms)."""
    from sageattention_tpu_torch.ops.attention import attention_kernel
    q, k, v, cfg = args
    ms = timer(lambda: attention_kernel(*args))
    out = attention_kernel(*args)
    bound = attn_bound(cfg, q, k, nbytes(q, k, v, *out))
    n = cfg.kv_len or k.shape[2]
    lib = None   # the library's flash takes causal only with Sq == Sk
    if not cfg.causal or q.shape[2] == n:
        lib = library_ms(torch, q, k[:, :, :n], v[:, :, :n], cfg.causal, reps=lib_reps)
    libs = "none (causal, Sq != Sk)" if lib is None else f"{lib:.3f} ms"
    print(f"     B4 at {what}: kernel {ms:.3f} ms, bound {bound[0]:.3f} ms ({bound[1]}), "
          f"library {libs}", flush=True)
    return ms, bound, lib


def flash_edge_cases(torch):
    """B4 on flash_sm90.cu's edges, each against its plain version on every
    head, with its time, bound and library time: lengths off the 128-row q
    tile and the kv tile, kv_len < Sk (the K/V maps end there), Sq != Sk
    under causal (top-left), NHD strides, a batch of two with sliced heads
    (strided, offset bases), a kv length of whole tiles inside a longer Sk
    (no tail tile) and a one-column tail tile, at head dims 64, 128 and
    256.  Returns the largest max_abs_err."""
    from sageattention_tpu_torch.ops.attention import AttnConfig, flash_kv_tile
    g = torch.Generator(device="cuda").manual_seed(SEED + 81)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda").bfloat16()  # noqa: E731
    nhd_view = lambda x: x.transpose(1, 2).contiguous().transpose(1, 2)  # noqa: E731
    errs = []
    for D in (64, 128, 256):
        bn = flash_kv_tile(D)

        def cfg(causal, kv_len=0):
            return AttnConfig(causal=causal, quantized=False, sm_scale=D ** -0.5, kv_len=kv_len)

        q, k, v = rn(1, 4, 1000, D), rn(1, 2, 1333, D), rn(1, 2, 1333, D)
        big = [rn(2, 8, 1100, D) for _ in range(3)]
        tail = tuple(rn(1, 2, 2 * bn + 1, D) for _ in range(3))
        cases = [
            ("unaligned (1,4/2,1000 x 1333)", (q, k, v, cfg(False))),
            ("kv_len 900 of Sk 1333", (q, k, v, cfg(False, 900))),
            ("causal, Sq 700 < Sk 1000", (q[:, :, :700], k[:, :, :1000], v[:, :, :1000],
                                          cfg(True))),
            ("NHD strides, causal (1,4/2,1000)", tuple(nhd_view(x[:, :, :1000]) for x in (q, k, v))
             + (cfg(True),)),
            ("B = 2, q heads 1-4 of 8, kv heads 2-3, 1100", (big[0][:, 1:5], big[1][:, 2:4],
                                                              big[2][:, 2:4], cfg(False))),
            (f"kv_len {2 * bn} (whole tiles) of Sk 1333", (q, k, v, cfg(False, 2 * bn))),
            (f"causal, S = {2 * bn + 1} (a one-column tail tile)", tail + (cfg(True),)),
        ]
        for what, args in cases:
            what = f"{what}, D={D}"
            errs.append(flash_vs_plain(torch, what, args)[0])
            flash_timing(torch, what, args, kernel_ms)
    return max(errs)


def run_flash(torch, st, totals):
    """Phase 12 (slice 8): B4 on its Hopper kernel (``csrc/flash_sm90.cu``)
    at the main paths' shapes.  For each: ``flash_attention`` counted on its
    own (one B4 launch), flash against the f32 oracle on sampled rows, B4
    launched on all heads against its plain version on the sampled heads
    (the sampled row blocks of the first and last head at HunyuanVideo),
    its time beside its
    bound and the library call's; then the edge cases.  Returns B4's JSON
    entry (CogVideoX1.5's numbers; the largest error of all)."""
    from sageattention_tpu_torch.ops.attention import AttnConfig
    res = {}
    for i, (label, (B, H, Hk, S, D, causal)) in enumerate(FLASH_SHAPES.items()):
        q, k, v = realistic_qkv(torch, B, H, Hk, S, D, SEED + 70 + i)
        what = f"{label} ({B},{H}/{Hk},{S},{D}) causal={causal}"
        out, _ = counted_path(torch, f"{what} flash", ("B4",), {}, totals,
                              lambda: st.flash_attention(q, k, v, is_causal=causal))
        exact_counts(f"{what} flash", read_counts(), {"B4": 1})
        flash_oracle_check(torch, what, out, q, k, v, causal)
        del out
        args = (q, k, v, AttnConfig(causal=causal, quantized=False, sm_scale=D ** -0.5))
        if label == "HunyuanVideo":
            rows = row_blocks(S)
            err, plain_ms = flash_vs_plain(torch, f"{what}, {len(rows)} sampled rows", args,
                                           plain_rows=rows)
            timing = flash_timing(torch, what, args, lambda fn: trials_ms(torch, fn), lib_reps=3)
        else:
            err, plain_ms = flash_vs_plain(torch, what, args, sampled=True)
            timing = flash_timing(torch, what, args, kernel_ms)
        res[label] = (err, plain_ms) + timing
        del q, k, v, args
        torch.cuda.empty_cache()
    edge_err = flash_edge_cases(torch)
    err, plain_ms, ms, bound, lib = res["CogVideoX1.5"]
    return [{"name": "B4", "route": "cuda", "source": SRC_FLASH, "replaces": TPU_KERNELS["B"],
             "launches": 0, "max_abs_err": max([edge_err] + [r[0] for r in res.values()]),
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
             "library_ms": lib,
             "shape": f"{COG_SHAPE}; plain on q heads 0, 47; "
                      + "; ".join(f"{lb}: {r[2]:.3f} ms, bound {r[3][0]:.3f}, library {r[4]:.3f}"
                                  for lb, r in res.items())}]


# ------------------------------------------- slice 9: C1/C2 on Hopper ----

SRC_BWD_SM90 = "sageattention_tpu_torch/csrc/backward_sm90.cu"
SRC_BWD_Q8_SM90 = "sageattention_tpu_torch/csrc/backward_q8_sm90.cu"
# C1/C2's bf16 forms with no mask and no window on the main paths: B, Hq, Hk,
# Sq, Sk, D, causal.  Phase 9's Llama-3-8B-width fine-tune and CogVideoX1.5-
# width DiT step; the ring's per-pair form (a given di, f32 outputs) on a
# CogVideoX1.5 chunk pair and a diagonal pair of phase 10's 4-rank
# Llama-3.1-8B ring at 65,536 tokens
BWD_SHAPES = {"Llama-3-8B causal": (1, 32, 8, 8192, 8192, 128, True),
              "CogVideoX1.5": (1, 48, 48, 17776, 17776, 64, False)}
BWD_RING_PAIRS = {"CogVideoX1.5 chunk pair": (1, 48, 48, 5120, 5120, 64, False),
                  "Llama-3.1-8B diagonal pair": (1, 32, 8, 16384, 16384, 128, True)}
# the edges of backward_sm90.cu's tiles (blocks of 192 rows at D = 64 and of
# 128 at D = 128, over 64-row tiles) at D = 64 and 128: B, Hq, Hk, Sq, Sk,
# causal; and a one-row tail (two 64-row tiles and one row) through
# attention_backward
BWD_EDGES = {"odd tiles (1,2/2,320), causal": (1, 2, 2, 320, 320, True),
             "odd tiles (1,2/2,320)": (1, 2, 2, 320, 320, False),
             "Sq 192 < Sk 448": (1, 2, 2, 192, 448, False),
             "Sq 448 > Sk 192, GQA 2/1": (1, 2, 1, 448, 192, False),
             "GQA 8/2, causal (1,8/2,448)": (1, 8, 2, 448, 448, True),
             "B = 2 (2,4/4,320)": (2, 4, 4, 320, 320, False)}
BWD_TAIL_S = 129


def bwd_source(name, D):
    """The source that runs C1/C2 launch key ``name`` at head dim ``D``."""
    from sageattention_tpu_torch.ops import backward as tbwd
    cfg = (name[3:].startswith("int8"), name.endswith("-bool"), "-window" in name,
           tbwd._head_dim(D))
    if tbwd.bwd_sm90_route(*cfg):
        return SRC_BWD_SM90
    return SRC_BWD_Q8_SM90 if tbwd.bwd_q8_sm90_route(*cfg) else SRC_BWD


def bwd_inputs(torch, B, Hq, Hk, Sq, Sk, D, causal, seed):
    """Activation-like q, k, v, a dO, and the port's flash forward's (o, lse)."""
    import sageattention_tpu_torch as st
    q, k, v = realistic_qkv(torch, B, Hq, Hk, max(Sq, Sk), D, seed)
    q, k, v = q[:, :, :Sq].contiguous(), k[:, :, :Sk].contiguous(), v[:, :, :Sk].contiguous()
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g, device="cuda").bfloat16()
    o, lse = st.flash_attention(q, k, v, is_causal=causal, return_lse=True)
    return q, k, v, o, lse, do


def bwd_vs_plain(torch, what, q, k, v, o, lse, do, causal, di=None, every_head=False,
                 quantized=False, window=0, sinks=0, attn_mask=None):
    """C1 and C2 (int8 with ``quantized``; under a ``window`` with ``sinks``
    or a bool ``attn_mask``) launched once each on all heads (f32
    outputs), each gradient held to ``attention_backward_plain`` at
    KERNEL_BAR on the first q heads of kv head 0 and the last q head with
    the last kv head (or, with ``every_head``, on all of them).  Returns
    (max_abs_err, plain ms of the first sample)."""
    from sageattention_tpu_torch.ops import backward as tbwd
    from sageattention_tpu_torch.utils.testing import calc_diff
    pa = tbwd.prepare(q, k, v, o, lse, do, sm_scale=q.shape[-1] ** -0.5, di=di,
                      quantized=quantized, attn_mask=attn_mask)
    pa.update(causal=causal, window=window, sinks=sinks, out_dtype=torch.float32)
    got = tbwd.attention_backward_kernel(**pa)
    Hq, Hk = q.shape[1], k.shape[1]
    parts = [(slice(0, Hq), slice(0, Hk))]
    if not every_head:
        parts = [(slice(0, min(Hq // Hk, 2)), slice(0, 1))]
        if parts[0][0].stop < Hq:
            parts.append((slice(Hq - 1, Hq), slice(Hk - 1, Hk)))
    err, plain_ms = 0.0, None
    for hs, ks in parts:
        sub = dict(pa, **{n: pa[n][:, hs] for n in ("q", "do", "lse2", "di", "qs") if n in pa},
                   **{n: pa[n][:, ks] for n in ("k", "v", "ks") if n in pa})
        if attn_mask is not None and attn_mask.shape[1] > 1:
            sub["mask"] = pa["mask"][:, hs]
        plain, ms = timed_call(torch, lambda: tbwd.attention_backward_plain(**sub))
        plain_ms = ms if plain_ms is None else plain_ms
        ds = [calc_diff(a[:, hs], b) for a, b in zip(got, plain)]
        e = max(float((a[:, hs] - b).abs().max()) for a, b in zip(got, plain))
        err = max(err, e)
        check(all(d <= KERNEL_BAR for d in ds),
              f"C1/C2 vs plain, {what}, q heads {hs.start}-{hs.stop - 1}: dq/dk/dv calc_diff "
              + "/".join(f"{d:.3e}" for d in ds) + f" <= {KERNEL_BAR}, max_abs {e:.3e}")
    return err, plain_ms


def bwd_timing(torch, what, q, k, v, o, lse, do, causal, di=None, f32_out=False,
               quantized=False):
    """C1's and C2's times on all heads, each alone (bf16 outputs, or f32
    with ``f32_out``), and their bounds; bf16: the library's backward (C1 +
    C2); int8 (``quantized``, whose time includes the wrapper's dequantized
    copy): the bf16 pair's times on the same inputs beside them.  Returns
    {kernel: (ms, bound)}, library_ms (None for int8) and the bf16 pair's
    {kernel: ms} (int8 only)."""
    from sageattention_tpu_torch.ops import backward as tbwd
    B, Hq, Sq, D = q.shape
    pairs = bwd_pairs(torch, B, Hq, Sq, k.shape[2], {"is_causal": causal})
    res, bf16 = {}, {}
    for quant in (quantized, False) if quantized else (False,):
        pa = tbwd.prepare(q, k, v, o, lse, do, sm_scale=D ** -0.5, di=di, quantized=quant)
        pa.update(causal=causal, out_dtype=torch.float32 if f32_out else torch.bfloat16)
        for kernel in ("C1", "C2"):
            ms = kernel_ms(lambda: tbwd.attention_backward_kernel(**pa, kernels=(kernel,)))
            if quant != quantized:   # the bf16 pair beside the int8 one
                bf16[kernel] = ms
                continue
            out = tbwd.attention_backward_kernel(**pa, kernels=(kernel,))
            reads = [pa[n] for n in ("q", "k", "v", "do", "lse2", "di", "qs", "ks") if n in pa]
            res[kernel] = (ms, bwd_bound(kernel, quant, pairs, pa["q"].shape[-1],
                                         nbytes(*reads, *(x for x in out if x is not None))))
            del out
        del pa
    lib = None if quantized else library_bwd_ms(torch, q, k, v, do,
                                                {"is_causal": causal, "sm_scale": D ** -0.5})
    beside = (f"library (C1 + C2) {lib:.3f} ms" if lib is not None else
              f"bf16 sm90 pair {bf16['C1']:.3f} / {bf16['C2']:.3f} ms")
    print(f"     C1/C2 {'int8' if quantized else 'bf16'} at {what}: " + ", ".join(
        f"{kn} {ms:.3f} ms (bound {b[0]:.3f}, {b[1]})" for kn, (ms, b) in res.items())
          + f", C1 + C2 {res['C1'][0] + res['C2'][0]:.3f} ms, {beside}, {pairs} kept pairs",
          flush=True)
    return res, lib, bf16


def sm90_ptxas(source="backward_sm90"):
    """A Hopper source's ptxas report: printed, and no spill allowed (a
    spill serializes every wgmma)."""
    from sageattention_tpu_torch.ops import _build
    lines = [ln.strip() for ln in _build.build_log.get(source, "").splitlines()
             if "entry function" in ln or "spill" in ln or "Used" in ln or "wgmma" in ln]
    for ln in lines:
        print(f"     {source}.cu ptxas: " + ln, flush=True)
    spills = [ln for ln in lines if "spill" in ln]
    if lines:   # a library reused from an earlier build has no report
        check(bool(spills) and all(ln.startswith("0 bytes stack frame, 0 bytes spill stores, "
                                                 "0 bytes spill loads") for ln in spills)
              and not any("wgmma" in ln for ln in lines),
              f"{source}.cu: no spill and no serialized wgmma in {len(spills)} functions")


def run_bwd_sm90(torch, st, totals):
    """Phase 13 (slice 9): C1 and C2 bf16 with no mask and no window on
    ``csrc/backward_sm90.cu`` (:func:`bwd_sm90_phase`).  Returns the JSON
    entries of the four routed launch keys (``ptxas``'s report for the
    source is printed after the build)."""
    return bwd_sm90_phase(torch, totals, quantized=False)


def run_bwd_q8_sm90(torch, st, totals):
    """Phase 16 (slice 12): C1 and C2 int8 (the S-recompute) with no mask
    and no window on ``csrc/backward_q8_sm90.cu`` (:func:`bwd_sm90_phase`),
    each timed beside the bf16 pair on the same inputs.  Returns the JSON
    entries of the four routed launch keys."""
    sm90_ptxas("backward_q8_sm90")
    return bwd_sm90_phase(torch, totals, quantized=True)


def bwd_sm90_phase(torch, totals, quantized):
    """C1 and C2 on their Hopper kernel, bf16 or int8 (``quantized``), each
    shape counted on its own.  At the main paths' shapes:
    ``attention_backward`` from the port's flash forward on realistic inputs
    (one C1 and one C2 launch), C1 and C2 on all heads against the plain
    version on the first and the last heads, their times beside their
    bounds and the library's backward (bf16) or the bf16 pair (int8); the
    ring's per-pair form (a given di, f32 outputs) on a CogVideoX1.5 chunk
    pair and a diagonal Llama-3.1-8B pair, the same way; then the edge cases
    at D = 64 and 128 against the plain version on every head, and a
    one-row tail through ``attention_backward`` against the same call on the
    CPU.  Returns the JSON entries of the four routed launch keys."""
    from sageattention_tpu_torch.ops import backward as tbwd
    from sageattention_tpu_torch.utils.testing import calc_diff
    form = "int8" if quantized else "bf16"
    src = SRC_BWD_Q8_SM90 if quantized else SRC_BWD_SM90
    res, ring_text, errs = {}, [], []
    shapes = [(lb, s, False) for lb, s in BWD_SHAPES.items()] + [
        (lb, s, True) for lb, s in BWD_RING_PAIRS.items()]
    for i, (label, (B, Hq, Hk, Sq, Sk, D, causal), ring) in enumerate(shapes):
        q, k, v, o, lse, do = bwd_inputs(torch, B, Hq, Hk, Sq, Sk, D, causal, SEED + 90 + 2 * i)
        di = (do.float() * o.float()).sum(-1) if ring else None
        kw = dict(di=di, out_dtype=torch.float32) if ring else {}
        what = f"{label} ({B},{Hq}/{Hk},{Sq}x{Sk},{D}) causal={causal}" + (
            ", given di, f32 out" if ring else "")
        c = "-causal" if causal else ""
        keys = (f"C1-{form}{c}", f"C2-{form}{c}")
        out, _ = counted_path(torch, f"{what}: attention_backward ({form})", keys, {}, totals,
                              lambda: tbwd.attention_backward(
                                  q, k, v, None if ring else o, lse, do, sm_scale=D ** -0.5,
                                  is_causal=causal, quantized=quantized, **kw))
        exact_counts(what, read_counts(), dict.fromkeys(keys, 1))
        check(all(bool(torch.isfinite(x).all()) for x in out)
              and [tuple(x.shape) for x in out] == [tuple(q.shape), tuple(k.shape), tuple(v.shape)],
              f"{what}: attention_backward's gradients finite, of the input shapes")
        del out
        err, plain_ms = bwd_vs_plain(torch, what, q, k, v, o, lse, do, causal, di=di,
                                     quantized=quantized)
        errs.append(err)
        timing, lib, bf16 = bwd_timing(torch, what, q, k, v, o, lse, do, causal, di=di,
                                       f32_out=ring, quantized=quantized)
        if ring:
            ring_text.append(f"{label}: C1 {timing['C1'][0]:.3f} / C2 {timing['C2'][0]:.3f} ms, "
                             + (f"bf16 {bf16['C1']:.3f} / {bf16['C2']:.3f}" if quantized
                                else f"library {lib:.3f}"))
        else:
            res[c] = (err, plain_ms, timing, lib, bf16, what)
        del q, k, v, o, lse, do, di
        torch.cuda.empty_cache()
    for D in (64, 128):
        for j, (label, (B, Hq, Hk, Sq, Sk, causal)) in enumerate(BWD_EDGES.items()):
            what = f"{label}, D={D} ({form})"
            q, k, v, o, lse, do = bwd_inputs(torch, B, Hq, Hk, Sq, Sk, D, causal, SEED + 100 + j)
            c = "-causal" if causal else ""
            counted_path(torch, what, (f"C1-{form}{c}", f"C2-{form}{c}"), {}, totals,
                         lambda: tbwd.attention_backward(q, k, v, o, lse, do, sm_scale=D ** -0.5,
                                                         is_causal=causal, quantized=quantized))
            errs.append(bwd_vs_plain(torch, what, q, k, v, o, lse, do, causal, every_head=True,
                                     quantized=quantized)[0])
        q, k, v, o, lse, do = bwd_inputs(torch, 1, 4, 1, BWD_TAIL_S, BWD_TAIL_S, D, True,
                                         SEED + 110)
        what = (f"one-row tail (1,4/1,{BWD_TAIL_S},{D}) causal through attention_backward "
                f"({form})")
        got, _ = counted_path(torch, what, (f"C1-{form}-causal", f"C2-{form}-causal"), {}, totals,
                              lambda: tbwd.attention_backward(q, k, v, o, lse, do,
                                                              sm_scale=D ** -0.5, is_causal=True,
                                                              quantized=quantized,
                                                              out_dtype=torch.float32))
        ref = tbwd.attention_backward(*(x.cpu() for x in (q, k, v, o, lse, do)),
                                      sm_scale=D ** -0.5, is_causal=True, quantized=quantized,
                                      out_dtype=torch.float32)
        ds = [calc_diff(a.cpu(), b) for a, b in zip(got, ref)]
        errs.append(max(float((a.cpu() - b).abs().max()) for a, b in zip(got, ref)))
        check(all(d <= KERNEL_BAR for d in ds), f"{what} vs the same call on the CPU (the plain "
              "version): dq/dk/dv calc_diff " + "/".join(f"{d:.3e}" for d in ds)
              + f" <= {KERNEL_BAR}")
    entries = []
    beside = "the bf16 sm90 pair on the same inputs" if quantized else "library: C1 + C2"
    for c, (err, plain_ms, timing, lib, bf16, what) in res.items():
        for kernel in ("C1", "C2"):
            ms, bound = timing[kernel]
            extra = f" (bf16 {bf16[kernel]:.3f} ms)" if quantized else ""
            entries.append({"name": f"{kernel}-{form}{c}", "route": "cuda", "source": src,
                            "replaces": TPU_KERNELS[kernel], "launches": 0,
                            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib,
                            "shape": f"{what}{extra}; plain (C1 + C2) on the first and last q "
                                     f"heads; {beside}; " + "; ".join(ring_text)})
    return entries


# ------------------------- slice 18: the masked backward on Hopper ----

# C1/C2's window, sink and bool-mask forms at the shapes of 9e's gradient
# paths: Mistral-7B-v0.1's W = 4096 window with 0 and 4 sinks, and phase 7's
# left-padded Llama-3-8B batch, causal, with its bool mask
def bwd_masked_paths():
    H, Hk, D, S, W = TRAIN["mistral"]
    B, Hp, Hpk, Sp, Dp = TRAIN["padded"]
    return {f"Mistral-7B window {W}": ((1, H, Hk, S, D), dict(window=W)),
            f"Mistral-7B window {W}, 4 sinks": ((1, H, Hk, S, D), dict(window=W, sinks=4)),
            "Llama-3-8B left-padded batch": ((B, Hp, Hpk, Sp, Dp), dict(mask="pad"))}


# the edges of the masked walks at head dims 64 and 128, on every head: B,
# Hq, Hk, S, causal, options (a window under one tile and off the tiles (W =
# 1 alone keeps a row's own key, where dS is 0 and both sides' rounding noise),
# sinks across a 64-row slice, a tail off the 128- and 192-row blocks, GQA
# 4:1; bool masks with dead rows and dead tiles, causal and not; a 128 x 128
# block-sparse mask, whose mask rows a 192-row block at D = 64 cuts in two)
BWD_MASKED_EDGES = {"W = 1, 4 sinks": (1, 2, 2, 320, True, dict(window=1, sinks=4)),
                    "W = 37, tail (300 of 320)": (1, 2, 2, 300, True, dict(window=37)),
                    "W = 200, GQA 4/1": (1, 4, 1, 448, True, dict(window=200)),
                    "W = 100, 70 sinks": (1, 2, 2, 448, True, dict(window=100, sinks=70)),
                    "left-padded, causal": (2, 2, 2, 448, True, dict(mask="pad")),
                    "dead rows and tiles": (1, 2, 1, 300, False, dict(mask="holes")),
                    "dead rows and tiles, causal, per head": (1, 2, 2, 320, True,
                                                              dict(mask="holes", per_head=True)),
                    "128 x 128 block-sparse": (1, 2, 2, 512, False, dict(mask="blocks"))}


def bwd_keep_mask(torch, kind, B, H, S, seed, lens=None):
    """A bool keep-mask ``[B, H, S, S]`` on the card: "pad" keeps the last
    ``lens[b]`` keys of sequence b (by default ``S - S * b / (2 B)``),
    "holes" keeps 85% of pairs at random with rows 0-69 and kv columns
    128-191 dead, "blocks" keeps ~40% of 128 x 128 blocks."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if kind == "pad":
        lens = lens or [S - S * b // (2 * B) for b in range(B)]
        pad = S - torch.tensor(lens, device="cuda")
        keep = torch.arange(S, device="cuda")[None, None, None, :] >= pad[:, None, None, None]
        return keep.expand(B, H, S, S).contiguous()
    if kind == "holes":
        keep = torch.rand(B, H, S, S, generator=g, device="cuda") < 0.85
        keep[:, :, :70] = False
        keep[..., 128:192] = False
        return keep
    n = -(-S // 128)
    blocks = torch.rand(B, H, n, n, generator=g, device="cuda") < 0.4
    return blocks.repeat_interleave(128, 2).repeat_interleave(128, 3)[..., :S, :S].contiguous()


def exact_fwd(torch, q, k, v, keep):
    """f32 attention (TF32 off) under a keep-mask ``[B, 1|H, Sq, Sk]``: ``(o
    bf16, lse f32)``, lse -inf on a row that keeps no key."""
    from sageattention_tpu_torch.ops.reference import _no_tf32
    G = q.shape[1] // k.shape[1]
    kf, vf = (x.float().repeat_interleave(G, 1) for x in (k, v))
    with _no_tf32():
        s = q.float() @ kf.transpose(-1, -2) * q.shape[-1] ** -0.5
        s = s.masked_fill(~keep, -float("inf"))
        lse = torch.logsumexp(s, -1)
        p = torch.exp(s - torch.where(torch.isfinite(lse), lse, 0)[..., None])
        return (p @ vf).bfloat16(), lse


def on_old_bwd(fn):
    """``fn()`` with the masked bf16 forms sent to ``backward.cu`` (the route
    to ``backward_sm90.cu``'s masked kernels turned off for the call)."""
    from sageattention_tpu_torch.ops import backward as tbwd
    real = tbwd.bwd_sm90_route
    tbwd.bwd_sm90_route = lambda quantized, masked, window, D: (
        real(quantized, masked, window, D) and not (masked or window))
    try:
        return fn()
    finally:
        tbwd.bwd_sm90_route = real


def masked_entry_ms(torch, pa, kernel):
    """The masked kernel's own time: ``sage_bwd_sm90_masked`` launched again
    with the arguments that one ``attention_backward_kernel`` call handed
    it (its tile lists held), without the glue that builds
    them.  Returns ``(ms, that call's gradients)``."""
    from sageattention_tpu_torch.ops import _build
    from sageattention_tpu_torch.ops import backward as tbwd
    held, calls = [], []
    real_args, real_call = tbwd._masked_args, _build.call
    tbwd._masked_args = lambda *a: held.append(real_args(*a)) or held[-1]
    _build.call = lambda fn, dev, *a: calls.append((fn, dev, a)) or real_call(fn, dev, *a)
    try:
        out = tbwd.attention_backward_kernel(**pa, kernels=(kernel,))
    finally:
        tbwd._masked_args, _build.call = real_args, real_call
    (fn, dev, args), = calls
    check(fn == "sage_bwd_sm90_masked", f"{kernel} launched {fn}")
    return kernel_ms(lambda: real_call(fn, dev, *args)), out


def run_bwd_masked_sm90(torch, st, totals):
    """Phase 22 (slice 18): C1 and C2 bf16 under a window (sinks too) or a
    bool mask on ``csrc/backward_sm90.cu``'s masked kernels.  At 9e's shapes
    (:func:`bwd_masked_paths`), from ``sageattn``'s forward with the same
    band or mask: ``attention_backward``, counted on its own (one C1 and
    one C2 launch, ``sage_bwd_sm90_masked`` called and ``sage_attn_bwd``
    never), C1 and C2 on all heads against the plain version on the first
    and last q heads, each kernel's time (:func:`masked_entry_ms`: its C
    entry alone) beside its bound over the kept pairs, the call's time with
    the wrapper's glue, the library's backward, ``backward.cu``'s time on
    the same inputs (the route turned off for the call, glue included, as
    9f timed it before), and the tile lists' glue alone; then
    :data:`BWD_MASKED_EDGES` at head dims 64 and 128 on every head from the
    exact forward, and a tail with f32 outputs through
    ``attention_backward`` against the same call on the CPU.  Returns the
    JSON entries of the four masked keys."""
    from sageattention_tpu_torch.ops import backward as tbwd
    from sageattention_tpu_torch.utils.testing import calc_diff, time_fn
    calls = {"sage_bwd_sm90_masked": True, "sage_attn_bwd": False}
    rows, errs = {}, []
    for i, (label, ((B, Hq, Hk, S, D), opt)) in enumerate(bwd_masked_paths().items()):
        q, k, v = realistic_qkv(torch, B, Hq, Hk, S, D, SEED + 120 + i)
        do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(
            SEED + 130 + i), device="cuda").bfloat16()
        if opt.get("mask"):
            keep = bwd_keep_mask(torch, "pad", B, 1, S, 0, lens=TRAIN["padded_lens"])
            fkw, kw, suffix = dict(attn_mask=keep), dict(attn_mask=keep), "-causal-bool"
        else:
            fkw = dict(sliding_window=opt["window"], attention_sinks=opt.get("sinks", 0))
            kw, suffix = dict(window=opt["window"], sinks=opt.get("sinks", 0)), "-window"
        o, lse = st.sageattn(q, k, v, is_causal=True, return_lse=True, **fkw)
        what = f"{label} ({B},{Hq}/{Hk},{S},{D})"
        keys = (f"C1-bf16{suffix}", f"C2-bf16{suffix}")
        out, _ = counted_path(torch, f"{what}: attention_backward", keys, {}, totals,
                              lambda: tbwd.attention_backward(q, k, v, o, lse, do,
                                                              sm_scale=D ** -0.5, is_causal=True,
                                                              **kw), entries=calls)
        exact_counts(what, read_counts(), dict.fromkeys(keys, 1))
        check(all(bool(torch.isfinite(x).all()) for x in out)
              and [tuple(x.shape) for x in out] == [tuple(q.shape), tuple(k.shape), tuple(v.shape)],
              f"{what}: attention_backward's gradients finite, of the input shapes")
        del out
        err, plain_ms = bwd_vs_plain(torch, what, q, k, v, o, lse, do, True, **kw)
        errs.append(err)
        pa = tbwd.prepare(q, k, v, o, lse, do, sm_scale=D ** -0.5, attn_mask=kw.get("attn_mask"))
        pa.update(causal=True, window=kw.get("window", 0), sinks=kw.get("sinks", 0),
                  out_dtype=torch.bfloat16)
        pairs = bwd_pairs(torch, B, Hq, S, S, dict(kw, is_causal=True))
        res = {}
        for kernel in ("C1", "C2"):
            run = lambda: tbwd.attention_backward_kernel(**pa, kernels=(kernel,))  # noqa: E731
            ms, got = masked_entry_ms(torch, pa, kernel)
            wrapper = kernel_ms(run)
            old = on_old_bwd(lambda: kernel_ms(run))
            reads = [pa[n] for n in ("q", "k", "v", "do", "lse2", "di", "mask") if n in pa]
            bound = bwd_bound(kernel, False, pairs, D, nbytes(*reads, *(x for x in got
                                                                       if x is not None)))
            res[kernel] = (ms, old, bound, wrapper)
            del got
        Sqp = pa["q"].shape[2]
        glue = time_fn(lambda: tbwd._masked_args(("C1", "C2"), Sqp, Sqp, D, True,
                                                 pa["window"], pa["sinks"], pa.get("mask"),
                                                 q.device), warmup=2, reps=10) * 1e3
        lib = library_bwd_ms(torch, q, k, v, do, dict(kw, is_causal=True, sm_scale=D ** -0.5))
        print(f"     C1/C2 bf16{suffix} at {what}: " + ", ".join(
            f"{kn} {ms:.3f} ms (with the wrapper's glue {wr:.3f}; backward.cu {old:.3f}; bound "
            f"{b[0]:.3f}, {b[1]})" for kn, (ms, old, b, wr) in res.items())
              + f", tile lists {glue:.3f} ms, library (C1 + C2) {lib:.3f} ms, "
              f"{pairs} kept pairs", flush=True)
        rows.setdefault(suffix, []).append((what, res, glue, lib, plain_ms))
        del q, k, v, o, lse, do, pa
        torch.cuda.empty_cache()
    for D in (64, 128):
        for j, (label, (B, Hq, Hk, S, causal, opt)) in enumerate(BWD_MASKED_EDGES.items()):
            what = f"{label} ({B},{Hq}/{Hk},{S}), D={D}, causal={causal}"
            g = torch.Generator(device="cuda").manual_seed(SEED + 140 + j)
            q, do = (torch.randn(B, Hq, S, D, generator=g, device="cuda").bfloat16()
                     for _ in range(2))
            k, v = (torch.randn(B, Hk, S, D, generator=g, device="cuda").bfloat16()
                    for _ in range(2))
            kw = {n: opt[n] for n in ("window", "sinks") if n in opt}
            r = torch.arange(S, device="cuda")
            keep = ((r[None, :] <= r[:, None]) if causal else torch.ones(
                S, S, dtype=torch.bool, device="cuda"))[None, None]
            if kw:
                keep = keep & band_keep(torch, kw["window"], kw.get("sinks", 0), S)(0, S)
            if opt.get("mask"):
                kw["attn_mask"] = bwd_keep_mask(torch, opt["mask"], B,
                                                Hq if opt.get("per_head") else 1, S, j)
                keep = keep & kw["attn_mask"]
            o, lse = exact_fwd(torch, q, k, v, keep)
            keys = tuple(tbwd.config_name(c, False, causal, kw.get("window", 0),
                                          "attn_mask" in kw) for c in ("C1", "C2"))
            counted_path(torch, what, keys, {}, totals,
                         lambda: tbwd.attention_backward(q, k, v, o, lse, do, sm_scale=D ** -0.5,
                                                         is_causal=causal, **kw), entries=calls)
            errs.append(bwd_vs_plain(torch, what, q, k, v, o, lse, do, causal, every_head=True,
                                     **kw)[0])
            if label.startswith("W = 37"):   # the whole wrapper, f32 out, against the CPU
                got = tbwd.attention_backward(q, k, v, o, lse, do, sm_scale=D ** -0.5,
                                              is_causal=causal, out_dtype=torch.float32, **kw)
                ref = tbwd.attention_backward(*(x.cpu() for x in (q, k, v, o, lse, do)),
                                              sm_scale=D ** -0.5, is_causal=causal,
                                              out_dtype=torch.float32, **kw)
                ds = [calc_diff(a.cpu(), b) for a, b in zip(got, ref)]
                check(all(d <= KERNEL_BAR for d in ds) and all(a.dtype == torch.float32
                                                               for a in got),
                      f"{what} through attention_backward (f32 out) vs the same call on the "
                      "CPU: dq/dk/dv calc_diff " + "/".join(f"{d:.3e}" for d in ds)
                      + f" <= {KERNEL_BAR}")
    entries = []
    for suffix, runs in rows.items():
        what, res, glue, lib, plain_ms = runs[0]
        more = "; ".join(f"{w}: C1 {r['C1'][0]:.3f} / C2 {r['C2'][0]:.3f} ms (backward.cu "
                         f"{r['C1'][1]:.3f} / {r['C2'][1]:.3f}), glue {gl:.3f}, library {lb:.3f}"
                         for w, r, gl, lb, _ in runs[1:])
        for kernel in ("C1", "C2"):
            ms, old, bound, wrapper = res[kernel]
            entries.append({"name": f"{kernel}-bf16{suffix}", "route": "cuda",
                            "source": SRC_BWD_SM90, "replaces": TPU_KERNELS[kernel],
                            "launches": 0, "max_abs_err": max(errs), "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
                            "library_ms": lib,
                            "shape": f"{what}; with the wrapper's glue {wrapper:.3f} ms; "
                                     f"backward.cu {old:.3f} ms; tile lists {glue:.3f} ms; "
                                     f"plain (C1 + C2) on the first and last q heads; library: "
                                     f"C1 + C2" + (f"; {more}" if more else "")})
    return entries


# ------------------------------- slice 10: B1 and B4-float on Hopper ----

# B1's shapes on the main paths: B, Hq, Hk, S, D, causal
B1_SHAPES = {"CogVideoX1.5": COG_SHAPE + (False,),
             "Llama-70B GQA": (1, 64, 8, 16384, 128, True),
             "HunyuanVideo": HUNYUAN_SHAPE + (False,),
             "Llama-3.1-8B 128K": LLAMA_128K + (True,)}
MPT_7B = (2, 32, 2048, 128)   # B, H, S, D: ALiBi, causal


def alibi_bias(torch, B, H, S):
    """MPT-7B's ALiBi: slopes 2^(-8 (h + 1) / H), -slope * (row - col) at
    and below the diagonal, f32 [B, H, S, S] (1 GiB at MPT-7B's shape)."""
    slopes = 2.0 ** (-8.0 * torch.arange(1, H + 1, device="cuda") / H)
    pos = torch.arange(S, device="cuda", dtype=torch.float32)
    alibi = (-slopes[:, None, None] * (pos[:, None] - pos[None, :]).clamp_min(0))
    return alibi[None].expand(B, H, S, S).contiguous()


def b1_phase(torch, st, totals):
    """B1 through ``sageattn`` at each of ``B1_SHAPES``, each call counted
    on its own (one B1 launch, on attention_sm90.cu), then the launch on
    all heads against its plain version on the sampled heads, its time and
    bound.  Returns B1's JSON entry (CogVideoX1.5's numbers)."""
    from sageattention_tpu_torch.utils.testing import time_fn
    res = {}
    for i, (label, (B, H, Hk, S, D, causal)) in enumerate(B1_SHAPES.items()):
        q, k, v = realistic_qkv(torch, B, H, Hk, S, D, SEED + 120 + i)
        what = f"{label} ({B},{H}/{Hk},{S},{D}) causal={causal}"
        call = lambda: st.sageattn(q, k, v, is_causal=causal)  # noqa: E731
        out, rec = counted_path(torch, f"{what} sageattn", ("B1",), {}, totals, call)
        exact_counts(f"{what} sageattn", read_counts(), {"B1": 1, "B2": 0})
        check(bool(torch.isfinite(out).all()) and out.shape == q.shape,
              f"{what} sageattn: finite output {tuple(out.shape)}")
        del out
        args, kw = rec["B1"]
        check(fwd_source(args[3], args[0]) == SRC_ATTN_SM90,
              f"{what}: B1 ran on {SRC_ATTN_SM90}")
        long = S > 100_000
        timer = (lambda fn: time_once(torch, fn)) if causal and long else (
            (lambda fn: trials_ms(torch, fn)) if long else kernel_ms)
        err, plain_ms, ms, bound = long_b1_check(torch, what, args, kw,
                                                 timer=lambda torch, fn: timer(fn))
        call_ms = timer(call) if not long else None
        if call_ms is not None:
            print(f"     {what}: sageattn {call_ms:.3f} ms a call", flush=True)
        res[label] = (err, plain_ms, ms, bound, call_ms)
        del q, k, v, args, kw, rec
        torch.cuda.empty_cache()
    err, plain_ms, ms, bound, _ = res["CogVideoX1.5"]
    return {"name": "B1", "route": "cuda", "source": SRC_ATTN_SM90,
            "replaces": TPU_KERNELS["B"], "launches": 0,
            "max_abs_err": max(r[0] for r in res.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "shape": f"{COG_SHAPE}; plain on q head 0; "
                     + "; ".join(f"{lb}: {r[2]:.3f} ms, bound {r[3][0]:.3f}"
                                 for lb, r in res.items())
                     + f"; D = 256 and f32/f16 Q on {SRC_ATTN}"}


def biased_flash_phase(torch, totals):
    """B4-float at MPT-7B's shape with its ALiBi bias, counted on its own,
    against the f32 oracle on two heads and its plain version on the
    sampled heads; its time, the bound over the bias tiles a causal launch
    reads, and the library's biased call.  Returns its JSON entry."""
    from sageattention_tpu_torch.ops.attention import attention_call
    from sageattention_tpu_torch.utils.testing import calc_diff
    B, H, S, D = MPT_7B
    q, k, v = realistic_qkv(torch, B, H, H, S, D, SEED + 23)
    bias = alibi_bias(torch, B, H, S)
    cfg = flash_cfg(torch, D, True, masked="float")
    what = f"MPT-7B ALiBi ({B},{H},{S},{D}) causal"
    out, rec = counted_path(torch, f"{what} flash", ("B4-float",), {}, totals,
                            lambda: attention_call(q, k, v, attn_mask=bias, cfg=cfg)[0])
    exact_counts(what, read_counts(), {"B4-float": 1})
    d = max(calc_diff(out[b, h], masked_oracle(torch, q[b, h], k[b, h], v[b, h],
                                               band_keep(torch, S, 0, S), bias[b, h]))
            for b, h in ((0, 0), (1, H - 1)))
    check(d < ORACLE_BAR, f"{what}: biased flash vs f32 oracle on 2 heads: {d:.3e} < "
                          f"{ORACLE_BAR}")
    args, kw = rec["B4-float"]
    check(fwd_source(args[3], args[0]) == SRC_FLASH, f"{what}: B4-float ran on {SRC_FLASH}")
    return attn_kernel_entry(torch, "B4-float", args, kw, 0)


def _edge_qkv(torch, g, B, Hq, Hk, Sq, Sk, D):
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    q, k, v = rn(B, Hq, Sq, D), rn(B, Hk, Sk, D), rn(B, Hk, Sk, D)
    k[..., 3] += 2.0
    return tuple(x.bfloat16() for x in (q, k, v))


def fwd_sm90_edges(torch):
    """B1 and B4-float on their Hopper kernels at head dims 64 and 128, each
    against its plain version on every head (lmin too for B1): lengths off
    the 64-row tiles, the block's rows and the kv tile, ``kv_len < Sk``, Sq
    != Sk, GQA 8/2, causal, NHD strides, sliced heads of a batch of two and
    a one-row tail block; for B4-float one bias for all heads, a
    zero-stride broadcast bias, a misaligned one (rows of 1001 floats: the
    wrapper pads a copy), and -inf entries with a row that sees no key.
    Returns the largest max_abs_err."""
    from sageattention_tpu_torch.ops.attention import attention_kernel, attention_plain
    from sageattention_tpu_torch.utils.testing import calc_diff
    g = torch.Generator(device="cuda").manual_seed(SEED + 130)
    nhd_view = lambda x: x.transpose(1, 2).contiguous().transpose(1, 2)  # noqa: E731
    errs = []

    def hold(what, args, kw):
        a = attention_kernel(*args, **kw)
        b = attention_plain(*args, **kw)
        kept, note = static_kept_rows(torch, a, b, args[0].shape[2])
        live = (b[1] > -1e19) & kept
        d = calc_diff(a[0][live], b[0][live])
        e = float((a[0].float() - b[0].float()).abs().max())
        dl = float((a[1][live] - b[1][live]).abs().max())
        errs.append(e)
        check(d < KERNEL_BAR and dl < LSE_BAR and bool(torch.equal(a[0][~live], b[0][~live]))
              and fwd_source(args[3], args[0]) in (SRC_FLASH, SRC_ATTN_SM90),
              f"{what} vs plain on every head{note}: calc_diff {d:.3e} < {KERNEL_BAR}, max_abs "
              f"{e:.3e}, lse {dl:.2e} < {LSE_BAR}, rows with no live key equal")

    for D in (64, 128):
        tail = 64 * (3 if D == 64 else 2) + 1   # one row past the first block
        # (label, B, Hq, Hk, Sq, Sk, causal, kv_len, nhd, sliced)
        cases = [("unaligned (1,4/2,1000)", 1, 4, 2, 1000, 1000, False, 0, False, False),
                 ("GQA 8/2, causal (1,8/2,1000)", 1, 8, 2, 1000, 1000, True, 0, False, False),
                 ("Sq 700 != Sk 1000", 1, 4, 2, 700, 1000, False, 0, False, False),
                 ("kv_len 900 of Sk 1000", 1, 4, 2, 1000, 1000, False, 900, False, False),
                 ("NHD strides, causal (1,4/2,1000)", 1, 4, 2, 1000, 1000, True, 0, True, False),
                 ("B = 2, q heads 1-4 of 8, kv heads 2-3 of 4, 1100", 2, 8, 4, 1100, 1100, False,
                  0, False, True),
                 (f"one-row tail, causal (1,2/1,{tail})", 1, 2, 1, tail, tail, True, 0, False,
                  False)]
        for label, B, Hq, Hk, Sq, Sk, causal, kv_len, nhd, sliced in cases:
            q, k, v = _edge_qkv(torch, g, B, Hq, Hk, Sq, Sk, D)
            if nhd:
                q, k, v = (nhd_view(x) for x in (q, k, v))
            if sliced:
                q, k, v = q[:, 1:5], k[:, 2:4], v[:, 2:4]
            # B1 on the quantizers' codes (Q stays a strided bf16 view)
            cfg = dataclasses.replace(attn_cfg(torch, "B1", D, causal), kv_len=kv_len)
            xs, kw = fused_args(torch, q, k, v, True)
            hold(f"B1 edge {label}, D={D}", (*xs, cfg), kw)
            # B4-float: a bias per head with a -inf column and a dead row
            bias = torch.randn(B, q.shape[1], Sq, Sk, generator=g, device="cuda")
            bias[..., 5] = float("-inf")
            bias[:, :, Sq // 2] = float("-inf")
            cfg = dataclasses.replace(flash_cfg(torch, D, causal, masked="float", kv_len=kv_len),
                                      emit_lse=True)
            hold(f"B4-float edge {label}, D={D}", (q, k, v, cfg), {"attn_mask": bias})
        q, k, v = _edge_qkv(torch, g, 2, 4, 4, 700, 700, D)
        one = torch.randn(1, 1, 700, 700, generator=g, device="cuda")
        for label, bias in (("one bias for all heads (Hm = 1)", one.expand(2, 1, 700, 700)
                             .contiguous()),
                            ("a zero-stride broadcast bias", one.expand(2, 4, 700, 700))):
            cfg = dataclasses.replace(flash_cfg(torch, D, True, masked="float"), emit_lse=True)
            hold(f"B4-float edge {label}, causal (2,4/4,700), D={D}", (q, k, v, cfg),
                 {"attn_mask": bias})
        q, k, v = _edge_qkv(torch, g, 1, 4, 2, 700, 1001, D)
        cfg = dataclasses.replace(flash_cfg(torch, D, False, masked="float"), emit_lse=True)
        hold(f"B4-float edge misaligned bias rows (700 x 1001), D={D}", (q, k, v, cfg),
             {"attn_mask": torch.randn(1, 4, 700, 1001, generator=g, device="cuda")})
    return max(errs)


def b1_rerun_phase(torch, st, totals):
    """x60 inputs through ``sageattn`` at head dims 64 and 128: B1 runs on
    attention_sm90.cu, its lmin falls below 2^-100 and the call reruns
    online (B2), and B1's lmin keeps the same tiles as the plain
    version's."""
    from sageattention_tpu_torch.ops.attention import attention_kernel, attention_plain
    g = torch.Generator(device="cuda").manual_seed(SEED + 131)
    for D in (64, 128):
        x = [(torch.randn(1, h, 4096, D, generator=g, device="cuda") * 60).bfloat16()
             for h in (8, 2, 2)]
        what = f"x60 (1,8/2,4096,{D}) sageattn"
        out, rec = counted_path(torch, what, ("B1", "B2"), {}, totals, lambda: st.sageattn(*x))
        exact_counts(what, read_counts(), {"B1": 1, "B2": 1})
        check(bool(torch.isfinite(out).all()), f"{what}: finite output after the rerun")
        args, kw = rec["B1"]
        a, b = attention_kernel(*args, **kw), attention_plain(*args, **kw)
        check(fwd_source(args[3], args[0]) == SRC_ATTN_SM90 and bool((a[2] < 2.0 ** -100).any()),
              f"{what}: B1 on {SRC_ATTN_SM90}, {int((a[2] < 2.0 ** -100).sum())} of "
              f"{a[2].numel()} tiles below 2^-100")
        static_kept_rows(torch, a, b, args[0].shape[2])


def run_fwd_sm90(torch, st, totals):
    """Phase 14 (slice 10): B1 on ``csrc/attention_sm90.cu`` and B4-float
    on ``csrc/flash_sm90.cu``'s biased instantiations.  Returns their JSON
    entries, which replace the earlier phases' rows of the same keys."""
    b1 = b1_phase(torch, st, totals)
    biased = biased_flash_phase(torch, totals)
    edge_err = fwd_sm90_edges(torch)
    b1_rerun_phase(torch, st, totals)
    b1["max_abs_err"] = max(b1["max_abs_err"], edge_err)
    biased["max_abs_err"] = max(biased["max_abs_err"], edge_err)
    return [b1, biased]


# ------------------------------ slice 11: B6 and B10-B6 on Hopper ----

# B6's shapes on the main paths: B, Hq, Hk, S, D, causal
B6_SHAPES = {"CogVideoX1.5": COG_SHAPE + (False,),
             "Llama-70B GQA": (1, 64, 8, 16384, 128, True)}


def b6_phase(torch, st, totals):
    """B6 through ``sageattn`` at each of ``B6_SHAPES``, static with
    per-column K scales (``k_scale_mode="fine"``) and with the scale folded
    into Q's (``fuse_q_quant=False``), and at CogVideoX1.5 the fine call
    with its predictive check refused (B6-online): each call counted on its
    own (one launch, on attention_q8_sm90.cu) and held to flash, then its
    launch on all heads against the plain version on the sampled heads, with
    its time and bound.  Returns the JSON entries of B6-static and B6-online
    (CogVideoX1.5's fine calls)."""
    from sageattention_tpu_torch import core
    entries = {}
    for i, (label, (B, H, Hk, S, D, causal)) in enumerate(B6_SHAPES.items()):
        q, k, v = realistic_qkv(torch, B, H, Hk, S, D, SEED + 140 + i)
        flash = st.flash_attention(q, k, v, is_causal=causal)
        calls = [("fine", "B6-static", dict(k_scale_mode="fine")),
                 ("folded", "B6-static", dict(fuse_q_quant=False))]
        if label == "CogVideoX1.5":
            calls.append(("fine, static check refused", "B6-online", dict(k_scale_mode="fine")))
        for how, key, kw in calls:
            what = f"{label} ({B},{H}/{Hk},{S},{D}) causal={causal} sageattn {how}"
            real = core._static_safe
            if key == "B6-online":
                core._static_safe = lambda **_: False
            try:
                out, rec = counted_path(torch, what, (key,), {}, totals,
                                        lambda: st.sageattn(q, k, v, is_causal=causal, **kw))
            finally:
                core._static_safe = real
            exact_counts(what, read_counts(), {key: 1})
            check(bool(torch.isfinite(out).all()) and out.shape == q.shape,
                  f"{what}: finite output {tuple(out.shape)}")
            check_vs(f"{what} vs flash", out, flash, "int8")
            args, akw = rec[key]
            check(fwd_source(args[3], args[0]) == SRC_Q8_SM90, f"{what}: {key} ran on {SRC_Q8_SM90}")
            e = attn_kernel_entry(torch, key, args, akw, 0, label=f"{key} ({what})")
            if label == "CogVideoX1.5" and how != "folded":
                entries[key] = dict(e, name=key)
            del out, rec, args, akw
        del q, k, v, flash
        torch.cuda.empty_cache()
    return [entries["B6-static"], entries["B6-online"]]


def b10_b6_phase(torch, st, totals):
    """The ring over 4 virtual ranks at CogVideoX1.5 (padded chunks:
    B10-B6-static-kvtrue) and at Llama-3.1-8B 65,536 causal (device
    offsets: B10-B6-static-offsets), each also on x60 inputs whose static
    check every rank refuses (B10-B6-online-kvtrue, -online-offsets), each
    counted on its own and held to flash; then every kind of their B10-B6
    launches against the plain version on sampled heads.  Returns one JSON
    entry per key, from its launch with the most work."""
    from sageattention_tpu_torch.utils.testing import calc_diff
    rec = ring_recorder(torch)
    runs = [("CogVideoX1.5", COG_SHAPE, False, "kvtrue"), ("Llama-3.1-8B", LLAMA_LONG, True, "offsets")]
    for i, (label, (B, H, Hk, S, D), causal, suffix) in enumerate(runs):
        g = torch.Generator(device="cuda").manual_seed(SEED + 152 + i)
        for adv in (False, True):
            x = ([(torch.randn(B, h, S, D, generator=g, device="cuda") * 60).to(torch.bfloat16)
                  for h in (H, Hk, Hk)] if adv else realistic_qkv(torch, B, H, Hk, S, D,
                                                                  SEED + 150 + i))
            key = f"B10-B6-{'online' if adv else 'static'}-{suffix}"
            what = (f"15 ring {label} ({B},{H}/{Hk},{S},{D}) causal={causal}"
                    f"{' x60 inputs' if adv else ''} on 4 ranks")
            with rec:
                (out, safe), _ = counted_path(torch, what, [key], {}, totals,
                                              lambda: virtual_ring(torch, *x, 4, is_causal=causal))
            check(bool(torch.isfinite(out).all()) and out.shape == x[0].shape,
                  f"{what}: finite output {tuple(out.shape)}")
            check(not any(safe) if adv else all(safe),
                  f"{what}: every rank {'refused' if adv else 'took'} the static softmax")
            flash = st.flash_attention(*x, is_causal=causal)
            if adv:
                d = calc_diff(out, flash)
                check(d < RING_ADV_BAR, f"{what}: vs flash calc_diff {d:.3e} < {RING_ADV_BAR}")
            else:
                check_vs(f"{what} vs flash", out, flash, "int8")
            del x, out, flash
            torch.cuda.empty_cache()
    calls = {n: c for n, c in rec.calls.items() if n.startswith("B10-B6-")}
    for name, kinds in calls.items():
        args = kinds[0][0]
        check(fwd_source(args[3], args[0]) == SRC_Q8_SM90, f"{name} ran on {SRC_Q8_SM90}")
    entries = b10_checks(torch, calls, totals)
    rec.calls.clear()
    torch.cuda.empty_cache()
    return entries


def q8_sm90_edges(torch, names=("B6-static", "B6-online")):
    """B6 and B10-B6 (``names``: B5-fp8 and its B10 forms in phase 17,
    B-pvbf16's in phase 18) on
    their Hopper kernel at head dims 64 and 128, static and online, each
    against its plain version on every head: a hidden
    chunk pair (no kv tile), a diagonal and a partly hidden pair, a padded
    chunk with fewer than 64 real rows and a one-row tail block, a chunk of
    padding only, an unaligned Sk with per-column K scales, GQA 8/2 with
    kv_len < Sk, a batch of two with NHD-strided codes, Q groups of 4, 32
    and 128 rows.  Rows
    that see no key must equal the plain version's (v_mean, or 0) exactly.
    Returns the largest max_abs_err."""
    from sageattention_tpu_torch.ops.attention import (attention_kernel, attention_plain,
                                                       config_name)
    from sageattention_tpu_torch.utils.testing import calc_diff
    g = torch.Generator(device="cuda").manual_seed(SEED + 160)
    nhd_view = lambda x: x.transpose(1, 2).contiguous().transpose(1, 2)  # noqa: E731
    errs = []
    for D in (64, 128):
        BM = 64 * (3 if D == 64 else 2)
        # (label, B, Hq, Hk, Sq, Sk, causal, kv_len, offsets, kv_true, fold, q_group)
        cases = [("hidden pair (no kv tile)", 1, 4, 2, 640, 640, True, 0, (0, 640), None, True, 4),
                 ("diagonal pair", 1, 4, 2, 1024, 1024, True, 0, (1024, 1024), None, True, 128),
                 ("partly hidden pair (shift -300)", 1, 4, 2, 1000, 1000, True, 0, (0, 300), None,
                  True, 32),
                 (f"padded chunk, 40 real rows, one-row tail (Sq {BM + 1})", 1, 4, 2, BM + 1, 640,
                  False, 0, None, 40, True, 4),
                 ("a chunk of padding only (no real row)", 1, 4, 2, 640, 640, False, 0, None, 0,
                  True, 32),
                 ("unaligned Sk (Sq 700, Sk 1001), per-column K scales", 1, 4, 2, 700, 1001, False,
                  0, None, None, False, 4),
                 ("GQA 8/2, causal, kv_len 900 of 1000", 1, 8, 2, 1000, 1000, True, 900, None, None,
                  False, 32),
                 ("B = 2, NHD codes, offsets and true length", 2, 4, 4, 640, 640, True, 0,
                  (640, 0), 500, True, 128)]
        for label, B, Hq, Hk, Sq, Sk, causal, kv_len, offs, kv_true, fold, q_group in cases:
            q, k, v = _edge_qkv(torch, g, B, Hq, Hk, Sq, Sk, D)
            shift = offs[0] - offs[1] if offs else 0
            kv_eff = min(kv_len or Sk, Sk if kv_true is None else kv_true)
            rows = torch.arange(Sq, device="cuda")
            live = (torch.clamp(rows + shift + 1, max=kv_eff) > 0) if causal else (
                torch.full((Sq,), kv_eff > 0, device="cuda"))
            for name in names:
                ring = offs is not None or kv_true is not None
                cfg = dataclasses.replace(
                    attn_cfg(torch, name, D, causal), fold_k_scale=fold, kv_len=kv_len,
                    causal_dynamic=offs is not None, kv_len_dynamic=kv_true is not None,
                    fuse_v_mean=not ring and not name.startswith("B-pvbf16"))
                xs, kw = kernel_args(torch, cfg, q, k, v, q_group)
                if ring:
                    kw.pop("v_mean", None)   # the ring adds each chunk's V mean after the merge
                if offs is not None:
                    kw["offsets"] = torch.tensor(offs, dtype=torch.int32, device="cuda")
                if kv_true is not None:
                    kw["kv_true"] = torch.tensor([kv_true], dtype=torch.int32, device="cuda")
                if B == 2:
                    xs = (nhd_view(xs[0]), nhd_view(xs[1]), xs[2])
                what = f"{config_name(cfg, Sq)} edge {label}, D={D}"
                a = attention_kernel(*xs, cfg, **kw)
                b = attention_plain(*xs, cfg, **kw)
                d = calc_diff(a[0][:, :, live], b[0][:, :, live]) if bool(live.any()) else 0.0
                e = float((a[0].float() - b[0].float()).abs().max())
                dl = float((a[1] - b[1]).abs().max())
                errs.append(e)
                check(d < KERNEL_BAR and dl < LSE_BAR
                      and bool(torch.equal(a[0][:, :, ~live], b[0][:, :, ~live]))
                      and fwd_source(cfg, xs[0]) == SRC_Q8_SM90,
                      f"{what} vs plain on every head ({int(live.sum())} of {Sq} rows see a key): "
                      f"calc_diff {d:.3e} < {KERNEL_BAR}, max_abs {e:.3e}, lse {dl:.2e} < "
                      f"{LSE_BAR}, rows with no key equal, on {SRC_Q8_SM90}")
    return max(errs)


def run_q8_sm90(torch, st, totals):
    """Phase 15 (slice 11): B6 and the ring's B10-B6 forms on
    ``csrc/attention_q8_sm90.cu``.  Returns their JSON entries, which
    replace phases 4's and 10's rows of the same keys."""
    entries = b6_phase(torch, st, totals) + b10_b6_phase(torch, st, totals)
    edge_err = q8_sm90_edges(torch)
    for e in entries:
        e["max_abs_err"] = max(e["max_abs_err"], edge_err)
    return entries


# ------------------------ slice 14: B-pvbf16 and D1-int8 on Hopper ----

SRC_D1_SM90 = "sageattention_tpu_torch/csrc/paged_decode_sm90.cu"
# B-pvbf16's shapes on the main paths: B, Hq, Hk, S, D, causal
PVBF16_SHAPES = B6_SHAPES
# the ring's padded CogVideoX1.5 chunks on 8 ranks: 2,560 rows, the seventh
# holding 2,416 real ones and the eighth none
PVBF16_CHUNK = (1, 48, 48, 2560, 64)


def pvbf16_phase(torch, st, totals):
    """B-pvbf16 at each of ``PVBF16_SHAPES`` through
    ``sageattn_qk_int8_pv_bf16`` (a pre-quantized Q with per-column K
    scales: attention_q8_sm90.cu) and through ``sageattn(pv_dtype="bf16",
    k_scale_mode="head")`` (a fused Q, static: attention_sm90.cu), and at
    CogVideoX1.5 the first with its predictive check refused
    (B-pvbf16-online): each call counted on its own (one launch), held to
    flash (cosine >= 0.999), its launch on all heads against the plain
    version on the sampled heads, with its time and bound and the call's
    time.  Returns the JSON entries of CogVideoX1.5's launches, the fused
    form's named ``B-pvbf16 fused Q`` with its own launch count."""
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.utils.testing import time_fn
    entries, fused = {}, 0
    for i, (label, (B, H, Hk, S, D, causal)) in enumerate(PVBF16_SHAPES.items()):
        q, k, v = realistic_qkv(torch, B, H, Hk, S, D, SEED + 190 + i)
        flash = st.flash_attention(q, k, v, is_causal=causal)
        calls = [("sageattn_qk_int8_pv_bf16", "B-pvbf16", SRC_Q8_SM90,
                  lambda: st.sageattn_qk_int8_pv_bf16(q, k, v, is_causal=causal)),
                 ("sageattn pv_dtype=bf16, head K scales (fused Q)", "B-pvbf16", SRC_ATTN_SM90,
                  lambda: core._sage_attention(q, k, v, is_causal=causal, pv_dtype="bf16",
                                               k_scale_mode="head"))]
        if label == "CogVideoX1.5":
            calls.append(("sageattn_qk_int8_pv_bf16, static check refused", "B-pvbf16-online",
                          SRC_Q8_SM90, calls[0][3]))
        for how, key, src, fn in calls:
            what = f"{label} ({B},{H}/{Hk},{S},{D}) causal={causal} {how}"
            real = core._static_safe
            if key == "B-pvbf16-online":
                core._static_safe = lambda **_: False
            try:
                out, rec = counted_path(torch, what, (key,), {}, totals, fn)
                exact_counts(what, read_counts(), {key: 1})
                call_ms = time_fn(fn, warmup=2, reps=10) * 1e3
            finally:
                core._static_safe = real
            check(bool(torch.isfinite(out).all()) and out.shape == q.shape,
                  f"{what}: finite output {tuple(out.shape)}")
            check_vs(f"{what} vs flash", out, flash, "int8")
            args, akw = rec[key]
            check(fwd_source(args[3], args[0]) == src, f"{what}: {key} ran on {src}")
            e = attn_kernel_entry(torch, key, args, akw, 0, label=f"{key} ({what})")
            print(f"     {what}: {call_ms:.3f} ms a call", flush=True)
            if src == SRC_ATTN_SM90:
                fused += 1
            if label == "CogVideoX1.5":
                name = f"{key} fused Q" if src == SRC_ATTN_SM90 else key
                entries[name] = dict(e, name=name)
            del out, rec, args, akw
        del q, k, v, flash
        torch.cuda.empty_cache()
    entries["B-pvbf16 fused Q"]["launches"] = fused
    return list(entries.values())


def pvbf16_edges(torch, st, totals):
    """B-pvbf16 on its Hopper kernels at head dims 64 and 128, each against
    its plain version on every head: ``q8_sm90_edges`` in B-pvbf16's forms
    (static, online and the ring's, hidden pairs and a chunk of padding
    only among them); the ring's padded CogVideoX1.5 chunks on 8 ranks (48
    heads, 2,560 rows: 2,416 real, and none); the fused-Q form (lmin too):
    lengths off the tiles, GQA 8/2 causal, ``kv_len < Sk``, NHD strides and
    a one-row tail block; and an fp16 call of ``sageattn_qk_int8_pv_fp16_cuda``
    (fp16 output).  Returns the largest max_abs_err."""
    from sageattention_tpu_torch.ops.attention import attention_kernel, attention_plain
    from sageattention_tpu_torch.utils.testing import calc_diff
    errs = [q8_sm90_edges(torch, ("B-pvbf16", "B-pvbf16-online"))]
    g = torch.Generator(device="cuda").manual_seed(SEED + 195)
    nhd_view = lambda x: x.transpose(1, 2).contiguous().transpose(1, 2)  # noqa: E731

    def hold(what, args, kw, src, live=None):
        a = attention_kernel(*args, **kw)
        b = attention_plain(*args, **kw)
        kept, note = static_kept_rows(torch, a, b, args[0].shape[2])
        live = ((b[1] > -1e19) if live is None else live) & kept
        d = calc_diff(a[0][live], b[0][live]) if bool(live.any()) else 0.0
        e = float((a[0].float() - b[0].float()).abs().max())
        dl = float((a[1][live] - b[1][live]).abs().max()) if bool(live.any()) else 0.0
        errs.append(e)
        check(d < KERNEL_BAR and dl < LSE_BAR and bool(torch.equal(a[0][~live], b[0][~live]))
              and a[0].dtype == b[0].dtype and fwd_source(args[3], args[0]) == src,
              f"{what} vs plain on every head{note} ({int(live.sum())} of {live.numel()} rows "
              f"see a key): calc_diff {d:.3e} < {KERNEL_BAR}, max_abs {e:.3e}, lse {dl:.2e} < "
              f"{LSE_BAR}, rows with no key equal, {a[0].dtype}, on {src}")

    B, H, Hk, S, D = PVBF16_CHUNK
    q, k, v = _edge_qkv(torch, g, B, H, Hk, S, S, D)
    cfg = dataclasses.replace(attn_cfg(torch, "B-pvbf16", D, False), fold_k_scale=True,
                              kv_len_dynamic=True)
    xs, kw = kernel_args(torch, cfg, q, k, v)
    for real in (2416, 0):
        kw["kv_true"] = torch.tensor([real], dtype=torch.int32, device="cuda")
        hold(f"B10-B-pvbf16-kvtrue, CogVideoX1.5 chunk on 8 ranks {(B, H, S, D)}, {real} real "
             f"rows", (*xs, cfg), kw, SRC_Q8_SM90,
             live=torch.full((B, H, S), real > 0, device="cuda"))
    del q, k, v, xs, kw
    for D in (64, 128):
        tail = 64 * (3 if D == 64 else 2) + 1
        # (label, B, Hq, Hk, S, causal, kv_len, nhd)
        cases = [("unaligned (1,4/2,1000)", 1, 4, 2, 1000, False, 0, False),
                 ("GQA 8/2, causal (1,8/2,1000)", 1, 8, 2, 1000, True, 0, False),
                 ("kv_len 900 of Sk 1000", 1, 4, 2, 1000, False, 900, False),
                 ("NHD strides, causal (1,4/2,1000)", 1, 4, 2, 1000, True, 0, True),
                 (f"one-row tail, causal (1,2/1,{tail})", 1, 2, 1, tail, True, 0, False)]
        for label, B, Hq, Hk, S, causal, kv_len, nhd in cases:
            q, k, v = _edge_qkv(torch, g, B, Hq, Hk, S, S, D)
            if nhd:
                q, k, v = (nhd_view(x) for x in (q, k, v))
            cfg = dataclasses.replace(attn_cfg(torch, "B-pvbf16", D, causal), fuse_q_quant=True,
                                      fold_k_scale=True, kv_len=kv_len)
            xs, kw = kernel_args(torch, cfg, q, k, v)
            hold(f"B-pvbf16 fused Q edge {label}, D={D}", (*xs, cfg), kw, SRC_ATTN_SM90)
    q, k, v = (x.half() for x in _edge_qkv(torch, g, 1, 8, 2, 4096, 4096, 128))
    what = "sageattn_qk_int8_pv_fp16_cuda, fp16 (1,8/2,4096,128) causal"
    out, rec = counted_path(torch, what, ("B-pvbf16",), {}, totals,
                            lambda: st.sageattn_qk_int8_pv_fp16_cuda(q, k, v, is_causal=True))
    check(out.dtype == torch.float16 and bool(torch.isfinite(out).all()),
          f"{what}: finite fp16 output")
    args, akw = rec["B-pvbf16"]
    args = (*args[:3], dataclasses.replace(args[3], emit_lse=True), *args[4:])
    hold(f"B-pvbf16 edge {what}", args, akw, SRC_Q8_SM90)
    return max(errs)


def _d1_pools(torch, g, P, Hk, page, D):
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    k8 = torch.randint(-127, 128, (P, Hk, page, D), generator=g, device="cuda", dtype=torch.int8)
    v8 = torch.randint(-127, 128, (P, Hk, page, D), generator=g, device="cuda", dtype=torch.int8)
    ks = rn(P, Hk, 1, page).abs() * 0.01 + 0.002
    vs, vm = rn(1, Hk, 1, D).abs() * 0.01 + 0.005, rn(1, Hk, 1, D) * 0.1
    return k8, ks, v8, vs, vm


def _d1_stream(torch, table, lens, page, n_pages, window=0, sinks=0):
    """``sageattn_decode_paged``'s stream for ``table`` and ``lens``: the
    effective table, and for a sliding window the logical pages and the
    window's lower bound."""
    B, max_pages = table.shape
    dev = table.device
    last = torch.clamp_min(lens - 1, 0) // page
    slot = torch.arange(max_pages, device=dev).expand(B, max_pages)
    lpage = lo = None
    if window:
        lo = torch.clamp_min(torch.clamp_min(lens - window, 0), sinks)
        sp = -(-sinks // page) if sinks else 0
        band = (lo // page)[:, None] + torch.arange(n_pages - sp, device=dev)[None, :]
        slot = torch.cat([torch.arange(sp, device=dev).expand(B, sp), band], 1)
        lpage = slot.to(torch.int32)
    slot_c = torch.clamp(torch.minimum(slot, last[:, None]), max=max_pages - 1)
    return torch.gather(table, 1, slot_c.long()).to(torch.int32), lpage, lo


def d1_edges(torch):
    """D1-int8 on ``csrc/paged_decode_sm90.cu`` at head dims 64 and 128,
    each launch against its plain version on every head (rows that see no
    key: v_mean exactly, and an lse of -1e30 in both): lengths 0, 1, a page
    boundary and one past it over pages out of order, with ``emit_state``;
    a T = 4 window over GQA heads (a length-1 sequence's first rows see no
    key); a sliding window whose lower bound falls inside a page with sinks
    covering part of one; 32 window rows of 2 GQA heads a block, 8 rows of 4
    (64 and 32 rows a block); one row a head (MHA).  A slot frozen mid-run
    is phase 8b's.  Returns the largest max_abs_err."""
    from sageattention_tpu_torch.ops import paged_decode as tpd
    from sageattention_tpu_torch.utils.testing import calc_diff
    g = torch.Generator(device="cuda").manual_seed(SEED + 200)
    errs = []
    page = 256
    # (label, Hg, Hk, R, lens, T, window, sinks, state)
    cases = [("lengths 0, 1, 256, 257, 4100, pages out of order", 2, 2, 4,
              (0, 1, 256, 257, 4100), 1, 0, 0, True),
             ("T = 4 window, GQA 8/2, lengths 300, 517, 1", 8, 2, 4, (300, 517, 1), 4, 0, 0,
              False),
             ("sliding W = 300 with 4 sinks, lengths 5000, 700, 290", 2, 2, 4, (5000, 700, 290),
              1, 300, 4, False),
             ("T = 32 window, 2 heads a block (64 rows)", 8, 2, 32, (2000, 1500), 32, 0, 0,
              False),
             ("T = 8 window, 4 heads a block (32 rows)", 8, 2, 8, (1200, 64), 8, 0, 0, False),
             ("MHA, one row a head, with state", 4, 4, 1, (3000, 129), 1, 0, 0, True)]
    for D in (64, 128):
        for label, Hg, Hk, R, lens, T, window, sinks, state in cases:
            B = len(lens)
            max_pages = -(-max(lens) // page) + 1
            P = B * max_pages + 3
            k8, ks, v8, vs, vm = _d1_pools(torch, g, P, Hk, page, D)
            perm = torch.randperm(P, generator=g, device="cuda")[:B * max_pages]
            table = perm.reshape(B, max_pages).to(torch.int32)
            L = torch.tensor(lens, dtype=torch.int32, device="cuda")
            n_pages = max_pages
            if window:
                sp = -(-sinks // page) if sinks else 0
                band = min(max_pages, -(-window // page) + 1)
                n_pages = sp + band if sp else min(n_pages, band)
            table_eff, lpage, lo = _d1_stream(torch, table, L, page, n_pages, window, sinks)
            q = (torch.randn(B, Hg, R, D, generator=g, device="cuda") * D ** -0.5).bfloat16()
            args = (q, k8, ks, v8, vs, vm, table_eff, L)
            kw = dict(n_pages=n_pages, window=T, lpage=lpage, win_lo=lo, sinks=sinks,
                      emit_state=state)
            a = tpd.paged_decode_kernel(*args, **kw)
            b = tpd.paged_decode_plain(*args, **kw)
            what = f"D1-int8 edge {label}, D={D}"
            # the rows that see a key: the plain version's l > 0, from its lse
            # (or, without state, the length and the window)
            rows = torch.arange(R, device="cuda")
            if T > 1:
                seen = (L[:, None] - T + rows[None, :] >= 0)[:, None, :].expand(B, Hg, R)
            else:
                seen = (L > 0)[:, None, None].expand(B, Hg, R)
            d = calc_diff(a[0][seen], b[0][seen]) if bool(seen.any()) else 0.0
            e = float((a[0].float() - b[0].float()).abs().max())
            ok = d < KERNEL_BAR and bool(torch.equal(a[0][~seen], b[0][~seen]))
            if state:
                dl = float((a[1][seen] - b[1][seen]).abs().max()) if bool(seen.any()) else 0.0
                ok = (ok and dl < LSE_BAR and bool(torch.equal(b[1] > -1e29, seen))
                      and bool((a[1][~seen] == -1e30).all()))
            errs.append(e)
            check(ok and tpd.d1_sm90_route(v8.dtype, D),
                  f"{what} vs plain on every head ({int(seen.sum())} of {seen.numel()} rows see "
                  f"a key): calc_diff {d:.3e} < {KERNEL_BAR}, max_abs {e:.3e}, rows with no key "
                  f"equal, on {SRC_D1_SM90}")
    return max(errs)


def run_pvbf16_d1_sm90(torch, st, totals):
    """Phase 18 (slice 14): B-pvbf16 on ``csrc/attention_q8_sm90.cu``
    (pre-quantized Q, static and online; the ring's B10 forms in phase 10)
    and ``csrc/attention_sm90.cu`` (fused Q, static), and D1-int8 on
    ``csrc/paged_decode_sm90.cu`` (phase 8 timed its launches), each against
    its plain version: the main-path calls, then the edge cases.  Returns
    the B-pvbf16 JSON entries, which replace phase 4's of the same keys."""
    entries = pvbf16_phase(torch, st, totals)
    err = pvbf16_edges(torch, st, totals)
    for e in entries:
        e["max_abs_err"] = max(e["max_abs_err"], err)
    print(f"     D1-int8 edges: max_abs_err {d1_edges(torch):.3e}", flush=True)
    return entries


# ------------------------------------------------ slice 16 (phase 20) ----

# (label, B, Hq, Hk, length, T, folded, max_len, bucket, emit_lse)
B11_EDGES = [("length 0", 1, 8, 2, 0, 1, True, 512, 512, False),
             ("length 1", 1, 8, 2, 1, 1, True, 512, 512, False),
             ("length 256 (a tile boundary)", 1, 8, 2, 256, 1, True, 512, 512, False),
             ("length 257 (one past it)", 1, 8, 2, 257, 1, True, 512, 512, False),
             ("a bucket of 384 of a 1,024-token cache", 1, 8, 2, 300, 1, True, 1024, 384,
              False),
             ("B = 3, per-sequence V scales, MHA, lse", 3, 4, 4, 700, 1, True, 768, 768, True),
             ("a T = 4 window at length 2", 1, 8, 2, 2, 4, True, 256, 256, False),
             ("folded T = 4 window, GQA 8/2", 1, 8, 2, 1000, 4, True, 1024, 1024, False),
             ("folded T = 9 window (36 rows), B = 2", 2, 8, 2, 3000, 9, True, 4096, 3072, False),
             ("unfolded T = 25 window, GQA 8/2 (2 heads a block)", 1, 8, 2, 2000, 25, False,
              2048, 2048, False),
             ("64 folded rows (T = 16, GQA 8/2)", 1, 8, 2, 1500, 16, True, 2048, 2048, False),
             ("65 folded rows (T = 13, GQA 10/2)", 1, 10, 2, 1500, 13, True, 2048, 2048, True)]


def b11_edges(torch):
    """B11-int8 on ``csrc/decode_sm90.cu`` at head dims 64 and 128 over a
    dense cache's view (random codes and scales, per-sequence V scale and
    mean), each launch (one for every row) against ``decode_plain`` on
    every head: the cases of ``B11_EDGES``.  Returns the largest
    max_abs_err."""
    from sageattention_tpu_torch.ops import attention as tatt
    from sageattention_tpu_torch.utils.testing import calc_diff
    g = torch.Generator(device="cuda").manual_seed(SEED + 210)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    errs = []
    for D in (64, 128):
        for label, B, Hq, Hk, L, T, fold, max_len, bucket, lse in B11_EDGES:
            codes = lambda: torch.randint(-127, 128, (B, Hk, max_len, D), generator=g,  # noqa: E731
                                          device="cuda", dtype=torch.int8)
            k8, v8 = codes(), codes()
            ks = rn(B, Hk, 1, max_len).abs() * 0.01 + 0.002
            vs, vm = rn(B, Hk, 1, D).abs() * 0.01 + 0.005, rn(B, Hk, 1, D) * 0.1
            G = Hq // Hk
            q = rn(B, Hk, G * T, D) if fold else rn(B, Hq, T, D)
            q = q.bfloat16()
            causal = T > 1
            cfg = tatt.AttnConfig(causal=causal, causal_dynamic=causal,
                                  causal_row_mod=T if fold and causal else 0, quantized=True,
                                  pv_dtype="int8", sm_scale=D ** -0.5, kv_len=bucket,
                                  kv_len_dynamic=True, fuse_v_mean=True, emit_lse=lse,
                                  fuse_q_quant=True)
            kv_true = torch.tensor([L], dtype=torch.int32, device="cuda")
            offsets = (torch.tensor([L - T, 0], dtype=torch.int32, device="cuda") if causal
                       else None)
            args = (q, k8[:, :, :bucket], v8[:, :, :bucket], cfg, ks[..., :bucket], vs, vm,
                    kv_true, offsets)
            name = tatt.config_name(cfg, q.shape[2])
            before = tatt.attention_call.launches[name]
            a = tatt.decode_kernel(*args)
            launches = tatt.attention_call.launches[name] - before
            b = tatt.decode_plain(*args)
            # rows that see a key: row r of a head sits at L - T + r % T (folded)
            rows = torch.arange(q.shape[2], device="cuda") % T
            seen = ((L - T + rows >= 0) & (L > 0))[None, None, :].expand_as(a[0][..., 0])
            d = calc_diff(a[0][seen], b[0][seen]) if bool(seen.any()) else 0.0
            e = float((a[0].float() - b[0].float()).abs().max())
            ok = (d < KERNEL_BAR and bool(torch.equal(a[0][~seen], b[0][~seen]))
                  and a[0].dtype == b[0].dtype == torch.bfloat16)
            if lse:
                dl = float((a[1] - b[1]).abs().max())
                ok = ok and dl < LSE_BAR
            errs.append(e)
            check(ok and launches == 1 and tatt.b11_sm90_route(cfg, q.shape[2], D, torch.int8),
                  f"{name} edge {label}, D={D}, q {tuple(q.shape)}: {launches} launch vs plain on "
                  f"every head ({int(seen.sum())} of {seen.numel()} rows see a key): calc_diff "
                  f"{d:.3e} < {KERNEL_BAR}, max_abs {e:.3e}, rows with no key equal, on "
                  f"{SRC_DECODE_SM90}")
    return max(errs)


def run_b11_sm90(torch, st, totals):
    """Phase 20 (slice 16): B11-int8's edge cases on ``csrc/decode_sm90.cu``
    (phases 8 and 9b hold and time its launches on the serving paths).
    Returns no JSON entry."""
    print(f"     B11-int8 edges: max_abs_err {b11_edges(torch):.3e}", flush=True)
    return []


# ------------------------------------------------ slice 17 (phase 21) ----

SRC_ONLINE_SM90 = "sageattention_tpu_torch/csrc/attention_online_sm90.cu"
ONLINE_SHAPES = {"Llama-70B GQA": (1, 64, 8, 16384, 128, True),
                 "CogVideoX1.5": COG_SHAPE + (False,)}
# the C entries an online call may and may not reach
ONLINE_ENTRIES = {"sage_attn_fwd_online_sm90": True, "sage_attn_fwd": False,
                  "sage_attn_fwd_q8": False}
B5I8_ENTRIES = {"sage_attn_fwd_q8_sm90": True, "sage_attn_fwd": False, "sage_attn_fwd_q8": False}


def online_phase(torch, st, totals):
    """The four keys through their public calls at Llama-70B GQA causal and
    the fused-Q B-pvbf16-online at CogVideoX1.5: B5-fp8-fusedq
    (``sageattn(pv_dtype="fp8")``) and B5-int8 (the int8-P online call) on
    activation-like inputs, B2 and the fused-Q B-pvbf16-online as the
    online reruns of ``sageattn`` and ``sageattn(pv_dtype="bf16")`` on x60
    inputs; each call counted on its own (the key launched once, on its
    Hopper entry and never on ``sage_attn_fwd``/``sage_attn_fwd_q8``), its
    launch on all heads against the plain version on sampled heads, timed.
    Returns the JSON entry of the fused-Q B-pvbf16-online at CogVideoX1.5,
    with its own launch count."""
    from sageattention_tpu_torch import core
    entry, fused = None, 0
    for i, (label, (B, H, Hk, S, D, causal)) in enumerate(ONLINE_SHAPES.items()):
        real = realistic_qkv(torch, B, H, Hk, S, D, SEED + 220 + i)
        g = torch.Generator(device="cuda").manual_seed(SEED + 222 + i)
        adv = [(torch.randn(B, h, S, D, generator=g, device="cuda") * 60).bfloat16()
               for h in (H, Hk, Hk)]
        # (label, key, source, C entries, call)
        calls = [("sageattn pv_dtype=bf16, x60 inputs (online rerun)", "B-pvbf16-online",
                  SRC_ONLINE_SM90, ONLINE_ENTRIES,
                  lambda: st.sageattn(*adv, is_causal=causal, pv_dtype="bf16"))]
        if label != "CogVideoX1.5":
            calls = [("sageattn pv_dtype=fp8", "B5-fp8-fusedq", SRC_ONLINE_SM90, ONLINE_ENTRIES,
                      lambda: st.sageattn(*real, is_causal=causal, pv_dtype="fp8")),
                     ("int8 P online (fine K scales)", "B5-int8", SRC_Q8_SM90, B5I8_ENTRIES,
                      lambda: core._sage_attention(*real, is_causal=causal, pv_dtype="int8",
                                                   softmax_mode="online")),
                     ("sageattn, x60 inputs (online rerun)", "B2", SRC_ONLINE_SM90,
                      ONLINE_ENTRIES, lambda: st.sageattn(*adv, is_causal=causal))] + calls
        for how, key, src, ents, fn in calls:
            what = f"21 {label} ({B},{H}/{Hk},{S},{D}) causal={causal} {how}"
            out, rec = counted_path(torch, what, (key,), {}, totals, fn, entries=ents)
            exact_counts(what, read_counts(), {key: 1})
            check(bool(torch.isfinite(out).all()) and out.shape == real[0].shape,
                  f"{what}: finite output {tuple(out.shape)}")
            args, akw = rec[key]
            check(fwd_source(args[3], args[0]) == src, f"{what}: {key} ran on {src}")
            e = attn_kernel_entry(torch, key, args, akw, 0, label=f"{key} ({what})")
            if src == SRC_ONLINE_SM90 and key == "B-pvbf16-online":
                fused += 1
                if label == "CogVideoX1.5":
                    entry = dict(e, name="B-pvbf16-online fused Q")
            del out, rec, args, akw
        del real, adv
        torch.cuda.empty_cache()
    entry["launches"] = fused
    return [entry]


def online_edges(torch):
    """The four keys on their Hopper kernels at head dims 64 and 128, each
    launch on every head against the plain version: Sq off the blocks,
    ``kv_len < Sk`` (causal too), one kv tile only, GQA 8:1, and B5-int8
    with folded and per-column K scales; each launch must reach its route's
    C entry and no other.  Returns the largest max_abs_err."""
    from sageattention_tpu_torch.ops import _build
    from sageattention_tpu_torch.ops.attention import (attention_kernel, attention_plain,
                                                       config_name)
    from sageattention_tpu_torch.utils.testing import calc_diff
    g = torch.Generator(device="cuda").manual_seed(SEED + 225)
    errs = []
    # (label, B, Hq, Hk, Sq, Sk, causal, kv_len)
    cases = [("Sq off the blocks (1,4/2,1000)", 1, 4, 2, 1000, 1000, False, 0),
             ("kv_len 900 of Sk 1000", 1, 4, 2, 1000, 1000, False, 900),
             ("causal, kv_len 900 of Sk 1000", 1, 4, 2, 1000, 1000, True, 900),
             ("one kv tile (Sq 300, Sk 50)", 1, 4, 2, 300, 50, False, 0),
             ("GQA 8:1, causal (1,8/1,700)", 1, 8, 1, 700, 700, True, 0)]
    forms = [("B2", {}), ("B5-fp8-fusedq", {}),
             ("B-pvbf16-online", dict(fuse_q_quant=True, fold_k_scale=True)),
             ("B5-int8", {}), ("B5-int8", dict(fold_k_scale=True))]
    real_call = _build.call
    for D in (64, 128):
        for label, B, Hq, Hk, Sq, Sk, causal, kv_len in cases:
            q, k, v = _edge_qkv(torch, g, B, Hq, Hk, Sq, Sk, D)
            for name, extra in forms:
                cfg = dataclasses.replace(attn_cfg(torch, name, D, causal), kv_len=kv_len,
                                          **extra)
                xs, kw = kernel_args(torch, cfg, q, k, v)
                if name == "B-pvbf16-online":
                    cfg = dataclasses.replace(cfg, fuse_v_mean=False)
                called = []
                _build.call = lambda fn, *a: called.append(fn) or real_call(fn, *a)
                try:
                    a = attention_kernel(*xs, cfg, **kw)
                finally:
                    _build.call = real_call
                b = attention_plain(*xs, cfg, **kw)
                src = fwd_source(cfg, xs[0])
                want = ["sage_attn_fwd_online_sm90" if src == SRC_ONLINE_SM90
                        else "sage_attn_fwd_q8_sm90"]
                d = calc_diff(a[0], b[0])
                e = float((a[0].float() - b[0].float()).abs().max())
                dl = float((a[1] - b[1]).abs().max())
                errs.append(e)
                kind = "folded" if cfg.fold_k_scale else "per-column"
                check(d < KERNEL_BAR and dl < LSE_BAR and called == want
                      and src in (SRC_ONLINE_SM90, SRC_Q8_SM90)
                      and (src == SRC_Q8_SM90) == (name == "B5-int8"),
                      f"{config_name(cfg, Sq)} ({kind} K) edge {label}, D={D} vs plain on every "
                      f"head: calc_diff {d:.3e} < {KERNEL_BAR}, max_abs {e:.3e}, lse {dl:.2e} < "
                      f"{LSE_BAR}, entries {called}, on {src}")
    return max(errs)


def run_online_sm90(torch, st, totals):
    """Phase 21 (slice 17): B2, B5-fp8-fusedq and the fused-Q
    B-pvbf16-online on ``csrc/attention_online_sm90.cu`` and B5-int8 on
    ``csrc/attention_q8_sm90.cu``'s mode 5 (phase 4 holds and times B2,
    B5-int8 and B5-fp8-fusedq at CogVideoX1.5): the main-path calls, then
    the edge cases.  Returns the fused-Q B-pvbf16-online's JSON entry."""
    entries = online_phase(torch, st, totals)
    err = online_edges(torch)
    print(f"     online Hopper forms' edge cases: max_abs_err {err:.3e}", flush=True)
    for e in entries:
        e["max_abs_err"] = max(e["max_abs_err"], err)
    return entries


# ------------------------------------------------ slice 19 (phase 23) ----

SRC_PREP_SM90 = "sageattention_tpu_torch/csrc/prep_sm90.cu"
# ~25 ms of spin on the card: longer than the host takes to queue 20 prep
# calls (~0.1 ms each), so the events that follow time the device alone
PREP_SPIN_CYCLES = 50_000_000
# the C entries an A1/A2 call on the route may and may not reach
PREP_ENTRIES = {"sage_prep_sm90": True, "sage_prep_kv": False}
# A1/A2 at the main paths' K/V (activation-like, from realistic_qkv): B, Hq,
# Hk, S, D, the attention call's causal flag
PREP_MAIN = {"CogVideoX1.5": COG_SHAPE + (False,),
             "Llama-70B GQA": (1, 64, 8, 16384, 128, True),
             "Gemma-7B": (1, 16, 16, 8192, 256, True)}
# the edges: [B, H, S, D] (stored as [B, S, H, D] when NHD), s_true, dtype,
# NHD storage, a constant slice
PREP_EDGES = {
    "largest slice, D = 64 (288 chunks)": ((1, 2, 73728, 64), 73728, "bf16", False, False),
    "largest slice, D = 128": ((1, 2, 36864, 128), 36800, "bf16", False, False),
    "largest slice, D = 256": ((1, 2, 18432, 256), 18432, "bf16", False, False),
    "largest f32 slice, D = 64": ((1, 2, 73728, 64), 73000, "f32", False, False),
    "f32, D = 128, a block for every chunk": ((1, 2, 33792, 128), 33792, "f32", False, False),
    "one chunk": ((1, 8, 256, 128), 256, "bf16", False, False),
    "one short chunk": ((2, 3, 200, 64), 200, "bf16", False, False),
    "s_true < S, 4 chunks of padding": ((1, 4, 4096, 64), 3000, "bf16", False, False),
    "s_true < S, f16 widened": ((2, 3, 777, 128), 700, "f16", False, False),
    "s_true < S, D = 256": ((1, 3, 1280, 256), 1100, "bf16", False, False),
    "NHD view": ((1, 8, 3000, 128), 2900, "bf16", True, False),
    "NHD view, f32": ((2, 4, 1000, 64), 1000, "f32", True, False),
    "constant slice": ((1, 2, 1024, 64), 1000, "bf16", False, True)}


def prep_device_ms(torch, fn, reps=20):
    """Device time per call of what ``fn`` launches, with the host's work
    left out: a spin kernel holds the card while the host queues ``reps``
    calls between two CUDA events (median of 3; ``torch.profiler`` drops
    kernels this late in the run)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(PREP_SPIN_CYCLES)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        runs.append(s.elapsed_time(e) / reps)
    return sorted(runs)[1]


def prep_outputs_ok(torch, what, got, plain, old):
    """A1/A2's outputs against the plain version (quant_entry's bars) and
    ``prep_kv.cu``'s first version (bit for bit: the same sums in the same
    order).  Returns the largest difference from the plain version."""
    same, worst = _codes_ok(torch, got[0], plain[0])
    stats = [(x, y) for x, y in zip(got[1:], plain[1:]) if x is not None]
    ok = (same >= 0.999 and worst <= 1
          and all(torch.allclose(x, y, rtol=1e-5, atol=1e-6) for x, y in stats))
    exact = len(got) == len(old) and all(torch.equal(x, y) for x, y in zip(got, old))
    check(ok and exact, f"{what}: {same:.9f} of codes equal to the plain version's, max code "
                        f"diff {worst}, stats within rtol 1e-5 / atol 1e-6; prep_kv.cu's "
                        f"outputs equal bit for bit: {exact}")
    return max([float(worst)] + [float((x - y).abs().max()) for x, y in stats])


def prep_pair(torch, what, x, s_true, totals):
    """A1 (with and without capmax) and A2 on ``x`` through the public
    entries, counted (``sage_prep_sm90`` called, ``sage_prep_kv`` never),
    against the plain versions and ``prep_kv.cu``.  Returns the largest
    difference from the plain version."""
    from sageattention_tpu_torch.ops import quant_fused as qf
    check(qf.prep_sm90_route(qf._kernel_input(x).dtype, x.shape[3], x.shape[2],
                             qf._sm_count(x.device)), f"{what}: on prep_sm90_route")
    (k1, k0, v1), _ = counted_path(
        torch, f"{what}: A1, A1 without capmax, A2", ("A1", "A2"), {}, totals,
        lambda: (qf.prep_k_onepass(x, s_true, True), qf.prep_k_onepass(x, s_true),
                 qf.prep_v_onepass(x, s_true)), entries=PREP_ENTRIES)
    exact_counts(what, read_counts(), dict(A1=2, A2=1))
    old_k = qf._launch(x, s_true, per_channel=False, capmax=True)
    old_v = qf._launch(x, s_true, per_channel=True, capmax=False)
    err = prep_outputs_ok(torch, f"{what} A1", k1, qf.prep_k_onepass_plain(x, s_true, True),
                          old_k)
    err = max(err, prep_outputs_ok(torch, f"{what} A1 without capmax", k0,
                                   qf.prep_k_onepass_plain(x, s_true), old_k[:3]))
    return max(err, prep_outputs_ok(torch, f"{what} A2", v1, qf.prep_v_onepass_plain(x, s_true),
                                    old_v[:3]))


def run_prep_sm90(torch, st, totals):
    """Phase 23 (slice 19): A1 and A2 on ``csrc/prep_sm90.cu``.  At the main
    paths' shapes (:data:`PREP_MAIN`), ``sageattn`` counted on its own (its
    A1 and A2 calls reach ``sage_prep_sm90`` and never ``sage_prep_kv``),
    then A1 (with and without capmax) and A2 on its K and V against the
    plain versions and ``prep_kv.cu``'s first version (:func:`prep_pair`),
    each kernel's device time per call (:func:`prep_device_ms`), its call's
    time, ``prep_kv.cu``'s on the same inputs, the plain version's and the
    bound; then :data:`PREP_EDGES` the same way.  Returns the JSON entries
    of A1 and A2 (at CogVideoX1.5; the other shapes in their ``shape``)."""
    from sageattention_tpu_torch.ops import quant_fused as qf
    rows, errs = {"A1": [], "A2": []}, []
    for i, (label, (B, Hq, Hk, S, D, causal)) in enumerate(PREP_MAIN.items()):
        q, k, v = realistic_qkv(torch, B, Hq, Hk, S, D, SEED + 150 + i)
        what = f"{label} ({B},{Hq}/{Hk},{S},{D})"
        out, _ = counted_path(torch, f"{what}: sageattn", ("A1", "A2"), {}, totals,
                              lambda: st.sageattn(q, k, v, is_causal=causal),
                              entries=PREP_ENTRIES)
        exact_counts(what, read_counts(), dict(A1=1, A2=1, A3=0, A4=0))
        check(bool(torch.isfinite(out).all()) and out.shape == q.shape,
              f"{what}: sageattn's output finite, of q's shape")
        del out
        errs.append(prep_pair(torch, f"{what} K", k, S, totals))
        errs.append(prep_pair(torch, f"{what} V", v, S, totals))
        for name, x, new, old, plain in (
                ("A1", k, lambda: qf.prep_k_onepass(k, S, True),
                 lambda: qf._launch(k, S, False, True),
                 lambda: qf.prep_k_onepass_plain(k, S, True)),
                ("A2", v, lambda: qf.prep_v_onepass(v, S),
                 lambda: qf._launch(v, S, True, False),
                 lambda: qf.prep_v_onepass_plain(v, S))):
            t = dict(ms=prep_device_ms(torch, new), old=prep_device_ms(torch, old),
                     call=kernel_ms(new), old_call=kernel_ms(old), plain=time_once(torch, plain))
            t["bound"] = bytes_bound(nbytes(x) + x.numel())
            rows[name].append((what, t))
            print(f"     {name} at {what}: prep_sm90.cu {t['ms']:.4f} ms on the device (the call "
                  f"{t['call']:.4f}), prep_kv.cu {t['old']:.4f} (the call {t['old_call']:.4f}), "
                  f"plain {t['plain']:.3f}, bound {t['bound'][0]:.4f} ({t['bound'][1]})",
                  flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(SEED + 160)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32, "f16": torch.float16}
    for label, ((B, H, S, D), s_true, dt, nhd, const) in PREP_EDGES.items():
        shape = (B, S, H, D) if nhd else (B, H, S, D)
        if const:
            x = torch.full(shape, 0.75, device="cuda")
        else:
            x = torch.randn(*shape, generator=g, device="cuda") * 2.0
            x[..., 7] += 4.0
        x = x.to(dtypes[dt])
        x = x.transpose(1, 2) if nhd else x
        errs.append(prep_pair(torch, f"{label} {tuple(x.shape)} s_true={s_true} {dt}"
                                     f"{' NHD' if nhd else ''}", x, s_true, totals))
        del x
    torch.cuda.empty_cache()
    entries = []
    for name, runs in rows.items():
        what, t = runs[0]
        more = "; ".join(f"{w}: {u['ms']:.4f} ms (call {u['call']:.4f}; prep_kv.cu {u['old']:.4f}, "
                         f"call {u['old_call']:.4f}; plain {u['plain']:.3f}; bound "
                         f"{u['bound'][0]:.4f})" for w, u in runs[1:])
        entries.append({"name": name, "route": "cuda", "source": SRC_PREP_SM90,
                        "replaces": TPU_KERNELS[name], "launches": 0,
                        "max_abs_err": max(errs), "ms": t["ms"], "plain_ms": t["plain"],
                        "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                        "library_ms": None,
                        "shape": f"{what}; device time per call; the call "
                                 f"{t['call']:.4f} ms; prep_kv.cu {t['old']:.4f} ms (the call "
                                 f"{t['old_call']:.4f}); {more}"})
    return entries


# ---------------------------------------------------------------- configs ----

# ------------------------------------------------ slice 15 (phase 19) ----

def colk_args(torch, q, k, v):
    """B1-colk inputs from bf16 q/k/v: A1/A2's V and kn_max, K quantized in
    64-row groups (per-column scales, their norms in kn_max), no head
    scale, as the varlen path hands them."""
    from sageattention_tpu_torch.ops import quant as tquant
    from sageattention_tpu_torch.ops import quant_kernels as qk
    S, G = k.shape[2], q.shape[1] // k.shape[1]
    km = qk.channel_stats(k, S)[0]
    k8, ksg, kcap = qk.quant_int8_groupwise(k, 64, sub=km, with_capmax=True, s_true=S)
    (_, _, v8), kw = fused_args(torch, q, k, v, True)
    kw.update(k_head_scale=None, kn_max=kcap.repeat_interleave(G, 1),
              k_scale=tquant.expand_scales_cols(ksg, 64, k8.shape[2])[..., :S])
    return (q, k8[:, :, :S], v8), kw


def _segment_ids(torch, B, S, lens, pads=(-1, -2)):
    """q and kv segment ids ``[B, S]`` (pads -1 and -2 past the lengths) and
    each kv token's position in its segment (``SEGPOS_PAD`` on pads)."""
    from sageattention_tpu_torch.ops.attention import SEGPOS_PAD
    ids = torch.cat([torch.full((n,), i, dtype=torch.int32) for i, n in enumerate(lens)])
    pos = torch.cat([torch.arange(n, dtype=torch.int32) for n in lens])
    pad = S - len(ids)
    cat = lambda x, v: torch.cat([x, torch.full((pad,), v, dtype=torch.int32)])  # noqa: E731
    return tuple(x.cuda()[None].expand(B, S).contiguous()
                 for x in (cat(ids, pads[0]), cat(ids, pads[1]), cat(pos, SEGPOS_PAD)))


def masked_sm90_edges(torch):
    """B4-window and B4-bool on ``flash_sm90.cu`` (head dims 64, 128, 256)
    and B1's window, bool and segment forms on ``attention_sm90.cu`` (64,
    128), each launched once on every head and held to its plain version
    on every head (lmin too for B1): a window smaller than a tile with its
    sinks far below the band, a window of 300 (the band starting mid-tile)
    with GQA 8/2, a left-padded causal batch whose first q block sees no
    key, block-sparse masks per head and one for all heads with dead, full
    and partly live tiles (a thin stripe and ragged block edges), Sq != Sk;
    segments crossing q tiles with lengths off 64, pads -1 / -2, per-column
    K scales, with and without a window and per-segment sinks.  Returns the
    largest max_abs_err."""
    from sageattention_tpu_torch.ops.attention import attention_kernel, attention_plain
    from sageattention_tpu_torch.utils.testing import calc_diff
    g = torch.Generator(device="cuda").manual_seed(SEED + 190)
    errs = []

    def hold(what, args, kw):
        a = attention_kernel(*args, **kw)
        b = attention_plain(*args, **kw)
        kept, note = static_kept_rows(torch, a, b, args[0].shape[2])
        nokey = b[1] <= -1e19   # the online softmax's rows with no live key
        live = ~nokey & kept
        d = calc_diff(a[0][live], b[0][live])
        e = float((a[0][live].float() - b[0][live].float()).abs().max())
        dl = float((a[1][live] - b[1][live]).abs().max())
        errs.append(e)
        check(d < KERNEL_BAR and dl < LSE_BAR and bool(torch.equal(a[0][nokey], b[0][nokey]))
              and bool(torch.equal(a[1] > -1e19, ~nokey))
              and fwd_source(args[3], args[0]) in (SRC_FLASH, SRC_ATTN_SM90),
              f"{what} vs plain on every head{note}: calc_diff {d:.3e} < {KERNEL_BAR}, max_abs "
              f"{e:.3e}, lse {dl:.2e} < {LSE_BAR}, rows with no live key equal")

    def block_sparse(B, Hm, Sq, Sk, live=0.3):
        nb = -(-max(Sq, Sk) // 128)
        blocks = torch.rand(B, Hm, nb, nb, generator=g, device="cuda") < live
        m = blocks.repeat_interleave(128, 2).repeat_interleave(128, 3)[:, :, :Sq, :Sk]
        m = m.contiguous()
        m[..., 40:45] = True                       # a thin live stripe
        m[..., :Sq // 3, Sk - 77:] = False         # a ragged dead corner
        return m

    # (label, B, Hq, Hk, S, Sk, causal, options, mask kind)
    cases = [("window 40, sinks 3 far below the band", 1, 4, 2, 1000, 1000, True,
              dict(window=40, sinks=3), None),
             ("window 300 (mid-tile band), GQA 8/2", 1, 8, 2, 1100, 1100, True,
              dict(window=300), None),
             ("left-padded causal batch, first q block dead", 2, 4, 2, 1000, 1000, True, {},
              "left pad"),
             ("block-sparse per head (Hm = H)", 1, 4, 2, 900, 900, False, {}, "sparse H"),
             ("block-sparse, one mask (Hm = 1), Sq 700 != Sk 1000", 1, 4, 2, 700, 1000, False, {},
              "sparse 1")]
    seg_cases = [("segments (300, 1, 250, 77) + pads, causal", (300, 1, 250, 77), True, {}),
                 ("segments (400, 130, 200), window 150, per-segment sinks 4", (400, 130, 200),
                  True, dict(window=150, sinks=4)),
                 ("segments (333, 333), not causal", (333, 333), False, {})]
    for D in (64, 128, 256):
        for label, B, Hq, Hk, S, Sk, causal, opts, mkind in cases:
            q = torch.randn(B, Hq, S, D, generator=g, device="cuda").bfloat16()
            k, v = (torch.randn(B, Hk, Sk, D, generator=g, device="cuda").bfloat16()
                    for _ in range(2))
            kw = {}
            if mkind == "left pad":
                pad = torch.tensor([300, 0], device="cuda")
                kw["attn_mask"] = (torch.arange(Sk, device="cuda")[None, None, None, :]
                                   >= pad[:, None, None, None]).expand(B, 1, S, Sk).contiguous()
            elif mkind:
                kw["attn_mask"] = block_sparse(B, Hq if mkind == "sparse H" else 1, S, Sk)
            mopt = dict(opts, masked="bool" if mkind else "none")
            cfg = dataclasses.replace(flash_cfg(torch, D, causal, **mopt), emit_lse=True)
            hold(f"B4 edge {label}, D={D}", (q, k, v, cfg), kw)
            if D == 256:
                continue
            b1 = dataclasses.replace(attn_cfg(torch, "B1", D, causal), **mopt)
            xs, fkw = fused_args(torch, q, k, v, True)
            hold(f"B1 edge {label}, D={D}", (*xs, b1), {**fkw, **kw})
        if D == 256:
            continue
        for label, lens, causal, opts in seg_cases:
            S = 760
            q, k, v = _edge_qkv(torch, g, 1, 4, 2, S, S, D)
            qs, ks, sp = _segment_ids(torch, 1, S, lens)
            seg = dict(q_segments=qs, kv_segments=ks, kv_segpos=sp if opts.get("sinks") else None)
            for colk in (True, False):
                cfg = dataclasses.replace(attn_cfg(torch, "B1", D, causal), segmented=True,
                                          fold_k_scale=not colk, **opts)
                xs, fkw = colk_args(torch, q, k, v) if colk else fused_args(torch, q, k, v, True)
                hold(f"B1{'-colk' if colk else ''} edge {label}, D={D}", (*xs, cfg),
                     {**fkw, **seg})
    return max(errs)


def run_masked_sm90(torch, st, totals):
    """Phase 19 (slice 15): the masked forms' edge cases on their Hopper
    kernels (phase 7 holds their launches on its paths' inputs to the plain
    versions, times them, and times the skip ratios against dense B1 on its
    Hopper kernel); the mask header's report lines come with
    ``flash_sm90.cu``'s and ``attention_sm90.cu``'s after the build."""
    err = masked_sm90_edges(torch)
    print(f"     masked Hopper forms' edge cases: max_abs_err {err:.3e}", flush=True)
    return []


def attn_cfg(torch, name, D, causal):
    """The AttnConfig of launch key ``name``, as the pipeline builds it."""
    from sageattention_tpu_torch.ops.attention import AttnConfig
    if name == "B4":
        return AttnConfig(causal=causal, quantized=False, sm_scale=D ** -0.5, emit_lse=True)
    static = name in ("B1", "B3", "B6-static", "B-pvbf16") or name == "B6-bf16c"
    pv = {"B5-fp8": "fp8", "B5-fp8-fusedq": "fp8", "B-pvbf16": "bf16",
          "B-pvbf16-online": "bf16"}.get(name, "int8")
    fused = name in ("B1", "B2", "B3", "B3-online", "B5-fp8-fusedq")
    return AttnConfig(
        causal=causal, quantized=True, pv_dtype=pv, out_dtype=torch.bfloat16,
        fold_k_scale=fused or name == "B6-bf16c",
        compute_dtype="bf16" if name.startswith("B3") or name == "B6-bf16c" else "native",
        softmax_mode="static" if static else "online", emit_lse=True,
        fuse_v_mean=pv != "bf16",
        pv_via_bf16=name in ("B2", "B3-online", "B6-online"),
        fuse_q_quant=fused, sm_scale=D ** -0.5)


def fused_args(torch, q, k, v, static):
    """Kernel inputs for B1-B3 from bf16 q/k/v, as _sage_attention builds them."""
    from sageattention_tpu_torch.ops import quant_fused as qf
    kp = qf.prep_k_onepass(k, k.shape[2], with_capmax=True)
    vp = qf.prep_v_onepass(v, v.shape[2])
    G = q.shape[1] // k.shape[1]
    ks = torch.where(kp[2] > 0, kp[2] * (1.0 / 127.0), torch.ones_like(kp[2]))
    vs = torch.where(vp[2] > 0, vp[2] * (1.0 / 127.0), torch.ones_like(vp[2]))
    return (q, kp[0], vp[0]), dict(
        k_head_scale=ks, kn_max=kp[3].repeat_interleave(G, 1) if static else None,
        v_scale=vs, v_mean=vp[1])


def kernel_args(torch, cfg, q, k, v, q_group=4):
    """Kernel inputs for any quantized configuration, built by the port's
    quantizers as ``_sage_attention`` builds them (A1/A2 for B1-B3); a
    pre-quantized Q in groups of ``q_group`` rows."""
    from sageattention_tpu_torch.core import fp8_v
    from sageattention_tpu_torch.ops import quant as tquant
    from sageattention_tpu_torch.ops import quant_kernels as qk
    from sageattention_tpu_torch.ops.attention import _per_q_head
    static = cfg.softmax_mode == "static"
    if cfg.fuse_q_quant and cfg.pv_dtype == "int8":
        return fused_args(torch, q, k, v, static)
    S, Hq = k.shape[2], q.shape[1]
    scale = lambda a, m: torch.where(a > 0, a * (1.0 / m), torch.ones_like(a))  # noqa: E731
    km, kamax = qk.channel_stats(k, S)
    kw = {}
    if cfg.fold_k_scale:
        ks = scale(kamax.amax(dim=3, keepdim=True), 127.0)
        k8, kcap = qk.quant_int8_fixed(k, ks, sub=km, with_capmax=True, s_true=S)
        if cfg.fuse_q_quant:
            kw["k_head_scale"] = ks
    else:
        k8, ksg, kcap = qk.quant_int8_groupwise(k, 16, sub=km, with_capmax=True, s_true=S)
        kw["k_scale"] = tquant.expand_scales_cols(ksg, 16, k8.shape[2])[..., :S]
        k8 = k8[:, :, :S]
    qin = q
    if not cfg.fuse_q_quant:
        q8, qsg = qk.quant_int8_groupwise(q, q_group, fold=cfg.sm_scale * tquant.LOG2E)
        qs = tquant.expand_scales_rows(qsg, q_group, q8.shape[2])[:, :, :q.shape[2]]
        if cfg.fold_k_scale:
            qs = qs * _per_q_head(ks, Hq)
        qin, kw["q_scale"] = q8[:, :, :q.shape[2]], qs
    if static:
        kw["kn_max"] = kcap.repeat_interleave(Hq // k.shape[1], dim=1)
    if cfg.pv_dtype == "bf16":
        return (qin, k8, v), kw
    vm, vamax = qk.channel_stats(v, S)
    if cfg.pv_dtype == "int8":
        vs = scale(vamax, 127.0)
        return (qin, k8, qk.quant_int8_fixed(v, vs, sub=vm)), {**kw, "v_scale": vs, "v_mean": vm}
    vs = scale(vamax, 448.0)
    v8, vm = fp8_v(v, vm, vs)
    return (qin, k8, v8), {**kw, "v_scale": vs, "v_mean": vm}


# ----------------------------------------------------------------- bounds ----

def nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs if x is not None)


def bytes_bound(n):
    return n / HBM_BYTES_S * 1e3, "bytes"


def attn_bound(cfg, q, k, moved_bytes):
    """Least time for the attention of ``cfg``: the larger of its tensor-core
    products (QK^T and PV, each at its operands' peak), its exp2s on the
    SFUs, and its bytes.  Causal counts the visible half."""
    B, Hq, S, D = q.shape
    pairs = B * Hq * (S * (S + 1) / 2 if cfg.causal else S * k.shape[2])
    return attn_bound_pairs(cfg, pairs, D, moved_bytes)


def attn_bound_pairs(cfg, pairs, D, moved_bytes):
    """:func:`attn_bound` for ``pairs`` visible (query, key) pairs over all
    heads: masks, windows and segments count what the data keeps."""
    qk = "bf16" if (not cfg.quantized or cfg.compute_dtype == "bf16") else "int8"
    pv = "bf16" if (not cfg.quantized or cfg.p_bf16) else cfg.pv_dtype
    tc = 2 * pairs * D / TC_OPS_S[qk] + 2 * pairs * D / TC_OPS_S[pv]
    ops = max(tc, pairs / EX2_S)
    by = moved_bytes / HBM_BYTES_S
    return max(ops, by) * 1e3, "operations" if ops >= by else "bytes"


def timed_call(torch, fn):
    """``(fn(), ms)`` of one call: the plain versions take up to seconds at
    full width, so their comparison call is also their timed one."""
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def time_once(torch, fn):
    """ms of one call, after a first call that warmed it."""
    return timed_call(torch, fn)[1]


# ---------------------------------------------------------------- checks ----

def _codes_ok(torch, a, b):
    dc = (a.int() - b.int()).abs()
    return float((dc == 0).double().mean()), int(dc.max())


def edge_checks(torch):
    """Shapes, types and layouts the full-width phases do not reach."""
    from sageattention_tpu_torch.ops import quant_fused as qf
    from sageattention_tpu_torch.ops import quant_kernels as qk
    from sageattention_tpu_torch.ops.attention import attention_kernel, attention_plain
    from sageattention_tpu_torch.utils.testing import calc_diff

    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    nhd_view = lambda x: x.transpose(1, 2).contiguous().transpose(1, 2)  # noqa: E731
    pad = lambda x, n: torch.nn.functional.pad(x.float(), (0, 0, 0, n - x.shape[2]))  # noqa: E731
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        for shape, s_true, nhd in (((1, 2, 333, 64), 333, False),
                                   ((2, 3, 777, 128), 700, True),
                                   ((1, 1, 600, 256), 513, False)):
            x = (rn(*shape) * 2.0).to(dtype)
            x[..., 7] += 4.0
            if nhd:
                x = nhd_view(x)
            tag = f"{shape} s_true={s_true} {dtype} nhd={nhd}"
            for name, a, b in (("A1", qf.prep_k_onepass(x, s_true, True),
                                qf.prep_k_onepass_plain(x, s_true, True)),
                               ("A2", qf.prep_v_onepass(x, s_true),
                                qf.prep_v_onepass_plain(x, s_true))):
                same, worst = _codes_ok(torch, a[0], b[0])
                ok = (same >= 0.999 and worst <= 1
                      and all(torch.allclose(u, w, rtol=1e-5, atol=1e-6)
                              for u, w in zip(a[1:], b[1:])))
                check(ok, f"{name} edge {tag}")
            y = (rn(*shape) * 1.5).to(dtype)
            y = nhd_view(y) if nhd else y
            a = qf.channel_stats2(x, y, s_true)
            ok = all(torch.allclose(u, w, rtol=STATS_TOL, atol=STATS_TOL)
                     for u, w in zip(a, qf.channel_stats2_plain(x, y, s_true)))
            check(ok, f"A3 edge {tag}")
            ka = a[1].amax(dim=3, keepdim=True)
            args = (x, torch.where(ka > 0, ka / 127.0, 1.0), a[0], y,
                    torch.where(a[3] > 0, a[3] / 127.0, 1.0), a[2])
            a, b = (qf.quant_kv(*args, with_capmax=True, s_true=s_true),
                    qf.quant_kv_plain(*args, with_capmax=True, s_true=s_true))
            check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                  and torch.allclose(a[2], b[2], rtol=STATS_TOL, atol=0), f"A4 edge {tag}")
            km, kamax = qk.channel_stats(x, s_true)
            ok = all(torch.allclose(u, w, rtol=1e-5, atol=1e-6)
                     for u, w in zip((km, kamax), qk.channel_stats_plain(x, s_true)))
            check(ok, f"A5 edge {tag}")
            for group, fold, sub in ((4, 0.18, None), (16, 1.0, km), (128, 1.0, km)):
                a = qk.quant_int8_groupwise(x, group, fold=fold, sub=sub, with_capmax=True,
                                            s_true=s_true)
                S_out = -(-shape[2] // group) * group
                b = qk.quant_int8_plain(pad(x, S_out), "group", group, fold, sub,
                                        with_capmax=True, s_true=s_true)
                same, worst = _codes_ok(torch, a[0], b[0])
                check(same >= 0.999 and worst <= 1 and torch.allclose(a[1], b[1], rtol=1e-5)
                      and torch.allclose(a[2], b[2], rtol=1e-5),
                      f"A6-group edge group={group} {tag}")
            hs = torch.where(kamax > 0, kamax / 127.0, 1.0).amax(dim=3, keepdim=True)
            a = qk.quant_int8_fixed(x, hs, sub=km, with_capmax=True, s_true=s_true)
            b = qk.quant_int8_plain(x, "scalar", sub=km, scale=hs, with_capmax=True,
                                    s_true=s_true)
            same, worst = _codes_ok(torch, a[0], b[0])
            check(same >= 0.999 and worst <= 1 and torch.allclose(a[1], b[2], rtol=1e-5),
                  f"A6-scalar edge {tag}")
            cs = torch.where(kamax > 0, kamax / 127.0, 1.0)
            same, worst = _codes_ok(torch, qk.quant_int8_fixed(x, cs, sub=km),
                                    qk.quant_int8_plain(x, "channel", sub=km, scale=cs)[0])
            check(same >= 0.999 and worst <= 1, f"A6-channel edge {tag}")
    # the two-pass route end to end on NHD views at a GQA shape: with the
    # one-pass limit at 0 the call equals the one-pass call bit for bit (A3
    # and A1 finish the same partials in the same order; A4 and A1 round
    # the same products)
    import sageattention_tpu_torch as st
    q, k, v = rn(1, 1000, 4, 128), rn(1, 1000, 2, 128) + 1.0, rn(1, 1000, 2, 128)
    for causal in (False, True):
        one = st.sageattn(q, k, v, tensor_layout="NHD", is_causal=causal)
        real, qf.ONEPASS_MAX_ELS = qf.ONEPASS_MAX_ELS, 0
        try:
            before = read_counts()
            two = st.sageattn(q, k, v, tensor_layout="NHD", is_causal=causal)
            after = read_counts()
        finally:
            qf.ONEPASS_MAX_ELS = real
        ran = {n: after[n] - before[n] for n in ("A1", "A2", "A3", "A4")}
        check(torch.equal(one, two) and ran == dict(A1=0, A2=0, A3=1, A4=1),
              f"two-pass route (1, 1000, 4/2, 128) NHD causal={causal}: equals the one-pass "
              f"call, launches {ran}")
    for Hq, Hk, S, D, causal, dtype, nhd in ((4, 2, 333, 64, False, torch.bfloat16, False),
                                             (2, 2, 300, 128, True, torch.float32, False),
                                             (4, 1, 1000, 128, False, torch.float16, True)):
        q, k, v = rn(1, Hq, S, D), rn(1, Hk, S, D), rn(1, Hk, S, D)
        k[..., 3] += 2.0
        view = nhd_view if nhd else (lambda x: x)
        for name in KEYS[6:]:
            cfg = attn_cfg(torch, name, D, causal)
            if name == "B4":
                xs, kw = tuple(view(x.to(torch.bfloat16)) for x in (q, k, v)), {}
            else:
                xs, kw = kernel_args(torch, cfg, view(q.to(dtype)), view(k), view(v))
                xs = tuple(view(x.contiguous()) for x in xs)
                cfg = dataclasses.replace(cfg, out_dtype=dtype)
            a = attention_kernel(*xs, cfg, **kw)
            b, plain_ms = timed_call(torch, lambda: attention_plain(*xs, cfg, **kw))
            d = calc_diff(a[0], b[0])
            ok = (a[0].dtype == b[0].dtype and d < KERNEL_BAR
                  and float((a[1] - b[1]).abs().max()) < LSE_BAR)
            if a[2] is not None:
                ok = ok and bool(torch.allclose(a[2], b[2], rtol=1e-4, atol=0))
            check(ok, f"{name} edge Hq={Hq} Hk={Hk} S={S} D={D} causal={causal} "
                      f"{xs[0].dtype} nhd={nhd}: calc_diff {d:.2e}")


# attention_kernel's keyword inputs after (q, k, v, cfg), in its order
ATTN_KW = ("k_head_scale", "kn_max", "v_scale", "v_mean", "q_scale", "k_scale")


def kernel_checks(torch, inputs, short, adv_native, launches):
    from sageattention_tpu_torch.ops import quant_fused as qf
    from sageattention_tpu_torch.ops import quant_kernels as qk
    from sageattention_tpu_torch.ops.attention import attention_kernel, attention_plain
    from sageattention_tpu_torch.utils.testing import calc_diff

    entries = []

    def entry(name, source, replaces, err, ms, plain_ms, bound, library_ms, shape):
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound[0], "bound_by": bound[1],
                        "library_ms": library_ms, "shape": shape})
        lib = "" if library_ms is None else f", library {library_ms:.3f} ms"
        print(f"     {name}: max_abs_err {err:.3e}, kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound[0]:.3f} ms ({bound[1]}){lib} at {shape}",
              flush=True)

    def quant_entry(name, src, fk, fp, moved, shape, stats_only=False):
        """Codes identical in >= 99.9% of places and never more than 1 apart
        (the f32 mean is summed in another order); stats, scales and capmax
        to rtol 1e-5."""
        a, b = fk(), fp()
        torch.cuda.synchronize()
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        if stats_only:
            same, worst, stats = 1.0, 0, list(zip(a, b))
        else:
            same, worst = _codes_ok(torch, a[0], b[0])
            stats = [(x, y) for x, y in zip(a[1:], b[1:]) if x is not None and y is not None]
        stats_ok = all(torch.allclose(x, y, rtol=1e-5, atol=1e-6) for x, y in stats)
        err = max([float(worst)] + [float((x - y).abs().max()) for x, y in stats])
        check(same >= 0.999 and worst <= 1 and stats_ok,
              f"{name} vs plain: {same:.9f} of codes equal, max code diff {worst}, "
              f"stats within rtol 1e-5 / atol 1e-6")
        entry(name, src, TPU_KERNELS[name[:2]], err, kernel_ms(fk), time_once(torch, fp),
              bytes_bound(moved), None, shape)

    q, k, v = inputs[COG]
    S = k.shape[2]
    shape = str(tuple(k.shape))
    kb = nbytes(k)
    quant_entry("A1", SRC_PREP, lambda: qf.prep_k_onepass(k, S, True),
                lambda: qf.prep_k_onepass_plain(k, S, True), kb * 3 // 2, shape)
    quant_entry("A2", SRC_PREP, lambda: qf.prep_v_onepass(v, S),
                lambda: qf.prep_v_onepass_plain(v, S), kb * 3 // 2, shape)
    quant_entry("A5", SRC_QUANT, lambda: qk.channel_stats(k, S),
                lambda: qk.channel_stats_plain(k, S), kb, shape, stats_only=True)
    km, kamax = qk.channel_stats(k, S)
    vm, vamax = qk.channel_stats(v, S)
    S16 = -(-S // 16) * 16
    kpad = torch.nn.functional.pad(k.float(), (0, 0, 0, S16 - S))
    quant_entry("A6-group", SRC_QUANT,
                lambda: qk.quant_int8_groupwise(k, 16, sub=km, with_capmax=True, s_true=S),
                lambda: qk.quant_int8_plain(kpad, "group", 16, 1.0, km, with_capmax=True,
                                            s_true=S), kb * 3 // 2, shape + " K, group 16")
    S4 = -(-S // 4) * 4
    qpad = torch.nn.functional.pad(q.float(), (0, 0, 0, S4 - S))
    fold = q.shape[-1] ** -0.5 * 1.4426950408889634
    a, b = (qk.quant_int8_groupwise(q, 4, fold=fold, with_capmax=True),
            qk.quant_int8_plain(qpad, "group", 4, fold, with_capmax=True))
    torch.cuda.synchronize()
    same, worst = _codes_ok(torch, a[0], b[0])
    check(same >= 0.999 and worst <= 1 and torch.allclose(a[1], b[1], rtol=1e-5)
          and torch.allclose(a[2], b[2], rtol=1e-5),
          f"A6-group (Q, group 4, fold) vs plain: {same:.9f} of codes equal, max diff {worst}")
    hs = torch.where(kamax > 0, kamax / 127.0, 1.0).amax(dim=3, keepdim=True)
    quant_entry("A6-scalar", SRC_QUANT,
                lambda: qk.quant_int8_fixed(k, hs, sub=km, with_capmax=True, s_true=S),
                lambda: tuple(x for x in qk.quant_int8_plain(k, "scalar", sub=km, scale=hs,
                                                             with_capmax=True, s_true=S)
                              if x is not None), kb * 3 // 2, shape + " K")
    vs = torch.where(vamax > 0, vamax / 127.0, 1.0)
    quant_entry("A6-channel", SRC_QUANT, lambda: qk.quant_int8_fixed(v, vs, sub=vm),
                lambda: qk.quant_int8_plain(v, "channel", sub=vm, scale=vs)[0],
                kb * 3 // 2, shape + " V")

    llama = inputs[LLAMA]
    plan = [("B1", [(q, k, v, False), (*llama, True)]),
            ("B2", [(q, k, v, False), (*adv_native, False)]),
            ("B3", [(*short, False)]),
            ("B3-online", [(*short, False)]),
            ("B5-int8", [(q, k, v, False)]),
            ("B5-fp8", [(q, k, v, False), (*llama, True)]),
            ("B5-fp8-fusedq", [(q, k, v, False)]),
            ("B6-static", [(q, k, v, False), (*llama, True)]),
            ("B6-online", [(q, k, v, False)]),
            ("B6-bf16c", [(*short, False)]),
            ("B-pvbf16", [(q, k, v, False)]),
            ("B-pvbf16-online", [(q, k, v, False)])]
    for name, shapes in plan:
        errs, timed = [], None
        for qq, kk, vv, causal in shapes:
            cfg = attn_cfg(torch, name, qq.shape[-1], causal)
            xs, kw = kernel_args(torch, cfg, qq, kk, vv)
            # one launch on all heads; the plain version's host-bound tile
            # loop runs on the sampled heads, held to those heads' outputs
            full = (*xs, cfg) + tuple(kw.get(n) for n in ATTN_KW)
            out = attention_kernel(*full)
            if name in ("B2", "B5-int8", "B5-fp8-fusedq"):   # slice 17's Hopper kernels
                check(fwd_source(cfg, xs[0]) in (SRC_ONLINE_SM90, SRC_Q8_SM90),
                      f"{name} at {tuple(qq.shape)} ran on {fwd_source(cfg, xs[0])}")
            plain_ms, heads = None, []
            for sub, _, hs in sampled_heads(full, {}):
                a = heads_of(out, hs)
                b, ms = timed_call(torch, lambda: attention_plain(*sub))
                plain_ms = ms if plain_ms is None else plain_ms
                d = calc_diff(a[0], b[0])
                err = float((a[0].float() - b[0].float()).abs().max())
                dl = float((a[1] - b[1]).abs().max())
                ok = d < KERNEL_BAR and dl < LSE_BAR
                if a[2] is not None:
                    ok = ok and bool(torch.allclose(a[2], b[2], rtol=1e-4, atol=0))
                heads.append(f"{hs.start}-{hs.stop - 1}")
                check(ok, f"{name} vs plain on q heads {heads[-1]} of {tuple(qq.shape)} "
                          f"Hk={kk.shape[1]} causal={causal}: calc_diff {d:.3e} < {KERNEL_BAR}, "
                          f"max_abs {err:.3e}, lse {dl:.2e}")
                errs.append(err)
            if timed is None:
                ms = kernel_ms(lambda: attention_kernel(*full))
                moved = nbytes(*xs, *kw.values(), *out)
                source = fwd_source(cfg, xs[0])
                timed = (ms, plain_ms, attn_bound(cfg, qq, kk, moved), None,
                         f"{tuple(qq.shape)} Hk={kk.shape[1]} causal={causal}; plain on "
                         f"q heads {', '.join(heads)}")
            del out
        entry(name, source, TPU_KERNELS["B"], max(errs), *timed)
    return entries


def library_ms(torch, q, k, v, causal, reps=20):
    """``F.scaled_dot_product_attention`` on its flash backend, bf16: the one
    PyTorch call that computes what B4 computes (timed here, never called
    by the port), over ``reps`` calls."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from sageattention_tpu_torch.utils.testing import time_fn
    if k.shape[1] != q.shape[1]:
        G = q.shape[1] // k.shape[1]
        k, v = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return time_fn(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal), warmup=min(3, reps), reps=reps) * 1e3


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke failed: {e}", file=sys.stderr)
        sys.exit(1)
