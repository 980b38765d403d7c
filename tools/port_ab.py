#!/usr/bin/env python3
"""Times the port's plain attention configurations and its ``sageattn``
entry in several checkouts, each in a process of its own, on one CUDA card.

    python3 tools/port_ab.py [--rows bwd|prep] build/parent . . build/parent

``--rows bwd`` times the C1/C2 rows alone (``bwd_rows`` and
``q8_bwd_rows`` below, ~1 minute a tree); ``--rows prep`` the K/V prep
rows alone (``prep_rows`` below).  Give the trees in the order
parent, change, change, parent within one run (a card's clocks and power
drift between runs).  Each tree builds its own
kernels into its own ``build/torch_kernels/``.  For each tree, at the
CogVideoX1.5 (1, 48, 17776, 64), Llama-70B GQA causal (1, 64/8, 16384,
128) and Gemma-7B causal (1, 16, 8192, 256) shapes, it prints one line
``AB <tree> <json>`` with:

- the kernel time (ms) of B2, B5-fp8-fusedq, B4 and B1 on the
  inputs the port's quantizers give them, B4's windowed form (``B4-window``
  with a 4,096-token window on the causal shapes), and B4's library call
  (``F.scaled_dot_product_attention`` on its flash backend, ``B4
  library``) beside them;
- ``sageattn``'s time per call, back to back as a caller makes them;
- where one ``sageattn`` call spends its time: the device time of each
  kernel it launches (CUDA events around each launch), of the widening of
  B1's V codes to bf16 (``widen_v_codes``, in trees that have it), the
  rest of the call (PyTorch glue kernels, the host read of the static check
  and the host's dispatch while the card waits), and the host time from the
  call's start to its first kernel launch;

then, at MPT-7B's ALiBi shape (2, 32, 2048, 128, causal, a 1 GiB f32
bias), the kernel time of ``B4-float`` and its library call (``mpt
B4-float library``: ``F.scaled_dot_product_attention`` with the bias and
the causal mask as one float ``attn_mask``);

the time (ms) of C1 and C2, each alone through the wrapper, in their
masked forms (``-window`` with a 4,096-token window and ``-causal-bool``
with a left-padding mask at Llama-3-8B width, (1, 32/8, 8192, 128); the
kernel table's Mistral-7B window with 4 sinks, (1, 32/8, 16,384, 128), and
left-padded batch, (4, 32/8, 4096, 128)) and then unmasked (``-bf16`` at
CogVideoX1.5, ``-bf16-causal`` at Llama-3-8B width), from the port's
forward on the same inputs, with the library's backward (one
``torch.autograd.grad`` through ``F.scaled_dot_product_attention``,
``C1+C2 library``, with the masked shapes' band or mask) at each shape;

for the training steps of ``chip_smoke.py``'s phase 9 with the port's
exact attention (``flash_dot_product_attention``: the B4 forward and the
bf16 C1/C2 backward), the ms per Adam step at Llama-3-8B width (2 blocks,
8,192 tokens, causal) and at CogVideoX1.5 width (the 2-block DiT's
diffusion step), each the median of 6 steps after 2 warm ones;

and last, the kernels this version of the tool was written for: B6-static
and B6-online (a pre-quantized Q, per-column K scales) at the three shapes;
the ring's four B10-B6 forms, ``-static-offsets`` and ``-online-offsets`` on
a visible Llama-3.1-8B chunk pair (32/8 heads, 16,384 x 16,384, hd 128) and
``-static-kvtrue`` and ``-online-kvtrue`` on a CogVideoX1.5 chunk pair (48
heads, 5,120 x 5,120, hd 64); and the ring over 4 virtual ranks
(``chip_smoke.virtual_ring``) at CogVideoX1.5 and at Llama-3.1-8B 65,536
causal: ms per call, and where one call spends it (``ring parts``: the
device time of its attention launches, of which the widening of the V codes
to bf16, and the rest: prep, the safety read, the merges);

and last, the kernels this version of the tool was written for: the int8
C1 and C2 (the S-recompute, each alone, bf16 outputs) at CogVideoX1.5
(``-int8``) and Llama-3-8B width (``-int8-causal``), and in the ring's
per-pair form (a given di, f32 outputs) on a CogVideoX1.5 chunk pair and a
diagonal Llama-3.1-8B pair, each with where one launch spends its time
(``parts``: the kernel, the dequantized bf16 copy of the codes it reads in
trees that make one, and the rest); then the 2-block CogVideoX1.5-width
DiT's Adam step through ``sage_dot_product_attention``, whose non-causal
gradient takes the int8 backward (``cog DiT train step sage``);

and last, the kernels this version of the tool was written for: B4-fp4 (the
e2m1-P flash, 64-column tiles) at CogVideoX1.5, Gemma-7B causal and
HunyuanVideo (1, 24, 119,056, 128; 3 launches after a warm one) and the
``sageattn3_blackwell`` call at CogVideoX1.5; B5-fp8 (pre-quantized Q,
per-column K scales, e4m3 P and V) at CogVideoX1.5 and Llama-70B GQA
causal, with where one launch spends its time (``parts``: the kernel, the
e4m3 V^T copy ``transpose_v_codes`` writes in trees that have it, and the
rest); ``B10-B5-fp8-kvtrue`` on the CogVideoX1.5 chunk pair; and
``sageattn_qk_int8_pv_fp8``'s call beside ``sageattn``'s (int8 PV) at
CogVideoX1.5 and Llama-70B GQA (``sageattn pv fp8``);

and last, the kernels this version of the tool was written for: D1-int8
at phase 8b's shape (8 slots of 4,097 ... 257 tokens, Llama-3-8B attention
width, pages of 256, one T = 1 step) and its T = 4 window over phase 8e's
ragged pools (8 slots up to 32,768 tokens, ``D1-int8-causal``), each as
device and wrapper time; B-pvbf16 (a pre-quantized Q, per-column K
scales, V in bf16) at CogVideoX1.5 and Llama-70B GQA causal, its online
form at CogVideoX1.5, its fused-Q form (``sageattn(pv_dtype="bf16")``'s
launch) at both shapes; ``B10-B-pvbf16-offsets`` on a visible
Llama-3-8B-width chunk pair (32/8 heads, 8,192 x 8,192, hd 128) and
``-kvtrue`` on the CogVideoX1.5 chunk pair; and ``sageattn_qk_int8_pv_bf16``'s
call at both shapes with where it spends its time (``parts``);

and last, the kernels this version of the tool was written for: the masked,
windowed and segmented forms of B4 and B1 on the inputs the public entries
hand them at ``chip_smoke.py`` phase 7's shapes (``masked_rows``): the
Mistral-7B window (1, 32/8, 16,384, 128, W = 4,096) for ``B4-window`` and
``B1-window`` beside causal ``B4`` and ``B1``, the left-padded Llama-3-8B
batch (4, 32/8, 4,096, 128) for ``B4-bool`` and ``B1-bool``, the ~25%-live
block-sparse mask at CogVideoX1.5 for ``B1-bool`` and ``B4-bool`` beside
dense ``B1``, and the packed varlen prompts (16,384 tokens at Llama-3-8B
width) for ``B1-colk-seg`` and, with a 4,096 window and 4 sinks,
``B1-colk-seg-window``;

and last, the kernels this version of the tool was written for: B11 on an
int8 V cache (``decode_rows``: device time from ``torch.profiler``, split
and merge launches, and the wrapper's host time), on the launches
``sageattn_decode`` makes: ``B11-int8`` at ``chip_smoke.py`` phase 8a's
step (one sequence of 8,192 tokens at Llama-3-8B width, its 4 GQA rows
folded), ``B11-int8-causal-mod T=4`` (its T = 4 verify window) and, over
8 sequences of 32,768 tokens at the same width, ``B11-int8-causal-mod T=9``
(the folded T = 9 window, 36 rows a KV head) and ``B11-int8-causal T=25``
(the unfolded T = 25 window);

and last, the kernels this version of the tool was written for
(``online_rows``): at CogVideoX1.5 and Llama-70B GQA causal, the
pre-quantized forms that share ``attention_q8_sm90.cu`` (B6-static,
B6-online, B5-fp8, B-pvbf16, B-pvbf16-online) and the online forms moved to
Hopper: B5-int8 (a pre-quantized Q, per-column K scales, int8 P and V), B2,
B5-fp8-fusedq and the fused-Q B-pvbf16-online (``B-pvbf16-online fused
Q``), each launch on the inputs the port's quantizers give it, the
``sageattn(pv_dtype="fp8")`` call (``sageattn fp8``), and the ring's
``-kvtrue`` forms of the pre-quantized ones on the CogVideoX1.5 chunk pair
(``B10-... pair``), each key starting with ``online``.  Each tree also
reports ``ptxas``'s registers and spills for ``flash_sm90.cu``,
``attention_sm90.cu``, ``attention_q8_sm90.cu`` and, where it has them,
``attention_online_sm90.cu``, ``paged_decode_sm90.cu`` and
``decode_sm90.cu`` (``ptxas``).

The tree's ``chip_smoke.py`` provides the inputs, configurations and models.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

CASES = {"cog": (1, 48, 48, 17776, 64, False), "llama": (1, 64, 8, 16384, 128, True),
         "gemma": (1, 16, 16, 8192, 256, True)}
# the changed kernel runs after the configurations that must stay put: what
# runs before a kernel can move its reading (the parent's B5-fp8-fusedq at
# Gemma-7B read faster after the old B4 than before it, with the same code)
KERNELS = ("B2", "B5-fp8-fusedq", "B4", "B1")
Q8_KERNELS = ("B6-static", "B6-online")
# the ring's B10-B6 forms: (B, Hq, Hk, S, D), softmax, device scalar
B10_PAIRS = {"B10-B6-static-offsets": ((1, 32, 8, 16384, 128), "static", "offsets"),
             "B10-B6-online-offsets": ((1, 32, 8, 16384, 128), "online", "offsets"),
             "B10-B6-static-kvtrue": ((1, 48, 48, 5120, 64), "static", "kvtrue"),
             "B10-B6-online-kvtrue": ((1, 48, 48, 5120, 64), "online", "kvtrue")}
B4_FORMS = {"B4-window": dict(window=4096)}
# B4-fp4's shapes (timed last): B, Hq, Hk, S, D, causal
FP4_SHAPES = {"cog": CASES["cog"], "gemma": CASES["gemma"],
              "hunyuan": (1, 24, 24, 119056, 128, False)}
# C1/C2: B, Hq, Hk, S, D, causal, timed shape by shape in this order; the
# forms of each shape: the masked ones at Llama-3-8B width, and at the
# kernel table's shapes (Mistral-7B's W = 4096 window with 4 sinks and the
# smoke's left-padded Llama-3-8B batch, prompts of
# chip_smoke.TRAIN["padded_lens"])
BWD_SHAPES = {"cog": (1, 48, 48, 17776, 64, False), "llama8k": (1, 32, 8, 8192, 128, True),
              "mistral": (1, 32, 8, 16384, 128, True), "padded": (4, 32, 8, 4096, 128, True)}
BWD_FORMS = (("llama8k", "bf16-window", dict(window=4096)),
             ("llama8k", "bf16-causal-bool", dict(mask=True)),
             ("mistral", "bf16-window", dict(window=4096, sinks=4)),
             ("padded", "bf16-causal-bool", dict(mask=True)),
             ("cog", "bf16", {}),
             ("llama8k", "bf16-causal", {}))
# the int8 C1/C2 (timed last): B, Hq, Hk, S, D, causal, the ring's per-pair
# form (a given di, f32 outputs)
Q8_BWD = {"cog": (1, 48, 48, 17776, 64, False, False),
          "llama8k": (1, 32, 8, 8192, 128, True, False),
          "ring cog pair": (1, 48, 48, 5120, 64, False, True),
          "ring llama diagonal pair": (1, 32, 8, 16384, 128, True, True)}


def one_tree(tree: str) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    import sageattention_tpu_torch as st
    from sageattention_tpu_torch.ops import _build
    from sageattention_tpu_torch.ops.attention import AttnConfig, attention_kernel
    from sageattention_tpu_torch.utils.testing import time_fn
    if not _build.__file__.startswith(tree):
        raise RuntimeError(f"imported {_build.__file__}, not the tree {tree}")
    _build.build_all()
    res = {}
    with torch.inference_mode():
        for shape, (B, Hq, Hk, S, D, causal) in CASES.items():
            q, k, v = cs.realistic_qkv(torch, B, Hq, Hk, S, D, 0)
            for name in KERNELS:
                cfg = cs.attn_cfg(torch, name, D, causal)
                xs, kw = ((q, k, v), {}) if name == "B4" else cs.kernel_args(torch, cfg, q, k, v)
                res[f"{shape} {name}"] = time_fn(lambda: attention_kernel(*xs, cfg, **kw),
                                                 warmup=3, reps=20) * 1e3
            for name, opt in B4_FORMS.items():
                if opt.get("window") and not causal:
                    continue
                cfg = AttnConfig(causal=causal, quantized=False, sm_scale=D ** -0.5,
                                 emit_lse=True, **opt)
                res[f"{shape} {name}"] = time_fn(lambda: attention_kernel(q, k, v, cfg),
                                                 warmup=3, reps=20) * 1e3
            res[f"{shape} B4 library"] = cs.library_ms(torch, q, k, v, causal)
            call = lambda: st.sageattn(q, k, v, is_causal=causal)  # noqa: E731
            res[f"{shape} sageattn"] = time_fn(call, warmup=2, reps=10) * 1e3
            res[f"{shape} sageattn parts"] = call_parts(torch, _build, call)
            del q, k, v
        torch.cuda.empty_cache()
        res.update(biased_rows(torch, cs))
    torch.cuda.empty_cache()
    with torch.no_grad():
        res.update(bwd_rows(torch, cs, st))
    torch.cuda.empty_cache()
    res.update(train_steps(torch, cs))
    torch.cuda.empty_cache()
    with torch.inference_mode():
        res.update(q8_rows(torch, cs))
        res.update(ring_rows(torch, cs))
    torch.cuda.empty_cache()
    with torch.no_grad():
        res.update(q8_bwd_rows(torch, cs, st, _build))
    torch.cuda.empty_cache()
    res.update(sage_dit_step(torch, cs))
    torch.cuda.empty_cache()
    with torch.inference_mode():
        res.update(lowbit_fp8_rows(torch, cs, st, _build))
    torch.cuda.empty_cache()
    with torch.inference_mode():
        res.update(pvbf16_d1_rows(torch, cs, st, _build))
    torch.cuda.empty_cache()
    with torch.inference_mode():
        res.update(masked_rows(torch, cs, st))
    torch.cuda.empty_cache()
    with torch.inference_mode():
        res.update(b11_rows(torch, cs, st))
    torch.cuda.empty_cache()
    with torch.inference_mode():
        res.update(online_rows(torch, cs, st))
    res["ptxas"] = {src: [ln.strip() for ln in _build.build_log.get(src, "").splitlines()
                          if "Used" in ln or "spill" in ln or "entry function" in ln]
                    for src in ("flash_sm90", "attention_sm90", "attention_q8_sm90",
                                "attention_online_sm90", "paged_decode_sm90", "decode_sm90")
                    if src in _build.SOURCES}
    return res


# the ring's B-pvbf16 chunk pairs: (B, Hq, Hk, S, D), device scalar
PVBF16_B10 = {"B10-B-pvbf16-offsets": ((1, 32, 8, 8192, 128), "offsets"),
              "B10-B-pvbf16-kvtrue": ((1, 48, 48, 5120, 64), "kvtrue")}


def decode_rows(torch, cs, label, kern_mod, kern_name, call):
    """``{label: device ms, label wrapper: host ms}`` of the decode kernel
    launch that ``call`` makes (its inputs recorded, then replayed)."""
    from sageattention_tpu_torch.utils.testing import time_fn
    real, seen = getattr(kern_mod, kern_name), []

    def record(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    setattr(kern_mod, kern_name, record)
    try:
        call()
    finally:
        setattr(kern_mod, kern_name, real)
    args, kw = seen[0]
    fn = lambda: real(*args, **kw)  # noqa: E731
    return {label: cs.decode_device_ms(torch, fn),
            label + " wrapper": time_fn(fn, warmup=3, reps=20) * 1e3}


def pvbf16_d1_rows(torch, cs, st, _build):
    """D1-int8 and D1-int8-causal (device and wrapper time), B-pvbf16 in its
    forms, its ring pairs and ``sageattn_qk_int8_pv_bf16``'s call with its
    parts."""
    from sageattention_tpu_torch.ops import attention as tatt
    from sageattention_tpu_torch.ops import paged_decode as tpd
    from sageattention_tpu_torch.utils.testing import time_fn
    res = {}
    H, Hk, D = cs.SERVE["attn"]
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 45)
    rn = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    page = cs.SERVE["page"]
    for label, lens, T in (("D1-int8", [L + 1 for L in cs.SERVE["serve"]], 1),
                           ("D1-int8-causal", list(cs.SERVE["paged_lens"]), 4)):
        B = len(lens)
        per = -(-max(lens) // page) + 1
        table = st.build_table([[b * per + j for j in range(per)] for b in range(B)], per)
        k, v = rn(B, Hk, (per - 1) * page, D).bfloat16(), rn(B, Hk, (per - 1) * page, D).bfloat16()
        cache = st.paged_prefill(k, v, lens, table, num_pages=B * per, page_size=page,
                                 v_format="int8")
        q = rn(B, H, T, D).bfloat16()
        res.update(decode_rows(torch, cs, label, tpd, "paged_decode_kernel",
                               lambda: st.sageattn_decode_paged(q, cache)))
        del cache, k, v
        torch.cuda.empty_cache()
    for shape in ("cog", "llama"):
        B, Hq, Hk, S, D, causal = CASES[shape]
        q, k, v = cs.realistic_qkv(torch, B, Hq, Hk, S, D, 0)
        forms = [("B-pvbf16", {}), ("B-pvbf16 fused", dict(fuse_q_quant=True, fold_k_scale=True))]
        if shape == "cog":
            forms.insert(1, ("B-pvbf16-online", {}))
        for label, opt in forms:
            cfg = dataclasses.replace(cs.attn_cfg(torch, label.split()[0], D, causal), **opt)
            xs, kw = cs.kernel_args(torch, cfg, q, k, v)
            res[f"{shape} {label}"] = time_fn(lambda: tatt.attention_kernel(*xs, cfg, **kw),
                                              warmup=3, reps=20) * 1e3
            del xs, kw
        call = lambda: st.sageattn_qk_int8_pv_bf16(q, k, v, is_causal=causal)  # noqa: E731
        res[f"{shape} sageattn pv bf16"] = time_fn(call, warmup=2, reps=10) * 1e3
        res[f"{shape} sageattn pv bf16 parts"] = call_parts(torch, _build, call)
        res[f"{shape} sageattn pv bf16 fused"] = time_fn(
            lambda: st.sageattn(q, k, v, is_causal=causal, pv_dtype="bf16"),
            warmup=2, reps=10) * 1e3
        del q, k, v
        torch.cuda.empty_cache()
    for name, ((B, Hq, Hk, S, D), dyn) in PVBF16_B10.items():
        q, k, v = cs.realistic_qkv(torch, B, Hq, Hk, S, D, 3)
        causal = dyn == "offsets"
        cfg = dataclasses.replace(cs.attn_cfg(torch, "B-pvbf16", D, causal), fold_k_scale=True,
                                  causal_dynamic=causal, kv_len_dynamic=not causal)
        xs, kw = cs.kernel_args(torch, cfg, q, k, v)
        if causal:   # q_start - kv_start >= S: every key visible
            kw["offsets"] = torch.tensor([3 * S, 0], dtype=torch.int32, device="cuda")
        else:
            kw["kv_true"] = torch.tensor([S], dtype=torch.int32, device="cuda")
        res[name] = time_fn(lambda: tatt.attention_kernel(*xs, cfg, **kw), warmup=3,
                            reps=20) * 1e3
        del q, k, v, xs, kw
    return res


def b11_rows(torch, cs, st):
    """B11 on an int8 V cache (device and wrapper time) at phase 8a's step
    and its T = 4 window (B = 1, 8,192 tokens), then the folded T = 9 and
    unfolded T = 25 windows over 8 sequences of 32,768 tokens, all at
    Llama-3-8B attention width."""
    from sageattention_tpu_torch.ops import attention as tatt
    res = {}
    H, Hk, D = cs.SERVE["attn"]
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 45)
    rn = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    k, v = rn(1, Hk, 8192, D).bfloat16(), rn(1, Hk, 8192, D).bfloat16()
    cache = st.kv_cache_init(k, v, 8320, v_format="int8")
    for label, T in (("B11-int8", 1), ("B11-int8-causal-mod T=4", 4)):
        q = rn(1, H, T, D).bfloat16()
        res.update(decode_rows(torch, cs, label, tatt, "decode_kernel",
                               lambda: st.sageattn_decode(q, cache)))
    del cache, k, v
    B, L = cs.SERVE["kernel_B"], cs.SERVE["dense_len"]
    k, v = rn(B, Hk, L, D).bfloat16(), rn(B, Hk, L, D).bfloat16()
    cache = st.kv_cache_init(k, v, L)
    del k, v
    for label, T in (("B11-int8-causal-mod T=9", 9), ("B11-int8-causal T=25", 25)):
        q = rn(B, H, T, D).bfloat16()
        res.update(decode_rows(torch, cs, label, tatt, "decode_kernel",
                               lambda: st.sageattn_decode(q, cache)))
    return res


def masked_rows(torch, cs, st):
    """The masked forms' kernel ms on the launches the public entries make
    at phase 7's shapes, recorded by ``chip_smoke.Recorder``."""
    from sageattention_tpu_torch.ops import attention as tatt
    from sageattention_tpu_torch.utils.testing import time_fn
    res = {}

    def rows(label, keys, calls):
        seen = {}
        with cs.Recorder(seen):
            for fn in calls:
                fn()
        torch.cuda.synchronize()
        for key in keys:
            args, kw = seen[key]
            run = lambda: tatt.attention_kernel(*args, **kw)  # noqa: E731
            res[f"{label} {key}"] = time_fn(run, warmup=3, reps=20) * 1e3
        del seen

    H, Hk, S, D, W = 32, 8, 16384, 128, 4096
    q, k, v = cs.realistic_qkv(torch, 1, H, Hk, S, D, cs.SEED + 21)
    rows("mistral", ("B4", "B4-window", "B1", "B1-window"),
         (lambda: st.flash_attention(q, k, v, is_causal=True),
          lambda: st.flash_attention(q, k, v, is_causal=True, sliding_window=W),
          lambda: st.sageattn(q, k, v, is_causal=True),
          lambda: st.sageattn(q, k, v, is_causal=True, sliding_window=W)))
    B, S = 4, 4096
    q, k, v = cs.realistic_qkv(torch, B, H, Hk, S, D, cs.SEED + 24)
    pad = S - torch.tensor([4096, 3072, 1536, 512], device="cuda")
    keep = (torch.arange(S, device="cuda")[None, None, None, :] >= pad[:, None, None, None])
    keep = keep.expand(B, 1, S, S).contiguous()
    rows("left-padded", ("B4-bool", "B1-bool"),
         (lambda: st.sageattn(q, k, v, is_causal=True, attn_mask=keep),
          lambda: tatt.attention_call(q, k, v, attn_mask=keep,
                                      cfg=cs.flash_cfg(torch, D, True, masked="bool"))))
    del keep
    B, H, S, D = 1, 48, 17776, 64
    q, k, v = cs.realistic_qkv(torch, B, H, H, S, D, cs.SEED + 25)
    nb = -(-S // 128)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 26)
    blocks = torch.rand(nb, nb, generator=g, device="cuda") < cs.SPARSE_LIVE
    blocks |= torch.eye(nb, dtype=torch.bool, device="cuda")
    keep = blocks.repeat_interleave(128, 0).repeat_interleave(128, 1)[:S, :S][None, None]
    rows("sparse", ("B1", "B1-bool", "B4-bool"),
         (lambda: st.sageattn(q, k, v, attn_mask=keep), lambda: st.sageattn(q, k, v),
          lambda: tatt.attention_call(q, k, v, attn_mask=keep,
                                      cfg=cs.flash_cfg(torch, D, False, masked="bool"))))
    del keep
    H, D = 32, 128
    T = sum(cs.VARLEN_LENS)
    q, k, v = (x[0].transpose(0, 1) for x in cs.realistic_qkv(torch, 1, H, Hk, T, D,
                                                              cs.SEED + 22))
    cu = cs.cu_seqlens(torch, cs.VARLEN_LENS)
    rows("varlen", ("B1-colk-seg", "B1-colk-seg-window"),
         (lambda: st.sageattn_varlen(q, k, v, cu, cu, is_causal=True),
          lambda: st.sageattn_varlen(q, k, v, cu, cu, is_causal=True, sliding_window=4096,
                                     attention_sinks=4)))
    return res


# online_rows' launches: (label, AttnConfig fields over the key's own)
ONLINE_ROWS = (("B6-static", {}), ("B6-online", {}), ("B5-fp8", {}), ("B-pvbf16", {}),
               ("B-pvbf16-online", {}), ("B5-int8", {}), ("B2", {}), ("B5-fp8-fusedq", {}),
               ("B-pvbf16-online fused Q", dict(fuse_q_quant=True, fold_k_scale=True)))


def online_rows(torch, cs, st):
    """The kernel ms of each of ``ONLINE_ROWS`` at CogVideoX1.5 and
    Llama-70B GQA causal, ``sageattn(pv_dtype="fp8")``'s call there, and the
    ring's ``-kvtrue`` forms of the pre-quantized rows on the CogVideoX1.5
    chunk pair (a full chunk's true length on the device, folded K scales,
    no V mean); every key starts with ``online``, apart from the earlier
    rows of the same configurations."""
    from sageattention_tpu_torch.ops.attention import attention_kernel
    from sageattention_tpu_torch.utils.testing import time_fn
    res = {}
    for shape in ("cog", "llama"):
        B, Hq, Hk, S, D, causal = CASES[shape]
        q, k, v = cs.realistic_qkv(torch, B, Hq, Hk, S, D, 0)
        for label, extra in ONLINE_ROWS:
            cfg = dataclasses.replace(cs.attn_cfg(torch, label.split(" ")[0], D, causal), **extra)
            xs, kw = cs.kernel_args(torch, cfg, q, k, v)
            res[f"online {shape} {label}"] = time_fn(lambda: attention_kernel(*xs, cfg, **kw),
                                                     warmup=3, reps=20) * 1e3
            del xs, kw
        res[f"online {shape} sageattn fp8"] = time_fn(
            lambda: st.sageattn(q, k, v, is_causal=causal, pv_dtype="fp8"), warmup=2,
            reps=10) * 1e3
        del q, k, v
        torch.cuda.empty_cache()
    B, Hq, Hk, S, D = 1, 48, 48, 5120, 64
    q, k, v = cs.realistic_qkv(torch, B, Hq, Hk, S, D, 3)
    for name in ("B6-static", "B6-online", "B5-fp8", "B-pvbf16", "B-pvbf16-online"):
        cfg = dataclasses.replace(cs.attn_cfg(torch, name, D, False), fold_k_scale=True,
                                  fuse_v_mean=False, kv_len_dynamic=True)
        xs, kw = cs.kernel_args(torch, cfg, q, k, v)
        kw.pop("v_mean", None)
        kw["kv_true"] = torch.tensor([S], dtype=torch.int32, device="cuda")
        res[f"online B10-{name}-kvtrue pair"] = time_fn(lambda: attention_kernel(*xs, cfg, **kw),
                                                 warmup=3, reps=20) * 1e3
    return res


def lowbit_fp8_rows(torch, cs, st, _build):
    """B4-fp4's kernel ms at each of ``FP4_SHAPES`` and the
    ``sageattn3_blackwell`` call at CogVideoX1.5; B5-fp8's at CogVideoX1.5
    and Llama-70B GQA with where one launch spends its time,
    ``B10-B5-fp8-kvtrue``'s on the CogVideoX1.5 chunk pair, and
    ``sageattn_qk_int8_pv_fp8``'s call."""
    from sageattention_tpu_torch.ops import attention as tatt
    from sageattention_tpu_torch.utils.testing import time_fn
    res = {}
    for shape, (B, Hq, Hk, S, D, causal) in FP4_SHAPES.items():
        q, k, v = cs.realistic_qkv(torch, B, Hq, Hk, S, D, 0)
        cfg = tatt.AttnConfig(causal=causal, quantized=False, sm_scale=D ** -0.5,
                              emit_lse=False, p_sim_fp4=True)
        warm, reps = (1, 3) if shape == "hunyuan" else (3, 20)
        res[f"{shape} B4-fp4"] = time_fn(lambda: tatt.attention_kernel(q, k, v, cfg),
                                         warmup=warm, reps=reps) * 1e3
        if shape == "cog":
            res["cog sageattn3_blackwell"] = time_fn(lambda: st.sageattn3_blackwell(q, k, v),
                                                     warmup=2, reps=10) * 1e3
        del q, k, v
        torch.cuda.empty_cache()
    for shape in ("cog", "llama"):
        B, Hq, Hk, S, D, causal = CASES[shape]
        q, k, v = cs.realistic_qkv(torch, B, Hq, Hk, S, D, 0)
        cfg = cs.attn_cfg(torch, "B5-fp8", D, causal)
        xs, kw = cs.kernel_args(torch, cfg, q, k, v)
        call = lambda: tatt.attention_kernel(*xs, cfg, **kw)  # noqa: E731
        res[f"{shape} B5-fp8"] = time_fn(call, warmup=3, reps=20) * 1e3
        res[f"{shape} B5-fp8 parts"] = call_parts(torch, _build, call,
                                                  extra=((tatt, "transpose_v_codes"),))
        res[f"{shape} sageattn pv fp8"] = time_fn(
            lambda: st.sageattn_qk_int8_pv_fp8(q, k, v, is_causal=causal), warmup=2, reps=10) * 1e3
        del q, k, v, xs, kw
    B, Hq, Hk, S, D = 1, 48, 48, 5120, 64
    q, k, v = cs.realistic_qkv(torch, B, Hq, Hk, S, D, 3)
    # the ring's fp8 chunks keep per-column K scales (``RingPlan.fold_k``)
    cfg = dataclasses.replace(cs.attn_cfg(torch, "B5-fp8", D, False), fuse_v_mean=False,
                              kv_len_dynamic=True)
    xs, kw = cs.kernel_args(torch, cfg, q, k, v)
    kw.pop("v_mean")
    kw["kv_true"] = torch.tensor([S], dtype=torch.int32, device="cuda")
    res["B10-B5-fp8-kvtrue"] = time_fn(lambda: tatt.attention_kernel(*xs, cfg, **kw),
                                       warmup=3, reps=20) * 1e3
    return res


def q8_bwd_rows(torch, cs, st, _build):
    """The int8 C1's and C2's kernel ms, each alone, at each of ``Q8_BWD``
    from the port's flash forward on realistic inputs, and where one launch
    spends its time."""
    from sageattention_tpu_torch.ops import backward as tbwd
    from sageattention_tpu_torch.utils.testing import time_fn
    res = {}
    for label, (B, Hq, Hk, S, D, causal, ring) in Q8_BWD.items():
        q, k, v = cs.realistic_qkv(torch, B, Hq, Hk, S, D, 1)
        do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(2),
                         device="cuda").bfloat16()
        o, lse = st.flash_attention(q, k, v, is_causal=causal, return_lse=True)
        di = (do.float() * o.float()).sum(-1) if ring else None
        pa = tbwd.prepare(q, k, v, o, lse, do, sm_scale=D ** -0.5, quantized=True, di=di)
        pa.update(causal=causal, out_dtype=torch.float32 if ring else torch.bfloat16)
        for kernel in ("C1", "C2"):
            call = lambda: tbwd.attention_backward_kernel(**pa, kernels=(kernel,))  # noqa: E731
            res[f"{label} {kernel}-int8"] = time_fn(call, warmup=2, reps=5) * 1e3
            res[f"{label} {kernel}-int8 parts"] = call_parts(
                torch, _build, call, reps=5, extra=((tbwd, "dequant_rows"),))
        del q, k, v, o, lse, do, di, pa
        torch.cuda.empty_cache()
    return res


def q8_rows(torch, cs):
    """B6's kernel ms at each of ``CASES`` on the inputs the port's
    quantizers give it, and the B10-B6 forms' on ``B10_PAIRS``: the
    ring's operands (Q codes per 4 rows with the per-head K scale folded
    in, no V mean), a visible pair's offsets or a full chunk's true length
    on the device."""
    from sageattention_tpu_torch.ops.attention import attention_kernel
    from sageattention_tpu_torch.utils.testing import time_fn
    res = {}
    for shape, (B, Hq, Hk, S, D, causal) in CASES.items():
        q, k, v = cs.realistic_qkv(torch, B, Hq, Hk, S, D, 0)
        for name in Q8_KERNELS:
            cfg = cs.attn_cfg(torch, name, D, causal)
            xs, kw = cs.kernel_args(torch, cfg, q, k, v)
            res[f"{shape} {name}"] = time_fn(lambda: attention_kernel(*xs, cfg, **kw),
                                             warmup=3, reps=20) * 1e3
        del q, k, v
    for name, ((B, Hq, Hk, S, D), mode, dyn) in B10_PAIRS.items():
        q, k, v = cs.realistic_qkv(torch, B, Hq, Hk, S, D, 3)
        causal = dyn == "offsets"
        cfg = dataclasses.replace(cs.attn_cfg(torch, f"B6-{mode}", D, causal), fold_k_scale=True,
                                  fuse_v_mean=False, causal_dynamic=causal,
                                  kv_len_dynamic=not causal)
        xs, kw = cs.kernel_args(torch, cfg, q, k, v)
        kw.pop("v_mean")
        if causal:   # q_start - kv_start >= S: every key visible
            kw["offsets"] = torch.tensor([3 * S, 0], dtype=torch.int32, device="cuda")
        else:
            kw["kv_true"] = torch.tensor([S], dtype=torch.int32, device="cuda")
        res[name] = time_fn(lambda: attention_kernel(*xs, cfg, **kw), warmup=3, reps=20) * 1e3
        del q, k, v, xs, kw
    return res


def ring_rows(torch, cs, reps=3):
    """ms per call of the ring over 4 virtual ranks at CogVideoX1.5 and at
    Llama-3.1-8B 65,536 causal (int8 PV, static), and the median over
    ``reps`` calls of where a call's time goes: the device time of its
    attention launches (CUDA events around each), of which the V widening,
    and the rest."""
    from sageattention_tpu_torch.ops import attention as tatt
    from sageattention_tpu_torch.utils.testing import time_fn
    res = {}
    for label, ((B, H, Hk, S, D), causal) in (("ring cog", (cs.COG_SHAPE, False)),
                                              ("ring llama", (cs.LLAMA_LONG, True))):
        q, k, v = cs.realistic_qkv(torch, B, H, Hk, S, D, cs.SEED + 81 + int(causal))
        call = lambda: cs.virtual_ring(torch, q, k, v, 4, is_causal=causal)  # noqa: E731
        res[label] = time_fn(call, warmup=1, reps=reps) * 1e3
        real, real_widen = tatt.attention_kernel, tatt.widen_v_codes
        spans = []

        def timed(fn, what):
            def run(*args, **kw):
                s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                s.record()
                out = fn(*args, **kw)
                e.record()
                spans.append((what, s, e))
                return out
            return run

        tatt.attention_kernel = timed(real, "B10 launches")
        tatt.widen_v_codes = timed(real_widen, "of which V widening")
        rows = []
        try:
            for _ in range(reps):
                spans.clear()
                torch.cuda.synchronize()
                s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                s.record()
                call()
                e.record()
                torch.cuda.synchronize()
                row = {"total": s.elapsed_time(e), "B10 launches": 0.0, "of which V widening": 0.0}
                for what, a, b in spans:
                    row[what] += a.elapsed_time(b)
                row["rest"] = row["total"] - row["B10 launches"]
                rows.append(row)
        finally:
            tatt.attention_kernel, tatt.widen_v_codes = real, real_widen
        res[label + " parts"] = {key: sorted(r[key] for r in rows)[len(rows) // 2]
                                 for key in rows[0]}
        del q, k, v
        torch.cuda.empty_cache()
    return res


def biased_rows(torch, cs):
    """B4-float's kernel ms at MPT-7B's ALiBi shape, and the library's
    biased call on the same inputs."""
    from sageattention_tpu_torch.ops.attention import attention_kernel
    from sageattention_tpu_torch.utils.testing import time_fn
    B, H, S, D = 2, 32, 2048, 128
    q, k, v = cs.realistic_qkv(torch, B, H, H, S, D, 23)
    slopes = 2.0 ** (-8.0 * torch.arange(1, H + 1, device="cuda") / H)
    pos = torch.arange(S, device="cuda", dtype=torch.float32)
    bias = (-slopes[:, None, None] * (pos[:, None] - pos[None, :]).clamp_min(0))[None]
    bias = bias.expand(B, H, S, S).contiguous()
    cfg = cs.flash_cfg(torch, D, True, masked="float")
    res = {"mpt B4-float": time_fn(lambda: attention_kernel(q, k, v, cfg, attn_mask=bias),
                                   warmup=3, reps=20) * 1e3}
    res["mpt B4-float library"] = cs.library_masked_ms(torch, (q, k, v, cfg),
                                                       {"attn_mask": bias})
    return res


def bwd_rows(torch, cs, st):
    """C1's and C2's ms, each alone through ``attention_backward_kernel``
    (the wrapper's glue included: the masked forms' tile lists), in each
    form of ``BWD_FORMS`` (bf16 outputs), from the port's flash forward
    with the same window (sageattn's with the same mask), and the library's
    backward at each shape (with the form's band or mask at the masked
    forms' own shapes)."""
    from sageattention_tpu_torch.ops import backward as tbwd
    from sageattention_tpu_torch.utils.testing import time_fn
    res = {}
    for shape, (B, Hq, Hk, S, D, causal) in BWD_SHAPES.items():
        q, k, v = cs.realistic_qkv(torch, B, Hq, Hk, S, D, 1)
        do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(2),
                         device="cuda").bfloat16()
        lib = {"is_causal": causal, "sm_scale": D ** -0.5}
        for form_shape, form, opt in BWD_FORMS:
            if form_shape != shape:
                continue
            mask, fwd = None, dict(is_causal=causal, return_lse=True)
            if opt.get("mask"):   # left-padded prompts: the smoke's lengths, or S / 8 of padding
                lens = cs.TRAIN["padded_lens"] if shape == "padded" else [S - S // 8] * B
                pad = S - torch.tensor(lens, device="cuda")
                mask = torch.arange(S, device="cuda")[None, None, None, :] >= pad[:, None, None,
                                                                                  None]
                mask = mask.expand(B, 1, S, S)
                o, lse = st.sageattn(q, k, v, attn_mask=mask, **fwd)
            else:
                o, lse = st.flash_attention(q, k, v, sliding_window=opt.get("window", 0),
                                            attention_sinks=opt.get("sinks", 0), **fwd)
            pa = tbwd.prepare(q, k, v, o, lse, do, sm_scale=D ** -0.5, attn_mask=mask)
            pa.update(causal=causal, window=opt.get("window", 0), sinks=opt.get("sinks", 0),
                      out_dtype=torch.bfloat16)
            for kernel in ("C1", "C2"):
                res[f"{shape} {kernel}-{form}"] = time_fn(
                    lambda: tbwd.attention_backward_kernel(**pa, kernels=(kernel,)),
                    warmup=2, reps=5) * 1e3
            if shape in ("mistral", "padded"):
                lib.update(window=opt.get("window", 0), sinks=opt.get("sinks", 0),
                           attn_mask=mask)
            del pa, o, lse
        res[f"{shape} C1+C2 library"] = cs.library_bwd_ms(torch, q, k, v, do, lib)
        del q, k, v, do
        torch.cuda.empty_cache()
    return res


def train_steps(torch, cs, warm=2, reps=6):
    """ms per Adam step (CUDA events, the median of ``reps`` after ``warm``)
    of the phase-9 Llama-width fine-tune and CogVideoX1.5-width DiT step
    with the port's exact attention, from the smoke's weights and data."""
    from sageattention_tpu_torch.examples import train_finetune as tex
    from sageattention_tpu_torch.models import (DiTConfig, LlamaConfig, LlamaLM,
                                                flash_dot_product_attention)
    from sageattention_tpu_torch.models import dit as tdit
    lcfg = LlamaConfig(**cs.TRAIN["llama"])
    toks = next(tex.batches(lcfg.vocab, 1, cs.TRAIN["seq"] + 1, 1, seed=cs.SEED + 1,
                                device="cuda"))
    dcfg = DiTConfig(**cs.TRAIN["dit"])
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 64)
    batch = tdit.example_inputs(dcfg, 1, generator=g, device="cuda")
    noise = torch.randn(batch[0].shape, generator=g, device="cuda")
    models = {"llama train step": (
        lambda: LlamaLM(lcfg, attn_fn=flash_dot_product_attention,
                        device="cuda").init_weights(cs.SEED),
        lambda m: tex.lm_loss(m, toks)),
        "cog DiT train step": (
        lambda: tdit.make_dit(dcfg, attn_fn=flash_dot_product_attention,
                              device="cuda").init_weights(cs.SEED),
        lambda m: tdit.diffusion_loss(m, batch, noise=noise))}
    res = {}
    for key, (make, loss_fn) in models.items():
        res.update(adam_ms(torch, key, make(), loss_fn, warm, reps))
        torch.cuda.empty_cache()
    return res


def sage_dit_step(torch, cs, warm=2, reps=6):
    """ms per Adam step of the phase-9 CogVideoX1.5-width DiT with
    ``sage_dot_product_attention``: the int8 forward and, the call being
    non-causal, the int8 backward."""
    from sageattention_tpu_torch.models import DiTConfig, sage_dot_product_attention
    from sageattention_tpu_torch.models import dit as tdit
    dcfg = DiTConfig(**cs.TRAIN["dit"])
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 64)
    batch = tdit.example_inputs(dcfg, 1, generator=g, device="cuda")
    noise = torch.randn(batch[0].shape, generator=g, device="cuda")
    model = tdit.make_dit(dcfg, attn_fn=sage_dot_product_attention,
                          device="cuda").init_weights(cs.SEED)
    return adam_ms(torch, "cog DiT train step sage", model,
                   lambda m: tdit.diffusion_loss(m, batch, noise=noise), warm, reps)


def adam_ms(torch, key, model, loss_fn, warm, reps):
    """``{key: median ms per Adam step over reps after warm, key all: every
    step's ms}`` (CUDA events around each step)."""
    opt = torch.optim.Adam(model.parameters(), lr=3e-4)
    ms = []
    for _ in range(warm + reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        opt.zero_grad(set_to_none=True)
        loss_fn(model).backward()
        opt.step()
        e.record()
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e))
    return {key: sorted(ms[warm:])[reps // 2], key + " all": ms}


def call_parts(torch, _build, call, reps=10, extra=None):
    """Median over ``reps`` calls of where one call's time goes (ms): each
    kernel launch, each call of the functions ``extra`` names (``(module,
    attribute)`` pairs; by default B1's V widening) in trees that have them,
    and the rest."""
    from sageattention_tpu_torch.ops import attention as tatt
    real = _build.call
    spans, launches = [], []

    def timed(fn, device, *args):
        launches.append((fn, time.perf_counter()))
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        real(fn, device, *args)
        e.record()
        spans.append((fn, s, e))

    def wrap(name, fn):
        def run(*args):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*args)
            e.record()
            spans.append((name, s, e))
            return out
        return run

    wrapped = [(mod, name, getattr(mod, name)) for mod, name in
               (extra if extra is not None else ((tatt, "widen_v_codes"),)) if hasattr(mod, name)]
    _build.call = timed
    for mod, name, fn in wrapped:
        setattr(mod, name, wrap(name, fn))
    rows = []
    try:
        call()
        for _ in range(reps):
            spans, launches = [], []
            torch.cuda.synchronize()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            s.record()
            call()
            e.record()
            torch.cuda.synchronize()
            row = {"total": s.elapsed_time(e), "host_to_first_launch": (launches[0][1] - t0) * 1e3}
            for fn, a, b in spans:
                row[fn] = row.get(fn, 0.0) + a.elapsed_time(b)
            row["rest"] = row["total"] - sum(a.elapsed_time(b) for _, a, b in spans)
            rows.append(row)
    finally:
        _build.call = real
        for mod, name, fn in wrapped:
            setattr(mod, name, fn)
    return {key: sorted(r[key] for r in rows)[len(rows) // 2] for key in rows[0]}


def bwd_tree(tree: str) -> dict:
    """``--rows bwd``: the C1/C2 rows alone (``bwd_rows``, ``q8_bwd_rows``)."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    import sageattention_tpu_torch as st
    from sageattention_tpu_torch.ops import _build
    if not _build.__file__.startswith(tree):
        raise RuntimeError(f"imported {_build.__file__}, not the tree {tree}")
    _build.build_all()
    with torch.no_grad():
        res = bwd_rows(torch, cs, st)
        torch.cuda.empty_cache()
        res.update(q8_bwd_rows(torch, cs, st, _build))
    return res


# the prep rows' shapes: B, Hq, Hk, S, D, causal
PREP_CASES = {"cog": CASES["cog"], "llama": CASES["llama"]}


def device_ms(torch, fn, reps=20):
    """Device time per call of what ``fn`` launches, with the host's work
    left out: a ~25 ms spin kernel holds the card while the host queues
    ``reps`` calls between two CUDA events (median of 3)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        runs.append(s.elapsed_time(e) / reps)
    return sorted(runs)[1]


def prep_rows(torch, cs, st, calls=True):
    """At CogVideoX1.5 and Llama-70B GQA (``PREP_CASES``) on the K and V of
    ``chip_smoke.realistic_qkv``: the K/V prep's kernels as ``sageattn``
    calls them (A1 with capmax and A2; A3 + A4, the two-pass pair; A5 and
    the A6 group on K, as phase 4 calls them), each as its device time per
    call (``<shape> <row> device``, :func:`device_ms`) and its call's time
    (``<shape> <row>``, CUDA events over back-to-back calls); then, with
    ``calls``, ``sageattn``'s time per call and where it goes (``parts``)."""
    from sageattention_tpu_torch.ops import _build
    from sageattention_tpu_torch.ops import quant_fused as qf
    from sageattention_tpu_torch.ops import quant_kernels as qk
    from sageattention_tpu_torch.utils.testing import time_fn
    res = {}
    for shape, (B, Hq, Hk, S, D, causal) in PREP_CASES.items():
        q, k, v = cs.realistic_qkv(torch, B, Hq, Hk, S, D, 0)
        km, _ = qk.channel_stats(k, S)
        rows = {"A1": lambda: qf.prep_k_onepass(k, S, with_capmax=True),
                "A2": lambda: qf.prep_v_onepass(v, S),
                "A3+A4": lambda: cs.two_pass_prep(torch, k, v, S),
                "A5": lambda: qk.channel_stats(k, S),
                "A6-group": lambda: qk.quant_int8_groupwise(k, 16, sub=km, with_capmax=True,
                                                            s_true=S)}
        for name in ("A3+A4", "A5", "A6-group", "A2", "A1"):   # the changed kernels last
            res[f"{shape} {name} device"] = device_ms(torch, rows[name])
            res[f"{shape} {name}"] = time_fn(rows[name], warmup=3, reps=20) * 1e3
        if calls:
            call = lambda: st.sageattn(q, k, v, is_causal=causal)  # noqa: E731
            res[f"{shape} sageattn"] = time_fn(call, warmup=2, reps=10) * 1e3
            res[f"{shape} sageattn parts"] = call_parts(torch, _build, call)
        del q, k, v
        torch.cuda.empty_cache()
    return res


def prep_tree(tree: str, calls: bool = True) -> dict:
    """``--rows prep``: the K/V prep rows alone (``prep_rows``)."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    import sageattention_tpu_torch as st
    from sageattention_tpu_torch.ops import _build
    if not _build.__file__.startswith(tree):
        raise RuntimeError(f"imported {_build.__file__}, not the tree {tree}")
    _build.build_all()
    with torch.inference_mode():
        return prep_rows(torch, cs, st, calls)


ROWS = {"all": one_tree, "bwd": bwd_tree, "prep": prep_tree}


def main(argv) -> int:
    rows = "all"
    if len(argv) > 2 and argv[1] == "--rows":
        rows, argv = argv[2], argv[:1] + argv[3:]
    if len(argv) == 3 and argv[1] == "--one":
        print("AB", argv[2], json.dumps(ROWS[rows](argv[2])), flush=True)
        return 0
    rc = 0
    for tree in argv[1:]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--rows", rows, "--one",
                              tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
