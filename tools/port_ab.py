#!/usr/bin/env python3
"""Times the port's plain attention configurations and its ``sageattn``
entry in several checkouts, each in a process of its own, on one CUDA card.

    python3 tools/port_ab.py build/parent . . build/parent

Give the trees in the order parent, change, change, parent within one run
(a card's clocks and power drift between runs).  Each tree builds its own
kernels into its own ``build/torch_kernels/``.  For each tree, at the
CogVideoX1.5 (1, 48, 17776, 64), Llama-70B GQA causal (1, 64/8, 16384,
128) and Gemma-7B causal (1, 16, 8192, 256) shapes, it prints one line
``AB <tree> <json>`` with:

- the kernel time (ms) of B1, B2, B5-fp8-fusedq, B6-static, B-pvbf16 and
  B4 on the inputs the port's quantizers give them, B4's masked and
  FP4 forms (``B4-window`` with a 4,096-token window on the causal shapes,
  ``B4-fp4``), and B4's library call (``F.scaled_dot_product_attention``
  on its flash backend, ``B4 library``) beside them;
- ``sageattn``'s time per call, back to back as a caller makes them;
- where one ``sageattn`` call spends its time: the device time of each
  kernel it launches (CUDA events around each launch), the rest of the
  call (PyTorch glue kernels, the host read of the static check and the
  host's dispatch while the card waits), and the host time from the call's
  start to its first kernel launch;

the time (ms) of C1 and C2, each alone, in the forms that stay on
``backward.cu`` (``-int8`` at CogVideoX1.5 and ``-int8-causal``,
``-window`` with a 4,096-token window and ``-causal-bool`` with a
left-padding mask at Llama-3-8B width, (1, 32/8, 8192, 128)) and then the
bf16 forms that ``backward_sm90.cu`` takes (``-bf16`` at CogVideoX1.5,
``-bf16-causal`` at Llama-3-8B width), from the port's flash forward on the
same inputs, with the library's backward (one ``torch.autograd.grad``
through ``F.scaled_dot_product_attention``, ``C1+C2 library``) at both
shapes;

and, for the training steps of ``chip_smoke.py``'s phase 9 with the port's
exact attention (``flash_dot_product_attention``: the B4 forward and the
bf16 C1/C2 backward), the ms per Adam step at Llama-3-8B width (2 blocks,
8,192 tokens, causal) and at CogVideoX1.5 width (the 2-block DiT's
diffusion step), each the median of 6 steps after 2 warm ones.

The tree's ``chip_smoke.py`` provides the inputs, configurations and models.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

CASES = {"cog": (1, 48, 48, 17776, 64, False), "llama": (1, 64, 8, 16384, 128, True),
         "gemma": (1, 16, 16, 8192, 256, True)}
# B4 runs after the configurations that must stay put: what runs before a
# kernel can move its reading (the parent's B5-fp8-fusedq at Gemma-7B read
# faster after the old B4 than before it, with the same code)
KERNELS = ("B1", "B2", "B5-fp8-fusedq", "B6-static", "B-pvbf16", "B4")
B4_FORMS = {"B4-fp4": dict(p_sim_fp4=True), "B4-window": dict(window=4096)}
# C1/C2: B, Hq, Hk, S, D, causal; the forms that stay on backward.cu first,
# the routed bf16 forms last (as B4 above)
BWD_SHAPES = {"cog": (1, 48, 48, 17776, 64, False), "llama8k": (1, 32, 8, 8192, 128, True)}
BWD_FORMS = (("cog", "int8", dict(quantized=True)),
             ("llama8k", "int8-causal", dict(quantized=True)),
             ("llama8k", "bf16-window", dict(window=4096)),
             ("llama8k", "bf16-causal-bool", dict(mask=True)),
             ("cog", "bf16", {}),
             ("llama8k", "bf16-causal", {}))


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
    with torch.no_grad():
        res.update(bwd_rows(torch, cs, st))
    torch.cuda.empty_cache()
    res.update(train_steps(torch, cs))
    return res


def bwd_rows(torch, cs, st):
    """C1's and C2's kernel ms, each alone, in each form of ``BWD_FORMS``
    (bf16 outputs), and the library's backward at each shape."""
    from sageattention_tpu_torch.ops import backward as tbwd
    from sageattention_tpu_torch.utils.testing import time_fn
    inputs, res = {}, {}
    for shape, (B, Hq, Hk, S, D, causal) in BWD_SHAPES.items():
        q, k, v = cs.realistic_qkv(torch, B, Hq, Hk, S, D, 1)
        do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(2),
                         device="cuda").bfloat16()
        o, lse = st.flash_attention(q, k, v, is_causal=causal, return_lse=True)
        inputs[shape] = (q, k, v, o, lse, do)
    for shape, form, opt in BWD_FORMS:
        B, Hq, Hk, S, D, causal = BWD_SHAPES[shape]
        q, k, v, o, lse, do = inputs[shape]
        mask = None
        if opt.get("mask"):   # a left-padded prompt: its first S / 8 keys are padding
            mask = (torch.arange(S, device="cuda") >= S // 8).expand(B, 1, S, S)
        pa = tbwd.prepare(q, k, v, o, lse, do, sm_scale=D ** -0.5,
                          quantized=opt.get("quantized", False), attn_mask=mask)
        pa.update(causal=causal, window=opt.get("window", 0), out_dtype=torch.bfloat16)
        for kernel in ("C1", "C2"):
            res[f"{shape} {kernel}-{form}"] = time_fn(
                lambda: tbwd.attention_backward_kernel(**pa, kernels=(kernel,)),
                warmup=2, reps=5) * 1e3
        del pa
    for shape, (B, Hq, Hk, S, D, causal) in BWD_SHAPES.items():
        q, k, v, o, lse, do = inputs[shape]
        res[f"{shape} C1+C2 library"] = cs.library_bwd_ms(
            torch, q, k, v, do, {"is_causal": causal, "sm_scale": D ** -0.5})
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
        model = make()
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
        res[key] = sorted(ms[warm:])[reps // 2]
        res[key + " all"] = ms
        del model, opt
        torch.cuda.empty_cache()
    return res


def call_parts(torch, _build, call, reps=10):
    """Median over ``reps`` calls of where one call's time goes (ms)."""
    real = _build.call
    spans, launches = [], []

    def timed(fn, device, *args):
        launches.append((fn, time.perf_counter()))
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        real(fn, device, *args)
        e.record()
        spans.append((fn, s, e))

    _build.call = timed
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
    return {key: sorted(r[key] for r in rows)[len(rows) // 2] for key in rows[0]}


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        print("AB", argv[2], json.dumps(one_tree(argv[2])), flush=True)
        return 0
    rc = 0
    for tree in argv[1:]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
