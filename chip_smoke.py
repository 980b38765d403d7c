#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``sageattention_tpu_torch``).

Run from the root of a checkout on a machine with one Hopper card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device: needs CUDA; prints the card's name and power limit;
2. build: compiles the port's CUDA kernels from ``sageattention_tpu_torch/csrc``;
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
   one PyTorch call computes the same function, that call's time;
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
   under 0.7 and 0.6.

The line before the last is a JSON object with one entry per kernel; the
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
    "A5": "sageattention_tpu/ops/quant_pallas.py:264",
    "A6": "sageattention_tpu/ops/quant_pallas.py:69",
    "B": "sageattention_tpu/ops/attention.py:251",
}
SRC_PREP = "sageattention_tpu_torch/csrc/prep_kv.cu"
SRC_QUANT = "sageattention_tpu_torch/csrc/quant.cu"
SRC_ATTN = "sageattention_tpu_torch/csrc/attention.cuh"
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

    with torch.inference_mode():
        kernels, totals = run(torch, st)
        torch.cuda.empty_cache()
        kernels += run_slice3(torch, st, totals)
    for e in kernels:   # launches over every counted path
        e["launches"] = totals[e["name"]]
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
    from sageattention_tpu_torch.ops import quant_kernels as qk
    from sageattention_tpu_torch.ops.attention import attention_call
    from sageattention_tpu_torch.ops.quant_fused import prep_k_onepass, prep_v_onepass
    return prep_k_onepass, prep_v_onepass, qk, attention_call


def reset_counts():
    pk, pv, qk, att = counters()
    pk.launches = pv.launches = qk.channel_stats.launches = 0
    qk.quant_int8_groupwise.launches = qk.quant_int8_segmented.launches = 0
    for d in (qk.quant_int8_fixed.launches, att.launches):
        for name in d:
            d[name] = 0


def read_counts():
    pk, pv, qk, att = counters()
    return {"A1": pk.launches, "A2": pv.launches, "A5": qk.channel_stats.launches,
            "A6-group": qk.quant_int8_groupwise.launches,
            "A6-scalar": qk.quant_int8_fixed.launches["scalar"],
            "A6-channel": qk.quant_int8_fixed.launches["channel"],
            "A6-seg": qk.quant_int8_segmented.launches, **att.launches}


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
    model = DiT(cfg, device="cuda").init_weights(SEED)
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
    while a counted path runs, so that the kernel checks replay exactly what
    the path launched."""

    def __init__(self, seen):
        self.seen = seen

    def __enter__(self):
        from sageattention_tpu_torch.ops import attention as tatt
        self.tatt, self.real = tatt, tatt.attention_kernel

        def record(*args, **kw):
            self.seen.setdefault(tatt.config_name(args[3]), (args, kw))
            return self.real(*args, **kw)

        tatt.attention_kernel = record
        return self

    def __exit__(self, *exc):
        self.tatt.attention_kernel = self.real


def counted_path(torch, name, expect, seen, totals, fn):
    """Runs one path with every launch count set to 0 just before and read
    just after; checks that each kernel of ``expect`` ran and adds the
    counts to ``totals``.  Returns the path's result and the inputs of its
    launches by configuration (also merged into ``seen``, first wins)."""
    reset_counts()
    rec = {}
    with Recorder(rec):
        out = fn()
        torch.cuda.synchronize()
    counts = read_counts()
    for key, val in rec.items():
        seen.setdefault(key, val)
    print(f"{name} launches: " + ", ".join(f"{k} {n}" for k, n in counts.items() if n),
          flush=True)
    for key in expect:
        check(counts.get(key, 0) > 0, f"{name}: launched {key} {counts.get(key, 0)} times")
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
    timed in turns in one call."""
    from sageattention_tpu_torch.ops.attention import attention_kernel
    from sageattention_tpu_torch.utils.testing import time_fn
    ts = {}
    for _ in range(2):
        for name in (base, key):
            args, kw = seen[name]
            ts.setdefault(name, []).append(
                time_fn(lambda: attention_kernel(*args, **kw), warmup=2, reps=10) * 1e3)
    a, b = min(ts[key]), min(ts[base])
    ratios[label] = {key: a, base: b, "ratio": a / b}
    print(f"     {key} {a:.3f} ms vs {base} {b:.3f} ms on the same inputs: ratio {a / b:.3f}",
          flush=True)
    if bar is not None:
        check(a / b < bar, f"{key} / {base} = {a / b:.3f} < {bar}")


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
    B, H, S, D = 2, 32, 2048, 128
    q, k, v = realistic_qkv(torch, B, H, H, S, D, SEED + 23)
    slopes = 2.0 ** (-8.0 * torch.arange(1, H + 1, device="cuda") / H)
    pos = torch.arange(S, device="cuda", dtype=torch.float32)
    alibi = (-slopes[:, None, None] * (pos[:, None] - pos[None, :]).clamp_min(0))
    bias = alibi[None].expand(B, H, S, S).contiguous()            # f32, 1 GiB
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
    del bias, alibi

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


def slice_heads(args, kw):
    """The launch's inputs for q heads [0, min(G, 2)) and kv head 0: the
    plain versions' check at full length on sampled heads."""
    q, k, v, cfg, khs, knm, vs, vm, qs, ks = args
    G = q.shape[1] // k.shape[1]
    nq = min(G, 2)
    hq = lambda x: None if x is None else x[:, :nq]  # noqa: E731
    hk = lambda x: None if x is None else x[:, :1]  # noqa: E731
    khs = None if khs is None else (hq(khs) if cfg.fuse_k_rows else hk(khs))
    kw = dict(kw)
    if kw.get("attn_mask") is not None and kw["attn_mask"].shape[1] > 1:
        kw["attn_mask"] = kw["attn_mask"][:, :nq]
    return (hq(q), hk(k), hk(v), cfg, khs, hq(knm), hk(vs), hk(vm), hq(qs), hk(ks)), kw


def live_pairs(torch, args, kw):
    """(query, key) pairs the launch's masks keep, over every head."""
    from sageattention_tpu_torch.ops.attention import _keep_mask
    q, k, cfg = args[0], args[1], args[3]
    B, Hq, Sq, _ = q.shape
    Sk = k.shape[2]
    kv_len = cfg.kv_len or Sk
    ext = dict(kw, Sk=Sk)
    cols = torch.arange(Sk, device=q.device)
    n = 0
    for r0 in range(0, Sq, 1024):
        r1 = min(Sq, r0 + 1024)
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        hi = min(kv_len, r1) if cfg.causal else kv_len
        keep = _keep_mask(cfg, rows, cols, r0, r1, hi, ext)
        n += int(keep.sum()) * (Hq // keep.shape[1]) * (B // keep.shape[0])
    return n


def ext_kernel_checks(torch, seen, totals):
    """Every B7-B9 configuration the paths launched, against its plain
    version on sampled heads at full length, with its time at the path's
    full shape; and A6's segmented mode at the varlen K shape."""
    from sageattention_tpu_torch.ops.attention import attention_kernel, attention_plain
    from sageattention_tpu_torch.utils.testing import calc_diff, time_fn
    entries, failures = [], []
    for name in sorted(n for n in seen if n not in KEYS):
        args, kw = seen[name]
        sub, skw = slice_heads(args, kw)
        a = attention_kernel(*sub, **skw)
        b, plain_ms = timed_call(torch, lambda: attention_plain(*sub, **skw))
        kept, note = static_kept_rows(torch, a, b, sub[0].shape[2])
        d = calc_diff(a[0][kept], b[0][kept])
        err = float((a[0][kept].float() - b[0][kept].float()).abs().max())
        ok = d < KERNEL_BAR
        if a[1] is not None:
            rows = (a[1] > -1e19) & (b[1] > -1e19) & kept
            dl = float((a[1][rows] - b[1][rows]).abs().max()) if bool(rows.any()) else 0.0
            ok = ok and dl < LSE_BAR and bool(torch.equal(rows, (b[1] > -1e19) & kept))
        q, k = args[0], args[1]
        shape = f"{tuple(q.shape)} Hk={k.shape[1]} causal={args[3].causal}"
        what = (f"{name} vs plain on {sub[0].shape[1]} q heads of {shape}{note}: calc_diff "
                f"{d:.3e} < {KERNEL_BAR}, max_abs {err:.3e}")
        print(("ok   " if ok else "FAIL ") + what, flush=True)
        if not ok:
            failures.append(what)
            continue
        ms = time_fn(lambda: attention_kernel(*args, **kw), warmup=2, reps=5) * 1e3
        a = attention_kernel(*args, **kw)
        moved = nbytes(*(x for x in args if isinstance(x, torch.Tensor)),
                       *(x for x in kw.values() if isinstance(x, torch.Tensor)),
                       *(x for x in a if x is not None))
        pairs = live_pairs(torch, args, kw)
        bound = attn_bound_pairs(args[3], pairs, q.shape[-1], moved)
        lib = None
        if name.startswith("B4-"):
            lib = library_masked_ms(torch, args, kw)
        entries.append(ext_entry(totals, name, err, ms, plain_ms, bound, lib,
                                 shape + f", {pairs} live pairs; plain on {sub[0].shape[1]} "
                                         "q heads"))
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


def ext_entry(totals, name, err, ms, plain_ms, bound, lib, shape):
    src = SRC_QUANT if name.startswith("A") else SRC_ATTN
    rep = TPU_KERNELS["A6"] if name.startswith("A") else TPU_KERNELS["B"]
    libs = "" if lib is None else f", library {lib:.3f} ms"
    print(f"     {name}: max_abs_err {err:.3e}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bound[0]:.3f} ms ({bound[1]}){libs} at {shape}", flush=True)
    return {"name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": totals.get(name, 0), "max_abs_err": err, "ms": ms,
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
    return ext_entry(totals, "A6-seg", err, ms, plain_ms, bytes_bound(nbytes(k) * 3 // 2), None,
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


# ---------------------------------------------------------------- configs ----

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


def kernel_args(torch, cfg, q, k, v):
    """Kernel inputs for any quantized configuration, built by the port's
    quantizers as ``_sage_attention`` builds them (A1/A2 for B1-B3)."""
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
        q8, qsg = qk.quant_int8_groupwise(q, 4, fold=cfg.sm_scale * tquant.LOG2E)
        qs = tquant.expand_scales_rows(qsg, 4, q8.shape[2])[:, :, :q.shape[2]]
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


def kernel_checks(torch, inputs, short, adv_native, launches):
    from sageattention_tpu_torch.ops import quant_fused as qf
    from sageattention_tpu_torch.ops import quant_kernels as qk
    from sageattention_tpu_torch.ops.attention import attention_kernel, attention_plain
    from sageattention_tpu_torch.utils.testing import calc_diff, time_fn

    def kernel_ms(fk):
        return time_fn(fk, warmup=3, reps=20) * 1e3

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
            ("B4", [(q, k, v, False), (*llama, True)]),
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
            if name == "B4":
                xs, kw = (qq, kk, vv), {}
            else:
                xs, kw = kernel_args(torch, cfg, qq, kk, vv)
            a = attention_kernel(*xs, cfg, **kw)
            b, plain_ms = timed_call(torch, lambda: attention_plain(*xs, cfg, **kw))
            d = calc_diff(a[0], b[0])
            err = float((a[0].float() - b[0].float()).abs().max())
            dl = float((a[1] - b[1]).abs().max())
            ok = d < KERNEL_BAR and dl < LSE_BAR
            if a[2] is not None:
                ok = ok and bool(torch.allclose(a[2], b[2], rtol=1e-4, atol=0))
            check(ok, f"{name} vs plain at {tuple(qq.shape)} Hk={kk.shape[1]} causal={causal}: "
                      f"calc_diff {d:.3e} < {KERNEL_BAR}, max_abs {err:.3e}, lse {dl:.2e}")
            errs.append(err)
            if timed is None:
                ms = kernel_ms(lambda: attention_kernel(*xs, cfg, **kw))
                moved = nbytes(*xs, *kw.values(), *a)
                lib = library_ms(torch, qq, kk, vv, causal) if name == "B4" else None
                timed = (ms, plain_ms, attn_bound(cfg, qq, kk, moved), lib,
                         f"{tuple(qq.shape)} Hk={kk.shape[1]} causal={causal}")
        entry(name, SRC_ATTN, TPU_KERNELS["B"], max(errs), *timed)
    return entries


def library_ms(torch, q, k, v, causal):
    """``F.scaled_dot_product_attention`` on its flash backend, bf16: the one
    PyTorch call that computes what B4 computes (timed here, never called
    by the port)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from sageattention_tpu_torch.utils.testing import time_fn
    if k.shape[1] != q.shape[1]:
        G = q.shape[1] // k.shape[1]
        k, v = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return time_fn(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal), warmup=3, reps=20) * 1e3


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke failed: {e}", file=sys.stderr)
        sys.exit(1)
