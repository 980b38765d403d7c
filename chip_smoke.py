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
6. small inputs of every entry against the float32 oracle.

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
        kernels = run(torch, st)
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
    qk.quant_int8_groupwise.launches = 0
    for d in (qk.quant_int8_fixed.launches, att.launches):
        for name in d:
            d[name] = 0


def read_counts():
    pk, pv, qk, att = counters()
    return {"A1": pk.launches, "A2": pv.launches, "A5": qk.channel_stats.launches,
            "A6-group": qk.quant_int8_groupwise.launches,
            "A6-scalar": qk.quant_int8_fixed.launches["scalar"],
            "A6-channel": qk.quant_int8_fixed.launches["channel"], **att.launches}


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
    print(f"main-path launches: {launches}", flush=True)

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
    return kernels


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
    qk = "bf16" if (not cfg.quantized or cfg.compute_dtype == "bf16") else "int8"
    pv = "bf16" if (not cfg.quantized or cfg.p_bf16) else cfg.pv_dtype
    tc = 2 * pairs * D / TC_OPS_S[qk] + 2 * pairs * D / TC_OPS_S[pv]
    ops = max(tc, pairs / EX2_S)
    by = moved_bytes / HBM_BYTES_S
    return max(ops, by) * 1e3, "operations" if ops >= by else "bytes"


def time_once(torch, fn):
    """ms of one call (the plain versions take seconds: one timed call after
    the comparison call that warmed them)."""
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e)


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
            b = attention_plain(*xs, cfg, **kw)
            torch.cuda.synchronize()
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
            b = attention_plain(*xs, cfg, **kw)
            torch.cuda.synchronize()
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
                plain_ms = time_once(torch, lambda: attention_plain(*xs, cfg, **kw))
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
