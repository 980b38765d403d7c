"""The port's attention forward (configurations B1-B6 and the bf16 V)
against the JAX package's ``attention_call`` in interpret mode on the same
inputs.

Bars:
  - port vs JAX, same configuration: calc_diff < 1e-5 (both quantize Q and
    round P at the same points; only summation order differs).  The JAX
    side runs ``fp8_native_dot=False`` (the port's e4m3 PV numerics) and,
    under the online softmax, 64-column inner kv tiles, the port's: an int8
    or e4m3 P is rounded against the running max, so another tile width
    gives other codes;
  - base-2 lse within 5e-3 of JAX's (1.5e-2 for a fused Q under an int8 or
    e4m3 P, see ``_check_against_jax``) and, where P stays bf16, within 1e-5 of
    the float64 logsumexp of the port's own quantized logits: JAX's
    interpret-mode denominators for the int8-Q configurations sit up to
    ~2e-3 (base 2) away from that float64 sum at these sizes, so the JAX bar
    is set above JAX's own error and the exact one holds the port;
  - the minimum row denominator within rtol 1e-2 of JAX's (the same
    denominator error) and 1e-5 of the float64 value;
  - port vs the float64 oracle: tests/test_attention.py's bars (1.5e-3 for
    the int8-P/bf16-P configurations, 5e-3 for e4m3 P at unaligned
    lengths), < 2e-5 for the flash baseline B4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu.ops import attention as jatt
from sageattention_tpu_torch.core import fp8_v
from sageattention_tpu_torch.ops import attention as tatt
from sageattention_tpu_torch.ops import quant as tquant
from sageattention_tpu_torch.ops.quant_fused import prep_k_onepass, prep_v_onepass
from sageattention_tpu_torch.ops.quant_kernels import (channel_stats, quant_int8_fixed,
                                                       quant_int8_groupwise)
from sageattention_tpu_torch.ops.reference import sdpa
from sageattention_tpu_torch.utils.testing import calc_diff

from port_cpu import yield_cpu  # noqa: F401  (one torch thread, low CPU priority)


def _bf16_rand(shape, rng, scale=1.0):
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(torch.bfloat16).float()


def _inputs(Hq, Hk, S, D, seed):
    rng = np.random.default_rng(seed)
    q = _bf16_rand((1, Hq, S, D), rng)
    k = _bf16_rand((1, Hk, S, D), rng)
    k[..., 3] += 2.0
    v = _bf16_rand((1, Hk, S, D), rng)
    return q, k, v


def _quant_args(k, v, Hq):
    k8, km, amax, cap = prep_k_onepass(k, k.shape[2], with_capmax=True)
    v8, vm, vamax = prep_v_onepass(v, v.shape[2])
    ks = torch.where(amax > 0, amax * (1.0 / 127.0), torch.ones_like(amax))
    vs = torch.where(vamax > 0, vamax * (1.0 / 127.0), torch.ones_like(vamax))
    kn = cap.repeat_interleave(Hq // k.shape[1], dim=1)
    return k8, v8, dict(k_head_scale=ks, kn_max=kn, v_scale=vs, v_mean=vm)


def _cfg_fields(name, causal, S, D):
    if name == "B4":
        return dict(causal=causal, quantized=False, sm_scale=D ** -0.5, kv_len=S)
    static = name in ("B1", "B3")
    return dict(causal=causal, quantized=True, pv_dtype="int8", kv_len=S,
                fold_k_scale=True, fuse_q_quant=True, fuse_v_mean=True,
                compute_dtype="bf16" if name.startswith("B3") else "native",
                softmax_mode="static" if static else "online",
                pv_via_bf16=not static, sm_scale=D ** -0.5)


def _pad(x, n):
    return np.pad(np.asarray(x), [(0, 0), (0, 0), (0, n - x.shape[2]), (0, 0)])


def _run_jax(name, causal, q, k8, v8, kw, S, D):
    blk = 128
    Sp = -(-S // blk) * blk
    cfg = jatt.AttnConfig(block_q=blk, block_k=blk, block_k_inner=blk,
                          out_dtype=jnp.float32, emit_lse=True,
                          q_len=S if Sp != S else 0, **_cfg_fields(name, causal, S, D))
    if name == "B4":
        res = jatt.attention_call(jnp.asarray(_pad(q, Sp)), jnp.asarray(_pad(k8, Sp)),
                                  jnp.asarray(_pad(v8, Sp)), cfg=cfg, interpret=True)
    else:
        static = cfg.softmax_mode == "static"
        res = jatt.attention_call(
            jnp.asarray(_pad(q, Sp)), jnp.asarray(_pad(k8, Sp)), jnp.asarray(_pad(v8, Sp)),
            v_scale=jnp.asarray(kw["v_scale"]), v_mean=jnp.asarray(kw["v_mean"]),
            kn_max=jnp.asarray(kw["kn_max"]) if static else None,
            k_head_scale=jnp.asarray(kw["k_head_scale"]), cfg=cfg, interpret=True)
    out = np.asarray(res[0])[:, :, :S]
    lse = np.asarray(res[1])[:, :, :S]
    lmin = float(np.asarray(res[2]).min()) if len(res) == 3 else None
    return out, lse, lmin


def _exact_lse2(name, cfg, q, k, kw):
    """float64 base-2 logsumexp of the logits the port's quantized
    operands define, and (static) the minimum row sum of exp2(s - cap)."""
    qop, qse, cap = tatt._prepare_q(q, cfg, name, kw.get("k_head_scale"), kw.get("kn_max"),
                                    kw.get("q_scale"))
    kf = tatt._per_q_head(k, q.shape[1]).double()
    s = qop.double() @ kf.transpose(-1, -2)
    if qse is not None:
        s = s * qse.double()
    elif name == "B4":
        s = s * tatt._F32(cfg.sm_scale * tatt.LOG2E)
    if kw.get("k_scale") is not None:
        s = s * tatt._per_q_head(kw["k_scale"], q.shape[1]).double()
    if cfg.causal:
        S = q.shape[2]
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -np.inf)
    lse2 = torch.logsumexp(s * np.log(2.0), dim=-1) / np.log(2.0)
    lmin = None if cap is None else float(torch.exp2(lse2 - cap[..., 0].double()).min())
    return lse2.numpy(), lmin


CASES = [
    ("B1", False, 4, 2, 256, 64),
    ("B1", True, 2, 2, 300, 128),
    ("B2", False, 2, 1, 300, 64),
    ("B2", True, 2, 2, 256, 64),
    ("B3", False, 2, 2, 300, 64),
    ("B3", True, 4, 2, 256, 128),
    ("B3-online", False, 2, 2, 256, 64),
    ("B4", False, 2, 2, 300, 64),
    ("B4", True, 2, 1, 256, 128),
]


@pytest.mark.parametrize("name,causal,Hq,Hk,S,D", CASES)
def test_attention_matches_jax(name, causal, Hq, Hk, S, D):
    q, k, v = _inputs(Hq, Hk, S, D, seed=CASES.index((name, causal, Hq, Hk, S, D)))
    cfg = tatt.AttnConfig(out_dtype=torch.float32, emit_lse=True,
                          **_cfg_fields(name, causal, S, D))
    assert tatt.config_name(cfg, S) == name
    if name == "B4":
        kk, vv, kw = k, v, {}
    else:
        kk, vv, kw = _quant_args(k, v, Hq)
        if cfg.softmax_mode == "online":
            kw = {**kw, "kn_max": None}
    res = tatt.attention_call(q, kk, vv, cfg=cfg, **kw)
    j_out, j_lse, j_lmin = _run_jax(name, causal, q, kk, vv,
                                    {**kw, "kn_max": kw.get("kn_max")}, S, D)
    out, lse = res[0], res[1]
    assert out.shape == q.shape and out.dtype == torch.float32
    assert calc_diff(out, j_out) < 1e-5
    np.testing.assert_allclose(lse.numpy(), j_lse, atol=5e-3)
    e_lse, e_lmin = _exact_lse2(name, cfg, q, kk, kw)
    np.testing.assert_allclose(lse.double().numpy(), e_lse, atol=1e-5)
    if j_lmin is not None:
        assert len(res) == 3
        np.testing.assert_allclose(float(res[2].min()), j_lmin, rtol=1e-2)
        np.testing.assert_allclose(float(res[2].min()), e_lmin, rtol=1e-5)
    else:
        assert len(res) == 2
    ref = sdpa(q, k, v, is_causal=causal)
    assert calc_diff(out, ref) < (2e-5 if name == "B4" else 1.5e-3)


# ---- slice 2: int8 / e4m3 P (B5), a pre-quantized Q (B6), bf16 V ----

_PV = {"B5-int8": "int8", "B5-fp8": "fp8", "B5-fp8-fusedq": "fp8", "B6-static": "int8",
       "B6-online": "int8", "B6-bf16c": "int8", "B-pvbf16": "bf16", "B-pvbf16-online": "bf16"}
_BLK = 64   # JAX tiles: the port's online softmax walks 64-column kv tiles


def _cfg2_fields(name, causal, S, D, kscale, mode, fused):
    return dict(causal=causal, quantized=True, pv_dtype=_PV[name], kv_len=S,
                sm_scale=D ** -0.5, fold_k_scale=kscale == "head", softmax_mode=mode,
                compute_dtype="bf16" if name == "B6-bf16c" else "native",
                pv_via_bf16=mode == "online" and name.startswith("B6"),
                fuse_q_quant=fused, fuse_v_mean=_PV[name] != "bf16")


def _args2(cfg, q, k, v):
    """Kernel inputs as ``_sage_attention`` builds them: A5 stats, A6 codes
    (K per head or per 16 rows with ``sub = km``; Q per 4 rows with the
    fold, unless fused), int8 / e4m3 / bf16 V."""
    Hq, S = q.shape[1], q.shape[2]
    km, kamax = channel_stats(k, S)
    kw = {}
    if cfg.fold_k_scale:
        ks = tquant_scale(kamax.amax(dim=3, keepdim=True), 127.0)
        k8, kcap = quant_int8_fixed(k, ks, sub=km, with_capmax=True, s_true=S)
        if cfg.fuse_q_quant:
            kw["k_head_scale"] = ks
    else:
        k8, ksg, kcap = quant_int8_groupwise(k, 16, sub=km, with_capmax=True, s_true=S)
        kw["k_scale"] = tquant.expand_scales_cols(ksg, 16, k8.shape[2])[..., :S]
        k8 = k8[:, :, :S]
    qin = q
    if not cfg.fuse_q_quant:
        q8, qsg = quant_int8_groupwise(q, 4, fold=cfg.sm_scale * tquant.LOG2E)
        qs = tquant.expand_scales_rows(qsg, 4, q8.shape[2])[:, :, :S]
        if cfg.fold_k_scale:
            qs = qs * tatt._per_q_head(ks, Hq)
        qin, kw["q_scale"] = q8[:, :, :S], qs
    if cfg.softmax_mode == "static":
        kw["kn_max"] = kcap.repeat_interleave(Hq // k.shape[1], dim=1)
    if cfg.pv_dtype == "bf16":
        return qin, k8, v, kw
    vm, vamax = channel_stats(v, S)
    if cfg.pv_dtype == "int8":
        vs = tquant_scale(vamax, 127.0)
        return qin, k8, quant_int8_fixed(v, vs, sub=vm), {**kw, "v_scale": vs, "v_mean": vm}
    vs = tquant_scale(vamax, 448.0)
    v8, vm = fp8_v(v, vm, vs)
    return qin, k8, v8, {**kw, "v_scale": vs, "v_mean": vm}


def tquant_scale(amax, qmax):
    return torch.where(amax > 0, amax * np.float32(1.0 / qmax), torch.ones_like(amax))


def _jnp(x):
    if x.dtype == torch.float8_e4m3fn:   # numpy has no e4m3: go through f32 (exact)
        return jnp.asarray(x.float().numpy()).astype(jnp.float8_e4m3fn)
    return jnp.asarray(x.numpy())


def _run_jax2(cfg, q, k, v, kw, S):
    Sp = -(-S // _BLK) * _BLK
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
              if f.name not in ("out_dtype", "block_q", "block_k", "block_k_inner")}
    jcfg = jatt.AttnConfig(**{**fields, "out_dtype": jnp.float32, "block_q": _BLK,
                              "block_k": _BLK, "block_k_inner": _BLK, "fp8_native_dot": False,
                              "q_len": S if Sp != S and cfg.fuse_q_quant else 0})
    pad = lambda x, val=0.0: torch.nn.functional.pad(  # noqa: E731
        x.float() if x.dtype == torch.float8_e4m3fn else x, (0, 0, 0, Sp - S), value=val)
    jkw = {}
    if "q_scale" in kw:
        jkw["q_scale"] = _jnp(pad(kw["q_scale"], 1.0))
    if "k_scale" in kw:
        jkw["k_scale"] = _jnp(torch.nn.functional.pad(kw["k_scale"], (0, Sp - S)))
    for key in ("v_scale", "v_mean", "kn_max", "k_head_scale"):
        if key in kw:
            jkw[key] = _jnp(kw[key])
    vj = _jnp(pad(v))
    if v.dtype == torch.float8_e4m3fn:
        vj = vj.astype(jnp.float8_e4m3fn)
    res = jatt.attention_call(_jnp(pad(q)), _jnp(pad(k)), vj, cfg=jcfg, interpret=True, **jkw)
    lmin = float(np.asarray(res[2]).min()) if len(res) == 3 else None
    return np.asarray(res[0])[:, :, :S], np.asarray(res[1])[:, :, :S], lmin


def _check_against_jax(name, cfg, q, k, v):
    assert tatt.config_name(cfg, q.shape[2]) == name
    xs = _args2(cfg, q, k, v)
    kw = xs[3]
    res = tatt.attention_call(*xs[:3], cfg=cfg, **kw)
    j_out, j_lse, j_lmin = _run_jax2(cfg, *xs, q.shape[2])
    out, lse = res[0], res[1]
    assert out.shape == q.shape and out.dtype == torch.float32
    assert calc_diff(out, j_out) < 1e-5
    # Q quantized inside JAX's jitted interpret kernel moves ~0.06% of the
    # codes by one against the unjitted arithmetic the port follows; under
    # an e4m3 P that moves JAX's lse up to ~9e-3 (base 2, measured)
    lse_bar = 1.5e-2 if cfg.fuse_q_quant and not cfg.p_bf16 else 5e-3
    np.testing.assert_allclose(lse.numpy(), j_lse, atol=lse_bar)
    if cfg.p_bf16:
        e_lse, e_lmin = _exact_lse2(name, cfg, xs[0], xs[1], kw)
        np.testing.assert_allclose(lse.double().numpy(), e_lse, atol=1e-5)
    assert (len(res) == 3) == (j_lmin is not None)
    if j_lmin is not None:
        np.testing.assert_allclose(float(res[2].min()), j_lmin, rtol=1e-2)
        np.testing.assert_allclose(float(res[2].min()), e_lmin, rtol=1e-5)
    bar = 5e-3 if cfg.pv_dtype == "fp8" else 1.5e-3
    assert calc_diff(out, sdpa(q, k, v, is_causal=cfg.causal)) < bar


CASES2 = [
    ("B5-int8", False, 4, 2, 300, 64, "fine", "online", False),
    ("B5-int8", True, 2, 2, 256, 128, "head", "online", False),
    ("B5-fp8", False, 2, 1, 333, 64, "fine", "online", False),
    ("B5-fp8", True, 4, 2, 256, 128, "fine", "online", False),
    ("B5-fp8-fusedq", False, 2, 2, 300, 64, "head", "online", True),
    ("B5-fp8-fusedq", True, 2, 1, 256, 128, "head", "online", True),
    ("B6-static", False, 4, 2, 300, 64, "fine", "static", False),
    ("B6-static", True, 2, 2, 256, 128, "head", "static", False),
    ("B6-online", False, 2, 1, 300, 128, "fine", "online", False),
    ("B6-online", True, 2, 2, 256, 64, "head", "online", False),
    ("B6-bf16c", False, 4, 2, 300, 64, "head", "static", False),
    ("B6-bf16c", True, 2, 2, 256, 128, "head", "online", False),
    ("B-pvbf16", False, 2, 2, 300, 64, "fine", "static", False),
    ("B-pvbf16", True, 4, 2, 256, 128, "head", "static", True),
    ("B-pvbf16-online", False, 2, 1, 300, 64, "fine", "online", False),
]


@pytest.mark.parametrize("name,causal,Hq,Hk,S,D,kscale,mode,fused", CASES2)
def test_slice2_attention_matches_jax(name, causal, Hq, Hk, S, D, kscale, mode, fused):
    q, k, v = _inputs(Hq, Hk, S, D, seed=100 + CASES2.index(
        (name, causal, Hq, Hk, S, D, kscale, mode, fused)))
    cfg = tatt.AttnConfig(out_dtype=torch.float32, emit_lse=True,
                          **_cfg2_fields(name, causal, S, D, kscale, mode, fused))
    _check_against_jax(name, cfg, q, k, v)


# Options that raised before this slice: each now runs, from the B2
# configuration, and matches JAX (the fix-ups make the configuration whole:
# an e4m3 V needs the e4m3 P, per-column K scales a pre-quantized Q).
SLICE2_OPTIONS = [
    ("pv_dtype", "fp8", dict(pv_via_bf16=False), "B5-fp8-fusedq"),
    ("pv_dtype", "bf16", dict(fuse_v_mean=False), "B-pvbf16-online"),
    ("fold_k_scale", False, dict(fuse_q_quant=False), "B6-online"),
    ("fuse_q_quant", False, {}, "B6-online"),
    ("pv_via_bf16", False, {}, "B5-int8"),
]


@pytest.mark.parametrize("field,value,fixups,name", SLICE2_OPTIONS,
                         ids=[f"{o[0]}-{o[1]}" for o in SLICE2_OPTIONS])
def test_slice2_options_run_and_match_jax(field, value, fixups, name):
    q, k, v = _inputs(2, 1, 200, 64, seed=7)
    base = tatt.AttnConfig(out_dtype=torch.float32, emit_lse=True,
                           **_cfg_fields("B2", False, 200, 64))
    _check_against_jax(name, dataclasses.replace(base, **{field: value, **fixups}), q, k, v)


@pytest.mark.parametrize("field,value", [
    ("masked", "bool"), ("segmented", True), ("window", 16), ("sinks", 4),
    ("causal_dynamic", True), ("kv_len_dynamic", True), ("kv_split", 2),
    ("causal_row_mod", 4), ("fuse_k_rows", True), ("p_sim_fp4", True),
])
def test_configs_outside_the_slice_raise(field, value):
    """Options of later slices raise NotImplementedError.  Those of slice 3
    (B7-B9) name their launch key, or raise ValueError where the B2 base
    cannot take them (a window needs causal, sinks need a window); so does
    p_sim_fp4, which runs on the flash base only (B4-fp4)."""
    slice3 = {"masked": "B2-bool", "segmented": "B2-seg", "fuse_k_rows": "B2-rowk",
              "window": ValueError, "sinks": ValueError, "p_sim_fp4": ValueError}
    base = tatt.AttnConfig(**_cfg_fields("B2", False, 128, 64))
    cfg = dataclasses.replace(base, **{field: value})
    expected = slice3.get(field, NotImplementedError)
    if isinstance(expected, str):
        assert tatt.config_name(cfg, 1) == expected
        return
    with pytest.raises(expected):   # a decode-sized call: B11 takes no B2 base
        tatt.config_name(cfg, 1)


@pytest.mark.parametrize("fields", [
    dict(pv_dtype="fp8"),                                 # e4m3 V under a bf16 P
    dict(pv_dtype="fp8", pv_via_bf16=False, softmax_mode="static"),
    dict(fold_k_scale=False, fuse_k_rows=True),           # per-row K scales need the fold
    dict(compute_dtype="bf16", fold_k_scale=False, fuse_q_quant=False),
])
def test_incoherent_configs_raise(fields):
    base = tatt.AttnConfig(**_cfg_fields("B2", False, 128, 64))
    with pytest.raises((ValueError, NotImplementedError)):
        tatt.config_name(dataclasses.replace(base, **fields), 128)


def test_attention_call_rejects_inputs_outside_the_slice():
    q, k, v = _inputs(2, 2, 128, 64, seed=5)
    cfg = tatt.AttnConfig(**_cfg_fields("B4", False, 128, 64))
    with pytest.raises(ValueError, match="offsets"):   # offsets need causal_dynamic (B10)
        tatt.attention_call(q, k, v, offsets=torch.zeros(2, dtype=torch.int32), cfg=cfg)
    with pytest.raises(ValueError):   # a mask needs cfg.masked
        tatt.attention_call(q, k, v, attn_mask=torch.ones(1, 1, 128, 128), cfg=cfg)
    with pytest.raises(ValueError):
        tatt.attention_call(q, k[:, :, :64], v, cfg=cfg)


def test_static_lmin_flags_underflow():
    """The minimum row denominator is O(1) for normal data and underflows
    for x60 data, where the Cauchy-Schwarz cap overshoots every logit."""
    mins = []
    for scale in (1.0, 60.0):
        q, k, v = (x * scale for x in _inputs(2, 2, 256, 64, seed=9))
        k8, v8, kw = _quant_args(k, v, 2)
        cfg = tatt.AttnConfig(**_cfg_fields("B1", False, 256, 64))
        mins.append(float(tatt.attention_call(q, k8, v8, cfg=cfg, **kw)[2].min()))
    assert mins[0] >= 2.0 ** -100 > mins[1]

