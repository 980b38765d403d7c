"""The port's dense int8 KV cache and decode (B11's plain version) against the
JAX package's ``decode.py`` run in interpret mode, on the same numpy inputs.

Bars: ``tests/test_decode.py``'s, 1.5e-3 calc_diff against the f32 oracle
(2.5e-3 for an e4m3 V cache), and the same bar between the two packages: a
quantized P is rounded against the running max of its kv tile, and the two
walk different tiles (JAX 2048-wide blocks, the port 64-wide tiles in its
own KV splits).  The port's plain version is held tightly against an exact
softmax over the same codes.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import decode as jdec
from sageattention_tpu.ops.reference import sdpa as jsdpa
from sageattention_tpu.utils.testing import calc_diff
from sageattention_tpu_torch import decode as tdec
from sageattention_tpu_torch.ops import attention as tatt

BAR = 1.5e-3
FP8_BAR = 2.5e-3


def _mk(B=1, Hq=4, Hk=None, S=192, T=1, D=64, seed=0):
    Hk = Hk or Hq
    r = np.random.RandomState(seed)
    return tuple(r.randn(*s).astype(np.float32)
                 for s in ((B, Hq, T, D), (B, Hk, S, D), (B, Hk, S, D)))


def _oracle(q, k, v, T, causal=True):
    G = q.shape[1] // k.shape[1]
    S = k.shape[2]
    mask = None
    if causal:
        mask = jnp.asarray((np.arange(S)[None, :] <= np.arange(S - T, S)[:, None])[None, None])
    return np.asarray(_jit(jsdpa, jnp.asarray(q), jnp.asarray(np.repeat(k, G, 1)),
                           jnp.asarray(np.repeat(v, G, 1)), mask=mask))


def _jit(fn, *args, **static):
    """``fn(*args, **static)`` under ``jax.jit``: the interpret-mode kernels
    compile once instead of running op by op (a few times faster here)."""
    return jax.jit(functools.partial(fn, **static))(*args)


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) else x.float().numpy()


def _caches(k, v, max_len, **kw):
    return (jdec.kv_cache_init(jnp.asarray(k), jnp.asarray(v), max_len, **kw),
            tdec.kv_cache_init(torch.tensor(k), torch.tensor(v), max_len, **kw))


def _same_cache(jc, tc, code_frac=1e-3):
    """Codes equal but for a few off by one (f32 means summed in another
    order); scales and means within 1e-6."""
    for name in ("k8", "v"):
        a, b = _np(getattr(jc, name)), _np(getattr(tc, name))
        assert a.shape == b.shape, name
        if name == "v" and tc.v.dtype == torch.bfloat16:
            np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-6)
            continue
        diff = np.abs(a - b)
        # an e4m3 code one apart may be several units apart
        assert (diff > 0).mean() <= code_frac, name
        if name == "k8" or tc.v.dtype == torch.int8:
            assert diff.max() <= 1, name
    for name in ("k_scale", "v_scale", "v_mean", "k_mean"):
        np.testing.assert_allclose(_np(getattr(jc, name)), _np(getattr(tc, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert int(jc.length) == int(tc.length)


@pytest.mark.parametrize("fmt", ["int8", "fp8", "bf16"])
@pytest.mark.parametrize("smooth", [True, False])
def test_cache_init_and_append_match_jax(fmt, smooth):
    _, k, v = _mk(B=2, Hk=2, S=203, seed=1)
    jc, tc = _caches(k[:, :, :200], v[:, :, :200], 300, v_format=fmt, smooth_k=smooth,
                     smooth_v=smooth)
    assert tc.max_len == 384   # rounded up to 128, as JAX
    _same_cache(jc, tc)
    jc = jdec.kv_cache_append(jc, jnp.asarray(k[:, :, 200:]), jnp.asarray(v[:, :, 200:]))
    tc = tdec.kv_cache_append(tc, torch.tensor(k[:, :, 200:]), torch.tensor(v[:, :, 200:]))
    _same_cache(jc, tc)


CASES = {   # name: (B, Hq, Hk, S, T, fmt, kwargs of sageattn_decode)
    "t1_mha": (2, 3, 3, 200, 1, "int8", {}),
    "t1_gqa_fold": (1, 8, 2, 160, 1, "int8", {}),
    "t4_causal_folded": (1, 4, 2, 140, 4, "int8", {}),
    "t5_causal_unfolded": (1, 8, 1, 140, 5, "int8", {}),    # G*T = 40 rows > 32
    "t4_noncausal_folded": (1, 6, 2, 120, 4, "int8", {"is_causal": False}),
    "t1_fp8": (2, 4, 2, 200, 1, "fp8", {}),
    "t4_fp8": (1, 2, 2, 160, 4, "fp8", {}),
    "t1_bf16": (1, 2, 2, 130, 1, "bf16", {}),
    "bucket": (1, 2, 2, 200, 1, "int8", {"bucket": 256}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_decode_matches_jax_and_oracle(case):
    B, Hq, Hk, S, T, fmt, kw = CASES[case]
    q, k, v = _mk(B, Hq, Hk, S, T, seed=len(case))
    max_len = 2048 if case == "bucket" else 256
    jc, tc = _caches(k, v, max_len, v_format=fmt)
    jo = _np(_jit(jdec.sageattn_decode, jnp.asarray(q), jc, interpret=True, **kw))
    to = tdec.sageattn_decode(torch.tensor(q), tc, **kw)
    assert to.shape == q.shape and to.dtype == torch.bfloat16
    to = _np(to)
    bar = FP8_BAR if fmt == "fp8" else BAR
    ref = _oracle(q, k, v, T, causal=kw.get("is_causal", True) and T > 1)
    assert calc_diff(to, ref) < bar
    assert calc_diff(jo, ref) < bar
    assert calc_diff(to, jo) < bar


def test_nhd_and_bucket_views():
    q, k, v = _mk(1, 2, 2, 130, 1, seed=5)
    tc = tdec.kv_cache_init(torch.tensor(k).transpose(1, 2), torch.tensor(v).transpose(1, 2),
                            max_len=1024, tensor_layout="NHD")
    out = tdec.sageattn_decode(torch.tensor(q).transpose(1, 2), tc, tensor_layout="NHD")
    assert calc_diff(_np(out.transpose(1, 2)), _oracle(q, k, v, 1)) < BAR
    # the kernel's splits follow the live length, not the bucket: the same answer
    b = tdec.decode_bucket(130, block=128)
    assert b == 256
    out_b = tdec.sageattn_decode(torch.tensor(q), tc, bucket=b)
    assert torch.equal(out_b, out.transpose(1, 2))


def test_fold_does_not_change_results():
    """Folding the GQA heads (and a verify window's rows) into one block is
    a tactic: the unfolded call gives the same bits."""
    q, k, v = _mk(2, 8, 2, 300, 3, seed=6)
    tc = tdec.kv_cache_init(torch.tensor(k), torch.tensor(v), 384)
    folded = tdec.sageattn_decode(torch.tensor(q), tc)
    cfg = tatt.AttnConfig(causal=True, causal_dynamic=True, quantized=True, pv_dtype="int8",
                          sm_scale=64 ** -0.5, kv_len=384, kv_len_dynamic=True,
                          fuse_v_mean=True, emit_lse=False, fuse_q_quant=True)
    offsets = torch.stack([tc.length - 3, torch.zeros_like(tc.length)])
    unfolded, _ = tatt.attention_call(torch.tensor(q).bfloat16(), tc.k8, tc.v,
                                      k_scale=tc.k_scale, v_scale=tc.v_scale, v_mean=tc.v_mean,
                                      kv_true_dyn=tc.length, offsets=offsets, cfg=cfg)
    assert torch.equal(folded, unfolded)


def test_fold_decision_and_tiles_match_jax(monkeypatch):
    """A T = 9 verify window of 4 query heads per KV head: JAX folds the 36
    rows (two 32-row tiles per KV head instead of four, one per query head,
    ``decode.py:301``).  The port makes the same decision, runs the folded
    rows in one call whose rows take the same two tiles, and its output
    equals the unfolded call's bit for bit and JAX's at the module's bar."""
    G, T = 4, 9
    for g, t in ((4, 9), (4, 1), (1, 4), (8, 4), (8, 5), (4, 17), (2, 32)):
        assert tdec.fold_heads(g, t) == (g > 1 and (t == 1 or -(-(g * t) // jdec._BQ) < g))
    assert tdec.fold_heads(G, T) and G * T > tatt.DECODE_ROWS
    q, k, v = _mk(1, 8, 2, 300, T, seed=11)
    jc, tc = _caches(k, v, 384)
    rows = []
    real = tatt.decode_plain
    monkeypatch.setattr(tatt, "decode_plain",
                        lambda q_, *a: rows.append(tuple(q_.shape)) or real(q_, *a))
    folded = tdec.sageattn_decode(torch.tensor(q), tc)
    assert rows == [(1, 2, G * T, 64)]   # one call per step: 2 tiles per KV head
    assert -(-rows[0][2] // tatt.DECODE_ROWS) == 2
    cfg = tatt.AttnConfig(causal=True, causal_dynamic=True, quantized=True, pv_dtype="int8",
                          sm_scale=64 ** -0.5, kv_len=384, kv_len_dynamic=True,
                          fuse_v_mean=True, emit_lse=False, fuse_q_quant=True)
    offsets = torch.stack([tc.length - T, torch.zeros_like(tc.length)])
    unfolded, _ = tatt.attention_call(torch.tensor(q).bfloat16(), tc.k8, tc.v,
                                      k_scale=tc.k_scale, v_scale=tc.v_scale, v_mean=tc.v_mean,
                                      kv_true_dyn=tc.length, offsets=offsets, cfg=cfg)
    assert torch.equal(folded, unfolded)
    jo = _np(_jit(jdec.sageattn_decode, jnp.asarray(q), jc, interpret=True))
    ref = _oracle(q, k, v, T)
    assert calc_diff(_np(folded), ref) < BAR
    assert calc_diff(_np(folded), jo) < BAR


@pytest.mark.parametrize("fmt", ["int8", "fp8", "bf16"])
def test_plain_version_matches_exact_softmax_of_codes(fmt):
    """B11's plain version against float64 attention over the same
    quantized operands: the int8 Q codes and row scales, the K codes times
    their per-token scales, and V as codes x scale + mean.  What is left is
    the rounding of P (bf16, e4m3 or int8 against the running max)."""
    q, k, v = _mk(2, 4, 2, 700, 1, seed=7)
    tc = tdec.kv_cache_init(torch.tensor(k), torch.tensor(v), 768, v_format=fmt)
    out = tdec.sageattn_decode(torch.tensor(q), tc).double()
    L = 700
    qf = torch.tensor(q).bfloat16().float() * np.float32(64 ** -0.5 * 1.4426950408889634)
    q8, qs = tatt._row_quant(qf)
    kd = tc.k8[:, :, :L].double() * tc.k_scale[:, :, 0, :L, None].double()
    s = torch.matmul((q8 * qs).double(), kd.repeat_interleave(2, 1).transpose(-1, -2))
    p = torch.softmax(s * np.log(2.0), dim=-1)
    vd = tc.v[:, :, :L].double()
    if fmt != "bf16":
        vd = vd * tc.v_scale.double()
    vd = (vd + tc.v_mean.double()).repeat_interleave(2, 1)
    ref = torch.matmul(p, vd)
    bar = {"bf16": 2e-5, "int8": 2e-4, "fp8": 1e-3}[fmt]
    assert calc_diff(out, ref) < bar


def test_trim_then_append_overwrites_in_place():
    _, k, v = _mk(1, 2, 2, 110, 1, seed=8)
    tc = tdec.kv_cache_init(torch.tensor(k[:, :, :100]), torch.tensor(v[:, :, :100]), 128)
    c1 = tdec.kv_cache_append(tc, torch.tensor(k[:, :, 100:105]), torch.tensor(v[:, :, 100:105]))
    assert int(c1.length) == 105 and int(tc.length) == 100
    old = c1.k8[:, :, 102:105].clone()
    c2 = tdec.kv_cache_trim(c1, 3)
    assert int(c2.length) == 102
    c3 = tdec.kv_cache_append(c2, torch.tensor(k[:, :, 105:108]), torch.tensor(v[:, :, 105:108]))
    assert int(c3.length) == 105
    # the buffers are shared: the cache from before the trim sees the new codes
    assert c1.k8.data_ptr() == c3.k8.data_ptr()
    assert not torch.equal(c1.k8[:, :, 102:105], old)
    jc = jdec.kv_cache_init(jnp.asarray(k[:, :, :100]), jnp.asarray(v[:, :, :100]), 128)
    jc = jdec.kv_cache_append(jc, jnp.asarray(k[:, :, 100:102]), jnp.asarray(v[:, :, 100:102]))
    jc = jdec.kv_cache_append(jc, jnp.asarray(k[:, :, 105:108]), jnp.asarray(v[:, :, 105:108]))
    np.testing.assert_array_equal(_np(jc.k8)[:, :, :105], _np(c3.k8)[:, :, :105])


def test_errors_jax_raises_the_port_raises():
    q, k, v = _mk(Hq=3, S=128)
    for mod, conv in ((jdec, jnp.asarray), (tdec, torch.tensor)):
        kw = {"interpret": True} if mod is jdec else {}
        cache = mod.kv_cache_init(conv(k[:, :2]), conv(v[:, :2]), 256)
        with pytest.raises(ValueError):                       # head mismatch (3 % 2)
            mod.sageattn_decode(conv(q), cache, **kw)
        cache = mod.kv_cache_init(conv(k), conv(v), 256)
        with pytest.raises(ValueError):                       # bucket too large
            mod.sageattn_decode(conv(q), cache, bucket=512, **kw)
        with pytest.raises(ValueError):                       # max_len too small
            mod.kv_cache_init(conv(k), conv(v), 100)
        with pytest.raises(ValueError):                       # k/v shapes differ
            mod.kv_cache_init(conv(k), conv(v[:, :, :64]), 256)
        with pytest.raises(ValueError, match="v_format"):
            mod.kv_cache_init(conv(k), conv(v), 256, v_format="int4")


def test_decode_configuration_routing():
    """The decode fields at prefill sizes are the ring's (B10), which takes a
    pre-quantized Q, so a decode-shaped call past 32 rows raises; a decode
    call names its B11 launch key.  (Folded verify rows, with
    ``causal_row_mod``, may pass 32: the kernel walks them 32 at a time.)"""
    cfg = tatt.AttnConfig(quantized=True, pv_dtype="fp8", fuse_q_quant=True, kv_len_dynamic=True,
                          causal=True, causal_dynamic=True, causal_row_mod=4, kv_split=4)
    assert tatt.config_name(cfg, 4) == "B11-fp8-causal-mod"
    cfg = dataclasses.replace(cfg, causal_row_mod=0)
    q = torch.zeros(1, 2, 33, 64)
    k = torch.zeros(1, 2, 64, 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="B10"):
        tatt.attention_call(q, k, k, k_scale=torch.ones(1, 2, 1, 64), v_scale=torch.ones(1, 2, 1, 64),
                            kv_true_dyn=torch.tensor(64), offsets=torch.tensor([0, 0]),
                            cfg=cfg)
    with pytest.raises(NotImplementedError, match="B11"):
        tatt.config_name(tatt.AttnConfig(quantized=True, kv_len_dynamic=True,
                                         fuse_q_quant=False), 1)
