"""B4, the unmasked bf16 flash forward, on its Hopper route
(``csrc/flash_sm90.cu``): the plain version at the kernel's kv tiles
(``flash_kv_tile``: 128 columns at head dims 64 and 128, 64 at 256) against
the JAX package's ``flash_attention`` (Pallas, interpret mode, under
``jax.jit``) and the float64 oracle; which configurations the route takes;
and how far the tile width moves the result.

Inputs are bf16-exact float32 from a numpy seed, so the oracle sees the
values the kernel rounds to.  Bars: port vs the oracle calc_diff < 2e-5
(tests/test_attention.py's flash bar, ``chip_smoke.ORACLE_BAR``), port vs
JAX < 1e-5 (tests/test_torch_core.py's bar: JAX walks its own kv blocks, so
P rounds against other running maxima); natural-log lse within 1e-4 of JAX
and 0.02 of the oracle, as the existing flash tests hold it.
"""

import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sageattention_tpu as jsa
import sageattention_tpu_torch as tsa
from sageattention_tpu_torch.ops import _build
from sageattention_tpu_torch.ops import attention as tatt
from sageattention_tpu_torch.ops.reference import sdpa
from sageattention_tpu_torch.utils.testing import calc_diff

from port_cpu import yield_cpu  # noqa: F401  (one torch thread, low CPU priority)

ORACLE_BAR = 2e-5
JAX_BAR = 1e-5
LSE_JAX_ATOL = 1e-4
LSE_ORACLE_ATOL = 0.02


def _bf16_exact(shape, rng, scale=1.0):
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(torch.bfloat16).float()


def _inputs(B, Hq, Hk, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    q = _bf16_exact((B, Hq, Sq, D), rng)
    k = _bf16_exact((B, Hk, Sk, D), rng)
    k[..., 3] += 2.0   # a biased channel: rows with a clear maximum
    v = _bf16_exact((B, Hk, Sk, D), rng)
    return q, k, v


@functools.lru_cache(maxsize=None)
def _jax_flash(causal, layout):
    return jax.jit(functools.partial(jsa.flash_attention, is_causal=causal, return_lse=True,
                                     tensor_layout=layout, interpret=True))


def _nhd(x):
    return x.transpose(1, 2)


# (B, Hq, Hk, Sq, Sk, D, causal, layout): every length is off the kernel's
# 128-row q tile and its kv tile
CASES = [
    (1, 4, 1, 200, 200, 64, False, "HND"),    # GQA 4:1
    (1, 2, 2, 100, 100, 64, True, "NHD"),
    (1, 8, 1, 300, 300, 128, True, "NHD"),    # GQA 8:1, causal, NHD storage
    (1, 4, 2, 130, 500, 128, False, "HND"),   # Sq != Sk
    (2, 2, 2, 77, 333, 256, False, "HND"),    # B = 2, Sq != Sk
    (1, 2, 1, 257, 257, 256, True, "NHD"),
]


@pytest.mark.parametrize("B,Hq,Hk,Sq,Sk,D,causal,layout", CASES)
def test_flash_matches_jax_and_oracle(B, Hq, Hk, Sq, Sk, D, causal, layout):
    q, k, v = _inputs(B, Hq, Hk, Sq, Sk, D, seed=Sq + Sk + D)
    view = _nhd if layout == "NHD" else (lambda x: x)
    out, lse = tsa.flash_attention(*(view(x) for x in (q, k, v)), tensor_layout=layout,
                                   is_causal=causal, return_lse=True)
    out = view(out)   # back to HND
    j_out, j_lse = _jax_flash(causal, layout)(*(jnp.asarray(view(x).numpy()) for x in (q, k, v)))
    j_out = np.asarray(j_out.astype(jnp.float32))
    if layout == "NHD":
        j_out = j_out.transpose(0, 2, 1, 3)
    ref, ref_lse = sdpa(q, k, v, is_causal=causal, return_lse=True)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert calc_diff(out, ref) < ORACLE_BAR
    assert calc_diff(out, j_out) < JAX_BAR
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=LSE_JAX_ATOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=LSE_ORACLE_ATOL)


@pytest.mark.parametrize("D,kv_len", [(64, 150), (128, 129), (256, 65)])
def test_kv_len_below_sk(D, kv_len):
    """``kv_len < Sk`` masks the kv tail: the same as JAX's flash and the
    oracle over the first ``kv_len`` keys."""
    q, k, v = _inputs(1, 4, 2, 190, 300, D, seed=D + kv_len)
    cfg = tatt.AttnConfig(quantized=False, sm_scale=D ** -0.5, kv_len=kv_len)
    out, lse_b2 = tatt.attention_call(q.bfloat16(), k.bfloat16(), v.bfloat16(), cfg=cfg)
    kk, vv = k[:, :, :kv_len], v[:, :, :kv_len]
    j_out, j_lse = _jax_flash(False, "HND")(*(jnp.asarray(x.numpy()) for x in (q, kk, vv)))
    ref, ref_lse = sdpa(q, kk, vv, return_lse=True)
    assert calc_diff(out, ref) < ORACLE_BAR
    assert calc_diff(out, np.asarray(j_out.astype(jnp.float32))) < JAX_BAR
    lse = lse_b2 * np.log(2.0)   # base 2 -> natural log
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=LSE_JAX_ATOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=LSE_ORACLE_ATOL)


# the bf16 P of a tile is exp2(s - m) rounded to nearest, a relative error
# of at most 2^-9; with l summing the unrounded P, each width's output is
# within 2^-9 * max|v| of the exact one, so two widths differ by at most
# 2^-8 * max|v| per element (f32 sums add ~1e-6).  The lse is m + log2(l)
# of the unrounded P, the same number under either width up to f32 rounding.
TILE_BOUND = 2.0 ** -8
TILE_LSE_ATOL = 1e-5


@pytest.mark.parametrize("D,causal", [(64, False), (128, True), (256, False)])
def test_tile_width_moves_only_the_bf16_rounding(monkeypatch, D, causal):
    q, k, v = (x.bfloat16() for x in _inputs(1, 2, 2, 260, 260, D, seed=7 * D))
    cfg = tatt.AttnConfig(quantized=False, causal=causal, sm_scale=D ** -0.5)
    out, lse = tatt.attention_call(q, k, v, cfg=cfg)
    monkeypatch.setattr(tatt, "flash_kv_tile", lambda D: tatt.KV_TILE)
    out64, lse64 = tatt.attention_call(q, k, v, cfg=cfg)
    bound = TILE_BOUND * float(v.float().abs().max()) + 1e-5
    assert float((out.float() - out64.float()).abs().max()) <= bound
    assert float((lse - lse64).abs().max()) <= TILE_LSE_ATOL


def _route_configs():
    """Every configuration the launch keys come from, as ``_launch_keys``
    walks them, and the flash ones with each option."""
    for quantized, pv, cd, sm, fqq, fold, masked, seg, window in itertools.product(
            (True, False), ("int8", "fp8", "bf16"), ("native", "bf16"), ("static", "online"),
            (True, False), (True, False), ("none", "bool", "float"), (False, True), (0, 1)):
        yield tatt.AttnConfig(causal=True, quantized=quantized, pv_dtype=pv, compute_dtype=cd,
                              softmax_mode=sm, fuse_q_quant=fqq, fold_k_scale=fold,
                              masked=masked, segmented=seg, window=window)
    flash = tatt.AttnConfig(quantized=False)
    yield flash
    yield dataclasses.replace(flash, p_sim_fp4=True)
    yield dataclasses.replace(flash, causal=True, window=64, sinks=4)


def test_route_takes_exactly_the_unmasked_flash():
    """``flash_sm90_route`` is a function of the configuration, the rows and
    the head dim: it takes exactly the configurations whose launch key is
    ``B4`` (no mask, bias, window or segments) or ``B4-fp4`` (the same with
    e2m1 rounding) at every head dim, and ``B4-float`` (a float bias alone)
    at head dims 64 and 128; none of B4-bool/-window/-seg, the quantized
    ones or the ring's."""
    seen = set()
    for cfg in _route_configs():
        try:
            name = tatt.config_name(cfg, 512)
        except ValueError:
            continue
        seen.add(name)
        for D in (64, 128, 256):
            assert tatt.flash_sm90_route(cfg, 512, D) == (
                name in ("B4", "B4-fp4") or (name == "B4-float" and D <= 128)), (name, D)
    assert {"B4", "B4-bool", "B4-float", "B4-window", "B4-fp4", "B1", "B5-fp8"} <= seen
    # the ring's dynamic lengths and offsets never take it
    ring = tatt.AttnConfig(quantized=False, causal=True, causal_dynamic=True,
                           kv_len_dynamic=True)
    assert not tatt.flash_sm90_route(ring, 512, 128)
    assert [tatt.flash_kv_tile(D) for D in (64, 128, 256)] == [128, 128, 64]


@pytest.mark.parametrize("cfg_kw,entry", [
    (dict(), "sage_flash_fwd"),
    (dict(causal=True), "sage_flash_fwd"),
    (dict(masked="bool"), "sage_attn_fwd_ext"),
    (dict(masked="float"), "sage_flash_fwd"),
    (dict(causal=True, window=64, sinks=2), "sage_attn_fwd_ext"),
    (dict(p_sim_fp4=True), "sage_flash_fwd"),
])
def test_kernel_entry_per_configuration(monkeypatch, cfg_kw, entry):
    """``attention_kernel`` launches B4, B4-fp4 and, at this head dim,
    B4-float through the new entry and the bool-masked and windowed forms
    through the old builds, under the same launch key family; the launch is
    recorded instead of run (no card here)."""
    calls = []
    monkeypatch.setattr(_build, "call", lambda fn, device, *args: calls.append((fn, args)))
    D, S = 128, 192
    q, k, v = (x.bfloat16() for x in _inputs(1, 4, 2, S, S, D, seed=3))
    cfg = tatt.AttnConfig(quantized=False, sm_scale=D ** -0.5, **cfg_kw)
    mask = None
    if cfg.masked == "bool":
        mask = torch.ones((1, 1, S, S), dtype=torch.bool)
    elif cfg.masked == "float":
        mask = torch.zeros((1, 1, S, S))
    name = tatt.config_name(cfg, S)
    before = tatt.attention_call.launches[name]
    tatt.attention_kernel(q, k, v, cfg, attn_mask=mask)
    assert [fn for fn, _ in calls] == [entry]
    assert tatt.attention_call.launches[name] == before + 1
    if entry == "sage_flash_fwd":
        args = calls[0][1]
        # head dim, the plain version's tile (64 with a bias or FP4), the mode
        narrow = mask is not None or cfg.p_sim_fp4
        assert args[:3] == (D, tatt.KV_TILE if narrow else tatt.flash_kv_tile(D),
                            2 if cfg.p_sim_fp4 else 0)
        assert args[-8:-1] == (1, 4, 2, S, S, S, int(cfg.causal))   # B .. causal
