"""Sliding-window attention with sinks in the port (B9): ``sageattn``,
``flash_attention``, ``attention_call`` and ``sage_dot_product_attention``
against the JAX package in interpret mode on the same numpy-seeded inputs.

Bars:
  - port vs JAX, same pinned modes and 64-wide tiles: calc_diff < 1e-5;
  - port vs the float64 band oracle: < 1e-3 for the quantized modes
    (``tests/test_sliding_window.py``), 5e-3 for e4m3 P, < 2e-5 for flash;
  - a window of at least S equals plain causal attention exactly, in both
    the plain and the windowed configuration;
  - the base-2 lse of the flash configuration within 1e-5 of JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu.core import _sage_attention as jax_sage
from sageattention_tpu.core import flash_attention as jax_flash
from sageattention_tpu.models.integration import sage_dot_product_attention as jax_sdpa
from sageattention_tpu.ops import attention as jatt
from sageattention_tpu_torch import core as tcore
from sageattention_tpu_torch import flash_attention
from sageattention_tpu_torch.models import sage_dot_product_attention
from sageattention_tpu_torch.ops import attention as tatt
from sageattention_tpu_torch.utils.testing import calc_diff

ORACLE_BAR = {"int8": 1e-3, "bf16": 1e-3, "fp8": 5e-3}
JAX_BAR = 1e-5


def qkv(Hq, Hk, S, D, seed):
    rng = np.random.default_rng(seed)
    xs = [torch.from_numpy(rng.standard_normal((1, h, S, D)).astype(np.float32))
          .to(torch.bfloat16).float() for h in (Hq, Hk, Hk)]
    xs[1][..., 5] += 2.0
    return xs


def band_oracle(q, k, v, window, sinks=0, sm_scale=None):
    """float64 causal attention over [r - window + 1, r] plus keys < sinks."""
    q, k, v = (x.double() for x in (q, k, v))
    G = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    S = q.shape[2]
    r = torch.arange(S)[:, None]
    c = torch.arange(S)[None, :]
    keep = (c <= r) & ((c >= r - window + 1) | (c < sinks))
    s = q @ k.transpose(-1, -2) * (sm_scale or q.shape[-1] ** -0.5)
    return torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1) @ v


def run_jax(q, k, v, **kw):
    res = jax_sage(*(jnp.asarray(x.numpy()) for x in (q, k, v)), use_fused=True,
                   interpret=True, **kw)
    return np.asarray(res[0] if isinstance(res, tuple) else res)


PINNED = dict(qk_quant_gran="per_thread", k_scale_mode="head", compute_dtype="native",
              block_q=64, block_k=64, is_causal=True)
# pv, S, window, sinks: window >= S, window 1, sinks spanning two tiles,
# unaligned S, and a window inside a tile
CASES = [("int8", 200, 256, 0), ("int8", 200, 1, 0), ("int8", 333, 100, 70),
         ("int8", 256, 64, 4), ("fp8", 333, 90, 70), ("fp8", 200, 1, 0),
         ("bf16", 256, 40, 4)]


@pytest.mark.parametrize("pv,S,window,sinks", CASES)
def test_sageattn_window_matches_jax(pv, S, window, sinks):
    q, k, v = qkv(4, 2, S, 64, seed=S + window)
    kw = dict(PINNED, pv_dtype=pv, smooth_v=pv != "bf16", sliding_window=window,
              attention_sinks=sinks)
    out = tcore._sage_attention(q, k, v, **kw)
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    assert calc_diff(out, run_jax(q, k, v, **kw)) < JAX_BAR
    assert calc_diff(out, band_oracle(q, k, v, window, sinks)) < ORACLE_BAR[pv]


def test_window_of_the_whole_sequence_is_causal(monkeypatch):
    """A window over the whole sequence, with or without sinks, equals the
    causal call bit for bit.  The windowed flash (B4-window) walks 64-column
    kv tiles and the unmasked one ``flash_kv_tile(D)``; its bf16 P rounds
    per tile, so the causal reference walks the windowed kernel's tiles and
    only the window can make a difference."""
    monkeypatch.setattr(tatt, "flash_kv_tile", lambda D: tatt.KV_TILE)
    q, k, v = qkv(2, 2, 200, 64, seed=3)
    for fn in (tcore.sageattn, flash_attention):
        causal = fn(q, k, v, is_causal=True)
        for window, sinks in ((200, 0), (1000, 0), (200, 50)):
            assert torch.equal(fn(q, k, v, is_causal=True, sliding_window=window,
                                  attention_sinks=sinks), causal)


@pytest.mark.parametrize("S,window,sinks", [(333, 100, 70), (256, 1, 0), (200, 256, 0),
                                            (300, 128, 16)])
def test_flash_window_matches_jax_and_oracle(S, window, sinks):
    q, k, v = qkv(2, 1, S, 128, seed=S)
    out, lse = flash_attention(q, k, v, is_causal=True, sliding_window=window,
                               attention_sinks=sinks, return_lse=True)
    jo, jl = jax_flash(*(jnp.asarray(x.numpy()) for x in (q, k, v)), is_causal=True,
                       sliding_window=window, attention_sinks=sinks, return_lse=True,
                       interpret=True)
    assert calc_diff(out, np.asarray(jo)) < JAX_BAR
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    assert calc_diff(out, band_oracle(q, k, v, window, sinks)) < 2e-5


@pytest.mark.parametrize("quantized", [False, True])
def test_attention_call_window_matches_jax(quantized):
    """B4-window and B2-window through ``attention_call`` at 64-wide tiles,
    with the base-2 lse."""
    from sageattention_tpu_torch.ops.quant_fused import prep_k_onepass, prep_v_onepass
    S = 256
    q, k, v = qkv(2, 2, S, 64, seed=17)
    fields = dict(block_q=64, block_k=64, causal=True, out_dtype=torch.float32,
                  emit_lse=True, sm_scale=0.125, kv_len=S, window=80, sinks=8,
                  quantized=quantized)
    kw = {}
    if quantized:
        fields.update(pv_dtype="int8", fold_k_scale=True, softmax_mode="online",
                      pv_via_bf16=True, fuse_v_mean=True, fuse_q_quant=True)
        k, km, amax, _ = prep_k_onepass(k, S, with_capmax=True)
        v, vm, vamax = prep_v_onepass(v, S)
        kw = dict(k_head_scale=torch.where(amax > 0, amax / 127.0, 1.0),
                  v_scale=torch.where(vamax > 0, vamax / 127.0, 1.0), v_mean=vm)
    cfg = tatt.AttnConfig(**fields)
    assert tatt.config_name(cfg, S) == ("B2-window" if quantized else "B4-window")
    out, lse = tatt.attention_call(q, k, v, cfg=cfg, **kw)[:2]
    jo, jl = jatt.attention_call(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)),
        cfg=jatt.AttnConfig(**{**fields, "out_dtype": jnp.float32}), interpret=True,
        **{a: jnp.asarray(b.numpy()) for a, b in kw.items()})[:2]
    assert calc_diff(out, np.asarray(jo)) < JAX_BAR
    # JAX's interpret-mode denominators sit up to ~2e-3 (base 2) off for a
    # fused int8 Q (ROADMAP queue 3); flash agrees to float rounding
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=5e-3 if quantized else 1e-5,
                               rtol=0)


def test_sage_dot_product_attention_local_window_matches_jax():
    """``local_window_size=(left, 0)`` with ``is_causal`` is the window
    ``left + 1``; JAX's interpret-mode NHD path quantizes Q before the
    kernel, so the port is asked for the same."""
    q, k, v = (x.transpose(1, 2).contiguous() for x in qkv(2, 2, 160, 64, seed=23))
    out = sage_dot_product_attention(q, k, v, is_causal=True, local_window_size=(47, 0),
                                     fuse_q_quant=False)
    jo = jax_sdpa(*(jnp.asarray(x.numpy()) for x in (q, k, v)), is_causal=True,
                  local_window_size=(47, 0), pv_dtype="int8", compute_dtype="native",
                  k_scale_mode="head", qk_quant_gran="per_thread", use_fused=True,
                  interpret=True)
    assert calc_diff(out, np.asarray(jo)) < JAX_BAR
    ref = band_oracle(*(x.transpose(1, 2) for x in (q, k, v)), 48).transpose(1, 2)
    assert calc_diff(out, ref) < 1e-3


@pytest.mark.parametrize("kwargs", [dict(sliding_window=16),
                                    dict(is_causal=True, attention_sinks=4),
                                    dict(is_causal=True, sliding_window=16,
                                         attn_mask=torch.ones(1, 1, 64, 64, dtype=torch.bool))])
def test_window_arguments_are_checked(kwargs):
    q, k, v = qkv(2, 2, 64, 64, seed=29)
    with pytest.raises(ValueError):
        tcore.sageattn(q, k, v, **kwargs)
    if "attn_mask" not in kwargs:
        with pytest.raises(ValueError):
            flash_attention(q, k, v, **kwargs)
