"""User masks in the port (B7): bool keep-masks and float biases through
``sageattn``, ``attention_call`` and ``sage_dot_product_attention``, against
the JAX package run in interpret mode on the same numpy-seeded inputs.

Bars:
  - port vs JAX, same pinned modes: calc_diff < 1e-5.  Explicit
    ``block_q=block_k=64`` keeps native compute at these lengths and pins
    JAX's kv tiles to the port's (an int8 or e4m3 P depends on them);
  - port vs the float64 masked oracle: < 1e-3 (``tests/test_mask_grad.py``),
    5e-3 for e4m3 P (the fp8 bar of ``tests/test_torch_modes.py``), < 2e-5
    for the bf16 flash configuration;
  - rows with no live key give exactly what JAX gives (its online rerun
    after the post-hoc check reads l = 0: zero, plus the V mean with
    smoothing);
  - the tile liveness table equals the JAX kernel's ``minfo`` expression at
    64-wide blocks.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu.core import _sage_attention as jax_sage
from sageattention_tpu.models.integration import sage_dot_product_attention as jax_sdpa
from sageattention_tpu.ops import attention as jatt
from sageattention_tpu_torch import core as tcore
from sageattention_tpu_torch.models import sage_dot_product_attention
from sageattention_tpu_torch.ops import attention as tatt
from sageattention_tpu_torch.utils.testing import calc_diff

ORACLE_BAR = {"int8": 1e-3, "bf16": 1e-3, "fp8": 5e-3}
JAX_BAR = 1e-5


def qkv(Hq, Hk, S, D, seed):
    rng = np.random.default_rng(seed)
    xs = [torch.from_numpy(rng.standard_normal((1, h, S, D)).astype(np.float32))
          .to(torch.bfloat16).float() for h in (Hq, Hk, Hk)]
    xs[1][..., 5] += 2.0   # a biased K channel, as smooth_k expects
    return xs


def make_mask(kind, Hm, S, seed, causal=False, dead_rows=()):
    """A bool keep-mask with some dead 64x64 tiles and rows, or a float
    bias (natural-log units) with an ALiBi-like slope."""
    rng = np.random.default_rng(seed)
    if kind == "bool":
        m = rng.random((1, Hm, S, S)) > 0.35
        m[:, :, 64:128, :] = False              # dead tiles
        m[:, :, :, 128:192] = False
        for r in dead_rows:
            m[:, :, r, :] = False                # rows with no live key
        if causal:
            m |= np.eye(S, dtype=bool)[None, None]   # each row keeps its diagonal
            for r in dead_rows:
                m[:, :, r, :] = False
        return torch.from_numpy(m)
    slope = np.arange(1, Hm + 1, dtype=np.float32)[None, :, None, None] * 0.05
    pos = np.arange(S, dtype=np.float32)
    b = -slope * np.abs(pos[:, None] - pos[None, :]) + rng.standard_normal((1, Hm, S, S)) * 0.3
    return torch.from_numpy(b.astype(np.float32))


def masked_oracle(q, k, v, mask=None, causal=False, sm_scale=None):
    """float64 attention with a keep-mask or an additive bias; rows with no
    live key come back as NaN (excluded by the callers)."""
    q, k, v = (x.double() for x in (q, k, v))
    G = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    S, Sk = q.shape[2], k.shape[2]
    s = q @ k.transpose(-1, -2) * (sm_scale or q.shape[-1] ** -0.5)
    keep = torch.ones(S, Sk, dtype=torch.bool)
    if causal:
        keep = torch.tril(keep)
    keep = keep[None, None].expand_as(s).clone()
    if mask is not None and mask.dtype == torch.bool:
        keep &= mask
    elif mask is not None:
        s = s + mask.double()
    s = s.masked_fill(~keep, float("-inf"))
    return torch.softmax(s, dim=-1) @ v


def live_rows(mask, causal, S):
    if mask is None or mask.dtype != torch.bool:
        return torch.ones(S, dtype=torch.bool)
    m = mask.clone()
    if causal:
        m &= torch.tril(torch.ones(S, S, dtype=torch.bool))
    return m.any(dim=-1).all(dim=(0, 1))


def run_jax(q, k, v, mask, **kw):
    res = jax_sage(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                   attn_mask=jnp.asarray(mask.numpy()), use_fused=True, interpret=True, **kw)
    return np.asarray(res[0] if isinstance(res, tuple) else res)


# pv, mask kind, per-head mask, causal, extra pinned arguments
CASES = [
    ("int8", "bool", True, False, dict(block_q=64, block_k=64)),        # B1-bool
    ("int8", "bool", False, True, dict(block_q=64, block_k=64)),        # B1-bool causal
    ("int8", "float", False, False, dict(block_q=64, block_k=64)),      # auto: online int8 P
    ("int8", "float", True, True, dict(block_q=64, block_k=64, softmax_mode="static")),
    ("int8", "bool", False, False, dict()),                             # bf16 compute: B3-bool
    ("int8", "float", True, True, dict()),                              # B3-online-float
    ("int8", "bool", True, True, dict(block_q=64, block_k=64, k_scale_mode="fine")),
    ("fp8", "bool", True, True, dict(block_q=64, block_k=64)),
    ("fp8", "float", False, False, dict(block_q=64, block_k=64)),
    ("bf16", "bool", False, False, dict(block_q=64, block_k=64)),
    ("bf16", "float", True, True, dict(block_q=64, block_k=64)),
]


@pytest.mark.parametrize("pv,kind,per_head,causal,extra", CASES,
                         ids=[f"{c[0]}-{c[1]}-{'head' if c[2] else 'bcast'}-"
                              f"{'causal' if c[3] else 'dense'}-{i}"
                              for i, c in enumerate(CASES)])
def test_sageattn_masks_match_jax(pv, kind, per_head, causal, extra):
    Hq, Hk, S, D = 4, 2, 200, 64
    q, k, v = qkv(Hq, Hk, S, D, seed=S + len(extra) + (pv == "fp8"))
    mask = make_mask(kind, Hq if per_head else 1, S, seed=3, causal=causal)
    kw = dict(is_causal=causal, pv_dtype=pv, qk_quant_gran="per_thread",
              k_scale_mode=extra.get("k_scale_mode", "head"), compute_dtype="native",
              smooth_v=pv != "bf16", **{k_: v_ for k_, v_ in extra.items()
                                        if k_ != "k_scale_mode"})
    out = tcore._sage_attention(q, k, v, attn_mask=mask, **kw)
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    assert calc_diff(out, run_jax(q, k, v, mask, **kw)) < JAX_BAR
    live = live_rows(mask, causal, S)
    ref = masked_oracle(q, k, v, mask, causal)
    assert calc_diff(out[:, :, live], ref[:, :, live]) < ORACLE_BAR[pv]


@pytest.mark.parametrize("pv", ["int8", "bf16"])
def test_rows_without_live_keys_match_jax(pv):
    """A causal left-padded batch: the first rows of row 1 see no key.  The
    static call's minimum row denominator is 0, so both packages rerun it
    online, and the dead rows come back as JAX gives them."""
    Hq, Hk, S, D = 2, 2, 160, 64
    q, k, v = (torch.cat([x, x.flip(2)]) for x in qkv(Hq, Hk, S, D, seed=11))
    keep = torch.ones(2, 1, S, S, dtype=torch.bool)
    keep[1, :, :, :40] = False                 # row 1: 40 pad tokens on the left
    keep[1, :, :40, :] = False
    modes = []
    real = tatt.attention_call

    def spy(*a, cfg, **kw):
        modes.append(cfg.softmax_mode)
        return real(*a, cfg=cfg, **kw)

    kw = dict(is_causal=True, pv_dtype=pv, k_scale_mode="head", compute_dtype="native",
              qk_quant_gran="per_thread", smooth_v=pv != "bf16", block_q=64, block_k=64)
    try:
        tcore.attention_call = spy
        out = tcore._sage_attention(q, k, v, attn_mask=keep, **kw)
    finally:
        tcore.attention_call = real
    assert modes == ["static", "online"]
    jo = run_jax(q, k, v, keep, **kw)
    np.testing.assert_allclose(out[1, :, :40].numpy(), jo[1, :, :40], rtol=0, atol=1e-6)
    if pv == "bf16":
        assert float(out[1, :, :40].abs().max()) == 0.0
    assert calc_diff(out, jo) < JAX_BAR
    ref = masked_oracle(q, k, v, keep, causal=True)
    assert calc_diff(out[1, :, 40:], ref[1, :, 40:]) < ORACLE_BAR[pv]


def test_liveness_table_matches_jax_minfo():
    """``mask_tile_table`` is live where the JAX kernel's ``minfo``
    (``attention.py``: ``any(mask6 != 0, axis=(3, 5))`` over the padded
    mask) is, at 64x64, and marks the fully kept tiles inside the mask."""
    rng = np.random.default_rng(5)
    B, Hm, Sq, Sk = 2, 3, 300, 200
    m = rng.random((B, Hm, Sq, Sk)) > 0.995        # sparse: many dead tiles
    m[:, 1, :128, :128] = True                     # fully kept tiles
    pad = np.zeros((B, Hm, 320, 256), dtype=np.int8)
    pad[:, :, :Sq, :Sk] = m
    m6 = jnp.asarray(pad).reshape(B, Hm, 5, 64, 4, 64)
    minfo = np.asarray(jnp.any(m6 != 0, axis=(3, 5)).astype(jnp.int32))
    table = tatt.mask_tile_table(torch.from_numpy(m))
    assert table.dtype == torch.uint8 and tuple(table.shape) == (B, Hm, 5, 4)
    np.testing.assert_array_equal((table > 0).numpy(), minfo)
    np.testing.assert_array_equal((table == 2).numpy(), np.asarray(jnp.all(m6 != 0, axis=(3, 5))))
    assert 0 < int((table == 0).sum()) and int((table == 2).sum()) == 2 * 4


def _cfg_b(name, causal, masked, S=192):
    base = dict(block_q=64, block_k=64, causal=causal, out_dtype=torch.float32,
                emit_lse=True, sm_scale=0.125, masked=masked, kv_len=S)
    if name == "B4":
        return dict(base, quantized=False)
    return dict(base, quantized=True, pv_dtype="int8", fold_k_scale=True,
                softmax_mode="online", pv_via_bf16=True, fuse_v_mean=True,
                fuse_q_quant=True)


@pytest.mark.parametrize("name,kind,causal", [("B4", "bool", False), ("B4", "float", True),
                                              ("B2", "bool", True), ("B2", "float", False)])
def test_attention_call_masks_match_jax(name, kind, causal):
    """The kernel's plain version against JAX's ``attention_call`` with the
    same operands, mask and 64-wide tiles (outputs and base-2 lse)."""
    from sageattention_tpu_torch.ops.quant_fused import prep_k_onepass, prep_v_onepass
    Hq, Hk, S, D = 2, 1, 192, 64
    q, k, v = qkv(Hq, Hk, S, D, seed=21)
    mask = make_mask(kind, 1, S, seed=4, causal=causal)
    fields = _cfg_b(name, causal, kind)
    kw = {}
    if name != "B4":
        k, km, amax, _ = prep_k_onepass(k, S, with_capmax=True)
        v, vm, vamax = prep_v_onepass(v, S)
        kw = dict(k_head_scale=torch.where(amax > 0, amax / 127.0, 1.0),
                  v_scale=torch.where(vamax > 0, vamax / 127.0, 1.0), v_mean=vm)
    tcfg = tatt.AttnConfig(**fields)
    jcfg = jatt.AttnConfig(**{**fields, "out_dtype": jnp.float32})
    out, lse = tatt.attention_call(q, k, v, attn_mask=mask, cfg=tcfg, **kw)[:2]
    m_j = mask.to(torch.int8) if kind == "bool" else mask
    jo, jl = jatt.attention_call(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), attn_mask=jnp.asarray(m_j.numpy()),
        cfg=jcfg, interpret=True, **{a: jnp.asarray(b.numpy()) for a, b in kw.items()})[:2]
    assert calc_diff(out, np.asarray(jo)) < JAX_BAR
    live = live_rows(mask, causal, S)
    np.testing.assert_allclose(lse[:, :, live].numpy(), np.asarray(jl)[:, :, live.numpy()],
                               atol=5e-3, rtol=0)
    if name == "B4":
        ref = masked_oracle(q, k, v, mask, causal, sm_scale=0.125)
        assert calc_diff(out[:, :, live], ref[:, :, live]) < 2e-5
    assert tatt.config_name(tcfg, S) == f"{name}-{kind}"


def test_static_float_bias_without_fused_q_is_refused():
    cfg = tatt.AttnConfig(**{**_cfg_b("B2", False, "float"), "softmax_mode": "static",
                             "fuse_q_quant": False, "fold_k_scale": True})
    with pytest.raises(ValueError, match="fused"):
        tatt.config_name(cfg, 128)
    # the pipeline turns such a request into the online softmax, as JAX does
    q, k, v = qkv(2, 2, 128, 64, seed=31)
    bias = make_mask("float", 1, 128, seed=6)
    out = tcore._sage_attention(q, k, v, attn_mask=bias, pv_dtype="int8",
                                k_scale_mode="fine", softmax_mode="static",
                                block_q=64, block_k=64)
    assert calc_diff(out, masked_oracle(q, k, v, bias)) < 1e-3


@pytest.mark.parametrize("arg", ["mask", "bias"])
def test_sage_dot_product_attention_masks_match_jax(arg):
    """NHD drop-in with ``mask`` / ``bias`` against the JAX function; JAX's
    modes pinned to the port's CPU defaults.  In interpret mode JAX takes
    its NHD-direct path, which quantizes Q before the kernel: the port is
    asked for the same (``fuse_q_quant=False``)."""
    q, k, v = (x.transpose(1, 2).contiguous() for x in qkv(2, 2, 128, 64, seed=41))
    m = make_mask("bool" if arg == "mask" else "float", 1, 128, seed=7)
    out = sage_dot_product_attention(q, k, v, **{arg: m}, fuse_q_quant=False)
    jo = jax_sdpa(*(jnp.asarray(x.numpy()) for x in (q, k, v)), **{arg: jnp.asarray(m.numpy())},
                  pv_dtype="int8", compute_dtype="native", k_scale_mode="head",
                  qk_quant_gran="per_thread", use_fused=True, interpret=True)
    assert calc_diff(out, np.asarray(jo)) < JAX_BAR
    ref = masked_oracle(*(x.transpose(1, 2) for x in (q, k, v)), m).transpose(1, 2)
    live = live_rows(m, False, 128)
    assert calc_diff(out[:, live], ref[:, live]) < 1e-3


def test_masked_configs_compose_with_dataclass_replace():
    """Every quantized base configuration takes either mask kind."""
    base = tatt.AttnConfig(**_cfg_b("B2", False, "none"))
    for masked in ("bool", "float"):
        for pv in ("int8", "bf16"):
            cfg = dataclasses.replace(base, masked=masked, pv_dtype=pv, fuse_v_mean=pv == "int8")
            assert tatt.config_name(cfg, 128).endswith("-" + masked)


def test_masks_on_another_device_are_refused():
    """The kernel reads masks and segment ids through raw pointers: inputs
    on another device than the attention's are refused, not read."""
    q, k, v = qkv(2, 2, 64, 64, seed=51)
    cfg = tatt.AttnConfig(**_cfg_b("B4", False, "bool", S=64))
    with pytest.raises(ValueError, match="device"):
        tatt.attention_call(q, k, v, attn_mask=torch.ones(1, 1, 64, 64, dtype=torch.bool,
                                                          device="meta"), cfg=cfg)
