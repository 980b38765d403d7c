"""The explicit modes of the port (``sageattn_qk_int8_pv_fp8`` / ``_bf16`` /
``_int8``, their reference-name aliases, fine K scales, the predictive
static-softmax check, the fp8 V fold) against the JAX package's
``_sage_attention`` run with ``use_fused=True, interpret=True`` and the
entry's own arguments.

Bars:
  - port vs JAX calc_diff < 1e-5 for the int8 and bf16 PV modes;
  - fp8 PV: JAX's e4m3 P is rounded against the running max of its kv
    tile, so its result depends on the tile width; the port's online
    softmax walks 64-wide tiles.  With JAX's tiles pinned to 64 the two
    agree to < 1e-5 (measured ~1e-14).  Through the public entries JAX
    picks 512-wide tiles at these lengths, some P codes land one e4m3 step
    apart, and the two differ by that rounding noise: < 5e-4 (worst
    measured here 2.2e-4, against ~5e-4 of either from the oracle);
  - port vs the float64 oracle: tests/test_attention.py's bars (5e-4 bf16,
    1e-3 int8), 5e-3 for fp8 at unaligned lengths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu.core import _sage_attention as jax_sage
import sageattention_tpu_torch as tsa
from sageattention_tpu_torch import core as tcore
from sageattention_tpu_torch.ops.reference import sdpa
from sageattention_tpu_torch.utils.testing import calc_diff

from port_cpu import yield_cpu  # noqa: F401  (one torch thread, low CPU priority)

ORACLE_BAR = {"bf16": 5e-4, "int8": 1e-3, "fp8": 5e-3}
JAX_BAR = {"bf16": 1e-5, "int8": 1e-5, "fp8": 5e-4}
ENTRIES = {
    "fp8": (tsa.sageattn_qk_int8_pv_fp8, dict(pv_dtype="fp8")),
    "bf16": (tsa.sageattn_qk_int8_pv_bf16, dict(pv_dtype="bf16", smooth_v=False)),
    "int8": (tsa.sageattn_qk_int8_pv_int8, dict(pv_dtype="int8")),
}
SHAPES = [  # Hq, Hk, S, D, causal, layout
    (2, 1, 333, 64, False, "HND"),
    (2, 2, 256, 80, True, "NHD"),     # head dim 80 padded to 128
    (4, 2, 300, 128, False, "HND"),
]


def qkv(Hq, Hk, S, D, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((1, h, S, D)).astype(np.float32) * scale
          for h in (Hq, Hk, Hk)]
    xs[1][..., 5] += 3.0   # a biased K channel, as smooth_k expects
    return [torch.from_numpy(x) for x in xs]


def run_jax(q, k, v, tensor_layout="HND", **kw):
    res = jax_sage(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                   tensor_layout=tensor_layout, use_fused=True, interpret=True, **kw)
    return np.asarray(res[0] if isinstance(res, tuple) else res)


def _nhd(*xs):
    return tuple(x.transpose(1, 2) for x in xs)


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{s[2]}x{s[3]}-{s[5]}" for s in SHAPES])
@pytest.mark.parametrize("mode", list(ENTRIES))
def test_entry_matches_jax(mode, shape):
    Hq, Hk, S, D, causal, layout = shape
    q, k, v = qkv(Hq, Hk, S, D, seed=S + D + Hq)
    fn, pinned = ENTRIES[mode]
    xs = _nhd(q, k, v) if layout == "NHD" else (q, k, v)
    out = fn(*xs, tensor_layout=layout, is_causal=causal)
    if layout == "NHD":
        out = out.transpose(1, 2)
    assert out.shape == q.shape and out.dtype == q.dtype
    # JAX gets HND: under interpret mode an NHD call takes its NHD-direct
    # path, which quantizes Q outside the kernel where the port does not
    kw = dict(pinned, is_causal=causal, qk_quant_gran="per_thread")
    assert calc_diff(out, run_jax(q, k, v, **kw)) < JAX_BAR[mode]
    assert calc_diff(out, sdpa(q, k, v, is_causal=causal)) < ORACLE_BAR[mode]
    if mode == "fp8":
        # the port's numerics do not depend on the tile width; JAX's match
        # them once its tiles are the port's
        tiles = dict(kw, block_q=64, block_k=64)
        assert torch.equal(out, tcore._sage_attention(q, k, v, **tiles))
        assert calc_diff(out, run_jax(q, k, v, **tiles)) < 1e-5


@pytest.mark.parametrize("alias,base", [
    ("sageattn_qk_int8_pv_fp16_triton", "sageattn_qk_int8_pv_bf16"),
    ("sageattn_qk_int8_pv_fp16_cuda", "sageattn_qk_int8_pv_bf16"),
    ("sageattn_qk_int8_pv_fp8_cuda", "sageattn_qk_int8_pv_fp8"),
    ("sageattn_qk_int8_pv_fp8_cuda_sm90", "sageattn_qk_int8_pv_fp8"),
])
def test_reference_aliases(alias, base):
    q, k, v = qkv(2, 1, 200, 64, seed=5)
    out = getattr(tsa, alias)(q, k, v, is_causal=True, pv_accum_dtype="fp32",
                              quantization_backend="cuda")
    assert torch.equal(out, getattr(tsa, base)(q, k, v, is_causal=True))
    assert getattr(tsa, alias).__name__ == base
    with pytest.raises(TypeError):
        getattr(tsa, alias)(q, k, v, interpret=True)


@pytest.mark.parametrize("mode,causal,smooth_k", [("int8", False, True), ("bf16", True, True),
                                                  ("int8", True, False)])
def test_fine_modes_nhd_match_jax_nhd_direct(mode, causal, smooth_k):
    """Fine K scales at native compute (explicit blocks), NHD storage: the
    port's A5/A6 read strided views, JAX's interpret run takes its
    NHD-direct kernels (A7)."""
    q, k, v = qkv(2, 1, 256, 64, seed=13)
    kw = dict(ENTRIES[mode][1], is_causal=causal, smooth_k=smooth_k, k_scale_mode="fine",
              block_q=128, block_k=128)
    out = tcore._sage_attention(*_nhd(q, k, v), tensor_layout="NHD", **kw)
    ref = run_jax(*_nhd(q, k, v), tensor_layout="NHD", **kw)
    assert out.shape == (1, 256, 2, 64)
    assert calc_diff(out, ref) < 1e-5
    assert calc_diff(out.transpose(1, 2), sdpa(q, k, v, is_causal=causal)) < ORACLE_BAR[mode]


@pytest.mark.parametrize("pv,softmax,gran", [("int8", "online", "per_thread"),
                                             ("fp8", "online", "per_warp"),
                                             ("int8", "static", "per_block")])
def test_return_lse_fine_modes(pv, softmax, gran):
    q, k, v = qkv(2, 2, 256, 64, seed=17)
    kw = dict(pv_dtype=pv, softmax_mode=softmax, qk_quant_gran=gran, k_scale_mode="fine",
              block_q=64, block_k=64, return_lse=True)
    out, lse = tcore._sage_attention(q, k, v, **kw)
    j_out, j_lse = jax_sage(*(jnp.asarray(x.numpy()) for x in (q, k, v)), use_fused=True,
                            interpret=True, **kw)
    _, o_lse = sdpa(q, k, v, return_lse=True)
    assert calc_diff(out, np.asarray(j_out)) < 1e-5
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=5e-3)
    np.testing.assert_allclose(lse.double().numpy(), o_lse.numpy(), atol=0.05)


def _record_modes(monkeypatch):
    modes = []
    real = tcore.attention_call

    def spy(*args, cfg, **kw):
        modes.append(cfg.softmax_mode)
        return real(*args, cfg=cfg, **kw)

    monkeypatch.setattr(tcore, "attention_call", spy)
    return modes


@pytest.mark.parametrize("case,expect", [
    ("normal", "static"),
    ("x60", "online"),            # the per-head cap and the diagonal both fail
    ("self_norm30", "static"),    # smooth_k off, q = k: the diagonal bound holds
    ("x60_unsmoothed", "online"),
])
def test_predictive_static_check(monkeypatch, case, expect):
    """A pre-quantized Q takes the JAX package's predictive check: the port
    must take the branch JAX takes.  On x60 inputs the static result would
    underflow, so agreeing with JAX there shows the same branch."""
    scale = {"normal": 1.0, "x60": 60.0, "self_norm30": 1.0, "x60_unsmoothed": 60.0}[case]
    q, k, v = qkv(2, 2, 256, 64, seed=23, scale=scale)
    if case == "self_norm30":
        # rows of norm 30, q = k: every cap overshoots the per-head bound
        # (30^2 * sm_scale * log2e = 162 > 80), but each row's diagonal
        # logit sits at its cap
        k = k / k.norm(dim=-1, keepdim=True) * 30.0
        q = k.clone()
    kw = dict(pv_dtype="int8", k_scale_mode="fine", block_q=128, block_k=128,
              smooth_k=case in ("normal", "x60"))
    modes = _record_modes(monkeypatch)
    out = tcore._sage_attention(q, k, v, **kw)
    assert modes == [expect]
    assert bool(torch.isfinite(out).all())
    assert calc_diff(out, run_jax(q, k, v, **kw)) < 1e-5


def test_head_mode_unfused_q_falls_back_online(monkeypatch):
    q, k, v = qkv(1, 1, 256, 64, seed=29, scale=60.0)
    modes = _record_modes(monkeypatch)
    out = tsa.sageattn(q, k, v, fuse_q_quant=False)
    assert modes == ["online"]
    kw = dict(pv_dtype="int8", k_scale_mode="head", compute_dtype="native",
              fuse_q_quant=False)
    assert calc_diff(out, run_jax(q, k, v, **kw)) < 1e-5


def test_fp8_fold_under_torch_compile_equals_eager():
    """The fold takes the mean of the rounded e4m3 codes; a compiler that
    cancelled the f32 -> e4m3 -> f32 round trip would make it zero (the
    JAX package met that under XLA:TPU, ROADMAP queue 3)."""
    rng = np.random.default_rng(31)
    v = torch.from_numpy(rng.standard_normal((1, 2, 200, 64)).astype(np.float32))
    vm = v.mean(dim=2, keepdim=True)
    vs = (v - vm).abs().amax(dim=2, keepdim=True) * (1.0 / 448.0)
    codes, vm_eager = tcore.fp8_v(v, vm, vs)
    codes_c, vm_comp = torch.compile(tcore.fp8_v, dynamic=False)(v, vm, vs)
    assert torch.equal(codes_c.float(), codes.float())
    assert torch.equal(vm_comp, vm_eager)
    assert float((vm_eager - vm).abs().max()) > 1e-4   # the fold is not zero
