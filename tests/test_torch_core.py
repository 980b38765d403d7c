"""The port's public forward (``sageattn``, ``_sage_attention``,
``flash_attention``) against the JAX package's ``_sage_attention`` run with
``use_fused=True, interpret=True`` and every mode argument pinned, plus the
port's value checks, dispatch and layout helpers.

JAX always receives HND tensors: under interpret mode an NHD call takes
its NHD-direct path, which turns in-kernel Q quantization off and so has
other numerics.  The port's NHD results are transposed for the comparison.

Bars: port vs JAX calc_diff < 1e-5; port vs the float64 oracle < 1.5e-3
(tests/test_attention.py's bar), flash < 2e-5; natural-log lse within 0.05
of the oracle and 5e-3 of JAX (whose interpret-mode denominators carry up to
~2e-3 of error, see tests/test_torch_attention.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sageattention_tpu as jsa
import sageattention_tpu_torch as tsa
from sageattention_tpu.core import _sage_attention as jax_sage
from sageattention_tpu.utils import layout as jlayout
from sageattention_tpu_torch import dispatch
from sageattention_tpu_torch.core import _sage_attention as port_sage
from sageattention_tpu_torch.ops import attention as tatt
from sageattention_tpu_torch.ops.reference import sdpa, sdpa_nhd
from sageattention_tpu_torch.utils import layout as tlayout
from sageattention_tpu_torch.utils.testing import calc_diff

PINNED = dict(pv_dtype="int8", k_scale_mode="head", compute_dtype="native",
              softmax_mode="auto", smooth_k=True, smooth_v=True,
              qk_quant_gran="per_thread")


def qkv(Hq=2, Hk=None, S=256, D=64, scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    Hk = Hk or Hq
    xs = [rng.standard_normal((1, h, S, D)).astype(np.float32) * scale
          for h in (Hq, Hk, Hk)]
    xs[1][..., 5] += 3.0   # a biased K channel, as smooth_k expects
    return [torch.from_numpy(x) for x in xs]


def run_jax(q, k, v, **kw):
    return run_jax_unfused_q(q, k, v, **{"fuse_q_quant": True, **kw})


def run_jax_unfused_q(q, k, v, tensor_layout="HND", **kw):
    """JAX's ``_sage_attention`` on the fused (kernel) prep, ``fuse_q_quant``
    left to its own rule unless given."""
    res = jax_sage(*(jnp.asarray(x.numpy()) for x in (q, k, v)), tensor_layout=tensor_layout,
                   use_fused=True, interpret=True, **kw)
    if isinstance(res, tuple):
        return tuple(np.asarray(r) for r in res)
    return np.asarray(res)


@pytest.mark.parametrize("Hq,Hk,S,D,causal,blocks", [
    (4, 2, 300, 64, False, 0),      # short: int8 storage, bf16 compute (B3)
    (2, 2, 256, 64, True, 0),
    (4, 2, 300, 64, False, 128),    # explicit blocks: native int8 (B1)
    (2, 1, 256, 128, True, 128),
    (2, 2, 256, 96, False, 0),      # head dim 96 padded to 128
])
def test_sage_attention_matches_jax(Hq, Hk, S, D, causal, blocks):
    q, k, v = qkv(Hq, Hk, S, D, seed=S + D + Hq)
    kw = dict(PINNED, is_causal=causal, block_q=blocks, block_k=blocks)
    out = port_sage(q, k, v, **kw)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert calc_diff(out, run_jax(q, k, v, **kw)) < 1e-5
    assert calc_diff(out, sdpa(q, k, v, is_causal=causal)) < 1.5e-3


@pytest.mark.parametrize("blocks", [0, 128])
def test_nhd_layout_matches_jax_hnd(blocks):
    q, k, v = qkv(2, 2, 256, 64, seed=11)
    kw = dict(PINNED, block_q=blocks, block_k=blocks)
    out = port_sage(*(x.transpose(1, 2) for x in (q, k, v)), tensor_layout="NHD", **kw)
    assert out.shape == (1, 256, 2, 64)
    assert calc_diff(out.transpose(1, 2), run_jax(q, k, v, **kw)) < 1e-5
    ref = sdpa_nhd(*(x.transpose(1, 2) for x in (q, k, v)))
    assert calc_diff(out, ref) < 1.5e-3


@pytest.mark.parametrize("causal,blocks", [(False, 0), (True, 128)])
def test_return_lse(causal, blocks):
    q, k, v = qkv(4, 2, 300, 64, seed=21)
    kw = dict(PINNED, is_causal=causal, block_q=blocks, block_k=blocks, return_lse=True)
    out, lse = port_sage(q, k, v, **kw)
    j_out, j_lse = run_jax(q, k, v, **kw)
    _, o_lse = sdpa(q, k, v, is_causal=causal, return_lse=True)
    assert lse.shape == (1, 4, 300) and lse.dtype == torch.float32
    assert calc_diff(out, j_out) < 1e-5
    np.testing.assert_allclose(lse.numpy(), j_lse, atol=5e-3)
    np.testing.assert_allclose(lse.double().numpy(), o_lse.numpy(), atol=0.05)


@pytest.mark.parametrize("blocks,online_name", [(0, "B3-online"), (128, "B2")])
def test_adversarial_input_falls_back_online(blocks, online_name):
    """x60 inputs: the static cap overshoots every logit, the minimum row
    denominator trips, and the call reruns with the online softmax; the
    result equals the online configuration run directly."""
    q, k, v = qkv(1, 1, 256, 64, scale=60.0, seed=31)
    kw = dict(PINNED, block_q=blocks, block_k=blocks)
    before = dict(tatt.attention_call.launches)
    out = port_sage(q, k, v, **kw)
    assert bool(torch.isfinite(out).all())
    assert calc_diff(out, run_jax(q, k, v, **kw)) < 1e-5
    # the online rerun, by hand: same prep, the online configuration
    from sageattention_tpu_torch.ops.quant_fused import prep_k_onepass, prep_v_onepass
    k8, km, amax = prep_k_onepass(k, 256)
    v8, vm, vamax = prep_v_onepass(v, 256)
    cfg = tatt.AttnConfig(quantized=True, pv_dtype="int8", kv_len=256, out_dtype=q.dtype,
                          fold_k_scale=True, fuse_q_quant=True, fuse_v_mean=True,
                          compute_dtype="bf16" if online_name == "B3-online" else "native",
                          softmax_mode="online", pv_via_bf16=True, emit_lse=False,
                          sm_scale=0.125)
    assert tatt.config_name(cfg, 256) == online_name
    inv127 = 1.0 / 127.0   # multiplied as f32, as the pipeline does
    online, _ = tatt.attention_call(
        q, k8, v8, v_scale=torch.where(vamax > 0, vamax * inv127, 1.0), v_mean=vm,
        k_head_scale=torch.where(amax > 0, amax * inv127, 1.0), cfg=cfg)
    assert torch.equal(out, online)
    assert tatt.attention_call.launches == before   # CPU tensors launch no kernel


def test_sageattn_defaults_match_pinned_jax():
    """On a CPU tensor the port's dispatch picks the flagship (int8 PV,
    native compute), unlike the JAX CPU row (bf16 PV)."""
    q, k, v = qkv(4, 2, 300, 64, seed=41)
    out = tsa.sageattn(q, k, v)
    assert calc_diff(out, run_jax(q, k, v, **PINNED)) < 1e-5
    caps = dispatch.detect(q)
    assert (caps.default_pv_dtype, caps.default_compute_dtype) == ("int8", "native")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax(causal):
    q, k, v = qkv(2, 1, 300, 64, seed=51)
    out, lse = tsa.flash_attention(q, k, v, is_causal=causal, return_lse=True)
    j_out, j_lse = jsa.flash_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                       is_causal=causal, return_lse=True, interpret=True)
    assert out.dtype == torch.bfloat16
    assert calc_diff(out, np.asarray(j_out.astype(jnp.float32))) < 1e-5
    assert calc_diff(out, sdpa(q, k, v, is_causal=causal)) < 2e-5
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=1e-4)


def test_qk_int8_pv_int8_entry_short_sequence():
    q, k, v = qkv(2, 2, 256, 64, seed=61)
    out = tsa.sageattn_qk_int8_pv_int8(q, k, v, is_causal=True)
    assert calc_diff(out, sdpa(q, k, v, is_causal=True)) < 1.5e-3
    # explicit blocks keep native compute: fine K scales (B6) at this length
    kw = dict(pv_dtype="int8", k_scale_mode="fine", block_q=128, block_k=128)
    fine = port_sage(q, k, v, **kw)
    assert calc_diff(fine, run_jax_unfused_q(q, k, v, **kw)) < 1e-5
    assert calc_diff(fine, sdpa(q, k, v)) < 1.5e-3


# sageattn options that raised before slice 2: each runs and matches JAX
# (S = 64 is one kv tile, so the e4m3 P sees the same running max on both
# sides whatever JAX's tile width)
SLICE2_SAGEATTN_OPTIONS = [
    dict(pv_dtype="bf16"), dict(pv_dtype="fp8"), dict(smooth_k=False),
    dict(smooth_v=False), dict(fuse_q_quant=False),
]


@pytest.mark.parametrize("kwargs", SLICE2_SAGEATTN_OPTIONS,
                         ids=[f"{k}={v}" for o in SLICE2_SAGEATTN_OPTIONS for k, v in o.items()])
def test_slice2_sageattn_options_match_jax(kwargs):
    q, k, v = qkv(2, 2, 64, 64, seed=71)
    out = tsa.sageattn(q, k, v, **kwargs)
    assert calc_diff(out, run_jax_unfused_q(q, k, v, **{**PINNED, **kwargs})) < 1e-5
    bar = 5e-3 if kwargs.get("pv_dtype") == "fp8" else 1.5e-3
    assert calc_diff(out, sdpa(q, k, v)) < bar


@pytest.mark.parametrize("kwargs,exc", [
    (dict(pv_dtype="int4"), ValueError),
    (dict(attn_mask=torch.ones(1, 64, 64, dtype=torch.bool)), ValueError),   # not 4-d
    (dict(sliding_window=16, is_causal=True,
          attn_mask=torch.ones(1, 1, 64, 64, dtype=torch.bool)), ValueError),
    (dict(sliding_window=16), ValueError),
    (dict(attention_sinks=4), ValueError),
    (dict(qk_quant_gran="per_row"), ValueError),
    (dict(tensor_layout="HDN"), ValueError),
    (dict(quant_backward="int8"), ValueError),   # True, False or None
    (dict(interpret=True), TypeError),
    (dict(pv_dtype="fp8", softmax_mode="static"), TypeError),
])
def test_options_outside_the_slice_raise(kwargs, exc):
    q, k, v = qkv(2, 2, 64, 64, seed=71)
    with pytest.raises(exc):
        tsa.sageattn(q, k, v, **kwargs)


@pytest.mark.parametrize("kwargs,match", [
    (dict(pv_dtype="fp8", softmax_mode="static"), "fp8"),
    (dict(pv_dtype="fp8", compute_dtype="bf16"), "fp8"),
    (dict(fuse_q_quant=True, k_scale_mode="fine", block_q=128, block_k=128), "fuse_q_quant"),
    (dict(k_scale_mode="row", block_q=128, block_k=128), "k_scale_mode"),
])
def test_incoherent_modes_raise(kwargs, match):
    q, k, v = qkv(2, 2, 64, 64, seed=72)
    with pytest.raises(ValueError, match=match):
        port_sage(q, k, v, **kwargs)


@pytest.mark.parametrize("shapes,causal", [
    (((1, 3, 64, 64), (1, 2, 64, 64), (1, 2, 64, 64)), False),   # Hq % Hk
    (((1, 2, 64, 64), (1, 2, 64, 64), (1, 2, 32, 64)), False),   # k/v shapes
    (((1, 2, 64, 64), (1, 2, 32, 64), (1, 2, 32, 64)), True),    # causal Sq != Sk
])
def test_value_checks(shapes, causal):
    with pytest.raises(ValueError):
        port_sage(*qkv(2, 2, 64, 64), pv_dtype="int8", softmax_mode="fast")
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        tsa.sageattn(q, k, v, is_causal=causal)


def test_inputs_that_require_grad_raise():
    """Functions with no backward of their own raise on inputs that
    require grad (``flash_attention`` and the pipeline ``_sage_attention``,
    as JAX has no VJP for them); ``sageattn`` takes the gradient."""
    q, k, v = qkv(2, 2, 64, 64, seed=81)
    q.requires_grad_(True)
    for fn in (tsa.flash_attention, port_sage):
        with pytest.raises(NotImplementedError, match="backward"):
            fn(q, k, v)
    with torch.no_grad():
        assert tsa.sageattn(q, k, v).shape == q.shape
        assert tsa.flash_attention(q, k, v).shape == q.shape
    out = tsa.sageattn(q, k, v)
    assert out.requires_grad and out.shape == q.shape


def test_dispatch_rows():
    assert dispatch.detect("cpu").default_pv_dtype == "int8"
    assert dispatch.detect("cpu").generation == "cpu"
    if not torch.cuda.is_available():   # no argument means the first CUDA card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dispatch.detect()
    # sm_90 has fast fp8 (passed on as fp8_native_dot) but keeps pv int8
    assert dispatch._SM90.has_fast_fp8 and dispatch._SM90.default_pv_dtype == "int8"
    assert not dispatch.detect("cpu").has_fast_fp8
    with pytest.raises(NotImplementedError):
        dispatch.detect(torch.device("meta"))


@pytest.mark.parametrize("d", [32, 64, 96, 128, 200, 256])
def test_layout_helpers_match_jax(d):
    x = np.arange(2 * 3 * 5 * d, dtype=np.float32).reshape(2, 3, 5, d)
    tp, tt = tlayout.pad_head_dim(torch.from_numpy(x), tlayout.HND)
    jp, jt = jlayout.pad_head_dim(jnp.asarray(x), jlayout.HND)
    assert tt == jt
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tlayout.pad_axis(torch.from_numpy(x), 2, 8).numpy(),
                                  np.asarray(jlayout.pad_axis(jnp.asarray(x), 2, 8)))
    assert tlayout.round_up(d, 64) == jlayout.round_up(d, 64)
    assert tlayout.get_layout("NHD").seq_axis == jlayout.get_layout("NHD").seq_axis


@pytest.mark.parametrize("layout", ["HND", "NHD"])
def test_k_mean_matches_jax(layout):
    from sageattention_tpu.ops import quant as jquant
    from sageattention_tpu_torch.ops import quant as tquant
    k = qkv(2, 2, 100, 64, seed=91)[1]
    if layout == "NHD":
        k = k.transpose(1, 2).contiguous()
    np.testing.assert_allclose(tquant.k_mean(k, layout).numpy(),
                               np.asarray(jquant.k_mean(jnp.asarray(k.numpy()), layout)),
                               rtol=1e-6, atol=1e-6)
    assert tquant.QUANT_GRANULARITIES == jquant.QUANT_GRANULARITIES
    assert tquant.LOG2E == jquant.LOG2E


def test_choose_blocks_matches_jax():
    from sageattention_tpu import core as jcore
    from sageattention_tpu_torch import core as tcore
    for sq, sk, quant, cd, causal in [(300, 300, True, "native", False),
                                      (17776, 17776, True, "native", False),
                                      (40000, 40000, True, "native", True),
                                      (1576, 1576, True, "bf16", False),
                                      (5000, 5000, False, "native", False)]:
        assert (tcore._choose_blocks(sq, sk, quant, cd, causal)
                == jcore._choose_blocks(sq, sk, quant, cd, causal))
    assert jax.devices()[0].platform == "cpu"
