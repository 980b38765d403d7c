"""The port's quantizers against the JAX package's.

- ``ops/quant.py`` (the unfused quantizers, plain PyTorch) against
  ``sageattention_tpu/ops/quant.py``: codes equal, scales to rtol 1e-6.
- The plain versions of kernels A5 (``channel_stats``) and A6
  (``quant_int8_groupwise`` / ``quant_int8_fixed``) against the Pallas
  kernels run in interpret mode, HND and NHD (the NHD-direct Pallas kernels
  A7a/A7b, whose counterpart is the same A5/A6 reading strided views).
  Codes within 1 of JAX's and equal in >= 99.9% of places (the f32 K mean
  is summed in another order, which can move a code at a rounding tie);
  stats, scales and capmax to rtol 1e-5.

JAX's group quantizer takes a length that a 128-row block divides, as its
pipeline pads to its tiles first; the port takes the true length and pads
to the group multiple itself.  Rows the two share are compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu.ops import quant as jquant
from sageattention_tpu.ops import quant_pallas as qp
from sageattention_tpu_torch.ops import _build
from sageattention_tpu_torch.ops import quant as tquant
from sageattention_tpu_torch.ops import quant_kernels as qk

from port_cpu import yield_cpu  # noqa: F401  (one torch thread, low CPU priority)


def _rand(shape, seed, scale=1.0, outlier=True):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    if outlier:
        x[..., 7] += 4.0
    # a bf16 round trip: both sides see exactly representable bf16 values
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _assert_codes(a, b):
    a = np.asarray(a).astype(np.int32)
    b = np.asarray(b).astype(np.int32)
    assert a.shape == b.shape
    assert np.mean(a == b) >= 0.999
    assert np.abs(a - b).max() <= 1


def _close(a, b, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a, dtype=np.float32),
                               rtol=rtol, atol=1e-7)


# ------------------------------------------------- (a) ops/quant.py ----

@pytest.mark.parametrize("group,fold,with_sub", [(4, 0.18, False), (16, 1.0, True),
                                                 (64, 1.0, False), (128, 0.3, True)])
def test_quant_int8_groupwise_matches_jax(group, fold, with_sub):
    x = _rand((2, 3, 256, 64), group)
    sub = x.mean(axis=2, keepdims=True) if with_sub else None
    j8, js = jquant.quant_int8_groupwise(jnp.asarray(x), group, fold=fold,
                                         sub=None if sub is None else jnp.asarray(sub))
    t8, ts = tquant.quant_int8_groupwise(torch.from_numpy(x), group, fold=fold,
                                         sub=None if sub is None else torch.from_numpy(sub))
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    _close(js, ts, 1e-6)
    np.testing.assert_array_equal(
        tquant.dequant_int8_groupwise(t8, ts, group).numpy(),
        np.asarray(jquant.dequant_int8_groupwise(j8, js, group)))
    rows = tquant.expand_scales_rows(ts, group, 256)
    cols = tquant.expand_scales_cols(ts, group, 256)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jquant.expand_scales_rows(js, group, 256)))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jquant.expand_scales_cols(js, group, 256)))
    with pytest.raises(ValueError):
        tquant.quant_int8_groupwise(torch.from_numpy(x[:, :, :250]), group)


@pytest.mark.parametrize("fn,layout", [("per_block_int8", "HND"), ("per_warp_int8", "NHD"),
                                       ("per_thread_int8", "HND"), ("per_thread_int8", "NHD")])
def test_per_granularity_quant_matches_jax(fn, layout):
    q, k = _rand((1, 2, 256, 64), 1, outlier=False), _rand((1, 2, 256, 64), 2)
    km = k.mean(axis=2, keepdims=True)
    if layout == "NHD":
        q, k = q.transpose(0, 2, 1, 3).copy(), k.transpose(0, 2, 1, 3).copy()
    jr = getattr(jquant, fn)(jnp.asarray(q), jnp.asarray(k), km=jnp.asarray(km),
                             sm_scale=0.1, tensor_layout=layout)
    tr = getattr(tquant, fn)(torch.from_numpy(q), torch.from_numpy(k), km=torch.from_numpy(km),
                             sm_scale=0.1, tensor_layout=layout)
    for a, b in zip(jr, tr):
        assert tuple(b.shape) == a.shape
        if b.dtype == torch.int8:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            _close(a, b, 1e-6)


@pytest.mark.parametrize("layout,smooth_v", [("HND", True), ("NHD", True), ("HND", False)])
def test_per_channel_v_quant_matches_jax(layout, smooth_v):
    v = _rand((1, 2, 200, 64), 3, 2.0)
    if layout == "NHD":
        v = v.transpose(0, 2, 1, 3).copy()
    jf8, jfs, jfm = jquant.per_channel_fp8(jnp.asarray(v), layout, smooth_v=smooth_v)
    tf8, tfs, tfm = tquant.per_channel_fp8(torch.from_numpy(v), layout, smooth_v=smooth_v)
    assert tf8.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(tf8.float().numpy(), np.asarray(jf8.astype(jnp.float32)))
    _close(jfs, tfs, 1e-6)
    ji8, jis, jim = jquant.per_channel_int8(jnp.asarray(v), layout, smooth_v=smooth_v)
    ti8, tis, tim = tquant.per_channel_int8(torch.from_numpy(v), layout, smooth_v=smooth_v)
    np.testing.assert_array_equal(ti8.numpy(), np.asarray(ji8))
    _close(jis, tis, 1e-6)
    if smooth_v:
        _close(jfm, tfm, 1e-6)
        _close(jim, tim, 1e-6)
    else:
        assert tfm is None and tim is None
    jsm, jvm = jquant.sub_mean(jnp.asarray(v), layout)
    tsm, tvm = tquant.sub_mean(torch.from_numpy(v), layout)
    np.testing.assert_array_equal(tsm.float().numpy(), np.asarray(jsm.astype(jnp.float32)))
    _close(jvm, tvm, 1e-6)


# ------------------------------------------------------ (b) A5 / A6 ----

@pytest.mark.parametrize("shape,s_true,layout", [
    ((1, 2, 512, 64), 400, "HND"),
    ((1, 3, 384, 128), 333, "HND"),
    ((2, 1, 256, 256), 256, "HND"),
    ((1, 256, 4, 64), 250, "NHD"),
])
def test_channel_stats_matches_pallas(shape, s_true, layout):
    x = _rand(shape, 4, 2.0)
    jr = qp.channel_stats_pallas(jnp.asarray(x), s_true, in_layout=layout, interpret=True)
    tr = qk.channel_stats(torch.from_numpy(x), s_true, in_layout=layout)
    for a, b in zip(jr, tr):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32
        _close(a, b)


def _pad_rows(x, n):
    return np.pad(x, [(0, 0), (0, 0), (0, n - x.shape[2]), (0, 0)])


@pytest.mark.parametrize("group,S,s_true,fold,with_sub", [
    (4, 333, 0, 0.127, False),     # Q: the sm_scale*log2e fold, every row
    (16, 333, 333, 1.0, True),     # K: sub = km, capmax over the true rows
    (32, 300, 290, 1.0, True),
    (64, 256, 200, 1.0, False),
    (128, 333, 333, 0.5, True),
])
def test_quant_groupwise_matches_pallas(group, S, s_true, fold, with_sub):
    """The port pads to the group multiple with zeros before subtracting
    ``sub``, as JAX pads K before quantizing it: the pad rows of a partial
    last group hold -sub and enter its scale."""
    x = _rand((1, 2, S, 64), 5 + group, 1.5)
    sub = x[:, :, :S].mean(axis=2, keepdims=True) if with_sub else None
    Sj = -(-S // 128) * 128
    jr = qp.quant_int8_groupwise_pallas(
        jnp.asarray(_pad_rows(x, Sj)), group, fold=fold,
        sub=None if sub is None else jnp.asarray(sub), with_capmax=True, s_true=s_true,
        interpret=True)
    tr = qk.quant_int8_groupwise(torch.from_numpy(x), group, fold=fold,
                                 sub=None if sub is None else torch.from_numpy(sub),
                                 with_capmax=True, s_true=s_true)
    S_out = -(-S // group) * group
    assert tuple(tr[0].shape) == (1, 2, S_out, 64) and tuple(tr[1].shape) == (1, 2, S_out // group)
    _assert_codes(np.asarray(jr[0])[:, :, :S_out], tr[0])
    _close(np.asarray(jr[1])[:, :, :S_out // group], tr[1])
    _close(jr[2], tr[2])
    two = qk.quant_int8_groupwise(torch.from_numpy(x), group, fold=fold,
                                  sub=None if sub is None else torch.from_numpy(sub))
    assert len(two) == 2 and torch.equal(two[0], tr[0])


@pytest.mark.parametrize("group", [16, 4])
def test_quant_groupwise_nhd_matches_pallas_nhd(group):
    """A7a's counterpart: NHD storage read through strides, HND out."""
    x = _rand((1, 256, 2, 64), 6, 1.5)
    sub = x.mean(axis=1, keepdims=True).transpose(0, 2, 1, 3).copy()
    jr = qp.quant_int8_groupwise_pallas(jnp.asarray(x), group, sub=jnp.asarray(sub),
                                        with_capmax=True, s_true=250, in_layout="NHD",
                                        interpret=True)
    tr = qk.quant_int8_groupwise(torch.from_numpy(x), group, sub=torch.from_numpy(sub),
                                 with_capmax=True, s_true=250, in_layout="NHD")
    _assert_codes(jr[0], tr[0])
    # JAX's NHD entry returns per-row scales, the port per-group ones
    _close(jr[1], tquant.expand_scales_rows(tr[1], group, 256))
    _close(jr[2], tr[2])


@pytest.mark.parametrize("mode,layout", [("scalar", "HND"), ("channel", "HND"),
                                         ("scalar", "NHD"), ("channel", "NHD")])
def test_quant_fixed_matches_pallas(mode, layout):
    x = _rand((1, 2, 256, 128), 7, 2.0)
    rng = np.random.default_rng(8)
    last = 1 if mode == "scalar" else 128
    scale = (rng.random((1, 2, 1, last)) * 0.05 + 0.01).astype(np.float32)
    sub = x.mean(axis=2, keepdims=True)
    if layout == "NHD":
        x = x.transpose(0, 2, 1, 3).copy()
    capmax = mode == "scalar"
    kw = dict(sub=sub, with_capmax=capmax, s_true=200 if capmax else 0, in_layout=layout)
    jr = qp.quant_int8_fixed_pallas(jnp.asarray(x), jnp.asarray(scale), interpret=True,
                                    **{**kw, "sub": jnp.asarray(sub)})
    tr = qk.quant_int8_fixed(torch.from_numpy(x), torch.from_numpy(scale),
                             **{**kw, "sub": torch.from_numpy(sub)})
    if capmax:
        _assert_codes(jr[0], tr[0])
        _close(jr[1], tr[1])
    else:
        _assert_codes(jr, tr)


def test_quant_kernels_refuse_varlen_options_and_bad_groups():
    """The varlen options run since slice 3 (row norms and dots beside the
    codes; segments through ``quant_int8_segmented``); bad groups, a
    channel-mode capmax, short segment ids and a dot operand that does not
    cover the rows are refused."""
    x = torch.from_numpy(_rand((1, 1, 128, 64), 9))
    assert len(qk.quant_int8_groupwise(x, 16, with_norm=True)) == 3
    assert len(qk.quant_int8_groupwise(x, 16, dot_with=x.to(torch.int8))) == 3
    assert len(qk.quant_int8_fixed(x, torch.ones(1, 1, 1, 1), with_norm=True)) == 2
    with pytest.raises(TypeError):
        qk.quant_int8_groupwise(x, 16, segment_ids=torch.zeros(1, 128, dtype=torch.int32))
    with pytest.raises(ValueError):
        qk.quant_int8_segmented(x, torch.zeros(1, 64, dtype=torch.int32), 16)
    with pytest.raises(ValueError):
        qk.quant_int8_groupwise(x, 16, dot_with=x[:, :, :64].to(torch.int8))
    with pytest.raises(NotImplementedError):
        qk.quant_int8_groupwise(x, 48)
    with pytest.raises(NotImplementedError):
        qk.quant_int8_fixed(x, torch.ones(1, 1, 1, 64), with_capmax=True)
    with pytest.raises(ValueError):
        qk.channel_stats(x, 0)
    with pytest.raises(ValueError):
        qk.channel_stats(x, 64, in_layout="HDN")


def test_quant_kernel_path_without_a_card_raises(monkeypatch):
    """A CUDA-bound call builds and launches or raises: it never hands back
    the plain result."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    x = torch.from_numpy(_rand((1, 1, 128, 64), 10))
    with pytest.raises(RuntimeError, match="nvcc"):
        qk._launch_quant(x, "group", 16, 1.0, None, None, True, 128, 128)
    meta = torch.empty((1, 1, 128, 64), device="meta")
    with pytest.raises(NotImplementedError):
        qk.channel_stats(meta, 128)
    with pytest.raises(NotImplementedError):
        qk.quant_int8_groupwise(meta, 16)
