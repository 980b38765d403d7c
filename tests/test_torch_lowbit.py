"""The port's SageAttention3 simulation (``ops/lowbit.py``) and the B4-fp4
configuration of its attention against the JAX package, on inputs made with
numpy.

Bars: the e2m1 rounding and the microscaled FP4 codes and scales exact.
``q_block_mean_center`` exact on dyadic inputs, whose block sums are exact
in any order; on general inputs within 1e-6, since XLA and PyTorch sum a
block's 128 rows in different orders.  ``sageattn3`` within 1e-5 calc_diff
of JAX's; ``sageattn3_tiled`` with 64-wide tiles (the port's kv tile)
within 1e-4 of JAX's under ``jax.jit`` in interpret mode (the K mean, summed
in another order, can move an FP4 code at a rounding edge); at its default
tiles within ``tests/test_lowbit.py``'s bars.  The plain B4-fp4 kernel
version within 1e-5 of JAX's kernel and its lse within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu.ops import attention as jatt
from sageattention_tpu.ops import lowbit as jlow
from sageattention_tpu.ops.reference import sdpa as jsdpa
import sageattention_tpu_torch as tsa
from sageattention_tpu_torch.ops import attention as tatt
from sageattention_tpu_torch.ops import lowbit as tlow
from sageattention_tpu_torch.utils.testing import calc_diff


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, dtype=np.float32)


def _qkv(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32) for _ in range(3)]


def test_round_to_e2m1_exact():
    mids = [0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0]
    grid = [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0]
    special = mids + [np.nextafter(np.float32(m), np.float32(9)) for m in mids] + grid + [
        6.0, 7.0, 1e3, 0.0, 0.1, 5.9]
    rng = np.random.default_rng(0)
    x = np.concatenate([np.array(special, np.float32), -np.array(special, np.float32),
                        (rng.standard_normal(4096) * 3).astype(np.float32)])
    got = tlow._round_to_e2m1(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jlow._round_to_e2m1(jnp.asarray(x))))
    # ties round to the smaller magnitude
    np.testing.assert_array_equal(got[:7], [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0])


@pytest.mark.parametrize("shape,scale", [((2, 3, 64, 64), 1.0), ((1, 2, 48, 128), 40.0)])
def test_microscale_quant_exact(shape, scale):
    x = _qkv(shape, 1, scale)[0]
    x[0, 0, 0, :16] = 0.0   # an all-zero block takes scale 1
    codes, scales = tlow.quant_fp4_microscaled(torch.from_numpy(x))
    j_codes, j_scales = jlow.quant_fp4_microscaled(jnp.asarray(x))
    assert codes.dtype == torch.bfloat16 and scales.shape == j_scales.shape
    np.testing.assert_array_equal(_np(codes), _np(j_codes))
    np.testing.assert_array_equal(_np(scales), _np(j_scales))
    np.testing.assert_array_equal(
        _np(tlow.dequant_fp4_microscaled(codes, scales)),
        _np(jlow.dequant_fp4_microscaled(j_codes, j_scales)))


def test_q_block_mean_center():
    rng = np.random.default_rng(2)
    dyadic = (rng.integers(-64, 64, (1, 2, 256, 80)) / 8.0).astype(np.float32)
    for x, exact in ((dyadic, True), (_qkv((2, 2, 384, 64), 3, 2.0)[0] + 1.0, False)):
        qc, qm = tlow.q_block_mean_center(torch.from_numpy(x))
        j_qc, j_qm = jlow.q_block_mean_center(jnp.asarray(x))
        assert qc.shape == j_qc.shape and qm.shape == j_qm.shape
        if exact:
            np.testing.assert_array_equal(qc.numpy(), _np(j_qc))
            np.testing.assert_array_equal(qm.numpy(), _np(j_qm))
        else:
            np.testing.assert_allclose(qc.numpy(), _np(j_qc), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(qm.numpy(), _np(j_qm), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_sageattn3_matches_jax(causal):
    q, k, v = _qkv((1, 2, 200, 72), 4)
    q += np.linspace(-3, 3, 200, dtype=np.float32)[None, None, :, None]
    out = tsa.sageattn3(*(torch.from_numpy(x) for x in (q, k, v)), is_causal=causal)
    ref = jlow.sageattn3(*(jnp.asarray(x) for x in (q, k, v)), is_causal=causal)
    assert out.shape == q.shape and out.dtype == torch.float32
    assert calc_diff(out, _np(ref)) < 1e-5


_jax_tiled = jax.jit(jlow.sageattn3_tiled,
                     static_argnames=("is_causal", "block_q", "block_k", "interpret"))


@pytest.mark.parametrize("shape,causal", [((1, 2, 256, 64), False), ((1, 1, 200, 64), True),
                                          ((1, 2, 256, 80), False)])
def test_sageattn3_tiled_matches_jax_at_64_wide_tiles(shape, causal):
    q, k, v = _qkv(shape, 5)
    out = tsa.sageattn3_tiled(*(torch.from_numpy(x) for x in (q, k, v)), is_causal=causal,
                              block_q=64, block_k=64)
    ref = _jax_tiled(*(jnp.asarray(x) for x in (q, k, v)), is_causal=causal, block_q=64,
                     block_k=64, interpret=True)
    assert out.shape == q.shape and out.dtype == torch.float32
    assert calc_diff(out, _np(ref)) < 1e-4


def test_sageattn3_tiled_default_tiles_within_the_jax_bars():
    """At its default tiles JAX rounds P against wider tile maxima than the
    port's 64 columns; both stay within tests/test_lowbit.py's bars."""
    q, k, v = _qkv((1, 2, 256, 64), 8)
    tq = [torch.from_numpy(x) for x in (q, k, v)]
    jq = [jnp.asarray(x) for x in (q, k, v)]
    out = tsa.sageattn3_tiled(*tq)
    assert calc_diff(out, _np(jsdpa(*jq))) < 6e-2
    assert calc_diff(out, _np(jlow.sageattn3(*jq))) < 5e-2
    assert calc_diff(out, _np(_jax_tiled(*jq, interpret=True))) < 5e-2
    rng = np.random.default_rng(11)
    qp = (rng.standard_normal((1, 2, 256, 64)) * 3.0).astype(np.float32)
    kp = qp + 0.1 * rng.standard_normal((1, 2, 256, 64)).astype(np.float32)
    vp = rng.standard_normal((1, 2, 256, 64)).astype(np.float32)
    out = tsa.sageattn3_blackwell(*(torch.from_numpy(x) for x in (qp, kp, vp)),
                                  qk_quant_gran="per_warp")
    assert calc_diff(out, _np(jsdpa(*(jnp.asarray(x) for x in (qp, kp, vp))))) < 5e-3


@pytest.mark.parametrize("S,kv_len,causal,D", [(256, 256, False, 64), (200, 200, True, 128),
                                               (256, 190, False, 128)])
def test_plain_b4_fp4_matches_jax_kernel(S, kv_len, causal, D):
    rng = np.random.default_rng(S + D)
    q, k, v = (torch.from_numpy((rng.standard_normal((1, 2, S, D)) * 1.5).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    cfg = tatt.AttnConfig(causal=causal, quantized=False, sm_scale=D ** -0.5, kv_len=kv_len,
                          out_dtype=torch.float32, p_sim_fp4=True)
    assert tatt.config_name(cfg, S) == "B4-fp4"
    out, lse = tatt.attention_call(q, k, v, cfg=cfg)
    Sp = -(-S // 64) * 64
    pad = lambda x: jnp.asarray(torch.nn.functional.pad(x.float(), (0, 0, 0, Sp - S)).numpy())  # noqa: E731
    jcfg = jatt.AttnConfig(causal=causal, quantized=False, sm_scale=D ** -0.5, kv_len=kv_len,
                           out_dtype=jnp.float32, p_sim_fp4=True, block_q=64, block_k=64,
                           block_k_inner=64)
    j_out, j_lse = jatt.attention_call(*(pad(x).astype(jnp.bfloat16) for x in (q, k, v)),
                                       cfg=jcfg, interpret=True)
    assert calc_diff(out, np.asarray(j_out)[:, :, :S]) < 1e-5
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[:, :, :S], atol=1e-4)


@pytest.mark.parametrize("fields", [
    dict(quantized=False, softmax_mode="static"),                             # static flash
    dict(quantized=True, pv_dtype="int8", softmax_mode="static", fuse_q_quant=True,
         fold_k_scale=True),                                                  # B1's static base
    dict(quantized=True, pv_dtype="int8", fuse_q_quant=True, fold_k_scale=True),  # int8 P
    dict(quantized=True, pv_dtype="fp8", fuse_q_quant=True, fold_k_scale=True),   # e4m3 P
    dict(quantized=True, pv_dtype="int8", fuse_q_quant=True, fold_k_scale=True,
         pv_via_bf16=True),                                                   # B2: bf16 P
    dict(quantized=False, kv_split=2),
    dict(quantized=False, causal=True, window=16),
])
def test_fp4_on_other_bases_raises(fields):
    """p_sim_fp4 runs on the online flash base only.  JAX asserts against
    the static softmax and kv_split and ignores the flag on an int8 or e4m3
    P; the port deliberately raises on every other base."""
    cfg = dataclasses.replace(tatt.AttnConfig(p_sim_fp4=True), **fields)
    with pytest.raises(ValueError):
        tatt.config_name(cfg, 128)
