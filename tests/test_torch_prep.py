"""The port's one-pass K/V prep (A1, A2) against the JAX package's Pallas
kernels run in interpret mode, plus the port's guards: the package imports
no JAX, and the kernel path never falls back to the plain version.

Bars: int8 codes identical in >= 99.9% of places and never more than 1
apart (the f32 mean is summed in another order, which can move a code at a
rounding tie); stats (mean, amax, capmax) to rtol 1e-5.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu.ops import quant_pallas as qp
from sageattention_tpu_torch.ops import _build
from sageattention_tpu_torch.ops import quant_fused as qf

from port_cpu import yield_cpu  # noqa: F401  (one torch thread, low CPU priority)


def _rand(shape, seed, scale=1.0, outlier=False, dtype=np.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    if outlier:
        x[..., 7] += 4.0
    # a bf16 round trip: both sides see exactly representable bf16 values
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy().astype(dtype)


def _assert_codes(a, b):
    a = np.asarray(a).astype(np.int32)
    b = np.asarray(b).astype(np.int32)
    assert np.mean(a == b) >= 0.999
    assert np.abs(a - b).max() <= 1


def _assert_stat(a, b):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a, dtype=np.float32),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,s_true,scale,outlier", [
    ((1, 2, 512, 64), 400, 2.0, True),
    ((1, 3, 300, 128), 300, 1.0, False),
    ((1, 1, 256, 256), 255, 5.0, True),
])
def test_prep_k_matches_jax(shape, s_true, scale, outlier):
    k = _rand(shape, 1, scale, outlier)
    jr = qp.prep_k_onepass_pallas(jnp.asarray(k), s_true, with_capmax=True,
                                  interpret=True)
    tr = qf.prep_k_onepass(torch.from_numpy(k), s_true, with_capmax=True)
    assert tr[0].dtype == torch.int8 and tuple(tr[0].shape) == shape
    _assert_codes(jr[0], tr[0])
    for a, b in zip(jr[1:], tr[1:]):
        assert tuple(b.shape) == a.shape
        _assert_stat(a, b)


@pytest.mark.parametrize("shape,s_true,scale", [
    ((1, 2, 512, 64), 512, 3.0),
    ((1, 2, 384, 128), 333, 1.0),
    ((2, 1, 128, 64), 100, 0.5),
])
def test_prep_v_matches_jax(shape, s_true, scale):
    v = _rand(shape, 2, scale)
    jr = qp.prep_v_onepass_pallas(jnp.asarray(v), s_true, interpret=True)
    tr = qf.prep_v_onepass(torch.from_numpy(v), s_true)
    _assert_codes(jr[0], tr[0])
    for a, b in zip(jr[1:], tr[1:]):
        assert tuple(b.shape) == a.shape
        _assert_stat(a, b)


def test_prep_k_without_capmax_and_bf16_input():
    k = _rand((1, 2, 256, 64), 3, 2.0, True)
    three = qf.prep_k_onepass(torch.from_numpy(k).to(torch.bfloat16), 256)
    assert len(three) == 3
    four = qf.prep_k_onepass(torch.from_numpy(k), 256, with_capmax=True)
    for a, b in zip(three, four):
        assert torch.equal(a, b)


def test_prep_constant_slice_has_unit_scale():
    k = np.full((1, 1, 128, 64), 0.75, np.float32)
    k8, km, amax, cap = qf.prep_k_onepass(torch.from_numpy(k), 128, with_capmax=True)
    assert int(k8.abs().max()) == 0 and float(amax.max()) == 0.0
    assert float(cap.max()) == 0.0
    np.testing.assert_allclose(km.numpy(), 0.75)


@pytest.mark.parametrize("s_true", [0, 129])
def test_prep_rejects_bad_s_true(s_true):
    with pytest.raises(ValueError):
        qf.prep_k_onepass(torch.zeros(1, 1, 128, 64), s_true)


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import sageattention_tpu_torch, sageattention_tpu_torch.models\n"
            "import sageattention_tpu_torch.ops.attention, sageattention_tpu_torch.ops.quant_fused\n"
            "import sageattention_tpu_torch.ops.quant_kernels, sageattention_tpu_torch.ops.quant\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', 'sageattention_tpu.'))"
            " or m == 'sageattention_tpu']\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_kernel_path_without_a_card_raises(monkeypatch):
    """The kernel path builds and launches or raises: it never hands back the
    plain result."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    k = torch.from_numpy(_rand((1, 1, 128, 64), 4))
    with pytest.raises(RuntimeError, match="nvcc"):
        qf._launch(k, 128, per_channel=False, capmax=True)
    from sageattention_tpu_torch.ops.attention import AttnConfig, attention_kernel
    cfg = AttnConfig(quantized=False, sm_scale=0.125)
    with pytest.raises(RuntimeError, match="nvcc"):
        attention_kernel(k, k, k, cfg)


def test_non_cpu_non_cuda_device_raises():
    k = torch.empty((1, 1, 128, 64), device="meta")
    with pytest.raises(NotImplementedError):
        qf.prep_k_onepass(k, 128)
    with pytest.raises(NotImplementedError):
        qf.prep_v_onepass(k, 128)

