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
version within 1e-5 of JAX's kernel (under ``jax.jit``, 64-wide blocks) and
its lse within 1e-4.

B4-fp4's Hopper route (``csrc/flash_sm90.cu``'s FP4 mode, which no CPU
runs): ``flash_sm90_route`` takes it at head dims 64, 128 and 256 over
every launch key; ``attention_kernel`` hands ``sage_flash_fwd`` mode 2 and
the plain version's 64-column tile (recorded, not run); a failed launch
raises; and the kernel's rounding from the bits of x, emulated here in
numpy float32, equals the plain rule exactly wherever the kernel takes it
(away from a midpoint, where it would redo the element by the plain rule).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu.ops import attention as jatt
from sageattention_tpu.ops import lowbit as jlow
from sageattention_tpu.ops.reference import sdpa as jsdpa
import sageattention_tpu_torch as tsa
from sageattention_tpu_torch.ops import _build
from sageattention_tpu_torch.ops import attention as tatt
from sageattention_tpu_torch.ops import lowbit as tlow
from sageattention_tpu_torch.utils.testing import calc_diff

from port_cpu import yield_cpu  # noqa: F401  (one torch thread, low CPU priority)


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


@functools.lru_cache(maxsize=None)
def _jax_fp4_call(jcfg):
    return jax.jit(lambda q, k, v: jatt.attention_call(q, k, v, cfg=jcfg, interpret=True))


@pytest.mark.parametrize("S,kv_len,causal,D", [(256, 256, False, 64), (200, 200, True, 128),
                                               (256, 190, False, 128), (192, 150, False, 256)])
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
    j_out, j_lse = _jax_fp4_call(jcfg)(*(pad(x).astype(jnp.bfloat16) for x in (q, k, v)))
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


# ---- B4-fp4's Hopper route (csrc/flash_sm90.cu, mode 2) ----

def test_fp4_route_takes_b4_fp4_at_every_head_dim():
    """``flash_sm90_route`` takes the one B4-fp4 configuration at head dims
    64, 128 and 256 (``sageattn3_tiled`` pads to those), and of the other
    launch keys only B4 and B4-float; the plain version then walks
    ``KV_TILE`` columns for B4-fp4 (the tile whose row max sets the e2m1
    scale), ``flash_kv_tile`` for B4."""
    seen = set()
    for cfg, rows in tatt._launch_configs():
        try:
            name = tatt.config_name(cfg, rows)
        except ValueError:
            continue
        seen.add(name)
        for D in (64, 128, 256):
            got = tatt.flash_sm90_route(cfg, rows, D)
            assert got == (name in ("B4", "B4-fp4") or (name == "B4-float" and D < 256)), (
                name, D)
    assert seen == set(tatt.LAUNCH_KEYS) and "B4-fp4" in seen


def _record(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "call", lambda fn, device, *args: calls.append((fn, args)))
    return calls


@pytest.mark.parametrize("D", [64, 128, 256])
def test_fp4_dispatch(monkeypatch, D):
    """B4-fp4 goes to ``sage_flash_fwd`` with mode 2 and the 64-column
    tile at every head dim: Q, K and V as bf16 with their own strides (an
    NHD-strided Q included), no bias, the lse pointer, the true kv length
    and causality; the launch key is counted."""
    calls = _record(monkeypatch)
    rng = np.random.default_rng(D)
    B, Hq, Hk, S = 1, 4, 2, 200
    q = torch.from_numpy(rng.standard_normal((B, S, Hq, D)).astype(np.float32)).to(
        torch.bfloat16).transpose(1, 2)
    k, v = (torch.from_numpy(rng.standard_normal((B, Hk, S, D)).astype(np.float32)).to(
        torch.bfloat16) for _ in range(2))
    cfg = tatt.AttnConfig(quantized=False, p_sim_fp4=True, causal=True, kv_len=S,
                          sm_scale=D ** -0.5)
    before = tatt.attention_call.launches["B4-fp4"]
    out, lse, lmin = tatt.attention_kernel(q, k, v, cfg)
    assert [fn for fn, _ in calls] == ["sage_flash_fwd"] and lmin is None
    assert tatt.attention_call.launches["B4-fp4"] == before + 1
    args = calls[0][1]
    assert args[:3] == (D, tatt.KV_TILE, 2) and tatt.KV_TILE == 64
    assert args[3:5] == (q.data_ptr(), k.data_ptr()) and args[5] == v.data_ptr()
    assert args[7:10] == q.stride()[:3] and args[10:13] == k.stride()[:3]
    assert args[19:24] == (None, 0, 0, 0, 1)            # no bias
    assert args[24] == lse.data_ptr()
    assert args[25:] == (B, Hq, Hk, S, S, S, 1, np.float32(D ** -0.5 * tatt.LOG2E))
    assert out.dtype == torch.bfloat16 and out.shape == (B, Hq, S, D)


def test_a_failed_fp4_launch_raises(monkeypatch):
    """An error code from ``sage_flash_fwd`` raises with its message:
    nothing falls back to another kernel or to the plain version."""
    class Lib:
        calls = []

        def sage_flash_fwd(self, *args):
            self.calls.append(args)
            return -1

        def sage_flash_error_string(self, e):
            return b"unsupported flash configuration"

    lib = Lib()
    monkeypatch.setattr(_build, "build_all", lambda: {"flash_sm90": lib})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    q, k, v = (torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16) for _ in range(3))
    cfg = tatt.AttnConfig(quantized=False, p_sim_fp4=True, sm_scale=128 ** -0.5)
    with pytest.raises(RuntimeError, match="sage_flash_fwd failed to launch: "
                                           "unsupported flash configuration"):
        tatt.attention_kernel(q, k, v, cfg)
    assert len(lib.calls) == 1


def _e2m1_bits(p, s, r):
    """csrc/flash_sm90.cu's ``e2m1_fast`` in numpy float32: x = p * r, z =
    x + 1 below 1, z rounded to one mantissa bit with a tie down, less that
    1, times s; and whether z lies within 16 ulps of a tie (``near``)."""
    f32, u32 = np.float32, np.uint32
    x = (p * r).astype(f32)
    c = np.where(x < f32(1), f32(1), f32(0))
    u = (x + c).astype(f32).view(u32)
    near = ((u + u32(0x1FFFFF + 16)) & u32(0x3FFFE0)) == 0
    qz = ((u + u32(0x1FFFFF)) & u32(0xFFC00000)).view(f32)
    return ((qz - c).astype(f32) * s).astype(f32), near


def test_kernel_e2m1_bit_rounding_is_the_plain_rule():
    """The kernel's rounding from the bits of x = p * (1 / s) equals the
    plain rule (x = p / s, strict > at each midpoint) on every element it
    does not flag; the flagged ones (redone by the plain rule on the card)
    are rare on random P and include every p at or next to a midpoint."""
    rng = np.random.default_rng(12)
    f32 = np.float32
    pmax = np.exp2(-rng.uniform(0, 30, (64, 1))).astype(f32)
    pmax[0] = 0.0                        # an all-masked row: the 1e-30 floor
    s = (np.maximum(pmax, f32(1e-30)) * f32(1.0 / 6.0)).astype(f32)
    r = (f32(1) / s).astype(f32)
    p = (rng.uniform(0, 1, (64, 4096)).astype(f32) ** 3 * pmax).astype(f32)
    p[:, 0] = pmax[:, 0]                 # the row max itself: 6
    mids = np.array([0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0], f32)
    edge = (mids[None, :, None] * s[:, :, None]).astype(f32)
    edge = np.concatenate([np.nextafter(edge, f32(0)), edge, np.nextafter(edge, f32(9))], -1)
    p = np.concatenate([p, edge.reshape(64, -1)], -1)
    want = tatt._round_e2m1_tile(torch.from_numpy(p), torch.from_numpy(pmax)).numpy()
    got, near = _e2m1_bits(p, s, r)
    assert np.array_equal(got[~near], want[~near])
    assert near[:, 4096:].all()                            # at and next to each midpoint
    assert near[:, :4096].mean() < 1e-3
    assert np.array_equal(got[1:, 0], (f32(6) * s[1:, 0]).astype(f32))
