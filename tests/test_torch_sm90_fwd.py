"""B4-float (the ALiBi-style biased bf16 flash) and B1 (the static fused-Q
int8 forward) on their Hopper routes (``csrc/flash_sm90.cu``'s biased
instantiations, ``csrc/attention_sm90.cu``): the biased flash's plain
version at the kernel's 64-column kv tiles against the JAX package's
``attention_call(masked="float", quantized=False)`` (Pallas, interpret mode,
64-wide blocks, under ``jax.jit``) and a float64 oracle; which
configurations, head dims and Q dtypes each route takes; and what
``attention_kernel`` hands each entry (recorded, not run: no card here).

Inputs are bf16-exact float32 from a numpy seed.  Bars: port vs JAX
calc_diff < 1e-5 (the same 64-wide tiles, so P rounds against the same
running maxima; tests/test_torch_masks.py's bar), base-2 lse within 1e-4
of JAX's; port vs the float64 oracle < 2e-5 (the flash bar of
tests/test_attention.py).  Rows whose every key is masked (a bias row of
-inf) are compared apart: zeros, and the plain version's lse.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu.ops import attention as jatt
from sageattention_tpu_torch.ops import _build
from sageattention_tpu_torch.ops import attention as tatt
from sageattention_tpu_torch.utils.testing import calc_diff

from port_cpu import yield_cpu  # noqa: F401  (one torch thread, low CPU priority)

JAX_BAR = 1e-5
ORACLE_BAR = 2e-5
LSE_JAX_ATOL = 1e-4
S = 192   # a multiple of JAX's 64-row blocks
DEAD_ROW = 5


def _bf16_exact(shape, rng, scale=1.0):
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(torch.bfloat16).float()


def _biased_inputs(Hq, Hk, Hm, D, seed):
    """q, k, v and an ALiBi-like bias [1, Hm, S, S] with a column of -inf
    and one row (DEAD_ROW) that masks every key."""
    rng = np.random.default_rng(seed)
    q = _bf16_exact((1, Hq, S, D), rng)
    k = _bf16_exact((1, Hk, S, D), rng)
    v = _bf16_exact((1, Hk, S, D), rng)
    pos = np.arange(S, dtype=np.float32)
    slope = (np.arange(1, Hm + 1, dtype=np.float32) * 0.05)[None, :, None, None]
    bias = -slope * np.abs(pos[:, None] - pos[None, :])[None, None]
    bias = bias + rng.standard_normal(bias.shape).astype(np.float32) * 0.5
    bias[..., 7] = -np.inf
    bias[:, :, DEAD_ROW, :] = -np.inf
    return q, k, v, torch.from_numpy(bias.astype(np.float32))


def _oracle(q, k, v, bias, causal, kv_len, sm_scale):
    """float64 attention with the additive bias, the causal mask and the kv
    tail; a row with no live key gives zeros."""
    q, k, v, bias = (x.double() for x in (q, k, v, bias))
    G = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    s = q @ k.transpose(-1, -2) * sm_scale + bias
    c = torch.arange(S)
    keep = (c[None, :] < kv_len) & ((c[None, :] <= c[:, None]) if causal else True)
    s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    p = torch.nan_to_num(p)
    return (p @ v) / p.sum(-1, keepdim=True).clamp_min(1e-300)


@functools.lru_cache(maxsize=None)
def _jax_biased(cfg):
    return jax.jit(lambda q, k, v, m: jatt.attention_call(q, k, v, attn_mask=m, cfg=cfg,
                                                          interpret=True))


# (D, causal, Hq, Hk, Hm, kv_len)
BIASED = [
    (64, False, 2, 1, 2, S),     # GQA 2:1, a bias per head
    (64, True, 2, 2, 1, S),      # one bias for all heads
    (128, True, 2, 1, 2, S),
    (128, False, 2, 2, 1, 150),  # kv_len < Sk
]


@pytest.mark.parametrize("D,causal,Hq,Hk,Hm,kv_len", BIASED)
def test_biased_flash_matches_jax_and_oracle(D, causal, Hq, Hk, Hm, kv_len):
    q, k, v, bias = _biased_inputs(Hq, Hk, Hm, D, seed=D + Hm + kv_len + causal)
    fields = dict(block_q=64, block_k=64, causal=causal, quantized=False, emit_lse=True,
                  sm_scale=D ** -0.5, masked="float", kv_len=kv_len)
    tcfg = tatt.AttnConfig(**fields, out_dtype=torch.float32)
    assert tatt.flash_sm90_route(tcfg, S, D) and tatt.config_name(tcfg, S) == "B4-float"
    out, lse = tatt.attention_call(q, k, v, attn_mask=bias, cfg=tcfg)
    jo, jl = _jax_biased(jatt.AttnConfig(**fields, out_dtype=jnp.float32))(
        *(jnp.asarray(x.numpy()) for x in (q, k, v, bias)))
    live = torch.ones(S, dtype=torch.bool)
    live[DEAD_ROW] = False
    assert calc_diff(out[:, :, live], np.asarray(jo)[:, :, live.numpy()]) < JAX_BAR
    np.testing.assert_allclose(lse[:, :, live].numpy(), np.asarray(jl)[:, :, live.numpy()],
                               atol=LSE_JAX_ATOL, rtol=0)
    ref = _oracle(q, k, v, bias, causal, kv_len, D ** -0.5)
    assert calc_diff(out[:, :, live], ref[:, :, live]) < ORACLE_BAR
    # the row that sees no key: zeros, and m + log2(l) at the floor of both
    assert float(out[:, :, DEAD_ROW].abs().max()) == 0.0
    dead = lse[:, :, DEAD_ROW]
    floor = tatt.M_CLAMP + float(np.log2(np.float32(1e-37)))
    assert torch.equal(dead, torch.full_like(dead, floor))


def _configs():
    """Every configuration the launch keys come from, the flash ones with
    each option, and B1 with each Q-side choice."""
    yield from (dataclasses.replace(c, causal=True) for c in _base_configs())
    flash = tatt.AttnConfig(quantized=False)
    yield from (flash, dataclasses.replace(flash, p_sim_fp4=True),
                dataclasses.replace(flash, causal=True, window=64, sinks=4),
                dataclasses.replace(flash, masked="float", segmented=True))


def _base_configs():
    for quantized in (True, False):
        for pv in ("int8", "fp8", "bf16"):
            for cd in ("native", "bf16"):
                for sm in ("static", "online"):
                    for fqq, via in ((True, False), (True, True), (False, False)):
                        for masked in ("none", "bool", "float"):
                            for window in (0, 1):
                                yield tatt.AttnConfig(
                                    quantized=quantized, pv_dtype=pv, compute_dtype=cd,
                                    softmax_mode=sm, fuse_q_quant=fqq, fold_k_scale=True,
                                    pv_via_bf16=via, masked=masked, window=window)


def test_routes_take_exactly_their_configurations():
    """``flash_sm90_route`` takes exactly B4 and B4-fp4 (head dims 64, 128
    and 256) and B4-float (64 and 128); ``b1_sm90_route`` exactly B1 and
    the fused-Q B-pvbf16 with native compute on a bf16 Q at 64 and 128.
    Every other key, head dim and Q dtype stays on ``attention.cuh``."""
    seen = set()
    for cfg in _configs():
        try:
            name = tatt.config_name(cfg, 512)
        except ValueError:
            continue
        seen.add(name)
        for D in (64, 128, 256):
            assert tatt.flash_sm90_route(cfg, 512, D) == (
                name in ("B4", "B4-fp4") or (name == "B4-float" and D < 256)), (name, D)
            for dtype in (torch.bfloat16, torch.float32, torch.float16):
                fused_bf16_v = (name == "B-pvbf16" and cfg.fuse_q_quant
                                and cfg.compute_dtype == "native")
                assert tatt.b1_sm90_route(cfg, 512, D, dtype) == (
                    (name == "B1" or fused_bf16_v) and D < 256 and dtype == torch.bfloat16), (
                        name, D, dtype)
    assert {"B1", "B2", "B1-float", "B1-window", "B4", "B4-float", "B4-bool", "B4-window",
            "B4-fp4", "B4-float-seg"} <= seen
    ring = tatt.AttnConfig(quantized=False, causal=True, causal_dynamic=True,
                           kv_len_dynamic=True, masked="float")
    assert not tatt.flash_sm90_route(ring, 512, 128)


def _record(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "call", lambda fn, device, *args: calls.append((fn, args)))
    return calls


# the bias arguments of sage_flash_fwd: after (D, tile, mode), 4 pointers
# and 12 strides come (bias, 3 strides, Hm)
BIAS_AT = 19


@pytest.mark.parametrize("D,entry", [(64, "sage_flash_fwd"), (128, "sage_flash_fwd"),
                                     (256, "sage_attn_fwd_ext")])
def test_biased_flash_dispatch(monkeypatch, D, entry):
    """B4-float at D = 64 and 128 goes to ``sage_flash_fwd`` with the
    plain version's 64-column tile and the bias as it is: a broadcast
    bias's zero batch and head strides are passed through, with no copy;
    at D = 256 it stays on the old build.  The launch key is counted."""
    calls = _record(monkeypatch)
    B, Hq, Hk, Sq = 2, 4, 2, 128
    q, k, v = (torch.zeros(B, h, Sq, D, dtype=torch.bfloat16) for h in (Hq, Hk, Hk))
    row = torch.zeros(1, 1, Sq, Sq)
    bias = row.expand(B, Hq, Sq, Sq)            # zero batch and head strides
    cfg = tatt.AttnConfig(quantized=False, masked="float", causal=True, sm_scale=D ** -0.5)
    before = tatt.attention_call.launches["B4-float"]
    tatt.attention_kernel(q, k, v, cfg, attn_mask=bias)
    assert [fn for fn, _ in calls] == [entry]
    assert tatt.attention_call.launches["B4-float"] == before + 1
    if entry == "sage_flash_fwd":
        args = calls[0][1]
        assert args[:3] == (D, tatt.KV_TILE, 0)
        assert args[BIAS_AT:BIAS_AT + 5] == (row.data_ptr(), 0, 0, Sq, Hq)
        assert args[-8:-1] == (B, Hq, Hk, Sq, Sq, Sq, 1)


def test_biased_flash_pads_only_a_misaligned_bias(monkeypatch):
    """A bias whose rows are not a multiple of 16 bytes apart (Sk = 129
    floats) is copied with rows padded to 132 floats, and only the heads it
    holds: a head-broadcast bias stays broadcast."""
    calls = _record(monkeypatch)
    Sk = 129
    q, k, v = (torch.zeros(1, h, Sk, 64, dtype=torch.bfloat16) for h in (4, 4, 4))
    bias = torch.randn(1, 1, Sk, Sk).expand(1, 4, Sk, Sk)
    cfg = tatt.AttnConfig(quantized=False, masked="float", sm_scale=0.125)
    tatt.attention_kernel(q, k, v, cfg, attn_mask=bias)
    args = calls[0][1]
    assert calls[0][0] == "sage_flash_fwd" and args[BIAS_AT] != bias.data_ptr()
    assert args[BIAS_AT + 1:BIAS_AT + 5] == (132 * Sk, 0, 132, 4)


@pytest.mark.parametrize("D,dtype,entry", [(64, torch.bfloat16, "sage_attn_fwd_sm90"),
                                           (128, torch.bfloat16, "sage_attn_fwd_sm90"),
                                           (128, torch.float32, "sage_attn_fwd"),
                                           (256, torch.bfloat16, "sage_attn_fwd")])
def test_b1_dispatch(monkeypatch, D, dtype, entry):
    """B1 on a bf16 Q at D = 64 and 128 goes to ``sage_attn_fwd_sm90`` with
    the V codes widened to bf16 by ``widen_v_codes`` (their values
    unchanged) and the per-row lmin buffer; an f32 Q or D = 256 stays on
    ``sage_attn_fwd``.  The launch key is counted and lmin returned."""
    calls = _record(monkeypatch)
    widened = []
    real = tatt.widen_v_codes
    monkeypatch.setattr(tatt, "widen_v_codes", lambda v: widened.append(real(v)) or widened[-1])
    B, Hq, Hk, Sq = 1, 4, 2, 200
    rng = np.random.default_rng(D)
    q = torch.from_numpy(rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)).to(dtype)
    k8 = torch.from_numpy(rng.integers(-127, 128, (B, Hk, Sq, D)).astype(np.int8))
    v8 = torch.from_numpy(rng.integers(-127, 128, (B, Hk, Sq, D)).astype(np.int8))
    ones = lambda *s: torch.ones(*s)  # noqa: E731
    cfg = tatt.AttnConfig(quantized=True, pv_dtype="int8", fuse_q_quant=True, fold_k_scale=True,
                          softmax_mode="static", fuse_v_mean=True, sm_scale=D ** -0.5,
                          out_dtype=dtype)
    before = tatt.attention_call.launches["B1"]
    out, lse, lmin = tatt.attention_kernel(
        q, k8, v8, cfg, k_head_scale=ones(B, Hk, 1, 1), kn_max=ones(B, Hq, 1, 1),
        v_scale=ones(B, Hk, 1, D), v_mean=ones(B, Hk, 1, D))
    assert [fn for fn, _ in calls] == [entry]
    assert tatt.attention_call.launches["B1"] == before + 1
    assert tuple(lmin.shape) == (B, Hq, -(-Sq // tatt.Q_TILE)) and out.dtype == dtype
    if entry == "sage_attn_fwd_sm90":
        args = calls[0][1]
        assert args[0] == D and args[1] == q.data_ptr() and args[2] == k8.data_ptr()
        assert len(widened) == 1 and args[3] == widened[0].data_ptr()
        assert widened[0].dtype == torch.bfloat16 and torch.equal(widened[0].float(), v8.float())
        assert args[-8:-1] == (B, Hq, Hk, Sq, Sq, Sq, 0)
        assert args[-9] == lmin.data_ptr()
    else:
        assert not widened
