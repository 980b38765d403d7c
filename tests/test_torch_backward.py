"""The port's attention backward (``ops/backward.py``, kernels C1/C2, and the
autograd of the public entries) against the JAX package's
``attention_backward_pallas`` run in interpret mode and against float64
autodiff of exact attention, on the same numpy inputs.

Bars:

- the plain version against JAX's kernels: calc_diff < 1e-4 per gradient.
  Both round at the same points (P and dS to bf16 for the products, f32
  sums); what differs is the order of the f32 sums, over the port's 64-row
  tiles against JAX's 128- to 2048-row blocks;
- against the exact float64 gradient (``tests/test_backward_pallas.py``):
  relative max error < 3e-2 for the bf16 backward, cosine distance
  < 1.5e-3 for the int8 one;
- gradients through the public entries against ``jax.grad`` through JAX's
  and against the exact gradient: relative max error < 0.05-0.06
  (``tests/test_mask_grad.py``, ``tests/test_sliding_window.py``); a window
  wider than the sequence equals plain causal within 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sageattention_tpu as jsa
import sageattention_tpu_torch as tsa
from sageattention_tpu.models import sage_dot_product_attention as j_sdpa
from sageattention_tpu.ops.backward_pallas import attention_backward_pallas
from sageattention_tpu.utils.testing import calc_diff
from sageattention_tpu_torch.models import sage_dot_product_attention
from sageattention_tpu_torch.ops import backward as tbwd

from port_cpu import yield_cpu  # noqa: F401  (one torch thread, low CPU priority)

JAX_BAR = 1e-4
ORACLE_REL = 3e-2
INT8_COS = 1.5e-3
API_REL = 6e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _keep(Sq, Sk, causal=False, window=0, sinks=0, mask=None):
    r = np.arange(Sq)[:, None]
    c = np.arange(Sk)[None, :]
    keep = np.ones((Sq, Sk), bool)
    if causal:
        keep &= c <= r
        if window:
            keep &= (c >= r - (window - 1)) | (c < sinks)
    keep = keep[None, None]
    return keep if mask is None else keep & mask


def _exact(q, k, v, keep, sm):
    """float64 attention with a keep-mask [B|1, H|1, Sq, Sk]; a row with no
    kept key gives 0."""
    G = q.shape[1] // k.shape[1]
    s = q @ k.repeat_interleave(G, 1).transpose(-1, -2) * sm
    keep = torch.as_tensor(keep)
    zero = torch.zeros((), dtype=s.dtype)
    m = torch.where(keep, s, torch.tensor(-1e300, dtype=s.dtype)).amax(-1, keepdim=True)
    m = torch.where(keep.any(-1, keepdim=True), m, zero)   # no kept key: any finite shift
    p = torch.where(keep, torch.exp(torch.where(keep, s, zero) - m), zero)
    l = p.sum(-1, keepdim=True)
    o = (p / torch.clamp_min(l, 1e-300)) @ v.repeat_interleave(G, 1)
    return o, (m + torch.log(l))[..., 0]


def _setup(B=1, Hq=2, Hk=2, Sq=256, Sk=256, D=64, causal=False, window=0, sinks=0,
           mask=False, seed=0):
    """Inputs, the float64 forward (o, lse) and exact gradients for dO."""
    r = np.random.RandomState(seed)
    q, do = (r.randn(B, Hq, Sq, D).astype(np.float32) for _ in range(2))
    k, v = (r.randn(B, Hk, Sk, D).astype(np.float32) for _ in range(2))
    m = None
    if mask:
        m = r.rand(B, 1, Sq, Sk) < 0.85
        m[:, :, :5] = False    # left-pad rows: no kept key at all
    keep = _keep(Sq, Sk, causal, window, sinks, m)
    t = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in (q, k, v)]
    o, lse = _exact(*t, keep, D ** -0.5)
    ref = torch.autograd.grad(o, t, torch.tensor(do, dtype=torch.float64))
    lse = torch.where(torch.isfinite(lse), lse, torch.tensor(-np.inf, dtype=lse.dtype))
    return (q, k, v, o.detach().float().numpy(), lse.detach().float().numpy(), do, m), ref


CASES = {   # name: setup kwargs, plus quantized
    "full": dict(),
    "causal": dict(causal=True),
    "gqa_unaligned": dict(Hq=2, Hk=1, Sq=200, Sk=333),
    "gqa_causal_unaligned": dict(Hq=2, Hk=1, Sq=300, Sk=300, causal=True),
    "int8": dict(quantized=True),
    "int8_causal": dict(quantized=True, causal=True, Sq=300, Sk=300),
    "window_sinks": dict(causal=True, window=100, sinks=4, Sq=384, Sk=384),
    "bool_mask": dict(mask=True, Sk=320),
    "bool_mask_int8_causal": dict(mask=True, quantized=True, causal=True),
}


@functools.lru_cache(maxsize=None)
def _jax_bwd(causal, quantized, window, sinks):
    def f(q, k, v, o, lse, do, mask):
        return attention_backward_pallas(q, k, v, o, lse, do, sm_scale=q.shape[-1] ** -0.5,
                                         is_causal=causal, attn_mask=mask, quantized=quantized,
                                         window=window, sinks=sinks, interpret=True)
    return jax.jit(f)


@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_jax_and_exact(case):
    kw = dict(CASES[case])
    quantized = kw.pop("quantized", False)
    (q, k, v, o, lse, do, m), ref = _setup(seed=len(case), **kw)
    causal, window, sinks = kw.get("causal", False), kw.get("window", 0), kw.get("sinks", 0)
    sm = q.shape[-1] ** -0.5
    got = tbwd.attention_backward(
        *(torch.tensor(x) for x in (q, k, v, o, lse, do)), sm_scale=sm, is_causal=causal,
        attn_mask=None if m is None else torch.tensor(m), quantized=quantized, window=window,
        sinks=sinks)
    jax_got = _jax_bwd(causal, quantized, window, sinks)(
        *(jnp.asarray(x) for x in (q, k, v, o, lse, do)), None if m is None else jnp.asarray(m))
    for a, j, r, n in zip(got, jax_got, ref, "qkv"):
        assert a.shape == j.shape and a.dtype == torch.float32
        assert np.isfinite(_np(a)).all(), f"d{n}"
        assert calc_diff(_np(a), _np(j)) < JAX_BAR, f"d{n} vs JAX"
        if quantized:
            assert calc_diff(_np(a), _np(r)) < INT8_COS, f"d{n} vs exact"
        else:
            assert _rel(a, r) < ORACLE_REL, f"d{n} vs exact"


def test_bf16_inputs_and_out_dtype():
    """bf16 inputs give bf16 gradients; ``out_dtype`` overrides; a given
    ``di`` replaces ``o``; head dims other than 64/128/256 pad."""
    (q, k, v, o, lse, do, _), ref = _setup(Hq=2, Hk=1, Sq=130, Sk=130, D=80, causal=True,
                                           seed=3)
    t = [torch.tensor(x) for x in (q, k, v, o, lse, do)]
    sm = 80 ** -0.5
    g32 = tbwd.attention_backward(*t, sm_scale=sm, is_causal=True)
    gb = tbwd.attention_backward(*(x.bfloat16() if x.ndim == 4 else x for x in t), sm_scale=sm,
                                 is_causal=True)
    assert all(g.dtype == torch.bfloat16 for g in gb)
    di = (t[5].bfloat16().float() * t[3]).sum(-1)   # as the wrapper: dO in bf16
    gd = tbwd.attention_backward(t[0], t[1], t[2], None, t[4], t[5], sm_scale=sm,
                                 is_causal=True, di=di, out_dtype=torch.float64)
    assert all(g.dtype == torch.float64 for g in gd)
    for a, b, c, r in zip(g32, gb, gd, ref):
        assert _rel(a, r) < ORACLE_REL and _rel(b.float(), r) < ORACLE_REL
        assert calc_diff(_np(a), _np(c)) < 1e-6


def test_launch_keys_and_errors():
    assert tbwd.config_name("C1", True, True, 0, True) == "C1-int8-causal-bool"
    assert tbwd.config_name("C2", False, True, 128, False) == "C2-bf16-window"
    assert len(tbwd.LAUNCH_KEYS) == 24 and set(tbwd.attention_backward_kernel.launches) == set(
        tbwd.LAUNCH_KEYS)
    z = torch.zeros(1, 2, 64, 64)
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="window requires"):
        tbwd.attention_backward(z, z, z, z, lse, z, sm_scale=1.0, is_causal=False, window=8)
    with pytest.raises(ValueError, match="sinks requires"):
        tbwd.attention_backward(z, z, z, z, lse, z, sm_scale=1.0, is_causal=True, sinks=4)
    with pytest.raises(ValueError, match="bool keep-mask"):
        tbwd.attention_backward(z, z, z, z, lse, z, sm_scale=1.0, is_causal=False,
                                attn_mask=torch.zeros(1, 1, 64, 64))


# ------------------------------------------------------ through the API ----

def _qkv(S=256, D=64, H=2, Hk=None, seed=3):
    r = np.random.RandomState(seed)
    return tuple(r.randn(1, h, S, D).astype(np.float32) for h in (H, Hk or H, Hk or H))


def _port_grads(fn, q, k, v, **kw):
    t = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fn(*t, **kw)
    return torch.autograd.grad((out.float() ** 2).sum(), t)


def _jax_grads(fn, q, k, v, **kw):
    f = lambda a, b, c: jnp.sum(fn(a, b, c, **kw).astype(jnp.float32) ** 2)  # noqa: E731
    return jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, k, v)))


def _exact_grads(q, k, v, keep):
    t = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in (q, k, v)]
    o, _ = _exact(*t, keep, q.shape[-1] ** -0.5)
    return torch.autograd.grad((o ** 2).sum(), t)


API_CASES = {   # name: (port fn, jax fn, kwargs, keep kwargs, layout NHD)
    "sageattn_int8_bwd": ("sageattn", dict(pv_dtype="int8"), dict(), False),
    "pv_bf16_bool_mask": ("sageattn_qk_int8_pv_bf16", dict(), dict(mask=True), False),
    "window_sinks": ("sageattn", dict(pv_dtype="int8", is_causal=True, sliding_window=150,
                                      attention_sinks=32), dict(causal=True, window=150,
                                                                sinks=32), False),
    "nhd_gqa_causal_adapter": ("sdpa", dict(is_causal=True), dict(causal=True), True),
}


@pytest.mark.parametrize("case", list(API_CASES))
def test_api_grads_match_jax_and_exact(case):
    name, kw, keep_kw, nhd = API_CASES[case]
    H, Hk = (4, 2) if nhd else (2, 2)
    q, k, v = _qkv(S=384 if "window" in case else 256, H=H, Hk=Hk, seed=len(case))
    kw = dict(kw)
    mask = None
    if keep_kw.pop("mask", False):
        mask = np.random.RandomState(9).rand(1, 1, q.shape[2], k.shape[2]) < 0.8
        keep_kw["mask"] = mask
    keep = _keep(q.shape[2], k.shape[2], **keep_kw)
    ref = _exact_grads(q, k, v, keep)
    if nhd:
        sw = lambda x: np.ascontiguousarray(x.transpose(0, 2, 1, 3))  # noqa: E731
        got = _port_grads(sage_dot_product_attention, sw(q), sw(k), sw(v), **kw)
        jgot = _jax_grads(j_sdpa, sw(q), sw(k), sw(v), **kw)
        got = [g.transpose(1, 2) for g in got]
        jgot = [jnp.swapaxes(g, 1, 2) for g in jgot]
    else:
        pkw, jkw = dict(kw), dict(kw)
        if mask is not None:
            pkw["attn_mask"], jkw["attn_mask"] = torch.tensor(mask), jnp.asarray(mask)
        got = _port_grads(getattr(tsa, name), q, k, v, **pkw)
        jgot = _jax_grads(getattr(jsa, name), q, k, v, **jkw)
    for a, j, r, n in zip(got, jgot, ref, "qkv"):
        assert _rel(a, r) < API_REL, f"d{n} vs exact"
        assert _rel(a, j) < API_REL, f"d{n} vs JAX"


@pytest.mark.parametrize("entry", ["sageattn_qk_int8_pv_int8", "sageattn_qk_int8_pv_fp8",
                                   "sageattn_qk_int8_pv_fp8_cuda_sm90"])
def test_explicit_entries_grads_match_exact(entry):
    """Every explicit entry is differentiable (causal: the bf16 backward;
    non-causal: the int8 one), within the API bar of the exact gradient."""
    q, k, v = _qkv(seed=21)
    for causal in (False, True):
        got = _port_grads(getattr(tsa, entry), q, k, v, is_causal=causal)
        ref = _exact_grads(q, k, v, _keep(256, 256, causal))
        for a, r, n in zip(got, ref, "qkv"):
            assert _rel(a, r) < API_REL, f"{entry} causal={causal} d{n}"


def test_quant_backward_switch_and_wide_window():
    """``quant_backward`` picks the backward: the bf16 one (False) is the
    tighter of the two and the paths differ; a window wider than the
    sequence gives the plain causal gradient within 1e-4."""
    q, k, v = _qkv(seed=8)
    ref = _exact_grads(q, k, v, _keep(256, 256))
    g8 = _port_grads(tsa.sageattn_qk_int8_pv_bf16, q, k, v)
    gb = _port_grads(tsa.sageattn_qk_int8_pv_bf16, q, k, v, quant_backward=False)
    for a, b, r in zip(g8, gb, ref):
        assert _rel(a, r) < API_REL and _rel(b, r) < ORACLE_REL
        assert float((a - b).abs().max()) > 0.0
    wide = _port_grads(tsa.sageattn, q, k, v, is_causal=True, sliding_window=4096)
    causal = _port_grads(tsa.sageattn, q, k, v, is_causal=True)
    for a, b in zip(wide, causal):
        assert float((a - b).abs().max()) < 1e-4


def test_float_bias_and_return_lse_raise_on_backward():
    q, k, v = (torch.tensor(x, requires_grad=True) for x in _qkv(S=128, seed=5))
    bias = torch.randn(1, 1, 128, 128)
    out = tsa.sageattn_qk_int8_pv_bf16(q, k, v, attn_mask=bias)
    with pytest.raises(NotImplementedError, match="float additive-bias"):
        out.sum().backward()
    out, lse = tsa.sageattn(q, k, v, return_lse=True)
    assert lse.shape == (1, 2, 128)
    with pytest.raises(NotImplementedError, match="return_lse"):
        out.sum().backward()
    with torch.no_grad():   # inference is untouched
        assert tsa.sageattn(q, k, v, attn_mask=bias).shape == q.shape
