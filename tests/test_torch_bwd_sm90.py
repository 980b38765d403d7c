"""The route of C1/C2 onto ``csrc/backward_sm90.cu`` (``ops/backward.py``),
and the backward at the shapes whose tiles that kernel cuts differently
from ``csrc/backward.cu`` (blocks of 192 rows at head dim 64 and of 128
at head dim 128, over 64-row tiles: lengths that are not multiples of the
block, Sq != Sk, GQA, a given ``di`` with f32 outputs), against the JAX
package's ``attention_backward_pallas`` run in interpret mode and against
float64 autodiff of exact attention, on the same numpy inputs.

No card here: the launches are recorded instead of run (``_build.call``
patched), and the gradients come from the plain version, which is the
kernel's on a CUDA tensor.  Bars as ``tests/test_torch_backward.py``:
calc_diff < 1e-4 against JAX (the same rounding points, f32 sums in
another order), relative max error < 3e-2 against the exact gradient.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu.ops.backward_pallas import attention_backward_pallas
from sageattention_tpu.utils.testing import calc_diff
from sageattention_tpu_torch.ops import _build
from sageattention_tpu_torch.ops import backward as tbwd

JAX_BAR = 1e-4
ORACLE_REL = 3e-2
SM90_KEYS = {"C1-bf16", "C1-bf16-causal", "C2-bf16", "C2-bf16-causal"}


def _configs():
    """Every launch key with its (quantized, causal, window, masked)."""
    for kernel, quant, (causal, window), masked in itertools.product(
            ("C1", "C2"), (False, True), ((False, 0), (True, 0), (True, 64)), (False, True)):
        yield tbwd.config_name(kernel, quant, causal, window, masked), quant, causal, window, masked


def test_route_takes_exactly_the_bf16_unmasked_keys():
    seen = set()
    for D in (64, 128, 256):
        for name, quant, causal, window, masked in _configs():
            seen.add(name)
            routed = tbwd.bwd_sm90_route(quant, masked, window, D)
            assert routed == (name in SM90_KEYS and D != 256), (name, D)
    assert seen == set(tbwd.LAUNCH_KEYS)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("name,quant,causal,window,masked",
                         [c for c in _configs() if c[0].startswith("C1")])
def test_kernel_entry_per_configuration(monkeypatch, D, name, quant, causal, window, masked):
    """``attention_backward_kernel`` launches C1 then C2 through
    ``sage_bwd_sm90`` when routed and ``sage_attn_bwd`` otherwise, and
    counts both under the configuration's launch keys."""
    calls = []
    monkeypatch.setattr(_build, "call", lambda fn, device, *args: calls.append((fn, args)))
    B, Hq, Hk, Sqp, Skp = 2, 4, 1, 192, 320
    r = np.random.RandomState(D)
    q, do = (torch.tensor(r.randn(B, Hq, Sqp, D)) for _ in range(2))
    k, v = (torch.tensor(r.randn(B, Hk, Skp, D)) for _ in range(2))
    kw = dict(fold=0.2, dk_fin=0.125, dq_fin=0.125, causal=causal, window=window,
              sinks=0, out_dtype=torch.float32)
    if quant:
        q, kw["qs"] = q.to(torch.int8), torch.ones(B, Hq, Sqp)
        k, kw["ks"] = k.to(torch.int8), torch.ones(B, Hk, Skp)
    else:
        q, k = q.bfloat16(), k.bfloat16()
    if masked:
        kw["mask"] = torch.ones(B, 1, Sqp, Skp, dtype=torch.bool)
    keys = [name, "C2" + name[2:]]
    before = [tbwd.attention_backward_kernel.launches[n] for n in keys]
    tbwd.attention_backward_kernel(q, k, v, do, torch.zeros(B, Hq, Sqp), torch.zeros(B, Hq, Sqp),
                                   **kw)
    routed = name in SM90_KEYS and D != 256
    entry = "sage_bwd_sm90" if routed else "sage_attn_bwd"
    assert [fn for fn, _ in calls] == [entry, entry]
    assert [args[0] for _, args in calls] == [1, 2]   # which: C1, then C2
    assert [tbwd.attention_backward_kernel.launches[n] for n in keys] == [b + 1 for b in before]
    if routed:
        args = calls[0][1]
        assert args[1] == D and len(args) == len(_build.SIGNATURES[entry][1]) - 1
        # (out_f32, B, Hq, Hk, Sqp, Skp, causal) and the three factors
        assert args[11:18] == (1, B, Hq, Hk, Sqp, Skp, int(causal))
        assert args[18:] == pytest.approx((0.2, 0.125, 0.125))


def test_routed_launch_raises_without_fallback(monkeypatch):
    """A routed configuration whose launch fails raises; nothing else is
    tried."""
    calls = []

    def fail(fn, device, *args):
        calls.append(fn)
        raise RuntimeError(f"{fn} failed to launch")

    monkeypatch.setattr(_build, "call", fail)
    x = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="sage_bwd_sm90"):
        tbwd.attention_backward_kernel(x, x, x, x, torch.zeros(1, 2, 64), torch.zeros(1, 2, 64),
                                       fold=1.0, dk_fin=1.0, dq_fin=1.0, causal=False)
    assert calls == ["sage_bwd_sm90"]


# ------------------------------------------------------ against JAX ----

def _exact(q, k, v, causal, sm):
    """float64 attention, top-left causal; returns (o, lse)."""
    G = q.shape[1] // k.shape[1]
    s = q @ k.repeat_interleave(G, 1).transpose(-1, -2) * sm
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = torch.where(keep, s, torch.tensor(-torch.inf, dtype=s.dtype))
    lse = torch.logsumexp(s, -1)
    return torch.exp(s - lse[..., None]) @ v.repeat_interleave(G, 1), lse


@functools.lru_cache(maxsize=None)
def _jax_bwd(causal, given_di):
    def f(q, k, v, o, lse, do, di):
        return attention_backward_pallas(q, k, v, None if given_di else o, lse, do,
                                         sm_scale=q.shape[-1] ** -0.5, is_causal=causal,
                                         di=di if given_di else None,
                                         out_dtype=jnp.float32 if given_di else None,
                                         interpret=True)
    return jax.jit(f)


CASES = {   # name: B, Hq, Hk, Sq, Sk, D, causal, given di with f32 outputs
    "192_causal_d64": (1, 2, 2, 192, 192, 64, True, False),
    "320_d128": (1, 2, 2, 320, 320, 128, False, False),
    "320_causal_d128": (1, 2, 1, 320, 320, 128, True, False),
    "192x320_d64": (1, 2, 1, 192, 320, 64, False, False),
    "192x320_d128": (2, 2, 2, 192, 320, 128, False, False),
    "gqa4_causal_d64": (1, 4, 1, 320, 320, 64, True, False),
    "gqa4_d128": (1, 4, 1, 192, 192, 128, False, False),
    "given_di_f32_causal": (1, 4, 1, 192, 192, 128, True, True),
    "given_di_f32_192x320": (1, 2, 2, 192, 320, 64, False, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_jax_and_exact(case):
    B, Hq, Hk, Sq, Sk, D, causal, given_di = CASES[case]
    r = np.random.RandomState(len(case) + Sk)
    q, do = (r.randn(B, Hq, Sq, D).astype(np.float32) for _ in range(2))
    k, v = (r.randn(B, Hk, Sk, D).astype(np.float32) for _ in range(2))
    t = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in (q, k, v)]
    o64, lse64 = _exact(*t, causal, D ** -0.5)
    ref = torch.autograd.grad(o64, t, torch.tensor(do, dtype=torch.float64))
    o, lse = o64.detach().float().numpy(), lse64.detach().float().numpy()
    # as the ring hands it over: rowsum(dO * O) with dO in bf16
    di = (torch.tensor(do).bfloat16().float() * torch.tensor(o)).sum(-1).numpy()
    tt = [torch.tensor(x) for x in (q, k, v, o, lse, do)]
    kw = dict(di=torch.tensor(di), out_dtype=torch.float32) if given_di else {}
    got = tbwd.attention_backward(*tt[:3], None if given_di else tt[3], tt[4], tt[5],
                                  sm_scale=D ** -0.5, is_causal=causal, **kw)
    jax_got = _jax_bwd(causal, given_di)(*(jnp.asarray(x) for x in (q, k, v, o, lse, do, di)))
    for a, j, e, n in zip(got, jax_got, ref, "qkv"):
        a, j = a.double().numpy(), np.asarray(j, np.float64)
        e = e.numpy()
        assert a.shape == j.shape == e.shape, f"d{n}"
        assert np.isfinite(a).all(), f"d{n}"
        assert calc_diff(a, j) < JAX_BAR, f"d{n} vs JAX"
        assert np.abs(a - e).max() / np.abs(e).max() < ORACLE_REL, f"d{n} vs exact"
