"""The routes of C1/C2 onto ``csrc/backward_sm90.cu`` (bf16) and
``csrc/backward_q8_sm90.cu`` (the int8 S-recompute) in ``ops/backward.py``,
and the backward, bf16 and int8, at the shapes whose tiles those kernels
cut differently from ``csrc/backward.cu`` (blocks of 192 rows at head dim
64 and of 128 at head dim 128, over 64-row tiles: lengths that are not
multiples of the block, Sq != Sk, GQA, causal, a given ``di`` with f32
outputs), against the JAX package's ``attention_backward_pallas`` run in
interpret mode and against float64 autodiff of exact attention, on the
same numpy inputs.

No card here: the launches are recorded instead of run (``_build.call``
patched), and the gradients come from the plain version, which is the
kernels' on a CUDA tensor.  Bars as ``tests/test_torch_backward.py``:
calc_diff < 1e-4 against JAX (the same rounding points, f32 sums in
another order); against the exact gradient, relative max error < 3e-2 for
the bf16 backward and calc_diff < 1.5e-3 for the int8 one.

Alone: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_bwd_sm90.py -q``.
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

from port_cpu import yield_cpu  # noqa: F401  (one torch thread, low CPU priority)

JAX_BAR = 1e-4
ORACLE_REL = 3e-2
INT8_COS = 1.5e-3
SM90_KEYS = {"C1-bf16", "C1-bf16-causal", "C2-bf16", "C2-bf16-causal"}
# the window, sink and bool-mask forms of the bf16 backward: sage_bwd_sm90_masked
SM90_MASKED_KEYS = {n for n in tbwd.LAUNCH_KEYS if "-bf16" in n} - SM90_KEYS
Q8_SM90_KEYS = {"C1-int8", "C1-int8-causal", "C2-int8", "C2-int8-causal"}


def _configs():
    """Every launch key with its (quantized, causal, window, masked)."""
    for kernel, quant, (causal, window), masked in itertools.product(
            ("C1", "C2"), (False, True), ((False, 0), (True, 0), (True, 64)), (False, True)):
        yield tbwd.config_name(kernel, quant, causal, window, masked), quant, causal, window, masked


def test_route_takes_exactly_the_bf16_unmasked_keys():
    """``bwd_sm90_route`` takes every bf16 key at head dims 64 and 128, with
    or without a window or a mask (the unmasked ones are ``SM90_KEYS``, the
    rest launch the masked entry); no int8 key and no head dim 256."""
    seen = set()
    for D in (64, 128, 256):
        for name, quant, causal, window, masked in _configs():
            seen.add(name)
            routed = tbwd.bwd_sm90_route(quant, masked, window, D)
            assert routed == (name in SM90_KEYS | SM90_MASKED_KEYS and D != 256), (name, D)
    assert seen == set(tbwd.LAUNCH_KEYS)
    assert len(SM90_MASKED_KEYS) == 8 and not SM90_MASKED_KEYS & Q8_SM90_KEYS


def test_q8_route_takes_exactly_the_int8_unmasked_keys():
    seen = set()
    for D in (64, 128, 256):
        for name, quant, causal, window, masked in _configs():
            seen.add(name)
            routed = tbwd.bwd_q8_sm90_route(quant, masked, window, D)
            assert routed == (name in Q8_SM90_KEYS and D != 256), (name, D)
            assert not (routed and tbwd.bwd_sm90_route(quant, masked, window, D)), (name, D)
    assert seen == set(tbwd.LAUNCH_KEYS)


def _entry(name, D):
    """The C entry that launches key ``name`` at head dim ``D``: the int8
    masked and windowed keys and head dim 256 stay on ``sage_attn_bwd``."""
    if D == 256:
        return "sage_attn_bwd"
    return {**dict.fromkeys(SM90_KEYS, "sage_bwd_sm90"),
            **dict.fromkeys(SM90_MASKED_KEYS, "sage_bwd_sm90_masked"),
            **dict.fromkeys(Q8_SM90_KEYS, "sage_bwd_q8_sm90")}.get(name, "sage_attn_bwd")


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("name,quant,causal,window,masked",
                         [c for c in _configs() if c[0].startswith("C1")])
def test_kernel_entry_per_configuration(monkeypatch, D, name, quant, causal, window, masked):
    """``attention_backward_kernel`` launches C1 then C2 through
    ``sage_bwd_sm90`` (bf16), ``sage_bwd_sm90_masked`` (bf16 with a window
    or a mask) or ``sage_bwd_q8_sm90`` (int8) when routed and
    ``sage_attn_bwd`` otherwise, and counts both under the configuration's
    launch keys.  The int8 entry is handed the codes, their copies
    dequantized to bf16 and the row scales; the masked entry each kernel's
    own tile lists, row length and order after the shared arguments, then
    the window and sinks."""
    calls, deq = [], []
    monkeypatch.setattr(_build, "call", lambda fn, device, *args: calls.append((fn, args)))
    real_deq = tbwd.dequant_rows
    monkeypatch.setattr(tbwd, "dequant_rows",
                        lambda c, s: deq.append((c, s, real_deq(c, s))) or deq[-1][2])
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
    entry = _entry(name, D)
    assert [fn for fn, _ in calls] == [entry, entry]
    assert [args[0] for _, args in calls] == [1, 2]   # which: C1, then C2
    assert [tbwd.attention_backward_kernel.launches[n] for n in keys] == [b + 1 for b in before]
    assert len(deq) == (2 if entry == "sage_bwd_q8_sm90" else 0)
    if entry == "sage_attn_bwd":
        return
    args = calls[0][1]
    assert args[1] == D and len(args) == len(_build.SIGNATURES[entry][1]) - 1
    own = 13 if entry == "sage_bwd_sm90_masked" else 0   # each kernel's own arguments
    shared = args[:len(args) - own]
    assert calls[1][1][1:len(shared)] == shared[1:]
    # (out_f32, B, Hq, Hk, Sqp, Skp, causal) and the three factors
    assert shared[-10:-3] == (1, B, Hq, Hk, Sqp, Skp, int(causal))
    assert shared[-3:] == pytest.approx((0.2, 0.125, 0.125))
    if own:
        # row lengths: C1 walks q tiles, C2 kv tiles; then window and sinks
        assert (args[-11], calls[1][1][-11]) == (Sqp // 64, Skp // 64)
        assert args[-2:] == calls[1][1][-2:] == (window, 0)
    if entry == "sage_bwd_q8_sm90":
        # q8, qd, k8, kd, v, dO, lse2, di, qs, ks: the codes and scales as
        # given, and their bf16 copies bf16(code * row scale)
        (qc, qsc, qd), (kc, ksc, kd) = deq
        assert (qc is q and qsc is kw["qs"]) and (kc is k and ksc is kw["ks"])
        assert args[2:6] == (q.data_ptr(), qd.data_ptr(), k.data_ptr(), kd.data_ptr())
        assert args[10:12] == (kw["qs"].data_ptr(), kw["ks"].data_ptr())
        for x, c, sc in ((qd, q, kw["qs"]), (kd, k, kw["ks"])):
            assert x.dtype == torch.bfloat16 and x.shape == c.shape
            assert torch.equal(x, (c.float() * sc[..., None]).to(torch.bfloat16))


def test_q8_entry_reads_one_copy_per_kernel(monkeypatch):
    """C1 alone is handed q dequantized and no k copy, C2 alone the
    reverse (a null pointer)."""
    calls = []
    monkeypatch.setattr(_build, "call", lambda fn, device, *args: calls.append((fn, args)))
    r = np.random.RandomState(3)
    q, k = (torch.tensor(r.randint(-127, 128, (1, 2, 128, 64)), dtype=torch.int8) for _ in range(2))
    v = torch.tensor(r.randn(1, 2, 128, 64))
    kw = dict(fold=1.0, dk_fin=1.0, dq_fin=1.0, causal=False, qs=torch.ones(1, 2, 128),
              ks=torch.ones(1, 2, 128))
    for kernel in ("C1", "C2"):
        tbwd.attention_backward_kernel(q, k, v, v, torch.zeros(1, 2, 128), torch.zeros(1, 2, 128),
                                       kernels=(kernel,), **kw)
    (f1, a1), (f2, a2) = calls
    assert f1 == f2 == "sage_bwd_q8_sm90" and (a1[0], a2[0]) == (1, 2)
    assert a1[3] and a1[5] is None and a2[3] is None and a2[5]


def _launch_failing(monkeypatch, quant):
    """Calls ``attention_backward_kernel`` on a routed configuration (int8
    with ``quant``) whose launch fails; returns the entries tried."""
    calls = []

    def fail(fn, device, *args):
        calls.append(fn)
        raise RuntimeError(f"{fn} failed to launch")

    monkeypatch.setattr(_build, "call", fail)
    x = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16)
    qk, kw = (x, {}) if not quant else (x.to(torch.int8), dict(qs=torch.ones(1, 2, 64),
                                                               ks=torch.ones(1, 2, 64)))
    with pytest.raises(RuntimeError, match="sage_bwd_q8_sm90" if quant else "sage_bwd_sm90"):
        tbwd.attention_backward_kernel(qk, qk, x, x, torch.zeros(1, 2, 64), torch.zeros(1, 2, 64),
                                       fold=1.0, dk_fin=1.0, dq_fin=1.0, causal=False, **kw)
    return calls


def test_routed_launch_raises_without_fallback(monkeypatch):
    """A routed configuration whose launch fails raises; nothing else is
    tried."""
    assert _launch_failing(monkeypatch, False) == ["sage_bwd_sm90"]


def test_q8_routed_launch_raises_without_fallback(monkeypatch):
    """The same for an int8 configuration on ``sage_bwd_q8_sm90``."""
    assert _launch_failing(monkeypatch, True) == ["sage_bwd_q8_sm90"]


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
def _jax_bwd(causal, given_di, quantized):
    def f(q, k, v, o, lse, do, di):
        return attention_backward_pallas(q, k, v, None if given_di else o, lse, do,
                                         sm_scale=q.shape[-1] ** -0.5, is_causal=causal,
                                         quantized=quantized, di=di if given_di else None,
                                         out_dtype=jnp.float32 if given_di else None,
                                         interpret=True)
    return jax.jit(f)


CASES = {   # name: B, Hq, Hk, Sq, Sk, D, causal, given di with f32 outputs[, int8]
    "192_causal_d64": (1, 2, 2, 192, 192, 64, True, False),
    "320_d128": (1, 2, 2, 320, 320, 128, False, False),
    "320_causal_d128": (1, 2, 1, 320, 320, 128, True, False),
    "192x320_d64": (1, 2, 1, 192, 320, 64, False, False),
    "192x320_d128": (2, 2, 2, 192, 320, 128, False, False),
    "gqa4_causal_d64": (1, 4, 1, 320, 320, 64, True, False),
    "gqa4_d128": (1, 4, 1, 192, 192, 128, False, False),
    "given_di_f32_causal": (1, 4, 1, 192, 192, 128, True, True),
    "given_di_f32_192x320": (1, 2, 2, 192, 320, 64, False, True),
    "int8_320_d64": (1, 2, 2, 320, 320, 64, False, False, True),
    "int8_320_causal_d128": (1, 2, 1, 320, 320, 128, True, False, True),
    "int8_192x320_d128": (2, 2, 2, 192, 320, 128, False, False, True),
    "int8_gqa4_causal_d64": (1, 4, 1, 320, 320, 64, True, False, True),
    "int8_given_di_f32_448x192": (1, 2, 1, 448, 192, 64, False, True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_jax_and_exact(case):
    B, Hq, Hk, Sq, Sk, D, causal, given_di, *quant = CASES[case]
    quant = bool(quant and quant[0])
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
                                  sm_scale=D ** -0.5, is_causal=causal, quantized=quant, **kw)
    jax_got = _jax_bwd(causal, given_di, quant)(
        *(jnp.asarray(x) for x in (q, k, v, o, lse, do, di)))
    for a, j, e, n in zip(got, jax_got, ref, "qkv"):
        a, j = a.double().numpy(), np.asarray(j, np.float64)
        e = e.numpy()
        assert a.shape == j.shape == e.shape, f"d{n}"
        assert np.isfinite(a).all(), f"d{n}"
        assert calc_diff(a, j) < JAX_BAR, f"d{n} vs JAX"
        if quant:
            assert calc_diff(a, e) < INT8_COS, f"d{n} vs exact"
        else:
            assert np.abs(a - e).max() / np.abs(e).max() < ORACLE_REL, f"d{n} vs exact"
