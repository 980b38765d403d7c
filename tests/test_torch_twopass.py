"""The port's two-pass K/V prep (A3, A4) and its route in ``_sage_attention``
against the JAX package, on inputs made with numpy.

Bars (those of ``tests/test_quant_pallas.py``'s merged-prep tests): stats
to rtol 1e-6 (atol 1e-6 for means that cancel), codes exact, capmax to
rtol 1e-6.  The route through A3/A4 is taken past ``ONEPASS_MAX_ELS``,
which no CPU-sized input reaches, so the route tests patch both packages'
limit to 0; the card's run (``chip_smoke.py`` phase 11) proves the real
route at HunyuanVideo and Llama-3.1-8B lengths.  The flagship bars of
``tests/test_torch_core.py``: port vs JAX calc_diff < 1e-5, vs the float64
oracle < 1.5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import core as jcore
from sageattention_tpu.ops import quant_pallas as qp
from sageattention_tpu_torch import core as tcore
from sageattention_tpu_torch.ops import quant_fused as qf
from sageattention_tpu_torch.ops.reference import sdpa
from sageattention_tpu_torch.utils.testing import calc_diff

PINNED = dict(pv_dtype="int8", k_scale_mode="head", compute_dtype="native",
              smooth_k=True, smooth_v=True, qk_quant_gran="per_thread")


def _rand(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    x[..., 7] += 4.0   # a biased channel, as smooth_k expects
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


_jax_stats2 = jax.jit(qp.channel_stats2_pallas, static_argnames=("s_true", "interpret"))
_jax_quant_kv = jax.jit(qp.quant_kv_pallas,
                        static_argnames=("with_capmax", "s_true", "interpret"))


def _stat_close(a, b):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float32), np.asarray(b), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("shape,s_true", [((1, 2, 512, 64), 400), ((1, 2, 512, 64), 512),
                                          ((2, 2, 384, 128), 384), ((2, 2, 384, 128), 300)])
def test_two_pass_matches_jax(shape, s_true):
    k, v = _rand(shape, 1, 2.0), _rand(shape, 2, 3.0)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    j_stats = _jax_stats2(jk, jv, s_true=s_true, interpret=True)
    t_stats = qf.channel_stats2(tk, tv, s_true)
    for a, b in zip(j_stats, t_stats):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32
        _stat_close(a, b)
    # A4 from the same scales on both sides: the codes must be equal
    km, ka, vm, va = j_stats
    ks = jnp.where(jnp.max(ka, axis=3, keepdims=True) > 0,
                   jnp.max(ka, axis=3, keepdims=True) * (1.0 / 127.0), 1.0)
    vs = jnp.where(va > 0, va * (1.0 / 127.0), 1.0)
    j_k8, j_v8, j_cap = _jax_quant_kv(jk, ks, km, jv, vs, vm, with_capmax=True, s_true=s_true,
                                      interpret=True)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    t_k8, t_v8, t_cap = qf.quant_kv(tk, t(ks), t(km), tv, t(vs), t(vm), with_capmax=True,
                                    s_true=s_true)
    assert t_k8.dtype == torch.int8 and t_cap.shape == (shape[0], shape[1], 1, 1)
    np.testing.assert_array_equal(t_k8.numpy(), np.asarray(j_k8))
    np.testing.assert_array_equal(t_v8.numpy(), np.asarray(j_v8))
    np.testing.assert_allclose(t_cap.numpy(), np.asarray(j_cap), rtol=1e-6)
    two = qf.quant_kv(tk, t(ks), t(km), tv, t(vs), t(vm))
    assert len(two) == 2 and torch.equal(two[0], t_k8) and torch.equal(two[1], t_v8)


@pytest.mark.parametrize("shape,s_true", [((1, 3, 640, 64), 600), ((2, 2, 384, 128), 384)])
def test_two_pass_equals_one_pass(shape, s_true):
    """A3 + A4 against A1 + A2 on the same K and V."""
    k, v = torch.from_numpy(_rand(shape, 3, 1.5)), torch.from_numpy(_rand(shape, 4, 0.7))
    k8, km, k_amax, cap = qf.prep_k_onepass(k, s_true, with_capmax=True)
    v8, vm, v_amax = qf.prep_v_onepass(v, s_true)
    km2, k_amax_ch, vm2, v_amax2 = qf.channel_stats2(k, v, s_true)
    for a, b in ((km, km2), (k_amax, k_amax_ch.amax(dim=3, keepdim=True)), (vm, vm2),
                 (v_amax, v_amax2)):
        _stat_close(a.numpy(), b)
    ks = tcore._scale_of(k_amax_ch.amax(dim=3, keepdim=True), qf._INV127)
    k8b, v8b, capb = qf.quant_kv(k, ks, km2, v, tcore._scale_of(v_amax2, qf._INV127), vm2,
                                 with_capmax=True, s_true=s_true)
    assert torch.equal(k8, k8b) and torch.equal(v8, v8b)
    np.testing.assert_allclose(capb.numpy(), cap.numpy(), rtol=1e-6)


def _spy(monkeypatch, mod, name):
    calls = []
    real = getattr(mod, name)

    def wrapped(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(mod, name, wrapped)
    return calls


@pytest.mark.parametrize("Hq,Hk,S,D,causal,kv_true", [(3, 3, 320, 64, False, 0),
                                                      (4, 2, 384, 128, True, 0),
                                                      (4, 2, 384, 128, False, 300)])
def test_sage_attention_two_pass_route_matches_jax(monkeypatch, Hq, Hk, S, D, causal, kv_true):
    monkeypatch.setattr(qf, "ONEPASS_MAX_ELS", 0)
    monkeypatch.setattr(qp, "ONEPASS_MAX_ELS", 0)
    t_calls = [_spy(monkeypatch, qf, n) for n in ("channel_stats2", "quant_kv", "prep_k_onepass")]
    j_calls = [_spy(monkeypatch, qp, n) for n in ("channel_stats2_pallas", "quant_kv_pallas")]
    rng = np.random.default_rng(S + Hq + kv_true)
    xs = [rng.standard_normal((1, h, S, D)).astype(np.float32) for h in (Hq, Hk, Hk)]
    xs[1][..., 5] += 3.0
    kw = dict(PINNED, is_causal=causal, kv_true=kv_true)
    out = tcore._sage_attention(*(torch.from_numpy(x) for x in xs), **kw)
    jfn = jax.jit(lambda q, k, v: jcore._sage_attention(q, k, v, use_fused=True, interpret=True,
                                                        fuse_q_quant=True, **kw))
    ref = np.asarray(jfn(*(jnp.asarray(x) for x in xs)))
    assert [len(c) for c in t_calls] == [1, 1, 0] and [len(c) for c in j_calls] == [1, 1]
    assert out.shape == xs[0].shape
    assert calc_diff(out, ref) < 1e-5
    n = kv_true or S
    t = [torch.from_numpy(x) for x in xs]
    oracle = sdpa(t[0], t[1][:, :, :n], t[2][:, :, :n], is_causal=causal)
    assert calc_diff(out, oracle) < 1.5e-3


# (name, Sq = Sk, head dim, causal, one-pass?) of the shapes the two routes split
ROUTE_SHAPES = [("HunyuanVideo 720p x 129 frames", 119056, 128, False, False),
                ("Llama-3.1-8B at 131,072", 131072, 128, True, False),
                ("Wan2.1 720p", 75600, 128, False, False),
                ("HunyuanVideo-32528", 32528, 128, False, True),
                ("CogVideoX1.5", 17776, 64, False, True)]


@pytest.mark.parametrize("name,S,D,causal,onepass", ROUTE_SHAPES,
                         ids=[s[0] for s in ROUTE_SHAPES])
def test_route_matches_jax(name, S, D, causal, onepass):
    """The padded length from each package's own tile heuristic, then each
    package's rule (JAX's inline at ``core.py:339``)."""
    jbq, jbk, _ = jcore._choose_blocks(S, S, quantized=True, compute_dtype="native",
                                       causal=causal)
    tbq, tbk, _ = tcore._choose_blocks(S, S, quantized=True, compute_dtype="native",
                                       causal=causal)
    assert (tbq, tbk) == (jbq, jbk) and min(tbq, tbk) >= 512
    sk_pad = -(-S // tbk) * tbk
    assert tcore.onepass_kv(sk_pad, D) == (sk_pad * D <= qp.ONEPASS_MAX_ELS) == onepass
