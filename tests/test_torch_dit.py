"""The port's CogVideoX-style DiT against the JAX package's flax DiT, with
the port's weights converted from the flax parameters by
``dit_state_dict_from_jax``.

Bars: the DiT with SageAttention on both sides (JAX's attention is the HND
``_sage_attention`` with every mode pinned, interpret mode): calc_diff <
1e-3; with exact attention on both sides: < 1e-4 (bf16 compute, summed in
other orders); embeddings and LayerNorm to float32 rounding.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu.core import _sage_attention as jax_sage
from sageattention_tpu.models import dit as jdit
from sageattention_tpu_torch.models import dit as tdit
from sageattention_tpu_torch.models import dit_state_dict_from_jax, sage_dot_product_attention
from sageattention_tpu_torch.ops.reference import sdpa_nhd
from sageattention_tpu_torch.utils.testing import calc_diff

from port_cpu import yield_cpu  # noqa: F401  (one torch thread, low CPU priority)

SMALL = dict(hidden=128, heads=2, depth=2, frames=2, height=16, width=16, patch=2,
             text_len=16, text_dim=64, in_channels=4, zero_init_gates=False)
PINNED = dict(pv_dtype="int8", k_scale_mode="head", compute_dtype="native",
              softmax_mode="auto", smooth_k=True, smooth_v=True)


def jax_sage_nhd(q, k, v, *args, **kwargs):
    o = jax_sage(*(jnp.swapaxes(x, 1, 2) for x in (q, k, v)), tensor_layout="HND",
                 use_fused=True, interpret=True, fuse_q_quant=True, **PINNED)
    return jnp.swapaxes(o, 1, 2)


def jax_sage_fp8_nhd(q, k, v, *args, **kwargs):
    """The reference's H100 mode inside the model: fine K scales, e4m3 PV;
    JAX's kv tiles pinned to the port's 64 (an e4m3 P depends on them)."""
    o = jax_sage(*(jnp.swapaxes(x, 1, 2) for x in (q, k, v)), tensor_layout="HND",
                 use_fused=True, interpret=True, pv_dtype="fp8", k_scale_mode="fine",
                 block_q=64, block_k=64)
    return jnp.swapaxes(o, 1, 2)


def oracle_nhd(q, k, v):
    return sdpa_nhd(q, k, v).to(q.dtype)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((1, 2, 16, 16, 4)).astype(np.float32)
    txt = rng.standard_normal((1, 16, 64)).astype(np.float32)
    return lat, txt, np.array([500], np.int32)


def _models(jax_attn, port_attn, cfg=SMALL):
    jm = jdit.make_dit(jdit.DiTConfig(**cfg), attn_fn=jax_attn)
    lat, txt, t = _inputs()
    # the attention holds no parameters: initialize through exact attention
    params = jdit.make_dit(jdit.DiTConfig(**cfg)).init(
        jax.random.PRNGKey(0), jnp.asarray(lat), jnp.asarray(txt), jnp.asarray(t))
    tm = tdit.DiT(tdit.DiTConfig(**cfg), attn_fn=port_attn, device="cpu")
    tm.load_state_dict(dit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


def _forward_both(jm, params, tm):
    lat, txt, t = _inputs()
    jo = jm.apply(params, jnp.asarray(lat), jnp.asarray(txt), jnp.asarray(t))
    with torch.no_grad():
        to = tm(torch.from_numpy(lat), torch.from_numpy(txt), torch.from_numpy(t))
    assert tuple(to.shape) == jo.shape and to.dtype == torch.bfloat16
    return np.asarray(jo.astype(jnp.float32)), to


def test_dit_with_sage_matches_jax():
    jm, params, tm = _models(jax_sage_nhd, sage_dot_product_attention)
    jo, to = _forward_both(jm, params, tm)
    assert bool(torch.isfinite(to.float()).all())
    assert calc_diff(jo, to) < 1e-3


def test_dit_with_fp8_sage_matches_jax():
    port_attn = functools.partial(sage_dot_product_attention, pv_dtype="fp8",
                                  k_scale_mode="fine")
    jm, params, tm = _models(jax_sage_fp8_nhd, port_attn)
    jo, to = _forward_both(jm, params, tm)
    assert bool(torch.isfinite(to.float()).all())
    assert calc_diff(jo, to) < 1e-3
    _, exact = _forward_both(*_models(None, oracle_nhd))
    assert calc_diff(to, exact) < 5e-3


def test_dit_with_exact_attention_matches_jax():
    jm, params, tm = _models(None, oracle_nhd)
    jo, to = _forward_both(jm, params, tm)
    assert calc_diff(jo, to) < 1e-4


def test_converted_state_dict_is_complete():
    jm, params, tm = _models(None, oracle_nhd)
    sd = dit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert set(sd) == set(tm.state_dict())
    k = np.asarray(params["params"]["block_1"]["qkv"]["kernel"])
    np.testing.assert_array_equal(sd["blocks.1.qkv.weight"].numpy(), k.T)
    with pytest.raises(KeyError):
        dit_state_dict_from_jax({"params": {**params["params"], "extra": {"kernel": k}}})


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 500, 999], np.int32)
    np.testing.assert_allclose(tdit.timestep_embedding(torch.from_numpy(t), 256).numpy(),
                               np.asarray(jdit.timestep_embedding(jnp.asarray(t), 256)),
                               rtol=1e-5, atol=2e-4)


@pytest.mark.parametrize("affine", [False, True])
def test_layer_norm_matches_flax(affine):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 7, 128)).astype(np.float32) * 3 + 1)
    x = x.to(torch.bfloat16)
    ln = fnn.LayerNorm(use_bias=affine, use_scale=affine, dtype=jnp.bfloat16)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    p = ln.init(jax.random.PRNGKey(0), xj)
    tl = tdit.LayerNorm(128, torch.bfloat16, affine=affine)
    if affine:
        w = rng.standard_normal(128).astype(np.float32)
        b = rng.standard_normal(128).astype(np.float32)
        p = {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}}
        tl.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)})
    jo = np.asarray(ln.apply(p, xj).astype(jnp.float32))
    with torch.no_grad():
        to = tl(x).float().numpy()
    assert np.mean(jo == to) > 0.99
    np.testing.assert_allclose(to, jo, rtol=1e-2, atol=1e-2)


def test_per_layer_attention_selection():
    calls = []

    def select(i):
        def fn(q, k, v):
            calls.append(i)
            return oracle_nhd(q, k, v)
        return fn

    select._per_layer = True
    model = tdit.DiT(tdit.DiTConfig(**SMALL), attn_fn=select, device="cpu").init_weights(1)
    lat, txt, t = _inputs()
    with torch.no_grad():
        out = model(torch.from_numpy(lat), torch.from_numpy(txt), torch.from_numpy(t))
    assert calls == [0, 1] and bool(torch.isfinite(out.float()).all())


def test_zero_init_gates_make_blocks_identity():
    cfg = tdit.DiTConfig(**{**SMALL, "zero_init_gates": True})
    model = tdit.DiT(cfg, attn_fn=oracle_nhd, device="cpu").init_weights(2)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 144, 128, generator=g).to(torch.bfloat16)
    c = torch.randn(1, 128, generator=g).to(torch.bfloat16)
    with torch.no_grad():
        assert torch.equal(model.blocks[0](x, c), x)


@pytest.mark.parametrize("kwargs", [
    # a mask or a bias alone runs since slice 3 (B7); both at once, sequence
    # lengths and a non-causal window have no kernel path and raise
    dict(mask=torch.ones(1, 1, 8, 8, dtype=torch.bool), bias=torch.zeros(1, 1, 8, 8)),
    dict(mask=torch.ones(1, 1, 8, 8, dtype=torch.bool), local_window_size=(4, 0),
         is_causal=True),
    dict(query_seq_lengths=torch.tensor([8])),
    dict(key_value_seq_lengths=torch.tensor([8])),
    dict(local_window_size=(4, 0)),
])
def test_sage_dot_product_attention_refuses_masks(kwargs):
    q = torch.randn(1, 8, 2, 64)
    with pytest.raises(NotImplementedError):
        sage_dot_product_attention(q, q, q, **kwargs)


def test_sage_dot_product_attention_is_nhd_sageattn():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 200, 2, 64)).astype(np.float32))
               for _ in range(3))
    out = sage_dot_product_attention(q, k, v, is_causal=True, scale=0.1)
    ref = sdpa_nhd(q, k, v, is_causal=True, sm_scale=0.1)
    assert out.shape == q.shape and calc_diff(out, ref) < 1.5e-3
