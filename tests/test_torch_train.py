"""The port's training path against the JAX package's: the Llama LM's loss
and gradients (``tests/test_llm.py``'s loss), the DiT's ``diffusion_loss``
and gradients with the same noise, and the training example's data stream,
with the weights carried over by ``models/convert.py``.

Bars: the loss within 1e-3 relative; each parameter's gradient within
1e-3 calc_diff of JAX's.  The forward already differs by up to ~1e-4 where
the two packages round P at other points (``tests/test_torch_llm.py``,
``tests/test_torch_dit.py``), and the backward kernels sum in another tile
order (``tests/test_torch_backward.py``); the worst gradient reads
2.4e-4 (Llama, SageAttention) and 8.8e-5 (DiT) on these inputs.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu.models import dit as jdit
from sageattention_tpu.models import sage_dot_product_attention as j_sage
from sageattention_tpu.models.llm import LlamaConfig as JConfig
from sageattention_tpu.models.llm import LlamaLM as JLM
from sageattention_tpu.utils.testing import calc_diff
from sageattention_tpu_torch.examples import train_finetune as tex
from sageattention_tpu_torch.models import (LlamaConfig, LlamaLM, dit_state_dict_from_jax,
                                            llm_state_dict_from_jax, sage_dot_product_attention)
from sageattention_tpu_torch.models import dit as tdit

from port_cpu import yield_cpu  # noqa: F401  (one torch thread, low CPU priority)

LOSS_REL = 1e-3
GRAD_BAR = 1e-3
LLM = dict(hidden=128, heads=4, kv_heads=2, depth=2, vocab=256)
DIT = dict(hidden=128, heads=2, depth=2, frames=2, height=16, width=16, patch=2, text_len=16,
           text_dim=64, in_channels=4, zero_init_gates=False)


def _f32(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _same_grads(model, jax_grads, convert):
    ref = convert(_f32(jax_grads))
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert calc_diff(p.grad.numpy(), ref[name].numpy()) < GRAD_BAR, name


@pytest.mark.parametrize("attn", ["sage", "exact"])
def test_llm_loss_and_grads_match_jax(attn):
    """``LlamaLM`` with SageAttention (causal: the bf16 C1/C2 backward) and
    with its default exact attention (the port's flash, whose gradient is
    the same backward; JAX's is autodiff of ``jax.nn``'s attention)."""
    tokens = np.random.RandomState(2).randint(0, 256, (1, 256)).astype(np.int32)
    jm = JLM(JConfig(**LLM), attn_fn=j_sage if attn == "sage" else None)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(tokens))

    def loss(p):
        return -jnp.mean(jax.nn.log_softmax(jm.apply(p, jnp.asarray(tokens)))[..., 0])

    val, grads = jax.jit(jax.value_and_grad(loss))(params)
    tm = LlamaLM(LlamaConfig(**LLM), attn_fn=sage_dot_product_attention if attn == "sage"
                 else None, device="cpu")
    tm.load_state_dict(llm_state_dict_from_jax(_f32(params)))
    tl = -torch.log_softmax(tm(torch.tensor(tokens).long()), -1)[..., 0].mean()
    tl.backward()
    assert abs(tl.item() - float(val)) <= LOSS_REL * abs(float(val))
    _same_grads(tm, grads, llm_state_dict_from_jax)


def test_diffusion_loss_and_grads_match_jax():
    """``diffusion_loss`` with JAX's noise handed to the port (non-causal
    SageAttention: the int8 C1/C2 backward on both sides)."""
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((1, 2, 16, 16, 4)).astype(np.float32)
    txt = rng.standard_normal((1, 16, 64)).astype(np.float32)
    t = np.array([500], np.int32)
    cfg = jdit.DiTConfig(**DIT)
    params = jdit.make_dit(cfg).init(jax.random.PRNGKey(0),
                                     *(jnp.asarray(x) for x in (lat, txt, t)))
    jm = jdit.make_dit(cfg, attn_fn=functools.partial(j_sage, pv_dtype="int8"))
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, lat.shape, jnp.float32))
    batch = tuple(jnp.asarray(x) for x in (lat, txt, t))
    val, grads = jax.jit(jax.value_and_grad(
        lambda p: jdit.diffusion_loss(jm, p, batch, key)))(params)
    tm = tdit.make_dit(tdit.DiTConfig(**DIT), device="cpu",
                       attn_fn=functools.partial(sage_dot_product_attention, pv_dtype="int8"))
    tm.load_state_dict(dit_state_dict_from_jax(_f32(params)))
    loss = tdit.diffusion_loss(tm, tuple(torch.tensor(x) for x in (lat, txt, t)),
                               noise=torch.tensor(noise))
    assert loss.dtype == torch.float32
    loss.backward()
    assert abs(loss.item() - float(val)) <= LOSS_REL * abs(float(val))
    _same_grads(tm, grads, dit_state_dict_from_jax)


def test_diffusion_helpers():
    """``example_inputs`` and the generator-drawn noise: the same generator
    state gives the same loss, another one another loss."""
    cfg = tdit.DiTConfig(**DIT)
    lat, txt, t = tdit.example_inputs(cfg, batch=2, device="cpu")
    assert lat.shape == (2, 2, 16, 16, 4) and txt.shape == (2, 16, 64)
    assert t.dtype == torch.int32 and bool((t == 500).all())
    model = tdit.make_dit(cfg, device="cpu").init_weights(1)
    with torch.no_grad():
        a, b, c = (tdit.diffusion_loss(model, (lat, txt, t), torch.Generator().manual_seed(s))
                   for s in (7, 7, 8))
    assert a.item() == b.item() != c.item()


def _jax_example():
    path = Path(__file__).resolve().parents[1] / "examples" / "train_finetune.py"
    spec = importlib.util.spec_from_file_location("jax_train_finetune", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_example_stream_and_short_run():
    """The example's synthetic stream equals the JAX example's; eight Adam
    steps of the tiny model learn, with every run within 0.01 of the
    exact run's loss."""
    j = list(_jax_example().batches(64, 2, 32, 3, seed=1))
    t = list(tex.batches(64, 2, 32, 3, seed=1, device="cpu"))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    cfg = LlamaConfig(hidden=128, heads=4, kv_heads=2, depth=2, vocab=64)
    init = LlamaLM(cfg, device="cpu").init_weights(seed=0).state_dict()
    runs = {}
    for name, attn in tex.RUNS.items():
        model = LlamaLM(cfg, attn_fn=attn, device="cpu")
        model.load_state_dict(init)
        runs[name], _ = tex.train(model, tex.batches(64, 2, 128, 8, seed=1, device="cpu"))
    assert all(np.isfinite(v).all() for v in runs.values())
    assert runs["exact"][-1] < runs["exact"][0]
    for name in ("sage", "sage-int8"):
        assert np.abs(np.array(runs[name]) - np.array(runs["exact"])).max() < 0.01
