"""The port's Llama model (``models/llm.py``) against the JAX package's flax
``LlamaLM``, with the same weights (``llm_state_dict_from_jax``) and tokens.

Bars (``tests/test_llm.py``'s): a cached decode step within 2e-3 calc_diff
of the full no-cache forward (dense cache), 3e-3 (paged, sliding window,
sinks); each step is also held against the JAX model's step logits at the
same bar.  Prefill: the exact attentions of the two packages round P to
bf16 at different points (JAX normalizes, then rounds; the port's flash
kernel rounds the unnormalized P of each 64-wide tile), which moves the
logits of this 2-layer model by ~5e-5 calc_diff, as far as either is from
float64 attention.  So the prefill is held three ways: with the port's
exact default within 1e-4 of JAX and no farther from float64 attention than
JAX is (x1.5); with JAX's attention arithmetic rebuilt in torch within
1e-5 of JAX (the rest of the model: norms, RoPE, SwiGLU, projections).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu.models import sage_dot_product_attention as j_sage
from sageattention_tpu.models.llm import LlamaConfig as JConfig
from sageattention_tpu.models.llm import LlamaLM as JLM
from sageattention_tpu.paged import PageAllocator, build_table
from sageattention_tpu.utils.testing import calc_diff
from sageattention_tpu_torch.models import (LlamaConfig, LlamaLM, llm_state_dict_from_jax,
                                            sage_dot_product_attention)

from port_cpu import yield_cpu  # noqa: F401  (one torch thread, low CPU priority)

CFG = dict(hidden=128, heads=4, kv_heads=2, depth=2, vocab=256)
PAGE = 256


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) else x.float().numpy()


def _pair(cfg, tokens, seed, j_attn=None, t_attn=None):
    jm = JLM(JConfig(**cfg), attn_fn=j_attn)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(tokens))
    tm = LlamaLM(LlamaConfig(**cfg), attn_fn=t_attn, device="cpu")
    tm.load_state_dict(llm_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


def _japply(jm, params, tokens, caches=None, **kw):
    """``jm.apply`` under ``jax.jit`` (the interpret-mode kernels compile once
    instead of running op by op, a few times faster here); ``kw`` is closed
    over, the caches are traced."""
    return jax.jit(lambda p, t, c: jm.apply(p, t, caches=c, **kw))(params, jnp.asarray(tokens),
                                                                   caches)


def _tokens(shape, seed, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(np.int32)


def test_state_dict_round_trip():
    tokens = _tokens((1, 16), 0)
    jm, params, tm = _pair(CFG, tokens, 1)
    sd = llm_state_dict_from_jax(params)
    assert set(sd) == set(tm.state_dict())
    p = params["params"]
    np.testing.assert_array_equal(sd["layers.1.gate.weight"].numpy(),
                                  np.asarray(p["layer_1"]["Dense_0"]["kernel"]).T)
    np.testing.assert_array_equal(sd["embed.weight"].numpy(), np.asarray(p["Embed_0"]["embedding"]))
    np.testing.assert_array_equal(sd["norm.weight"].numpy(), np.asarray(p["RMSNorm_0"]["scale"]))
    for name, t in tm.state_dict().items():
        assert torch.equal(t, sd[name]), name


def _jax_attention_in_torch(q, k, v, is_causal=False, **kw):
    """jax.nn.dot_product_attention's arithmetic on bf16 NHD inputs: f32
    logits, an f32 softmax, normalized P rounded to bf16, then P V."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kk, vv = k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)
    lg = torch.einsum("bthd,bshd->bhts", q.float(), kk.float()) * np.float32(D ** -0.5)
    lg = lg.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), float("-inf"))
    p = torch.softmax(lg, -1).to(torch.bfloat16)
    return torch.einsum("bhts,bshd->bthd", p.float(), vv.float()).to(torch.bfloat16)


def _f64_attention(q, k, v, is_causal=False, **kw):
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kk, vv = k.repeat_interleave(G, 2).double(), v.repeat_interleave(G, 2).double()
    lg = torch.einsum("bthd,bshd->bhts", q.double(), kk) * D ** -0.5
    lg = lg.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), float("-inf"))
    return torch.einsum("bhts,bshd->bthd", torch.softmax(lg, -1), vv).to(torch.bfloat16)


def test_prefill_logits_match_jax():
    tokens = _tokens((2, 160), 2)
    jm, params, tm = _pair(CFG, tokens, 3)
    ref = _np(jm.apply(params, jnp.asarray(tokens)))
    tt = torch.from_numpy(tokens).long()
    with torch.no_grad():
        out = _np(tm(tt))
        exact = {}
        for name, fn in (("jaxlike", _jax_attention_in_torch), ("f64", _f64_attention)):
            for blk in tm.layers:
                blk.attn_fn = fn
            exact[name] = _np(tm(tt))
    assert out.shape == (2, 160, CFG["vocab"])
    assert calc_diff(exact["jaxlike"], ref) < 1e-5
    assert calc_diff(out, ref) < 1e-4
    assert calc_diff(out, exact["f64"]) < 1.5 * calc_diff(ref, exact["f64"])


def test_dense_cached_decode_t1_and_t4():
    """Prefill with a dense cache, a T=1 step, then a T=4 window: each
    against the port's own no-cache forward and JAX's step logits."""
    S0, T = 100, 4
    tokens = _tokens((1, S0 + 1 + T), 4)
    jm, params, tm = _pair(CFG, tokens[:, :S0], 5)
    tt = torch.from_numpy(tokens).long()
    with torch.no_grad():
        full = _np(tm(tt))
        logits, caches = tm(tt[:, :S0], max_len=256)
        assert calc_diff(_np(logits), full[:, :S0]) < 1e-6
        _, jc = _japply(jm, params, tokens[:, :S0], max_len=256)
        pos = S0
        for width in (1, T):
            step, caches = tm(tt[:, pos:pos + width], caches=caches, pos=pos)
            js, jc = _japply(jm, params, tokens[:, pos:pos + width], caches=jc, pos=pos)
            assert calc_diff(_np(step), full[:, pos:pos + width]) < 2e-3, pos
            assert calc_diff(_np(step), _np(js)) < 2e-3, pos
            pos += width
    assert int(caches[0].length) == S0 + 1 + T


def test_paged_ragged_decode_with_active():
    """Ragged paged prefill (one table for every layer), then pos=None
    decode; slot 1 is frozen by ``active`` on the second step."""
    lengths, T = [256, 192], 2
    tokens = _tokens((2, PAGE + T), 8)
    jm, params, tm = _pair(CFG, tokens[:, :PAGE], 9)
    alloc = PageAllocator(8, PAGE)
    table = build_table([alloc.reserve(2), alloc.reserve(2)], max_pages=2)
    jspec = dict(num_pages=8, page_table=table, lengths=jnp.asarray(lengths, jnp.int32))
    tspec = dict(num_pages=8, page_table=table, lengths=torch.tensor(lengths))
    tt = torch.from_numpy(tokens).long()
    with torch.no_grad():
        _, caches = tm(tt[:, :PAGE], paged_spec=tspec)
        _, jc = _japply(jm, params, tokens[:, :PAGE], paged_spec=jspec)
        cur = list(lengths)
        for t in range(T):
            active = [True, t == 0]
            step_tok = np.stack([tokens[b, cur[b]] for b in range(2)])[:, None]
            step, caches = tm(torch.from_numpy(step_tok).long(), caches=caches, pos=None,
                              active=torch.tensor(active))
            js, jc = _japply(jm, params, step_tok, caches=jc, pos=None,
                             active=jnp.asarray(active))
            for b in range(2):
                if not active[b]:
                    continue
                cur[b] += 1
                full = _np(tm(tt[b:b + 1, :cur[b]]))
                assert calc_diff(_np(step[b, 0]), full[0, -1]) < 3e-3, (t, b)
                assert calc_diff(_np(step[b, 0]), _np(js[b, 0])) < 3e-3, (t, b)
    assert caches[0].lengths.tolist() == cur == [258, 193]


@pytest.mark.parametrize("sinks", [0, 16])
def test_sliding_window_paged_decode(sinks):
    """A Mistral-style window (and StreamingLLM sinks): paged prefill, then
    windowed decode against the no-cache forward (exact windowed flash
    without sinks; the sage band with sinks, whose prefill JAX and the port
    both run through their SageAttention)."""
    W, T = 128, 2
    cfg = dict(CFG, hidden=256, sliding_window=W, attention_sinks=sinks)
    tokens = _tokens((1, PAGE + T), 13)
    attn = (j_sage, sage_dot_product_attention) if sinks else (None, None)
    jm, params, tm = _pair(cfg, tokens[:, :PAGE], 14, *attn)
    table = build_table([PageAllocator(8, PAGE).reserve(2)], max_pages=2)
    jspec = dict(num_pages=8, page_table=table, lengths=jnp.asarray([PAGE], jnp.int32))
    tspec = dict(num_pages=8, page_table=table, lengths=torch.tensor([PAGE]))
    tt = torch.from_numpy(tokens).long()
    with torch.no_grad():
        logits, caches = tm(tt[:, :PAGE], paged_spec=tspec)
        assert calc_diff(_np(logits), _np(tm(tt[:, :PAGE]))) < 1e-6
        _, jc = _japply(jm, params, tokens[:, :PAGE], paged_spec=jspec)
        for t in range(T):
            cur = PAGE + t
            step, caches = tm(tt[:, cur:cur + 1], caches=caches, pos=cur)
            js, jc = _japply(jm, params, tokens[:, cur:cur + 1], caches=jc, pos=cur)
            oracle = _np(tm(tt[:, :cur + 1]))
            assert calc_diff(_np(step[:, 0]), oracle[:, -1]) < 3e-3, t
            assert calc_diff(_np(step), _np(js)) < 3e-3, t


def test_errors_and_device_default():
    cfg = LlamaConfig(**dict(CFG, sliding_window=64, attention_sinks=4))
    tm = LlamaLM(cfg, device="cpu")
    with torch.no_grad():
        with pytest.raises(ValueError, match="attention_sinks"):
            tm(torch.zeros(1, 8, dtype=torch.long))
        tm = LlamaLM(LlamaConfig(**dict(CFG, sliding_window=64)), device="cpu")
        _, caches = tm(torch.zeros(1, 8, dtype=torch.long), max_len=128)
        with pytest.raises(ValueError, match="paged"):   # a window needs the paged cache
            tm(torch.zeros(1, 1, dtype=torch.long), caches=caches, pos=8)
    if not torch.cuda.is_available():   # the default device is the first CUDA card
        with pytest.raises((RuntimeError, AssertionError)):
            LlamaLM(LlamaConfig(**CFG))
