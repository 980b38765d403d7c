"""Two numerical behaviours of cached decode, measured in one package at a
time: the JAX reference (``--impl jax``, on the CPU, Pallas kernels in
interpret mode) or the port (``--impl torch``, on the CPU, the kernels'
plain versions).  The inputs come from numpy with fixed seeds, so the two
runs see the same weights, tokens and tensors; each process imports only
its own package.

``depth``: a Llama-shaped model (hidden 512, 4 query heads and 1 KV head of
128, MLP x3.5, vocab 4096, rope theta 500,000) with random weights, at
depths 2, 8 and 32.  The kernels are N(0, 0.02 x sqrt(4096 / 512)), so that
each projection's outputs spread as they do in a 4096-wide model with
N(0, 0.02) weights (Llama-3-8B's width): the logits of its attention are
as peaked; the embedding is N(0, 0.02).  At each depth a 1,024-token prompt
is prefilled through the package's int8 ``sage_dot_product_attention`` into
a dense int8 cache, then 4 teacher-forced T=1 steps decode from it.
Printed per depth, for steps 1 and 4: the int8 no-cache forward's
distance from the exact no-cache forward (calc_diff of the last position's
logits), and the step's distance from both.  With random weights the int8
error adds up over depth.

``bf16v``: ``sageattn_decode`` over a bf16 V cache of 32,768 tokens (random
N(0, 1) K and V in bf16, one channel of K offset by 3) against float64
attention, once with the true V and once with the V the cache stores
(``bf16(v - v_mean) + v_mean``).

    python tools/decode_witness.py --impl jax depth
    python tools/decode_witness.py --impl torch bf16v

Each measurement prints one JSON line.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CFG = dict(hidden=512, heads=4, kv_heads=1, vocab=4096, mlp_ratio=3.5, rope_theta=500000.0)
STD = 0.02 * (4096 / CFG["hidden"]) ** 0.5   # a 4096-wide model's spread
DEPTHS, PROMPT, STEPS, LENGTH, SEED = (2, 8, 32), 1024, 4, 32768, 0


def calc_diff(x, y) -> float:
    """1 - cosine similarity, in float64."""
    x = np.asarray(x, dtype=np.float64).ravel()
    y = np.asarray(y, dtype=np.float64).ravel()
    return 1.0 - 2.0 * float((x * y).sum()) / float((x * x + y * y).sum())


def llama_params(depth):
    """The flax parameter tree of ``LlamaLM`` (f32; kernels N(0, STD), the
    embedding N(0, 0.02), norm scales 1)."""
    rng = np.random.RandomState(SEED)
    h, hd = CFG["hidden"], CFG["hidden"] // CFG["heads"]
    kv, inner = CFG["kv_heads"] * hd, int(h * CFG["mlp_ratio"])

    def w(*shape, s=STD):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    tree = {"Embed_0": {"embedding": w(CFG["vocab"], h, s=0.02)}}
    for i in range(depth):
        tree[f"layer_{i}"] = {
            "RMSNorm_0": {"scale": np.ones(h, np.float32)},
            "RMSNorm_1": {"scale": np.ones(h, np.float32)},
            "wq": {"kernel": w(h, h)}, "wk": {"kernel": w(h, kv)}, "wv": {"kernel": w(h, kv)},
            "wo": {"kernel": w(h, h)}, "Dense_0": {"kernel": w(h, inner)},
            "Dense_1": {"kernel": w(h, inner)}, "Dense_2": {"kernel": w(inner, h)}}
    tree["RMSNorm_0"] = {"scale": np.ones(h, np.float32)}
    tree["lm_head"] = {"kernel": w(h, CFG["vocab"])}
    return {"params": tree}


class JaxModel:
    def __init__(self, depth, params):
        import jax
        from sageattention_tpu.models import sage_dot_product_attention
        from sageattention_tpu.models.llm import LlamaConfig, LlamaLM
        cfg = LlamaConfig(depth=depth, **CFG)
        exact, sage = LlamaLM(cfg), LlamaLM(cfg, attn_fn=sage_dot_product_attention)
        self.p = params
        self.exact, self.sage = jax.jit(exact.apply), jax.jit(sage.apply)
        self.prefill_fn = jax.jit(sage.apply, static_argnames="max_len")
        self.step_fn = jax.jit(lambda p, t, c, pos: sage.apply(p, t, caches=c, pos=pos))

    def forward(self, tokens, exact=False):
        return np.asarray((self.exact if exact else self.sage)(self.p, tokens), np.float32)

    def prefill(self, tokens, max_len):
        return self.prefill_fn(self.p, tokens, max_len=max_len)[1]

    def step(self, token, caches, pos):
        logits, caches = self.step_fn(self.p, token, caches, pos)
        return np.asarray(logits, np.float32), caches


class TorchModel:
    def __init__(self, depth, params):
        import torch
        from sageattention_tpu_torch.models import (LlamaConfig, LlamaLM, llm_state_dict_from_jax,
                                                    sage_dot_product_attention)
        self.torch = torch
        cfg = LlamaConfig(depth=depth, **CFG)
        sd = llm_state_dict_from_jax(params)
        self.exact = LlamaLM(cfg, device="cpu")
        self.sage = LlamaLM(cfg, attn_fn=sage_dot_product_attention, device="cpu")
        self.exact.load_state_dict(sd)
        self.sage.load_state_dict(sd)

    def _t(self, tokens):
        return self.torch.tensor(np.asarray(tokens), dtype=self.torch.long)

    def forward(self, tokens, exact=False):
        with self.torch.no_grad():
            return (self.exact if exact else self.sage)(self._t(tokens)).float().numpy()

    def prefill(self, tokens, max_len):
        with self.torch.no_grad():
            return self.sage(self._t(tokens), max_len=max_len)[1]

    def step(self, token, caches, pos):
        with self.torch.no_grad():
            logits, caches = self.sage(self._t(token), caches=caches, pos=pos)
        return logits.float().numpy(), caches


def depth_witness(impl):
    P, steps = PROMPT, STEPS
    tokens = np.random.RandomState(SEED + 1).randint(0, CFG["vocab"], (1, P + steps)).astype(
        np.int32)
    checked = sorted({1, steps})
    for depth in DEPTHS:
        t0 = time.time()
        model = (JaxModel if impl == "jax" else TorchModel)(depth, llama_params(depth))
        exact = model.forward(tokens, exact=True)[0]
        caches = model.prefill(tokens[:, :P], P + steps)
        got = {}
        for i in range(1, steps + 1):
            logits, caches = model.step(tokens[:, P + i - 1:P + i], caches, P + i - 1)
            if i in checked:
                got[i] = logits[0, -1]
        row = {"impl": impl, "depth": depth, "prompt": P, "std": STD, "steps": {}}
        for i in checked:
            fwd = model.forward(tokens[:, :P + i])[0, -1]
            row["steps"][i] = {"int8_fwd_vs_exact": calc_diff(fwd, exact[P + i - 1]),
                               "step_vs_exact": calc_diff(got[i], exact[P + i - 1]),
                               "step_vs_int8_fwd": calc_diff(got[i], fwd)}
        row["seconds"] = round(time.time() - t0, 1)
        print(json.dumps(row), flush=True)


def bf16v_witness(impl):
    B, Hk, G, D, L = 1, 2, 4, 128, LENGTH
    rng = np.random.RandomState(SEED)
    k = rng.standard_normal((B, Hk, L, D)).astype(np.float32)
    k[..., 7] += 3.0
    v = rng.standard_normal((B, Hk, L, D)).astype(np.float32)
    q = rng.standard_normal((B, Hk * G, 1, D)).astype(np.float32)
    if impl == "jax":
        import jax.numpy as jnp
        from sageattention_tpu.decode import kv_cache_init, sageattn_decode
        kb, vb, qb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (k, v, q))
        cache = kv_cache_init(kb, vb, L, v_format="bf16")
        out = np.asarray(sageattn_decode(qb, cache).astype(jnp.float32))
        stored = np.asarray(cache.v.astype(jnp.float32))[:, :, :L] + np.asarray(
            cache.v_mean, np.float32)
        k, v, q = (np.asarray(x.astype(jnp.float32)) for x in (kb, vb, qb))
    else:
        import torch
        from sageattention_tpu_torch.decode import kv_cache_init, sageattn_decode
        kb, vb, qb = (torch.tensor(x).bfloat16() for x in (k, v, q))
        cache = kv_cache_init(kb, vb, L, v_format="bf16")
        out = sageattn_decode(qb, cache).float().numpy()
        stored = (cache.v[:, :, :L].float() + cache.v_mean.float()).numpy()
        k, v, q = (x.float().numpy() for x in (kb, vb, qb))
    k, v, stored, q = (x.astype(np.float64) for x in (k, v, stored, q))
    row = {"impl": impl, "length": L, "true_v": [], "stored_v": []}
    for h in range(Hk * G):
        s = q[0, h] @ k[0, h // G].T / np.sqrt(D)
        p = np.exp(s - s.max())
        p /= p.sum()
        row["true_v"].append(calc_diff(out[0, h], p @ v[0, h // G]))
        row["stored_v"].append(calc_diff(out[0, h], p @ stored[0, h // G]))
    print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("what", choices=("depth", "bf16v"))
    a = ap.parse_args()
    (depth_witness if a.what == "depth" else bf16v_witness)(a.impl)


if __name__ == "__main__":
    main()
