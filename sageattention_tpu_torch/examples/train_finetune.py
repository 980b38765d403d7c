"""Fine-tuning with quantized attention end to end: the forward (int8 QK^T,
static softmax) and the backward (kernels C1/C2) of the port, the
counterpart of the JAX package's ``examples/train_finetune.py``.

A Llama-style LM learns a synthetic next-token rule three ways:

  exact      the port's exact attention (``flash_dot_product_attention``:
             bf16 flash forward, bf16 C1/C2 backward)
  sage       ``sage_dot_product_attention`` with its default backward (the
             model is causal, so the exact bf16 C1/C2)
  sage-int8  ``sage_dot_product_attention(quant_backward=True)``: the int8
             S-recompute of C1/C2

and prints each run's loss trajectory, its median ms per step, and the
largest loss drift of the sage runs from the exact one.

Run on the card:  python -m sageattention_tpu_torch.examples.train_finetune
On the CPU:       python -m sageattention_tpu_torch.examples.train_finetune --tiny --device cpu
"""

from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..models import LlamaConfig, LlamaLM, flash_dot_product_attention, sage_dot_product_attention


def batches(vocab, batch, seq, steps, seed=0, device="cuda"):
    """Synthetic 'skill': next token = (3 * tok + 7) % vocab, with a random
    token in 10% of places; the JAX example's stream from the same numpy
    seed, as int64 tensors on ``device``."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        t0 = rng.integers(0, vocab, (batch, 1))
        toks = [t0]
        for _ in range(seq - 1):
            nxt = (3 * toks[-1] + 7) % vocab
            flip = rng.random((batch, 1)) < 0.1
            nxt = np.where(flip, rng.integers(0, vocab, (batch, 1)), nxt)
            toks.append(nxt)
        yield torch.as_tensor(np.concatenate(toks, axis=1), device=device)


def lm_loss(model, toks):
    """Mean next-token cross-entropy (f32 log-softmax of the logits)."""
    logits = model(toks[:, :-1])
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, toks[:, 1:, None]).mean()


def train(model, data, lr=3e-4):
    """Adam (``torch.optim.Adam``'s defaults are ``optax.adam``'s) over
    ``data``; returns the losses and the median seconds of a step after the
    first."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    losses, t_steps = [], []
    for i, toks in enumerate(data):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(model, toks)
        loss.backward()
        opt.step()
        losses.append(loss.item())   # a host read ends the step
        if i > 0:
            t_steps.append(time.perf_counter() - t0)
    return losses, (float(np.median(t_steps)) if t_steps else 0.0)


RUNS = {
    "exact": flash_dot_product_attention,
    "sage": sage_dot_product_attention,
    "sage-int8": functools.partial(sage_dot_product_attention, quant_backward=True),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.tiny:
        cfg = LlamaConfig(hidden=128, heads=4, kv_heads=2, depth=2, vocab=64)
        batch, seq = 2, 256
    else:
        cfg = LlamaConfig(hidden=512, heads=8, kv_heads=4, depth=4, vocab=512)
        batch, seq = 4, 2048
    init = LlamaLM(cfg, device=args.device).init_weights(seed=0).state_dict()
    runs = {}
    for name, attn in RUNS.items():
        model = LlamaLM(cfg, attn_fn=attn, device=args.device)
        model.load_state_dict(init)
        data = batches(cfg.vocab, batch, seq, args.steps, seed=1, device=args.device)
        losses, t_med = train(model, data)
        runs[name] = losses
        print(f"{name:9s}: loss {losses[0]:.4f} -> {losses[-1]:.4f}  "
              f"({t_med * 1e3:.1f} ms/step)", flush=True)
    exact = np.array(runs["exact"])
    for name in ("sage", "sage-int8"):
        drift = np.abs(np.array(runs[name]) - exact).max()
        print(f"max |loss drift| {name} vs exact: {drift:.4f}")
    assert runs["sage"][-1] < runs["sage"][0] * 0.7, "no learning?"
    print("TRAIN OK")


if __name__ == "__main__":
    main()
