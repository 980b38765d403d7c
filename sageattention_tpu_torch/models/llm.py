"""Llama-style decoder (counterpart of ``sageattention_tpu/models/llm.py``).

Causal GQA attention with RoPE, a SwiGLU MLP and RMSNorm (eps 1e-6), with
the flax model's numerics: parameters in ``param_dtype`` (f32 by default,
as flax keeps them) used in the compute ``dtype`` (bf16), RMSNorm
statistics and RoPE angles in f32.  Attention is a pluggable NHD callable
with ``jax.nn.dot_product_attention``'s arguments (``attn_fn``); the
default is the port's exact attention on its flash kernel
(:func:`~sageattention_tpu_torch.models.integration.flash_dot_product_attention`),
where the JAX model calls ``jax.nn.dot_product_attention``.

Three modes, with the same weights:

- plain causal prefill: ``model(tokens)`` returns the logits;
- prefill that also builds caches: ``max_len > 0`` (a dense int8 cache per
  layer, ``decode.kv_cache_init``) or ``paged_spec={num_pages, page_table,
  lengths}`` (a page pool per layer, one table for all, ``paged.
  paged_prefill``); returns ``(logits, caches)``;
- decode of ``S`` new tokens against ``caches``: append, then attend the
  grown cache; ``pos=None`` takes each sequence's own length (paged) and
  ``active`` freezes finished slots.  Returns ``(logits, caches)``.

Constructors take ``device``, the first CUDA card unless told otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import decode as dec
from .. import paged as pg
from .integration import flash_dot_product_attention


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    hidden: int = 512
    heads: int = 8
    kv_heads: int = 2          # GQA
    depth: int = 4
    vocab: int = 1024
    mlp_ratio: float = 2.7
    rope_theta: float = 10000.0
    sliding_window: int = 0    # Mistral-class local attention (0 = full)
    attention_sinks: int = 0   # StreamingLLM sinks beside the window
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


def rope(x, theta: float = 10000.0, pos=0):
    """Rotary embedding over NHD ``[B, S, H, D]``; ``pos`` offsets the
    positions: a scalar, or a ``[B]`` tensor (each sequence's own index)."""
    B, S, H, D = x.shape
    half = D // 2
    dev = x.device
    # scalars stay on the host: a host-to-device copy per call would stall
    # the stream at every layer of a decode step
    freqs = float(theta) ** (-torch.arange(half, dtype=torch.float32, device=dev) / half)
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=dev, dtype=torch.float32).reshape(-1, 1)
    else:
        pos = float(pos)
    ang = ((torch.arange(S, dtype=torch.float32, device=dev)[None] + pos)[..., None]
           * freqs[None, None])                                      # [1|B, S, half]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def silu(x):
    """SiLU op by op in ``x``'s dtype, x * (1 / (1 + exp(-x))), each step
    rounded, as ``jax.nn.silu`` evaluates a bf16 input (``F.silu`` rounds
    once and differs in ~40% of bf16 outputs)."""
    return x * (1 / (1 + torch.exp(-x)))


def _device(device):
    return torch.device("cuda" if device is None else device)


class Linear(nn.Linear):
    """Bias-free ``nn.Linear`` whose parameters compute in ``dtype``."""

    def __init__(self, in_features, out_features, dtype, device=None, param_dtype=torch.float32):
        super().__init__(in_features, out_features, bias=False, device=device, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.compute_dtype), self.weight.to(self.compute_dtype))


class RMSNorm(nn.Module):
    def __init__(self, dim, dtype, device=None, param_dtype=torch.float32, eps: float = 1e-6):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=param_dtype))

    def forward(self, x):
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps)).to(self.dtype) * self.weight.to(self.dtype)


class LlamaBlock(nn.Module):
    """Decoder block; see the module docstring for its modes."""

    def __init__(self, cfg: LlamaConfig, attn_fn: Optional[Callable] = None, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        device = _device(device)
        self.cfg, self.attn_fn = cfg, attn_fn
        h, dt, kvw = cfg.hidden, cfg.dtype, cfg.kv_heads * cfg.head_dim
        inner = int(h * cfg.mlp_ratio)
        kw = dict(device=device, param_dtype=param_dtype)
        self.attn_norm = RMSNorm(h, dt, **kw)
        self.wq, self.wk, self.wv = Linear(h, h, dt, **kw), Linear(h, kvw, dt, **kw), \
            Linear(h, kvw, dt, **kw)
        self.wo = Linear(h, h, dt, **kw)
        self.mlp_norm = RMSNorm(h, dt, **kw)
        self.gate, self.up = Linear(h, inner, dt, **kw), Linear(h, inner, dt, **kw)
        self.down = Linear(inner, h, dt, **kw)

    def forward(self, x, cache=None, pos=0, max_len: int = 0, bucket: int = 0,
                paged_spec=None, active=None):
        cfg = self.cfg
        B, S, _ = x.shape
        if pos is None:
            if not isinstance(cache, pg.PagedKVCache):
                raise ValueError("pos=None (ragged positions) needs a paged cache")
            pos = cache.lengths
        h = self.attn_norm(x)
        q = rope(self.wq(h).reshape(B, S, cfg.heads, cfg.head_dim), cfg.rope_theta, pos=pos)
        k = rope(self.wk(h).reshape(B, S, cfg.kv_heads, cfg.head_dim), cfg.rope_theta, pos=pos)
        v = self.wv(h).reshape(B, S, cfg.kv_heads, cfg.head_dim)
        W = cfg.sliding_window
        if isinstance(cache, pg.PagedKVCache):
            if W and S > 1:
                raise ValueError("sliding-window decode is T=1; chunk the window")
            cache = pg.paged_append(cache, k, v, tensor_layout="NHD", active=active)
            o = pg.sageattn_decode_paged(q, cache, tensor_layout="NHD", pages_bucket=bucket,
                                         sliding_window=W,
                                         attention_sinks=cfg.attention_sinks)
        elif cache is not None:
            if W:
                raise ValueError("sliding-window serving needs the paged cache (paged_spec=...); "
                                 "the dense cache streams the full prefix")
            cache = dec.kv_cache_append(cache, k, v, tensor_layout="NHD")
            o = dec.sageattn_decode(q, cache, tensor_layout="NHD", bucket=bucket)
        else:
            if cfg.attention_sinks and self.attn_fn is None:
                raise ValueError(
                    "attention_sinks prefill needs an attn_fn that takes the kwarg (e.g. "
                    "sage_dot_product_attention); the default exact attention has no sinks")
            attn = self.attn_fn or flash_dot_product_attention
            o = attn(q, k, v, is_causal=True,
                     **({"local_window_size": (W - 1, 0)} if W else {}),
                     **({"attention_sinks": cfg.attention_sinks} if cfg.attention_sinks else {}))
            if paged_spec is not None:
                cache = pg.paged_prefill(k, v, paged_spec["lengths"], paged_spec["page_table"],
                                         num_pages=paged_spec["num_pages"], tensor_layout="NHD")
            elif max_len:
                cache = dec.kv_cache_init(k, v, max_len, tensor_layout="NHD")
        x = x + self.wo(o.reshape(B, S, cfg.hidden).to(cfg.dtype))
        h = self.mlp_norm(x)
        x = x + self.down(silu(self.gate(h)) * self.up(h))
        if max_len or paged_spec is not None or cache is not None:
            return x, cache
        return x


class LlamaLM(nn.Module):
    """``forward(tokens)`` -> logits; with ``max_len`` or ``paged_spec`` ->
    ``(logits, caches)``; with ``caches`` -> decode, ``(logits, caches)``."""

    def __init__(self, cfg: LlamaConfig, attn_fn: Optional[Callable] = None, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        device = _device(device)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab, cfg.hidden, device=device, dtype=param_dtype)
        self.layers = nn.ModuleList(LlamaBlock(cfg, attn_fn, device, param_dtype)
                                    for _ in range(cfg.depth))
        self.norm = RMSNorm(cfg.hidden, cfg.dtype, device=device, param_dtype=param_dtype)
        self.lm_head = Linear(cfg.hidden, cfg.vocab, cfg.dtype, device=device,
                              param_dtype=param_dtype)

    @torch.no_grad()
    def init_weights(self, seed: int = 0, std: float = 0.02):
        """Random weights from ``seed`` on the parameters' device: every
        linear kernel and the embedding N(0, std), norm scales 1."""
        gen = torch.Generator(device=self.embed.weight.device).manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=gen)
        return self

    def forward(self, tokens, caches=None, pos=0, max_len: int = 0, bucket: int = 0,
                paged_spec=None, active=None):
        cfg = self.cfg
        x = self.embed(tokens).to(cfg.dtype)
        new_caches = []
        for i, blk in enumerate(self.layers):
            if max_len or paged_spec is not None or caches is not None:
                x, c = blk(x, cache=None if caches is None else caches[i], pos=pos,
                           max_len=max_len, bucket=bucket, paged_spec=paged_spec, active=active)
                new_caches.append(c)
            else:
                x = blk(x)
        logits = self.lm_head(self.norm(x))
        if new_caches:
            return logits, tuple(new_caches)
        return logits
