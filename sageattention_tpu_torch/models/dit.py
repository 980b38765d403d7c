"""CogVideoX-style video diffusion transformer (counterpart of
``sageattention_tpu/models/dit.py``).

Joint text+video token attention with adaLN-zero modulation.  The numerics
follow the flax model: bf16 compute with fp32 parameters, tanh GELU (flax's
default), LayerNorm with eps 1e-6 whose statistics are taken in f32 as
E[x^2] - E[x]^2, and no scale or bias inside the blocks.  Attention inputs
are NHD ([B, S, H, D]); ``attn_fn`` is any callable with the
``jax.nn.dot_product_attention`` argument order, SageAttention by default.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .integration import sage_dot_product_attention

AttentionFn = Callable  # (q, k, v) -> out, NHD layout


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    hidden: int = 512
    heads: int = 8
    depth: int = 4
    patch: int = 2            # spatial patch size
    in_channels: int = 16     # latent channels
    text_dim: int = 512
    text_len: int = 64
    frames: int = 4           # latent frames
    height: int = 32          # latent H
    width: int = 32           # latent W
    mlp_ratio: float = 4.0
    dtype: torch.dtype = torch.bfloat16
    # adaLN-Zero starts every block as the identity; comparisons of attention
    # implementations must turn it off, or attention is ignored entirely
    zero_init_gates: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def video_tokens(self) -> int:
        return self.frames * (self.height // self.patch) * (self.width // self.patch)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class Dense(nn.Linear):
    """``nn.Linear`` with fp32 parameters that computes in ``dtype``."""

    def __init__(self, in_features, out_features, dtype, device=None):
        super().__init__(in_features, out_features, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.compute_dtype), self.weight.to(self.compute_dtype),
                        self.bias.to(self.compute_dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: f32 statistics, eps 1e-6, output in ``dtype``."""

    def __init__(self, dim, dtype, affine: bool, eps: float = 1e-6, device=None):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        if affine:
            self.weight = nn.Parameter(torch.ones(dim, device=device))
            self.bias = nn.Parameter(torch.zeros(dim, device=device))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, 0.0)
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (xf - mu) * mul
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype)


class AdaLNZero(nn.Module):
    """adaLN-Zero modulation: 6 vectors per block from the conditioning."""

    def __init__(self, hidden, dtype, device=None):
        super().__init__()
        self.linear = Dense(hidden, 6 * hidden, dtype, device=device)

    def forward(self, c):
        mods = self.linear(F.silu(c))
        return torch.chunk(mods[:, None, :], 6, dim=-1)


class JointBlock(nn.Module):
    """CogVideoX-style joint text+video transformer block."""

    def __init__(self, cfg: DiTConfig, attn_fn: Optional[AttentionFn] = None, device=None):
        super().__init__()
        device = torch.device("cuda" if device is None else device)
        self.cfg = cfg
        self.attn_fn = attn_fn or sage_dot_product_attention
        h, dt = cfg.hidden, cfg.dtype
        mlp = int(h * cfg.mlp_ratio)
        self.ada = AdaLNZero(h, dt, device=device)
        self.ln1 = LayerNorm(h, dt, affine=False, device=device)
        self.qkv = Dense(h, 3 * h, dt, device=device)
        self.proj = Dense(h, h, dt, device=device)
        self.ln2 = LayerNorm(h, dt, affine=False, device=device)
        self.fc1 = Dense(h, mlp, dt, device=device)
        self.fc2 = Dense(mlp, h, dt, device=device)

    def forward(self, x, c):
        cfg = self.cfg
        shift1, scale1, gate1, shift2, scale2, gate2 = self.ada(c)
        if not cfg.zero_init_gates:
            gate1 = 1.0 + gate1
            gate2 = 1.0 + gate2
        h = self.ln1(x) * (1 + scale1) + shift1
        q, k, v = torch.chunk(self.qkv(h), 3, dim=-1)
        B, S, _ = q.shape
        shape = (B, S, cfg.heads, cfg.head_dim)
        o = self.attn_fn(q.reshape(shape), k.reshape(shape), v.reshape(shape))
        o = o.reshape(B, S, cfg.hidden).to(cfg.dtype)
        x = x + gate1 * self.proj(o)
        h = self.ln2(x) * (1 + scale2) + shift2
        h = self.fc2(F.gelu(self.fc1(h), approximate="tanh"))
        return x + gate2 * h


class DiT(nn.Module):
    """Video DiT: patchify(latents) ++ text -> N joint blocks -> unpatchify.

    ``attn_fn`` is a callable, or a per-layer selector (``_per_layer`` set)
    mapping a block index to a callable.  The parameters live on ``device``,
    the first CUDA card unless told otherwise."""

    def __init__(self, cfg: DiTConfig, attn_fn: Optional[AttentionFn] = None, device=None):
        super().__init__()
        device = torch.device("cuda" if device is None else device)
        self.cfg = cfg
        h, dt, p, C = cfg.hidden, cfg.dtype, cfg.patch, cfg.in_channels
        self.patch_embed = Dense(p * p * C, h, dt, device=device)
        self.pos_emb = nn.Parameter(torch.zeros(1, cfg.video_tokens, h, device=device))
        self.text_embed = Dense(cfg.text_dim, h, dt, device=device)
        self.t_embed = Dense(256, h, dt, device=device)
        self.t_embed2 = Dense(h, h, dt, device=device)
        if attn_fn is not None and not callable(attn_fn):
            raise TypeError("attn_fn must be callable")
        per_layer = getattr(attn_fn, "_per_layer", False)
        self.blocks = nn.ModuleList(
            JointBlock(cfg, attn_fn(i) if per_layer else attn_fn, device=device)
            for i in range(cfg.depth))
        self.final_norm = LayerNorm(h, dt, affine=True, device=device)
        self.final = Dense(h, p * p * C, dt, device=device)

    @torch.no_grad()
    def init_weights(self, seed: int = 0):
        """Random weights from ``seed`` (on the parameters' device): linear
        kernels N(0, 1/fan_in), zero biases, positional embedding N(0, 0.02),
        adaLN modulation zero or N(0, 0.02) as ``zero_init_gates`` says."""
        dev = self.pos_emb.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        for name, mod in self.named_modules():
            if isinstance(mod, Dense):
                if name.endswith("ada.linear"):
                    std = 0.0 if self.cfg.zero_init_gates else 0.02
                else:
                    std = mod.in_features ** -0.5
                mod.weight.normal_(0.0, 1.0, generator=gen).mul_(std)
                mod.bias.zero_()
        self.pos_emb.normal_(0.0, 1.0, generator=gen).mul_(0.02)
        self.final_norm.weight.fill_(1.0)
        self.final_norm.bias.zero_()
        return self

    def forward(self, latents, text_emb, t):
        """latents [B, F, H, W, C]; text_emb [B, L, text_dim]; t [B]."""
        cfg = self.cfg
        B, Fr, H, W, C = latents.shape
        p = cfg.patch
        x = latents.reshape(B, Fr, H // p, p, W // p, p, C)
        x = x.permute(0, 1, 2, 4, 3, 5, 6).reshape(B, cfg.video_tokens, p * p * C)
        x = self.patch_embed(x) + self.pos_emb.to(cfg.dtype)
        x = torch.cat([self.text_embed(text_emb), x], dim=1)
        c = self.t_embed(timestep_embedding(t, 256).to(cfg.dtype))
        c = self.t_embed2(F.silu(c))
        for block in self.blocks:
            x = block(x, c)
        x = self.final(self.final_norm(x[:, cfg.text_len:]))
        x = x.reshape(B, Fr, H // p, W // p, p, p, C)
        return x.permute(0, 1, 2, 4, 3, 5, 6).reshape(B, Fr, H, W, C)


def make_dit(cfg: DiTConfig, attn_fn: Optional[AttentionFn] = None, device=None) -> DiT:
    """``DiT(cfg, attn_fn, device)``, as JAX's ``make_dit``."""
    return DiT(cfg, attn_fn, device=device)


def example_inputs(cfg: DiTConfig, batch: int = 1, generator: Optional[torch.Generator] = None,
                   device=None):
    """``(latents [B, F, H, W, C], text [B, L, text_dim], t [B])``: standard
    normal f32 latents and text from ``generator`` (a fresh one seeded 0 by
    default), every timestep 500, on ``device`` (the card by default)."""
    device = torch.device("cuda" if device is None else device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    latents = torch.randn(batch, cfg.frames, cfg.height, cfg.width, cfg.in_channels,
                          generator=generator, device=device)
    text = torch.randn(batch, cfg.text_len, cfg.text_dim, generator=generator, device=device)
    t = torch.full((batch,), 500, dtype=torch.int32, device=device)
    return latents, text, t


def diffusion_loss(model: DiT, batch, generator: Optional[torch.Generator] = None, *,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The epsilon-prediction MSE of JAX's ``diffusion_loss`` (the training
    step's workload): ``noisy = alpha * latents + sqrt(1 - alpha^2) * noise``
    with ``alpha = 1 - t / 1000``, the f32 mean of ``(model(noisy) -
    noise)^2``.  The noise is standard normal from ``generator`` (where JAX
    takes a ``jax.random`` key), or given as ``noise``."""
    latents, text, t = batch
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=latents.device,
                            dtype=latents.dtype)
    alpha = (1.0 - t.float() / 1000.0)[:, None, None, None, None]
    noisy = alpha * latents + (1 - alpha ** 2) ** 0.5 * noise
    pred = model(noisy, text, t)
    return torch.mean((pred.float() - noise) ** 2)
