"""Model integration: drop-in attention callables for NHD models
(counterpart of ``sageattention_tpu/models/integration.py``).

- :func:`sage_dot_product_attention` takes the arguments of
  ``jax.nn.dot_product_attention`` (NHD: [batch, seq, heads, head_dim]), the
  signature the JAX package's models call, and runs :func:`sageattn`, with
  ``mask``/``bias`` as its ``attn_mask`` and a causal
  ``local_window_size=(left, 0)`` as its sliding window; ``quant_backward``
  passes through to the backward.  What the JAX function hands to the exact
  ``jax.nn`` attention (a mask and a bias together, sequence lengths, other
  windows) raises here: there is no silent fallback to another attention.
- :func:`flash_dot_product_attention`: the port's exact attention (bf16
  flash, B4) with the same arguments, differentiable through the bf16
  backward kernels C1/C2, as ``jax.nn.dot_product_attention`` is through
  autodiff in the JAX models.
- :func:`sage_joint_attention_ragged`: Mochi-style joint attention that
  strips each row's padded text tokens through one ``sageattn_varlen`` call.
- :func:`layered_attention`: a per-layer selector (the reference's
  per-block processor swap) whose skipped layers run the port's exact
  ``flash_attention``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import _wants_grad, flash_attention, sageattn
from ..ops import backward as backward_ops


def sage_dot_product_attention(
    query,
    key,
    value,
    bias=None,
    mask=None,
    *,
    scale: Optional[float] = None,
    is_causal: bool = False,
    query_seq_lengths=None,
    key_value_seq_lengths=None,
    local_window_size=None,
    implementation=None,
    **kwargs,
):
    """SageAttention on NHD inputs with ``jax.nn.dot_product_attention``'s
    arguments; ``kwargs`` (``quant_backward``, the mode arguments) pass
    through to :func:`sageattn`.  ``mask`` (bool,
    keep where True) or ``bias`` (additive, natural log), broadcastable to
    ``[B, 1|H, Sq, Sk]``; ``local_window_size=(left, 0)`` with
    ``is_causal`` attends ``[r - left, r]``."""
    sliding = 0
    if local_window_size is not None:
        lw = (local_window_size if isinstance(local_window_size, (tuple, list))
              else (local_window_size, local_window_size))
        if is_causal and lw[1] == 0 and mask is None and bias is None:
            sliding = int(lw[0]) + 1     # row r attends [r - left, r]
            local_window_size = None
    unsupported = dict(mask_and_bias=(bias if mask is not None else None),
                       query_seq_lengths=query_seq_lengths,
                       key_value_seq_lengths=key_value_seq_lengths,
                       local_window_size=local_window_size)
    for name, val in unsupported.items():
        if val is not None:
            raise NotImplementedError(
                f"sage_dot_product_attention({name}=...): the JAX package hands this to "
                "the exact jax.nn attention; the port has no such fallback")
    attn_mask = None
    if mask is not None or bias is not None:
        m = mask if mask is not None else bias
        B, Sq, Sk = query.shape[0], query.shape[1], key.shape[1]
        hm = m.shape[1] if m.ndim == 4 and m.shape[1] != 1 else 1
        attn_mask = torch.broadcast_to(m, (B, hm, Sq, Sk))
    return sageattn(query, key, value, tensor_layout="NHD", is_causal=is_causal,
                    sm_scale=scale, attn_mask=attn_mask, sliding_window=sliding, **kwargs)


def sage_joint_attention_ragged(query, key, value, text_mask,
                                text_len: Optional[int] = None, **sage_kwargs):
    """Mochi-style ragged joint attention: each row's padded text tokens are
    stripped before attending, as the reference's per-row loop does
    (``example/modify_model/modify_mochi.py``), in one varlen call:

    - the text prefix of every row is permuted invalid-first (a stable sort
      of the mask, a gather);
    - each row becomes two segments of a packed varlen batch, its garbage
      prefix and its real sequence (valid text, then video), so
      segment-aware quantization keeps the garbage out of every scale and
      the segment mask replaces the loop.  A row whose text is all valid
      has an empty garbage segment (a repeated ``cu_seqlens`` entry);
    - outputs return to the original order with the invalid text positions
      zeroed (the reference zero-pads too).

    ``query``/``key``/``value``: NHD ``[B, S, H, D]`` with the text tokens
    first, padded to ``text_len`` (default ``text_mask.shape[1]``), then the
    video tokens, all valid.  ``text_mask``: bool ``[B, text_len]``, True =
    real token.  ``sage_kwargs`` pass through to ``sageattn_varlen``.
    """
    from ..varlen import sageattn_varlen

    B, S, H, D = query.shape
    T = int(text_mask.shape[1]) if text_len is None else int(text_len)
    if tuple(text_mask.shape) != (B, T):
        raise ValueError(f"text_mask must be [B={B}, text_len={T}], got "
                         f"{tuple(text_mask.shape)}")
    text_mask = text_mask.to(query.device)
    order = torch.argsort(text_mask.to(torch.int32), dim=1, stable=True)   # invalid first
    inv = torch.argsort(order, dim=1, stable=True)
    n_garbage = (T - text_mask.sum(dim=1)).to(torch.int32)                # [B]

    def compact(x):
        xt = torch.take_along_dim(x[:, :T], order[:, :, None, None], dim=1)
        return torch.cat([xt, x[:, T:]], dim=1).reshape(B * S, H, D)

    starts = torch.arange(B, dtype=torch.int32, device=query.device) * S
    # alternating (garbage, real) segment boundaries, then the total
    cu = torch.cat([torch.stack([starts, starts + n_garbage], dim=1).reshape(-1),
                    torch.full((1,), B * S, dtype=torch.int32, device=query.device)])
    out = sageattn_varlen(compact(query), compact(key), compact(value), cu, cu, S, S,
                          is_causal=False, **sage_kwargs).reshape(B, S, H, D)
    out_t = torch.take_along_dim(out[:, :T], inv[:, :, None, None], dim=1)
    out_t = torch.where(text_mask[:, :, None, None], out_t, torch.zeros_like(out_t))
    return torch.cat([out_t, out[:, T:]], dim=1).to(query.dtype)


class _FlashAttnFn(torch.autograd.Function):
    """``flash_attention`` (NHD) under autograd: forward with its lse,
    backward the bf16 C1/C2 from the saved ``(q, k, v, o, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, opts):
        out, lse = flash_attention(q, k, v, tensor_layout="NHD", return_lse=True, **opts)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        q, k, v, o = (x.transpose(1, 2) for x in (q, k, v, o))
        opts = ctx.opts
        sm_scale = opts["sm_scale"] or q.shape[-1] ** -0.5
        grads = backward_ops.attention_backward(
            q, k, v, o, lse, do.transpose(1, 2), sm_scale=sm_scale,
            is_causal=opts["is_causal"], window=opts["sliding_window"],
            sinks=opts["attention_sinks"])
        return (*(g.transpose(1, 2) for g in grads), None)


def flash_dot_product_attention(query, key, value, bias=None, mask=None, *,
                                scale: Optional[float] = None, is_causal: bool = False,
                                query_seq_lengths=None, key_value_seq_lengths=None,
                                local_window_size=None, implementation=None,
                                attention_sinks: int = 0):
    """The port's exact attention with ``jax.nn.dot_product_attention``'s
    arguments (NHD), on its bf16 flash kernel (B4): ``is_causal``, ``scale``
    and a causal ``local_window_size=(left, 0)`` (row r attends ``[r -
    left, r]``, plus ``attention_sinks`` first keys).  Masks, biases,
    sequence lengths and other windows raise.  Differentiable: the backward
    is the bf16 C1/C2."""
    sliding = 0
    if local_window_size is not None:
        lw = (local_window_size if isinstance(local_window_size, (tuple, list))
              else (local_window_size, local_window_size))
        if not (is_causal and lw[1] == 0):
            raise NotImplementedError("flash_dot_product_attention takes causal windows "
                                      "(left, 0) only")
        sliding = int(lw[0]) + 1
    for name, val in dict(bias=bias, mask=mask, query_seq_lengths=query_seq_lengths,
                          key_value_seq_lengths=key_value_seq_lengths).items():
        if val is not None:
            raise NotImplementedError(f"flash_dot_product_attention({name}=...) is not "
                                      "supported")
    opts = dict(is_causal=is_causal, sm_scale=scale, sliding_window=sliding,
                attention_sinks=attention_sinks)
    if _wants_grad(query, key, value):
        return _FlashAttnFn.apply(query, key, value, opts).to(query.dtype)
    return flash_attention(query, key, value, tensor_layout="NHD", **opts).to(query.dtype)


def layered_attention(default_fn=None, overrides=None, skip_layers=()):
    """Per-layer attention selection, the reference's second integration
    style (``example/modify_model/modify_mochi.py`` swaps processors per
    block and skips fragile layers, e.g. Mochi's last).

    Returns a selector for ``DiT(attn_fn=...)``: layer ``i`` runs
    ``overrides[i]`` if present, the port's exact ``flash_attention`` if
    ``i`` is in ``skip_layers``, else ``default_fn``
    (:func:`sage_dot_product_attention` by default)."""
    default_fn = default_fn or sage_dot_product_attention
    overrides = dict(overrides or {})
    skip = frozenset(skip_layers)

    def select(i: int):
        if i in skip:
            return flash_dot_product_attention
        return overrides.get(i, default_fn)

    select._per_layer = True
    return select
