"""SageAttention3-style microscaled FP4 attention, as a numerics simulation.

Counterpart of ``sageattention_tpu/ops/lowbit.py``: the algorithms of
SageAttention3 (micro-scaled FP4 Q/K/V with one scale per 16 elements on the
e2m1 grid {0, ±0.5, ±1, ±1.5, ±2, ±3, ±4, ±6} at amax / 6; Q's per-128-token
block mean removed before quantization and restored in the scores; K
mean-centered; P re-quantized to FP4 per tile).  The H100 has no FP4 matrix
product, so nothing here runs in four bits: the codes are e2m1 values
carried in bf16 and the products run in bf16 or f32.  What the module gives
is SageAttention3's accuracy at real model lengths.

- :func:`sageattn3` materializes the S x S scores: the reference, never on
  a card path at full length;
- :func:`sageattn3_tiled` (and its alias :func:`sageattn3_blackwell`) runs
  the same quantizers in plain torch, then one launch of the flash kernel
  in its ``p_sim_fp4`` configuration (B4-fp4, ``csrc/flash_sm90.cu``'s FP4
  instantiations), which rounds each 64-column P tile to e2m1 at (its row
  max) / 6.  The
  quantizers stay plain torch on the card: the JAX package computes them in
  ``jnp`` outside any kernel.  A CPU tensor takes the kernel's plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

# e2m1 representable magnitudes
E2M1_GRID = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
E2M1_MAX = 6.0
MICROSCALE_BLOCK = 16  # elements per scale factor


def _round_to_e2m1(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest e2m1 value (magnitude grid, sign kept): strict
    ``>`` at each midpoint, so a tie rounds to the smaller magnitude."""
    mag = x.abs()
    q = torch.zeros_like(mag)
    for lo, hi in zip(E2M1_GRID[:-1], E2M1_GRID[1:]):
        q = torch.where(mag > (lo + hi) / 2.0, hi, q)
    return torch.sign(x) * q


def quant_fp4_microscaled(x: torch.Tensor, block: int = MICROSCALE_BLOCK):
    """Micro-scaled FP4 quantization along the last axis.

    Returns ``(codes, scales)``: e2m1 values carried in bf16, and one f32
    scale per ``block`` elements, ``amax / 6`` (1 where amax is 0).
    """
    *lead, D = x.shape
    if D % block:
        raise ValueError(f"last axis {D} is not a multiple of the microscale block {block}")
    xb = x.float().reshape(*lead, D // block, block)
    amax = xb.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / E2M1_MAX, torch.ones_like(amax))
    codes = _round_to_e2m1(xb / scale)
    return codes.reshape(*lead, D).to(torch.bfloat16), scale[..., 0]


def dequant_fp4_microscaled(codes: torch.Tensor, scales: torch.Tensor,
                            block: int = MICROSCALE_BLOCK) -> torch.Tensor:
    *lead, D = codes.shape
    cb = codes.float().reshape(*lead, D // block, block)
    return (cb * scales[..., None]).reshape(*lead, D)


def q_block_mean_center(q: torch.Tensor, block: int = 128):
    """Subtract the per-``block``-token mean from Q.

    Returns ``(q_centered [B, H, S, D] f32, q_means [B, H, S/block, D])``;
    the removed component comes back inside attention as ``q_mean @ K^T``.
    """
    B, H, S, D = q.shape
    if S % block:
        raise ValueError(f"length {S} is not a multiple of the block {block}")
    qb = q.float().reshape(B, H, S // block, block, D)
    qm = qb.mean(dim=3, keepdim=True)
    return (qb - qm).reshape(B, H, S, D), qm[:, :, :, 0]


def _fp4_round_trip(x: torch.Tensor) -> torch.Tensor:
    return dequant_fp4_microscaled(*quant_fp4_microscaled(x))


def sageattn3(q, k, v, is_causal: bool = False, sm_scale: Optional[float] = None,
              q_block: int = 128):
    """FP4-microscaled attention with SageAttention3's quantization points,
    on the whole S x S score matrix (the reference for :func:`sageattn3_tiled`).

    HND inputs ``[B, H, S, D]``: K centered by its mean; Q block-mean
    centered; Q, K, V quantized per 16 elements; ``s = dq(q4) dq(k4)^T +
    q_mean k_c^T`` times ``sm_scale``; softmax; P quantized per 16 columns
    and renormalized; ``out = P dq(v4)``.
    """
    from .reference import _no_tf32

    B, H, Sq, D_og = q.shape
    Sk = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / (D_og ** 0.5)
    pad_d = (-D_og) % MICROSCALE_BLOCK
    kf, vf = k.float(), v.float()
    qf = q.float()
    if pad_d:
        qf, kf, vf = (torch.nn.functional.pad(x, (0, pad_d)) for x in (qf, kf, vf))
    kc = kf - kf.mean(dim=2, keepdim=True)
    pad_q = (-Sq) % q_block
    qc, qm = q_block_mean_center(torch.nn.functional.pad(qf, (0, 0, 0, pad_q)), q_block)
    qd = _fp4_round_trip(qc)[:, :, :Sq]
    kd, vd = _fp4_round_trip(kc), _fp4_round_trip(vf)
    with _no_tf32():
        s = torch.matmul(qd, kd.transpose(-1, -2))
        # the removed block means, unquantized: row r of block b gets qm[b] kc^T
        delta = torch.matmul(qm, kc.transpose(-1, -2))
        s = (s + delta.repeat_interleave(q_block, dim=2)[:, :, :Sq]) * sm_scale
        if is_causal:
            keep = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril_()
            s = torch.where(keep, s, -1e30)
        p = torch.softmax(s, dim=-1)
        del s
        pad_p = (-Sk) % MICROSCALE_BLOCK
        pd = _fp4_round_trip(torch.nn.functional.pad(p, (0, pad_p)))[..., :Sk]
        pd = pd / torch.clamp_min(pd.sum(dim=-1, keepdim=True), 1e-30)
        out = torch.matmul(pd, vd)[..., :D_og]
    return out.to(q.dtype)


def sageattn3_tiled(q, k, v, is_causal: bool = False, sm_scale: Optional[float] = None,
                    q_block: int = 128, block_q: int = 0, block_k: int = 0):
    """SageAttention3's simulation in O(S) memory: the quantizers of
    :func:`sageattn3`, then one flash launch with ``p_sim_fp4`` (B4-fp4).

    Two deviations from :func:`sageattn3`, as in the JAX package: the
    removed Q block mean (f32, unquantized) is folded back into the
    dequantized Q before the kernel (``(qc + qm) k^T`` instead of adding
    ``qm k^T`` to the scores; the bf16 carrier rounds the sum), and P is
    re-quantized per (row, kv tile) max rather than per 16 columns.
    The kernel's kv tile is 64 columns, so a result matches JAX's closely
    only where JAX runs 64-wide tiles (``block_q=block_k=64``); otherwise
    the two round P against different tile maxima.  ``block_q``/``block_k``
    are accepted as in JAX and steer nothing else: the kernel masks the
    ragged edges itself, so the sequences are not padded to blocks.
    HND inputs ``[B, H, S, D]``; head dims are padded to 64, 128 or 256.
    """
    from .attention import AttnConfig, attention_call

    B, H, Sq, D_og = q.shape
    Sk = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / (D_og ** 0.5)
    d_target = 64 if D_og <= 64 else (128 if D_og <= 128 else 256)
    pad = lambda x: torch.nn.functional.pad(x.float(), (0, d_target - D_og))  # noqa: E731
    kf = pad(k)
    kc = kf - kf.mean(dim=2, keepdim=True)
    del kf
    pad_q = (-Sq) % q_block
    qc, qm = q_block_mean_center(torch.nn.functional.pad(pad(q), (0, 0, 0, pad_q)), q_block)
    # fold the unquantized f32 block means back into the dequantized Q
    qd = (_fp4_round_trip(qc) + qm.repeat_interleave(q_block, dim=2))[:, :, :Sq]
    del qc
    qd = qd.to(torch.bfloat16)
    kd = _fp4_round_trip(kc).to(torch.bfloat16)
    del kc
    vd = _fp4_round_trip(pad(v)).to(torch.bfloat16)
    cfg = AttnConfig(causal=is_causal, quantized=False, layout="HND", sm_scale=sm_scale,
                     kv_len=Sk, out_dtype=torch.bfloat16, emit_lse=False, p_sim_fp4=True)
    out, _ = attention_call(qd, kd, vd, cfg=cfg)
    return out[..., :D_og].to(q.dtype)


def sageattn3_blackwell(q, k, v, *args, **kwargs):
    """The reference's name for :func:`sageattn3_tiled` (``qk_quant_gran``
    is accepted and dropped)."""
    kwargs.pop("qk_quant_gran", None)
    return sageattn3_tiled(q, k, v, *args, **kwargs)
