"""Quantization front end in plain PyTorch (counterpart of
``sageattention_tpu/ops/quant.py``).

These are the unfused quantizers: they divide by the scale, as the JAX
ones do, where the fused kernels (``ops.quant_kernels``, ``ops.quant_fused``)
multiply by its reciprocal.  The two can differ in the last bit of a value
and so move a code by 1.  Scales are ``[B, H, n_groups]`` float32,
symmetric int8 at ``amax / 127`` with round-to-nearest-even.

Granularities (rows per scale group, Q and K):
``per_block`` 128/64, ``per_warp`` 32/64, ``per_thread`` 4/16.
The segmented (varlen) quantizer arrives with the varlen slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

LOG2E = 1.4426950408889634

# Granularity name -> (q_group_rows, k_group_rows)
QUANT_GRANULARITIES = {
    "per_block": (128, 64),
    "per_warp": (32, 64),
    "per_thread": (4, 16),
}


def _seq_to_axis2(x: torch.Tensor, tensor_layout: str) -> torch.Tensor:
    """View ``x`` as [B, H, S, D] whatever its layout."""
    if tensor_layout == "NHD":
        return x.transpose(1, 2)
    if tensor_layout != "HND":
        raise ValueError(f"tensor_layout must be 'HND' or 'NHD', got {tensor_layout!r}")
    return x


def quant_int8_groupwise(x: torch.Tensor, group: int, fold: float = 1.0,
                         sub: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over groups of ``group`` rows of ``x [B, H, S, D]``:
    ``sub`` is subtracted first, then ``fold`` multiplied in.  Returns
    ``(int8 [B,H,S,D], scales [B,H,S//group])``."""
    B, H, S, D = x.shape
    if S % group != 0:
        raise ValueError(f"seq {S} not a multiple of quant group {group}")
    xf = x.float()
    if sub is not None:
        xf = xf - sub.float()
    if fold != 1.0:
        xf = xf * fold
    xg = xf.reshape(B, H, S // group, group, D)
    scale = xg.abs().amax(dim=(3, 4)) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xg / safe[..., None, None]), -127, 127).to(torch.int8)
    return q.reshape(B, H, S, D), safe


def expand_scales_rows(scales: torch.Tensor, group: int, seq: int) -> torch.Tensor:
    """[B,H,nG] group scales -> [B,H,S,1] per-row scales."""
    if scales.shape[2] * group != seq:
        raise ValueError(f"{scales.shape[2]} groups of {group} rows != {seq}")
    return scales.repeat_interleave(group, dim=2)[..., None]


def expand_scales_cols(scales: torch.Tensor, group: int, seq: int) -> torch.Tensor:
    """[B,H,nG] group scales -> [B,H,1,S] per-column scales."""
    if scales.shape[2] * group != seq:
        raise ValueError(f"{scales.shape[2]} groups of {group} rows != {seq}")
    return scales.repeat_interleave(group, dim=2)[:, :, None, :]


def _quant_qk(q, k, km, sm_scale, q_group, k_group, tensor_layout):
    qh = _seq_to_axis2(q, tensor_layout)
    kh = _seq_to_axis2(k, tensor_layout)
    if sm_scale is None:
        sm_scale = 1.0 / (qh.shape[-1] ** 0.5)
    q_i8, q_s = quant_int8_groupwise(qh, q_group, fold=sm_scale * LOG2E)
    k_i8, k_s = quant_int8_groupwise(kh, k_group, sub=km)
    return (_seq_to_axis2(q_i8, tensor_layout), q_s,
            _seq_to_axis2(k_i8, tensor_layout), k_s)


def per_block_int8(q, k, km=None, sm_scale=None, BLKQ: int = 128, BLKK: int = 64,
                   tensor_layout: str = "HND"):
    """Q per ``BLKQ`` rows, K per ``BLKK`` rows (``km`` subtracted from K).
    Returns ``(q_int8, q_scale, k_int8, k_scale)``."""
    return _quant_qk(q, k, km, sm_scale, BLKQ, BLKK, tensor_layout)


def per_warp_int8(q, k, km=None, sm_scale=None, BLKQ: int = 128, WARPQ: int = 32,
                  BLKK: int = 64, tensor_layout: str = "HND"):
    """Q per ``WARPQ`` rows, K per ``BLKK`` rows."""
    del BLKQ
    return _quant_qk(q, k, km, sm_scale, WARPQ, BLKK, tensor_layout)


def per_thread_int8(q, k, km=None, sm_scale=None, BLKQ: int = 128, WARPQ: int = 32,
                    BLKK: int = 64, WARPK: int = 64, tensor_layout: str = "HND"):
    """The finest granularity: Q per 4 rows, K per 16 rows."""
    del BLKQ, WARPQ, BLKK, WARPK
    qg, kg = QUANT_GRANULARITIES["per_thread"]
    return _quant_qk(q, k, km, sm_scale, qg, kg, tensor_layout)


def k_mean(k: torch.Tensor, tensor_layout: str = "HND") -> torch.Tensor:
    """Mean of K over the sequence axis, ``[B, H, 1, D]`` in HND view (the
    ``km`` of smooth_k)."""
    return _seq_to_axis2(k, tensor_layout).float().mean(dim=2, keepdim=True)


def sub_mean(v: torch.Tensor, tensor_layout: str = "HND"):
    """V smoothing: ``(v - mean_seq(v)`` as bf16 in ``v``'s layout, ``vm
    [B,H,1,D])``."""
    vh = _seq_to_axis2(v, tensor_layout).float()
    vm = vh.mean(dim=2, keepdim=True)
    return _seq_to_axis2((vh - vm).to(torch.bfloat16), tensor_layout), vm


def _per_channel(v, tensor_layout, smooth_v, scale_max, cast):
    vh = _seq_to_axis2(v, tensor_layout).float()
    vm = None
    if smooth_v:
        vm = vh.mean(dim=2, keepdim=True)
        vh = vh - vm
    scale = vh.abs().amax(dim=2) / scale_max            # [B, H, D]
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return _seq_to_axis2(cast(vh / safe[:, :, None, :]), tensor_layout), safe, vm


def per_channel_fp8(v, tensor_layout: str = "HND", scale_max: float = 448.0,
                    smooth_v: bool = True):
    """Per-channel e4m3 V: ``(v_fp8, v_scale [B,H,D], vm [B,H,1,D] | None)``."""
    return _per_channel(v, tensor_layout, smooth_v, scale_max,
                        lambda x: x.to(torch.float8_e4m3fn))


def per_channel_int8(v, tensor_layout: str = "HND", smooth_v: bool = True):
    """Per-channel symmetric int8 V: ``(v_int8, v_scale [B,H,D], vm | None)``."""
    return _per_channel(v, tensor_layout, smooth_v, 127.0,
                        lambda x: torch.clamp(torch.round(x), -127, 127).to(torch.int8))


def dequant_int8_groupwise(x_i8: torch.Tensor, scales: torch.Tensor, group: int) -> torch.Tensor:
    """Inverse of :func:`quant_int8_groupwise` (testing only)."""
    B, H, S, D = x_i8.shape
    xs = x_i8.float().reshape(B, H, S // group, group, D)
    return (xs * scales[..., None, None]).reshape(B, H, S, D)
