"""Per-channel statistics (A5) and the int8 quantizer with group, scalar and
channel scales (A6).

Counterparts of ``channel_stats_pallas``, ``quant_int8_groupwise_pallas``
and ``quant_int8_fixed_pallas`` in ``sageattention_tpu/ops/quant_pallas.py``
and of their NHD-direct twins: ``in_layout="NHD"`` reads a ``[B, S, H, D]``
tensor through its strides, and every output is HND.  Unlike the JAX NHD
entry, group scales come back per group in both layouts.

The arithmetic is the Pallas kernels': ``y = (x - sub) * fold``, scale =
``amax * (1/127)``, code = ``rint(y * (1 / scale))``.  The unfused
``ops.quant`` quantizers divide instead; the two can move a code by 1.

Group mode pads the rows to a multiple of ``group`` with zeros *before*
``sub`` is subtracted, as the JAX pipeline pads K before quantizing it, so
the pad rows of a partial last group hold ``-sub`` and enter its amax.

Each wrapper takes the plain PyTorch version for a CPU tensor and launches
the CUDA kernel (``csrc/quant.cu``) for a CUDA tensor; there is no fallback
between the two.  ``launches`` counts kernel launches: an int on
``channel_stats`` and ``quant_int8_groupwise``, a dict by mode on
``quant_int8_fixed``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import _build
from .quant import _seq_to_axis2
from .quant_fused import _INV127, _masked_stats
from ..utils.layout import pad_axis, round_up

_ROWS = 128  # rows per kernel block: group sizes must divide it
_VARLEN = ("arrive with the varlen slice (ROADMAP queue 1 item 7, kernel A6 "
           "segmented entry)")


def _f32(x: float) -> float:
    return float(np.float32(x))


def _hnd(x: torch.Tensor, in_layout: str) -> torch.Tensor:
    if x.ndim != 4:
        raise ValueError(f"expected a 4-d tensor, got shape {tuple(x.shape)}")
    return _seq_to_axis2(x, in_layout)


def _device(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no kernel for device {x.device}")
    return x.device.type


def _kernel_input(x: torch.Tensor) -> torch.Tensor:
    if x.shape[-1] not in (64, 128, 256):
        raise NotImplementedError(f"quant kernels take head_dim 64/128/256, got {x.shape[-1]}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        x = x.float()   # f16 and int8 are exact in f32; the kernels read bf16 or f32
    return _build.vector_aligned(x)


# ---------------------------------------------------------------- A5 ----

def channel_stats_plain(x: torch.Tensor, s_true: int):
    """Plain version of A5 on an HND view; see :func:`channel_stats`."""
    _, mean, amax = _masked_stats(x, s_true)
    return mean, amax


def channel_stats(x: torch.Tensor, s_true: int, in_layout: str = "HND"):
    """Per-channel mean over the true rows and amax(|x - mean|) by the
    max/min identity.  ``[B,H,S,D]`` (or ``[B,S,H,D]`` with
    ``in_layout="NHD"``) -> ``(mean [B,H,1,D], amax [B,H,1,D])`` f32."""
    x = _hnd(x, in_layout)
    if not 0 < s_true <= x.shape[2]:
        raise ValueError(f"s_true {s_true} out of range for S={x.shape[2]}")
    if _device(x) == "cpu":
        return channel_stats_plain(x, s_true)
    x = _kernel_input(x)
    B, H, S, D = x.shape
    dev = x.device
    nsplit = -(-s_true // 256)
    scratch = torch.empty((3, B * H * nsplit * D), dtype=torch.float32, device=dev)
    mean = torch.empty((B, H, 1, D), dtype=torch.float32, device=dev)
    amax = torch.empty((B, H, 1, D), dtype=torch.float32, device=dev)
    _build.call("sage_channel_stats", dev, 0 if x.dtype == torch.bfloat16 else 1,
                x.data_ptr(), *x.stride()[:3], B, H, s_true, D, _f32(1.0 / s_true),
                scratch[0].data_ptr(), scratch[1].data_ptr(), scratch[2].data_ptr(),
                mean.data_ptr(), amax.data_ptr())
    channel_stats.launches += 1
    return mean, amax


# ---------------------------------------------------------------- A6 ----

def quant_int8_plain(x: torch.Tensor, mode: str, group: int = 0, fold: float = 1.0,
                     sub: Optional[torch.Tensor] = None, scale: Optional[torch.Tensor] = None,
                     with_capmax: bool = False, s_true: int = 0):
    """Plain version of A6 on an HND view ``x`` whose rows are already a
    multiple of ``group`` (group mode).  Returns ``(codes, group scales |
    None, capmax | None)``."""
    y = x.float()
    if sub is not None:
        y = y - sub.float()
    if fold != 1.0:
        y = y * _f32(fold)
    B, H, S, D = y.shape
    if mode == "group":
        g = y.abs().amax(dim=3).view(B, H, S // group, group).amax(dim=3)
        gs = torch.where(g > 0, g * _INV127, torch.ones_like(g))
        row_scale = gs.repeat_interleave(group, dim=2)[..., None]
        inv = (1.0 / gs).repeat_interleave(group, dim=2)[..., None]
    else:
        gs, row_scale, inv = None, None, 1.0 / scale.float()
    codes = torch.clamp(torch.round(y * inv), -127, 127)
    cap = None
    if with_capmax:
        n = torch.sqrt((codes * codes).sum(dim=3, keepdim=True))
        if row_scale is not None:
            n = n * row_scale
        if s_true:
            n = n[:, :, :s_true]
        cap = n.amax(dim=2, keepdim=True)
    return codes.to(torch.int8), gs, cap


def _launch_quant(x, mode, group, fold, sub, scale, with_capmax, s_true, S_out):
    x = _kernel_input(x)
    B, H, S, D = x.shape
    dev = x.device
    out = torch.empty((B, H, S_out, D), dtype=torch.int8, device=dev)
    gs = (torch.empty((B, H, S_out // group), dtype=torch.float32, device=dev)
          if mode == "group" else None)
    cap = torch.zeros((B, H, 1, 1), dtype=torch.float32, device=dev) if with_capmax else None
    sub = None if sub is None else sub.float().contiguous()
    scale = None if scale is None else scale.float().contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.call("sage_quant_int8", dev, {"group": 0, "scalar": 1, "channel": 2}[mode],
                int(with_capmax), 0 if x.dtype == torch.bfloat16 else 1, x.data_ptr(),
                *x.stride()[:3], B, H, S, S_out, D, group or 1, _f32(fold), int(fold != 1.0),
                ptr(sub), ptr(scale), out.data_ptr(), ptr(gs), ptr(cap), s_true or S_out)
    return out, gs, cap


def _unsupported(with_norm, dot_with=None, segment_ids=None):
    if with_norm or dot_with is not None or segment_ids is not None:
        raise NotImplementedError(f"with_norm, dot_with and segment_ids {_VARLEN}")


def quant_int8_groupwise(x: torch.Tensor, group: int, fold: float = 1.0,
                         sub: Optional[torch.Tensor] = None, with_norm: bool = False,
                         dot_with=None, with_capmax: bool = False, s_true: int = 0,
                         in_layout: str = "HND", segment_ids=None):
    """Per-row-group int8: ``x [B,H,S,D]`` (NHD with ``in_layout``) ->
    ``(int8 [B,H,S_pad,D], scales [B,H,S_pad//group][, capmax [B,H,1,1]])``
    with ``S_pad`` the next multiple of ``group``.  ``capmax`` is the max
    over rows ``< s_true`` (every row when 0) of ``scale_row *
    ||x8_row||``."""
    _unsupported(with_norm, dot_with, segment_ids)
    x = _hnd(x, in_layout)
    if group <= 0 or _ROWS % group:
        raise NotImplementedError(f"group sizes dividing {_ROWS} only, got {group}")
    S_out = round_up(x.shape[2], group)
    if _device(x) == "cpu":
        codes, gs, cap = quant_int8_plain(pad_axis(x, 2, S_out), "group", group, fold, sub,
                                          with_capmax=with_capmax, s_true=s_true)
    else:
        codes, gs, cap = _launch_quant(x, "group", group, fold, sub, None, with_capmax,
                                       s_true, S_out)
        quant_int8_groupwise.launches += 1
    return (codes, gs, cap) if with_capmax else (codes, gs)


def quant_int8_fixed(x: torch.Tensor, scale: torch.Tensor, fold: float = 1.0,
                     sub: Optional[torch.Tensor] = None, with_norm: bool = False,
                     with_capmax: bool = False, s_true: int = 0, in_layout: str = "HND"):
    """int8 at a given scale: ``[B,H,1,1]`` (scalar, per head) or
    ``[B,H,1,D]`` (channel).  Returns the codes ``[B,H,S,D]`` (and, scalar
    mode only, the per-head capmax of the unscaled ``||x8_row||``)."""
    _unsupported(with_norm)
    x = _hnd(x, in_layout)
    mode = "scalar" if scale.shape[-1] == 1 else "channel"
    if with_capmax and mode == "channel":
        raise NotImplementedError("capmax is a scalar-mode output")
    if _device(x) == "cpu":
        codes, _, cap = quant_int8_plain(x, mode, fold=fold, sub=sub, scale=scale,
                                         with_capmax=with_capmax, s_true=s_true)
    else:
        codes, _, cap = _launch_quant(x, mode, 0, fold, sub, scale, with_capmax, s_true,
                                      x.shape[2])
        quant_int8_fixed.launches[mode] += 1
    return (codes, cap) if with_capmax else codes


channel_stats.launches = 0
quant_int8_groupwise.launches = 0
quant_int8_fixed.launches = {"scalar": 0, "channel": 0}
