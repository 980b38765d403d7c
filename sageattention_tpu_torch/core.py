"""Public API of the port: ``sageattn`` and the explicit per-mode entries.

Counterpart of ``sageattention_tpu/core.py``, with the JAX functions'
signatures, defaults and numerics (its ``use_fused`` pipeline: every
quantizer is a kernel, and a CPU tensor runs each kernel's plain version).
``_sage_attention`` runs:

1. pad the head dim to 64/128/256; pick the softmax (``"auto"``: static
   unless PV is fp8) and the compute mode (short sequences run the
   int8-storage / bf16-compute kernel, which forces per-head K scales; fp8
   PV keeps native compute there, as JAX's 512 tile floor does);
2. K and V prep.  The flagship combination (smooth_k, smooth_v, int8 V,
   per-head K scale) takes the one-pass kernels A1/A2.  Otherwise A5
   gives the K mean (smooth_k) and V's channel stats, and A6 quantizes:
   K at one scale per head (scalar mode) or per 16-row group (``"fine"``,
   with ``sub = km``), int8 V per channel;
3. Q: quantized inside the attention kernel when K has one scale per head
   and Q is float (``fuse_q_quant``); otherwise by A6 in group mode with
   the ``sm_scale * log2(e)`` fold;
4. V for ``pv_dtype="fp8"``: e4m3 codes at ``amax / 448`` and the mean of
   the actual codes folded into ``v_mean`` (:func:`fp8_v`); for ``"bf16"``
   V stays unquantized;
5. one attention launch (``ops.attention``).  Under the static softmax
   the call must not underflow a row.  With Q quantized in the kernel the
   check is post hoc: one host read of the kernel's minimum row
   denominator, and an online rerun if it underflowed.  With a
   pre-quantized Q the check is the JAX package's prediction, evaluated on
   the device from the quantizers' capmax outputs: the per-head bound first,
   then, only when it fails and the attention is square, the diagonal
   bound.  Normal data pays one host read (JAX keeps both decisions on the
   device with ``lax.cond``; eager PyTorch has no such branch);
6. slice the output back, and repair the lse for smooth_k.

Options outside the slices ported so far raise ``NotImplementedError``
naming the slice that brings them.  There is no backward yet: inputs that
require grad raise.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import numpy as np
import torch

from . import dispatch
from .ops import quant as quant_ops
from .ops.attention import AttnConfig, _per_q_head, attention_call
from .ops.quant_fused import _INV127, prep_k_onepass, prep_v_onepass
from .ops.quant_kernels import channel_stats, quant_int8_fixed, quant_int8_groupwise
from .ops.reference import _no_tf32
from .utils.layout import HND as HND_LAYOUT, get_layout, pad_head_dim, round_up

LOG2E = quant_ops.LOG2E
_INV448 = float(np.float32(1.0 / 448.0))
_CAP_SLACK = float(np.float32(1.0 + 1e-5))
# exp2(s - C) underflows once the cap C sits this far (log2 units) above a
# row's largest logit: the static softmax is safe below it
_STATIC_SLACK_LOG2 = 80.0

# Relative kernel efficiency by tile width, measured for the TPU kernel.  The
# port keeps the table for two purposes only: the compute-mode decision of
# _sage_attention, which changes the numerics (Q quantized or left bf16),
# and the padded lengths that decide whether the static-softmax prediction
# may use the diagonal bound.  The CUDA kernel picks its own tiles.
_BLOCK_EFF = {8192: 1.03, 4096: 1.02, 2048: 1.0, 1024: 0.96, 512: 0.82,
              256: 0.6, 128: 0.15}


def _pick_block(cap: int, seq: int) -> int:
    """Block minimizing (padded length / efficiency) among widths <= cap."""
    best_b, best_cost = 128, float("inf")
    for b, eff in _BLOCK_EFF.items():
        if b > cap:
            continue
        cost = (-(-seq // b) * b) / (max(seq, 1) * eff)
        if cost < best_cost:
            best_b, best_cost = b, cost
    return best_b


def _choose_blocks(sq: int, sk: int, quantized: bool,
                   compute_dtype: str = "native", causal: bool = False):
    """The JAX package's tile heuristic; returns (block_q, block_k, bk_inner)."""
    if quantized and compute_dtype == "native":
        if causal and sk >= 32768:
            bq = _pick_block(2048, sq)
            bk = _pick_block(2048, sk)
            return bq, bk, bk
        bq = _pick_block(1024, sq)
        bk = _pick_block(8192, sk)
        bki = min(1024, bk)
    elif quantized:
        bq = _pick_block(4096, sq)
        bk = _pick_block(2048, sk)
        bki = min(256, bk)
    else:
        bq = _pick_block(1024, sq)
        bk = _pick_block(2048, sk)
        bki = min(256, bk)
    return bq, bk, bki


def _finish_lse(lse_b2, lse_correction):
    """base-2 kernel lse -> natural log (+ the smooth_k repair)."""
    lse = lse_b2 / LOG2E
    if lse_correction is not None:
        lse = lse + lse_correction
    return lse


def _no_grad_inputs(*xs):
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise NotImplementedError(
            "the port has no attention backward yet (ROADMAP queue 2 C1/C2); "
            "run inference under torch.no_grad() or detach the inputs")


def _to_hnd(layout, *xs):
    return xs if layout.is_hnd else tuple(x.transpose(1, 2) for x in xs)


def _scale_of(amax: torch.Tensor, inv: float) -> torch.Tensor:
    return torch.where(amax > 0, amax * inv, torch.ones_like(amax))


def fp8_v(v: torch.Tensor, vm: Optional[torch.Tensor], v_scale: torch.Tensor):
    """e4m3 V and the ``v_mean`` the epilogue adds (``core.py:489-516`` of
    the JAX package): codes = e4m3((v - vm) / v_scale), and with smoothing
    the per-channel mean of the actual codes over the rows, times the scale,
    comes off ``vm``.  That cancels the codes' rounding bias, which would
    otherwise dominate the fp8 mode's error.  The mean is taken of the
    rounded codes: an optimizer that cancels the f32 -> e4m3 -> f32 round
    trip would turn the fold into zero (ROADMAP queue 3).
    ``v [B,H,S,D]`` -> ``(codes, vm')``."""
    vc = v.float() - vm if vm is not None else v.float()
    codes = (vc / v_scale).to(torch.float8_e4m3fn)
    if vm is not None:
        code_mean = codes.float().sum(dim=2, keepdim=True) / v.shape[2]
        vm = vm - code_mean * v_scale
    return codes, vm


def _static_safe(*, q, k, q_i8, q_scale, q_capmax, kn_max, ks_head, k_scale, k_i8,
                 smooth_k, sm_scale, Sq_pad, Sk_pad) -> bool:
    """The JAX package's predictive static-softmax check (``core.py:551-632``)
    for a pre-quantized Q: True when no row's cap can sit more than 80 log2
    units above that row's largest logit.  ``q``/``k`` are the float inputs;
    ``q_i8``, ``q_scale`` (the folded per-row scale), ``k_i8`` and
    ``k_scale`` (per column, fine modes) the quantized ones.  ``Sq_pad`` and
    ``Sk_pad`` are the lengths the JAX package pads to: its row-mean bound
    averages K over the padded length and takes the padded (zero) query rows
    into its minimum, and the diagonal bound needs Sq == Sk and equal padded
    lengths.  Evaluated on the device; one host read decides, a second one
    only when the per-head bound fails."""
    Hq = q_i8.shape[1]
    cap_bh = q_capmax * kn_max * _CAP_SLACK
    if ks_head is not None:
        cap_bh = cap_bh * ks_head
    row_lo = None
    if smooth_k:
        row_lo_min = 0.0   # smoothed logits have row mean 0, so row max >= 0
    else:
        # the row mean q . mean(k) bounds the row max from below; the mean
        # runs over the padded length and the padded query rows, as in JAX
        km_all = _per_q_head(k.float().sum(dim=2, keepdim=True) / Sk_pad, Hq)
        with _no_tf32():
            row_lo = torch.matmul(q.float(), km_all.transpose(-1, -2)) * float(
                np.float32(sm_scale * LOG2E))
        row_lo_min = row_lo.amin(dim=2, keepdim=True)
        if Sq_pad > q.shape[2]:
            row_lo_min = torch.clamp_max(row_lo_min, 0.0)
    if bool((cap_bh - row_lo_min <= _STATIC_SLACK_LOG2).all()):
        return True
    if not (q.shape[2] == k.shape[2] and Sq_pad == Sk_pad):
        return False
    q8 = q_i8.float()
    qn = torch.sqrt((q8 * q8).sum(dim=3, keepdim=True))
    logit_cap = q_scale * qn * kn_max * _CAP_SLACK
    diag = (q8 * _per_q_head(k_i8, Hq).float()).sum(dim=3, keepdim=True) * q_scale
    if k_scale is not None:
        diag = diag * _per_q_head(k_scale.transpose(2, 3), Hq)
    lo = torch.clamp_min(diag, 0.0) if smooth_k else torch.maximum(row_lo, diag)
    return bool((logit_cap - lo <= _STATIC_SLACK_LOG2).all())


def _sage_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tensor_layout: str = "HND",
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    smooth_k: bool = True,
    smooth_v: bool = True,
    qk_quant_gran: str = "per_thread",
    pv_dtype: str = "bf16",
    compute_dtype: str = "native",
    k_scale_mode: str = "fine",
    return_lse: bool = False,
    block_q: int = 0,
    block_k: int = 0,
    attn_mask=None,
    softmax_mode: str = "auto",
    fuse_q_quant: Optional[bool] = None,
    sliding_window: int = 0,
    attention_sinks: int = 0,
):
    """Shared quantized-attention pipeline (prep -> kernel -> repair), with
    the JAX function's arguments and defaults.  ``block_q``/``block_k`` only
    steer the compute-mode decision and the padded lengths of the static
    check: explicit blocks keep native compute at any length, as in JAX."""
    layout = get_layout(tensor_layout)
    _no_grad_inputs(q, k, v)
    q, k, v = _to_hnd(layout, q, k, v)
    B, Hq, Sq, D_og = q.shape
    _, Hk, Sk, _ = k.shape
    if Hq % Hk != 0:
        raise ValueError(f"num_qo_heads ({Hq}) must be divisible by num_kv_heads ({Hk})")
    if v.shape != k.shape:
        raise ValueError(f"k and v shapes must match, got {tuple(k.shape)} vs {tuple(v.shape)}")
    if is_causal and Sq != Sk:
        raise ValueError("is_causal requires qo_len == kv_len (as in the reference)")
    if sliding_window:
        if not is_causal:
            raise ValueError("sliding_window requires is_causal=True")
        if attn_mask is not None:
            raise ValueError("sliding_window composes with no user attn_mask")
    if attention_sinks and not sliding_window:
        raise ValueError("attention_sinks requires sliding_window")
    if sm_scale is None:
        sm_scale = 1.0 / (D_og ** 0.5)
    if qk_quant_gran not in quant_ops.QUANT_GRANULARITIES:
        raise ValueError(f"unknown qk_quant_gran {qk_quant_gran!r}")
    q_group, k_group = quant_ops.QUANT_GRANULARITIES[qk_quant_gran]
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if pv_dtype not in ("int8", "fp8", "bf16"):
        raise ValueError(f"unknown pv_dtype {pv_dtype!r}")
    if attn_mask is not None:
        raise NotImplementedError("attn_mask arrives with ROADMAP queue 1 item 6 (kernel B7)")
    if sliding_window:
        raise NotImplementedError("sliding_window arrives with queue 1 item 6 (kernel B9)")
    if softmax_mode == "auto":
        # static keeps a bf16 P; fp8 PV keeps the online e4m3 P with its offset
        softmax_mode = "static" if pv_dtype != "fp8" else "online"
    if softmax_mode not in ("static", "online"):
        raise ValueError(f"unknown softmax_mode {softmax_mode!r}")
    if pv_dtype == "fp8" and (softmax_mode == "static" or compute_dtype == "bf16"):
        raise ValueError("pv_dtype='fp8' runs the online softmax with native compute "
                         "(its e4m3 P carries the exp offset)")

    q, _ = pad_head_dim(q, HND_LAYOUT)
    k, _ = pad_head_dim(k, HND_LAYOUT)
    v, _ = pad_head_dim(v, HND_LAYOUT)
    if block_q and block_k:
        bq, bk = block_q, block_k
    else:
        bq, bk, _ = _choose_blocks(Sq, Sk, quantized=True,
                                   compute_dtype=compute_dtype, causal=is_causal)
        if compute_dtype == "native" and (Sk < 4096 or min(bq, bk) < 512):
            if pv_dtype == "fp8":
                # fp8 PV stays on native compute at short lengths (JAX pads
                # its tiles to 512 there)
                bq, bk = max(bq, 512), max(bk, 512)
            else:
                # short sequences run int8 storage with bf16 compute
                compute_dtype = "bf16"
                bq, bk, _ = _choose_blocks(Sq, Sk, quantized=True,
                                           compute_dtype="bf16", causal=is_causal)
    Sq_pad, Sk_pad = round_up(Sq, bq), round_up(Sk, bk)
    if compute_dtype == "bf16":
        k_scale_mode = "head"
    if k_scale_mode not in ("head", "fine"):
        raise ValueError(f"k_scale_mode must be 'fine' or 'head', got {k_scale_mode!r}")
    head = k_scale_mode == "head"
    fuse_qq = head and torch.is_floating_point(q) and fuse_q_quant is not False
    if fuse_q_quant and not fuse_qq:
        raise ValueError("fuse_q_quant=True requires the head-mode path with float inputs")
    static = softmax_mode == "static"

    # ---- K and V prep ----
    km = vm = v_amax = k_capmax = k_scale = ks_sc = None
    merged = smooth_k and smooth_v and pv_dtype == "int8" and head
    if merged:
        res = prep_k_onepass(k, Sk, with_capmax=static)
        k_i8, km, k_head_amax = res[:3]
        k_capmax = res[3] if static else None
        ks_sc = _scale_of(k_head_amax, _INV127)
        v_in, vm, v_amax = prep_v_onepass(v, Sk)
    else:
        if smooth_k:
            km, k_amax_ch = channel_stats(k, Sk)
        elif head:
            k_amax_ch = k.float().abs().amax(dim=2, keepdim=True)
        if head:
            ks_sc = _scale_of(k_amax_ch.amax(dim=3, keepdim=True), _INV127)
            res = quant_int8_fixed(k, ks_sc, sub=km, with_capmax=static, s_true=Sk)
            k_i8, k_capmax = res if static else (res, None)
        else:
            res = quant_int8_groupwise(k, k_group, sub=km, with_capmax=static, s_true=Sk)
            k_i8 = res[0][:, :, :Sk]
            k_scale = quant_ops.expand_scales_cols(
                res[1], k_group, res[0].shape[2])[..., :Sk]
            k_capmax = res[2] if static else None
        if pv_dtype != "bf16":
            if smooth_v:
                vm, v_amax = channel_stats(v, Sk)
            else:
                v_amax = v.float().abs().amax(dim=2, keepdim=True)
    v_scale = None
    if pv_dtype == "int8":
        v_scale = _scale_of(v_amax, _INV127)
        if not merged:
            v_in = quant_int8_fixed(v, v_scale, sub=vm)
    elif pv_dtype == "fp8":
        v_scale = _scale_of(v_amax, _INV448)
        v_in, vm = fp8_v(v, vm, v_scale)
    else:
        v_in = v.to(torch.bfloat16)
    ks_head = None if ks_sc is None else _per_q_head(ks_sc, Hq)   # [B,Hq,1,1]

    # ---- Q ----
    q_i8 = q_scale = q_capmax = None
    if not fuse_qq:
        res = quant_int8_groupwise(q, q_group, fold=sm_scale * LOG2E, with_capmax=static)
        q_i8 = res[0][:, :, :Sq]
        q_scale = quant_ops.expand_scales_rows(res[1], q_group, res[0].shape[2])[:, :, :Sq]
        q_capmax = res[2] if static else None
        if head:
            q_scale = q_scale * ks_head
    kn_max = None if k_capmax is None else _per_q_head(k_capmax, Hq)

    caps = dispatch.detect(q.device)

    def _call(mode):
        cfg = AttnConfig(
            causal=is_causal, quantized=True, pv_dtype=pv_dtype, layout="HND",
            kv_len=Sk, out_dtype=q.dtype if torch.is_floating_point(q) else torch.bfloat16,
            fold_k_scale=head, compute_dtype=compute_dtype, softmax_mode=mode,
            fp8_native_dot=caps.has_fast_fp8, emit_lse=return_lse,
            fuse_v_mean=vm is not None, pv_via_bf16=(mode == "online" and static),
            fuse_q_quant=fuse_qq, sm_scale=sm_scale)
        return attention_call(q if fuse_qq else q_i8, k_i8, v_in, q_scale=q_scale,
                              k_scale=k_scale, v_scale=v_scale,
                              kn_max=kn_max if mode == "static" else None,
                              v_mean=vm, k_head_scale=ks_sc if fuse_qq else None, cfg=cfg)

    if static and fuse_qq:
        out, lse_b2, lmin = _call("static")
        # one host read: a denominator below 2^-100 means the cap's slack
        # underflowed some row, and the call reruns online
        if not bool(lmin.min() >= 2.0 ** -100):
            out, lse_b2 = _call("online")
    elif static:
        safe = _static_safe(
            q=q, k=k, q_i8=q_i8, q_scale=q_scale, q_capmax=q_capmax, kn_max=kn_max,
            ks_head=ks_head, k_scale=k_scale, k_i8=k_i8, smooth_k=smooth_k,
            sm_scale=sm_scale, Sq_pad=Sq_pad, Sk_pad=Sk_pad)
        out, lse_b2 = _call("static" if safe else "online")
    else:
        out, lse_b2 = _call("online")

    out = out[..., :D_og]
    if not layout.is_hnd:
        out = out.transpose(1, 2)
    if not return_lse:
        return out
    corr = None
    if smooth_k:
        # smooth_k repair: (q . km) * sm_scale per row, natural-log units
        with _no_tf32():
            corr = torch.matmul(q.float(), _per_q_head(km, Hq).transpose(-1, -2))[..., 0]
        corr = corr * sm_scale
    return out, _finish_lse(lse_b2, corr)


def _no_backward_kwargs(kwargs, name):
    if kwargs.pop("quant_backward", None) is not None:
        raise NotImplementedError("quant_backward arrives with the backward (C1/C2)")
    if kwargs:
        raise TypeError(f"{name} got unexpected arguments {sorted(kwargs)}")


def sageattn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tensor_layout: str = "HND",
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
    **kwargs: Any,
):
    """Auto-dispatching SageAttention: int8 QK^T and int8 PV with
    per-channel V scales and mean smoothing on the flagship path; any mode
    argument of ``_sage_attention`` (``pv_dtype``, ``k_scale_mode``, ...)
    may be given.

    Layouts: "HND" [B,H,S,D] or "NHD" [B,S,H,D]; GQA via Hq % Hk == 0;
    ``return_lse`` also returns the natural-log row logsumexp [B,Hq,Sq].
    """
    caps = dispatch.detect(q.device)
    opts = dict(
        qk_quant_gran=kwargs.pop("qk_quant_gran", "per_thread"),
        pv_dtype=kwargs.pop("pv_dtype", caps.default_pv_dtype),
        compute_dtype=kwargs.pop("compute_dtype", caps.default_compute_dtype),
        smooth_k=kwargs.pop("smooth_k", True),
        smooth_v=kwargs.pop("smooth_v", True),
        k_scale_mode=kwargs.pop("k_scale_mode", "head"),
        attn_mask=kwargs.pop("attn_mask", None),
        fuse_q_quant=kwargs.pop("fuse_q_quant", None),
        sliding_window=kwargs.pop("sliding_window", 0),
        attention_sinks=kwargs.pop("attention_sinks", 0),
    )
    _no_backward_kwargs(kwargs, "sageattn")
    return _sage_attention(q, k, v, tensor_layout=tensor_layout, is_causal=is_causal,
                           sm_scale=sm_scale, return_lse=return_lse, **opts)


def sageattn_qk_int8_pv_bf16(
    q, k, v,
    tensor_layout: str = "HND",
    is_causal: bool = False,
    qk_quant_gran: str = "per_thread",
    sm_scale: Optional[float] = None,
    smooth_k: bool = True,
    attn_mask=None,
    return_lse: bool = False,
    **kwargs: Any,
):
    """INT8 QK^T + bf16 PV with f32 sums, the reference's most robust mode
    (``sageattn_qk_int8_pv_fp16_cuda`` with ``pv_accum_dtype="fp32"``):
    fine K scales, V unquantized and unsmoothed, static softmax with its
    online fallback."""
    _no_backward_kwargs(kwargs, "sageattn_qk_int8_pv_bf16")
    return _sage_attention(
        q, k, v, tensor_layout=tensor_layout, is_causal=is_causal,
        sm_scale=sm_scale, smooth_k=smooth_k, smooth_v=False,
        qk_quant_gran=qk_quant_gran, pv_dtype="bf16", return_lse=return_lse,
        attn_mask=attn_mask)


def sageattn_qk_int8_pv_int8(
    q, k, v,
    tensor_layout: str = "HND",
    is_causal: bool = False,
    qk_quant_gran: str = "per_thread",
    sm_scale: Optional[float] = None,
    smooth_k: bool = True,
    smooth_v: bool = True,
    attn_mask=None,
    return_lse: bool = False,
    **kwargs: Any,
):
    """INT8 QK^T + INT8 PV (per-channel V scales, V-mean smoothing) with
    reference-granularity ("fine") K scales; short sequences run the
    bf16-compute kernel, which applies the K scale per head."""
    _no_backward_kwargs(kwargs, "sageattn_qk_int8_pv_int8")
    return _sage_attention(
        q, k, v, tensor_layout=tensor_layout, is_causal=is_causal,
        sm_scale=sm_scale, smooth_k=smooth_k, smooth_v=smooth_v,
        qk_quant_gran=qk_quant_gran, pv_dtype="int8", return_lse=return_lse,
        attn_mask=attn_mask)


def sageattn_qk_int8_pv_fp8(
    q, k, v,
    tensor_layout: str = "HND",
    is_causal: bool = False,
    qk_quant_gran: str = "per_thread",
    sm_scale: Optional[float] = None,
    smooth_k: bool = True,
    smooth_v: bool = True,
    attn_mask=None,
    return_lse: bool = False,
    **kwargs: Any,
):
    """INT8 QK^T + FP8 (e4m3) PV with the exp-offset trick, the
    SageAttention2 mode that the reference runs on the H100: fine K scales,
    e4m3 P under the online softmax, per-channel e4m3 V with its code-mean
    fold."""
    _no_backward_kwargs(kwargs, "sageattn_qk_int8_pv_fp8")
    return _sage_attention(
        q, k, v, tensor_layout=tensor_layout, is_causal=is_causal,
        sm_scale=sm_scale, smooth_k=smooth_k, smooth_v=smooth_v,
        qk_quant_gran=qk_quant_gran, pv_dtype="fp8", return_lse=return_lse,
        attn_mask=attn_mask)


def _alias(fn, note):
    """Reference-name alias: drops the reference's ``pv_accum_dtype`` and
    ``quantization_backend`` (accumulation is f32 and there is one backend)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        kwargs.pop("pv_accum_dtype", None)
        kwargs.pop("quantization_backend", None)
        return fn(*args, **kwargs)
    wrapper.__doc__ = note + "\n\n" + (fn.__doc__ or "")
    return wrapper


sageattn_qk_int8_pv_fp16_triton = _alias(
    sageattn_qk_int8_pv_bf16, "Reference-name alias: fp16 PV maps to bf16 PV.")
sageattn_qk_int8_pv_fp16_cuda = _alias(
    sageattn_qk_int8_pv_bf16, "Reference-name alias: fp16 PV maps to bf16 PV.")
sageattn_qk_int8_pv_fp8_cuda = _alias(sageattn_qk_int8_pv_fp8, "Reference-name alias.")
sageattn_qk_int8_pv_fp8_cuda_sm90 = _alias(
    sageattn_qk_int8_pv_fp8, "Reference-name alias (the reference's H100 mode).")


def flash_attention(
    q, k, v,
    tensor_layout: str = "HND",
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
    block_q: int = 0,
    block_k: int = 0,
    sliding_window: int = 0,
    attention_sinks: int = 0,
):
    """Unquantized bf16 FlashAttention baseline (kernel B4): the numeric
    baseline the quantized modes are compared against.  ``block_q`` and
    ``block_k`` are accepted for parity and ignored."""
    layout = get_layout(tensor_layout)
    _no_grad_inputs(q, k, v)
    q, k, v = _to_hnd(layout, q, k, v)
    B, Hq, Sq, D_og = q.shape
    Sk = k.shape[2]
    if is_causal and Sq != Sk:
        raise ValueError("is_causal requires qo_len == kv_len")
    if sliding_window and not is_causal:
        raise ValueError("sliding_window requires is_causal=True")
    if attention_sinks and not sliding_window:
        raise ValueError("attention_sinks requires sliding_window")
    if sliding_window:
        raise NotImplementedError("sliding_window arrives with queue 1 item 6 (kernel B9)")
    if sm_scale is None:
        sm_scale = 1.0 / (D_og ** 0.5)
    q, _ = pad_head_dim(q.to(torch.bfloat16), HND_LAYOUT)
    k, _ = pad_head_dim(k.to(torch.bfloat16), HND_LAYOUT)
    v, _ = pad_head_dim(v.to(torch.bfloat16), HND_LAYOUT)
    cfg = AttnConfig(causal=is_causal, quantized=False, layout="HND",
                     sm_scale=sm_scale, kv_len=Sk, out_dtype=torch.bfloat16,
                     emit_lse=return_lse)
    out, lse_b2 = attention_call(q, k, v, cfg=cfg)
    out = out[..., :D_og]
    if not layout.is_hnd:
        out = out.transpose(1, 2)
    if not return_lse:
        return out
    return out, _finish_lse(lse_b2, None)
