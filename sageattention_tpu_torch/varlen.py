"""Variable-length (packed, ragged-batch) attention: ``sageattn_varlen``.

Counterpart of ``sageattention_tpu/varlen.py``.  The packed token buffer is
one long sequence whose tokens carry their sequence's index (segment ids,
derived from ``cu_seqlens``); the attention kernel masks cross-segment
scores (B8).  Query pads carry id -1 and kv pads -2, so they never match.

Notes kept from the JAX package:

- K smoothing subtracts the mean over the whole packed batch (true tokens
  only), the reference's documented approximation;
- per-sequence causal masking is the global causal mask AND the segment
  mask, which holds only when the q and k packings are the same: causal
  calls check that (identity first, then values);
- quantization is segment-aware: group scales are confined to (group ∩
  segment) by A6's segmented mode, so one sequence's outliers never set a
  neighbour's scale; under bf16 compute each segment gets one K scale per
  head, folded into its query rows (``fuse_k_rows``);
- Q is quantized inside the attention kernel (per row, so segment-correct
  by construction) unless a mask is given or ``fuse_q_quant=False``; the
  static softmax then takes the exact post-hoc check.  Otherwise the static
  softmax needs matching packings and takes the predictive check, whose
  diagonal bound comes from A6's row norms and row dots.

Unlike the JAX function, nothing is padded to kernel blocks: the kernel
masks its ragged edges, and the quantizers pad to their group size only.
The JAX package's ``SAGE_VARLEN_FUSED_STATS`` switch is a TPU experiment;
the port takes its default (the fused statistics).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from . import dispatch
from .core import _CAP_SLACK, _INV448, _choose_blocks, _no_grad_inputs, _scale_of
from .ops import quant as quant_ops
from .ops.attention import SEGPOS_PAD, AttnConfig, _per_q_head, attention_call
from .ops.quant_fused import _INV127
from .ops.quant_kernels import channel_stats, quant_int8_fixed, quant_int8_segmented
from .ops.reference import _no_tf32
from .utils.layout import pad_axis, round_up

LOG2E = quant_ops.LOG2E


def cu_seqlens_to_segment_ids(cu_seqlens, total_padded: int) -> torch.Tensor:
    """``[n_seq+1]`` cumulative lengths -> ``[total_padded]`` int32 segment
    ids: token t belongs to the last sequence whose start is <= t, so a
    zero-length sequence (a repeated boundary) owns no token.  Tokens past
    the last boundary get id ``n_seq``; callers overwrite pads."""
    cu = torch.as_tensor(cu_seqlens).to(torch.int64)
    pos = torch.arange(total_padded, dtype=torch.int64, device=cu.device)
    return (torch.searchsorted(cu, pos, right=True) - 1).to(torch.int32)


def _same_packing(cq, ck) -> bool:
    if cq is ck:
        return True
    a, b = torch.as_tensor(cq).cpu(), torch.as_tensor(ck).cpu()
    return a.shape == b.shape and bool(torch.equal(a.to(torch.int64), b.to(torch.int64)))


def sageattn_varlen(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cu_seqlens_q,
    cu_seqlens_k,
    max_seqlen_q: int = 0,
    max_seqlen_k: int = 0,
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    smooth_k: bool = True,
    qk_quant_gran: str = "per_block",
    pv_dtype: Optional[str] = None,
    softmax_mode: str = "auto",
    return_lse: bool = False,
    attn_mask=None,
    sliding_window: int = 0,
    attention_sinks: int = 0,
    **kwargs: Any,
):
    """Ragged-batch SageAttention.

    ``q [total_q, Hq, D]``, ``k``/``v [total_k, Hk, D]`` (packed NHD without
    a batch axis, as in the reference); ``cu_seqlens_q/k [n_seq+1]``
    cumulative starts (first 0, last the total).  ``max_seqlen_*`` are
    accepted for the reference's signature and unused.  ``attn_mask``:
    ``[1|Hq, total_q, total_k]`` bool keep-mask or float bias (natural log)
    on top of the segment mask.  ``sliding_window``/``attention_sinks``
    (causal): each sequence's own band and its own first tokens.  Also
    ``fuse_q_quant`` (None: auto) and ``compute_dtype``.  Returns
    ``[total_q, Hq, D]`` (and the natural-log lse ``[Hq, total_q]``).
    """
    del max_seqlen_q, max_seqlen_k
    fuse_q_quant = kwargs.pop("fuse_q_quant", None)
    caps = dispatch.detect(q.device)
    compute_dtype = kwargs.pop("compute_dtype", caps.default_compute_dtype)
    if kwargs:
        raise TypeError(f"sageattn_varlen got unexpected arguments {sorted(kwargs)}")
    _no_grad_inputs(q, k, v)
    Tq, Hq, D_og = q.shape
    Tk, Hk, _ = k.shape
    if Hq % Hk or v.shape != k.shape or k.shape[2] != D_og:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if sliding_window:
        # identical packings make the global band every sequence's own band
        if not is_causal:
            raise ValueError("sliding_window requires is_causal=True")
        if attn_mask is not None:
            raise ValueError("sliding_window composes with no attn_mask")
    if attention_sinks and not sliding_window:
        raise ValueError("attention_sinks requires sliding_window")
    if is_causal and not _same_packing(cu_seqlens_q, cu_seqlens_k):
        raise ValueError("is_causal=True requires cu_seqlens_q == cu_seqlens_k "
                         "(per-sequence qo_len == kv_len, as in the reference)")
    if sm_scale is None:
        sm_scale = 1.0 / (D_og ** 0.5)
    if pv_dtype is None:
        pv_dtype = caps.default_pv_dtype
    if pv_dtype not in ("int8", "fp8", "bf16"):
        raise ValueError(f"unknown pv_dtype {pv_dtype!r}")
    if compute_dtype == "bf16" and pv_dtype == "fp8":
        pv_dtype = "int8"
    if qk_quant_gran not in quant_ops.QUANT_GRANULARITIES:
        raise ValueError(f"unknown qk_quant_gran {qk_quant_gran!r}")
    bq, bk, _ = _choose_blocks(Tq, Tk, quantized=True, compute_dtype=compute_dtype)
    if compute_dtype == "native" and min(bq, bk) < 512 and pv_dtype != "fp8":
        compute_dtype = "bf16"   # short packs: int8 storage, bf16 compute
    fold_k = compute_dtype == "bf16"
    q_group, k_group = quant_ops.QUANT_GRANULARITIES[qk_quant_gran]

    dev = q.device
    cu_q = torch.as_tensor(cu_seqlens_q).to(dev)
    cu_k = torch.as_tensor(cu_seqlens_k).to(dev)
    same_pack = Tq == Tk and _same_packing(cu_seqlens_q, cu_seqlens_k)
    # packed as B = 1 HND, head dim padded to 64/128/256
    d = 64 if D_og <= 64 else (128 if D_og <= 128 else 256)
    qb, kb, vb = (pad_axis(x.transpose(0, 1)[None], 3, d) for x in (q, k, v))
    Tq_g = round_up(Tq, q_group)
    Tk_g = max(round_up(Tk, k_group), Tq_g if same_pack else 0)   # K covers Q's rows
    q_seg = torch.where(torch.arange(Tq_g, device=dev) < Tq,
                        cu_seqlens_to_segment_ids(cu_q, Tq_g), -1).to(torch.int32)
    kv_seg = torch.where(torch.arange(Tk_g, device=dev) < Tk,
                         cu_seqlens_to_segment_ids(cu_k, Tk_g), -2).to(torch.int32)
    kv_segpos = None
    if attention_sinks:
        # each kv token's position in its own sequence; pads are never sinks
        seg = kv_seg[:Tk]
        starts = cu_k.to(torch.int64)[seg.clamp_min(0).to(torch.int64)]
        kv_segpos = torch.where(seg >= 0, torch.arange(Tk, device=dev) - starts,
                                SEGPOS_PAD).to(torch.int32)

    km = channel_stats(kb, Tk)[0] if smooth_k else None    # whole-batch K mean (A5)
    fuse_qq = attn_mask is None and torch.is_floating_point(q) and fuse_q_quant is not False
    if fuse_q_quant and not fuse_qq:
        raise ValueError("fuse_q_quant=True requires the unmasked varlen path with float inputs")
    if softmax_mode == "auto":
        softmax_mode = ("static" if (pv_dtype != "fp8" and attn_mask is None
                                     and (same_pack or fuse_qq)) else "online")
    elif softmax_mode == "static" and not (same_pack or fuse_qq):
        # the predictive check anchors each row's max at its diagonal logit,
        # which only matching packings make a visible logit
        raise ValueError("softmax_mode='static' requires matching q/k packings "
                         "(cu_seqlens_q == cu_seqlens_k) unless Q is quantized in the "
                         "kernel (fuse_q_quant); use softmax_mode='auto' or 'online'")
    if softmax_mode not in ("static", "online"):
        raise ValueError(f"unknown softmax_mode {softmax_mode!r}")
    static = softmax_mode == "static"
    fold = sm_scale * LOG2E

    q_i8 = q_scale = k_scale = k_rows = qn2 = diag_dot = kn_max_raw = None
    if not fold_k:
        if fuse_qq or not static:
            res = quant_int8_segmented(kb, kv_seg, k_group, sub=km,
                                       with_capmax=static, s_true=Tk)
            if not fuse_qq:
                q_i8, q_scale = quant_int8_segmented(qb, q_seg, q_group, fold=fold)
        else:   # predictive check: capmax, row norms and diagonal dots from A6
            res = quant_int8_segmented(kb, kv_seg, k_group, sub=km, with_capmax=True,
                                       s_true=Tk)
            q_i8, q_scale, qn2, diag_dot = quant_int8_segmented(
                qb, q_seg, q_group, fold=fold, with_norm=True, dot_with=res[0])
        k_i8, k_scale = res[0], res[1].transpose(2, 3)           # [1,Hk,1,Tk_g]
        kn_max_raw = res[2] if static else None
        vm = None
        if pv_dtype == "bf16":
            v_in = vb.to(torch.bfloat16)
        else:
            vm, v_amax = channel_stats(vb, Tk)
            if pv_dtype == "int8":
                v_scale = _scale_of(v_amax, _INV127)
                v_in = quant_int8_fixed(vb, v_scale, sub=vm)
            else:
                v_scale = _scale_of(v_amax, _INV448)
                v_in = ((vb.float() - vm) / v_scale).to(torch.float8_e4m3fn)
    else:
        if not fuse_qq:
            q_i8, q_srow = quant_ops.quant_int8_groupwise_segmented(
                pad_axis(qb, 2, Tq_g), q_seg, q_group, fold=fold)
            q_scale = q_srow[..., None]
        # one K scale per (head, segment), folded into that segment's rows
        kf = kb.float() - km if km is not None else kb.float()
        seg_amax = quant_ops._segmented_group_amax(kf.abs().amax(dim=3), kv_seg[:Tk], Tk)
        ks_row = torch.where(seg_amax > 0, seg_amax * _INV127, torch.ones_like(seg_amax))
        k_i8 = torch.clamp(torch.round(kf / ks_row[..., None]), -127, 127).to(torch.int8)
        n_seq = cu_k.shape[0] - 1
        starts = cu_k.to(torch.int64)[q_seg[:Tq].to(torch.int64).clamp(0, n_seq - 1)]
        sk_q = _per_q_head(ks_row[:, :, starts.clamp(0, Tk - 1)], Hq)   # [1,Hq,Tq]
        if fuse_qq:
            k_rows = sk_q[..., None]
        else:
            q_scale = q_scale[:, :, :Tq] * sk_q[..., None]
        vm = None
        if pv_dtype == "bf16":
            v_in = vb.to(torch.bfloat16)
        else:   # per-channel stats over the true tokens (jnp glue in JAX)
            vf = vb.float()
            vm = vf.sum(dim=2, keepdim=True) / max(Tk, 1)
            v_amax = (vf - vm).abs().amax(dim=2, keepdim=True)
            v_scale = _scale_of(v_amax, _INV127)
            v_in = torch.clamp(torch.round((vf - vm) / v_scale), -127, 127).to(torch.int8)
    if pv_dtype == "bf16":
        v_scale = None

    masked, mask_in = "none", None
    if attn_mask is not None:
        m = attn_mask[None] if attn_mask.ndim == 2 else attn_mask
        if m.ndim != 3:
            raise ValueError("varlen attn_mask must be [1|Hq, Tq, Tk]")
        masked = "bool" if m.dtype == torch.bool else "float"
        mask_in = (m if masked == "bool" else m.float())[None]
    # the kernel takes the true rows; the quantizers' group pads go
    k_i8 = k_i8[:, :, :Tk]
    k_scale = None if k_scale is None else k_scale[..., :Tk]
    if q_i8 is not None:
        q_i8, q_scale = q_i8[:, :, :Tq], q_scale[:, :, :Tq]

    kn_max = None
    safe = None
    if static:
        if kn_max_raw is None:   # bf16 compute: ||k8|| over the true rows
            kn = torch.sqrt((k_i8.float() ** 2).sum(dim=3))
            kfac = kn if fold_k else kn * k_scale[:, :, 0, :]
            kn_max_raw = kfac.amax(dim=2)[:, :, None, None]
        kn_max = _per_q_head(kn_max_raw, Hq)
        if not fuse_qq:
            # predictive: the diagonal logit q_i . k_i is visible for every
            # row of matching packings; each row's cap may sit <= 80 log2
            # units above it
            if qn2 is None:
                q8 = q_i8.float()
                qn2 = (q8 * q8).sum(dim=3, keepdim=True)
                diag_dot = (q8 * _per_q_head(k_i8[:, :, :Tq], Hq).float()).sum(
                    dim=3, keepdim=True)
            qn2, diag_dot = qn2[:, :, :Tq], diag_dot[:, :, :Tq]
            cap_row = q_scale * torch.sqrt(qn2) * kn_max * _CAP_SLACK
            diag = diag_dot * q_scale
            if not fold_k:
                diag = diag * _per_q_head(k_scale.transpose(2, 3)[:, :, :Tq], Hq)
            safe = bool(((cap_row - diag) <= 80.0).all())

    cfg = AttnConfig(
        causal=is_causal, quantized=True, pv_dtype=pv_dtype, layout="HND", kv_len=Tk,
        out_dtype=q.dtype if torch.is_floating_point(q) else torch.bfloat16,
        segmented=True, masked=masked, fp8_native_dot=caps.has_fast_fp8,
        compute_dtype=compute_dtype, fold_k_scale=fold_k, fuse_v_mean=vm is not None,
        emit_lse=return_lse, fuse_q_quant=fuse_qq, fuse_k_rows=fuse_qq and fold_k,
        sm_scale=sm_scale, window=sliding_window, sinks=attention_sinks)

    def _call(mode):
        c = dataclasses.replace(cfg, softmax_mode=mode, pv_via_bf16=mode == "online" and static)
        return attention_call(
            qb if fuse_qq else q_i8, k_i8, v_in, q_scale, k_scale, v_scale,
            q_segments=q_seg[:Tq][None], kv_segments=kv_seg[:Tk][None],
            kv_segpos=None if kv_segpos is None else kv_segpos[None],
            attn_mask=mask_in, v_mean=vm, kn_max=kn_max if mode == "static" else None,
            k_head_scale=k_rows, cfg=c)

    if static and fuse_qq:
        # exact post-hoc check: a row denominator below 2^-100 reruns online
        out, lse_b2, lmin = _call("static")
        if not bool(lmin.min() >= 2.0 ** -100):
            out, lse_b2 = _call("online")
    elif static:
        out, lse_b2 = _call("static" if safe else "online")
    else:
        out, lse_b2 = _call("online")
    out = out[0].transpose(0, 1)[..., :D_og]
    if not return_lse:
        return out
    lse = lse_b2[0] / LOG2E                                      # [Hq, Tq]
    if smooth_k:
        with _no_tf32():
            corr = torch.matmul(qb[0].float(), _per_q_head(km, Hq)[0].transpose(-1, -2))[..., 0]
        lse = lse + corr * sm_scale
    return out, lse
