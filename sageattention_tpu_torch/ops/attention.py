"""SageAttention forward kernel and its plain version (B1-B6).

Counterpart of ``sageattention_tpu/ops/attention.py``: ``AttnConfig`` keeps
the JAX field names and ``attention_call`` takes the same inputs.  The
configurations, by their launch key (``config_name``):

  B1 / B2        fused int8 Q, native int8 QK^T, int8 V under a bf16 P:
                 static, and its online fallback (pv_via_bf16)
  B3 / B3-online fused Q with bf16 compute (short sequences), int8 V
  B4             quantized=False: the bf16 flash baseline
  B5-int8        int8 P under the online softmax, int8 V (either Q source)
  B5-fp8(-fusedq) e4m3 P under the online softmax, e4m3 V; a pre-quantized
                 Q (``q_scale``), or a fused one
  B6-static / B6-online  a pre-quantized Q with per-row scales, per-head
                 (folded) or per-column (``k_scale``) K scales, int8 V
  B6-bf16c       a pre-quantized Q dequantized to bf16 (bf16 compute),
                 static or online
  B-pvbf16(-online)  bf16 V (pv_dtype "bf16"), any Q source and compute

``fp8_native_dot`` selects no other numerics here: the kernel always runs
the e4m3 PV product on exact bf16 copies of the codes, which is what JAX
computes with ``fp8_native_dot=False``.  Unlike the TPU kernel, the inputs
need no padding to the block sizes: the CUDA kernel masks the ragged edges
itself and picks its own tiles, so ``block_q``/``block_k``/
``block_k_inner`` are accepted and ignored, and the online softmax walks
64-column kv tiles.  ``lmin`` comes back as ``[B, Hq, ceil(Sq/64)]``, one
minimum row denominator per 64-row query tile.

A CPU tensor takes the plain version, a CUDA tensor the kernel; there is no
fallback between the two.  ``attention_call.launches`` counts kernel
launches per configuration name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _build
from .quant import LOG2E
from .reference import _no_tf32

MASK_NEG = -1e30  # added to masked scores (finite: avoids exp(-inf - -inf))
M_CLAMP = -1e20   # lower clamp for the running max => exp2(MASK_NEG - m) == 0
FP8_OFFSET_LOG2 = 8.807354922057604     # log2(448): e4m3 P fills its range
INT8_P_OFFSET_LOG2 = 6.988684686772166  # log2(127): the int8 P scale in the exp2
KV_TILE = 64      # kv tile of the kernel; the plain online softmax walks the same tiles
Q_TILE = 64       # query rows per kernel block (the lmin granularity)

_F32 = lambda x: float(np.float32(x))  # noqa: E731  python float rounded as f32


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    block_q: int = 128
    block_k: int = 128
    block_k_inner: int = 0
    causal: bool = False
    causal_dynamic: bool = False
    causal_row_mod: int = 0
    quantized: bool = True
    pv_dtype: str = "bf16"
    fp8_native_dot: bool = False
    compute_dtype: str = "native"
    layout: str = "HND"
    sm_scale: float = 1.0
    kv_len: int = 0
    out_dtype: torch.dtype = torch.bfloat16
    segmented: bool = False
    fold_k_scale: bool = False
    masked: str = "none"
    fuse_v_mean: bool = False
    pv_via_bf16: bool = False
    p_sim_fp4: bool = False
    kv_len_dynamic: bool = False
    emit_lse: bool = True
    fuse_q_quant: bool = False
    fuse_k_rows: bool = False
    q_len: int = 0
    window: int = 0
    sinks: int = 0
    kv_split: int = 1
    softmax_mode: str = "online"

    @property
    def p_bf16(self) -> bool:
        """True when P stays bf16 for the PV product (see the JAX config)."""
        return (not self.quantized or self.pv_dtype == "bf16"
                or self.compute_dtype == "bf16"
                or self.softmax_mode == "static"
                or self.pv_via_bf16)


LAUNCH_KEYS = ("B1", "B2", "B3", "B3-online", "B4", "B5-int8", "B5-fp8", "B5-fp8-fusedq",
               "B6-static", "B6-online", "B6-bf16c", "B-pvbf16", "B-pvbf16-online")


def config_name(cfg: AttnConfig) -> str:
    """The port's name for ``cfg`` (one of ``LAUNCH_KEYS``), or raise
    ``NotImplementedError`` naming the later slice that brings it."""
    later = {
        "masked": "B7 (masks)", "segmented": "B8 (varlen segments)",
        "window": "B9 (sliding window)", "sinks": "B9 (attention sinks)",
        "causal_dynamic": "B10 (ring offsets)", "kv_len_dynamic": "B10",
        "causal_row_mod": "B11 (decode)", "fuse_k_rows": "B8 (varlen)",
        "p_sim_fp4": "queue 1 item 14 (low-bit simulation)",
    }
    for field, slice_ in later.items():
        val = getattr(cfg, field)
        if val and val != "none":
            raise NotImplementedError(f"AttnConfig.{field}={val!r} arrives with {slice_}")
    if cfg.kv_split != 1:
        raise NotImplementedError("AttnConfig.kv_split arrives with B11 (decode)")
    if cfg.layout != "HND":
        raise ValueError("attention_call operates in HND; transpose first")
    if cfg.softmax_mode not in ("static", "online"):
        raise ValueError(f"unknown softmax_mode {cfg.softmax_mode!r}")
    static = cfg.softmax_mode == "static"
    if not cfg.quantized:
        if static:
            raise ValueError("static softmax needs the quantized payload bounds")
        return "B4"
    if cfg.pv_dtype not in ("int8", "fp8", "bf16"):
        raise ValueError(f"unknown pv_dtype {cfg.pv_dtype!r}")
    if cfg.compute_dtype not in ("native", "bf16"):
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")
    dq = cfg.compute_dtype == "bf16"
    if dq and not cfg.fold_k_scale:
        raise ValueError("bf16-compute mode needs head-folded K scales")
    if cfg.pv_dtype == "fp8" and cfg.p_bf16:
        raise ValueError("e4m3 V needs the e4m3 P of the online softmax "
                         "(not static, bf16 compute or pv_via_bf16)")
    if cfg.fuse_q_quant and not cfg.fold_k_scale:
        raise NotImplementedError("a fused Q with per-column K scales arrives with B8 (varlen)")
    if cfg.pv_dtype == "bf16":
        return "B-pvbf16" if static else "B-pvbf16-online"
    if not cfg.p_bf16:
        if cfg.pv_dtype == "int8":
            return "B5-int8"
        return "B5-fp8-fusedq" if cfg.fuse_q_quant else "B5-fp8"
    if cfg.fuse_q_quant:
        if dq:
            return "B3" if static else "B3-online"
        return "B1" if static else "B2"
    if dq:
        return "B6-bf16c"
    return "B6-static" if static else "B6-online"


def _per_q_head(x: torch.Tensor, Hq: int) -> torch.Tensor:
    return x if x.shape[1] == Hq else x.repeat_interleave(Hq // x.shape[1], dim=1)


def _prepare_q(q, cfg, name, k_head_scale, kn_max, q_scale=None):
    """Per-row Q operand, row scale and static cap, as the kernel's Q step
    computes them (``attention.py:316-374`` of the JAX package)."""
    Hq = q.shape[1]
    fold = _F32(cfg.sm_scale * LOG2E)
    if name == "B4":
        return q.to(torch.bfloat16).float(), None, None
    static = cfg.softmax_mode == "static"
    dq = cfg.compute_dtype == "bf16"
    if not cfg.fuse_q_quant:   # int8 codes with per-row scales
        q8, qs = q.float(), q_scale.float()
        cap = None
        if static:
            qn = torch.sqrt((q8 * q8).sum(dim=-1, keepdim=True))
            cap = qs * qn * (kn_max.float() * _F32(1.0 + 1e-5))
        if dq:   # dequantized once: (q8 * qs) rounded to bf16
            return (q8 * qs).to(torch.bfloat16).float(), None, cap
        return q8, qs, cap
    qf = q.float() * fold
    ksh = _per_q_head(k_head_scale.float(), Hq)
    if dq:
        qe = qf * ksh
        cap = None
        if static:
            qn = torch.sqrt((qe * qe).sum(dim=-1, keepdim=True))
            cap = qn * (kn_max.float() * _F32(1.0 + 2.0 ** -7))
        return qe.to(torch.bfloat16).float(), None, cap
    a = qf.abs().amax(dim=-1, keepdim=True)
    qs = torch.where(a > 0, a * _F32(1.0 / 127.0), torch.ones_like(a))
    q8 = torch.clamp(torch.round(qf * (1.0 / qs)), -127, 127)
    qse = qs * ksh
    cap = None
    if static:
        qn = torch.sqrt((q8 * q8).sum(dim=-1, keepdim=True))
        cap = qse * qn * (kn_max.float() * _F32(1.0 + 1e-5))
    return q8, qse, cap


def _v_operand(v, pv_dtype):
    """V as the PV product sees it: int8 / e4m3 codes (exact in f32) or bf16."""
    if pv_dtype in ("int8", "fp8"):
        return v.float()
    return v.to(torch.bfloat16).float()


def _p_tile(st, m_next, p_mode):
    """P of one online kv tile and its contribution to l."""
    if p_mode == "bf16":
        p = torch.exp2(st - m_next)
        return p.to(torch.bfloat16).float(), p.sum(dim=-1, keepdim=True)
    if p_mode == "int8":
        p = torch.round(torch.exp2((st - m_next) + _F32(INT8_P_OFFSET_LOG2)))
        return p, p.sum(dim=-1, keepdim=True) * _F32(1.0 / 127.0)
    p = torch.exp2((st - m_next) + _F32(FP8_OFFSET_LOG2)).to(torch.float8_e4m3fn).float()
    return p, p.sum(dim=-1, keepdim=True)


def attention_plain(q, k, v, cfg: AttnConfig, k_head_scale=None, kn_max=None,
                    v_scale=None, v_mean=None, q_scale=None, k_scale=None):
    """Plain PyTorch version of the kernel: the same quantization points,
    exact int8 QK^T (an f32 product of int8 codes is exact for D <= 256 with
    TF32 off), P summed into l as the kernel rounds it (unrounded f32 for a
    bf16 P, the codes for int8/e4m3 P), P times V with f32 sums, and the
    online softmax over the kernel's 64-column kv tiles.

    Returns ``(out [B,Hq,Sq,D], lse_base2 [B,Hq,Sq] | None, lmin | None)``."""
    name = config_name(cfg)
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    kv_len = cfg.kv_len or Sk
    static = cfg.softmax_mode == "static"
    p_mode = "bf16" if (name == "B4" or cfg.p_bf16) else cfg.pv_dtype
    qop, qse, cap = _prepare_q(q, cfg, name, k_head_scale, kn_max, q_scale)
    kf = _per_q_head(k, Hq).float()
    vf = _per_q_head(_v_operand(v, cfg.pv_dtype if name != "B4" else "bf16"), Hq)
    ksc = None if k_scale is None else _per_q_head(k_scale.float(), Hq)   # [B,Hq,1,Sk]
    fold = _F32(cfg.sm_scale * LOG2E)
    # query rows per step: keep the [B, Hq, rows, Sk] f32 scores near 512 MB
    chunk = max(Q_TILE, (2 ** 27 // max(1, B * Hq * Sk)) // Q_TILE * Q_TILE)
    cols = torch.arange(Sk, device=q.device)
    outs, ms, ls = [], [], []
    with _no_tf32():
        for r0 in range(0, Sq, chunk):
            r1 = min(Sq, r0 + chunk)
            rows = torch.arange(r0, r1, device=q.device)[:, None]
            hi = min(kv_len, r1) if cfg.causal else kv_len  # cols past it are all masked
            mask = cols[None, :hi] >= kv_len
            if cfg.causal:
                mask = mask | (cols[None, :hi] > rows)
            s = torch.matmul(qop[:, :, r0:r1], kf[:, :, :hi].transpose(-1, -2))
            if qse is not None:
                s = s * qse[:, :, r0:r1]
            elif name == "B4":
                s = s * fold
            if ksc is not None:
                s = s * ksc[..., :hi]
            s = s.masked_fill(mask, MASK_NEG)
            if static:
                m = cap[:, :, r0:r1]
                p = torch.exp2(s - m)
                l = p.sum(dim=-1, keepdim=True)
                acc = torch.matmul(p.to(torch.bfloat16).float(), vf[:, :, :hi])
            else:
                m = torch.full((B, Hq, r1 - r0, 1), M_CLAMP, device=q.device)
                l = torch.zeros_like(m)
                acc = torch.zeros((B, Hq, r1 - r0, D), device=q.device)
                for c0 in range(0, hi, KV_TILE):
                    st = s[..., c0:c0 + KV_TILE]
                    m_next = torch.clamp_min(
                        torch.maximum(m, st.amax(dim=-1, keepdim=True)), M_CLAMP)
                    alpha = torch.exp2(m - m_next)
                    p, l_cur = _p_tile(st, m_next, p_mode)
                    l = alpha * l + l_cur
                    acc = acc * alpha + torch.matmul(p, vf[:, :, c0:c0 + KV_TILE])
                    m = m_next
            l_safe = torch.where(l == 0, torch.ones_like(l), l)
            o = acc * (1.0 / l_safe)
            if name != "B4" and cfg.pv_dtype != "bf16":
                vs = _per_q_head(v_scale.float(), Hq)
                o = o * (vs * _F32(1.0 / 127.0) if p_mode == "int8" else vs)
            if v_mean is not None:
                o = o + _per_q_head(v_mean.float(), Hq)
            outs.append(o.to(cfg.out_dtype))
            ms.append(m)
            ls.append(l)
    out = torch.cat(outs, dim=2)
    m = torch.cat(ms, dim=2)[..., 0]
    l = torch.cat(ls, dim=2)[..., 0]
    lse = None
    if cfg.emit_lse:
        lse = m + torch.log2(torch.clamp_min(l, 1e-37))
        if p_mode == "fp8":
            lse = lse - _F32(FP8_OFFSET_LOG2)
    lmin = None
    if static and cfg.fuse_q_quant:
        n_qt = -(-Sq // Q_TILE)
        lp = torch.full((B, Hq, n_qt * Q_TILE), 3e38, device=q.device)
        lp[..., :Sq] = l
        lmin = lp.view(B, Hq, n_qt, Q_TILE).amin(dim=-1)
    return out, lse, lmin


def _f32c(x):
    return None if x is None else x.float().contiguous()


_PV_MODE = {("bf16", "int8"): 0, ("bf16", "bf16"): 1, ("int8", "int8"): 2, ("fp8", "fp8"): 3}
_V_DTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def attention_kernel(q, k, v, cfg: AttnConfig, k_head_scale=None, kn_max=None,
                     v_scale=None, v_mean=None, q_scale=None, k_scale=None):
    """Launch ``csrc/attention.cu`` (fused Q, flash) or ``attention_q8.cu``
    (pre-quantized Q) for ``cfg`` on CUDA tensors; same returns as
    :func:`attention_plain`."""
    name = config_name(cfg)
    B, Hq, Sq, D = q.shape
    _, Hk, Sk, _ = k.shape
    if D not in (64, 128):
        raise NotImplementedError(f"the attention kernel takes head_dim 64/128, got {D}")
    static = cfg.softmax_mode == "static"
    out_dtype = cfg.out_dtype if cfg.out_dtype in (torch.bfloat16, torch.float32) else torch.float32
    if name == "B4":
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        in_dtype, out_dtype, pv = 0, torch.bfloat16, 1
    else:
        if k.dtype != torch.int8:
            raise TypeError("quantized attention takes int8 K codes")
        if cfg.pv_dtype == "bf16":
            v = v.to(torch.bfloat16)
        elif v.dtype != _V_DTYPE[cfg.pv_dtype]:
            raise TypeError(f"pv_dtype={cfg.pv_dtype!r} takes {_V_DTYPE[cfg.pv_dtype]} V codes")
        p_mode = "bf16" if cfg.p_bf16 else cfg.pv_dtype
        pv = _PV_MODE[(p_mode, "bf16" if cfg.pv_dtype == "bf16" else cfg.pv_dtype)]
        if cfg.fuse_q_quant:
            if q.dtype == torch.float16:
                q = q.float()   # exact; the kernel reads bf16 or f32
            if q.dtype not in (torch.bfloat16, torch.float32):
                raise TypeError(f"fused Q quantization takes float Q, got {q.dtype}")
            in_dtype = 0 if q.dtype == torch.bfloat16 else 1
            out_dtype = q.dtype
        else:
            if q.dtype != torch.int8:
                raise TypeError(f"a pre-quantized Q takes int8 codes, got {q.dtype}")
            in_dtype = 2
    q, k, v = (_build.vector_aligned(x) for x in (q, k, v))
    out = torch.empty((B, Hq, Sq, D), dtype=out_dtype, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if cfg.emit_lse else None)
    lmin = (torch.empty((B, Hq, -(-Sq // Q_TILE)), dtype=torch.float32, device=q.device)
            if static and cfg.fuse_q_quant else None)
    qs = None if q_scale is None else q_scale.float().reshape(B, Hq, Sq).contiguous()
    ks = None if k_scale is None else k_scale.float().reshape(B, Hk, Sk).contiguous()
    knm = _f32c(_per_q_head(kn_max, Hq)) if static else None
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    qmode = 2 if name == "B4" else (1 if cfg.compute_dtype == "bf16" else 0)
    _build.call(
        "sage_attn_fwd" if in_dtype != 2 else "sage_attn_fwd_q8", q.device,
        qmode, int(static), pv, in_dtype, 0 if out_dtype == torch.bfloat16 else 1, D,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        ptr(qs), ptr(ks), ptr(_f32c(k_head_scale)), ptr(knm), ptr(_f32c(v_scale)),
        ptr(_f32c(v_mean)), ptr(lse), ptr(lmin),
        B, Hq, Hk, Sq, Sk, cfg.kv_len or Sk, int(cfg.causal), _F32(cfg.sm_scale * LOG2E))
    attention_call.launches[name] += 1
    if out.dtype != cfg.out_dtype:
        out = out.to(cfg.out_dtype)
    return out, lse, lmin


def attention_call(
    q, k, v,
    q_scale=None, k_scale=None, v_scale=None, offsets=None,
    q_segments=None, kv_segments=None, kv_segpos=None, attn_mask=None,
    kn_max=None, v_mean=None, kv_true_dyn=None, k_head_scale=None,
    *, cfg: AttnConfig,
):
    """Run the attention forward for ``cfg`` on HND inputs.

    ``q [B,Hq,Sq,D]``: float (``fuse_q_quant``) or int8 codes with
    ``q_scale [B,Hq,Sq,1]`` per-row f32 scales (the per-head K scale
    folded in under ``fold_k_scale``).  ``k [B,Hk,Sk,D]`` int8 codes (bf16
    when ``quantized=False``) with, unless ``fold_k_scale``, per-column
    scales ``k_scale [B,Hk,1,Sk]``; under ``fuse_q_quant`` the per-head K
    scale comes as ``k_head_scale [B,Hk,1,1]``.  ``v`` int8 / e4m3 codes for
    ``pv_dtype`` "int8" / "fp8" with ``v_scale [B,Hk,1,D]``, or float for
    "bf16".  ``kn_max [B,Hq,1,1]`` (static), ``v_mean [B,Hk,1,D]``
    (``fuse_v_mean``).  Returns ``(out, lse_base2)``, plus ``lmin`` for the
    static fused-Q configurations, as the JAX ``attention_call`` does.
    """
    name = config_name(cfg)
    unsupported = dict(offsets=offsets, q_segments=q_segments, kv_segments=kv_segments,
                       kv_segpos=kv_segpos, attn_mask=attn_mask, kv_true_dyn=kv_true_dyn)
    for arg, val in unsupported.items():
        if val is not None:
            raise NotImplementedError(f"attention_call({arg}=...) is outside this slice")
    B, Hq, Sq, D = q.shape
    _, Hk, Sk, _ = k.shape
    if Hq % Hk or v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if cfg.causal and Sq != Sk:
        raise ValueError("causal attention needs Sq == Sk")
    if not 0 <= cfg.kv_len <= Sk:
        raise ValueError(f"kv_len {cfg.kv_len} out of range for Sk={Sk}")
    if name != "B4":
        if cfg.fuse_q_quant:
            if k_head_scale is None or q_scale is not None:
                raise ValueError("a fused Q takes k_head_scale and no q_scale")
        elif q_scale is None or k_head_scale is not None:
            raise ValueError("a pre-quantized Q takes q_scale and no k_head_scale")
        if cfg.fold_k_scale != (k_scale is None):
            raise ValueError("k_scale is given iff not cfg.fold_k_scale")
        if (cfg.pv_dtype != "bf16") != (v_scale is not None):
            raise ValueError("v_scale is given iff V is quantized (pv_dtype int8/fp8)")
        if cfg.softmax_mode == "static" and kn_max is None:
            raise ValueError("softmax_mode='static' needs kn_max")
        if cfg.fuse_v_mean != (v_mean is not None):
            raise ValueError("v_mean is given iff cfg.fuse_v_mean")
    args = (q, k, v, cfg, k_head_scale, kn_max, v_scale, v_mean, q_scale, k_scale)
    if q.device.type == "cpu":
        out, lse, lmin = attention_plain(*args)
    elif q.device.type == "cuda":
        out, lse, lmin = attention_kernel(*args)
    else:
        raise NotImplementedError(f"no kernel for device {q.device}")
    if cfg.softmax_mode == "static" and cfg.quantized and cfg.fuse_q_quant:
        return out, lse, lmin
    return out, lse


attention_call.launches = {name: 0 for name in LAUNCH_KEYS}
