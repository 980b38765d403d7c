"""SageAttention forward kernel and its plain version (B1-B9).

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

Each of them may carry the options of B7-B9, which add a suffix to the key:
``-colk`` a fused Q with per-column K scales (varlen, native compute),
``-rowk`` a fused Q with a per-row K scale (``fuse_k_rows``: varlen's
per-segment scale under bf16 compute), ``-bool`` / ``-float`` a user mask
(B7: a keep-mask whose dead 64x64 tiles are skipped, or an additive bias in
natural-log units, times log2(e) in the kernel), ``-seg`` varlen segment
ids (B8: q pads -1, kv pads -2; with sinks, the per-segment positions
``kv_segpos``), ``-window`` a causal sliding window with optional sinks
(B9: tiles below the band are skipped unless they hold a sink).  Masking
happens after the scale and before the softmax, in the JAX kernel's order:
kv tail, causal and window band, segments, bool mask, then the float bias.

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
launches per configuration name, over every name in ``LAUNCH_KEYS``.
"""

from __future__ import annotations

import dataclasses
import itertools

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
SEGPOS_PAD = 1 << 30  # kv_segpos of a pad token: never a sink

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


_LATER = {
    "causal_dynamic": "B10 (ring offsets)", "kv_len_dynamic": "B10",
    "causal_row_mod": "B11 (decode)", "p_sim_fp4": "queue 1 item 14 (low-bit simulation)",
}


def _check_options(cfg: AttnConfig) -> None:
    """The B7-B9 options' own rules (the JAX ``attention_call`` asserts)."""
    if cfg.masked not in ("none", "bool", "float"):
        raise ValueError(f"unknown masked {cfg.masked!r}")
    if cfg.window:
        if not cfg.causal:
            raise ValueError("a sliding window needs causal attention")
        if cfg.masked != "none":
            raise ValueError("a sliding window composes with no user attn_mask")
        if cfg.window < 1 or cfg.sinks < 0:
            raise ValueError(f"bad window {cfg.window} / sinks {cfg.sinks}")
    elif cfg.sinks:
        raise ValueError("attention sinks require a sliding window")
    if cfg.fuse_k_rows and not (cfg.quantized and cfg.fuse_q_quant and cfg.fold_k_scale):
        raise ValueError("fuse_k_rows needs a fused Q with folded K scales")
    if (cfg.softmax_mode == "static" and cfg.masked == "float"
            and not (cfg.quantized and cfg.fuse_q_quant)):
        raise ValueError("a static softmax with a float bias needs the fused "
                         "post-hoc safety check (fuse_q_quant)")


def _base_name(cfg: AttnConfig) -> str:
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


def config_name(cfg: AttnConfig) -> str:
    """The port's launch key for ``cfg``: the base configuration (B1-B6) and
    the suffixes of its B7-B9 options; raises ``NotImplementedError``
    naming the later slice for options not ported yet."""
    for field, slice_ in _LATER.items():
        val = getattr(cfg, field)
        if val:
            raise NotImplementedError(f"AttnConfig.{field}={val!r} arrives with {slice_}")
    if cfg.kv_split != 1:
        raise NotImplementedError("AttnConfig.kv_split arrives with B11 (decode)")
    if cfg.layout != "HND":
        raise ValueError("attention_call operates in HND; transpose first")
    if cfg.softmax_mode not in ("static", "online"):
        raise ValueError(f"unknown softmax_mode {cfg.softmax_mode!r}")
    _check_options(cfg)
    name = _base_name(cfg)
    if cfg.quantized and cfg.fuse_q_quant and not cfg.fold_k_scale:
        name += "-colk"
    if cfg.fuse_k_rows:
        name += "-rowk"
    if cfg.masked != "none":
        name += "-" + cfg.masked
    if cfg.segmented:
        name += "-seg"
    if cfg.window:
        name += "-window"
    return name


def _launch_keys() -> tuple:
    """Every key :func:`config_name` gives: each valid combination of the
    fields that name a configuration."""
    keys = {}
    for quantized, pv, cd, sm, fqq, fold, via, rows, masked, seg, window in itertools.product(
            (True, False), ("int8", "fp8", "bf16"), ("native", "bf16"), ("static", "online"),
            (True, False), (True, False), (False, True), (False, True),
            ("none", "bool", "float"), (False, True), (0, 1)):
        cfg = AttnConfig(causal=True, quantized=quantized, pv_dtype=pv, compute_dtype=cd,
                         softmax_mode=sm, fuse_q_quant=fqq, fold_k_scale=fold,
                         pv_via_bf16=via, fuse_k_rows=rows, masked=masked, segmented=seg,
                         window=window)
        try:
            keys.setdefault(config_name(cfg))
        except ValueError:
            continue
    return tuple(keys)


LAUNCH_KEYS = _launch_keys()


def _extended(cfg: AttnConfig) -> bool:
    """True for the configurations built from the B7-B9 kernel sources."""
    return (cfg.masked != "none" or cfg.segmented or bool(cfg.window)
            or cfg.fuse_k_rows)


def _per_q_head(x: torch.Tensor, Hq: int) -> torch.Tensor:
    return x if x.shape[1] == Hq else x.repeat_interleave(Hq // x.shape[1], dim=1)


def _prepare_q(q, cfg, name, k_head_scale, kn_max, q_scale=None):
    """Per-row Q operand, row scale and static cap, as the kernel's Q step
    computes them (``attention.py:316-374`` of the JAX package)."""
    Hq = q.shape[1]
    fold = _F32(cfg.sm_scale * LOG2E)
    if name.startswith("B4"):
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
    # per head ([B,Hk,1,1]), per row (fuse_k_rows, [B,Hq,Sq,1]), or none
    # (per-column K scales ride k_scale and kn_max includes them)
    ksh = 1.0 if k_head_scale is None else _per_q_head(k_head_scale.float(), Hq)
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


def _keep_mask(cfg, rows, cols, r0, r1, hi, ext):
    """True where a score of query rows ``rows`` (``[r1-r0, 1]``) and kv
    columns ``cols[:hi]`` survives the kv tail, causal, window, segment and
    bool masks; ``[B|1, Hm|1, r1-r0, hi]``."""
    c = cols[None, :hi]
    kv_len = cfg.kv_len or ext["Sk"]
    keep = c < kv_len
    if cfg.causal:
        keep = keep & (c <= rows)
        if cfg.window:
            band = c >= rows - (cfg.window - 1)
            if cfg.sinks:
                if cfg.segmented:
                    band = band | (ext["kv_segpos"][:, None, None, :hi] < cfg.sinks)
                else:
                    band = band | (c < cfg.sinks)
            keep = keep & band
    keep = keep[None, None] if keep.ndim == 2 else keep
    if cfg.segmented:
        qs = ext["q_segments"][:, None, r0:r1, None]
        keep = keep & (qs == ext["kv_segments"][:, None, None, :hi])
    if cfg.masked == "bool":
        keep = keep & (ext["attn_mask"][:, :, r0:r1, :hi] != 0)
    return keep


def attention_plain(q, k, v, cfg: AttnConfig, k_head_scale=None, kn_max=None,
                    v_scale=None, v_mean=None, q_scale=None, k_scale=None,
                    q_segments=None, kv_segments=None, kv_segpos=None, attn_mask=None):
    """Plain PyTorch version of the kernel: the same quantization points,
    exact int8 QK^T (an f32 product of int8 codes is exact for D <= 256 with
    TF32 off), P summed into l as the kernel rounds it (unrounded f32 for a
    bf16 P, the codes for int8/e4m3 P), P times V with f32 sums, and the
    online softmax over the kernel's 64-column kv tiles.  A kv tile that
    the kernel skips (dead under a mask or below a window) holds only masked
    scores here, which changes no running sum, so both agree exactly.
    ``q_segments [B,Sq]``, ``kv_segments``/``kv_segpos [B,Sk]``,
    ``attn_mask [B,Hm,Sq,Sk]`` (bool keep-mask or float bias).

    Returns ``(out [B,Hq,Sq,D], lse_base2 [B,Hq,Sq] | None, lmin | None)``."""
    name = config_name(cfg)
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    kv_len = cfg.kv_len or Sk
    static = cfg.softmax_mode == "static"
    p_mode = "bf16" if cfg.p_bf16 else cfg.pv_dtype
    qop, qse, cap = _prepare_q(q, cfg, name, k_head_scale, kn_max, q_scale)
    kf = _per_q_head(k, Hq).float()
    vf = _per_q_head(_v_operand(v, cfg.pv_dtype if cfg.quantized else "bf16"), Hq)
    ksc = None if k_scale is None else _per_q_head(k_scale.float(), Hq)   # [B,Hq,1,Sk]
    fold = _F32(cfg.sm_scale * LOG2E)
    ext = dict(Sk=Sk, q_segments=q_segments, kv_segments=kv_segments,
               kv_segpos=kv_segpos, attn_mask=attn_mask)
    # query rows per step: keep the [B, Hq, rows, Sk] f32 scores near 512 MB
    chunk = max(Q_TILE, (2 ** 27 // max(1, B * Hq * Sk)) // Q_TILE * Q_TILE)
    cols = torch.arange(Sk, device=q.device)
    outs, ms, ls = [], [], []
    with _no_tf32():
        for r0 in range(0, Sq, chunk):
            r1 = min(Sq, r0 + chunk)
            rows = torch.arange(r0, r1, device=q.device)[:, None]
            hi = min(kv_len, r1) if cfg.causal else kv_len  # cols past it are all masked
            s = torch.matmul(qop[:, :, r0:r1], kf[:, :, :hi].transpose(-1, -2))
            if qse is not None:
                s = s * qse[:, :, r0:r1]
            elif not cfg.quantized:
                s = s * fold
            if ksc is not None:
                s = s * ksc[..., :hi]
            s = torch.where(_keep_mask(cfg, rows, cols, r0, r1, hi, ext), s, MASK_NEG)
            if cfg.masked == "float":
                s = s + attn_mask[:, :, r0:r1, :hi].float() * _F32(LOG2E)
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
            if cfg.quantized and cfg.pv_dtype != "bf16":
                vs = _per_q_head(v_scale.float(), Hq)
                o = o * (vs * _F32(1.0 / 127.0) if p_mode == "int8" else vs)
            if v_mean is not None:
                o = o + _per_q_head(v_mean.float(), Hq)
            outs.append(o.to(cfg.out_dtype))
            ms.append(m.expand(B, Hq, r1 - r0, 1))
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


def mask_tile_table(attn_mask: torch.Tensor, bq: int = Q_TILE, bk: int = KV_TILE) -> torch.Tensor:
    """``[B, Hm, ceil(Sq/bq), ceil(Sk/bk)]`` uint8 for the keep-mask ``[B,
    Hm, Sq, Sk]``: 0 where the ``bq x bk`` tile keeps no score (the kernel
    skips its loads and compute; JAX's ``minfo`` table at its own blocks),
    2 where it keeps every score (the kernel reads no mask), 1 in between
    (a tile cut by the mask's edge counts as 1 at most).  One read of the
    mask: kept scores are counted per tile row, then per tile."""
    m = attn_mask.view(torch.int8) if attn_mask.dtype == torch.bool else (
        attn_mask != 0).to(torch.int8)
    B, Hm, Sq, Sk = m.shape
    nq, nk_full = -(-Sq // bq), Sk // bk
    counts = [m[..., :nk_full * bk].unfold(-1, bk, bk).sum(-1, dtype=torch.int32)]
    if Sk % bk:
        counts.append(m[..., nk_full * bk:].sum(-1, keepdim=True, dtype=torch.int32))
    c = torch.nn.functional.pad(torch.cat(counts, -1), (0, 0, 0, nq * bq - Sq))
    c = c.view(B, Hm, nq, bq, -1).sum(3)
    return ((c > 0).to(torch.uint8) + (c == bq * bk).to(torch.uint8)).contiguous()


def segment_sink_tiles(kv_segpos: torch.Tensor, sinks: int, bk: int = KV_TILE) -> torch.Tensor:
    """``[B, ceil(Sk/bk)]`` uint8: does the kv tile hold a token among the
    first ``sinks`` of its own segment?  (The JAX kernel's ``sinkblk``
    table at the port's tile.)"""
    B, Sk = kv_segpos.shape
    nk = -(-Sk // bk)
    pos = torch.nn.functional.pad(kv_segpos, (0, nk * bk - Sk), value=SEGPOS_PAD)
    return (pos.view(B, nk, bk).amin(dim=-1) < sinks).to(torch.uint8).contiguous()


def segment_tile_ranges(ids: torch.Tensor, bt: int = Q_TILE) -> torch.Tensor:
    """``[B, ceil(S/bt), 2]`` int32: the min and max segment id of each
    ``bt``-row tile of ``ids [B, S]``.  A q tile and a kv tile whose ranges
    do not meet share no segment (the kernel skips the pair), and two tiles
    whose ranges are the same single id need no segment mask."""
    B, S = ids.shape
    n = -(-S // bt)
    pad = lambda v: torch.nn.functional.pad(ids, (0, n * bt - S), value=v).view(B, n, bt)  # noqa: E731
    return torch.stack([pad(2 ** 30).amin(-1), pad(-2 ** 30).amax(-1)], -1).to(
        torch.int32).contiguous()


def _f32c(x):
    return None if x is None else x.float().contiguous()


_PV_MODE = {("bf16", "int8"): 0, ("bf16", "bf16"): 1, ("int8", "int8"): 2, ("fp8", "fp8"): 3}
_V_DTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def attention_kernel(q, k, v, cfg: AttnConfig, k_head_scale=None, kn_max=None,
                     v_scale=None, v_mean=None, q_scale=None, k_scale=None,
                     q_segments=None, kv_segments=None, kv_segpos=None, attn_mask=None):
    """Launch the kernel for ``cfg`` on CUDA tensors: ``csrc/attention.cu``
    (fused Q, flash) or ``attention_q8.cu`` (pre-quantized Q), and their
    ``*_ext.cu`` builds for the B7-B9 options; same arguments and returns
    as :func:`attention_plain`."""
    name = config_name(cfg)
    B, Hq, Sq, D = q.shape
    _, Hk, Sk, _ = k.shape
    if D not in (64, 128):
        raise NotImplementedError(f"the attention kernel takes head_dim 64/128, got {D}")
    static = cfg.softmax_mode == "static"
    out_dtype = cfg.out_dtype if cfg.out_dtype in (torch.bfloat16, torch.float32) else torch.float32
    if not cfg.quantized:
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
    # contiguous f32 copies where needed, each held by a name until the
    # launch: the address of a copy freed before it would be reused memory
    qs = None if q_scale is None else q_scale.float().reshape(B, Hq, Sq).contiguous()
    ks = None if k_scale is None else k_scale.float().reshape(B, Hk, Sk).contiguous()
    knm = _f32c(_per_q_head(kn_max, Hq)) if static else None
    head_scale = None if cfg.fuse_k_rows else _f32c(k_head_scale)
    vs, vm = _f32c(v_scale), _f32c(v_mean)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    qmode = 2 if not cfg.quantized else (1 if cfg.compute_dtype == "bf16" else 0)
    args = [qmode, int(static), pv, in_dtype, 0 if out_dtype == torch.bfloat16 else 1, D,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            ptr(qs), ptr(ks), ptr(head_scale), ptr(knm), ptr(vs), ptr(vm), ptr(lse), ptr(lmin),
            B, Hq, Hk, Sq, Sk, cfg.kv_len or Sk, int(cfg.causal), _F32(cfg.sm_scale * LOG2E)]
    fn = "sage_attn_fwd" if in_dtype != 2 else "sage_attn_fwd_q8"
    if _extended(cfg):
        fn += "_ext"
        mask = bias = live = sinkblk = None
        m_strides, Hm = (0, 0, 0), 1
        if cfg.masked != "none":
            if cfg.masked == "bool":   # bool and int8 share a byte: no copy
                m = attn_mask.view(torch.int8) if attn_mask.dtype == torch.bool else attn_mask
                m = m.to(torch.int8)
            else:
                m = attn_mask.float()
            if m.stride(-1) != 1:
                m = m.contiguous()
            m_strides, Hm = m.stride()[:3], m.shape[1]
            if cfg.masked == "bool":
                mask, live = m, mask_tile_table(m)
            else:
                bias = m
        q_rng = kv_rng = None
        if cfg.segmented:
            q_rng, kv_rng = segment_tile_ranges(q_segments), segment_tile_ranges(kv_segments)
            if cfg.sinks:
                sinkblk = segment_sink_tiles(kv_segpos, cfg.sinks)
        k_rows = (k_head_scale.float().reshape(B, Hq, Sq).contiguous()
                  if cfg.fuse_k_rows else None)
        args += [ptr(mask), ptr(bias), *m_strides, Hm, ptr(live), ptr(q_segments),
                 ptr(kv_segments), ptr(kv_segpos), ptr(q_rng), ptr(kv_rng), ptr(sinkblk),
                 ptr(k_rows), cfg.window, cfg.sinks]
    _build.call(fn, q.device, *args)
    attention_call.launches[name] += 1
    if out.dtype != cfg.out_dtype:
        out = out.to(cfg.out_dtype)
    return out, lse, lmin


def _segment_ids(x, B, S, what):
    """Segment ids or positions as contiguous int32 ``[B, S]``."""
    if x is None:
        return None
    if x.numel() != B * S:
        raise ValueError(f"{what} must hold {B} x {S} ids, got shape {tuple(x.shape)}")
    return x.reshape(B, S).to(torch.int32).contiguous()


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
    scales ``k_scale [B,Hk,1,Sk]``; under ``fuse_q_quant`` the K scale
    comes as ``k_head_scale``: ``[B,Hk,1,1]`` per head, ``[B,Hq,Sq,1]`` per
    query row (``fuse_k_rows``), or none with per-column scales.  ``v``
    int8 / e4m3 codes for ``pv_dtype`` "int8" / "fp8" with ``v_scale
    [B,Hk,1,D]``, or float for "bf16".  ``kn_max [B,Hq,1,1]`` (static),
    ``v_mean [B,Hk,1,D]`` (``fuse_v_mean``).  B7-B9: ``attn_mask
    [B,1|Hq,Sq,Sk]`` (``masked`` "bool": nonzero keeps; "float": additive
    bias in natural-log units); ``q_segments [B,Sq(,1)]`` and
    ``kv_segments [B,(1,)Sk]`` int ids (``segmented``; pads carry ids that
    never match, -1 and -2), ``kv_segpos`` like ``kv_segments`` (each kv
    token's position in its segment: per-segment sinks).  Unlike JAX, no
    input needs padding to block sizes.  Returns ``(out, lse_base2)``, plus
    ``lmin`` for the static fused-Q configurations, as the JAX
    ``attention_call`` does.
    """
    name = config_name(cfg)
    for arg, val in dict(offsets=offsets, kv_true_dyn=kv_true_dyn).items():
        if val is not None:
            raise NotImplementedError(f"attention_call({arg}=...) arrives with B10 (ring)")
    B, Hq, Sq, D = q.shape
    _, Hk, Sk, _ = k.shape
    if Hq % Hk or v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if cfg.causal and Sq != Sk:
        raise ValueError("causal attention needs Sq == Sk")
    if not 0 <= cfg.kv_len <= Sk:
        raise ValueError(f"kv_len {cfg.kv_len} out of range for Sk={Sk}")
    if cfg.quantized:
        if cfg.fuse_q_quant:
            if (k_head_scale is None) == cfg.fold_k_scale or q_scale is not None:
                raise ValueError("a fused Q takes no q_scale, and k_head_scale iff fold_k_scale")
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
    if (cfg.masked != "none") != (attn_mask is not None):
        raise ValueError("attn_mask is given iff cfg.masked")
    if attn_mask is not None and (attn_mask.ndim != 4 or attn_mask.shape[1] not in (1, Hq) or (
            attn_mask.shape[0], attn_mask.shape[2], attn_mask.shape[3]) != (B, Sq, Sk)):
        raise ValueError(f"attn_mask must be [B, 1|Hq, Sq, Sk], got {tuple(attn_mask.shape)}")
    if cfg.segmented != (q_segments is not None and kv_segments is not None):
        raise ValueError("q_segments and kv_segments are given iff cfg.segmented")
    if (kv_segpos is not None) != (cfg.segmented and cfg.sinks > 0):
        raise ValueError("kv_segpos is given iff segmented attention has sinks")
    for arg, val in dict(attn_mask=attn_mask, q_segments=q_segments, kv_segments=kv_segments,
                         kv_segpos=kv_segpos).items():
        if val is not None and val.device != q.device:
            raise ValueError(f"{arg} is on device {val.device}, the attention on {q.device}")
    ext = dict(q_segments=_segment_ids(q_segments, B, Sq, "q_segments"),
               kv_segments=_segment_ids(kv_segments, B, Sk, "kv_segments"),
               kv_segpos=_segment_ids(kv_segpos, B, Sk, "kv_segpos"), attn_mask=attn_mask)
    args = (q, k, v, cfg, k_head_scale, kn_max, v_scale, v_mean, q_scale, k_scale)
    if q.device.type == "cpu":
        out, lse, lmin = attention_plain(*args, **ext)
    elif q.device.type == "cuda":
        out, lse, lmin = attention_kernel(*args, **ext)
    else:
        raise NotImplementedError(f"no kernel for device {q.device}")
    if cfg.softmax_mode == "static" and cfg.quantized and cfg.fuse_q_quant:
        return out, lse, lmin
    return out, lse


attention_call.launches = {name: 0 for name in LAUNCH_KEYS}
