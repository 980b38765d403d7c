"""SageAttention forward kernels and their plain versions (B1-B9, B11).

Counterpart of ``sageattention_tpu/ops/attention.py``: ``AttnConfig`` keeps
the JAX field names and ``attention_call`` takes the same inputs.  The
configurations, by their launch key (``config_name``):

  B1 / B2        fused int8 Q, native int8 QK^T, int8 V under a bf16 P:
                 static, and its online fallback (pv_via_bf16); B1 with a
                 bf16 Q at head dims 64 and 128 runs
                 ``csrc/attention_sm90.cu`` (TMA, int8 wgmma, warpgroups
                 taking turns; :func:`b1_sm90_route`), on V codes widened to
                 bf16 (:func:`widen_v_codes`), and so do its window, bool-mask
                 and segment forms (each block walking its list of kv tiles,
                 :func:`tile_list`), per-column K scales (``-colk``) too
  B3 / B3-online fused Q with bf16 compute (short sequences), int8 V
  B4             quantized=False: the bf16 flash baseline; with no mask,
                 window or segments it runs ``csrc/flash_sm90.cu`` (TMA,
                 wgmma, warpgroups taking turns), whose kv tiles are
                 ``flash_kv_tile(D)`` wide, and so do ``B4-window`` and
                 ``B4-bool`` (a window or a bool mask, no segments: each
                 block walks its list of kv tiles) and ``B4-float`` (a
                 float bias and no other option) at head dims 64 and 128,
                 on 64-column tiles (:func:`flash_sm90_route`)
  B4-fp4         the same with ``p_sim_fp4``: each 64-column P tile rounded
                 to e2m1 at (its row max) / 6 under the online softmax, l
                 summing the rounded P (``csrc/flash_sm90.cu``'s FP4 mode at
                 head dims 64, 128 and 256; the SageAttention3 simulation of
                 ``ops/lowbit.py``)
  B5-int8        int8 P under the online softmax, int8 V (either Q source)
  B5-fp8(-fusedq) e4m3 P under the online softmax, e4m3 V; a pre-quantized
                 Q (``q_scale``), or a fused one.  B5-fp8 with a bf16
                 output at head dims 64 and 128 runs
                 ``csrc/attention_q8_sm90.cu`` (an e4m3 wgmma PV on the V^T
                 copy :func:`transpose_v_codes` writes;
                 :func:`q8_sm90_route`), as do the ring's B10 forms of it
  B6-static / B6-online  a pre-quantized Q with per-row scales, per-head
                 (folded) or per-column (``k_scale``) K scales, int8 V; with
                 a bf16 output at head dims 64 and 128 it runs
                 ``csrc/attention_q8_sm90.cu`` (TMA-loaded Q codes, int8
                 wgmma, the online softmax on 64-column tiles;
                 :func:`q8_sm90_route`), as do the ring's B10 forms of it
  B6-bf16c       a pre-quantized Q dequantized to bf16 (bf16 compute),
                 static or online
  B-pvbf16(-online)  bf16 V (pv_dtype "bf16"), any Q source and compute;
                 with native compute at head dims 64 and 128 it runs
                 ``csrc/attention_q8_sm90.cu`` on a pre-quantized Q (static
                 and online, a bf16 or fp16 output, and the ring's B10
                 forms; :func:`q8_sm90_route`) and ``csrc/attention_sm90.cu``
                 on a fused bf16 Q (static; :func:`b1_sm90_route`), both on
                 the caller's bf16 V with no scale or mean

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

``fp8_native_dot`` selects no other numerics here: the plain version and
``attention.cuh``'s kernel run the e4m3 PV product on exact bf16 copies of
the codes, which is what JAX computes with ``fp8_native_dot=False``; the
Hopper B5-fp8 multiplies the codes themselves, its f32 sums per 64-column
tile within rounding of those.  Unlike the TPU kernel, the inputs
need no padding to the block sizes: the CUDA kernel masks the ragged edges
itself and picks its own tiles, so ``block_q``/``block_k``/
``block_k_inner`` are accepted and ignored, and the online softmax walks
64-column kv tiles (B4 on ``flash_sm90.cu``, but for its bias and FP4
forms: ``flash_kv_tile(D)`` columns).
``lmin`` comes back as ``[B, Hq, ceil(Sq/64)]``, one minimum row
denominator per 64-row query tile.

The decode configuration (B11: a dynamic length ``kv_true_dyn``, dynamic
causal ``offsets``, ``causal_row_mod`` for folded verify windows, any
``kv_split``; at most 32 query rows a launch, folded rows past them in
further launches) goes to ``csrc/decode.cu``, a split-KV
kernel whose splits are its own choice (:func:`decode_splits`); its keys
are ``B11-<V format>`` with ``-causal`` or ``-causal-mod``.  Its plain
version (:func:`decode_plain`) walks the same splits and 64-token tiles.
The same fields over more rows are the ring's (B10, ``parallel/ring.py``):
the prefill kernel on a pre-quantized Q (``csrc/attention_ring.cu``) with
causal positions shifted by the device ``offsets`` ``(q_start, kv_start)``
(a kv column is seen iff ``kv_start + col <= q_start + row``) and the kv
length cut at the device ``kv_true_dyn``; its keys are ``B10-<base key>``
with ``-offsets`` and/or ``-kvtrue``.

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


DECODE_ROWS = 32            # query rows of one decode block (JAX's _BQ)
DECODE_SPLIT_BLOCKS = 264   # decode blocks to aim for: two on each of the H100's 132 SMs
DECODE_MAX_SPLITS = 32


def is_decode(cfg: AttnConfig, rows: int) -> bool:
    """True for the decode configuration (B11) of a launch over ``rows``
    query rows: folded verify rows, or a dynamic length, dynamic causal
    offsets or a KV split over at most ``DECODE_ROWS`` rows, as
    ``sageattn_decode`` sets them."""
    if cfg.causal_row_mod:
        return True
    return (bool(cfg.kv_len_dynamic or cfg.causal_dynamic or cfg.kv_split != 1)
            and rows <= DECODE_ROWS)


def is_ring(cfg: AttnConfig, rows: int) -> bool:
    """True for the ring's configuration (B10): a dynamic length or dynamic
    causal offsets at prefill sizes (more than ``DECODE_ROWS`` rows).  A KV
    split there changes nothing: the kernel picks its own tiles."""
    return bool(cfg.kv_len_dynamic or cfg.causal_dynamic) and not is_decode(cfg, rows)


def _decode_name(cfg: AttnConfig) -> str:
    """B11's launch key: ``B11-<V format>``, ``-causal`` for a verify window,
    ``-causal-mod`` when its rows are folded GQA heads."""
    if not (cfg.quantized and cfg.fuse_q_quant and not cfg.fold_k_scale
            and cfg.softmax_mode == "online" and cfg.compute_dtype == "native"):
        raise NotImplementedError(
            "B11 (decode) takes a fused int8 Q, per-token K scales (fold_k_scale=False), "
            "the online softmax and native compute, as sageattn_decode builds them")
    if (cfg.masked != "none" or cfg.segmented or cfg.window or cfg.fuse_k_rows
            or cfg.pv_via_bf16):
        raise ValueError("the decode configuration composes with no masks, segments, "
                         "window or row K scales")
    if cfg.pv_dtype not in ("int8", "fp8", "bf16"):
        raise ValueError(f"unknown pv_dtype {cfg.pv_dtype!r}")
    if cfg.causal != cfg.causal_dynamic or (cfg.causal_row_mod and not cfg.causal):
        raise ValueError("decode causality comes from dynamic offsets (causal and "
                         "causal_dynamic together; causal_row_mod only with them)")
    if cfg.kv_split < 1:
        raise ValueError(f"bad kv_split {cfg.kv_split}")
    name = f"B11-{cfg.pv_dtype}"
    if cfg.causal:
        name += "-causal-mod" if cfg.causal_row_mod else "-causal"
    return name


def _extended(cfg: AttnConfig) -> bool:
    """True for the configurations built from the B7-B9 kernel sources."""
    return (cfg.masked != "none" or cfg.segmented or bool(cfg.window)
            or cfg.fuse_k_rows)


def flash_sm90_route(cfg: AttnConfig, rows: int, D: int) -> bool:
    """True for the launches that ``csrc/flash_sm90.cu`` runs: the bf16
    flash baseline (``quantized=False``) with no ring offsets or device
    length, either with no mask, segments, window or row K scales (B4 and,
    with ``p_sim_fp4``, B4-fp4, head dims 64, 128 and 256), with a window
    (sinks too) or a bool mask and no segments (B4-window, B4-bool: the
    MASKED mode, head dims 64, 128 and 256), or with a float bias and none
    of the others (B4-float, head dims 64 and 128: at 256 its stages do not
    fit).  Every other B4 form (segments) stays on ``attention.cuh``'s
    body."""
    if cfg.quantized or is_ring(cfg, rows):
        return False
    if not _extended(cfg):
        return True
    if cfg.segmented or cfg.fuse_k_rows:
        return False
    return cfg.masked != "float" or (not cfg.window and D in (64, 128))



def b1_sm90_route(cfg: AttnConfig, rows: int, D: int, q_dtype: torch.dtype) -> bool:
    """True for the launches that ``csrc/attention_sm90.cu`` runs: B1 (the
    static fused-Q int8 forward with int8 V and no ring offsets), with no
    option or a window, a bool mask or segments (``B1-window``,
    ``B1-bool``, ``B1-colk-seg``, ``B1-colk-seg-window``, ...), and
    B-pvbf16 with no option (V in bf16 with no scale or mean, native
    compute) on a bf16 Q at head dims 64 and 128.  B1 or B-pvbf16 at D =
    256 or with an f32/f16 Q, B-pvbf16 with bf16 compute or a V mean, the
    online reruns (B2, B2-bool, ...), and every other configuration stay on
    ``attention.cuh``'s body.  ``cfg`` must be one :func:`config_name`
    takes."""
    if D not in (64, 128) or q_dtype != torch.bfloat16:
        return False
    name = config_name(cfg, rows)
    if name == "B1" or (name == "B-pvbf16" and cfg.fuse_q_quant and _bf16_v_native(cfg)):
        return True
    # the options of the masked kernel: a window, a bool mask or segments,
    # folded or per-column K scales; no float bias, row K scales, or bool
    # mask with segments
    return (_base_name(cfg) == "B1" and _extended(cfg) and cfg.masked != "float"
            and not cfg.fuse_k_rows and not (cfg.masked == "bool" and cfg.segmented))


def _bf16_v_native(cfg: AttnConfig) -> bool:
    """B-pvbf16's forms the Hopper kernels take: native compute (int8 QK^T)
    and no V mean (their epilogue adds none)."""
    return cfg.compute_dtype == "native" and not cfg.fuse_v_mean


def q8_sm90_route(cfg: AttnConfig, rows: int, D: int, q_dtype: torch.dtype) -> bool:
    """True for the launches that ``csrc/attention_q8_sm90.cu`` runs: B6
    (int8 Q codes with per-row scales, folded or per-column K scales, int8 V
    under a bf16 P), static or online, B5-fp8 (the same Q and K under the
    online softmax with an e4m3 P and e4m3 V), B-pvbf16 (the same Q and K
    with V in bf16 and no V mean, native compute, static or online), and
    the ring's B10 forms of all three (``-offsets`` and/or ``-kvtrue``),
    with a bf16 output (B-pvbf16 also fp16) at head dims 64 and 128.  D =
    256, an f32 output, ``B6-bf16c``, ``B5-fp8-fusedq``, B-pvbf16 with bf16
    compute and every other configuration stay on ``attention.cuh``'s body.
    ``cfg`` must be one :func:`config_name` takes."""
    if D not in (64, 128) or q_dtype != torch.int8:
        return False
    base = _q8_base(cfg, rows)
    if base not in Q8_SM90_BASES:
        return False
    if base.startswith("B-pvbf16"):
        return (cfg.out_dtype in (torch.bfloat16, torch.float16) and not cfg.fuse_q_quant
                and _bf16_v_native(cfg))
    return cfg.out_dtype == torch.bfloat16


def _q8_base(cfg: AttnConfig, rows: int) -> str:
    """The launch key of ``cfg`` without B10's prefix and suffixes."""
    base = config_name(cfg, rows).removeprefix("B10-")
    return base.replace("-offsets", "").replace("-kvtrue", "")


# the base keys that ``csrc/attention_q8_sm90.cu`` runs, by its mode argument
Q8_SM90_BASES = {"B6-static": 0, "B6-online": 1, "B5-fp8": 2, "B-pvbf16": 3,
                 "B-pvbf16-online": 4}


def flash_kv_tile(D: int) -> int:
    """kv columns per online-softmax tile of ``flash_sm90.cu`` at head dim
    ``D`` (its BN): 128 up to D = 128, 64 at D = 256, where Q and two K and
    V stages must fit the 227 KB of shared memory.  B4's bf16 P is rounded
    per tile against the running max, so the plain version walks the same
    tiles (B4-window and B4-bool too).  With a bias (B4-float) or FP4
    rounding (B4-fp4, whose scale is each tile's row max, as JAX's 64-wide
    tiles take it) the kernel walks ``KV_TILE``."""
    return 128 if D <= 128 else 64


def _plain_kv_tile(cfg: AttnConfig, rows: int, D: int) -> int:
    """The kv tile of the kernel that runs ``cfg``, which the plain
    version's online softmax walks: ``flash_kv_tile(D)`` on
    ``flash_sm90.cu`` but for its bias and FP4 forms, else ``KV_TILE``."""
    if flash_sm90_route(cfg, rows, D) and cfg.masked != "float" and not cfg.p_sim_fp4:
        return flash_kv_tile(D)
    return KV_TILE


SM90_SLICE = 64       # query rows of a warpgroup of the Hopper forwards: a tile class each
SM90_KV_TILE = 128    # kv columns of a tile of attention_sm90.cu


def sm90_block_rows(D: int, cfg: AttnConfig | None = None) -> int:
    """Query rows of one block of ``flash_sm90.cu`` and
    ``attention_sm90.cu`` at head dim ``D``: three 64-row warpgroups at D =
    64, two above; with a bool mask (``cfg.masked == "bool"``) two at D = 64
    too, so that a 128 x 128 block-sparse mask's rows share a block's list
    of live tiles (three warpgroups' 192 rows walk two mask rows' union)."""
    if D == 64 and not (cfg is not None and cfg.masked == "bool"):
        return 3 * SM90_SLICE
    return 2 * SM90_SLICE


def _classes(dead, full):
    """0 where ``dead``, 2 where ``full``, 1 between (uint8)."""
    return torch.where(dead, 0, torch.where(full, 2, 1)).to(torch.uint8)


def tile_classes(cfg: AttnConfig, Sq: int, Sk: int, bn: int, q_segments=None,
                 kv_segments=None, kv_segpos=None, attn_mask=None,
                 device=None) -> torch.Tensor:
    """``[B|1, Hm|1, ceil(Sq/64), ceil(Sk/bn)]`` uint8: for each 64-row query
    slice and ``bn``-column kv tile, 0 where the masks keep no score of the
    pair, 2 where they keep every score (no mask to apply), 1 or 3 between:
    3 where only the rows' and columns' positions cut the pair (the kv
    tail, causal, the band and global sinks: the kernels mask it from
    arithmetic alone), 1 where segment ids, per-segment sinks or the bool
    mask's bytes must be read.  One class per mask, then the plain version's
    rule over them: the kv tail and causal, the window band or its sinks,
    segments (the ids' ranges of :func:`segment_tile_ranges`; per-segment
    sinks from :func:`segment_sink_tiles`), the bool mask
    (:func:`mask_tile_table`'s 64x64 table, two of its tiles a 128-column
    one); the least class of what must hold, the greatest of the band and
    its sinks.  A class short of exact is partly live (its masks are applied
    per element).  On ``device`` (by default the CPU)."""
    dev = device
    kv_len = cfg.kv_len or Sk
    n64, nkt = -(-Sq // SM90_SLICE), -(-Sk // bn)
    r0 = torch.arange(n64, device=dev)[:, None] * SM90_SLICE
    rl = torch.clamp_max(r0 + SM90_SLICE - 1, Sq - 1)
    k0 = torch.arange(nkt, device=dev)[None, :] * bn
    k1 = k0 + bn - 1
    c = _classes(k0 >= kv_len, k1 < kv_len).expand(n64, nkt)
    if cfg.causal:
        c = torch.minimum(c, _classes(k0 > rl, k1 <= r0))
    data = torch.zeros((), dtype=torch.bool, device=dev)   # a cut only data can say
    if cfg.window:
        W = cfg.window
        band = _classes(k1 < r0 - (W - 1), k0 >= rl - (W - 1))
        if cfg.sinks and cfg.segmented:
            held = segment_sink_tiles(kv_segpos, cfg.sinks, bn)[:, None, :]   # [B, 1, nkt]
            data = (held == 1) & (band < 2)         # kv_segpos decides within the tile
            band = torch.maximum(band, held)        # a sink tile: partly live at most
        elif cfg.sinks:
            band = torch.maximum(band, _classes(k0 >= cfg.sinks, k1 < cfg.sinks))
        c = torch.minimum(c, band)
    c, data = c.reshape((-1, 1) + c.shape[-2:]), data.reshape((-1, 1) + data.shape[-2:])
    if cfg.segmented:
        qr = segment_tile_ranges(q_segments, SM90_SLICE)[:, :, None]   # [B, n64, 1, 2]
        kr = segment_tile_ranges(kv_segments, bn)[:, None]              # [B, 1, nkt, 2]
        qlo, qhi, klo, khi = qr[..., 0], qr[..., 1], kr[..., 0], kr[..., 1]
        seg = _classes((qhi < klo) | (qlo > khi), (qlo == qhi) & (klo == khi) & (qlo == klo))
        c, data = torch.minimum(c, seg[:, None]), data | (seg[:, None] == 1)
    if cfg.masked == "bool":
        t = mask_tile_table(attn_mask)                       # [B, Hm, n64, ceil(Sk/64)]
        per = bn // KV_TILE
        pad = nkt * per - t.shape[-1]
        lo = torch.nn.functional.pad(t, (0, pad), value=0).view(*t.shape[:3], nkt, per)
        hi = torch.nn.functional.pad(t, (0, pad), value=2).view(*t.shape[:3], nkt, per)
        tb = _classes(lo.amax(-1) == 0, hi.amin(-1) == 2)
        c, data = torch.minimum(c, tb), data | (tb == 1)
    return torch.where((c == 1) & ~data, 3, c).to(torch.uint8).contiguous()


def tile_list(classes: torch.Tensor, nwg: int):
    """The blocks' walks of ``nwg`` 64-row slices each, from ``classes``
    (:func:`tile_classes`): ``(tiles [B', H', n_blocks, nkt] int32, counts
    [B', H', n_blocks] int32)``.  Row ``tiles[..., i, :]`` holds, first and
    in order, the ``counts[..., i]`` kv tiles where some slice of block i is
    live, each entry the tile's index in its low 24 bits and slice w's
    class in bits ``24 + 2 w`` (the kernels' ``mask_sm90.cuh``)."""
    Bl, Hl, n64, nkt = classes.shape
    nb = -(-n64 // nwg)
    c = torch.nn.functional.pad(classes, (0, 0, 0, nb * nwg - n64)).view(Bl, Hl, nb, nwg, nkt)
    c = c.to(torch.int32)
    packed = torch.arange(nkt, dtype=torch.int32, device=c.device).expand(Bl, Hl, nb, nkt)
    for w in range(nwg):
        packed = packed | (c[:, :, :, w] << (24 + 2 * w))
    live = (c > 0).any(3)
    order = torch.argsort((~live).to(torch.int32), dim=-1, stable=True)
    return (packed.gather(-1, order).contiguous(),
            live.sum(-1, dtype=torch.int32).contiguous())


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


def _check_fp4(cfg: AttnConfig) -> None:
    """``p_sim_fp4`` (B4-fp4, the SageAttention3 simulation of
    ``ops/lowbit.py``) runs on the bf16 flash base only, under the online
    softmax, causal or not, with a static ``kv_len``.  Every other base
    raises: JAX asserts against the static softmax and ``kv_split``, and
    silently ignores the flag on an int8 or e4m3 P; the port refuses those
    too, rather than run something other than what was asked."""
    if cfg.quantized:
        raise ValueError("p_sim_fp4 rounds the bf16 P of the flash base (quantized=False)")
    if cfg.softmax_mode != "online":
        raise ValueError("p_sim_fp4 needs the online softmax: P is rounded against its "
                         "tile's row max")
    if cfg.kv_split != 1 or cfg.causal_row_mod or cfg.kv_len_dynamic or cfg.causal_dynamic:
        raise ValueError("p_sim_fp4 composes with no kv_split, folded rows or dynamic "
                         "lengths and offsets")
    if _extended(cfg):
        raise ValueError("p_sim_fp4 composes with no masks, segments, window or row K scales")


def _base_name(cfg: AttnConfig) -> str:
    static = cfg.softmax_mode == "static"
    if not cfg.quantized:
        if static:
            raise ValueError("static softmax needs the quantized payload bounds")
        return "B4-fp4" if cfg.p_sim_fp4 else "B4"
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


def config_name(cfg: AttnConfig, rows: int) -> str:
    """The port's launch key for ``cfg`` over ``rows`` query rows: the base configuration (B1-B6) and the suffixes of
    its B7-B9 options, B10's prefix and suffixes, B11's key, or B4-fp4;
    raises ``ValueError`` for a combination the kernel does not take."""
    if cfg.p_sim_fp4:
        _check_fp4(cfg)
    if cfg.layout != "HND":
        raise ValueError("attention_call operates in HND; transpose first")
    if is_decode(cfg, rows):
        return _decode_name(cfg)
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
    if is_ring(cfg, rows):
        if not cfg.quantized or cfg.fuse_q_quant:
            raise ValueError("the ring configuration (B10) takes a pre-quantized Q "
                             "(int8 codes with q_scale)")
        if _extended(cfg):
            raise ValueError("the ring configuration (B10) composes with no masks, "
                             "segments, window or row K scales")
        if cfg.causal_dynamic and not cfg.causal:
            raise ValueError("causal_dynamic needs causal")
        name = "B10-" + name + ("-offsets" if cfg.causal_dynamic else "") + (
            "-kvtrue" if cfg.kv_len_dynamic else "")
    return name


def _launch_configs():
    """``(cfg, rows)`` over the combinations of the fields that name a
    configuration, valid or not: over one query tile (prefill-sized), with
    the ring's dynamic fields on a pre-quantized Q, and, for the decode
    configuration, over ``DECODE_ROWS`` rows."""
    for quantized, pv, cd, sm, fqq, fold, via, krows, masked, seg, window in itertools.product(
            (True, False), ("int8", "fp8", "bf16"), ("native", "bf16"), ("static", "online"),
            (True, False), (True, False), (False, True), (False, True),
            ("none", "bool", "float"), (False, True), (0, 1)):
        cfg = AttnConfig(causal=True, quantized=quantized, pv_dtype=pv, compute_dtype=cd,
                         softmax_mode=sm, fuse_q_quant=fqq, fold_k_scale=fold,
                         pv_via_bf16=via, fuse_k_rows=krows, masked=masked, segmented=seg,
                         window=window)
        yield cfg, Q_TILE
        if _extended(cfg) or not quantized or fqq:
            continue
        for dyn_causal, dyn_len in ((True, False), (False, True), (True, True)):
            yield dataclasses.replace(cfg, causal_dynamic=dyn_causal,
                                      kv_len_dynamic=dyn_len), Q_TILE
    yield AttnConfig(quantized=False, p_sim_fp4=True), Q_TILE
    for pv, causal, mod in itertools.product(("int8", "fp8", "bf16"), (False, True), (0, 2)):
        if mod and not causal:
            continue
        yield AttnConfig(quantized=True, pv_dtype=pv, fuse_q_quant=True, kv_len_dynamic=True,
                         causal=causal, causal_dynamic=causal, causal_row_mod=mod), DECODE_ROWS


def _launch_keys() -> tuple:
    """Every key :func:`config_name` gives: the key of each valid
    combination :func:`_launch_configs` walks, in its order."""
    keys = {}
    for cfg, rows in _launch_configs():
        try:
            keys.setdefault(config_name(cfg, rows))
        except ValueError:
            pass
    return tuple(keys)


LAUNCH_KEYS = _launch_keys()


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


_E2M1_GRID = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
_E2M1_MIDS = (0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0)


def _round_e2m1_tile(p, pmax):
    """``p`` rounded onto the e2m1 grid {0, .5, 1, 1.5, 2, 3, 4, 6} at scale
    ``pmax / 6`` per row (the JAX kernel's ``_round_e2m1_tile``): strict
    ``>`` at each midpoint, so a tie rounds down; ``p >= 0``."""
    scale = torch.clamp_min(pmax, 1e-30) * _F32(1.0 / 6.0)
    x = p / scale
    q = torch.zeros_like(x)
    for g, mid in zip(_E2M1_GRID[1:], _E2M1_MIDS):
        q = torch.where(x > mid, g, q)
    return q * scale


def _p_tile(st, m_next, p_mode):
    """P of one online kv tile and its contribution to l.  ``"fp4"``
    rounds the bf16 P to e2m1 against its tile's row maximum (taken before
    the ``M_CLAMP`` floor), and l sums the rounded P."""
    if p_mode == "bf16":
        p = torch.exp2(st - m_next)
        return p.to(torch.bfloat16).float(), p.sum(dim=-1, keepdim=True)
    if p_mode == "fp4":
        pmax = torch.exp2(st.amax(dim=-1, keepdim=True) - m_next)
        p = _round_e2m1_tile(torch.exp2(st - m_next), pmax)
        return p.to(torch.bfloat16).float(), p.sum(dim=-1, keepdim=True)
    if p_mode == "int8":
        p = torch.round(torch.exp2((st - m_next) + _F32(INT8_P_OFFSET_LOG2)))
        return p, p.sum(dim=-1, keepdim=True) * _F32(1.0 / 127.0)
    p = torch.exp2((st - m_next) + _F32(FP8_OFFSET_LOG2)).to(torch.float8_e4m3fn).float()
    return p, p.sum(dim=-1, keepdim=True)


def _dynamic(cfg, ext):
    """``(shift, kv_len)``: ``q_start - kv_start`` of the ring's device
    offsets (0 without them), and the kv length, cut at the device true
    length under ``kv_len_dynamic``.  Read on the host: the plain version
    only."""
    kv_len = cfg.kv_len or ext["Sk"]
    if cfg.kv_len_dynamic:
        kv_len = max(0, min(kv_len, int(ext["kv_true"].reshape(-1)[0])))
    shift = 0
    if cfg.causal and cfg.causal_dynamic:
        q_start, kv_start = (int(x) for x in ext["offsets"].reshape(-1)[:2])
        shift = q_start - kv_start
    return shift, kv_len


def _col_hi(cfg, ext, r1):
    """Columns past which every score of the rows before ``r1`` is masked."""
    shift, kv_len = _dynamic(cfg, ext)
    return min(kv_len, max(0, r1 + shift)) if cfg.causal else kv_len


def _keep_mask(cfg, rows, cols, r0, r1, hi, ext):
    """True where a score of query rows ``rows`` (``[r1-r0, 1]``) and kv
    columns ``cols[:hi]`` survives the kv tail, causal, window, segment and
    bool masks; ``[B|1, Hm|1, r1-r0, hi]``."""
    c = cols[None, :hi]
    shift, kv_len = _dynamic(cfg, ext)
    keep = c < kv_len
    if cfg.causal:
        keep = keep & (c <= rows + shift)
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
                    q_segments=None, kv_segments=None, kv_segpos=None, attn_mask=None,
                    offsets=None, kv_true=None):
    """Plain PyTorch version of the kernel: the same quantization points,
    exact int8 QK^T (an f32 product of int8 codes is exact for D <= 256 with
    TF32 off), P summed into l as the kernel rounds it (unrounded f32 for a
    bf16 P, the codes for int8/e4m3 P), P times V with f32 sums, and the
    online softmax over the kernel's kv tiles (:func:`_plain_kv_tile`: 64
    columns, or ``flash_kv_tile(D)`` on ``flash_sm90.cu``).  A kv tile that
    the kernel skips (dead under a mask or below a window) holds only masked
    scores here, which changes no running sum, so both agree exactly.
    ``q_segments [B,Sq]``, ``kv_segments``/``kv_segpos [B,Sk]``,
    ``attn_mask [B,Hm,Sq,Sk]`` (bool keep-mask or float bias); B10's
    ``offsets`` (q_start, kv_start) and ``kv_true`` int32 tensors.

    Returns ``(out [B,Hq,Sq,D], lse_base2 [B,Hq,Sq] | None, lmin | None)``."""
    B, Hq, Sq, D = q.shape
    name = config_name(cfg, Sq)
    Sk = k.shape[2]
    static = cfg.softmax_mode == "static"
    p_mode = "fp4" if cfg.p_sim_fp4 else "bf16" if cfg.p_bf16 else cfg.pv_dtype
    tile = _plain_kv_tile(cfg, Sq, D)   # the kernel's kv tile
    qop, qse, cap = _prepare_q(q, cfg, name, k_head_scale, kn_max, q_scale)
    kf = _per_q_head(k, Hq).float()
    vf = _per_q_head(_v_operand(v, cfg.pv_dtype if cfg.quantized else "bf16"), Hq)
    ksc = None if k_scale is None else _per_q_head(k_scale.float(), Hq)   # [B,Hq,1,Sk]
    fold = _F32(cfg.sm_scale * LOG2E)
    ext = dict(Sk=Sk, q_segments=q_segments, kv_segments=kv_segments,
               kv_segpos=kv_segpos, attn_mask=attn_mask, offsets=offsets, kv_true=kv_true)
    # query rows per step: keep the [B, Hq, rows, Sk] f32 scores near 512 MB
    chunk = max(Q_TILE, (2 ** 27 // max(1, B * Hq * Sk)) // Q_TILE * Q_TILE)
    cols = torch.arange(Sk, device=q.device)
    outs, ms, ls = [], [], []
    with _no_tf32():
        for r0 in range(0, Sq, chunk):
            r1 = min(Sq, r0 + chunk)
            rows = torch.arange(r0, r1, device=q.device)[:, None]
            hi = _col_hi(cfg, ext, r1)  # cols past it are all masked
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
                for c0 in range(0, hi, tile):
                    st = s[..., c0:c0 + tile]
                    m_next = torch.clamp_min(
                        torch.maximum(m, st.amax(dim=-1, keepdim=True)), M_CLAMP)
                    alpha = torch.exp2(m - m_next)
                    p, l_cur = _p_tile(st, m_next, p_mode)
                    l = alpha * l + l_cur
                    acc = acc * alpha + torch.matmul(p, vf[:, :, c0:c0 + st.shape[-1]])
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
    mask: each column's keeps over a tile's ``bq`` rows (``bq`` < 256, a
    byte each: summed 8 columns a word where the mask's layout lets it be
    read as int64, since no byte lane can carry), then the least and
    greatest count over the tile's ``bk`` columns."""
    m = (attn_mask if attn_mask.dtype == torch.bool else attn_mask != 0).view(torch.uint8)
    B, Hm, Sq, Sk = m.shape
    nq_full, nk_full = Sq // bq, Sk // bk
    counts = []
    if nq_full:
        x = m.narrow(2, 0, nq_full * bq).unflatten(2, (nq_full, bq))
        try:
            counts.append(x.view(torch.int64).sum(3).view(torch.uint8))
        except RuntimeError:   # a layout that an 8-byte view cannot read
            counts.append(x.sum(3, dtype=torch.int32).to(torch.uint8))
    if Sq % bq:   # a tile cut by the mask's last row is never full: count at most bq - 1
        counts.append(m.narrow(2, nq_full * bq, Sq % bq).sum(2, keepdim=True, dtype=torch.int32)
                      .to(torch.uint8))
    c = torch.cat(counts, 2)                            # [B, Hm, nq, Sk]
    lo, hi = [], []
    if nk_full:
        a, b = torch.aminmax(c.narrow(3, 0, nk_full * bk).unflatten(3, (nk_full, bk)), dim=4)
        lo.append(a)
        hi.append(b)
    if Sk % bk:   # a tile cut by the mask's edge is never full
        hi.append(c.narrow(3, nk_full * bk, Sk % bk).amax(3, keepdim=True))
        lo.append(torch.zeros_like(hi[-1]))
    lo, hi = torch.cat(lo, 3), torch.cat(hi, 3)
    return ((hi > 0).to(torch.uint8) + (lo == bq).to(torch.uint8)).contiguous()


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
                     q_segments=None, kv_segments=None, kv_segpos=None, attn_mask=None,
                     offsets=None, kv_true=None):
    """Launch the kernel for ``cfg`` on CUDA tensors: ``csrc/flash_sm90.cu``
    (the unmasked, windowed, bool-masked, biased and FP4 flash,
    :func:`flash_sm90_route`), ``csrc/attention_sm90.cu`` (B1, its window,
    bool and segment forms, and the fused-Q B-pvbf16 on a bf16 Q,
    :func:`b1_sm90_route`), ``csrc/attention_q8_sm90.cu`` (B6, B5-fp8,
    B-pvbf16 and their B10 forms, :func:`q8_sm90_route`),
    ``csrc/attention.cu`` (fused Q) or ``attention_q8.cu`` (pre-quantized
    Q), and their ``*_ext.cu`` builds for the B7-B9 options (masked flash
    too); same arguments and returns as :func:`attention_plain`.  B10's
    offsets and true length stay on the device: the kernel reads them."""
    B, Hq, Sq, D = q.shape
    name = config_name(cfg, Sq)
    _, Hk, Sk, _ = k.shape
    if D not in (64, 128, 256):
        raise ValueError(f"the attention kernel takes head_dim 64/128/256 (pad first), got {D}")
    if flash_sm90_route(cfg, Sq, D):
        out, lse = _flash_sm90(q, k, v, cfg, v_mean, attn_mask)
        attention_call.launches[name] += 1
        if out.dtype != cfg.out_dtype:
            out = out.to(cfg.out_dtype)
        return out, lse, None
    if b1_sm90_route(cfg, Sq, D, q.dtype):
        out, lse, lmin = _b1_sm90(q, k, v, cfg, k_head_scale, kn_max, v_scale, v_mean, k_scale,
                                  q_segments, kv_segments, kv_segpos, attn_mask)
        attention_call.launches[name] += 1
        if out.dtype != cfg.out_dtype:
            out = out.to(cfg.out_dtype)
        return out, lse, lmin
    if q8_sm90_route(cfg, Sq, D, q.dtype):
        out, lse = _q8_sm90(q, k, v, cfg, kn_max, v_scale, v_mean, q_scale, k_scale,
                            offsets, kv_true)
        attention_call.launches[name] += 1
        if out.dtype != cfg.out_dtype:
            out = out.to(cfg.out_dtype)
        return out, lse, None
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
    offs = (offsets.reshape(-1)[:2].to(torch.int32).contiguous()
            if cfg.causal and cfg.causal_dynamic else None)
    kvt = kv_true.reshape(-1)[:1].to(torch.int32).contiguous() if cfg.kv_len_dynamic else None
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    qmode = 2 if not cfg.quantized else (1 if cfg.compute_dtype == "bf16" else 0)
    args = [qmode, int(static), pv, in_dtype, 0 if out_dtype == torch.bfloat16 else 1, D,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            ptr(qs), ptr(ks), ptr(head_scale), ptr(knm), ptr(vs), ptr(vm), ptr(lse), ptr(lmin),
            B, Hq, Hk, Sq, Sk, cfg.kv_len or Sk, int(cfg.causal), _F32(cfg.sm_scale * LOG2E)]
    fn = "sage_attn_fwd" if in_dtype != 2 else "sage_attn_fwd_q8"
    if is_ring(cfg, Sq):
        fn = "sage_attn_fwd_ring"
        args += [ptr(offs), ptr(kvt)]
    elif _extended(cfg):
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


def _tma_operand(x):
    """``x`` (in bf16 unless it is int8 codes) as a tensor map takes it:
    :func:`_build.vector_aligned` and no zero stride over a dimension longer
    than 1 (an expanded view)."""
    x = _build.vector_aligned(x if x.dtype == torch.int8 else x.to(torch.bfloat16))
    if any(st == 0 and n > 1 for st, n in zip(x.stride(), x.shape)):
        return x.contiguous()
    return x


def _tma_bias(m):
    """The float bias ``[B, Hm, Sq, Sk]`` in f32 as a tensor map takes it:
    itself where its base and its batch, head and row strides (in bytes)
    are multiples of 16, a zero batch or head stride included (a broadcast
    bias is never expanded); else a copy whose rows are padded to a
    multiple of 4 floats, of the batches and heads it holds."""
    m = m.float()
    B, Hm, Sq, Sk = m.shape
    sb, sh, ss = (m.stride(i) for i in range(3))
    bb, hb = B > 1 and sb == 0, Hm > 1 and sh == 0   # broadcast over batch / heads
    if (m.stride(3) == 1 and m.data_ptr() % 16 == 0 and (Sq == 1 or (ss % 4 == 0 and ss >= Sk))
            and (B == 1 or bb or sb % 4 == 0) and (Hm == 1 or hb or sh % 4 == 0)):
        return m
    src = m[:1 if bb else B, :1 if hb else Hm]
    buf = torch.empty(src.shape[:3] + (-(-Sk // 4) * 4,), dtype=torch.float32,
                      device=m.device)[..., :Sk]
    buf.copy_(src)
    return buf.expand(B, Hm, Sq, Sk)


_NO_MASK_ARGS = (None, None, 0, 0, 0, 0, None, 0, 0, 0, 0)


def _mask_args(cfg, Sq, Sk, bn, D, q_segments, kv_segments, kv_segpos, attn_mask, device):
    """The masked forms' launch arguments of ``flash_sm90.cu`` and
    ``attention_sm90.cu`` (``_build._TILE_ARGS``): the blocks' tile lists
    and their lengths (:func:`tile_list` over :func:`tile_classes` at ``bn``
    columns and the kernel's blocks), the list's row length, whether it
    steps over batch and heads, the block rows (:func:`sm90_block_rows`),
    and the bool mask (its bytes as int8, read in place: no alignment
    needed, a copy only for a column stride other than 1), its strides and
    whether it steps over heads; then the tensors to hold until the
    launch."""
    m = keep = None
    if cfg.masked == "bool":
        keep = attn_mask if attn_mask.dtype == torch.bool else attn_mask != 0
        if keep.stride(-1) != 1:
            keep = keep.contiguous()
        m = keep.view(torch.int8)
    cls = tile_classes(cfg, Sq, Sk, bn, q_segments, kv_segments, kv_segpos, keep, device)
    bm = sm90_block_rows(D, cfg)
    tiles, counts = tile_list(cls, bm // SM90_SLICE)
    margs = ((None, 0, 0, 0, 0) if m is None else
             (m.data_ptr(), *m.stride()[:3], int(m.shape[1] > 1)))
    args = (tiles.data_ptr(), counts.data_ptr(), tiles.shape[-1], int(tiles.shape[0] > 1),
            int(tiles.shape[1] > 1), bm, *margs)
    return args, (tiles, counts, m)


def _flash_sm90(q, k, v, cfg, v_mean, attn_mask=None):
    """Launch ``csrc/flash_sm90.cu`` (B4, B4-window, B4-bool, B4-float and
    B4-fp4 on :func:`flash_sm90_route`): ``(out bf16, lse_base2 | None)``.
    Any strides with a unit column stride load as they are (HND, NHD,
    sliced heads); ``attn_mask`` is B4-float's bias (see :func:`_tma_bias`)
    or B4-bool's keep-mask (see :func:`_mask_args`).  The entry takes the
    mode (2: FP4, 3: the MASKED walk of a window or a bool mask) and the
    plain version's kv tile."""
    if v_mean is not None:
        raise ValueError("the flash kernel takes no v_mean")
    if not cfg.sm_scale > 0:
        raise ValueError(f"the flash kernel takes sm_scale > 0, got {cfg.sm_scale}")
    B, Hq, Sq, D = q.shape
    _, Hk, Sk, _ = k.shape
    q, k, v = (_tma_operand(x) for x in (q, k, v))
    out = torch.empty((B, Hq, Sq, D), dtype=torch.bfloat16, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if cfg.emit_lse else None)
    tile, bias_args, mode = _plain_kv_tile(cfg, Sq, D), (None, 0, 0, 0, 1), 0
    mask_args, held = _NO_MASK_ARGS, None
    if cfg.masked == "float":
        bias = _tma_bias(attn_mask)
        bias_args = (bias.data_ptr(), *bias.stride()[:3], bias.shape[1])
    elif _extended(cfg):
        mode = 3
        mask_args, held = _mask_args(cfg, Sq, Sk, tile, D, None, None, None, attn_mask,
                                     q.device)
    elif cfg.p_sim_fp4:
        mode = 2
    _build.call("sage_flash_fwd", q.device, D, tile, mode, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), out.data_ptr(), *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], *out.stride()[:3], *bias_args,
                None if lse is None else lse.data_ptr(),
                B, Hq, Hk, Sq, Sk, cfg.kv_len or Sk, int(cfg.causal),
                _F32(cfg.sm_scale * LOG2E), *mask_args, cfg.window, cfg.sinks)
    return out, lse


def widen_v_codes(v):
    """B1's and B6's int8 V codes in bf16 (exact), the B operand of the PV
    product of ``csrc/attention_sm90.cu`` and ``attention_q8_sm90.cu``: one
    elementwise pass per call (per ring step for B10), its own line in
    ``tools/port_ab.py``'s breakdown; ``v_scale`` stays in the kernel's
    epilogue.  B-pvbf16's V is bf16 already and takes no pass."""
    return v.to(torch.bfloat16)


V_T_GROUP = 16   # kv rows of V^T whose order follows the e4m3 P fragments


def transpose_v_codes(v):
    """B5-fp8's e4m3 V codes ``[B, H, Sk, D]`` as the B operand of its e4m3
    PV product on ``csrc/attention_q8_sm90.cu``: V^T ``[B, H, D, Sk padded
    to 16]``, contiguous, zero codes in the padding, the codes themselves
    (e4m3, no rounding).  An 8-bit wgmma takes B K-major only, so the kv
    axis must be contiguous; within each group of 16 kv rows, slot
    ``4 t + 2 h + e`` holds kv row ``8 h + 2 t + e`` (t < 4, h, e < 2), the
    order in which the kernel's P fragments hold their columns (each thread
    packs its columns ``2 t, 2 t + 1, 8 + 2 t, 9 + 2 t`` into one register),
    so the product sums the same (P, V) pairs.  One pass per call (per ring
    step for B10), its own line in ``tools/port_ab.py``'s breakdown."""
    B, H, S, D = v.shape
    Sp = -(-S // V_T_GROUP) * V_T_GROUP
    u = v.view(torch.uint8)
    if Sp != S:
        u = torch.nn.functional.pad(u, (0, 0, 0, Sp - S))
    out = torch.empty((B, H, D, Sp), dtype=torch.uint8, device=v.device)
    # source [B, H, group, h, t, e, D] -> [B, H, D, group, t, h, e]
    out.view(B, H, D, Sp // V_T_GROUP, 4, 2, 2).copy_(
        u.reshape(B, H, Sp // V_T_GROUP, 2, 4, 2, D).permute(0, 1, 6, 2, 4, 3, 5))
    return out.view(v.dtype)


def _b1_sm90(q, k, v, cfg, k_head_scale, kn_max, v_scale, v_mean, k_scale=None,
             q_segments=None, kv_segments=None, kv_segpos=None, attn_mask=None):
    """Launch ``csrc/attention_sm90.cu`` (B1, its masked forms and B-pvbf16
    on :func:`b1_sm90_route`): ``(out bf16, lse_base2 | None, lmin)``.
    ``q`` bf16 with any strides of unit column stride, ``k`` int8 codes,
    ``v`` int8 codes (B1) or float (B-pvbf16: rounded to bf16, its null
    ``v_scale`` selects the kernel's bf16-V form), the scales, segment ids
    and mask as :func:`attention_call` takes them (``-colk``: per-column
    ``k_scale`` and no ``k_head_scale``, see :func:`_tma_cols`)."""
    bf16_v = cfg.pv_dtype == "bf16"
    if k.dtype != torch.int8 or (v.dtype == torch.int8) == bf16_v:
        raise TypeError("B1 takes int8 K and V codes, B-pvbf16 int8 K codes and a float V")
    if not cfg.sm_scale > 0:
        raise ValueError(f"B1's kernel takes sm_scale > 0, got {cfg.sm_scale}")
    B, Hq, Sq, D = q.shape
    _, Hk, Sk, _ = k.shape
    q, k = _tma_operand(q), _tma_operand(k)
    vb = _tma_operand(v if bf16_v else widen_v_codes(v))
    out = torch.empty((B, Hq, Sq, D), dtype=torch.bfloat16, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if cfg.emit_lse else None)
    lmin = torch.empty((B, Hq, -(-Sq // Q_TILE)), dtype=torch.float32, device=q.device)
    # contiguous f32 copies, each held by a name until the launch
    ks = None if k_head_scale is None else k_head_scale.float().reshape(B * Hk).contiguous()
    knm = _per_q_head(kn_max.float().reshape(B, -1, 1, 1), Hq).reshape(B * Hq).contiguous()
    vs = None if bf16_v else v_scale.float().reshape(B * Hk * D).contiguous()
    vm = None if v_mean is None else v_mean.float().reshape(B * Hk * D).contiguous()
    kc = None if k_scale is None else _tma_cols(k_scale.float().reshape(B, Hk, Sk))
    kc_args = (None, 0, 0, 1) if kc is None else (kc.data_ptr(), *kc.stride()[:2], Sk)
    mask_args, held = _NO_MASK_ARGS, None
    if _extended(cfg):
        mask_args, held = _mask_args(cfg, Sq, Sk, SM90_KV_TILE, D, q_segments, kv_segments,
                                     kv_segpos, attn_mask, q.device)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    _build.call("sage_attn_fwd_sm90", q.device, D, q.data_ptr(), k.data_ptr(), vb.data_ptr(),
                out.data_ptr(), *q.stride()[:3], *k.stride()[:3], *vb.stride()[:3],
                *out.stride()[:3], ptr(ks), knm.data_ptr(), ptr(vs), ptr(vm), ptr(lse),
                lmin.data_ptr(), B, Hq, Hk, Sq, Sk, cfg.kv_len or Sk, int(cfg.causal),
                _F32(cfg.sm_scale * LOG2E), *kc_args, *mask_args, ptr(q_segments),
                ptr(kv_segments), ptr(kv_segpos), cfg.window, cfg.sinks)
    return out, lse, lmin


def _tma_cols(x):
    """Per-column K scales ``[B, Hk, Sk]`` in f32 as a tensor map takes
    them: itself where its base and its batch and head strides are nonzero
    16-byte multiples with a unit column stride; else a copy whose rows are
    padded to a multiple of 4 floats (the map's zero fill covers the
    tail)."""
    B, Hk, Sk = x.shape
    aligned = lambda n, st: n == 1 or (st > 0 and st % 4 == 0)  # noqa: E731
    if (x.stride(2) == 1 and x.data_ptr() % 16 == 0 and aligned(Hk, x.stride(1))
            and aligned(B, x.stride(0))):
        return x
    buf = torch.zeros((B, Hk, -(-Sk // 4) * 4), dtype=torch.float32, device=x.device)
    buf[..., :Sk] = x
    return buf[..., :Sk]


def _q8_sm90(q, k, v, cfg, kn_max, v_scale, v_mean, q_scale, k_scale, offsets, kv_true):
    """Launch ``csrc/attention_q8_sm90.cu`` (B6, B5-fp8, B-pvbf16 and their
    B10 forms on :func:`q8_sm90_route`): ``(out, lse_base2 | None)``, out
    in bf16 (B-pvbf16: ``cfg.out_dtype``, bf16 or fp16).  ``q`` int8 codes
    and ``k`` int8 codes with any strides of unit column stride, ``v`` int8
    codes (B6, widened by :func:`widen_v_codes`), e4m3 codes (B5-fp8,
    transposed by :func:`transpose_v_codes`) or float (B-pvbf16: rounded to
    bf16, no scale or mean), the scales as :func:`attention_call` takes
    them; B10's ``offsets`` and ``kv_true`` stay on the device."""
    base = _q8_base(cfg, q.shape[2])
    mode = Q8_SM90_BASES[base]
    bf16_v = mode >= 3
    vdt = torch.float8_e4m3fn if mode == 2 else torch.int8
    if (q.dtype != torch.int8 or k.dtype != torch.int8
            or (not torch.is_floating_point(v) if bf16_v else v.dtype != vdt)):
        raise TypeError(f"{base} takes int8 Q and K codes and "
                        f"{'a float V' if bf16_v else f'{vdt} V codes'}")
    B, Hq, Sq, D = q.shape
    _, Hk, Sk, _ = k.shape
    q, k = _tma_operand(q), _tma_operand(k)
    vb = (transpose_v_codes(v) if mode == 2 else
          _tma_operand(v if bf16_v else widen_v_codes(v)))
    out_f16 = bf16_v and cfg.out_dtype == torch.float16
    out = torch.empty((B, Hq, Sq, D), dtype=torch.float16 if out_f16 else torch.bfloat16,
                      device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if cfg.emit_lse else None)
    # contiguous f32 copies, each held by a name until the launch
    qs = q_scale.float().reshape(B, Hq, Sq).contiguous()
    ks = None if k_scale is None else _tma_cols(k_scale.float().reshape(B, Hk, Sk))
    knm = (_per_q_head(kn_max.float().reshape(B, -1, 1, 1), Hq).reshape(B * Hq).contiguous()
           if mode in (0, 3) else None)
    vs = None if bf16_v else v_scale.float().reshape(B * Hk * D).contiguous()
    vm = None if v_mean is None else v_mean.float().reshape(B * Hk * D).contiguous()
    offs = (offsets.reshape(-1)[:2].to(torch.int32).contiguous()
            if cfg.causal and cfg.causal_dynamic else None)
    kvt = kv_true.reshape(-1)[:1].to(torch.int32).contiguous() if cfg.kv_len_dynamic else None
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    ks_st = (0, 0) if ks is None else ks.stride()[:2]
    _build.call("sage_attn_fwd_q8_sm90", q.device, D, mode, q.data_ptr(),
                k.data_ptr(), vb.data_ptr(), out.data_ptr(), *q.stride()[:3], *k.stride()[:3],
                *vb.stride()[:3], *out.stride()[:3], qs.data_ptr(), ptr(ks), *ks_st, Sk,
                ptr(knm), ptr(vs), ptr(vm), ptr(lse), ptr(offs), ptr(kvt),
                B, Hq, Hk, Sq, Sk, cfg.kv_len or Sk, int(cfg.causal), int(out_f16))
    return out, lse


# ------------------------------------------------------------ decode (B11) ----
# The decode kernel (csrc/decode.cu) splits each sequence's live 64-token
# tiles into ``decode_splits`` contiguous shares, one block each, and merges
# the shares' (m, l, acc) exactly.  The plain versions below walk the same
# shares and tiles, so a quantized P is rounded against the same running
# maxima on both sides.

def decode_splits(B: int, Hk: int) -> int:
    """KV splits of one decode launch for ``B`` sequences of ``Hk`` KV heads:
    enough blocks for the card, at most ``DECODE_MAX_SPLITS``.  A function of
    these two only, so a result does not depend on the GQA fold or on the
    static bucket."""
    return max(1, min(DECODE_MAX_SPLITS, -(-DECODE_SPLIT_BLOCKS // (B * Hk))))


def split_online_plain(s, vf, p_mode, n_split, min_per=1):
    """Online softmax of one sequence over ``s [H, R, n*64]`` masked base-2
    scores and ``vf [H, n*64, D]``, walked in contiguous shares of
    ``max(min_per, ceil(n / n_split))`` 64-column tiles and merged exactly.
    Returns ``(m, l, acc)``."""
    H, R, n_tok = s.shape
    D = vf.shape[-1]
    n = n_tok // KV_TILE
    per = max(min_per, -(-n // n_split)) if n else 0
    parts = []
    for sp in range(n_split if n else 0):
        u0, u1 = sp * per, min(sp * per + per, n)
        if u0 >= u1:
            continue
        m = torch.full((H, R, 1), M_CLAMP, device=s.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((H, R, D), device=s.device)
        for u in range(u0, u1):
            st = s[..., u * KV_TILE:(u + 1) * KV_TILE]
            m_next = torch.clamp_min(torch.maximum(m, st.amax(dim=-1, keepdim=True)), M_CLAMP)
            alpha = torch.exp2(m - m_next)
            p, l_cur = _p_tile(st, m_next, p_mode)
            l = alpha * l + l_cur
            acc = acc * alpha + torch.matmul(p, vf[:, u * KV_TILE:(u + 1) * KV_TILE])
            m = m_next
        parts.append((m, l, acc))
    mg = torch.full((H, R, 1), M_CLAMP, device=s.device)
    for m, _, _ in parts:
        mg = torch.maximum(mg, m)
    l = torch.zeros_like(mg)
    acc = torch.zeros((H, R, D), device=s.device)
    for m, lp, ap in parts:
        w = torch.exp2(m - mg)
        l = l + w * lp
        acc = acc + w * ap
    return mg[..., 0], l[..., 0], acc


def decode_epilogue(m, l, acc, v_scale, vs_mul, v_mean):
    """``acc / l`` (l = 0 reads as 1), times ``v_scale * vs_mul``, plus
    ``v_mean``, as the merge launch computes it."""
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = acc * (1.0 / l_safe)[..., None]
    if v_scale is not None:
        o = o * (v_scale * vs_mul)
    if v_mean is not None:
        o = o + v_mean
    return o


def _row_quant(qf):
    """Per-row int8 codes and scales of ``qf`` (the kernel's fused Q)."""
    a = qf.abs().amax(dim=-1, keepdim=True)
    qs = torch.where(a > 0, a * _F32(1.0 / 127.0), torch.ones_like(a))
    return torch.clamp(torch.round(qf * (1.0 / qs)), -127, 127), qs


def _pad_rows(x, n, value=0.0):
    """``x [..., S, D]`` cut or zero-padded along S to ``n`` rows."""
    if x.shape[-2] >= n:
        return x[..., :n, :]
    return torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[-2]), value=value)


def decode_plain(q, k, v, cfg: AttnConfig, k_scale, v_scale, v_mean, kv_true, offsets):
    """Plain version of B11 on HND inputs: ``q [B,Hq,R,D]`` float, ``k
    [B,Hk,Sk,D]`` int8 codes with ``k_scale [B,Hk,1,Sk]``, ``v`` int8/e4m3
    codes or bf16, the true length ``kv_true`` and, for a causal window,
    ``offsets`` (q_start, kv_start).  Returns ``(out, lse_base2 | None)``."""
    B, Hq, R, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    G = Hq // Hk
    kv_len = max(0, min(int(kv_true.reshape(-1)[0]), Sk))
    hi = min(-(-Sk // KV_TILE), -(-kv_len // KV_TILE))
    n_tok = hi * KV_TILE
    n_split = decode_splits(B, Hk)
    p_mode = "bf16" if cfg.pv_dtype == "bf16" else cfg.pv_dtype
    q8, qs = _row_quant(q.float() * _F32(cfg.sm_scale * LOG2E))
    cols = torch.arange(n_tok, device=q.device)[None, :]
    keep = (cols < kv_len).expand(R, n_tok)
    if cfg.causal:
        q_start, kv_start = (int(x) for x in offsets.reshape(-1)[:2])
        rows = torch.arange(R, device=q.device)
        pos = q_start + (rows % cfg.causal_row_mod if cfg.causal_row_mod else rows)
        keep = keep & (cols + kv_start <= pos[:, None])
    vs_mul = _F32(1.0 / 127.0) if p_mode == "int8" else 1.0
    outs, lses = [], []
    with _no_tf32():
        for b in range(B):
            kb = _pad_rows(k[b].float(), n_tok).repeat_interleave(G, dim=0)
            ksb = torch.nn.functional.pad(k_scale[b, :, 0, :n_tok].float(),
                                          (0, n_tok - min(n_tok, Sk)), value=1.0)
            s = torch.matmul(q8[b], kb.transpose(-1, -2)) * qs[b]
            s = s * ksb.repeat_interleave(G, dim=0)[:, None, :]
            s = torch.where(keep, s, MASK_NEG)
            vb = _pad_rows(_v_operand(v[b], cfg.pv_dtype), n_tok).repeat_interleave(G, dim=0)
            m, l, acc = split_online_plain(s, vb, p_mode, n_split)
            vs = None if v_scale is None else _per_q_head(v_scale[b:b + 1].float(), Hq)[0]
            vm = None if v_mean is None else _per_q_head(v_mean[b:b + 1].float(), Hq)[0]
            outs.append(decode_epilogue(m, l, acc, vs, vs_mul, vm).to(cfg.out_dtype))
            lse = m + torch.log2(torch.clamp_min(l, 1e-37))
            lses.append(lse - _F32(FP8_OFFSET_LOG2) if p_mode == "fp8" else lse)
    return torch.stack(outs), (torch.stack(lses) if cfg.emit_lse else None)


_VKIND = {torch.int8: 0, torch.float8_e4m3fn: 1, torch.bfloat16: 2}


def decode_launch(*, paged, q, k, v, ks, lens, Hk, S,
                  n_units, n_split, fold=1.0, offsets=None, table=None, lpage=None,
                  win_lo=None, n_slots=0, page=0, causal=False, row_mod=0, row_base=0,
                  window_T=1,
                  sliding=False, sinks=0, sink_pages=0, v_scale=None, vs_mul=1.0,
                  v_mean=None, out_dtype=torch.bfloat16, lse_mode=0, lse_off=0.0):
    """Launch ``csrc/decode.cu`` (the split walk, then the merge) for ``q
    [B, Hg, R, D]`` over the dense cache or the pools ``k``, ``v`` (rows of
    ``D`` along the last axis) and the per-token K scales ``ks`` (tokens
    along the last axis); return ``(out [B, Hg, R, D], lse_base2 | None)``.
    ``row_base``: the first of these rows among a folded window's rows
    (their positions are ``q_start + (row_base + r) % row_mod``).
    Every length, offset and table stays on the device."""
    B, Hg, R, D = q.shape
    if D not in (64, 128, 256):
        raise ValueError(f"the decode kernel takes head_dim 64/128/256 (pad first), got {D}")
    if not 1 <= R <= DECODE_ROWS:
        raise ValueError(f"the decode kernel takes 1..{DECODE_ROWS} query rows, got {R}")
    if v.dtype not in _VKIND:
        raise TypeError(f"V codes must be int8, float8_e4m3fn or bfloat16, got {v.dtype}")
    if ks.stride(-1) != 1:
        raise ValueError("the per-token K scales need unit stride along the tokens")
    dev = q.device
    q32 = q.float().contiguous()
    k, v = _build.vector_aligned(k), _build.vector_aligned(v)
    vs, vm = _f32c(v_scale), _f32c(v_mean)
    per_batch = [x for x in (vs, vm) if x is not None and x.shape[0] > 1]
    vs_sb = Hk * D if per_batch else 0   # per-sequence (dense) or pool-global scales
    pm = torch.empty((B * Hg, n_split, R), dtype=torch.float32, device=dev)
    pl = torch.empty_like(pm)
    pacc = torch.empty((B * Hg, n_split, R, D), dtype=torch.float32, device=dev)
    out_f32 = out_dtype == torch.float32
    out = torch.empty((B, Hg, R, D), dtype=torch.float32 if out_f32 else torch.bfloat16,
                      device=dev)
    lse = torch.empty((B, Hg, R), dtype=torch.float32, device=dev) if lse_mode else None
    ints = [x if x is None else x.to(torch.int32).contiguous()
            for x in (lens, offsets, table, lpage, win_lo)]
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    _build.call("sage_decode", dev, int(paged), _VKIND[v.dtype], D, q32.data_ptr(),
                k.data_ptr(), v.data_ptr(), ks.data_ptr(), *k.stride()[:3], *v.stride()[:3],
                ks.stride(0), ks.stride(1),
                *(ptr(x) for x in ints), B, Hg, Hk, R, n_units, n_slots, page, S, int(causal),
                row_mod, row_base, window_T, int(sliding), sinks, sink_pages, n_split, _F32(fold),
                ptr(vs), ptr(vm), vs_sb, _F32(vs_mul), pm.data_ptr(), pl.data_ptr(),
                pacc.data_ptr(), out.data_ptr(), int(out_f32), ptr(lse), lse_mode,
                _F32(lse_off))
    if out.dtype != out_dtype:
        out = out.to(out_dtype)
    return out, lse


def decode_kernel(q, k, v, cfg: AttnConfig, k_scale, v_scale, v_mean, kv_true, offsets):
    """Launch B11 on CUDA tensors; same arguments and returns as
    :func:`decode_plain`."""
    name = config_name(cfg, q.shape[2])
    B, Hq, R, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    if k.dtype != torch.int8:
        raise TypeError("decode takes int8 K codes")
    if cfg.pv_dtype == "bf16":
        v = v.to(torch.bfloat16)
    elif v.dtype != _V_DTYPE[cfg.pv_dtype]:
        raise TypeError(f"pv_dtype={cfg.pv_dtype!r} takes {_V_DTYPE[cfg.pv_dtype]} V codes")
    fp8 = cfg.pv_dtype == "fp8"
    ks = k_scale.float()
    outs, lses = [], []
    # folded verify rows past DECODE_ROWS: one launch per 32-row tile, each
    # told where its rows start among the folded ones
    for r0 in range(0, R, DECODE_ROWS):
        out, lse = decode_launch(
            paged=False, q=q[:, :, r0:r0 + DECODE_ROWS], k=k, v=v, ks=ks,
            lens=kv_true.reshape(1), Hk=Hk, S=Sk, n_units=-(-Sk // KV_TILE),
            n_split=decode_splits(B, Hk), fold=cfg.sm_scale * LOG2E,
            offsets=offsets.reshape(-1) if cfg.causal else None, causal=cfg.causal,
            row_mod=cfg.causal_row_mod, row_base=r0, v_scale=v_scale,
            vs_mul=(1.0 / 127.0) if cfg.pv_dtype == "int8" else 1.0, v_mean=v_mean,
            out_dtype=cfg.out_dtype, lse_mode=1 if cfg.emit_lse else 0,
            lse_off=FP8_OFFSET_LOG2 if fp8 else 0.0)
        attention_call.launches[name] += 1
        outs.append(out)
        lses.append(lse)
    if len(outs) == 1:
        return outs[0], lses[0]
    return torch.cat(outs, dim=2), (torch.cat(lses, dim=2) if cfg.emit_lse else None)


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
    B, Hq, Sq, D = q.shape
    _, Hk, Sk, _ = k.shape
    config_name(cfg, Sq)
    if is_decode(cfg, Sq):
        return _decode_call(q, k, v, k_scale, v_scale, v_mean, kv_true_dyn, offsets,
                            cfg, q_scale, k_head_scale, kn_max, q_segments, attn_mask)
    if (offsets is not None) != (cfg.causal and cfg.causal_dynamic):
        raise ValueError("offsets (q_start, kv_start) are given iff causal and causal_dynamic")
    if (kv_true_dyn is not None) != cfg.kv_len_dynamic:
        raise ValueError("kv_true_dyn is given iff kv_len_dynamic")
    for arg, val in dict(offsets=offsets, kv_true_dyn=kv_true_dyn).items():
        if val is not None and val.device != q.device:
            raise ValueError(f"{arg} is on device {val.device}, the attention on {q.device}")
    if Hq % Hk or v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if cfg.causal and not cfg.causal_dynamic and Sq != Sk:
        raise ValueError("causal attention needs Sq == Sk (or dynamic offsets)")
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
               kv_segpos=_segment_ids(kv_segpos, B, Sk, "kv_segpos"), attn_mask=attn_mask,
               offsets=offsets, kv_true=kv_true_dyn)
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



def _decode_call(q, k, v, k_scale, v_scale, v_mean, kv_true, offsets, cfg,
                 q_scale, k_head_scale, kn_max, q_segments, attn_mask):
    """``attention_call`` in the decode configuration (B11): at most
    ``DECODE_ROWS`` query rows, or any number of folded verify-window rows
    (``causal_row_mod``), which the kernel takes 32 at a time."""
    B, Hq, Sq, D = q.shape
    _, Hk, Sk, _ = k.shape
    if Hq % Hk or v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if any(x is not None for x in (q_scale, k_head_scale, kn_max, q_segments, attn_mask)):
        raise ValueError("decode takes no q_scale, k_head_scale, kn_max, segments or mask")
    if k_scale is None or tuple(k_scale.shape) != (B, Hk, 1, Sk):
        raise ValueError("decode takes per-token K scales k_scale [B, Hk, 1, Sk]")
    if (cfg.pv_dtype != "bf16") != (v_scale is not None):
        raise ValueError("v_scale is given iff V is quantized (pv_dtype int8/fp8)")
    if cfg.fuse_v_mean != (v_mean is not None):
        raise ValueError("v_mean is given iff cfg.fuse_v_mean")
    if cfg.causal and offsets is None:
        raise ValueError("causal_dynamic needs offsets (q_start, kv_start)")
    if kv_true is None:
        if cfg.kv_len_dynamic:
            raise ValueError("kv_len_dynamic needs kv_true_dyn")
        kv_true = torch.full((1,), cfg.kv_len or Sk, dtype=torch.int32, device=q.device)
    args = (q, k, v, cfg, k_scale, v_scale, v_mean, kv_true, offsets)
    if q.device.type == "cpu":
        return decode_plain(*args)
    if q.device.type == "cuda":
        return decode_kernel(*args)
    raise NotImplementedError(f"no kernel for device {q.device}")


attention_call.launches = {name: 0 for name in LAUNCH_KEYS}
