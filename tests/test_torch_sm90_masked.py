"""The masked, windowed and segmented forms of B4 and B1 on their Hopper
routes (``csrc/flash_sm90.cu``'s MASKED mode: B4-window, B4-bool;
``csrc/attention_sm90.cu``'s MASKED instantiations: B1-window, B1-bool,
B1-colk-seg, B1-colk-seg-window): which launch keys and head dims the routes
take; the tile classes and lists each block walks, against the dense keep
mask of the plain version; what ``attention_kernel`` hands each entry
(recorded, not run: no card here); that a failed launch raises; and the
plain versions, at the kernels' kv tiles, against the JAX package's
``attention_call`` (Pallas, interpret mode, under ``jax.jit``).

Inputs come from a numpy seed.  Bars: the masked flash vs JAX calc_diff <
1e-5 at JAX blocks of the kernel's 128 columns (P rounds per tile against
the same running maxima), base-2 lse within 1e-5; B1's forms (a static
softmax: no tile dependence) < 1e-5 with the base-2 lse within 5e-3 (JAX's
interpret-mode denominators for an in-kernel int8 Q, ROADMAP queue 3); the
masked flash vs a float64 oracle < 2e-5 (tests/test_attention.py).
"""

import dataclasses
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu.ops import attention as jatt
from sageattention_tpu_torch.ops import _build
from sageattention_tpu_torch.ops import attention as tatt
from sageattention_tpu_torch.utils.testing import calc_diff

from port_cpu import yield_cpu  # noqa: F401  (one torch thread, low CPU priority)

JAX_BAR = 1e-5
ORACLE_BAR = 2e-5
LSE_FLASH = 1e-5
LSE_INT8 = 5e-3

# the B1 forms attention_sm90.cu takes with options: B1 with a window, a
# bool mask or segments (a window on segments too), folded or per-column
# K scales
B1_MASKED = {"B1-bool", "B1-seg", "B1-window", "B1-seg-window", "B1-colk-bool", "B1-colk-seg",
             "B1-colk-window", "B1-colk-seg-window"}


def _named_configs():
    """One configuration of every launch key (the first the module's own
    walk gives), over a prefill-sized launch."""
    seen = {}
    for cfg, rows in tatt._launch_configs():
        try:
            seen.setdefault(tatt.config_name(cfg, rows), (cfg, rows))
        except ValueError:
            pass
    return seen


def test_launch_keys_unchanged():
    digest = hashlib.sha256("\n".join(tatt.LAUNCH_KEYS).encode()).hexdigest()[:16]
    assert (len(tatt.LAUNCH_KEYS), digest) == (245, "77f5dffabd22793c")


@pytest.mark.parametrize("D", [64, 128, 256])
def test_routes_over_every_launch_key(D):
    """``flash_sm90_route`` takes B4, B4-fp4, B4-window and B4-bool at every
    head dim and B4-float below 256; ``b1_sm90_route`` takes B1, the
    fused-Q B-pvbf16 and B1's window, bool and segment forms on a bf16 Q
    below 256.  Every other key stays on ``attention.cuh`` (B2-bool, the
    B4 segment forms, the pre-quantized and e4m3 masked forms, -rowk)."""
    configs = _named_configs()
    assert set(configs) == set(tatt.LAUNCH_KEYS)
    flash, b1 = set(), set()
    for name, (cfg, rows) in configs.items():
        if tatt.flash_sm90_route(cfg, rows, D):
            flash.add(name)
        for dtype in (torch.bfloat16, torch.float32, torch.float16):
            if tatt.b1_sm90_route(cfg, rows, D, dtype):
                assert dtype == torch.bfloat16, (name, dtype)
                b1.add(name)
    assert flash == {"B4", "B4-fp4", "B4-window", "B4-bool"} | ({"B4-float"} if D < 256 else set())
    assert b1 == (set() if D == 256 else {"B1", "B-pvbf16"} | B1_MASKED)
    assert {"B2-bool", "B4-seg", "B4-bool-seg", "B5-fp8-bool", "B5-fp8-window",
            "B5-int8-bool-seg", "B5-fp8-fusedq-window", "B5-fp8-fusedq-colk-seg",
            "B3-rowk-seg", "B1-float"} <= set(configs) - flash - b1


def _keep(cfg, B, Sq, Sk, ext):
    """The plain version's dense keep mask ``[B|1, Hm|1, Sq, Sk]``."""
    rows = torch.arange(Sq)[:, None]
    keep = tatt._keep_mask(cfg, rows, torch.arange(Sk), 0, Sq, Sk, dict(ext, Sk=Sk))
    return keep.expand(keep.shape[0], keep.shape[1], Sq, Sk)


def _segments(lens, S, q_pad=-1, kv_pad=-2):
    ids = np.concatenate([np.full(n, i) for i, n in enumerate(lens)]).astype(np.int32)
    pos = np.concatenate([np.arange(n) for n in lens]).astype(np.int32)
    pad = S - len(ids)
    q = np.concatenate([ids, np.full(pad, q_pad, np.int32)])
    kv = np.concatenate([ids, np.full(pad, kv_pad, np.int32)])
    sp = np.concatenate([pos, np.full(pad, tatt.SEGPOS_PAD, np.int32)])
    return (torch.from_numpy(x)[None] for x in (q, kv, sp))


def _bool_mask(B, Hm, Sq, Sk, seed, block=128, live=0.3):
    """A block-sparse keep mask with a left-padded batch row and a few
    ragged cuts, so that tiles are dead, full and partly live."""
    rng = np.random.default_rng(seed)
    nb = -(-max(Sq, Sk) // block)
    blocks = rng.random((B, Hm, nb, nb)) < live
    m = np.repeat(np.repeat(blocks, block, 2), block, 3)[:, :, :Sq, :Sk].copy()
    m[:, :, :, 40:45] = True                      # a thin live stripe
    m[0, :, :, :70] = False                       # row 0 left-padded by 70
    return torch.from_numpy(m)


# (label, cfg fields, Sq, B, Hm, lens) for the class checks
CLASS_CASES = [
    ("window below a tile, sinks far below", dict(causal=True, window=50, sinks=3), 700, 1, 1, None),
    ("window not a multiple of 128", dict(causal=True, window=300), 515, 1, 1, None),
    ("bool Hm 1, kv_len cut", dict(masked="bool", kv_len=600), 640, 2, 1, None),
    ("bool Hm H, causal", dict(masked="bool", causal=True), 512, 1, 3, None),
    ("segments, causal, pads", dict(segmented=True, causal=True), 600, 1, 1, (200, 1, 130, 77)),
    ("segments, window, per-segment sinks", dict(segmented=True, causal=True, window=90,
                                                 sinks=4), 600, 1, 1, (300, 64, 150)),
]


@pytest.mark.parametrize("label,fields,S,B,Hm,lens", CLASS_CASES, ids=[c[0] for c in CLASS_CASES])
def test_tile_classes_and_lists_hold_the_dense_mask(label, fields, S, B, Hm, lens):
    """At each kernel's tiles (128 columns in blocks of 192 and 128 rows,
    64 columns in blocks of 128) a dead class keeps no score of its 64-row
    slice and kv tile, a full one keeps every score, and class 3 keeps what
    the rows' and columns' positions alone keep (the kv tail, causal, the
    band and global sinks); each block's list holds, in order, exactly the
    tiles where one of its slices is live, with their classes packed."""
    for bn, nwg in ((128, 3), (128, 2), (64, 2)):
        _check_classes(fields, S, B, Hm, lens, bn, nwg)


def _check_classes(fields, S, B, Hm, lens, bn, nwg):
    cfg = tatt.AttnConfig(quantized=False, **fields)
    ext = dict(q_segments=None, kv_segments=None, kv_segpos=None, attn_mask=None)
    if cfg.segmented:
        q_seg, kv_seg, segpos = _segments(lens, S)
        ext.update(q_segments=q_seg, kv_segments=kv_seg,
                   kv_segpos=segpos if cfg.sinks else None)
    if cfg.masked == "bool":
        ext["attn_mask"] = _bool_mask(B, Hm, S, S, seed=S + Hm)
    cls = tatt.tile_classes(cfg, S, S, bn, **ext)
    keep = _keep(cfg, B, S, S, ext)
    n64, nkt = -(-S // 64), -(-S // bn)
    assert cls.dtype == torch.uint8 and cls.shape[2:] == (n64, nkt)
    pad = torch.nn.functional.pad(keep, (0, nkt * bn - S, 0, n64 * 64 - S))
    t = pad.view(*keep.shape[:2], n64, 64, nkt, bn)
    anyk = t.any(5).any(3)
    full = t.all(5)
    rows_in = (torch.arange(n64 * 64) < S).view(n64, 64)[:, :, None]
    allk = (full | ~rows_in).all(3)           # rows past Sq never count
    c = cls.expand_as(anyk)
    assert not bool((anyk & (c == 0)).any()), "a dead class over a kept score"
    assert not bool((~allk & (c == 2)).any()), "a full class over a masked score"
    assert bool((c == 0).any()) and bool((c > 0).any())
    pos = dataclasses.replace(cfg, segmented=False, masked="none",
                              sinks=0 if cfg.segmented else cfg.sinks)
    arith = _keep(pos, B, S, S, dict(ext, q_segments=None, kv_segments=None, kv_segpos=None,
                                      attn_mask=None))
    differ = torch.nn.functional.pad(keep != arith, (0, nkt * bn - S, 0, n64 * 64 - S)).view(
        *keep.shape[:2], n64, 64, nkt, bn).any(5).any(3)
    assert not bool((differ & (c == 3)).any()), "class 3 where data cuts the tile"
    assert bool((c == 3).any())
    if cfg.window and not cfg.segmented:   # the band's classes are exact here
        assert torch.equal(c > 0, anyk)
    tiles, counts = tatt.tile_list(cls, nwg)
    nb = -(-n64 // nwg)
    assert tiles.shape == cls.shape[:2] + (nb, nkt) and counts.shape == cls.shape[:2] + (nb,)
    cp = torch.nn.functional.pad(cls, (0, 0, 0, nb * nwg - n64)).view(*cls.shape[:2], nb, nwg, nkt)
    for idx in np.ndindex(*tiles.shape[:3]):
        live = [j for j in range(nkt) if bool((cp[idx][:, j] > 0).any())]
        n = int(counts[idx])
        got = tiles[idx][:n]
        assert [int(e) & 0xFFFFFF for e in got] == live
        for e in got:
            j = int(e) & 0xFFFFFF
            assert [(int(e) >> (24 + 2 * w)) & 3 for w in range(nwg)] == cp[idx][:, j].tolist()
    if cfg.sinks and not cfg.segmented:   # the sink tile leads every late block's walk
        assert int(tiles[0, 0, -1, 0]) & 0xFFFFFF == 0 and int(counts[0, 0, -1]) < nkt


def _record(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "call", lambda fn, device, *args: calls.append((fn, args)))
    return calls


# sage_flash_fwd: (D, tile, mode) 0-2, pointers 3-6, strides 7-18, bias 19-23,
# lse 24, (B .. causal) 25-31, fold 32, the tile lists, block rows and mask
# 33-43, (window, sinks) 44-45
FLASH_TILES_AT, FLASH_TAIL_AT = 33, 44


@pytest.mark.parametrize("kind", ["window", "bool Hm 1", "bool Hm H", "seg"])
def test_masked_flash_dispatch(monkeypatch, kind):
    """B4-window and B4-bool go to ``sage_flash_fwd`` in mode 3 at D = 64,
    128 and 256 with the plain version's tile (``flash_kv_tile(D)``), the
    blocks' tile lists (as :func:`tile_list` builds them at the kernel's
    blocks), the bool mask in place as int8 with its strides, the window,
    sinks; B4-seg stays on the old build."""
    for D in (64, 128, 256):
        _check_flash_dispatch(monkeypatch, kind, D)


def _check_flash_dispatch(monkeypatch, kind, D):
    calls = _record(monkeypatch)
    B, Hq, Hk, S = 2, 4, 2, 320
    q, k, v = (torch.zeros(B, h, S, D, dtype=torch.bfloat16) for h in (Hq, Hk, Hk))
    fields, kw = dict(quantized=False, sm_scale=D ** -0.5), {}
    if kind == "window":
        fields.update(causal=True, window=100, sinks=2)
    elif kind == "seg":
        fields.update(segmented=True)
        q_seg, kv_seg, _ = _segments((100, 200), S)
        kw = dict(q_segments=q_seg.expand(B, S).contiguous(),
                  kv_segments=kv_seg.expand(B, S).contiguous())
    else:
        Hm = 1 if kind == "bool Hm 1" else Hq
        fields.update(masked="bool")
        kw = dict(attn_mask=_bool_mask(B, Hm, S, S, seed=D))
    cfg = tatt.AttnConfig(**fields)
    name = tatt.config_name(cfg, S)
    before = tatt.attention_call.launches[name]
    tatt.attention_kernel(q, k, v, cfg, **kw)
    assert tatt.attention_call.launches[name] == before + 1
    if kind == "seg":
        assert [fn for fn, _ in calls] == ["sage_attn_fwd_ext"]
        return
    assert [fn for fn, _ in calls] == ["sage_flash_fwd"]
    args = calls[0][1]
    bn = tatt.flash_kv_tile(D)
    assert args[:3] == (D, bn, 3) and args[19:24] == (None, 0, 0, 0, 1)
    assert args[25:32] == (B, Hq, Hk, S, S, S, int(cfg.causal))
    nkt, lb, lh, bm = args[FLASH_TILES_AT + 2:FLASH_TILES_AT + 6]
    assert nkt == -(-S // bn) and args[FLASH_TAIL_AT:] == (cfg.window, cfg.sinks)
    assert bm == (192 if D == 64 and kind == "window" else 128)
    margs = args[FLASH_TILES_AT + 6:FLASH_TAIL_AT]
    if kind == "window":
        assert (lb, lh) == (0, 0) and margs == (None, 0, 0, 0, 0)
    else:
        m = kw["attn_mask"]
        assert (lb, lh) == (1, int(m.shape[1] > 1))
        assert margs == (m.data_ptr(), *m.stride()[:3], int(m.shape[1] > 1))   # no copy


# sage_attn_fwd_sm90: D 0, pointers 1-4, strides 5-16, (k_head_scale, kn_max,
# v_scale, v_mean, lse, lmin) 17-22, (B .. causal) 23-29, fold 30, (k_scale,
# 2 strides, columns) 31-34, the tile lists, block rows and mask 35-45, (q/kv
# segment ids, kv_segpos) 46-48, (window, sinks) 49-50
B1_KS_AT, B1_TILES_AT, B1_SEG_AT = 31, 35, 46


@pytest.mark.parametrize("name", ["B1-window", "B1-bool", "B1-colk-seg", "B1-colk-seg-window"])
def test_masked_b1_dispatch(monkeypatch, name):
    """B1's masked forms go to ``sage_attn_fwd_sm90`` with the tile lists
    at its 128-column tiles, the segment ids and positions, the mask, the
    window and sinks; ``-colk`` hands the per-column K scales (a padded
    copy where rows are not 16 bytes apart) and no head scale."""
    calls = _record(monkeypatch)
    B, Hq, Hk, S, D = 1, 4, 2, 201, 64
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((B, Hq, S, D)).astype(np.float32)).bfloat16()
    k8, v8 = (torch.from_numpy(rng.integers(-127, 128, (B, Hk, S, D)).astype(np.int8))
              for _ in range(2))
    colk = "-colk" in name
    fields = dict(quantized=True, pv_dtype="int8", fuse_q_quant=True, fold_k_scale=not colk,
                  softmax_mode="static", fuse_v_mean=True, sm_scale=D ** -0.5,
                  causal="bool" not in name, window=64 if "window" in name else 0,
                  sinks=2 if "window" in name else 0, segmented="seg" in name,
                  masked="bool" if "bool" in name else "none")
    cfg = tatt.AttnConfig(**fields)
    assert tatt.config_name(cfg, S) == name
    kw = dict(kn_max=torch.ones(B, Hq, 1, 1), v_scale=torch.ones(B, Hk, 1, D),
              v_mean=torch.zeros(B, Hk, 1, D))
    if colk:
        kw["k_scale"] = torch.full((B, Hk, 1, S), 0.01)
    else:
        kw["k_head_scale"] = torch.ones(B, Hk, 1, 1)
    if cfg.segmented:
        kw["q_segments"], kw["kv_segments"], segpos = _segments((120, 81), S)
        if cfg.sinks:
            kw["kv_segpos"] = segpos
    if cfg.masked == "bool":
        kw["attn_mask"] = _bool_mask(B, 1, S, S, seed=3)
    before = tatt.attention_call.launches[name]
    out, lse, lmin = tatt.attention_kernel(q, k8, v8, cfg, **kw)
    assert tatt.attention_call.launches[name] == before + 1
    assert [fn for fn, _ in calls] == ["sage_attn_fwd_sm90"]
    args = calls[0][1]
    assert args[22] == lmin.data_ptr() and args[23:30] == (B, Hq, Hk, S, S, S, int(cfg.causal))
    ks = args[B1_KS_AT:B1_KS_AT + 4]
    if colk:
        assert args[17] is None and ks[0] is not None and ks[1:] == (Hk * 204, 204, S)
    else:
        assert args[17] is not None and ks == (None, 0, 0, 1)
    assert args[B1_TILES_AT + 2] == -(-S // tatt.SM90_KV_TILE)
    assert args[B1_TILES_AT + 5] == (128 if "bool" in name else 192)   # block rows at D = 64
    seg = args[B1_SEG_AT:B1_SEG_AT + 3]
    if cfg.segmented:
        assert seg[0] == kw["q_segments"].data_ptr() and seg[1] == kw["kv_segments"].data_ptr()
        assert (seg[2] is None) == (not cfg.sinks)
    else:
        assert seg == (None, None, None)
    assert args[B1_SEG_AT + 3:] == (cfg.window, cfg.sinks)


def test_a_failed_masked_launch_raises(monkeypatch):
    """An error code from either entry raises with its message: nothing
    falls back to ``attention.cuh`` or to the plain version."""
    class Lib:
        calls = []

        def sage_flash_fwd(self, *args):
            self.calls.append(args)
            return -1

        def sage_flash_error_string(self, e):
            return b"unsupported flash configuration"

        sage_attn_fwd_sm90 = sage_flash_fwd

        def sage_attn_sm90_error_string(self, e):
            return b"unsupported B1 configuration"

    lib = Lib()
    monkeypatch.setattr(_build, "build_all", lambda: {"flash_sm90": lib, "attention_sm90": lib})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    q, k, v = (torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16) for _ in range(3))
    cfg = tatt.AttnConfig(quantized=False, causal=True, window=16, sm_scale=128 ** -0.5)
    with pytest.raises(RuntimeError, match="sage_flash_fwd failed to launch: unsupported"):
        tatt.attention_kernel(q, k, v, cfg)
    cfg = tatt.AttnConfig(quantized=True, pv_dtype="int8", fuse_q_quant=True, fold_k_scale=True,
                          softmax_mode="static", causal=True, window=16, sm_scale=0.1)
    k8 = torch.zeros(1, 2, 64, 128, dtype=torch.int8)
    with pytest.raises(RuntimeError, match="sage_attn_fwd_sm90 failed to launch: unsupported"):
        tatt.attention_kernel(q, k8, k8, cfg, k_head_scale=torch.ones(1, 2, 1, 1),
                              kn_max=torch.ones(1, 2, 1, 1), v_scale=torch.ones(1, 2, 1, 128))
    assert len(lib.calls) == 2


def _bf16_exact(shape, rng, scale=1.0):
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(torch.bfloat16).float()


@functools.lru_cache(maxsize=None)
def _jax_call(cfg, names):
    def run(q, k, v, *xs):
        out = jatt.attention_call(q, k, v, **dict(zip(names, xs)), cfg=cfg, interpret=True)
        return out[0], out[1]
    return jax.jit(run)


def _jax(fields, q, k, v, **kw):
    cfg = jatt.AttnConfig(**{**fields, "out_dtype": jnp.float32})
    kw = {n: x for n, x in kw.items() if x is not None}
    shape = dict(q_segments=lambda x: x[:, :, None], kv_segments=lambda x: x[:, None],
                 kv_segpos=lambda x: x[:, None], attn_mask=lambda x: x.to(torch.int8))
    xs = [jnp.asarray(shape.get(n, lambda x: x)(x).numpy()) for n, x in kw.items()]
    jo, jl = _jax_call(cfg, tuple(kw))(*(jnp.asarray(x.numpy()) for x in (q, k, v)), *xs)
    return np.asarray(jo), np.asarray(jl)


def _oracle(q, k, v, keep, sm_scale):
    """float64 attention under the keep mask; a row with no key gives 0."""
    q, k, v = (x.double() for x in (q, k, v))
    G = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    s = (q @ k.transpose(-1, -2) * sm_scale).masked_fill(~keep, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.nan_to_num(torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)))
    return (p @ v) / p.sum(-1, keepdim=True).clamp_min(1e-300)


# (label, D, cfg fields, Hq, Hk, Hm): the flash forms at S = 384
FLASH_CASES = [
    ("window + sinks", 64, dict(causal=True, window=150, sinks=5), 2, 1, 0),
    ("window below a tile", 128, dict(causal=True, window=40), 2, 2, 0),
    ("bool Hm 1", 128, dict(masked="bool"), 2, 1, 1),
    ("bool Hm H, causal", 64, dict(masked="bool", causal=True), 2, 1, 2),
]


@pytest.mark.parametrize("label,D,fields,Hq,Hk,Hm", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_plain_masked_flash_matches_jax(label, D, fields, Hq, Hk, Hm):
    """B4-window and B4-bool's plain version at the kernel's tile
    (``flash_kv_tile(D)`` = 128 columns) against JAX at 128-wide blocks and
    against the float64 oracle; rows with no key: zeros."""
    S = 384
    rng = np.random.default_rng(D + Hm + len(label))
    q, k, v = (_bf16_exact((1, h, S, D), rng) for h in (Hq, Hk, Hk))
    fields = dict(fields, block_q=128, block_k=128, quantized=False, emit_lse=True,
                  sm_scale=D ** -0.5, kv_len=S)
    cfg = tatt.AttnConfig(**fields, out_dtype=torch.float32)
    assert tatt.flash_sm90_route(cfg, S, D) and tatt._plain_kv_tile(cfg, S, D) == 128
    mask = _bool_mask(1, Hm, S, S, seed=Hm) if Hm else None
    out, lse = tatt.attention_call(q, k, v, attn_mask=mask, cfg=cfg)
    jo, jl = _jax(fields, q, k, v, attn_mask=mask)
    keep = _keep(cfg, 1, S, S, dict(q_segments=None, kv_segments=None, kv_segpos=None,
                                    attn_mask=mask))
    live = keep.any(-1).expand(1, Hq, S)
    assert calc_diff(out[live], jo[live.numpy()]) < JAX_BAR
    np.testing.assert_allclose(lse[live].numpy(), jl[live.numpy()], atol=LSE_FLASH, rtol=0)
    ref = _oracle(q, k, v, keep, D ** -0.5)
    assert calc_diff(out[live], ref[live]) < ORACLE_BAR
    assert float(out[~live].abs().sum()) == 0.0


def _b1_inputs(rng, Hq, Hk, S, D, colk):
    """A bf16-exact Q, int8 K and V codes with per-head or per-column K
    scales, V scales and means, and kn_max, the static cap's K factor."""
    q = _bf16_exact((1, Hq, S, D), rng)
    k8 = torch.from_numpy(rng.integers(-127, 128, (1, Hk, S, D)).astype(np.int8))
    v8 = torch.from_numpy(rng.integers(-127, 128, (1, Hk, S, D)).astype(np.int8))
    kn = k8.float().norm(dim=-1)[:, :, None]                     # [1, Hk, 1, S]
    kw = dict(v_scale=torch.from_numpy(rng.uniform(0.005, 0.02, (1, Hk, 1, D)).astype(np.float32)),
              v_mean=torch.from_numpy(rng.standard_normal((1, Hk, 1, D)).astype(np.float32)))
    if colk:
        ks = torch.from_numpy(rng.uniform(0.004, 0.012, (1, Hk, 1, S)).astype(np.float32))
        kw["k_scale"], knm = ks, (ks * kn).amax(-1, keepdim=True)
    else:
        kw["k_head_scale"] = torch.full((1, Hk, 1, 1), 0.008)
        knm = kn.amax(-1, keepdim=True)
    kw["kn_max"] = knm.repeat_interleave(Hq // Hk, 1)
    return q, k8, v8, kw


# (label, D, option fields, lens or None, Hm): B1's forms at S = 384
B1_CASES = [
    ("window + sinks", 64, dict(causal=True, window=100, sinks=3), None, 0),
    ("bool Hm 1", 128, dict(masked="bool"), None, 1),
    ("bool Hm H, causal", 64, dict(masked="bool", causal=True), None, 2),
    ("colk segments, pads", 128, dict(segmented=True, causal=True), (150, 1, 100, 70), 0),
    ("colk segments, window, per-segment sinks", 64,
     dict(segmented=True, causal=True, window=60, sinks=4), (200, 90, 33), 0),
]


@pytest.mark.parametrize("label,D,opts,lens,Hm", B1_CASES, ids=[c[0] for c in B1_CASES])
def test_plain_masked_b1_matches_jax(label, D, opts, lens, Hm):
    """B1-window, B1-bool, B1-colk-seg and B1-colk-seg-window's plain
    version (a static softmax: the kv tile does not enter) against JAX's
    ``attention_call`` with the same codes, scales and masks, on the rows
    that see a key; their lmin tiles agree on which ones rerun."""
    S, Hq, Hk = 384, 2, 1
    colk = opts.get("segmented", False)
    rng = np.random.default_rng(D + len(label))
    q, k8, v8, kw = _b1_inputs(rng, Hq, Hk, S, D, colk)
    fields = dict(opts, block_q=128, block_k=128, quantized=True, pv_dtype="int8",
                  fuse_q_quant=True, fold_k_scale=not colk, softmax_mode="static",
                  fuse_v_mean=True, emit_lse=True, sm_scale=D ** -0.5, kv_len=S)
    cfg = tatt.AttnConfig(**fields, out_dtype=torch.float32)
    assert tatt.b1_sm90_route(cfg, S, D, torch.bfloat16)
    assert tatt.config_name(cfg, S) == "B1" + ("-colk" if colk else "") + (
        "-bool" if Hm else "") + ("-seg" if colk else "") + ("-window" if "window" in opts else "")
    ext = dict(q_segments=None, kv_segments=None, kv_segpos=None, attn_mask=None)
    if lens:
        q_seg, kv_seg, segpos = _segments(lens, S)
        ext.update(q_segments=q_seg, kv_segments=kv_seg,
                   kv_segpos=segpos if cfg.sinks else None)
    if Hm:
        ext["attn_mask"] = _bool_mask(1, Hm, S, S, seed=Hm + 7)
    out, lse, lmin = tatt.attention_call(q, k8, v8, cfg=cfg, **kw, **ext)
    jo, jl = _jax(fields, q, k8, v8, **kw, **ext)
    live = _keep(cfg, 1, S, S, ext).any(-1).expand(1, Hq, S)
    assert calc_diff(out[live], jo[live.numpy()]) < JAX_BAR
    np.testing.assert_allclose(lse[live].numpy(), jl[live.numpy()], atol=LSE_INT8, rtol=0)
    # a 64-row tile with a row that sees no key has lmin 0: the pipeline reruns it online
    dead = (~live).view(1, Hq, -1, 64).any(-1)
    assert torch.equal(lmin == 0, dead)
