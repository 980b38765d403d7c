"""Paged decode attention (D1) and its plain version (counterpart of
``sageattention_tpu/ops/paged_decode.py``).

The cache lives in a pool of fixed-size pages; each sequence finds its
pages through a table.  ``paged_decode_call`` takes the JAX function's
inputs: Q pre-scaled by sm_scale*log2(e) and rounded to bf16 by the host,
the int8 K pool with per-token scales, the V pool (int8, e4m3 or bf16) with
pool-global per-channel scale and mean, an effective table (stream slot ->
physical page), per-sequence lengths, and for sliding windows the logical
page of each slot, the window's lower bound and the sink count.  The TPU
kernel's DMA tactics (``ways`` concurrent page streams, superpage runs) are
not taken: the CUDA kernels choose their own KV splits and skip the slots
past a sequence's length or outside its window.  An int8 V pool at head
dims 64 and 128 (every ``D1-int8`` key, :func:`d1_sm90_route`) runs
``csrc/paged_decode_sm90.cu``: TMA-staged tiles, tensor-core scores and PV,
the query heads of a KV head in one block, and shares of at least
``SM90_DECODE_MIN_TILES`` live tiles (``ops.attention.sm90_decode_splits``);
e4m3 and bf16 V and head dim 256 run ``csrc/decode.cu``.

Numerics (the Pallas kernel's): s = (q . k8) * ks in f32 with K codes
upcast; the online softmax with the running max floored at ``M_CLAMP``, l
summing the f32 p and a bf16 P against the V codes upcast; the epilogue
``acc / l * v_scale + v_mean``; with ``emit_state`` the base-2 lse per row
(-1e30 for a row that saw nothing).  Masks: the tail (tokens < length),
T > 1 causal windows (row r at length - T + r), the sliding window
[win_lo, length) and sink slots [0, sinks).

Unlike the JAX kernel, the query rows need no padding to 32 (at most 32),
and the lse comes back as ``[B, Hg, R]``, not lane-replicated.  A CPU tensor
takes the plain version, a CUDA tensor the kernel; ``paged_decode_call.
launches`` counts kernel launches per configuration.
"""

from __future__ import annotations

import itertools

import torch

from . import _build
from .attention import (DECODE_ROWS, KV_TILE, MASK_NEG, SM90_DECODE_MIN_TILES, _no_tf32,
                        _v_operand, decode_epilogue, decode_launch, decode_splits, ks_operand,
                        sm90_decode_splits, sm90_heads_per_block, split_online_plain)

_FMT = {torch.int8: "int8", torch.float8_e4m3fn: "fp8", torch.bfloat16: "bf16"}


def config_name(v_dtype, window: int, sliding: bool, sinks: int, emit_state: bool) -> str:
    """D1's launch key: ``D1-<V format>``, then ``-causal`` (T > 1 window),
    ``-sliding`` or ``-sinks``, and ``-state``."""
    name = f"D1-{_FMT[v_dtype]}"
    if window > 1:
        name += "-causal"
    if sliding:
        name += "-sinks" if sinks else "-sliding"
    if emit_state:
        name += "-state"
    return name


LAUNCH_KEYS = tuple(
    config_name(dt, w, sl, sk, st)
    for dt, (w, sl, sk), st in itertools.product(
        _FMT, ((1, False, 0), (2, False, 0), (1, True, 0), (1, True, 1)), (False, True)))


def d1_sm90_route(v_dtype, D: int) -> bool:
    """True for the D1 launches that ``csrc/paged_decode_sm90.cu`` runs: an
    int8 V pool at head dims 64 and 128, every window, sliding, sink and
    state form.  e4m3 and bf16 V and D = 256 stay on ``csrc/decode.cu``."""
    return v_dtype == torch.int8 and D in (64, 128)


def _stream(table_eff, lengths, lpage, win_lo, n_pages, page):
    """Per-slot inputs, cut to the ``n_pages`` stream slots, as contiguous int32."""
    B = table_eff.shape[0]
    if lpage is None:
        lpage = torch.arange(n_pages, device=table_eff.device).expand(B, n_pages)
    return (table_eff[:, :n_pages].to(torch.int32).contiguous(),
            lpage[:, :n_pages].to(torch.int32).contiguous(),
            lengths.to(torch.int32).contiguous(),
            None if win_lo is None else win_lo.to(torch.int32).contiguous())


def paged_decode_plain(q, k8_pool, ks_pool, v_pool, v_scale, v_mean, table_eff, lengths, *,
                       n_pages, window, lpage=None, win_lo=None, sinks=0, emit_state=False):
    """Plain version of D1: the kernel's walk over the live 64-token tiles
    of each sequence's stream, split in the kernel's shares.  Returns
    ``(out [B, Hg, R, D] bf16, lse_base2 [B, Hg, R] | None)``."""
    B, Hg, R, D = q.shape
    P, Hk, page, _ = k8_pool.shape
    G = Hg // Hk
    table, lp, lens, lo = _stream(table_eff, lengths, lpage, win_lo, n_pages, page)
    sliding = win_lo is not None
    sink_pages = -(-sinks // page) if sinks else 0
    n_units = n_pages * (page // KV_TILE)
    if d1_sm90_route(v_pool.dtype, D):   # csrc/paged_decode_sm90.cu's shares
        n_split, min_per = sm90_decode_splits(B, Hk, n_units), SM90_DECODE_MIN_TILES
    else:
        n_split, min_per = decode_splits(B, Hk), 1
    qf = q.float()
    outs, lses = [], []
    with _no_tf32():
        for b in range(B):
            L = int(lens[b])
            hi = n_units if sliding else min(n_units, -(-max(L, 0) // KV_TILE))
            n_tok = hi * KV_TILE
            slots = torch.arange(n_tok, device=q.device) // page
            pos = lp[b, slots] * page + torch.arange(n_tok, device=q.device) % page
            phys = table[b, slots].long()
            off = torch.arange(n_tok, device=q.device) % page
            kb = k8_pool[phys, :, off].permute(1, 0, 2).float()        # [Hk, n_tok, D]
            ksb = ks_pool[:, :, 0][phys, :, off].permute(1, 0).float()  # [Hk, n_tok]
            vb = _v_operand(v_pool[phys, :, off].permute(1, 0, 2),
                            "bf16" if v_pool.dtype == torch.bfloat16 else "int8")
            s = torch.matmul(qf[b], kb.repeat_interleave(G, 0).transpose(-1, -2))
            s = s * ksb.repeat_interleave(G, 0)[:, None, :]
            if window > 1:
                keep = pos[None, :] <= L - window + torch.arange(R, device=q.device)[:, None]
            else:
                keep = (pos < L)[None, :]
                if sliding:
                    band = pos >= int(lo[b])
                    if sinks:
                        band = torch.where(slots < sink_pages, pos < sinks, band)
                    keep = keep & band[None, :]
            s = torch.where(keep, s, MASK_NEG)
            m, l, acc = split_online_plain(s, vb.repeat_interleave(G, 0), "bf16", n_split,
                                           min_per)
            vs = v_scale[0].float().repeat_interleave(G, 0)
            vm = v_mean[0].float().repeat_interleave(G, 0)
            outs.append(decode_epilogue(m, l, acc, vs, 1.0, vm).to(torch.bfloat16))
            lses.append(torch.where(l > 0, m + torch.log2(torch.where(l > 0, l, 1.0)),
                                    torch.full_like(l, -1e30)))
    return torch.stack(outs), (torch.stack(lses) if emit_state else None)


def paged_decode_kernel(q, k8_pool, ks_pool, v_pool, v_scale, v_mean, table_eff, lengths, *,
                        n_pages, window, lpage=None, win_lo=None, sinks=0, emit_state=False):
    """Launch D1 on CUDA tensors (``csrc/paged_decode_sm90.cu`` on
    :func:`d1_sm90_route`, else ``csrc/decode.cu``); same arguments and
    returns as :func:`paged_decode_plain`."""
    name = config_name(v_pool.dtype, window, win_lo is not None, sinks, emit_state)
    B, Hg, R, D = q.shape
    P, Hk, page, _ = k8_pool.shape
    if k8_pool.dtype != torch.int8:
        raise TypeError("the K pool holds int8 codes")
    table, lp, lens, lo = _stream(table_eff, lengths, lpage, win_lo, n_pages, page)
    if d1_sm90_route(v_pool.dtype, D):
        out, lse = _paged_sm90(q, k8_pool, ks_pool, v_pool, v_scale, v_mean, table, lp, lens, lo,
                               n_pages=n_pages, window=window, sinks=sinks,
                               emit_state=emit_state)
        paged_decode_call.launches[name] += 1
        return out, lse
    out, lse = decode_launch(
        paged=True, q=q, k=k8_pool, v=v_pool, ks=ks_pool.float(), lens=lens,
        Hk=Hk, S=0, n_units=n_pages * (page // KV_TILE), n_split=decode_splits(B, Hk),
        table=table, lpage=lp, win_lo=lo, n_slots=n_pages, page=page, window_T=window,
        sliding=win_lo is not None, sinks=sinks,
        sink_pages=-(-sinks // page) if sinks else 0, v_scale=v_scale, v_mean=v_mean,
        lse_mode=2 if emit_state else 0)
    paged_decode_call.launches[name] += 1
    return out, lse


def _paged_sm90(q, k8_pool, ks_pool, v_pool, v_scale, v_mean, table, lp, lens, lo, *,
                n_pages, window, sinks, emit_state):
    """Launch ``csrc/paged_decode_sm90.cu`` (the shares, then their merge)
    on the stream inputs :func:`_stream` makes; returns ``(out [B, Hg, R, D]
    bf16, lse_base2 | None)``.  The pools are read in place through tensor
    maps; every length, table and window stays on the device."""
    B, Hg, R, D = q.shape
    P, Hk, page, _ = k8_pool.shape
    if not 1 <= R <= DECODE_ROWS:
        raise ValueError(f"D1 takes 1..{DECODE_ROWS} query rows, got {R}")
    dev = q.device
    hpb = sm90_heads_per_block(Hg // Hk, R)
    n_units = n_pages * (page // KV_TILE)
    n_split = sm90_decode_splits(B, Hk, n_units)
    qb = q.to(torch.bfloat16).contiguous()
    k, v = _build.vector_aligned(k8_pool), _build.vector_aligned(v_pool)
    ks = ks_operand(ks_pool, page)
    vs = v_scale.float().reshape(Hk * D).contiguous()
    vm = v_mean.float().reshape(Hk * D).contiguous()
    pm = torch.empty((B * Hg, n_split, R), dtype=torch.float32, device=dev)
    pl = torch.empty_like(pm)
    pacc = torch.empty((B * Hg, n_split, R, D), dtype=torch.float32, device=dev)
    out = torch.empty((B, Hg, R, D), dtype=torch.bfloat16, device=dev)
    lse = torch.empty((B, Hg, R), dtype=torch.float32, device=dev) if emit_state else None
    _build.call("sage_paged_decode_sm90", dev, D, hpb, qb.data_ptr(), k.data_ptr(), v.data_ptr(),
                ks.data_ptr(), *k.stride()[:3], *v.stride()[:3], ks.stride(0), ks.stride(1),
                lens.data_ptr(), table.data_ptr(), lp.data_ptr(),
                None if lo is None else lo.data_ptr(), B, P, Hg, Hk, R, n_units, n_pages, page,
                window, sinks, -(-sinks // page) if sinks else 0, n_split, vs.data_ptr(),
                vm.data_ptr(), pm.data_ptr(), pl.data_ptr(), pacc.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr())
    return out, lse


def paged_decode_call(q, k8_pool, ks_pool, v_pool, v_scale, v_mean, table_eff, lengths, *,
                      n_pages: int, window: int, lpage=None, win_lo=None, sinks: int = 0,
                      emit_state: bool = False):
    """Paged decode attention.  ``q [B, Hg, R, D]`` bf16, scale pre-folded,
    R <= 32 rows (``Hg`` is Hk when the host folded GQA heads into rows,
    else Hq); pools ``k8_pool [P, Hk, page, D]`` int8, ``ks_pool [P, Hk, 1,
    page]`` f32, ``v_pool [P, Hk, page, D]``; ``v_scale``/``v_mean [1, Hk,
    1, D]``; ``table_eff [B, >= n_pages]`` int32 physical page per stream
    slot; ``lengths [B]``; ``window`` T of a causal window (1 = none);
    ``lpage`` the logical page per slot (identity if None); ``win_lo [B]``
    the sliding window's lower bound (None = no window); ``sinks`` the sink
    tokens.  Returns ``out`` or ``(out, lse_base2 [B, Hg, R])``."""
    B, Hg, R, D = q.shape
    P, Hk, page, Dk = k8_pool.shape
    if D != Dk or Hg % Hk or not 1 <= R <= 32:
        raise ValueError(f"bad shapes q {tuple(q.shape)} pool {tuple(k8_pool.shape)}")
    if page % KV_TILE:
        raise ValueError(f"page size {page} must be a multiple of {KV_TILE}")
    if n_pages > table_eff.shape[1] or (lpage is not None and n_pages > lpage.shape[1]):
        raise ValueError(f"n_pages {n_pages} > table width {table_eff.shape[1]}")
    if sinks and win_lo is None:
        raise ValueError("sinks ride the sliding-window stream (win_lo)")
    args = (q, k8_pool, ks_pool, v_pool, v_scale, v_mean, table_eff, lengths)
    kw = dict(n_pages=n_pages, window=window, lpage=lpage, win_lo=win_lo, sinks=sinks,
              emit_state=emit_state)
    if q.device.type == "cpu":
        out, lse = paged_decode_plain(*args, **kw)
    elif q.device.type == "cuda":
        out, lse = paged_decode_kernel(*args, **kw)
    else:
        raise NotImplementedError(f"no kernel for device {q.device}")
    return (out, lse) if emit_state else out


paged_decode_call.launches = {name: 0 for name in LAUNCH_KEYS}
