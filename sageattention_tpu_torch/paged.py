"""Paged int8 KV cache: a pool of pages and per-sequence block tables
(counterpart of ``sageattention_tpu/paged.py``).

Sequences of a serving batch arrive and finish on their own, so the cache
is a pool of fixed-size pages with a table per sequence, ragged lengths,
and prefix sharing (two table rows may point at the same pages).  The
quantization follows ``decode.py`` with one difference: the K centering and
the V scale and mean are pool-global, per KV head and channel, so that a
page is exact for every sequence that reads it; per-token K scales carry
the accuracy.

As in ``decode.py``, the pools are written in place (``paged_prefill``
allocates them; ``paged_insert`` and ``paged_append`` write into them) and
the table and lengths are device tensors, of which each call returns new
ones; a decode step (``paged_append`` with ``sageattn_decode_paged``) reads
nothing back to the host.  ``paged_prefill`` and ``pages_bucket_for`` read
the lengths on the host.  A cache object from before an insert or append
shares the pools and sees what was written.

Typical flow::

    alloc = PageAllocator(num_pages=4096, page_size=256)
    table = build_table([alloc.reserve(alloc.pages_for(n)) for n in lens], max_pages)
    cache = paged_prefill(k, v, lens, table, num_pages=4096)
    cache = paged_append(cache, k_new, v_new)        # one token per sequence
    out = sageattn_decode_paged(q, cache, pages_bucket=...)
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .decode import _V_DTYPES, FP8_SCALE_MAX, _quant_k, _quant_v, _raw, _to_hnd, _v_format
from .ops.attention import DECODE_ROWS, _F32
from .ops.paged_decode import paged_decode_call
from .ops.quant import LOG2E

_PAGE_DEFAULT = 256
_RUNS_GRAIN = 4   # the allocator hands out aligned runs of this many pages first


class PagedKVCache(NamedTuple):
    """Pooled paged cache.  ``page_table[b, j]`` is the physical page that
    holds tokens ``j*page .. (j+1)*page - 1`` of sequence ``b``."""

    k8_pool: torch.Tensor     # [P, Hk, page, D] int8 (centered by k_mean)
    ks_pool: torch.Tensor     # [P, Hk, 1, page] f32 per token
    v_pool: torch.Tensor      # [P, Hk, page, D] int8/e4m3 (centered) or bf16
    v_scale: torch.Tensor     # [1, Hk, 1, D] f32 (ones when V is bf16)
    v_mean: torch.Tensor      # [1, Hk, 1, D] f32
    k_mean: torch.Tensor      # [1, Hk, 1, D] f32
    page_table: torch.Tensor  # [B, max_pages] int32
    lengths: torch.Tensor     # [B] int32

    @property
    def page_size(self) -> int:
        return self.k8_pool.shape[2]

    @property
    def num_pages(self) -> int:
        return self.k8_pool.shape[0]

    @property
    def v_int8(self) -> bool:
        return self.v_pool.dtype == torch.int8


class PageAllocator:
    """Host-side free-list page allocator with reference counts (shared
    prefixes free correctly).  ``reserve`` hands out aligned runs of 4
    consecutive pages first, then the rest ascending, as the JAX package
    does, so both give the same page ids."""

    def __init__(self, num_pages: int, page_size: int = _PAGE_DEFAULT):
        self.page_size = page_size
        self._free = list(range(num_pages - 1, -1, -1))
        self._refs = np.zeros(num_pages, np.int32)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def reserve(self, n: int) -> list:
        if n > len(self._free):
            raise MemoryError(f"page pool exhausted: need {n}, have {len(self._free)}")
        R = _RUNS_GRAIN
        free = sorted(self._free)
        free_set = set(free)
        take: list = []
        if n >= R:
            for p in free:
                if len(take) + R > n:
                    break
                if p % R == 0 and all(p + i in free_set for i in range(R)):
                    run = [p + i for i in range(R)]
                    take += run
                    free_set.difference_update(run)
        if len(take) < n:
            rest = [p for p in free if p in free_set][:n - len(take)]
            take += rest
            free_set.difference_update(rest)
        self._free = [p for p in free if p in free_set]
        self._refs[take] += 1
        return take

    def share(self, pages: Sequence[int]) -> list:
        """Add a reference to pages already reserved (prefix sharing)."""
        self._refs[list(pages)] += 1
        return list(pages)

    def release(self, pages: Sequence[int]) -> None:
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
            elif self._refs[p] < 0:
                raise ValueError(f"double release of page {p}")

    def pages_for(self, length: int) -> int:
        return -(-max(length, 1) // self.page_size)


def build_table(rows: Sequence[Sequence[int]], max_pages: int) -> np.ndarray:
    """Per-sequence page lists padded with 0 into the ``[B, max_pages]``
    int32 table."""
    table = np.zeros((len(rows), max_pages), np.int32)
    for b, r in enumerate(rows):
        if len(r) > max_pages:
            raise ValueError(f"sequence {b} needs {len(r)} pages > max_pages {max_pages}")
        table[b, :len(r)] = r
    return table


def _masked_mean(x, lengths):
    """Mean over every sequence's true tokens, pooled across the batch:
    ``[B, Hk, S, D] -> [1, Hk, 1, D]``."""
    S = x.shape[2]
    valid = (torch.arange(S, device=x.device)[None, :, None] < lengths[:, None, None])[:, None]
    total = torch.where(valid, x, 0.0).sum(dim=(0, 2), keepdim=True)
    count = torch.clamp_min(lengths.sum(), 1).float()
    return total / count


def paged_prefill(k, v, lengths, page_table, *, num_pages: int,
                  page_size: int = _PAGE_DEFAULT, tensor_layout: str = "HND",
                  smooth_k: bool = True, smooth_v: bool = True, v_quant: bool = True,
                  v_margin: float = 1.25, v_format: Optional[str] = None) -> PagedKVCache:
    """Quantize a ragged, right-padded prefill batch into a new page pool.

    ``k``/``v``: [B, Hk, S_pad, D] (HND), S_pad a multiple of the page size;
    ``lengths``: the true lengths; ``page_table``: [B, max_pages] (from
    :class:`PageAllocator` and :func:`build_table`).  Only the live pages of
    each sequence are written (a shorter sequence's padded table slots point
    at page 0, which another sequence may own); the rest of the pool stays
    zero, with unit K scales."""
    k, v = _to_hnd(tensor_layout, k, v)
    B, Hk, S, D = k.shape
    dev = k.device
    page_table = torch.as_tensor(np.asarray(page_table) if not isinstance(
        page_table, torch.Tensor) else page_table, dtype=torch.int32).to(dev)
    max_pages = page_table.shape[1]
    page = page_size
    if S % page:
        raise ValueError(f"prefill length {S} must be page-aligned ({page}); pad the input")
    n_seq = S // page
    if n_seq > max_pages:
        raise ValueError(f"{n_seq} prefill pages > max_pages {max_pages}")
    lens_host = [int(x) for x in torch.as_tensor(lengths).reshape(-1).tolist()]
    lengths = torch.tensor(lens_host, dtype=torch.int32, device=dev)
    kf, vf = k.float(), v.float()
    zeros = torch.zeros((1, Hk, 1, D), dtype=torch.float32, device=dev)
    km = _masked_mean(kf, lengths) if smooth_k else zeros
    vm = _masked_mean(vf, lengths) if smooth_v else zeros
    valid = (torch.arange(S, device=dev)[None, :, None] < lengths[:, None, None])[:, None]
    k8, ks = _quant_k(torch.where(valid, kf - km, 0.0), 0.0)
    vc = torch.where(valid, vf - vm, 0.0)
    fmt = _v_format(v_quant, v_format)
    if fmt != "bf16":
        qmax = 127.0 if fmt == "int8" else FP8_SCALE_MAX
        av = vc.abs().amax(dim=(0, 2), keepdim=True)
        vs = torch.where(av > 1e-8, av * (v_margin / qmax), torch.ones_like(av))
        vq = _quant_v(vc, 0.0, vs, _V_DTYPES[fmt])
        # the pool-global rounding bias of the codes folds into v_mean (pads
        # quantize to 0, so the masked mean is sum(codes) / true tokens)
        count = torch.clamp_min(lengths.sum(), 1).float()
        vm = vm - vq.float().sum(dim=(0, 2), keepdim=True) / count * vs
    else:
        vs = torch.ones((1, Hk, 1, D), dtype=torch.float32, device=dev)
        vq = vc.to(torch.bfloat16)
    k8_pool = torch.zeros((num_pages, Hk, page, D), dtype=torch.int8, device=dev)
    ks_pool = torch.ones((num_pages, Hk, 1, page), dtype=torch.float32, device=dev)
    v_pool = torch.zeros((num_pages, Hk, page, D), dtype=vq.dtype, device=dev)
    live = [(b, j) for b, L in enumerate(lens_host) for j in range(min(-(-L // page), n_seq))]
    if live:
        ib = torch.tensor([x[0] for x in live], device=dev)
        ij = torch.tensor([x[1] for x in live], device=dev)
        phys = page_table[ib, ij].long()
        pages = lambda x: x.reshape(B, Hk, n_seq, page, D).permute(0, 2, 1, 3, 4)[ib, ij]  # noqa: E731
        k8_pool.index_copy_(0, phys, pages(k8))
        _raw(v_pool).index_copy_(0, phys, _raw(pages(vq)))
        ks_pages = ks[..., 0].reshape(B, Hk, n_seq, page).permute(0, 2, 1, 3)[ib, ij]
        ks_pool.index_copy_(0, phys, ks_pages[:, :, None])
    return PagedKVCache(k8_pool, ks_pool, v_pool, vs, vm, km, page_table, lengths)


def paged_insert(cache: PagedKVCache, slot: int, k, v, length, pages: Sequence[int], *,
                 start_page: int = 0, tensor_layout: str = "HND") -> PagedKVCache:
    """Admit a new sequence into batch ``slot`` (continuous batching):
    ``k``/``v`` [Hk, S_pad, D] page-aligned, quantized with the pool's fixed
    statistics into ``pages``.  ``start_page``: the first ``start_page``
    pages already hold this prompt's prefix (prefix caching) and ``k``/``v``
    cover only the suffix from ``start_page * page_size``; only the fresh
    pages are written, and the table row points at all of them."""
    if tensor_layout == "NHD":
        k, v = k.transpose(0, 1), v.transpose(0, 1)
    elif tensor_layout != "HND":
        raise ValueError(f"tensor_layout must be HND or NHD, got {tensor_layout!r}")
    Hk, S, D = k.shape
    page = cache.page_size
    if S % page:
        raise ValueError(f"insert length {S} must be page-aligned ({page})")
    n = S // page
    if start_page + n > len(pages):
        raise ValueError(f"{start_page}+{n} pages of data but only {len(pages)} reserved")
    if len(pages) > cache.page_table.shape[1]:
        raise ValueError(f"{len(pages)} pages > table width {cache.page_table.shape[1]}")
    dev = cache.k8_pool.device
    k8, ks = _quant_k(k.float(), cache.k_mean[0])
    vc = v.float() - cache.v_mean[0]
    if cache.v_pool.dtype == torch.bfloat16:
        vq = vc.to(torch.bfloat16)
    else:
        vq = _quant_v(vc, 0.0, cache.v_scale[0], cache.v_pool.dtype)
    if n:
        phys = torch.tensor(list(pages[start_page:start_page + n]), dtype=torch.long, device=dev)
        cache.k8_pool.index_copy_(0, phys, k8.reshape(Hk, n, page, D).transpose(0, 1))
        _raw(cache.v_pool).index_copy_(0, phys, _raw(vq.reshape(Hk, n, page, D).transpose(0, 1)))
        cache.ks_pool.index_copy_(0, phys, ks[..., 0].reshape(Hk, n, page).transpose(0, 1)[:, :, None])
    table = cache.page_table.clone()
    table[slot] = 0
    table[slot, :len(pages)] = torch.tensor(list(pages), dtype=torch.int32, device=dev)
    lengths = cache.lengths.clone()
    lengths[slot] = int(length)
    return cache._replace(page_table=table, lengths=lengths)


def paged_append(cache: PagedKVCache, k_new, v_new, *, active=None,
                 tensor_layout: str = "HND") -> PagedKVCache:
    """Quantize ``T`` new tokens per sequence with the pool's statistics and
    write each at its own ``lengths[b] + t``, in place; returns the cache
    with the grown lengths.  The table must already cover the grown length.
    ``active``: optional [B] bool; an inactive slot neither writes nor
    grows (it writes its old codes back)."""
    k_new, v_new = _to_hnd(tensor_layout, k_new, v_new)
    B, Hk, T, D = k_new.shape
    page = cache.page_size
    k8, ks = _quant_k(k_new.float(), cache.k_mean)
    vc = v_new.float() - cache.v_mean
    if cache.v_pool.dtype == torch.bfloat16:
        vq = vc.to(torch.bfloat16)
    else:
        vq = _quant_v(vc, 0.0, cache.v_scale, cache.v_pool.dtype)
    dev = cache.k8_pool.device
    bidx = torch.arange(B, device=dev)
    ks_view = cache.ks_pool[:, :, 0]          # [P, Hk, page], a view of the pool
    max_pages = cache.page_table.shape[1]
    if active is not None:
        active = torch.as_tensor(active, dtype=torch.bool, device=dev)
    for t in range(T):
        pos = cache.lengths.long() + t
        col = torch.clamp(pos // page, max=max_pages - 1)
        phys = cache.page_table[bidx, col].long()
        off = pos % page
        kv, sv, vv = k8[:, :, t], ks[:, :, t, 0], _raw(vq[:, :, t])
        v_pool = _raw(cache.v_pool)
        if active is not None:
            a = active[:, None]
            kv = torch.where(a[..., None], kv, cache.k8_pool[phys, :, off])
            sv = torch.where(a, sv, ks_view[phys, :, off])
            vv = torch.where(a[..., None], vv, v_pool[phys, :, off])
        cache.k8_pool[phys, :, off] = kv
        ks_view[phys, :, off] = sv
        v_pool[phys, :, off] = vv
    grow = (torch.full((B,), T, dtype=torch.int32, device=dev) if active is None
            else torch.where(active, T, 0).to(torch.int32))
    return cache._replace(lengths=cache.lengths + grow)


def paged_decode_step_deferred(q, cache: PagedKVCache, k_new, v_new, *, pages_bucket: int = 0,
                               sm_scale: Optional[float] = None):
    """One T = 1 step with the append after the attention read: the kernel
    attends the pre-append cache and the new token's exact contribution is
    merged through the kernel's lse (``return_state``).  The merged term
    uses the unquantized new token.  Returns ``(out [B, Hq, 1, D],
    new_cache)``; HND only."""
    B, Hq, T, D = q.shape
    if T != 1:
        raise ValueError("deferred step is T=1 decode only")
    G = Hq // cache.k8_pool.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    o_c, lse_c = sageattn_decode_paged(q, cache, pages_bucket=pages_bucket, sm_scale=sm_scale,
                                       return_state=True)
    new_cache = paged_append(cache, k_new, v_new)
    k1 = k_new.repeat_interleave(G, dim=1).float()
    v1 = v_new.repeat_interleave(G, dim=1).float()
    s1 = (q.float() * k1).sum(dim=-1) * sm_scale
    m = torch.maximum(lse_c, s1)
    w_c, w_1 = torch.exp(lse_c - m), torch.exp(s1 - m)
    out = ((w_c[..., None] * o_c.float() + w_1[..., None] * v1) / (w_c + w_1)[..., None])
    return out.to(o_c.dtype), new_cache


def paged_decode_block_staged(qs, cache: PagedKVCache, ks_new, vs_new, *,
                              pages_bucket: int = 0, sm_scale: Optional[float] = None):
    """``T`` steps with one pool append: each step attends the constant
    pool and merges the block's tokens up to its own (causal, unquantized)
    through the kernel's lse, then the block is appended once.
    ``qs``/``ks_new``/``vs_new``: [T, B, H, 1, D].  Returns ``(outs [T, B,
    Hq, 1, D], new_cache)``; HND only."""
    T = qs.shape[0]
    B, Hq, _, D = qs.shape[1:]
    G = Hq // cache.k8_pool.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    kb = ks_new[:, :, :, 0].permute(1, 2, 0, 3)             # [B, Hk, T, D]
    vb = vs_new[:, :, :, 0].permute(1, 2, 0, 3)
    kbe = kb.repeat_interleave(G, dim=1).float()
    vbe = vb.repeat_interleave(G, dim=1).float()
    outs = []
    for t in range(T):
        q1 = qs[t]
        o_c, lse_c = sageattn_decode_paged(q1, cache, pages_bucket=pages_bucket,
                                           sm_scale=sm_scale, return_state=True)
        s_tail = torch.matmul(q1.float(), kbe[:, :, :t + 1].transpose(-1, -2)) * sm_scale
        m_tail = s_tail.amax(dim=-1)
        w_tail = torch.exp(s_tail - m_tail[..., None])
        l_tail = w_tail.sum(dim=-1)
        o_tail = torch.matmul(w_tail, vbe[:, :, :t + 1])
        m = torch.maximum(lse_c, m_tail + torch.log(l_tail))
        w_c, w_t = torch.exp(lse_c - m), torch.exp(m_tail - m)
        den = w_c + w_t * l_tail
        out = (w_c[..., None] * o_c.float() + w_t[..., None] * o_tail) / den[..., None]
        outs.append(out.to(o_c.dtype))
    new_cache = paged_append(cache, kb, vb)
    return torch.stack(outs), new_cache


def paged_trim(cache: PagedKVCache, n) -> PagedKVCache:
    """Roll back the last ``n`` tokens per sequence (scalar or [B])."""
    n = torch.as_tensor(n, dtype=torch.int32, device=cache.lengths.device)
    return cache._replace(lengths=torch.clamp_min(cache.lengths - n, 0))


def pages_bucket_for(cache_or_lengths, page_size: int = _PAGE_DEFAULT) -> int:
    """Host-side static page budget that covers every sequence (reads the
    lengths back)."""
    if isinstance(cache_or_lengths, PagedKVCache):
        lengths = cache_or_lengths.lengths.cpu().numpy()
        page_size = cache_or_lengths.page_size
    else:
        lengths = np.asarray(cache_or_lengths.cpu() if isinstance(cache_or_lengths, torch.Tensor)
                             else cache_or_lengths)
    return int(-(-int(lengths.max()) // page_size))


def sageattn_decode_paged(q, cache: PagedKVCache, *, tensor_layout: str = "HND",
                          sm_scale: Optional[float] = None, pages_bucket: int = 0,
                          is_causal: bool = True, sliding_window: int = 0,
                          attention_sinks: int = 0, return_state: bool = False):
    """Attention of ``T`` fresh tokens per sequence against the paged pool.

    ``q``: [B, Hq, T, D] (HND); row ``t`` of sequence ``b`` sits at position
    ``lengths[b] - T + t`` (append first, then decode).  ``pages_bucket``
    statically bounds the page stream (0 = the table's width).
    ``sliding_window``: attend only the last ``W`` tokens (T = 1); the
    stream starts at each sequence's window, so a step costs O(W).
    ``attention_sinks``: keep the first ``n`` tokens visible too.
    ``return_state``: also return the natural-log lse ``[B, Hq, 1]``,
    head-major whatever the layout, as the JAX package returns it (plain
    T = 1 decode only).  Returns [B, Hq, T, D] bf16 in the input layout.
    """
    (q,) = _to_hnd(tensor_layout, q)
    B, Hq, T, D = q.shape
    _, Hk, page, Dk = cache.k8_pool.shape
    if D != Dk:
        raise ValueError(f"head_dim mismatch: q {D} vs pool {Dk}")
    if Hq % Hk != 0:
        raise ValueError(f"num_qo_heads ({Hq}) must be divisible by num_kv_heads ({Hk})")
    if T > DECODE_ROWS:
        raise ValueError(f"decode window T={T} exceeds the q tile ({DECODE_ROWS}); "
                         "chunk the window")
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    max_pages = cache.page_table.shape[1]
    n_pages = pages_bucket or max_pages
    if n_pages > max_pages:
        raise ValueError(f"pages_bucket ({n_pages}) > table width ({max_pages})")
    if attention_sinks and not sliding_window:
        raise ValueError("attention_sinks needs sliding_window (full attention already "
                         "sees the sinks)")
    sink_pages = band_w = 0
    if sliding_window:
        if T != 1:
            raise ValueError("sliding_window decode supports T=1 (chunk verify windows are "
                             "full-attention)")
        sink_pages = -(-attention_sinks // page) if attention_sinks else 0
        band_w = min(max_pages, -(-sliding_window // page) + 1)
        n_pages = (sink_pages + band_w) if sink_pages else min(n_pages, band_w)
    if return_state and (sliding_window or T > 1):
        raise ValueError("return_state supports plain T=1 decode only")
    G = Hq // Hk
    fold = T == 1 and 1 < G <= DECODE_ROWS
    qt, Hg = (q.reshape(B, Hk, G, D), Hk) if fold else (q, Hq)
    rows = qt.shape[2]
    qt = (qt.float() * _F32(sm_scale * LOG2E)).to(torch.bfloat16)

    dev = q.device
    lengths = cache.lengths
    last_live = torch.clamp_min(lengths - 1, 0) // page
    slot = torch.arange(max_pages, device=dev).expand(B, max_pages)
    lpage = win_lo = None
    if sliding_window:
        win_lo = torch.clamp_min(lengths - sliding_window, 0)
        if attention_sinks:
            win_lo = torch.clamp_min(win_lo, attention_sinks)
        band = ((win_lo // page)[:, None]
                + torch.arange(band_w if sink_pages else max_pages, device=dev)[None, :])
        slot = torch.cat([torch.arange(sink_pages, device=dev).expand(B, sink_pages), band], 1)
        lpage = slot
    slot_c = torch.clamp(torch.minimum(slot, last_live[:, None]), max=max_pages - 1)
    table_eff = torch.gather(cache.page_table, 1, slot_c.long())
    res = paged_decode_call(
        qt, cache.k8_pool, cache.ks_pool, cache.v_pool, cache.v_scale, cache.v_mean,
        table_eff, lengths, n_pages=n_pages, window=T if (is_causal and T > 1) else 1,
        lpage=lpage, win_lo=win_lo, sinks=attention_sinks, emit_state=return_state)
    out, lse = res if return_state else (res, None)
    if return_state:
        lse = lse[:, :, :rows] / LOG2E
        lse = lse.reshape(B, Hq, 1) if fold else lse
        # smooth-k repair: the pool stores K centered by k_mean, which shifts
        # the lse by -q.km * sm_scale (the output is shift-invariant)
        kmq = cache.k_mean.repeat_interleave(G, dim=1)
        lse = lse + (q.float() * kmq).sum(dim=-1) * sm_scale
    if fold:
        out = out.reshape(B, Hq, 1, D)
    (out,) = _to_hnd(tensor_layout, out)
    return (out, lse) if return_state else out
