"""Serving runtime: automatic prefix caching over the paged KV pool
(counterpart of ``sageattention_tpu/serving.py``).

The host half of a continuous-batching server: admission decides, per
request, which pages already hold the prompt's prefix (quantized by an
earlier request) and which must be filled fresh.  A shared system prompt is
quantized once; a later request's prefill runs only on its suffix
(``paged.paged_insert(..., start_page=...)``) and its table row points at
the shared pages, which is exact because the pool's statistics are global.

Host-only Python: the port keeps its own copy of the JAX package's pure
Python page pool and radix trie.  The JAX package's native C++ runtime is
not ported yet (``use_native=True`` raises).

Typical flow::

    alloc = PrefixCachingAllocator(num_pages=4096, page_size=256)
    adm = alloc.admit(tokens)           # longest cached prefix + fresh pages
    cache = paged_insert(cache, slot, k_suffix, v_suffix, len(tokens),
                         adm.pages, start_page=adm.n_cached_pages)
    alloc.commit(tokens, adm.pages)     # publish this prompt's full blocks
    ...
    alloc.release(adm.pages)            # request finished
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

HAVE_NATIVE = False


class Admission(NamedTuple):
    pages: list          # full table row: cached prefix pages + fresh pages
    n_cached_pages: int  # leading entries of `pages` reused from the cache
    new_pages: list      # = pages[n_cached_pages:] (fresh, to be filled)


class _PyPagePool:
    """Refcounted free-list page pool (the JAX package's Python fallback)."""

    def __init__(self, num_pages: int):
        self._free = list(range(num_pages - 1, -1, -1))
        self._refs = [0] * num_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def reserve(self, n: int) -> list:
        if n > len(self._free):
            raise MemoryError(f"page pool exhausted: need {n}, "
                              f"have {len(self._free)}")
        # aligned runs of 4 pages first, then the rest ascending: the JAX
        # package's order, so both hand out the same page ids
        R = 4
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
        for p in take:
            self._refs[p] = 1
        return take

    def share(self, pages: Sequence[int]) -> list:
        for p in pages:
            self._refs[p] += 1
        return list(pages)

    def release(self, pages: Sequence[int]) -> None:
        for p in pages:
            if self._refs[p] <= 0:
                raise ValueError("double release")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)


class _PyRadixCache:
    """Radix trie over page-sized token blocks with LRU eviction (the JAX
    package's Python fallback)."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._clock = 0
        # node id -> (parent, page, lru, children); 0 is the root
        self._nodes = {0: [-1, -1, 0, 0]}
        self._edges = {}      # (parent, block tokens tuple) -> node id
        self._next = 1

    @property
    def size(self) -> int:
        return len(self._nodes) - 1

    def match(self, tokens: Sequence[int]) -> list:
        self._clock += 1
        cur, pages = 0, []
        ps = self.page_size
        for off in range(0, len(tokens) - ps + 1, ps):
            child = self._edges.get((cur, tuple(tokens[off:off + ps])))
            if child is None:
                break
            self._nodes[child][2] = self._clock
            pages.append(self._nodes[child][1])
            cur = child
        return pages

    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               start_block: int) -> None:
        ps = self.page_size
        full = len(tokens) // ps
        if len(pages) < full:
            raise ValueError("need one page id per full token block")
        self._clock += 1
        cur = 0
        for blk in range(full):
            key = (cur, tuple(tokens[blk * ps:(blk + 1) * ps]))
            child = self._edges.get(key)
            if blk < start_block:
                if child is None:
                    return  # prefix chain broken (evicted) — stop
                self._nodes[child][2] = self._clock
                cur = child
                continue
            if child is not None:
                self._nodes[child][2] = self._clock
                cur = child
                continue
            nid = self._next
            self._next += 1
            self._nodes[nid] = [cur, pages[blk], self._clock, 0]
            self._edges[key] = nid
            self._nodes[cur][3] += 1
            cur = nid

    def evict(self, n: int) -> list:
        freed = []
        while len(freed) < n:
            leaves = [(v[2], k) for k, v in self._nodes.items()
                      if k != 0 and v[3] == 0]
            if not leaves:
                break
            _, nid = min(leaves)
            parent, page = self._nodes[nid][0], self._nodes[nid][1]
            self._nodes[parent][3] -= 1
            del self._nodes[nid]
            self._edges = {k: v for k, v in self._edges.items() if v != nid}
            freed.append(page)
        return freed


class PrefixCachingAllocator:
    """Page allocation with automatic prefix caching (radix-trie lookup).

    Semantics (the JAX package's):

    - ``admit(tokens)``: the longest cached prefix of FULL page-sized token
      blocks is reused (those pages gain a reference); fresh pages are
      reserved for the rest, evicting least-recently-used cached blocks if
      the free list is short.  Returns the full table row.
    - ``commit(tokens, pages)``: publish a prompt's full blocks into the
      trie after its suffix is quantized (the trie holds its own reference
      on each published page, so cached data survives request exit).
    - ``release(pages)``: drop a finished request's references.
    """

    def __init__(self, num_pages: int, page_size: int = 256,
                 use_native: Optional[bool] = None):
        if use_native:
            raise RuntimeError("the native serving runtime (_sageattn_serving) is not part "
                               "of the port yet; use the Python pool and trie")
        self.page_size = page_size
        self.native = False
        self._pool = _PyPagePool(num_pages)
        self._radix = _PyRadixCache(page_size)

    @property
    def free_pages(self) -> int:
        return self._pool.free_pages

    @property
    def cached_blocks(self) -> int:
        return self._radix.size

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.page_size)

    def admit(self, tokens: Sequence[int]) -> Admission:
        tokens = [int(t) for t in tokens]
        cached = self._radix.match(tokens)
        need = self.pages_for(len(tokens)) - len(cached)
        # evict cold cached blocks if the free list is short (their pages
        # are refcounted by the trie alone once no request holds them)
        short = need - self._pool.free_pages
        if short > 0:
            freed = self._radix.evict(short)
            self._pool.release(freed)
            if need > self._pool.free_pages:
                raise MemoryError(
                    f"page pool exhausted: need {need}, have "
                    f"{self._pool.free_pages} after evicting {len(freed)}")
        self._pool.share(cached)
        new = self._pool.reserve(need)
        return Admission(pages=cached + new, n_cached_pages=len(cached),
                         new_pages=new)

    def commit(self, tokens: Sequence[int], pages: Sequence[int]) -> None:
        tokens = [int(t) for t in tokens]
        full = len(tokens) // self.page_size
        pages = [int(p) for p in pages[:full]]
        before = self._radix.size
        # trie takes its own reference on every block it NEWLY holds
        self._radix.insert(tokens, pages, 0)
        added = self._radix.size - before
        if added > 0:
            # the newly published blocks are the TRAILING ones (prefix
            # blocks were already present)
            self._pool.share(pages[full - added:])

    def release(self, pages: Sequence[int]) -> None:
        self._pool.release([int(p) for p in pages])
