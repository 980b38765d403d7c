"""The port's prefix-caching allocator (``serving.py``) against the JAX
package's Python backend, and the suffix prefill of a shared prompt through
the port's ``paged_insert``.  The cases of ``tests/test_serving_runtime.py``
run on the port's allocator; a randomized trace holds both packages to the
same admissions, free pages and cached blocks."""

import numpy as np
import pytest
import torch

from sageattention_tpu import serving as jserving
from sageattention_tpu_torch import serving as tserving
from sageattention_tpu_torch.paged import (build_table, paged_insert, paged_prefill,
                                           pages_bucket_for, sageattn_decode_paged)
from sageattention_tpu_torch.serving import PrefixCachingAllocator
from sageattention_tpu_torch.utils.testing import calc_diff


def test_reserve_release():
    a = PrefixCachingAllocator(8, page_size=4)
    adm = a.admit(list(range(10)))
    assert adm.n_cached_pages == 0 and len(adm.pages) == 3 and a.free_pages == 5
    a.release(adm.pages)
    assert a.free_pages == 8


def test_exhaustion_and_double_release_raise():
    a = PrefixCachingAllocator(2, page_size=4)
    a.admit(list(range(8)))
    with pytest.raises(MemoryError):
        a.admit(list(range(100, 140)))
    a = PrefixCachingAllocator(4, page_size=4)
    adm = a.admit(list(range(4)))
    a.release(adm.pages)
    with pytest.raises(ValueError):
        a.release(adm.pages)


def test_second_request_reuses_prefix_and_partial_blocks_never_cached():
    a = PrefixCachingAllocator(16, page_size=4)
    sys_prompt = list(range(8))
    t1 = sys_prompt + [50, 51, 52, 53, 54]
    adm1 = a.admit(t1)
    a.commit(t1, adm1.pages)
    assert a.cached_blocks == 3
    adm2 = a.admit(sys_prompt + [70, 71, 72])
    assert adm2.n_cached_pages == 2 and adm2.pages[:2] == adm1.pages[:2]
    assert len(adm2.new_pages) == 1
    b = PrefixCachingAllocator(16, page_size=4)
    t = list(range(6))
    adm = b.admit(t)
    b.commit(t, adm.pages)
    assert b.cached_blocks == 1 and b.admit(list(range(6))).n_cached_pages == 1


def test_cached_pages_survive_exit_and_lru_eviction():
    a = PrefixCachingAllocator(16, page_size=4)
    t = list(range(8))
    adm = a.admit(t)
    a.commit(t, adm.pages)
    a.release(adm.pages)
    assert a.free_pages == 14
    adm2 = a.admit(t)
    assert adm2.n_cached_pages == 2 and adm2.pages == adm.pages
    a = PrefixCachingAllocator(4, page_size=4)
    t1, t2 = list(range(8)), list(range(100, 108))
    for tt in (t1, t2):
        adm = a.admit(tt)
        a.commit(tt, adm.pages)
        a.release(adm.pages)
    assert a.free_pages == 0 and a.cached_blocks == 4
    a.admit(list(range(200, 208)))       # evicts t1, the least recently used
    assert a.cached_blocks == 2 and a.admit(t1).n_cached_pages == 0


def test_commit_idempotent_and_native_raises():
    a = PrefixCachingAllocator(8, page_size=4)
    t = list(range(8))
    adm = a.admit(t)
    a.commit(t, adm.pages)
    a.commit(t, adm.pages)
    a.release(adm.pages)
    assert a.free_pages == 6
    freed = a._radix.evict(5)
    a._pool.release(freed)
    assert sorted(freed) == sorted(adm.pages) and a.free_pages == 8
    assert not tserving.HAVE_NATIVE
    with pytest.raises(RuntimeError, match="native"):
        PrefixCachingAllocator(8, page_size=4, use_native=True)


def test_randomized_trace_matches_jax():
    rng = np.random.RandomState(0)
    ja = jserving.PrefixCachingAllocator(64, page_size=4, use_native=False)
    ta = PrefixCachingAllocator(64, page_size=4)
    prompts = [list(rng.randint(0, 5, rng.randint(4, 20))) for _ in range(12)]
    live = []
    for step in range(80):
        op = rng.randint(3)
        if op < 2 or not live:
            t = prompts[rng.randint(len(prompts))]
            try:
                a1 = ja.admit(t)
            except MemoryError:
                with pytest.raises(MemoryError):
                    ta.admit(t)
                continue
            a2 = ta.admit(t)
            assert tuple(a1) == tuple(a2), step
            if op == 1:
                ja.commit(t, a1.pages)
                ta.commit(t, a2.pages)
            live.append(a1.pages)
        else:
            pages = live.pop(rng.randint(len(live)))
            ja.release(pages)
            ta.release(pages)
        assert ja.free_pages == ta.free_pages and ja.cached_blocks == ta.cached_blocks, step


def test_suffix_prefill_matches_oracle():
    """Request B reuses request A's two prefix pages and quantizes only its
    suffix (``paged_insert(start_page=2)``); both decode against their own
    f32 oracle (``tests/test_serving_runtime.py``'s bar, 2e-2 relative
    max error) and at the decode bar (1.5e-3 calc_diff)."""
    PAGE, Hk, Hq, D = 256, 2, 4, 64
    S_a, prefix = 768, 512
    r = np.random.RandomState(0)
    k_a, v_a = (r.randn(Hk, S_a, D).astype(np.float32) for _ in range(2))
    k_b = np.concatenate([k_a[:, :prefix], r.randn(Hk, PAGE, D).astype(np.float32)], 1)
    v_b = np.concatenate([v_a[:, :prefix], r.randn(Hk, PAGE, D).astype(np.float32)], 1)
    tok_a = list(range(S_a))
    tok_b = tok_a[:prefix] + list(range(1000, 1000 + PAGE))
    alloc = PrefixCachingAllocator(16, page_size=PAGE)
    adm_a = alloc.admit(tok_a)
    table = build_table([adm_a.pages, [0, 0, 0]], max_pages=3)
    kz = torch.tensor(np.stack([k_a, np.zeros_like(k_a)]))
    vz = torch.tensor(np.stack([v_a, np.zeros_like(v_a)]))
    cache = paged_prefill(kz, vz, torch.tensor([S_a, 0]), table, num_pages=16, page_size=PAGE)
    alloc.commit(tok_a, adm_a.pages)
    adm_b = alloc.admit(tok_b)
    assert adm_b.n_cached_pages == 2 and adm_b.pages[:2] == adm_a.pages[:2]
    cache = paged_insert(cache, 1, torch.tensor(k_b[:, prefix:]), torch.tensor(v_b[:, prefix:]),
                         S_a, adm_b.pages, start_page=adm_b.n_cached_pages)
    q = r.randn(2, Hq, 1, D).astype(np.float32)
    out = sageattn_decode_paged(torch.tensor(q), cache, pages_bucket=pages_bucket_for(cache))
    for b, (kk, vv) in enumerate(((k_a, v_a), (k_b, v_b))):
        s = np.einsum("hd,hsd->hs", q[b, :, 0].astype(np.float64),
                      np.repeat(kk, 2, 0).astype(np.float64)) / np.sqrt(D)
        p = np.exp(s - s.max(-1, keepdims=True))
        ref = np.einsum("hs,hsd->hd", p / p.sum(-1, keepdims=True), np.repeat(vv, 2, 0))
        o = out[b, :, 0].float().numpy()
        assert np.abs(o - ref).max() / np.abs(ref).max() < 0.02, b
        assert calc_diff(o, ref) < 1.5e-3, b
