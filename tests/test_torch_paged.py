"""The port's paged int8 KV cache and paged decode (D1's plain version)
against the JAX package's ``paged.py`` run in interpret mode, on the same
numpy inputs.

Bars: ``tests/test_paged.py``'s, 1.5e-3 calc_diff against the f32 oracle
(2.5e-3 for an e4m3 pool), the same between the two packages, 5e-4 for the
deferred and staged steps against classic steps, and 1.5e-1 (nat) for the
lse against the oracle's logsumexp.  D1's P stays bf16, so the two packages
differ only in the order of f32 sums: they are also held at 1e-4 apart.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import paged as jpg
from sageattention_tpu.ops.reference import sdpa as jsdpa
from sageattention_tpu.utils.testing import calc_diff
from sageattention_tpu_torch import paged as tpg
from sageattention_tpu_torch.ops import paged_decode as tpd

from port_cpu import yield_cpu  # noqa: F401  (one torch thread, low CPU priority)

BAR = 1.5e-3
FP8_BAR = 2.5e-3
PKG_BAR = 1e-4     # port vs JAX: the same bf16-P numerics, other sum orders
PAGE = 256


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) else x.float().numpy()


def _jit(fn, *args, **static):
    """``fn(*args, **static)`` under ``jax.jit``: the interpret-mode kernels
    compile once instead of running op by op (a few times faster here)."""
    return jax.jit(functools.partial(fn, **static))(*args)


def _mk(B, Hk, lengths, D, seed=0, s_pad=None, page=PAGE, bias=False):
    s_pad = s_pad or -(-max(lengths) // page) * page
    r = np.random.RandomState(seed)
    k = r.randn(B, Hk, s_pad, D).astype(np.float32)
    v = r.randn(B, Hk, s_pad, D).astype(np.float32)
    if bias:   # a large K mean: the lse's smooth-k repair is load-bearing
        k[..., :2] += np.array([7.0, -5.0], np.float32)
    return k, v


def _oracle(q, k, v, length, T=1, lo=0, sinks=0):
    """One sequence: q [Hq, T, D] over its true prefix (rows at the last T
    positions), optionally a window [lo, length) plus sinks [0, sinks)."""
    G = q.shape[0] // k.shape[0]
    idx = np.arange(length)
    if lo or sinks:
        idx = idx[(idx >= lo) | (idx < sinks)]
    kk, vv = np.repeat(k[:, idx], G, 0)[None], np.repeat(v[:, idx], G, 0)[None]
    mask = (idx[None, :] <= (length - T + np.arange(T))[:, None])[None, None]
    return np.asarray(_jit(jsdpa, jnp.asarray(q[None]), jnp.asarray(kk), jnp.asarray(vv),
                           mask=jnp.asarray(mask)))[0]


def _build(k, v, lengths, num_pages=64, shuffle_seed=None, extra=2, page=PAGE, **kw):
    per = k.shape[2] // page
    ja, ta = jpg.PageAllocator(num_pages, page), tpg.PageAllocator(num_pages, page)
    rows = [ja.reserve(per) for _ in lengths]
    assert rows == [ta.reserve(per) for _ in lengths]
    if shuffle_seed is not None:
        rng = np.random.RandomState(shuffle_seed)
        for r in rows:
            rng.shuffle(r)
    table = jpg.build_table(rows, per + extra)
    np.testing.assert_array_equal(table, tpg.build_table(rows, per + extra))
    jc = _jit(jpg.paged_prefill, jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
              jnp.asarray(table), num_pages=num_pages, page_size=page, **kw)
    tc = tpg.paged_prefill(torch.tensor(k), torch.tensor(v), torch.tensor(lengths), table,
                           num_pages=num_pages, page_size=page, **kw)
    return jc, tc, rows


def _same_pool(jc, tc):
    """Buffer by buffer: codes equal but for a few off by one, scales and
    means within 1e-6, the same table and lengths."""
    for name in ("k8_pool", "v_pool"):
        a, b = _np(getattr(jc, name)), _np(getattr(tc, name))
        if name == "v_pool" and tc.v_pool.dtype == torch.bfloat16:
            np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-6)
            continue
        assert (a != b).mean() <= 1e-3, name
        if name == "k8_pool" or tc.v_int8:
            assert np.abs(a - b).max() <= 1, name
    for name in ("ks_pool", "v_scale", "v_mean", "k_mean"):
        np.testing.assert_allclose(_np(getattr(jc, name)), _np(getattr(tc, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(np.asarray(jc.page_table), tc.page_table.numpy())
    np.testing.assert_array_equal(np.asarray(jc.lengths), tc.lengths.numpy())


def test_allocator_page_ids_match_jax():
    ja, ta = jpg.PageAllocator(40, PAGE), tpg.PageAllocator(40, PAGE)
    rng = np.random.RandomState(0)
    held = []
    for step in range(40):
        if held and rng.rand() < 0.4:
            i = rng.randint(len(held))
            pages = held.pop(i)
            ja.release(pages)
            ta.release(pages)
        else:
            n = int(rng.randint(1, 9))
            try:
                a = ja.reserve(n)
            except MemoryError:
                with pytest.raises(MemoryError):
                    ta.reserve(n)
                continue
            assert ta.reserve(n) == a, step
            held.append(a)
            if rng.rand() < 0.3:
                assert ta.share(a[:1]) == ja.share(a[:1])
                held.append(a[:1])
        assert ta.free_pages == ja.free_pages
    with pytest.raises(ValueError):
        tpg.build_table([[0, 1, 2]], max_pages=2)


@pytest.mark.parametrize("fmt", ["int8", "fp8", "bf16"])
def test_prefill_insert_append_buffers_match_jax(fmt):
    """Ragged prefill with dead table slots (a 500-token sequence in a
    768-token pad, a zero-length slot), an insert with ``start_page`` into
    the freed slot, appends crossing a page with one slot inactive."""
    B, Hk, D = 3, 2, 64
    lengths = [700, 500, 0]
    k, v = _mk(B, Hk, [768] * B, D, seed=1)
    jc, tc, rows = _build(k, v, lengths, v_format=fmt)
    _same_pool(jc, tc)
    kn, vn = _mk(1, Hk, [512], D, seed=2)
    pages = [rows[0][0], 40, 41]          # one cached prefix page, two fresh
    jc = jpg.paged_insert(jc, 2, jnp.asarray(kn[0, :, 256:]), jnp.asarray(vn[0, :, 256:]), 400,
                          pages, start_page=1)
    tc = tpg.paged_insert(tc, 2, torch.tensor(kn[0, :, 256:]), torch.tensor(vn[0, :, 256:]),
                          400, pages, start_page=1)
    _same_pool(jc, tc)
    active = np.array([True, False, True])
    for t in range(3):   # slot 0 crosses from page 2 into page 3 at 768
        ka, va = _mk(B, Hk, [1], D, seed=10 + t, s_pad=1)
        jc = jpg.paged_append(jc, jnp.asarray(ka), jnp.asarray(va), active=jnp.asarray(active))
        tc = tpg.paged_append(tc, torch.tensor(ka), torch.tensor(va), active=torch.tensor(active))
    _same_pool(jc, tc)
    assert tc.lengths.tolist() == [703, 500, 403]


CASES = {   # name: (B, Hq, Hk, lengths, D, T, fmt, sliding_window, sinks, s_pad)
    "ragged_t1": (3, 4, 4, [300, 512, 117], 64, 1, "int8", 0, 0, None),
    "gqa_fold_d128": (2, 8, 2, [400, 256], 128, 1, "int8", 0, 0, None),
    "window_t4": (2, 2, 2, [200, 301], 64, 4, "int8", 0, 0, None),
    "fp8": (2, 4, 2, [256, 192], 64, 1, "fp8", 0, 0, None),
    "bf16": (1, 2, 2, [300], 64, 1, "bf16", 0, 0, None),
    "sliding_128": (2, 4, 2, [520, 380], 64, 1, "int8", 128, 0, 768),
    "sliding_200": (2, 4, 2, [520, 380], 64, 1, "int8", 200, 0, 768),
    "sliding_128_sinks_16": (2, 4, 2, [520, 380], 64, 1, "int8", 128, 16, 768),
    "sliding_200_sinks_16": (2, 4, 2, [520, 380], 64, 1, "int8", 200, 16, 768),
}


@pytest.mark.parametrize("case", list(CASES))
def test_decode_paged_matches_jax_and_oracle(case):
    B, Hq, Hk, lengths, D, T, fmt, W, sinks, s_pad = CASES[case]
    k, v = _mk(B, Hk, lengths, D, seed=len(case), s_pad=s_pad)
    jc, tc, _ = _build(k, v, lengths, shuffle_seed=3, v_format=fmt)
    q = np.random.RandomState(5).randn(B, Hq, T, D).astype(np.float32)
    kw = dict(sliding_window=W, attention_sinks=sinks)
    jo = _np(_jit(jpg.sageattn_decode_paged, jnp.asarray(q), jc, interpret=True, **kw))
    to = tpg.sageattn_decode_paged(torch.tensor(q), tc, **kw)
    assert to.shape == q.shape and to.dtype == torch.bfloat16
    to = _np(to)
    bar = FP8_BAR if fmt == "fp8" else BAR
    for b in range(B):
        L = lengths[b]
        lo = max(max(0, L - W), sinks) if W else 0
        ref = _oracle(q[b], k[b], v[b], L, T, lo=lo, sinks=sinks if W else 0)
        assert calc_diff(to[b], ref) < bar, b
        assert calc_diff(jo[b], ref) < bar, b
    assert calc_diff(to, jo) < PKG_BAR


def test_nhd_bucket_and_page_sizes():
    B, Hq, Hk, D = 2, 4, 2, 64
    for page, lengths in ((128, [300, 129]), (512, [8 * 64 + 77, 513])):
        k, v = _mk(B, Hk, lengths, D, seed=page, page=page)
        _, tc, _ = _build(k, v, lengths, page=page)
        q = np.random.RandomState(1).randn(B, Hq, 1, D).astype(np.float32)
        out = tpg.sageattn_decode_paged(torch.tensor(q).transpose(1, 2), tc, tensor_layout="NHD",
                                        pages_bucket=tpg.pages_bucket_for(tc))
        for b in range(B):
            ref = _oracle(q[b], k[b], v[b], lengths[b])
            assert calc_diff(_np(out.transpose(1, 2)[b]), ref) < BAR, (page, b)


def test_return_state_lse_and_merged_steps():
    """``return_state``: the lse head-major [B, Hq, 1] against JAX's and the
    oracle's logsumexp; the deferred step and the staged block against
    classic append-then-decode steps."""
    B, Hq, Hk, D, lens = 2, 4, 2, 64, [300, 517]
    k, v = _mk(B, Hk, lens, D, seed=41, bias=True)
    jc, tc, _ = _build(k, v, lens, num_pages=16, shuffle_seed=3)
    r = np.random.RandomState(42)
    q = r.randn(B, Hq, 1, D).astype(np.float32)
    jo, jl = _jit(jpg.sageattn_decode_paged, jnp.asarray(q), jc, return_state=True,
                  interpret=True, pages_bucket=jpg.pages_bucket_for(jc))
    to, tl = tpg.sageattn_decode_paged(torch.tensor(q), tc, return_state=True,
                                       pages_bucket=tpg.pages_bucket_for(tc))
    assert tuple(tl.shape) == (B, Hq, 1)
    assert calc_diff(_np(to), _np(jo)) < PKG_BAR
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3)
    for b in range(B):
        s = np.einsum("htd,hsd->hts", q[b], np.repeat(k[b, :, :lens[b]], 2, 0)) / 8.0
        ref = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
        assert np.abs(tl[b].numpy() - ref).max() < 1.5e-1
    # NHD keeps the head-major lse
    _, tl_n = tpg.sageattn_decode_paged(torch.tensor(q).transpose(1, 2), tc, return_state=True,
                                        tensor_layout="NHD")
    assert torch.equal(tl_n, tl)

    k1 = r.randn(B, Hk, 1, D).astype(np.float32)
    v1 = r.randn(B, Hk, 1, D).astype(np.float32)
    bucket = tpg.pages_bucket_for(np.asarray(lens) + 4, PAGE)
    _, tc_a, _ = _build(k, v, lens, num_pages=16, shuffle_seed=3)
    ref = tpg.sageattn_decode_paged(torch.tensor(q), tpg.paged_append(
        tc_a, torch.tensor(k1), torch.tensor(v1)), pages_bucket=bucket)
    out, tc2 = tpg.paged_decode_step_deferred(torch.tensor(q), tc, torch.tensor(k1),
                                              torch.tensor(v1), pages_bucket=bucket)
    assert calc_diff(out.float(), ref.float()) < 5e-4
    assert tc2.lengths.tolist() == [L + 1 for L in lens]

    T = 4
    qs = r.randn(T, B, Hq, 1, D).astype(np.float32)
    kn = r.randn(T, B, Hk, 1, D).astype(np.float32)
    vn = r.randn(T, B, Hk, 1, D).astype(np.float32)
    _, c, _ = _build(k, v, lens, num_pages=16, shuffle_seed=3)
    refs = []
    for t in range(T):
        c = tpg.paged_append(c, torch.tensor(kn[t]), torch.tensor(vn[t]))
        refs.append(tpg.sageattn_decode_paged(torch.tensor(qs[t]), c, pages_bucket=bucket))
    _, c0, _ = _build(k, v, lens, num_pages=16, shuffle_seed=3)
    outs, c2 = tpg.paged_decode_block_staged(torch.tensor(qs), c0, torch.tensor(kn),
                                             torch.tensor(vn), pages_bucket=bucket)
    assert calc_diff(outs.float(), torch.stack(refs).float()) < 5e-4
    assert c2.lengths.tolist() == [L + T for L in lens]


def test_kernel_plain_walks_splits_exactly():
    """D1's plain version against float64 attention over the same operands
    (q rounded to bf16 after the scale, K codes x per-token scales, V codes
    x scale + mean): only the bf16 rounding of P is left."""
    B, Hq, Hk, D, lens = 2, 8, 2, 64, [700, 333]
    k, v = _mk(B, Hk, lens, D, seed=9)
    _, tc, _ = _build(k, v, lens)
    q = np.random.RandomState(9).randn(B, Hq, 1, D).astype(np.float32)
    out = tpg.sageattn_decode_paged(torch.tensor(q), tc).double()
    qs = (torch.tensor(q).float() * np.float32(D ** -0.5 * 1.4426950408889634)).bfloat16().double()
    for b in range(B):
        L = lens[b]
        pages = tc.page_table[b, :-(-L // PAGE)].long()
        kd = (tc.k8_pool[pages].double() * tc.ks_pool[pages, :, 0, :, None].double())
        kd = kd.permute(1, 0, 2, 3).reshape(Hk, -1, D)[:, :L]
        vd = (tc.v_pool[pages].double() * tc.v_scale[0].double()[None] + tc.v_mean[0].double()[None])
        vd = vd.permute(1, 0, 2, 3).reshape(Hk, -1, D)[:, :L]
        s = torch.matmul(qs[b], kd.repeat_interleave(4, 0).transpose(-1, -2))
        ref = torch.matmul(torch.softmax(s * np.log(2.0), -1), vd.repeat_interleave(4, 0))
        assert calc_diff(out[b], ref) < 2e-5, b


def test_errors_jax_raises_the_port_raises():
    B, H, D = 1, 2, 64
    k, v = _mk(B, H, [300], D)
    jc, tc, _ = _build(k, v, [300])
    for mod, c, conv in ((jpg, jc, jnp.asarray), (tpg, tc, lambda x: torch.tensor(np.asarray(x)))):
        kw = {"interpret": True} if mod is jpg else {}
        q1 = conv(np.zeros((B, H, 1, D), np.float32))
        with pytest.raises(ValueError, match="sliding_window"):
            mod.sageattn_decode_paged(q1, c, attention_sinks=4, **kw)
        with pytest.raises(ValueError, match="T=1"):
            mod.sageattn_decode_paged(conv(np.zeros((B, H, 4, D), np.float32)), c,
                                      sliding_window=128, **kw)
        with pytest.raises(ValueError):
            mod.sageattn_decode_paged(q1, c, sliding_window=128, return_state=True, **kw)
        with pytest.raises(ValueError):                   # 3 % 2 != 0
            mod.sageattn_decode_paged(conv(np.zeros((B, 3, 1, D), np.float32)), c, **kw)
        with pytest.raises(ValueError):                   # window > 32 rows
            mod.sageattn_decode_paged(conv(np.zeros((B, H, 64, D), np.float32)), c, **kw)
        with pytest.raises(ValueError):
            mod.sageattn_decode_paged(q1, c, pages_bucket=99, **kw)


def test_launch_keys():
    assert tpd.config_name(torch.int8, 1, False, 0, False) == "D1-int8"
    assert tpd.config_name(torch.float8_e4m3fn, 4, False, 0, False) == "D1-fp8-causal"
    assert tpd.config_name(torch.bfloat16, 1, True, 16, False) == "D1-bf16-sinks"
    assert tpd.config_name(torch.int8, 1, False, 0, True) == "D1-int8-state"
    assert len(tpd.LAUNCH_KEYS) == 24 and set(tpd.paged_decode_call.launches) == set(
        tpd.LAUNCH_KEYS)
