"""D1-int8, the paged int8 decode, on its Hopper route
(``csrc/paged_decode_sm90.cu``): which launches ``d1_sm90_route`` takes,
the launch keys of both modules unchanged, what ``paged_decode_kernel``
hands the entry (recorded, not run: no card here), that a failed launch
raises, and the plain version's walk, which follows the kernel's shares
(``sm90_decode_splits``, at least ``SM90_DECODE_MIN_TILES`` tiles a share,
which csrc/decode_sm90.cu's B11 shares too), against the JAX
package's ``paged_decode_call(interpret=True)`` under ``jax.jit``: a
sequence of length 0, 1, a page boundary and one past it, pages out of
order, a T = 4 causal window over GQA heads, a sliding window whose lower
bound falls inside a page with sinks covering part of a page, ``emit_state``
with a row that sees no key, and a stream cut into a dozen shares.

Inputs are random int8 codes and f32 scales from a numpy seed, with a
bf16-exact Q.  Bar (tests/test_torch_paged.py's PKG_BAR): port vs JAX
calc_diff < 1e-4, the same bf16-P numerics over other tiles (JAX walks
whole pages, the port 64-token tiles in shares) and sum orders; the base-2
lse within 1e-3 of JAX's, and -1e30 in both where a row sees no key.
"""

import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu.ops import paged_decode as jpd
from sageattention_tpu_torch.ops import _build
from sageattention_tpu_torch.ops import attention as tatt
from sageattention_tpu_torch.ops import paged_decode as tpd
from sageattention_tpu_torch.utils.testing import calc_diff

from port_cpu import yield_cpu  # noqa: F401  (one torch thread, low CPU priority)

PKG_BAR = 1e-4
LSE_ATOL = 1e-3
TQ = 32   # the JAX kernel's query rows


def _pools(rng, P, Hk, page, D):
    k8 = rng.integers(-127, 128, (P, Hk, page, D)).astype(np.int8)
    v8 = rng.integers(-127, 128, (P, Hk, page, D)).astype(np.int8)
    ks = (rng.random((P, Hk, 1, page)) * 0.02 + 0.005).astype(np.float32)
    vs = (rng.random((1, Hk, 1, D)) * 0.02 + 0.01).astype(np.float32)
    vm = (rng.standard_normal((1, Hk, 1, D)) * 0.1).astype(np.float32)
    return k8, ks, v8, vs, vm


def _q(rng, B, Hg, R, D):
    """A bf16-exact Q, pre-scaled as the host folds sm_scale * log2(e)."""
    q = rng.standard_normal((B, Hg, R, D)).astype(np.float32) * (D ** -0.5 * 1.4426950408889634)
    return torch.from_numpy(q).to(torch.bfloat16)


def _stream(table, lens, page, n_pages, window=0, sinks=0):
    """``sageattn_decode_paged``'s stream: the effective table (dead slots
    clamped to the last live page), and for a sliding window the logical
    page of each slot (sink slots, then the band) and its lower bound."""
    B, max_pages = table.shape
    lens = np.asarray(lens)
    last = np.maximum(lens - 1, 0) // page
    slot = np.broadcast_to(np.arange(max_pages), (B, max_pages))
    lpage = lo = None
    if window:
        lo = np.maximum(lens - window, 0)
        if sinks:
            lo = np.maximum(lo, sinks)
        sink_pages = -(-sinks // page) if sinks else 0
        band = (lo // page)[:, None] + np.arange(n_pages - sink_pages)[None, :]
        slot = np.concatenate([np.broadcast_to(np.arange(sink_pages), (B, sink_pages)), band], 1)
        lpage = slot.astype(np.int32)
    slot_c = np.clip(np.minimum(slot, last[:, None]), None, max_pages - 1)
    return (np.take_along_axis(table, slot_c, 1).astype(np.int32), lpage,
            None if lo is None else lo.astype(np.int32))


@functools.lru_cache(maxsize=None)
def _jax_fn(n_pages, window, sinks, emit_state, sliding):
    def run(q, k8, ks, v8, vs, vm, table, lens, lpage, lo):
        return jpd.paged_decode_call(q, k8, ks, v8, vs, vm, table, lens, n_pages=n_pages,
                                     window=window, lpage=lpage if sliding else None,
                                     win_lo=lo if sliding else None, sinks=sinks,
                                     emit_state=emit_state, interpret=True)
    return jax.jit(run)


# (label, B, Hg, Hk, R, D, page, lens, n_pages, T, window, sinks, emit_state, shuffle)
CASES = [
    ("tail: lengths 0, 1, a page boundary and one past it", 4, 2, 2, 2, 64, 128,
     (0, 1, 256, 257), 3, 1, 0, 0, True, True),
    ("T = 4 window over 2 GQA heads a KV head", 2, 4, 2, 4, 128, 128, (300, 517), 5, 4, 0, 0,
     False, True),
    ("sliding window inside a page, 4 sinks", 2, 2, 2, 4, 64, 128, (700, 450), 4, 1, 200, 4,
     False, False),
    ("a dozen shares", 1, 1, 1, 4, 128, 128, (3000,), 24, 1, 0, 0, True, True),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0].split(":")[0] for c in CASES])
def test_plain_matches_jax(case, monkeypatch):
    """The plain version, walking the kernel's shares of 64-token tiles,
    against JAX's page-by-page kernel in interpret mode."""
    label, B, Hg, Hk, R, D, page, lens, n_pages, T, window, sinks, emit_state, shuffle = case
    rng = np.random.default_rng(CASES.index(case))
    max_pages = n_pages + 1
    P = B * max_pages + 2
    k8, ks, v8, vs, vm = _pools(rng, P, Hk, page, D)
    ids = rng.permutation(P)[:B * max_pages] if shuffle else np.arange(B * max_pages)
    table = ids.reshape(B, max_pages).astype(np.int32)   # pages out of order
    table_eff, lpage, lo = _stream(table, lens, page, n_pages, window, sinks)
    q = _q(rng, B, Hg, R, D)
    walks = []
    real = tpd.split_online_plain
    monkeypatch.setattr(tpd, "split_online_plain",
                        lambda *a: walks.append(a[3:]) or real(*a))
    t = lambda x: None if x is None else torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    out, lse = tpd.paged_decode_plain(
        q, t(k8), t(ks), t(v8), t(vs), t(vm), t(table_eff), torch.tensor(lens, dtype=torch.int32),
        n_pages=n_pages, window=T, lpage=t(lpage), win_lo=t(lo), sinks=sinks,
        emit_state=emit_state)
    n_units = n_pages * (page // tatt.KV_TILE)
    assert walks == [(tatt.sm90_decode_splits(B, Hk, n_units), tatt.SM90_DECODE_MIN_TILES)] * B
    qp = np.zeros((B, Hg, TQ, D), np.float32)
    qp[:, :, :R] = q.float().numpy()
    lo_j = np.zeros(B, np.int32) if lo is None else lo
    lp_j = table_eff if lpage is None else lpage
    res = _jax_fn(n_pages, T, sinks, emit_state, window > 0)(
        jnp.asarray(qp, jnp.bfloat16), *(jnp.asarray(x) for x in (k8, ks, v8, vs, vm)),
        jnp.asarray(table_eff), jnp.asarray(np.asarray(lens, np.int32)), jnp.asarray(lp_j),
        jnp.asarray(lo_j))
    jo, jl = res if emit_state else (res, None)
    jo = torch.from_numpy(np.array(jo.astype(jnp.float32)))[:, :, :R]
    assert out.shape == (B, Hg, R, D) and out.dtype == torch.bfloat16
    assert calc_diff(out.float(), jo) < PKG_BAR, label
    if emit_state:
        jl = torch.from_numpy(np.array(jl))[:, :, :R, 0]
        seen = lse > -1e29
        assert torch.equal(seen, jl > -1e29), label
        assert bool(seen.any()) and (not (0 in lens) or not bool(seen.all()))
        torch.testing.assert_close(lse[seen], jl[seen], atol=LSE_ATOL, rtol=0)
        assert bool((lse[~seen] == -1e30).all())


def test_route_and_launch_keys():
    """``d1_sm90_route`` takes an int8 V pool at head dims 64 and 128 and
    declines e4m3 and bf16 pools and D = 256; the launch keys of D1 and of
    the attention module are those they were."""
    for dt in (torch.int8, torch.float8_e4m3fn, torch.bfloat16):
        for D in (64, 128, 256):
            assert tpd.d1_sm90_route(dt, D) == (dt == torch.int8 and D < 256), (dt, D)
    assert tpd.LAUNCH_KEYS == tuple(
        f"D1-{fmt}{w}{s}" for fmt in ("int8", "fp8", "bf16")
        for w in ("", "-causal", "-sliding", "-sinks") for s in ("", "-state"))
    digest = hashlib.sha256("\n".join(tatt.LAUNCH_KEYS).encode()).hexdigest()[:16]
    assert (len(tatt.LAUNCH_KEYS), digest) == (245, "77f5dffabd22793c")


def test_shares_and_heads_per_block():
    """The Hopper decode kernels' shares (D1's and B11's): up to 16 a
    sequence, more when B * Hk is small, never more than 4-tile shares
    need; the query heads of a KV head share a block within 64 rows (B11's
    rows past 64, one head a block)."""
    splits, hpb = tatt.sm90_decode_splits, tatt.sm90_heads_per_block
    assert splits(8, 8, 68) == 16      # 8 slots, pages of 256, 17 a slot
    assert splits(1, 8, 129) == 33     # one sequence: 264 blocks
    assert splits(8, 8, 8) == 2 and splits(8, 8, 1) == 1
    assert splits(8, 8, 516) == 16
    assert [hpb(4, R) for R in (1, 4, 16, 25, 32, 36)] == [4, 4, 4, 2, 2, 1]
    assert hpb(1, 32) == 1 and hpb(8, 16) == 4 and hpb(1, 65) == 1 and hpb(2, 64) == 1
    # plain: shares of max(4, ceil(live / n_split)) tiles, merged exactly
    rng = np.random.default_rng(0)
    s = torch.from_numpy(rng.standard_normal((2, 3, 10 * 64)).astype(np.float32)) * 8
    vf = torch.from_numpy(rng.standard_normal((2, 10 * 64, 64)).astype(np.float32))
    m1, l1, a1 = tatt.split_online_plain(s, vf, "bf16", 16, 4)   # shares 4, 4, 2
    m2, l2, a2 = tatt.split_online_plain(s, vf, "bf16", 3)       # the same shares
    assert torch.equal(m1, m2) and torch.equal(l1, l2) and torch.equal(a1, a2)


def _call_args(rng, B, Hg, Hk, R, D, page, lens, n_pages, window=0, sinks=0, v_dtype=torch.int8):
    max_pages = n_pages + 1
    P = B * max_pages
    k8, ks, v8, vs, vm = (torch.from_numpy(x) for x in _pools(rng, P, Hk, page, D))
    if v_dtype != torch.int8:
        v8 = v8.float().to(v_dtype)
    table = np.arange(P, dtype=np.int32).reshape(B, max_pages)
    table_eff, lpage, lo = _stream(table, lens, page, n_pages, window, sinks)
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    args = (_q(rng, B, Hg, R, D), k8, ks, v8, vs, vm, t(table_eff),
            torch.tensor(lens, dtype=torch.int32))
    return args, dict(n_pages=n_pages, window=1, lpage=t(lpage), win_lo=t(lo), sinks=sinks)


def _record(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "call", lambda fn, device, *args: calls.append((fn, args)))
    return calls


# positions in sage_paged_decode_sm90's arguments
STRIDES_AT, STREAM_AT, SHAPE_AT, VS_AT = 6, 14, 18, 30


@pytest.mark.parametrize("what", ["folded, state", "T = 4, GQA heads in a block",
                                  "sliding with sinks"])
def test_dispatch(monkeypatch, what):
    """D1-int8 goes to ``sage_paged_decode_sm90``: the pools in place with
    their strides, the K scales as ``[P, Hk, page]`` in place, the stream
    (lengths, table, logical pages, window bound) as device int32 pointers,
    the heads a block, the shares ``sm90_decode_splits`` gives and the scratch they
    need; the launch key is counted once."""
    calls = _record(monkeypatch)
    rng = np.random.default_rng(11)
    if what.startswith("folded"):
        B, Hg, Hk, R, D, window, sinks, T, state = 8, 8, 8, 4, 128, 0, 0, 1, True
    elif what.startswith("T = 4"):
        B, Hg, Hk, R, D, window, sinks, T, state = 2, 8, 2, 4, 64, 0, 0, 4, False
    else:
        B, Hg, Hk, R, D, window, sinks, T, state = 2, 2, 2, 4, 64, 300, 4, 1, False
    page, n_pages = 256, 6
    args, kw = _call_args(rng, B, Hg, Hk, R, D, page, [1000, 700] + [300] * (B - 2), n_pages,
                          window, sinks)
    kw.update(window=T, emit_state=state)
    name = tpd.config_name(torch.int8, T, window > 0, sinks, state)
    before = tpd.paged_decode_call.launches[name]
    out, lse = tpd.paged_decode_kernel(*args, **kw)
    assert tpd.paged_decode_call.launches[name] == before + 1
    assert [fn for fn, _ in calls] == ["sage_paged_decode_sm90"]
    a = calls[0][1]
    q, k8, ks, v8 = args[:4]
    hpb = tatt.sm90_heads_per_block(Hg // Hk, R)
    n_units = n_pages * page // 64
    n_split = tatt.sm90_decode_splits(B, Hk, n_units)
    assert a[:6] == (D, hpb, q.data_ptr(), k8.data_ptr(), v8.data_ptr(), ks.data_ptr())
    assert a[STRIDES_AT:STREAM_AT] == (*k8.stride()[:3], *v8.stride()[:3], Hk * page, page)
    assert all(isinstance(x, int) for x in a[STREAM_AT:STREAM_AT + 3])   # device pointers
    assert (a[STREAM_AT + 3] is None) == (window == 0)
    assert a[SHAPE_AT:VS_AT] == (B, k8.shape[0], Hg, Hk, R, n_units, n_pages, page, T, sinks,
                                 -(-sinks // page) if sinks else 0, n_split)
    assert a[VS_AT:VS_AT + 2] != (None, None) and (a[-1] is None) == (not state)
    assert out.shape == (B, Hg, R, D) and out.dtype == torch.bfloat16
    assert (lse is None) == (not state)


@pytest.mark.parametrize("v_dtype,D", [(torch.float8_e4m3fn, 128), (torch.bfloat16, 64),
                                       (torch.int8, 256)])
def test_outside_the_route_stays_on_decode_cu(monkeypatch, v_dtype, D):
    """e4m3 and bf16 pools and D = 256 stay on ``csrc/decode.cu``'s entry,
    whose plain walk keeps ``decode_splits``."""
    calls = _record(monkeypatch)
    rng = np.random.default_rng(12)
    args, kw = _call_args(rng, 2, 2, 2, 4, D, 128, [300, 200], 3, v_dtype=v_dtype)
    tpd.paged_decode_kernel(*args, **kw)
    assert [fn for fn, _ in calls] == ["sage_decode"]
    assert calls[0][1][-14] == tatt.decode_splits(2, 2)   # n_split


def test_a_failed_launch_raises(monkeypatch):
    """An error code from the entry raises with its message: nothing falls
    back to ``decode.cu`` or to the plain version."""
    class Lib:
        calls = []

        def sage_paged_decode_sm90(self, *args):
            self.calls.append(args)
            return -2

        def sage_paged_decode_sm90_error_string(self, e):
            return b"cuTensorMapEncodeTiled failed"

    lib = Lib()
    monkeypatch.setattr(_build, "build_all", lambda: {"paged_decode_sm90": lib})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    args, kw = _call_args(np.random.default_rng(13), 1, 2, 2, 1, 64, 128, [200], 2)
    with pytest.raises(RuntimeError, match="sage_paged_decode_sm90 failed to launch: "
                                           "cuTensorMapEncodeTiled failed"):
        tpd.paged_decode_kernel(*args, **kw)
    assert len(lib.calls) == 1
