"""The masked bf16 backward on ``csrc/backward_sm90.cu`` (``ops/backward.py``'s
``bwd_tile_lists`` and ``sage_bwd_sm90_masked``): C1 and C2 under a causal
sliding window with or without sinks, or a bool keep-mask.

- the kernels' tile lists against the kept set ``_keep`` gives, pair by
  pair: every kept pair lies in a listed tile of a live slice, a full
  class keeps every pair of its tile, a dead one none, a class cut by
  positions alone (3) reads no mask byte it needs, a tile no slice of a
  block needs is left out, and the blocks launch longest list first;
- what ``attention_backward_kernel`` hands the masked entry (``_build.call``
  recorded): each kernel's lists and order, the mask in place, the launch
  keys, and a failed launch raising with nothing else tried;
- the backward through ``attention_backward`` at shapes whose 128- and
  192-row blocks cut the band and the mask apart from the 64-row tiles,
  against the JAX package's ``attention_backward_pallas`` run in interpret
  mode and float64 autodiff of exact attention, on the same numpy inputs.
  No card here: the gradients come from the plain version, which is the
  kernels' on a CUDA tensor.  Bars as ``tests/test_torch_backward.py``:
  calc_diff < 1e-4 against JAX, relative max error < 3e-2 against exact.

Alone: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_bwd_sm90_masked.py -q``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu.ops.backward_pallas import attention_backward_pallas
from sageattention_tpu.utils.testing import calc_diff
from sageattention_tpu_torch.ops import _build
from sageattention_tpu_torch.ops import backward as tbwd

from port_cpu import yield_cpu  # noqa: F401  (one torch thread, low CPU priority)

JAX_BAR = 1e-4
ORACLE_REL = 3e-2
TILE = 64


def _mask(kind, B, H, Sq, Sk, seed):
    """A bool keep-mask ``[B, H, Sq, Sk]``: "pad" left-pads sequence b by
    ``70 + 90 b`` keys, "holes" keeps 85% of pairs at random with rows 0-69
    and kv columns 128-191 dead, "blocks" keeps ~40% of 128 x 128 blocks."""
    r = np.random.RandomState(seed)
    if kind == "pad":
        pad = 70 + 90 * np.arange(B)
        keep = np.arange(Sk)[None, None, None, :] >= pad[:, None, None, None]
        return np.broadcast_to(keep, (B, H, Sq, Sk)).copy()
    if kind == "holes":
        keep = r.rand(B, H, Sq, Sk) < 0.85
        keep[:, :, :70] = False
        keep[..., 128:192] = False
        return keep
    blocks = r.rand(B, H, -(-Sq // 128), -(-Sk // 128)) < 0.4
    return blocks.repeat(128, 2).repeat(128, 3)[:, :, :Sq, :Sk].copy()


LIST_CASES = {   # name: D, Sqp, Skp, causal, window, sinks, mask (kind, B, Hm)
    "window_sinks_d64": (64, 448, 448, True, 100, 70, None),
    "window_1_d128": (128, 320, 320, True, 1, 0, None),
    "window_37_sinks_tails_d64": (64, 320, 448, True, 37, 4, None),
    "pad_causal_d128": (128, 448, 448, True, 0, 0, ("pad", 2, 1)),
    "holes_d64": (64, 320, 384, False, 0, 0, ("holes", 1, 2)),
    "holes_causal_d128": (128, 384, 320, True, 0, 0, ("holes", 2, 1)),
    "blocks_d64": (64, 512, 512, False, 0, 0, ("blocks", 1, 1)),
}


@pytest.mark.parametrize("case", list(LIST_CASES))
def test_tile_lists_cover_exactly_the_kept_pairs(case):
    """C1's and C2's lists against the kept set, on every (slice, tile) of
    every block: the classes a kernel acts on are right and nothing kept is
    skipped."""
    D, Sqp, Skp, causal, window, sinks, mk = LIST_CASES[case]
    mask = None if mk is None else torch.tensor(_mask(mk[0], mk[1], mk[2], Sqp, Skp, 5))
    lists = tbwd.bwd_tile_lists(Sqp, Skp, D, causal, window, sinks, mask)
    rows, cols = torch.arange(Sqp)[:, None], torch.arange(Skp)[None, :]
    pos = tbwd._keep(causal, window, sinks, rows, cols, None)
    pos = torch.ones(Sqp, Skp, dtype=torch.bool) if pos is None else pos
    keep = (pos if mask is None else pos & mask).expand(
        *(mask.shape[:2] if mask is not None else (1, 1)), Sqp, Skp)
    nwg = tbwd.bwd_sm90_block_rows(D) // TILE
    classes_seen = set()
    for kernel in ("C1", "C2"):
        tiles, counts, order = lists[kernel]
        # the kernel's rows and streamed tiles: C1 owns kv rows, C2 q rows
        k = keep.transpose(-1, -2) if kernel == "C1" else keep
        m = None if mask is None else (mask.transpose(-1, -2) if kernel == "C1" else mask)
        p = pos.transpose(-1, -2) if kernel == "C1" else pos
        n_rows, n_t = k.shape[-2], k.shape[-1] // TILE
        assert tiles.shape[-1] == n_t and tiles.dtype == counts.dtype == torch.int32
        assert tiles.shape[-2] == -(-n_rows // (TILE * nwg))
        longest = counts.reshape(-1, counts.shape[-1]).amax(0)
        assert torch.equal(order.long(), torch.argsort(longest, descending=True, stable=True))
        for b in range(k.shape[0]):
            for h in range(k.shape[1]):
                lb, lh = min(b, tiles.shape[0] - 1), min(h, tiles.shape[1] - 1)
                for blk in range(tiles.shape[-2]):
                    n = int(counts[lb, lh, blk])
                    listed = {}
                    for e in tiles[lb, lh, blk, :n].tolist():
                        listed[e & 0xFFFFFF] = [(e >> (24 + 2 * w)) & 3 for w in range(nwg)]
                    assert list(listed) == sorted(listed)   # in order
                    for t in range(n_t):
                        cls = listed.get(t, [0] * nwg)
                        assert t not in listed or any(cls), (kernel, blk, t)
                        for w in range(nwg):
                            r0 = (blk * nwg + w) * TILE
                            c0 = t * TILE
                            if r0 >= n_rows:
                                assert cls[w] == 0
                                continue
                            tk = k[b, h, r0:r0 + TILE, c0:c0 + TILE]
                            classes_seen.add(cls[w])
                            if cls[w] == 0:
                                assert not tk.any(), (kernel, b, h, blk, t, w)
                            elif cls[w] == 2:
                                assert tk.all(), (kernel, b, h, blk, t, w)
                            elif cls[w] == 3 and m is not None:   # positions alone decide
                                assert m[b, min(h, m.shape[1] - 1), r0:r0 + TILE,
                                         c0:c0 + TILE].all()
                            if not tk.any() and (m is None or not p[r0:r0 + TILE, c0:c0 + TILE]
                                                 .any() or not m[b, min(h, m.shape[1] - 1),
                                                                 r0:r0 + TILE,
                                                                 c0:c0 + TILE].any()):
                                assert cls[w] == 0   # dead by one mask alone: never listed live
    assert 0 in classes_seen and len(classes_seen) > 1   # some tiles dead, some live
    assert mask is not None or 1 not in classes_seen   # class 1 reads the mask
    # lists shared over batch and heads unless the mask steps over them
    for kernel in ("C1", "C2"):
        tiles = lists[kernel][0]
        assert tiles.shape[:2] == ((1, 1) if mask is None else tuple(mask.shape[:2]))


def _record(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "call", lambda fn, device, *args: calls.append((fn, args)))
    return calls


def _inputs(B=2, Hq=4, Hk=2, Sqp=320, Skp=448, D=64):
    r = np.random.RandomState(D + Sqp)
    q, do = (torch.tensor(r.randn(B, Hq, Sqp, D)).bfloat16() for _ in range(2))
    k, v = (torch.tensor(r.randn(B, Hk, Skp, D)).bfloat16() for _ in range(2))
    return q, k, v, do, torch.zeros(B, Hq, Sqp), torch.zeros(B, Hq, Sqp)


@pytest.mark.parametrize("D", [64, 128])
def test_masked_entry_gets_each_kernels_lists_and_the_mask(monkeypatch, D):
    """A bool mask with partly live tiles: C1 and C2 get their own lists and
    orders and the mask in place as int8 (no copy); both count under the
    ``-bool`` keys."""
    calls = _record(monkeypatch)
    q, k, v, do, lse2, di = _inputs(D=D)
    mask = torch.tensor(_mask("holes", 2, 1, 320, 448, 3))
    held = {}
    real = tbwd._masked_args
    monkeypatch.setattr(tbwd, "_masked_args",
                        lambda *a: held.setdefault("per", real(*a)))
    before = [tbwd.LAUNCHES[n] for n in ("C1-bf16-causal-bool", "C2-bf16-causal-bool")]
    tbwd.attention_backward_kernel(q, k, v, do, lse2, di, fold=0.2, dk_fin=0.125,
                                   dq_fin=0.125, causal=True, mask=mask)
    assert [fn for fn, _ in calls] == ["sage_bwd_sm90_masked"] * 2
    assert [tbwd.LAUNCHES[n] for n in ("C1-bf16-causal-bool", "C2-bf16-causal-bool")] == [
        b + 1 for b in before]
    lists = tbwd.bwd_tile_lists(320, 448, D, True, 0, 0, mask)
    per = held["per"]
    for which, kernel in ((1, "C1"), (2, "C2")):
        args = calls[which - 1][1]
        own = per[which]
        tiles, counts, order = lists[kernel]
        assert torch.equal(own[0], tiles) and torch.equal(own[1], counts)
        assert torch.equal(own[5], order)
        assert own[2:5] == (tiles.shape[-1], 1, 0)   # per batch, shared over heads
        m = own[6]
        assert m.dtype == torch.int8 and m.data_ptr() == mask.data_ptr()
        assert torch.equal(m.bool(), mask)
        assert own[7:11] == (*m.stride()[:3], 0) and own[-2:] == (0, 0)
        # the pointers handed over are those tensors'
        assert args[-13:-7] == (own[0].data_ptr(), own[1].data_ptr(), *own[2:5],
                                own[5].data_ptr())
        assert args[-7] == m.data_ptr()


def test_window_lists_are_shared_and_read_no_mask(monkeypatch):
    """A window with sinks: lists shared over batch and heads, built once
    for the shape, no mask pointer, window and sinks passed; a mask whose
    tiles are all dead or full (128 x 128 blocks) is still handed over
    (whether a slice reads it would take a host read)."""
    calls = _record(monkeypatch)
    q, k, v, do, lse2, di = _inputs(Sqp=448, Skp=448, D=128)
    tbwd.attention_backward_kernel(q, k, v, do, lse2, di, fold=1.0, dk_fin=1.0, dq_fin=1.0,
                                   causal=True, window=100, sinks=70)
    for _, args in calls:   # (lb, lh), then (mask, 3 strides, mh), (window, sinks)
        assert args[-10:-8] == (0, 0)
        assert args[-7] is None and args[-6:] == (0, 0, 0, 0, 100, 70)
    assert tbwd.bwd_tile_lists(448, 448, 128, True, 100, 70) is tbwd.bwd_tile_lists(
        448, 448, 128, True, 100, 70)
    calls.clear()
    mask = torch.tensor(_mask("blocks", 2, 1, 448, 448, 1))
    tbwd.attention_backward_kernel(q, k, v, do, lse2, di, fold=1.0, dk_fin=1.0, dq_fin=1.0,
                                   causal=False, mask=mask)
    assert [fn for fn, _ in calls] == ["sage_bwd_sm90_masked"] * 2
    assert all(args[-7] is not None and args[-2:] == (0, 0) for _, args in calls)
    # both read the mask in place: q rows of Skp bytes
    assert [args[-4] for _, args in calls] == [448, 448] and calls[0][1][-7] == calls[1][1][-7]


def test_masked_launch_raises_without_fallback(monkeypatch):
    """A masked bf16 configuration whose launch fails raises; nothing else
    (``sage_attn_bwd``, the unmasked entry) is tried."""
    tried = []

    def fail(fn, device, *args):
        tried.append(fn)
        raise RuntimeError(f"{fn} failed to launch")

    monkeypatch.setattr(_build, "call", fail)
    q, k, v, do, lse2, di = _inputs()
    with pytest.raises(RuntimeError, match="sage_bwd_sm90_masked"):
        tbwd.attention_backward_kernel(q, k, v, do, lse2, di, fold=1.0, dk_fin=1.0,
                                       dq_fin=1.0, causal=True, window=64)
    assert tried == ["sage_bwd_sm90_masked"]


@pytest.mark.parametrize("quantized,D", [(True, 64), (False, 256)])
def test_int8_and_hd256_masked_forms_stay_on_backward_cu(monkeypatch, quantized, D):
    """The int8 masked forms and head dim 256 launch ``sage_attn_bwd``."""
    calls = _record(monkeypatch)
    q, k, v, do, lse2, di = _inputs(D=D)
    kw = {}
    if quantized:
        q, kw["qs"] = q.to(torch.int8), torch.ones(q.shape[:3])
        k, kw["ks"] = k.to(torch.int8), torch.ones(k.shape[:3])
    tbwd.attention_backward_kernel(q, k, v, do, lse2, di, fold=1.0, dk_fin=1.0, dq_fin=1.0,
                                   causal=True, window=64, **kw)
    assert [fn for fn, _ in calls] == ["sage_attn_bwd"] * 2


# ------------------------------------------------------ against JAX ----

def _keep(Sq, Sk, causal, window, sinks, mask):
    r, c = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    keep = np.ones((Sq, Sk), bool)
    if causal:
        keep &= c <= r
        if window:
            keep &= (c >= r - (window - 1)) | (c < sinks)
    keep = keep[None, None]
    return keep if mask is None else keep & mask


def _exact(q, k, v, keep, sm):
    """float64 attention with a keep-mask; a row with no kept key gives 0
    and lse -inf."""
    G = q.shape[1] // k.shape[1]
    s = q @ k.repeat_interleave(G, 1).transpose(-1, -2) * sm
    keep = torch.as_tensor(keep)
    zero = torch.zeros((), dtype=s.dtype)
    m = torch.where(keep, s, torch.tensor(-1e300, dtype=s.dtype)).amax(-1, keepdim=True)
    m = torch.where(keep.any(-1, keepdim=True), m, zero)
    p = torch.where(keep, torch.exp(torch.where(keep, s, zero) - m), zero)
    l = p.sum(-1, keepdim=True)
    o = (p / torch.clamp_min(l, 1e-300)) @ v.repeat_interleave(G, 1)
    return o, (m + torch.log(l))[..., 0]


@functools.lru_cache(maxsize=None)
def _jax_bwd(causal, window, sinks):
    def f(q, k, v, o, lse, do, mask):
        return attention_backward_pallas(q, k, v, o, lse, do, sm_scale=q.shape[-1] ** -0.5,
                                         is_causal=causal, attn_mask=mask, window=window,
                                         sinks=sinks, interpret=True)
    return jax.jit(f)


JAX_CASES = {   # name: B, Hq, Hk, Sq, Sk, D, causal, window, sinks, mask (kind, Hm)
    "window_sinks_d64": (1, 2, 2, 448, 448, 64, True, 100, 70, None),
    "window_37_gqa4_tail_d128": (1, 4, 1, 300, 300, 128, True, 37, 0, None),
    # W = 1 alone keeps a row's own key: P = 1 and dS = 0, so sinks give it gradients
    "window_1_sinks_4_d64": (1, 2, 1, 200, 200, 64, True, 1, 4, None),
    "pad_causal_d128": (2, 2, 2, 320, 320, 128, True, 0, 0, ("pad", 1)),
    "holes_d64": (1, 2, 1, 300, 384, 64, False, 0, 0, ("holes", 1)),
    "holes_causal_per_head_d64": (1, 2, 2, 320, 320, 64, True, 0, 0, ("holes", 2)),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_masked_backward_matches_jax_and_exact(case):
    B, Hq, Hk, Sq, Sk, D, causal, window, sinks, mk = JAX_CASES[case]
    r = np.random.RandomState(len(case) + Sq)
    q, do = (r.randn(B, Hq, Sq, D).astype(np.float32) for _ in range(2))
    k, v = (r.randn(B, Hk, Sk, D).astype(np.float32) for _ in range(2))
    mask = None if mk is None else _mask(mk[0], B, mk[1], Sq, Sk, 7)
    keep = _keep(Sq, Sk, causal, window, sinks, mask)
    t = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in (q, k, v)]
    o64, lse64 = _exact(*t, keep, D ** -0.5)
    ref = torch.autograd.grad(o64, t, torch.tensor(do, dtype=torch.float64))
    o = o64.detach().float().numpy()
    lse = lse64.detach()
    lse = torch.where(torch.isfinite(lse), lse, torch.tensor(-np.inf, dtype=lse.dtype))
    lse = lse.float().numpy()
    got = tbwd.attention_backward(
        *(torch.tensor(x) for x in (q, k, v, o, lse, do)), sm_scale=D ** -0.5,
        is_causal=causal, attn_mask=None if mask is None else torch.tensor(mask),
        window=window, sinks=sinks)
    jax_got = _jax_bwd(causal, window, sinks)(
        *(jnp.asarray(x) for x in (q, k, v, o, lse, do)),
        None if mask is None else jnp.asarray(mask))
    for a, j, e, n in zip(got, jax_got, ref, "qkv"):
        a, j, e = a.double().numpy(), np.asarray(j, np.float64), e.numpy()
        assert a.shape == j.shape == e.shape, f"d{n}"
        assert np.isfinite(a).all(), f"d{n}"
        assert calc_diff(a, j) < JAX_BAR, f"d{n} vs JAX"
        assert np.abs(a - e).max() / np.abs(e).max() < ORACLE_REL, f"d{n} vs exact"
