"""B11 on an int8 V cache, the dense decode and its verify windows, on its
Hopper route (``csrc/decode_sm90.cu``): which launches ``b11_sm90_route``
takes, the attention module's launch keys unchanged, what ``decode_kernel``
hands the entry (recorded, not run: no card here; every row of a folded
window in one launch), that a failed launch raises, and the plain version's
walk, which follows the kernel's shares (``sm90_decode_splits``, at least
``SM90_DECODE_MIN_TILES`` tiles a share; tests/test_torch_sm90_decode.py
checks their counts), against the JAX package's
``sageattn_decode(interpret=True)`` under ``jax.jit``: head dims 64 and 128,
folded T = 4 and T = 9 windows, an unfolded T = 25 window over GQA heads,
single-row steps (no window) at lengths of 1 and of a tile boundary, and
B = 2 with per-sequence V scales.

Inputs are standard normal K, V and Q from a numpy seed, quantized into
each package's own cache.  Bar (tests/test_torch_decode.py's BAR): port vs
JAX calc_diff < 1.5e-3, both against the f32 oracle too; an int8 P is
rounded against the running max of its kv tile, and the two walk different
tiles (JAX 2048-wide blocks, the port 64-token tiles in its shares).
"""

import dataclasses
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import decode as jdec
from sageattention_tpu.ops.reference import sdpa as jsdpa
from sageattention_tpu_torch import decode as tdec
from sageattention_tpu_torch.ops import _build
from sageattention_tpu_torch.ops import attention as tatt
from sageattention_tpu_torch.utils.testing import calc_diff

from port_cpu import yield_cpu  # noqa: F401  (one torch thread, low CPU priority)

BAR = 1.5e-3


def _cfg(T, D, bucket, causal=True, fold=True, **kw):
    """The decode configuration ``sageattn_decode`` builds for a T-row step."""
    causal = causal and T > 1
    return tatt.AttnConfig(causal=causal, causal_dynamic=causal,
                           causal_row_mod=T if (fold and causal) else 0, quantized=True,
                           pv_dtype="int8", sm_scale=D ** -0.5, kv_len=bucket,
                           kv_len_dynamic=True, fuse_v_mean=True, emit_lse=False,
                           fuse_q_quant=True, **kw)


def test_route_and_launch_keys():
    """``b11_sm90_route`` takes every B11-int8 key at head dims 64 and 128
    with a bf16 output, folded rows past 64 too; e4m3 and bf16 V, D = 256,
    an f32 output and the prefill configurations stay off it.  The launch
    keys are those they were."""
    for causal, fold in ((False, True), (True, False), (True, True)):
        cfg = _cfg(4, 64, 256, causal=causal, fold=fold)
        name = tatt.config_name(cfg, 4)
        assert name.startswith("B11-int8")
        for D in (64, 128, 256):
            for vt in (torch.int8, torch.float8_e4m3fn, torch.bfloat16):
                assert tatt.b11_sm90_route(cfg, 4, D, vt) == (D < 256 and vt == torch.int8)
        assert not tatt.b11_sm90_route(dataclasses.replace(cfg, out_dtype=torch.float32), 4, 64,
                                       torch.int8)
    for fmt in ("fp8", "bf16"):
        cfg = dataclasses.replace(_cfg(1, 128, 256), pv_dtype=fmt)
        assert not tatt.b11_sm90_route(cfg, 1, 128, torch.int8)
    assert tatt.b11_sm90_route(_cfg(13, 128, 256), 65, 128, torch.int8)   # 65 folded rows
    prefill = tatt.AttnConfig(quantized=True, pv_dtype="int8", fuse_q_quant=True,
                              kv_len_dynamic=True)
    assert not tatt.b11_sm90_route(prefill, 33, 128, torch.int8)   # B10's fields past 32 rows
    digest = hashlib.sha256("\n".join(tatt.LAUNCH_KEYS).encode()).hexdigest()[:16]
    assert (len(tatt.LAUNCH_KEYS), digest) == (245, "77f5dffabd22793c")


def _record(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "call", lambda fn, device, *args: calls.append((fn, args)))
    return calls


def _cache(B, Hk, L, D, max_len, seed, fmt="int8"):
    r = np.random.RandomState(seed)
    k, v = (torch.from_numpy(r.randn(B, Hk, L, D).astype(np.float32)) for _ in range(2))
    return tdec.kv_cache_init(k, v, max_len, v_format=fmt), r


# positions in sage_decode_sm90's arguments
STRIDES_AT, DEV_AT, SHAPE_AT, FOLD_AT, VS_AT, SCRATCH_AT = 7, 15, 17, 25, 26, 30


@pytest.mark.parametrize("what", ["T = 9 folded, 36 rows", "64 folded rows", "65 folded rows",
                                  "T = 25 unfolded, 2 heads a block", "B = 2, T = 1, f32 Q"])
def test_dispatch(monkeypatch, what):
    """B11-int8 goes to ``sage_decode_sm90`` in one launch for every row:
    the cache's K and V views in place with their strides, the K scales as
    ``[B, Hk, S]`` in place, the device length and offsets as int32
    pointers, the heads a block, ``sm90_decode_splits`` shares, the fold's T, the
    scale with log2(e), per-sequence V scale and mean (batch stride Hk D),
    a bf16 Q as it is (an f32 one as f32); the key is counted once."""
    calls = _record(monkeypatch)
    B, Hq, Hk, T, D, fold = {
        "T = 9 folded, 36 rows": (1, 8, 2, 9, 128, True),
        "64 folded rows": (1, 8, 2, 16, 64, True),
        "65 folded rows": (1, 10, 2, 13, 128, True),
        "T = 25 unfolded, 2 heads a block": (1, 4, 2, 25, 64, False),
        "B = 2, T = 1, f32 Q": (2, 8, 2, 1, 128, True)}[what]
    cache, r = _cache(B, Hk, 300, D, 512, 3)
    bucket = 384
    G = Hq // Hk
    q = torch.from_numpy(r.randn(B, Hq, T, D).astype(np.float32))
    q = q.reshape(B, Hk, G * T, D) if fold else q
    if T > 1 or not what.endswith("f32 Q"):
        q = q.bfloat16()
    cfg = _cfg(T, D, bucket, fold=fold)
    k8, v8, ks = cache.k8[:, :, :bucket], cache.v[:, :, :bucket], cache.k_scale[..., :bucket]
    offsets = torch.stack([cache.length - T, torch.zeros_like(cache.length)]) if T > 1 else None
    name = tatt.config_name(cfg, q.shape[2])
    before = tatt.attention_call.launches[name]
    out, lse = tatt.decode_kernel(q, k8, v8, cfg, ks, cache.v_scale, cache.v_mean, cache.length,
                                  offsets)
    assert tatt.attention_call.launches[name] == before + 1
    assert [fn for fn, _ in calls] == ["sage_decode_sm90"]
    a = calls[0][1]
    Hg, R = q.shape[1], q.shape[2]
    assert a[:3] == (D, tatt.sm90_heads_per_block(Hg // Hk, R), int(q.dtype == torch.float32))
    assert a[3] == q.data_ptr() and a[4:7] == (k8.data_ptr(), v8.data_ptr(), ks.data_ptr())
    assert a[STRIDES_AT:DEV_AT] == (*k8.stride()[:3], *v8.stride()[:3], Hk * 512, 512)
    assert isinstance(a[DEV_AT], int) and (a[DEV_AT + 1] is None) == (T == 1)
    n_units = bucket // 64
    assert a[SHAPE_AT:FOLD_AT] == (B, Hg, Hk, R, bucket, n_units,
                                   tatt.sm90_decode_splits(B, Hk, n_units),
                                   T if (fold and T > 1) else 0)
    assert a[FOLD_AT] == np.float32(D ** -0.5 * 1.4426950408889634)
    assert a[VS_AT + 1] == a[VS_AT + 3] == (Hk * D if B > 1 else 0)
    assert all(isinstance(x, int) for x in a[SCRATCH_AT:SCRATCH_AT + 4]) and a[-1] is None
    assert out.shape == (B, Hg, R, D) and out.dtype == torch.bfloat16 and lse is None


def test_k_scales_copied_only_off_the_tiles(monkeypatch):
    """The K scales go in place when they are aligned and the view ends on
    a tile; a view that ends inside a tile is padded (with ones) to whole
    tiles, which the bulk copies read."""
    calls = _record(monkeypatch)
    cache, r = _cache(1, 2, 100, 64, 256, 4)
    q = torch.from_numpy(r.randn(1, 2, 2, 64).astype(np.float32)).bfloat16()
    cfg = _cfg(1, 64, 200)
    tatt.decode_kernel(q, cache.k8[:, :, :200], cache.v[:, :, :200], cfg,
                       cache.k_scale[..., :200], cache.v_scale, cache.v_mean, cache.length, None)
    ks = tatt.ks_operand(cache.k_scale[..., :200], 256)
    assert calls[0][1][6] != cache.k_scale.data_ptr() and ks.shape == (1, 2, 256)
    assert torch.equal(ks[..., :200], cache.k_scale[:, :, 0, :200]) and bool((ks[..., 200:] == 1).all())
    assert calls[0][1][22] == 4   # n_units: the padded tiles


@pytest.mark.parametrize("fmt,D,out_dtype", [("fp8", 128, torch.bfloat16),
                                             ("bf16", 64, torch.bfloat16),
                                             ("int8", 256, torch.bfloat16),
                                             ("int8", 128, torch.float32)])
def test_outside_the_route_stays_on_decode_cu(monkeypatch, fmt, D, out_dtype):
    """e4m3 and bf16 V, D = 256 and an f32 output stay on ``csrc/decode.cu``'s
    entry, 32 rows a launch, and its plain walk keeps ``decode_splits``."""
    calls = _record(monkeypatch)
    cache, r = _cache(1, 2, 100, D, 128, 5, fmt)
    q = torch.from_numpy(r.randn(1, 2, 36, D).astype(np.float32)).bfloat16()
    cfg = dataclasses.replace(_cfg(9, D, 128), pv_dtype=fmt, out_dtype=out_dtype)
    offsets = torch.stack([cache.length - 9, torch.zeros_like(cache.length)])
    tatt.decode_kernel(q, cache.k8, cache.v, cfg, cache.k_scale,
                       None if fmt == "bf16" else cache.v_scale, cache.v_mean, cache.length,
                       offsets)
    assert [fn for fn, _ in calls] == ["sage_decode", "sage_decode"]   # rows 0-31, 32-35
    assert calls[0][1][-14] == tatt.decode_splits(1, 2)   # n_split


def test_a_failed_launch_raises(monkeypatch):
    """An error code from the entry raises with its message: nothing falls
    back to ``decode.cu`` or to the plain version."""
    class Lib:
        calls = []

        def sage_decode_sm90(self, *args):
            self.calls.append(args)
            return -2

        def sage_decode_sm90_error_string(self, e):
            return b"cuTensorMapEncodeTiled failed"

    lib = Lib()
    monkeypatch.setattr(_build, "build_all", lambda: {"decode_sm90": lib})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    cache, r = _cache(1, 2, 100, 64, 128, 6)
    q = torch.from_numpy(r.randn(1, 2, 1, 64).astype(np.float32)).bfloat16()
    with pytest.raises(RuntimeError, match="sage_decode_sm90 failed to launch: "
                                           "cuTensorMapEncodeTiled failed"):
        tatt.decode_kernel(q, cache.k8, cache.v, _cfg(1, 64, 128), cache.k_scale, cache.v_scale,
                           cache.v_mean, cache.length, None)
    assert len(lib.calls) == 1


@functools.lru_cache(maxsize=None)
def _jax_decode(is_causal):
    return jax.jit(functools.partial(jdec.sageattn_decode, interpret=True, is_causal=is_causal))


def _oracle(q, k, v, T, causal):
    G = q.shape[1] // k.shape[1]
    S = k.shape[2]
    mask = None
    if causal and T > 1:
        mask = jnp.asarray((np.arange(S)[None, :] <= np.arange(S - T, S)[:, None])[None, None])
    return np.asarray(jax.jit(jsdpa)(jnp.asarray(q), jnp.asarray(np.repeat(k, G, 1)),
                                     jnp.asarray(np.repeat(v, G, 1)), mask=mask))


# (label, B, Hq, Hk, length, T, D, max_len, is_causal)
CASES = [
    ("length 1, D = 64", 1, 4, 2, 1, 1, 64, 128, True),
    ("a tile boundary in two shares, B = 2, D = 128", 2, 4, 2, 320, 1, 128, 512, True),
    ("folded T = 4, D = 64", 1, 8, 2, 300, 4, 64, 384, True),
    ("folded T = 9, D = 128", 1, 8, 2, 450, 9, 128, 512, True),
    ("unfolded T = 25 over GQA heads, D = 64", 1, 4, 2, 400, 25, 64, 512, True),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_jax(case, monkeypatch):
    """The plain version, walking ``csrc/decode_sm90.cu``'s shares of
    64-token tiles, against JAX's decode in interpret mode and the f32
    oracle."""
    label, B, Hq, Hk, L, T, D, max_len, causal = case
    r = np.random.RandomState(CASES.index(case) + 20)
    q, k, v = (r.randn(*s).astype(np.float32) for s in ((B, Hq, T, D), (B, Hk, L, D),
                                                          (B, Hk, L, D)))
    jc = jdec.kv_cache_init(jnp.asarray(k), jnp.asarray(v), max_len)
    tc = tdec.kv_cache_init(torch.tensor(k), torch.tensor(v), max_len)
    walks = []
    real = tatt.split_online_plain
    monkeypatch.setattr(tatt, "split_online_plain",
                        lambda *a: walks.append(a[3:]) or real(*a))
    to = tdec.sageattn_decode(torch.tensor(q), tc, is_causal=causal)
    n_units = max_len // 64
    fold = tdec.fold_heads(Hq // Hk, T)
    rows = Hq // Hk * T if fold else T
    calls = B * -(-rows // (rows if fold and causal else tatt.DECODE_ROWS))
    assert walks == [(tatt.sm90_decode_splits(B, Hk, n_units),
                      tatt.SM90_DECODE_MIN_TILES)] * calls, label
    jo = np.asarray(_jax_decode(causal)(jnp.asarray(q), jc).astype(jnp.float32))
    to = to.float().numpy()
    assert to.shape == q.shape
    ref = _oracle(q, k, v, T, causal)
    assert calc_diff(to, ref) < BAR, label
    assert calc_diff(jo, ref) < BAR, label
    assert calc_diff(to, jo) < BAR, label
