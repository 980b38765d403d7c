"""The online forms moved to Hopper kernels: B2, B5-fp8-fusedq and the
fused-Q B-pvbf16-online on ``csrc/attention_online_sm90.cu``
(``online_sm90_route``), and B5-int8 on a pre-quantized Q on
``csrc/attention_q8_sm90.cu``'s mode 5 (``q8_sm90_route``): which
configurations, head dims and dtypes each route takes and what stays on
``attention.cuh`` (D = 256, an f32 output or Q, masks, a fused-Q B5-int8,
the ring's B5-int8); what ``attention_kernel`` hands each entry (recorded,
not run: no card here): V^T for the e4m3 and int8 P forms, widened codes
for B2, the caller's bf16 V with no copy, scale or mean, and no
``kn_max``; ``transpose_v_codes`` on int8 codes; a failed launch raising;
and the plain version the kernels are held to against the JAX package's
``attention_call(interpret=True)`` under ``jax.jit`` with 64-wide blocks,
for the fused-Q B-pvbf16-online and for B2 at D = 128, causal, GQA 4:1,
``kv_len < Sk``.

Bars (tests/test_torch_attention.py's): plain vs JAX calc_diff < 1e-5 and
the base-2 lse within 5e-3 of JAX's (a bf16 P in both cases).
"""

import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu.ops import attention as jatt
from sageattention_tpu_torch.ops import _build
from sageattention_tpu_torch.ops import attention as tatt
from sageattention_tpu_torch.ops import quant as tquant
from sageattention_tpu_torch.ops.quant_kernels import channel_stats, quant_int8_fixed
from sageattention_tpu_torch.utils.testing import calc_diff

from port_cpu import yield_cpu  # noqa: F401  (one torch thread, low CPU priority)

JAX_BAR = 1e-5
LSE_JAX_ATOL = 5e-3
BLK = 64
ONLINE_KEYS = ("B2", "B5-fp8-fusedq", "B-pvbf16-online")
PV_DTYPE = {"B2": "int8", "B5-fp8-fusedq": "fp8", "B-pvbf16-online": "bf16"}
# positions in sage_attn_fwd_online_sm90's arguments
V_AT, KS_AT, DIMS_AT = 4, 18, 22
# positions in sage_attn_fwd_q8_sm90's arguments
Q8_KS_AT, Q8_KNM_AT, Q8_DYN_AT = 19, 23, 27


def _key_configs():
    """One ``(cfg, rows)`` for each launch key, the first the walk gives."""
    seen = {}
    for cfg, rows in tatt._launch_configs():
        try:
            seen.setdefault(tatt.config_name(cfg, rows), (cfg, rows))
        except ValueError:
            pass
    return seen


def test_online_route_takes_exactly_the_three_fused_online_keys():
    """``online_sm90_route`` takes B2, B5-fp8-fusedq and B-pvbf16-online
    (native compute, no V mean) on a fused bf16 Q with a bf16 output at
    head dims 64 and 128, and nothing else: D = 256, an f32 / f16 / int8 Q,
    an f32 output, B-pvbf16 with bf16 compute or a V mean, the ``-colk``,
    masked, windowed and segmented forms of these bases, and every other
    key stay off it."""
    routed = set()
    for key, (cfg, rows) in _key_configs().items():
        for D, q_dtype, out_dtype, cd, vmean in itertools.product(
                (64, 128, 256), (torch.bfloat16, torch.float32, torch.float16, torch.int8),
                (torch.bfloat16, torch.float32), ("native", "bf16"), (False, True)):
            c = dataclasses.replace(cfg, out_dtype=out_dtype)
            if key == "B-pvbf16-online" and cfg.fuse_q_quant:   # fields the key does not name
                c = dataclasses.replace(c, compute_dtype=cd, fuse_v_mean=vmean)
            elif (cd, vmean) != ("native", False):
                continue
            got = tatt.online_sm90_route(c, rows, D, q_dtype)
            want = (key in ONLINE_KEYS and c.fuse_q_quant and D < 256
                    and q_dtype == torch.bfloat16 and out_dtype == torch.bfloat16
                    and (cd, vmean) == ("native", False))
            assert got == want, (key, D, q_dtype, out_dtype, cd, vmean)
            if got:
                routed.add(key)
    assert routed == set(ONLINE_KEYS)
    assert tatt.ONLINE_SM90_BASES == {"B2": 0, "B5-fp8-fusedq": 1, "B-pvbf16-online": 2}
    # a pre-quantized B-pvbf16-online is the q8 route's
    cfg = tatt.AttnConfig(quantized=True, pv_dtype="bf16", fold_k_scale=True,
                          softmax_mode="online")
    assert tatt.config_name(cfg, 128) == "B-pvbf16-online"
    assert not tatt.online_sm90_route(cfg, 128, 64, torch.bfloat16)
    assert tatt.q8_sm90_route(cfg, 128, 64, torch.int8)


def test_b5_int8_routes():
    """B5-int8 on a pre-quantized Q (folded or per-column K scales) with a
    bf16 output at D = 64 / 128 is the q8 route's, mode 5; a fused-Q
    B5-int8, its ring forms, D = 256 and an f32 output stay on
    ``attention.cuh``."""
    assert tatt.Q8_SM90_BASES["B5-int8"] == 5
    for fold, D, out_dtype in itertools.product((True, False), (64, 128, 256),
                                                (torch.bfloat16, torch.float32)):
        cfg = tatt.AttnConfig(quantized=True, pv_dtype="int8", fold_k_scale=fold,
                              softmax_mode="online", out_dtype=out_dtype)
        assert tatt.config_name(cfg, 128) == "B5-int8"
        assert tatt.q8_sm90_route(cfg, 128, D, torch.int8) == (
            D < 256 and out_dtype == torch.bfloat16)
        fused = dataclasses.replace(cfg, fuse_q_quant=True, fold_k_scale=True)
        assert tatt.config_name(fused, 128) == "B5-int8"
        assert not tatt.q8_sm90_route(fused, 128, D, torch.int8)
        assert not tatt.online_sm90_route(fused, 128, D, torch.bfloat16)
        for dyn_causal, dyn_len in ((True, False), (False, True)):
            ring = dataclasses.replace(cfg, causal=True, causal_dynamic=dyn_causal,
                                            kv_len_dynamic=dyn_len)
            assert tatt.config_name(ring, 128).startswith("B10-B5-int8")
            assert not tatt.q8_sm90_route(ring, 128, D, torch.int8)


def test_routes_are_disjoint():
    """No launch takes two Hopper routes: every key's configuration at D =
    64 and 128 with a bf16 or int8 Q goes to at most one kernel."""
    for key, (cfg, rows) in _key_configs().items():
        for D, q_dtype in itertools.product((64, 128), (torch.bfloat16, torch.int8)):
            if tatt.is_decode(cfg, rows):
                continue
            n = (tatt.flash_sm90_route(cfg, rows, D) + tatt.b1_sm90_route(cfg, rows, D, q_dtype)
                 + tatt.q8_sm90_route(cfg, rows, D, q_dtype)
                 + tatt.online_sm90_route(cfg, rows, D, q_dtype))
            assert n <= 1, (key, D, q_dtype)


def _record(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "call", lambda fn, device, *args: calls.append((fn, args)))
    return calls


def _codes(rng, *shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()


@pytest.mark.parametrize("key,D,causal", [("B2", 64, False), ("B5-fp8-fusedq", 128, True),
                                          ("B-pvbf16-online", 64, True)])
def test_online_dispatch(monkeypatch, key, D, causal):
    """The three keys go to ``sage_attn_fwd_online_sm90`` with their mode:
    the bf16 Q and the K codes and their strides as they are (NHD-strided Q
    included), B2's V codes widened by ``widen_v_codes``, B5-fp8-fusedq's
    e4m3 codes transposed by ``transpose_v_codes``, B-pvbf16-online's V
    itself (no copy) with null ``v_scale`` and ``v_mean``; the head K
    scales, ``kv_len`` and the fold, no ``kn_max`` (none is passed, even
    when the caller holds one); the key counted and no lmin returned."""
    calls = _record(monkeypatch)
    copies = []
    for helper in ("widen_v_codes", "transpose_v_codes"):
        real = getattr(tatt, helper)
        monkeypatch.setattr(tatt, helper, lambda v, _r=real, _h=helper: copies.append(
            (_h, _r(v))) or copies[-1][1])
    rng = np.random.default_rng(11)
    B, Hq, Hk, S, kv_len = 1, 4, 2, 200, 180
    q = _bf16(rng, B, S, Hq, D).transpose(1, 2)   # NHD storage
    k8 = _codes(rng, B, Hk, S, D)
    mode = tatt.ONLINE_SM90_BASES[key]
    kw = dict(k_head_scale=torch.rand(B, Hk, 1, 1) + 0.5, kn_max=torch.ones(B, Hq, 1, 1))
    if key == "B-pvbf16-online":
        v = _bf16(rng, B, Hk, S, D)
    else:
        v = _codes(rng, B, Hk, S, D)
        if key == "B5-fp8-fusedq":
            v = (v.float() / 4).to(torch.float8_e4m3fn)
        kw.update(v_scale=torch.rand(B, Hk, 1, D), v_mean=torch.rand(B, Hk, 1, D))
    cfg = tatt.AttnConfig(quantized=True, pv_dtype=PV_DTYPE[key], fuse_q_quant=True,
                          fold_k_scale=True, softmax_mode="online", pv_via_bf16=key == "B2",
                          fuse_v_mean=key != "B-pvbf16-online", causal=causal, kv_len=kv_len,
                          sm_scale=D ** -0.5)
    assert tatt.config_name(cfg, S) == key
    before = tatt.attention_call.launches[key]
    out, lse, lmin = tatt.attention_kernel(q, k8, v, cfg, **kw)
    assert [fn for fn, _ in calls] == ["sage_attn_fwd_online_sm90"] and lmin is None
    assert tatt.attention_call.launches[key] == before + 1
    args = calls[0][1]
    assert len(args) == len(_build.SIGNATURES["sage_attn_fwd_online_sm90"][1]) - 1
    assert args[:4] == (D, mode, q.data_ptr(), k8.data_ptr())
    assert args[6:9] == q.stride()[:3] and args[9:12] == k8.stride()[:3]
    if key == "B-pvbf16-online":
        assert copies == [] and args[V_AT] == v.data_ptr() and args[12:15] == v.stride()[:3]
        assert args[KS_AT + 1:KS_AT + 3] == (None, None)   # v_scale, v_mean
    else:
        helper = "transpose_v_codes" if key == "B5-fp8-fusedq" else "widen_v_codes"
        assert [h for h, _ in copies] == [helper] and args[V_AT] == copies[0][1].data_ptr()
        vb = copies[0][1]
        if key == "B2":
            assert vb.dtype == torch.bfloat16 and torch.equal(vb.float(), v.float())
        else:
            assert vb.dtype == torch.float8_e4m3fn and vb.shape == (B, Hk, D, 208)
        assert args[KS_AT + 1] is not None and args[KS_AT + 2] is not None
    ks = args[KS_AT]
    assert ks is not None and kw["kn_max"].data_ptr() not in args
    assert args[KS_AT + 3] == lse.data_ptr()
    assert args[DIMS_AT:] == (B, Hq, Hk, S, S, kv_len, int(causal),
                              float(np.float32(D ** -0.5 * tquant.LOG2E)))
    assert out.dtype == torch.bfloat16 and out.shape == (B, Hq, S, D)


@pytest.mark.parametrize("fold", [True, False])
def test_b5_int8_dispatch(monkeypatch, fold):
    """B5-int8 on a pre-quantized Q goes to ``sage_attn_fwd_q8_sm90`` with
    mode 5: the int8 V codes transposed by ``transpose_v_codes`` (``[B, Hk,
    D, Sk padded to 16]``, int8, the codes unchanged), the row scales,
    per-column K scales or a null pointer when folded, no kn_max, v_scale
    and v_mean."""
    calls = _record(monkeypatch)
    copies = []
    real = tatt.transpose_v_codes
    monkeypatch.setattr(tatt, "transpose_v_codes", lambda v: copies.append(real(v)) or copies[-1])
    monkeypatch.setattr(tatt, "widen_v_codes", lambda v: pytest.fail("B5-int8 widened V"))
    rng = np.random.default_rng(12)
    B, Hq, Hk, S, D = 1, 4, 2, 200, 128
    q8, k8, v8 = _codes(rng, B, Hq, S, D), _codes(rng, B, Hk, S, D), _codes(rng, B, Hk, S, D)
    kw = dict(q_scale=torch.ones(B, Hq, S, 1), v_scale=torch.ones(B, Hk, 1, D),
              v_mean=torch.zeros(B, Hk, 1, D))
    if not fold:
        kw["k_scale"] = torch.ones(B, Hk, 1, S)
    cfg = tatt.AttnConfig(quantized=True, pv_dtype="int8", fold_k_scale=fold,
                          softmax_mode="online", sm_scale=D ** -0.5)
    assert tatt.config_name(cfg, S) == "B5-int8"
    before = tatt.attention_call.launches["B5-int8"]
    out, lse, lmin = tatt.attention_kernel(q8, k8, v8, cfg, **kw)
    assert [fn for fn, _ in calls] == ["sage_attn_fwd_q8_sm90"] and lmin is None
    assert tatt.attention_call.launches["B5-int8"] == before + 1
    args = calls[0][1]
    assert args[:4] == (D, 5, q8.data_ptr(), k8.data_ptr())
    vt = copies[0]
    assert len(copies) == 1 and args[4] == vt.data_ptr()
    assert vt.dtype == torch.int8 and vt.shape == (B, Hk, D, 208) and vt.is_contiguous()
    assert args[12:15] == (Hk * D * 208, D * 208, 208)
    if fold:
        assert args[Q8_KS_AT:Q8_KS_AT + 4] == (None, 0, 0, S)
    else:
        assert args[Q8_KS_AT] == kw["k_scale"].data_ptr()
    assert args[Q8_KNM_AT] is None
    assert args[Q8_KNM_AT + 1] == kw["v_scale"].data_ptr()
    assert args[Q8_KNM_AT + 2] == kw["v_mean"].data_ptr()
    assert args[Q8_DYN_AT:Q8_DYN_AT + 2] == (None, None)
    assert out.dtype == torch.bfloat16 and lse.shape == (B, Hq, S)


@pytest.mark.parametrize("S", [64, 37])
def test_transpose_v_codes_on_int8_codes(S):
    """``transpose_v_codes`` moves int8 codes as bytes: the same V^T as for
    e4m3 codes of the same bits (slot ``4 t + 2 h + e`` of each 16 kv rows
    holds row ``8 h + 2 t + e``, zero codes in the padding), in int8."""
    rng = np.random.default_rng(S)
    B, H, D = 1, 2, 64
    v8 = _codes(rng, B, S, H, D).transpose(1, 2)   # NHD storage
    vt = tatt.transpose_v_codes(v8)
    Sp = -(-S // 16) * 16
    assert vt.dtype == torch.int8 and vt.shape == (B, H, D, Sp) and vt.is_contiguous()
    as_e4m3 = tatt.transpose_v_codes(v8.view(torch.float8_e4m3fn))
    assert torch.equal(vt.view(torch.uint8), as_e4m3.view(torch.uint8))
    slot = np.arange(Sp)
    row = slot // 16 * 16 + 8 * ((slot % 4) // 2) + 2 * ((slot % 16) // 4) + slot % 2
    got, codes = vt.numpy(), v8.numpy()
    real = row < S
    np.testing.assert_array_equal(got[..., real], codes[:, :, row[real], :].transpose(0, 1, 3, 2))
    assert not got[..., ~real].any()


class _FailingLib:
    def __init__(self, entry, err_fn):
        self.calls = []
        setattr(self, entry, lambda *a: self.calls.append(a) or -1)
        setattr(self, err_fn, lambda e: b"unsupported configuration")


@pytest.mark.parametrize("which", ["online", "b5-int8"])
def test_a_failed_launch_raises(monkeypatch, which):
    """An error code from either entry raises with its message: nothing
    falls back to ``attention.cuh``'s body or to the plain version."""
    rng = np.random.default_rng(13)
    S, D = 128, 64
    k8, v8 = _codes(rng, 1, 2, S, D), _codes(rng, 1, 2, S, D)
    if which == "online":
        source, entry = "attention_online_sm90", "sage_attn_fwd_online_sm90"
        q = _bf16(rng, 1, 2, S, D)
        cfg = tatt.AttnConfig(quantized=True, pv_dtype="int8", fuse_q_quant=True,
                              fold_k_scale=True, softmax_mode="online", pv_via_bf16=True,
                              sm_scale=0.125)
        kw = dict(k_head_scale=torch.ones(1, 2, 1, 1), v_scale=torch.ones(1, 2, 1, D))
    else:
        source, entry = "attention_q8_sm90", "sage_attn_fwd_q8_sm90"
        q = _codes(rng, 1, 2, S, D)
        cfg = tatt.AttnConfig(quantized=True, pv_dtype="int8", fold_k_scale=True,
                              softmax_mode="online", sm_scale=0.125)
        kw = dict(q_scale=torch.ones(1, 2, S, 1), v_scale=torch.ones(1, 2, 1, D))
    lib = _FailingLib(entry, _build.ERROR_STRINGS[source])
    monkeypatch.setattr(_build, "build_all", lambda: {source: lib})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    with pytest.raises(RuntimeError, match=f"{entry} failed to launch: unsupported"):
        tatt.attention_kernel(q, k8, v8, cfg, **kw)
    assert len(lib.calls) == 1


@pytest.mark.parametrize("what,D,q_dtype,entry", [
    ("B2 at D = 256", 256, torch.bfloat16, "sage_attn_fwd"),
    ("B2 on an f32 Q", 64, torch.float32, "sage_attn_fwd"),
    ("fused-Q B5-int8", 64, torch.bfloat16, "sage_attn_fwd"),
    ("B-pvbf16-online with a V mean", 128, torch.bfloat16, "sage_attn_fwd"),
    ("B2-bool", 64, torch.bfloat16, "sage_attn_fwd_ext"),
    ("B10-B5-int8-kvtrue", 64, torch.int8, "sage_attn_fwd_ring")])
def test_outside_the_routes_stays_on_the_old_body(monkeypatch, what, D, q_dtype, entry):
    """What this slice leaves on ``attention.cuh``: D = 256, an f32 Q, a
    fused-Q B5-int8, a B-pvbf16-online with a V mean, the masked B2 and the
    ring's B5-int8 go to the old entries."""
    calls = _record(monkeypatch)
    rng = np.random.default_rng(14)
    S = 128
    k8, v8 = _codes(rng, 1, 2, S, D), _codes(rng, 1, 2, S, D)
    fused = q_dtype != torch.int8
    q = _bf16(rng, 1, 2, S, D).to(q_dtype) if fused else _codes(rng, 1, 2, S, D)
    fields = dict(quantized=True, pv_dtype="int8", fuse_q_quant=fused, fold_k_scale=True,
                  softmax_mode="online", pv_via_bf16=what.startswith("B2"),
                  sm_scale=D ** -0.5, out_dtype=q_dtype if fused else torch.bfloat16)
    kw = dict(v_scale=torch.ones(1, 2, 1, D))
    if what.startswith("B-pvbf16"):
        fields.update(pv_dtype="bf16", fuse_v_mean=True)
        v8, kw = _bf16(rng, 1, 2, S, D), dict(v_mean=torch.zeros(1, 2, 1, D))
    if what == "B2-bool":
        fields["masked"] = "bool"
        kw["attn_mask"] = torch.ones(1, 1, S, S, dtype=torch.bool)
    if what.startswith("B10"):
        fields["kv_len_dynamic"] = True
        kw.update(q_scale=torch.ones(1, 2, S, 1), kv_true=torch.tensor([S], dtype=torch.int32))
    else:
        kw["k_head_scale"] = torch.ones(1, 2, 1, 1)
    cfg = tatt.AttnConfig(**fields)
    key = tatt.config_name(cfg, S)
    assert key.startswith(("B2", "B5-int8", "B-pvbf16-online", "B10-B5-int8")), key
    tatt.attention_kernel(q, k8, v8, cfg, **kw)
    assert [fn for fn, _ in calls] == [entry]


# ---- the plain version against JAX ----

@functools.lru_cache(maxsize=None)
def _jax_call(cfg, keys):
    def run(q, k, v, *vals):
        return jatt.attention_call(q, k, v, cfg=cfg, interpret=True, **dict(zip(keys, vals)))
    return jax.jit(run)


def _scale(amax, qmax):
    return torch.where(amax > 0, amax * np.float32(1.0 / qmax), torch.ones_like(amax))


@pytest.mark.parametrize("key,D,causal,Hq,Hk,S,kv_len", [
    ("B-pvbf16-online", 64, False, 2, 1, 192, 192),
    ("B2", 128, True, 4, 1, 256, 200)])
def test_plain_matches_jax(key, D, causal, Hq, Hk, S, kv_len):
    """The plain version of the fused-Q online forms (the kernel's 64-column
    tiles) against JAX's ``attention_call(fuse_q_quant=True,
    interpret=True)`` on the same codes and scales: K per head about its
    channel mean, B2's V per channel about its mean, B-pvbf16-online's V in
    bf16 with no scale or mean; under causal, the rows before kv_len."""
    rng = np.random.default_rng(15 + D)
    # f32 Q: a bf16 Q's codes sit at exact ties (a half of the row's amax
    # is 63.5 codes), which JAX's interpret mode and the port may break
    # apart: at a row that sees three keys JAX's lse then sat ~5e-3 from the
    # float64 logsumexp of the port's codes, the port's ~7e-7
    q = torch.from_numpy(rng.standard_normal((1, Hq, S, D)).astype(np.float32))
    k, v = (_bf16(rng, 1, Hk, S, D).float() for _ in range(2))
    k[..., 3] += 2.0
    km, kamax = channel_stats(k, kv_len)
    ks = _scale(kamax.amax(dim=3, keepdim=True), 127.0)
    k8 = quant_int8_fixed(k, ks, sub=km)
    kw = dict(k_head_scale=ks)
    bf16_v = key == "B-pvbf16-online"
    if not bf16_v:
        vm, vamax = channel_stats(v, kv_len)
        vs = _scale(vamax, 127.0)
        v = quant_int8_fixed(v, vs, sub=vm)
        kw.update(v_scale=vs, v_mean=vm)
    fields = dict(block_q=BLK, block_k=BLK, block_k_inner=BLK, causal=causal, quantized=True,
                  pv_dtype="bf16" if bf16_v else "int8", fuse_q_quant=True, fold_k_scale=True,
                  softmax_mode="online", pv_via_bf16=not bf16_v, fuse_v_mean=not bf16_v,
                  kv_len=kv_len, emit_lse=True, sm_scale=D ** -0.5)
    cfg = tatt.AttnConfig(**fields, out_dtype=torch.float32)
    assert tatt.config_name(cfg, S) == key
    assert tatt.online_sm90_route(dataclasses.replace(cfg, out_dtype=torch.bfloat16), S, D,
                                  torch.bfloat16)
    out, lse = tatt.attention_call(q, k8, v, cfg=cfg, **kw)
    keys = tuple(sorted(kw))
    jo, jl = _jax_call(jatt.AttnConfig(**fields, out_dtype=jnp.float32, fp8_native_dot=False),
                       keys)(*(jnp.asarray(x.numpy()) for x in (q, k8, v)),
                             *(jnp.asarray(kw[n].numpy()) for n in keys))[:2]
    jo, jl = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jl))
    # JAX's static causal takes the rows from kv_len on as padding (its
    # attention.py:591-596): the real rows are compared
    r = kv_len if causal else S
    assert calc_diff(out[:, :, :r], jo[:, :, :r]) < JAX_BAR
    torch.testing.assert_close(lse[:, :, :r], jl[:, :, :r], atol=LSE_JAX_ATOL, rtol=0)
