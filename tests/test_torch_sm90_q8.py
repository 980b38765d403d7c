"""B6 (the forward on a pre-quantized Q) and the ring's B10 forms of it on
their Hopper route (``csrc/attention_q8_sm90.cu``): which configurations,
head dims and dtypes ``q8_sm90_route`` takes; what ``attention_kernel``
hands the entry (recorded, not run: no card here); and the plain version
the kernel is held to, at its 64-column online tiles, against the JAX
package's ``attention_call(fuse_q_quant=False, interpret=True)`` under
``jax.jit`` with 64-wide blocks and a float64 oracle, over head dims 64
and 128, causal or not, GQA 4:1, ``kv_len < Sk``, Q groups of 4, 32 and
128 rows, per-column and folded K scales, and the ring's device offsets
and true length (a hidden chunk and a chunk with fewer than 64 real rows
included).

Inputs are bf16-exact float32 from a numpy seed, quantized by the port's
plain quantizers.  Bars (tests/test_torch_attention.py's): port vs JAX
calc_diff < 1e-5, base-2 lse within 5e-3 of JAX's and within 1e-5 of the
float64 logsumexp of the port's own quantized logits; port vs the float64
attention of the float inputs < 1.5e-3.  A row that sees no key is
compared apart: v_mean (0 without it), and the plain version's lse.
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
from sageattention_tpu_torch.utils.testing import calc_diff

from port_cpu import yield_cpu  # noqa: F401  (one torch thread, low CPU priority)

JAX_BAR = 1e-5
LSE_JAX_ATOL = 5e-3
LSE_EXACT_ATOL = 1e-5
ORACLE_BAR = 1.5e-3
BLK = 64
Q8_KEY = ("B6-static", "B6-online")


def _bf16_exact(shape, rng):
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float()


def _quantized(q, k, v, q_group, fold_k, v_mean, sm_scale):
    """The pre-quantized operands of ``attention_call``: Q codes in groups
    of ``q_group`` rows (times sm_scale * log2 e), K codes with per-head
    scales folded into ``q_scale`` or per-column scales in groups of 16
    rows, V per-channel codes (about their mean with ``v_mean``), and the
    static cap factor ``kn_max``."""
    B, Hq, S, D = q.shape
    G = Hq // k.shape[1]
    q8, qs = tquant.quant_int8_groupwise(q, q_group, fold=sm_scale * tquant.LOG2E)
    q_scale = tquant.expand_scales_rows(qs, q_group, S)
    kw = {}
    if fold_k:
        ks = (k.abs().amax(dim=(2, 3), keepdim=True) / 127.0).clamp_min(1e-12)
        k8 = torch.clamp(torch.round(k / ks), -127, 127)
        q_scale = q_scale * ks.repeat_interleave(G, 1)
        kfac = k8.norm(dim=-1, keepdim=True)
    else:
        k8, kss = tquant.quant_int8_groupwise(k, 16)
        kw["k_scale"] = tquant.expand_scales_cols(kss, 16, k.shape[2])
        kfac = kw["k_scale"].transpose(2, 3) * k8.float().norm(dim=-1, keepdim=True)
    kw["kn_max"] = kfac.amax(dim=2, keepdim=True).repeat_interleave(G, 1)
    vm = v.mean(dim=2, keepdim=True) if v_mean else torch.zeros_like(v[:, :, :1])
    vs = ((v - vm).abs().amax(dim=2, keepdim=True) / 127.0).clamp_min(1e-12)
    v8 = torch.clamp(torch.round((v - vm) / vs), -127, 127).to(torch.int8)
    kw.update(q_scale=q_scale, v_scale=vs)
    if v_mean:
        kw["v_mean"] = vm
    return q8.to(torch.int8), k8.to(torch.int8), v8, kw


def _visible(S, Sk, causal, shift, kv_len):
    """[S, Sk] bool: row r sees column c."""
    c = torch.arange(Sk)[None, :]
    keep = (c < kv_len).expand(S, Sk)
    if causal:
        keep = keep & (c <= torch.arange(S)[:, None] + shift)
    return keep


def _oracle(q, k, v, keep, sm_scale):
    """float64 attention of the float inputs; a row that sees no key gives
    zeros."""
    G = q.shape[1] // k.shape[1]
    q, k, v = q.double(), k.double().repeat_interleave(G, 1), v.double().repeat_interleave(G, 1)
    s = (q @ k.transpose(-1, -2) * sm_scale).masked_fill(~keep, float("-inf"))
    p = torch.nan_to_num(torch.exp(s - s.amax(-1, keepdim=True)))
    return (p @ v) / p.sum(-1, keepdim=True).clamp_min(1e-300)


def _exact_lse2(q8, k8, kw, keep):
    """float64 base-2 logsumexp of the port's quantized logits."""
    G = q8.shape[1] // k8.shape[1]
    s = q8.double() @ k8.double().repeat_interleave(G, 1).transpose(-1, -2)
    s = s * kw["q_scale"].double()
    if "k_scale" in kw:
        s = s * kw["k_scale"].double().repeat_interleave(G, 1)
    s = s.masked_fill(~keep, float("-inf"))
    return torch.logsumexp(s * np.log(2.0), dim=-1) / np.log(2.0)


@functools.lru_cache(maxsize=None)
def _jax_call(cfg, keys):
    def run(q, k, v, *vals):
        return jatt.attention_call(q, k, v, cfg=cfg, interpret=True, **dict(zip(keys, vals)))
    return jax.jit(run)


# (key, D, causal, Hq, Hk, S, kv_len, q_group, fold_k, v_mean, shift, kv_true)
CASES = [
    ("B6-static", 64, False, 4, 1, 192, 150, 4, False, True, None, None),
    ("B6-online", 128, True, 2, 2, 192, 192, 32, True, True, None, None),
    ("B10-B6-static-offsets-kvtrue", 64, True, 4, 1, 256, 256, 128, True, False, 64, 200),
    ("B10-B6-online-offsets", 128, True, 2, 1, 192, 192, 32, True, False, -192, None),
    ("B10-B6-online-kvtrue", 64, False, 2, 2, 192, 192, 4, True, False, None, 40),
]


@pytest.mark.parametrize("key,D,causal,Hq,Hk,S,kv_len,q_group,fold_k,v_mean,shift,kv_true",
                         CASES, ids=[f"{c[0]}-D{c[1]}" for c in CASES])
def test_plain_matches_jax_and_oracle(key, D, causal, Hq, Hk, S, kv_len, q_group, fold_k,
                                      v_mean, shift, kv_true):
    rng = np.random.default_rng(CASES.index((key, D, causal, Hq, Hk, S, kv_len, q_group, fold_k,
                                             v_mean, shift, kv_true)))
    q, k, v = _bf16_exact((1, Hq, S, D), rng), _bf16_exact((1, Hk, S, D), rng), \
        _bf16_exact((1, Hk, S, D), rng)
    sm_scale = D ** -0.5
    q8, k8, v8, kw = _quantized(q, k, v, q_group, fold_k, v_mean, sm_scale)
    static = "static" in key
    if not static:
        kw.pop("kn_max")
    dyn = {}
    if shift is not None:
        dyn["offsets"] = torch.tensor([S + shift, S], dtype=torch.int32)   # q_start, kv_start
    if kv_true is not None:
        dyn["kv_true_dyn"] = torch.tensor(kv_true, dtype=torch.int32)
    fields = dict(block_q=BLK, block_k=BLK, block_k_inner=BLK, causal=causal,
                  causal_dynamic=shift is not None, kv_len_dynamic=kv_true is not None,
                  quantized=True, pv_dtype="int8", fold_k_scale=fold_k, kv_len=kv_len,
                  softmax_mode="static" if static else "online", pv_via_bf16=not static,
                  fuse_v_mean=v_mean, emit_lse=True, sm_scale=sm_scale)
    cfg = tatt.AttnConfig(**fields, out_dtype=torch.float32)
    assert tatt.config_name(cfg, S) == key
    assert tatt.q8_sm90_route(dataclasses.replace(cfg, out_dtype=torch.bfloat16), S, D,
                              torch.int8)
    out, lse = tatt.attention_call(q8, k8, v8, cfg=cfg, **kw, **dyn)
    jkw = {**kw, **dyn}
    keys = tuple(sorted(jkw))
    jo, jl = _jax_call(jatt.AttnConfig(**fields, out_dtype=jnp.float32, fp8_native_dot=False),
                       keys)(*(jnp.asarray(x.numpy()) for x in (q8, k8, v8)),
                             *(jnp.asarray(jkw[n].numpy()) for n in keys))[:2]
    jo, jl = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jl))
    keep = _visible(S, S, causal, 0 if shift is None else shift,
                    min(kv_len, S if kv_true is None else kv_true))
    live = keep.any(-1)
    if live.any():
        assert calc_diff(out[:, :, live], jo[:, :, live]) < JAX_BAR
        torch.testing.assert_close(lse[:, :, live], jl[:, :, live], atol=LSE_JAX_ATOL, rtol=0)
        exact = _exact_lse2(q8, k8, kw, keep)
        torch.testing.assert_close(lse[:, :, live].double(), exact[:, :, live],
                                   atol=LSE_EXACT_ATOL, rtol=0)
        ref = _oracle(q, k, v, keep, sm_scale)
        assert calc_diff(out[:, :, live], ref[:, :, live]) < ORACLE_BAR
    # rows that see no key: v_mean (0 without it) and the floor of the lse
    dead = ~live
    if dead.any():
        vm = kw["v_mean"] if v_mean else torch.zeros(1, Hk, 1, D)
        want = vm.repeat_interleave(Hq // Hk, 1).expand(1, Hq, int(dead.sum()), D)
        assert torch.equal(out[:, :, dead], want)
        tiny = float(np.log2(np.float32(1e-37)))
        floor = (tatt._prepare_q(q8, cfg, key, None, kw["kn_max"], kw["q_scale"])[2][..., 0]
                 if static else torch.full((1, Hq, S), tatt.M_CLAMP)) + tiny
        assert torch.equal(lse[:, :, dead], floor[:, :, dead])
        torch.testing.assert_close(jl[:, :, dead], lse[:, :, dead], atol=LSE_JAX_ATOL, rtol=0)


def _key_configs():
    """One configuration and row count for every launch key."""
    seen = {}
    for cfg, rows in tatt._launch_configs():
        try:
            seen.setdefault(tatt.config_name(cfg, rows), (cfg, rows))
        except ValueError:
            pass
    return seen


def test_route_takes_exactly_b6_and_its_ring_forms():
    """``q8_sm90_route`` takes exactly B6-static, B6-online and their B10
    forms, at head dims 64 and 128, on int8 Q codes with a bf16 output;
    every other launch key, D = 256, another Q dtype or an f32/f16 output
    stays on ``attention.cuh``."""
    configs = _key_configs()
    assert set(configs) == set(tatt.LAUNCH_KEYS)
    routed = set()
    for key, (cfg, rows) in configs.items():
        base = key.removeprefix("B10-").removesuffix("-kvtrue").removesuffix("-offsets")
        for D, q_dtype, out_dtype in itertools.product(
                (64, 128, 256), (torch.int8, torch.bfloat16, torch.float32),
                (torch.bfloat16, torch.float32, torch.float16)):
            got = tatt.q8_sm90_route(dataclasses.replace(cfg, out_dtype=out_dtype), rows, D,
                                     q_dtype)
            want = (base in Q8_KEY and D < 256 and q_dtype == torch.int8
                    and out_dtype == torch.bfloat16)
            assert got == want, (key, D, q_dtype, out_dtype)
            if got:
                routed.add(key)
    assert routed == {"B6-static", "B6-online"} | {
        b + s for b in ("B10-B6-static", "B10-B6-online")
        for s in ("-offsets", "-kvtrue", "-offsets-kvtrue")}


def _record(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "call", lambda fn, device, *args: calls.append((fn, args)))
    return calls


def _codes(rng, *shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


# positions in sage_attn_fwd_q8_sm90's arguments
Q_SCALE_AT, KS_AT, KNM_AT, DYN_AT = 18, 19, 23, 27


@pytest.mark.parametrize("mode,fold,dyn", [("static", False, False), ("online", True, False),
                                           ("static", True, True), ("online", True, True)])
def test_dispatch(monkeypatch, mode, fold, dyn):
    """B6 and B10-B6 at D = 64 go to ``sage_attn_fwd_q8_sm90``: the Q and K
    codes and their strides as they are (NHD-strided Q codes included), V's
    codes widened by ``widen_v_codes``, the row scales, per-column K scales
    (a null pointer when folded), kn_max only when static, and the ring's
    offsets and true length as device pointers, not values.  The launch key
    is counted and no lmin returned."""
    calls = _record(monkeypatch)
    widened = []
    real = tatt.widen_v_codes
    monkeypatch.setattr(tatt, "widen_v_codes", lambda v: widened.append(real(v)) or widened[-1])
    rng = np.random.default_rng(3)
    B, Hq, Hk, S, D = 1, 4, 2, 200, 64
    q8 = _codes(rng, B, S, Hq, D).transpose(1, 2)   # NHD storage
    k8, v8 = _codes(rng, B, Hk, S, D), _codes(rng, B, Hk, S, D)
    ones = lambda *s: torch.ones(*s)  # noqa: E731
    kw = dict(q_scale=ones(B, Hq, S, 1), v_scale=ones(B, Hk, 1, D))
    if not fold:
        kw["k_scale"] = ones(B, Hk, 1, S)
    if mode == "static":
        kw["kn_max"] = ones(B, Hq, 1, 1)
    ext = {}
    if dyn:
        ext = dict(offsets=torch.tensor([S, 0], dtype=torch.int32),
                   kv_true=torch.tensor([150], dtype=torch.int32))
    cfg = tatt.AttnConfig(quantized=True, pv_dtype="int8", fold_k_scale=fold, softmax_mode=mode,
                          pv_via_bf16=mode == "online", causal=dyn, causal_dynamic=dyn,
                          kv_len_dynamic=dyn, sm_scale=D ** -0.5)
    name = tatt.config_name(cfg, S)
    before = tatt.attention_call.launches[name]
    out, lse, lmin = tatt.attention_kernel(q8, k8, v8, cfg, **kw, **ext)
    assert [fn for fn, _ in calls] == ["sage_attn_fwd_q8_sm90"] and lmin is None
    assert tatt.attention_call.launches[name] == before + 1
    args = calls[0][1]
    assert args[:3] == (D, int(mode == "online"), q8.data_ptr()) and args[3] == k8.data_ptr()
    assert len(widened) == 1 and args[4] == widened[0].data_ptr()
    assert widened[0].dtype == torch.bfloat16 and torch.equal(widened[0].float(), v8.float())
    assert args[6:9] == q8.stride()[:3] and args[9:12] == k8.stride()[:3]
    assert args[Q_SCALE_AT] == kw["q_scale"].data_ptr()
    if fold:
        assert args[KS_AT:KS_AT + 4] == (None, 0, 0, S)
    else:
        assert args[KS_AT:KS_AT + 4] == (kw["k_scale"].data_ptr(), Hk * S, S, S)
    assert (args[KNM_AT] is None) == (mode == "online")
    want = (ext["offsets"].data_ptr(), ext["kv_true"].data_ptr()) if dyn else (None, None)
    assert args[DYN_AT:DYN_AT + 2] == want
    assert args[DYN_AT + 2:] == (B, Hq, Hk, S, S, S, int(dyn))
    assert out.dtype == torch.bfloat16 and lse.shape == (B, Hq, S)


def test_dispatch_pads_misaligned_column_scales(monkeypatch):
    """Per-column K scales whose rows are not 16 bytes apart (Sk = 129)
    go to the entry as a copy with rows of 132 floats."""
    calls = _record(monkeypatch)
    rng = np.random.default_rng(4)
    S, D = 129, 128
    q8, k8, v8 = (_codes(rng, 1, 2, S, D) for _ in range(3))
    ks = torch.rand(1, 2, 1, S) + 0.5
    cfg = tatt.AttnConfig(quantized=True, pv_dtype="int8", softmax_mode="online",
                          pv_via_bf16=True, sm_scale=D ** -0.5)
    tatt.attention_kernel(q8, k8, v8, cfg, q_scale=torch.ones(1, 2, S, 1), k_scale=ks,
                          v_scale=torch.ones(1, 2, 1, D))
    args = calls[0][1]
    assert calls[0][0] == "sage_attn_fwd_q8_sm90" and args[KS_AT] != ks.data_ptr()
    assert args[KS_AT + 1:KS_AT + 4] == (2 * 132, 132, S)


@pytest.mark.parametrize("D,out_dtype,entry", [(256, torch.bfloat16, "sage_attn_fwd_q8"),
                                               (128, torch.float32, "sage_attn_fwd_ring")])
def test_outside_the_route_stays_on_the_old_body(monkeypatch, D, out_dtype, entry):
    """D = 256, and an f32 output (the old ring entry writes f32 O), stay
    on ``attention.cuh``'s entries."""
    calls = _record(monkeypatch)
    rng = np.random.default_rng(5)
    S = 128
    q8, k8, v8 = (_codes(rng, 1, 2, S, D) for _ in range(3))
    ring = entry == "sage_attn_fwd_ring"
    cfg = tatt.AttnConfig(quantized=True, pv_dtype="int8", fold_k_scale=True,
                          softmax_mode="static", kv_len_dynamic=ring, out_dtype=out_dtype,
                          sm_scale=D ** -0.5)
    tatt.attention_kernel(q8, k8, v8, cfg, q_scale=torch.ones(1, 2, S, 1),
                          kn_max=torch.ones(1, 2, 1, 1), v_scale=torch.ones(1, 2, 1, D),
                          kv_true=torch.tensor([S], dtype=torch.int32) if ring else None)
    assert [fn for fn, _ in calls] == [entry]


def test_a_failed_launch_raises(monkeypatch):
    """An error code from the entry raises with its message: nothing falls
    back to another kernel or to the plain version."""
    class Lib:
        calls = []

        def sage_attn_fwd_q8_sm90(self, *args):
            self.calls.append(args)
            return -1

        def sage_attn_q8_sm90_error_string(self, e):
            return b"unsupported B6 configuration"

    lib = Lib()
    monkeypatch.setattr(_build, "build_all", lambda: {"attention_q8_sm90": lib})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    rng = np.random.default_rng(6)
    q8, k8, v8 = (_codes(rng, 1, 2, 128, 64) for _ in range(3))
    cfg = tatt.AttnConfig(quantized=True, pv_dtype="int8", fold_k_scale=True,
                          softmax_mode="online", pv_via_bf16=True, sm_scale=0.125)
    with pytest.raises(RuntimeError, match="sage_attn_fwd_q8_sm90 failed to launch: "
                                           "unsupported B6 configuration"):
        tatt.attention_kernel(q8, k8, v8, cfg, q_scale=torch.ones(1, 2, 128, 1),
                              v_scale=torch.ones(1, 2, 1, 64))
    assert len(lib.calls) == 1
