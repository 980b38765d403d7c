"""Packed varlen attention in the port (B8 and A6's segmented mode):
segment ids, the segment-aware quantizer, ``sageattn_varlen``,
``sage_joint_attention_ragged`` and ``layered_attention``, against the JAX
package in interpret mode on the same numpy-seeded inputs.

Bars:
  - segment ids and the quantizer's codes, scales, norms, dots and capmax:
    equal to JAX's;
  - ``sageattn_varlen`` vs JAX's, same arguments: calc_diff < 1e-5.  e4m3
    P depends on the kv tile (ROADMAP queue 3): JAX's varlen picks 512-wide
    tiles there and the port walks 64-wide ones, so fp8 is held to 5e-4
    (the bar of ``tests/test_torch_modes.py``);
  - each sequence against its own float64 attention: < 1e-3
    (``tests/test_varlen.py``), 5e-3 for e4m3 P;
  - natural-log lse within 5e-3 of JAX's (its interpret-mode denominators
    for an in-kernel int8 Q, ROADMAP queue 3);
  - the ragged joint attention and a two-block DiT through
    ``layered_attention`` against the JAX functions: < 1e-3 (bf16 model).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import varlen as jvarlen
from sageattention_tpu.models import dit as jdit
from sageattention_tpu.models import integration as jint
from sageattention_tpu.ops import quant_pallas as qp
from sageattention_tpu_torch import sageattn_varlen
from sageattention_tpu_torch import varlen as tvarlen
from sageattention_tpu_torch.models import (DiT, DiTConfig, dit_state_dict_from_jax,
                                            layered_attention, sage_joint_attention_ragged)
from sageattention_tpu_torch.ops import quant_kernels as qk
from sageattention_tpu_torch.utils.testing import calc_diff

from port_cpu import yield_cpu  # noqa: F401  (one torch thread, low CPU priority)

ORACLE_BAR = {"int8": 1e-3, "bf16": 1e-3, "fp8": 5e-3}
JAX_BAR = {"int8": 1e-5, "bf16": 1e-5, "fp8": 5e-4}


def packed(lens, Hq, Hk, D, seed, lens_k=None):
    rng = np.random.default_rng(seed)
    Tq, Tk = sum(lens), sum(lens_k or lens)
    q = rng.standard_normal((Tq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((Tk, Hk, D)).astype(np.float32)
    v = rng.standard_normal((Tk, Hk, D)).astype(np.float32)
    k[..., 5] += 2.0
    cu = lambda ls: np.concatenate([[0], np.cumsum(ls)]).astype(np.int32)  # noqa: E731
    return ([torch.from_numpy(x).to(torch.bfloat16).float() for x in (q, k, v)],
            cu(lens), cu(lens_k or lens))


def per_sequence_oracle(q, k, v, cu_q, cu_k, causal, window=0, sinks=0):
    """float64 attention of every sequence on its own; empty ones skipped."""
    outs = torch.zeros(q.shape, dtype=torch.float64)
    G = q.shape[1] // k.shape[1]
    for i in range(len(cu_q) - 1):
        a, b, c, d = cu_q[i], cu_q[i + 1], cu_k[i], cu_k[i + 1]
        if b == a or d == c:
            continue
        qs = q[a:b].double().transpose(0, 1)
        ks = k[c:d].double().transpose(0, 1).repeat_interleave(G, 0)
        vs = v[c:d].double().transpose(0, 1).repeat_interleave(G, 0)
        s = qs @ ks.transpose(-1, -2) / q.shape[-1] ** 0.5
        r, col = torch.arange(b - a)[:, None], torch.arange(d - c)[None, :]
        keep = torch.ones(b - a, d - c, dtype=torch.bool)
        if causal:
            keep = col <= r
            if window:
                keep &= (col >= r - window + 1) | (col < sinks)
        outs[a:b] = (torch.softmax(s.masked_fill(~keep, float("-inf")), -1) @ vs).transpose(0, 1)
    return outs


def run_both(q, k, v, cu_q, cu_k, **kw):
    port = sageattn_varlen(q, k, v, torch.from_numpy(cu_q), torch.from_numpy(cu_k), **kw)
    jkw = {a: (jnp.asarray(b.numpy()) if isinstance(b, torch.Tensor) else b)
           for a, b in kw.items()}
    ref = jvarlen.sageattn_varlen(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                  jnp.asarray(cu_q), jnp.asarray(cu_k), use_fused=True,
                                  interpret=True, **jkw)
    return port, ref


@pytest.mark.parametrize("cu,total", [([0, 5, 5, 12, 40], 64), ([0, 0, 7, 7, 7], 16),
                                      ([0, 64, 128], 130)])
def test_segment_ids_match_jax(cu, total):
    """Zero-length sequences (repeated boundaries) own no token."""
    ids = tvarlen.cu_seqlens_to_segment_ids(torch.tensor(cu, dtype=torch.int32), total)
    ref = jvarlen.cu_seqlens_to_segment_ids(jnp.asarray(cu, jnp.int32), total)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref))
    assert ids.dtype == torch.int32


@pytest.mark.parametrize("group,fold,stats", [(64, 1.0, False), (128, 0.18, True),
                                              (16, 1.0, True)])
def test_segmented_quant_matches_jax(group, fold, stats):
    """A6's segmented mode: codes, per-row scales confined to (group ∩
    segment), row norms, row dots against a GQA int8 operand, capmax over
    the true rows."""
    rng = np.random.default_rng(group)
    S, H, D = 384, 4, 64
    x = rng.standard_normal((1, H, S, D)).astype(np.float32)
    x[:, :, 100:103] *= 40.0                    # an outlier run in one segment
    seg = np.repeat(np.arange(5), [30, 71, 1, 200, 82]).astype(np.int32)
    seg[-20:] = -1                              # pads
    sub = rng.standard_normal((1, H, 1, D)).astype(np.float32) * 0.1
    w = rng.integers(-127, 128, (1, 2, S, D)).astype(np.int8)
    kw = dict(fold=fold, sub=sub)
    if stats:
        kw.update(with_norm=True, dot_with=w, with_capmax=True, s_true=S - 20)
    jr = qp.quant_int8_segmented_pallas(jnp.asarray(x), jnp.asarray(seg), group,
                                        interpret=True,
                                        **{a: (jnp.asarray(b) if isinstance(b, np.ndarray) else b)
                                           for a, b in kw.items()})
    tr = qk.quant_int8_segmented(torch.from_numpy(x), torch.from_numpy(seg), group,
                                 **{a: (torch.from_numpy(b) if isinstance(b, np.ndarray) else b)
                                    for a, b in kw.items()})
    assert len(jr) == len(tr)
    np.testing.assert_array_equal(tr[0].numpy(), np.asarray(jr[0]))
    for a, b in zip(tr[1:], jr[1:]):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


LENS = [100, 0, 37, 140, 23]      # a zero-length sequence, unaligned lengths
CASES = [  # id, kwargs
    ("causal-static", dict(is_causal=True, pv_dtype="int8")),
    ("dense-static", dict(pv_dtype="int8")),
    ("fp8", dict(pv_dtype="fp8", is_causal=True)),
    ("bf16", dict(pv_dtype="bf16")),
    ("window-sinks", dict(pv_dtype="int8", is_causal=True, sliding_window=48,
                          attention_sinks=4)),
    ("fp8-window-sinks", dict(pv_dtype="fp8", is_causal=True, sliding_window=30,
                              attention_sinks=70)),
    ("unfused-q-predictive", dict(pv_dtype="int8", is_causal=True, fuse_q_quant=False)),
    ("per-thread", dict(pv_dtype="int8", qk_quant_gran="per_thread")),
]


@pytest.mark.parametrize("kw", [c[1] for c in CASES], ids=[c[0] for c in CASES])
def test_varlen_matches_jax(kw):
    (q, k, v), cu, _ = packed(LENS, 4, 2, 64, seed=len(kw))
    port, ref = run_both(q, k, v, cu, cu, **kw)
    pv = kw["pv_dtype"]
    assert port.shape == q.shape and bool(torch.isfinite(port).all())
    assert calc_diff(port, np.asarray(ref)) < JAX_BAR[pv]
    oracle = per_sequence_oracle(q, k, v, cu, cu, kw.get("is_causal", False),
                                 kw.get("sliding_window", 0), kw.get("attention_sinks", 0))
    assert calc_diff(port, oracle) < ORACLE_BAR[pv]


def test_varlen_native_compute_matches_jax():
    """A pack long enough for native compute: K through A6's segmented mode
    with per-row scales, Q quantized inside the kernel against per-column K
    scales (B1-colk-seg), the static softmax's post-hoc check."""
    (q, k, v), cu, _ = packed([700, 300, 200], 2, 1, 64, seed=3)
    port, ref = run_both(q, k, v, cu, cu, is_causal=True, pv_dtype="int8",
                         compute_dtype="native")
    assert calc_diff(port, np.asarray(ref)) < JAX_BAR["int8"]
    assert calc_diff(port, per_sequence_oracle(q, k, v, cu, cu, True)) < 1e-3


def test_varlen_mismatched_packings_and_lse_match_jax():
    """Non-causal, q and k packed differently (the static softmax takes the
    post-hoc check of a fused Q), with the lse."""
    (q, k, v), cu_q, cu_k = packed(LENS, 4, 2, 64, seed=5, lens_k=[60, 40, 77, 100, 23])
    (port, lse), (ref, jlse) = run_both(q, k, v, cu_q, cu_k, pv_dtype="int8",
                                        return_lse=True)
    assert calc_diff(port, np.asarray(ref)) < JAX_BAR["int8"]
    assert calc_diff(port, per_sequence_oracle(q, k, v, cu_q, cu_k, False)) < 1e-3
    assert tuple(lse.shape) == (4, 300)
    # JAX's interpret-mode denominators for an in-kernel int8 Q sit up to
    # ~2e-3 (base 2) off the exact sum (ROADMAP queue 3)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=5e-3, rtol=0)


@pytest.mark.parametrize("kind", ["bool", "float"])
def test_varlen_attn_mask_matches_jax(kind):
    """A user mask on top of the segments (Q quantized before the kernel,
    the online softmax under "auto")."""
    (q, k, v), cu, _ = packed(LENS, 4, 2, 64, seed=7)
    rng = np.random.default_rng(8)
    if kind == "bool":
        m = torch.from_numpy(rng.random((1, 300, 300)) > 0.3)
        m |= torch.eye(300, dtype=torch.bool)
    else:
        m = torch.from_numpy(rng.standard_normal((4, 300, 300)).astype(np.float32))
    port, ref = run_both(q, k, v, cu, cu, pv_dtype="int8", is_causal=True, attn_mask=m)
    assert calc_diff(port, np.asarray(ref)) < JAX_BAR["int8"]


def test_varlen_packing_guards():
    (q, k, v), cu_q, cu_k = packed([50, 80, 30], 2, 2, 64, seed=9, lens_k=[90, 20, 50])
    with pytest.raises(ValueError, match="cu_seqlens_q == cu_seqlens_k"):
        sageattn_varlen(q, k, v, torch.from_numpy(cu_q), torch.from_numpy(cu_k),
                        is_causal=True)
    with pytest.raises(ValueError, match="matching"):
        sageattn_varlen(q, k, v, torch.from_numpy(cu_q), torch.from_numpy(cu_k),
                        softmax_mode="static", fuse_q_quant=False)
    with pytest.raises(ValueError):
        sageattn_varlen(q, k, v, cu_q, cu_q, sliding_window=16)
    # equal values in separate tensors are the same packing
    cu = torch.from_numpy(cu_q)
    out = sageattn_varlen(q, q[:, :2], q[:, :2], cu, cu.clone(), is_causal=True)
    assert out.shape == q.shape


def _ragged_inputs(B, T, V, H, D, valid, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T + V, H, D)).astype(np.float32) for _ in range(3))
    mask = np.array([[i < n for i in range(T)] for n in valid])
    return [torch.from_numpy(x).to(torch.bfloat16).float() for x in (q, k, v)], mask


@pytest.mark.parametrize("valid", [(64, 23), (64, 64)])
def test_ragged_joint_attention_matches_jax(valid):
    """Per-row padded text stripped through one varlen call; a row whose
    text is all valid makes a zero-length garbage segment."""
    (q, k, v), mask = _ragged_inputs(2, 64, 192, 2, 64, valid, seed=sum(valid))
    out = sage_joint_attention_ragged(q, k, v, torch.from_numpy(mask), pv_dtype="int8")
    ref = jint.sage_joint_attention_ragged(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                           jnp.asarray(mask), pv_dtype="int8",
                                           use_fused=True, interpret=True)
    assert calc_diff(out, np.asarray(ref)) < JAX_BAR["int8"]
    # the exact answer: attention over each row's real tokens, pads zeroed
    for b, n in enumerate(valid):
        real = np.concatenate([np.arange(n), np.arange(64, 256)])
        xs = [x[b, real][None].transpose(1, 2).double() for x in (q, k, v)]
        s = xs[0] @ xs[1].transpose(-1, -2) / 8.0
        o = (torch.softmax(s, -1) @ xs[2]).transpose(1, 2)[0]
        assert calc_diff(out[b, real], o) < 1e-3
        assert not bool(out[b, n:64].any())


def test_layered_ragged_dit_matches_jax():
    """A two-block DiT whose first layer runs the ragged joint attention
    and whose last is skipped (the port's exact flash, JAX's exact jax.nn),
    with the JAX model's weights carried over."""
    cfg = dict(hidden=128, heads=2, depth=2, frames=2, height=8, width=8, patch=2,
               text_len=16, text_dim=64, in_channels=4, zero_init_gates=False)
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 2, 8, 8, 4)).astype(np.float32)
    txt = rng.standard_normal((2, 16, 64)).astype(np.float32)
    t = np.array([500, 500], np.int32)
    tmask = np.array([[i < n for i in range(16)] for n in (16, 9)])

    def j_ragged(q, k, v, *a, **kw):
        return jint.sage_joint_attention_ragged(q, k, v, jnp.asarray(tmask), pv_dtype="int8",
                                                use_fused=True, interpret=True)

    jsel = jint.layered_attention(default_fn=j_ragged, skip_layers=(1,))
    jm = jdit.make_dit(jdit.DiTConfig(**cfg), attn_fn=jsel)
    params = jdit.make_dit(jdit.DiTConfig(**cfg)).init(
        jax.random.PRNGKey(0), jnp.asarray(lat), jnp.asarray(txt), jnp.asarray(t))
    jo = np.asarray(jm.apply(params, jnp.asarray(lat), jnp.asarray(txt), jnp.asarray(t))
                    .astype(jnp.float32))

    def t_ragged(q, k, v, *a, **kw):
        return sage_joint_attention_ragged(q, k, v, torch.from_numpy(tmask), pv_dtype="int8")

    tm = DiT(DiTConfig(**cfg), attn_fn=layered_attention(default_fn=t_ragged,
                                                         skip_layers=(cfg["depth"] - 1,)),
             device="cpu")
    tm.load_state_dict(dit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        to = tm(*(torch.from_numpy(x) for x in (lat, txt, t)))
    assert calc_diff(to, jo) < 1e-3 and bool(torch.isfinite(to.float()).all())


def test_segment_tile_ranges_decide_skips_exactly():
    """The kernel skips a (q tile, kv tile) pair whose segment-id ranges do
    not meet and leaves unmasked one whose ids are all one value: both must
    agree with the element-wise segment mask."""
    from sageattention_tpu_torch.ops.attention import segment_tile_ranges
    lens = [100, 0, 37, 140, 23, 64, 1]
    T = sum(lens)
    ids = tvarlen.cu_seqlens_to_segment_ids(
        torch.tensor(np.concatenate([[0], np.cumsum(lens)]), dtype=torch.int32), T + 50)
    q_ids = torch.where(torch.arange(T + 50) < T, ids, -1)[None]
    kv_ids = torch.where(torch.arange(T + 50) < T, ids, -2)[None]
    rq, rk = segment_tile_ranges(q_ids), segment_tile_ranges(kv_ids)
    assert tuple(rq.shape) == (1, -(-(T + 50) // 64), 2) and rq.dtype == torch.int32
    same = q_ids[0, :, None] == kv_ids[0, None, :]
    n_dead = n_uniform = 0
    for i in range(rq.shape[1]):
        for j in range(rk.shape[1]):
            tile = same[i * 64:(i + 1) * 64, j * 64:(j + 1) * 64]
            (qlo, qhi), (klo, khi) = rq[0, i].tolist(), rk[0, j].tolist()
            if qhi < klo or qlo > khi:
                n_dead += 1
                assert not bool(tile.any())
            elif qlo == qhi == klo == khi:
                n_uniform += 1
                assert bool(tile.all())
    assert n_dead and n_uniform
