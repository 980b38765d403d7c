"""Ring attention over a process group: quantized KV chunks rotate with
their scales (counterpart of ``sageattention_tpu/parallel/ring.py``).

Each rank of the ``axis_name`` group holds one block-aligned shard of the
sequence.  The shape of the computation is the JAX package's:

  - the global K mean (smooth_k) is an ``all_reduce`` before quantization;
    pad rows of a padded sequence become the mean, so they quantize to 0;
  - K and V are quantized once per shard, and the int8 / e4m3 payloads
    rotate around the ring with their scales (``dist.batch_isend_irecv``,
    posted before the step's attention, as JAX issues its ``ppermute``);
  - every step is one attention launch on the chunk that arrived: kernel
    B10 when the call is causal (the device ``offsets`` ``(q_start,
    kv_start)`` make the causal test global, so a later shard's chunk runs
    no tile) or padded (the chunk's device true length masks its tail);
  - the static softmax's safety is decided once per call before the loop,
    from the ring-wide worst K factor (an ``all_reduce`` MAX): one host
    read, as single-device ``sageattn`` makes one;
  - partials come back bf16 with a base-2 lse, get their chunk's V mean
    added, and merge in f32 by lse weights; the smooth_k lse repair uses
    the global mean.

The body is split into per-rank phase functions that take the
collectives' results as arguments (:func:`ring_k_stat`, :func:`ring_prep`,
:func:`ring_static_safe`, :func:`ring_step`, :func:`ring_finish`, and
:func:`ring_bwd_pair` for the backward); ``_ring_body`` and
``_ring_bwd_body`` compose them with the collectives.  ``chip_smoke.py``
composes the same functions over virtual ranks in one process.

No fallback: a CUDA tensor needs an NCCL group and a CPU tensor a gloo
group; anything else raises.  The offsets and true lengths of a call are
device tensors built once, so no step copies a Python number to the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from .. import core
from .. import dispatch
from ..ops import backward as backward_ops
from ..ops import quant as quant_ops
from ..ops.attention import AttnConfig, attention_call
from ..ops.quant_kernels import channel_stats, quant_int8_fixed, quant_int8_groupwise
from ..ops.reference import _no_tf32
from ..utils.layout import round_up
from .mesh import SP

LOG2E = quant_ops.LOG2E


def _merge(o1, lse1, o2, lse2):
    """Combine two attention partials (natural-log lse), lse-weighted."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    l = w1 + w2
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = (o1.float() * w1[..., None] + o2.float() * w2[..., None]) / l[..., None]
    return o, m + torch.log(l)


def _repeat_heads(x, G):
    """Broadcast a KV-head tensor [B,Hk,...] over query head groups -> [B,Hq,...]."""
    return x if G == 1 else x.repeat_interleave(G, dim=1)


@dataclasses.dataclass(frozen=True)
class RingPlan:
    """What every rank of one ring call agrees on: ``n`` ranks of ``S``
    padded rows each, ``s_true`` real rows in all (0: none padded), and the
    resolved modes."""
    n: int
    S: int
    s_true: int
    is_causal: bool
    sm_scale: float
    qk_quant_gran: str
    pv_dtype: str
    compute_dtype: str
    softmax_mode: str

    @property
    def padded(self) -> bool:
        return bool(self.s_true) and self.s_true != self.n * self.S

    @property
    def static_mode(self) -> bool:
        return self.softmax_mode == "static"

    @property
    def fold_k(self) -> bool:
        """Per-head K scales, folded into the per-row Q scales each step."""
        return self.compute_dtype == "bf16" or self.static_mode

    def real_rows(self, src: int) -> int:
        """Real rows of shard ``src``."""
        return min(max(self.s_true - src * self.S, 0), self.S) if self.padded else self.S


def ring_setup(q, k, v, n: int, *, is_causal=False, sm_scale=None, qk_quant_gran="per_thread",
               pv_dtype=None, compute_dtype=None, softmax_mode="auto", block_q=0, block_k=0):
    """JAX's argument handling and padding (``ring.py:448-500``): ``(plan,
    q, k, v)`` with the sequence padded to ``n`` block-aligned shards and
    the head dim to 64/128/256.  ``block_q``/``block_k`` only set the
    padding granule here: the kernel picks its own tiles."""
    B, Hq, S, D = q.shape
    Hk = k.shape[1]
    if Hq % Hk != 0:
        raise ValueError(f"num_qo_heads ({Hq}) must be divisible by "
                         f"num_kv_heads ({Hk}) for ring GQA")
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    caps = dispatch.detect(q.device)
    if pv_dtype is None:
        pv_dtype = caps.default_pv_dtype
    if compute_dtype is None:
        compute_dtype = caps.default_compute_dtype
    if compute_dtype == "bf16" and pv_dtype == "fp8":
        pv_dtype = "int8"
    if softmax_mode == "auto":
        softmax_mode = "static" if pv_dtype != "fp8" else "online"
    S_local_min = -(-S // n)
    gran = max(block_q, block_k) or core._pick_block(2048, S_local_min)
    S_local = round_up(S_local_min, gran)
    S_pad = n * S_local
    pads = (0, 0, 0, S_pad - S)
    if D not in (64, 128, 256):
        pads = (0, (64 if D < 64 else 128 if D < 128 else 256) - D) + pads[2:]
    if any(pads):
        q, k, v = (torch.nn.functional.pad(x, pads) for x in (q, k, v))
    plan = RingPlan(n=n, S=S_local, s_true=S if S_pad != S else 0, is_causal=is_causal,
                    sm_scale=sm_scale, qk_quant_gran=qk_quant_gran, pv_dtype=pv_dtype,
                    compute_dtype=compute_dtype, softmax_mode=softmax_mode)
    return plan, q, k, v


# ------------------------------------------------ per-rank phases ----

def _valid(plan: RingPlan, idx: int, device):
    """[1, 1, S, 1]: the rows of shard ``idx`` that are real."""
    return (idx * plan.S + torch.arange(plan.S, device=device) < plan.s_true)[None, None, :, None]


def ring_k_stat(k, plan: RingPlan, idx: int):
    """This rank's share of the global K mean, to be summed over the ring:
    the sum of its real rows when padded, else its own mean."""
    kf = k.float()
    if plan.padded:
        return (kf * _valid(plan, idx, k.device)).sum(dim=2, keepdim=True)
    return kf.mean(dim=2, keepdim=True)


def ring_k_mean(total, plan: RingPlan):
    """The global K mean from the ring's sum of :func:`ring_k_stat`."""
    return total * (1.0 / plan.s_true) if plan.padded else total / plan.n


def ring_prep(q, k, v, km, plan: RingPlan, idx: int):
    """Quantize this rank's shard given the global K mean ``km``.  Returns
    ``(qpack, chunk)``: the rank's own int8 Q with its unfolded per-row
    scales (and, static, its capmax), and the K/V chunk that rotates:
    codes, K scales (per head ``ks_head``, or per column ``ks``), the cap
    factor ``knmax`` (static), V scales ``vs`` and V mean ``vm``."""
    S = plan.S
    q_group, k_group = quant_ops.QUANT_GRANULARITIES[plan.qk_quant_gran]
    fold = plan.sm_scale * LOG2E
    if plan.padded:
        valid = _valid(plan, idx, k.device)
        k = torch.where(valid, k, km.to(k.dtype))
    chunk, qpack = {}, {}
    if plan.fold_k:
        amax = (k.float() - km).abs().amax(dim=(2, 3), keepdim=True)
        ks_head = torch.where(amax > 0, amax * (1.0 / 127.0), torch.ones_like(amax))
        if plan.static_mode:
            chunk["k"], chunk["knmax"] = quant_int8_fixed(k, ks_head, sub=km, with_capmax=True)
            q_i8, q_s, qpack["capmax"] = quant_int8_groupwise(q, q_group, fold=fold,
                                                              with_capmax=True)
        else:
            chunk["k"] = quant_int8_fixed(k, ks_head, sub=km)
            q_i8, q_s = quant_int8_groupwise(q, q_group, fold=fold)
        chunk["ks_head"] = ks_head
    else:
        q_i8, q_s = quant_int8_groupwise(q, q_group, fold=fold)
        chunk["k"], k_s = quant_int8_groupwise(k, k_group, sub=km)
        chunk["ks"] = quant_ops.expand_scales_cols(k_s, k_group, S).contiguous()
    qpack["q"] = q_i8
    qpack["scale"] = quant_ops.expand_scales_rows(q_s, q_group, S)

    if plan.padded:
        # channel stats over real rows only; the quantized pad rows are
        # garbage that the kernel's device true length hides
        n_real = float(plan.real_rows(idx))
        vf = v.float()
        vm_pad = (vf * valid).sum(dim=2, keepdim=True) / max(n_real, 1.0)
        va_pad = ((vf - vm_pad).abs() * valid).amax(dim=2, keepdim=True)
    if plan.pv_dtype == "bf16":
        chunk["v"] = v.to(torch.bfloat16)
    elif plan.pv_dtype == "int8":
        if plan.padded:
            vm, v_amax = vm_pad, va_pad
        else:
            vm, v_amax = channel_stats(v, S)
        vs = torch.where(v_amax > 0, v_amax * (1.0 / 127.0), torch.ones_like(v_amax))
        chunk["v"] = quant_int8_fixed(v, vs, sub=vm)
        chunk["vs"], chunk["vm"] = vs, vm
    else:
        if plan.padded:
            vm, v_amax = vm_pad, va_pad
            vs = torch.where(v_amax > 0, v_amax * (1.0 / 448.0), torch.ones_like(v_amax))
            chunk["v"] = ((v.float() - vm) / vs).to(torch.float8_e4m3fn)
        else:
            v_fp8, vs3, vm = quant_ops.per_channel_fp8(v, "HND", smooth_v=True)
            chunk["v"], vs = v_fp8, vs3[:, :, None, :]
        chunk["vs"], chunk["vm"] = vs, vm
    return qpack, {key: x.contiguous() for key, x in chunk.items()}


def ring_kfac(chunk):
    """This shard's cap factor, to be maxed over the ring (static only)."""
    return chunk["knmax"] * chunk["ks_head"]


def ring_static_safe(qpack, chunk, g_kfac, plan: RingPlan):
    """Whether this rank may run every step with the static softmax, from
    the ring-wide worst cap factor ``g_kfac`` (a device bool).  Causal: the
    diagonal logit of the rank's own chunk anchors each row (``ring.py:
    167-185``); non-causal: the row cap ``q_capmax * g_kfac`` itself."""
    G = qpack["q"].shape[1] // chunk["k"].shape[1]
    gk = _repeat_heads(g_kfac, G)
    q8f = qpack["q"].float()
    if plan.is_causal:
        qn_row = torch.sqrt((q8f * q8f).sum(dim=3, keepdim=True))
        cap_row = qpack["scale"] * qn_row * gk * (1.0 + 1e-5)
        diag = (q8f * _repeat_heads(chunk["k"], G).float()).sum(dim=3, keepdim=True)
        diag = diag * qpack["scale"] * _repeat_heads(chunk["ks_head"], G)
        return (cap_row - diag <= 80.0).all()
    return (qpack["capmax"] * gk * (1.0 + 1e-5) <= 80.0).all()


def ring_schedule(plan: RingPlan, idx: int, device):
    """The device tensors of one call on rank ``idx``: ``offsets [n, 2]``
    (row ``step``: this rank's and the step's source shard's first
    positions) and ``kv_true [n]`` (row ``src``: shard ``src``'s real rows),
    built once so that no step copies a number to the card."""
    n, S = plan.n, plan.S
    offsets = torch.tensor([[idx * S, ((idx - step) % n) * S] for step in range(n)],
                           dtype=torch.int32, device=device)
    kv_true = torch.tensor([plan.real_rows(src) for src in range(n)], dtype=torch.int32,
                           device=device)
    return offsets, kv_true


def ring_init(qpack):
    """The merge state before the first step: zero output, lse -inf."""
    B, Hq, S, D = qpack["q"].shape
    dev = qpack["q"].device
    return (torch.zeros((B, Hq, S, D), dtype=torch.float32, device=dev),
            torch.full((B, Hq, S), float("-inf"), dtype=torch.float32, device=dev))


def ring_step(state, qpack, chunk, plan: RingPlan, *, static_safe: bool, offsets, kv_true):
    """One step of the ring on this rank: attention of its Q over the chunk
    that arrived (B10 when causal or padded, with that step's device
    ``offsets`` row and the chunk's device ``kv_true``), the chunk's V mean
    added, merged into ``state = (o, lse)``."""
    G = qpack["q"].shape[1] // chunk["k"].shape[1]
    mode = "online" if plan.static_mode and not static_safe else plan.softmax_mode
    if plan.fold_k:
        # the chunk's per-head K scale folds into the per-row Q scales
        q_scale = qpack["scale"] * _repeat_heads(chunk["ks_head"], G)
    else:
        q_scale = qpack["scale"]
    cfg = AttnConfig(
        causal=plan.is_causal, causal_dynamic=plan.is_causal, quantized=True,
        fold_k_scale=plan.fold_k, compute_dtype=plan.compute_dtype, pv_dtype=plan.pv_dtype,
        layout="HND", kv_len=plan.S, softmax_mode=mode, sm_scale=plan.sm_scale,
        fp8_native_dot=dispatch.detect(qpack["q"].device).has_fast_fp8,
        # both softmax branches keep P bf16, as core._sage_attention does
        pv_via_bf16=(mode == "online" and plan.static_mode),
        kv_len_dynamic=plan.padded, out_dtype=torch.bfloat16)
    o_p, lse_b2 = attention_call(
        qpack["q"], chunk["k"], chunk["v"], q_scale=q_scale, k_scale=chunk.get("ks"),
        v_scale=chunk.get("vs"), offsets=offsets if plan.is_causal else None,
        kn_max=_repeat_heads(chunk["knmax"], G) if mode == "static" else None,
        kv_true_dyn=kv_true if plan.padded else None, cfg=cfg)
    o_p = o_p.float()
    if "vm" in chunk:
        # each chunk has its own V mean: the repair precedes the merge
        o_p = o_p + _repeat_heads(chunk["vm"], G)
    return _merge(*state, o_p, lse_b2 / LOG2E)


def ring_finish(state, q, km, plan: RingPlan, return_lse: bool):
    """The merged output in Q's dtype and, with ``return_lse``, the lse with
    the smooth_k repair from the global K mean (natural log)."""
    o_acc, lse_acc = state
    if not return_lse:
        return o_acc.to(q.dtype)
    G = q.shape[1] // km.shape[1]
    with _no_tf32():
        corr = torch.matmul(q.float(), _repeat_heads(km, G).transpose(-1, -2))[..., 0]
    return o_acc.to(q.dtype), lse_acc + corr * plan.sm_scale


def ring_bwd_pair(chunk, kb, vb, src: int, idx: int, plan: RingPlan, quantized: bool):
    """dQ, dK, dV of the q-side chunk from shard ``src`` against this rank's
    K/V (shard ``idx``), or None when causal masking hides it (``src <
    idx``): the whole pair when ``src > idx``, the aligned causal pair when
    ``src == idx``.  C1/C2 take the chunk's precomputed ``di`` and write
    f32."""
    if plan.is_causal and src < idx:
        return None
    return backward_ops.attention_backward(
        chunk["q"], kb, vb, None, chunk["lse"], chunk["do"], di=chunk["di"],
        sm_scale=plan.sm_scale, is_causal=plan.is_causal and src == idx,
        quantized=quantized, out_dtype=torch.float32)


# ------------------------------------------------- collectives ----

def _check_group(group, device):
    """A CUDA tensor needs an NCCL group, a CPU tensor a gloo group."""
    backend = str(dist.get_backend(group))
    need = "nccl" if device.type == "cuda" else "gloo"
    if need not in backend:
        raise ValueError(f"tensors on {device} need a {need} process group; this group's "
                         f"backend is {backend!r}")


def _rotate(tensors: dict, group, n: int, idx: int):
    """Post the sends of ``tensors`` to the next rank and the receives from
    the previous one; returns ``(requests, received)``.  Payloads travel as
    bytes (e4m3 included)."""
    to = dist.get_global_rank(group, (idx + 1) % n)
    frm = dist.get_global_rank(group, (idx - 1) % n)
    recv = {key: torch.empty_like(x) for key, x in tensors.items()}
    ops = []
    for key in sorted(tensors):
        ops.append(dist.P2POp(dist.isend, tensors[key].view(torch.uint8), to, group))
        ops.append(dist.P2POp(dist.irecv, recv[key].view(torch.uint8), frm, group))
    return dist.batch_isend_irecv(ops), recv


def _wait(reqs):
    for r in reqs:
        r.wait()


def _gather_seq(x, group, n: int):
    """All-gather the shards ``x [B, H, S, ...]`` of the group along the
    sequence axis (rank order)."""
    xs = x.movedim(2, 0).contiguous()
    out = torch.empty((n * xs.shape[0],) + tuple(xs.shape[1:]), dtype=xs.dtype,
                      device=xs.device)
    dist.all_gather_into_tensor(out, xs, group=group)
    return out.movedim(0, 2)


def _ring_body(q, k, v, plan: RingPlan, group, idx: int, return_lse: bool):
    """Forward on this rank's shard ``q [B,Hq,S,D]``, ``k``/``v [B,Hk,S,D]``."""
    n = plan.n
    stat = ring_k_stat(k, plan, idx)
    dist.all_reduce(stat, op=dist.ReduceOp.SUM, group=group)
    km = ring_k_mean(stat, plan)
    qpack, chunk = ring_prep(q, k, v, km, plan, idx)
    safe = False
    if plan.static_mode:
        g_kfac = ring_kfac(chunk).contiguous()
        dist.all_reduce(g_kfac, op=dist.ReduceOp.MAX, group=group)
        safe = bool(ring_static_safe(qpack, chunk, g_kfac, plan))   # the call's one host read
    offsets, kv_true = ring_schedule(plan, idx, q.device)
    state = ring_init(qpack)
    for step in range(n):
        if step != n - 1:
            # posted first: the transfer overlaps this step's attention
            reqs, nxt = _rotate(chunk, group, n, idx)
        src = (idx - step) % n
        state = ring_step(state, qpack, chunk, plan, static_safe=safe,
                          offsets=offsets[step], kv_true=kv_true[src])
        if step != n - 1:
            _wait(reqs)
            chunk = nxt
    return ring_finish(state, q, km, plan, return_lse)


def _ring_bwd_body(q, k, v, o, lse, do, plan: RingPlan, group, idx: int, quantized: bool):
    """Context-parallel backward on this rank (``ring.py:330-400``): the
    q-side (q, dO, lse, di) rotates while K/V stay home; dK/dV accumulate in
    f32 here, and dQ hops with its chunk on every step, the last included,
    so it lands home.  The chunk's transfer is posted before the step's
    pair and waited for before the dQ hop is posted, so one batch of
    point-to-point ops is in flight at a time; one rank has no hop."""
    n = plan.n
    di = (do.float() * o.float()).sum(dim=-1)
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    chunk = {"q": q.to(torch.bfloat16).contiguous(), "do": do.to(torch.bfloat16).contiguous(),
             "lse": lse.float().contiguous(), "di": di}
    for step in range(n):
        if step != n - 1:
            reqs, nxt = _rotate(chunk, group, n, idx)
        pair = ring_bwd_pair(chunk, kb, vb, (idx - step) % n, idx, plan, quantized)
        if pair is not None:
            dq += pair[0]
            dk += pair[1]
            dv += pair[2]
        if step != n - 1:
            _wait(reqs)
            chunk = nxt
        if n > 1:
            hop, got = _rotate({"dq": dq}, group, n, idx)
            _wait(hop)
            dq = got["dq"]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingFn(torch.autograd.Function):
    """``differentiable=True`` (JAX's ``custom_vjp``): the forward saves
    this rank's (q, k, v, o, lse) shards, the backward runs
    ``_ring_bwd_body`` and all-gathers the gradients, since every rank
    holds the global inputs."""

    @staticmethod
    def forward(ctx, q, k, v, plan, group, idx, quant_bwd):
        sh = slice(idx * plan.S, (idx + 1) * plan.S)
        ql, kl, vl = (x[:, :, sh] for x in (q, k, v))
        o, lse = _ring_body(ql, kl, vl, plan, group, idx, return_lse=True)
        ctx.save_for_backward(ql, kl, vl, o, lse)
        ctx.plan, ctx.group, ctx.idx, ctx.quant_bwd = plan, group, idx, quant_bwd
        return _gather_seq(o, group, plan.n)

    @staticmethod
    def backward(ctx, do):
        plan, idx = ctx.plan, ctx.idx
        dol = do[:, :, idx * plan.S:(idx + 1) * plan.S]
        grads = _ring_bwd_body(*ctx.saved_tensors, dol, plan, ctx.group, idx, ctx.quant_bwd)
        return tuple(_gather_seq(g, ctx.group, plan.n) for g in grads) + (None,) * 4


def ring_sageattn(
    q, k, v,
    mesh,
    axis_name: str = SP,
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    qk_quant_gran: str = "per_thread",
    pv_dtype: Optional[str] = None,
    compute_dtype: Optional[str] = None,
    softmax_mode: str = "auto",
    return_lse: bool = False,
    block_q: int = 0,
    block_k: int = 0,
    differentiable: bool = False,
    quant_backward: Optional[bool] = None,
):
    """Sequence-parallel quantized attention over the ``axis_name``
    dimension of ``mesh`` (a ``DeviceMesh``, :func:`..mesh.make_mesh`).

    ``q``: global HND [B, Hq, S, D]; ``k``/``v``: [B, Hk, S, D] with
    Hq % Hk == 0 (GQA), the same on every rank of the group.  Each rank
    takes its block-aligned shard (the sequence is padded to ``n`` of them:
    pad rows are kept out of every statistic and masked as columns),
    computes its rows, and the output rows are all-gathered, so every rank
    returns the global output (and with ``return_lse`` the natural-log lse
    [B, Hq, S]).  ``softmax_mode="auto"``: static unless pv is fp8.

    ``differentiable=True`` attaches the context-parallel backward (the
    straight-through flash backward from the saved (q, k, v, o, lse), as
    single-device ``sageattn``); it needs S to divide into ``n``
    block-aligned shards and no ``return_lse``.  ``quant_backward`` as in
    ``sageattn`` (None: the int8 backward for non-causal calls)."""
    group = mesh.get_group(axis_name)
    n = mesh[axis_name].size()
    idx = mesh.get_local_rank(axis_name)
    _check_group(group, q.device)
    S_true, D_og = q.shape[2], q.shape[3]
    plan, q, k, v = ring_setup(
        q, k, v, n, is_causal=is_causal, sm_scale=sm_scale, qk_quant_gran=qk_quant_gran,
        pv_dtype=pv_dtype, compute_dtype=compute_dtype, softmax_mode=softmax_mode,
        block_q=block_q, block_k=block_k)
    if differentiable:
        if return_lse:
            raise ValueError(
                "differentiable ring attention does not return lse; take "
                "gradients through the plain output")
        if plan.padded:
            raise ValueError(
                f"differentiable ring attention requires the global "
                f"sequence length ({S_true}) to divide evenly into "
                f"block-aligned shards ({n} x {plan.S}); pad the inputs "
                f"or use ulysses_sageattn")
        quant_bwd = core._resolve_quant_bwd(quant_backward, is_causal)
        return _RingFn.apply(q, k, v, plan, group, idx, quant_bwd)[..., :D_og]
    core._no_grad_inputs(q, k, v)
    sh = slice(idx * plan.S, (idx + 1) * plan.S)
    res = _ring_body(q[:, :, sh], k[:, :, sh], v[:, :, sh], plan, group, idx, return_lse)
    if return_lse:
        out, lse = res
        out = _gather_seq(out, group, n)[:, :, :S_true, :D_og]
        return out, _gather_seq(lse, group, n)[:, :, :S_true]
    return _gather_seq(res, group, n)[:, :, :S_true, :D_og]
