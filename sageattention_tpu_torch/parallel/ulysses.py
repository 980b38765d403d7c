"""Ulysses sequence parallelism: all-to-all heads <-> sequence (counterpart
of ``sageattention_tpu/parallel/ulysses.py``).

Each rank trades its sequence shard of *all* heads for the full sequence of
*its* heads (``dist.all_to_all_single``), runs the single-device quantized
attention (``core._route``) on them, and trades back.  Attention itself
needs no collective.  A CUDA tensor needs an NCCL group and a CPU tensor a
gloo group.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from .. import core
from .. import dispatch
from .mesh import SP
from .ring import _check_group, _gather_seq


def _all_to_all(x, group):
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _scatter_heads(x, group, n: int):
    """[B, H, S/n, D] sequence shards -> [B, H/n, S, D]: heads to ranks."""
    B, H, Sl, D = x.shape
    parts = x.reshape(B, n, H // n, Sl, D).movedim(1, 0).contiguous()   # [n, B, H/n, Sl, D]
    got = _all_to_all(parts, group)                                      # by source rank
    return got.permute(1, 2, 0, 3, 4).reshape(B, H // n, n * Sl, D)


def _gather_heads(x, group, n: int):
    """[B, H/n, S, D] -> [B, H, S/n, D]: the inverse of :func:`_scatter_heads`."""
    B, Hl, S, D = x.shape
    parts = x.reshape(B, Hl, n, S // n, D).movedim(2, 0).contiguous()   # [n, B, Hl, S/n, D]
    got = _all_to_all(parts, group)
    return got.movedim(0, 1).reshape(B, n * Hl, S // n, D)


def _ulysses_body(q, k, v, *, group, idx, n, is_causal, sm_scale, qk_quant_gran, pv_dtype,
                  kv_true=0):
    """q/k/v local shards [B, H, S/n, D] (HND) -> output [B, Hq, S/n, D].

    GQA: when the KV heads don't divide by the degree, K/V are all-gathered
    along the sequence instead and each rank slices the KV head(s) its
    contiguous q-head chunk maps to."""
    Hq, Hk = q.shape[1], k.shape[1]
    qg = _scatter_heads(q, group, n)
    if Hk % n == 0:
        kg, vg = _scatter_heads(k, group, n), _scatter_heads(v, group, n)
    else:
        G = Hq // Hk
        hq_loc = Hq // n
        k_full, v_full = _gather_seq(k, group, n), _gather_seq(v, group, n)
        if hq_loc % G == 0:
            span = hq_loc // G
        elif G % hq_loc == 0:
            span = 1
        else:
            raise ValueError(f"ulysses GQA needs the per-device q-head chunk ({hq_loc}) "
                             f"and the group size ({G}) to divide one another")
        start = (idx * hq_loc) // G
        kg, vg = k_full[:, start:start + span], v_full[:, start:start + span]
    out = core._route(qg, kg, vg, tensor_layout="HND", is_causal=is_causal,
                      sm_scale=sm_scale, qk_quant_gran=qk_quant_gran, pv_dtype=pv_dtype,
                      kv_true=kv_true)
    return _gather_heads(out, group, n)


def ulysses_sageattn(
    q, k, v,
    mesh,
    axis_name: str = SP,
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    qk_quant_gran: str = "per_thread",
    pv_dtype: Optional[str] = None,
):
    """Sequence-parallel attention via head scatter / sequence gather.

    Global HND tensors, the same on every rank of the ``axis_name`` group:
    q [B, Hq, S, D], k/v [B, Hk, S, D] with Hq % Hk == 0 (GQA); returns
    the global output.  Awkward shapes are padded: ``S`` to a multiple of
    the degree (pad columns masked through ``kv_true``, pad rows sliced
    off), and when Hq doesn't divide by the degree, whole GQA groups of
    zero heads are appended (Hk -> Hk', Hq -> G*Hk') so the head->kv-head
    map of every real head is unchanged; the dummy heads are sliced off."""
    B, H, S, D = q.shape
    Hk = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    if pv_dtype is None:
        pv_dtype = dispatch.detect(q.device).default_pv_dtype
    group = mesh.get_group(axis_name)
    n = mesh[axis_name].size()
    idx = mesh.get_local_rank(axis_name)
    _check_group(group, q.device)
    core._no_grad_inputs(q, k, v)
    if H % Hk:
        raise ValueError(f"q heads {H} must be a multiple of kv heads {Hk}")
    G = H // Hk
    H_pad = H
    if H % n != 0:
        # smallest Hk' >= Hk with (G * Hk') % n == 0: step by whole groups
        step = n // math.gcd(G, n)
        Hk_pad = -(-Hk // step) * step
        H_pad = G * Hk_pad
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, H_pad - H))
        k, v = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, Hk_pad - Hk)) for x in (k, v))
    S_pad = -(-S // n) * n
    if S_pad != S:
        q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, S_pad - S)) for x in (q, k, v))
    Sl = S_pad // n
    sh = slice(idx * Sl, (idx + 1) * Sl)
    out = _ulysses_body(q[:, :, sh], k[:, :, sh], v[:, :, sh], group=group, idx=idx, n=n,
                        is_causal=is_causal, sm_scale=sm_scale, qk_quant_gran=qk_quant_gran,
                        pv_dtype=pv_dtype, kv_true=S if S_pad != S else 0)
    return _gather_seq(out, group, n)[:, :H, :S]
