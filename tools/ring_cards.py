#!/usr/bin/env python3
"""The differentiable ring over one rank per card, through NCCL.

    torchrun --nproc_per_node 4 tools/ring_cards.py

Every rank makes the same inputs from fixed seeds at Llama-3-8B width (one
sequence of 32,768 tokens, 32 query and 8 KV heads of 128, causal, bf16
PV), runs ``ring_sageattn(differentiable=True)`` over the ``sp`` axis of a
mesh of all ranks, and takes the gradients of ``<out, w>``: the forward's
rotation and the backward's ``_ring_bwd_body`` with its dQ hops, as users
run them.  Rank 0 holds the output and the gradients against the same ring
composed over virtual ranks in one process (``chip_smoke.virtual_ring`` and
``chip_smoke.ring_bwd_grads``: the per-rank phase functions, with the
collectives done by hand) at ``chip_smoke.KERNEL_BAR``, and, on standard
normal inputs, against single-device ``sageattn_qk_int8_pv_bf16``'s
gradients at ``chip_smoke.RING_GRAD_BAR`` (on activation-like inputs that
distance is printed: see ``chip_smoke.ring_bwd_phase``).  It prints the
cards' names and power limits and the host-clock ms of one forward and
backward of the ring beside the single-device call's, and exits non-zero
if a check fails.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
import sageattention_tpu_torch as st  # noqa: E402
from sageattention_tpu_torch.parallel import make_mesh, ring_sageattn  # noqa: E402
from sageattention_tpu_torch.utils.testing import calc_diff  # noqa: E402


def make_inputs(kind, B, H, Hk, S, D):
    if kind == "activation-like":
        return cs.realistic_qkv(torch, B, H, Hk, S, D, cs.SEED + 90)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 91)
    return [torch.randn(B, h, S, D, generator=g, device="cuda").to(torch.bfloat16)
            for h in (H, Hk, Hk)]


def fwd_bwd(entry, q, k, v, w, **kw):
    """``[out, dq, dk, dv]`` of ``entry`` with the output weights ``w``."""
    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    out = entry(*xs, is_causal=True, **kw)
    return [out.detach()] + list(torch.autograd.grad(out, xs, w))


def host_ms(fn):
    """Host-clock ms of one synchronized call, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def main() -> int:
    dist.init_process_group("nccl")
    rank, n = dist.get_rank(), dist.get_world_size()
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    failures = []

    def check(ok, what):
        print(("ok   " if ok else "FAIL ") + what, flush=True)
        if not ok:
            failures.append(what)

    try:
        if rank == 0:
            print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip(), flush=True)
        mesh = make_mesh(sp=n)
        B, H, Hk, S, D = cs.LLAMA_BWD
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 92)
        w = torch.randn(B, H, S, D, generator=g, device="cuda").to(torch.bfloat16)
        for kind in ("activation-like", "standard normal"):
            q, k, v = make_inputs(kind, B, H, Hk, S, D)

            def ring():
                return fwd_bwd(ring_sageattn, q, k, v, w, mesh=mesh, pv_dtype="bf16",
                               differentiable=True)

            got = ring()
            ring_ms = host_ms(ring)
            if rank == 0:
                name = (f"ring_sageattn(differentiable=True) over {n} cards, {kind} "
                        f"{(B, H, S, D)} Hk={Hk} causal")
                o, lse, _ = cs.virtual_ring(torch, q, k, v, n, return_lse=True, is_causal=True,
                                            pv_dtype="bf16")
                comp = [o] + cs.ring_bwd_grads(torch, q, k, v, w, n, o, lse)
                ds = [calc_diff(a, b) for a, b in zip(got, comp)]
                check(all(bool(torch.isfinite(x).all()) for x in got)
                      and max(ds) <= cs.KERNEL_BAR,
                      f"{name}: o/dq/dk/dv vs the ring over {n} virtual ranks, calc_diff "
                      + "/".join(f"{d:.3e}" for d in ds) + f" <= {cs.KERNEL_BAR}")

                def single():
                    return fwd_bwd(st.sageattn_qk_int8_pv_bf16, q, k, v, w)

                ref = single()
                ds = [calc_diff(a, b) for a, b in zip(got[1:], ref[1:])]
                text = (f"{name}: dq/dk/dv vs single-device sageattn_qk_int8_pv_bf16, calc_diff "
                        + "/".join(f"{d:.3e}" for d in ds))
                if kind == "standard normal":
                    check(max(ds) < cs.RING_GRAD_BAR, f"{text} < {cs.RING_GRAD_BAR}")
                else:
                    print(f"     {text} (reading)", flush=True)
                print(f"     {name}: forward and backward {ring_ms:.1f} ms (host clock, rank 0); "
                      f"single-device on one card {host_ms(single):.1f} ms", flush=True)
                del comp, ref, o, lse
            del got, q, k, v
            torch.cuda.empty_cache()
            dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print("ring_cards: " + ("FAILED: " + "; ".join(failures) if failures else "ok"),
              flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
