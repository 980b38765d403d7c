"""Sequence-parallel DiT denoising over a process group, the counterpart of
the JAX package's ``examples/parallel_dit_infer.py`` (and of the
reference's xDiT runs with ``--ring_degree`` / ``--ulysses_degree``).

The ranks form a (dp, sp, tp) mesh (``parallel.make_mesh``): dp splits the
CFG batch, and the DiT's attention runs as ``ring_sageattn`` or
``ulysses_sageattn`` over sp.  It prints the time of one denoising run and
each step's share, and the output's calc_diff against the same DiT with
single-device ``sageattn``.

On the CPU (gloo), two ranks:
    torchrun --nproc_per_node 2 -m sageattention_tpu_torch.examples.parallel_dit_infer \\
        --tiny --device cpu --sp 2
On cards (NCCL), one rank per card; the default model is CogVideoX1.5's
width (hidden 3072, 48 heads, 13x60x90 latents, 226 text tokens) cut to
2 of its 42 blocks, with random weights from seed 0:
    torchrun --nproc_per_node 4 -m sageattention_tpu_torch.examples.parallel_dit_infer --sp 4
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from ..core import sageattn
from ..models.dit import DiTConfig, example_inputs, make_dit
from ..parallel import SP, DP, make_mesh, ring_sageattn, ulysses_sageattn
from ..utils.testing import calc_diff

SEED = 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dp", type=int, default=1, help="CFG/data parallel degree")
    ap.add_argument("--sp", type=int, default=None, help="sequence parallel degree")
    ap.add_argument("--tp", type=int, default=1, help="head parallel degree")
    ap.add_argument("--seq-parallel", choices=["ring", "ulysses"], default="ring")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--tiny", action="store_true",
                    help="the JAX example's model: hidden 256, 8 heads, 2 blocks")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def _config(args, sp: int) -> DiTConfig:
    if args.tiny:
        return DiTConfig(hidden=256, heads=8, depth=2, frames=4, height=32, width=32,
                         text_len=sp * 128, zero_init_gates=False)
    return DiTConfig(hidden=3072, heads=48, depth=2, patch=2, in_channels=16,
                     text_dim=4096, text_len=226, frames=13, height=60, width=90,
                     zero_init_gates=False)


def denoise(model, x, text, steps: int):
    """``steps`` Euler steps of the JAX example's schedule."""
    for i in range(steps):
        t = torch.full((x.shape[0],), 1000 - i * (1000 // steps), dtype=torch.int32,
                       device=x.device)
        x = x - (1.0 / steps) * model(x, text, t).to(x.dtype)
    return x


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Run the example; uses the process group that is initialised, or
    initialises one from torchrun's environment.  Returns what it prints."""
    args = parse_args(argv)
    own_group = not dist.is_initialized()
    if own_group:
        dist.init_process_group("gloo" if args.device == "cpu" else "nccl")
    try:
        if args.device == "cuda":
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
            torch.cuda.set_device(local)
            device = torch.device("cuda", local)
        else:
            device = torch.device("cpu")
        mesh = make_mesh(dp=args.dp, sp=args.sp, tp=args.tp, device_type=device.type)
        sp = mesh[SP].size()
        cfg = _config(args, sp)
        seq_fn = ring_sageattn if args.seq_parallel == "ring" else ulysses_sageattn

        def attn(q, k, v, *a, **kw):   # NHD in and out, as the DiT calls it
            out = seq_fn(*(x.transpose(1, 2) for x in (q, k, v)), mesh, axis_name=SP)
            return out.transpose(1, 2)

        def single(q, k, v, *a, **kw):
            return sageattn(q, k, v, tensor_layout="NHD")

        g = torch.Generator(device=device).manual_seed(SEED + 1)
        batch = 2 * args.dp   # CFG pairs
        latents, text, _ = example_inputs(cfg, batch=batch, generator=g, device=device)
        per = batch // args.dp
        rows = slice(mesh.get_local_rank(DP) * per, (mesh.get_local_rank(DP) + 1) * per)
        latents, text = latents[rows], text[rows]
        with torch.no_grad():
            model = make_dit(cfg, attn_fn=attn, device=device).init_weights(SEED)
            out = denoise(model, latents, text, args.steps)   # warm-up (and kernel builds)
            _sync(device)
            t0 = time.perf_counter()
            out = denoise(model, latents, text, args.steps)
            _sync(device)
            ms = (time.perf_counter() - t0) * 1e3
            for block in model.blocks:
                block.attn_fn = single
            ref = denoise(model, latents, text, args.steps)
        res = {"seq_parallel": args.seq_parallel, "mesh": tuple(mesh.mesh.shape),
               "ms": ms, "ms_per_step": ms / args.steps, "calc_diff": calc_diff(out, ref),
               "shape": tuple(out.shape), "finite": bool(torch.isfinite(out).all())}
        if dist.get_rank() == 0:
            print(f"{args.seq_parallel} over mesh dp={args.dp} sp={sp} tp={args.tp} "
                  f"({dist.get_world_size()} ranks, {device.type}): {ms:.1f} ms per denoise "
                  f"({ms / args.steps:.1f} ms per step), out {tuple(out.shape)}; "
                  f"calc_diff vs single-device sageattn {res['calc_diff']:.3e}", flush=True)
        return res
    finally:
        if own_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
