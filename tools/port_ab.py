#!/usr/bin/env python3
"""Times the port's plain attention configurations and its ``sageattn``
entry in several checkouts, each in a process of its own, on one CUDA card.

    python3 tools/port_ab.py build/parent . . build/parent

Give the trees in the order parent, change, change, parent within one run
(a card's clocks and power drift between runs).  Each tree builds its own
kernels into its own ``build/torch_kernels/``.  For each tree, at the
CogVideoX1.5 (1, 48, 17776, 64) and Llama-70B GQA causal (1, 64/8, 16384,
128) shapes, it prints one line ``AB <tree> <json>`` with:

- the kernel time (ms) of B1, B2, B4, B5-fp8-fusedq, B6-static and
  B-pvbf16 on the inputs the port's quantizers give them;
- ``sageattn``'s time per call, back to back as a caller makes them;
- where one ``sageattn`` call spends its time: the device time of each
  kernel it launches (CUDA events around each launch), the rest of the
  call (PyTorch glue kernels, the host read of the static check and the
  host's dispatch while the card waits), and the host time from the call's
  start to its first kernel launch.

The tree's ``chip_smoke.py`` provides the inputs and configurations.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

CASES = {"cog": (1, 48, 48, 17776, 64, False), "llama": (1, 64, 8, 16384, 128, True)}
KERNELS = ("B1", "B2", "B4", "B5-fp8-fusedq", "B6-static", "B-pvbf16")


def one_tree(tree: str) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    import sageattention_tpu_torch as st
    from sageattention_tpu_torch.ops import _build
    from sageattention_tpu_torch.ops.attention import attention_kernel
    from sageattention_tpu_torch.utils.testing import time_fn
    if not _build.__file__.startswith(tree):
        raise RuntimeError(f"imported {_build.__file__}, not the tree {tree}")
    _build.build_all()
    res = {}
    with torch.inference_mode():
        for shape, (B, Hq, Hk, S, D, causal) in CASES.items():
            q, k, v = cs.realistic_qkv(torch, B, Hq, Hk, S, D, 0)
            for name in KERNELS:
                cfg = cs.attn_cfg(torch, name, D, causal)
                xs, kw = ((q, k, v), {}) if name == "B4" else cs.kernel_args(torch, cfg, q, k, v)
                res[f"{shape} {name}"] = time_fn(lambda: attention_kernel(*xs, cfg, **kw),
                                                 warmup=3, reps=20) * 1e3
            call = lambda: st.sageattn(q, k, v, is_causal=causal)  # noqa: E731
            res[f"{shape} sageattn"] = time_fn(call, warmup=2, reps=10) * 1e3
            res[f"{shape} sageattn parts"] = call_parts(torch, _build, call)
    return res


def call_parts(torch, _build, call, reps=10):
    """Median over ``reps`` calls of where one call's time goes (ms)."""
    real = _build.call
    spans, launches = [], []

    def timed(fn, device, *args):
        launches.append((fn, time.perf_counter()))
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        real(fn, device, *args)
        e.record()
        spans.append((fn, s, e))

    _build.call = timed
    rows = []
    try:
        call()
        for _ in range(reps):
            spans, launches = [], []
            torch.cuda.synchronize()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            s.record()
            call()
            e.record()
            torch.cuda.synchronize()
            row = {"total": s.elapsed_time(e), "host_to_first_launch": (launches[0][1] - t0) * 1e3}
            for fn, a, b in spans:
                row[fn] = row.get(fn, 0.0) + a.elapsed_time(b)
            row["rest"] = row["total"] - sum(a.elapsed_time(b) for _, a, b in spans)
            rows.append(row)
    finally:
        _build.call = real
    return {key: sorted(r[key] for r in rows)[len(rows) // 2] for key in rows[0]}


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        print("AB", argv[2], json.dumps(one_tree(argv[2])), flush=True)
        return 0
    rc = 0
    for tree in argv[1:]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
