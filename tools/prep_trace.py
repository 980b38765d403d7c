#!/usr/bin/env python3
"""Where a ``csrc/prep_sm90.cu`` launch (A1, A2) spends its time, work item
by work item, on one CUDA card:

    python3 tools/prep_trace.py

It builds an instrumented copy of the source into ``build/prep_trace/``, in
which thread 0 of a block stamps ``%globaltimer`` at each step of a work
item (one 256-row chunk of a slice): the chunk's copy issued, the copy
landed, the chunk's arrival counted, the slice finished (its last arrival
only), the quantization entered (before the wait on the slice's flag), the
slice's statistics read, the codes stored.  It runs A1 (with capmax) and A2
on ``chip_smoke.PREP_MAIN``'s K and V through the copy, checks that the
copy's outputs equal ``prep_kv.cu``'s, and prints one line a kernel and
shape: the launch's span and the medians over items, in microseconds, of

- ``load``: the copy, issued to landed;
- ``stats``: landed to arrived (the chunk's partial sums and the arrival);
- ``finish``: arrived to the flag raised (the slice's last arrival);
- ``to_quant``: the item's arrival (landing, for a chunk of padding rows) to
  its quantization, which is where a block with two buffers works on its
  next item;
- ``wait``: on the slice's flag and its statistics;
- ``quant``: the codes;
- ``hold``: copy issued to codes stored, the time the item holds a buffer.

The stamps cost a few percent of the launch: read the uninstrumented
kernel's time from ``chip_smoke.py`` phase 23 or ``tools/port_ab.py --rows
prep``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = 8   # stamps 0-6, then the block's index


def instrumented(src: str) -> str:
    """``prep_sm90.cu`` with the stamps (each edit asserts its anchor)."""
    def rep(old, new):
        nonlocal src
        if src.count(old) != 1:
            raise RuntimeError(f"prep_sm90.cu changed: anchor not found once:\n{old}")
        src = src.replace(old, new)

    def stamp(k):
        return f"g_trace[(long long)t * {FIELDS} + {k}] = gtime();"

    rep("namespace {\n", """namespace {
__device__ unsigned long long* g_trace;
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
""")
    rep("    if (warp != 0) return;\n",
        f"    if (warp != 0) return;\n    if (lane == 0) {stamp(0)}\n")
    rep("    if (j >= p.ns) return;   // padding rows only\n",
        f"    if (tid == 0) {{ {stamp(1)} g_trace[(long long)t * {FIELDS} + 7] = blockIdx.x; }}\n"
        "    if (j >= p.ns) return;   // padding rows only\n")
    rep("    if (s_int[1] == 0) return;\n",
        f"    if (tid == 0) {stamp(2)}\n    if (s_int[1] == 0) return;\n")
    rep("      st_release(flag + 2 * s, gen);",
        f"      st_release(flag + 2 * s, gen);\n      {stamp(3)}")
    rep("    int next = 0;\n", f"    if (tid == 0) {stamp(5)}\n    int next = 0;\n")
    rep("    if (take && tid == 0) s_int[0] = next;\n",
        f"    if (tid == 0) {stamp(6)}\n    if (take && tid == 0) s_int[0] = next;\n")
    rep("    const int r0 = j * ROWS, rows = min(ROWS, p.S - r0);\n    if (tid == 0) {\n",
        f"    const int r0 = j * ROWS, rows = min(ROWS, p.S - r0);\n    if (tid == 0) {stamp(4)}\n"
        "    if (tid == 0) {\n")
    rep('extern "C" {\n', """extern "C" {
int sage_prep_sm90_set_trace(unsigned long long* p) {
  return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p));
}
""")
    return src


def summary(torch, trace):
    import numpy as np
    a = trace.view(-1, FIELDS).cpu().numpy().astype(np.int64)
    t0 = a[:, 0].min()
    st = a[:, :7]
    st[st > 0] -= t0
    stats_item = a[:, 2] > 0
    last = a[:, 3] > 0

    def med(x):
        return round(float(np.median(x)) / 1e3, 3) if len(x) else None

    arrived = np.where(stats_item, a[:, 2], a[:, 1])
    return {"span": round(float(a[:, 6].max()) / 1e3, 3), "items": int(a.shape[0]),
            "blocks": int(len(set(a[:, 7]))), "load": med(a[:, 1] - a[:, 0]),
            "stats": med((a[:, 2] - a[:, 1])[stats_item]),
            "finish": med((a[:, 3] - a[:, 2])[last]), "to_quant": med(a[:, 4] - arrived),
            "wait": med(a[:, 5] - a[:, 4]), "quant": med(a[:, 6] - a[:, 5]),
            "hold": med(a[:, 6] - a[:, 0])}


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    from sageattention_tpu_torch.ops import _build
    from sageattention_tpu_torch.ops import quant_fused as qf
    if not torch.cuda.is_available():
        print("prep_trace: no CUDA device", file=sys.stderr)
        return 2
    out_dir = os.path.join(ROOT, "build", "prep_trace")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, "prep_trace.cu"), os.path.join(out_dir, "prep_trace.so")
    with open(_build.CSRC / "prep_sm90.cu") as f:
        text = instrumented(f.read())
    with open(cu, "w") as f:
        f.write(text)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", so, cu],
                   check=True, capture_output=True)
    _build.build_all()
    lib = ctypes.CDLL(so)
    lib.sage_prep_sm90.argtypes = _build.SIGNATURES["sage_prep_sm90"][1]
    lib.sage_prep_sm90.restype = ctypes.c_int
    lib.sage_prep_sm90_set_trace.argtypes = [ctypes.c_void_p]
    real, held = _build.call, {}

    def traced(fn, dev, *args):
        if fn != "sage_prep_sm90":
            return real(fn, dev, *args)
        B, H, S = args[7:10]
        held["trace"] = torch.zeros(B * H * -(-S // 256) * FIELDS, dtype=torch.int64, device=dev)
        if lib.sage_prep_sm90_set_trace(held["trace"].data_ptr()) != 0:
            raise RuntimeError("could not set the trace buffer")
        rc = lib.sage_prep_sm90(*args, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the instrumented sage_prep_sm90 failed to launch (code {rc})")

    print(torch.cuda.get_device_name(0), flush=True)
    with torch.inference_mode():
        for label, (B, Hq, Hk, S, D, _) in cs.PREP_MAIN.items():
            _, k, v = cs.realistic_qkv(torch, B, Hq, Hk, S, D, cs.SEED)
            for name, x, per_channel, capmax in (("A1", k, False, True), ("A2", v, True, False)):
                ref = qf._launch(x, S, per_channel, capmax)
                _build.call = traced
                try:
                    for _ in range(3):   # the last launch's stamps are kept
                        got = qf._prep(x, S, per_channel, capmax)
                    torch.cuda.synchronize()
                finally:
                    _build.call = real
                same = all(torch.equal(a, b) for a, b in zip(got, ref) if a is not None)
                print("TRACE", label, name, json.dumps(dict(summary(torch, held["trace"]),
                                                            equal_to_prep_kv=same)), flush=True)
            del k, v
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
