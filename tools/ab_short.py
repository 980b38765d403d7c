#!/usr/bin/env python3
"""Times two short kernels whose single parent / change readings in
``tools/port_ab.py`` spread by a few percent, in several checkouts
alternated over many pairs, each reading in a process of its own, on one
CUDA card:

    python3 tools/ab_short.py --pairs 6 [--rows bwd] build/parent .

For each pair it runs the trees in the given order, then (next pair) in the
reverse order, and prints one line ``SHORT <tree> <json>`` a reading:
``mpt B4-float`` (``flash_sm90.cu``'s biased form at MPT-7B's ALiBi shape,
(2, 32, 2048, 128) causal, and its library call), ``B11-int8`` (the dense
int8 decode of ``chip_smoke.py`` phase 8a: one sequence of 8,192 tokens at
Llama-3-8B width; device time from ``torch.profiler`` and the wrapper's
host time) and ``B11-int8-causal-mod T=4`` (its T = 4 verify window), as
``tools/port_ab.py`` times them, and the unmasked
B4 and B1 at ``tools/port_ab.py``'s Gemma-7B (head dim 256) and Llama-70B
GQA shapes (``gemma B4``, ``llama B1``, ...), the B11 rows, and last
``tools/port_ab.py``'s ``online_rows`` (the pre-quantized forms on
``attention_q8_sm90.cu`` and their ring's ``-kvtrue`` forms, B5-int8, B2,
B5-fp8-fusedq, the fused-Q B-pvbf16-online and the ``sageattn fp8`` call);
then, per tree and row, the median of its readings (``MEDIAN <tree>
<json>``).  ``--rows bwd`` takes ``tools/port_ab.py``'s C1/C2 rows
instead: the bf16 forms, masked and not, and the int8 ones
(``bwd_tree``); ``--rows prep`` its K/V prep rows (``prep_tree``, without
the ``sageattn`` calls).  Each tree
builds its own kernels into its own ``build/torch_kernels/``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

TOOLS = os.path.dirname(os.path.abspath(__file__))


def one_reading(tree: str, rows: str = "all") -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    import sageattention_tpu_torch as st
    from sageattention_tpu_torch.ops import _build
    from sageattention_tpu_torch.ops import attention as tatt
    from sageattention_tpu_torch.utils.testing import time_fn
    if not _build.__file__.startswith(tree):
        raise RuntimeError(f"imported {_build.__file__}, not the tree {tree}")
    spec = importlib.util.spec_from_file_location("port_ab", os.path.join(TOOLS, "port_ab.py"))
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    _build.build_all()
    if rows == "bwd":
        return ab.bwd_tree(tree)
    if rows == "prep":
        return ab.prep_tree(tree, calls=False)
    with torch.inference_mode():
        res = ab.biased_rows(torch, cs)
        for shape in ("gemma", "llama"):
            B, Hq, Hk, S, D, causal = ab.CASES[shape]
            q, k, v = cs.realistic_qkv(torch, B, Hq, Hk, S, D, 0)
            for name in ("B4", "B1"):
                cfg = cs.attn_cfg(torch, name, D, causal)
                xs, kw = ((q, k, v), {}) if name == "B4" else cs.kernel_args(torch, cfg, q, k, v)
                res[f"{shape} {name}"] = time_fn(lambda: tatt.attention_kernel(*xs, cfg, **kw),
                                                 warmup=3, reps=20) * 1e3
            del q, k, v
        torch.cuda.empty_cache()
        H, Hk, D = cs.SERVE["attn"]
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 45)
        k = torch.randn(1, Hk, 8192, D, generator=g, device="cuda").bfloat16()
        v = torch.randn(1, Hk, 8192, D, generator=g, device="cuda").bfloat16()
        cache = st.kv_cache_init(k, v, 8320, v_format="int8")
        for label, T in (("B11-int8", 1), ("B11-int8-causal-mod T=4", 4)):
            q = torch.randn(1, H, T, D, generator=g, device="cuda").bfloat16()
            res.update(ab.decode_rows(torch, cs, label, tatt, "decode_kernel",
                                      lambda: st.sageattn_decode(q, cache)))
        del k, v, cache
        torch.cuda.empty_cache()
        res.update(ab.online_rows(torch, cs, st))
    return res


def main(argv) -> int:
    row_set = "all"
    if "--rows" in argv:
        i = argv.index("--rows")
        row_set, argv = argv[i + 1], argv[:i] + argv[i + 2:]
    if len(argv) == 3 and argv[1] == "--one":
        print("SHORT", argv[2], json.dumps(one_reading(argv[2], row_set)), flush=True)
        return 0
    if len(argv) < 4 or argv[1] != "--pairs":
        print(__doc__, file=sys.stderr)
        return 2
    pairs, trees = int(argv[2]), argv[3:]
    readings = {t: [] for t in trees}
    for i in range(pairs):
        for tree in trees if i % 2 == 0 else trees[::-1]:
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--rows", row_set,
                                  "--one", tree], capture_output=True, text=True)
            if out.returncode != 0:
                print(out.stderr[-3000:], file=sys.stderr)
                return out.returncode
            line = next(ln for ln in out.stdout.splitlines() if ln.startswith("SHORT "))
            print(line, flush=True)
            readings[tree].append(json.loads(line.split(" ", 2)[2]))
    for tree, rows in readings.items():
        med = {k: sorted(r[k] for r in rows)[len(rows) // 2] for k in rows[0]
               if not isinstance(rows[0][k], dict)}   # a breakdown (``parts``) has no median
        print("MEDIAN", tree, json.dumps(med), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
