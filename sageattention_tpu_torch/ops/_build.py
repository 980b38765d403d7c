"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``.  The
libraries land in ``build/torch_kernels/`` at the root of the checkout, named
by a hash of the sources and flags, so an edited source is rebuilt and a
built one is reused; ``build_log`` keeps ``ptxas``'s report of each
kernel's registers, shared memory and spills.  Nothing is built at import time: the first wrapper
that launches a kernel builds all sources at once, one ``nvcc`` process per
source, started together.

No ``--use_fast_math``: the int8 codes must match the plain versions, and
fast math turns ``1.0f/x`` and ``exp2f`` into approximations and flushes
denormals.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("prep_kv", "quant", "attention", "attention_q8", "attention_ext", "attention_q8_ext")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

# (modes, dtypes, D), (q, k, v, o), 12 strides, 8 scale/stat pointers,
# (B, Hq, Hk, Sq, Sk, kv_len, causal), fold, stream
_ATTN_ARGS = [_I] * 6 + [_P] * 4 + [_LL] * 12 + [_P] * 8 + [_I] * 7 + [_F, _P]
# the B7-B9 builds add: mask, bias, 3 mask strides, Hm, liveness, q/kv segment
# ids, kv_segpos, the q/kv tiles' segment-id ranges, sink tiles, per-row K
# scales, window, sinks
_ATTN_EXT_ARGS = _ATTN_ARGS[:-1] + [_P, _P] + [_LL] * 3 + [_I] + [_P] * 8 + [_I, _I, _P]

# C signatures: name -> (library, argtypes)
SIGNATURES = {
    "sage_prep_kv": ("prep_kv", [_I, _I, _I, _P, _LL, _LL, _LL, _I, _I, _I, _I, _I, _F,
                                 _P, _P, _P, _P, _P, _P, _P, _P]),
    "sage_channel_stats": ("quant", [_I, _P, _LL, _LL, _LL, _I, _I, _I, _I, _F] + [_P] * 6),
    "sage_quant_int8": ("quant", [_I, _I, _I, _P, _LL, _LL, _LL] + [_I] * 6
                        + [_F, _I] + [_P] * 5 + [_I] + [_P] * 4 + [_I, _I, _P]),
    "sage_attn_fwd": ("attention", _ATTN_ARGS),
    "sage_attn_fwd_q8": ("attention_q8", _ATTN_ARGS),
    "sage_attn_fwd_ext": ("attention_ext", _ATTN_EXT_ARGS),
    "sage_attn_fwd_q8_ext": ("attention_q8_ext", _ATTN_EXT_ARGS),
}
ERROR_STRINGS = {"prep_kv": "sage_prep_error_string",
                 "quant": "sage_quant_error_string",
                 "attention": "sage_attn_error_string",
                 "attention_q8": "sage_attn_q8_error_string",
                 "attention_ext": "sage_attn_ext_error_string",
                 "attention_q8_ext": "sage_attn_q8_ext_error_string"}

_lock = threading.Lock()
_libs: dict = {}
build_log: dict = {}   # source -> nvcc's stderr (register/spill report)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                           "machine with the card, from the CUDA toolkit")
    return path


def _lib_path(name: str, flags) -> Path:
    h = hashlib.sha1()
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source that has no current library, all in parallel,
    and load them.  Returns the loaded libraries by source name."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in SOURCES:
            out = _lib_path(name, NVCC_FLAGS)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True),
                           tmp, out)
        errors = []
        for name, (proc, tmp, out) in procs.items():
            _, err = proc.communicate()
            build_log[name] = err
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{err}")
                continue
            os.replace(tmp, out)   # atomic: a concurrent build sees all or none
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in SOURCES:
            lib = ctypes.CDLL(str(_lib_path(name, NVCC_FLAGS)))
            for fn, (owner, argtypes) in SIGNATURES.items():
                if owner == name:
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            err_fn = getattr(lib, ERROR_STRINGS[name])
            err_fn.argtypes = [ctypes.c_int]
            err_fn.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs


def vector_aligned(x):
    """``x`` itself, or a contiguous copy where the kernels' 16-byte vector
    loads need one: unit stride along the last axis and a 16-byte aligned
    base and outer strides."""
    e = x.element_size()
    if (x.stride(-1) != 1 or x.data_ptr() % 16
            or any((st * e) % 16 for st in x.stride()[:-1])):
        return x.contiguous()
    return x


def call(fn: str, device, *args) -> None:
    """Launch C entry ``fn`` on the current stream of ``device`` (building
    on first use) and raise if the launch reported an error."""
    import torch

    owner = SIGNATURES[fn][0]
    lib = build_all()[owner]
    rc = getattr(lib, fn)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = getattr(lib, ERROR_STRINGS[owner])(rc).decode()
        raise RuntimeError(f"{fn} failed to launch: {msg} (code {rc})")
