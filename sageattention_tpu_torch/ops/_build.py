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
SOURCES = ("prep_kv", "prep_sm90", "quant", "attention", "attention_q8", "attention_ext",
           "attention_q8_ext", "attention_ring", "flash_sm90", "attention_sm90",
           "attention_q8_sm90", "attention_online_sm90", "decode", "decode_sm90",
           "paged_decode_sm90", "backward", "backward_sm90", "backward_q8_sm90")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

# (modes, dtypes, D), (q, k, v, o), 12 strides, 8 scale/stat pointers,
# (B, Hq, Hk, Sq, Sk, kv_len, causal), fold, stream
_ATTN_ARGS = [_I] * 6 + [_P] * 4 + [_LL] * 12 + [_P] * 8 + [_I] * 7 + [_F, _P]
# the ring's build (B10) adds the device offsets and true length
_ATTN_RING_ARGS = _ATTN_ARGS[:-1] + [_P, _P, _P]
# the B7-B9 builds add: mask, bias, 3 mask strides, Hm, liveness, q/kv segment
# ids, kv_segpos, the q/kv tiles' segment-id ranges, sink tiles, per-row K
# scales, window, sinks
_ATTN_EXT_ARGS = _ATTN_ARGS[:-1] + [_P, _P] + [_LL] * 3 + [_I] + [_P] * 8 + [_I, _I, _P]

# the masked forms' arguments of flash_sm90.cu and attention_sm90.cu: (tile
# lists, their lengths), (row length, per batch, per head, block rows),
# (mask, 3 mask strides, per head)
_TILE_ARGS = [_P, _P, _I, _I, _I, _I, _P, _LL, _LL, _LL, _I]

# (D, kv tile, mode), (q, k, v, o), 12 strides, (bias, 3 bias strides, Hm),
# lse, (B, Hq, Hk, Sq, Sk, kv_len, causal), fold, the tile lists and mask,
# (window, sinks), stream
_FLASH_ARGS = ([_I] * 3 + [_P] * 4 + [_LL] * 12 + [_P] + [_LL] * 3 + [_I] + [_P] + [_I] * 7
               + [_F] + _TILE_ARGS + [_I] * 2 + [_P])

# D, (q, k, v, o), 12 strides, (k_head_scale, kn_max, v_scale, v_mean, lse,
# lmin), (B, Hq, Hk, Sq, Sk, kv_len, causal), fold, (k_scale, 2 strides,
# columns), the tile lists and mask, (q/kv segment ids, kv_segpos), (window,
# sinks), stream
_ATTN_SM90_ARGS = ([_I] + [_P] * 4 + [_LL] * 12 + [_P] * 6 + [_I] * 7 + [_F] + [_P, _LL, _LL, _I]
                   + _TILE_ARGS + [_P] * 3 + [_I] * 2 + [_P])

# (D, mode), (q, k, v, o), 12 strides, q_scale, (k_scale, 2 strides,
# columns), (kn_max, v_scale, v_mean, lse, offsets, kv_true), (B, Hq, Hk,
# Sq, Sk, kv_len, causal, out_f16), stream
_ATTN_Q8_SM90_ARGS = ([_I] * 2 + [_P] * 4 + [_LL] * 12 + [_P] * 2 + [_LL] * 2 + [_I] + [_P] * 6
                      + [_I] * 8 + [_P])

# (D, mode), (q, k, v, o), 12 strides, (k_head_scale, v_scale, v_mean,
# lse), (B, Hq, Hk, Sq, Sk, kv_len, causal), fold, stream
_ATTN_ONLINE_SM90_ARGS = [_I] * 2 + [_P] * 4 + [_LL] * 12 + [_P] * 4 + [_I] * 7 + [_F, _P]

# (paged, vkind, D), (q, k, v, ks), 8 strides, (lens, offsets, table, lpage,
# win_lo), 16 shape/mode ints, fold, (v_scale, v_mean), vs_sb, vs_mul, (pm,
# pl, pacc, out), out_f32, lse, lse_mode, lse_off, stream
_DECODE_ARGS = ([_I] * 3 + [_P] * 4 + [_LL] * 8 + [_P] * 5 + [_I] * 16 + [_F] + [_P, _P, _LL, _F]
                + [_P] * 4 + [_I, _P, _I, _F, _P])

# (D, hpb, q_f32), (q, k, v, ks), 8 strides, (kv_true, offsets), (B, Hg, Hk,
# R, S, n_units, n_split, row_mod), fold, (v_scale, vs_sb, v_mean, vm_sb),
# (pm, pl, pacc, out, lse), stream
_DECODE_SM90_ARGS = ([_I] * 3 + [_P] * 4 + [_LL] * 8 + [_P] * 2 + [_I] * 8 + [_F]
                     + [_P, _LL, _P, _LL] + [_P] * 5 + [_P])

# (D, hpb), (q, k, v, ks), 8 strides, (lens, table, lpage, win_lo), (B, P,
# Hg, Hk, R, n_units, n_slots, page, window_T, sinks, sink_pages, n_split),
# (v_scale, v_mean, pm, pl, pacc, out, lse), stream
_PAGED_SM90_ARGS = [_I] * 2 + [_P] * 4 + [_LL] * 8 + [_P] * 4 + [_I] * 12 + [_P] * 7 + [_P]

# (which, quant, D), (q, k, v, dO, lse2, di, qs, ks, mask), 3 mask strides, Hm,
# liveness, (dk, dv, dq), (out_f32, B, Hq, Hk, Sqp, Skp, causal, window,
# sinks), (fold, dk_fin, dq_fin), stream
_BWD_ARGS = [_I] * 3 + [_P] * 9 + [_LL] * 3 + [_I] + [_P] * 4 + [_I] * 9 + [_F] * 3 + [_P]

# (which, D), (q, k, v, dO, lse2, di), (dk, dv, dq), (out_f32, B, Hq, Hk, Sqp,
# Skp, causal), (fold, dk_fin, dq_fin), stream
_BWD_SM90_ARGS = [_I] * 2 + [_P] * 9 + [_I] * 7 + [_F] * 3 + [_P]

# sage_bwd_sm90's arguments, then (tile lists, their lengths), (row length,
# per batch, per head), the blocks' order, (mask, 3 mask strides, per head),
# (window, sinks), stream
_BWD_SM90_MASKED_ARGS = (_BWD_SM90_ARGS[:-1] + [_P, _P, _I, _I, _I, _P, _P, _LL, _LL, _LL, _I]
                         + [_I] * 2 + [_P])

# (which, D), (q8, qd, k8, kd, v, dO, lse2, di, qs, ks), (dk, dv, dq), (out_f32,
# B, Hq, Hk, Sqp, Skp, causal), (fold, dk_fin, dq_fin), stream
_BWD_Q8_SM90_ARGS = [_I] * 2 + [_P] * 13 + [_I] * 7 + [_F] * 3 + [_P]

# C signatures: name -> (library, argtypes)
SIGNATURES = {
    "sage_prep_kv": ("prep_kv", [_I, _I, _I, _P, _LL, _LL, _LL, _I, _I, _I, _I, _I, _F,
                                 _P, _P, _P, _P, _P, _P, _P, _P]),
    # (per_channel, capmax, dtype), x, 3 strides, (B, H, S, s_true, D), inv_s,
    # grid, (part, ws, out, mean, amax, cap), stream
    "sage_prep_sm90": ("prep_sm90", [_I] * 3 + [_P] + [_LL] * 3 + [_I] * 5 + [_F, _I]
                       + [_P] * 7),
    "sage_stats2": ("prep_kv", [_I, _P, _LL, _LL, _LL, _P, _LL, _LL, _LL, _I, _I, _I, _I, _F]
                    + [_P] * 6),
    "sage_quant_kv": ("prep_kv", [_I, _I, _P, _LL, _LL, _LL, _P, _LL, _LL, _LL] + [_I] * 5
                      + [_P] * 8),
    "sage_channel_stats": ("quant", [_I, _P, _LL, _LL, _LL, _I, _I, _I, _I, _F] + [_P] * 6),
    "sage_quant_int8": ("quant", [_I, _I, _I, _P, _LL, _LL, _LL] + [_I] * 6
                        + [_F, _I] + [_P] * 5 + [_I] + [_P] * 4 + [_I, _I, _P]),
    "sage_attn_fwd": ("attention", _ATTN_ARGS),
    "sage_attn_fwd_q8": ("attention_q8", _ATTN_ARGS),
    "sage_attn_fwd_ext": ("attention_ext", _ATTN_EXT_ARGS),
    "sage_attn_fwd_q8_ext": ("attention_q8_ext", _ATTN_EXT_ARGS),
    "sage_attn_fwd_ring": ("attention_ring", _ATTN_RING_ARGS),
    "sage_flash_fwd": ("flash_sm90", _FLASH_ARGS),
    "sage_attn_fwd_sm90": ("attention_sm90", _ATTN_SM90_ARGS),
    "sage_attn_fwd_q8_sm90": ("attention_q8_sm90", _ATTN_Q8_SM90_ARGS),
    "sage_attn_fwd_online_sm90": ("attention_online_sm90", _ATTN_ONLINE_SM90_ARGS),
    "sage_decode": ("decode", _DECODE_ARGS),
    "sage_decode_sm90": ("decode_sm90", _DECODE_SM90_ARGS),
    "sage_paged_decode_sm90": ("paged_decode_sm90", _PAGED_SM90_ARGS),
    "sage_attn_bwd": ("backward", _BWD_ARGS),
    "sage_bwd_sm90": ("backward_sm90", _BWD_SM90_ARGS),
    "sage_bwd_sm90_masked": ("backward_sm90", _BWD_SM90_MASKED_ARGS),
    "sage_bwd_q8_sm90": ("backward_q8_sm90", _BWD_Q8_SM90_ARGS),
}
ERROR_STRINGS = {"prep_kv": "sage_prep_error_string",
                 "prep_sm90": "sage_prep_sm90_error_string",
                 "quant": "sage_quant_error_string",
                 "attention": "sage_attn_error_string",
                 "attention_q8": "sage_attn_q8_error_string",
                 "attention_ext": "sage_attn_ext_error_string",
                 "attention_q8_ext": "sage_attn_q8_ext_error_string",
                 "attention_ring": "sage_attn_ring_error_string",
                 "flash_sm90": "sage_flash_error_string",
                 "attention_sm90": "sage_attn_sm90_error_string",
                 "attention_q8_sm90": "sage_attn_q8_sm90_error_string",
                 "attention_online_sm90": "sage_attn_online_sm90_error_string",
                 "decode": "sage_decode_error_string",
                 "decode_sm90": "sage_decode_sm90_error_string",
                 "paged_decode_sm90": "sage_paged_decode_sm90_error_string",
                 "backward": "sage_bwd_error_string",
                 "backward_sm90": "sage_bwd_sm90_error_string",
                 "backward_q8_sm90": "sage_bwd_q8_sm90_error_string"}

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
