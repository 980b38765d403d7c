"""K/V prep of the flagship path: one pass (A1, A2) or two (A3, A4).

Counterparts of ``prep_k_onepass_pallas``, ``prep_v_onepass_pallas``,
``channel_stats2_pallas`` and ``quant_kv_pallas`` in
``sageattention_tpu/ops/quant_pallas.py``.  ``_sage_attention`` takes the
one-pass kernels while a padded K/V slice holds at most ``ONEPASS_MAX_ELS``
elements, and the two-pass pair past it: A3 gives the channel stats of K
and V in one launch, torch glue turns them into scales, and A4 quantizes K
and V in one launch.  Each wrapper takes the plain PyTorch version for a CPU
tensor and launches a CUDA kernel for a CUDA tensor; there is no fallback
between the two.  A1 and A2 launch ``csrc/prep_sm90.cu`` (one launch, each
element read once) where :func:`prep_sm90_route` takes the input, and
``csrc/prep_kv.cu``'s first version (a partial pass, then the quantizer)
off it; A3 and A4 launch ``csrc/prep_kv.cu``.  ``launches`` on each wrapper
counts its calls that reached a kernel (one call of A3 launches a partial
pass and a finish, and counts one).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build

_INV127 = float(np.float32(1.0 / 127.0))

# The JAX package's route between the one-pass and the two-pass prep: the
# largest padded (S, D) slice the TPU kernel holds in VMEM.  The port keeps
# its own copy so that it runs the same kernel sequence as JAX; whether the
# line suits the H100 is measured in chip_smoke.py (A3 + A4 against A1 + A2
# on the same K/V).
ONEPASS_MAX_ELS = 36864 * 128


def _masked_stats(x: torch.Tensor, s_true: int):
    """Per-channel mean and amax(|x - mean|) over rows < s_true, as the
    TPU kernel orders them: mean = sum * (1/s_true) in f32."""
    xf = x.float()
    xt = xf[:, :, :s_true]
    mean = xt.sum(dim=2, keepdim=True) * float(np.float32(1.0 / s_true))
    amax = torch.maximum(xt.amax(dim=2, keepdim=True) - mean,
                         mean - xt.amin(dim=2, keepdim=True))
    return xf, mean, amax


def _codes(xc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xc * (1.0 / scale)), -127, 127).to(torch.int8)


def prep_k_onepass_plain(k: torch.Tensor, s_true: int, with_capmax: bool = False):
    """Plain version of A1; see :func:`prep_k_onepass`."""
    kf, mean, amax_ch = _masked_stats(k, s_true)
    head_amax = amax_ch.amax(dim=3, keepdim=True)
    scale = torch.where(head_amax > 0, head_amax * _INV127,
                        torch.ones_like(head_amax))
    k8 = _codes(kf - mean, scale)
    res = (k8, mean, head_amax)
    if with_capmax:
        n = torch.sqrt((k8[:, :, :s_true].float() ** 2).sum(dim=3))
        res += (n.amax(dim=2)[:, :, None, None],)
    return res


def prep_v_onepass_plain(v: torch.Tensor, s_true: int):
    """Plain version of A2; see :func:`prep_v_onepass`."""
    vf, mean, amax = _masked_stats(v, s_true)
    scale = torch.where(amax > 0, amax * _INV127, torch.ones_like(amax))
    return _codes(vf - mean, scale), mean, amax


def _check(x: torch.Tensor, s_true: int):
    if x.ndim != 4:
        raise ValueError(f"expected [B, H, S, D], got shape {tuple(x.shape)}")
    if not 0 < s_true <= x.shape[2]:
        raise ValueError(f"s_true {s_true} out of range for S={x.shape[2]}")


# ------------------------------------- prep_sm90.cu: one launch, one read ----

SM90_ROWS = 256            # rows of a chunk, the partials' rows (A3's)
_SMEM_SM = 233472          # shared memory of an H100 SM
_SMEM_BLOCK = 232448       # the most one block may take
_SMEM_RESERVED = 1024      # the runtime's share of each block
_MAX_BPS = 4               # 64 registers a thread


def prep_sm90_smem(elt: int, D: int, bufs: int = 1) -> int:
    """Dynamic shared memory of a ``prep_sm90.cu`` block for ``elt``-byte
    inputs: ``bufs`` chunk buffers (256 rows each), the 2,048-float
    reduction buffer, the slice's means and inverse scales, and the
    barriers and counters."""
    return bufs * SM90_ROWS * D * elt + 2048 * 4 + 2 * 256 * 4 + 64


def _fit(smem: int) -> int:
    if smem > _SMEM_BLOCK:
        return 0
    return min(_MAX_BPS, _SMEM_SM // (smem + _SMEM_RESERVED))


def prep_sm90_layout(elt: int, D: int):
    """``(buffers a block, blocks an SM)`` of ``prep_sm90.cu`` (its ``Cfg``):
    two chunk buffers where they let an SM hold more chunks than one does,
    as many blocks as the shared memory fits, at most 4; no block where one
    does not fit."""
    one, two = _fit(prep_sm90_smem(elt, D, 1)), _fit(prep_sm90_smem(elt, D, 2))
    return (2, two) if 2 * two > one else (1, one)


def prep_sm90_grid(elt: int, D: int, n_sms: int) -> int:
    """The persistent grid the wrapper asks for: every block the card holds
    at once."""
    return n_sms * prep_sm90_layout(elt, D)[1]


def prep_sm90_route(dtype: torch.dtype, D: int, S: int, n_sms: int) -> bool:
    """Whether A1/A2 on a ``[B, H, S, D]`` input that the kernel reads as
    ``dtype`` (bf16 or f32; f16 is widened to f32) run on ``prep_sm90.cu``
    on a card of ``n_sms`` SMs: its blocks wait on their slice's statistics
    holding their chunks, so every chunk of a slice must be held at once.
    On an H100 (132 SMs) that takes bf16 at D = 64/128/256 and f32 at D =
    64 up to ``ONEPASS_MAX_ELS``, and f32 at D = 128 up to 33,792 rows; f32
    at D = 256 does not fit a block."""
    if dtype not in (torch.bfloat16, torch.float32) or D not in (64, 128, 256):
        return False
    elt = 2 if dtype == torch.bfloat16 else 4
    return -(-S // SM90_ROWS) <= prep_sm90_grid(elt, D, n_sms)


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


_workspaces: dict = {}   # (device, stream) -> int32 counters


def _counters(dev: torch.device, n_slices: int) -> torch.Tensor:
    """The kernel's workspace, kept per device and stream: a ticket, an exit
    count, a launch count, and each slice's arrival count and flag (``3 + 2
    * n_slices`` int32).  Each launch leaves the ticket and the counts at
    zero and raises a slice's flag to its own launch count, so a call
    launches no memset; the buffer is zeroed once, and again when a call
    has more slices."""
    stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else 0
    ws = _workspaces.get((dev, stream))
    if ws is None or ws.numel() < 3 + 2 * n_slices:
        ws = torch.zeros(3 + 2 * max(n_slices, 1024), dtype=torch.int32, device=dev)
        _workspaces[(dev, stream)] = ws
    return ws


def _kernel_input(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the prep kernels read it: bf16 or f32 (f16 widened, exact),
    16-byte aligned rows."""
    D = x.shape[3]
    if D not in (64, 128, 256):
        raise NotImplementedError(f"prep kernels take head_dim 64/128/256, got {D}")
    if x.dtype == torch.float16:
        x = x.float()
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"prep kernels take float inputs, got {x.dtype}")
    return _build.vector_aligned(x)


def _prep(x: torch.Tensor, s_true: int, per_channel: bool, capmax: bool):
    """A1 (``per_channel=False``) or A2 on a CUDA tensor: ``prep_sm90.cu``
    on the route, ``prep_kv.cu`` off it.  Returns ``(codes, mean, amax,
    capmax or None)``."""
    x = _kernel_input(x)
    n_sms = _sm_count(x.device)
    if prep_sm90_route(x.dtype, x.shape[3], x.shape[2], n_sms):
        return _launch_sm90(x, s_true, per_channel, capmax, n_sms)
    return _launch(x, s_true, per_channel, capmax)


def _outputs(x: torch.Tensor, per_channel: bool, capmax: bool, zero_cap: bool):
    B, H, S, D = x.shape
    dev = x.device
    out = torch.empty((B, H, S, D), dtype=torch.int8, device=dev)
    mean = torch.empty((B, H, 1, D), dtype=torch.float32, device=dev)
    amax = torch.empty((B, H, 1, D) if per_channel else (B, H, 1, 1),
                       dtype=torch.float32, device=dev)
    cap = None
    if capmax:
        cap = (torch.zeros if zero_cap else torch.empty)((B, H, 1, 1), dtype=torch.float32,
                                                         device=dev)
    return out, mean, amax, cap


def _launch_sm90(x: torch.Tensor, s_true: int, per_channel: bool, capmax: bool, n_sms: int):
    """One launch of ``prep_sm90.cu`` on ``x`` (as :func:`_kernel_input`
    gives it).  The kernel writes capmax itself, so ``cap`` is not zeroed."""
    B, H, S, D = x.shape
    elt = x.element_size()
    ns, nq = -(-s_true // SM90_ROWS), -(-S // SM90_ROWS)
    grid = min(prep_sm90_grid(elt, D, n_sms), B * H * nq)
    part = torch.empty((3, B * H * ns * D), dtype=torch.float32, device=x.device)
    ws = _counters(x.device, B * H)
    out, mean, amax, cap = _outputs(x, per_channel, capmax, zero_cap=False)
    _build.call(
        "sage_prep_sm90", x.device, int(per_channel), int(capmax),
        0 if x.dtype == torch.bfloat16 else 1, x.data_ptr(), x.stride(0), x.stride(1),
        x.stride(2), B, H, S, s_true, D, float(np.float32(1.0 / s_true)), grid,
        part.data_ptr(), ws.data_ptr(), out.data_ptr(), mean.data_ptr(), amax.data_ptr(),
        cap.data_ptr() if cap is not None else None)
    return out, mean, amax, cap


def _launch(x: torch.Tensor, s_true: int, per_channel: bool, capmax: bool):
    """``prep_kv.cu``'s first version: a partial pass, then the quantizer
    (each block finishing its slice's statistics)."""
    x = _kernel_input(x)
    B, H, S, D = x.shape
    dev = x.device
    nsplit = -(-s_true // 256)
    scratch = torch.empty((3, B * H * nsplit * D), dtype=torch.float32, device=dev)
    out, mean, amax, cap = _outputs(x, per_channel, capmax, zero_cap=True)
    _build.call(
        "sage_prep_kv", dev, int(per_channel), int(capmax),
        0 if x.dtype == torch.bfloat16 else 1, x.data_ptr(),
        x.stride(0), x.stride(1), x.stride(2), B, H, S, s_true, D,
        float(np.float32(1.0 / s_true)),
        scratch[0].data_ptr(), scratch[1].data_ptr(), scratch[2].data_ptr(),
        out.data_ptr(), mean.data_ptr(), amax.data_ptr(),
        cap.data_ptr() if cap is not None else None)
    return out, mean, amax, cap


def prep_k_onepass(k: torch.Tensor, s_true: int, with_capmax: bool = False):
    """Flagship K prep: per-channel mean over the true rows (smooth_k), the
    per-head amax of the centered K, int8 codes at the head scale for every
    row, and optionally capmax = max over true rows of ||k8_row||.

    ``k [B, H, S, D]`` -> ``(k_i8 [B,H,S,D], km [B,H,1,D], head_amax
    [B,H,1,1][, capmax [B,H,1,1]])``.
    """
    _check(k, s_true)
    if k.device.type == "cpu":
        return prep_k_onepass_plain(k, s_true, with_capmax)
    if k.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {k.device}")
    out, mean, amax, cap = _prep(k, s_true, per_channel=False, capmax=with_capmax)
    prep_k_onepass.launches += 1
    return (out, mean, amax, cap) if with_capmax else (out, mean, amax)


def prep_v_onepass(v: torch.Tensor, s_true: int):
    """Flagship V prep: per-channel mean (smooth_v), per-channel amax of the
    centered V and per-channel int8 codes.

    ``v [B, H, S, D]`` -> ``(v_i8 [B,H,S,D], vm [B,H,1,D], v_amax [B,H,1,D])``.
    """
    _check(v, s_true)
    if v.device.type == "cpu":
        return prep_v_onepass_plain(v, s_true)
    if v.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {v.device}")
    out, mean, amax, _ = _prep(v, s_true, per_channel=True, capmax=False)
    prep_v_onepass.launches += 1
    return out, mean, amax


prep_k_onepass.launches = 0
prep_v_onepass.launches = 0


# ------------------------------------------------------- two-pass prep ----

def channel_stats2_plain(k: torch.Tensor, v: torch.Tensor, s_true: int):
    """Plain version of A3; see :func:`channel_stats2`."""
    _, km, k_amax = _masked_stats(k, s_true)
    _, vm, v_amax = _masked_stats(v, s_true)
    return km, k_amax, vm, v_amax


def quant_kv_plain(k, k_scale, km, v, v_scale, vm, with_capmax: bool = False,
                   s_true: int = 0):
    """Plain version of A4; see :func:`quant_kv`."""
    k8 = _codes(k.float() - km.float(), k_scale.float())
    v8 = _codes(v.float() - vm.float(), v_scale.float())
    if not with_capmax:
        return k8, v8
    rows = s_true or k.shape[2]
    n = torch.sqrt((k8[:, :, :rows].float() ** 2).sum(dim=3))
    return k8, v8, n.amax(dim=2)[:, :, None, None]


def _check_pair(k: torch.Tensor, v: torch.Tensor, s_true: int):
    _check(k, s_true)
    if v.shape != k.shape or v.device != k.device:
        raise ValueError(f"k and v must share shape and device, got {tuple(k.shape)} on "
                         f"{k.device} and {tuple(v.shape)} on {v.device}")


def _kernel_pair(k: torch.Tensor, v: torch.Tensor):
    """``(dtype code, k, v)`` as the two-pass kernels read them: both bf16,
    or both f32 (f16, or two different float types, widen exactly)."""
    if not (k.is_floating_point() and v.is_floating_point()):
        raise TypeError(f"prep kernels take float inputs, got {k.dtype} and {v.dtype}")
    if k.shape[3] not in (64, 128, 256):
        raise NotImplementedError(f"prep kernels take head_dim 64/128/256, got {k.shape[3]}")
    dt = torch.bfloat16 if k.dtype == v.dtype == torch.bfloat16 else torch.float32
    k, v = (_build.vector_aligned(x.to(dt)) for x in (k, v))
    return (0 if dt == torch.bfloat16 else 1), k, v


def channel_stats2(k: torch.Tensor, v: torch.Tensor, s_true: int):
    """Per-channel mean and amax(|x - mean|) of K and of V over the rows
    ``< s_true``, in one pass over both (A3).

    ``k, v [B, H, S, D]`` -> ``(km, k_amax, vm, v_amax)``, each ``[B, H, 1,
    D]`` f32, with ``mean = sum * f32(1 / s_true)`` as A1/A2 compute it.
    """
    _check_pair(k, v, s_true)
    if k.device.type == "cpu":
        return channel_stats2_plain(k, v, s_true)
    if k.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {k.device}")
    dtype, k, v = _kernel_pair(k, v)
    B, H, _, D = k.shape
    nsplit = -(-s_true // 256)
    scratch = torch.empty((6, B * H * nsplit * D), dtype=torch.float32, device=k.device)
    stats = torch.empty((4, B, H, 1, D), dtype=torch.float32, device=k.device)
    _build.call("sage_stats2", k.device, dtype, k.data_ptr(), *k.stride()[:3], v.data_ptr(),
                *v.stride()[:3], B, H, s_true, D, float(np.float32(1.0 / s_true)),
                scratch.data_ptr(), *(stats[i].data_ptr() for i in range(4)))
    channel_stats2.launches += 1
    return tuple(stats.unbind(0))


def quant_kv(k, k_scale, km, v, v_scale, vm, with_capmax: bool = False, s_true: int = 0):
    """K and V to int8 in one pass (A4): K's codes ``clip(rint((k - km) *
    (1 / k_scale)))`` at one scale per head, V's the same at one scale per
    channel, for every row; optionally K's capmax = max over the rows ``<
    s_true`` (all rows when 0) of ``||k8 row||_2``.

    ``k_scale [B, H, 1, 1]``, ``km``/``v_scale``/``vm [B, H, 1, D]`` ->
    ``(k_i8, v_i8[, capmax [B, H, 1, 1]])``.
    """
    rows = s_true or k.shape[2]
    _check_pair(k, v, rows)
    if k.device.type == "cpu":
        return quant_kv_plain(k, k_scale, km, v, v_scale, vm, with_capmax, s_true)
    if k.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {k.device}")
    dtype, k, v = _kernel_pair(k, v)
    B, H, S, D = k.shape
    f32 = lambda x, shape: x.float().expand(shape).contiguous()  # noqa: E731
    ks, kmc = f32(k_scale, (B, H, 1, 1)), f32(km, (B, H, 1, D))
    vs, vmc = f32(v_scale, (B, H, 1, D)), f32(vm, (B, H, 1, D))
    k8 = torch.empty((B, H, S, D), dtype=torch.int8, device=k.device)
    v8 = torch.empty_like(k8)
    cap = torch.zeros((B, H, 1, 1), dtype=torch.float32, device=k.device) if with_capmax else None
    _build.call("sage_quant_kv", k.device, int(with_capmax), dtype, k.data_ptr(),
                *k.stride()[:3], v.data_ptr(), *v.stride()[:3], B, H, S, rows, D,
                ks.data_ptr(), kmc.data_ptr(), vs.data_ptr(), vmc.data_ptr(), k8.data_ptr(),
                v8.data_ptr(), cap.data_ptr() if cap is not None else None)
    quant_kv.launches += 1
    return (k8, v8, cap) if with_capmax else (k8, v8)


channel_stats2.launches = 0
quant_kv.launches = 0
