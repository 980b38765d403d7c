"""K/V prep of the flagship path: one pass (A1, A2) or two (A3, A4).

Counterparts of ``prep_k_onepass_pallas``, ``prep_v_onepass_pallas``,
``channel_stats2_pallas`` and ``quant_kv_pallas`` in
``sageattention_tpu/ops/quant_pallas.py``.  ``_sage_attention`` takes the
one-pass kernels while a padded K/V slice holds at most ``ONEPASS_MAX_ELS``
elements, and the two-pass pair past it: A3 gives the channel stats of K
and V in one launch, torch glue turns them into scales, and A4 quantizes K
and V in one launch.  Each wrapper takes the plain PyTorch version for a CPU
tensor and launches the CUDA kernel (``csrc/prep_kv.cu``) for a CUDA tensor;
there is no fallback between the two.  ``launches`` on each wrapper counts
its kernel launches (one call of A3 launches a partial pass and a finish,
and counts one).
"""

from __future__ import annotations

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


def _launch(x: torch.Tensor, s_true: int, per_channel: bool, capmax: bool):
    B, H, S, D = x.shape
    if D not in (64, 128, 256):
        raise NotImplementedError(f"prep kernels take head_dim 64/128/256, got {D}")
    if x.dtype == torch.float16:
        x = x.float()   # exact; the kernel reads bf16 or f32
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"prep kernels take float inputs, got {x.dtype}")
    x = _build.vector_aligned(x)
    dev = x.device
    nsplit = -(-s_true // 256)
    scratch = torch.empty((3, B * H * nsplit * D), dtype=torch.float32, device=dev)
    out = torch.empty((B, H, S, D), dtype=torch.int8, device=dev)
    mean = torch.empty((B, H, 1, D), dtype=torch.float32, device=dev)
    amax = torch.empty((B, H, 1, D) if per_channel else (B, H, 1, 1),
                       dtype=torch.float32, device=dev)
    cap = torch.zeros((B, H, 1, 1), dtype=torch.float32, device=dev) if capmax else None
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
    out, mean, amax, cap = _launch(k, s_true, per_channel=False, capmax=with_capmax)
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
    out, mean, amax, _ = _launch(v, s_true, per_channel=True, capmax=False)
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
