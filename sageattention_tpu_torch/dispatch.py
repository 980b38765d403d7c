"""Kernel-mode selection keyed on the tensor's device (counterpart of
``sageattention_tpu/dispatch.py``).

Rows:

- CUDA compute capability 9.0 (Hopper, H100/H200): pv ``"int8"``, compute
  ``"native"``, ``has_fast_fp8`` True (the card multiplies e4m3 at twice the
  bf16 rate).  The JAX rule for a fast-fp8 chip would pick fp8 PV, which is
  also what the reference runs on sm_90.  The port keeps int8 PV as the
  default all the same: switching changes the numerics and the cost of the
  default call, and that choice waits for a benchmark.  ``PERF.md`` keeps
  the H100 times of ``sageattn`` with int8 PV and with ``pv_dtype="fp8"`` at
  the two full-width shapes that ``chip_smoke.py`` drives, for that choice.
- CPU: the same defaults as sm_90, so that the plain path a CPU tensor takes
  runs the same numerics as the card.  This differs from the JAX package's
  CPU row, which picks pv ``"bf16"``.  ``has_fast_fp8`` is False there, as
  in the JAX CPU row; the port's kernel computes the same e4m3 PV numerics
  either way (see ``ops.attention``).
- Any other CUDA device raises: the kernels are built for ``sm_90a`` only.
"""

from __future__ import annotations

import dataclasses
import functools

import torch


@dataclasses.dataclass(frozen=True)
class DeviceCapabilities:
    generation: str          # "sm_90" | "cpu"
    has_fast_fp8: bool       # native e4m3 tensor-core products
    default_pv_dtype: str
    default_compute_dtype: str


_CPU = DeviceCapabilities("cpu", False, "int8", "native")
_SM90 = DeviceCapabilities("sm_90", True, "int8", "native")


@functools.lru_cache(maxsize=8)
def _cuda_caps(index: int) -> DeviceCapabilities:
    major, minor = torch.cuda.get_device_capability(index)
    if (major, minor) == (9, 0):
        return _SM90
    raise NotImplementedError(
        f"CUDA device {index} has compute capability {major}.{minor}; the "
        "port's kernels are built for sm_90a (Hopper) only")


def detect(device=None) -> DeviceCapabilities:
    """Capabilities of ``device`` (a ``torch.device``, a string, or a tensor,
    whose device is taken); with no argument, of the first CUDA card
    (``cuda:0``), which raises on a machine without one."""
    if isinstance(device, torch.Tensor):
        device = device.device
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("dispatch.detect(): no CUDA device; pass device='cpu' "
                               "for the CPU row")
        device = "cuda:0"
    device = torch.device(device)
    if device.type == "cpu":
        return _CPU
    if device.type == "cuda":
        return _cuda_caps(device.index if device.index is not None
                          else torch.cuda.current_device())
    raise NotImplementedError(f"no kernels for device type {device.type!r}")
