"""SageAttention in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The port of the JAX package ``sageattention_tpu``, slice by slice (see
ROADMAP.md).  This package never imports JAX.  A CPU tensor runs each
kernel's plain PyTorch version; a CUDA tensor launches the kernel, built with
``nvcc`` at first use into ``build/torch_kernels/``.
"""

from .core import (
    flash_attention,
    sageattn,
    sageattn_qk_int8_pv_bf16,
    sageattn_qk_int8_pv_fp8,
    sageattn_qk_int8_pv_fp8_cuda,
    sageattn_qk_int8_pv_fp8_cuda_sm90,
    sageattn_qk_int8_pv_fp16_cuda,
    sageattn_qk_int8_pv_fp16_triton,
    sageattn_qk_int8_pv_int8,
)
from .dispatch import detect
from .utils.testing import calc_diff

__all__ = ["sageattn", "sageattn_qk_int8_pv_bf16", "sageattn_qk_int8_pv_int8",
           "sageattn_qk_int8_pv_fp8", "sageattn_qk_int8_pv_fp16_triton",
           "sageattn_qk_int8_pv_fp16_cuda", "sageattn_qk_int8_pv_fp8_cuda",
           "sageattn_qk_int8_pv_fp8_cuda_sm90", "flash_attention", "detect", "calc_diff"]
