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
from .decode import (KVCache, decode_bucket, kv_cache_append, kv_cache_init, kv_cache_trim,
                     sageattn_decode)
from .dispatch import detect
from .ops.lowbit import sageattn3, sageattn3_blackwell, sageattn3_tiled
from .paged import (PageAllocator, PagedKVCache, build_table, paged_append,
                    paged_decode_block_staged, paged_decode_step_deferred, paged_insert,
                    paged_prefill, paged_trim, pages_bucket_for, sageattn_decode_paged)
from .serving import Admission, PrefixCachingAllocator
from .utils.testing import calc_diff
from .varlen import sageattn_varlen

__all__ = ["sageattn", "sageattn_qk_int8_pv_bf16", "sageattn_qk_int8_pv_int8",
           "sageattn_qk_int8_pv_fp8", "sageattn_qk_int8_pv_fp16_triton",
           "sageattn_qk_int8_pv_fp16_cuda", "sageattn_qk_int8_pv_fp8_cuda",
           "sageattn_qk_int8_pv_fp8_cuda_sm90", "flash_attention", "sageattn_varlen",
           "detect", "calc_diff", "KVCache", "kv_cache_init", "kv_cache_append",
           "kv_cache_trim", "decode_bucket", "sageattn_decode", "PagedKVCache", "PageAllocator",
           "build_table", "paged_prefill", "paged_insert", "paged_append", "paged_trim",
           "pages_bucket_for", "paged_decode_step_deferred", "paged_decode_block_staged",
           "sageattn_decode_paged", "Admission", "PrefixCachingAllocator", "sageattn3",
           "sageattn3_tiled", "sageattn3_blackwell"]
