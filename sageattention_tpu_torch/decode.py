"""Int8 KV-cache decode attention (counterpart of ``sageattention_tpu/decode.py``).

The serving path after prefill: each step attends a few fresh query tokens
against the whole cache, so it is bound by the bytes of the cache, and an
int8 cache halves them.

- **Per-token K scales**: an append never rescales old codes.  K is
  centered by the fixed prefill mean (softmax shift invariance makes any
  fixed centering exact).
- **Per-channel V scale with a growth margin** (default 1.25x the prefill
  amax); later tokens that exceed it clip.  ``v_format`` "int8" (default),
  "fp8" (e4m3 codes, 448 max) or "bf16" (``v_quant=False``).  For int8 and
  fp8 the mean of the codes times the scale is folded out of the V mean, so
  the reconstruction's channel mean equals the true one.
- **GQA head folding**: the G query heads of a KV head (times T for a
  verify window) become the rows of its decode tiles of 32 rows, as in
  JAX, whenever that takes fewer tiles than one per query head
  (:func:`fold_heads`); the kernel's results do not depend on the fold.
- The kernel (B11, ``csrc/decode.cu``) quantizes Q per row, runs the
  online softmax with the quantized P of the V format, reads the cache's
  true length and a verify window's offsets from device memory, and
  chooses its own KV splits.  ``bucket`` statically bounds the view of the
  cache that a step may read.

Unlike the JAX package, whose cache is an immutable pytree, the port's
buffers are preallocated once and ``kv_cache_append`` writes the new tokens
into them in place, as a server must; ``length`` stays a device tensor, and
a decode step reads nothing back to the host.  The one visible difference:
a ``KVCache`` object taken before a ``kv_cache_trim`` and a later append
shares the buffers, so it sees the overwritten slots.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .ops.attention import DECODE_ROWS, AttnConfig, attention_call
from .utils.layout import get_layout, round_up

_LANES = 128
_BUCKET_DEFAULT = 512
FP8_SCALE_MAX = 448.0   # e4m3 max-normal; per-channel fp8 V fills the full range


class KVCache(NamedTuple):
    """Quantized KV cache.  All buffers are HND with a static ``max_len``
    extent; ``length`` is the filled prefix, shared across the batch (an
    int32 device tensor).  V is int8, float8_e4m3fn or bf16."""

    k8: torch.Tensor       # [B, Hk, Smax, D] int8 (centered by k_mean)
    k_scale: torch.Tensor  # [B, Hk, 1, Smax] f32 per token
    v: torch.Tensor        # [B, Hk, Smax, D] int8/e4m3 (centered by v_mean) or bf16
    v_scale: torch.Tensor  # [B, Hk, 1, D] f32 per channel (ones for bf16)
    v_mean: torch.Tensor   # [B, Hk, 1, D] f32 (zeros when smooth_v=False)
    k_mean: torch.Tensor   # [B, Hk, 1, D] f32 (zeros when smooth_k=False)
    length: torch.Tensor   # () int32 filled length

    @property
    def max_len(self) -> int:
        return self.k8.shape[2]

    @property
    def v_int8(self) -> bool:
        return self.v.dtype == torch.int8

    @property
    def v_fp8(self) -> bool:
        return self.v.dtype == torch.float8_e4m3fn


def _to_hnd(tensor_layout: str, *xs):
    """``xs`` as HND views (NHD swaps the head and sequence axes)."""
    return xs if get_layout(tensor_layout).is_hnd else tuple(x.transpose(1, 2) for x in xs)


def _quant_k(kf, km, eps=1e-8):
    """Center by the fixed mean, per-token int8: (k8, ks [..., S, 1])."""
    kc = kf - km
    a = kc.abs().amax(dim=-1, keepdim=True)
    ks = torch.where(a > eps, a * (1.0 / 127.0), torch.ones_like(a))
    k8 = torch.clamp(torch.round(kc / ks), -127, 127).to(torch.int8)
    return k8, ks


def _quant_v(vf, vm, vs, dtype=torch.int8):
    vc = vf - vm
    if dtype == torch.float8_e4m3fn:
        # clip before the cast: torch's f32 -> e4m3fn cast does not saturate
        return torch.clamp(vc / vs, -FP8_SCALE_MAX, FP8_SCALE_MAX).to(torch.float8_e4m3fn)
    return torch.clamp(torch.round(vc / vs), -127, 127).to(torch.int8)


def _v_format(v_quant, v_format):
    """The V storage mode: "int8" (default), "fp8" (e4m3 codes) or "bf16";
    ``v_quant=False`` is the older spelling of "bf16"."""
    if v_format is None:
        v_format = "int8" if v_quant else "bf16"
    if v_format not in ("int8", "fp8", "bf16"):
        raise ValueError(f"v_format must be int8|fp8|bf16, got {v_format!r}")
    return v_format


_V_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def kv_cache_init(k, v, max_len: int, *, tensor_layout: str = "HND", smooth_k: bool = True,
                  smooth_v: bool = True, v_quant: bool = True, v_margin: float = 1.25,
                  v_format: Optional[str] = None) -> KVCache:
    """Quantize prefill K/V into a cache preallocated to ``max_len`` (rounded
    up to 128, as the JAX package does)."""
    k, v = _to_hnd(tensor_layout, k, v)
    B, Hk, S, D = k.shape
    if v.shape != k.shape:
        raise ValueError(f"k and v shapes must match, got {tuple(k.shape)} vs {tuple(v.shape)}")
    if max_len < S:
        raise ValueError(f"max_len ({max_len}) < prefill length ({S})")
    max_len = round_up(max_len, _LANES)
    kf, vf = k.float(), v.float()
    dev = k.device
    zeros = torch.zeros((B, Hk, 1, D), dtype=torch.float32, device=dev)
    km = kf.mean(dim=2, keepdim=True) if smooth_k else zeros
    vm = vf.mean(dim=2, keepdim=True) if smooth_v else zeros
    k8, ks = _quant_k(kf, km)
    fmt = _v_format(v_quant, v_format)
    if fmt != "bf16":
        qmax = 127.0 if fmt == "int8" else FP8_SCALE_MAX
        a = (vf - vm).abs().amax(dim=2, keepdim=True)
        vs = torch.where(a > 1e-8, a * (v_margin / qmax), torch.ones_like(a))
        vq = _quant_v(vf, vm, vs, _V_DTYPES[fmt])
        # fold the per-channel rounding bias into v_mean: the mean of the
        # actual codes (see the JAX module; never simplified away)
        vm = vm - vq.float().mean(dim=2, keepdim=True) * vs
    else:
        vs = torch.ones((B, Hk, 1, D), dtype=torch.float32, device=dev)
        vq = (vf - vm).to(torch.bfloat16)
    k8_buf = torch.zeros((B, Hk, max_len, D), dtype=torch.int8, device=dev)
    ks_buf = torch.zeros((B, Hk, 1, max_len), dtype=torch.float32, device=dev)
    v_buf = torch.zeros((B, Hk, max_len, D), dtype=vq.dtype, device=dev)
    k8_buf[:, :, :S] = k8
    ks_buf[:, :, 0, :S] = ks[..., 0]
    v_buf[:, :, :S] = vq
    return KVCache(k8_buf, ks_buf, v_buf, vs, vm, km,
                   torch.tensor(S, dtype=torch.int32, device=dev))


def _raw(x):
    """``x``, or its bytes for e4m3 codes (copies and selects of float8 are
    not implemented on every device)."""
    return x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x


def _write_at(buf, val, pos, dim):
    """``buf[..., pos:pos+T, ...] = val`` along ``dim`` at a device position."""
    T = val.shape[dim]
    idx = pos.to(torch.int64) + torch.arange(T, device=buf.device)
    _raw(buf).index_copy_(dim, idx, _raw(val))


def kv_cache_append(cache: KVCache, k_new, v_new, *, tensor_layout: str = "HND") -> KVCache:
    """Quantize ``T`` new tokens with the cache's fixed centering and V
    scales and write them in place at ``cache.length``; returns the cache
    with the grown length.  Old codes are never touched."""
    k_new, v_new = _to_hnd(tensor_layout, k_new, v_new)
    k8, ks = _quant_k(k_new.float(), cache.k_mean)
    if cache.v.dtype == torch.bfloat16:
        vq = (v_new.float() - cache.v_mean).to(torch.bfloat16)
    else:
        vq = _quant_v(v_new.float(), cache.v_mean, cache.v_scale, cache.v.dtype)
    _write_at(cache.k8, k8, cache.length, 2)
    _write_at(cache.k_scale, ks.transpose(2, 3), cache.length, 3)
    _write_at(cache.v, vq, cache.length, 2)
    return cache._replace(length=cache.length + k_new.shape[2])


def kv_cache_trim(cache: KVCache, n) -> KVCache:
    """Roll back the last ``n`` tokens (rejected draft tokens): only the
    visible length moves; the next append overwrites the stale codes."""
    n = torch.as_tensor(n, dtype=torch.int32, device=cache.length.device)
    return cache._replace(length=torch.clamp_min(cache.length - n, 0))


def decode_bucket(length: int, block: int = _BUCKET_DEFAULT) -> int:
    """Smallest multiple of ``block`` covering ``length`` (a host-side
    static bound of the cache view a step reads)."""
    return max(block, round_up(length, block))


def fold_heads(G: int, T: int) -> bool:
    """Fold the ``G`` query heads of a KV group (x ``T`` window rows, row
    ``r = g*T + t``) into the rows of one decode tile, as the JAX package
    does (``decode.py:301``): when ``T == 1`` or the folded rows take fewer
    32-row tiles than one tile per query head, ``ceil(G*T/32) < G``.  The
    cache is then read once per tile instead of once per query head."""
    return G > 1 and (T == 1 or -(-(G * T) // DECODE_ROWS) < G)


def sageattn_decode(q, cache: KVCache, *, tensor_layout: str = "HND",
                    sm_scale: Optional[float] = None, bucket: int = 0, block_k: int = 0,
                    is_causal: bool = True) -> torch.Tensor:
    """Attention of ``T`` fresh query tokens against the quantized cache.

    ``q``: [B, Hq, T, D] (HND), the new tokens' queries at global positions
    ``cache.length - T .. cache.length - 1`` (append first, then decode).
    ``is_causal`` masks within a T > 1 window.  ``bucket`` statically bounds
    the cache view (0 = the full ``max_len``); pick it with
    :func:`decode_bucket`.  ``block_k`` is a TPU tile size, accepted and
    ignored.  Returns [B, Hq, T, D] bf16 in the input layout.
    """
    del block_k
    (q,) = _to_hnd(tensor_layout, q)
    B, Hq, T, D = q.shape
    _, Hk, Smax, Dk = cache.k8.shape
    if D != Dk:
        raise ValueError(f"head_dim mismatch: q {D} vs cache {Dk}")
    if Hq % Hk != 0:
        raise ValueError(f"num_qo_heads ({Hq}) must be divisible by num_kv_heads ({Hk})")
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    if bucket == 0:
        bucket = Smax
    bucket = round_up(bucket, _LANES)
    if bucket > Smax:
        raise ValueError(f"bucket ({bucket}) exceeds cache max_len ({Smax})")
    G = Hq // Hk
    causal = is_causal and T > 1
    fold = fold_heads(G, T)
    qt = q.reshape(B, Hk, G * T, D) if fold else q
    cfg = AttnConfig(
        causal=causal, causal_dynamic=causal,
        causal_row_mod=T if (fold and causal) else 0, quantized=True,
        pv_dtype="fp8" if cache.v_fp8 else "int8" if cache.v_int8 else "bf16",
        layout="HND", sm_scale=sm_scale, kv_len=bucket, kv_len_dynamic=True,
        fold_k_scale=False, fuse_v_mean=True, emit_lse=False, fuse_q_quant=True,
        softmax_mode="online")
    kv = dict(k_scale=cache.k_scale[..., :bucket],
              v_scale=None if cache.v.dtype == torch.bfloat16 else cache.v_scale,
              v_mean=cache.v_mean, kv_true_dyn=cache.length, cfg=cfg)
    k8, v = cache.k8[:, :, :bucket], cache.v[:, :, :bucket]
    zero = torch.zeros_like(cache.length)
    # folded causal rows go in one call (the kernel walks them 32 at a time,
    # with their row base); other rows past 32 in calls of their own, the
    # causal offset moved to each call's first row
    step = qt.shape[2] if (fold and causal) else DECODE_ROWS
    outs = []
    for r0 in range(0, qt.shape[2], step):
        r1 = min(qt.shape[2], r0 + step)
        offsets = (torch.stack([cache.length - T + (0 if fold else r0), zero]) if causal
                   else None)
        outs.append(attention_call(qt[:, :, r0:r1].to(torch.bfloat16), k8, v,
                                   offsets=offsets, **kv)[0])
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    if fold:
        out = out.reshape(B, Hq, T, D)
    (out,) = _to_hnd(tensor_layout, out)
    return out
