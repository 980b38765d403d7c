"""Attention backward kernels C1 (dK, dV) and C2 (dQ), and their plain
version (counterpart of ``sageattention_tpu/ops/backward_pallas.py``).

The flash backward of exact attention from the saved ``(q, k, v, o, lse)``,
the straight-through estimator of the quantized forward::

    P_ij  = exp2(s_ij - lse2_i),   lse2 = lse * log2(e)
    dV_j  = sum_i P_ij dO_i
    dS_ij = P_ij (dO_i . V_j - D_i),   D_i = sum(dO_i * O_i)
    dK_j  = scale * sum_i dS_ij Q_i,   dQ_i = scale * sum_j dS_ij K_j

with the JAX kernels' rounding points: P in f32, rounded to bf16 for the dV
product; dS rounded to bf16 for the dK and dQ products; ``dO V^T`` an f32
sum of bf16 products; f32 accumulators.  ``quantized=True`` (the SageBwd
path) recomputes the scores from fresh per-row int8 codes of the saved q
(``sm_scale * log2(e)`` folded in) and k, ``s = (s32 * qs) * ks``, and
feeds the dK and dQ products q and k dequantized to bf16; dK's epilogue
then multiplies by ``1 / log2(e)``, the rest of the fold being in the q
scale.  Options: causal, a causal sliding ``window`` with ``sinks``, a bool
keep-mask ``[B, 1|Hq, Sq, Sk]`` (the lse must come from the forward with
the same mask).  A pair outside the kept set gets P = 0 by a select, so a
row with no live key (whose lse is -inf or hugely negative) gives zeros,
not NaN.

:func:`attention_backward` is the entry: plain-torch glue (pad the
sequences to the kernel's 64-row tiles and the head dim to 64/128/256,
padded q rows at lse2 = 3e38 so their P is 0; ``D_i``; the int8 codes;
the GQA group sum in f32) around :func:`attention_backward_kernel` (CUDA
tensors) or :func:`attention_backward_plain` (CPU tensors).  On the card
the configurations with no mask and no window at head dims 64 and 128 run
on Hopper kernels (TMA, ``wgmma``, warpgroups taking turns): the bf16 ones
(:func:`bwd_sm90_route`) ``csrc/backward_sm90.cu``, the int8 ones
(:func:`bwd_q8_sm90_route`) ``csrc/backward_q8_sm90.cu``, whose dK and dQ
products read the codes dequantized by :func:`dequant_rows`; every other
one runs ``csrc/backward.cu``.  The plain version has no running max and no
per-tile rounding, so it stands for all three whatever their tiles.  The two kernels are counted
per configuration in ``attention_backward_kernel.launches`` (``LAUNCHES``)
under keys
``C1-<bf16|int8>[-causal|-window][-bool]`` and the same for C2.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from . import _build
from . import quant as quant_ops
from .attention import _F32, _per_q_head, mask_tile_table
from .reference import _no_tf32

LOG2E = quant_ops.LOG2E
TILE = 64                 # rows of the kernels' q and kv tiles
LSE_PAD = 3e38            # lse2 of a padded q row: exp2(s - 3e38) = 0


def config_name(kernel: str, quantized: bool, causal: bool, window: int, masked: bool) -> str:
    """Launch key of C1 or C2 (``kernel``) in a configuration."""
    name = f"{kernel}-{'int8' if quantized else 'bf16'}"
    if window:
        name += "-window"
    elif causal:
        name += "-causal"
    return name + ("-bool" if masked else "")


LAUNCH_KEYS = tuple(config_name(c, qz, ca, w, m) for c, qz, (ca, w), m in itertools.product(
    ("C1", "C2"), (False, True), ((False, 0), (True, 0), (True, 1)), (False, True)))


def _pad_to(x, n, dim, value=0.0):
    """``x`` zero- (or ``value``-) padded along ``dim`` to ``n``."""
    extra = n - x.shape[dim]
    if extra == 0:
        return x
    pad = [0, 0] * (x.ndim - 1 - dim % x.ndim) + [0, extra]
    return F.pad(x, pad, value=value)


def _head_dim(D: int) -> int:
    for d in (64, 128, 256):
        if D <= d:
            return d
    raise ValueError(f"head_dim {D} > 256 is not supported")


def _keep(causal, window, sinks, rows, cols, mask_rows):
    """Kept pairs of query ``rows [R, 1]`` and key ``cols [1, C]``: the
    causal band and the mask rows ``[B, Hm, R, C]`` (or None)."""
    keep = None
    if causal:
        keep = cols <= rows
        if window:
            keep = keep & ((cols >= rows - (window - 1)) | (cols < sinks))
    if mask_rows is not None:
        keep = mask_rows != 0 if keep is None else keep & (mask_rows != 0)
    return keep


def dequant_rows(codes, scale):
    """bf16 copy of int8 ``codes [B, H, S, D]`` with row scales ``scale [B,
    H, S]``, ``bf16(f32(code) * scale)`` as the plain version rounds it: the
    q and k that ``csrc/backward_q8_sm90.cu``'s dK and dQ products read
    (JAX dequantizes in the kernel).  One elementwise pass, computed in f32
    and written in bf16."""
    out = torch.empty(codes.shape, dtype=torch.bfloat16, device=codes.device)
    return torch.mul(codes, scale[..., None], out=out)


def attention_backward_plain(q, k, v, do, lse2, di, *, fold, dk_fin, dq_fin, causal,
                             window=0, sinks=0, qs=None, ks=None, mask=None,
                             out_dtype=torch.float32):
    """Plain PyTorch version of C1 and C2 on the padded inputs
    :func:`attention_backward` builds: ``q``/``do [B,Hq,Sqp,D]`` (q bf16,
    or int8 codes with row scales ``qs [B,Hq,Sqp]``), ``k``/``v
    [B,Hk,Skp,D]`` (k bf16 or codes with ``ks [B,Hk,Skp]``), ``lse2``/
    ``di [B,Hq,Sqp]`` f32, ``mask [B,Hm,Sqp,Skp]`` or None.  Walks the
    query rows in runs of whole 64-row tiles, with the kernels' rounding
    points and f32 sums (in another order).  Returns per-q-head
    ``(dq, dk, dv)`` in ``out_dtype``."""
    B, Hq, Sqp, D = q.shape
    Skp = k.shape[2]
    quant = qs is not None
    kf = _per_q_head(k, Hq).float()
    vf = _per_q_head(v, Hq).float()
    if quant:
        qd_all = (q.float() * qs[..., None]).to(torch.bfloat16).float()
        kd = (kf * _per_q_head(ks, Hq)[..., None]).to(torch.bfloat16).float()
        ksc = _per_q_head(ks, Hq)[:, :, None, :]
    else:
        qd_all, kd = None, kf
    dof = do.float()
    dq = torch.zeros(B, Hq, Sqp, D, device=q.device)
    dk = torch.zeros(B, Hq, Skp, D, device=q.device)
    dv = torch.zeros_like(dk)
    # rows per step: keep the [B, Hq, rows, Skp] f32 scores near 512 MB
    chunk = max(TILE, (2 ** 27 // max(1, B * Hq * Skp)) // TILE * TILE)
    cols_all = torch.arange(Skp, device=q.device)[None, :]
    with _no_tf32():
        for r0 in range(0, Sqp, chunk):
            r1 = min(Sqp, r0 + chunk)
            hi = min(Skp, r1) if causal else Skp   # later columns are above the diagonal
            qc = q[:, :, r0:r1].float()
            s = torch.matmul(qc, kf[:, :, :hi].transpose(-1, -2))
            if quant:
                s = (s * qs[:, :, r0:r1, None]) * ksc[..., :hi]
            else:
                s = s * _F32(fold)
            p = torch.exp2(s - lse2[:, :, r0:r1, None])
            rows = torch.arange(r0, r1, device=q.device)[:, None]
            keep = _keep(causal, window, sinks, rows, cols_all[:, :hi],
                         None if mask is None else mask[:, :, r0:r1, :hi])
            if keep is not None:
                p = torch.where(keep, p, torch.zeros((), device=q.device))
            doc = dof[:, :, r0:r1]
            dov = torch.matmul(doc, vf[:, :, :hi].transpose(-1, -2))
            ds = p * (dov - di[:, :, r0:r1, None])
            pb = p.to(torch.bfloat16).float()
            dsb = ds.to(torch.bfloat16).float()
            qd = qd_all[:, :, r0:r1] if quant else qc
            dv[:, :, :hi] += torch.matmul(pb.transpose(-1, -2), doc)
            dk[:, :, :hi] += torch.matmul(dsb.transpose(-1, -2), qd)
            dq[:, :, r0:r1] = torch.matmul(dsb, kd[:, :, :hi])
    return ((dq * _F32(dq_fin)).to(out_dtype), (dk * _F32(dk_fin)).to(out_dtype),
            dv.to(out_dtype))


LAUNCHES = {name: 0 for name in LAUNCH_KEYS}


def bwd_sm90_route(quantized: bool, masked: bool, window: int, D: int) -> bool:
    """Does C1/C2 in this configuration run ``csrc/backward_sm90.cu``?  The
    bf16 form with no mask and no window, causal or not, at head dims 64
    and 128 (``D`` padded); the int8 S-recompute, the window, the bool mask
    and head dim 256 stay on ``csrc/backward.cu``."""
    return not quantized and not masked and not window and D in (64, 128)


def bwd_q8_sm90_route(quantized: bool, masked: bool, window: int, D: int) -> bool:
    """Does C1/C2 in this configuration run ``csrc/backward_q8_sm90.cu``?
    The int8 S-recompute with no mask and no window, causal or not, at head
    dims 64 and 128 (``D`` padded); its window, bool-mask and head-dim-256
    forms stay on ``csrc/backward.cu``."""
    return quantized and not masked and not window and D in (64, 128)


def _aligned16(x):
    """``x`` itself, or a copy when its base is not 16-byte aligned (TMA)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def attention_backward_kernel(q, k, v, do, lse2, di, *, fold, dk_fin, dq_fin, causal,
                              window=0, sinks=0, qs=None, ks=None, mask=None,
                              out_dtype=torch.float32, kernels=("C1", "C2")):
    """Launch C1 and C2 on CUDA tensors; same arguments and returns as
    :func:`attention_backward_plain`.  A configuration that
    :func:`bwd_sm90_route` takes launches ``sage_bwd_sm90``, one that
    :func:`bwd_q8_sm90_route` takes ``sage_bwd_q8_sm90`` (after
    :func:`dequant_rows` of the codes its kernels read), each raising if it
    cannot, with no fallback; the rest launch ``sage_attn_bwd``, under the
    same launch keys.  ``kernels`` may name one of the two (to time it
    alone); the gradients of the other come back as None."""
    B, Hq, Sqp, D = q.shape
    Hk, Skp = k.shape[1], k.shape[2]
    quant = qs is not None
    if D not in (64, 128, 256) or Sqp % TILE or Skp % TILE:
        raise ValueError(f"C1/C2 take head_dim 64/128/256 and 64-row multiples, got "
                         f"{tuple(q.shape)} / {tuple(k.shape)}")
    if quant != (q.dtype == torch.int8) or quant != (k.dtype == torch.int8):
        raise TypeError("quantized C1/C2 take int8 q and k codes with row scales")
    if not quant and (q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16):
        raise TypeError("C1/C2 take bf16 q and k")
    q, k, v, do = (x.contiguous() for x in (q, k, v.to(torch.bfloat16), do.to(torch.bfloat16)))
    lse2, di = lse2.float().contiguous(), di.float().contiguous()
    qs = None if qs is None else qs.float().contiguous()
    ks = None if ks is None else ks.float().contiguous()
    out_f32 = out_dtype != torch.bfloat16
    odt = torch.float32 if out_f32 else torch.bfloat16
    dk = torch.empty((B, Hq, Skp, D), dtype=odt, device=q.device)
    dv = torch.empty_like(dk)
    dq = torch.empty((B, Hq, Sqp, D), dtype=odt, device=q.device)
    m = live = None
    m_strides, Hm = (0, 0, 0), 1
    if mask is not None:
        m = mask.view(torch.int8) if mask.dtype == torch.bool else mask.to(torch.int8)
        m = m.contiguous()
        m_strides, Hm = m.stride()[:3], m.shape[1]
        live = mask_tile_table(m)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    outs = [dk.data_ptr(), dv.data_ptr(), dq.data_ptr()]
    if bwd_sm90_route(quant, mask is not None, window, D):
        q, k, v, do, lse2, di = (_aligned16(x) for x in (q, k, v, do, lse2, di))
        fn = "sage_bwd_sm90"
        common = [D, *(x.data_ptr() for x in (q, k, v, do, lse2, di)), *outs, int(out_f32), B,
                  Hq, Hk, Sqp, Skp, int(causal), _F32(fold), _F32(dk_fin), _F32(dq_fin)]
    elif bwd_q8_sm90_route(quant, mask is not None, window, D):
        # C1 reads q dequantized, C2 k
        qd = dequant_rows(q, qs) if "C1" in kernels else None
        kd = dequant_rows(k, ks) if "C2" in kernels else None
        q, k, v, do, lse2, di, qs, ks = (_aligned16(x) for x in (q, k, v, do, lse2, di, qs, ks))
        fn = "sage_bwd_q8_sm90"
        common = [D, q.data_ptr(), ptr(qd), k.data_ptr(), ptr(kd),
                  *(x.data_ptr() for x in (v, do, lse2, di, qs, ks)), *outs, int(out_f32), B,
                  Hq, Hk, Sqp, Skp, int(causal), _F32(fold), _F32(dk_fin), _F32(dq_fin)]
    else:
        fn = "sage_attn_bwd"
        common = [int(quant), D, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse2.data_ptr(), di.data_ptr(), ptr(qs), ptr(ks), ptr(m), *m_strides, Hm,
                  ptr(live), *outs, int(out_f32), B, Hq, Hk, Sqp, Skp, int(causal), window,
                  sinks, _F32(fold), _F32(dk_fin), _F32(dq_fin)]
    for which, kernel in ((1, "C1"), (2, "C2")):
        if kernel in kernels:
            _build.call(fn, q.device, which, *common)
            LAUNCHES[config_name(kernel, quant, causal, window, mask is not None)] += 1
    dq = dq.to(out_dtype) if "C2" in kernels else None
    if "C1" not in kernels:
        return dq, None, None
    return dq, dk.to(out_dtype), dv.to(out_dtype)


attention_backward_kernel.launches = LAUNCHES


def prepare(q, k, v, o, lse, do, *, sm_scale, quantized=False, di=None, attn_mask=None):
    """The padded kernel inputs of :func:`attention_backward` (a dict of
    the plain version's and the kernel's arguments), as the JAX wrapper
    builds them (``backward_pallas.py:272-340``), at the port's 64-row tiles
    and padded head dim."""
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    Dp = _head_dim(D)
    Sqp, Skp = -(-Sq // TILE) * TILE, -(-Sk // TILE) * TILE
    pad = lambda x, n: _pad_to(_pad_to(x.to(torch.bfloat16), Dp, -1), n, 2)  # noqa: E731
    qb, kb, vb, dob = pad(q, Sqp), pad(k, Skp), pad(v, Skp), pad(do, Sqp)
    lse2 = _pad_to(lse.float() * LOG2E, Sqp, 2, value=LSE_PAD)
    if di is None:
        di = (dob.float() * _pad_to(_pad_to(o.float(), Dp, -1), Sqp, 2)).sum(dim=-1)
    else:
        di = _pad_to(di.float(), Sqp, 2)
    args = dict(q=qb, k=kb, v=vb, do=dob, lse2=lse2, di=di)
    if quantized:
        args["q"], args["qs"] = quant_ops.quant_int8_groupwise(qb, 1, fold=sm_scale * LOG2E)
        args["k"], args["ks"] = quant_ops.quant_int8_groupwise(kb, 1)
    if attn_mask is not None:
        m = attn_mask.to(torch.int8) if attn_mask.dtype != torch.int8 else attn_mask
        args["mask"] = _pad_to(_pad_to(m, Skp, 3), Sqp, 2)
    args.update(fold=sm_scale * LOG2E, dq_fin=sm_scale,
                dk_fin=(1.0 / LOG2E) if quantized else sm_scale)
    return args


def attention_backward(q, k, v, o, lse, do, *, sm_scale, is_causal, attn_mask=None,
                       quantized: bool = False, window: int = 0, sinks: int = 0, di=None,
                       out_dtype=None):
    """``(dq, dk, dv)`` of attention from the saved forward, the JAX
    ``attention_backward_pallas`` (HND; any lengths and head dim <= 256).

    ``q``/``o``/``do [B,Hq,Sq,D]``, ``k``/``v [B,Hk,Sk,D]``, ``lse
    [B,Hq,Sq]`` natural-log (computed with ``attn_mask`` when given).
    ``attn_mask``: bool keep-mask ``[B, 1|Hq, Sq, Sk]``.  ``quantized``:
    the int8 S-recompute.  ``window``/``sinks``: the causal band the
    forward used.  ``di``: a precomputed ``rowsum(dO * O) [B,Hq,Sq]`` (then
    ``o`` may be None).  ``out_dtype``: the gradients' dtype (default: each
    input's).  dK/dV are per q head in that dtype, then summed over the
    GQA group in f32."""
    if window:
        if not is_causal:
            raise ValueError("window requires is_causal")
    elif sinks:
        raise ValueError("sinks requires window")
    B, Hq, Sq, D = q.shape
    _, Hk, Sk, _ = k.shape
    if Hq % Hk or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if attn_mask is not None and (attn_mask.dtype != torch.bool or attn_mask.ndim != 4 or (
            attn_mask.shape[0], attn_mask.shape[2], attn_mask.shape[3]) != (B, Sq, Sk)
            or attn_mask.shape[1] not in (1, Hq)):
        raise ValueError("attn_mask must be a bool keep-mask [B, 1|Hq, Sq, Sk]")
    args = prepare(q, k, v, o, lse, do, sm_scale=sm_scale, quantized=quantized, di=di,
                   attn_mask=attn_mask)
    dts = [out_dtype or x.dtype for x in (q, k, v)]
    # the kernels write the caller's dtype when it is bf16, else f32
    kdt = torch.bfloat16 if all(d == torch.bfloat16 for d in dts) else torch.float32
    args.update(causal=is_causal, window=window, sinks=sinks, out_dtype=kdt)
    if q.device.type == "cpu":
        dq, dk, dv = attention_backward_plain(**args)
    elif q.device.type == "cuda":
        dq, dk, dv = attention_backward_kernel(**args)
    else:
        raise NotImplementedError(f"no kernel for device {q.device}")
    G = Hq // Hk
    dq = dq[:, :, :Sq, :D].to(dts[0])
    dk = dk[:, :, :Sk, :D].to(dts[1])
    dv = dv[:, :, :Sk, :D].to(dts[2])
    if G > 1:
        # f32 sum over the GQA group of the per-head slices in the caller's dtype
        dk = dk.reshape(B, Hk, G, Sk, D).sum(dim=2, dtype=torch.float32).to(dts[1])
        dv = dv.reshape(B, Hk, G, Sk, D).sum(dim=2, dtype=torch.float32).to(dts[2])
    return dq, dk, dv
