"""The one-pass K/V prep (A1, A2) on its Hopper route (``csrc/prep_sm90.cu``):
which inputs ``prep_sm90_route`` takes, the residency arithmetic the route
rests on (every chunk of a slice held by a block at once), what the wrapper
hands ``sage_prep_sm90`` (recorded, not run: no card here), that off-route
inputs still reach ``prep_kv.cu`` and that a failed launch raises.  The
plain versions these kernels are held to on the card are held to the JAX
package's Pallas kernels in interpret mode at the layouts the kernel reads
(NHD views, s_true < S, several chunks); tests/test_torch_prep.py and
tests/test_torch_twopass.py do so at other shapes.

Bars (tests/test_torch_prep.py's): int8 codes identical in >= 99.9% of
places and never more than 1 apart; stats to rtol 1e-5 / atol 1e-6.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu.ops import quant_pallas as qp
from sageattention_tpu_torch.ops import _build
from sageattention_tpu_torch.ops import quant_fused as qf

from port_cpu import yield_cpu  # noqa: F401  (one torch thread, low CPU priority)

H100_SMS = 132
ARGS = ("per_channel", "capmax", "dtype", "x", "sb", "sh", "ss", "B", "H", "S", "s_true", "D",
        "inv_s", "grid", "part", "ws", "out", "mean", "amax", "cap")


def _padded_lengths(D):
    """Padded lengths up to the one-pass limit: a chunk, odd multiples of
    the chunk, and the limit itself."""
    top = qf.ONEPASS_MAX_ELS // D
    return sorted(S for S in {256, 512, 2816, 17792, 33792, 34048, top // 2, top - 256, top}
                  if S <= top)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_route_and_residency(dtype):
    """bf16 at D = 64/128/256 (the main path's dtype; Gemma-7B's D = 256) is
    on the route over the whole one-pass range, f32 at D = 64 too and at
    D = 128 while a slice's chunks fit the grid; f32 at D = 256 and f16 (the
    wrapper widens it to f32 first) are not.  On the route, the largest
    slice's chunk count is at most the grid the wrapper asks for, and that
    grid's blocks fit the SMs' shared memory."""
    for D in (64, 128, 256):
        for S in _padded_lengths(D):
            on = qf.prep_sm90_route(dtype, D, S, H100_SMS)
            if dtype == torch.bfloat16 or (dtype == torch.float32 and D == 64):
                assert on, (D, S)
            elif dtype == torch.float32 and D == 128:
                assert on == (S <= 33792), S
            else:
                assert not on, (D, S)
            for n_sms in (H100_SMS, 114):
                if not qf.prep_sm90_route(dtype, D, S, n_sms):
                    continue
                elt = 2 if dtype == torch.bfloat16 else 4
                bufs, bps = qf.prep_sm90_layout(elt, D)
                smem = qf.prep_sm90_smem(elt, D, bufs)
                assert -(-S // 256) <= qf.prep_sm90_grid(elt, D, n_sms) == n_sms * bps
                assert 1 <= bps <= 4 and smem <= 232448
                assert bps * (smem + 1024) <= 233472
    assert qf.prep_sm90_layout(4, 256)[1] == 0
    # (buffers, blocks) a block and an SM: bf16 at D = 64 holds 6 chunks an
    # SM in 3 blocks of 2 (4 blocks of 1 would hold 4)
    assert [qf.prep_sm90_layout(2, D) for D in (64, 128, 256)] == [(2, 3), (1, 3), (1, 1)]
    assert [qf.prep_sm90_layout(4, D) for D in (64, 128)] == [(1, 3), (1, 1)]


def test_python_mirrors_the_kernels_layout():
    """The wrapper's shared-memory arithmetic is the kernel's ``Cfg``."""
    src = (Path(qf.__file__).parent.parent / "csrc" / "prep_sm90.cu").read_text()
    const = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert const["RED"] == 2048 and const["MAX_BPS"] == qf._MAX_BPS
    assert const["SMEM_SM"] == qf._SMEM_SM and const["SMEM_RESERVED"] == qf._SMEM_RESERVED
    assert const["SMEM_BLOCK"] == qf._SMEM_BLOCK
    for line in ("OFF_RED = BUFS * CHUNK", "OFF_MEAN = OFF_RED + RED * 4",
                 "OFF_INV = OFF_MEAN + 256 * 4", "OFF_MISC = OFF_INV + 256 * 4",
                 "SMEM = OFF_MISC + 64", "CHUNK = ROWS * D * (int)sizeof(T)",
                 "BUFS = 2 * Layout<T, D, 2>::BPS > Layout<T, D, 1>::BPS ? 2 : 1",
                 "__launch_bounds__(NT, Cfg<T, D>::BPS)", "cudaLaunchCooperativeKernel"):
        assert line in src, line


def _record(monkeypatch, n_sms=H100_SMS):
    calls = []
    monkeypatch.setattr(_build, "call", lambda fn, device, *args: calls.append((fn, args)))
    monkeypatch.setattr(qf, "_sm_count", lambda dev: n_sms)
    monkeypatch.setattr(qf, "_workspaces", {})
    return calls


def _x(shape, dtype=torch.bfloat16, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32)).to(dtype)


@pytest.mark.parametrize("per_channel,capmax", [(False, True), (False, False), (True, False)])
def test_one_launch_a_call(monkeypatch, per_channel, capmax):
    """One ``sage_prep_sm90`` call: the input in place, the persistent grid
    (every block the card holds, no more than the work items), one partial
    buffer per statistic over the chunks with true rows, and the outputs
    the kernel writes (capmax too: it is not zero-filled beforehand)."""
    calls = _record(monkeypatch)
    x = _x((2, 3, 1000, 128))
    out, mean, amax, cap = qf._prep(x, 700, per_channel, capmax)
    (fn, args), = calls
    a = dict(zip(ARGS, args))
    assert fn == "sage_prep_sm90"
    assert (a["per_channel"], a["capmax"], a["dtype"]) == (int(per_channel), int(capmax), 0)
    assert a["x"] == x.data_ptr() and (a["sb"], a["sh"], a["ss"]) == x.stride()[:3]
    assert (a["B"], a["H"], a["S"], a["s_true"], a["D"]) == (2, 3, 1000, 700, 128)
    assert a["inv_s"] == float(np.float32(1 / 700))
    assert a["grid"] == min(3 * H100_SMS, 2 * 3 * 4)
    assert tuple(out.shape) == (2, 3, 1000, 128) and out.dtype == torch.int8
    assert a["out"] == out.data_ptr() and a["mean"] == mean.data_ptr()
    assert a["amax"] == amax.data_ptr()
    assert tuple(amax.shape) == ((2, 3, 1, 128) if per_channel else (2, 3, 1, 1))
    assert (cap is None) == (not capmax) and a["cap"] == (cap.data_ptr() if capmax else None)


def test_nhd_view_in_place(monkeypatch):
    """An NHD tensor seen as [B, H, S, D] is read through its strides (one
    bulk copy a row in the kernel), not copied; f16 is widened to f32 in
    the same layout."""
    calls = _record(monkeypatch)
    nhd = _x((1, 600, 4, 64))
    x = nhd.transpose(1, 2)
    qf._prep(x, 600, False, True)
    a = dict(zip(ARGS, calls[-1][1]))
    assert a["x"] == nhd.data_ptr() and (a["sb"], a["sh"], a["ss"]) == (600 * 256, 64, 256)
    qf._prep(x.to(torch.float16), 600, True, False)
    a = dict(zip(ARGS, calls[-1][1]))
    assert calls[-1][0] == "sage_prep_sm90" and a["dtype"] == 1 and a["ss"] == 256


def test_counters_zero_and_shared(monkeypatch):
    """The workspace: int32 zeros of ``3 + 2 * slices`` or more (a ticket, an
    exit count, a launch count, then each slice's arrival count and flag at
    fixed words, so that slice counts may change from call to call), one
    buffer a device and stream that A1 and A2 share (each launch leaves its
    counts at zero), a larger one zeroed once when a call has more slices;
    no other buffer is zero-filled."""
    calls = _record(monkeypatch)
    qf._prep(_x((1, 8, 512, 64)), 512, False, True)
    qf._prep(_x((2, 3, 512, 128)), 512, True, False)
    ws = qf._workspaces[(torch.device("cpu"), 0)]
    assert ws.dtype == torch.int32 and ws.numel() == 3 + 2 * 1024 and not ws.any()
    a, b = (dict(zip(ARGS, c[1])) for c in calls)
    assert a["ws"] == b["ws"] == ws.data_ptr()
    qf._prep(torch.empty((1, 1100, 256, 64), dtype=torch.bfloat16), 200, True, False)
    big = qf._workspaces[(torch.device("cpu"), 0)]
    c = dict(zip(ARGS, calls[-1][1]))
    assert big.numel() == 3 + 2 * 1100 and c["ws"] == big.data_ptr() and not big.any()
    src = (Path(qf.__file__).parent.parent / "csrc" / "prep_sm90.cu").read_text()
    assert "int* arrived = p.ws + 3;" in src and "int* flag = p.ws + 4;" in src
    assert "arrive(arrived + 2 * s)" in src and "ld_acquire(flag + 2 * s)" in src


@pytest.mark.parametrize("dtype,D,S,n_sms", [
    (torch.float32, 256, 512, H100_SMS),       # one f32 chunk at D = 256 exceeds a block
    (torch.float32, 128, 34048, H100_SMS),     # 133 chunks, 132 blocks
    (torch.bfloat16, 64, 1280, 1),             # 5 chunks, 4 blocks
])
def test_off_route_reaches_prep_kv(monkeypatch, dtype, D, S, n_sms):
    calls = _record(monkeypatch, n_sms)
    x = torch.empty((1, 1, S, D), dtype=dtype)
    qf._prep(x, S - 3, False, True)
    qf._prep(x, S - 3, True, False)
    assert [fn for fn, _ in calls] == ["sage_prep_kv", "sage_prep_kv"]
    assert calls[0][1][:3] == (0, 1, 0 if dtype == torch.bfloat16 else 1)


def test_a_failed_launch_raises(monkeypatch):
    """An error code from the entry (a grid the card cannot hold at once,
    say) raises with its message: nothing falls back to ``prep_kv.cu`` or
    to the plain version."""
    class Lib:
        calls = []

        def sage_prep_sm90(self, *args):
            self.calls.append(args)
            return 720

        def sage_prep_sm90_error_string(self, e):
            return b"too many blocks in cooperative launch"

    lib = Lib()
    monkeypatch.setattr(_build, "build_all", lambda: {"prep_sm90": lib})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(qf, "_sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(qf, "_workspaces", {})
    with pytest.raises(RuntimeError, match="sage_prep_sm90 failed to launch: too many blocks"):
        qf._prep(_x((1, 2, 300, 64)), 300, False, True)
    assert len(lib.calls) == 1


@pytest.mark.parametrize("which", ["K", "V"])
def test_plain_matches_jax_at_the_kernels_layouts(which):
    """The plain versions on an NHD view with several chunks, s_true < S and
    a chunk of padding rows only, against ``prep_*_onepass_pallas(interpret=
    True)`` on the same values."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 830, 2, 64)).astype(np.float32) * 2.0
    x[..., 5] += 3.0
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    hnd = np.ascontiguousarray(x.transpose(0, 2, 1, 3))
    view = torch.from_numpy(x).transpose(1, 2)
    if which == "K":
        jr = qp.prep_k_onepass_pallas(jnp.asarray(hnd), 500, with_capmax=True, interpret=True)
        tr = qf.prep_k_onepass(view, 500, with_capmax=True)
    else:
        jr = qp.prep_v_onepass_pallas(jnp.asarray(hnd), 500, interpret=True)
        tr = qf.prep_v_onepass(view, 500)
    a, b = np.asarray(jr[0]).astype(np.int32), tr[0].numpy().astype(np.int32)
    assert np.mean(a == b) >= 0.999 and np.abs(a - b).max() <= 1
    for u, w in zip(jr[1:], tr[1:]):
        assert tuple(w.shape) == u.shape
        np.testing.assert_allclose(w.numpy(), np.asarray(u, dtype=np.float32), rtol=1e-5,
                                   atol=1e-6)
