"""The port's sequence parallelism (``sageattention_tpu_torch.parallel``:
the ring with kernel B10, its backward, Ulysses, the mesh, and the
``parallel_dit_infer`` example) against the JAX package's on the same
numpy inputs, on the CPU.

The port's side runs in two gloo process groups, of 2 and 4 ranks, spawned
once for the module; every case runs inside a group and rank 0 sends the
results back.  The workers import torch and the port only: the JAX side
runs here, in the parent, under ``jax.jit`` on 2- or 4-device CPU meshes
(its interpret-mode kernels compile once), while the workers compute.

Bars:

- B10's plain version against JAX's ``attention_call(interpret=True)``
  with ``block_q=block_k=64`` (the port's tiles): calc_diff < 1e-5 on the
  output and base-2 lse within 5e-3 (JAX's interpret-mode int8-Q row sums
  sit up to ~2e-3 off the exact ones; ROADMAP queue 3);
- the ring against JAX's ring: calc_diff < 2e-4 (the two quantize the
  shards with different code paths: JAX's interpret runs take its jnp
  quantizers, the port its kernels' plain versions) and natural-log lse
  within 5e-3; against the oracle ``tests/test_parallel.py``'s bars (1e-3,
  1.5e-3 for causal int8 with GQA, lse 0.05);
- the ring against the port's single-device entry: calc_diff < 2e-4, 5e-4
  with padding (``tests/test_parallel.py:37, :262``);
- ring gradients against the port's single-device gradients: < 1e-4
  (``tests/test_parallel.py:152``); against ``jax.grad`` of JAX's ring: the
  same 1e-4;
- Ulysses against JAX's: calc_diff < 1e-4 (both run their single-device
  pipeline on the same head groups, but JAX's interpret-mode
  ``_sage_attention`` takes its unfused path, Q quantized per 4-row group
  outside the kernel, and the port its fused one: the cases read up to
  2.9e-5), and an aligned call equals the port's single-device call within
  1e-6 (``tests/test_parallel.py:74``);
- ``kv_true`` in ``_sage_attention`` against JAX's: calc_diff < 1e-5, 5e-4
  for fp8 PV at JAX's own tile width (``tests/test_torch_modes.py``);
- the example's DiT with ring attention against the same DiT with
  single-device ``sageattn``: calc_diff < 2e-4, the attention-level bar
  (three denoising steps of a 2-block DiT add no measurable error here).
"""

import functools
import multiprocessing as mp
import queue
import socket
import traceback

import numpy as np
import pytest
import torch

from sageattention_tpu_torch.utils.testing import calc_diff

RING_JAX_BAR = 2e-4
LSE_JAX_BAR = 5e-3
SINGLE_BAR, SINGLE_PAD_BAR = 2e-4, 5e-4
ORACLE_BAR, ORACLE_GQA_CAUSAL_BAR, ORACLE_LSE_BAR = 1e-3, 1.5e-3, 0.05
GRAD_BAR = 1e-4
KERNEL_BAR, KERNEL_LSE_BAR = 1e-5, 5e-3
ULYSSES_JAX_BAR, ULYSSES_SINGLE_BAR = 1e-4, 1e-6
KV_TRUE_BAR = {"int8": 1e-5, "bf16": 1e-5, "fp8": 5e-4}
EXAMPLE_BAR = 2e-4
WAIT_S = 240


def qkv(seed, Hq=2, Hk=2, S=256, D=64, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((1, h, S, D)) * scale).astype(np.float32)
            for h in (Hq, Hk, Hk)]


def weights(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------ the ring cases ----
# name -> (world size, qkv arguments, ring arguments).  Each runs the port's
# ring in the group; the ones with a JAX twin also run JAX's ring.
RING = {
    "bf16-lse": (2, dict(seed=1), dict(pv_dtype="bf16", return_lse=True)),
    "int8-static-causal-gqa": (2, dict(seed=2, Hq=4, Hk=2), dict(pv_dtype="int8",
                                                                   is_causal=True)),
    "fp8-online": (2, dict(seed=3), dict(pv_dtype="fp8")),
    "bf16-S300": (2, dict(seed=4, S=300), dict(pv_dtype="bf16")),
    "int8-S200-empty-shards": (4, dict(seed=5, S=200), dict(pv_dtype="int8",
                                                            return_lse=True)),
    "int8-static-causal-4": (4, dict(seed=6, S=512), dict(pv_dtype="int8", is_causal=True)),
}
# the port's single-device twin of each bf16-PV case (pv bf16 means no V smoothing)
SINGLE = {"bf16-lse": SINGLE_BAR, "bf16-S300": SINGLE_PAD_BAR}
GRADS = {  # name -> (world size, qkv arguments, causal, ring arguments)
    "causal": (2, dict(seed=7), True, dict(pv_dtype="bf16")),
    "dense": (2, dict(seed=8), False, dict(pv_dtype="bf16")),
    "int8-static": (2, dict(seed=9), False, dict(pv_dtype="int8")),
    "gqa-causal-4": (4, dict(seed=10, Hq=4, Hk=2, S=512), True, dict(pv_dtype="bf16")),
}
ULYSSES = {  # name -> (qkv arguments, ulysses arguments), world size 4
    "kv-divisible": (dict(seed=11, Hq=8, Hk=4), dict(pv_dtype="bf16")),
    "kv-gathered-unaligned": (dict(seed=12, Hq=8, Hk=2, S=250), dict(pv_dtype="bf16",
                                                                     is_causal=True)),
    "heads-padded": (dict(seed=13, Hq=6, Hk=3), dict(pv_dtype="int8")),
}


def _ring_kw(kw):
    return dict(kw, block_q=128, block_k=128, compute_dtype="native")


# ------------------------------------------------------ workers ----

def _cases(n):
    """The cases of a group of ``n`` ranks: name -> fn(mesh) -> results."""
    import sageattention_tpu_torch as tsa
    from sageattention_tpu_torch import parallel as par
    from sageattention_tpu_torch.examples import parallel_dit_infer

    t = lambda xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
    out = {}

    def ring_case(args, kw):
        def run(mesh):
            res = par.ring_sageattn(*t(qkv(**args)), mesh, **_ring_kw(kw))
            return [r.numpy() for r in res] if isinstance(res, tuple) else [res.numpy()]
        return run

    def grad_case(args, causal, kw):
        def run(mesh):
            q, k, v = (x.requires_grad_() for x in t(qkv(**args)))
            w = torch.from_numpy(weights(args["seed"] + 100, q.shape))
            o = par.ring_sageattn(q, k, v, mesh, is_causal=causal, differentiable=True,
                                  **_ring_kw(kw))
            (o * w).sum().backward()
            ring = [x.grad.numpy().copy() for x in (q, k, v)]
            for x in (q, k, v):
                x.grad = None
            fn = tsa.sageattn_qk_int8_pv_bf16 if kw["pv_dtype"] == "bf16" else \
                tsa.sageattn_qk_int8_pv_int8
            (fn(q, k, v, is_causal=causal) * w).sum().backward()
            return ring + [x.grad.numpy() for x in (q, k, v)]
        return run

    def uly_case(args, kw):
        def run(mesh):
            return [par.ulysses_sageattn(*t(qkv(**args)), mesh, **kw).numpy()]
        return run

    def raises(**kw):
        def run(mesh):
            try:
                par.ring_sageattn(*t(qkv(seed=0, S=kw.pop("S", 256))), mesh, block_q=128,
                                  block_k=128, differentiable=True, **kw)
            except ValueError as e:
                return [str(e)]
            return ["no error"]
        return run

    def mesh_case(mesh):
        par.make_mesh(device_type="cpu")   # sp defaults to the whole group
        try:
            par.make_mesh(dp=3, sp=1, tp=1, device_type="cpu")
            bad = "no error"
        except AssertionError as e:
            bad = str(e)
        return [tuple(mesh.mesh.shape), mesh.mesh_dim_names, bad,
                [str(p) for p in par.seq_sharded(mesh)], [str(p) for p in par.head_sharded(mesh)],
                [str(p) for p in par.seq_sharded(mesh, "NHD")]]

    for name, (size, args, kw) in RING.items():
        if size == n:
            out["ring/" + name] = ring_case(args, kw)
    for name, (size, args, causal, kw) in GRADS.items():
        if size == n:
            out["grad/" + name] = grad_case(args, causal, kw)
    if n == 2:
        out["raise/unaligned"] = raises(S=300)
        out["raise/lse"] = raises(return_lse=True)
        out["example"] = lambda mesh: [parallel_dit_infer.main(
            ["--tiny", "--device", "cpu", "--sp", "2", "--steps", "1"])]
    if n == 4:
        for name, (args, kw) in ULYSSES.items():
            out["ulysses/" + name] = uly_case(args, kw)
        out["mesh"] = mesh_case
    return out


def _worker(rank, n, port, results):
    """One rank of a gloo group of ``n``: runs every case of ``_cases(n)``;
    rank 0 puts each result (or the error) on ``results``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=n,
                            rank=rank)
    try:
        from sageattention_tpu_torch.parallel import make_mesh
        mesh = make_mesh(dp=1, sp=n, tp=1, device_type="cpu")
        for name, fn in _cases(n).items():
            try:
                res = ("ok", fn(mesh))
            except Exception:   # reported to the parent, which fails the test
                res = ("error", traceback.format_exc())
            if rank == 0:
                results.put((name, res))
            if res[0] == "error":
                break
    finally:
        if rank == 0:
            results.put(("done", None))
        dist.destroy_process_group()


class _Group:
    """A spawned gloo group of ``n`` ranks running its cases."""

    def __init__(self, n):
        ctx = mp.get_context("spawn")
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        self.results, self.got, self.done = ctx.Queue(), {}, False
        self.procs = [ctx.Process(target=_worker, args=(r, n, port, self.results), daemon=True)
                      for r in range(n)]
        for p in self.procs:
            p.start()

    def __getitem__(self, name):
        while name not in self.got and not self.done:
            try:
                key, val = self.results.get(timeout=WAIT_S)
            except queue.Empty:
                self.done = True
                break
            if key == "done":
                self.done = True
            else:
                self.got[key] = val
        status, val = self.got.get(name, ("error", f"no result for {name}"))
        assert status == "ok", val
        return val

    def close(self):
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


@pytest.fixture(scope="module")
def groups():
    gs = {n: _Group(n) for n in (2, 4)}
    yield gs
    for g in gs.values():
        g.close()


# ------------------------------------------------------ the JAX side ----

def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


@functools.lru_cache(maxsize=None)
def _jmesh(n):
    jax, _ = _jax()
    from sageattention_tpu.parallel import make_mesh
    return make_mesh(dp=1, sp=n, tp=1, devices=jax.devices()[:n])


def _jit(fn, *args, **static):
    jax, _ = _jax()
    return jax.jit(functools.partial(fn, **static))(*args)


def _jax_ring(n, args, kw):
    _, jnp = _jax()
    from sageattention_tpu.parallel import ring_sageattn
    res = _jit(ring_sageattn, *(jnp.asarray(x) for x in qkv(**args)), mesh=_jmesh(n),
               interpret=True, **_ring_kw(kw))
    return [np.asarray(r) for r in res] if isinstance(res, tuple) else [np.asarray(res)]


def _oracle(args, causal, lse=False):
    from sageattention_tpu_torch.ops.reference import sdpa
    return sdpa(*(torch.from_numpy(x) for x in qkv(**args)), is_causal=causal,
                return_lse=lse)


# ------------------------------------------------------------ tests ----

@pytest.mark.parametrize("name", list(RING))
def test_ring_matches_jax_ring_and_oracle(groups, name):
    n, args, kw = RING[name]
    jres = _jax_ring(n, args, kw)
    tres = groups[n]["ring/" + name]
    S = args.get("S", 256)
    assert tres[0].shape == jres[0].shape == (1, args.get("Hq", 2), S, 64)
    assert np.isfinite(tres[0]).all()
    assert calc_diff(tres[0], jres[0]) < RING_JAX_BAR
    causal = kw.get("is_causal", False)
    bar = ORACLE_GQA_CAUSAL_BAR if causal and args.get("Hq", 2) != args.get("Hk", 2) else \
        ORACLE_BAR
    o_ref, lse_ref = _oracle(args, causal, lse=True)
    assert calc_diff(tres[0], o_ref) < bar
    if kw.get("return_lse"):
        assert tres[1].shape == (1, args.get("Hq", 2), S) and np.isfinite(tres[1]).all()
        assert np.abs(tres[1] - jres[1]).max() < LSE_JAX_BAR
        assert np.abs(tres[1] - lse_ref.numpy()).max() < ORACLE_LSE_BAR


@pytest.mark.parametrize("name", list(SINGLE))
def test_ring_matches_single_device(groups, name):
    import sageattention_tpu_torch as tsa
    n, args, kw = RING[name]
    single = tsa.sageattn_qk_int8_pv_bf16(*(torch.from_numpy(x) for x in qkv(**args)))
    assert calc_diff(groups[n]["ring/" + name][0], single) < SINGLE[name]


@pytest.mark.parametrize("name", list(GRADS))
def test_ring_gradients_match_single_device(groups, name):
    n, args, _, _ = GRADS[name]
    g = groups[n]["grad/" + name]
    for ring, single, x in zip(g[:3], g[3:], qkv(**args)):
        assert ring.shape == x.shape and np.isfinite(ring).all()
        assert calc_diff(ring, single) < GRAD_BAR


def test_ring_gradients_match_jax_grad(groups):
    """The causal GQA case on 4 ranks against ``jax.grad`` through JAX's
    ``ring_sageattn(differentiable=True)``."""
    jax, jnp = _jax()
    from sageattention_tpu.parallel import ring_sageattn
    n, args, causal, kw = GRADS["gqa-causal-4"]
    w = jnp.asarray(weights(args["seed"] + 100, (1, args["Hq"], args["S"], 64)))

    def loss(q, k, v):
        return jnp.sum(w * ring_sageattn(q, k, v, _jmesh(n), is_causal=causal,
                                         differentiable=True, interpret=True, **_ring_kw(kw)))

    jg = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in qkv(**args)))
    for ring, j in zip(groups[n]["grad/gqa-causal-4"][:3], jg):
        assert calc_diff(ring, np.asarray(j)) < GRAD_BAR


@pytest.mark.parametrize("case,match", [("unaligned", "divide evenly"), ("lse", "lse")])
def test_differentiable_ring_raises(groups, case, match):
    """JAX's two refusals, with its messages."""
    assert match in groups[2]["raise/" + case][0]


@pytest.mark.parametrize("name", list(ULYSSES))
def test_ulysses_matches_jax(groups, name):
    _, jnp = _jax()
    import sageattention_tpu_torch as tsa
    from sageattention_tpu.parallel import ulysses_sageattn
    args, kw = ULYSSES[name]
    xs = qkv(**args)
    jo = np.asarray(_jit(ulysses_sageattn, *(jnp.asarray(x) for x in xs), mesh=_jmesh(4),
                         interpret=True, **kw))
    to = groups[4]["ulysses/" + name][0]
    assert to.shape == xs[0].shape and np.isfinite(to).all()
    assert calc_diff(to, jo) < ULYSSES_JAX_BAR
    if args.get("S", 256) % 4 == 0:
        # the same pipeline per head group: equal to the single-device call
        single = tsa.sageattn(*(torch.from_numpy(x) for x in xs), is_causal=kw.get(
            "is_causal", False), pv_dtype=kw["pv_dtype"], k_scale_mode="fine")
        assert calc_diff(to, single) < ULYSSES_SINGLE_BAR


def test_mesh(groups):
    shape, names, bad, seq, head, seq_nhd = groups[4]["mesh"]
    assert shape == (1, 4, 1) and names == ("dp", "sp", "tp")
    assert "mesh 3x1x1 != 4 devices" in bad
    assert seq == ["S(0)", "S(2)", "S(1)"] and head == ["S(0)", "R", "S(1)"]
    assert seq_nhd == ["S(0)", "S(1)", "S(2)"]


def test_parallel_dit_example(groups):
    """``parallel_dit_infer --tiny --device cpu`` at world size 2: the DiT
    with ring attention against the same DiT with single-device sageattn."""
    res = groups[2]["example"][0]
    assert res["finite"] and res["shape"] == (2, 4, 32, 32, 16)
    assert res["mesh"] == (1, 2, 1)
    assert res["calc_diff"] < EXAMPLE_BAR


# ----------------------------------------------- B10's plain version ----
# (name, D, causal offsets (q_start, kv_start) or None, kv_true or None,
#  softmax, folded K scales, pv)
B10 = [
    ("earlier-chunk-kvtrue-mid", 64, (128, 0), 100, "static", True, "int8"),
    ("diagonal", 128, (64, 64), None, "static", True, "bf16"),
    ("later-chunk", 64, (0, 192), None, "online", True, "int8"),
    ("kvtrue-0", 128, None, 0, "online", False, "fp8"),
    ("kvtrue-mid-colk", 64, None, 77, "online", False, "int8"),
    ("earlier-chunk-colk-fp8", 64, (256, 128), 150, "online", False, "fp8"),
]


def _b10_inputs(D, fold, pv, seed, Hq=4, Hk=2, S=192):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (1, Hq, S, D)).astype(np.int8)
    k = rng.integers(-127, 128, (1, Hk, S, D)).astype(np.int8)
    # row scales that put the logits' spread near 3 (log2 units)
    qs = rng.uniform(0.5, 1.5, (1, Hq, S, 1)).astype(np.float32) * (0.005 / D)
    ks = None if fold else rng.uniform(0.5, 1.5, (1, Hk, 1, S)).astype(np.float32)
    if pv == "fp8":
        v = torch.from_numpy(rng.standard_normal((1, Hk, S, D)).astype(np.float32) * 100).to(
            torch.float8_e4m3fn)
    elif pv == "int8":
        v = torch.from_numpy(rng.integers(-127, 128, (1, Hk, S, D)).astype(np.int8))
    else:
        v = torch.from_numpy(rng.standard_normal((1, Hk, S, D)).astype(np.float32)).to(
            torch.bfloat16)
    vs = None if pv == "bf16" else rng.uniform(0.5, 1.5, (1, Hk, 1, D)).astype(np.float32) / 127
    kn = np.sqrt((k.astype(np.float32) ** 2).sum(-1))      # [1, Hk, S]
    if ks is not None:
        kn = kn * ks[:, :, 0]
    kn_max = np.repeat(kn.max(-1)[..., None, None], Hq // Hk, axis=1)
    return q, k, v, qs, ks, vs, kn_max


@pytest.mark.parametrize("case", B10, ids=[c[0] for c in B10])
def test_b10_plain_matches_jax(case):
    _, jnp = _jax()
    from sageattention_tpu.ops.attention import AttnConfig as JCfg
    from sageattention_tpu.ops.attention import attention_call as jattn
    from sageattention_tpu_torch.ops import attention as tatt
    name, D, offs, kv_true, mode, fold, pv = case
    q, k, v, qs, ks, vs, kn_max = _b10_inputs(D, fold, pv, seed=D + len(name))
    S = q.shape[2]
    fields = dict(causal=offs is not None, causal_dynamic=offs is not None, quantized=True,
                  fold_k_scale=fold, compute_dtype="native", pv_dtype=pv, kv_len=S,
                  softmax_mode=mode, pv_via_bf16=mode == "online" and pv != "fp8" and fold,
                  kv_len_dynamic=kv_true is not None, sm_scale=D ** -0.5)
    dyn = dict(offsets=None if offs is None else np.asarray(offs, np.int32),
               kv_true_dyn=None if kv_true is None else np.int32(kv_true))
    static = dict(kn_max=kn_max) if mode == "static" else {}
    tcfg = tatt.AttnConfig(out_dtype=torch.float32, **fields)
    assert tatt.config_name(tcfg, S).startswith("B10-")
    conv = lambda x: None if x is None else torch.as_tensor(x)  # noqa: E731
    to, tl = tatt.attention_call(
        conv(q), conv(k), v, q_scale=conv(qs), k_scale=conv(ks), v_scale=conv(vs),
        cfg=tcfg, **{a: conv(b) for a, b in dict(dyn, **static).items()})
    jcfg = JCfg(block_q=64, block_k=64, block_k_inner=64, out_dtype=jnp.float32, **fields)
    jv = jnp.asarray(v.float().numpy()).astype(
        {"fp8": jnp.float8_e4m3fn, "int8": jnp.int8, "bf16": jnp.bfloat16}[pv])
    jarg = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    jo, jl = _jit(jattn, jarg(q), jarg(k), jv, jarg(qs), jarg(ks), jarg(vs), cfg=jcfg,
                  interpret=True, **{a: jarg(b) for a, b in dict(dyn, **static).items()})
    jo, jl = np.asarray(jo), np.asarray(jl)
    shift = 0 if offs is None else offs[0] - offs[1]
    if kv_true == 0 or shift <= -S:   # no row sees a key: zero output, a finite lse
        assert not to.any() and not jo.any()
        assert np.isfinite(tl.numpy()).all() and np.allclose(tl.numpy(), jl, rtol=1e-6)
        return
    assert calc_diff(to, jo) < KERNEL_BAR
    live = np.isfinite(jl) & (jl > -1e19)
    assert np.array_equal(live, tl.numpy() > -1e19)
    assert np.abs(tl.numpy()[live] - jl[live]).max() < KERNEL_LSE_BAR


def test_b10_routing():
    """At most 32 rows the dynamic fields stay B11's (decode); past them the
    call is the ring's B10 on the prefill kernel, which takes a
    pre-quantized Q and composes with no B7-B9 option."""
    import dataclasses
    from sageattention_tpu_torch.ops import attention as tatt
    cfg = tatt.AttnConfig(quantized=True, pv_dtype="int8", fuse_q_quant=True,
                          kv_len_dynamic=True, causal=True, causal_dynamic=True)
    assert tatt.config_name(cfg, 1) == tatt.config_name(cfg, 32) == "B11-int8-causal"
    with pytest.raises(ValueError, match="B10"):
        tatt.config_name(cfg, 33)
    ring = tatt.AttnConfig(quantized=True, pv_dtype="bf16", fold_k_scale=True, causal=True,
                           causal_dynamic=True, softmax_mode="static")
    assert tatt.config_name(ring, 64) == "B10-B-pvbf16-offsets"
    b10 = {k for k in tatt.LAUNCH_KEYS if k.startswith("B10-")}
    assert b10 >= {"B10-B6-static-offsets", "B10-B6-online-kvtrue", "B10-B5-fp8-offsets-kvtrue",
                   "B10-B6-bf16c-offsets"}
    assert not any("fusedq" in k or "colk" in k or k.startswith("B10-B4") for k in b10)
    with pytest.raises(ValueError, match="B10"):
        tatt.config_name(dataclasses.replace(ring, window=16), 64)


# ------------------------------------------------------ kv_true ----

@pytest.mark.parametrize("pv", ["int8", "fp8", "bf16"])
def test_sage_attention_kv_true_matches_jax(pv):
    """Pre-padded K/V with ``kv_true``: the columns from it on are masked and
    out of every statistic, as in JAX's ``_sage_attention``."""
    _, jnp = _jax()
    from sageattention_tpu.core import _sage_attention as jsage
    from sageattention_tpu_torch import core as tcore
    q, k, v = qkv(seed=20, Hq=4, Hk=2, S=320, D=64)
    # pad rows that would move every statistic; V's stay inside the e4m3
    # range at the real rows' scale (JAX's e4m3 cast turns a value past it
    # into NaN, which a masked P of 0 does not cancel; torch's saturates)
    k[..., 250:, :] = 50.0
    v[..., 250:, :] = 0.5 * v[..., 100:170, :] + 0.3
    kw = dict(pv_dtype=pv, kv_true=250, qk_quant_gran="per_thread",
              smooth_v=pv != "bf16")
    to = tcore._sage_attention(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    jo = np.asarray(_jit(jsage, *(jnp.asarray(x) for x in (q, k, v)), use_fused=True,
                         interpret=True, **kw))
    assert calc_diff(to, jo) < KV_TRUE_BAR[pv]
    from sageattention_tpu_torch.ops.reference import sdpa
    ref = sdpa(*(torch.from_numpy(x[:, :, :250] if i else x) for i, x in enumerate((q, k, v))))
    assert calc_diff(to, ref) < ORACLE_BAR * (5 if pv == "fp8" else 1)


def test_sage_attention_kv_true_errors():
    _, jnp = _jax()
    from sageattention_tpu.core import _sage_attention as jsage
    from sageattention_tpu_torch import core as tcore
    xs = qkv(seed=21, S=128)
    for fn, conv in ((jsage, jnp.asarray), (tcore._sage_attention, torch.from_numpy)):
        kw = {"interpret": True} if fn is jsage else {}
        with pytest.raises(ValueError, match="sliding_window with pre-padded kv_true"):
            fn(*(conv(x) for x in xs), is_causal=True, sliding_window=32, kv_true=100, **kw)
        with pytest.raises(ValueError, match="out of range"):
            fn(*(conv(x) for x in xs), kv_true=200, **kw)
