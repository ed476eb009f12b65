"""The port's multi-device runtime against the JAX package's.

The port's side runs in spawned ``gloo`` worlds (``torch_mesh_worker.py``)
of four ranks -- a ``("workers",)`` mesh of 4 (n_local = 2) and a
``("data", "workers")`` mesh of (2, 2) -- and of one rank; the JAX side
runs in process on a one-wide mesh, as the JAX package's own tests run
it.  Cases:

* ``DistributedCodedPlan.run`` for ``CodedFFT`` (kernel and reference
  backends, batched per-request masks and one request, every decode
  method), ``CodedRFFT`` / ``CodedFFTND`` / ``CodedFFTMultiInput`` in
  complex128, the partial and communication-efficient plans on both
  backends, and ``faults=`` with a kill and a corrupt worker -- every
  rank's output equal, NaN straggler rows never reaching it, complex64
  within 5e-4 of ``numpy.fft`` and of the JAX run, complex128 within
  1e-8;
* ``run_sharded`` and the collectives each call records;
* the sharding rules, ``logical_spec`` and ``_resolve`` against the JAX
  package's; ``reshard`` 4 -> 2 -> 4 ranks and ``reshard_like`` onto a
  mesh without "pod", bit for bit;
* ``FFTService(mesh=)`` (mixed kinds, the strategies) against same-seed
  JAX services on a one-wide mesh: outputs, ``coded_latency``, rng state;
* the refusals; and, on the card, a world of one on NCCL against
  ``plan.run``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_mesh_worker import (
    M,
    N,
    S,
    case_inputs,
    fault_plan,
    reshard_tree,
    world_of_one,
)

from repro_torch.core import CodedFFT
from repro_torch.distributed import DistributedCodedPlan, sharding
from repro_torch.distributed import mesh as tmesh
from repro_torch.distributed.elastic import _resolve
from repro_torch.serving import FFTService, FFTServiceConfig

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
NAN = float("nan")
C64_TOL, C128_TOL = 5e-4, 1e-8


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def _launched(tmp_path_factory):
    """Start the 4-rank and 1-rank worlds; they run while the JAX side
    computes."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), os.environ.get("PYTHONPATH", "")]))
    worlds = {}
    for world in (4, 1):
        outdir = tmp_path_factory.mktemp(f"world{world}")
        worlds[world] = (outdir, subprocess.Popen(
            [sys.executable, str(TESTS / "torch_mesh_worker.py"),
             str(outdir), str(world)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    yield worlds
    for _, proc in worlds.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _collect(launched, world: int) -> list[dict]:
    outdir, proc = launched[world]
    _, stderr = proc.communicate(timeout=600)
    errs = "".join(p.read_text() for p in sorted(outdir.glob("*.err")))
    assert proc.returncode == 0, errs + stderr[-3000:]
    return [dict(np.load(outdir / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def world4(_launched, jax_side):
    return _collect(_launched, 4)


@pytest.fixture(scope="module")
def world1(_launched, jax_side):
    return _collect(_launched, 1)


@pytest.fixture(scope="module")
def jax_side(_launched):
    """The JAX package's runtime and services on a one-wide mesh, with the
    same inputs; name -> numpy value, keyed as the port's cases."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import (
        CodedFFT as JFFT,
        CodedFFTMultiInput as JMulti,
        CodedFFTND as JND,
        CodedRFFT as JRFFT,
    )
    from repro.core.strategies import make_strategy as jmake
    from repro.distributed import DistributedCodedPlan as JDist
    from repro.distributed import faults as jfaults
    from repro.distributed import test_mesh as jtest_mesh
    from repro.serving import FFTService as JService
    from repro.serving import FFTServiceConfig as JConfig

    inp = case_inputs()
    mesh = jtest_mesh((1,), ("workers",))
    a = {k: jnp.asarray(v) for k, v in inp.items()
         if isinstance(v, np.ndarray)}
    out = {}

    def run(plan, *args, **kw):
        d = JDist(plan, mesh, masked_fill=NAN)
        return np.asarray(jax.jit(lambda *xs: d.run(*xs, **kw))(*args))

    fft = JFFT(S, M, N)
    out["fft_b"] = run(fft, a["x"], a["masks"])
    out["fft_1"] = run(fft, a["x"][0], a["mask1"])
    xm = jax.jit(JDist(fft, mesh, masked_fill=NAN).run_sharded)(
        a["x"][0], a["mask1"])
    out["sharded"] = np.asarray(xm)
    ref = JFFT(S, M, N, backend="reference")
    out["fft_b_ref"] = run(ref, a["x"], a["masks"])
    out["fft_b_solve"] = run(ref, a["x"], a["masks"], method="solve")
    out["fft_b_ifft"] = run(ref, a["x"], a["masks"], method="ifft")
    c128 = jnp.complex128
    out["rfft"] = run(JRFFT(s=96, m=M, n_workers=N, dtype=c128,
                            backend="reference"), a["xr"], a["masks"])
    nd = JND(shape=(16, 8), factors=(2, 2), n_workers=N, dtype=c128)
    out["fftnd_1"] = run(nd, a["t_nd"][0], a["mask1"])
    out["fftnd_b"] = run(nd, a["t_nd"], a["masks"])
    out["multi"] = run(JMulti(q=4, shape=(8,), m_tilde=2, factors=(2,),
                              n_workers=N, dtype=c128), a["tq"], a["mask1"])
    for name in ("partial", "comm_efficient"):
        for backend in ("reference", "kernel"):
            plan = jmake(name, S, 2, N, backend=backend)
            if name == "comm_efficient":
                # the plan caches its fold weights at first use: build
                # them outside the trace
                plan.fold_weights
            key = f"{name}_{backend}"
            if name == "partial":
                out[key + "_b"] = run(plan, a["x"], fragment_mask=a["fmask"])
                out[key + "_1"] = run(plan, a["x"][0],
                                      fragment_mask=a["fmask"][1])
            else:
                out[key + "_b"] = run(plan, a["x"], a["masks"])
                out[key + "_1"] = run(plan, a["x"][0], a["mask1"])
    plan_f = fault_plan(jfaults)
    out["faults_b"] = run(fft, a["x"], faults=plan_f)
    out["faults_masked"] = run(
        fft, a["x"], jnp.asarray(~np.eye(N, dtype=bool)[[1, 1, 1]]),
        faults=jfaults.FaultInjector(plan_f))
    out["faults_round1"] = run(fft, a["x"], faults=plan_f, round_idx=1)

    svc = JService(JConfig(s=S, m=M, n_workers=N, seed=3, autotune=False),
                   mesh=mesh)
    xs = inp["reqs"] + inp["reals"] + inp["halves"]
    kinds = ["c2c"] * 5 + ["r2c"] * 3 + ["c2r"] * 2
    for i, y in enumerate(svc.submit_batch(xs, kind=kinds)):
        out[f"svc_{i}"] = np.asarray(y)
    for i, y in enumerate(svc.submit_batch(inp["reqs"][:2])):
        out[f"svc2_{i}"] = np.asarray(y)
    out["svc_latency"] = svc.stats.coded_latency
    out["svc_rng"] = str(svc.rng.bit_generator.state)
    for strategy in ("partial", "comm_efficient"):
        svc = JService(JConfig(s=S, m=2, n_workers=N, seed=5,
                               autotune=False, strategy=strategy), mesh=mesh)
        for i, y in enumerate(svc.submit_batch(inp["reqs"][:3])):
            out[f"svc_{strategy}_{i}"] = np.asarray(y)
        out[f"svc_{strategy}_latency"] = svc.stats.coded_latency
        out[f"svc_{strategy}_rng"] = str(svc.rng.bit_generator.state)
    return out


def _truth(case: str):
    """``numpy.fft`` in float64 of a case's inputs (None for the case
    whose corrupt worker is read: its output is deliberately wrong)."""
    inp = case_inputs()
    x = inp["x"].astype(np.complex128)
    fx = np.fft.fft(x, axis=-1)
    if case.startswith(("fft_b", "partial_", "comm_efficient_")) or \
            case in ("faults_masked", "faults_round1"):
        return fx[0] if case.endswith("_1") else fx
    if case.startswith("fft_1"):
        return fx[0]
    if case == "rfft":
        return np.fft.rfft(inp["xr"], axis=-1)
    if case == "fftnd_1":
        return np.fft.fftn(inp["t_nd"][0])
    if case == "fftnd_b":
        return np.fft.fftn(inp["t_nd"], axes=(-2, -1))
    if case == "multi":
        return np.fft.fft(inp["tq"], axis=-1)
    return None


RUN_CASES = [
    "fft_b", "fft_1", "fft_b_ref", "fft_b_solve", "fft_b_ifft", "rfft",
    "fftnd_1", "fftnd_b", "multi", "partial_reference_b",
    "partial_reference_1", "partial_kernel_b", "partial_kernel_1",
    "comm_efficient_reference_b", "comm_efficient_reference_1",
    "comm_efficient_kernel_b", "comm_efficient_kernel_1", "faults_b",
    "faults_masked", "faults_round1",
]
C128_CASES = ("rfft", "fftnd_1", "fftnd_b", "multi")


@pytest.mark.parametrize("world", [4, 1])
@pytest.mark.parametrize("case", RUN_CASES)
def test_run_matches_numpy_and_jax(world4, world1, jax_side, world, case):
    ranks = world4 if world == 4 else world1
    got = ranks[0][case]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[case], got)     # replicated decode
    assert not np.isnan(got).any()
    tol = C128_TOL if case in C128_CASES else C64_TOL
    assert _rel(got, jax_side[case]) < tol
    want = _truth(case)
    if want is None:
        # worker 1 is corrupt and among the first m responders: both
        # implementations read the same warped rows
        assert _rel(got, np.fft.fft(case_inputs()["x"], axis=-1)) > 1e-2
    else:
        assert _rel(got, want) < tol


@pytest.mark.parametrize("case", ["fft_b", "fft_1", "sharded"])
def test_two_dimensional_mesh(world4, case):
    """The ("data", "workers") mesh of (2, 2): each data row runs the
    workers axis of 2 (n_local = 4) and gets the 1-D mesh's values."""
    for r in world4:
        assert _rel(r[case + "2d"], world4[0][case]) < C64_TOL


def test_run_sharded(world4, world1, jax_side):
    want = np.fft.fft(case_inputs()["x"][0].astype(np.complex128))
    ell = S // M
    for ranks in (world4, world1):
        p = len(ranks)
        for rank, r in enumerate(ranks):
            xmat = r["sharded"]
            assert xmat.shape == (M, ell)
            assert _rel(xmat.reshape(-1), want) < C64_TOL
            assert _rel(xmat, jax_side["sharded"]) < C64_TOL
            np.testing.assert_array_equal(r["sharded_rs"], xmat)
            cols = slice(rank * ell // p, (rank + 1) * ell // p)
            np.testing.assert_array_equal(r["sharded_local"], xmat[:, cols])
            assert str(r["sharded_placements"]) == "[Shard(dim=1)]"


def test_collectives_recorded(world4, world1):
    """``run``: one all-gather, each rank receiving all N*nb*payload coded
    symbols (N/m*s for one request); ``run_sharded``: one all-to-all,
    each rank receiving N*(s/m)/P, P times fewer."""
    ell = S // M
    for ranks in (world4, world1):
        p = len(ranks)
        for r in ranks:
            np.testing.assert_array_equal(
                r["coll_run"], [[p, N // p * 3 * ell, N * 3 * ell]])
            np.testing.assert_array_equal(
                r["coll_run1"], [[p, N // p * ell, N * ell]])
            np.testing.assert_array_equal(
                r["coll_sharded"], [[p, N // p * ell, N * ell // p]])
            assert r["coll_run1"][0, 2] == N // M * S
            assert r["coll_run1"][0, 2] == p * r["coll_sharded"][0, 2]
    for r in world4:
        np.testing.assert_array_equal(r["coll_run2d"],
                                      [[2, N // 2 * 3 * ell, N * 3 * ell]])
        np.testing.assert_array_equal(r["coll_sharded2d"],
                                      [[2, N // 2 * ell, N * ell // 2]])


def test_world_refusals(world4):
    r = world4[0]
    assert str(r["err_axis"]) == \
        "ValueError: N=6 must be a multiple of axis size 4"
    assert str(r["err_mesh"]).startswith(
        "RuntimeError: test mesh (5,) needs 5 devices, have 4")
    assert str(r["err_sharded"]).startswith(
        "NotImplementedError: run_sharded implements the 1-D Cooley-Tukey "
        "output layout; got CodedRFFT")


# -- the sharding rules ----------------------------------------------------
def _spec_tuple(spec) -> tuple:
    """A spec as a tuple, a one-name tuple entry as the name (JAX's
    ``PartitionSpec`` compares them equal)."""
    return tuple(e[0] if isinstance(e, (tuple, list)) and len(e) == 1
                 else tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


def test_rules_tables_equal_the_reference():
    pytest.importorskip("jax")
    from repro.distributed import sharding as jsharding

    assert sharding.SINGLE_POD_RULES == jsharding.SINGLE_POD_RULES
    assert sharding.MULTI_POD_RULES == jsharding.MULTI_POD_RULES


@pytest.mark.parametrize("axes", [
    ("batch", "seq", "embed"), ("batch", None, "heads"), ("p_fsdp", "p_mlp"),
    ("tokens", "experts"), ("workers",), ("kv_seq", "unknown"), (),
])
@pytest.mark.parametrize("rules", ["SINGLE_POD_RULES", "MULTI_POD_RULES"])
def test_logical_spec_matches_reference(axes, rules):
    pytest.importorskip("jax")
    from repro.distributed import sharding as jsharding

    got = sharding.logical_spec(axes, getattr(sharding, rules))
    want = jsharding.logical_spec(axes, getattr(jsharding, rules))
    assert _spec_tuple(got) == _spec_tuple(want)
    assert sharding.logical_spec(axes) == ()      # no rules active


def test_rules_context_and_lshard(tmp_path):
    x = torch.arange(12.0).reshape(4, 3)
    assert sharding.lshard(x, "batch", None) is x     # no mesh: a no-op
    assert sharding.named_sharding(("batch",)) is None
    with world_of_one(tmp_path / "pg"):
        mesh = tmesh.test_mesh((1, 1), ("data", "model"))
        with sharding.use_rules(mesh):
            assert sharding.current_mesh() is mesh
            assert sharding.current_rules() is sharding.SINGLE_POD_RULES
            placed = sharding.lshard(x, "batch", "heads")
            assert [p.dim for p in placed.placements] == [0, 1]
            np.testing.assert_array_equal(placed.to_local().numpy(),
                                          x.numpy())
            again = sharding.lshard(placed, None, None)
            assert all(p.is_replicate() for p in again.placements)
            np.testing.assert_array_equal(again.to_local().numpy(),
                                          x.numpy())
        assert sharding.current_mesh() is None
        pod = tmesh.test_mesh((1, 1), ("pod", "data"))
        with sharding.use_rules(pod):
            assert sharding.current_rules() is sharding.MULTI_POD_RULES


def test_resolve_drops_missing_axes():
    """As the JAX package's ``_resolve``: names the target mesh lacks drop
    to None, tuples keep only the axes that exist, and anything but a
    spec resolves to replicated."""
    names = ("d",)
    assert _resolve(("pod", None), names) == (None, None)
    assert _resolve((("pod", "d"), None), names) == (("d",), None)
    assert _resolve((("pod", "host"),), names) == (None,)
    assert _resolve(None, names) == ()
    assert _resolve(("d",), names) == ("d",)


def test_resolve_matches_reference():
    pytest.importorskip("jax")
    from jax.sharding import PartitionSpec as P
    from repro.distributed import test_mesh as jtest_mesh
    from repro.distributed.elastic import _resolve as jresolve

    jmesh = jtest_mesh((1,), ("d",))
    for spec in (("pod", None), (("pod", "d"), None), (("pod", "host"),),
                 ("d",), ("d", "pod")):
        want = jresolve(P(*spec), jmesh).spec
        assert _spec_tuple(_resolve(spec, ("d",))) == _spec_tuple(want)


# -- reshard -----------------------------------------------------------------
@pytest.mark.parametrize("tag,local", [
    ("rs4", [(2, 8)] * 4), ("rs2", [(4, 8), (4, 8), (0,), (0,)]),
    ("rs4b", [(2, 8)] * 4), ("pod", [(2, 8)] * 4), ("down", [(2, 8)] * 4),
    ("like", [(4, 8), (4, 8), (0,), (0,)]),
])
def test_reshard_roundtrip_bit_for_bit(world4, tag, local):
    """4 -> 2 -> 4 ranks, a ("pod", "d") layout, that layout onto a mesh
    without "pod" (reshard) and onto the 2-rank mesh keeping each leaf's
    spec (reshard_like): every leaf's bytes exact on every rank (the -0.0
    leaf keeps its sign), each rank's shard where the spec puts it."""
    tree = reshard_tree()
    for rank, r in enumerate(world4):
        for key in ("w", "tw", "step"):
            assert r[f"{tag}_{key}"].tobytes() == tree[key].numpy().tobytes()
        assert r[f"{tag}_host"].tobytes() == tree["host"][0].tobytes()
        assert tuple(r[f"{tag}_wlocal"]) == local[rank]
    want = ("[Shard(dim=0), Shard(dim=0)]" if tag == "pod"
            else "[Shard(dim=0)]")
    assert str(world4[0][f"{tag}_wplace"]) == want


# -- the service -----------------------------------------------------------
def test_service_on_mesh_matches_jax_service(world4, world1, jax_side):
    inp = case_inputs()
    xs = inp["reqs"] + inp["reals"] + inp["halves"]
    truths = ([np.fft.fft(x.astype(np.complex128)) for x in inp["reqs"]]
              + [np.fft.rfft(x.astype(np.float64)) for x in inp["reals"]]
              + [np.fft.irfft(y.astype(np.complex128)) for y in inp["halves"]])
    for ranks in (world4, world1):
        for r in ranks:
            for i, want in enumerate(truths):
                assert r[f"svc_{i}"].shape == want.shape
                assert _rel(r[f"svc_{i}"], want) < C64_TOL
                assert _rel(r[f"svc_{i}"], jax_side[f"svc_{i}"]) < C64_TOL
            for i in range(2):
                assert _rel(r[f"svc2_{i}"], jax_side[f"svc2_{i}"]) < C64_TOL
            assert float(r["svc_latency"]) == jax_side["svc_latency"]
            assert str(r["svc_rng"]) == jax_side["svc_rng"]
    assert len(xs) == 10


@pytest.mark.parametrize("strategy", ["partial", "comm_efficient"])
def test_strategy_service_on_mesh_matches_jax(world4, world1, jax_side,
                                              strategy):
    reqs = case_inputs()["reqs"][:3]
    for ranks in (world4, world1):
        for r in ranks:
            for i, x in enumerate(reqs):
                got = r[f"svc_{strategy}_{i}"]
                assert _rel(got, np.fft.fft(x.astype(np.complex128))) \
                    < C64_TOL
                assert _rel(got, jax_side[f"svc_{strategy}_{i}"]) < C64_TOL
            assert float(r[f"svc_{strategy}_latency"]) == \
                jax_side[f"svc_{strategy}_latency"]
            assert str(r[f"svc_{strategy}_rng"]) == \
                jax_side[f"svc_{strategy}_rng"]


# -- refusals and helpers, in a world of one -----------------------------
def test_mesh_helpers_without_a_group():
    assert tmesh.device_count_at_least(1)
    assert not tmesh.device_count_at_least(2)
    with pytest.raises(RuntimeError, match=r"test mesh \(1,\) needs 1 "
                                           r"devices, have 0"):
        tmesh.test_mesh((1,), ("workers",))


def test_constructor_refusals(tmp_path):
    """A robust service with a mesh raises the JAX package's ValueError;
    a plan whose device is not the mesh's device type and a mesh without
    the axis are refused."""
    pytest.importorskip("jax")
    from repro.distributed import test_mesh as jtest_mesh
    from repro.serving import FFTService as JService
    from repro.serving import FFTServiceConfig as JConfig

    with pytest.raises(ValueError) as jerr:
        JService(JConfig(health=True), mesh=jtest_mesh((1,), ("workers",)))
    with world_of_one(tmp_path / "pg"):
        mesh = tmesh.test_mesh((1,), ("workers",))
        assert mesh.device_type == "cpu"
        with pytest.raises(ValueError) as ours:
            FFTService(FFTServiceConfig(health=True), device="cpu", mesh=mesh)
        assert str(ours.value) == str(jerr.value)
        meta = CodedFFT(s=64, m=4, n_workers=8, device="meta")
        with pytest.raises(ValueError, match="does not match"):
            DistributedCodedPlan(meta, mesh)
        with pytest.raises(ValueError, match="no axis 'data'"):
            DistributedCodedPlan(CodedFFT(s=64, m=4, n_workers=8,
                                          device="cpu"), mesh, axis="data")
        svc = FFTService(FFTServiceConfig(s=64, m=4, n_workers=8,
                                          autotune=False), device="cpu",
                         mesh=mesh)
        assert svc.runtime.plan is svc.plan and svc.runtime.n_local == 8
        assert not svc._kernel_path(64, "c2c")


@pytest.mark.parametrize("q,m,k,ell", [(3, 4, 8, 16), (2, 8, 16, 5)])
def test_bcmatmul_cpu_route_skips_zero_columns(q, m, k, ell):
    """The CPU route of ``bcmatmul`` skips a decode matrix's zero columns
    as the kernel does: straggler rows of inf and NaN give the product
    with those rows zeroed, where the plain product turns NaN."""
    from repro_torch.kernels.cmatmul import bcmatmul, bcmatmul_body

    rng = np.random.default_rng(k)
    live = np.zeros((q, k), bool)
    for i in range(q):
        live[i, rng.permutation(k)[:m]] = True
    dr = rng.standard_normal((q, m, k)).astype(np.float32) * live[:, None]
    di = rng.standard_normal((q, m, k)).astype(np.float32) * live[:, None]
    br = rng.standard_normal((q, k, ell)).astype(np.float32)
    bi = rng.standard_normal((q, k, ell)).astype(np.float32)
    zr, zi = br * live[..., None], bi * live[..., None]
    br[~live], bi[~live] = np.inf, np.nan
    t = torch.as_tensor
    got = bcmatmul(t(dr), t(di), t(br), t(bi))
    want = bcmatmul_body(t(dr), t(di), t(zr), t(zi))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert not torch.isfinite(bcmatmul_body(t(dr), t(di), t(br),
                                            t(bi))[0]).all()


# -- on the card --------------------------------------------------------------
@pytest.mark.gpu
def test_gpu_nccl_world_of_one_matches_plan_run(tmp_path):
    """A world of one on NCCL: the runtime's encode on cmatmul, the workers
    on the four-step kernels and the batched decode on bcmatmul give
    plan.run's values on the card, NaN straggler rows unread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    inp = case_inputs()
    x = torch.as_tensor(inp["x"], device="cuda")
    masks = torch.as_tensor(inp["masks"], device="cuda")
    with world_of_one(tmp_path / "pg", backend="nccl"):
        mesh = tmesh.test_mesh((1,), ("workers",))
        assert mesh.device_type == "cuda"
        plan = CodedFFT(s=S, m=M, n_workers=N, device="cuda")
        d = DistributedCodedPlan(plan, mesh, masked_fill=NAN)
        _build.reset_launch_counts()
        got = d.run(x, masks).cpu().numpy()
        counts = _build.launch_counts()
        want = plan.run(x, mask=masks).cpu().numpy()
    assert counts.get("cmatmul") and counts.get("bcmatmul")
    assert not np.isnan(got).any()
    assert _rel(got, want) < C64_TOL
    assert _rel(got, np.fft.fft(inp["x"].astype(np.complex128),
                                axis=-1)) < C64_TOL
