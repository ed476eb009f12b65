"""A ``torch.distributed`` world for the port's mesh tests.

``python tests/torch_mesh_worker.py OUTDIR WORLD [CASES]`` starts WORLD
ranks on the ``gloo`` backend (``file://`` rendezvous under OUTDIR, so
concurrent test workers never share a port), runs every case of
:func:`run_cases` (CASES ``coded``, the default) or of
:func:`run_grad_cases` (``grad``) on each rank and writes rank r's
results to ``OUTDIR/rank{r}.npz``.  The test modules compare them with
the JAX package on a one-wide mesh and with ``numpy.fft``;
:func:`case_inputs` and :func:`grad_inputs` make the inputs both sides
use.
:func:`world_of_one` is an in-process world of one rank for tests that
need a mesh object and nothing more.

This module imports no JAX: four ranks import it.
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

S, M, N = 256, 4, 8
NAN = float("nan")


def case_inputs() -> dict:
    """Every case's inputs, from one seed."""
    rng = np.random.default_rng(0)

    def cplx(*shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    fmask = np.ones((3, N, 2), bool)
    fmask[0, [1, 4]] = False              # two workers lost entirely
    fmask[1, [0, 3, 5], 1] = False        # three slow, first fragment in
    fmask[2, 2:6, 1] = False
    fmask[2, 6] = False
    return {
        "x": cplx(3, S).astype(np.complex64),
        "masks": np.array([[1, 0, 1, 1, 0, 1, 0, 0],
                           [1, 1, 1, 1, 1, 1, 1, 1],
                           [0, 1, 0, 1, 1, 0, 1, 1]], bool),
        "mask1": np.array([0, 1, 0, 1, 1, 0, 1, 0], bool),
        "xr": rng.normal(size=(3, 96)),
        "t_nd": cplx(3, 16, 8),
        "tq": cplx(4, 8),
        "fmask": fmask,
        "reqs": [cplx(S).astype(np.complex64) for _ in range(5)],
        "reals": [rng.normal(size=S).astype(np.float32) for _ in range(3)],
        "halves": [cplx(S // 2 + 1).astype(np.complex64) for _ in range(2)],
    }


def reshard_tree() -> dict:
    """A mixed tree: a float32 matrix, a complex vector, an int scalar and
    a host array of -0.0 (whose sign a sum of values would lose)."""
    return {
        "w": torch.arange(64.0, dtype=torch.float32).reshape(8, 8),
        "tw": torch.exp(2j * torch.pi * torch.arange(16) / 16).to(
            torch.complex64),
        "step": torch.tensor(7, dtype=torch.int32),
        "host": [np.ones((8, 4), np.float32) * -0.0],
    }


def fault_plan(faults_mod):
    """Worker 2 killed and worker 1 corrupt in round 0."""
    return faults_mod.FaultPlan().kill(2).corrupt(1)


@contextlib.contextmanager
def world_of_one(path, backend: str = "gloo"):
    """An in-process world of one rank (``file://`` rendezvous at
    ``path``), destroyed on exit."""
    dist.init_process_group(backend, init_method=f"file://{path}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, RuntimeError, NotImplementedError) as err:
        return f"{type(err).__name__}: {err}"
    return ""


def run_cases(world: int) -> dict:
    """The port's side of every case on this rank; the mesh's device is
    the CPU.  Returns name -> numpy value."""
    from repro_torch.core import (
        CodedFFT,
        CodedFFTMultiInput,
        CodedFFTND,
        CodedRFFT,
        make_strategy,
    )
    from repro_torch.distributed import (
        DistributedCodedPlan,
        faults,
        reshard,
        reshard_like,
        test_mesh,
    )
    from repro_torch.serving import FFTService, FFTServiceConfig

    inp = case_inputs()
    c128 = torch.complex128
    out: dict = {}
    mesh = test_mesh((world,), ("workers",))
    meshes = {"": mesh}
    if world == 4:
        meshes["2d"] = test_mesh((2, 2), ("data", "workers"))

    def t(a):
        return torch.as_tensor(a)

    for tag, msh in meshes.items():
        d = DistributedCodedPlan(CodedFFT(s=S, m=M, n_workers=N,
                                          device="cpu"), msh,
                                 masked_fill=NAN)
        out[f"fft_b{tag}"] = d.run(t(inp["x"]), t(inp["masks"])).numpy()
        out[f"coll_run{tag}"] = np.array([
            [c["group_size"], c["send_symbols"], c["recv_symbols"]]
            for c in d.last_collectives])
        out[f"fft_1{tag}"] = d.run(t(inp["x"][0]), t(inp["mask1"])).numpy()
        out[f"coll_run1{tag}"] = np.array([
            [c["group_size"], c["send_symbols"], c["recv_symbols"]]
            for c in d.last_collectives])
        xm = d.run_sharded(t(inp["x"][0]), t(inp["mask1"]))
        out[f"sharded{tag}"] = xm.full_tensor().numpy()
        out[f"sharded_local{tag}"] = xm.to_local().numpy()
        out[f"sharded_placements{tag}"] = np.array(str(list(xm.placements)))
        out[f"coll_sharded{tag}"] = np.array([
            [c["group_size"], c["send_symbols"], c["recv_symbols"]]
            for c in d.last_collectives])
        # the replicated global value through reshard, the path used where
        # DTensor's own collectives cannot run
        out[f"sharded_rs{tag}"] = reshard(xm, msh, ()).to_local().numpy()

    d = DistributedCodedPlan(
        CodedFFT(s=S, m=M, n_workers=N, device="cpu", backend="reference"),
        mesh, masked_fill=NAN)
    out["fft_b_ref"] = d.run(t(inp["x"]), t(inp["masks"])).numpy()
    out["fft_b_solve"] = d.run(t(inp["x"]), t(inp["masks"]),
                               method="solve").numpy()
    out["fft_b_ifft"] = d.run(t(inp["x"]), t(inp["masks"]),
                              method="ifft").numpy()
    d = DistributedCodedPlan(
        CodedRFFT(s=96, m=M, n_workers=N, dtype=c128, backend="reference",
                  device="cpu"), mesh, masked_fill=NAN)
    out["rfft"] = d.run(t(inp["xr"]), t(inp["masks"])).numpy()
    d = DistributedCodedPlan(
        CodedFFTND(shape=(16, 8), factors=(2, 2), n_workers=N, dtype=c128,
                   device="cpu"), mesh, masked_fill=NAN)
    out["fftnd_1"] = d.run(t(inp["t_nd"][0]), t(inp["mask1"])).numpy()
    out["fftnd_b"] = d.run(t(inp["t_nd"]), t(inp["masks"])).numpy()
    d = DistributedCodedPlan(
        CodedFFTMultiInput(q=4, shape=(8,), m_tilde=2, factors=(2,),
                           n_workers=N, dtype=c128, device="cpu"),
        mesh, masked_fill=NAN)
    out["multi"] = d.run(t(inp["tq"]), t(inp["mask1"])).numpy()

    for name, backend in (("partial", "reference"), ("partial", "kernel"),
                          ("comm_efficient", "reference"),
                          ("comm_efficient", "kernel")):
        plan = make_strategy(name, S, 2, N, backend=backend, device="cpu")
        d = DistributedCodedPlan(plan, mesh, masked_fill=NAN)
        key = f"{name}_{backend}"
        if name == "partial":
            out[key + "_b"] = d.run(
                t(inp["x"]), fragment_mask=t(inp["fmask"])).numpy()
            out[key + "_1"] = d.run(
                t(inp["x"][0]), fragment_mask=t(inp["fmask"][1])).numpy()
        else:
            out[key + "_b"] = d.run(t(inp["x"]), t(inp["masks"])).numpy()
            out[key + "_1"] = d.run(t(inp["x"][0]), t(inp["mask1"])).numpy()

    d = DistributedCodedPlan(CodedFFT(s=S, m=M, n_workers=N, device="cpu"),
                             mesh, masked_fill=NAN)
    plan_f = fault_plan(faults)
    out["faults_b"] = d.run(t(inp["x"]), faults=plan_f).numpy()
    out["faults_masked"] = d.run(
        t(inp["x"]), t(~np.eye(N, dtype=bool)[[1, 1, 1]]),
        faults=faults.FaultInjector(plan_f)).numpy()
    out["faults_round1"] = d.run(t(inp["x"]), faults=plan_f,
                                 round_idx=1).numpy()

    # the refusals
    out["err_axis"] = np.array(_error(lambda: DistributedCodedPlan(
        CodedFFT(s=S, m=M, n_workers=6, device="cpu"), mesh)))
    out["err_mesh"] = np.array(_error(
        lambda: test_mesh((world + 1,), ("workers",))))
    out["err_sharded"] = np.array(_error(lambda: DistributedCodedPlan(
        CodedRFFT(s=96, m=M, n_workers=N, device="cpu"), mesh
    ).run_sharded(t(inp["xr"][0]))))

    # the service: mixed kinds, then the strategies
    svc = FFTService(FFTServiceConfig(s=S, m=M, n_workers=N, seed=3,
                                      autotune=False), device="cpu",
                     mesh=mesh)
    xs = inp["reqs"] + inp["reals"] + inp["halves"]
    kinds = ["c2c"] * 5 + ["r2c"] * 3 + ["c2r"] * 2
    for i, y in enumerate(svc.submit_batch(xs, kind=kinds)):
        out[f"svc_{i}"] = y
    for i, y in enumerate(svc.submit_batch(inp["reqs"][:2])):
        out[f"svc2_{i}"] = y
    out["svc_latency"] = np.array(svc.stats.coded_latency)
    out["svc_rng"] = np.array(str(svc.rng.bit_generator.state))
    for strategy in ("partial", "comm_efficient"):
        svc = FFTService(FFTServiceConfig(s=S, m=2, n_workers=N, seed=5,
                                          autotune=False, strategy=strategy),
                         device="cpu", mesh=mesh)
        for i, y in enumerate(svc.submit_batch(inp["reqs"][:3])):
            out[f"svc_{strategy}_{i}"] = y
        out[f"svc_{strategy}_latency"] = np.array(svc.stats.coded_latency)
        out[f"svc_{strategy}_rng"] = np.array(str(svc.rng.bit_generator.state))

    if world == 4:
        out.update(_reshard_cases(test_mesh, reshard, reshard_like))
    return out


def _reshard_cases(test_mesh, reshard, reshard_like):
    """4 -> 2 -> 4 ranks and a ("pod", "d") layout onto a mesh without
    "pod"; every leaf's global value comes back through a replicated
    reshard."""
    out = {}
    tree = reshard_tree()
    specs = {"w": ("d", None), "tw": (), "step": (), "host": [("d",)]}
    m4 = test_mesh((4,), ("d",))
    m2 = test_mesh((2,), ("d",))
    m2x2 = test_mesh((2, 2), ("pod", "d"))

    def values(tr, tag):
        rep = reshard(tr, m4, None)
        out[f"{tag}_w"] = rep["w"].to_local().numpy()
        out[f"{tag}_tw"] = rep["tw"].to_local().numpy()
        out[f"{tag}_step"] = rep["step"].to_local().numpy()
        out[f"{tag}_host"] = rep["host"][0].to_local().numpy()
        out[f"{tag}_wlocal"] = np.array(tuple(tr["w"].to_local().shape))
        out[f"{tag}_wplace"] = np.array(str(list(tr["w"].placements)))

    t4 = reshard(tree, m4, specs)
    t2 = reshard(t4, m2, specs)
    t4b = reshard(t2, m4, specs)
    values(t4, "rs4")
    values(t2, "rs2")
    values(t4b, "rs4b")
    pod = {"w": (("pod", "d"), None), "tw": ("pod",), "step": (),
           "host": [(("pod", "d"),)]}
    tp = reshard(tree, m2x2, pod)
    values(tp, "pod")
    values(reshard(tp, m4, pod), "down")
    values(reshard_like(tp, m2), "like")
    return out


GRAD_SHAPE, GRAD_STEPS = (3, 700), 3     # 700 * 3: not whole blocks


def grad_inputs(world: int) -> np.ndarray:
    """(steps, world) + GRAD_SHAPE f32 gradients, rank r's at [:, r]."""
    rng = np.random.default_rng(11)
    return (rng.standard_normal((GRAD_STEPS, world) + GRAD_SHAPE)
            * 0.01).astype(np.float32)


def local_shape(shape, spec, mesh) -> tuple:
    """This rank's shard shape of a tensor of ``shape`` under ``spec``:
    each dimension split in ``torch.chunk`` pieces over the mesh
    dimensions its entry names, in mesh order."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        for i in sorted(names.index(a) for a in axes):
            k = mesh.size(i)
            chunk = -(-n // k)
            n = len(range(n)[coord[i] * chunk:(coord[i] + 1) * chunk])
        out.append(n)
    return tuple(out)


def run_grad_cases(world: int) -> dict:
    """The compressed all-reduce over the world (GRAD_STEPS steps of
    error feedback from zero residuals) and, in a world of 4, reduced
    gemma-2b's exact-AdamW training state placed on a (data 2, model 2)
    mesh by its sharding plan, then gathered back."""
    from repro_torch.configs import SHAPES, get_reduced_config
    from repro_torch.distributed import test_mesh
    from repro_torch.distributed.sharding import global_tensor, place
    from repro_torch.launch.shardings import make_plan
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, compressed_psum, init_residual
    from repro_torch.optim import compression
    from repro_torch.training import init_train_state, train_state_pspecs

    rank = dist.get_rank()
    g = torch.from_numpy(grad_inputs(world))
    out: dict = {}
    res = init_residual(g[0, rank])
    for t in range(GRAD_STEPS):
        mean, res = compressed_psum(g[t, rank], res)
        out[f"psum_mean_{t}"] = mean.numpy()
        out[f"psum_res_{t}"] = res.numpy()
    out["psum_coll"] = np.array([
        [c["group_size"], c["send_bytes"], c["recv_bytes"]]
        for c in compression.last_collectives])
    if world != 4:
        return out

    mesh = test_mesh((2, 2), ("data", "model"))
    # over the mesh's "data" dimension: ranks r and r ^ 2
    mean, res = compressed_psum(g[0, rank], init_residual(g[0, rank]),
                                mesh=mesh, axis="data")
    out["psum_data_mean"] = mean.numpy()
    out["psum_data_coll"] = np.array([c["group_size"]
                                      for c in compression.last_collectives])
    model = build_model(get_reduced_config("gemma-2b"), device="cpu")
    opt = adamw(1e-3)
    plan = make_plan(model.cfg, SHAPES["train_4k"], mesh)
    state = init_train_state(model, opt, torch.Generator().manual_seed(0))
    with torch.no_grad():               # moments that are not all zero
        for st in state.opt_state["mu"].values():
            st["m"].normal_(generator=torch.Generator().manual_seed(1))
    specs = train_state_pspecs(model, opt, plan.rules)
    named = plan.named(specs)
    flat = {f"params.{n}": (s, named.params[n])
            for n, s in specs.params.items()}
    for n in specs.params:
        for mv in ("m", "v"):
            flat[f"opt_state.mu.{n}.{mv}"] = (specs.opt_state["mu"][n][mv],
                                              named.opt_state["mu"][n][mv])
    tree = state.tree()
    wrong_shape, unequal, local_bytes, want_bytes = [], [], 0, 0
    for name, (spec, placements) in flat.items():
        x = tree[name].detach()
        dt = place(x, mesh, placements)
        want = local_shape(tuple(x.shape), spec, mesh)
        if tuple(dt.to_local().shape) != want:
            wrong_shape.append(name)
        local_bytes += dt.to_local().numel() * x.element_size()
        want_bytes += math.prod(want) * x.element_size()
        if not torch.equal(global_tensor(dt), x):
            unequal.append(name)
    out["plan_fallbacks"] = np.array(plan.fallbacks)
    out["plan_wrong_shape"] = np.array(wrong_shape, dtype=str)
    out["plan_unequal"] = np.array(unequal, dtype=str)
    out["plan_bytes"] = np.array([local_bytes, want_bytes, len(flat)])
    return out


def _rank_main(rank: int, world: int, outdir: str,
               cases: str = "coded") -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo",
                            init_method=f"file://{outdir}/rendezvous",
                            rank=rank, world_size=world)
    try:
        res = (run_grad_cases if cases == "grad" else run_cases)(world)
    except Exception:
        with open(os.path.join(outdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **res)


if __name__ == "__main__":
    import torch.multiprocessing as mp

    outdir, world = sys.argv[1], int(sys.argv[2])
    cases = sys.argv[3] if len(sys.argv) > 3 else "coded"
    mp.spawn(_rank_main, args=(world, outdir, cases), nprocs=world,
             join=True)
