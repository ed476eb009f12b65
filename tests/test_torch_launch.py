"""The port's launch tools against the JAX package's, on the CPU.

* ``roofline.useful_flops`` equals the reference's for every arch x shape
  (relative 1e-9);
* ``cost_analysis``: a 7-trip 64 x 64 matmul loop counts exactly
  7·2·64³ FLOPs, and the reference's ``analyze_hlo`` of the jitted scan
  agrees within its own 5%; an all-gather of an f32[8] result in a
  4-trip loop counts 4, with 4·8·4 result bytes (the reference's
  ``test_analyzer_collective_accounting``), an all-reduce twice that on
  the wire; the counter's FLOPs of reduced dense, MoE and hybrid prefill
  and decode steps on meta tensors within 5% of ``analyze_hlo`` of the
  same jitted steps (every gap over 1% is explained in ``CHANGES.md``);
  the FLOPs split by dtype, and ``roofline.terms`` charging bf16 at the
  tensor cores' peak and f32 at the FP32 peak;
* ``fft_dryrun``'s wire bytes a rank, both variants, equal the
  reference's analyzer of the same runtime lowered on 4 host devices (a
  subprocess), at s = 2^14, m = 16, N = 32 (past ``IFFT_AUTO_MAX_M``:
  the decode is the solve, as at the paper's m = 256);
* ``dryrun``: the bytes a rank of params, cache and batch equal, exactly,
  those of the reference's ``param_pspecs``/``cache_pspecs``/
  ``batch_pspecs`` on the same mesh shape (gemma-2b, qwen1.5-32b,
  llama4-maverick; both production meshes; prefill and decode); every
  arch x shape has the reference's ``cell_runnable`` skip reason, and
  ``run_cell`` records it; a meta ``wkv`` call launches nothing and
  reports its cost;
* ``serve_step.make_serve_fns`` against the JAX one in f32 on reduced
  gemma-2b (prefill logits, the cache, two decode steps) within 1e-5;
* ``launch/train.py --lower-only --mesh single --shape decode_32k`` and
  ``examples/quickstart_torch.py --device cpu`` exit 0 in subprocesses.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, \
    get_reduced_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.wkv import wkv, wkv_cost
from repro_torch.launch import dryrun, fft_dryrun, report, roofline
from repro_torch.launch.cost_analysis import analyze
from repro_torch.launch.mesh import production_mesh
from repro_torch.launch.shardings import make_plan
from repro_torch.models import build_model
from repro_torch.serving import make_serve_fns

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import cell_runnable as jcell_runnable  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import shardings as jshardings  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.serving.serve_step import make_serve_fns as jmake_serve_fns  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]


@pytest.fixture
def fake_world():
    """This process as rank 0 of a 4-rank fake process group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield 4
    finally:
        dist.destroy_process_group()


# -- roofline ----------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", CELLS)
def test_useful_flops_equal_reference(arch, shape):
    got = roofline.useful_flops(arch, shape)
    want = jroofline.useful_flops(arch, shape)
    for k in ("linear", "attention", "total"):
        assert got[k] == pytest.approx(want[k], rel=1e-9, abs=0.0), k


def test_peaks_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.PEAK_FP32, roofline.HBM_BW,
            roofline.LINK_BW, roofline.HBM_PER_CHIP) == (
        989e12, 67e12, 3.35e12, 450e9, 80e9)


# -- the counter -------------------------------------------------------------
def test_loop_flops_exact_and_match_reference_analyzer():
    def loop(x):
        for _ in range(7):
            x = x @ x
        return x

    _, cost = analyze(loop, torch.empty(64, 64, device="meta"))
    one = 2 * 64 ** 3
    assert cost.flops == 7 * one

    def scan(x):
        c, _ = jax.lax.scan(lambda c, _: (c @ c, None), x, None, length=7)
        return c

    hlo = jax.jit(scan).lower(jax.ShapeDtypeStruct((64, 64), jnp.float32)) \
        .compile().as_text()
    ref = analyze_hlo(hlo).flops
    assert abs(cost.flops - ref) / ref < 0.05


def test_flops_split_by_dtype_and_charged_at_their_peaks():
    def mixed(a, b):
        return a @ a, b @ b

    a = torch.empty(64, 64, dtype=torch.bfloat16, device="meta")
    b = torch.empty(32, 32, device="meta")
    _, cost = analyze(mixed, a, b)
    fa, fb = 2 * 64 ** 3, 2 * 32 ** 3
    assert cost.flops_by_dtype == {"bfloat16": fa, "float32": fb}
    assert cost.flops == fa + fb
    t = roofline.terms({"cost": cost.as_dict(), "chips": 1})
    assert t["compute_bf16_s"] == fa / roofline.PEAK_FLOPS
    assert t["compute_fp32_s"] == fb / roofline.PEAK_FP32
    assert t["compute_s"] == t["compute_bf16_s"] + t["compute_fp32_s"]


def test_collective_accounting(fake_world):
    x = torch.empty(2, device="meta")

    def gathers(x):
        out = torch.empty(2 * fake_world, device="meta")
        for _ in range(4):
            dist.all_gather_into_tensor(out, x)
        return out

    _, cost = analyze(gathers, x)
    assert cost.collective_counts == {"all-gather": 4}
    assert cost.collective_result_bytes["all-gather"] == 4 * 8 * 4
    assert cost.collective_wire_bytes == 4 * 8 * 4

    def reduces(y):
        for _ in range(4):
            dist.all_reduce(y)
        return y

    _, cost = analyze(reduces, torch.empty(8, device="meta"))
    assert cost.collective_counts == {"all-reduce": 4}
    assert cost.collective_result_bytes["all-reduce"] == 4 * 8 * 4
    assert cost.collective_wire_bytes == 2 * 4 * 8 * 4


STEP_ARCHS = ("gemma-2b", "dbrx-132b", "recurrentgemma-9b")
SB, ST, SC = 2, 32, 64       # batch, prompt, cache slots


def _reference_hlo_flops(arch, kind):
    jmodel = jbuild(jget_reduced(arch))
    params = jparams.abstract_params(jmodel.specs)
    cache = jax.eval_shape(lambda: jmodel.init_cache(SB, SC))
    if kind == "prefill":
        tok = jax.ShapeDtypeStruct((SB, ST), jnp.int32)
        low = jax.jit(jmodel.prefill).lower(params, {"tokens": tok}, cache)
    else:
        tok = jax.ShapeDtypeStruct((SB, 1), jnp.int32)
        step = jax.ShapeDtypeStruct((), jnp.int32)
        low = jax.jit(jmodel.decode_step).lower(params, cache,
                                                {"tokens": tok}, step)
    return analyze_hlo(low.compile().as_text()).flops


def _port_flops(arch, kind):
    model = build_model(get_reduced_config(arch), device="meta")
    params = model.make_params("meta")
    cache = model.init_cache(SB, SC)
    with torch.no_grad():
        if kind == "prefill":
            tok = torch.empty((SB, ST), dtype=torch.int32, device="meta")
            _, cost = analyze(model.prefill, params, {"tokens": tok}, cache)
        else:
            tok = torch.empty((SB, 1), dtype=torch.int32, device="meta")
            _, cost = analyze(model.decode_step, params, cache,
                              {"tokens": tok}, SC - 1)
    return cost.flops


@pytest.mark.parametrize("kind", ("prefill", "decode"))
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_step_flops_match_reference_analyzer(arch, kind):
    got = _port_flops(arch, kind)
    want = _reference_hlo_flops(arch, kind)
    assert abs(got - want) / want < 0.05, (got, want)


# -- fft_dryrun --------------------------------------------------------------
_JAX_FFT_WIRE = """
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro.core.coded_fft import CodedFFT
from repro.distributed.coded_runtime import DistributedCodedFFT
from repro.launch.fft_dryrun import matmul_fft
from repro.launch.hlo_analysis import analyze_hlo
mesh = jax.make_mesh((4,), ("workers",))
# the reference's matmul_fft takes (n, L) only; run() hands it leading axes
def worker(x):
    return matmul_fft(x.reshape(-1, x.shape[-1])).reshape(x.shape)
plan = CodedFFT(s=16384, m=16, n_workers=32, worker_fn=worker)
rt = DistributedCodedFFT(plan, mesh)
out = {}
for v, sharded in (("baseline", False), ("a2a-decode", True)):
    hc = analyze_hlo(rt.lower(sharded=sharded).compile().as_text())
    out[v] = [hc.collective_wire_bytes, hc.collective_result_bytes]
print(json.dumps(out))
"""


def test_fft_dryrun_wire_equals_reference(fake_world, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_FFT_WIRE], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    got = {v: fft_dryrun.run_cell(16384, 16, 32, v, str(tmp_path),
                                  ranks=fake_world)
           for v in fft_dryrun.VARIANTS}
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr
    import json

    want = json.loads(stdout.strip().splitlines()[-1])
    for v, rec in got.items():
        cost = rec["cost"]
        assert cost["collective_wire_bytes"] == want[v][0], v
        assert cost["collective_result_bytes"] == want[v][1], v
        rc = rec["recorded_collectives"][0]
        assert rc["recv_bytes"] == cost["collective_wire_bytes"], v
    # the all-to-all moves a P-th of the all-gather's symbols
    assert (got["baseline"]["cost"]["collective_wire_bytes"]
            == 4 * got["a2a-decode"]["cost"]["collective_wire_bytes"])


def test_matmul_fft_is_the_fft():
    x = np.random.default_rng(0).standard_normal((3, 2, 128)) \
        + 1j * np.random.default_rng(1).standard_normal((3, 2, 128))
    got = fft_dryrun.matmul_fft(torch.from_numpy(x).to(torch.complex128))
    np.testing.assert_allclose(got.numpy(), np.fft.fft(x), atol=1e-10)


# -- dry run: bytes a rank ----------------------------------------------------
class _FakeMesh:
    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes


def _ref_bytes(tree, specs, mesh) -> int:
    """Bytes a rank of the reference's abstract leaves beside their
    PartitionSpecs, each dim over its mesh axes rounded up."""
    from jax.sharding import PartitionSpec as P

    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
        n = 1
        for d, e in zip(leaf.shape, entries):
            names = () if e is None else (e if isinstance(e, tuple) else (e,))
            n *= -(-d // math.prod(mesh.shape[a] for a in names))
        total += n * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("multi", (False, True))
@pytest.mark.parametrize("shape", ("prefill_32k", "decode_32k"))
@pytest.mark.parametrize("arch", ("gemma-2b", "qwen1.5-32b",
                                  "llama4-maverick-400b-a17b"))
def test_bytes_a_rank_equal_reference_plan(arch, shape, multi):
    mesh = production_mesh(multi_pod=multi)
    jmesh = _FakeMesh(mesh.axis_sizes, mesh.axis_names)
    cfg, sh = get_config(arch), SHAPES[shape]
    plan = make_plan(cfg, sh, mesh)
    model = build_model(cfg, device="meta")
    quant = sh.kind == "decode" and cfg.kv_quant_decode
    got = dryrun.argument_bytes(
        cfg, sh, mesh, plan.rules, model, params=model.make_params("meta"),
        cache=model.init_cache(sh.global_batch, sh.seq_len, quant),
        batch=model.input_specs(sh))

    jcfg, jsh = jget_config(arch), JSHAPES[shape]
    rules, fallbacks = jshardings.build_rules(jcfg, jsh, jmesh)
    assert fallbacks == plan.fallbacks
    jmodel = jbuild(jcfg)
    want = {
        "params_bytes": _ref_bytes(jparams.abstract_params(jmodel.specs),
                                   jparams.param_pspecs(jmodel.specs, rules),
                                   jmesh),
        "cache_bytes": _ref_bytes(
            jax.eval_shape(lambda: jmodel.init_cache(
                jsh.global_batch, jsh.seq_len, quant)),
            jshardings.cache_pspecs(jcfg, rules, quantized=quant), jmesh),
        "batch_bytes": _ref_bytes(jmodel.input_specs(jsh),
                                  jshardings.batch_pspecs(jcfg, jsh, rules),
                                  jmesh),
    }
    for k, v in want.items():
        assert got[k] == v, (k, got[k], v)
    step = 4 if sh.kind == "decode" else 0
    assert got["argument_size_in_bytes"] == sum(want.values()) + step


@pytest.mark.parametrize("arch,shape", CELLS)
def test_skip_reasons_equal_reference(arch, shape, tmp_path):
    ok, reason = jcell_runnable(jget_config(arch), JSHAPES[shape])
    assert dryrun.cell_skip(arch, shape) == (None if ok else reason)
    if not ok:          # run_cell records it without counting anything
        rec = dryrun.run_cell(arch, shape, "single", str(tmp_path))
        assert rec["skipped"] == reason
        assert "cost" not in rec


def test_run_cell_decode_record(tmp_path):
    rec = dryrun.run_cell("gemma-2b", "decode_32k", "single", str(tmp_path))
    assert rec["chips"] == 256 and rec["collectives"] is None
    assert rec["fits_hbm"]
    glob = rec["global_cost"]
    # the global decode step is the useful work within the head's rounding
    assert glob["flops"] == pytest.approx(rec["model_flops"]["total"],
                                          rel=0.01)
    assert rec["cost"]["flops"] == glob["flops"] / 256
    assert rec["terms"]["dominant"] == "memory"
    path = dryrun.write_record(str(tmp_path), rec)
    assert Path(path).exists()
    assert roofline.render_table(str(tmp_path)).count("| gemma-2b |") == 1
    # report's table: the meshes side by side, a cell without its multi
    # record listed as missing
    assert "gemma-2b × decode_32k" in report.dryrun_table(str(tmp_path))
    dryrun.write_record(str(tmp_path), dict(rec, mesh="multi"))
    table = report.dryrun_table(str(tmp_path))
    assert "| gemma-2b | decode_32k | 0.342 / 0.342 |" in table


def test_meta_wkv_launches_nothing_and_reports_its_cost():
    bh, t, kd = 6, 16, 64
    args = [torch.empty((bh, t, kd), device="meta") for _ in range(4)] + [
        torch.empty((bh, kd), device="meta"),
        torch.empty((bh, kd, kd), device="meta")]
    reset_launch_counts()
    (o, s), cost = analyze(wkv, *args)
    assert launch_counts() == {}
    assert o.shape == (bh, t, kd) and s.shape == (bh, kd, kd)
    assert o.device.type == "meta"
    flops, nbytes = wkv_cost(bh, t, kd)
    assert cost.kernels == {"wkv": {"calls": 1, "flops": flops,
                                    "bytes": nbytes}}
    assert cost.flops == flops
    assert cost.flops_by_dtype == {"float32": flops}


# -- serving -----------------------------------------------------------------
def test_make_serve_fns_matches_reference():
    arch = "gemma-2b"
    jmodel = jbuild(jget_reduced(arch), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    model = build_model(get_reduced_config(arch), dtype=torch.float32,
                        device="cpu")
    params = model.make_params()
    params.load_state_dict(convert.transformer_params_from_reference(tree))
    jp = jax.tree.map(jnp.asarray, tree)
    b, t, cache_len = 2, 12, 32
    toks = np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (b, t + 2)).astype(np.int32)

    jprefill, jdecode = (jax.jit(f) for f in jmake_serve_fns(jmodel))
    prefill, decode = make_serve_fns(model)
    jlog, jcache = jprefill(jp, {"tokens": jnp.asarray(toks[:, :t])},
                            jmodel.init_cache(b, cache_len))
    with torch.no_grad():
        log, cache = prefill(params, {"tokens": torch.from_numpy(
            toks[:, :t])}, model.init_cache(b, cache_len))

    def rel(got, want):
        want = np.asarray(want, np.float64)
        return float(np.abs(got.double().numpy() - want).max()
                     / np.abs(want).max())

    assert rel(log, jlog) < 1e-5
    for k in ("k", "v"):        # the reference's one stacked slot
        assert rel(cache[k], jcache[0][k]) < 1e-5
    for i in range(2):
        step = t + i
        jlog, jcache = jdecode(jp, jcache,
                               jnp.asarray(toks[:, step:step + 1]),
                               jnp.int32(step))
        with torch.no_grad():
            log, cache = decode(params, cache, torch.from_numpy(
                toks[:, step:step + 1]), step)
        assert rel(log, jlog) < 1e-5, i
    for k in ("k", "v"):
        assert rel(cache[k], jcache[0][k]) < 1e-5

# -- entry points --------------------------------------------------------------
def _run(args, cwd) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_train_lower_only_exits_zero(tmp_path):
    proc = _run(["-m", "repro_torch.launch.train", "--arch", "gemma-2b",
                 "--lower-only", "--mesh", "single", "--shape",
                 "decode_32k"], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "dry run OK: memory-bound, fits one card" in proc.stdout
    assert list((tmp_path / "experiments" / "torch" / "dryrun").glob(
        "gemma-2b--decode_32k--single--train-launcher.json"))


def test_quickstart_cpu_exits_zero(tmp_path):
    proc = _run([str(ROOT / "examples" / "quickstart_torch.py"),
                 "--device", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "straggler-tolerant FFT: OK" in proc.stdout
    assert "n-D real coded FFT service: OK" in proc.stdout
