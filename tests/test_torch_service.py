"""The port's c2c service and plan against the JAX package's, same seed.

* ``FFTService(device="cpu")`` vs the JAX ``FFTService``: identical
  straggler draws (equal ``coded_latency``), outputs within 3e-4 of each
  other and of ``numpy.fft`` (the reference's masked-bucket bound), at one
  length under the port's whole-bucket gate and one over it, so both
  routes run.
* an empty ``submit_batch`` (``[]``, one host transfer counted) and a
  c2c request with m not dividing s (the reference's ``ValueError``
  after the same straggler draw) on both services, with equal stats.
* ``CodedFFT.run`` on the reference backend vs ``repro.core.CodedFFT``
  with NaN-poisoned straggler rows (1e-4 at complex64, 1e-9 at
  complex128, relative to the largest output).
* ``import repro_torch`` loads neither JAX nor the JAX package; entry
  points refuse to run without a GPU unless asked for the CPU; bf16
  planes and the strategy zoo's configurations do what the reference's
  do (``device_decode=False`` and ``m >
  LAGRANGE_MAX_M`` are served: ``tests/test_torch_host_decode.py``; the
  fault runtime and a ``pool=``: ``tests/test_torch_faults.py``).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_kernels import private_autotune_table  # noqa: F401

from repro_torch import CodedFFT, FFTService, FFTServiceConfig
from repro_torch.convert import config_from_reference, generator_from_reference
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs files in parallel
    workers, beside tests that measure wall-clock deadlines."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jref():
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import CodedFFT as JCodedFFT
    from repro.serving import FFTService as JService
    from repro.serving import FFTServiceConfig as JConfig

    return jnp, JCodedFFT, JService, JConfig


def _requests(lengths, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) + 1j * rng.standard_normal(s))
            .astype(np.complex64) for s in lengths]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _port_twin(jsvc):
    """A port service with the reference's config and generator."""
    jcfg = jsvc.cfg
    cfg = config_from_reference(
        {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    svc = FFTService(cfg, device="cpu")
    svc.load_generator(*generator_from_reference(
        np.asarray(jsvc.plan.generator), CPU))
    return svc


def test_service_matches_reference_on_both_routes(jref):
    _, _, JService, JConfig = jref
    small, large = 2048, 16384
    assert tops.coded_bucket_fusable(small, 4, 8)
    assert not tops.coded_bucket_fusable(large, 4, 8)
    jsvc = JService(JConfig(s=small, m=4, n_workers=8, seed=7))
    tsvc = _port_twin(jsvc)
    lengths = [small, large, small, small, large, small]
    for call in range(2):      # the second call continues the same draws
        xs = _requests(lengths, seed=call)
        want = [np.fft.fft(x.astype(np.complex128)) for x in xs]
        jout = jsvc.submit_batch(xs)
        tout = tsvc.submit_batch(xs)
        for j, t, w in zip(jout, tout, want):
            assert t.shape == w.shape and t.dtype == np.complex64
            assert _rel(t, w) < 3e-4
            assert _rel(np.asarray(j), w) < 3e-4
            assert _rel(t, np.asarray(j)) < 3e-4
        assert tsvc.stats.coded_latency == jsvc.stats.coded_latency
        assert tsvc.stats.uncoded_latency == jsvc.stats.uncoded_latency
        assert (tsvc.stats.stragglers_tolerated
                == jsvc.stats.stragglers_tolerated)
    assert tsvc.stats.requests == jsvc.stats.requests == 2 * len(lengths)
    assert tsvc.stats.batches == jsvc.stats.batches == 4
    assert tsvc.stats.host_transfers == 2


def test_service_masks_match_reference_draws(jref):
    _, _, JService, JConfig = jref
    jsvc = JService(JConfig(s=256, m=4, n_workers=8, seed=3))
    tsvc = _port_twin(jsvc)
    for n in (1, 5, 64):
        jl, jm = jsvc._simulate_arrivals(n)
        tl, tm = tsvc._simulate_arrivals(n)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tm, jm)


def test_reference_escape_hatch(jref):
    _, _, JService, JConfig = jref
    jsvc = JService(JConfig(s=512, m=4, n_workers=8, seed=1,
                            use_reference=True))
    tsvc = _port_twin(jsvc)
    assert tsvc.plan.resolved_backend == "reference"
    xs = _requests([512] * 3, seed=5)
    for t, j, x in zip(tsvc.submit_batch(xs), jsvc.submit_batch(xs), xs):
        want = np.fft.fft(x.astype(np.complex128))
        assert _rel(t, want) < 1e-4 and _rel(t, np.asarray(j)) < 1e-4
    assert tsvc.stats.coded_latency == jsvc.stats.coded_latency


def _hist_state(hist):
    """A latency histogram's whole state, comparable across packages."""
    return (hist.counts, hist.n, hist.total, hist.max)


def _assert_stats_equal(tsvc, jsvc):
    """Every count the port's ServiceStats keeps equals the reference's
    (the wall-clock fields aside; the latency histograms by their state)."""
    for f in dataclasses.fields(tsvc.stats):
        if f.name in ("dispatch_s", "sync_s"):
            continue
        got, want = getattr(tsvc.stats, f.name), getattr(jsvc.stats, f.name)
        if f.name == "latency":
            got, want = _hist_state(got), _hist_state(want)
        elif f.name == "tier_latency":
            got = {k: _hist_state(h) for k, h in got.items()}
            want = {k: _hist_state(h) for k, h in want.items()}
        assert got == want, f.name


def test_submit_batch_of_nothing_matches_reference(jref):
    """An empty batch returns [] with no launch and no fetch, and counts
    the one host transfer the reference counts."""
    _, _, JService, JConfig = jref
    jsvc = JService(JConfig(s=256, m=4, n_workers=8, seed=2))
    tsvc = _port_twin(jsvc)
    _build.reset_launch_counts()
    assert tsvc.submit_batch([]) == [] == jsvc.submit_batch([])
    assert _build.launch_counts() == {}
    assert tsvc.stats.host_transfers == 1
    _assert_stats_equal(tsvc, jsvc)


@pytest.mark.parametrize("device_decode", [True, False])
@pytest.mark.parametrize("s", [130, 258, 1026, 4097, 16386])
def test_c2c_length_m_does_not_divide_raises_as_reference(jref, s,
                                                          device_decode):
    """A c2c request with m not dividing s: the reference's ValueError,
    raised after the straggler draw on both decode paths, with the same
    stats after it (no decode planes built on the host path)."""
    _, _, JService, JConfig = jref
    jsvc = JService(JConfig(s=256, m=4, n_workers=8, seed=5,
                            device_decode=device_decode))
    tsvc = _port_twin(jsvc)
    xs = _requests([s], seed=s)
    with pytest.raises(ValueError) as jerr:
        jsvc.submit_batch(xs)
    with pytest.raises(ValueError) as terr:
        tsvc.submit_batch(xs)
    assert str(terr.value) == str(jerr.value) == f"m=4 must divide s={s}"
    assert tsvc.stats.requests == tsvc.stats.batches == 1
    _assert_stats_equal(tsvc, jsvc)


@pytest.mark.parametrize("dtype,tol", [(torch.complex64, 1e-4),
                                       (torch.complex128, 1e-9)])
def test_coded_fft_run_nan_poisoned_stragglers(jref, dtype, tol):
    jnp, JCodedFFT, _, _ = jref
    s, m, n, q = 240, 4, 7, 3
    jdt = jnp.complex64 if dtype == torch.complex64 else jnp.complex128
    tplan = CodedFFT(s=s, m=m, n_workers=n, dtype=dtype, backend="reference",
                     device="cpu")
    jplan = JCodedFFT(s=s, m=m, n_workers=n, dtype=jdt, backend="reference")
    rng = np.random.default_rng(11)
    x = rng.standard_normal((q, s)) + 1j * rng.standard_normal((q, s))
    masks = np.zeros((q, n), bool)
    for row in masks:
        row[rng.choice(n, size=m + int(rng.integers(0, n - m + 1)),
                       replace=False)] = True
    b = tplan.worker_compute(tplan.encode(torch.as_tensor(x)))
    jb = np.asarray(jplan.worker_compute(jplan.encode(jnp.asarray(x))))
    assert _rel(b.numpy(), jb) < tol
    # stragglers outside each request's first-m responders hold NaN
    poisoned = b.clone()
    for i, row in enumerate(masks):
        keep = np.flatnonzero(row)[:m]
        drop = np.setdiff1d(np.arange(n), keep)
        poisoned[i, torch.as_tensor(drop)] = float("nan")
    got = tplan.decode(poisoned, mask=torch.as_tensor(masks)).numpy()
    jgot = np.asarray(jplan.decode(jnp.asarray(poisoned.numpy()),
                                   mask=jnp.asarray(masks)))
    want = np.fft.fft(x, axis=-1)
    assert np.isfinite(got).all()
    assert _rel(got, want) < tol and _rel(got, jgot) < tol
    # shared subset and the one-call run agree too
    subset = torch.as_tensor(np.flatnonzero(masks[0])[:m])
    assert _rel(tplan.run(torch.as_tensor(x), subset=subset).numpy(),
                want) < tol
    assert _rel(tplan.decode(b[0], mask=torch.as_tensor(masks[0])).numpy(),
                want[0]) < tol


def test_kernel_backend_plan_raises_until_ported():
    """The plan's kernel backend runs (encode, four-step worker, decode
    apply), and what used to raise here -- the transform decode and the
    streaming four-step -- now runs and matches numpy."""
    plan = CodedFFT(s=64, m=4, n_workers=8, device="cpu")
    assert plan.resolved_backend == "kernel"
    x = _requests([64], seed=4)[0]
    want = np.fft.fft(x.astype(np.complex128))
    got = plan.run(torch.as_tensor(x)).numpy()
    assert _rel(got, want) < 5e-4
    b = plan.worker_compute(plan.encode(torch.as_tensor(x)))
    assert _rel(plan.decode(b, method="ifft").numpy(), want) < 5e-4
    xs = np.stack(_requests([64, 64], seed=5))
    outr, outi = tops.fourstep_planar(
        torch.as_tensor(xs.real.copy()), torch.as_tensor(xs.imag.copy()),
        variant="streaming")
    assert _rel((outr + 1j * outi).numpy(),
                np.fft.fft(xs.astype(np.complex128), axis=-1)) < 5e-4
    assert CodedFFT(s=64, m=4, n_workers=8, dtype=torch.complex128,
                    device="cpu").resolved_backend == "reference"


def test_import_loads_neither_jax_nor_reference():
    code = ("import sys, repro_torch, repro_torch.convert, "
            "repro_torch.serving, repro_torch.kernels.ops, "
            "repro_torch.core.rfft, repro_torch.core.rfftn, "
            "repro_torch.core.multi_input, repro_torch.distributed, "
            "repro_torch.distributed.coded_runtime, "
            "repro_torch.distributed.sharding, "
            "repro_torch.distributed.mesh, repro_torch.distributed.elastic; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m == 'repro' or m.startswith('repro.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_refuse_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FFTService(FFTServiceConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CodedFFT(s=64, m=4, n_workers=8)
    assert FFTService(FFTServiceConfig(), device="cpu").device == CPU


@pytest.mark.parametrize("kwargs", [
    {"precision": "bf16"},
    {"strategy": "partial"},
    {"strategy": "comm_efficient"},
    {"strategy": "repetition"},
    {"precision": "bf16", "verify": "detect"},
    {"strategy": "partial", "measured": True},
])
def test_unserved_configs_raise(jref, private_autotune_table, kwargs):  # noqa: F811
    """Every configuration here does what the reference does.  bf16
    planes, alone and beside the fault runtime's ``verify``, build and
    serve c2c as a same-seed JAX service does, within ``ops.BF16_RTOL``
    of numpy and of the reference's values (tests/test_torch_bf16.py
    holds the rest).  The strategy zoo: ``partial`` and
    ``comm_efficient`` build and serve c2c as a same-seed JAX service
    does (tests/test_torch_strategy_service.py holds the rest), and
    ``repetition`` and ``partial`` with ``measured`` raise the reference's
    ValueError."""
    _, _, JService, JConfig = jref
    tol = tops.BF16_RTOL if "precision" in kwargs else 5e-4
    cfg = dict(s=256, m=2, n_workers=8, seed=4, autotune=False, **kwargs)
    try:
        jsvc = JService(JConfig(**cfg))
    except ValueError as err:
        with pytest.raises(ValueError) as ours:
            FFTService(FFTServiceConfig(**cfg), device="cpu")
        assert str(ours.value) == str(err)
        return
    tsvc = FFTService(FFTServiceConfig(**cfg), device="cpu")
    xs = _requests([256, 256, 256], seed=5)
    for t, j, x in zip(tsvc.submit_batch(xs), jsvc.submit_batch(xs), xs):
        want = np.fft.fft(x.astype(np.complex128))
        assert _rel(t, want) < tol and _rel(t, np.asarray(j)) < tol
    assert tsvc.stats.coded_latency == jsvc.stats.coded_latency
    assert tsvc.rng.bit_generator.state == jsvc.rng.bit_generator.state


def test_unserved_kinds_and_runtimes_raise(tmp_path):
    """A mesh, and moving state across meshes, are served now (the
    multi-device runtime: tests/test_torch_coded_runtime.py holds them
    against the JAX package): in a world of one, a ``mesh=`` service
    answers through ``DistributedCodedPlan`` and ``reshard`` /
    ``reshard_like`` place a tree on the mesh, value for value."""
    from torch_mesh_worker import world_of_one

    from repro_torch.distributed import reshard, reshard_like, test_mesh

    with world_of_one(tmp_path / "pg"):
        mesh = test_mesh((1,), ("workers",))
        svc = FFTService(FFTServiceConfig(s=64, m=4, n_workers=8,
                                          autotune=False), device="cpu",
                         mesh=mesh)
        xs = _requests([64, 64], seed=3)
        for x, y in zip(xs, svc.submit_batch(xs)):
            assert _rel(y, np.fft.fft(x.astype(np.complex128))) < 5e-4
        assert svc.runtime.last_collectives[0]["kind"] == "all_gather"
        tree = {"w": torch.arange(8.0).reshape(4, 2), "b": [torch.ones(3)]}
        placed = reshard(tree, mesh, {"w": ("workers", None), "b": [()]})
        again = reshard_like(placed, mesh)
        for got in (placed, again):
            assert torch.equal(got["w"].to_local(), tree["w"])
            assert torch.equal(got["b"][0].to_local(), tree["b"][0])
        assert again["w"].placements[0].is_shard()


def test_config_from_reference(jref):
    _, _, _, JConfig = jref
    jcfg = JConfig(s=512, m=2, n_workers=5, seed=9, max_batch=16,
                   autotune=False, device_decode=False, decode_cache_size=7)
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    assert (cfg.s, cfg.m, cfg.n_workers, cfg.seed, cfg.max_batch) == \
        (512, 2, 5, 9, 16)
    assert (cfg.device_decode, cfg.decode_cache_size) == (False, 7)
    assert config_from_reference(dataclasses.asdict(
        JConfig())).decode_cache_size == JConfig().decode_cache_size == 512
    assert cfg.dtype == torch.complex64
    assert cfg.straggler.wire_frac == jcfg.straggler.wire_frac
    # the strategy knobs map as they are
    assert config_from_reference(dataclasses.asdict(JConfig(
        strategy="partial", strategy_param=3))).strategy_param == 3
    # the fault runtime's fields map as they are
    assert config_from_reference(dataclasses.asdict(
        JConfig(max_retries=5, on_failure="degrade"))).max_retries == 5


WARMUP_CASES = {
    "c2c_m_does_not_divide": dict(lengths=[258], kinds=("c2c",)),
    "c2r_2m_does_not_divide": dict(lengths=[258], kinds=("c2r",)),
    "r2c_2m_does_not_divide": dict(lengths=[252], kinds=("r2c",)),
    "unknown_kind": dict(kinds=("bogus",)),
    "tuple_with_1d_kind": dict(lengths=[(16, 16)], kinds=("c2c",)),
    "scalar_with_nd_kind": dict(lengths=[256], kinds=("rfftn",)),
}


def _outcome(call):
    """``("ok", value)`` or ``(exception type name, message)``."""
    try:
        return "ok", call()
    except Exception as err:            # noqa: BLE001 -- compared below
        return type(err).__name__, str(err)


@pytest.mark.parametrize("autotune_on", [False, True])
@pytest.mark.parametrize("case", sorted(WARMUP_CASES))
def test_warmup_validates_as_reference(jref, private_autotune_table, case,
                                       autotune_on):
    """``warmup`` on the reference and its port twin: the same exception
    type and message, or the same count, with ``autotune`` off and on --
    and no search runs or table entry is written for the invalid pairs."""
    from repro_torch.kernels import autotune

    _, _, JService, JConfig = jref
    kw = dict(WARMUP_CASES[case], buckets=[1])
    jsvc = JService(JConfig(s=256, m=4, n_workers=8, seed=2,
                            autotune=autotune_on))
    tsvc = _port_twin(jsvc)
    searches = autotune.searches_run()
    want = _outcome(lambda: jsvc.warmup(**kw))
    got = _outcome(lambda: tsvc.warmup(**kw))
    assert got == want
    assert got[0] != "ok" or got[1] == 0
    assert autotune.searches_run() == searches
    assert autotune.load_table() == {}
    assert not list(private_autotune_table.glob("**/*.json"))
    assert tsvc._runners == {}


@pytest.mark.parametrize("kind,n", [("c2r", 131), ("r2c", 260)])
def test_real_kind_length_error_after_draws_as_reference(jref, kind, n):
    """A real-kind request with 2m not dividing s, behind a c2c request in
    one call: both services raise the plan's error after the draws of
    both buckets, so ``requests``, ``batches`` and ``coded_latency`` stay
    equal -- then and after a following call of four c2c requests."""
    _, _, JService, JConfig = jref
    jsvc = JService(JConfig(s=256, m=4, n_workers=8, seed=2,
                            autotune=False))
    tsvc = _port_twin(jsvc)
    rng = np.random.default_rng(0)
    x0 = _requests([256], seed=5)[0]
    x1 = (_requests([n], seed=6)[0] if kind == "c2r"
          else rng.standard_normal(n).astype(np.float32))
    for svc in (jsvc, tsvc):
        with pytest.raises(ValueError, match=r"2m \| s"):
            svc.submit_batch([x0, x1], ["c2c", kind])

    def stats(svc):
        return (svc.stats.requests, svc.stats.batches,
                svc.stats.coded_latency)

    assert stats(tsvc) == stats(jsvc)
    assert jsvc.stats.requests == 2
    xs = _requests([256] * 4, seed=7)
    for j, t in zip(jsvc.submit_batch(xs), tsvc.submit_batch(xs)):
        assert _rel(t, np.asarray(j)) < 3e-4
    assert stats(tsvc) == stats(jsvc)


def test_warmup_and_submit_one():
    svc = FFTService(FFTServiceConfig(s=128, m=4, n_workers=8, max_batch=4),
                     device="cpu")
    assert svc.warmup() == 3                 # buckets 1, 2, 4
    x = _requests([128], seed=2)[0]
    assert _rel(svc.submit(x), np.fft.fft(x.astype(np.complex128))) < 3e-4


def test_batching_helpers_match_reference(jref):
    from repro.serving import batching as jb
    from repro_torch.serving import batching as tb

    for n, cap in [(1, 64), (3, 64), (64, 64), (65, 64), (17, 16)]:
        assert tb.bucket_size(n, cap) == jb.bucket_size(n, cap)
    assert tb.pad_requests([1, 2], 4, lambda: 0) == \
        jb.pad_requests([1, 2], 4, lambda: 0)
    with pytest.raises(ValueError):
        tb.pad_requests([1, 2, 3], 2, lambda: 0)
    rng = np.random.default_rng(0)
    th, jh = tb.LatencyHistogram(), jb.LatencyHistogram()
    for v in np.concatenate([rng.exponential(1e-3, 500), [0.0, 5e3]]):
        th.record(v)
        jh.record(v)
    assert th.summary() == jh.summary()
    for q in (1.0, 50.0, 99.0, 100.0):
        assert th.percentile(q) == jh.percentile(q)


def test_straggler_model_matches_reference(jref):
    from repro.distributed import straggler as js
    from repro_torch.distributed import straggler as ts

    tm = ts.StragglerModel(t0=0.5, mu=2.0, wire_frac=0.4)
    jm = js.StragglerModel(t0=0.5, mu=2.0, wire_frac=0.4)
    for scale in (1.0, 0.5):
        draw_t = tm.sample((4, 8), 0.25, np.random.default_rng(3),
                           payload_scale=scale)
        draw_j = jm.sample((4, 8), 0.25, np.random.default_rng(3),
                           payload_scale=scale)
        np.testing.assert_array_equal(draw_t, draw_j)
        assert tm.expected_kth(8, 4, 0.25, scale) == \
            jm.expected_kth(8, 4, 0.25, scale)
    assert ts.harmonic(7) == js.harmonic(7)
    assert ts.empirical_completion(draw_t[0], 3) == \
        js.empirical_completion(draw_j[0], 3)
    assert ts.expected_kth_completion(1.0, 1.0, 4, 5, 1.0) == float("inf")
