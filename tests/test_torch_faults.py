"""The port's fault runtime against the JAX package's, same seeds.

* fault plans and the injector: the same schedules, projections, latency
  perturbations and corrupted arrays, bit for bit;
* the health tracker: the same estimates, deadlines, masks, calibration
  and summary for the same observations;
* ``robust_decode`` / ``correct_errors`` on the port's plans;
* the service's fault path (``faults``, ``health``, ``verify``,
  ``on_failure``, a ``pool=``): each reference test of
  ``tests/test_faults.py`` ported, and held to a same-seed reference
  service -- the masks of every round, ``retries``,
  ``redispatched_shards``, ``degraded``, ``coded_latency``,
  ``stragglers_tolerated``, the reasons and the decoded values;
* the parity points of the port: the draw order, the instrumented
  path's kernel-backend plan, the N-keyed caches after an elastic
  ``join`` (and a grown code the stage kernels cannot carry, refused
  before its draw), and the complex64 clean-round syndrome;
* the measured thread-per-worker runtime, whose outcomes here depend on
  no host load: kill faults decide who responds, and where a test needs
  a round to succeed its retry ladder reaches seconds;
* ``gpu``-marked: the kernels each new path launches on the card.
"""

import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
import torch
from test_torch_kernels import private_autotune_table  # noqa: F401

from repro_torch.convert import config_from_reference, generator_from_reference
from repro_torch.core import CodedFFT, mds
from repro_torch.core.fault_tolerance import (
    correct_errors,
    detect_errors,
    robust_decode,
    syndromes,
)
from repro_torch.distributed import (
    ElasticWorkerPool,
    FaultInjector,
    FaultPlan,
    MeasuredWorkerRuntime,
    StragglerModel,
    WorkerHealthTracker,
)
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.serving import (
    FAILURE_REASONS,
    DegradedResult,
    FFTService,
    FFTServiceConfig,
    ServiceError,
)

CPU = torch.device("cpu")
# A near-deterministic straggler model: every worker completes in ~t0 *
# workload, so deadline-derived masks admit the whole fleet and k > m
# surplus (the Byzantine verifier's precondition) holds by construction.
_TIGHT = StragglerModel(t0=1.0, mu=1e6)
# the measured runtime's retry ladder where a test needs its round to
# succeed: windows of 2 ms * 2^10 reach seconds, so a busy host delays
# the round but does not fail it
_PATIENT = 10


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
    from repro import distributed as jdist
    from repro import serving as jserving
    from repro.core import CodedFFT as JCodedFFT
    from repro.core import fault_tolerance as jft
    from repro.core import mds as jmds

    return dict(jnp=jnp, dist=jdist, serving=jserving, CodedFFT=JCodedFFT,
                ft=jft, mds=jmds)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg(**kw):
    kw.setdefault("s", 256)
    kw.setdefault("m", 4)
    kw.setdefault("n_workers", 8)
    kw.setdefault("seed", 0)
    kw.setdefault("autotune", False)
    return FFTServiceConfig(**kw)


def _x(s=256, seed=0, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=s) + 1j * rng.normal(size=s)).astype(dtype)


def _jplan(jd, plan: FaultPlan):
    """The JAX package's FaultPlan with the same faults and seed."""
    JF = jd.FaultPlan
    return JF(tuple(jd.WorkerFault(f.worker, f.kind, f.start_round,
                                   f.rounds, f.delay_s)
                    for f in plan.faults), plan.seed)


def _twins(jref, pool=None, jpool=None, **kw):
    """A reference service and the port's (CPU) with the same config,
    seed and generator."""
    jd, js = jref["dist"], jref["serving"]
    faults = kw.pop("faults", None)
    straggler = kw.pop("straggler", None)
    dtype = kw.pop("dtype", np.complex64)
    jkw = dict(kw)
    jkw.setdefault("s", 256)
    jkw.setdefault("m", 4)
    jkw.setdefault("n_workers", 8)
    jkw.setdefault("seed", 0)
    jkw.setdefault("autotune", False)
    if faults is not None:
        jkw["faults"] = _jplan(jd, faults)
    if straggler is not None:
        jkw["straggler"] = jd.StragglerModel(straggler.t0, straggler.mu,
                                             straggler.wire_frac)
    jkw["dtype"] = jref["jnp"].dtype(dtype)
    jsvc = js.FFTService(js.FFTServiceConfig(**jkw), pool=jpool)
    cfg = config_from_reference(
        {f.name: getattr(jsvc.cfg, f.name)
         for f in dataclasses.fields(jsvc.cfg)})
    tsvc = FFTService(cfg, device="cpu", pool=pool)
    if tsvc._kernel_path(cfg.s, "c2c"):
        tsvc.load_generator(*generator_from_reference(
            np.asarray(jsvc.plan.generator), CPU))
    return jsvc, tsvc


_PARITY_FIELDS = ("requests", "batches", "coded_latency", "uncoded_latency",
                  "stragglers_tolerated", "retries", "redispatched_shards",
                  "degraded", "detected", "corrected", "host_transfers")


def _assert_same_stats(tsvc, jsvc):
    for name in _PARITY_FIELDS:
        assert getattr(tsvc.stats, name) == getattr(jsvc.stats, name), name
    if jsvc.health is not None:
        assert tsvc.health.summary() == jsvc.health.summary()


def _same_slot(t, j, tol):
    """Equal slot values: the same DegradedResult, or outputs within
    ``tol`` of each other (relative to the reference's largest)."""
    if hasattr(j, "reason"):                     # the reference's slot
        assert isinstance(t, DegradedResult)
        assert (t.reason, t.detail) == (j.reason, j.detail)
        return
    j = np.asarray(j)
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= tol * max(np.abs(j).max(), 1.0)


# ------------------------------------------------------------- fault plans
def test_fault_plan_builders_and_projection(jref):
    plan = (FaultPlan(seed=5)
            .kill(0, start_round=2, rounds=3)
            .delay(3, 0.25, rounds=2)
            .corrupt(1, start_round=1, rounds=10))
    r0 = plan.faults_for(0)
    assert r0.killed == frozenset() and dict(r0.delays) == {3: 0.25}
    r2 = plan.faults_for(2)
    assert r2.killed == {0} and r2.corrupt == {1} and not r2.delays
    assert plan.faults_for(99).any is False
    assert plan.horizon == 11
    # immutability: builders return NEW plans
    assert len(FaultPlan().faults) == 0
    jplan = _jplan(jref["dist"], plan)
    for r in range(14):
        t, j = plan.faults_for(r), jplan.faults_for(r)
        assert (t.killed, t.delays, t.corrupt, t.any) == \
            (j.killed, j.delays, j.corrupt, j.any)
    assert plan.horizon == jplan.horizon
    with pytest.raises(ValueError):
        FaultPlan.single(0, "explode")


def test_fault_plan_random_is_seeded_and_rate_scaled(jref):
    a = FaultPlan.random(8, 1 / 8, horizon=64, seed=3)
    b = FaultPlan.random(8, 1 / 8, horizon=64, seed=3)
    assert a == b                               # bit-identical schedules
    assert FaultPlan.random(8, 0.0, seed=1).faults == ()
    dense = FaultPlan.random(8, 1.0, horizon=4, kinds=("kill",), seed=0)
    assert len(dense.faults) == 32              # every (round, worker) hit
    # rate=1/N means ~one faulty worker per round on average
    avg = len(a.faults) / 64
    assert 0.3 <= avg <= 2.5
    # the reference draws the same schedule from the same seed
    for seed, rate in ((3, 1 / 8), (20, 0.25)):
        t = FaultPlan.random(8, rate, horizon=256, seed=seed)
        j = jref["dist"].FaultPlan.random(8, rate, horizon=256, seed=seed)
        assert [dataclasses.astuple(f) for f in t.faults] == \
            [dataclasses.astuple(f) for f in j.faults]


def test_injector_corruption_is_seeded_and_axis_aware(jref):
    plan = FaultPlan(seed=9).corrupt(2)
    inj = FaultInjector(plan)
    b = (np.arange(2 * 8 * 4) + 1j).reshape(2, 8, 4).astype(np.complex128)
    c1 = inj.corrupt_array(b, [2], 0, worker_axis=1)
    c2 = inj.corrupt_array(b, [2], 0, worker_axis=1)
    np.testing.assert_array_equal(c1, c2)       # keyed by (seed, round, w)
    c3 = inj.corrupt_array(b, [2], 1, worker_axis=1)
    assert not np.array_equal(c1[:, 2], c3[:, 2])   # distinct per round
    # only the targeted worker row changes, and changes BIG (Byzantine,
    # not noise)
    clean = np.delete(c1, 2, axis=1)
    np.testing.assert_array_equal(clean, np.delete(b, 2, axis=1))
    assert np.abs(c1[:, 2] - b[:, 2]).max() > np.abs(b).max()
    # the caller's buffer is never corrupted in place
    assert b[0, 2, 0] == np.arange(2 * 8 * 4).reshape(2, 8, 4)[0, 2, 0] + 1j
    # the reference's injector writes the same garbage, bit for bit, at
    # complex128 and complex64, on any axis
    jinj = jref["dist"].FaultInjector(_jplan(jref["dist"], plan))
    for dt in (np.complex128, np.complex64):
        bb = b.astype(dt)
        for axis, workers, r in ((1, [2], 0), (1, [0, 2, 7], 3),
                                 (-2, [1], 5), (0, [1], 2)):
            np.testing.assert_array_equal(
                inj.corrupt_array(bb, workers, r, worker_axis=axis),
                jinj.corrupt_array(bb, workers, r, worker_axis=axis))
    np.testing.assert_array_equal(inj.corrupt_flags(8, 0),
                                  jinj.corrupt_flags(8, 0))


def test_injector_latency_perturbation(jref):
    plan = FaultPlan().kill(1).delay(4, 0.5)
    inj = FaultInjector(plan)
    lat = np.full((3, 8), 1.0)
    out = inj.perturb_latencies(lat, 0)
    assert np.isinf(out[:, 1]).all()
    np.testing.assert_allclose(out[:, 4], 1.5)
    np.testing.assert_allclose(out[:, 0], 1.0)
    # no active faults -> identity (same object allowed)
    np.testing.assert_array_equal(inj.perturb_latencies(lat, 50), lat)
    jinj = jref["dist"].FaultInjector(_jplan(jref["dist"], plan))
    lat = np.random.default_rng(0).exponential(size=(5, 8))
    np.testing.assert_array_equal(inj.perturb_latencies(lat, 0),
                                  jinj.perturb_latencies(lat, 0))


# ------------------------------------------------------- health + deadlines
def test_health_tracker_deadline_and_dead_worker_estimates(jref):
    h = WorkerHealthTracker(4, slack_frac=0.5)
    jh = jref["dist"].WorkerHealthTracker(4, slack_frac=0.5)
    for tr in (h, jh):
        tr.observe_round([0.1, 0.2, 0.3, np.inf])
        tr.observe_round([0.1, 0.2, 0.3, np.inf])
    est = h.estimates()
    np.testing.assert_allclose(est[:3], [0.1, 0.2, 0.3])
    # a slot that has only ever missed must NOT keep the fast prior: it
    # would drag the deadline below what live workers can meet
    assert np.isinf(est[3])
    assert h.deadline(2) == pytest.approx(0.2 * 1.5)
    assert h.deadline(4) == np.inf              # 4th fastest is the dead one
    assert np.isinf(h.deadline(2, alive=np.array([True, False, False, False])))
    times = np.array([0.1, 0.4, np.inf, np.nan])
    mask = h.mask_from_times(times, 0.31)
    np.testing.assert_array_equal(mask, [True, False, False, False])
    np.testing.assert_array_equal(est, jh.estimates())
    for m in (1, 2, 3, 4):
        assert h.deadline(m) == jh.deadline(m)
    np.testing.assert_array_equal(mask, jh.mask_from_times(times, 0.31))
    assert h.summary() == jh.summary()


def test_health_tracker_calibration_recovers_straggler_model(jref):
    true = StragglerModel(t0=0.8, mu=2.5)
    rng = np.random.default_rng(0)
    h = WorkerHealthTracker(8)
    jh = jref["dist"].WorkerHealthTracker(8)
    w = 0.25
    for _ in range(400):
        lat = true.sample(8, w, rng)
        h.observe_round(lat)
        jh.observe_round(lat)
    fit = h.calibrate(workload=w)
    assert fit.t0 == pytest.approx(true.t0, rel=0.05)
    assert fit.mu == pytest.approx(true.mu, rel=0.2)
    jfit = jh.calibrate(workload=w)
    assert (fit.t0, fit.mu, fit.wire_frac) == \
        (jfit.t0, jfit.mu, jfit.wire_frac)
    with pytest.raises(ValueError):
        WorkerHealthTracker(2).calibrate()


def test_health_tracker_byzantine_flags_and_grow(jref):
    h = WorkerHealthTracker(4)
    jh = jref["dist"].WorkerHealthTracker(4)
    for tr in (h, jh):
        tr.observe_round([0.1, 0.2, 0.3, 0.4])
        tr.flag_byzantine(2)
    assert h.byzantine.tolist() == [False, False, True, False]
    for tr in (h, jh):
        tr.grow(6)
    assert h.n_workers == 6 and h.byzantine.shape == (6,)
    np.testing.assert_allclose(h.estimates()[:4], [0.1, 0.2, 0.3, 0.4])
    assert h.summary() == jh.summary()
    h.clear_byzantine(2)
    assert not h.byzantine.any()


# ---------------------------------------------------- robust decode satellite
def _ref_plan(s=64, m=4, n=8):
    return CodedFFT(s=s, m=m, n_workers=n, dtype=torch.complex128,
                    backend="reference", device="cpu")


def _rows(plan, x):
    return plan.worker_compute(plan.encode(torch.as_tensor(x))).numpy()


def test_correct_errors_returns_indices_single_prony_pass(jref):
    plan = _ref_plan()
    x = _x(64, 3, np.complex128)
    b = _rows(plan, x)
    nodes = mds.rs_nodes(8, torch.complex128).numpy()
    bad = b.copy()
    bad[5] += 11.0 - 3j
    out = correct_errors(nodes, bad, 4)
    assert out is not None
    corrected, idx = out
    assert idx.tolist() == [5]
    np.testing.assert_allclose(corrected, b, atol=1e-8)
    # clean rows: empty index vector, rows returned as-is
    _, idx0 = correct_errors(nodes, b, 4)
    assert idx0.shape == (0,)
    # the reference corrects the same rows to the same values
    jout = jref["ft"].correct_errors(nodes, bad, 4)
    assert jout[1].tolist() == [5]
    np.testing.assert_allclose(corrected, jout[0], atol=1e-12)


def test_robust_decode_nd_shards_and_bit_consistency(jref):
    """robust_decode accepts (N, *shard) rows and its corrected output is
    BIT-IDENTICAL to the clean decode over the same clean subset (the
    corrupted rows never enter the final decode)."""
    plan = _ref_plan()
    x = _x(64, 4, np.complex128)
    b = _rows(plan, x)
    inj = FaultInjector(FaultPlan(seed=1).corrupt(1).corrupt(6))
    bad = inj.corrupt_array(b[None], [1, 6], 0, worker_axis=1)[0]
    recv = np.arange(8)                         # k=8: correct up to 2
    res = robust_decode(plan, bad, recv)
    assert res.ok and res.n_errors_corrected == 2
    assert sorted(res.error_worker_indices.tolist()) == [1, 6]
    clean_subset = torch.as_tensor([0, 2, 3, 4])   # first m clean rows
    want = plan.decode(torch.as_tensor(b), subset=clean_subset).numpy()
    np.testing.assert_array_equal(res.output, want)   # bitwise
    # the same output from a tensor of rows
    np.testing.assert_array_equal(
        robust_decode(plan, torch.as_tensor(bad), recv).output, want)
    # 3 corrupt > floor((8-4)/2): uncorrectable, typed not-ok
    bad3 = inj.corrupt_array(b[None], [1, 3, 6], 0, worker_axis=1)[0]
    bad3[3] += 17.0
    assert not robust_decode(plan, bad3, recv).ok
    # against the reference on the same corrupted rows
    jplan = jref["CodedFFT"](s=64, m=4, n_workers=8,
                             dtype=jref["jnp"].complex128,
                             backend="reference")
    jres = jref["ft"].robust_decode(jplan, bad, recv)
    assert jres.error_worker_indices.tolist() == \
        res.error_worker_indices.tolist()
    np.testing.assert_allclose(res.output, np.asarray(jres.output),
                               atol=1e-9)


# ------------------------------------------------------- service fault path
def test_service_deadline_masks_serve_correctly_without_faults(jref):
    jsvc, svc = _twins(jref, health=True)
    for seed in range(4):
        xi = _x(seed=seed)
        y = svc.submit(xi)
        assert np.abs(y - np.fft.fft(xi)).max() < 1e-2
        _same_slot(y, jsvc.submit(xi), 3e-4)
    assert svc.stats.requests == 4 and svc.stats.degraded == 0
    assert svc.health.rounds == 4
    # measured-timings calibration is reachable from the service tracker
    fit = svc.health.calibrate(workload=1 / 4)
    assert fit.t0 > 0 and fit.mu > 0
    _assert_same_stats(svc, jsvc)


def test_service_kill_faults_recover_with_retry_and_redispatch(jref):
    plan = FaultPlan().kill(0, rounds=999).kill(1, rounds=999)
    jsvc, svc = _twins(jref, faults=plan, on_failure="degrade")
    for seed in range(10):
        xi = _x(seed=seed)
        y = svc.submit(xi)
        assert isinstance(y, np.ndarray)
        assert np.abs(y - np.fft.fft(xi)).max() < 1e-2
        _same_slot(y, jsvc.submit(xi), 3e-4)
    assert svc.stats.degraded == 0
    s = svc.stats.summary()
    assert s["retries"] >= 0 and s["redispatched_shards"] >= 0
    _assert_same_stats(svc, jsvc)


def test_service_insufficient_workers_typed_error_and_degrade(jref):
    pool = ElasticWorkerPool(8, 4)
    jpool = jref["dist"].ElasticWorkerPool(8, 4)
    for w in range(5):
        pool.leave(w)
        jpool.leave(w)
    jsvc, svc = _twins(jref, pool=pool, jpool=jpool, on_failure="degrade")
    r = svc.submit(_x())
    assert isinstance(r, DegradedResult)
    assert r.reason == "insufficient_workers" and not r.ok
    assert svc.stats.degraded == 1
    _same_slot(r, jsvc.submit(_x()), 0)
    _assert_same_stats(svc, jsvc)
    # on_failure="raise" surfaces the same reason as an exception
    svc2 = FFTService(_cfg(), device="cpu", pool=pool)
    with pytest.raises(ServiceError) as ei:
        svc2.submit(_x())
    assert ei.value.reason == "insufficient_workers"
    assert ei.value.reason in FAILURE_REASONS
    with pytest.raises(ValueError):
        FFTService(_cfg(m=2), device="cpu", pool=pool)   # pool m != cfg m


def test_service_retries_exhausted_typed_error(jref):
    plan = FaultPlan()
    for w in range(5):
        plan = plan.kill(w, rounds=999)
    jsvc, svc = _twins(jref, faults=plan, max_retries=0,
                       on_failure="degrade")
    r = svc.submit(_x())
    assert isinstance(r, DegradedResult) and r.reason == "retries_exhausted"
    _same_slot(r, jsvc.submit(_x()), 0)
    _assert_same_stats(svc, jsvc)


def test_service_verify_detect_catches_corruption(jref):
    plan = FaultPlan(seed=2).corrupt(3, rounds=999)
    jsvc, svc = _twins(jref, straggler=_TIGHT, faults=plan, verify="detect",
                       on_failure="degrade")
    r = svc.submit(_x())
    assert isinstance(r, DegradedResult)
    assert r.reason == "corrupt_uncorrectable"
    assert svc.stats.detected >= 1 and svc.stats.corrected == 0
    _same_slot(r, jsvc.submit(_x()), 0)
    _assert_same_stats(svc, jsvc)


def test_service_verify_off_corruption_poisons_output(jref):
    """The negative control: without verification a Byzantine worker's
    rows reach the decode and the output is visibly wrong."""
    plan = FaultPlan(seed=2).corrupt(0, rounds=999)   # worker 0: always in
    #                                                   the first-m subset
    jsvc, svc = _twins(jref, straggler=_TIGHT, faults=plan, verify="off",
                       on_failure="degrade", dtype=np.complex128,
                       use_reference=True)
    x = _x(dtype=np.complex128)
    y = svc.submit(x)
    assert np.abs(y - np.fft.fft(x)).max() > 1.0
    # the same garbage lands in the same rows: the same wrong output
    _same_slot(y, jsvc.submit(x), 1e-9)


def test_service_verify_correct_bit_consistent_at_capacity(jref):
    """verify="correct" recovers the transform with floor((k - m)/2) = 2
    corrupt workers out of k = 8 responders, over ADVERSARIAL patterns:
    the corrupt pair rotates every round."""
    plan = FaultPlan(seed=4)
    pairs = [(0, 1), (2, 5), (6, 7), (3, 4)]
    for r, (a, b) in enumerate(pairs):
        plan = plan.corrupt(a, start_round=r).corrupt(b, start_round=r)
    jsvc, svc = _twins(jref, straggler=_TIGHT, faults=plan,
                       verify="correct", dtype=np.complex128,
                       use_reference=True)
    for r in range(len(pairs)):
        x = _x(seed=10 + r, dtype=np.complex128)
        y = svc.submit(x)
        np.testing.assert_allclose(y, np.fft.fft(x), atol=1e-8)
        _same_slot(y, jsvc.submit(x), 1e-12)
    assert svc.stats.corrected == 2 * len(pairs)
    assert svc.stats.detected == svc.stats.corrected
    assert svc.stats.degraded == 0
    # offenders are flagged into the health tracker
    assert set(svc.health.summary()["byzantine"]) == {0, 1, 2, 3, 4, 5, 6, 7}
    _assert_same_stats(svc, jsvc)


def test_service_verify_correct_overwhelmed_fails_typed(jref):
    plan = FaultPlan(seed=6)
    for w in (1, 4, 7):                          # 3 > floor((8-4)/2)
        plan = plan.corrupt(w, rounds=999)
    jsvc, svc = _twins(jref, straggler=_TIGHT, faults=plan,
                       verify="correct", on_failure="degrade",
                       dtype=np.complex128, use_reference=True)
    r = svc.submit(_x(dtype=np.complex128))
    assert isinstance(r, DegradedResult)
    assert r.reason == "corrupt_uncorrectable"
    _same_slot(r, jsvc.submit(_x(dtype=np.complex128)), 0)
    _assert_same_stats(svc, jsvc)


def test_service_verify_correct_complex64_kernel_plan(jref):
    """verify="correct" at complex64 on the default (kernel) config: the
    instrumented path corrects 2 of 8 at the reference's complex64
    tolerance and flags the same offenders as a same-seed reference."""
    plan = FaultPlan(seed=4).corrupt(2, rounds=9).corrupt(5, rounds=9)
    jsvc, svc = _twins(jref, straggler=_TIGHT, faults=plan,
                       verify="correct")
    xs = [_x(seed=30 + i) for i in range(3)]
    out, jout = svc.submit_batch(xs), jsvc.submit_batch(xs)
    for x, y, j in zip(xs, out, jout):
        assert np.abs(y - np.fft.fft(x)).max() < 1e-2
        _same_slot(y, j, 3e-4)
    assert svc.stats.corrected == 6
    _assert_same_stats(svc, jsvc)


# ----------------------------------------------------------- elastic pool
def test_elastic_pool_membership_invariants(jref):
    pool = ElasticWorkerPool(8, m=4)
    jpool = jref["dist"].ElasticWorkerPool(8, m=4)
    assert pool.capacity == 8 and pool.n_live == 8 and pool.can_decode()
    pool.leave(3)
    pool.leave(3)                                # idempotent
    assert pool.n_live == 7 and pool.version == 1
    assert not pool.is_live(3) and pool.capacity == 8
    # join refills the LOWEST departed slot: same RS node, same capacity
    pool.leave(1)
    assert pool.join() == 1
    assert pool.capacity == 8
    # no departed slot left after refilling 3: join GROWS the code
    assert pool.join() == 3
    assert pool.join() == 8 and pool.capacity == 9
    assert pool.summary()["n_live"] == 9
    with pytest.raises(ValueError):
        ElasticWorkerPool(3, m=4)
    with pytest.raises(IndexError):
        pool.leave(99)
    for p in (jpool,):
        p.leave(3)
        p.leave(3)
        p.leave(1)
        p.join()
        p.join()
        p.join()
    assert pool.summary() == jpool.summary()
    np.testing.assert_array_equal(pool.mask(), jpool.mask())


def test_service_elastic_membership_live_changes(jref):
    """Workers leave/join between rounds while m stays fixed: departures
    mask rows, slot refills reuse the cached plan, capacity growth keys a
    NEW plan (roots-of-unity codes are capacity-specific)."""
    pool = ElasticWorkerPool(8, m=4)
    jpool = jref["dist"].ElasticWorkerPool(8, m=4)
    jsvc, svc = _twins(jref, pool=pool, jpool=jpool, on_failure="degrade")
    x = _x()

    def both():
        y = svc.submit(x)
        assert np.abs(y - np.fft.fft(x)).max() < 1e-2
        _same_slot(y, jsvc.submit(x), 3e-4)

    both()
    for p in (pool, jpool):
        p.leave(2)
        p.leave(5)
    both()
    n_plans = len(svc._plans)
    for p in (pool, jpool):
        p.join()                                 # refill slot 2: cache hit
    assert len(svc._plans) == n_plans
    both()
    for p in (pool, jpool):
        p.join()                                 # refill slot 5
    grown = pool.join()                          # growth: capacity 9
    jpool.join()
    assert grown == 8 and svc._n_workers() == 9
    both()
    assert len(svc._plans) > n_plans             # new capacity, new code
    assert svc.health.n_workers == 9             # tracker grew with it
    _assert_same_stats(svc, jsvc)


def test_n_keyed_caches_after_join():
    """Plans, generator planes, decode-matrix LRUs and executors are keyed
    by the live N: a growth builds the N=9 code beside the N=8 one (kept),
    ``load_generator`` checks against the live N, and both decode paths
    serve the grown code."""
    for device_decode in (True, False):
        pool = ElasticWorkerPool(8, m=4)
        svc = FFTService(_cfg(device_decode=device_decode), device="cpu",
                         pool=pool)
        x = _x(seed=7)
        svc.submit(x)
        g8 = svc.generator_planes()
        assert g8[0].shape == (8, 4)
        assert (256, "c2c", 8) in svc._plans
        pool.join()                              # capacity 9
        y = svc.submit(x)
        assert np.abs(y - np.fft.fft(x)).max() < 1e-2
        g9 = svc.generator_planes()
        assert g9[0].shape == (9, 4)
        assert set(svc._gplanes) == {8, 9}
        assert (256, "c2c", 9) in svc._plans and (256, "c2c", 8) in svc._plans
        assert {key[-1] for key in svc._runners} == {8, 9}
        want = mds.rs_generator(9, 4, torch.complex64)
        assert torch.equal(g9[0], want.real.float())
        if not device_decode:
            assert set(svc._decode_caches) == {8, 9}
        with pytest.raises(ValueError, match=r"\(9, 4\)"):
            svc.load_generator(*g8)
        svc.load_generator(*g9)                  # the live N's shape loads
        assert svc.health.n_workers == 9


def test_grown_code_past_stage_kernels_refused_before_draw():
    """A pool that grows the code past what the stage kernels carry (N*m >
    29,056 at m=64) is refused by ``bucket_key`` with
    ``ops.check_stage_code``'s text, before that bucket's draw."""
    pool = ElasticWorkerPool(454, m=64)          # 454 * 64 = 29,056
    svc = FFTService(_cfg(s=4096, m=64, n_workers=454, health=True),
                     device="cpu", pool=pool)
    assert svc._route(4096, "c2c") == "stage"
    pool.join()                                  # N = 455
    state = svc.rng.bit_generator.state
    with pytest.raises(NotImplementedError, match="Queue 2 item 7"):
        svc.submit(_x(4096))
    assert svc.rng.bit_generator.state == state
    assert svc._round == 0 and svc.stats.requests == 0


# ------------------------------------------------------------ parity points
_DRAW_CASES = {
    "kill_delay": dict(faults=FaultPlan().kill(2, rounds=3).delay(
        5, 1.5, rounds=6), health=True),
    "kill_many": dict(faults=FaultPlan().kill(0, rounds=99).kill(
        1, rounds=99).kill(6, rounds=99), max_retries=3),
    "storm": dict(faults=FaultPlan.random(8, 0.3, horizon=40,
                                          kinds=("kill", "delay"), seed=11),
                  on_failure="degrade", deadline_slack=0.1),
    "slow_tail": dict(health=True, straggler=StragglerModel(t0=1.0, mu=0.3),
                      deadline_slack=0.05, on_failure="degrade"),
}


@pytest.mark.parametrize("case", sorted(_DRAW_CASES))
def test_robust_draw_order_matches_reference(jref, case):
    """The robust path's draws -- the straggler times, the injected kills
    and delays, a fresh draw per re-dispatch round -- in the reference's
    order: round by round the same masks, reasons and completion times,
    and after a batch the same counters, across kinds."""
    kw = dict(_DRAW_CASES[case])
    jsvc, svc = _twins(jref, **kw)
    for n_live, kind in ((5, "c2c"), (1, "r2c"), (16, "c2c"), (3, "c2r"),
                         (7, "c2c"), (2, "r2c")):
        tm, te, tt, tl, trf, tr = svc._fault_arrivals(n_live, kind)
        jm, je, jt, jl, jrf, jr = jsvc._fault_arrivals(n_live, kind)
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tt, jt)
        assert tr == jr
        assert [None if e is None else (e.reason, e.detail) for e in te] \
            == [None if e is None else (e.reason, e.detail) for e in je]
    _assert_same_stats(svc, jsvc)
    rng = np.random.default_rng(3)
    xs = [(rng.normal(size=256) + 1j * rng.normal(size=256))
          .astype(np.complex64) for _ in range(11)]
    yr = [rng.normal(size=256).astype(np.float32) for _ in range(4)]
    kinds = ["c2c"] * 11 + ["r2c"] * 4
    on_failure = kw.get("on_failure", "raise")
    try:
        tout = svc.submit_batch(xs + yr, kind=kinds)
    except ServiceError as err:
        assert on_failure == "raise"
        with pytest.raises(ServiceError) as ei:
            jsvc.submit_batch(xs + yr, kind=kinds)
        assert (err.reason, err.detail) == (ei.value.reason,
                                            ei.value.detail)
    else:
        jout = jsvc.submit_batch(xs + yr, kind=kinds)
        for t, j in zip(tout, jout):
            _same_slot(t, j, 3e-4)
    _assert_same_stats(svc, jsvc)


def test_instrumented_path_uses_kernel_backend_plan(monkeypatch):
    """The verify path computes its rows with a kernel-backend plan (its
    own, beside the bucket path's reference-backend plan): the ``cmatmul``
    encode (``ops.mds_apply``), the fused four-step worker
    (``ops.fourstep_planar``) and the one-request decode on ``cmatmul``.
    The CPU twins count no launches, so the dispatch layer's calls are
    counted instead."""
    calls = {"mds_apply": 0, "fourstep": []}
    real_apply, real_fs = tops.mds_apply, tops.fourstep_planar

    def apply(g, c):
        calls["mds_apply"] += 1
        return real_apply(g, c)

    def fourstep(xr, xi, **kw):
        calls["fourstep"].append(tops.fourstep_route(xr.shape[-1], **kw))
        return real_fs(xr, xi, **kw)

    monkeypatch.setattr(tops, "mds_apply", apply)
    monkeypatch.setattr(tops, "fourstep_planar", fourstep)
    svc = FFTService(_cfg(s=4096, straggler=_TIGHT, verify="detect",
                          faults=FaultPlan(seed=1).corrupt(3, rounds=9),
                          on_failure="degrade"), device="cpu")
    assert svc._plan_for(4096, "c2c").resolved_backend == "reference"
    plan = svc._instrumented_plan(4096, "c2c")
    assert plan.resolved_backend == "kernel" and plan.n_workers == 8
    assert svc._instrumented_plan(4096, "c2c") is plan        # cached
    xs = [_x(4096, seed=i) for i in range(3)]
    out = svc.submit_batch(xs)
    assert all(isinstance(r, DegradedResult) for r in out)
    assert calls["mds_apply"] == 1                # one encode, no decode
    assert calls["fourstep"] == [("fused", (32, 32))]
    # a clean round decodes each request on cmatmul
    svc2 = FFTService(_cfg(s=4096, straggler=_TIGHT, verify="detect"),
                      device="cpu")
    calls["mds_apply"], calls["fourstep"] = 0, []
    out = svc2.submit_batch(xs)
    for x, y in zip(xs, out):
        assert np.abs(y - np.fft.fft(x)).max() < 1e-2
    assert calls["mds_apply"] == 1 + len(xs)
    assert svc2.stats.detected == 0


def test_clean_round_syndrome_complex64(jref):
    """At complex64 the largest clean-round syndrome of both packages,
    on the same inputs, sits far under ``detect_errors``'s 1e-6 of the
    largest row (so neither flags a clean round), and the port's
    verify="detect" service flags none on clean rounds."""
    jnp = jref["jnp"]
    x = np.stack([_x(4096, seed=i) for i in range(8)])
    tplan = CodedFFT(s=4096, m=4, n_workers=8, device="cpu")
    jplan = jref["CodedFFT"](s=4096, m=4, n_workers=8, dtype=jnp.complex64)
    tb = tplan.worker_compute(tplan.encode(torch.as_tensor(x))).numpy()
    jb = np.asarray(jplan.worker_compute(jplan.encode(jnp.asarray(x))))
    nodes = mds.rs_nodes(8, torch.complex128).numpy()
    jnodes = np.asarray(jref["mds"].rs_nodes(8, jnp.complex128))
    worst = {}
    for name, b, nd, syn, det in (
            ("port", tb, nodes, syndromes, detect_errors),
            ("reference", jb, jnodes, jref["ft"].syndromes,
             jref["ft"].detect_errors)):
        ratios = []
        for i in range(8):
            rows = b[i].astype(np.complex128).reshape(8, -1)
            ratios.append(np.abs(syn(nd, rows, 4)).max()
                          / max(np.abs(rows).max(), 1.0))
            assert not det(nd, rows, 4)
        worst[name] = max(ratios)
    assert max(worst.values()) < 1e-6 / 4, worst
    svc = FFTService(_cfg(s=4096, straggler=_TIGHT, verify="detect"),
                     device="cpu")
    out = svc.submit_batch(list(x))
    assert svc.stats.detected == 0 and svc.stats.degraded == 0
    for xi, y in zip(x, out):
        assert np.abs(y - np.fft.fft(xi)).max() < 1e-2


# ------------------------------------------------------- measured runtime
def test_measured_runtime_round_completes_and_decodes():
    plan = _ref_plan()
    h = WorkerHealthTracker(8)
    x = np.stack([_x(64, s, np.complex128) for s in range(3)])
    with MeasuredWorkerRuntime(plan, h, max_retries=_PATIENT) as rt:
        res = rt.round(x, 0)
    assert res.ok and res.mask.sum() >= 4
    assert np.isfinite(res.t_met) and res.t_met <= res.t_last
    for i in range(3):
        y = plan.decode(res.b[i], mask=torch.as_tensor(res.mask)).numpy()
        np.testing.assert_allclose(y, np.fft.fft(x[i]), atol=1e-8)
    assert h.rounds == 1                          # deadlines learn from it


def test_measured_runtime_kill_faults_and_insufficient():
    plan = _ref_plan()
    h = WorkerHealthTracker(8)
    inj = FaultInjector(FaultPlan().kill(0, rounds=999).kill(7, rounds=999))
    x = _x(64, 1, np.complex128)[None]
    with MeasuredWorkerRuntime(plan, h, injector=inj,
                               max_retries=_PATIENT) as rt:
        warm = rt.round(x, 0)                    # learn live-worker times
        res = rt.round(x, 1)
        for r in (warm, res):
            assert r.ok and r.mask.sum() >= 4
            if not r.redispatched:
                # only a healthy thread's re-dispatch brings a killed
                # worker's row; none ran, so rows 0 and 7 never arrived
                assert not r.mask[0] and not r.mask[7]
        y = plan.decode(res.b[0], mask=torch.as_tensor(res.mask)).numpy()
        np.testing.assert_allclose(y, np.fft.fft(x[0]), atol=1e-8)
        # fewer than m live workers: typed failure, not a hang
        alive = np.zeros(8, bool)
        alive[:3] = True
        bad = rt.round(x, 2, alive=alive)
        assert not bad.ok and bad.reason == "insufficient_workers"


def test_measured_runtime_kernel_plan_rows_on_cpu():
    """On the kernel-backend plan (complex64) the rows come from the
    plain twins of ``cmatmul`` and the four-step worker on the CPU."""
    plan = CodedFFT(s=4096, m=4, n_workers=8, device="cpu")
    h = WorkerHealthTracker(8)
    x = np.stack([_x(4096, s) for s in range(2)])
    with MeasuredWorkerRuntime(plan, h, max_retries=_PATIENT,
                               injector=FaultInjector(
                                   FaultPlan().kill(3, rounds=9))) as rt:
        res = rt.round(x, 0)
    assert res.ok and (res.redispatched or not res.mask[3])
    assert res.b.dtype == torch.complex64 and res.b.shape == (2, 8, 1024)
    for i in range(2):
        y = plan.decode(res.b[i], mask=torch.as_tensor(res.mask)).numpy()
        assert np.abs(y - np.fft.fft(x[i])).max() < 5e-4 * np.abs(
            np.fft.fft(x[i])).max()


def test_measured_runtime_raises_a_worker_failure():
    """A row whose compute raises fails the round with that exception
    instead of passing for a straggler."""
    plan = _ref_plan()

    class Broken(Exception):
        pass

    rt = MeasuredWorkerRuntime(plan, WorkerHealthTracker(8),
                               max_retries=_PATIENT)

    def boom(xb):
        def compute_row(row):
            raise Broken(row)
        return compute_row, (1, 16)

    rt._row_fn = boom
    with pytest.raises(Broken):
        rt.round(_x(64, 0, np.complex128)[None], 0)
    rt.close()


def test_measured_service_corrects_byzantine_workers():
    """End-to-end measured path: worker THREADS inject the corruption and
    verify="correct" still recovers the exact transform (quorum k = m + 4
    corrects 2 liars)."""
    plan = FaultPlan(seed=8).corrupt(2, rounds=999).corrupt(5, rounds=999)
    svc = FFTService(_cfg(s=64, measured=True, faults=plan,
                          verify="correct", verify_quorum=4,
                          max_retries=_PATIENT, dtype=torch.complex128,
                          use_reference=True), device="cpu")
    x = _x(64, 2, np.complex128)
    y = svc.submit(x)
    np.testing.assert_allclose(y, np.fft.fft(x), atol=1e-8)
    flagged = set(svc.health.summary()["byzantine"])
    assert flagged <= {2, 5} and svc.stats.corrected == len(flagged)
    if not svc.stats.redispatched_shards:
        # no healthy thread recomputed a liar's row: both lies arrived
        assert svc.stats.corrected == 2 and flagged == {2, 5}
    svc.close()


def test_measured_uncoded_baseline_requires_every_worker():
    """require_all=True is the uncoded baseline: one killed worker forces
    the full retry ladder (an uncoded partition has no slack)."""
    plan = FaultPlan().kill(3, rounds=999)
    svc = FFTService(_cfg(s=64, measured=True, require_all=True,
                          faults=plan, max_retries=0, on_failure="degrade",
                          dtype=torch.complex128, use_reference=True),
                     device="cpu")
    r = svc.submit(_x(64, 0, np.complex128))
    assert isinstance(r, DegradedResult) and r.reason == "retries_exhausted"
    assert r.detail == "measured round 0"
    # the coded service under the SAME fault plan just ... works
    svc2 = FFTService(_cfg(s=64, measured=True, faults=plan,
                           max_retries=_PATIENT, dtype=torch.complex128,
                           use_reference=True), device="cpu")
    x = _x(64, 0, np.complex128)
    np.testing.assert_allclose(svc2.submit(x), np.fft.fft(x), atol=1e-8)
    assert svc2.stats.degraded == 0
    with pytest.raises(ValueError, match="c2c buckets only"):
        svc2.submit_rfft(np.zeros(64, np.float64))
    svc.close()
    svc2.close()


def test_measured_default_config_serves_kernel_plan_rows():
    """measured=True on the default complex64 config: the runtime runs
    the instrumented kernel-backend plan, and a killed worker is a
    latency event."""
    svc = FFTService(_cfg(s=4096, measured=True, max_retries=_PATIENT,
                          faults=FaultPlan().kill(6, rounds=99)),
                     device="cpu")
    xs = [_x(4096, seed=i) for i in range(3)]
    out = svc.submit_batch(xs)
    rt = svc._measured[(4096, 8)]
    assert rt.plan is svc._instrumented_plan(4096, "c2c")
    assert rt.plan.resolved_backend == "kernel"
    for x, y in zip(xs, out):
        assert np.abs(y - np.fft.fft(x)).max() < 1e-2
    assert svc.stats.degraded == 0 and svc.stats.requests == 3
    svc.close()


def test_launch_counts_exact_under_threads():
    """``count_launch`` from more threads than cores at once, with the
    interpreter switching threads every microsecond, loses no count."""
    _build.reset_launch_counts()
    n_threads, per = 2 * (os.cpu_count() or 8), 2000
    barrier = threading.Barrier(n_threads)

    def hammer():
        barrier.wait()
        for _ in range(per):
            _build.count_launch("probe")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert _build.launch_counts() == {"probe": n_threads * per}
    _build.reset_launch_counts()


# ------------------------------------------------------------------ the card
@pytest.mark.gpu
@pytest.mark.parametrize("kind,kernel", [
    ("c2c", "coded_fft_bucket_masked"),
    ("r2c", "coded_rfft_bucket_masked"),
    ("c2r", "coded_irfft_bucket_masked"),
])
def test_gpu_robust_path_runs_masked_bucket_kernels(cuda, kind, kernel):
    """verify="off" with kill and delay faults: each bucket is one launch
    of the kind's masked whole-bucket kernel, fed the deadline masks."""
    svc = FFTService(_cfg(s=4096, health=True,
                          faults=FaultPlan(seed=0).kill(2, rounds=9)
                          .delay(5, 0.4, rounds=9)))
    rng = np.random.default_rng(1)
    if kind == "c2c":
        xs = [_x(4096, seed=i) for i in range(16)]
        want = [np.fft.fft(x.astype(np.complex128)) for x in xs]
    elif kind == "r2c":
        xs = [rng.normal(size=4096).astype(np.float32) for _ in range(16)]
        want = [np.fft.rfft(x.astype(np.float64)) for x in xs]
    else:
        sig = [rng.normal(size=4096) for _ in range(16)]
        xs = [np.fft.rfft(x).astype(np.complex64) for x in sig]
        want = sig
    _build.reset_launch_counts()
    out = svc.submit_batch(xs, kind=kind)
    assert _build.launch_counts() == {kernel: 1}
    for y, w in zip(out, want):
        assert np.abs(y - w).max() < 3e-4 * np.abs(w).max()
    assert svc.stats.degraded == 0 and svc.stats.retries >= 0


@pytest.mark.gpu
def test_gpu_verify_path_runs_cmatmul_and_fourstep(cuda):
    """verify="correct" with two corrupt workers at complex64: the
    encode on ``cmatmul``, the worker on ``fourstep_fused``, each
    request's decode on ``cmatmul``, and the transform recovered."""
    svc = FFTService(_cfg(s=4096, straggler=_TIGHT, verify="correct",
                          faults=FaultPlan(seed=3).corrupt(1, rounds=9)
                          .corrupt(6, rounds=9)))
    xs = [_x(4096, seed=i) for i in range(8)]
    _build.reset_launch_counts()
    out = svc.submit_batch(xs)
    assert _build.launch_counts() == {"cmatmul": 1 + len(xs),
                                      "fourstep_fused": 1}
    for x, y in zip(xs, out):
        w = np.fft.fft(x.astype(np.complex128))
        assert np.abs(y - w).max() < 3e-4 * np.abs(w).max()
    assert svc.stats.corrected == 2 * len(xs)


@pytest.mark.gpu
def test_gpu_measured_rows_from_the_card(cuda):
    """measured=True: every row on its worker's stream through ``cmatmul``
    and ``fourstep_fused``; a killed worker's row never arrives."""
    svc = FFTService(_cfg(s=4096, measured=True, max_retries=_PATIENT,
                          faults=FaultPlan().kill(4, rounds=99)))
    xs = [_x(4096, seed=i) for i in range(4)]
    svc.submit_batch(xs)                         # warm: learn the times
    _build.reset_launch_counts()
    out = svc.submit_batch(xs)
    counts = _build.launch_counts()
    assert set(counts) == {"cmatmul", "fourstep_fused"}
    assert counts["fourstep_fused"] >= 4 and counts["cmatmul"] >= 4 + 4
    for x, y in zip(xs, out):
        w = np.fft.fft(x.astype(np.complex128))
        assert np.abs(y - w).max() < 3e-4 * np.abs(w).max()
    svc.close()
