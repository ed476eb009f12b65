"""The port's streaming front-end: multi-tier EDF bucket formation,
adaptive slack, typed admission control, kind isolation, the
double-buffered staging pipeline, the latency histograms it reports
through ServiceStats, the scheduler-lifecycle invariants (EDF order,
flush scoping, cancellation safety, overlap accounting) and fault
injection under streaming -- each test of the JAX package's
``tests/test_streaming_service.py`` ported to ``StreamingFFTService``
over the port's ``FFTService(device="cpu")``.

Where a run's buckets form the same way whatever the timing (fills
under a long slack), the port's stats are held to a same-seed reference
stream's.  Every other assertion holds for any arrival order and host
load: a sleep waits 10x or more past the work it waits on, and the
results are checked against ``numpy.fft``.  ``gpu``-marked: the stream
layout on the card (copies, launches and fetches on streams of their
own) keeps the bucket kernels' launches and shows staging overlap.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch
from test_torch_kernels import private_autotune_table  # noqa: F401

from repro_torch.distributed import FaultPlan, StragglerModel
from repro_torch.kernels import _build
from repro_torch.serving import (
    FAILURE_REASONS,
    AdmissionError,
    FFTService,
    FFTServiceConfig,
    LatencyHistogram,
    ServiceError,
    StreamConfig,
    StreamingFFTService,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    from repro import distributed as jdist
    from repro import serving as jserving

    return jdist, jserving


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cfg(**kw):
    kw.setdefault("s", 256)
    kw.setdefault("m", 4)
    kw.setdefault("n_workers", 8)
    kw.setdefault("seed", 0)
    kw.setdefault("max_batch", 4)
    kw.setdefault("autotune", False)
    return FFTServiceConfig(**kw)


def _svc(**kw):
    return FFTService(_cfg(**kw), device="cpu")


def _reqs(n, s=256, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s)
             + 1j * rng.normal(size=s)).astype(np.complex64)
            for _ in range(n)]


def _ok(y, x):
    return np.abs(y - np.fft.fft(x)).max() < 1e-2


def _reference_stream(jref, xs, scfg_kw, **cfg_kw):
    """The same requests through the JAX package's streaming front-end
    (fills only: the buckets form the same way in both)."""
    jdist, js = jref
    if "faults" in cfg_kw:
        plan = cfg_kw.pop("faults")
        cfg_kw["faults"] = jdist.FaultPlan(
            tuple(jdist.WorkerFault(*dataclasses.astuple(f))
                  for f in plan.faults), plan.seed)
    kw = dict(s=256, m=4, n_workers=8, seed=0, max_batch=4, autotune=False)
    kw.update(cfg_kw)
    jsvc = js.FFTService(js.FFTServiceConfig(**kw))
    with js.StreamingFFTService(jsvc, js.StreamConfig(**scfg_kw)) as st:
        futs = [st.submit(x) for x in xs]
        for f in futs:
            try:
                f.result(timeout=240)
            except js.ServiceError:
                pass
    return jsvc


def test_fill_dispatch_and_results(jref):
    """Full buckets dispatch on the fill rule alone (huge slack), and the
    futures resolve to the true transforms with latency attached."""
    svc = _svc()
    xs = _reqs(8)
    with StreamingFFTService(svc, StreamConfig(slack_s=30.0)) as stream:
        futs = [stream.submit(x) for x in xs]
        for x, f in zip(xs, futs):
            assert _ok(f.result(timeout=120), x)
            assert f.latency_s > 0.0
    st = svc.stats.summary()
    assert st["fill_dispatches"] == 2            # 8 requests / max_batch 4
    assert st["deadline_dispatches"] == 0
    assert st["batches"] == 2
    assert st["host_transfers"] == 2             # one fetch per bucket
    assert st["latency"]["count"] == 8
    assert st["queue_peak"] >= 1
    jsvc = _reference_stream(jref, xs, dict(slack_s=30.0))
    for name in ("coded_latency", "uncoded_latency", "stragglers_tolerated",
                 "batches", "fill_dispatches", "host_transfers"):
        assert getattr(svc.stats, name) == getattr(jsvc.stats, name), name


def test_partial_bucket_dispatches_at_slack_expiry():
    """A partial bucket holds while its slack lasts, then dispatches on
    the DEADLINE rule -- never early, never waiting for a fill that is
    not coming."""
    svc = _svc()
    slack = 1.0
    with StreamingFFTService(svc, StreamConfig(slack_s=slack)) as stream:
        futs = [stream.submit(x) for x in _reqs(2, seed=1)]
        time.sleep(slack * 0.3)
        # well before expiry: the 2-of-4 bucket must still be queued
        assert not any(f.done() for f in futs)
        for f in futs:
            f.result(timeout=120)
    st = svc.stats.summary()
    assert st["deadline_dispatches"] == 1 and st["fill_dispatches"] == 0
    assert st["batches"] == 1                    # both rode ONE bucket
    # dispatched at expiry, not before: arrival->result spans the slack
    assert all(f.latency_s >= slack * 0.9 for f in futs)


def test_admission_control_rejects_with_typed_reason():
    """Over max_queue, submit fails fast with a machine-readable reason;
    accepted requests still complete on close(), and a closed service
    rejects with its own reason."""
    svc = _svc()
    stream = StreamingFFTService(
        svc, StreamConfig(fill_only=True, pipelined=False, max_queue=2))
    xs = _reqs(3, seed=2)
    f0 = stream.submit(xs[0])
    f1 = stream.submit(xs[1])                    # fill_only: both just queue
    with pytest.raises(AdmissionError) as ei:
        stream.submit(xs[2])
    assert ei.value.reason == "queue_full"
    assert svc.stats.rejected == 1
    stream.close()                               # drain flushes the partial
    assert _ok(f0.result(), xs[0])
    assert f1.done()
    assert svc.stats.drain_dispatches == 1
    with pytest.raises(AdmissionError) as ei:
        stream.submit(xs[2])
    assert ei.value.reason == "closed"


def test_mixed_kinds_never_share_a_bucket():
    """c2c / r2c / c2r arrivals at the same length land in three separate
    buckets -- kinds never mix inside one dispatch."""
    svc = _svc(max_batch=8)
    rng = np.random.default_rng(3)
    xc = [(rng.normal(size=256)
           + 1j * rng.normal(size=256)).astype(np.complex64)
          for _ in range(2)]
    xr = [rng.normal(size=256).astype(np.float32) for _ in range(2)]
    yh = [np.fft.rfft(x).astype(np.complex64) for x in xr]
    with StreamingFFTService(svc, StreamConfig(slack_s=30.0)) as stream:
        futs = ([stream.submit(x) for x in xc]
                + [stream.submit(x, kind="r2c") for x in xr]
                + [stream.submit(y, kind="c2r") for y in yh])
        assert stream.drain(timeout=240)
    st = svc.stats.summary()
    assert st["batches"] == 3                    # one bucket per (s, kind)
    assert st["drain_dispatches"] == 3
    for f, x in zip(futs[:2], xc):
        assert _ok(f.result(), x)
    for f, x in zip(futs[2:4], xr):
        assert np.abs(f.result() - np.fft.rfft(x)).max() < 1e-2
    for f, x in zip(futs[4:6], xr):
        assert np.abs(f.result() - x).max() < 1e-2


def test_pipeline_one_transfer_per_bucket_and_overlap_accounting():
    """The staged pipeline keeps the one-fetch-per-bucket invariant and
    accounts staging overlap without losing a single request."""
    svc = _svc()
    scfg = StreamConfig(slack_s=30.0, stage_depth=4)
    with StreamingFFTService(svc, scfg) as stream:
        xs = _reqs(16, seed=4)
        futs = [stream.submit(x) for x in xs]
        for f, x in zip(futs, xs):
            assert _ok(f.result(timeout=120), x)
    st = svc.stats.summary()
    assert st["requests"] == 16
    assert st["batches"] == 4                    # 16 / max_batch 4, all fills
    assert st["host_transfers"] == 4
    assert st["staging_overlap_s"] >= 0.0
    assert st["latency"]["count"] == 16
    hist = st["latency"]
    assert hist["p50_s"] <= hist["p99_s"] <= hist["max_s"] * 1.1


def test_stage_error_propagates_to_futures():
    """A request that blows up at staging time (here: a length the plan
    cannot shard) resolves its future with the exception instead of
    wedging the pipeline."""
    svc = _svc()
    with StreamingFFTService(svc, StreamConfig(slack_s=0.05)) as stream:
        bad = stream.submit(_reqs(1, s=6, seed=5)[0])   # m=4 does not divide 6
        good = stream.submit(_reqs(1, seed=6)[0])
        with pytest.raises(ValueError, match="must divide"):
            bad.result(timeout=120)
        good.result(timeout=120)                 # pipeline still alive
    assert svc.stats.latency.n == 2


def test_submit_validates_kind_synchronously():
    svc = _svc()
    with StreamingFFTService(svc) as stream:
        with pytest.raises(ValueError):
            stream.submit(_reqs(1)[0], kind="c2x")
        with pytest.raises(ValueError):
            stream.submit(np.zeros(1, np.complex64), kind="c2r")


def _slow_first_stage(svc, delay):
    """Monkey-patch ``svc.stage_bucket`` so its FIRST call sleeps
    ``delay`` seconds -- deterministically holds the scheduler (or the
    stager) busy while more traffic arrives."""
    orig = svc.stage_bucket
    fired = []

    def slow(*a, **kw):
        if not fired:
            fired.append(True)
            time.sleep(delay)
        return orig(*a, **kw)

    svc.stage_bucket = slow


def test_edf_earlier_deadline_bucket_dispatches_first():
    """Bucket A is created first, bucket B later with a SHORTER slack;
    when the scheduler next looks, both heads have expired and B -- the
    earlier deadline -- must dispatch first.  The blocker's stage holds
    the scheduler 2 s, past both deadlines by more than a second."""
    svc = _svc()
    _slow_first_stage(svc, 2.0)
    order = []
    scfg = StreamConfig(pipelined=False, adaptive=False)
    with StreamingFFTService(svc, scfg) as stream:
        fblk = stream.submit(_reqs(1, s=128, seed=7)[0], slack_s=0.0)
        time.sleep(0.1)
        fa = stream.submit(_reqs(1, s=256, seed=8)[0], slack_s=0.60)
        fb = stream.submit(_reqs(1, s=512, seed=9)[0], slack_s=0.20)
        fa.add_done_callback(lambda f: order.append("A"))
        fb.add_done_callback(lambda f: order.append("B"))
        fblk.result(timeout=120)
        fa.result(timeout=120)
        fb.result(timeout=120)
    assert order.index("B") < order.index("A"), order
    assert svc.stats.deadline_dispatches == 3


def test_edf_orders_rows_within_a_bucket():
    """Ties WITHIN a bucket are EDF too: when a full bucket takes only
    ``cap`` of the queued rows, it takes the EARLIEST DEADLINES, not the
    first arrivals."""
    svc = _svc(max_batch=2)
    _slow_first_stage(svc, 0.5)
    xs = _reqs(3, seed=10)
    scfg = StreamConfig(pipelined=False, adaptive=False)
    with StreamingFFTService(svc, scfg) as stream:
        # blocker holds the scheduler while all three same-bucket
        # requests queue up past cap=2
        fblk = stream.submit(_reqs(1, s=128, seed=20)[0], slack_s=0.0)
        time.sleep(0.1)
        fa = stream.submit(xs[0], slack_s=30.0)  # FIFO would take fa, fb
        fb = stream.submit(xs[1], slack_s=30.0)
        fu = stream.submit(xs[2], slack_s=0.05)  # EDF takes fu, fa
        fblk.result(timeout=120)
        assert _ok(fu.result(timeout=120), xs[2])
        assert _ok(fa.result(timeout=120), xs[0])   # fu's bucket
        assert not fb.done()                     # 30 s of slack left
        stream.flush()
        assert _ok(fb.result(timeout=120), xs[1])
    assert svc.stats.latency.n == 4
    assert svc.stats.fill_dispatches == 1 and svc.stats.drain_dispatches == 1


def test_cancelled_future_does_not_kill_the_pipeline():
    """A caller cancelling a pending future must not kill the syncer: the
    resolution claims the future first, counts the cancellation, and
    every subsequent request still completes."""
    svc = _svc()
    with StreamingFFTService(svc, StreamConfig(slack_s=1.0)) as stream:
        xs = _reqs(3, seed=11)
        f0 = stream.submit(xs[0])
        assert f0.cancel()                       # pending -> cancellable
        f1 = stream.submit(xs[1])
        assert _ok(f1.result(timeout=120), xs[1])
        f2 = stream.submit(xs[2])                # pipeline must be alive
        assert _ok(f2.result(timeout=120), xs[2])
        assert f0.cancelled()
    assert svc.stats.cancelled == 1
    assert svc.stats.latency.n == 3              # cancelled rows computed


def test_flush_scope_excludes_later_submits():
    """Requests submitted AFTER flush() returns are NOT swept into drain
    buckets: the flush drains exactly the generation it snapshotted."""
    svc = _svc()
    _slow_first_stage(svc, 0.5)
    scfg = StreamConfig(slack_s=30.0, pipelined=False, adaptive=False)
    stream = StreamingFFTService(svc, scfg)
    f1 = stream.submit(_reqs(1, seed=12)[0])
    stream.flush()                               # drains f1 (gen 0)
    time.sleep(0.1)                              # scheduler is staging f1
    f2 = stream.submit(_reqs(1, seed=13)[0])     # gen 1: NOT in scope
    f1.result(timeout=120)
    time.sleep(0.3)
    assert not f2.done()
    assert svc.stats.drain_dispatches == 1
    stream.flush()                               # new scope covers f2
    f2.result(timeout=120)
    stream.close()
    assert svc.stats.drain_dispatches == 2


def test_overlap_accounts_subinterval_not_whole_stage():
    """The overlap clock measures the overlapped sub-interval, not the
    whole staging interval: a long stage (2 s) that only briefly coexists
    with a downstream fetch is not counted wholesale."""
    svc = _svc()
    orig = svc.stage_bucket
    calls = []

    def slow_second(*a, **kw):
        calls.append(True)
        if len(calls) == 2:
            time.sleep(2.0)      # bucket 2 stages long AFTER bucket 1's
        return orig(*a, **kw)    # (fast) fetch has already completed

    svc.stage_bucket = slow_second
    with StreamingFFTService(svc, StreamConfig(slack_s=30.0)) as stream:
        xs = _reqs(8, seed=14)
        futs = [stream.submit(x) for x in xs]    # two fill buckets of 4
        for f in futs:
            f.result(timeout=120)
    st = svc.stats.summary()
    assert st["batches"] == 2
    # the 2 s stage of bucket 2 overlapped bucket 1's in-flight window
    # only for the time that fetch took
    assert st["staging_overlap_s"] <= 1.0
    assert 0.0 <= st["staging_overlap_s"] <= st["dispatch_s"]


def test_rejections_counted_for_both_reasons():
    """Both admission reject reasons -- queue_full and closed -- count
    into stats.rejected."""
    svc = _svc()
    stream = StreamingFFTService(
        svc, StreamConfig(fill_only=True, pipelined=False, max_queue=1))
    xs = _reqs(2, seed=15)
    f0 = stream.submit(xs[0])
    with pytest.raises(AdmissionError) as ei:
        stream.submit(xs[1])
    assert ei.value.reason == "queue_full"
    assert svc.stats.rejected == 1
    stream.close()
    f0.result(timeout=120)
    with pytest.raises(AdmissionError) as ei:
        stream.submit(xs[1])
    assert ei.value.reason == "closed"
    assert svc.stats.rejected == 2


# ---------------------------------------------------------------- tiers
def test_tiers_map_to_slack_and_histograms():
    """submit(tier=...) picks the tier's slack for the deadline and the
    per-tier histogram for the accounting; unknown tiers fail fast.  The
    batch request arrives first and resolves last, so its latency is the
    larger whatever the timing."""
    svc = _svc()
    scfg = StreamConfig(
        tiers={"interactive": 0.05, "batch": 5.0},
        default_tier="interactive", adaptive=False)
    with StreamingFFTService(svc, scfg) as stream:
        with pytest.raises(ValueError):
            stream.submit(_reqs(1)[0], tier="bogus")
        xs = _reqs(1, seed=16)
        fbat = stream.submit(_reqs(1, s=512, seed=16)[0], tier="batch")
        fi = stream.submit(xs[0], tier="interactive")
        # the interactive deadline expires long before batch's: it rides
        # its own deadline bucket while the batch bucket stays queued
        assert _ok(fi.result(timeout=120), xs[0])
        assert not fbat.done()
        stream.flush()
        fbat.result(timeout=120)
    st = svc.stats.summary()
    assert st["tiers"]["interactive"]["count"] == 1
    assert st["tiers"]["batch"]["count"] == 1
    assert st["tiers"]["interactive"]["p99_s"] <= st["tiers"]["batch"]["p99_s"]
    assert st["latency"]["count"] == 2           # global histogram too


def test_default_tier_must_exist():
    svc = _svc()
    with pytest.raises(ValueError):
        StreamingFFTService(
            svc, StreamConfig(tiers={"fast": 0.001}, default_tier="standard"))


def test_adaptive_slack_shrinks_deadline_by_predicted_compute():
    """With a compute EWMA recorded for the bucket shape, the effective
    slack shrinks so the deadline budget covers queueing only: a partial
    bucket dispatches well before its NOMINAL slack."""
    svc = _svc()
    scfg = StreamConfig(slack_s=5.0, min_slack_frac=0.01)
    with StreamingFFTService(svc, scfg) as stream:
        with stream._lock:                       # predicted compute: 4.9 s
            stream._ewma[(256, "c2c")] = 4.9
        t0 = time.perf_counter()
        f = stream.submit(_reqs(1, seed=17)[0])
        f.result(timeout=120)
        waited = time.perf_counter() - t0
    # effective slack = 5.0 - 4.9 = 0.1 s, not the nominal 5 s
    assert waited < 3.0
    assert svc.stats.deadline_dispatches == 1


def test_adaptive_slack_floor_and_ewma_updates():
    """The effective slack never drops below min_slack_frac of nominal,
    and real dispatches feed the per-shape EWMA."""
    svc = _svc()
    scfg = StreamConfig(slack_s=0.4, min_slack_frac=0.25)
    with StreamingFFTService(svc, scfg) as stream:
        with stream._lock:                       # absurd prediction
            stream._ewma[(256, "c2c")] = 100.0
        t0 = time.perf_counter()
        f = stream.submit(_reqs(1, seed=18)[0])
        f.result(timeout=120)
        waited = time.perf_counter() - t0
        assert waited >= 0.4 * 0.25 * 0.9        # floored, not immediate
        assert (256, "c2c") in stream.compute_ewma
        assert stream.compute_ewma[(256, "c2c")] < 100.0  # EWMA moved


# ------------------------------------------------------- lifecycle stress
def test_scheduler_stress_random_cancels_and_flushes():
    """Hundreds of tiny submits with random cancels and mid-stream
    flushes: nothing lost, nothing deadlocked, every pipeline thread
    exits -- all under an explicit wall-clock guard (a wedged scheduler
    fails the drain timeout instead of hanging the suite)."""
    t_start = time.perf_counter()
    svc = _svc(s=64, max_batch=4)
    scfg = StreamConfig(
        tiers={"interactive": 0.002, "standard": 0.01, "batch": 0.05},
        max_queue=10_000)
    rng = np.random.default_rng(19)
    xs = _reqs(8, s=64, seed=19)
    stream = StreamingFFTService(svc, scfg)
    futs, cancelled = [], 0
    for i in range(300):
        tier = ("interactive", "standard", "batch")[int(rng.integers(3))]
        f = stream.submit(xs[i % len(xs)], tier=tier)
        futs.append(f)
        if rng.random() < 0.25 and f.cancel():
            cancelled += 1
        if i % 37 == 36:
            stream.flush()
    assert stream.drain(timeout=60.0), "scheduler deadlocked"
    stream.close()
    assert all(f.done() for f in futs)
    ok = sum(1 for f in futs if not f.cancelled())
    assert ok == 300 - cancelled
    for i, f in enumerate(futs):
        if not f.cancelled():
            assert _ok(f.result(timeout=1), xs[i % len(xs)])
    st = svc.stats.summary()
    assert st["cancelled"] == cancelled
    assert st["latency"]["count"] == 300         # cancelled rows computed too
    assert sum(t["count"] for t in st["tiers"].values()) == 300
    assert not any(t.is_alive() for t in stream._threads)
    assert time.perf_counter() - t_start < 60.0, "wall-clock guard"


# ------------------------------------------------- fault-injected streaming
def test_streaming_kill_fault_recovers_transparently(jref):
    """One persistently dead worker is a latency event, not a failure:
    re-dispatch fills the missing shard rows and every future resolves to
    the true transform (and the same counters as a same-seed reference
    stream: full buckets form the same way)."""
    plan = FaultPlan().kill(2, rounds=999)
    svc = _svc(faults=plan)
    xs = _reqs(8, seed=21)
    with StreamingFFTService(svc, StreamConfig(slack_s=30.0)) as stream:
        futs = [stream.submit(x) for x in xs]
        for x, f in zip(xs, futs):
            assert _ok(f.result(timeout=120), x)
    assert svc.stats.degraded == 0
    assert not any(t.is_alive() for t in stream._threads)
    jsvc = _reference_stream(jref, xs, dict(slack_s=30.0), faults=plan)
    for name in ("coded_latency", "uncoded_latency", "stragglers_tolerated",
                 "retries", "redispatched_shards", "degraded"):
        assert getattr(svc.stats, name) == getattr(jsvc.stats, name), name


def test_streaming_fault_failures_are_typed_future_exceptions():
    """An unservable round (5 dead workers, zero retries) surfaces as a
    typed ServiceError on EACH future -- and the scheduler/stager/syncer
    threads survive to serve the next submission."""
    plan = FaultPlan()
    for w in range(5):
        plan = plan.kill(w, rounds=999)
    svc = _svc(faults=plan, max_retries=0)
    with StreamingFFTService(svc, StreamConfig(slack_s=30.0)) as stream:
        futs = [stream.submit(x) for x in _reqs(4, seed=22)]
        for f in futs:
            with pytest.raises(ServiceError) as ei:
                f.result(timeout=120)
            assert ei.value.reason == "retries_exhausted"
        # the pipeline is still alive: a second wave gets the same
        # typed answer instead of a hang or a dead-thread timeout
        assert all(t.is_alive() for t in stream._threads)
        f2 = stream.submit(_reqs(1, seed=23)[0])
        with pytest.raises(ServiceError):
            f2.result(timeout=120)
    assert svc.stats.degraded >= 5
    assert not any(t.is_alive() for t in stream._threads)


def test_streaming_corrupt_fault_detected_as_future_exception():
    """A Byzantine worker under verify="detect": the syndrome check turns
    silent corruption into a typed corrupt_uncorrectable Future
    exception."""
    tight = StragglerModel(t0=1.0, mu=1e6)  # all workers arrive -> k = 8
    svc = _svc(straggler=tight,
               faults=FaultPlan(seed=3).corrupt(1, rounds=999),
               verify="detect")
    with StreamingFFTService(svc, StreamConfig(slack_s=30.0)) as stream:
        f = stream.submit(_reqs(1, seed=24)[0])
        with pytest.raises(ServiceError) as ei:
            f.result(timeout=120)
        assert ei.value.reason == "corrupt_uncorrectable"
    assert svc.stats.detected >= 1
    assert not any(t.is_alive() for t in stream._threads)


def test_scheduler_stress_with_fault_injection():
    """The lifecycle stress under a random kill/delay/corrupt storm with
    Byzantine correction on: every non-cancelled future either holds the
    true transform or raises a TYPED ServiceError -- no untyped
    exceptions, no lost futures, no dead pipeline threads."""
    t_start = time.perf_counter()
    plan = FaultPlan.random(8, rate=0.25, horizon=256, seed=20)
    svc = _svc(s=64, max_batch=4, faults=plan, verify="correct",
               straggler=StragglerModel(t0=1.0, mu=50.0))
    scfg = StreamConfig(
        tiers={"interactive": 0.002, "standard": 0.01, "batch": 0.05},
        max_queue=10_000)
    rng = np.random.default_rng(25)
    xs = _reqs(8, s=64, seed=25)
    stream = StreamingFFTService(svc, scfg)
    futs, cancelled = [], 0
    for i in range(200):
        tier = ("interactive", "standard", "batch")[int(rng.integers(3))]
        f = stream.submit(xs[i % len(xs)], tier=tier)
        futs.append((xs[i % len(xs)], f))
        if rng.random() < 0.2 and f.cancel():
            cancelled += 1
        if i % 41 == 40:
            stream.flush()
    assert stream.drain(timeout=90.0), "scheduler deadlocked under faults"
    stream.close()
    assert all(f.done() for _, f in futs)
    served = failed = 0
    for x, f in futs:
        if f.cancelled():
            continue
        try:
            y = f.result(timeout=1)
        except ServiceError as e:
            assert e.reason in FAILURE_REASONS    # typed, never raw
            failed += 1
        else:
            assert _ok(y, x)
            served += 1
    assert served + failed == 200 - cancelled
    assert served > 0                             # the storm never won outright
    st = svc.stats.summary()
    assert st["cancelled"] == cancelled
    assert st["degraded"] >= failed               # cancelled rows still ride
    #                                               the bucket and may degrade
    # the fault machinery demonstrably engaged
    assert (st["retries"] + st["redispatched_shards"]
            + st["detected"] + st["corrected"]) > 0
    assert not any(t.is_alive() for t in stream._threads)
    assert time.perf_counter() - t_start < 90.0, "wall-clock guard"


def test_latency_histogram_percentiles(jref):
    h = LatencyHistogram()
    jh = jref[1].LatencyHistogram()
    samples = [0.001] * 90 + [1.0] * 10
    for v in samples:
        h.record(v)
        jh.record(v)
    s = h.summary()
    assert s["count"] == 100
    assert 0.0008 <= s["p50_s"] <= 0.00125       # within one log bin
    assert 0.9 <= s["p99_s"] <= 1.3
    assert s["max_s"] == 1.0
    assert s == jh.summary()
    assert np.isnan(LatencyHistogram().percentile(50))
    h.record(0.0)                                # clamps to the low edge
    h.record(1e9)                                # ... and the high edge
    assert h.n == 102


def test_stream_layout_off_cuda_and_summary_keys(jref):
    """Off CUDA the front-end makes no streams; the stats summary carries
    the reference's keys (streaming and fault fields included)."""
    svc = _svc()
    with StreamingFFTService(svc) as stream:
        assert stream._copy_stream is None and stream._launch_streams == []
        assert _ok(stream.submit(_reqs(1)[0], slack_s=0.0).result(120),
                   _reqs(1)[0])
    jsvc = jref[1].FFTService(jref[1].FFTServiceConfig(s=256,
                                                       autotune=False))
    assert set(svc.stats.summary()) == set(jsvc.stats.summary())


# ------------------------------------------------------------------ the card
@pytest.mark.gpu
def test_gpu_streaming_streams_overlap_and_kernels(cuda):
    """On the card: every bucket one launch of the masked whole-bucket
    kernel, counted right from the stager's thread, every result right,
    and staging overlap above zero with buckets in flight."""
    svc = FFTService(_cfg(s=4096, max_batch=8))
    svc.warmup()
    xs = _reqs(64, s=4096, seed=30)
    _build.reset_launch_counts()
    with StreamingFFTService(svc, StreamConfig(slack_s=30.0,
                                               stage_depth=4)) as stream:
        assert len(stream._launch_streams) == 2
        futs = [stream.submit(x) for x in xs]
        for x, f in zip(xs, futs):
            w = np.fft.fft(x.astype(np.complex128))
            assert np.abs(f.result(timeout=120) - w).max() < 3e-4 * np.abs(
                w).max()
    assert _build.launch_counts() == {"coded_fft_bucket_masked": 8}
    assert svc.stats.fill_dispatches == 8
    assert svc.stats.host_transfers == 8
    assert svc.stats.staging_overlap_s > 0.0


@pytest.mark.gpu
def test_gpu_launch_counts_exact_across_threads(cuda):
    """Kernel wrappers launched from several threads at once: the counts
    add up exactly."""
    from repro_torch.kernels import ops as tops

    g = torch.randn(8, 4, dtype=torch.complex64, device=cuda)
    c = torch.randn(4, 4096, dtype=torch.complex64, device=cuda)
    tops.mds_apply(g, c)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    barrier = threading.Barrier(6)

    def run():
        barrier.wait()
        with torch.cuda.stream(torch.cuda.Stream(cuda)):
            for _ in range(50):
                tops.mds_apply(g, c)
            torch.cuda.current_stream().synchronize()

    threads = [threading.Thread(target=run) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert _build.launch_counts() == {"cmatmul": 300}
