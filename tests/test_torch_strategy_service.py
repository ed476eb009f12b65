"""The service's ``strategy=`` knob against the JAX package's, same seeds.

* ``FFTService(strategy="partial" | "comm_efficient")`` against a
  same-seed JAX service: outputs (5e-4 at complex64, 1e-8 at
  complex128, and against ``numpy.fft``), the rng state and the counters
  after every call, across lengths and with ``warmup``;
* the wire model of ``tests/test_wire_model.py``: each bucket family's
  payload charge, the latency shift of the folded payload, the modeled
  crossover, the partial-coverage win;
* the fault path under a strategy: every round's masks (per fragment for
  partial), completion times and reasons from ``_fault_arrivals``, then
  the served values, ``retries``, ``redispatched_shards``, ``degraded``
  and the health tracker; corrupt rows through the instrumented path's
  fragment decode;
* ``StreamingFFTService`` over a partial service, as over an mds one;
* ``WorkerHealthTracker.fragment_mask_from_times``;
* the constructor's refusals and the per-bucket errors (c2c only,
  applicability), which come after the bucket's draw as in the
  reference, with the rng and the counters equal after the error and
  after the next call.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_kernels import private_autotune_table  # noqa: F401

from repro_torch.convert import config_from_reference
from repro_torch.core import REGISTRY, StrategyEntry
from repro_torch.distributed import (
    FaultPlan,
    StragglerModel,
    WorkerHealthTracker,
)
from repro_torch.serving import (
    DegradedResult,
    FFTService,
    FFTServiceConfig,
    StreamConfig,
    StreamingFFTService,
)

S, M, N, Q = 256, 2, 8, 2
_FIELDS = ("requests", "batches", "coded_latency", "uncoded_latency",
           "stragglers_tolerated", "retries", "redispatched_shards",
           "degraded", "host_transfers")


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


def _jfaults(jdist, plan):
    return jdist.FaultPlan(tuple(jdist.WorkerFault(*dataclasses.astuple(f))
                                 for f in plan.faults), plan.seed)


def _twins(jref, **kw):
    """A JAX service and the port's (CPU) on one config."""
    jdist, js = jref
    jkw = dict(s=S, m=M, n_workers=N, seed=0, autotune=False)
    jkw.update(kw)
    if "faults" in jkw:
        jkw["faults"] = _jfaults(jdist, jkw["faults"])
    if "straggler" in jkw:
        sm = jkw["straggler"]
        jkw["straggler"] = jdist.StragglerModel(sm.t0, sm.mu, sm.wire_frac)
    jsvc = js.FFTService(js.FFTServiceConfig(**jkw))
    cfg = config_from_reference({f.name: getattr(jsvc.cfg, f.name)
                                 for f in dataclasses.fields(jsvc.cfg)})
    return jsvc, FFTService(cfg, device="cpu")


def _same_state(tsvc, jsvc):
    for name in _FIELDS:
        assert getattr(tsvc.stats, name) == getattr(jsvc.stats, name), name
    assert tsvc.rng.bit_generator.state == jsvc.rng.bit_generator.state
    if jsvc.health is not None:
        assert tsvc.health.summary() == jsvc.health.summary()


def _reqs(lengths, seed, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) + 1j * rng.normal(size=s)).astype(dtype)
            for s in lengths]


def _same_slot(t, j, want, tol):
    if hasattr(j, "reason"):
        assert isinstance(t, DegradedResult)
        assert (t.reason, t.detail) == (j.reason, j.detail)
        return
    j = np.asarray(j)
    assert t.shape == j.shape == want.shape and t.dtype == j.dtype
    scale = np.abs(want).max()
    assert np.abs(t - want).max() < tol * scale
    assert np.abs(t - j).max() < tol * scale


SERVE_CASES = {
    "partial": dict(strategy="partial"),
    # an 8-of-32 fragment decode: f32 random draws are ill-conditioned in
    # both packages there, so its parity runs at complex128
    "partial_r4_c128": dict(strategy="partial", strategy_param=4,
                            dtype=np.complex128),
    "comm_efficient": dict(strategy="comm_efficient"),
    "comm_efficient_q4_wire": dict(
        strategy="comm_efficient", strategy_param=4,
        straggler=StragglerModel(t0=1.0, mu=4.0, wire_frac=0.8)),
    "partial_c128": dict(strategy="partial", dtype=np.complex128),
    "comm_efficient_c128": dict(strategy="comm_efficient",
                                dtype=np.complex128),
}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_strategy_service_matches_reference(jref, case):
    """Same seed, same requests: outputs, draws and counters equal call
    by call, two lengths a call (two buckets), then a warmup."""
    kw = dict(SERVE_CASES[case])
    dtype = kw.pop("dtype", np.complex64)
    jsvc, tsvc = _twins(jref, dtype=dtype, **kw)
    for s in (S, 2 * S):
        # the reference's comm-efficient plan caches its fold weights on
        # first use: inside a jit trace that value is a tracer, and a
        # second bucket size at that length fails on it (ROADMAP Queue 3),
        # so it is built outside any trace here
        getattr(jsvc._plan_for(s), "fold_weights", None)
    assert tsvc.cfg.strategy_param == kw.get("strategy_param")
    tol = 5e-4 if dtype == np.complex64 else 1e-8
    for call in range(3):
        xs = _reqs([S, 2 * S, S, S, 2 * S], call, dtype)
        tout = tsvc.submit_batch(xs)
        jout = jsvc.submit_batch(xs)
        for t, j, x in zip(tout, jout, xs):
            _same_slot(t, j, np.fft.fft(x.astype(np.complex128)), tol)
        _same_state(tsvc, jsvc)
    assert tsvc.warmup(buckets=[1, 4]) == jsvc.warmup(buckets=[1, 4]) == 2
    assert type(tsvc.plan).__name__ == type(jsvc.plan).__name__
    assert tsvc.plan.resolved_backend == "reference"


def test_strategy_bucket_errors_after_the_draw(jref):
    """"serves c2c buckets only" and "is not applicable" raise where the
    reference raises them -- after the bucket's draw -- so the rng and
    the counters stay equal after the error and after the next call."""
    jsvc, tsvc = _twins(jref, strategy="partial", m=4)
    x = _reqs([S], 0)[0]
    for bad, kind in ((np.zeros(S, np.float32), "r2c"), (x, "c2r"),
                      (np.zeros((8, 8), np.float32), "rfftn"),
                      (_reqs([260], 1)[0], "c2c")):
        with pytest.raises(ValueError) as te:
            tsvc.submit_batch([bad], kind=kind)
        with pytest.raises(ValueError) as je:
            jsvc.submit_batch([bad], kind=kind)
        assert str(te.value) == str(je.value)
        _same_state(tsvc, jsvc)
    xs = _reqs([S, S], 2)
    for t, j, xi in zip(tsvc.submit_batch(xs), jsvc.submit_batch(xs), xs):
        _same_slot(t, j, np.fft.fft(xi.astype(np.complex128)), 5e-4)
    _same_state(tsvc, jsvc)


def test_constructor_refusals_as_reference(jref):
    _, js = jref
    cases = [dict(strategy="nope"), dict(strategy="repetition"),
             dict(strategy="partial", measured=True),
             dict(strategy="comm_efficient", verify="detect"),
             dict(strategy="partial", worker_fn=lambda a: a),
             dict(strategy="comm_efficient", strategy_param=8)]
    for kw in cases:
        with pytest.raises(ValueError) as te:
            FFTService(FFTServiceConfig(s=S, m=M, n_workers=N, **kw),
                       device="cpu")
        with pytest.raises(ValueError) as je:
            js.FFTService(js.FFTServiceConfig(s=S, m=M, n_workers=N, **kw))
        assert str(te.value) == str(je.value), kw
    # precision="bf16" beside a served strategy serves at f32, as the
    # reference does: a strategy bucket runs plan.run, which carries no
    # planes, so nothing is probed and the values are the f32 service's
    kw = dict(s=S, m=M, n_workers=N, strategy="partial", seed=1,
              autotune=False)
    tsvc = FFTService(FFTServiceConfig(precision="bf16", **kw),
                      device="cpu")
    jsvc = js.FFTService(js.FFTServiceConfig(precision="bf16", **kw))
    f32 = FFTService(FFTServiceConfig(**kw), device="cpu")
    assert tsvc._precision_for(S, "c2c") == "f32"
    xs = _reqs([S, S], 3)
    for t, j, f, x in zip(tsvc.submit_batch(xs), jsvc.submit_batch(xs),
                          f32.submit_batch(xs), xs):
        _same_slot(t, j, np.fft.fft(x.astype(np.complex128)), 5e-4)
        np.testing.assert_array_equal(t, f)
    _same_state(tsvc, jsvc)


def test_mesh_refusals(tmp_path):
    """An entry with ``mesh_ok=False`` refuses a mesh with the
    reference's ValueError; a ``mesh_ok`` strategy is served on the mesh
    (tests/test_torch_coded_runtime.py holds it against the JAX
    package's)."""
    entry = StrategyEntry(
        name="test_only_no_mesh",
        factory=REGISTRY["partial"].factory,
        applicable=REGISTRY["partial"].applicable, default_param=2,
        mesh_ok=False)
    REGISTRY[entry.name] = entry
    try:
        with pytest.raises(ValueError, match="does not compose with a mesh"):
            FFTService(FFTServiceConfig(strategy=entry.name), device="cpu",
                       mesh=object())
        svc = FFTService(FFTServiceConfig(s=S, m=M, n_workers=N,
                                          strategy=entry.name),
                         device="cpu")
        assert svc.plan.fragments == 2
    finally:
        REGISTRY.pop(entry.name, None)
    from torch_mesh_worker import world_of_one

    from repro_torch.distributed import test_mesh

    with world_of_one(tmp_path / "pg"):
        svc = FFTService(FFTServiceConfig(s=S, m=M, n_workers=N,
                                          strategy="partial", autotune=False),
                         device="cpu", mesh=test_mesh((1,), ("workers",)))
        assert svc.runtime.plan is svc.plan
        x = np.random.default_rng(0).normal(size=S).astype(np.complex64)
        (y,) = svc.submit_batch([x])
        want = np.fft.fft(x.astype(np.complex128))
        assert np.abs(y - want).max() / np.abs(want).max() < 5e-4


# -- the wire model (tests/test_wire_model.py) -----------------------------
def test_service_charges_per_strategy_payload(jref):
    wire = StragglerModel(t0=1.0, mu=1.0, wire_frac=0.5)
    for strategy, param, kind, want in (
            ("mds", None, "c2c", 1.0), ("mds", None, "r2c", 0.5),
            ("mds", None, "c2r", 0.5), ("mds", None, "rfftn", 0.5),
            ("comm_efficient", None, "c2c", 1 / Q),
            ("comm_efficient", 4, "c2c", 0.25),
            ("partial", None, "c2c", 1.0)):
        jsvc, tsvc = _twins(jref, strategy=strategy, strategy_param=param,
                            straggler=wire, use_reference=True)
        assert tsvc._wire_scale(kind) == jsvc._wire_scale(kind)
        assert tsvc._wire_scale(kind) == pytest.approx(want)


def test_simulate_arrivals_use_strategy_payload(jref):
    """Same seed, same noise: the comm-efficient latencies sit EXACTLY
    the folded wire share below the mds ones; the masks are the
    reference's (per fragment for partial)."""
    wf = 0.8
    wire = StragglerModel(t0=1.0, mu=1.0, wire_frac=wf)
    draws = {}
    for strategy in ("mds", "comm_efficient", "partial"):
        jsvc, tsvc = _twins(jref, strategy=strategy, straggler=wire,
                            seed=11, use_reference=True)
        lat, mask = tsvc._simulate_arrivals(5, "c2c")
        jlat, jmask = jsvc._simulate_arrivals(5, "c2c")
        np.testing.assert_array_equal(lat, jlat)
        np.testing.assert_array_equal(mask, jmask)
        draws[strategy] = lat
    assert mask.shape == (5, N, 2)
    np.testing.assert_allclose(draws["mds"] - draws["comm_efficient"],
                               (1.0 / M) * wf * (1 - 1.0 / Q), rtol=1e-12)


def test_modeled_rounds_show_comm_efficient_crossover():
    def round_time(wire_frac, strategy):
        sm = StragglerModel(t0=1.0, mu=4.0, wire_frac=wire_frac)
        if strategy == "mds":
            return sm.expected_kth(N, M, 1.0 / M)
        return sm.expected_kth(N, M * Q, 1.0 / M, payload_scale=1.0 / Q)

    assert round_time(0.8, "comm_efficient") < round_time(0.8, "mds")
    assert round_time(0.0, "comm_efficient") > round_time(0.0, "mds")
    assert StragglerModel(t0=1.0, mu=1.0).expected_kth(
        M * Q - 1, M * Q, 1.0 / M) == float("inf")


def test_service_race_partial_and_comm_efficient(jref):
    """The reference's strategy race in miniature (bench_comm_load's
    service race): coverage means equal to the JAX services', the folded
    payload winning at wire_frac 0.8 and losing at 0.0, and partial's
    coverage never trailing mds's on the same draws."""
    rng = np.random.default_rng(1)
    xs = [list((rng.normal(size=(4, S)) + 1j * rng.normal(size=(4, S)))
               .astype(np.complex64)) for _ in range(3)]
    means = {}
    for wf in (0.8, 0.0):
        for strategy in ("mds", "partial", "comm_efficient"):
            sm = StragglerModel(t0=1.0, mu=4.0, wire_frac=wf)
            jsvc, tsvc = _twins(jref, strategy=strategy, straggler=sm,
                                use_reference=True)
            for xb in xs:
                tout, jout = tsvc.submit_batch(xb), jsvc.submit_batch(xb)
                for t, j, x in zip(tout, jout, xb):
                    _same_slot(t, j, np.fft.fft(x.astype(np.complex128)),
                               5e-4)
            _same_state(tsvc, jsvc)
            means[wf, strategy] = (tsvc.stats.coded_latency
                                   / tsvc.stats.requests)
    assert means[0.8, "comm_efficient"] < means[0.8, "mds"]
    assert means[0.0, "comm_efficient"] > means[0.0, "mds"]
    for wf in (0.8, 0.0):
        assert means[wf, "partial"] <= means[wf, "mds"] + 1e-12


# -- the fault path under a strategy ----------------------------------------
_DRAW_CASES = {
    "kill_delay": dict(faults=FaultPlan().kill(2, rounds=3).delay(
        5, 1.5, rounds=6), health=True),
    "kill_many": dict(faults=FaultPlan().kill(0, rounds=99).kill(
        1, rounds=99).kill(6, rounds=99), max_retries=3,
        on_failure="degrade"),
    "storm": dict(faults=FaultPlan.random(8, 0.3, horizon=40,
                                          kinds=("kill", "delay"), seed=11),
                  on_failure="degrade", deadline_slack=0.1),
    "slow_tail": dict(health=True, straggler=StragglerModel(t0=1.0, mu=0.3),
                      deadline_slack=0.05, on_failure="degrade"),
    "exhausted": dict(faults=FaultPlan().kill(0, rounds=99).kill(
        1, rounds=99).kill(2, rounds=99).kill(3, rounds=99).kill(
        4, rounds=99).kill(5, rounds=99), max_retries=0,
        on_failure="degrade"),
}


@pytest.mark.parametrize("strategy", ["partial", "comm_efficient"])
@pytest.mark.parametrize("case", sorted(_DRAW_CASES))
def test_fault_arrivals_match_reference(jref, case, strategy):
    """Round by round the reference's masks (per fragment for partial),
    completion times and reasons, then the served batch's values and
    counters and the health tracker."""
    jsvc, tsvc = _twins(jref, strategy=strategy, m=4, **_DRAW_CASES[case])
    for n_live in (5, 1, 16, 3):
        tm, te, tt, tl, _, tr = tsvc._fault_arrivals(n_live, "c2c")
        jm, je, jt, jl, _, jr = jsvc._fault_arrivals(n_live, "c2c")
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tt, jt)
        assert tr == jr
        assert [None if e is None else (e.reason, e.detail) for e in te] \
            == [None if e is None else (e.reason, e.detail) for e in je]
    _same_state(tsvc, jsvc)
    xs = _reqs([S] * 6, 3)
    tout, jout = tsvc.submit_batch(xs), jsvc.submit_batch(xs)
    for t, j, x in zip(tout, jout, xs):
        _same_slot(t, j, np.fft.fft(x.astype(np.complex128)), 5e-4)
    _same_state(tsvc, jsvc)


def test_fault_path_exercises_retries_and_fragments(jref):
    """Under kills with retries the partial path re-dispatches, lands
    late workers' fragment prefixes and reports fragments in its reason,
    as the reference's does."""
    faults = FaultPlan().kill(0, rounds=99).kill(1, rounds=99).kill(
        2, rounds=99).kill(3, rounds=99).kill(4, rounds=99)
    jsvc, tsvc = _twins(jref, strategy="partial", m=2, faults=faults,
                        max_retries=1, on_failure="degrade",
                        straggler=StragglerModel(t0=1.0, mu=0.5))
    xs = _reqs([S] * 8, 4)
    for _ in range(3):
        tout, jout = tsvc.submit_batch(xs), jsvc.submit_batch(xs)
        for t, j, x in zip(tout, jout, xs):
            _same_slot(t, j, np.fft.fft(x.astype(np.complex128)), 5e-4)
    _same_state(tsvc, jsvc)
    assert tsvc.stats.retries > 0 and tsvc.stats.redispatched_shards > 0
    tm, te, *_ = tsvc._fault_arrivals(64, "c2c")
    jm, je, *_ = jsvc._fault_arrivals(64, "c2c")
    np.testing.assert_array_equal(tm, jm)
    details = {e.detail for e in te if e is not None}
    assert details == {e.detail for e in je if e is not None}
    assert all("fragments after" in d for d in details)


def test_corrupt_rows_take_the_fragment_decode(jref):
    """A corrupt worker under ``verify="off"`` sends the bucket through
    the instrumented path, whose partial decode takes the per-fragment
    masks: the same (corrupted) values as the reference."""
    faults = FaultPlan(seed=3).corrupt(1, rounds=99)
    for strategy in ("partial", "comm_efficient"):
        jsvc, tsvc = _twins(jref, strategy=strategy, m=4, faults=faults,
                            straggler=StragglerModel(t0=1.0, mu=1e6))
        xs = _reqs([S] * 3, 5)
        tout, jout = tsvc.submit_batch(xs), jsvc.submit_batch(xs)
        for t, j in zip(tout, jout):
            j = np.asarray(j)
            assert np.isfinite(t).all()
            assert np.abs(t - j).max() < 5e-4 * np.abs(j).max()
        _same_state(tsvc, jsvc)


def test_fragment_mask_from_times_matches_reference(jref):
    jdist, _ = jref
    rng = np.random.default_rng(0)
    times = rng.exponential(1.0, size=(4, 6))
    times[1, 2] = np.inf
    frac = np.arange(1, 4) / 3
    tr = WorkerHealthTracker(6)
    jtr = jdist.WorkerHealthTracker(6)
    for deadline in (0.3, 1.0, np.inf):
        got = tr.fragment_mask_from_times(times, deadline, frac)
        np.testing.assert_array_equal(
            got, jtr.fragment_mask_from_times(times, deadline, frac))
        assert got.shape == (4, 6, 3)
        # a prefix: a finished fragment's predecessors finished too
        assert not (got[..., 1:] & ~got[..., :-1]).any()
    assert not tr.fragment_mask_from_times(times, np.inf, frac)[1, 2].any()


def test_stage_bucket_masks_per_fragment():
    """``stage_bucket(..., masks=)`` takes per-fragment masks under the
    partial strategy, and serves evenly spread fragments."""
    svc = FFTService(FFTServiceConfig(s=S, m=4, n_workers=N,
                                      strategy="partial"), device="cpu")
    xs = _reqs([S] * 2, 6)
    with pytest.raises(ValueError, match=r"masks must be \(2, 8, 2\)"):
        svc.stage_bucket(S, "c2c", xs, masks=np.ones((2, N), bool))
    masks = np.ones((2, N, 2), bool)
    masks[:, 1::2, 1] = False
    bucket, args = svc.stage_bucket(S, "c2c", xs, masks=masks)
    out = svc.launch_bucket(S, bucket, "c2c", args)[:2].numpy()
    want = np.fft.fft(np.stack(xs).astype(np.complex128), axis=-1)
    assert np.abs(out - want).max() < 5e-4 * np.abs(want).max()


def test_streaming_front_end_over_a_partial_service(jref):
    """The open-loop front-end serves a strategy service unchanged: fill
    dispatches, one fetch a bucket, the same draws and counters as the
    JAX front-end over the same service."""
    _, js = jref
    cfg = dict(s=S, m=4, n_workers=N, seed=0, max_batch=4, autotune=False,
               strategy="partial")
    svc = FFTService(FFTServiceConfig(**cfg), device="cpu")
    xs = _reqs([S] * 8, 7)
    with StreamingFFTService(svc, StreamConfig(slack_s=30.0)) as stream:
        futs = [stream.submit(x) for x in xs]
        for x, f in zip(xs, futs):
            want = np.fft.fft(x.astype(np.complex128))
            got = f.result(timeout=120)
            assert np.abs(got - want).max() < 5e-4 * np.abs(want).max()
    jsvc = js.FFTService(js.FFTServiceConfig(**cfg))
    with js.StreamingFFTService(jsvc, js.StreamConfig(slack_s=30.0)) as st:
        for f in [st.submit(x) for x in xs]:
            f.result(timeout=120)
    for name in ("coded_latency", "uncoded_latency", "stragglers_tolerated",
                 "batches", "fill_dispatches", "host_transfers"):
        assert getattr(svc.stats, name) == getattr(jsvc.stats, name), name
    assert svc.stats.fill_dispatches == 2
