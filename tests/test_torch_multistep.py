"""The port's tuned four-step path against the JAX package.

The mixed-radix ``multistep_fused`` (its plain twin on the CPU), its
dispatch through ``ops.fourstep_planar``, the autotune table with the
service's warmup search, the plans through the table, and the
near-prime stage route's two-pass encode.

CPU tests: the same numpy inputs, made from a seed, go through both
packages; the JAX kernel runs in interpret mode, its dispatch layer in
its CPU ("direct") mode.  Stated tolerances, relative to the largest
output magnitude:

* bit for bit: the multistep planes;
* 1e-5 between two f32 implementations of the same sums (the
  reference's two-pass-vs-fused bound, ``tests/test_kernels.py:78``), and
  against ``numpy.fft`` at the short plans;
* 1e-4 against ``numpy.fft`` and the reference at L = 2^18, (64, 64, 64)
  (the dense 64-point sums of three stages; the four-step rows' bound in
  ``chip_smoke.py``);
* 5e-4 for ``CodedFFT.run`` (``tests/test_kernels.py:146``);
* 3e-4 for the services (``tests/test_lagrange_decode.py:153``).

GPU tests (marker ``gpu``, skipped without a CUDA device): both kernel
modes against the plain twin at 1e-5, their launches, and the tuned
routes on the card.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch
from test_torch_kernels import private_autotune_table  # noqa: F401
from test_torch_real import _port_twin

from repro_torch import CodedFFT, FFTService, FFTServiceConfig
from repro_torch.convert import config_from_reference
from repro_torch.kernels import _build, autotune
from repro_torch.kernels import ops as tops
from repro_torch.kernels.fourstep_fft import (
    MAX_STAGES,
    _parse_stage_planes,
    fft_cols_tile,
    fft_rows_per_block,
    multistep_body,
    multistep_fused,
    multistep_layout,
    multistep_mode,
    multistep_stage_plan,
)

CPU = torch.device("cpu")
PAIR_TOL = 1e-5
LONG_TOL = 1e-4
PLAN_TOL = 5e-4
SERVICE_TOL = 3e-4
PLANS = [(4, 4, 4), (2, 4, 8), (8, 8, 8), (3, 5, 7), (16, 16, 4)]


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
    from repro.kernels import autotune as jat
    from repro.kernels import fourstep_fft as jfs
    from repro.kernels import ops as jops
    from repro.serving import FFTService as JService
    from repro.serving import FFTServiceConfig as JConfig

    return jnp, jat, jfs, jops, JCodedFFT, JService, JConfig


@pytest.fixture
def jtable(jref, private_autotune_table):
    """The JAX package's autotune table, private and empty for the test
    (in the same cache directory as the port's), restored afterwards."""
    jat = jref[1]
    tables, loaded = dict(jat._TABLES), set(jat._LOADED)
    jat._TABLES.clear()
    jat._LOADED.clear()
    yield jat
    jat._TABLES.clear()
    jat._TABLES.update(tables)
    jat._LOADED.clear()
    jat._LOADED.update(loaded)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _crand(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel(got, want):
    """Max-abs error over the largest magnitude, planar pairs or complex."""
    if isinstance(got, (tuple, list)):
        got = _np(got[0]).astype(np.float64) + 1j * _np(got[1])
    if isinstance(want, (tuple, list)):
        want = _np(want[0]).astype(np.float64) + 1j * _np(want[1])
    got = _np(got).astype(np.complex128)
    want = _np(want).astype(np.complex128)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _planar(x, device=CPU):
    return (torch.as_tensor(np.ascontiguousarray(x.real), device=device),
            torch.as_tensor(np.ascontiguousarray(x.imag), device=device))


def _unscramble(out, factors):
    k = len(factors)
    return out.reshape(out.shape[0], *factors).permute(
        0, *range(k, 0, -1)).reshape(out.shape[0], -1)


def _spy(monkeypatch, names):
    calls = []
    for name in names:
        fn = getattr(tops, name)

        def wrapped(*args, _name=name, _fn=fn, **kwargs):
            calls.append(_name)
            return _fn(*args, **kwargs)

        monkeypatch.setattr(tops, name, wrapped)
    return calls


# ------------------------------------------------ the kernel's plain twin
@pytest.mark.parametrize("factors", PLANS + [(64, 64, 64)])
def test_multistep_planes_match_reference(jref, factors):
    jops = jref[3]
    got = tops._multistep_planes(factors)
    want = jops._multistep_planes(factors)
    assert len(got) == len(want) == 4 * len(factors) - 2
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


@pytest.mark.parametrize("ell", [64, 960, 1024, 4096, 1 << 18,
                                 3 * 5 * 7 * 11, 257])
def test_candidate_factor_plans_match_reference(jref, ell):
    jat = jref[1]
    assert autotune.candidate_factor_plans(ell) == \
        jat.candidate_factor_plans(ell)


@pytest.mark.parametrize("factors", PLANS)
def test_multistep_body_matches_reference(jref, factors):
    """The wrapper on CPU tensors (its plain twin) == the Pallas kernel in
    interpret mode, the scrambled digit order included."""
    jnp, _, jfs, jops, _, _, _ = jref
    ell = int(np.prod(factors))
    x = _crand(np.random.default_rng(ell), 3, ell)
    planes = tops._multistep_planes(factors)
    got = multistep_fused(*_planar(x), [torch.as_tensor(p) for p in planes],
                          factors)
    body = multistep_body(*_planar(x), _parse_stage_planes(
        factors, [torch.as_tensor(p) for p in planes]))
    assert _rel(got, body) == 0.0
    want = jfs.multistep_fused(
        jnp.asarray(x.real), jnp.asarray(x.imag),
        [jnp.asarray(p) for p in planes], factors, block_q=3,
        interpret=True)
    assert _rel(got, want) < PAIR_TOL


@pytest.mark.parametrize("factors,batch,tol", [
    *((f, 2, PAIR_TOL) for f in PLANS), ((64, 64, 64), 1, LONG_TOL)])
def test_fourstep_planar_multistep_matches_reference(jref, factors, batch,
                                                      tol):
    jnp, _, _, jops, _, _, _ = jref
    ell = int(np.prod(factors))
    x = _crand(np.random.default_rng(ell + 1), batch, ell)
    got = tops.fourstep_planar(*_planar(x), variant="fused", factors=factors)
    want = jops.fourstep_planar(jnp.asarray(x.real), jnp.asarray(x.imag),
                                variant="fused", factors=factors)
    assert got[0].shape == (batch, ell)
    assert _rel(got, want) < tol
    assert _rel(got, np.fft.fft(x.astype(np.complex128), axis=-1)) < tol


def test_multistep_mode_is_a_function_of_the_plan():
    """Block mode where the layout fits one block's shared memory, else
    per stage: from the plan alone, so the CPU takes the card's choice."""
    assert multistep_layout((4, 4, 4)) == (0, 128, 256, 288, 320, 352)
    for factors in [(16, 16, 4), (4, 4, 4), (3, 5, 7), (8, 8, 8, 8)]:
        assert 4 * multistep_layout(factors)[-1] \
            <= _build.SMEM_PER_BLOCK_OPTIN
        assert multistep_mode(factors) == "block"
    for factors in [(64, 64, 64), (64, 64, 8), (64, 5, 100)]:
        assert 4 * multistep_layout(factors)[-1] \
            > _build.SMEM_PER_BLOCK_OPTIN
        assert multistep_mode(factors) == "per_stage"
    # the largest power-of-two row in one block: L = 8192
    assert multistep_mode((16, 16, 32)) == "block"
    assert multistep_mode((16, 32, 32)) == "per_stage"
    with pytest.raises(ValueError, match="factors"):
        multistep_mode((2,) * (MAX_STAGES + 1))
    with pytest.raises(ValueError, match="shared memory"):
        multistep_mode((30000, 2, 2))
    with pytest.raises(ValueError, match="plan"):
        multistep_fused(torch.zeros(1, 60), torch.zeros(1, 60),
                        tops._multistep_planes((4, 4, 4)), (4, 4, 4))


# ----------------------------------------- the per-stage mode's launches
STAGE_PLANS = [(64, 64, 64), (64, 64, 8), (64, 5, 100), (4, 4, 4),
               (3, 5, 7), (1, 16, 16), (16, 1, 4, 1)]


@pytest.mark.parametrize("factors", STAGE_PLANS)
def test_multistep_stage_plan_matches_body(jref, factors):
    """The per-stage launches, emulated with numpy.fft along each stage's
    axis -- the column FFT of n points down ld columns with the stage's
    twiddle, the last stage a row FFT -- against the port's plain twin
    and the JAX package's ``multistep_body`` on the same input."""
    jnp, _, jfs, _, _, _, _ = jref
    ell, batch = int(np.prod(factors)), 2
    x = _crand(np.random.default_rng(ell + 7), batch, ell)
    planes = tops._multistep_planes(factors)
    stages = _parse_stage_planes(factors, planes)
    plan = multistep_stage_plan(factors, batch)
    assert [p[0] for p in plan] == ["cols"] * (len(factors) - 1) + ["rows"]
    y = x.astype(np.complex128)
    for (kind, bt, n, ld, tile), f, (_, _, twr, twi) in zip(
            plan, factors, stages):
        assert n == f and bt * n * ld == batch * ell
        if kind == "cols":
            assert tile == fft_cols_tile(n, ld)
            tw = twr.astype(np.float64) + 1j * twi
            y = np.fft.fft(y.reshape(bt, n, ld), axis=1) * tw[None]
        else:
            assert ld == 1 and tile == fft_rows_per_block(n)
            y = np.fft.fft(y.reshape(bt, n), axis=1)
    y = y.reshape(batch, ell)
    tstages = [tuple(None if p is None else torch.as_tensor(p) for p in st)
               for st in stages]
    body = multistep_body(*_planar(x), tstages)
    assert _rel(body, y) < LONG_TOL
    jstages = [tuple(None if p is None else jnp.asarray(p) for p in st)
               for st in stages]
    want = jfs.multistep_body(jnp.asarray(x.real), jnp.asarray(x.imag),
                              jstages)
    assert _rel(want, y) < LONG_TOL


def _multistep_lengths():
    return sorted({1 << k for k in range(2, 22)} | {
        960, 3 * 5 * 7 * 11, 4099, 3 * 4099, 6 * 6 * 6 * 6 * 6, 1000000,
        27 * 125 * 49, 3 << 18})


@pytest.mark.parametrize("ell", _multistep_lengths())
def test_multistep_mode_admits_every_autotune_candidate(ell):
    """Every plan the search may time (more than two factors) keeps the
    answer the dense design gave it: block mode where its row fits one
    block, else per stage -- never a refusal."""
    for plan in autotune.candidate_factor_plans(ell):
        if len(plan) <= 2:
            continue
        fits = 4 * multistep_layout(plan)[-1] <= _build.SMEM_PER_BLOCK_OPTIN
        assert multistep_mode(plan) == ("block" if fits else "per_stage")


@pytest.mark.parametrize("factors,mode", [
    ((1, 64, 64, 64), "per_stage"), ((64, 64, 64, 1), "per_stage"),
    ((9392, 2, 2), "per_stage"), ((2, 2, 9392), "per_stage"),
    ((9393, 2, 2), None), ((2, 9393, 2), None), ((30000, 2, 2), None)])
def test_multistep_per_stage_factor_limit(factors, mode):
    """Per stage, a factor runs as the column FFT's one-column tile or the
    row FFT's one-row block: 9392 points is the largest whose two buffers
    and table fit one block; a factor of 1 is a copy (or the twiddle
    alone)."""
    if mode is None:
        with pytest.raises(ValueError, match="shared memory"):
            multistep_mode(factors)
    else:
        assert multistep_mode(factors) == mode


# ------------------------------------------------------ the autotune table
def test_key_of_matches_reference(jref):
    jat = jref[1]
    params = {"L": 1024, "mode": "kernel", "s": 64}
    assert autotune.key_of("fourstep", **params) == \
        jat.key_of("fourstep", **params) == "fourstep|L=1024|mode=kernel|s=64"
    assert autotune.key_of("bucket", s=64, m=2, n=4) == \
        autotune.key_of("bucket", n=4, m=2, s=64)


def test_cold_search_persists_and_warm_skips():
    before = autotune.searches_run()
    ent = autotune.ensure_fourstep(1024, batch=2, device="cpu", reps=1)
    assert autotune.searches_run() == before + 1
    assert ent["variant"] in ("fused", "two_pass")
    assert "xla" not in json.dumps(ent)
    path = autotune.cache_path("cpu")
    assert path.name == "autotune-torch-cpu.json" and path.exists()
    data = json.loads(path.read_text())
    assert data["version"] == autotune.SCHEMA_VERSION
    assert "fourstep|L=1024|mode=plain" in data["entries"]
    assert autotune.ensure_fourstep(1024, batch=2, device="cpu",
                                    reps=1) == ent
    assert autotune.searches_run() == before + 1
    autotune.clear(memory_only=True, backend="cpu")   # a new process
    warm = autotune.ensure_fourstep(1024, batch=2, device="cpu", reps=1)
    assert warm == ent and autotune.searches_run() == before + 1
    autotune.clear(memory_only=False, backend="cpu")
    assert not path.exists()


def test_corrupt_cache_file_tolerated():
    path = autotune.cache_path("cpu")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("{not json")
    autotune.clear(backend="cpu")
    assert autotune.lookup("fourstep", backend="cpu", L=64,
                           mode="plain") is None
    autotune.record("fourstep", {"variant": "fused", "ms": 1.0},
                    backend="cpu", L=64, mode="plain")
    assert json.loads(path.read_text())["entries"]


def test_recorded_multistep_entry_routes_fourstep_planar(monkeypatch):
    calls = _spy(monkeypatch, ["multistep_fused", "fourstep_fused"])
    x = _crand(np.random.default_rng(2), 2, 64)
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert _rel(tops.fourstep_planar(*_planar(x)), want) < PAIR_TOL
    assert calls == ["fourstep_fused"]                # empty table
    autotune.record("fourstep", {"variant": "fused", "factors": [4, 4, 4],
                                 "ms": 0.1}, persist=False, backend="cpu",
                    L=64, mode="plain")
    assert tops.fourstep_route(64, device=CPU) == ("fused", (4, 4, 4))
    calls.clear()
    assert _rel(tops.fourstep_planar(*_planar(x)), want) < PAIR_TOL
    assert calls == ["multistep_fused"]
    calls.clear()                                     # an explicit variant
    tops.fourstep_planar(*_planar(x), variant="two_pass")
    assert calls == []


def test_cache_path_is_the_ports_own(jref):
    jat = jref[1]
    assert autotune.cache_path("cpu") != jat.cache_path("cpu")
    assert autotune.cache_path("cpu").parent == jat.cache_path("cpu").parent
    assert autotune.cache_path("cuda:NVIDIA H100 80GB HBM3").name == \
        "autotune-torch-cuda_NVIDIA_H100_80GB_HBM3.json"


def test_search_skips_only_gate_refusals(monkeypatch):
    """At L = 2^18 the balanced (512, 512) split is past the fused
    kernel's block: the port's gate refuses it before any launch and the
    search skips it; a failing launch propagates."""
    ell = 1 << 18
    with pytest.raises(ValueError, match="two_pass"):
        tops.fourstep_route(ell, variant="fused", factors=(512, 512))
    timed = _spy(monkeypatch, ["multistep_fused", "fourstep_fused",
                               "fourstep_stage1"])
    ent = autotune.tune_fourstep(ell, batch=1, device="cpu", reps=1,
                                 persist=False)
    assert ent["variant"] in ("fused", "two_pass")
    assert ent.get("factors") != [512, 512]
    assert "fourstep_fused" not in timed
    assert timed.count("multistep_fused") == 2 * 3     # 3 plans, warm + 1
    assert timed.count("fourstep_stage1") == 2

    def broken(*args, **kwargs):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(tops, "multistep_fused", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        autotune.tune_fourstep(1024, batch=1, device="cpu", reps=1,
                               persist=False)


def test_search_at_prime_length_times_no_platform_fft(monkeypatch):
    """L = 4099 is prime: its one plan, (1, 4099), and the two-pass pair
    both resolve to the platform FFT, so the search times nothing and
    records that route, which the dispatcher takes there anyway; the
    warm path then runs no search."""
    timed = _spy(monkeypatch, ["fourstep_planar"])
    assert autotune.candidate_factor_plans(4099) == [[1, 4099]]
    before = autotune.searches_run()
    ent = autotune.ensure_fourstep(4099, 8, device="cpu", reps=1)
    assert ent == {"variant": "xla"} and timed == []
    assert autotune.searches_run() == before + 1
    written = json.loads(autotune.cache_path("cpu").read_text())
    assert written["entries"] == {"fourstep|L=4099|mode=plain": ent}
    autotune.clear(backend="cpu")
    assert tops.fourstep_route(4099, device=CPU) == ("xla", None)
    assert autotune.ensure_fourstep(4099, 8, device="cpu") == ent
    assert autotune.searches_run() == before + 1


# --------------------------------------------------------- the service
def _fourstep_lengths(table):
    return {int(k.split("|")[1][2:]) for k in table
            if k.startswith("fourstep|")}


def test_service_warmup_runs_search_once(jtable, jref):
    """The reference's test_service_warmup_runs_search_once config: the
    first port service's warmup searches, a second runs none, and the
    tuned lengths equal the JAX service's."""
    _, _, _, _, _, JService, JConfig = jref
    kw = dict(s=64, m=2, n_workers=4, max_batch=4, autotune_reps=1)
    before = autotune.searches_run()
    FFTService(FFTServiceConfig(**kw), device="cpu").warmup(kinds=("c2c",))
    first = autotune.searches_run()
    assert first > before
    FFTService(FFTServiceConfig(**kw), device="cpu").warmup(kinds=("c2c",))
    assert autotune.searches_run() == first
    JService(JConfig(**kw)).warmup(kinds=("c2c",))
    assert _fourstep_lengths(autotune.load_table("cpu")) == \
        _fourstep_lengths(jtable.load_table()) == {32}
    # the real kinds tune the half shard; autotune=False searches nothing
    FFTService(FFTServiceConfig(**kw), device="cpu").warmup(
        kinds=("r2c",))
    assert _fourstep_lengths(autotune.load_table("cpu")) == {32, 16}
    n = autotune.searches_run()
    FFTService(FFTServiceConfig(**{**kw, "s": 128, "autotune": False}),
               device="cpu").warmup()
    assert autotune.searches_run() == n


def test_coded_fft_run_through_recorded_multistep_entry(jtable, jref,
                                                        monkeypatch):
    """The same (4, 4, 4) entry recorded in both packages' tables: the
    plans' kernel-backend workers run the multistep kernel, on the same
    inputs and masks."""
    jnp, _, _, _, JCodedFFT, _, _ = jref
    s, m, n, q = 256, 4, 8, 3
    entry = {"variant": "fused", "factors": [4, 4, 4], "ms": 0.1}
    autotune.record("fourstep", entry, persist=False, backend="cpu", L=64,
                    mode="plain")
    jtable.record("fourstep", entry, persist=False, L=64, mode="direct")
    rng = np.random.default_rng(11)
    x = _crand(rng, q, s)
    masks = np.zeros((q, n), bool)
    for row in masks:
        row[rng.choice(n, size=m + 1, replace=False)] = True
    calls = _spy(monkeypatch, ["multistep_fused", "fourstep_fused"])
    got = CodedFFT(s=s, m=m, n_workers=n, device="cpu").run(
        torch.as_tensor(x), mask=torch.as_tensor(masks))
    assert calls == ["multistep_fused"]
    want = JCodedFFT(s=s, m=m, n_workers=n).run(jnp.asarray(x),
                                                mask=jnp.asarray(masks))
    assert _rel(got, np.asarray(want)) < PLAN_TOL
    assert _rel(got, np.fft.fft(x.astype(np.complex128), axis=-1)) \
        < PLAN_TOL


def test_config_from_reference_carries_autotune(jref):
    JConfig = jref[6]
    cfg = config_from_reference(dataclasses.asdict(
        JConfig(autotune=False, autotune_reps=7)))
    assert (cfg.autotune, cfg.autotune_reps) == (False, 7)
    dflt = config_from_reference(dataclasses.asdict(JConfig()))
    assert (dflt.autotune, dflt.autotune_reps) == (True, 3) == \
        (JConfig().autotune, JConfig().autotune_reps)


def test_warmup_searches_at_the_served_rows(monkeypatch):
    """The search times the rows the largest warmed bucket gives the
    plans' workers: bucket times n_workers."""
    seen = []
    real = autotune.tune_fourstep

    def spy(ell, batch=4, **kw):
        seen.append((ell, batch))
        return real(ell, batch, **kw)

    monkeypatch.setattr(autotune, "tune_fourstep", spy)
    svc = FFTService(FFTServiceConfig(s=64, m=2, n_workers=4, max_batch=4,
                                      autotune_reps=1), device="cpu")
    svc.warmup(kinds=("c2c",))
    svc.warmup(kinds=("r2c",), buckets=[1, 2])
    assert seen == [(32, 16), (16, 8)]


@pytest.mark.parametrize("kind,s", [("c2c", 4 * 4099), ("r2c", 8 * 4099)])
def test_near_prime_stage_route_matches_reference(jref, kind, s,
                                                  monkeypatch):
    """A shard of 4099 points (prime): the stage route's encode takes the
    two-pass branch (one cmatmul, then the platform FFT on an empty
    table), as in the reference; a same-seed JAX service and numpy
    agree, with equal coded latency, and warmup's search serves the
    length."""
    _, _, _, _, _, JService, JConfig = jref
    for masked in (True, False):
        assert tops.bucket_route(s, 4, 8, kind, masked=masked) == "stage"
    jsvc = JService(JConfig(s=s, m=4, n_workers=8, seed=5, autotune=False))
    tsvc = _port_twin(jsvc)
    rng = np.random.default_rng(s)
    xs = [rng.standard_normal(s).astype(np.float32) for _ in range(3)]
    if kind == "c2c":
        xs = [(x + 1j * rng.standard_normal(s)).astype(np.complex64)
              for x in xs]
        want = [np.fft.fft(x.astype(np.complex128)) for x in xs]
    else:
        want = [np.fft.rfft(x.astype(np.float64)) for x in xs]
    calls = _spy(monkeypatch, ["cmatmul", "encode_fourstep_fused"])
    tout = tsvc.submit_batch(xs, kind=kind)
    assert calls == ["cmatmul"]
    jout = jsvc.submit_batch(xs, kind=kind)
    for t, j, w in zip(tout, jout, want):
        assert _rel(t, w) < SERVICE_TOL
        assert _rel(t, np.asarray(j)) < SERVICE_TOL
    assert tsvc.stats.coded_latency == jsvc.stats.coded_latency
    svc = FFTService(FFTServiceConfig(s=s, autotune_reps=1), device="cpu")
    before = autotune.searches_run()
    assert svc.warmup(kinds=(kind,), buckets=[1]) == 1
    assert autotune.searches_run() == before + 1
    assert _fourstep_lengths(autotune.load_table("cpu")) == {4099}
    assert autotune.lookup("fourstep", backend="cpu", L=4099,
                           mode="plain") == {"variant": "xla"}


# ------------------------------------------------------------ GPU tests
@pytest.mark.gpu
@pytest.mark.parametrize("factors,batch", [
    ((16, 16, 4), 9), ((4, 4, 4), 3), ((3, 5, 7), 5), ((2, 64, 3), 2),
    ((64, 64, 64), 2), ((64, 5, 100), 3), ((7, 11, 13, 31), 2),
    ((16, 16, 16, 2), 2), ((64, 64, 2), 3)])
def test_gpu_multistep_matches_plain(cuda, factors, batch):
    """Both modes of the kernel against the plain twin on the card, its
    launches (one in block mode, one per stage past it), and the
    unscrambled spectrum against torch.fft; (16, 16, 16, 2) and
    (64, 64, 2) are the largest block-mode plans (L = 8192) of the
    autotune candidates."""
    ell = int(np.prod(factors))
    x = _crand(np.random.default_rng(ell), batch, ell)
    xr, xi = _planar(x, cuda)
    planes = tops._on_device(tops._multistep_planes, (factors,), cuda)
    _build.reset_launch_counts()
    got = multistep_fused(xr, xi, planes, factors)
    torch.cuda.synchronize()
    block = multistep_mode(factors) == "block"
    assert _build.launch_counts() == {
        "multistep_fused": 1 if block else len(factors)}
    want = multistep_body(xr, xi, _parse_stage_planes(factors, planes))
    assert _rel(got, want) < PAIR_TOL
    spec = torch.fft.fft(torch.as_tensor(x, device=cuda).to(
        torch.complex128), dim=-1)
    assert _rel([_unscramble(g, factors) for g in got], spec) < LONG_TOL


@pytest.mark.gpu
def test_gpu_recorded_entry_routes_to_multistep(cuda):
    autotune.record("fourstep", {"variant": "fused", "factors": [16, 16, 4],
                                 "ms": 0.1}, persist=False,
                    backend=autotune.backend_of(cuda), L=1024, mode="kernel")
    x = _crand(np.random.default_rng(3), 4, 1024)
    _build.reset_launch_counts()
    got = tops.fourstep_planar(*_planar(x, cuda))
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"multistep_fused": 1}
    assert _rel(got, np.fft.fft(x.astype(np.complex128), axis=-1)) \
        < LONG_TOL


@pytest.mark.gpu
def test_gpu_warmup_search_launches_multistep(cuda):
    """The default service's warmup searches L = 1024 on the card, whose
    candidates include the (16, 16, 4) plan; a second service reads the
    table."""
    before = autotune.searches_run()
    _build.reset_launch_counts()
    FFTService(FFTServiceConfig(s=4096)).warmup(buckets=[1])
    torch.cuda.synchronize()
    assert autotune.searches_run() == before + 1
    assert _build.launch_counts().get("multistep_fused", 0) >= 1
    ent = autotune.lookup("fourstep", backend=autotune.backend_of(cuda),
                          L=1024, mode="kernel")
    assert ent["variant"] in ("fused", "two_pass") and ent["ms"] > 0
    FFTService(FFTServiceConfig(s=4096)).warmup(buckets=[1])
    assert autotune.searches_run() == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("factors,batch", [
    ((64, 64, 64), 2), ((64, 64, 8), 3), ((64, 5, 100), 3),
    ((1, 64, 64, 64), 2), ((300, 7, 1), 2)])
def test_gpu_multistep_per_stage_runs_ffts(cuda, factors, batch):
    """The per-stage mode: k launches, traced as k - 1 column FFTs and one
    row FFT and nothing else, against the plain twin (1e-4) and
    torch.fft."""
    from torch.profiler import ProfilerActivity, profile

    assert multistep_mode(factors) == "per_stage"
    ell = int(np.prod(factors))
    x = _crand(np.random.default_rng(ell + 1), batch, ell)
    xr, xi = _planar(x, cuda)
    planes = tops._on_device(tops._multistep_planes, (factors,), cuda)
    multistep_fused(xr, xi, planes, factors)          # build and warm
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    # the call sits well inside the trace's window: the profiler drops a
    # kernel whose device timestamp, mapped onto the host's clock, falls
    # outside it, and that mapping can run milliseconds early
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        got = multistep_fused(xr, xi, planes, factors)
        torch.cuda.synchronize()
        time.sleep(0.05)
    assert _build.launch_counts() == {"multistep_fused": len(factors)}
    ran = {e.key: e.count for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA}
    assert sum(n for k, n in ran.items() if "fft_cols_kernel" in k) == \
        len(factors) - 1
    assert sum(n for k, n in ran.items() if "fft_rows_kernel" in k) == 1
    assert all("fft_cols_kernel" in k or "fft_rows_kernel" in k
               for k in ran)
    want = multistep_body(xr, xi, _parse_stage_planes(factors, planes))
    assert _rel(got, want) < LONG_TOL
    spec = torch.fft.fft(torch.as_tensor(x, device=cuda).to(
        torch.complex128), dim=-1)
    assert _rel([_unscramble(g, factors) for g in got], spec) < LONG_TOL
