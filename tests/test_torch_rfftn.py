"""The port's n-D real plans (``CodedRFFTN``, ``CodedIRFFTN``), their
symmetry helpers and the service's rfftn / irfftn kinds, against the JAX
package.

CPU tests: the same numpy inputs, made from a seed, go through both
packages; the JAX plans run their kernel backend as their own tests run
it on the CPU.  Stated tolerances:

* complex128 plans: 1e-8 relative against ``numpy.fft.rfftn`` and
  ``irfftn`` (``tests/test_rfftn.py:51``), 1e-7 over every decoding
  subset (``:77``), 1e-8 absolute on the endpoint case (``:106``); 1e-9
  against the JAX plan;
* complex64 plans on the kernel backend (and the complex64 reference
  backend): 1e-5 relative to the largest output against the JAX plan,
  5e-4 against ``numpy.fft`` (``tests/test_torch_plan.py:56-59``);
* the symmetry helpers: 1e-12 / 1e-5 relative (complex128 /
  complex64) against the reference's, 1e-10 on their identities
  (``tests/test_rfftn.py:162``);
* the services, output for output: 1e-5 relative, with equal
  ``coded_latency``, ``requests``, ``batches`` and LRU counters, and
  5e-4 against ``numpy.fft``.

GPU tests (marker ``gpu``, skipped without a CUDA device): the rfftn and
irfftn service buckets on the card against the same service on the
CPU (the kernels' plain versions), their launches (``cmatmul`` and
``fourstep_fused`` only), and ``numpy.fft``.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch
from test_torch_kernels import private_autotune_table  # noqa: F401

from repro_torch import FFTService, FFTServiceConfig
from repro_torch.convert import config_from_reference, generator_from_reference
from repro_torch.core import (
    CodedFFTND,
    CodedIRFFT,
    CodedIRFFTN,
    CodedRFFT,
    CodedRFFTN,
    adjoint_fold_nd,
    hermitian_extend_nd,
    interleave_nd,
    neg_freq,
    pack_half_nd,
    require_even_shards,
    split_packed_nd,
)
from repro_torch.kernels import _build

CPU = torch.device("cpu")
PAIR_TOL = 1e-5
PLAN_TOL = 5e-4
TIERS = [("kernel", torch.complex64), ("reference", torch.complex64),
         ("reference", torch.complex128)]
# tests/test_rfftn.py:38-44
RCASES = [((8, 8), (2, 2), 6), ((16, 4), (4, 1), 5), ((12, 6), (2, 3), 8),
          ((8, 4, 4), (2, 1, 2), 5), ((16,), (4,), 6)]


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
    from repro import core as jcore
    from repro.serving import FFTService as JService
    from repro.serving import FFTServiceConfig as JConfig

    return jnp, jcore, JService, JConfig


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np_dtype(dtype):
    return np.complex64 if dtype == torch.complex64 else np.complex128


def _pair_tol(dtype):
    return 1e-9 if dtype == torch.complex128 else PAIR_TOL


def _truth_tol(dtype):
    return 1e-8 if dtype == torch.complex128 else PLAN_TOL


def _half(rng, shape, dtype=np.complex128):
    """Half spectra of real signals with inconsistent endpoint bins."""
    h = shape[:-1] + (shape[-1] // 2 + 1,)
    return (rng.standard_normal(h) + 1j * rng.standard_normal(h)).astype(
        dtype)


def _axes(shape):
    return tuple(range(-len(shape), 0))


# ---------------------------------------------------------- symmetry ops
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_symmetry_helpers_match_reference(jref, dtype):
    """neg_freq, split_packed_nd, hermitian_extend_nd, pack_half_nd and
    adjoint_fold_nd on the same inputs as the reference's, 2-D and 3-D."""
    jnp, jcore, _, _ = jref
    rng = np.random.default_rng(4)
    tol = 1e-12 if dtype == torch.complex128 else PAIR_TOL
    npdt = _np_dtype(dtype)
    for shape, rest in [((3, 4, 8), (1,)), ((2, 6, 4, 8), (1, 2)),
                        ((5, 8), ())]:
        z = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(npdt)
        zt, zj = torch.as_tensor(z), jnp.asarray(z)
        np.testing.assert_array_equal(neg_freq(zt, rest).numpy(),
                                      np.asarray(jcore.neg_freq(zj, rest)))
        ell = 2 * shape[-1]
        assert _rel(split_packed_nd(zt, ell, rest).numpy(), np.asarray(
            jcore.split_packed_nd(zj, ell, rest))) < tol
        assert _rel(hermitian_extend_nd(zt, rest).numpy(), np.asarray(
            jcore.hermitian_extend_nd(zj, rest))) < tol
        ell = shape[-1]
        assert _rel(pack_half_nd(zt, ell, rest).numpy(), np.asarray(
            jcore.pack_half_nd(zj, ell, rest))) < tol
    jdt = jnp.complex64 if dtype == torch.complex64 else jnp.complex128
    for shape, factors in [((8, 8), (2, 4)), ((12, 6, 4), (3, 2, 2)),
                           ((16,), (4,))]:
        full = (rng.standard_normal((2,) + shape)
                + 1j * rng.standard_normal((2,) + shape)).astype(npdt)
        got = adjoint_fold_nd(torch.as_tensor(full), shape, factors,
                              dtype).numpy()
        want = np.stack([np.asarray(jcore.adjoint_fold_nd(
            jnp.asarray(f), shape, factors, jdt)) for f in full])
        assert _rel(got, want) < tol


def test_adjoint_pack_split_inverses():
    """pack_half_nd inverts split_packed_nd on jointly Hermitian spectra,
    and adjoint_fold_nd's folded shards ifftn to the interleave."""
    rng = np.random.default_rng(2)
    c = rng.normal(size=(3, 4, 8))
    zh = np.fft.fftn(c[..., ::2] + 1j * c[..., 1::2], axes=(1, 2))
    half = split_packed_nd(torch.as_tensor(zh), 8, rest_axes=(1,))
    full = np.fft.fftn(c, axes=(1, 2))
    np.testing.assert_allclose(half.numpy(), full[..., :5], atol=1e-10)
    packed = pack_half_nd(torch.as_tensor(full), 8, rest_axes=(1,))
    np.testing.assert_allclose(packed.numpy(), zh, atol=1e-10)
    ext = hermitian_extend_nd(torch.as_tensor(full[..., :5]), (1,))
    np.testing.assert_allclose(ext.numpy(), full, atol=1e-10)
    shape, factors = (8, 8), (2, 4)
    t = rng.normal(size=shape)
    folded = adjoint_fold_nd(torch.as_tensor(np.fft.fftn(t)), shape,
                             factors, torch.complex128)
    shards = interleave_nd(torch.as_tensor(t), factors).numpy()
    got = np.fft.ifftn(folded.numpy(), axes=(1, 2)) / np.prod(factors)
    np.testing.assert_allclose(got.real, shards, atol=1e-9)
    np.testing.assert_allclose(got.imag, 0, atol=1e-9)


# ------------------------------------------------------------- the plans
def _pair(jref, cls, shape, factors, n, backend, dtype):
    jnp, jcore = jref[:2]
    plan = cls(shape=shape, factors=factors, n_workers=n, dtype=dtype,
               backend=backend, device="cpu")
    jdt = jnp.complex64 if dtype == torch.complex64 else jnp.complex128
    jplan = getattr(jcore, cls.__name__)(shape=shape, factors=factors,
                                         n_workers=n, dtype=jdt,
                                         backend=backend)
    assert plan.resolved_backend == jplan.resolved_backend
    assert plan.worker_shard_shape == tuple(jplan.worker_shard_shape)
    return plan, jplan


def _stages(jref, plan, jplan, x, dtype, n):
    """encode, worker_compute and decode of ``plan`` on the same inputs
    as ``jplan``'s, each within the pair bound; returns the port's
    worker results."""
    jnp = jref[0]
    a = plan.encode(torch.as_tensor(x))
    assert tuple(a.shape) == (n,) + plan.worker_shard_shape
    assert _rel(a.numpy(), np.asarray(jplan.encode(jnp.asarray(x)))) \
        < _pair_tol(dtype)
    b = plan.worker_compute(a)
    assert _rel(b.numpy(), np.asarray(jplan.worker_compute(jnp.asarray(
        a.numpy())))) < _pair_tol(dtype)
    sub = np.arange(n)[::-1][:plan.m][::-1].copy()
    assert _rel(plan.decode(b, subset=torch.as_tensor(sub)).numpy(),
                np.asarray(jplan.decode(jnp.asarray(b.numpy()),
                                        subset=jnp.asarray(sub)))) \
        < _pair_tol(dtype)
    return b


@pytest.mark.parametrize("backend,dtype", TIERS)
@pytest.mark.parametrize("shape,factors,n", RCASES)
def test_rfftn_stages_match_reference(jref, shape, factors, n, backend,
                                      dtype):
    plan, jplan = _pair(jref, CodedRFFTN, shape, factors, n, backend, dtype)
    rng = np.random.default_rng(sum(shape))
    t = rng.standard_normal(shape)
    if dtype == torch.complex64:
        t = t.astype(np.float32)
    _stages(jref, plan, jplan, t, dtype, n)
    got = plan.run(torch.as_tensor(t)).numpy()
    want = np.fft.rfftn(t.astype(np.float64))
    assert got.shape == want.shape and got.dtype == _np_dtype(dtype)
    assert _rel(got, want) < _truth_tol(dtype)


@pytest.mark.parametrize("backend,dtype", TIERS)
@pytest.mark.parametrize("shape,factors,n", RCASES)
def test_irfftn_stages_match_reference(jref, shape, factors, n, backend,
                                       dtype):
    """Half spectra with inconsistent endpoint bins: the message stage's
    symmetrisation reproduces ``numpy.fft.irfftn``."""
    plan, jplan = _pair(jref, CodedIRFFTN, shape, factors, n, backend,
                        dtype)
    rng = np.random.default_rng(sum(shape) + 1)
    y = _half(rng, shape, _np_dtype(dtype))
    _stages(jref, plan, jplan, y, dtype, n)
    got = plan.run(torch.as_tensor(y)).numpy()
    want = np.fft.irfftn(y.astype(np.complex128), s=shape,
                         axes=_axes(shape))
    assert got.shape == shape and not np.iscomplexobj(got)
    assert _rel(got, want) < _truth_tol(dtype)


@pytest.mark.parametrize("backend,dtype", TIERS)
@pytest.mark.parametrize("shape,factors,n", RCASES)
def test_rfftn_irfftn_roundtrip(shape, factors, n, backend, dtype):
    """``rfftn`` then ``irfftn`` through the plans returns the signal,
    batched, with per-request masks."""
    kw = dict(shape=shape, factors=factors, n_workers=n, dtype=dtype,
              backend=backend, device="cpu")
    rng = np.random.default_rng(7)
    t = rng.standard_normal((3,) + shape)
    m = int(np.prod(factors))
    masks = torch.as_tensor(np.stack([np.roll(np.arange(n) < m, 2 * i)
                                      for i in range(3)]))
    y = CodedRFFTN(**kw).run(torch.as_tensor(t), mask=masks)
    back = CodedIRFFTN(**kw).run(y, mask=masks).numpy()
    assert _rel(back, t) < _truth_tol(dtype)


@pytest.mark.parametrize("backend,dtype", TIERS)
@pytest.mark.parametrize("cls", [CodedRFFTN, CodedIRFFTN])
def test_every_subset_with_nan_stragglers(jref, cls, backend, dtype):
    """Any m-subset decodes through its mask with the other rows
    NaN-poisoned: no NaN is read; numpy within the bound (1e-7 at
    complex128); the JAX plan's decode of the same rows."""
    jnp = jref[0]
    shape, factors, n = (8, 8), (2, 2), 6
    plan, jplan = _pair(jref, cls, shape, factors, n, backend, dtype)
    rng = np.random.default_rng(3)
    if cls is CodedRFFTN:
        x = rng.standard_normal(shape)
        want = np.fft.rfftn(x)
    else:
        x = _half(rng, shape)
        want = np.fft.irfftn(x, s=shape, axes=(0, 1))
    if dtype == torch.complex64:
        x = x.astype(np.float32 if cls is CodedRFFTN else np.complex64)
    b = plan.worker_compute(plan.encode(torch.as_tensor(x))).numpy()
    for k, sub in enumerate(itertools.combinations(range(n), plan.m)):
        mask = np.zeros(n, bool)
        mask[list(sub)] = True
        poisoned = np.where(mask[:, None, None], b, np.nan).astype(b.dtype)
        got = plan.decode(torch.as_tensor(poisoned),
                          mask=torch.as_tensor(mask)).numpy()
        assert not np.isnan(got).any(), sub
        tol = 1e-7 if dtype == torch.complex128 else PLAN_TOL
        assert _rel(got, want) < tol, sub
        if k % 5 == 0:
            assert _rel(got, np.asarray(jplan.decode(
                jnp.asarray(poisoned), mask=jnp.asarray(mask)))) \
                < _pair_tol(dtype)


@pytest.mark.parametrize("shape,factors", [((8, 8), (2, 2)),
                                           ((8, 4, 4), (2, 1, 2))])
def test_irfftn_inconsistent_endpoints_match_numpy_exactly(shape, factors):
    rng = np.random.default_rng(11)
    y = _half(rng, shape)
    plan = CodedIRFFTN(shape=shape, factors=factors, n_workers=6,
                       dtype=torch.complex128, backend="reference",
                       device="cpu")
    got = plan.run(torch.as_tensor(y)).numpy()
    want = np.fft.irfftn(y, s=shape, axes=_axes(shape))
    assert np.abs(got - want).max() < 1e-8


def test_nd_real_plans_reduce_to_1d():
    """shape = (s,): the same transform and shard payload as the 1-D
    real plans."""
    s, m, n = 64, 4, 8
    kw = dict(n_workers=n, dtype=torch.complex128, backend="reference",
              device="cpu")
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=s))
    p1, pn = CodedRFFT(s=s, m=m, **kw), CodedRFFTN(shape=(s,), factors=(m,),
                                                   **kw)
    assert pn.worker_shard_shape == p1.worker_shard_shape
    np.testing.assert_allclose(pn.run(x).numpy(), p1.run(x).numpy(),
                               atol=1e-9)
    y = torch.as_tensor(np.fft.rfft(x.numpy()))
    i1 = CodedIRFFT(s=s, m=m, **kw)
    in_ = CodedIRFFTN(shape=(s,), factors=(m,), **kw)
    np.testing.assert_allclose(in_.run(y).numpy(), i1.run(y).numpy(),
                               atol=1e-9)


def test_rfftn_payload_is_half_of_c2c_nd():
    shape, factors, n = (16, 16), (2, 2), 8
    c2c = CodedFFTND(shape=shape, factors=factors, n_workers=n, device="cpu")
    r2c = CodedRFFTN(shape=shape, factors=factors, n_workers=n, device="cpu")
    assert (2 * np.prod(r2c.worker_shard_shape)
            == np.prod(c2c.worker_shard_shape))
    a = r2c.encode(torch.zeros(shape))
    assert tuple(a.shape) == (n,) + r2c.worker_shard_shape
    assert a.dtype == torch.complex64


def test_rfftn_kernel_backend_batched_masks(jref):
    """Kernel backend, a batch of three with per-request masks: as the
    JAX plan (1e-5) and numpy (5e-4)."""
    jnp = jref[0]
    plan, jplan = _pair(jref, CodedRFFTN, (16, 16), (2, 2), 6, "kernel",
                        torch.complex64)
    rng = np.random.default_rng(7)
    tb = rng.normal(size=(3, 16, 16)).astype(np.float32)
    masks = np.stack([np.roll(np.arange(6) < 4, i) for i in range(3)])
    got = plan.run(torch.as_tensor(tb), mask=torch.as_tensor(masks)).numpy()
    assert _rel(got, np.fft.rfftn(tb.astype(np.float64), axes=(-2, -1))) \
        < PLAN_TOL
    assert _rel(got, np.asarray(jplan.run(jnp.asarray(tb),
                                          mask=jnp.asarray(masks)))) \
        < PAIR_TOL


@pytest.mark.parametrize("dtype,atol", [(torch.complex64, 1e-6),
                                        (torch.complex128, 1e-12)])
def test_generator_matches_reference(jref, dtype, atol):
    """The n-D plans carry no weights: their (N, m) generator is
    ``rs_generator``, the reference's (through
    ``convert.generator_from_reference``) within a rounding of the
    dtype: atol 1e-6 at complex64 (two f32 roundings of unit entries),
    1e-12 at complex128."""
    for cls in (CodedRFFTN, CodedIRFFTN, CodedFFTND):
        plan, jplan = _pair(jref, cls, (8, 8), (2, 2), 6, "kernel", dtype)
        jg = np.asarray(jplan.generator)
        gr, gi = generator_from_reference(jg, CPU)
        torch.testing.assert_close(plan.generator.real.float(), gr, rtol=0,
                                   atol=max(atol, 1e-7))
        torch.testing.assert_close(plan.generator.imag.float(), gi, rtol=0,
                                   atol=max(atol, 1e-7))
        assert np.abs(plan.generator.numpy() - jg).max() < atol


def test_even_shard_value_error_matches_reference(jref):
    """The documented ``2m | s`` error, word for word, from both
    packages' plans and helper."""
    jcore = jref[1]

    def text(call):
        with pytest.raises(ValueError, match=r"2m \| s") as err:
            call()
        return str(err.value)

    for cls in ("CodedRFFTN", "CodedIRFFTN"):
        kw = dict(shape=(8, 6), factors=(2, 2), n_workers=8)
        assert text(lambda: globals()[cls](**kw, device="cpu")) == \
            text(lambda: getattr(jcore, cls)(**kw))
    assert text(lambda: require_even_shards(30, 6, axis=1)) == \
        text(lambda: jcore.require_even_shards(30, 6, axis=1))
    require_even_shards(60, 6)


# ------------------------------------------------------------ the service
def _services(jref, **kw):
    """A same-seed reference service and its port twin (the reference's
    config and generator)."""
    _, _, JService, JConfig = jref
    jsvc = JService(JConfig(**{"s": 256, "m": 4, "n_workers": 8,
                               "autotune": False, **kw}))
    jcfg = jsvc.cfg
    cfg = config_from_reference(
        {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    tsvc = FFTService(cfg, device="cpu")
    tsvc.load_generator(*generator_from_reference(
        np.asarray(jsvc.plan.generator), CPU))
    return jsvc, tsvc


def _stats(svc):
    st = svc.stats
    return (st.requests, st.batches, st.coded_latency, st.uncoded_latency,
            st.stragglers_tolerated, st.host_transfers,
            st.decode_cache_hits, st.decode_cache_misses)


def _same_outputs(a, b):
    assert len(a) == len(b)
    for j, t in zip(a, b):
        j = np.asarray(j)
        assert t.shape == j.shape and t.dtype == j.dtype
        assert _rel(t, j) < PAIR_TOL


@pytest.mark.parametrize("cfg", [dict(seed=3), dict(seed=5, max_batch=2),
                                 dict(seed=1, device_decode=False),
                                 dict(seed=2, dtype="complex128"),
                                 dict(seed=4, use_reference=True)])
def test_service_nd_kinds_match_reference(jref, cfg):
    """rfftn then irfftn batches (one bucket each, or several past
    ``max_batch``), then the single-request conveniences: outputs within
    1e-5 of the reference service's and 5e-4 of numpy, the same draws
    (``coded_latency``), counters and LRU counters."""
    jnp = jref[0]
    if cfg.get("dtype") == "complex128":
        cfg = dict(cfg, dtype=jnp.complex128)
    jsvc, tsvc = _services(jref, **cfg)
    rng = np.random.default_rng(1)
    ts = [rng.normal(size=(16, 16)).astype(np.float32) for _ in range(5)]
    ys = [np.fft.rfftn(t).astype(np.complex64) for t in ts]
    outs = {}
    for reqs, kind in [(ts, "rfftn"), (ys, "irfftn")]:
        want = jsvc.submit_batch([jnp.asarray(r) for r in reqs], kind=kind)
        outs[kind] = tsvc.submit_batch([torch.as_tensor(r) for r in reqs],
                                       kind=kind)
        _same_outputs(want, outs[kind])
        assert _stats(tsvc) == _stats(jsvc)
    for y, t in zip(outs["rfftn"], ts):
        assert _rel(y, np.fft.rfftn(t.astype(np.float64))) < PLAN_TOL
    for z, t in zip(outs["irfftn"], ts):
        assert _rel(z, t) < PLAN_TOL
    _same_outputs([jsvc.submit_rfftn(jnp.asarray(ts[1])),
                   jsvc.submit_irfftn(jnp.asarray(ys[1]))],
                  [tsvc.submit_rfftn(ts[1]), tsvc.submit_irfftn(ys[1])])
    assert _stats(tsvc) == _stats(jsvc)
    assert not tsvc._kernel_path((16, 16), "rfftn")
    assert not tsvc._kernel_path((16, 16), "irfftn")


@pytest.mark.parametrize("device_decode", [True, False])
def test_service_mixed_kinds_match_reference(jref, device_decode):
    """One call mixing all five kinds (the n-D ones twice, at two shapes),
    then again: the buckets drawn in the reference's order, outputs in
    submission order, equal counters and LRU counters."""
    jnp = jref[0]
    jsvc, tsvc = _services(jref, seed=9, device_decode=device_decode)
    rng = np.random.default_rng(2)
    t = rng.normal(size=(16, 16)).astype(np.float32)
    t3 = rng.normal(size=(8, 4, 8)).astype(np.float32)
    x1 = (rng.normal(size=256) + 1j * rng.normal(size=256)).astype(
        np.complex64)
    xr = rng.normal(size=256).astype(np.float32)
    yh = np.fft.rfft(xr).astype(np.complex64)
    yn = np.fft.rfftn(t).astype(np.complex64)
    reqs = [x1, t, xr, yh, yn, t3, t, x1]
    kinds = ["c2c", "rfftn", "r2c", "c2r", "irfftn", "rfftn", "rfftn", "c2c"]
    for _ in range(2):
        want = jsvc.submit_batch([jnp.asarray(r) for r in reqs], kind=kinds)
        got = tsvc.submit_batch(reqs, kind=kinds)
        _same_outputs(want, got)
        assert _stats(tsvc) == _stats(jsvc)
    assert tsvc.stats.batches == 12
    assert _rel(got[1], np.fft.rfftn(t.astype(np.float64))) < PLAN_TOL
    assert _rel(got[5], np.fft.rfftn(t3.astype(np.float64))) < PLAN_TOL
    assert _rel(got[4], t) < PLAN_TOL


@pytest.mark.parametrize("kind,shape", [("rfftn", (4, 7)),
                                        ("irfftn", (3, 2)),
                                        ("rfftn", (3, 3, 2)),
                                        ("irfftn", (5, 4))])
def test_nd_length_error_after_draws_as_reference(jref, kind, shape):
    """A request no factor placement serves (an odd last axis; m = 4
    split across (3, 1), (3, 3, 1) or (5, 3) once the last axis is
    halved), behind a c2c request in one call: both services raise the
    plan's ValueError, word for word, after the draws of both buckets, so
    the counters stay equal -- then and after a following call."""
    jnp = jref[0]
    jsvc, tsvc = _services(jref, seed=2)
    rng = np.random.default_rng(0)
    x0 = (rng.normal(size=256) + 1j * rng.normal(size=256)).astype(
        np.complex64)
    x1 = (rng.normal(size=shape).astype(np.float32) if kind == "rfftn"
          else np.ones(shape, np.complex64))
    errors = []
    for svc, wrap in ((jsvc, jnp.asarray), (tsvc, np.asarray)):
        with pytest.raises(ValueError) as err:
            svc.submit_batch([wrap(x0), wrap(x1)], ["c2c", kind])
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert _stats(tsvc) == _stats(jsvc)
    assert jsvc.stats.requests == 2
    xs = [x0] * 3
    _same_outputs(jsvc.submit_batch([jnp.asarray(x) for x in xs]),
                  tsvc.submit_batch(xs))
    assert _stats(tsvc) == _stats(jsvc)


def test_nd_bin_count_error_as_reference(jref):
    """An irfftn request of one bin: the reference's ValueError, before
    any draw."""
    jnp = jref[0]
    jsvc, tsvc = _services(jref, seed=2)
    y = np.ones((4, 1), np.complex64)
    texts = []
    for svc, wrap in ((jsvc, jnp.asarray), (tsvc, np.asarray)):
        with pytest.raises(ValueError, match="half-spectrum bins") as err:
            svc.submit_irfftn(wrap(y))
        texts.append(str(err.value))
    assert texts[0] == texts[1]
    assert _stats(tsvc) == _stats(jsvc)
    assert tsvc.stats.requests == 0


WARMUP_ND = {
    "shapes_both_kinds": dict(lengths=[(16, 16), (8, 12)],
                              kinds=("rfftn", "irfftn")),
    "mixed_lengths": dict(lengths=[256, (16, 16), [8, 4, 4]],
                          kinds=("c2c", "rfftn", "r2c", "irfftn")),
    "odd_last_axis": dict(lengths=[(16, 16), (4, 7)], kinds=("rfftn",)),
    "unplaceable": dict(lengths=[(3, 3, 2)], kinds=("irfftn",)),
}


@pytest.mark.parametrize("autotune_on", [False, True])
@pytest.mark.parametrize("case", sorted(WARMUP_ND))
def test_warmup_with_shape_tuples_as_reference(jref, private_autotune_table,
                                               case, autotune_on):
    """``warmup`` with shape tuples: the reference's count, or its
    exception type and text; no four-step search for the n-D kinds, so
    no table entry beyond the 1-D pairs', and no executor run before an
    invalid pair is refused."""
    from repro_torch.kernels import autotune

    jsvc, tsvc = _services(jref, seed=2, autotune=autotune_on)
    kw = dict(WARMUP_ND[case], buckets=[1, 2])

    def outcome(call):
        try:
            return "ok", call()
        except Exception as err:        # noqa: BLE001 -- compared below
            return type(err).__name__, str(err)

    searches = autotune.searches_run()
    want = outcome(lambda: jsvc.warmup(**kw))
    got = outcome(lambda: tsvc.warmup(**kw))
    assert got == want
    if got[0] != "ok":
        assert tsvc._runners == {}
    if autotune_on and case == "mixed_lengths":
        # the 1-D pairs' searches only: c2c at L = 64, r2c at L = 32
        assert autotune.searches_run() - searches == 2
        assert sorted(autotune.load_table()) == [
            "fourstep|L=32|mode=plain", "fourstep|L=64|mode=plain"]
    else:
        assert autotune.searches_run() == searches
        assert autotune.load_table() == {}


def test_service_charges_nd_kinds_half_the_wire(jref):
    """The same seed draws the n-D kinds' arrivals with the halved wire
    share, as the reference's ``REAL_KINDS`` does."""
    from repro.distributed.straggler import StragglerModel as JStraggler

    wire = JStraggler(t0=1.0, mu=1.0, wire_frac=0.5)
    jsvc, tsvc = _services(jref, seed=0, straggler=wire)
    _, csvc = _services(jref, seed=0, straggler=wire)
    for kind in ("rfftn", "irfftn", "c2c"):
        lt, _ = tsvc._simulate_arrivals(256, kind=kind)
        lj, _ = jsvc._simulate_arrivals(256, kind=kind)
        np.testing.assert_array_equal(lt, lj)
    lr, _ = csvc._simulate_arrivals(4096, kind="rfftn")
    lc, _ = FFTService(csvc.cfg, device="cpu")._simulate_arrivals(4096)
    assert lr.mean() < lc.mean()
    assert set(FFTService.REAL_KINDS) >= set(FFTService.ND_KINDS)
    assert FFTService.KINDS == ("c2c", "r2c", "c2r", "rfftn", "irfftn")


# ------------------------------------------------------------ GPU tests
@pytest.mark.gpu
@pytest.mark.parametrize("kind,shape,n_req", [("rfftn", (64, 64), 32),
                                              ("irfftn", (64, 64), 32),
                                              ("rfftn", (8, 4, 4), 1),
                                              ("irfftn", (12, 6), 3)])
def test_gpu_service_nd_kinds(cuda, kind, shape, n_req):
    """The n-D buckets on the card: launches ``cmatmul`` (one, two for a
    bucket of one) and ``fourstep_fused`` (once an axis) and nothing
    else; the CPU service of the same seed within 1e-5 (the kernels'
    plain versions), numpy within 5e-4."""
    cfg = FFTServiceConfig(s=256, m=4, n_workers=8, seed=6, autotune=False)
    rng = np.random.default_rng(n_req)
    t = rng.normal(size=(n_req,) + shape).astype(np.float32)
    axes = tuple(range(1, len(shape) + 1))
    reqs = (list(t) if kind == "rfftn" else
            list(np.fft.rfftn(t, axes=axes).astype(np.complex64)))
    want = (np.fft.rfftn(t.astype(np.float64), axes=axes)
            if kind == "rfftn" else t)
    svc = FFTService(cfg, device=cuda)
    _build.reset_launch_counts()
    got = np.stack(svc.submit_batch(reqs, kind=kind))
    assert _build.launch_counts() == {"cmatmul": 2 if n_req == 1 else 1,
                                      "fourstep_fused": len(shape)}
    twin = np.stack(FFTService(cfg, device="cpu").submit_batch(reqs,
                                                               kind=kind))
    assert _rel(got, twin) < PAIR_TOL
    assert _rel(got, want) < PLAN_TOL
