"""The port's n-D complex plans (``CodedFFTND``, ``CodedFFTMultiInput``),
their glue and the n-D four-step sweep, against the JAX package.

CPU tests: the same numpy inputs, made from a seed, go through both
packages; the JAX plans run their kernel backend as their own tests run
it on the CPU, and the reference's sweep runs its Pallas kernel in
interpret mode.  Stated tolerances:

* complex128 plans: atol 1e-8 against ``numpy.fft.fftn``
  (``tests/test_ndim.py:54``), 1e-7 over every decoding subset (``:64``)
  and 1e-6 on drawn subsets (``:106``); 1e-9 against the JAX plan;
* complex64 plans on the kernel backend: 1e-5 relative to the largest
  output against the JAX plan, 5e-4 against ``numpy.fft`` (the port's
  plan limits, ``tests/test_torch_plan.py:56-59``); the complex64
  reference backend the same;
* the glue (interleave, recombine): bit for bit where it only moves
  data, 1e-12 / 1e-5 relative (complex128 / complex64) where it sums;
* ``plan_factors``: the same factors, or the same ``ValueError`` text.

GPU tests (marker ``gpu``, skipped without a CUDA device): the n-D sweep
``ops.make_kernel_fftn_fn`` on the card against its plain twin (the same
sweep on the CPU, whose wrappers run the kernels' plain versions) at
1e-5, at axis lengths 1, 2, 3 and 6 and at one request's coded shards
of the smoke run's 2048 x 2048 rfftn cell, and its launches.
"""

import itertools

import numpy as np
import pytest
import torch
from test_torch_kernels import private_autotune_table  # noqa: F401

from repro_torch.core import (
    CodedFFT,
    CodedFFTMultiInput,
    CodedFFTND,
    CodedIFFT,
    CodedIRFFT,
    CodedIRFFTN,
    CodedPlan,
    CodedRFFT,
    CodedRFFTN,
    MDSPlan,
    deinterleave_nd,
    interleave_nd,
    plan_factors,
    recombine_nd,
)
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops

CPU = torch.device("cpu")
PAIR_TOL = 1e-5
PLAN_TOL = 5e-4
ATOL_128 = 1e-8
# (backend, dtype): the kernel backend, and the two reference tiers
TIERS = [("kernel", torch.complex64), ("reference", torch.complex64),
         ("reference", torch.complex128)]
ND_CASES = [((8, 8), (2, 2), 6), ((4, 6), (2, 3), 8),
            ((8, 4, 4), (2, 1, 2), 5), ((16,), (4,), 6)]
MULTI_CASES = [(4, (8,), 2, (2,), 6), (2, (4, 4), 2, (2, 1), 6),
               (6, (6,), 3, (1,), 5), (2, (8,), 1, (4,), 6)]


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
    from repro.kernels import ops as jops

    return jnp, jcore, jops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cplx(rng, shape, dtype=np.complex128):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np_dtype(dtype):
    return np.complex64 if dtype == torch.complex64 else np.complex128


def _jdtype(jnp, dtype):
    return jnp.complex64 if dtype == torch.complex64 else jnp.complex128


def _check(got, want, dtype, truth=False):
    """The stated bound: atol 1e-8 (complex128 against numpy), else
    relative (1e-9 complex128 pairs, 1e-5 / 5e-4 complex64)."""
    if dtype == torch.complex128:
        if truth:
            np.testing.assert_allclose(np.asarray(got), want, atol=ATOL_128)
        else:
            assert _rel(got, want) < 1e-9
    else:
        assert _rel(got, want) < (PLAN_TOL if truth else PAIR_TOL)


# ----------------------------------------------------------------- glue
@pytest.mark.parametrize("shape,factors", [((4, 6), (2, 3)),
                                           ((8, 12, 6), (2, 3, 2)),
                                           ((8, 4, 4), (2, 1, 2)),
                                           ((16,), (4,))])
def test_interleave_nd_matches_reference(jref, shape, factors):
    """Bit for bit against the reference, unbatched and with two leading
    batch axes; ``deinterleave_nd`` inverts it."""
    jnp, jcore, _ = jref
    rng = np.random.default_rng(sum(shape))
    t = _cplx(rng, (2, 3) + shape)
    got = interleave_nd(torch.as_tensor(t), factors).numpy()
    want = np.stack([np.stack([np.asarray(jcore.interleave_nd(
        jnp.asarray(t[i, j]), factors)) for j in range(3)])
        for i in range(2)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        interleave_nd(torch.as_tensor(t[0, 0]), factors).numpy(), want[0, 0])
    back = deinterleave_nd(torch.as_tensor(got), factors, shape).numpy()
    np.testing.assert_array_equal(back, t)
    np.testing.assert_array_equal(
        deinterleave_nd(torch.as_tensor(got[1, 2]), factors, shape).numpy(),
        np.asarray(jcore.deinterleave_nd(jnp.asarray(want[1, 2]), factors,
                                         shape)))


def test_interleave_nd_layout():
    """``c_(i)[j] = t[i_k + j_k * m_k]`` (paper eq. 28, strides m_k)."""
    t = torch.arange(24.0).reshape(4, 6)
    c = interleave_nd(t, (2, 3))
    for i0, i1, j0, j1 in itertools.product(range(2), range(3), range(2),
                                            range(2)):
        assert float(c[i0 * 3 + i1, j0, j1]) == float(t[i0 + j0 * 2,
                                                        i1 + j1 * 3])
    with pytest.raises(ValueError, match="must divide"):
        interleave_nd(t, (3, 3))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("shape,factors", [((8, 8), (2, 2)),
                                           ((4, 6), (2, 3)),
                                           ((12, 6, 4), (3, 2, 1)),
                                           ((8, 4, 4), (2, 1, 2))])
def test_recombine_nd_matches_reference(jref, shape, factors, dtype):
    """Decoded sub-transforms of a random tensor: the port's batched
    recombine against the reference's, per batch row, and the
    sub-transforms of ``t``'s shards recombine to ``fftn(t)``."""
    jnp, jcore, _ = jref
    rng = np.random.default_rng(len(shape) * 7 + sum(factors))
    m = int(np.prod(factors))
    ells = tuple(s // f for s, f in zip(shape, factors))
    c = _cplx(rng, (3, m) + ells, _np_dtype(dtype))
    got = recombine_nd(torch.as_tensor(c), shape, factors).numpy()
    want = np.stack([np.asarray(jcore.recombine_nd(jnp.asarray(ci), shape,
                                                   factors)) for ci in c])
    assert got.dtype == c.dtype
    assert _rel(got, want) < (1e-12 if dtype == torch.complex128 else 1e-5)
    t = _cplx(rng, shape)
    shards = np.asarray(interleave_nd(torch.as_tensor(t), factors))
    sub = np.fft.fftn(shards, axes=tuple(range(1, len(shape) + 1)))
    np.testing.assert_allclose(
        recombine_nd(torch.as_tensor(sub), shape, factors).numpy(),
        np.fft.fftn(t), atol=1e-9)


PLAN_FACTOR_SHAPES = [(8, 8), (16, 16), (4, 6), (6, 4), (6, 4, 10), (3, 3),
                      (12, 6), (16, 4), (8, 4, 4), (5, 7), (9, 9, 2), (1, 8),
                      (8, 1), (10,), (7,), (2048, 2048), (256, 256, 256),
                      (512, 512), (4, 7), (4, 6, 6), (18, 12)]


def _outcome(call):
    try:
        return "ok", call()
    except ValueError as err:
        return "ValueError", str(err)


@pytest.mark.parametrize("shape", PLAN_FACTOR_SHAPES)
def test_plan_factors_matches_reference(jref, shape):
    """Every m in 1..12, 16, 24, 64, with ``even_last_shard`` off and
    on: the same factors (ties keep the first axis; the even-shard path
    recurses on a halved last axis) or the same ValueError text."""
    _, jcore, _ = jref
    for m, even in itertools.product([*range(1, 13), 16, 24, 64],
                                     (False, True)):
        got = _outcome(lambda: plan_factors(shape, m, even_last_shard=even))
        want = _outcome(lambda: jcore.plan_factors(shape, m,
                                                   even_last_shard=even))
        assert got == want, (shape, m, even)
        if got[0] == "ok":
            f = got[1]
            assert int(np.prod(f)) == m
            assert all(s % k == 0 for s, k in zip(shape, f))
            if even:
                assert shape[-1] % (2 * f[-1]) == 0


def test_plan_factors_ties_and_even_shard():
    """Equal quotients keep the first axis; the even-shard placement
    serves shapes the plain greedy split would give an odd last shard."""
    assert plan_factors((8, 8), 2) == (2, 1)
    assert plan_factors((8, 8), 4) == (2, 2)
    assert plan_factors((2048, 2048), 4, even_last_shard=True) == (4, 1)
    assert plan_factors((4, 6), 4) == (2, 2)
    assert plan_factors((4, 6), 4, even_last_shard=True) == (4, 1)
    with pytest.raises(ValueError, match="cannot split m=4"):
        plan_factors((3, 3), 4)
    with pytest.raises(ValueError, match=r"2m \| s"):
        plan_factors((4, 7), 2, even_last_shard=True)


# ------------------------------------------------------------ CodedFFTND
def _nd_pair(jref, shape, factors, n, backend, dtype):
    jnp, jcore, _ = jref
    plan = CodedFFTND(shape=shape, factors=factors, n_workers=n, dtype=dtype,
                      backend=backend, device="cpu")
    jplan = jcore.CodedFFTND(shape=shape, factors=factors, n_workers=n,
                             dtype=_jdtype(jnp, dtype), backend=backend)
    assert plan.resolved_backend == jplan.resolved_backend
    return plan, jplan


@pytest.mark.parametrize("backend,dtype", TIERS)
@pytest.mark.parametrize("shape,factors,n", ND_CASES)
def test_fftnd_stages_match_reference(jref, shape, factors, n, backend,
                                      dtype):
    """encode, worker_compute and decode, each on the same inputs as the
    JAX plan's, and run against ``numpy.fft.fftn``."""
    jnp = jref[0]
    plan, jplan = _nd_pair(jref, shape, factors, n, backend, dtype)
    rng = np.random.default_rng(sum(shape) + n)
    t = _cplx(rng, shape, _np_dtype(dtype))
    a = plan.encode(torch.as_tensor(t))
    assert tuple(a.shape) == (n,) + plan.worker_shard_shape
    _check(a.numpy(), np.asarray(jplan.encode(jnp.asarray(t))), dtype)
    b = plan.worker_compute(a)
    _check(b.numpy(), np.asarray(jplan.worker_compute(jnp.asarray(
        a.numpy()))), dtype)
    sub = np.array([n - 1 - i for i in range(plan.m)][::-1])
    got = plan.decode(b, subset=torch.as_tensor(sub))
    _check(got.numpy(), np.asarray(jplan.decode(jnp.asarray(b.numpy()),
                                                subset=jnp.asarray(sub))),
           dtype)
    _check(plan.run(torch.as_tensor(t)).numpy(), np.fft.fftn(
        t.astype(np.complex128)), dtype, truth=True)


@pytest.mark.parametrize("backend,dtype", TIERS)
@pytest.mark.parametrize("shape,factors,n", ND_CASES)
def test_fftnd_every_subset_nan_stragglers(jref, shape, factors, n, backend,
                                           dtype):
    """Every m-subset decodes through its mask with the other workers'
    rows NaN-poisoned: no NaN reads, the truth within the bound, and the
    JAX plan's decode of the same rows."""
    jnp = jref[0]
    plan, jplan = _nd_pair(jref, shape, factors, n, backend, dtype)
    rng = np.random.default_rng(3 * n)
    t = _cplx(rng, shape, _np_dtype(dtype))
    want = np.fft.fftn(t.astype(np.complex128))
    b = plan.worker_compute(plan.encode(torch.as_tensor(t))).numpy()
    lead = (slice(None),) + (None,) * len(shape)
    for k, sub in enumerate(itertools.combinations(range(n), plan.m)):
        mask = np.zeros(n, bool)
        mask[list(sub)] = True
        poisoned = np.where(mask[lead], b, np.nan).astype(b.dtype)
        got = plan.decode(torch.as_tensor(poisoned),
                          mask=torch.as_tensor(mask)).numpy()
        assert not np.isnan(got).any(), sub
        if dtype == torch.complex128:
            np.testing.assert_allclose(got, want, atol=1e-7)
        else:
            assert _rel(got, want) < PLAN_TOL, sub
        if k % 4 == 0:
            _check(got, np.asarray(jplan.decode(jnp.asarray(poisoned),
                                                mask=jnp.asarray(mask))),
                   dtype)


@pytest.mark.parametrize("backend,dtype", TIERS)
def test_fftnd_batched_masks_match_reference(jref, backend, dtype):
    """A batch of three with per-request masks (the per-request solve),
    a shared subset, and a pinned transform decode: as the JAX plan."""
    jnp = jref[0]
    shape, factors, n = (8, 4, 4), (2, 1, 2), 7
    plan, jplan = _nd_pair(jref, shape, factors, n, backend, dtype)
    rng = np.random.default_rng(11)
    t = _cplx(rng, (3,) + shape, _np_dtype(dtype))
    want = np.fft.fftn(t.astype(np.complex128), axes=(1, 2, 3))
    masks = np.stack([np.roll(np.arange(n) < 5, i) for i in range(3)])
    for kw, jkw in [
            (dict(mask=torch.as_tensor(masks)), dict(mask=jnp.asarray(masks))),
            (dict(subset=torch.tensor([1, 3, 4, 6])),
             dict(subset=jnp.asarray([1, 3, 4, 6]))),
            (dict(method="ifft"), dict(method="ifft"))]:
        got = plan.run(torch.as_tensor(t), **kw).numpy()
        _check(got, want, dtype, truth=True)
        _check(got, np.asarray(jplan.run(jnp.asarray(t), **jkw)), dtype)


def test_fftnd_drawn_subsets():
    """Drawn 2-D configs and subsets (``tests/test_ndim.py:94``'s law),
    complex128: atol 1e-6."""
    rng = np.random.default_rng(5)
    for _ in range(20):
        d0, d1 = rng.choice([4, 6, 8], 2)
        m0, m1 = rng.choice([1, 2], 2)
        m = int(m0 * m1)
        n = m + int(rng.integers(0, 5))
        t = _cplx(rng, (d0, d1))
        plan = CodedFFTND(shape=(int(d0), int(d1)),
                          factors=(int(m0), int(m1)), n_workers=n,
                          dtype=torch.complex128, device="cpu")
        b = plan.worker_compute(plan.encode(torch.as_tensor(t)))
        sub = torch.as_tensor(rng.choice(n, size=m, replace=False))
        np.testing.assert_allclose(plan.decode(b, subset=sub).numpy(),
                                   np.fft.fftn(t), atol=1e-6)


def test_fftnd_validates():
    with pytest.raises(ValueError, match="must divide"):
        CodedFFTND(shape=(8, 6), factors=(2, 4), n_workers=9, device="cpu")
    with pytest.raises(ValueError, match="N >= m"):
        CodedFFTND(shape=(8, 8), factors=(2, 2), n_workers=3, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        CodedFFTND(shape=(8, 8), factors=(2, 2), n_workers=4,
                   backend="bogus", device="cpu")


# ---------------------------------------------------- CodedFFTMultiInput
def _multi_pair(jref, q, shape, m_tilde, factors, n, backend, dtype):
    jnp, jcore, _ = jref
    kw = dict(q=q, shape=shape, m_tilde=m_tilde, factors=factors,
              n_workers=n, backend=backend)
    plan = CodedFFTMultiInput(**kw, dtype=dtype, device="cpu")
    jplan = jcore.CodedFFTMultiInput(**kw, dtype=_jdtype(jnp, dtype))
    return plan, jplan


@pytest.mark.parametrize("backend,dtype", TIERS)
@pytest.mark.parametrize("q,shape,m_tilde,factors,n", MULTI_CASES)
def test_multi_input_stages_match_reference(jref, q, shape, m_tilde,
                                            factors, n, backend, dtype):
    jnp = jref[0]
    plan, jplan = _multi_pair(jref, q, shape, m_tilde, factors, n, backend,
                              dtype)
    rng = np.random.default_rng(q * 10 + n)
    t = _cplx(rng, (q,) + shape, _np_dtype(dtype))
    c = plan.message(torch.as_tensor(t))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jplan.message(
        jnp.asarray(t))))
    a = plan.encode(torch.as_tensor(t))
    assert int(np.prod(a.shape[1:])) == q * int(np.prod(shape)) // plan.m
    _check(a.numpy(), np.asarray(jplan.encode(jnp.asarray(t))), dtype)
    b = plan.worker_compute(a)
    _check(b.numpy(), np.asarray(jplan.worker_compute(jnp.asarray(
        a.numpy()))), dtype)
    sub = np.arange(n)[::-1][:plan.m].copy()
    _check(plan.decode(b, subset=torch.as_tensor(sub)).numpy(),
           np.asarray(jplan.decode(jnp.asarray(b.numpy()),
                                   subset=jnp.asarray(sub))), dtype)
    want = np.fft.fftn(t.astype(np.complex128),
                       axes=tuple(range(1, len(shape) + 1)))
    _check(plan.run(torch.as_tensor(t)).numpy(), want, dtype, truth=True)


@pytest.mark.parametrize("backend,dtype", TIERS)
def test_multi_input_every_subset_nan_stragglers(jref, backend, dtype):
    q, shape, m_tilde, factors, n = 4, (4, 4), 2, (2, 1), 7
    plan, jplan = _multi_pair(jref, q, shape, m_tilde, factors, n, backend,
                              dtype)
    jnp = jref[0]
    rng = np.random.default_rng(5)
    t = _cplx(rng, (q,) + shape, _np_dtype(dtype))
    want = np.fft.fftn(t.astype(np.complex128), axes=(1, 2))
    b = plan.worker_compute(plan.encode(torch.as_tensor(t))).numpy()
    for k, sub in enumerate(itertools.combinations(range(n), plan.m)):
        mask = np.zeros(n, bool)
        mask[list(sub)] = True
        poisoned = np.where(mask[:, None, None, None], b,
                            np.nan).astype(b.dtype)
        got = plan.decode(torch.as_tensor(poisoned),
                          mask=torch.as_tensor(mask)).numpy()
        assert not np.isnan(got).any(), sub
        if dtype == torch.complex128:
            np.testing.assert_allclose(got, want, atol=1e-7)
        else:
            assert _rel(got, want) < PLAN_TOL, sub
        if k % 8 == 0:
            _check(got, np.asarray(jplan.decode(jnp.asarray(poisoned),
                                                mask=jnp.asarray(mask))),
                   dtype)


def test_multi_input_validates():
    with pytest.raises(ValueError, match="m_tilde must divide q"):
        CodedFFTMultiInput(q=3, shape=(8,), m_tilde=2, factors=(2,),
                           n_workers=6, device="cpu")
    plan = CodedFFTMultiInput(q=2, shape=(8,), m_tilde=2, factors=(2,),
                              n_workers=6, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        plan.message(torch.zeros(3, 8, dtype=torch.complex64))


# ------------------------------------------------------------- protocols
def _all_plans():
    kw = dict(n_workers=6, device="cpu")
    return [CodedFFT(s=16, m=4, **kw), CodedRFFT(s=16, m=4, **kw),
            CodedIFFT(s=16, m=4, **kw), CodedIRFFT(s=16, m=4, **kw),
            CodedFFTND(shape=(4, 4), factors=(2, 2), **kw),
            CodedRFFTN(shape=(4, 8), factors=(2, 2), **kw),
            CodedIRFFTN(shape=(4, 8), factors=(2, 2), **kw),
            CodedFFTMultiInput(q=4, shape=(8,), m_tilde=2, factors=(2,),
                               **kw)]


def _jplan_of(jcore, plan):
    """The reference plan with the port plan's fields."""
    name = type(plan).__name__
    fields = {k: getattr(plan, k) for k in (
        "s", "m", "shape", "factors", "q", "m_tilde") if k in
        plan.__dataclass_fields__}
    return getattr(jcore, name)(n_workers=plan.n_workers, **fields)


def _plan_input(plan, rng):
    if isinstance(plan, (CodedRFFT, CodedRFFTN)):
        return rng.standard_normal(plan.input_shape)
    return _cplx(rng, plan.input_shape)


def test_every_plan_satisfies_the_protocols(jref):
    """Every plan is a ``CodedPlan`` and an ``MDSPlan`` with the
    reference's ``decode_width``, ``decodable`` and shapes; its
    ``message`` and public ``postdecode`` match the reference's, and
    ``postdecode`` of the decoded shards is the plan's output."""
    jnp, jcore, _ = jref
    rng = np.random.default_rng(2)
    for plan in _all_plans():
        name = type(plan).__name__
        jplan = _jplan_of(jcore, plan)
        assert isinstance(plan, CodedPlan) and isinstance(plan, MDSPlan), \
            name
        assert plan.decode_width == jplan.decode_width == plan.m
        assert tuple(plan.worker_shard_shape) == tuple(
            jplan.worker_shard_shape)
        assert plan.input_shape == tuple(jplan.input_shape)
        assert plan.output_shape == tuple(jplan.output_shape)
        assert plan.recovery_threshold == jplan.recovery_threshold
        torch.testing.assert_close(plan.decode_generator, plan.generator)
        for mask in (None, np.arange(6) < 4, np.arange(6) < 3,
                     torch.arange(6) % 2 == 0):
            jmask = None if mask is None else np.asarray(mask)
            assert plan.decodable(mask) == jplan.decodable(jmask), name
        x = _plan_input(plan, rng)
        c = plan.message(torch.as_tensor(x))
        assert tuple(c.shape) == (plan.m,) + tuple(plan.worker_shard_shape)
        assert _rel(c.numpy(), np.asarray(jplan.message(jnp.asarray(x)))) \
            < PAIR_TOL, name
        c_hat = plan.worker_compute(c)
        out = plan.postdecode(c_hat)
        assert _rel(out.numpy(), np.asarray(jplan.postdecode(jnp.asarray(
            c_hat.numpy())))) < PAIR_TOL, name
        assert _rel(out.numpy(), plan.run(torch.as_tensor(x)).numpy()) \
            < PLAN_TOL, name
        with pytest.raises(ValueError, match="rank"):
            plan.postdecode(c_hat[0])
    assert not isinstance(object(), CodedPlan)


# ----------------------------------------------------- the n-D sweep
# worker arrays whose shard axes are 1, 2, 3 and 6 long: the packed
# shards of (8, 4, 4) / (2, 1, 2), (16, 4) / (4, 1), (12, 6) / (2, 3),
# a (6, 6) c2c shard of (12, 12) / (2, 2) and every length at once
TINY_SHAPES = [(5, 4, 4, 1), (5, 4, 2), (8, 6, 1), (4, 3, 3), (2, 6, 6),
               (2, 1, 2, 3, 6)]


@pytest.mark.parametrize("shape", TINY_SHAPES)
def test_fftn_sweep_tiny_axes(jref, shape):
    """``make_kernel_fftn_fn`` at the tiny axis lengths: each routes to
    the fused four-step with factors (1, 1), (1, 2), (1, 3) or (2, 3)
    (the kernel the reference runs there too), and the sweep matches the
    reference's sweep (Pallas, interpret mode) and ``numpy.fft.fftn``."""
    jnp, _, jops = jref
    nd = len(shape) - 1
    for ell in shape[1:]:
        variant, factors = tops.fourstep_route(ell)
        assert variant == "fused" and factors == tops.split_factor(ell)
    rng = np.random.default_rng(sum(shape))
    a = _cplx(rng, shape, np.complex64)
    got = tops.make_kernel_fftn_fn(nd)(torch.as_tensor(a)).numpy()
    want = np.fft.fftn(a.astype(np.complex128),
                       axes=tuple(range(1, nd + 1)))
    assert _rel(got, want) < PLAN_TOL
    jgot = jops.make_kernel_fftn_fn(nd, interpret=True)(jnp.asarray(a))
    assert _rel(got, np.asarray(jgot)) < PAIR_TOL


def test_fftn_sweep_is_one_call_per_axis(monkeypatch):
    """Every row of every leading axis goes through ONE four-step call an
    axis: three calls for a (2, 5, 4, 6, 8) batch of 3-D shards, each on
    the axis's rows made contiguous."""
    calls = []
    real = tops.fourstep_planar

    def spy(xr, xi, **kw):
        assert xr.is_contiguous() and xi.is_contiguous()
        calls.append(tuple(xr.shape))
        return real(xr, xi, **kw)

    monkeypatch.setattr(tops, "fourstep_planar", spy)
    a = torch.as_tensor(_cplx(np.random.default_rng(0), (2, 5, 4, 6, 8),
                              np.complex64))
    out = tops.make_kernel_fftn_fn(3)(a)
    assert calls == [(2 * 5 * 6 * 8, 4), (2 * 5 * 4 * 8, 6),
                     (2 * 5 * 4 * 6, 8)]
    assert _rel(out.numpy(), np.fft.fftn(a.numpy().astype(np.complex128),
                                         axes=(2, 3, 4))) < PLAN_TOL


# ------------------------------------------------------------ GPU tests
@pytest.mark.gpu
@pytest.mark.parametrize("shape", TINY_SHAPES + [(8, 512, 1024)])
def test_gpu_fftn_sweep_matches_plain(cuda, shape):
    """The sweep on the card against the same sweep on the CPU (the
    kernels' plain versions), 1e-5 relative: one ``fourstep_fused``
    launch an axis (fft_block_kernel at A = 1 and B <= 3 included), and
    ``numpy.fft.fftn`` within 5e-4.  The last shape is one request's
    eight coded shards in the smoke run's 2048 x 2048 rfftn cell."""
    nd = len(shape) - 1
    rng = np.random.default_rng(sum(shape))
    a = _cplx(rng, shape, np.complex64)
    sweep = tops.make_kernel_fftn_fn(nd)
    _build.reset_launch_counts()
    got = sweep(torch.as_tensor(a, device=cuda))
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"fourstep_fused": nd}
    twin = sweep(torch.as_tensor(a)).numpy()
    assert _rel(got.cpu().numpy(), twin) < PAIR_TOL
    want = np.fft.fftn(a.astype(np.complex128), axes=tuple(range(1, nd + 1)))
    assert _rel(got.cpu().numpy(), want) < PLAN_TOL


@pytest.mark.gpu
def test_gpu_fftnd_plan_launches(cuda):
    """``CodedFFTND.run`` on the card: one mask (``cmatmul`` encode and
    decode), then a batch with per-request masks (one ``cmatmul``), the
    sweep's ``fourstep_fused`` once an axis; numpy within 5e-4."""
    shape, factors, n = (32, 16, 24), (2, 2, 2), 12
    plan = CodedFFTND(shape=shape, factors=factors, n_workers=n,
                      device=cuda)
    rng = np.random.default_rng(1)
    t = _cplx(rng, (2,) + shape, np.complex64)
    want = np.fft.fftn(t.astype(np.complex128), axes=(1, 2, 3))
    masks = np.stack([np.roll(np.arange(n) < 8, i) for i in (0, 5)])
    for x, mk, w, n_cm in [(t[0], masks[0], want[0], 2),
                           (t, masks, want, 1)]:
        _build.reset_launch_counts()
        got = plan.run(torch.as_tensor(x, device=cuda),
                       mask=torch.as_tensor(mk, device=cuda))
        torch.cuda.synchronize()
        assert _build.launch_counts() == {"cmatmul": n_cm,
                                          "fourstep_fused": 3}
        assert _rel(got.cpu().numpy(), w) < PLAN_TOL
