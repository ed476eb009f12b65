"""The port's Reed-Solomon code and closed-form Lagrange decode against the
JAX package's ``repro.core.mds``, over EVERY responder subset of small
codes.  Tolerances: 1e-10 at complex128 (both sides are exact up to the
subset's conditioning, which is O(1)-O(10) at these sizes) and 1e-4 at
complex64 (f32 rounding of O(m) products); ``D @ G == I`` at the same.
"""

import importlib
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import mds as tmds
from repro_torch.kernels import coded_pipeline as tcp
from repro_torch.kernels import ops as tops

CODES = [(8, 4), (6, 4), (7, 3)]
TOL = {torch.complex128: 1e-10, torch.complex64: 1e-4}
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
    import jax
    from repro.core import mds
    from repro.kernels import coded_pipeline

    return jax, jnp, mds, coded_pipeline


def _jdtype(jnp, dtype):
    return jnp.complex128 if dtype == torch.complex128 else jnp.complex64


def _all_subsets(n, m):
    return np.array(list(itertools.combinations(range(n), m)), np.int32)


def _all_masks(n):
    return np.array([[(k >> i) & 1 for i in range(n)] for k in range(2 ** n)],
                    bool)


@pytest.mark.parametrize("n,m", CODES)
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_generator_matches_reference(jref, n, m, dtype):
    _, jnp, jmds, _ = jref
    want = np.asarray(jmds.rs_generator(n, m, _jdtype(jnp, dtype)))
    got = tmds.rs_generator(n, m, dtype, CPU).numpy()
    assert np.abs(got - want).max() < TOL[dtype]
    np.testing.assert_allclose(
        tmds.rs_nodes(n, dtype, CPU).numpy(),
        np.asarray(jmds.rs_nodes(n, _jdtype(jnp, dtype))), atol=TOL[dtype])


@pytest.mark.parametrize("n,m", CODES)
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_lagrange_inverse_every_subset(jref, n, m, dtype):
    jax, jnp, jmds, _ = jref
    subsets = _all_subsets(n, m)
    want = np.asarray(jax.jit(jax.vmap(
        lambda s: jmds.lagrange_inverse(s, n, _jdtype(jnp, dtype))))(
            jnp.asarray(subsets)))
    got = tmds.lagrange_inverse(torch.as_tensor(subsets), n, dtype).numpy()
    assert np.abs(got - want).max() < TOL[dtype]
    # the defining property: inv(G[subset]) @ G[subset] == I
    g = tmds.rs_generator(n, m, dtype, CPU)
    eye = torch.as_tensor(got) @ g[torch.as_tensor(subsets).long()]
    assert (eye - torch.eye(m, dtype=dtype)).abs().max() < TOL[dtype]


@pytest.mark.parametrize("n,m", CODES)
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_lagrange_decode_matrices_every_mask(jref, n, m, dtype):
    """Scatter matrices for all 2^N masks (short rows included: the first
    non-responders fill the subset, exactly as the reference)."""
    jax, jnp, jmds, _ = jref
    masks = _all_masks(n)
    want = np.asarray(jax.jit(jmds.lagrange_decode_matrices,
                              static_argnums=(1, 2))(
        jnp.asarray(masks), m, _jdtype(jnp, dtype)))
    got = tmds.lagrange_decode_matrices(torch.as_tensor(masks), m, dtype)
    assert np.abs(got.numpy() - want).max() < TOL[dtype]
    # D @ G == I wherever at least m workers responded
    ok = torch.as_tensor(masks.sum(1) >= m)
    g = tmds.rs_generator(n, m, dtype, CPU)
    eye = got[ok] @ g
    assert (eye - torch.eye(m, dtype=dtype)).abs().max() < TOL[dtype]


@pytest.mark.parametrize("n,m", CODES)
def test_lagrange_planes_body_every_subset(jref, n, m):
    """The f32-plane construction the bucket kernel mirrors == the
    reference's plane body (and == the complex64 closed form)."""
    jax, jnp, _, jcp = jref
    subsets = _all_subsets(n, m)
    want = [np.asarray(p) for p in jax.jit(
        jcp.lagrange_planes_body, static_argnums=1)(jnp.asarray(subsets), n)]
    got = [p.numpy() for p in tcp.lagrange_planes_body(
        torch.as_tensor(subsets), n)]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() < 1e-4
    dr, di = tops.lagrange_scatter_planes(torch.as_tensor(subsets), n)
    g64 = tmds.rs_generator(n, m, torch.complex64, CPU)
    eye = torch.complex(dr, di) @ g64
    assert (eye - torch.eye(m, dtype=torch.complex64)).abs().max() < 1e-4


@pytest.mark.parametrize("n,m", CODES)
def test_decode_from_subset_ignores_stragglers(jref, n, m):
    _, jnp, jmds, _ = jref
    rng = np.random.default_rng(n * m)
    c = (rng.standard_normal((m, 5)) + 1j * rng.standard_normal((m, 5)))
    g = tmds.rs_generator(n, m, torch.complex128, CPU)
    b = tmds.encode(g, torch.as_tensor(c))
    for subset in _all_subsets(n, m)[::3]:
        poisoned = b.clone()
        stragglers = np.setdiff1d(np.arange(n), subset)
        poisoned[torch.as_tensor(stragglers)] = float("nan")
        got = tmds.decode_from_subset(g, poisoned, torch.as_tensor(subset))
        assert np.abs(got.numpy() - c).max() < 1e-10
        want = np.asarray(jmds.decode_from_subset(
            jnp.asarray(np.asarray(g)), jnp.asarray(poisoned.numpy()),
            jnp.asarray(subset)))
        assert np.abs(got.numpy() - want).max() < 1e-10


@pytest.mark.parametrize("n,m", CODES)
def test_lagrange_decode_coeffs_match_reference(jref, n, m):
    """Locator coefficients and 1/A'(x_j) for every subset (complex128)."""
    jax, jnp, jmds, _ = jref
    subsets = _all_subsets(n, m)
    ja, jd = jax.jit(jax.vmap(
        lambda s: jmds.lagrange_decode_coeffs(s, n, m)))(jnp.asarray(subsets))
    for subset, wa, wd in zip(subsets, np.asarray(ja), np.asarray(jd)):
        ta, td = tmds.lagrange_decode_coeffs(torch.as_tensor(subset), n, m)
        assert np.abs(ta.numpy() - wa).max() < 1e-10
        assert np.abs(td.numpy() - wd).max() < 1e-10


@pytest.mark.parametrize("n,m", CODES)
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_encode_and_masked_decode_match_reference(jref, n, m, dtype):
    """Dense and DFT encode, first-available subsets, masked decode."""
    _, jnp, jmds, _ = jref
    jdt = _jdtype(jnp, dtype)
    rng = np.random.default_rng(7 * n + m)
    c = (rng.standard_normal((m, 3, 4))
         + 1j * rng.standard_normal((m, 3, 4))).astype(
             np.complex128 if dtype == torch.complex128 else np.complex64)
    g = tmds.rs_generator(n, m, dtype, CPU)
    jg = jmds.rs_generator(n, m, jdt)
    a = tmds.encode(g, torch.as_tensor(c))
    assert np.abs(a.numpy() - np.asarray(jmds.encode(jg, jnp.asarray(c)))
                  ).max() < TOL[dtype] * 10
    assert (tmds.encode_dft(torch.as_tensor(c), n) - a).abs().max() \
        < TOL[dtype] * 10
    for mask in _all_masks(n)[::5]:
        if mask.sum() < m:
            continue
        got = tmds.decode_masked(g, a, torch.as_tensor(mask)).numpy()
        assert np.abs(got - c).max() < TOL[dtype] * 10
        subset = tmds.first_available(torch.as_tensor(mask), m)
        np.testing.assert_array_equal(
            subset.numpy(), np.asarray(jmds.first_available(
                jnp.asarray(mask), m)))


@pytest.mark.parametrize("s,m", [(96, 3), (768, 4), (12, 12)])
def test_interleave_and_recombine_match_reference(jref, s, m):
    _, jnp, _, _ = jref
    jil = importlib.import_module("repro.core.interleave")
    jrc = importlib.import_module("repro.core.recombine")
    til = importlib.import_module("repro_torch.core.interleave")
    trc = importlib.import_module("repro_torch.core.recombine")

    rng = np.random.default_rng(s)
    x = rng.standard_normal((s, 2)) + 1j * rng.standard_normal((s, 2))
    c = til.interleave(torch.as_tensor(x), m)
    np.testing.assert_array_equal(c.numpy(), np.asarray(
        jil.interleave(jnp.asarray(x), m)))
    np.testing.assert_array_equal(til.deinterleave(c).numpy(), x)
    c_hat = torch.fft.fft(c[..., 0], dim=-1)       # (m, L) sub-transforms
    for sign in (-1.0, 1.0):
        got = trc.recombine(c_hat, s, sign).numpy()
        want = np.asarray(jrc.recombine(jnp.asarray(c_hat.numpy()), s, sign))
        assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()
    np.testing.assert_allclose(trc.recombine(c_hat, s).numpy(),
                               np.fft.fft(x[:, 0]), atol=1e-9 * s)
    np.testing.assert_allclose(
        trc.twiddle(s, m, torch.complex128).numpy(),
        np.asarray(jrc.twiddle(s, m, jnp.complex128)), atol=1e-12)
    np.testing.assert_allclose(
        trc.dft_matrix(m, torch.complex128, 1.0).numpy(),
        np.asarray(jrc.dft_matrix(m, jnp.complex128, 1.0)), atol=1e-12)
