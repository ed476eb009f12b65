"""The direct (off-accelerator) bucket executors against the JAX
package's: ``lagrange_compact_planes``, the three ``*_body_fftworker``
bodies and ``coded_bucket_direct``, ``coded_rbucket_direct``,
``coded_irbucket_direct``, on the same numpy inputs and responder
subsets, each also against ``numpy.fft`` and against the kind's masked
whole-bucket plain twin on the same masks.  The service does not route
to them (it runs the card's routes on every device); they are plain
PyTorch, as the reference's are XLA on the host.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import mds
from repro_torch.kernels import coded_pipeline as tcp
from repro_torch.kernels import ops as tops

# (m, N, s): s divisible by 2m for the real kinds
CONFIGS = [(4, 8, 128), (3, 5, 96), (1, 3, 64), (2, 2, 32)]
TOL = 3e-4          # the reference's whole-bucket bound


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jref():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import coded_pipeline as jcp
    from repro.kernels import ops as jops

    return jnp, jcp, jops


def _masks(q, n, m, seed):
    rng = np.random.default_rng(seed)
    masks = np.zeros((q, n), bool)
    for row in masks:
        row[rng.choice(n, size=int(rng.integers(m, n + 1)),
                       replace=False)] = True
    return masks


def _case(m, n, s, seed):
    """Requests, masks, subsets, the generator planes and the compact
    decode planes, as numpy float32 / int32."""
    q = 5
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((q, s))
         + 1j * rng.standard_normal((q, s))).astype(np.complex64)
    masks = _masks(q, n, m, seed)
    subsets = tops.mask_subsets(torch.as_tensor(masks), m).numpy()
    g = mds.rs_generator(n, m, torch.complex64).numpy()
    dvr, dvi = (t.numpy() for t in tops.lagrange_compact_planes(
        torch.as_tensor(subsets), n))
    return x, masks, subsets, g, dvr, dvi


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(*arrays):
    return tuple(torch.as_tensor(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("m,n,s", CONFIGS)
def test_lagrange_compact_planes_match_reference(jref, m, n, s):
    jnp, _, jops = jref
    _, _, subsets, g, dvr, dvi = _case(m, n, s, 1)
    jr, ji = jops.lagrange_compact_planes(jnp.asarray(subsets), n)
    np.testing.assert_allclose(dvr, np.asarray(jr), atol=1e-6)
    np.testing.assert_allclose(dvi, np.asarray(ji), atol=1e-6)
    inv = np.linalg.inv(g.astype(np.complex128)[subsets])
    np.testing.assert_allclose(dvr + 1j * dvi, inv, atol=1e-5)


@pytest.mark.parametrize("m,n,s", CONFIGS)
def test_c2c_direct_matches_reference(jref, m, n, s):
    jnp, jcp, jops = jref
    x, masks, subsets, g, dvr, dvi = _case(m, n, s, 2)
    args = (x.real, x.imag, dvr, dvi, subsets, g.real, g.imag)
    yr, yi = tops.coded_bucket_direct(*_t(*args), s)
    jyr, jyi = jops.coded_bucket_direct(*(jnp.asarray(a) for a in args), s)
    got = (yr + 1j * yi).numpy()
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert _rel(got, want) < TOL
    assert _rel(got, np.asarray(jyr) + 1j * np.asarray(jyi)) < TOL
    # the body with the reference's planes, and the masked bucket's twin
    planes = [np.asarray(p) for p in jops._recombine_planes(s, m)]
    br, bi = tcp.bucket_body_fftworker(*_t(*args, *planes))
    jbr, jbi = jcp.bucket_body_fftworker(
        *(jnp.asarray(a) for a in (*args, *planes)))
    assert _rel((br + 1j * bi).numpy(),
                np.asarray(jbr) + 1j * np.asarray(jbi)) < TOL
    mr, mi = tops.coded_bucket_masked(*_t(x.real, x.imag, masks, g.real,
                                          g.imag), s)
    assert _rel(got, (mr + 1j * mi).numpy()) < TOL


@pytest.mark.parametrize("m,n,s", CONFIGS)
def test_r2c_direct_matches_reference(jref, m, n, s):
    jnp, jcp, jops = jref
    x, masks, subsets, g, dvr, dvi = _case(m, n, s, 3)
    xr = x.real.copy()
    args = (xr, dvr, dvi, subsets, g.real, g.imag)
    yr, yi = tops.coded_rbucket_direct(*_t(*args), s)
    jyr, jyi = jops.coded_rbucket_direct(*(jnp.asarray(a) for a in args), s)
    got = (yr + 1j * yi).numpy()
    want = np.fft.rfft(xr.astype(np.float64), axis=-1)
    assert _rel(got, want) < TOL
    assert _rel(got, np.asarray(jyr) + 1j * np.asarray(jyi)) < TOL
    planes = [np.asarray(p) for p in jops._r2c_postdecode_planes(s, m)]
    br, bi = tcp.rbucket_body_fftworker(*_t(*args, *planes), s)
    jbr, jbi = jcp.rbucket_body_fftworker(
        *(jnp.asarray(a) for a in (*args, *planes)), s)
    assert _rel((br + 1j * bi).numpy(),
                np.asarray(jbr) + 1j * np.asarray(jbi)) < TOL
    mr, mi = tops.coded_rbucket_masked(*_t(xr, masks, g.real, g.imag), s)
    assert _rel(got, (mr + 1j * mi).numpy()) < TOL


@pytest.mark.parametrize("m,n,s", CONFIGS)
def test_c2r_direct_matches_reference(jref, m, n, s):
    jnp, jcp, jops = jref
    x, masks, subsets, g, dvr, dvi = _case(m, n, s, 4)
    y = np.fft.rfft(x.real.astype(np.float64), axis=-1).astype(np.complex64)
    args = (y.real, y.imag, dvr, dvi, subsets, g.real, g.imag)
    got = tops.coded_irbucket_direct(*_t(*args), s).numpy()
    jgot = jops.coded_irbucket_direct(*(jnp.asarray(a) for a in args), s)
    want = np.fft.irfft(y.astype(np.complex128), n=s, axis=-1)
    assert _rel(got, want) < TOL
    assert _rel(got, np.asarray(jgot)) < TOL
    planes = [np.asarray(p) for p in jops._c2r_message_planes(s, m)]
    body = tcp.irbucket_body_fftworker(*_t(*args, *planes), s).numpy()
    jbody = jcp.irbucket_body_fftworker(
        *(jnp.asarray(a) for a in (*args, *planes)), s)
    assert _rel(body, np.asarray(jbody)) < TOL
    masked = tops.coded_irbucket_masked(*_t(y.real, y.imag, masks, g.real,
                                            g.imag), s).numpy()
    assert _rel(got, masked) < TOL


def test_direct_reads_only_the_subset_rows():
    """The gathered decode never reads a straggler's row: NaN in every
    coded row outside the subsets leaves the output finite (the bodies'
    encode is computed from the message, so poison the gather's input
    through a generator row no subset uses)."""
    m, n, s = 2, 5, 32
    x, _, _, g, _, _ = _case(m, n, s, 5)
    subsets = np.tile(np.array([[0, 3]], np.int32), (x.shape[0], 1))
    dvr, dvi = (t.numpy() for t in tops.lagrange_compact_planes(
        torch.as_tensor(subsets), n))
    g = g.copy()
    g[[1, 2, 4]] = np.nan
    yr, yi = tops.coded_bucket_direct(*_t(x.real, x.imag, dvr, dvi, subsets,
                                          g.real, g.imag), s)
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert _rel((yr + 1j * yi).numpy(), want) < TOL
