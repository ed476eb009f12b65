"""Byzantine fault detection & correction (paper Remark 3) on the port's
plans, against the JAX package's ``core/fault_tolerance.py`` on the same
numpy inputs: syndromes, detection, Prony location, correction,
``robust_decode`` and ``RobustCodedFFT`` -- complex128 on the reference
backend, as the reference's tests run them, and complex64 on the kernel
backend (the CPU's plain twins)."""

import numpy as np
import pytest
import torch
from _hypothesis_shim import given, settings, st
from test_torch_kernels import private_autotune_table  # noqa: F401

from repro_torch.core import CodedFFT, RobustCodedFFT, mds, robust_decode
from repro_torch.core.fault_tolerance import (
    detect_errors,
    lagrange_weights,
    locate_errors,
    syndromes,
)

C128 = torch.complex128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jref():
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import CodedFFT as JCodedFFT
    from repro.core import fault_tolerance as jft
    from repro.core import mds as jmds

    return jnp, JCodedFFT, jft, jmds


def _rand(s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=s) + 1j * rng.normal(size=s)


def _setup(s=64, m=4, n=12, seed=0, dtype=C128):
    strat = CodedFFT(s=s, m=m, n_workers=n, dtype=dtype, device="cpu")
    x = _rand(s, seed)
    b = strat.worker_compute(strat.encode(torch.as_tensor(x)))
    return strat, x, b.numpy()


def _nodes(n, recv):
    return mds.rs_nodes(n, C128).numpy()[recv]


def test_syndromes_vanish_for_clean_codeword(jref):
    _, _, jft, jmds = jref
    strat, x, b = _setup()
    recv = np.arange(10)
    nodes = _nodes(strat.n_workers, recv)
    s = syndromes(nodes, b[recv], strat.m)
    assert np.abs(s).max() < 1e-9 * max(1.0, np.abs(b).max())
    # the reference's nodes and syndromes on the same rows
    jnodes = np.asarray(jmds.rs_nodes(12, jref[0].complex128))[recv]
    np.testing.assert_allclose(nodes, jnodes, atol=1e-15)
    np.testing.assert_allclose(s, jft.syndromes(nodes, b[recv], strat.m),
                               atol=1e-12)
    np.testing.assert_allclose(lagrange_weights(nodes),
                               jft.lagrange_weights(nodes), rtol=1e-12)


def test_detect_single_error(jref):
    _, _, jft, _ = jref
    strat, x, b = _setup()
    recv = np.arange(10)
    nodes = _nodes(strat.n_workers, recv)
    assert not detect_errors(nodes, b[recv], strat.m)
    bad = b[recv].copy()
    bad[3] += 10.0
    assert detect_errors(nodes, bad, strat.m)
    assert jft.detect_errors(nodes, bad, strat.m)


def test_detect_max_errors(jref):
    """Up to k - m arbitrary errors are always detected."""
    _, _, jft, _ = jref
    strat, x, b = _setup(m=4, n=12)
    recv = np.arange(9)  # k = 9, detect up to 5
    nodes = _nodes(strat.n_workers, recv)
    rng = np.random.default_rng(1)
    bad = b[recv].copy()
    for i in rng.choice(9, 5, replace=False):
        bad[i] += rng.normal() * 5 + 1j
    assert detect_errors(nodes, bad, strat.m)
    assert jft.detect_errors(nodes, bad, strat.m)


def test_locate_single_error(jref):
    _, _, jft, _ = jref
    strat, x, b = _setup()
    recv = np.arange(10)
    nodes = _nodes(strat.n_workers, recv)
    bad = b[recv].copy()
    bad[7] += 3.0 - 2.0j
    idx = locate_errors(nodes, bad, strat.m)
    np.testing.assert_array_equal(idx, [7])
    np.testing.assert_array_equal(idx, jft.locate_errors(nodes, bad,
                                                         strat.m))


@pytest.mark.parametrize("n_err", [0, 1, 2, 3])
def test_correct_up_to_floor_half(jref, n_err):
    """k=12 received, m=4 -> correct up to (12-4)/2 = 4 errors; test 0..3."""
    jnp, JCodedFFT, jft, _ = jref
    strat, x, b = _setup(s=64, m=4, n=12, seed=n_err)
    recv = np.arange(12)
    rng = np.random.default_rng(n_err + 100)
    err_pos = rng.choice(12, n_err, replace=False)
    corrupted = b.copy()
    for p in err_pos:
        corrupted[p] += rng.normal(size=b.shape[1]) * 2 + 1j * rng.normal(
            size=b.shape[1])
    res = robust_decode(strat, torch.as_tensor(corrupted), recv)
    assert res.ok
    assert res.n_errors_corrected == n_err
    np.testing.assert_array_equal(np.sort(res.error_worker_indices),
                                  np.sort(err_pos))
    np.testing.assert_allclose(res.output, np.fft.fft(x), atol=1e-6)
    jstrat = JCodedFFT(s=64, m=4, n_workers=12, dtype=jnp.complex128)
    jres = jft.robust_decode(jstrat, jnp.asarray(corrupted), recv)
    assert jres.n_errors_corrected == res.n_errors_corrected
    np.testing.assert_array_equal(res.error_worker_indices,
                                  jres.error_worker_indices)
    np.testing.assert_allclose(res.output, np.asarray(jres.output),
                               atol=1e-9)


def test_robust_wrapper_bounds():
    strat = CodedFFT(s=64, m=4, n_workers=12, dtype=C128, device="cpu")
    rob = RobustCodedFFT(strat)
    assert rob.max_correctable(12) == 4
    assert rob.max_detectable(12) == 8
    assert rob.max_correctable(4) == 0  # at threshold: no redundancy left


def test_robust_end_to_end_with_partial_receipt(jref):
    """Stragglers AND Byzantine workers simultaneously."""
    jnp, JCodedFFT, jft, _ = jref
    strat = CodedFFT(s=128, m=4, n_workers=16, dtype=C128, device="cpu")
    x = _rand(128, seed=42)
    b = strat.worker_compute(strat.encode(torch.as_tensor(x))).numpy()
    recv = np.asarray([0, 2, 3, 5, 7, 8, 11, 13])  # k = 8 of 16 arrived
    b[5] = 99.0 + 0j     # Byzantine
    b[11] -= 7.3j        # Byzantine
    res = robust_decode(strat, torch.as_tensor(b), recv)
    assert res.ok and res.n_errors_corrected == 2
    np.testing.assert_array_equal(np.sort(res.error_worker_indices), [5, 11])
    np.testing.assert_allclose(res.output, np.fft.fft(x), atol=1e-6)
    jres = jft.robust_decode(
        JCodedFFT(s=128, m=4, n_workers=16, dtype=jnp.complex128),
        jnp.asarray(b), recv)
    np.testing.assert_allclose(res.output, np.asarray(jres.output),
                               atol=1e-9)


def test_robust_coded_fft_run_kernel_backend_complex64(jref):
    """``RobustCodedFFT.run`` on a complex64 kernel-backend plan (the
    cmatmul encode, the four-step worker, the cmatmul decode; plain twins
    here): clean rows decode at the kernel tolerance, and the syndrome
    check at the reference's 1e-6 flags no clean complex64 round."""
    strat = CodedFFT(s=1024, m=4, n_workers=8, device="cpu")
    assert strat.resolved_backend == "kernel"
    rob = RobustCodedFFT(strat)
    x = _rand((3, 1024), seed=5).astype(np.complex64)
    for i in range(3):
        res = rob.run(torch.as_tensor(x[i]), np.arange(8))
        assert res.ok and res.n_errors_corrected == 0
        want = np.fft.fft(x[i].astype(np.complex128))
        assert np.abs(res.output - want).max() < 5e-4 * np.abs(want).max()
    # one liar among 8 responders is corrected at complex64 too
    b = strat.worker_compute(strat.encode(torch.as_tensor(x[0]))).numpy()
    b[6] += 40.0
    res = robust_decode(strat, b, np.arange(8))
    assert res.ok and res.error_worker_indices.tolist() == [6]
    want = np.fft.fft(x[0].astype(np.complex128))
    assert np.abs(res.output - want).max() < 5e-4 * np.abs(want).max()


@settings(max_examples=15, deadline=None)
@given(n_err=st.integers(0, 2), seed=st.integers(0, 10_000))
def test_property_correction(n_err, seed):
    strat = CodedFFT(s=48, m=3, n_workers=9, dtype=C128, device="cpu")
    rng = np.random.default_rng(seed)
    x = rng.normal(size=48) + 1j * rng.normal(size=48)
    b = strat.worker_compute(strat.encode(torch.as_tensor(x))).numpy()
    recv = np.sort(rng.choice(9, 3 + 2 * n_err + 1, replace=False))
    err_pos = rng.choice(recv, n_err, replace=False)
    for p in err_pos:
        b[p] += (rng.normal() + 1j * rng.normal()) * 3
    res = robust_decode(strat, torch.as_tensor(b), recv)
    assert res.ok
    np.testing.assert_allclose(res.output, np.fft.fft(x), atol=1e-5)
