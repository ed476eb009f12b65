"""The port's shape factoring and constant DFT/twiddle planes are the JAX
package's, bit for bit (``repro.kernels.ops`` vs ``repro_torch.kernels.ops``).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs files in parallel
    workers, beside tests that measure wall-clock deadlines."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jops():
    return pytest.importorskip("repro.kernels.ops")


@pytest.mark.parametrize("n", [1, 2, 7, 12, 96, 192, 256, 1000, 1021, 4096,
                               3 * 5 * 7 * 11, 1 << 18])
def test_split_factor_matches_reference(jops, n):
    a, b = tops.split_factor(n)
    assert (a, b) == jops.split_factor(n)
    assert a * b == n and a <= b


def test_split_factor_edge_cases():
    assert tops.split_factor(192) == (12, 16)   # s=768, m=4
    assert tops.split_factor(1021) == (1, 1021)  # prime -> (1, L)


@pytest.mark.parametrize("table,args", [
    ("_dft_planes", (1,)),
    ("_dft_planes", (4,)),
    ("_dft_planes", (12,)),
    ("_dft_planes", (3, np.float32, 1.0)),
    ("_twiddle_planes", (12, 16)),
    ("_twiddle_planes", (1, 31)),
    ("_twiddle_planes", (32, 32)),
    ("_recombine_planes", (768, 4)),
    ("_recombine_planes", (96, 3)),
    ("_recombine_planes_scrambled", (768, 4, 12, 16)),
    ("_recombine_planes_scrambled", (2048, 4, 16, 32)),
    ("_recombine_planes_scrambled", (124, 4, 1, 31)),
])
def test_plane_tables_bit_equal(jops, table, args):
    want = getattr(jops, table)(*args)
    got = getattr(tops, table)(*args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    # and the device copies the kernels read hold the same bits
    on_dev = tops._on_device(getattr(tops, table), args, torch.device("cpu"))
    for g, w in zip(on_dev, want):
        np.testing.assert_array_equal(g.numpy(), w)
