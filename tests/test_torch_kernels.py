"""The four kernels of the port's c2c slice against the JAX package.

CPU tests: each kernel wrapper, given CPU tensors, runs its plain PyTorch
twin; it must agree with the JAX Pallas kernel run through the real
Pallas machinery (``interpret=True``) and with the JAX direct body, on
the same numpy inputs -- adversarial responder masks included.  Stated
tolerances, relative to the largest output magnitude: 1e-5 between two
f32 implementations of the same sums (only the summation order differs),
3e-4 against the complex128 ``numpy.fft`` truth for the whole bucket
(the reference's own masked-bucket bound).

GPU tests (marker ``gpu``, skipped without a CUDA device): each CUDA
kernel against its plain twin on the card, odd shapes included, and its
launch counter.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.core import mds as tmds
from repro_torch.kernels import _build, autotune, fourstep_fft
from repro_torch.kernels import coded_pipeline as tcp
from repro_torch.kernels import ops as tops
from repro_torch.kernels.cmatmul import bcmatmul, bcmatmul_body, bcmatmul_map
from repro_torch.kernels.fourstep_fft import (
    _encode_on_card,
    encode_fourstep_body,
    encode_fourstep_fused,
    encode_rows_fold,
)
from repro_torch.kernels import recombine as trc
from repro_torch.kernels.recombine import (
    recombine_batched_body,
    recombine_design,
    recombine_twiddle_dft,
    recombine_twiddle_dft_batched,
)

# (s, m, N): a 3-shard code with odd N, a non-power-of-two shard length
# (L = 192 = 12 x 16) and the service default
SHAPES = [(96, 3, 7), (768, 4, 6), (2048, 4, 8)]
PAIR_TOL = 1e-5
TRUTH_TOL = 3e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs files in parallel
    workers, beside tests that measure wall-clock deadlines."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def private_autotune_table(tmp_path, monkeypatch):
    """Each test gets a private, empty four-step autotune table and cache
    directory; the old table comes back afterwards.  With ``autotune=True``
    the service default, one test's ``warmup()`` would otherwise record a
    measured CPU winner that moves a later test's route in the same
    worker.  Test files that build services or reach ``fourstep_planar``
    import it."""
    root = tmp_path / "autotune"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(root))
    tables, loaded = dict(autotune._TABLES), set(autotune._LOADED)
    autotune._TABLES.clear()
    autotune._LOADED.clear()
    yield root
    autotune._TABLES.clear()
    autotune._TABLES.update(tables)
    autotune._LOADED.clear()
    autotune._LOADED.update(loaded)


@pytest.fixture(scope="module")
def jref():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import cmatmul, coded_pipeline, fourstep_fft, recombine
    from repro.kernels import ops as jops

    return jnp, cmatmul, coded_pipeline, fourstep_fft, recombine, jops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def adversarial_masks(n: int, m: int) -> np.ndarray:
    """Byte-pattern mask set: everyone, exactly the first m, the same
    subset with a different tail, head block straggling, alternating and
    rotated spreads, random draws with >= m alive -- plus two SHORT rows
    (fewer than m responders), which fill with the first non-responders."""
    rng = np.random.default_rng(0)
    masks = [np.ones(n, bool)]
    first = np.zeros(n, bool)
    first[:m] = True
    masks.append(first)
    tail = first.copy()
    tail[-1] = True
    masks.append(tail)
    masks.append(~first if (~first).sum() >= m else np.ones(n, bool))
    alt = np.arange(n) % 2 == 0
    masks.append(alt)
    masks.append(np.roll(alt, 1))
    for _ in range(2):
        r = rng.random(n) < 0.75
        while r.sum() < m:
            r[rng.integers(n)] = True
        masks.append(r)
    short = np.zeros(n, bool)
    short[n - 1] = True
    masks.append(short)                   # one responder, at the end
    masks.append(np.zeros(n, bool))       # nobody
    return np.stack(masks)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _rel(got, want):
    got = [np.asarray(g, np.float64) for g in got]
    want = [np.asarray(w, np.float64) for w in want]
    scale = max(np.abs(w).max() for w in want)
    return max(np.abs(g - w).max() for g, w in zip(got, want)) / scale


def _t(*arrays, device=torch.device("cpu")):
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def _gen_planes(n, m):
    g = tmds.rs_generator(n, m, torch.complex64, torch.device("cpu"))
    return g.real.contiguous().numpy(), g.imag.contiguous().numpy()


def _bucket_planes(s, m):
    a, b = tops.split_factor(s // m)
    return (*tops._dft_planes(a), *tops._twiddle_planes(a, b),
            *tops._dft_planes(b), *tops._recombine_planes_scrambled(s, m, a, b))


# ------------------------------------------------------------ CPU parity
def test_subsets_from_masks_matches_stable_argsort_exhaustively(jref):
    """The port's subset selection (the stable argsort the plain bucket
    uses) == the reference's argsort and its in-kernel selection from f32
    masks, over ALL 2^N masks (short rows included)."""
    jnp, _, jcp, _, _, jops = jref
    for n, m in [(8, 4), (7, 3), (6, 4)]:
        masks = np.array([[(k >> i) & 1 for i in range(n)]
                          for k in range(2 ** n)], bool)
        got = tops.mask_subsets(torch.as_tensor(masks), m)
        assert got.dtype == torch.int32 and got.shape == (2 ** n, m)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jops.mask_subsets(jnp.asarray(masks), m)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jcp.subsets_from_masks_body(jnp.asarray(masks, np.float32), m)))
        assert torch.equal(tcp.mask_subsets(
            torch.as_tensor(masks.astype(np.float32)), m), got)


@pytest.mark.parametrize("s,m,n", SHAPES)
def test_bcmatmul_plain_matches_reference(jref, s, m, n):
    jnp, jcm, _, _, _, _ = jref
    rng = np.random.default_rng(s)
    q, ell = 3, s // m
    ar, ai = _rand(rng, q, m, n), _rand(rng, q, m, n)
    br, bi = _rand(rng, q, n, ell), _rand(rng, q, n, ell)
    got = bcmatmul(*_t(ar, ai, br, bi))
    args = [jnp.asarray(x) for x in (ar, ai, br, bi)]
    assert _rel(got, jcm.bcmatmul(*args, block_q=q, block_l=ell,
                                  interpret=True)) < PAIR_TOL
    assert _rel(got, jcm.bcmatmul_body(*args)) < PAIR_TOL


@pytest.mark.parametrize("s,m,n", SHAPES)
def test_recombine_plain_matches_reference(jref, s, m, n):
    jnp, _, _, _, jrc, _ = jref
    rng = np.random.default_rng(s + 1)
    q, ell = 3, s // m
    cr, ci = _rand(rng, q, m, ell), _rand(rng, q, m, ell)
    planes = tops._recombine_planes(s, m)
    got = recombine_twiddle_dft_batched(*_t(cr, ci, *planes))
    args = [jnp.asarray(x) for x in (cr, ci, *planes)]
    assert _rel(got, jrc.recombine_twiddle_dft_batched(
        *args, block_q=q, block_l=ell, interpret=True)) < PAIR_TOL
    assert _rel(got, jrc.recombine_batched_body(*args)) < PAIR_TOL


# the recombine's route by m, from both designs' timings at m = 4..64
# (chip_smoke.py's recombine_designs phase): the column design below 16
# shards, the tile design from there
@pytest.mark.parametrize("m", range(1, trc.MAX_M + 1))
def test_recombine_design_is_pinned(m):
    assert recombine_design(m) == ("tile" if m >= 16 else "column")


# (s, m, N) past SHAPES for the encode: A = 1 (a prime L = 127), a prime
# A (61 x 67: the column FFT's dense pass on the card), the mixed radix
# A = B = 384, and m = 16
ENCODE_EDGES = [(4 * 127, 4, 8), (4 * 61 * 67, 4, 8), (3 * 384 * 384, 3, 7),
                (16 * 64, 16, 32)]


@pytest.mark.parametrize("s,m,n", SHAPES + ENCODE_EDGES)
def test_encode_fourstep_plain_matches_reference(jref, s, m, n):
    """The plain twin == the JAX Pallas kernel in interpret mode and its
    direct body (PAIR_TOL), and == numpy.fft of the coded shards G @ c in
    complex128 (TRUTH_TOL), in the scrambled order out[k, c, d] =
    B_k[c + d*A]."""
    jnp, _, _, jfs, _, _ = jref
    rng = np.random.default_rng(s + 2)
    q = 2
    a, b = tops.split_factor(s // m)
    cr, ci = _rand(rng, q, m, a, b), _rand(rng, q, m, a, b)
    gr, gi = _gen_planes(n, m)
    planes = (*tops._dft_planes(a), *tops._twiddle_planes(a, b),
              *tops._dft_planes(b))
    got = encode_fourstep_fused(*_t(cr, ci, gr, gi, *planes))
    assert got[0].shape == (q, n, a, b)
    args = [jnp.asarray(x) for x in (cr, ci, gr, gi, *planes)]
    assert _rel(got, jfs.encode_fourstep_fused(
        *args, block_q=q, interpret=True)) < PAIR_TOL
    assert _rel(got, jfs.encode_fourstep_body(*args)) < PAIR_TOL
    coded = np.einsum("km,qml->qkl", gr + 1j * gi.astype(np.float64),
                      (cr + 1j * ci.astype(np.float64)).reshape(q, m, -1))
    spec = np.fft.fft(coded, axis=-1).reshape(q, n, b, a).transpose(
        0, 1, 3, 2)
    assert _rel(got, [spec.real, spec.imag]) < TRUTH_TOL


@pytest.mark.parametrize("s,m,n", SHAPES)
def test_coded_bucket_masked_plain_matches_reference(jref, s, m, n):
    """Whole masked bucket over the adversarial masks: the plain twin ==
    the JAX kernel (interpret) == the JAX direct body, and all == fft."""
    jnp, _, jcp, _, _, _ = jref
    import jax

    masks = adversarial_masks(n, m)
    rng = np.random.default_rng(s + m)
    xr, xi = _rand(rng, len(masks), s), _rand(rng, len(masks), s)
    gr, gi = _gen_planes(n, m)
    planes = _bucket_planes(s, m)
    got = tcp.coded_fft_bucket_masked(*_t(xr, xi, masks, gr, gi, *planes))
    want = np.fft.fft(xr.astype(np.float64) + 1j * xi, axis=-1)
    assert _rel(got, (want.real, want.imag)) < TRUTH_TOL
    args = [jnp.asarray(x) for x in (xr, xi, masks, gr, gi, *planes)]
    kernel = functools.partial(jcp.coded_fft_bucket_masked,
                               block_q=len(masks), interpret=True)
    assert _rel(got, jax.jit(kernel)(*args)) < PAIR_TOL
    assert _rel(got, jax.jit(jcp.bucket_body_masked)(*args)) < PAIR_TOL


@pytest.mark.parametrize("s,m,n", SHAPES)
def test_stage_route_matches_fft(s, m, n):
    """The stage route (mask subsets, Lagrange planes, encode + four-step,
    decode apply, recombine) == numpy.fft on the adversarial masks."""
    masks = torch.as_tensor(adversarial_masks(n, m))
    q = masks.shape[0]
    rng = np.random.default_rng(s + 3)
    xr, xi = _t(_rand(rng, q, s), _rand(rng, q, s))
    gr, gi = _t(*_gen_planes(n, m))
    subsets = tops.mask_subsets(masks, m)
    dr, di = tops.lagrange_scatter_planes(subsets, n)
    ell = s // m
    cr = xr.reshape(q, ell, m).transpose(1, 2)
    ci = xi.reshape(q, ell, m).transpose(1, 2)
    br, bi = tops.encode_worker(cr, ci, gr, gi)
    hr, hi = tops.decode_apply(dr, di, br, bi)
    yr, yi = tops.recombine_planar(hr, hi, s)
    want = np.fft.fft(xr.double().numpy() + 1j * xi.double().numpy(), axis=-1)
    assert _rel((yr, yi), (want.real, want.imag)) < TRUTH_TOL


def test_fused_gate_is_the_kernel_reckoning():
    """The gate is the kernel's shared-memory working set against the
    card's opt-in limit: the default config fuses, a 2^20 point transform
    does not, and m past the kernel's unroll bound never does."""
    assert tops.coded_bucket_fusable(4096, 4, 8)
    assert tops.coded_bucket_fusable(8192, 4, 8)
    assert not tops.coded_bucket_fusable(16384, 4, 8)
    assert not tops.coded_bucket_fusable(1 << 20, 4, 8)
    assert not tops.coded_bucket_fusable(64 * 33, 33, 66)
    # (m=4, A=B=32): every array of the block, counted by hand
    words = (2 * 32 * 32 * 2 + 3 * 2 * 1024 + 2 * 4 * 32 * 33
             + 8 * 16 + 2 * 5 + 2 * 4 + 4)
    assert tcp.bucket_smem_bytes(4, 32, 32) == 4 * words
    # the offsets the kernel receives: 13 arrays in order, then the total
    layout = tcp.bucket_layout(4, 32, 32)
    assert len(layout) == 14 and layout[0] == 0 and layout[-1] == words
    assert layout[5] == 2 * 32 * 32 * 2 + 3 * 2 * 1024      # shard spectra
    assert tops.SMEM_PER_BLOCK_OPTIN == 227 * 1024


# ------------------------------------ the c2c bucket kernel's FFT layout
def test_bucket_fft_layout_counted_by_hand():
    """(m=4, L=1024): all four shards in one group, its plane padded one
    word in 32; every array of the block counted by hand, in the order
    the kernel takes them."""
    gp = 4096 + 127                   # _padded(4 * 1024)
    words = [2 * gp,                  # z: one group of four shards
             2 * gp,                  # y: that group's ping-pong
             2 * (1024 + 31),         # tab: the 1024-point table
             2 * 4 * 4,               # gs: the subset's G rows
             2 * 4 * 4,               # fm
             2 * 4 * 4, 2 * 4 * 4,    # pw, qm
             2 * 5, 2 * 4, 4]         # loc, nodes, sub
    layout = tcp.bucket_fft_layout(4, 1024)
    assert tcp.bucket_fft_group(4, 1024) == 4
    assert layout == tuple(np.cumsum([0] + words))
    assert layout[-1] == 19152
    # the planes kernel: all N = 8 rows of G and the request's (4, 8) D
    planes = tcp.bucket_fft_layout(4, 1024, n=8, masked=False)
    assert planes[-1] == 4 * gp + 2 * 1055 + 64 + 32 + 64
    # past the block, fewer shards a group, the last one only as long as
    # its shards: m = 32, L = 256, N = 282 on the planes kernel takes
    # four a group, eight groups of 1024 points
    assert tcp.bucket_fft_group(32, 256, n=282, masked=False) == 4
    layout = tcp.bucket_fft_layout(32, 256, n=282, masked=False)
    assert layout[1] == 2 * 8 * (1024 + 31)
    assert 4 * layout[-1] <= tcp.SMEM_PER_BLOCK_OPTIN


_FIT_LENGTHS = sorted({1 << k for k in range(22)} | {
    96, 768, 4 * 127, 4 * 105, 4 * 1021, 4 * 4099, 12288, 3 * 1000,
    16 * 384, 32 * 256})


def _largest_planes_n(s, m):
    """The widest code N the planes gate admits at (s, m) (N enters both
    layouts linearly, so the widest is the one to hold)."""
    lo, hi = m, 1 << 17
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if tops.coded_bucket_fusable(s, m, mid, masked=False):
            lo = mid
        else:
            hi = mid - 1
    return lo


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("m", range(1, 33))
def test_bucket_fft_layout_fits_wherever_the_gate_admits(m, masked):
    """The gate stays the dense design's reckoning (``bucket_layout``);
    the kernel's own layout fits one block at every shape it admits: s
    over the powers of two to 2^21 and the odd lengths the tests use,
    every m to 32, both decode modes, N from m to the widest the planes
    gate admits."""
    checked = 0
    for s in sorted(set(_FIT_LENGTHS) | {m * k for k in (1, 3, 5, 7, 105,
                                                         127, 1021)}):
        if s % m or not tops.coded_bucket_fusable(s, m, m, masked=masked):
            continue
        ns = [m] if masked else sorted({m, m + 1, 2 * m,
                                        _largest_planes_n(s, m)})
        for n in ns:
            assert tops.coded_bucket_fusable(s, m, n, masked=masked)
            layout = tcp.bucket_fft_layout(m, s // m, n=n, masked=masked)
            assert 4 * layout[-1] <= tcp.SMEM_PER_BLOCK_OPTIN, (s, m, n)
            rows = tcp.bucket_fft_group(m, s // m, n=n, masked=masked)
            assert 1 <= rows <= m
            checked += 1
    assert checked > 0


# bucket_route's c2c answers, masked then planes, for the codes (m, N) =
# (1, 3), (3, 7), (4, 8), (8, 16), (16, 32), (32, 64): F fused, S
# streaming, T stage.  The kernel's FFT redesign moves no bucket.
_C2C_ROUTES = {
    96: "FF FF FF FF FF FF",
    768: "FF FF FF FF FF FF",
    2048: "FF TT FF FF FF FF",
    4096: "FF TT FF FF FF FF",
    8192: "SS TT FF FF FF FF",
    12288: "SS SS FF FF FF FF",
    16384: "SS TT SS FF FF FF",
    4 * 127: "FF TT FF TT TT TT",
    4 * 1021: "TT TT TT TT TT TT",
    4 * 105: "FF FF FF TT TT TT",
    1 << 20: "TT TT SS SS SS SS",
    1 << 21: "TT TT TT TT TT TT",
    4 * 4099: "TT TT TT TT TT TT",
}


@pytest.mark.parametrize("s", sorted(_C2C_ROUTES))
def test_bucket_route_is_frozen_for_c2c(s):
    names = {"F": "fused", "S": "streaming", "T": "stage"}
    codes = [(1, 3), (3, 7), (4, 8), (8, 16), (16, 32), (32, 64)]
    for (m, n), pair in zip(codes, _C2C_ROUTES[s].split()):
        assert tops.bucket_route(s, m, n, "c2c") == names[pair[0]]
        assert tops.bucket_route(s, m, n, "c2c", masked=False) == \
            names[pair[1]]


def _pad(a):
    return a + (a >> 5)


def _bucket_model(xr, xi, dr, di, gr, gi, fmr, fmi, s, m, n, masked):
    """A numpy model of ``csrc/coded_bucket.cu``, index for index: the
    contiguous load de-interleaved into the grouped, padded spectrum
    planes, each group's shards transformed in place (the row FFT's
    natural-order result), then per natural l the code phase reading
    those words and the recombine twiddle from the s-point table at j*l.
    Returns the (q, s) complex output, float64 arithmetic."""
    q = xr.shape[0]
    ell = s // m
    rows = tcp.bucket_fft_group(m, ell, n=n, masked=masked)
    layout = tcp.bucket_fft_layout(m, ell, n=n, masked=masked)
    gp = _pad(rows * ell - 1) + 1
    zplane = (layout[1] - layout[0]) // 2
    assert layout[2] - layout[1] == 2 * gp           # y: one full group
    groups = -(-m // rows)
    # load: x[j*m + i] -> shard row i, point j
    e = np.arange(s)
    i, j = e % m, e // m
    g = i // rows
    slot = g * gp + _pad((i - g * rows) * ell + j)
    assert len(np.unique(slot)) == s and slot.max() < zplane
    # the shard groups partition the shards, the last only as long as its
    # shards
    live = [min(rows, m - k * rows) for k in range(groups)]
    assert sum(live) == m and min(live) >= 1
    assert zplane == (groups - 1) * gp + _pad(live[-1] * ell - 1) + 1
    z = np.zeros((q, zplane), np.complex128)
    z[:, slot] = xr.astype(np.float64) + 1j * xi
    for k in range(groups):
        words = k * gp + _pad(np.arange(live[k] * ell))
        block = z[:, words].reshape(q, live[k], ell)
        z[:, words] = np.fft.fft(block, axis=-1).reshape(q, -1)
    # code phase: shard i of natural l at word slot(i, l); the twiddle of
    # shard j at l is the s-point table's entry j*l, bit for bit the
    # reference's pre-scrambled plane at c*B + d, l = c + d*A
    tabr, tabi = fourstep_fft.fft_rows_twiddles(s)
    a, b = tops.split_factor(ell)
    pr, pi_, _, _ = tops._recombine_planes_scrambled(s, m, a, b)
    l = np.arange(ell)
    lp = (l % a) * b + l // a
    for jj in range(m):
        assert np.array_equal(tabr[jj * l], pr[jj, lp])
        assert np.array_equal(tabi[jj * l], pi_[jj, lp])
    ii = np.arange(m)[:, None]
    gi_ = ii // rows
    words = gi_ * gp + _pad((ii - gi_ * rows) * ell + l[None, :])  # (m, L)
    t = z[:, words]                                            # (q, m, L)
    gc = gr.astype(np.float64) + 1j * gi
    dc = dr.astype(np.float64) + 1j * di                       # (q, m, n)
    bres = np.einsum("rm,qml->qrl", gc, t)
    hat = np.einsum("qjr,qrl->qjl", dc, bres)
    tw = (tabr.astype(np.float64) + 1j * tabi)[np.arange(m)[:, None] * l]
    fm = fmr.astype(np.float64) + 1j * fmi
    out = np.einsum("pj,qjl->qpl", fm, hat * tw[None])
    return out.reshape(q, s)


@pytest.mark.parametrize("s,m,n,masked", [
    (96, 3, 7, True), (768, 4, 6, True), (4096, 4, 8, True),
    (4096, 4, 8, False), (1024, 1, 3, True), (4 * 105, 4, 8, True),
    (4 * 1021, 4, 8, True), (16 * 64, 16, 32, True), (32 * 16, 32, 64, True),
    (8192, 32, 282, False), (3 * 1000, 3, 5, False)])
def test_bucket_kernel_model_matches_body(s, m, n, masked):
    """The numpy model of the kernel's index maps (load de-interleave,
    shard groups, spectrum words, twiddle slots) against the plain twin
    and numpy.fft, on evenly spread responders."""
    alt = np.arange(n) % 2 == 0
    masks = np.stack([np.roll(alt, k) for k in range(3)])
    rng = np.random.default_rng(s + m)
    xr, xi = _rand(rng, 3, s), _rand(rng, 3, s)
    gr, gi = _gen_planes(n, m)
    dr, di = tops.lagrange_scatter_planes(
        tops.mask_subsets(torch.as_tensor(masks), m), n)
    fmr, fmi = tops._dft_planes(m)
    got = _bucket_model(xr, xi, dr.numpy(), di.numpy(), gr, gi, fmr, fmi, s,
                        m, n, masked)
    planes = _bucket_planes(s, m)
    want = tcp.bucket_body(*_t(xr, xi), dr, di, *_t(gr, gi, *planes))
    assert _rel((got.real, got.imag), want) < PAIR_TOL
    if n == 2 * m or m <= 4:
        truth = np.fft.fft(xr.astype(np.float64) + 1j * xi, axis=-1)
        assert _rel((got.real, got.imag), (truth.real, truth.imag)) \
            < TRUTH_TOL


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper takes the plain twin only for CPU tensors; anything that
    is neither CPU nor CUDA is refused, never copied to the host."""
    meta = torch.empty((2, 4, 8), device="meta")
    with pytest.raises(ValueError, match="not a CUDA device"):
        bcmatmul(meta, meta, torch.empty((2, 8, 16), device="meta"),
                 torch.empty((2, 8, 16), device="meta"))


def test_oracles_agree_with_plain_twins():
    """``kernels/ref.py``'s natural-complex oracles (torch.fft included)
    against the plain twins the wrappers run on the CPU."""
    from repro_torch.kernels import ref

    rng = np.random.default_rng(4)
    q, m, n, a, b = 2, 4, 8, 12, 16
    ell, s = a * b, m * a * b
    cr, ci = _t(_rand(rng, q, m, ell), _rand(rng, q, m, ell))
    gr, gi = _t(*_gen_planes(n, m))
    br_, bi_ = tops.encode_worker(cr, ci, gr, gi)
    want = ref.encode_worker_ref(cr, ci, torch.complex(gr, gi))
    assert _rel((br_, bi_), want) < PAIR_TOL
    dr, di = _t(_rand(rng, q, m, n), _rand(rng, q, m, n))
    assert _rel(tops.decode_apply(dr, di, br_, bi_),
                ref.bcmatmul_ref(dr, di, br_, bi_)) < PAIR_TOL
    planes = _t(*tops._recombine_planes(s, m))
    assert _rel(recombine_twiddle_dft_batched(cr, ci, *planes),
                ref.recombine_batched_ref(cr, ci, *planes)) < PAIR_TOL
    assert _rel(ref.recombine_ref(cr[0], ci[0], *planes),
                [p[0] for p in ref.recombine_batched_ref(cr, ci, *planes)]) \
        < PAIR_TOL
    assert _rel(ref.cmatmul_ref(gr, gi, cr[0], ci[0]),
                (gr @ cr[0] - gi @ ci[0], gr @ ci[0] + gi @ cr[0])) < PAIR_TOL
    z = ref.unplanar(cr[0, 0], ci[0, 0])
    assert z.dtype == torch.complex64
    np.testing.assert_array_equal(ref.planar(z)[0].numpy(), cr[0, 0].numpy())
    assert _rel(ref.planar(ref.fft_ref_complex(z)),
                ref.fourstep_fft_ref(cr[0, :1], ci[0, :1], a, b)) < PAIR_TOL


@pytest.mark.parametrize("a,b", [(12, 16), (1, 31), (16, 32)])
def test_fourstep_body_matches_reference(jref, a, b):
    """The plain four-step (scrambled order) == the reference body, and
    unscrambled == the FFT."""
    jnp, _, _, jfs, _, _ = jref
    rng = np.random.default_rng(a + b)
    xr, xi = _rand(rng, 3, a, b), _rand(rng, 3, a, b)
    planes = (*tops._dft_planes(a), *tops._twiddle_planes(a, b),
              *tops._dft_planes(b))
    from repro_torch.kernels.fourstep_fft import fourstep_body

    got = fourstep_body(*_t(xr, xi, *planes))
    want = jfs.fourstep_body(*[jnp.asarray(x) for x in (xr, xi, *planes)])
    assert _rel(got, want) < PAIR_TOL
    nat = [g.transpose(-1, -2).reshape(3, a * b) for g in got]
    truth = np.fft.fft((xr + 1j * xi.astype(np.float64)).reshape(3, -1),
                       axis=-1)
    assert _rel(nat, (truth.real, truth.imag)) < PAIR_TOL



# ------------------------------------------------------- GPU: kernel vs plain
def _cuda_planes(device, *arrays):
    return _t(*arrays, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("q,m,k,ell", [(3, 4, 8, 1000), (2, 9, 11, 37),
                                       (1, 32, 64, 300), (2, 4, 8, 4096),
                                       (1, 16, 20, 2051)])
def test_gpu_bcmatmul_matches_plain(cuda, q, m, k, ell):
    """Dense left matrices (every column live), in both thread maps: L
    not a multiple of 4, q = 1."""
    rng = np.random.default_rng(q * m)
    args = _cuda_planes(cuda, _rand(rng, q, m, k), _rand(rng, q, m, k),
                        _rand(rng, q, k, ell), _rand(rng, q, k, ell))
    before = _build.launch_counts().get("bcmatmul", 0)
    got = bcmatmul(*args)
    assert _build.launch_counts()["bcmatmul"] == before + 1
    want = bcmatmul_body(*args)
    assert _rel([g.cpu() for g in got], [w.cpu() for w in want]) < PAIR_TOL


def _scatter_planes(rng, q, m, n):
    """Random (q, m, N) decode planes, each request's N - m straggler
    columns exactly zero (the form of ``ops.lagrange_scatter_planes``);
    returns the planes and the (q, N) live-column mask."""
    live = np.zeros((q, n), bool)
    for i in range(q):
        live[i, rng.permutation(n)[:m]] = True
    dr, di = _rand(rng, q, m, n), _rand(rng, q, m, n)
    return dr * live[:, None], di * live[:, None], live


def test_bcmatmul_thread_map():
    """The kernel's two thread maps, chosen from the shape alone: wide
    (4 columns a thread, every row in registers) from 1024 payload
    columns and up to 16 rows -- the m=4 stage route -- else narrow
    (16 x 64 tiles) -- the m=64 host path, and short payloads."""
    assert bcmatmul_map(4, 1 << 18) == "wide"
    assert bcmatmul_map(16, 1024) == "wide"
    assert bcmatmul_map(17, 1 << 18) == "narrow"
    assert bcmatmul_map(4, 1023) == "narrow"
    assert bcmatmul_map(64, 64) == "narrow"


@pytest.mark.gpu
@pytest.mark.parametrize("q,m,k,ell", [(3, 4, 8, 1000), (64, 64, 128, 64),
                                       (16, 4, 8, 1 << 18),
                                       (2, 9, 11, 4099), (2, 4, 300, 2048),
                                       (2, 20, 200, 100), (1, 16, 32, 1030)])
def test_gpu_bcmatmul_scatter_matches_plain(cuda, q, m, k, ell):
    """Scatter decode planes (zero straggler columns): the service's
    shapes at m=4 (narrow below 1024 columns, wide at 2^18) and m=64, a
    wide L not a multiple of 4, K past one 128-column chunk in both maps,
    q = 1."""
    rng = np.random.default_rng(q * m + k)
    dr, di, _ = _scatter_planes(rng, q, m, k)
    args = _cuda_planes(cuda, dr, di, _rand(rng, q, k, ell),
                        _rand(rng, q, k, ell))
    before = _build.launch_counts().get("bcmatmul", 0)
    got = bcmatmul(*args)
    assert _build.launch_counts()["bcmatmul"] == before + 1
    want = bcmatmul_body(*args)
    assert _rel([g.cpu() for g in got], [w.cpu() for w in want]) < PAIR_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("q,m,k,ell", [(3, 4, 8, 2048), (3, 4, 8, 100),
                                       (4, 64, 128, 64)])
def test_gpu_bcmatmul_skips_straggler_rows(cuda, q, m, k, ell):
    """A straggler's spectrum holding inf and NaN: the kernel never reads
    it (its decode column is zero), so it gives the plain product of the
    spectra with that row zeroed, where the plain product itself turns
    NaN -- the deliberate difference of ROADMAP.md Queue 3."""
    rng = np.random.default_rng(k + ell)
    dr, di, live = _scatter_planes(rng, q, m, k)
    br, bi = _rand(rng, q, k, ell), _rand(rng, q, k, ell)
    dead = ~live
    br[dead] = np.inf
    bi[dead] = np.nan
    got = bcmatmul(*_cuda_planes(cuda, dr, di, br, bi))
    zr, zi = br.copy(), bi.copy()
    zr[dead] = 0.0
    zi[dead] = 0.0
    want = bcmatmul_body(*_cuda_planes(cuda, dr, di, zr, zi))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert _rel([g.cpu() for g in got], [w.cpu() for w in want]) < PAIR_TOL
    plain = bcmatmul_body(*_cuda_planes(cuda, dr, di, br, bi))
    assert not bool(torch.isfinite(plain[0]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("s,m", [(96, 3), (2048, 4), (16 * 100, 16),
                                 (32 * 33, 32)])
def test_gpu_recombine_matches_plain(cuda, s, m):
    rng = np.random.default_rng(s)
    q, ell = 3, s // m
    args = _cuda_planes(cuda, _rand(rng, q, m, ell), _rand(rng, q, m, ell),
                        *tops._recombine_planes(s, m))
    got = recombine_twiddle_dft_batched(*args)
    want = recombine_batched_body(*args)
    assert _rel([g.cpu() for g in got], [w.cpu() for w in want]) < PAIR_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8, 9, 16, 17, 31, 32, 33,
                               63, 64])
def test_gpu_recombine_designs_match_plain(cuda, m):
    """Both designs of ``csrc/recombine.cu`` forced, and the routed one
    through both entries (one launch a call), against
    ``recombine_batched_body`` at 1e-5, for buckets of 1, 3 and 64
    requests and payloads ragged against the tile design's 32
    positions (L = 1, 33, 96; and 2^18 at m = 4)."""
    rng = np.random.default_rng(m)
    name = "recombine_twiddle_dft_batched"
    for q in (1, 3, 64):
        for ell in (1, 33, 96) + ((1 << 18,) if m == 4 else ()):
            args = _cuda_planes(cuda, _rand(rng, q, m, ell),
                                _rand(rng, q, m, ell),
                                *tops._recombine_planes(m * ell, m))
            want = [w.cpu() for w in recombine_batched_body(*args)]
            for design in ("column", "tile"):
                got = trc._launch(name, *args, design=design)
                assert _rel([g.cpu() for g in got], want) < 1e-5, (
                    q, ell, design)
            before = _build.launch_counts().get(name, 0)
            got = recombine_twiddle_dft_batched(*args)
            torch.cuda.synchronize()
            assert _build.launch_counts()[name] == before + 1
            assert _rel([g.cpu() for g in got], want) < 1e-5
            if q == 1:
                got = recombine_twiddle_dft(args[0][0], args[1][0],
                                            *args[2:])
                assert _rel([g.cpu() for g in got],
                            [w[0] for w in want]) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("q,m,n,a,b", [(2, 3, 7, 4, 8), (3, 4, 6, 12, 16),
                                       (2, 4, 8, 1, 31), (2, 4, 8, 100, 70),
                                       (2, 2, 5, 64, 128),
                                       (16, 4, 8, 512, 512),
                                       (2, 4, 8, 61, 67),
                                       (2, 3, 7, 384, 384),
                                       (4, 16, 32, 512, 512),
                                       (2, 16, 32, 7, 1024)])
def test_gpu_encode_fourstep_matches_plain(cuda, q, m, n, a, b):
    """Odd shapes, A = 1, the service's 2^20-point shape and a prime and
    a mixed-radix A on the folded route (two launches); m = 16 at
    B = 512 and B = 1024 (with A = 7 ragged) past the fold, on the
    row FFT and the G apply (three)."""
    rng = np.random.default_rng(a * b)
    planes = (*tops._dft_planes(a), *tops._twiddle_planes(a, b),
              *tops._dft_planes(b))
    args = _cuda_planes(cuda, _rand(rng, q, m, a, b), _rand(rng, q, m, a, b),
                        *_gen_planes(n, m), *planes)
    fold = encode_rows_fold(m, a, b)
    assert fold == (m * b <= 4096)
    before = _build.launch_counts().get("encode_fourstep_fused", 0)
    got = encode_fourstep_fused(*args)
    assert (_build.launch_counts()["encode_fourstep_fused"]
            == before + (2 if fold else 3))
    want = encode_fourstep_body(*args)
    assert _rel([g.cpu() for g in got], [w.cpu() for w in want]) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("q,m,n,a,b", [(2, 16, 32, 7, 512),
                                       (2, 64, 128, 4, 128)])
def test_gpu_encode_fourstep_both_routes_match_plain(cuda, q, m, n, a, b):
    """Past the 4096-point cap, where both routes fit a block: the folded
    row FFT (one block an SM) and the row FFT with the G apply, each
    forced, against the plain twin -- the fork chip_smoke.py times."""
    rng = np.random.default_rng(m * b)
    planes = (*tops._dft_planes(a), *tops._twiddle_planes(a, b),
              *tops._dft_planes(b))
    args = _cuda_planes(cuda, _rand(rng, q, m, a, b), _rand(rng, q, m, a, b),
                        *_gen_planes(n, m), *planes)
    assert not encode_rows_fold(m, a, b)
    want = encode_fourstep_body(*args)
    for fold in (True, False):
        got = _encode_on_card(*args[:4], *args[6:8], fold)
        assert _rel([g.cpu() for g in got], [w.cpu() for w in want]) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("s,m,n", SHAPES + [(4 * 127, 4, 8), (4096, 4, 8),
                                            (16 * 64, 16, 32),
                                            (32 * 16, 32, 64)])
def test_gpu_coded_bucket_matches_plain(cuda, s, m, n):
    if m <= 4:
        masks = adversarial_masks(n, m)
    else:
        # wide codes: evenly spread responders (n = 2m), the conditioning
        # regime LAGRANGE_MAX_M is set for -- a contiguous arc of m >= 16
        # nodes (e.g. the first m of an all-responder row) amplifies f32
        # rounding past any fixed tolerance, in both implementations
        alt = np.arange(n) % 2 == 0
        masks = np.stack([alt, np.roll(alt, 1), np.roll(alt, 3)])
    rng = np.random.default_rng(s)
    xr, xi = _rand(rng, len(masks), s), _rand(rng, len(masks), s)
    args = _cuda_planes(cuda, xr, xi, masks, *_gen_planes(n, m),
                        *_bucket_planes(s, m))
    assert tops.coded_bucket_fusable(s, m, n)
    before = _build.launch_counts().get("coded_fft_bucket_masked", 0)
    got = tcp.coded_fft_bucket_masked(*args)
    assert _build.launch_counts()["coded_fft_bucket_masked"] == before + 1
    want = tcp.bucket_body_masked(*args[:2], args[2].float(), *args[3:])
    assert _rel([g.cpu() for g in got], [w.cpu() for w in want]) < 1e-4
    if m <= 4 or n == 2 * m:
        truth = np.fft.fft(xr.astype(np.float64) + 1j * xi, axis=-1)
        assert _rel([g.cpu() for g in got], (truth.real, truth.imag)) \
            < TRUTH_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("s,m,n", [(8192, 4, 8), (32 * 512, 32, 64)])
def test_gpu_bucket_at_the_smem_gate(cuda, s, m, n):
    """The gate's limit is the card's opt-in shared memory, and the widest
    fusable buckets -- working sets near that limit -- launch and match
    their plain twin."""
    assert tcp.device_smem_optin(cuda.index or 0) == tcp.SMEM_PER_BLOCK_OPTIN
    a, b = tops.split_factor(s // m)
    assert tops.coded_bucket_fusable(s, m, n)
    assert tcp.bucket_smem_bytes(m, a, b) > tcp.SMEM_PER_BLOCK_OPTIN // 2
    alt = np.arange(n) % 2 == 0
    masks = np.stack([alt, np.roll(alt, 1)])
    rng = np.random.default_rng(s)
    args = _cuda_planes(cuda, _rand(rng, 2, s), _rand(rng, 2, s), masks,
                        *_gen_planes(n, m), *_bucket_planes(s, m))
    got = tcp.coded_fft_bucket_masked(*args)
    want = tcp.bucket_body_masked(*args[:2], args[2].float(), *args[3:])
    assert _rel([g.cpu() for g in got], [w.cpu() for w in want]) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("s,m,n", [(8192, 4, 8), (32 * 512, 32, 64)])
def test_gpu_planes_bucket_at_the_smem_gate(cuda, s, m, n):
    """The planes entry at the gate's two edge shapes, whose layout holds
    all N rows of G and the request's D beside the spectra."""
    assert tops.coded_bucket_fusable(s, m, n, masked=False)
    alt = np.arange(n) % 2 == 0
    masks = torch.as_tensor(np.stack([alt, np.roll(alt, 1)]), device=cuda)
    dr, di = tops.lagrange_scatter_planes(tops.mask_subsets(masks, m), n)
    rng = np.random.default_rng(s + 1)
    args = _cuda_planes(cuda, _rand(rng, 2, s), _rand(rng, 2, s))
    rest = _cuda_planes(cuda, *_gen_planes(n, m), *_bucket_planes(s, m))
    got = tcp.coded_fft_bucket(*args, dr.contiguous(), di.contiguous(),
                               *rest)
    want = tcp.bucket_body(*args, dr, di, *rest)
    assert _rel([g.cpu() for g in got], [w.cpu() for w in want]) < 1e-4


# (q, s, m, N): m in 1, 3, 4, 16, 32; shard lengths with radices 3, 5 and
# 7 (105, 384) and the prime 1021 (one dense pass); q = 1 and 64
_FFT_BUCKET_CASES = [
    (64, 4096, 4, 8), (1, 4096, 4, 8), (3, 1024, 1, 3), (3, 96, 3, 7),
    (3, 3 * 105, 3, 7), (2, 4 * 105, 4, 8), (2, 4 * 384, 4, 8),
    (1, 4 * 1021, 4, 8), (64, 4 * 1021, 4, 8), (3, 16 * 64, 16, 32),
    (2, 16 * 384, 16, 32), (3, 32 * 16, 32, 64), (2, 32 * 256, 32, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("q,s,m,n", _FFT_BUCKET_CASES)
def test_gpu_fft_bucket_matches_plain(cuda, q, s, m, n, masked):
    """Both entries of the bucket kernel against their plain twins, one
    launch a call, and numpy.fft where the code is well conditioned
    (adversarial masks at m <= 4, evenly spread responders past it)."""
    if m <= 4:
        masks = np.resize(adversarial_masks(n, m), (q, n))
    else:
        alt = np.arange(n) % 2 == 0
        masks = np.stack([np.roll(alt, k) for k in range(q)])
    rng = np.random.default_rng(s + q)
    xr, xi = _rand(rng, q, s), _rand(rng, q, s)
    x = _cuda_planes(cuda, xr, xi)
    rest = _cuda_planes(cuda, *_gen_planes(n, m), *_bucket_planes(s, m))
    mk = torch.as_tensor(masks, device=cuda)
    name = "coded_fft_bucket_masked" if masked else "coded_fft_bucket"
    before = _build.launch_counts().get(name, 0)
    if masked:
        got = tcp.coded_fft_bucket_masked(*x, mk, *rest)
        want = tcp.bucket_body_masked(*x, mk.float(), *rest)
    else:
        dr, di = tops.lagrange_scatter_planes(tops.mask_subsets(mk, m), n)
        got = tcp.coded_fft_bucket(*x, dr.contiguous(), di.contiguous(),
                                   *rest)
        want = tcp.bucket_body(*x, dr, di, *rest)
    torch.cuda.synchronize()
    assert _build.launch_counts()[name] == before + 1
    assert _rel([g.cpu() for g in got], [w.cpu() for w in want]) < 1e-4
    truth = np.fft.fft(xr.astype(np.float64) + 1j * xi, axis=-1)
    assert _rel([g.cpu() for g in got], (truth.real, truth.imag)) \
        < TRUTH_TOL
