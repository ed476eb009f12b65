"""The r2c whole-bucket kernel's FFT layout and index maps.

``csrc/coded_rbucket.cu`` transforms the m pair-packed shards of each
request with the row FFT's passes (``fft_rows.cuh``) and lays out
``coded_pipeline.bucket_fft_layout`` with the m//2+1 DFT rows it stages,
while the r2c route's gate stays the dense design's reckoning,
``coded_pipeline.rbucket_layout``.  CPU tests: that layout counted by
hand; its fit wherever the gate admits a bucket; ``bucket_route``'s r2c
answers frozen; and a numpy model of the kernel, index for index (the
packed de-interleave, the shard groups, the natural-order spectra, the
(p, n2 - p) split reads, the twiddle slots), held against the plain
twins ``rbucket_body`` / ``rbucket_body_masked``, ``numpy.fft.rfft`` and
the JAX kernel in interpret mode.  Stated tolerances, relative to the
largest output magnitude: 1e-4 against a twin (float64 model against
f32 sums; the card's own tests hold the kernel to the twin at 1e-4);
``TRUTH_TOL`` = 3e-4 against the complex128 ``numpy.fft`` at m <= 4, the
reference's whole-bucket bound (wider codes decode ill-conditioned
subsets in f32, so they are held to the twins).

GPU tests (marker ``gpu``, skipped without a CUDA device): both entries
at shapes whose groups hold fewer than m shards, against their twins;
the masked entry on bool, float and int masks (the card reads bytes).
"""

import numpy as np
import pytest
import torch
from test_torch_kernels import _gen_planes, _rand, _rel, _t

from repro_torch.kernels import _build, fourstep_fft
from repro_torch.kernels import coded_pipeline as tcp
from repro_torch.kernels import ops as tops

TWIN_TOL = 1e-4
TRUTH_TOL = 3e-4


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
    from repro.kernels import ops as jops

    return jnp, jops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layout(m, n2, n=0, masked=True):
    return tcp.bucket_fft_layout(m, n2, n=n, masked=masked,
                                 dft_rows=m // 2 + 1)


def _group(m, n2, n=0, masked=True):
    return tcp.bucket_fft_group(m, n2, n=n, masked=masked,
                                dft_rows=m // 2 + 1)


# ------------------------------------------------------------ the layout
def test_rbucket_fft_layout_counted_by_hand():
    """(m=4, n2=512), the default bucket's packed shards: all four in one
    group, its plane padded one word in 32; every array of the block
    counted by hand, in the order the kernel takes them."""
    gp = 2048 + 63                    # _padded(4 * 512)
    words = [2 * gp,                  # z: one group of four shards
             2 * gp,                  # y: that group's ping-pong
             2 * (512 + 15),          # tab: the 512-point table
             2 * 4 * 4,               # gs: the subset's G rows
             2 * 3 * 4,               # fh: the m//2+1 DFT rows
             2 * 4 * 4, 2 * 4 * 4,    # pw, qm
             2 * 5, 2 * 4, 4]         # loc, nodes, sub
    assert _group(4, 512) == 4
    assert _layout(4, 512) == tuple(np.cumsum([0] + words))
    assert 4 * _layout(4, 512)[-1] == 38560
    # the planes kernel: all N = 8 rows of G and the request's (4, 8) D,
    # no Lagrange scratch
    planes = _layout(4, 512, n=8, masked=False)
    assert planes[-1] == 4 * gp + 2 * 527 + 64 + 24 + 64
    assert planes[4] - planes[3] == 64 and planes[7] - planes[6] == 64
    # the dense design's reckoning, the gate: 39,992 bytes here, 157,240
    # at s = 16384, where this layout takes 152,608
    assert 4 * tcp.rbucket_layout(4, 16, 32)[-1] == 39992
    assert 4 * tcp.rbucket_layout(4, 32, 64)[-1] == 157240
    assert 4 * _layout(4, 2048)[-1] == 152608
    # the c2c kernel's layout is the same reckoning with m DFT rows
    assert tcp.bucket_fft_layout(4, 512) == tcp.bucket_fft_layout(
        4, 512, dft_rows=4)
    assert tcp.bucket_fft_layout(4, 512)[-1] - _layout(4, 512)[-1] == 8
    # past the block, fewer shards a group: (s, m) = (32768, 8) takes two
    # groups of four 2048-point shards
    assert tops.coded_rbucket_fusable(32768, 8, 16)
    assert _group(8, 2048) == 4
    layout = _layout(8, 2048)
    assert layout[1] == 2 * 2 * (8192 + 255)
    assert 4 * layout[-1] <= tcp.SMEM_PER_BLOCK_OPTIN


_FIT_LENGTHS = sorted({1 << k for k in range(22)} | {
    96, 768, 3000, 12288, 5488, 3840, 8 * 127, 8 * 105, 8 * 1021,
    8 * 4099})


def _largest_planes_n(s, m):
    """The widest code N the r2c planes gate admits at (s, m) (N enters
    both layouts linearly, so the widest is the one to hold)."""
    lo, hi = m, 1 << 17
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if tops.coded_rbucket_fusable(s, m, mid, masked=False):
            lo = mid
        else:
            hi = mid - 1
    return lo


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("m", range(1, 33))
def test_rbucket_fft_layout_fits_wherever_the_gate_admits(m, masked):
    """The gate stays the dense design's reckoning (``rbucket_layout``);
    the kernel's own layout fits one block at every shape it admits: s
    over the powers of two to 2^21, odd, prime and radix-3/5/7 packed
    lengths, every m to 32, both decode modes, N from m to the widest
    the planes gate admits."""
    checked = 0
    packed = (1, 3, 5, 7, 61, 105, 125, 127, 343, 1021)
    for s in sorted(set(_FIT_LENGTHS) | {2 * m * k for k in packed}):
        if s % (2 * m) or not tops.coded_rbucket_fusable(s, m, m,
                                                         masked=masked):
            continue
        n2 = s // m // 2
        ns = [m] if masked else sorted({m, m + 1, 2 * m,
                                        _largest_planes_n(s, m)})
        for n in ns:
            assert tops.coded_rbucket_fusable(s, m, n, masked=masked)
            layout = _layout(m, n2, n=n, masked=masked)
            assert 4 * layout[-1] <= tcp.SMEM_PER_BLOCK_OPTIN, (s, m, n)
            assert 1 <= _group(m, n2, n=n, masked=masked) <= m
            checked += 1
    assert checked > 0


# bucket_route's r2c answers, masked then planes, for the codes (m, N) =
# (1, 3), (3, 7), (4, 8), (8, 16), (16, 32), (32, 64), as the parent
# tree gave them: F fused, T stage (the real kinds do not stream).  The
# kernel's FFT redesign moves no bucket.
_R2C_ROUTES = {
    96: "FF FF FF FF FF TT",
    768: "FF FF FF FF FF FF",
    2048: "FF TT FF FF FF FF",
    4096: "FF TT FF FF FF FF",
    8192: "FF TT FF FF FF FF",
    12288: "TT FF FF FF FF FF",
    16384: "TT TT FF FF FF FF",
    32768: "TT TT TT FF FF FF",
    8 * 127: "FF TT FF TT TT TT",
    8 * 105: "FF FF FF TT TT TT",
    6 * 105: "FF FF TT TT TT TT",
    16 * 343: "FF TT FF FF TT TT",
    8 * 1021: "TT TT TT TT TT TT",
    3000: "FF FF FF TT TT TT",
    32 * 120: "FF FF FF FF FF FF",
    1 << 20: "TT TT TT TT TT TT",
    1 << 21: "TT TT TT TT TT TT",
}


@pytest.mark.parametrize("s", sorted(_R2C_ROUTES))
def test_bucket_route_is_frozen_for_r2c(s):
    names = {"F": "fused", "T": "stage"}
    codes = [(1, 3), (3, 7), (4, 8), (8, 16), (16, 32), (32, 64)]
    for (m, n), pair in zip(codes, _R2C_ROUTES[s].split()):
        assert tops.bucket_route(s, m, n, "r2c") == names[pair[0]]
        assert tops.bucket_route(s, m, n, "r2c", masked=False) == \
            names[pair[1]]


# ------------------------------------------------- the kernel's index maps
def _pad(a):
    return a + (a >> 5)


def _rbucket_model(x, dr, di, gr, gi, s, m, n, masked):
    """A numpy model of ``csrc/coded_rbucket.cu``, index for index: the
    contiguous real load de-interleaved into the grouped, padded spectrum
    planes (element e to shard (e mod 2m) mod m, point e // 2m, the
    imaginary plane where e mod 2m >= m), each group's shards transformed
    in place (the row FFT's natural-order result), the code phase at
    natural p written back to the same words, then per output position u
    the split reads at natural p and n2 - p, the split twiddle from
    ``swr`` at sp and the recombine twiddle from ``twr`` at j*L + u
    (each checked equal to its table entry bit for bit), the m//2+1
    rows, the s//2+1 bins.  Returns the (q, s//2+1) complex output,
    float64 arithmetic."""
    q = x.shape[0]
    n2 = s // m // 2
    ell = 2 * n2
    hrows = m // 2 + 1
    rows = _group(m, n2, n=n, masked=masked)
    layout = _layout(m, n2, n=n, masked=masked)
    gp = _pad(rows * n2 - 1) + 1
    zplane = (layout[1] - layout[0]) // 2
    assert layout[2] - layout[1] == 2 * gp           # y: one full group
    groups = -(-m // rows)
    live = [min(rows, m - k * rows) for k in range(groups)]
    assert sum(live) == m and min(live) >= 1
    assert zplane == (groups - 1) * gp + _pad(live[-1] * n2 - 1) + 1
    # load: x[t*2m + k] -> shard k mod m, point t, imaginary if k >= m
    e = np.arange(s)
    k, t = e % (2 * m), e // (2 * m)
    im = k >= m
    i = np.where(im, k - m, k)
    g = i // rows
    slot = g * gp + _pad((i - g * rows) * n2 + t)
    # each word takes one real and one imaginary value, inside the plane
    assert len(np.unique(slot[~im])) == s // 2 == len(np.unique(slot[im]))
    assert np.array_equal(np.sort(slot[~im]), np.sort(slot[im]))
    assert slot.max() < zplane
    z = np.zeros((q, zplane), np.complex128)
    z[:, slot[~im]] += x[:, ~im].astype(np.float64)
    z[:, slot[im]] += 1j * x[:, im].astype(np.float64)
    ii = np.arange(m)[:, None]
    gi_ = ii // rows
    words = gi_ * gp + _pad((ii - gi_ * rows) * n2 + np.arange(n2)[None])
    # the loaded words are pack_real_planes' z_i[t]
    zr, zi = tcp.pack_real_planes(torch.as_tensor(x), m)
    assert np.array_equal(z[:, words], zr.numpy() + 1j * zi.numpy())
    for kk in range(groups):
        w = kk * gp + _pad(np.arange(live[kk] * n2))
        block = z[:, w].reshape(q, live[kk], n2)
        z[:, w] = np.fft.fft(block, axis=-1).reshape(q, -1)
    # code phase at natural p, written back in place
    gc = gr.astype(np.float64) + 1j * gi
    dc = dr.astype(np.float64) + 1j * di                     # (q, m, n)
    bres = np.einsum("rm,qmp->qrp", gc, z[:, words])
    z[:, words] = np.einsum("qjr,qrp->qjp", dc, bres)
    # split reads: natural p and n2 - p; the twiddles bit for bit the
    # L-point table (swr) and the s-point table at j*u (twr)
    swr, swi, twr, twi, fhr, fhi = tops._r2c_postdecode_planes(s, m)
    lr, li = fourstep_fft.fft_rows_twiddles(ell)
    assert np.array_equal(swr[0], lr[:n2 + 1])
    assert np.array_equal(swi[0], li[:n2 + 1])
    sr_, si_ = fourstep_fft.fft_rows_twiddles(s)
    u = np.arange(ell)
    for j in range(m):
        assert np.array_equal(twr[j], sr_[j * u])
        assert np.array_equal(twi[j], si_[j * u])
    lower = u <= n2
    sp = np.where(lower, u, ell - u)
    pa = np.where(sp == n2, 0, sp)
    pb = np.where(sp == 0, 0, n2 - sp)
    za, zb = z[:, words[:, pa]], z[:, words[:, pb]]          # (q, m, L)
    ev = 0.5 * (za + np.conj(zb))
    od = -0.5j * (za - np.conj(zb))
    c = ev + od * (swr[0][sp].astype(np.float64) + 1j * swi[0][sp])
    c = np.where(lower, c, np.conj(c))
    tw = twr.astype(np.float64) + 1j * twi                   # (m, L)
    fh = fhr.astype(np.float64) + 1j * fhi
    full = np.einsum("rj,qju->qru", fh, c * tw[None])       # (q, hrows, L)
    assert full.shape[1] == hrows
    return full.reshape(q, hrows * ell)[:, :s // 2 + 1]


def _spread(n, q=3):
    alt = np.arange(n) % 2 == 0
    return np.stack([np.roll(alt, k) for k in range(q)])


def _rbucket_planes(s, m):
    a, b = tops.split_factor(s // m // 2)
    return _t(*tops._dft_planes(a), *tops._twiddle_planes(a, b),
              *tops._dft_planes(b), *tops._r2c_postdecode_planes(s, m))


@pytest.mark.parametrize("s,m,n,masked", [
    (96, 3, 7, True), (768, 4, 6, True), (4096, 4, 8, True),
    (4096, 4, 8, False), (16384, 4, 8, True), (1024, 1, 3, True),
    (8 * 105, 4, 8, True), (8 * 127, 4, 8, False), (3000, 3, 5, False),
    (16 * 343, 8, 16, True), (32 * 64, 16, 32, True),
    (64 * 32, 32, 64, False), (32768, 8, 16, True)])
def test_rbucket_kernel_model_matches_body(s, m, n, masked):
    """The numpy model of the kernel's index maps against the plain twin
    of its mode (1e-4) and, at m <= 4, numpy.fft.rfft (TRUTH_TOL), on
    evenly spread responders."""
    masks = _spread(n)
    rng = np.random.default_rng(s + m)
    x = _rand(rng, len(masks), s)
    gr, gi = _gen_planes(n, m)
    dr, di = tops.lagrange_scatter_planes(
        tops.mask_subsets(torch.as_tensor(masks), m), n)
    got = _rbucket_model(x, dr.numpy(), di.numpy(), gr, gi, s, m, n, masked)
    planes = _rbucket_planes(s, m)
    if masked:
        want = tcp.rbucket_body_masked(*_t(x, masks.astype(np.float32), gr,
                                           gi), *planes, s)
    else:
        want = tcp.rbucket_body(*_t(x), dr, di, *_t(gr, gi), *planes, s)
    assert want[0].shape == got.shape
    assert _rel((got.real, got.imag), want) < TWIN_TOL
    if m <= 4:
        truth = np.fft.rfft(x.astype(np.float64), axis=-1)
        assert _rel((got.real, got.imag), (truth.real, truth.imag)) \
            < TRUTH_TOL


@pytest.mark.parametrize("s,m,n", [(8 * 105, 4, 8), (32 * 32, 16, 32)])
def test_rbucket_kernel_model_matches_reference(jref, s, m, n):
    """The model against the JAX kernel (``interpret=True``): radix-3/5/7
    packed shards at m = 4, and m = 16 on evenly spread responders."""
    jnp, jops = jref
    masks = _spread(n)
    rng = np.random.default_rng(s * m)
    x = _rand(rng, len(masks), s)
    gr, gi = _gen_planes(n, m)
    dr, di = tops.lagrange_scatter_planes(
        tops.mask_subsets(torch.as_tensor(masks), m), n)
    got = _rbucket_model(x, dr.numpy(), di.numpy(), gr, gi, s, m, n, True)
    jgot = jops.coded_rbucket_masked(
        jnp.asarray(x), jnp.asarray(masks), jnp.asarray(gr),
        jnp.asarray(gi), s, interpret=True, block_q=len(masks))
    assert _rel((got.real, got.imag), jgot) < TWIN_TOL


# ------------------------------------------------------------- GPU
@pytest.mark.gpu
@pytest.mark.parametrize("s,m,n", [(32768, 8, 16), (26624, 13, 26)])
def test_gpu_rbucket_in_groups_matches_plain(cuda, s, m, n):
    """Both entries where the block holds fewer than m shards a group
    (two groups of four at (32768, 8), groups of 12 and 1 at (26624,
    13)): one launch a call, each against its plain twin to 1e-4."""
    assert _group(m, s // m // 2) < m
    masks = _spread(n)
    gr, gi = _t(*_gen_planes(n, m))
    dr, di = tops.lagrange_scatter_planes(
        tops.mask_subsets(torch.as_tensor(masks), m), n)
    rng = np.random.default_rng(s)
    x = _rand(rng, len(masks), s)
    cases = [("coded_rfft_bucket_masked",
              lambda dev: tops.coded_rbucket_masked(
                  *_t(x, masks, device=dev), gr.to(dev), gi.to(dev), s)),
             ("coded_rfft_bucket",
              lambda dev: tops.coded_rbucket(
                  *_t(x, device=dev), dr.to(dev), di.to(dev), gr.to(dev),
                  gi.to(dev), s))]
    for name, call in cases:
        assert tops.coded_rbucket_fusable(s, m, n,
                                          masked=name.endswith("masked"))
        before = _build.launch_counts().get(name, 0)
        got = call(cuda)
        torch.cuda.synchronize()
        assert _build.launch_counts()[name] == before + 1
        want = call(torch.device("cpu"))
        assert _rel([g.cpu() for g in got], want) < TWIN_TOL


@pytest.mark.gpu
def test_gpu_rbucket_masks_of_any_dtype(cuda):
    """The card reads one byte a worker: a bool mask in place, any other
    dtype as its nonzero entries (mask_subsets' reading), so float, int
    and bool masks give the same bins, each one launch, and the twin's."""
    s, m, n = 4096, 4, 8
    masks = _spread(n)
    gr, gi = _t(*_gen_planes(n, m))
    x = _rand(np.random.default_rng(7), len(masks), s)
    want = tops.coded_rbucket_masked(*_t(x, masks), gr, gi, s)
    name = "coded_rfft_bucket_masked"
    for dtype in (torch.bool, torch.float32, torch.int32):
        mk = torch.as_tensor(masks, device=cuda).to(dtype)
        before = _build.launch_counts().get(name, 0)
        got = tops.coded_rbucket_masked(*_t(x, device=cuda), mk,
                                        gr.to(cuda), gi.to(cuda), s)
        torch.cuda.synchronize()
        assert _build.launch_counts()[name] == before + 1
        assert _rel([g.cpu() for g in got], want) < TWIN_TOL
