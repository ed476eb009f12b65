"""The c2r whole-bucket kernel's FFT layout and index maps.

``csrc/coded_irbucket.cu`` runs the adjoint message stage into the shard
groups' padded planes, packs each shard in place (pairs {p, n2 - p},
T_i[n2] in a side array), transforms the packed, conjugated shards with
the row FFT's passes (``fft_rows.cuh``) and runs the code phase at
natural positions.  It lays out ``coded_pipeline.bucket_fft_layout``
with the m rows of the +sign F_m and 2m side words, while the c2r
route's gate stays the dense design's reckoning,
``coded_pipeline.irbucket_layout``.  CPU tests: that layout counted by
hand; its fit wherever the gate admits a bucket; ``bucket_route``'s c2r
answers frozen as a sha256; and a numpy model of the kernel, index for
index (the Hermitian extension, the in-place pair pack, the conj trick,
the groups, the natural-order code phase, the unpack), held against the
plain twins ``irbucket_body`` / ``irbucket_body_masked``,
``numpy.fft.irfft`` and the JAX kernel in interpret mode.  Stated
tolerances, relative to the largest output magnitude: 1e-4 against a
twin (float64 model against f32 sums; the card's own tests hold the
kernel to the twin at 1e-4); ``TRUTH_TOL`` = 3e-4 against the
complex128 ``numpy.fft.irfft`` at m <= 4, the reference's whole-bucket
bound (wider codes decode ill-conditioned subsets in f32, so they are
held to the twins).

GPU tests (marker ``gpu``, skipped without a CUDA device): both entries
against their twins for m 1..32 at odd, prime and radix-3/5/7 packed
lengths, and where the shards split into groups; the masked entry on
bool, float and int masks (the card reads bytes); one traced
``coded_irbucket_kernel`` a call and nothing else, in a fresh process.
"""

import hashlib
import time

import numpy as np
import pytest
import torch
from test_torch_kernels import _gen_planes, _rel, _t
from test_torch_rbucket import _pad, _spread
from test_torch_real import _half_spectra, _np_irfft

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
    return tcp.bucket_fft_layout(m, n2, n=n, masked=masked, side=2 * m)


def _group(m, n2, n=0, masked=True):
    return tcp.bucket_fft_group(m, n2, n=n, masked=masked, side=2 * m)


# ------------------------------------------------------------ the layout
def test_irbucket_fft_layout_counted_by_hand():
    """(m=4, n2=512), the default bucket's packed shards: all four in one
    group, its plane padded one word in 32; every array of the block
    counted by hand, in the order the kernel takes them."""
    gp = 2048 + 63                    # _padded(4 * 512)
    words = [2 * gp,                  # z: one group of four shards
             2 * gp,                  # y: that group's ping-pong
             2 * (512 + 15),          # tab: the 512-point table
             2 * 4 * 4,               # gs: the subset's G rows
             2 * 4 * 4,               # fp: the +sign F_m
             2 * 4 * 4, 2 * 4 * 4,    # pw, qm
             2 * 5, 2 * 4, 4,         # loc, nodes, sub
             2 * 4]                   # side: T_i[n2]
    assert _group(4, 512) == 4
    assert _layout(4, 512) == tuple(np.cumsum([0] + words))
    assert 4 * _layout(4, 512)[-1] == 38624
    # the c2c kernel's layout plus the 2m side words
    assert _layout(4, 512)[:-1] == tcp.bucket_fft_layout(4, 512)
    # the planes kernel: all N = 8 rows of G and the request's (4, 8) D,
    # no Lagrange scratch
    planes = _layout(4, 512, n=8, masked=False)
    assert planes[-1] == 4 * gp + 2 * 527 + 64 + 32 + 64 + 8
    assert planes[4] - planes[3] == 64 and planes[7] - planes[6] == 64
    # the dense design's reckoning, the gate: 56,440 bytes here (its
    # folded half spectra alone 16,416), 222,840 at s = 16384, where
    # this layout takes 152,672
    assert 4 * tcp.irbucket_layout(4, 16, 32)[-1] == 56440
    assert 4 * tcp.irbucket_layout(4, 32, 64)[-1] == 222840
    assert 4 * _layout(4, 2048)[-1] == 152672
    # past the gate, fewer shards a group: (s, m) = (32768, 8) takes two
    # groups of four 2048-point shards, which the kernel serves all the
    # same (the GPU tests launch it there)
    assert not tops.coded_irbucket_fusable(32768, 8, 16)
    assert _group(8, 2048) == 4
    layout = _layout(8, 2048)
    assert layout[1] == 2 * 2 * (8192 + 255)
    assert 4 * layout[-1] <= tcp.SMEM_PER_BLOCK_OPTIN


_FIT_LENGTHS = sorted({1 << k for k in range(22)} | {
    96, 768, 3000, 12288, 5488, 3840, 8 * 127, 8 * 105, 8 * 1021,
    8 * 2209})


def _largest_planes_n(s, m):
    """The widest code N the c2r planes gate admits at (s, m) (N enters
    both layouts linearly, so the widest is the one to hold)."""
    lo, hi = m, 1 << 17
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if tops.coded_irbucket_fusable(s, m, mid, masked=False):
            lo = mid
        else:
            hi = mid - 1
    return lo


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("m", range(1, 33))
def test_irbucket_fft_layout_fits_wherever_the_gate_admits(m, masked):
    """The gate stays the dense design's reckoning (``irbucket_layout``);
    the kernel's own layout fits one block, all m shards in one group,
    at every shape it admits: s over the powers of two to 2^21, odd,
    prime and radix-3/5/7 packed lengths, every m to 32, both decode
    modes, N from m to the widest the planes gate admits."""
    checked = 0
    packed = (1, 2, 3, 5, 7, 61, 105, 125, 127, 343, 1021, 2209)
    for s in sorted(set(_FIT_LENGTHS) | {2 * m * k for k in packed}):
        if s % (2 * m) or not tops.coded_irbucket_fusable(s, m, m,
                                                          masked=masked):
            continue
        n2 = s // m // 2
        widest = m if masked else _largest_planes_n(s, m)
        for n in sorted({k for k in (m, m + 1, 2 * m, widest)
                         if k <= widest}):
            assert tops.coded_irbucket_fusable(s, m, n, masked=masked)
            layout = _layout(m, n2, n=n, masked=masked)
            assert 4 * layout[-1] <= tcp.SMEM_PER_BLOCK_OPTIN, (s, m, n)
            assert layout[-1] < tcp.irbucket_layout(
                m, *tops.split_factor(n2), n=n, masked=masked)[-1]
            assert _group(m, n2, n=n, masked=masked) == m
            checked += 1
    assert checked > 0


# bucket_route's c2r answers for eight codes (m, N) over 108 lengths, as
# the parent tree gave them, one sha256 a decode mode (f fused, s stage:
# 305 fused masked, 304 on planes): the kernel's FFT redesign moves no
# bucket.
_C2R_CODES = [(1, 3), (2, 5), (3, 7), (4, 8), (5, 10), (8, 16), (16, 32),
              (32, 64)]
_C2R_PACKED = (1, 3, 5, 7, 61, 105, 125, 127, 343, 1021, 2209, 2210)
_C2R_ROUTES = {
    True: (305, "0490bbb377890158606e3f142a9b64e7"
                "687ac72b25b768a983e79ced7d9bb70e"),
    False: (304, "ee8396b4e47f791fee6346391f396105"
                 "a68f9ceafda60f322589b5a38d1a856a"),
}


@pytest.mark.parametrize("masked", [True, False])
def test_bucket_route_is_frozen_for_c2r(masked):
    lengths = sorted({1 << k for k in range(1, 22)} | {
        2 * m * k for m, _ in _C2R_CODES for k in _C2R_PACKED})
    assert len(lengths) == 108
    table = "\n".join(
        f"{s}:" + "".join(tops.bucket_route(s, m, n, "c2r",
                                            masked=masked)[0]
                          for m, n in _C2R_CODES) for s in lengths)
    fused, digest = _C2R_ROUTES[masked]
    assert table.count("f") == fused
    assert hashlib.sha256(table.encode()).hexdigest() == digest


# ------------------------------------------------- the kernel's index maps
def _irbucket_model(yr, yi, dr, di, gr, gi, s, m, n, masked):
    """A numpy model of ``csrc/coded_irbucket.cu``, index for index: per
    position t <= n2 the m bins X[r*L + t] of the Hermitian extension
    (endpoint imaginary parts dropped, conj(y[s - v]) past the half), the
    +sign m-point DFT and the conjugate twiddle ctw[i, t], T_i[t] written
    to shard i's word in the grouped, padded planes and T_i[n2] to the
    side array; the pack by pairs {p, n2 - p}, each word written once,
    in place, conjugated; each group's shards transformed (the row FFT's
    natural-order result); then per packed position p the encode with
    conj(G), the conj trick's (re/n2, -im/n2), the decode and the unpack
    to out[2p*m + j], out[(2p+1)*m + j].  Returns the (q, s) real
    output, float64 arithmetic."""
    q = yr.shape[0]
    n2 = s // m // 2
    ell = 2 * n2
    half = s // 2
    rows = _group(m, n2, n=n, masked=masked)
    layout = _layout(m, n2, n=n, masked=masked)
    gp = _pad(rows * n2 - 1) + 1
    zplane = (layout[1] - layout[0]) // 2
    assert layout[2] - layout[1] == 2 * gp           # y: one full group
    assert layout[-1] - layout[-2] == 2 * m          # side: T_i[n2]
    groups = -(-m // rows)
    live = [min(rows, m - k * rows) for k in range(groups)]
    assert sum(live) == m and min(live) >= 1
    assert zplane == (groups - 1) * gp + _pad(live[-1] * n2 - 1) + 1
    ii = np.arange(m)[:, None]
    gi_ = ii // rows
    words = gi_ * gp + _pad((ii - gi_ * rows) * n2 + np.arange(n2)[None])
    assert len(np.unique(words)) == m * n2 and words.max() < zplane
    # message stage: the bins each thread t <= n2 reads, then T_i[t]
    fpr, fpi, ctwr, ctwi, pwr, pwi = tops._c2r_message_planes(s, m)
    t = np.arange(n2 + 1)
    v = np.arange(m)[:, None] * ell + t[None]        # (m, n2+1)
    lower = v <= half
    src = np.where(lower, v, s - v)
    assert src.min() >= 0 and src.max() <= half
    yc = yr.astype(np.float64) + 1j * yi
    yc[:, 0] = yc[:, 0].real
    yc[:, half] = yc[:, half].real
    x = np.where(lower[None], yc[:, src], np.conj(yc[:, src]))
    fp = fpr.astype(np.float64) + 1j * fpi
    ctw = ctwr.astype(np.float64) + 1j * ctwi
    tt = np.einsum("ir,qrt->qit", fp, x) * ctw[None, :, :n2 + 1]
    z = np.zeros((q, zplane), np.complex128)
    z[:, words] = tt[..., :n2]
    side = tt[..., n2]                               # (q, m)
    # pack: one thread a pair {p, n2 - p} of a shard, in place; every
    # word of every shard written exactly once
    pw = pwr[0].astype(np.float64) + 1j * pwi[0]
    pp = np.arange(n2 // 2 + 1)
    partner = (pp > 0) & (2 * pp != n2)
    written = np.concatenate([pp, (n2 - pp)[partner]])
    assert np.array_equal(np.sort(written), np.arange(n2))
    snap = z.copy()

    def packed(a, b, p):
        ev = 0.5 * (a + np.conj(b))
        od = 0.5 * (a - np.conj(b)) * pw[p]
        return np.conj(ev + 1j * od)

    a = snap[:, words[:, pp]]                        # T_i[p]
    b = np.where(pp == 0, side[..., None],
                 snap[:, words[:, (n2 - pp) % n2]])  # T_i[n2 - p]
    z[:, words[:, pp]] = packed(a, b, pp)
    z[:, words[:, (n2 - pp)[partner]]] = packed(b[..., partner],
                                                 a[..., partner],
                                                 (n2 - pp)[partner])
    # the packed words are ir_message_body's z_i, conjugated
    zr, zi = tcp.ir_message_body(*_t(yr, yi, fpr, fpi, ctwr, ctwi, pwr,
                                     pwi), s, m)
    want = zr.double().numpy() - 1j * zi.double().numpy()
    assert np.abs(z[:, words] - want).max() <= 1e-5 * np.abs(want).max()
    for kk in range(groups):
        w = kk * gp + _pad(np.arange(live[kk] * n2))
        block = z[:, w].reshape(q, live[kk], n2)
        z[:, w] = np.fft.fft(block, axis=-1).reshape(q, -1)
    # code phase at natural p: encode with conj(G), the conj trick, decode
    gc = gr.astype(np.float64) + 1j * gi
    dc = dr.astype(np.float64) + 1j * di                     # (q, m, n)
    bres = np.einsum("rm,qmp->qrp", np.conj(gc), z[:, words])
    bres = np.conj(bres) / n2
    h = np.einsum("qjr,qrp->qjp", dc, bres)                  # (q, m, n2)
    # unpack: thread p stores 2m consecutive floats, each output once
    p = np.arange(n2)[:, None]
    j = np.arange(m)[None]
    even, odd = 2 * p * m + j, (2 * p + 1) * m + j
    idx = np.concatenate([even.ravel(), odd.ravel()])
    assert np.array_equal(np.sort(idx), np.arange(s))
    out = np.zeros((q, s))
    out[:, even] = h.real.transpose(0, 2, 1) / m
    out[:, odd] = h.imag.transpose(0, 2, 1) / m
    return out


def _irbucket_planes(s, m):
    a, b = tops.split_factor(s // m // 2)
    return _t(*tops._dft_planes(a), *tops._twiddle_planes(a, b),
              *tops._dft_planes(b), *tops._c2r_message_planes(s, m))


@pytest.mark.parametrize("s,m,n,masked", [
    (96, 3, 7, True), (768, 4, 6, True), (4096, 4, 8, True),
    (4096, 4, 8, False), (16384, 4, 8, True), (1024, 1, 3, True),
    (2, 1, 3, True), (12, 2, 5, False), (8 * 105, 4, 8, True),
    (8 * 127, 4, 8, False), (3000, 3, 5, False), (16 * 343, 8, 16, True),
    (32 * 64, 16, 32, True), (64 * 32, 32, 64, False),
    (32768, 8, 16, True), (32768, 8, 16, False)])
def test_irbucket_kernel_model_matches_body(s, m, n, masked):
    """The numpy model of the kernel's index maps against the plain twin
    of its mode (1e-4) and, at m <= 4, numpy.fft.irfft (TRUTH_TOL), on
    evenly spread responders; (32768, 8) past the gate, in two groups."""
    masks = _spread(n)
    rng = np.random.default_rng(s + m)
    yr, yi = _half_spectra(rng, len(masks), s)
    gr, gi = _gen_planes(n, m)
    dr, di = tops.lagrange_scatter_planes(
        tops.mask_subsets(torch.as_tensor(masks), m), n)
    got = _irbucket_model(yr, yi, dr.numpy(), di.numpy(), gr, gi, s, m, n,
                          masked)
    planes = _irbucket_planes(s, m)
    if masked:
        want = tcp.irbucket_body_masked(*_t(yr, yi, masks.astype(np.float32),
                                            gr, gi), *planes, s)
    else:
        want = tcp.irbucket_body(*_t(yr, yi), dr, di, *_t(gr, gi), *planes,
                                 s)
    assert want.shape == got.shape
    assert _rel([got], [want]) < TWIN_TOL
    if m <= 4:
        assert _rel([got], [_np_irfft(yr, yi, s)]) < TRUTH_TOL


@pytest.mark.parametrize("s,m,n", [(64, 1, 3), (96, 2, 5), (96, 3, 7),
                                   (768, 4, 8), (210, 5, 10),
                                   (240, 8, 16)])
def test_irbucket_kernel_model_matches_reference(jref, s, m, n):
    """The model against the JAX kernel (``interpret=True``) for m in
    {1, 2, 3, 4, 5, 8}, odd and radix-3/5/7 packed lengths among them,
    on evenly spread responders."""
    jnp, jops = jref
    masks = _spread(n)
    rng = np.random.default_rng(s * m)
    yr, yi = _half_spectra(rng, len(masks), s)
    gr, gi = _gen_planes(n, m)
    dr, di = tops.lagrange_scatter_planes(
        tops.mask_subsets(torch.as_tensor(masks), m), n)
    got = _irbucket_model(yr, yi, dr.numpy(), di.numpy(), gr, gi, s, m, n,
                          True)
    jgot = jops.coded_irbucket_masked(
        jnp.asarray(yr), jnp.asarray(yi), jnp.asarray(masks),
        jnp.asarray(gr), jnp.asarray(gi), s, interpret=True,
        block_q=len(masks))
    assert _rel([got], [jgot]) < TWIN_TOL


# ------------------------------------------------------------- GPU
def _gpu_shapes(m):
    """(s, n) for m: prime, odd and radix-3/5/7 packed lengths the gate
    admits, and a power of two; n = 2m."""
    out = []
    for n2 in (61, 105, 127, 512):
        s = 2 * m * n2
        if tops.coded_irbucket_fusable(s, m, 2 * m, masked=True):
            out.append(s)
    return out


def _entries(x_y, masks, dr, di, gr, gi, s):
    yr, yi = x_y
    return [("coded_irfft_bucket_masked",
             lambda dev: tops.coded_irbucket_masked(
                 *_t(yr, yi, masks, device=dev), gr.to(dev), gi.to(dev), s)),
            ("coded_irfft_bucket",
             lambda dev: tops.coded_irbucket(
                 *_t(yr, yi, device=dev), dr.to(dev), di.to(dev), gr.to(dev),
                 gi.to(dev), s))]


@pytest.mark.gpu
@pytest.mark.parametrize("m", range(1, 33))
def test_gpu_irbucket_matches_plain(cuda, m):
    """Both entries at every m to 32, at prime, odd and radix-3/5/7
    packed lengths and a power of two (each where the gate admits it):
    one launch a call, each against its plain twin to 1e-4, on evenly
    spread responders."""
    n = 2 * m
    masks = _spread(n)
    gr, gi = _t(*_gen_planes(n, m))
    dr, di = tops.lagrange_scatter_planes(
        tops.mask_subsets(torch.as_tensor(masks), m), n)
    shapes = _gpu_shapes(m)
    assert shapes
    for s in shapes:
        rng = np.random.default_rng(s + m)
        for name, call in _entries(_half_spectra(rng, len(masks), s), masks,
                                   dr, di, gr, gi, s):
            before = _build.launch_counts().get(name, 0)
            got = call(cuda)
            torch.cuda.synchronize()
            assert _build.launch_counts()[name] == before + 1
            want = call(torch.device("cpu"))
            assert _rel([got.cpu()], [want]) < TWIN_TOL, (s, name)


@pytest.mark.gpu
@pytest.mark.parametrize("s,m,n", [(32768, 8, 16), (26624, 13, 26)])
def test_gpu_irbucket_in_groups_matches_plain(cuda, s, m, n):
    """Both entries where the block holds fewer than m shards a group
    (two groups of four at (32768, 8), groups of 12 and 1 at (26624,
    13)): shapes past the dense gate, which the kernel serves when
    called; one launch a call, each against its plain twin to 1e-4."""
    assert _group(m, s // m // 2) < m
    masks = _spread(n)
    gr, gi = _t(*_gen_planes(n, m))
    dr, di = tops.lagrange_scatter_planes(
        tops.mask_subsets(torch.as_tensor(masks), m), n)
    rng = np.random.default_rng(s)
    for name, call in _entries(_half_spectra(rng, len(masks), s), masks,
                               dr, di, gr, gi, s):
        before = _build.launch_counts().get(name, 0)
        got = call(cuda)
        torch.cuda.synchronize()
        assert _build.launch_counts()[name] == before + 1
        want = call(torch.device("cpu"))
        assert _rel([got.cpu()], [want]) < TWIN_TOL


@pytest.mark.gpu
def test_gpu_irbucket_masks_of_any_dtype(cuda):
    """The card reads one byte a worker: a bool mask in place, any other
    dtype as its nonzero entries (mask_subsets' reading), so float, int
    and bool masks give the same output, each one launch, and the
    twin's."""
    s, m, n = 4096, 4, 8
    masks = _spread(n)
    gr, gi = _t(*_gen_planes(n, m))
    yr, yi = _half_spectra(np.random.default_rng(7), len(masks), s)
    want = tops.coded_irbucket_masked(*_t(yr, yi, masks), gr, gi, s)
    name = "coded_irfft_bucket_masked"
    for dtype in (torch.bool, torch.float32, torch.int32):
        mk = torch.as_tensor(masks, device=cuda).to(dtype)
        before = _build.launch_counts().get(name, 0)
        got = tops.coded_irbucket_masked(*_t(yr, yi, device=cuda), mk,
                                         gr.to(cuda), gi.to(cuda), s)
        torch.cuda.synchronize()
        assert _build.launch_counts()[name] == before + 1
        assert _rel([got.cpu()], [want]) < TWIN_TOL


def _trace_cases():
    """Each entry's call at the service default bucket (64 requests,
    s = 4096, m = 4, N = 8, a bool mask) once under ``torch.profiler``,
    in this process: prints one JSON object, per entry the launch
    counts, the traced kernels and the error against the twin.  Run in a
    fresh process (``traced``), as ``tests/test_torch_fftblock.py`` does
    for its kernel."""
    import json

    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device("cuda")
    q, s, m, n = 64, 4096, 4, 8
    masks = torch.as_tensor(_spread(n, q))
    gr, gi = _t(*_gen_planes(n, m))
    dr, di = tops.lagrange_scatter_planes(tops.mask_subsets(masks, m), n)
    yr, yi = _t(*_half_spectra(np.random.default_rng(11), q, s))
    cases = [("coded_irfft_bucket_masked", tops.coded_irbucket_masked,
              (yr, yi, masks, gr, gi, s)),
             ("coded_irfft_bucket", tops.coded_irbucket,
              (yr, yi, dr, di, gr, gi, s))]
    out = []
    for name, entry, args in cases:
        on_card = [a.to(cuda) if isinstance(a, torch.Tensor) else a
                   for a in args]
        entry(*on_card)                            # build and warm
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            got = entry(*on_card)
            torch.cuda.synchronize()
            time.sleep(0.05)
        counts = _build.launch_counts()
        ran = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
        out.append({"name": name, "launches": counts, "ran": ran,
                    "rel": _rel([got.cpu()], [entry(*args)])})
    print(json.dumps(out))


@pytest.fixture(scope="module")
def traced():
    """:func:`_trace_cases` in a new Python process; its results."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    tests = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tests.parent / "src"), str(tests)]))
    done = subprocess.run(
        [sys.executable, "-c",
         "import test_torch_irbucket as t; t._trace_cases()"],
        cwd=tests, env=env, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("case", [0, 1], ids=["masked", "planes"])
def test_gpu_irbucket_is_one_launch(traced, case):
    """One traced call is one launch of ``coded_irbucket_kernel`` and of
    nothing else (the bool mask is read in place: no conversion launch),
    counted once under its wrapper's name, and matches its twin at
    1e-4."""
    got = traced[case]
    assert got["launches"] == {got["name"]: 1}
    assert len(got["ran"]) == 1, got["ran"]
    (kernel, count), = got["ran"].items()
    assert "coded_irbucket_kernel" in kernel and count == 1
    assert got["rel"] < TWIN_TOL


def test_irbucket_table_is_the_planes_entries():
    """The card's n2-point f32 table holds the entries of the planes the
    twins read: F_B's row 1 at B = n2 (A = 1), bit for bit."""
    for n2 in (61, 105, 127, 512):
        tr, ti = fourstep_fft.fft_rows_twiddles(n2)
        fbr, fbi = tops._dft_planes(n2)
        assert np.array_equal(tr, fbr[1]) and np.array_equal(ti, fbi[1])
