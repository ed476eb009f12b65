"""The port's ``CodedFFT`` kernel backend against the JAX package.

CPU tests: the same numpy inputs, made from a seed, go through both
packages.  Each kernel wrapper, given CPU tensors, runs its plain PyTorch
twin; it must agree with the JAX Pallas kernel run through the real
Pallas machinery (``interpret=True``).  Stated tolerances, relative to the
largest output magnitude:

* 1e-5 between the four-step plain twins and the reference kernels (the
  reference's own two-pass-vs-fused bound, ``tests/test_kernels.py:78``);
* 1e-4 for ``cmatmul`` (``tests/test_kernels.py:107``);
* 2e-4 for the four-step FFT against ``numpy.fft``
  (``tests/test_kernels.py:29``);
* 5e-4 for the whole plan against the reference plan and ``numpy.fft``
  (``tests/test_kernels.py:146``).

The row FFT of ``fourstep_stage2`` has no Pallas twin: a numpy model of
its pass schedule, index for index, on the radix plan and twiddle table
the wrapper passes to the kernel, is held against ``numpy.fft`` (1e-12
on a float64 table, 1e-6 on the f32 one), and the table against the DFT
plane, bit for bit.

GPU tests (marker ``gpu``, skipped without a CUDA device): each of the
four kernels against its plain twin on the card, at the smoke run's
shapes, at A = 1 and at the fused gate, the row FFT over a sweep of B,
and their launch counters.
"""

import itertools

import numpy as np
import pytest
import torch
from test_torch_kernels import private_autotune_table  # noqa: F401

from repro_torch import CodedFFT
from repro_torch.core import mds as tmds
from repro_torch.core import plan as tplan
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels.cmatmul import cmatmul, cmatmul_body
from repro_torch.kernels.fourstep_fft import (
    fft_rows_layout,
    fft_rows_per_block,
    fft_rows_plan,
    fft_rows_twiddles,
    fourstep_body,
    fourstep_fused,
    fourstep_stage1,
    fourstep_stage2,
    stage1_body,
    stage2_body,
)

CPU = torch.device("cpu")
PAIR_TOL = 1e-5
CMATMUL_TOL = 1e-4
FFT_RTOL = 2e-4
PLAN_TOL = 5e-4


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
    from repro.core import mds as jmds
    from repro.kernels import cmatmul as jcm
    from repro.kernels import fourstep_fft as jfs
    from repro.kernels import ops as jops

    return jnp, JCodedFFT, jmds, jcm, jfs, jops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


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


def _t(*arrays, device=CPU):
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def _planes(a, b):
    return (*tops._dft_planes(a), *tops._twiddle_planes(a, b),
            *tops._dft_planes(b))


# ------------------------------------------------------------ CPU parity
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("ell", [64, 384, 1024, 127])
def test_fourstep_plain_twins_match_reference(jref, ell, batch):
    """fourstep_fused, fourstep_stage1 and fourstep_stage2 (plain twins on
    the CPU) == the reference Pallas kernels in interpret mode; A = 1 for
    the prime L = 127."""
    jnp, _, _, _, jfs, _ = jref
    a, b = tops.split_factor(ell)
    assert (a == 1) == (ell == 127)
    rng = np.random.default_rng(ell + batch)
    xr, xi = _rand(rng, batch, a, b), _rand(rng, batch, a, b)
    far, fai, wr, wi, fbr, fbi = _planes(a, b)
    j = lambda *xs: [jnp.asarray(x) for x in xs]
    got = fourstep_fused(*_t(xr, xi, far, fai, wr, wi, fbr, fbi))
    want = jfs.fourstep_fused(*j(xr, xi, far, fai, wr, wi, fbr, fbi),
                              block_q=batch, interpret=True)
    assert _rel(got, want) < PAIR_TOL
    t1 = fourstep_stage1(*_t(xr, xi, far, fai, wr, wi))
    jt1 = jfs.fourstep_stage1(*j(xr, xi, far, fai, wr, wi), block_q=batch,
                              interpret=True)
    assert _rel(t1, jt1) < PAIR_TOL
    t1n = [np.ascontiguousarray(_np(t)) for t in t1]
    out = fourstep_stage2(*_t(*t1n))
    jout = jfs.fourstep_stage2(*j(*t1n, fbr, fbi), block_q=batch,
                               interpret=True)
    assert _rel(out, jout) < PAIR_TOL
    assert _rel(out, got) < PAIR_TOL          # two-pass == fused


# (batch, A, B) of the column pass past the plan lengths above: a prime A
# (61 x 67), the mixed radix A = B = 384, A = 8 over a prime B = 4093
STAGE1_EDGES = [(2, 61, 67), (1, 384, 384), (2, 8, 4093)]


@pytest.mark.parametrize("batch,a,b", STAGE1_EDGES)
def test_fourstep_stage1_edge_shapes_match_reference(jref, batch, a, b):
    """fourstep_stage1's plain twin == the reference Pallas kernel in
    interpret mode (PAIR_TOL) at the column FFT's hard shapes on the card
    (A = 1 runs in test_fourstep_plain_twins_match_reference), and the
    pair == numpy.fft (FFT_RTOL)."""
    jnp, _, _, _, jfs, _ = jref
    rng = np.random.default_rng(a * b + batch)
    xr, xi = _rand(rng, batch, a, b), _rand(rng, batch, a, b)
    far, fai, wr, wi, _, _ = _planes(a, b)
    t1 = fourstep_stage1(*_t(xr, xi, far, fai, wr, wi))
    jt1 = jfs.fourstep_stage1(*[jnp.asarray(v) for v in
                                (xr, xi, far, fai, wr, wi)],
                              block_q=batch, block_b=b, interpret=True)
    assert _rel(t1, jt1) < PAIR_TOL
    out = fourstep_stage2(*(t.contiguous() for t in t1))
    x = (xr + 1j * xi.astype(np.float64)).reshape(batch, -1)
    want = np.fft.fft(x, axis=-1).reshape(batch, b, a).transpose(0, 2, 1)
    assert _rel(out, [want.real, want.imag]) < FFT_RTOL


@pytest.mark.parametrize("m,k,ell", [(8, 4, 1000), (4, 4, 64), (7, 3, 37)])
def test_cmatmul_matches_reference(jref, m, k, ell):
    jnp, _, _, jcm, _, _ = jref
    rng = np.random.default_rng(m * k + ell)
    args = (_rand(rng, m, k), _rand(rng, m, k), _rand(rng, k, ell),
            _rand(rng, k, ell))
    got = cmatmul(*_t(*args))
    assert got[0].shape == (m, ell)
    want = jcm.cmatmul(*[jnp.asarray(x) for x in args], block_l=128,
                       interpret=True)
    assert _rel(got, want) < CMATMUL_TOL


@pytest.mark.parametrize("fused", [None, True, False])
@pytest.mark.parametrize("ell", [64, 1024, 240])
def test_fft_fourstep_matches_numpy(ell, fused):
    rng = np.random.default_rng(ell)
    x = _crand(rng, 2, 3, ell)
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    got = tops.fft_fourstep(torch.as_tensor(x), fused=fused)
    assert got.shape == x.shape and got.dtype == torch.complex64
    assert _rel(got, want) < FFT_RTOL
    one = tops.fft_fourstep(torch.as_tensor(x[0, 0]), fused=fused)
    assert one.shape == (ell,) and _rel(one, want[0, 0]) < FFT_RTOL


@pytest.mark.parametrize("variant", ["fused", "two_pass", "xla", None])
@pytest.mark.parametrize("ell", [384, 127, 16384, 8191])
def test_fourstep_planar_variants_match_numpy(ell, variant):
    """Every variant at a fusable length, at A = 1, past the fused gate
    (so the two-pass plain route runs) and at a near-prime length whose
    dense plane the port refuses (the platform FFT, whatever the
    variant)."""
    a, b = tops.split_factor(ell)
    rng = np.random.default_rng(ell + 7)
    x = _crand(rng, 2, ell)
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    xr, xi = _t(x.real.copy(), x.imag.copy())
    if variant == "fused" and not tops.fourstep_fusable(a, b) \
            and b * b <= tops.MAX_PLANE_ELEMS:
        with pytest.raises(ValueError, match="two_pass"):
            tops.fourstep_planar(xr, xi, variant=variant)
        return
    got = tops.fourstep_planar(xr, xi, variant=variant)
    assert got[0].shape == (2, ell) and got[0].dtype == torch.float32
    assert _rel(got, want) < FFT_RTOL


def test_fourstep_planar_routing(monkeypatch):
    """variant=None (with an empty autotune table) picks fused, two-pass
    or the platform FFT by ``fourstep_fusable`` (the kernel's
    shared-memory reckoning) and the plane limit; a radix plan of more
    than two factors runs the multistep kernel; explicit factors and
    unknown variants are checked."""
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        monkeypatch.setattr(tops, name, wrapped)

    spy("fourstep_fused", tops.fourstep_fused)
    spy("fourstep_stage1", tops.fourstep_stage1)
    spy("fourstep_stage2", tops.fourstep_stage2)
    spy("multistep_fused", tops.multistep_fused)
    fft = torch.fft.fft
    monkeypatch.setattr(torch.fft, "fft", lambda *a, **k: (
        calls.append("xla"), fft(*a, **k))[1])
    # L: (fusable, route); the prime 4099 fits a block as (1, 4099) but
    # its dense 4099-point plane is past MAX_PLANE_ELEMS
    cases = {1024: (True, ["fourstep_fused"]),
             8192: (True, ["fourstep_fused"]),
             16384: (False, ["fourstep_stage1", "fourstep_stage2"]),
             127: (True, ["fourstep_fused"]),
             4099: (True, ["xla"])}
    for ell, (fusable, route) in cases.items():
        assert tops.fourstep_fusable(*tops.split_factor(ell)) == fusable
        calls.clear()
        tops.fourstep_planar(torch.zeros(1, ell), torch.zeros(1, ell))
        assert calls == route, ell
    # the gate is the kernel's working set: two A x B complex planes
    assert tops.fourstep_layout(32, 32) == (0, 2048, 4096)
    assert tops.fourstep_fusable(120, 121)
    assert not tops.fourstep_fusable(121, 121)
    calls.clear()
    tops.fourstep_planar(torch.zeros(1, 64), torch.zeros(1, 64),
                         factors=(4, 16), fused=False)
    assert calls == ["fourstep_stage1", "fourstep_stage2"]
    calls.clear()
    tops.fourstep_planar(torch.zeros(1, 64), torch.zeros(1, 64),
                         factors=(4, 4, 4))
    assert calls == ["multistep_fused"]
    with pytest.raises(ValueError):
        tops.fourstep_planar(torch.zeros(1, 64), torch.zeros(1, 64),
                             factors=(4, 8))
    with pytest.raises(ValueError):
        tops.fourstep_planar(torch.zeros(1, 64), torch.zeros(1, 64),
                             variant="radix2")


def test_make_kernel_worker_fn_forward_and_inverse():
    rng = np.random.default_rng(3)
    a = _crand(rng, 2, 8, 96)
    fwd = tops.make_kernel_worker_fn()(torch.as_tensor(a))
    inv = tops.make_kernel_worker_fn(inverse=True)(torch.as_tensor(a))
    assert fwd.shape == inv.shape == a.shape
    assert _rel(fwd, np.fft.fft(a.astype(np.complex128))) < FFT_RTOL
    assert _rel(inv, np.fft.ifft(a.astype(np.complex128))) < FFT_RTOL


@pytest.mark.parametrize("n,m,payload", [(8, 4, (96,)), (7, 3, (2, 30))])
def test_mds_apply_matches_reference(jref, n, m, payload):
    jnp, _, _, _, _, jops = jref
    rng = np.random.default_rng(n * m)
    g = _crand(rng, n, m)
    c = _crand(rng, m, *payload)
    got = tops.mds_apply(*_t(g, c))
    assert got.shape == (n, *payload) and got.dtype == torch.complex64
    assert _rel(got, np.asarray(jops.mds_apply(jnp.asarray(g),
                                               jnp.asarray(c)))) \
        < CMATMUL_TOL
    assert _rel(got, np.einsum("nm,m...->n...", g.astype(np.complex128),
                               c)) < CMATMUL_TOL


def test_subset_decode_matrix_every_subset(jref):
    """inv(G[subset]) for every 4-subset of an (8, 4) code == the
    reference's, and it inverts the subset rows."""
    jnp, _, jmds, _, _, _ = jref
    n, m = 8, 4
    g = tmds.rs_generator(n, m, torch.complex64, CPU)
    jg = jnp.asarray(g.numpy())
    for subset in itertools.combinations(range(n), m):
        sub = torch.as_tensor(subset)
        got = tmds.subset_decode_matrix(g, sub)
        want = np.asarray(jmds.subset_decode_matrix(
            jg, jnp.asarray(np.array(subset))))
        assert _rel(got, want) < CMATMUL_TOL
        eye = got.numpy().astype(np.complex128) @ g.numpy()[list(subset)]
        np.testing.assert_allclose(eye, np.eye(m), atol=1e-5)


def _poison(b, subsets):
    """NaN in every worker row outside each request's subset."""
    b = b.clone()
    for i, keep in enumerate(subsets):
        drop = sorted(set(range(b.shape[-2])) - set(keep.tolist()))
        b[i, drop] = float("nan")
    return b


DECODES = ["unbatched_subset", "unbatched_mask", "one_mask", "one_subset",
           "batched_mask", "batched_subsets", "batched_shared_subset",
           "batched_default", "unbatched_solve"]


@pytest.mark.parametrize("case", DECODES)
@pytest.mark.parametrize("s,m,n", [(256, 4, 8), (240, 3, 7)])
def test_plan_kernel_backend_matches_reference(jref, s, m, n, case):
    """The port's CodedFFT(device='cpu') on its default kernel backend ==
    repro.core.CodedFFT on its own, and both == numpy.fft, on every branch
    of the decode dispatch, with NaN in every row the decode must not
    read."""
    jnp, JCodedFFT, _, _, _, _ = jref
    tp = CodedFFT(s=s, m=m, n_workers=n, device="cpu")
    jp = JCodedFFT(s=s, m=m, n_workers=n)
    assert tp.resolved_backend == jp.resolved_backend == "kernel"
    rng = np.random.default_rng(s + m)
    q = 3
    x = _crand(rng, q, s)
    masks = np.zeros((q, n), bool)
    for row in masks:
        row[rng.choice(n, size=m + int(rng.integers(0, n - m + 1)),
                       replace=False)] = True
    first = np.stack([np.flatnonzero(r)[:m] for r in masks])
    unbatched = case.startswith("unbatched")
    if unbatched:
        x, masks, first = x[0], masks[0], first[0]
    elif case.startswith("one"):
        x, masks, first = x[:1], masks[:1], first[:1]
    kwargs, keep = {}, first
    if case.endswith("mask"):
        kwargs["mask"] = masks
    elif case.endswith("subsets") or case in ("unbatched_subset",
                                              "one_subset"):
        kwargs["subset"] = first
    elif case == "batched_shared_subset":
        kwargs["subset"] = first[1]
        keep = np.broadcast_to(first[1], first.shape)
    elif case == "unbatched_solve":
        kwargs["subset"] = first
        kwargs["method"] = "solve"
    else:
        keep = np.broadcast_to(np.arange(m), first.shape)
    b = tp.worker_compute(tp.encode(torch.as_tensor(x)))
    jb = jp.worker_compute(jp.encode(jnp.asarray(x)))
    assert _rel(b, np.asarray(jb)) < PLAN_TOL
    pb = (_poison(b[None], keep[None])[0] if unbatched
          else _poison(b, keep))
    t_kwargs = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
                for k, v in kwargs.items()}
    j_kwargs = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                for k, v in kwargs.items()}
    got = tp.decode(pb, **t_kwargs)
    jgot = np.asarray(jp.decode(jnp.asarray(pb.numpy()), **j_kwargs))
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert got.shape == x.shape and np.isfinite(got.numpy()).all()
    assert _rel(got, want) < PLAN_TOL
    assert _rel(got, jgot) < PLAN_TOL
    run = tp.run(torch.as_tensor(x), **t_kwargs)
    assert _rel(run, want) < PLAN_TOL


def test_plan_decode_dispatch(monkeypatch):
    """mds_apply runs for the encode and, with method='auto', for the
    decode of an unbatched request or a batch of one -- never for a batch
    of more than one, for method='solve', or on the reference backend."""
    calls = []
    real = tops.mds_apply

    def spy(g, c):
        calls.append(tuple(g.shape))
        return real(g, c)

    monkeypatch.setattr(tplan.ops, "mds_apply", spy)
    plan = CodedFFT(s=64, m=4, n_workers=8, device="cpu")
    x = torch.as_tensor(_crand(np.random.default_rng(0), 3, 64))
    mask = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.bool)
    for xin, kw, want in [
            (x[0], {"mask": mask}, [(8, 4), (4, 4)]),
            (x[:1], {"mask": mask[None]}, [(8, 4), (4, 4)]),
            (x[:1], {}, [(8, 4), (4, 4)]),
            (x, {"mask": mask}, [(8, 4)]),
            (x, {}, [(8, 4)]),
            (x[0], {"method": "solve"}, [(8, 4)])]:
        calls.clear()
        out = plan.run(xin, **kw)
        assert calls == want, kw
        assert _rel(out, np.fft.fft(xin.numpy().astype(np.complex128))) \
            < PLAN_TOL
    # the transform decode: the encode's mds_apply only
    calls.clear()
    out = plan.run(x, method="ifft")
    assert calls == [(8, 4)]
    assert _rel(out, np.fft.fft(x.numpy().astype(np.complex128))) < PLAN_TOL
    calls.clear()
    ref_plan = CodedFFT(s=64, m=4, n_workers=8, device="cpu",
                        backend="reference")
    ref_plan.run(x[0], mask=mask)
    assert calls == []


def test_plan_encode_fold_and_worker_fn(jref):
    """The kernel encode folds any batch shape into the payload columns:
    == the dense G @ c, the reference backend's DFT encode and the
    reference plan's encode; an explicit worker_fn replaces the kernel
    worker."""
    jnp, JCodedFFT, _, _, _, _ = jref
    s, m, n = 96, 4, 6
    rng = np.random.default_rng(5)
    x = _crand(rng, 2, 3, s)
    tp = CodedFFT(s=s, m=m, n_workers=n, device="cpu")
    enc = tp.encode(torch.as_tensor(x))
    assert enc.shape == (2, 3, n, s // m)
    assert _rel(enc, tp.encode_dense(torch.as_tensor(x))) < CMATMUL_TOL
    assert _rel(enc, tp.encode_fast(torch.as_tensor(x))) == 0.0
    ref_plan = CodedFFT(s=s, m=m, n_workers=n, device="cpu",
                        backend="reference")
    assert _rel(enc, ref_plan.encode(torch.as_tensor(x))) < CMATMUL_TOL
    jp = JCodedFFT(s=s, m=m, n_workers=n)
    assert _rel(enc, np.asarray(jp.encode(jnp.asarray(x)))) < CMATMUL_TOL
    seen = []

    def worker(a):
        seen.append(tuple(a.shape))
        return torch.fft.fft(a, dim=-1)

    wp = CodedFFT(s=s, m=m, n_workers=n, device="cpu", worker_fn=worker)
    assert wp.resolved_worker_fn is worker
    out = wp.run(torch.as_tensor(x))
    assert seen == [(2, 3, n, s // m)]
    jw = JCodedFFT(s=s, m=m, n_workers=n,
                   worker_fn=lambda a: jnp.fft.fft(a, axis=-1))
    assert _rel(out, np.asarray(jw.run(jnp.asarray(x)))) < PLAN_TOL
    assert _rel(out, np.fft.fft(x.astype(np.complex128))) < PLAN_TOL


# ------------------------------------------------- the row FFT's schedule
# B sweep of the row FFT (csrc/fft_rows.cuh): small and mixed radices, a
# prime past the unrolled ones (97), the smoke run's 384 and 512, 1000 =
# 8 * 5^3, the largest prime B of the two-pass route (4093) and 4096
ROW_FFT_B = [2, 3, 8, 12, 60, 97, 128, 384, 512, 1000, 4093, 4096]
UNROLLED = (2, 3, 4, 5, 7, 8)


def _stockham_model(x, plan, twr, twi, dense=False):
    """The row FFT kernel's pass schedule in numpy, index for index: for
    each pass of radix R (ns the product of the radices before it, m =
    B/R), butterfly j reads src[j + r*m], twiddles it by
    table[r * (j % ns) * B/(ns*R)], takes the R-point DFT through
    table[((r*c) % R) * m] and writes dst[(j - j % ns)*R + j % ns + c*ns].
    A dense pass (``dense``, or a radix the kernel does not unroll) takes
    the outputs in pairs (h, R - h): table[(r*h*m) % B] and its
    conjugate.  complex128 arithmetic on the given table."""
    rows, b = x.shape
    tab = twr.astype(np.float64) + 1j * twi.astype(np.float64)
    src = x.astype(np.complex128)
    ns = 1
    for radix in plan:
        m, unit = b // radix, b // (ns * radix)
        j = np.arange(m)
        k = j % ns
        r = np.arange(radix)
        v = src[:, j[None, :] + m * r[:, None]] * tab[
            r[:, None] * k[None, :] * unit]                      # (x, R, m)
        if radix in UNROLLED and not dense:
            cw = tab[(np.outer(r, r) % radix) * m]             # [r, c]
            y = np.einsum("xrj,rc->xcj", v, cw)
        else:
            y = np.empty_like(v)
            for h in range(radix // 2 + 1):
                t = tab[(r * h * m) % b][None, :, None]
                y[:, h] = (v * t).sum(1)
                if h and 2 * h != radix:
                    y[:, radix - h] = (v * np.conj(t)).sum(1)
        dst = np.empty_like(src)
        dst[:, ((j - k) * radix + k)[None, :] + ns * r[:, None]] = y
        src = dst
        ns *= radix
    return src


@pytest.mark.parametrize("b", ROW_FFT_B)
def test_fft_rows_plan_and_schedule_match_numpy(b):
    """The radix plan multiplies out to B, in the kernel's pass limit;
    the schedule on that plan and table (unrolled and dense index maths
    both) is np.fft.fft: to float64 rounding on a float64 table of the
    same angles, to f32 twiddle rounding on the kernel's own table."""
    plan = fft_rows_plan(b)
    assert int(np.prod(plan)) == b and 1 <= len(plan) <= 16
    assert all(f in UNROLLED or all(f % d for d in range(2, f))
               for f in plan)
    rng = np.random.default_rng(b)
    x = _crand(rng, 3, b).astype(np.complex128)
    want = np.fft.fft(x, axis=-1)
    ang = -2.0 * np.pi * np.arange(b) / b
    for dense in (False, True):
        got = _stockham_model(x, plan, np.cos(ang), np.sin(ang), dense)
        assert _rel(got, want) < 1e-12, dense
    got = _stockham_model(x, plan, *fft_rows_twiddles(b))
    assert _rel(got, want) < 1e-6


@pytest.mark.parametrize("b", [2, 3, 8, 12, 60, 97, 128, 384, 512, 1000])
def test_fft_rows_twiddles_are_entries_of_the_dft_plane(b):
    """The f32 table is row 1 of ``_dft_planes(B)``, and every F_B[j][k]
    is table[(j*k) % B], bit for bit: the CPU twin of fourstep_stage2 and
    the kernel use the same numbers as the DFT plane."""
    twr, twi = fft_rows_twiddles(b)
    fr, fi = tops._dft_planes(b)
    assert twr.dtype == np.float32
    np.testing.assert_array_equal(twr, fr[1])
    np.testing.assert_array_equal(twi, fi[1])
    jk = np.outer(np.arange(b), np.arange(b)) % b
    np.testing.assert_array_equal(fr, twr[jk])
    np.testing.assert_array_equal(fi, twi[jk])


def test_fft_rows_layout_fits_every_two_pass_b():
    """The row FFT's working set: two buffers of ceil(2048/B) rows and the
    table, each plane padded one word in 32, one reckoning, within a block's shared memory for
    every B of the two-pass route (B <= 4096); past it the wrapper
    refuses."""
    for b in range(1, 4097):
        rows = fft_rows_per_block(b)
        assert rows == max(1, -(-2048 // b))
        x, y, tab, total = fft_rows_layout(b)
        last = rows * b - 1
        assert x == 0 and y == tab - y and y >= 2 * (last + last // 32 + 1)
        assert total - tab >= 2 * (b - 1 + (b - 1) // 32 + 1)
        assert 4 * total <= _build.SMEM_PER_BLOCK_OPTIN, b
    assert 4 * fft_rows_layout(16384)[-1] > _build.SMEM_PER_BLOCK_OPTIN


def test_plan_kernel_wrappers_check_their_inputs():
    """The new wrappers refuse inconsistent shapes, and any device that is
    neither CPU nor CUDA -- never copied to the host."""
    meta = lambda *shape: torch.empty(shape, device="meta")
    with pytest.raises(ValueError, match="not a CUDA device"):
        cmatmul(meta(8, 4), meta(8, 4), meta(4, 16), meta(4, 16))
    with pytest.raises(ValueError, match="do not contract"):
        cmatmul(*_t(*[np.zeros(s, np.float32)
                      for s in [(8, 4), (8, 4), (5, 16), (5, 16)]]))
    planes = _planes(4, 8)
    with pytest.raises(ValueError, match="not a CUDA device"):
        fourstep_fused(meta(2, 4, 8), meta(2, 4, 8),
                       *[meta(*p.shape) for p in planes])
    with pytest.raises(ValueError, match="inconsistent"):
        fourstep_stage1(*_t(np.zeros((2, 4, 8), np.float32),
                            np.zeros((2, 4, 8), np.float32), *planes[:2],
                            *_planes(8, 4)[2:4]))
    with pytest.raises(ValueError, match="not a CUDA device"):
        fourstep_stage2(meta(2, 4, 8), meta(2, 4, 8))
    with pytest.raises(ValueError, match="inconsistent"):
        fourstep_stage2(*_t(np.zeros((2, 4, 8), np.float32),
                            np.zeros((2, 4, 9), np.float32)))


# ------------------------------------------------------- GPU: kernel vs plain
def _cuda(device, *arrays):
    return _t(*arrays, device=device)


def _count(name):
    return _build.launch_counts().get(name, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,a,b", [(512, 32, 32), (3, 1, 127),
                                       (2, 64, 128), (2, 120, 121),
                                       (5, 12, 20), (4, 96, 100),
                                       (2, 112, 128)])
def test_gpu_fourstep_fused_matches_plain(cuda, batch, a, b):
    """The smoke run's plan shape (512 rows of 32 x 32), A = 1, and the
    long fusable rows: L = 8192, 9600 (past 9392: the kernel's table in
    global memory), 14,336 and 120 x 121 at the gate (past 14,088: its
    buffers unpadded)."""
    assert tops.fourstep_fusable(a, b)
    rng = np.random.default_rng(a * b)
    args = _cuda(cuda, _rand(rng, batch, a, b), _rand(rng, batch, a, b),
                 *_planes(a, b))
    before = _count("fourstep_fused")
    got = fourstep_fused(*args)
    assert _count("fourstep_fused") == before + 1
    assert _rel(got, fourstep_body(*args)) < 1e-4


@pytest.mark.gpu
def test_gpu_fourstep_fused_refuses_past_the_gate(cuda):
    args = _cuda(cuda, np.zeros((1, 121, 121), np.float32),
                 np.zeros((1, 121, 121), np.float32), *_planes(121, 121))
    with pytest.raises(ValueError, match="two-pass"):
        fourstep_fused(*args)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,a,b", [(128, 512, 512), (3, 1, 127),
                                       (4, 100, 70), (70_000, 2, 4),
                                       (16, 384, 384), (4, 61, 67),
                                       (16, 8, 4093), (1, 4096, 4096)])
def test_gpu_fourstep_stages_match_plain(cuda, batch, a, b):
    """The smoke run's two-pass shape (128 rows of 512 x 512), A = 1, odd
    tiles, a batch past the grid's z limit, the mixed radix A = 384, a
    prime A (the column FFT's dense pass), A = 8 over a prime B (256-
    column tiles) and A = 4096 (one column a tile): one launch of each
    pass, for any batch (both lay their blocks on grid x)."""
    rng = np.random.default_rng(a + b)
    xr, xi = _cuda(cuda, _rand(rng, batch, a, b), _rand(rng, batch, a, b))
    far, fai, wr, wi, fbr, fbi = _cuda(cuda, *_planes(a, b))
    before = (_count("fourstep_stage1"), _count("fourstep_stage2"))
    t1 = fourstep_stage1(xr, xi, far, fai, wr, wi)
    out = fourstep_stage2(*t1)
    assert (_count("fourstep_stage1"), _count("fourstep_stage2")) == \
        (before[0] + 1, before[1] + 1)
    assert _rel(t1, stage1_body(xr, xi, far, fai, wr, wi)) < 1e-4
    assert _rel(out, stage2_body(*t1, fbr, fbi)) < 1e-4
    assert _rel(out, fourstep_body(xr, xi, far, fai, wr, wi, fbr, fbi)) \
        < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("b", ROW_FFT_B)
def test_gpu_fourstep_stage2_matches_plain(cuda, b):
    """The row FFT over the B sweep, one launch each, against the plain
    dense product (the DFT plane of B) and the exact FFT."""
    rng = np.random.default_rng(b)
    tr, ti = _cuda(cuda, _rand(rng, 3, 5, b), _rand(rng, 3, 5, b))
    fbr, fbi = _cuda(cuda, *tops._dft_planes(b))
    before = _count("fourstep_stage2")
    out = fourstep_stage2(tr, ti)
    assert _count("fourstep_stage2") == before + 1
    assert _rel(out, stage2_body(tr, ti, fbr, fbi)) < 1e-4
    truth = np.fft.fft(_np(tr).astype(np.float64) + 1j * _np(ti), axis=-1)
    assert _rel(out, truth) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,ell", [(8, 4, 1 << 22), (4, 4, 1 << 18),
                                     (7, 3, 37), (32, 64, 300)])
def test_gpu_cmatmul_matches_plain(cuda, m, k, ell):
    """The smoke run's encode (8, 4) @ (4, 2^22) and decode shapes, and
    odd ones."""
    rng = np.random.default_rng(m * k)
    args = _cuda(cuda, _rand(rng, m, k), _rand(rng, m, k),
                 _rand(rng, k, ell), _rand(rng, k, ell))
    before = _count("cmatmul")
    got = cmatmul(*args)
    assert _count("cmatmul") == before + 1
    assert _rel(got, cmatmul_body(*args)) < PAIR_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("s", [4096, 1 << 17])
def test_gpu_plan_runs_on_the_kernels(cuda, s):
    """CodedFFT on the card: the batched call launches one cmatmul and
    the four-step worker (fused at s=4096, two-pass at s=2^17), the
    unbatched call a second cmatmul for its decode."""
    plan = CodedFFT(s=s, m=4, n_workers=8)
    assert plan.device.type == "cuda"
    rng = np.random.default_rng(s)
    x = _crand(rng, 4, s)
    masks = np.ones((4, 8), bool)
    masks[:, ::3] = False
    fused = tops.fourstep_fusable(*tops.split_factor(s // 4))
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    for xin, mk, n_cm in [(x, masks, 1), (x[0], masks[0], 2)]:
        _build.reset_launch_counts()
        got = plan.run(torch.as_tensor(xin, device=cuda),
                       mask=torch.as_tensor(mk, device=cuda))
        counts = _build.launch_counts()
        assert counts.get("cmatmul") == n_cm
        assert counts.get("fourstep_fused", 0) == (1 if fused else 0)
        assert counts.get("fourstep_stage1", 0) == (0 if fused else 1)
        assert counts.get("fourstep_stage2", 0) == (0 if fused else 1)
        assert _rel(got, want if xin.ndim == 2 else want[0]) < PLAN_TOL
