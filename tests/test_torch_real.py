"""The port's real kinds (r2c, c2r) and inverse plans against the JAX package.

CPU tests: the same numpy inputs, made from a seed, go through both
packages.  The whole-bucket wrappers, given CPU tensors, run their plain
PyTorch twins; they must agree with the JAX Pallas kernels run through
the real Pallas machinery (``interpret=True``).  Stated tolerances,
relative to the largest output magnitude:

* 1e-5 between two f32 implementations of the same sums (plain twin vs
  Pallas kernel, stage helpers vs the reference's);
* 3e-4 for the whole bucket against ``numpy.fft`` in float64, over the
  adversarial masks (``tests/test_lagrange_decode.py:157``);
* the plans: 5e-3 for complex64 (kernel and reference backends) and
  1e-8 for complex128, against numpy with NaN-poisoned stragglers
  (``tests/test_properties.py``'s tiers), 1e-8 for the endpoint case;
* the services, output for output: 3e-4, with equal ``coded_latency``.

GPU tests (marker ``gpu``, skipped without a CUDA device): each new
kernel against its plain twin on the card, at the gate, and the
service's one launch per bucket.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_kernels import adversarial_masks
from test_torch_kernels import private_autotune_table  # noqa: F401

from repro_torch import (
    CodedIFFT,
    CodedIRFFT,
    CodedRFFT,
    FFTService,
    FFTServiceConfig,
)
from repro_torch.convert import config_from_reference, generator_from_reference
from repro_torch.core import mds as tmds
from repro_torch.core import rfft as trfft
from repro_torch.distributed import StragglerModel
from repro_torch.kernels import _build
from repro_torch.kernels import coded_pipeline as tcp
from repro_torch.kernels import ops as tops

CPU = torch.device("cpu")
# (s, m, N): odd N with m = 3, a non-power-of-two packed length
# (L/2 = 96 = 8 x 12) and the service default's code
SHAPES = [(96, 3, 7), (768, 4, 6), (2048, 4, 8)]
PAIR_TOL = 1e-5
TRUTH_TOL = 3e-4
# (backend, dtype, rtol): tests/test_properties.py's tiers
TIERS = [("kernel", torch.complex64, 5e-3),
         ("reference", torch.complex64, 5e-3),
         ("reference", torch.complex128, 1e-8)]
PLANS = {"r2c": CodedRFFT, "c2c_inv": CodedIFFT, "c2r": CodedIRFFT}


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
    from repro.core import rfft as jrfft
    from repro.kernels import ops as jops
    from repro.kernels import ref as jkref
    from repro.serving import FFTService as JService
    from repro.serving import FFTServiceConfig as JConfig

    return jnp, jrfft, jops, jkref, JService, JConfig


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    got = [np.asarray(g, np.complex128) for g in got]
    want = [np.asarray(w, np.complex128) for w in want]
    scale = max(np.abs(w).max() for w in want)
    return max(np.abs(g - w).max() for g, w in zip(got, want)) / scale


def _t(*arrays, device=CPU):
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                 for a in arrays)


def _gen_planes(n, m, device=CPU):
    g = tmds.rs_generator(n, m, torch.complex64, CPU)
    return _t(g.real.numpy(), g.imag.numpy(), device=device)


def _half_spectra(rng, q, s):
    """Half spectra of real signals, with endpoint imaginary parts that
    ``irfft`` must drop."""
    y = np.fft.rfft(rng.standard_normal((q, s)), axis=-1)
    y[:, 0] += 0.7j
    y[:, -1] -= 0.3j
    return y.real.astype(np.float32), y.imag.astype(np.float32)


def _np_irfft(yr, yi, s):
    return np.fft.irfft(yr.astype(np.float64) + 1j * yi, n=s, axis=-1)


# --------------------------------------------------- whole-bucket twins
@pytest.mark.parametrize("s,m,n", SHAPES)
def test_rbucket_masked_plain_matches_reference(jref, s, m, n):
    """r2c whole bucket over the adversarial masks: the plain twin == the
    JAX kernel (interpret) == numpy.fft.rfft."""
    jnp, _, jops, _, _, _ = jref
    masks = adversarial_masks(n, m)
    rng = np.random.default_rng(s * m)
    x = rng.standard_normal((len(masks), s)).astype(np.float32)
    gr, gi = _gen_planes(n, m)
    assert tops.coded_rbucket_fusable(s, m, n)
    got = tops.coded_rbucket_masked(*_t(x, masks), gr, gi, s)
    want = np.fft.rfft(x.astype(np.float64), axis=-1)
    assert got[0].shape == (len(masks), s // 2 + 1)
    assert _rel(got, (want.real, want.imag)) < TRUTH_TOL
    jgot = jops.coded_rbucket_masked(
        jnp.asarray(x), jnp.asarray(masks), jnp.asarray(gr.numpy()),
        jnp.asarray(gi.numpy()), s, interpret=True, block_q=len(masks))
    assert _rel(got, jgot) < PAIR_TOL


@pytest.mark.parametrize("s,m,n", SHAPES)
def test_irbucket_masked_plain_matches_reference(jref, s, m, n):
    """c2r whole bucket over the adversarial masks, endpoint imaginary
    parts included: the plain twin == the JAX kernel (interpret) ==
    numpy.fft.irfft."""
    jnp, _, jops, _, _, _ = jref
    masks = adversarial_masks(n, m)
    rng = np.random.default_rng(s + m)
    yr, yi = _half_spectra(rng, len(masks), s)
    gr, gi = _gen_planes(n, m)
    assert tops.coded_irbucket_fusable(s, m, n)
    got = tops.coded_irbucket_masked(*_t(yr, yi, masks), gr, gi, s)
    assert got.shape == (len(masks), s) and got.dtype == torch.float32
    assert _rel([got], [_np_irfft(yr, yi, s)]) < TRUTH_TOL
    jgot = jops.coded_irbucket_masked(
        jnp.asarray(yr), jnp.asarray(yi), jnp.asarray(masks),
        jnp.asarray(gr.numpy()), jnp.asarray(gi.numpy()), s, interpret=True,
        block_q=len(masks))
    assert _rel([got], [jgot]) < PAIR_TOL


@pytest.mark.parametrize("s,m,n", SHAPES[1:])
def test_stage_helpers_match_reference(jref, s, m, n):
    """pack_real_planes, rfft_postdecode_planar, irfft_message_planar and
    irfft_unpack_planar == the reference's, on the same planes."""
    jnp, _, jops, _, _, _ = jref
    rng = np.random.default_rng(s)
    q, n2 = 3, s // m // 2
    x = rng.standard_normal((q, s)).astype(np.float32)
    got = tops.pack_real_planes(*_t(x), m)
    assert _rel(got, jops.pack_real_planes(jnp.asarray(x), m)) == 0.0
    hr, hi = (rng.standard_normal((q, m, n2)).astype(np.float32)
              for _ in range(2))
    got = tops.rfft_postdecode_planar(*_t(hr, hi), s)
    want = jops.rfft_postdecode_planar(jnp.asarray(hr), jnp.asarray(hi), s)
    assert _rel(got, want) < PAIR_TOL
    yr, yi = _half_spectra(rng, q, s)
    got = tops.irfft_message_planar(*_t(yr, yi), s, m)
    want = jops.irfft_message_planar(jnp.asarray(yr), jnp.asarray(yi), s, m)
    assert _rel(got, want) < PAIR_TOL
    got = tops.irfft_unpack_planar(*_t(hr, hi))
    want = jops.irfft_unpack_planar(jnp.asarray(hr), jnp.asarray(hi))
    assert _rel([got], [want]) < PAIR_TOL


@pytest.mark.parametrize("kind", ["r2c", "c2r"])
@pytest.mark.parametrize("s,m,n", [(768, 4, 6), (32768, 4, 8)])
def test_stage_route_matches_numpy(kind, s, m, n):
    """The stage route of each real kind (plain glue around the encode
    and decode kernels) == numpy over the adversarial masks, below and
    past the whole-bucket gate."""
    masks = torch.as_tensor(adversarial_masks(n, m))
    q = masks.shape[0]
    gr, gi = _gen_planes(n, m)
    dr, di = tops.lagrange_scatter_planes(tops.mask_subsets(masks, m), n)
    rng = np.random.default_rng(s)
    if kind == "r2c":
        x = rng.standard_normal((q, s)).astype(np.float32)
        zr, zi = tops.pack_real_planes(*_t(x), m)
        br, bi = tops.encode_worker(zr, zi, gr, gi)
        hr, hi = tops.decode_apply(dr, di, br, bi)
        got = tops.rfft_postdecode_planar(hr, hi, s)
        want = np.fft.rfft(x.astype(np.float64), axis=-1)
        assert _rel(got, (want.real, want.imag)) < TRUTH_TOL
    else:
        n2 = s // m // 2
        yr, yi = _half_spectra(rng, q, s)
        zr, zi = tops.irfft_message_planar(*_t(yr, yi), s, m)
        br, bi = tops.encode_worker(zr, -zi, gr, -gi)
        hr, hi = tops.decode_apply(dr, di, br / n2, -bi / n2)
        got = tops.irfft_unpack_planar(hr, hi)
        assert _rel([got], [_np_irfft(yr, yi, s)]) < TRUTH_TOL


def test_real_gates_are_the_kernel_reckonings():
    """Each gate is its kernel's shared-memory working set against the
    card's opt-in limit: the default config fuses, 2^15 points do not,
    an odd shard never does, nor m past the unroll bound."""
    for fusable in (tops.coded_rbucket_fusable, tops.coded_irbucket_fusable):
        assert fusable(4096, 4, 8) and fusable(16384, 4, 8)
        assert not fusable(32768, 4, 8)
        assert not fusable(1 << 20, 4, 8)
        assert not fusable(18, 2, 6)                 # 2m does not divide s
        assert not fusable(64 * 33, 33, 66)
    # (m=4, A=16, B=32: the default bucket's packed shards), by hand
    a, b, m = 16, 32, 4
    r_words = (2 * a * a + 2 * b * b + 3 * 2 * a * b + 2 * m * a * (b + 1)
               + 2 * m * m + 2 * 3 * m + 2 * 2 * m * m + 2 * (m + 1)
               + 2 * m + m)
    layout = tcp.rbucket_layout(m, a, b)
    assert len(layout) == 14 and layout[0] == 0 and layout[-1] == r_words
    ir_words = r_words - 2 * 3 * m + 2 * m * (a * b + 1) + 2 * m * m
    layout = tcp.irbucket_layout(m, a, b)
    assert len(layout) == 15 and layout[-1] == ir_words
    assert layout[6] - layout[5] == 2 * m * a * (b + 1)   # shard spectra


def test_real_entry_points_refuse_without_gpu(monkeypatch):
    """The real kinds run on CUDA unless the caller names the CPU: with
    no GPU, device=None raises instead of running the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in PLANS.values():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(s=64, m=4, n_workers=8)
        assert cls(s=64, m=4, n_workers=8, device="cpu").device == CPU


def test_real_wrappers_refuse_other_devices():
    """A wrapper takes its plain twin only for CPU tensors; a tensor on
    any other non-CUDA device is refused, never copied to the host."""
    m, n, s = 4, 8, 64
    meta = lambda *shape: torch.empty(shape, device="meta")
    g = (meta(n, m), meta(n, m))
    half = (meta(2, 2), meta(2, 2), meta(2, 4), meta(2, 4), meta(4, 4),
            meta(4, 4))                            # A=2, B=4: n2 = 8
    with pytest.raises(ValueError, match="not a CUDA device"):
        tcp.coded_rfft_bucket_masked(
            meta(2, s), meta(2, n), *g, *half, meta(1, 9), meta(1, 9),
            meta(m, 16), meta(m, 16), meta(3, m), meta(3, m), s)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tcp.coded_irfft_bucket_masked(
            meta(2, 33), meta(2, 33), meta(2, n), *g, *half,
            meta(m, m), meta(m, m), meta(m, 16), meta(m, 16), meta(1, 9),
            meta(1, 9), s)


def test_real_wrappers_check_shapes():
    gr, gi = _gen_planes(8, 4)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        tcp.coded_rfft_bucket_masked(
            torch.zeros(2, 64), torch.ones(2, 8, dtype=torch.bool), gr, gi,
            *(torch.zeros(1, 1),) * 12, 64)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        tcp.coded_irfft_bucket_masked(
            torch.zeros(2, 30), torch.zeros(2, 30),
            torch.ones(2, 8, dtype=torch.bool), gr, gi,
            *(torch.zeros(1, 1),) * 12, 64)


# ------------------------------------------------------------ the plans
def _poisoned_run(plan, x, masks):
    """encode -> worker -> NaN in every row outside each request's first
    m responders -> masked decode."""
    b = plan.worker_compute(plan.encode(x))
    poisoned = b.clone()
    rows = masks.reshape(-1, plan.n_workers)
    flat = poisoned.reshape((-1,) + tuple(b.shape[-2:]))
    for i, row in enumerate(rows):
        keep = np.flatnonzero(row)[:plan.m]
        drop = np.setdiff1d(np.arange(plan.n_workers), keep)
        flat[i, torch.as_tensor(drop)] = float("nan")
    return plan.decode(poisoned, mask=torch.as_tensor(masks))


def _plan_case(kind, s, batch, dtype, seed):
    """(input, numpy truth) for one plan kind."""
    rng = np.random.default_rng(seed)
    shape = (batch, s) if batch else (s,)
    xt = rng.standard_normal(shape)
    if kind == "r2c":
        return xt, np.fft.rfft(xt, axis=-1)
    if kind == "c2r":
        y = np.fft.rfft(xt, axis=-1)
        return y, np.fft.irfft(y, n=s, axis=-1)
    x = xt + 1j * rng.standard_normal(shape)
    return x, np.fft.ifft(x, axis=-1)


@pytest.mark.parametrize("kind", list(PLANS))
@pytest.mark.parametrize("tier", TIERS, ids=["kernel64", "ref64", "ref128"])
@pytest.mark.parametrize("batch", [0, 3])
def test_plans_match_numpy_with_poisoned_stragglers(kind, tier, batch):
    backend, dtype, rtol = tier
    for s, m, n in [(48, 4, 6), (120, 4, 9), (96, 3, 7)]:
        plan = PLANS[kind](s=s, m=m, n_workers=n, dtype=dtype,
                           backend=backend, device="cpu")
        assert plan.kind == kind and plan.resolved_backend == (
            backend if dtype == torch.complex64 else "reference")
        x, want = _plan_case(kind, s, batch, dtype, seed=s + batch)
        rng = np.random.default_rng(s)
        masks = np.zeros((max(batch, 1), n), bool)
        for row in masks:
            row[rng.choice(n, size=m + int(rng.integers(0, n - m + 1)),
                           replace=False)] = True
        masks = masks if batch else masks[0]
        out = _poisoned_run(plan, torch.as_tensor(x), masks)
        assert out.dtype == (plan.real_dtype if kind == "c2r"
                             else plan.dtype)
        got = out.numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        assert _rel([got], [want]) < rtol, (kind, s, m, n)
        # the one-call run, first-m subset
        assert _rel([plan.run(torch.as_tensor(x)).numpy()], [want]) < rtol


@pytest.mark.parametrize("kind", list(PLANS))
def test_plans_match_reference_plans(jref, kind):
    """Each stage of the port's plan == the JAX plan's, complex128."""
    jnp, jrfft, _, _, _, _ = jref
    jcls = {"r2c": jrfft.CodedRFFT, "c2c_inv": jrfft.CodedIFFT,
            "c2r": jrfft.CodedIRFFT}[kind]
    s, m, n = 120, 4, 9
    tplan = PLANS[kind](s=s, m=m, n_workers=n, dtype=torch.complex128,
                        backend="reference", device="cpu")
    jplan = jcls(s=s, m=m, n_workers=n, dtype=jnp.complex128,
                 backend="reference")
    assert tplan.kind == jplan.kind
    # the same (N, m) code as the JAX plan and its service
    np.testing.assert_allclose(tplan.generator.numpy(),
                               np.asarray(jplan.generator), atol=1e-12)
    assert tplan.worker_shard_shape == jplan.worker_shard_shape
    assert tplan.output_shape == jplan.output_shape
    x, _ = _plan_case(kind, s, 2, torch.complex128, seed=5)
    msg = tplan.message(torch.as_tensor(x)).numpy()
    assert _rel([msg], [np.asarray(jplan.message(jnp.asarray(x)))]) < 1e-12
    b = tplan.worker_compute(tplan.encode(torch.as_tensor(x)))
    jb = np.asarray(jplan.worker_compute(jplan.encode(jnp.asarray(x))))
    assert _rel([b.numpy()], [jb]) < 1e-12
    mask = np.array([0, 1, 1, 0, 1, 1, 0, 1, 1], bool)
    got = tplan.decode(b, mask=torch.as_tensor(mask)).numpy()
    want = np.asarray(jplan.decode(jnp.asarray(jb), mask=jnp.asarray(mask)))
    assert _rel([got], [want]) < 1e-10


def test_real_plan_takes_the_real_part_of_a_complex_input():
    plan = CodedRFFT(s=64, m=4, n_workers=8, device="cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    got = plan.run(torch.as_tensor(x)).numpy()
    assert _rel([got], [np.fft.rfft(x.real)]) < 5e-4
    assert plan.message(torch.as_tensor(x)).dtype == torch.complex64


@pytest.mark.parametrize("backend,dtype,rtol", [
    ("reference", torch.complex128, 1e-8), ("kernel", torch.complex64, 5e-4)])
def test_irfft_endpoint_imag_discarded_like_numpy(backend, dtype, rtol):
    """Non-Hermitian endpoint bins: the plan and the whole bucket drop
    their imaginary parts exactly as numpy.fft.irfft does."""
    s, m, n = 64, 4, 8
    rng = np.random.default_rng(0)
    y = np.fft.rfft(rng.normal(size=s)).astype(np.complex128)
    y[0] += 0.7j
    y[-1] -= 0.3j
    plan = CodedIRFFT(s=s, m=m, n_workers=n, dtype=dtype, backend=backend,
                      device="cpu")
    want = np.fft.irfft(y, n=s)
    assert _rel([plan.run(torch.as_tensor(y)).numpy()], [want]) < rtol
    gr, gi = _gen_planes(n, m)
    got = tops.coded_irbucket_masked(
        *_t(y.real[None].astype(np.float32), y.imag[None].astype(np.float32),
            np.ones((1, n), bool)), gr, gi, s)
    assert _rel([got[0]], [want]) < TRUTH_TOL


def test_helpers_match_reference(jref):
    jnp, jrfft, _, _, _, _ = jref
    rng = np.random.default_rng(3)
    c = rng.standard_normal((2, 3, 16))
    z = trfft.pack_pairs(torch.as_tensor(c), torch.complex128)
    assert _rel([z.numpy()], [np.asarray(jrfft.pack_pairs(
        jnp.asarray(c), jnp.complex128))]) == 0.0
    np.testing.assert_array_equal(
        trfft.unpack_pairs(z, torch.float64).numpy(), c)
    zh = np.fft.fft(z.numpy(), axis=-1)
    half = trfft.split_packed(torch.as_tensor(zh), 16).numpy()
    assert _rel([half], [np.fft.rfft(c, axis=-1)]) < 1e-12
    back = trfft.pack_half(torch.as_tensor(half), 16).numpy()
    assert _rel([back], [zh]) < 1e-12
    full = trfft.hermitian_extend(torch.as_tensor(half)).numpy()
    assert _rel([full], [np.fft.fft(c, axis=-1)]) < 1e-12
    assert _rel([back], [np.asarray(jrfft.pack_half(jnp.asarray(half), 16))]) \
        < 1e-12


# ------------------------------------------------------- the 2m | s errors
def test_real_kinds_raise_named_error(jref):
    """s = 18, m = 2: m | s holds but 2m | s does not -- the plan, the
    packing op and both service entry points name the constraint, the
    service after the straggler draw, as a same-seed reference service
    counts it."""
    trfft.require_even_shards(24, 3)
    for call in (lambda: trfft.require_even_shards(18, 2),
                 lambda: trfft.require_even_shards(0, 1),
                 lambda: CodedRFFT(s=18, m=2, n_workers=6, device="cpu"),
                 lambda: CodedIRFFT(s=18, m=2, n_workers=6, device="cpu"),
                 lambda: tops.pack_real_planes(torch.zeros(2, 18), 2)):
        with pytest.raises(ValueError, match=r"2m \| s"):
            call()
    with pytest.raises(ValueError, match=r"axis 1"):
        trfft.require_even_shards(18, 2, axis=1)
    CodedIFFT(s=18, m=2, n_workers=6, device="cpu")     # c2c needs m | s
    _, _, _, _, JService, JConfig = jref
    jsvc = JService(JConfig(s=48, m=2, n_workers=6))
    svc = _port_twin(jsvc)
    for s_ in (jsvc, svc):
        with pytest.raises(ValueError, match=r"2m \| s"):
            s_.submit_rfft(np.zeros(18, np.float32))
        with pytest.raises(ValueError, match=r"2m \| s"):
            s_.submit_irfft(np.zeros(10, np.complex64))
        with pytest.raises(ValueError, match=">= 2 half-spectrum bins"):
            s_.submit_irfft(np.zeros(1, np.complex64))
    assert svc.stats.requests == jsvc.stats.requests
    assert svc.stats.coded_latency == jsvc.stats.coded_latency
    with pytest.raises(ValueError, match="unknown bucket kind"):
        svc.submit_batch([np.zeros(48)], kind="dct")


# ------------------------------------------------------------ the service
def _port_twin(jsvc):
    """A port service with the reference's config and generator."""
    jcfg = jsvc.cfg
    cfg = config_from_reference(
        {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    svc = FFTService(cfg, device="cpu")
    svc.load_generator(*generator_from_reference(
        np.asarray(jsvc.plan.generator), CPU))
    return svc


def _mixed_requests(specs, seed):
    """(requests, kinds, numpy truths) for (kind, s) specs."""
    rng = np.random.default_rng(seed)
    xs, kinds, want = [], [], []
    for kind, s in specs:
        x = rng.standard_normal(s)
        if kind == "c2c":
            x = (x + 1j * rng.standard_normal(s)).astype(np.complex64)
            w = np.fft.fft(x.astype(np.complex128))
        elif kind == "r2c":
            x = x.astype(np.float32)
            w = np.fft.rfft(x.astype(np.float64))
        else:
            x = np.fft.rfft(x).astype(np.complex64)
            w = np.fft.irfft(x.astype(np.complex128), n=s)
        xs.append(x)
        kinds.append(kind)
        want.append(w)
    return xs, kinds, want


def test_service_mixed_traffic_matches_reference(jref):
    """r2c, c2r and c2c requests in one call, below and past the real
    kinds' whole-bucket gate: output for output against a same-seed JAX
    service and numpy, equal coded latency, one host transfer a call."""
    _, _, _, _, JService, JConfig = jref
    small, large = 2048, 32768
    assert tops.coded_rbucket_fusable(small, 4, 8)
    assert not tops.coded_irbucket_fusable(large, 4, 8)
    jsvc = JService(JConfig(s=small, m=4, n_workers=8, seed=7))
    tsvc = _port_twin(jsvc)
    specs = [("r2c", small), ("c2r", small), ("c2c", small), ("r2c", large),
             ("c2r", small), ("c2r", large), ("r2c", small)]
    for call in range(2):      # the second call continues the same draws
        xs, kinds, want = _mixed_requests(specs, seed=call)
        jout = jsvc.submit_batch(xs, kind=kinds)
        tout = tsvc.submit_batch(xs, kind=kinds)
        for k, j, t, w in zip(kinds, jout, tout, want):
            assert t.shape == w.shape
            assert t.dtype == (np.float32 if k == "c2r" else np.complex64)
            assert _rel([t], [w]) < TRUTH_TOL
            assert _rel([t], [np.asarray(j)]) < TRUTH_TOL
        assert tsvc.stats.coded_latency == jsvc.stats.coded_latency
        assert tsvc.stats.uncoded_latency == jsvc.stats.uncoded_latency
        assert (tsvc.stats.stragglers_tolerated
                == jsvc.stats.stragglers_tolerated)
        assert tsvc.stats.host_transfers == call + 1
    assert tsvc.stats.batches == jsvc.stats.batches == 2 * 5


@pytest.mark.parametrize("kind", ["r2c", "c2r"])
def test_service_single_kind_matches_reference(jref, kind):
    """One kind for the whole call, through ``submit_rfft`` /
    ``submit_irfft`` too."""
    _, _, _, _, JService, JConfig = jref
    jsvc = JService(JConfig(s=768, m=4, n_workers=6, seed=11))
    tsvc = _port_twin(jsvc)
    xs, _, want = _mixed_requests([(kind, 768)] * 5, seed=4)
    jout = jsvc.submit_batch(xs, kind=kind)
    tout = tsvc.submit_batch(xs, kind=kind)
    for j, t, w in zip(jout, tout, want):
        assert _rel([t], [w]) < TRUTH_TOL and _rel([t], [j]) < TRUTH_TOL
    one = tsvc.submit_rfft if kind == "r2c" else tsvc.submit_irfft
    jone = jsvc.submit_rfft if kind == "r2c" else jsvc.submit_irfft
    assert _rel([one(xs[0])], [jone(xs[0])]) < TRUTH_TOL
    assert tsvc.stats.coded_latency == jsvc.stats.coded_latency


def test_submit_batch_one_transfer_for_mixed_dtypes():
    """c2c, r2c and c2r outputs (complex64 and float32 rows) come home in
    ONE device-to-host transfer, each in its own dtype and shape."""
    svc = FFTService(FFTServiceConfig(s=256, m=4, n_workers=8), device="cpu")
    xs, kinds, want = _mixed_requests(
        [("c2r", 256), ("c2c", 256), ("r2c", 512), ("c2r", 128),
         ("c2c", 128)], seed=9)
    out = svc.submit_batch(xs, kind=kinds)
    assert svc.stats.host_transfers == 1 and svc.stats.batches == 5
    for k, o, w in zip(kinds, out, want):
        assert o.shape == w.shape
        assert o.dtype == (np.float32 if k == "c2r" else np.complex64)
        assert _rel([o], [w]) < TRUTH_TOL
    # complex128 services bring home float64 and complex128 rows
    svc = FFTService(FFTServiceConfig(s=256, dtype=torch.complex128),
                     device="cpu")
    out = svc.submit_batch(xs, kind=kinds)
    assert [o.dtype for o in out] == [
        np.float64 if k == "c2r" else np.complex128 for k in kinds]
    assert max(_rel([o], [w]) for o, w in zip(out, want)) < 1e-8


def test_service_masks_match_reference_draws_per_kind(jref):
    _, _, _, _, JService, JConfig = jref
    jsvc = JService(JConfig(s=256, m=4, n_workers=8, seed=3))
    tsvc = _port_twin(jsvc)
    for kind in ("c2c", "r2c", "c2r", "r2c"):
        for n in (1, 5):
            jl, jm = jsvc._simulate_arrivals(n, kind)
            tl, tm = tsvc._simulate_arrivals(n, kind)
            np.testing.assert_array_equal(tl, jl)
            np.testing.assert_array_equal(tm, jm)
        assert tsvc._wire_scale(kind) == jsvc._wire_scale(kind)


def test_service_charges_real_kinds_half_wire_time():
    """r2c/c2r buckets draw at payload_scale=0.5: on a wire-heavy model
    their latency runs below c2c's by exactly the wire share
    (tests/test_lagrange_decode.py:324)."""
    model = StragglerModel(t0=1.0, mu=4.0, wire_frac=0.8)
    mk = lambda: FFTService(FFTServiceConfig(
        s=256, m=4, n_workers=8, straggler=model, seed=17), device="cpu")
    lat_c, _ = mk()._simulate_arrivals(4000, "c2c")
    lat_r, _ = mk()._simulate_arrivals(4000, "r2c")
    lat_i, _ = mk()._simulate_arrivals(4000, "c2r")
    assert lat_r.mean() < lat_c.mean() and lat_i.mean() < lat_c.mean()
    np.testing.assert_allclose(
        (lat_c - lat_r).mean(), (1.0 / 4) * 1.0 * 0.8 * 0.5, atol=1e-9)
    np.testing.assert_array_equal(lat_r, lat_i)


def test_warmup_over_kinds_and_reference_path():
    svc = FFTService(FFTServiceConfig(s=128, m=4, n_workers=8, max_batch=4),
                     device="cpu")
    assert svc.warmup(kinds=("c2c", "r2c", "c2r")) == 9   # 3 kinds x 3
    assert {k[1] for k in svc._runners} == {"c2c", "r2c", "c2r"}
    ref = FFTService(FFTServiceConfig(s=128, use_reference=True),
                     device="cpu")
    xs, kinds, want = _mixed_requests([("r2c", 128), ("c2r", 128)], seed=2)
    for o, w in zip(ref.submit_batch(xs, kind=kinds), want):
        assert _rel([o], [w]) < 1e-4
    assert not ref._kernel_path(128, "r2c")


# ------------------------------------------------------- GPU: kernel vs plain
# real-kind bucket shapes past SHAPES: m from 1 to 32, packed lengths
# n2 = s/(2m) of radix 3, 5 and 7 (105, 125, 343, 120), prime (127, 61),
# powers of two, and the largest s the gate admits at m = 4 (16384)
GPU_REAL_SHAPES = [(4096, 4, 8), (16384, 4, 8), (2 * 127 * 4, 4, 8),
                   (16 * 64, 16, 32), (32 * 32, 32, 64), (1024, 1, 3),
                   (420, 2, 5), (630, 3, 6), (840, 4, 8), (610, 5, 10),
                   (1500, 6, 12), (1344, 7, 14), (5488, 8, 16),
                   (2880, 12, 24), (3840, 16, 32), (3072, 24, 48),
                   (4096, 32, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("s,m,n", SHAPES + GPU_REAL_SHAPES)
def test_gpu_real_buckets_match_plain(cuda, s, m, n):
    """Both masked real-kind bucket kernels against their plain twins on
    the card (1e-4), one launch each, and at m <= 4 against numpy."""
    if m <= 4:
        masks = adversarial_masks(n, m)
    else:
        # wide codes: evenly spread responders (see the c2c bucket test)
        alt = np.arange(n) % 2 == 0
        masks = np.stack([alt, np.roll(alt, 1), np.roll(alt, 3)])
    rng = np.random.default_rng(s)
    q = len(masks)
    gr, gi = _gen_planes(n, m, cuda)
    mk = torch.as_tensor(masks, device=cuda)
    assert tops.coded_rbucket_fusable(s, m, n)
    assert tops.coded_irbucket_fusable(s, m, n)
    x = torch.as_tensor(rng.standard_normal((q, s)).astype(np.float32),
                        device=cuda)
    before = dict(_build.launch_counts())
    got = tops.coded_rbucket_masked(x, mk, gr, gi, s)
    planes = (*tops._fourstep_planes(*tops.split_factor(s // m // 2), cuda),
              *tops._on_device(tops._r2c_postdecode_planes, (s, m), cuda))
    want = tcp.rbucket_body_masked(x, mk.float(), gr, gi, *planes, s)
    assert _rel([g.cpu() for g in got], [w.cpu() for w in want]) < 1e-4
    yr, yi = _t(*_half_spectra(rng, q, s), device=cuda)
    out = tops.coded_irbucket_masked(yr, yi, mk, gr, gi, s)
    planes = (*tops._fourstep_planes(*tops.split_factor(s // m // 2), cuda),
              *tops._on_device(tops._c2r_message_planes, (s, m), cuda))
    want = tcp.irbucket_body_masked(yr, yi, mk.float(), gr, gi, *planes, s)
    assert _rel([out.cpu()], [want.cpu()]) < 1e-4
    counts = _build.launch_counts()
    for name in ("coded_rfft_bucket_masked", "coded_irfft_bucket_masked"):
        assert counts[name] == before.get(name, 0) + 1
    if m <= 4:
        truth = np.fft.rfft(x.double().cpu().numpy(), axis=-1)
        assert _rel([g.cpu() for g in got], (truth.real, truth.imag)) \
            < TRUTH_TOL
        assert _rel([out.cpu()], [_np_irfft(yr.cpu().numpy(),
                                            yi.cpu().numpy(), s)]) < TRUTH_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["r2c", "c2r"])
def test_gpu_service_one_launch_per_bucket(cuda, kind):
    """The default config's real buckets each run their whole-bucket
    kernel exactly once, and past the gate none."""
    svc = FFTService(FFTServiceConfig(s=4096, m=4, n_workers=8))
    name = ("coded_rfft_bucket_masked" if kind == "r2c"
            else "coded_irfft_bucket_masked")
    for s, launches in [(4096, 2), (32768, 0)]:
        xs, _, want = _mixed_requests([(kind, s)] * 70, seed=s)
        _build.reset_launch_counts()
        out = svc.submit_batch(xs, kind=kind)       # buckets of 64 and 6
        assert _build.launch_counts().get(name, 0) == launches
        assert max(_rel([o], [w]) for o, w in zip(out, want)) < TRUTH_TOL
