"""The port's host decode-matrix path against the JAX package.

The path serves ``device_decode=False`` and codes wider than the
closed-form Lagrange decode (``m > LAGRANGE_MAX_M``): per-mask (m, N)
scatter decode matrices from a complex128 host LRU, shipped as one
(2, q, m, N) f32 plane stack per bucket to the kind's planes bucket
kernel; past its gate a c2c bucket streams (the streaming bucket
kernel) where ``ops.coded_bucket_streamable`` admits it, and every other
bucket takes the stage kernels.

CPU tests: the same numpy inputs, made from a seed, go through both
packages.  Stated tolerances, relative to the largest output magnitude:

* the LRU: equal matrices, compact forms, counters and eviction order;
* 1e-4 between the port's planes buckets (plain twins on the CPU) and
  the JAX Pallas kernels in interpret mode on the same cache planes, and
  1e-3 against numpy in float64 (``tests/test_kernel_pipeline.py:113``);
* the services, output for output: 3e-4 against numpy and each other
  (``tests/test_lagrange_decode.py:153``), with equal ``coded_latency``
  and LRU counters.

At m = 64, N = 128 a random first-m responder subset of the roots of
unity is so ill-conditioned (median condition number about 1.5e6) that
an f32 decode of the reference's own draws loses most digits; accuracy
there is checked on evenly spread responders (``np.arange(N) % 2 == 0``
and its rolls: the 64th roots of unity, condition number 1).

GPU tests (marker ``gpu``, skipped without a CUDA device): the three
planes bucket kernels, the streaming bucket kernel and the three stage
kernels at m = 64 against their plain twins, and the host-path
service's launches.
"""

import numpy as np
import pytest
import torch
from test_torch_kernels import adversarial_masks
from test_torch_kernels import private_autotune_table  # noqa: F401
from test_torch_real import GPU_REAL_SHAPES
from test_torch_real import _mixed_requests as _requests
from test_torch_real import _port_twin, _rel, _t

from repro_torch import FFTService, FFTServiceConfig
from repro_torch.core import mds as tmds
from repro_torch.kernels import _build
from repro_torch.kernels import coded_pipeline as tcp
from repro_torch.kernels import ops as tops
from repro_torch.kernels.cmatmul import bcmatmul, bcmatmul_body
from repro_torch.kernels.fourstep_fft import (
    encode_fourstep_body,
    encode_fourstep_fused,
    encode_rows_fold,
)
from repro_torch.kernels.recombine import (
    recombine_batched_body,
    recombine_twiddle_dft_batched,
)
from repro_torch.serving import DecodeMatrixCache

# (s, m, N): odd N with m = 3, a non-power-of-two shard length and the
# service default's code
SHAPES = [(96, 3, 7), (768, 4, 6), (2048, 4, 8)]
PAIR_TOL = 1e-4
TRUTH_TOL = 1e-3
SERVICE_TOL = 3e-4
KINDS = ("c2c", "r2c", "c2r")


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
    from repro.serving import FFTService as JService
    from repro.serving import FFTServiceConfig as JConfig
    from repro.serving.decode_cache import DecodeMatrixCache as JCache

    return jnp, jops, JService, JConfig, JCache


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _generator(n, m):
    g = tmds.rs_generator(n, m, torch.complex64, torch.device("cpu"))
    return g.numpy()


def _servable_masks(n, m):
    """The adversarial masks with at least m responders each (the LRU
    refuses fewer, as the reference's does)."""
    masks = adversarial_masks(n, m)
    return masks[masks.sum(axis=1) >= m]


def _spread_masks(n, q):
    """Evenly spread responders, rolled row by row."""
    alt = np.arange(n) % 2 == 0
    return np.stack([np.roll(alt, i) for i in range(q)])


def _dplanes(g, masks):
    d = DecodeMatrixCache(g).matrices(masks)
    return d.real.copy(), d.imag.copy()


def _inputs(kind, rng, q, s):
    """A request block of ``kind`` as float32 planes and its float64
    truth: complex rows (c2c), real rows (r2c), half spectra (c2r)."""
    x = rng.standard_normal((q, s))
    if kind == "c2c":
        xi = rng.standard_normal((q, s))
        want = np.fft.fft(x + 1j * xi, axis=-1)
        return (x.astype(np.float32), xi.astype(np.float32)), want
    if kind == "r2c":
        return (x.astype(np.float32),), np.fft.rfft(x, axis=-1)
    y = np.fft.rfft(x, axis=-1)
    return ((y.real.astype(np.float32), y.imag.astype(np.float32)),
            np.fft.irfft(y, n=s, axis=-1))


def _planes_out(kind, out):
    return [out] if kind == "c2r" else list(out)


def _serve_with_masks(svc, s, kind, xb, masks):
    """One bucket of the rows of ``xb`` through the service's own staging
    and executor, with the given responders in place of a straggler
    draw."""
    bucket, args = svc.stage_bucket(s, kind, list(xb), masks=masks)
    assert bucket == len(xb)
    return svc.launch_bucket(s, bucket, kind, args)


_PORT_BUCKET = {"c2c": tops.coded_bucket, "r2c": tops.coded_rbucket,
                "c2r": tops.coded_irbucket}
_PORT_GATE = {"c2c": tops.coded_bucket_fusable,
              "r2c": tops.coded_rbucket_fusable,
              "c2r": tops.coded_irbucket_fusable}


# ------------------------------------------------------------ the LRU (a)
def test_decode_cache_matches_reference(jref):
    """One mask sequence with repeats and churn through both LRUs (size
    3): equal scatter and compact forms, equal counters after every
    step, and the same entries in the same recency order."""
    _, _, _, _, JCache = jref
    n, m = 8, 4
    g = _generator(n, m)
    tc, jc = DecodeMatrixCache(g, maxsize=3), JCache(g, maxsize=3)
    masks = _servable_masks(n, m)
    order = [0, 1, 0, 2, 3, 1, 4, 0, 5, 5, 2, 6, 1]
    for i in order:
        np.testing.assert_array_equal(tc.matrix(masks[i]),
                                      jc.matrix(masks[i]))
        assert (tc.hits, tc.misses) == (jc.hits, jc.misses)
        assert list(tc._store) == list(jc._store)
    assert len(tc) == len(jc) == 3
    block = masks[[0, 2, 5, 5]]
    np.testing.assert_array_equal(tc.matrices(block), jc.matrices(block))
    for t, j in zip(tc.compact(block), jc.compact(block)):
        np.testing.assert_array_equal(t, j)
    assert (tc.hits, tc.misses) == (jc.hits, jc.misses)
    for mask in masks[:3]:
        np.testing.assert_array_equal(tc.subset_of(mask, m),
                                      jc.subset_of(mask, m))
    with pytest.raises(ValueError, match="responders"):
        tc.matrix(np.eye(n, dtype=bool)[0])
    with pytest.raises(ValueError, match="maxsize"):
        DecodeMatrixCache(g, maxsize=0)


# ------------------------------------------------- planes buckets (b)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("s,m,n", SHAPES)
def test_planes_bucket_matches_reference(jref, kind, s, m, n):
    """Each kind's planes bucket on the CPU (its plain twin) == the JAX
    entry point in interpret mode on the same LRU planes, and == numpy."""
    jnp, jops, _, _, _ = jref
    masks = _servable_masks(n, m)
    q = len(masks)
    rng = np.random.default_rng(s + m + KINDS.index(kind))
    x, want = _inputs(kind, rng, q, s)
    g = _generator(n, m)
    dr, di = _dplanes(g, masks)
    gr, gi = g.real.copy(), g.imag.copy()
    assert _PORT_GATE[kind](s, m, n, masked=False)
    got = _PORT_BUCKET[kind](*_t(*x, dr, di, gr, gi), s)
    jfn = {"c2c": jops.coded_bucket, "r2c": jops.coded_rbucket,
           "c2r": jops.coded_irbucket}[kind]
    jgot = jfn(*[jnp.asarray(a) for a in (*x, dr, di, gr, gi)], s,
               interpret=True, block_q=q)
    got, jgot = _planes_out(kind, got), _planes_out(kind, jgot)
    truth = [want] if kind == "c2r" else [want.real, want.imag]
    assert got[0].shape == truth[0].shape
    assert _rel(got, jgot) < PAIR_TOL
    assert _rel(got, truth) < TRUTH_TOL


def test_planes_gates_are_the_kernel_reckonings():
    """A planes layout keeps the masked layout's 14 (15 for c2r) words in
    order -- the one Layout struct of each kernel -- with the Lagrange
    scratch at zero size, all N generator rows in gs and the (m, N) D in
    qm; the planes gate counts N, and refuses m past the unrolled bound
    (so m = 64 takes the stage route)."""
    m, n, a, b = 4, 8, 32, 32
    masked = tcp.bucket_layout(m, a, b)
    planes = tcp.bucket_layout(m, a, b, n=n, masked=False)
    assert len(planes) == len(masked) == 14
    assert planes[:7] == masked[:7]                    # through gs's start
    sizes = np.diff(planes)
    assert list(sizes[6:]) == [2 * n * m, 2 * m * m, 0, 2 * m * n, 0, 0, 0]
    assert tcp.bucket_smem_bytes(m, a, b, n=n, masked=False) == \
        4 * planes[-1]
    for layout in (tcp.rbucket_layout, tcp.irbucket_layout):
        lm, lp = layout(m, 16, 32), layout(m, 16, 32, n=n, masked=False)
        assert len(lm) == len(lp)
        assert lp[-1] - lm[-1] == (2 * n * m + 2 * m * n
                                   - (4 * m * m + 2 * (m + 1) + 2 * m + m
                                      + 2 * m * m))
    with pytest.raises(ValueError, match="N workers"):
        tcp.bucket_layout(m, a, b, masked=False)
    for kind in KINDS:
        gate = _PORT_GATE[kind]
        assert gate(4096, 4, 8, masked=False) and gate(4096, 4, 8)
        assert not gate(4096, 64, 128, masked=False)
        assert not gate(1 << 20, 4, 8, masked=False)
    # N counts in the planes gate only: a wide fleet's G and D push the
    # c2c bucket at s = 8192 past the limit that the masked one meets
    assert tops.coded_bucket_fusable(8192, 4, 2048)
    assert not tops.coded_bucket_fusable(8192, 4, 2048, masked=False)


def test_planes_wrappers_check_decode_shapes():
    s, m, n, q = 256, 4, 8, 2
    g = _generator(n, m)
    gr, gi = _t(g.real.copy(), g.imag.copy())
    bad = torch.zeros((q, m, n + 1))
    with pytest.raises(ValueError, match="decode planes"):
        tops.coded_bucket(torch.zeros(q, s), torch.zeros(q, s), bad, bad,
                          gr, gi, s)
    with pytest.raises(ValueError, match="decode planes"):
        tops.coded_rbucket(torch.zeros(q, s), bad, bad, gr, gi, s)
    with pytest.raises(ValueError, match="decode planes"):
        tops.coded_irbucket(torch.zeros(q, s // 2 + 1),
                            torch.zeros(q, s // 2 + 1), bad, bad, gr, gi, s)


# ------------------------------------------ the streaming c2c bucket
def test_streaming_gate():
    """The reference's streaming gate (DFT planes and the (m, L)
    recombine twiddle within its plane budget, A > 1), then the kernel's
    own bounds: m up to MAX_M, one block's G, D and F_m in shared
    memory."""
    assert tops.coded_bucket_streamable(1 << 20, 4, 8)
    assert tops.coded_bucket_streamable(16384, 4, 8)
    assert not tops.coded_bucket_fusable(1 << 20, 4, 8, masked=False)
    assert not tops.coded_bucket_streamable(1 << 22, 4, 8)  # twiddle
    assert not tops.coded_bucket_streamable(4 * 1021, 4, 8)  # A = 1
    assert not tops.coded_bucket_streamable(4096, 64, 128)  # m > MAX_M
    assert tops.coded_bucket_streamable(4096, 32, 64)
    assert tcp.streaming_smem_bytes(32, 64) == 4 * (4 * 64 * 32 + 2 * 32 * 32)
    assert not tops.coded_bucket_streamable(4096, 32, 1024)   # G, D smem
    assert not tops.coded_bucket_streamable(4095, 4, 8)       # m | s


@pytest.mark.parametrize("s,m,n", [(16384, 4, 8), (3 * 4096, 3, 7)])
def test_streaming_bucket_matches_reference(jref, s, m, n, monkeypatch):
    """A c2c planes bucket past the whole-bucket gate: ``ops.coded_bucket``
    routes it to the streaming wrapper (its plain twin on the CPU), which
    matches the JAX entry point's direct body on the same LRU planes and
    numpy."""
    jnp, jops, _, _, _ = jref
    assert not tops.coded_bucket_fusable(s, m, n, masked=False)
    assert tops.coded_bucket_streamable(s, m, n)
    calls = []
    real = tops.coded_fft_bucket_streaming
    monkeypatch.setattr(tops, "coded_fft_bucket_streaming",
                        lambda *a: (calls.append(1), real(*a))[1])
    masks = _servable_masks(n, m)[:3]
    rng = np.random.default_rng(s)
    x, want = _inputs("c2c", rng, len(masks), s)
    g = _generator(n, m)
    dr, di = _dplanes(g, masks)
    gr, gi = g.real.copy(), g.imag.copy()
    got = tops.coded_bucket(*_t(*x, dr, di, gr, gi), s)
    assert calls == [1]
    jgot = jops.coded_bucket(*[jnp.asarray(a) for a in (*x, dr, di, gr, gi)],
                             s)
    assert _rel(list(got), list(jgot)) < PAIR_TOL
    assert _rel(list(got), [want.real, want.imag]) < TRUTH_TOL


def test_streaming_wrapper_checks_shapes():
    s, m, n, q = 1024, 4, 8, 2
    a, b = tops.split_factor(s // m)
    g = _generator(n, m)
    gr, gi = _t(g.real.copy(), g.imag.copy())
    planes = tops._bucket_planes(s, m, torch.device("cpu"))
    x = torch.zeros(q, s)
    with pytest.raises(ValueError, match="decode planes"):
        tcp.coded_fft_bucket_streaming(x, x, torch.zeros(q, m, n + 1),
                                       torch.zeros(q, m, n + 1), gr, gi,
                                       *planes)
    with pytest.raises(ValueError, match="inconsistent"):
        tcp.coded_fft_bucket_streaming(torch.zeros(q, s - m),
                                       torch.zeros(q, s - m),
                                       torch.zeros(q, m, n),
                                       torch.zeros(q, m, n), gr, gi, *planes)


# -------------------------------------------------------- the service (c)
_SERVICE_SPECS = {
    # one length under each kind's planes gate and one past it, so the
    # whole-bucket and the stage routes both run
    "c2c": [("c2c", 2048), ("c2c", 16384), ("c2c", 2048)],
    "r2c": [("r2c", 2048), ("r2c", 32768), ("r2c", 2048)],
    "c2r": [("c2r", 2048), ("c2r", 32768), ("c2r", 2048)],
    "mixed": [("r2c", 2048), ("c2c", 2048), ("c2r", 2048), ("c2c", 16384),
              ("c2r", 32768), ("r2c", 2048)],
}


@pytest.mark.parametrize("traffic", list(_SERVICE_SPECS))
def test_host_service_matches_reference(jref, traffic):
    """``device_decode=False`` services of both packages, same seed, two
    calls: outputs against numpy and each other, equal coded latency,
    equal LRU counters (warmup's all-alive entry included), one host
    transfer a call."""
    _, _, JService, JConfig, _ = jref
    jsvc = JService(JConfig(s=2048, m=4, n_workers=8, seed=5,
                            device_decode=False, decode_cache_size=16,
                            autotune=False))
    tsvc = _port_twin(jsvc)
    assert tsvc.cfg.decode_cache_size == 16 and not tsvc._device_decode()
    assert tsvc.warmup(buckets=[1, 2]) == jsvc.warmup(buckets=[1, 2]) == 2
    assert tsvc.stats.decode_cache_misses == 1
    specs = _SERVICE_SPECS[traffic]
    for call in range(2):      # the second call continues the same draws
        xs, kinds, want = _requests(specs, seed=call)
        jout = jsvc.submit_batch(xs, kind=kinds)
        tout = tsvc.submit_batch(xs, kind=kinds)
        for k, j, t, w in zip(kinds, jout, tout, want):
            assert t.shape == w.shape
            assert t.dtype == (np.float32 if k == "c2r" else np.complex64)
            assert _rel([t], [w]) < SERVICE_TOL
            assert _rel([t], [np.asarray(j)]) < SERVICE_TOL
        assert tsvc.stats.host_transfers == call + 1
        for field in ("coded_latency", "uncoded_latency",
                      "stragglers_tolerated", "decode_cache_hits",
                      "decode_cache_misses", "batches"):
            assert getattr(tsvc.stats, field) == getattr(jsvc.stats, field)
    summary = tsvc.stats.summary()
    assert summary["decode_cache_misses"] > 1
    assert summary["decode_cache_hits"] == jsvc.stats.decode_cache_hits


# ----------------------------------------- device vs host decode (d)
@pytest.mark.parametrize("kind", KINDS)
def test_device_and_host_paths_serve_identical_results(kind):
    """Same seed, hence the same straggler masks: the device-decode
    service and the host-LRU service agree request for request, and both
    match numpy; only the host one pays inversions."""
    common = dict(s=512, m=4, n_workers=8, seed=21)
    dev = FFTService(FFTServiceConfig(**common), device="cpu")
    host = FFTService(FFTServiceConfig(**common, device_decode=False),
                      device="cpu")
    xs, _, want = _requests([(kind, 512)] * 9, seed=7)
    out_d = dev.submit_batch(xs, kind=kind)
    out_h = host.submit_batch(xs, kind=kind)
    for yd, yh, w in zip(out_d, out_h, want):
        assert _rel([yd], [w]) < SERVICE_TOL
        assert _rel([yh], [w]) < SERVICE_TOL
        assert np.abs(yd - yh).max() < 1e-3
    assert dev.stats.coded_latency == host.stats.coded_latency
    assert dev.stats.decode_cache_misses == 0
    assert host.stats.decode_cache_misses > 0


# ------------------------------------------- past LAGRANGE_MAX_M (e)
@pytest.mark.parametrize("kind", KINDS)
def test_wide_code_takes_the_stage_route(jref, kind, monkeypatch):
    """m = 64, N = 128, s = 2048: the service serves on the host path,
    the planes gate refuses, the stage kernels run, the LRU misses match
    a same-seed JAX service's, and on evenly spread masks the service's
    own runner is within 1e-3 of numpy."""
    _, _, JService, JConfig, _ = jref
    s, m, n = 2048, 64, 128
    assert m > tmds.LAGRANGE_MAX_M
    jsvc = JService(JConfig(s=s, m=m, n_workers=n, seed=3, autotune=False))
    tsvc = _port_twin(jsvc)
    assert not tsvc._device_decode()
    assert not _PORT_GATE[kind](s, m, n, masked=False)
    stages = []
    for name in ("encode_worker", "decode_apply"):
        real = getattr(tops, name)
        monkeypatch.setattr(tops, name, lambda *a, _f=real, _n=name: (
            stages.append(_n), _f(*a))[1])
    xs, kinds, want = _requests([(kind, s)] * 3, seed=9)
    tout = tsvc.submit_batch(xs, kind=kinds)
    jsvc.submit_batch(xs, kind=kinds)
    assert stages == ["encode_worker", "decode_apply"]
    for t, w in zip(tout, want):
        assert t.shape == w.shape and np.isfinite(t).all()
    assert tsvc.stats.decode_cache_misses == jsvc.stats.decode_cache_misses
    assert tsvc.stats.decode_cache_misses > 0
    assert tsvc.stats.coded_latency == jsvc.stats.coded_latency
    # well-conditioned subsets through the same staging and runner
    q = 4
    rng = np.random.default_rng(1)
    x, truth = _inputs(kind, rng, q, s)
    xb = (x[0] + 1j * x[1]).astype(np.complex64) if len(x) == 2 else x[0]
    out = _serve_with_masks(tsvc, s, kind, xb, _spread_masks(n, q))
    assert _rel([out.numpy()], [truth]) < TRUTH_TOL


@pytest.mark.parametrize("kwargs", [
    {"device_decode": False},
    {"m": 33, "n_workers": 66, "s": 33 * 64},
])
def test_formerly_unserved_configs_serve(kwargs):
    """``device_decode=False`` and a code past ``LAGRANGE_MAX_M`` used to
    raise NotImplementedError: both now serve every 1-D kind on the host
    decode-matrix path."""
    svc = FFTService(FFTServiceConfig(**kwargs), device="cpu")
    assert not svc._device_decode()
    s = svc.cfg.s
    xs, kinds, want = _requests([(k, s) for k in KINDS], seed=2)
    out = svc.submit_batch(xs, kind=kinds)
    for o, w in zip(out, want):
        assert o.shape == w.shape and np.isfinite(o).all()
        if svc.cfg.m <= tmds.LAGRANGE_MAX_M:
            assert _rel([o], [w]) < SERVICE_TOL
    assert svc.stats.decode_cache_misses > 0
    if svc.cfg.m > tmds.LAGRANGE_MAX_M:
        # N = 2m: evenly spread responders are the m-th roots of unity
        x, truth = _inputs("c2c", np.random.default_rng(0), 2, s)
        out = _serve_with_masks(
            svc, s, "c2c", (x[0] + 1j * x[1]).astype(np.complex64),
            _spread_masks(svc.cfg.n_workers, 2))
        assert _rel([out.numpy()], [truth]) < TRUTH_TOL


@pytest.mark.parametrize("kwargs,what", [
    ({"m": 65, "n_workers": 130, "s": 65 * 64}, "m=65"),
    ({"m": 32, "n_workers": 1000, "s": 32 * 64, "device_decode": False},
     "N=1000"),
    ({"m": 64, "n_workers": 600, "s": 64 * 64}, "N=600"),
])
def test_codes_past_the_stage_kernels_raise_at_construction(kwargs, what):
    """A host-path code the stage kernels cannot serve (the recombine past
    m=64, or a G or D over one block's shared memory) is refused when the
    service is built, naming the ROADMAP item -- not at its first
    submit."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as err:
        FFTService(FFTServiceConfig(**kwargs), device="cpu")
    assert what in str(err.value)
    # the reference backend serves any code
    svc = FFTService(FFTServiceConfig(**kwargs, use_reference=True),
                     device="cpu")
    assert svc.plan.resolved_backend == "reference"


def test_stage_bucket_with_given_masks():
    """The seam: chosen responders replace the straggler draw (no latency
    accounted), padded rows respond in full, and a wrong mask shape is
    refused."""
    svc = FFTService(FFTServiceConfig(s=256, device_decode=False),
                     device="cpu")
    masks = _spread_masks(8, 3)
    rng = np.random.default_rng(8)
    x, want = _inputs("c2c", rng, 3, 256)
    xb = (x[0] + 1j * x[1]).astype(np.complex64)
    bucket, args = svc.stage_bucket(256, "c2c", list(xb), masks=masks)
    assert bucket == 4 and svc.stats.coded_latency == 0.0
    assert svc.stats.requests == 0 and svc.stats.batches == 1
    g = svc._decode_cache_for()
    np.testing.assert_allclose(args[1][0, :3].numpy(),
                               g.matrices(masks).real, rtol=0, atol=0)
    out = svc.launch_bucket(256, bucket, "c2c", args)
    assert _rel([out[:3].numpy()], [want]) < SERVICE_TOL
    with pytest.raises(ValueError, match="masks must be"):
        svc.stage_bucket(256, "c2c", list(xb), masks=masks[:2])


def test_reference_escape_hatch_skips_the_lru():
    svc = FFTService(FFTServiceConfig(s=256, device_decode=False,
                                      use_reference=True), device="cpu")
    xs, kinds, want = _requests([("c2c", 256), ("r2c", 256)], seed=3)
    for o, w in zip(svc.submit_batch(xs, kind=kinds), want):
        assert _rel([o], [w]) < 1e-4
    assert svc.stats.decode_cache_misses == svc.stats.decode_cache_hits == 0


def test_load_generator_drops_the_lru():
    svc = FFTService(FFTServiceConfig(s=256, device_decode=False),
                     device="cpu")
    svc.submit_batch(_requests([("c2c", 256)], seed=4)[0])
    old = svc._decode_cache_for()
    svc.load_generator(*svc.generator_planes())
    assert svc._decode_cache_for() is not old


# ------------------------------------------------------ GPU (f): kernels
@pytest.mark.gpu
@pytest.mark.parametrize("s,m,n", SHAPES + [(8192, 4, 8)] + GPU_REAL_SHAPES)
def test_gpu_planes_buckets_match_plain(cuda, s, m, n):
    """Each planes bucket kernel against its plain twin on the card, one
    launch each, and (narrow codes) against numpy."""
    masks = _servable_masks(n, m) if m <= 4 else _spread_masks(n, 3)
    q = len(masks)
    g = _generator(n, m)
    dr, di = _t(*_dplanes(g, masks), device=cuda)
    gr, gi = _t(g.real.copy(), g.imag.copy(), device=cuda)
    rng = np.random.default_rng(s + m)
    for kind in KINDS:
        x, want = _inputs(kind, rng, q, s)
        if not _PORT_GATE[kind](s, m, n, masked=False):
            continue
        xt = _t(*x, device=cuda)
        name = {"c2c": "coded_fft_bucket", "r2c": "coded_rfft_bucket",
                "c2r": "coded_irfft_bucket"}[kind]
        before = _build.launch_counts().get(name, 0)
        got = _PORT_BUCKET[kind](*xt, dr, di, gr, gi, s)
        assert _build.launch_counts()[name] == before + 1
        plain = _PORT_BUCKET[kind](*_t(*x), dr.cpu(), di.cpu(), gr.cpu(),
                                   gi.cpu(), s)
        got = [o.cpu() for o in _planes_out(kind, got)]
        assert _rel(got, _planes_out(kind, plain)) < PAIR_TOL
        truth = [want] if kind == "c2r" else [want.real, want.imag]
        assert _rel(got, truth) < TRUTH_TOL


def _encode_m64(cuda, b, launches):
    """The encode with a (128, 64) G at A = 4: its launches, and the
    kernel against its plain twin."""
    q, m, n, a = 4, 64, 128, 4
    rng = np.random.default_rng(64)
    g = _generator(n, m)
    planes = (*tops._dft_planes(a), *tops._twiddle_planes(a, b),
              *tops._dft_planes(b))
    args = _t(rng.standard_normal((q, m, a, b)).astype(np.float32),
              rng.standard_normal((q, m, a, b)).astype(np.float32),
              g.real.copy(), g.imag.copy(), *planes, device=cuda)
    before = _build.launch_counts().get("encode_fourstep_fused", 0)
    got = encode_fourstep_fused(*args)
    torch.cuda.synchronize()
    assert (_build.launch_counts()["encode_fourstep_fused"]
            == before + launches)
    want = encode_fourstep_body(*args)
    assert _rel([o.cpu() for o in got], [w.cpu() for w in want]) < PAIR_TOL


@pytest.mark.gpu
def test_gpu_encode_fourstep_m64(cuda):
    """The smoke run's m = 64 shape, B = 8: the folded route (two
    launches), its row FFT block holding row c of all 64 shards and G
    read through the read-only path."""
    assert encode_rows_fold(64, 4, 8)
    _encode_m64(cuda, 8, 2)


@pytest.mark.gpu
def test_gpu_encode_fourstep_m64_fall_back(cuda):
    """B = 128, past the fold (8192 points a block): the row FFT, then
    the G apply with 64 KB of generator in its shared memory, past the
    48 KB a launch gets without opting in (three launches)."""
    assert not encode_rows_fold(64, 4, 128)
    _encode_m64(cuda, 128, 3)


@pytest.mark.gpu
def test_gpu_bcmatmul_m64(cuda):
    """The decode apply with (q, 64, 128) left matrices (64 KB each)."""
    q, m, k, ell = 3, 64, 128, 512
    rng = np.random.default_rng(65)
    args = _t(*(rng.standard_normal(sh).astype(np.float32)
                for sh in ((q, m, k), (q, m, k), (q, k, ell), (q, k, ell))),
              device=cuda)
    before = _build.launch_counts().get("bcmatmul", 0)
    got = bcmatmul(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts()["bcmatmul"] == before + 1
    want = bcmatmul_body(*args)
    assert _rel([o.cpu() for o in got], [w.cpu() for w in want]) < 1e-5


@pytest.mark.gpu
def test_gpu_bcmatmul_m64_decode_planes(cuda):
    """The host path's m=64 decode apply at the smoke run's shape: 64
    requests' (64, 128) scatter decode planes from the port's LRU on
    evenly spread responders, 64 payload columns (the narrow map, 64 live
    columns of 128)."""
    q, m, n, ell = 64, 64, 128, 64
    rng = np.random.default_rng(67)
    args = _t(*_dplanes(_generator(n, m), _spread_masks(n, q)),
              *(rng.standard_normal((q, n, ell)).astype(np.float32)
                for _ in range(2)), device=cuda)
    before = _build.launch_counts().get("bcmatmul", 0)
    got = bcmatmul(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts()["bcmatmul"] == before + 1
    want = bcmatmul_body(*args)
    assert _rel([o.cpu() for o in got], [w.cpu() for w in want]) < 1e-5


@pytest.mark.gpu
def test_gpu_recombine_m64(cuda):
    q, m, s = 3, 64, 64 * 96
    rng = np.random.default_rng(66)
    ell = s // m
    args = _t(rng.standard_normal((q, m, ell)).astype(np.float32),
              rng.standard_normal((q, m, ell)).astype(np.float32),
              *tops._recombine_planes(s, m), device=cuda)
    before = _build.launch_counts().get("recombine_twiddle_dft_batched", 0)
    got = recombine_twiddle_dft_batched(*args)
    torch.cuda.synchronize()
    assert (_build.launch_counts()["recombine_twiddle_dft_batched"]
            == before + 1)
    want = recombine_batched_body(*args)
    assert _rel([o.cpu() for o in got], [w.cpu() for w in want]) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_gpu_host_service_launches(cuda, kind):
    """The default config pinned to the host path: one planes bucket
    launch per bucket and no other kernel; the m = 64 code: exactly the
    stage kernels, and within 1e-3 of numpy on evenly spread masks."""
    name = {"c2c": "coded_fft_bucket", "r2c": "coded_rfft_bucket",
            "c2r": "coded_irfft_bucket"}[kind]
    svc = FFTService(FFTServiceConfig(s=4096, device_decode=False))
    xs, kinds, want = _requests([(kind, 4096)] * 70, seed=1)
    _build.reset_launch_counts()
    out = svc.submit_batch(xs, kind=kinds)        # buckets of 64 and 6
    assert _build.launch_counts() == {name: 2}
    assert max(_rel([o], [w]) for o, w in zip(out, want)) < SERVICE_TOL
    wide = FFTService(FFTServiceConfig(s=4096, m=64, n_workers=128))
    stage = {"encode_fourstep_fused", "bcmatmul"}
    if kind == "c2c":
        stage.add("recombine_twiddle_dft_batched")
    xs, kinds, want = _requests([(kind, 4096)] * 8, seed=2)
    _build.reset_launch_counts()
    out = wide.submit_batch(xs, kind=kinds)
    assert set(_build.launch_counts()) == stage
    assert all(o.shape == w.shape for o, w in zip(out, want))
    q = 8
    x, truth = _inputs(kind, np.random.default_rng(3), q, 4096)
    xb = (x[0] + 1j * x[1]).astype(np.complex64) if len(x) == 2 else x[0]
    _build.reset_launch_counts()
    got = _serve_with_masks(wide, 4096, kind, xb, _spread_masks(128, q))
    assert set(_build.launch_counts()) == stage
    assert _rel([got.cpu().numpy()], [truth]) < TRUTH_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("s,m,n", SHAPES + [(1 << 16, 4, 8),
                                            (16 * 64, 16, 32),
                                            (32 * 32, 32, 64),
                                            (3 * 4096, 3, 7)])
def test_gpu_streaming_bucket_matches_plain(cuda, s, m, n):
    """The streaming bucket kernel (three launches) against its plain
    twin on the card, at ragged and unrolled-bound shapes, m = 3 not
    dividing the column FFT's 64-column tile among them, and (narrow
    codes) against numpy."""
    masks = _servable_masks(n, m) if m <= 4 else _spread_masks(n, 3)
    q = len(masks)
    g = _generator(n, m)
    dr, di = _t(*_dplanes(g, masks), device=cuda)
    gr, gi = _t(g.real.copy(), g.imag.copy(), device=cuda)
    x, want = _inputs("c2c", np.random.default_rng(s + m), q, s)
    xr, xi = _t(*x, device=cuda)
    planes = tops._bucket_planes(s, m, cuda)
    before = _build.launch_counts().get("coded_fft_bucket_streaming", 0)
    got = tcp.coded_fft_bucket_streaming(xr, xi, dr, di, gr, gi, *planes)
    torch.cuda.synchronize()
    assert _build.launch_counts()["coded_fft_bucket_streaming"] == before + 3
    plain = tcp.bucket_body(xr.cpu(), xi.cpu(), dr.cpu(), di.cpu(),
                            gr.cpu(), gi.cpu(), *(p.cpu() for p in planes))
    got = [o.cpu() for o in got]
    assert _rel(got, list(plain)) < PAIR_TOL
    assert _rel(got, [want.real, want.imag]) < TRUTH_TOL


@pytest.mark.gpu
def test_gpu_host_service_streams_past_the_gate(cuda):
    """A c2c bucket past the planes gate on the host path: the streaming
    kernel's three launches and nothing else, within 1e-3 of numpy."""
    s = 1 << 16
    svc = FFTService(FFTServiceConfig(s=s, device_decode=False))
    assert not tops.coded_bucket_fusable(s, 4, 8, masked=False)
    xs, kinds, want = _requests([("c2c", s)] * 4, seed=6)
    _build.reset_launch_counts()
    out = svc.submit_batch(xs, kind=kinds)
    assert _build.launch_counts() == {"coded_fft_bucket_streaming": 3}
    assert max(_rel([o], [w]) for o, w in zip(out, want)) < TRUTH_TOL
