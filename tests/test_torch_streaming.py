"""The port's fifth slice against the JAX package: past one block.

* the decode dispatch (``mds.decode_ifft``, ``is_contiguous_subset``,
  ``decode_auto``) and the plans' ``method=`` routing;
* the service's ``decode_method`` and ``worker_fn`` knobs (the
  ``plan.run`` executor);
* ``ops.recombine_fused`` on the single-request recombine kernel's plain
  twin, and ``fourstep_planar(variant="streaming")`` on the streaming
  four-step's;
* the device-decode c2c bucket past the fused gate, on the masked
  streaming bucket kernel's plain twin;
* the refusals of codes the stage kernels cannot carry, before any draw;
* numpy models, index for index, of the column FFT and the row FFT the
  kernels run (csrc/fft_cols.cuh, fft_rows.cuh): the streaming four-step
  and bucket, fourstep_stage1's plain store, and the encode's two
  launches (the folded row block's source runs and output addresses,
  its working set as the fold gate).

CPU tests: the same numpy inputs, made from a seed, go through both
packages.  Stated tolerances, relative to the largest output magnitude:
1e-9 between the two packages' complex128 decodes; 5e-4 for the plans
(``tests/test_kernels.py:146``); 3e-4 for the services
(``tests/test_lagrange_decode.py:153``); 1e-5 for the recombine (one
twiddle and an m-point DFT in f32).  The JAX package's streaming Pallas
kernels cannot trace under jax 0.9.0 (``tests/test_streaming.py``), so
the streaming four-step is held against numpy and the reference's
``fourstep_body``, and the masked streaming bucket against the JAX
service's own (direct) executor and numpy.

GPU tests (marker ``gpu``, skipped without a CUDA device): the three new
kernels against their plain twins with their launch counts, and the
device-decode service's route past the fused gate.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch
from test_torch_kernels import adversarial_masks
from test_torch_kernels import private_autotune_table  # noqa: F401
from test_torch_plan import UNROLLED, _stockham_model
from test_torch_real import _mixed_requests as _requests
from test_torch_real import _port_twin, _rel, _t

from repro_torch import CodedFFT, FFTService, FFTServiceConfig
from repro_torch.convert import config_from_reference
from repro_torch.core import mds as tmds
from repro_torch.core.interleave import interleave
from repro_torch.core.rfft import CodedIFFT, CodedIRFFT, CodedRFFT
from repro_torch.kernels import _build
from repro_torch.kernels import coded_pipeline as tcp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fourstep_fft import (
    encode_fourstep_body,
    encode_rows_fold,
    encode_rows_layout,
    encode_rows_per_block,
    fft_cols_layout,
    fft_cols_spec,
    fft_cols_tile,
    fft_rows_plan,
    fft_rows_spec,
    fft_rows_twiddles,
    fourstep_streaming,
    fourstep_streaming_body,
    stage1_body,
    stage2_body,
)
from repro_torch.kernels.recombine import (
    recombine_body,
    recombine_twiddle_dft,
)

CPU = torch.device("cpu")
DECODE_TOL = 1e-9
PLAN_TOL = 5e-4
SERVICE_TOL = 3e-4
RECOMBINE_TOL = 1e-5
PAIR_TOL = 1e-4
TRUTH_TOL = 1e-3


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
    from repro.core.rfft import CodedIRFFT as JCodedIRFFT
    from repro.core.rfft import CodedRFFT as JCodedRFFT
    from repro.kernels import fourstep_fft as jfs
    from repro.kernels import ops as jops
    from repro.serving import FFTService as JService
    from repro.serving import FFTServiceConfig as JConfig

    return dict(jnp=jnp, mds=jmds, ops=jops, fs=jfs, CodedFFT=JCodedFFT,
                CodedRFFT=JCodedRFFT, CodedIRFFT=JCodedIRFFT,
                Service=JService, Config=JConfig)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _crand(rng, *shape, dtype=np.complex128):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _coded(n, m, payload, seed, dtype=np.complex128):
    """Message shards ``c (m, payload)`` and their codeword ``G @ c``."""
    c = _crand(np.random.default_rng(seed), m, payload, dtype=dtype)
    g = tmds.rs_generator(n, m, torch.complex128, CPU).numpy()
    return c, (g @ c).astype(dtype)


def streaming_worker(a):
    """A ``worker_fn`` on the streaming four-step: fft along the last
    axis, leading axes collapsed into the kernel's batch."""
    lead, ell = tuple(a.shape[:-1]), a.shape[-1]
    xr, xi = tref.planar(a.reshape(-1, ell))
    outr, outi = tops.fourstep_planar(xr, xi, variant="streaming")
    return tref.unplanar(outr, outi).reshape(lead + (ell,))


# ------------------------------------------------------ the decode dispatch
# (n, m, subset): a contiguous arc, a wrapping arc, scattered responders,
# the full set (permuted), arcs at IFFT_AUTO_MAX_M and one past it
SUBSETS = [
    (8, 4, [2, 3, 4, 5]),
    (8, 4, [6, 7, 0, 1]),
    (8, 4, [0, 2, 5, 7]),
    (7, 3, [1, 4, 6]),
    (8, 8, [3, 1, 0, 2, 7, 6, 5, 4]),
    (16, 8, list(range(5, 13))),
    (18, 9, list(range(9))),
]


@pytest.mark.parametrize("n,m,subset", SUBSETS)
def test_decode_ifft_matches_reference(jref, n, m, subset):
    jnp, jmds = jref["jnp"], jref["mds"]
    c, b = _coded(n, m, 6, seed=n + m)
    b_poisoned = b.copy()
    b_poisoned[np.setdiff1d(np.arange(n), subset)] = np.nan
    got = tmds.decode_ifft(torch.as_tensor(b_poisoned),
                           torch.as_tensor(subset), n).numpy()
    want = np.asarray(jmds.decode_ifft(jnp.asarray(b_poisoned),
                                       jnp.asarray(subset), n))
    assert np.isfinite(got).all()
    assert _rel([got], [want]) < DECODE_TOL
    assert _rel([got], [c]) < 1e-6
    if m > tmds.IFFT_AUTO_MAX_M:
        return      # f32 loses the ill-conditioned arc in both packages
    # complex64 through both packages: the plans' working type
    b64 = b_poisoned.astype(np.complex64)
    got64 = tmds.decode_ifft(torch.as_tensor(b64),
                             torch.as_tensor(subset), n).numpy()
    want64 = np.asarray(jmds.decode_ifft(jnp.asarray(b64),
                                         jnp.asarray(subset), n))
    assert got64.dtype == np.complex64
    assert _rel([got64], [want64]) < PAIR_TOL


def test_decode_ifft_batched_is_per_request(jref):
    """Per-request subsets decode at once, each as it would alone."""
    jnp, jmds = jref["jnp"], jref["mds"]
    n, m = 8, 4
    rng = np.random.default_rng(3)
    subsets = np.stack([rng.permutation(n)[:m] for _ in range(5)])
    bs = np.stack([_coded(n, m, 10, seed=i)[1] for i in range(5)])
    got = tmds.decode_ifft_batched(torch.as_tensor(bs),
                                   torch.as_tensor(subsets), n).numpy()
    for i in range(5):
        want = np.asarray(jmds.decode_ifft(jnp.asarray(bs[i]),
                                           jnp.asarray(subsets[i]), n))
        assert _rel([got[i]], [want]) < DECODE_TOL


def test_contiguity_matches_reference(jref):
    jmds = jref["mds"]
    for n, m in [(7, 3), (8, 4), (9, 1), (6, 6)]:
        for subset in itertools.combinations(range(n), m):
            want = jmds.is_contiguous_subset(subset, n)
            assert tmds.is_contiguous_subset(subset, n) == want, subset
            flag = tmds.contiguous_flag(torch.as_tensor(subset), n)
            assert flag.dtype == torch.bool and flag.ndim == 0
            assert bool(flag) == want, subset
    assert tmds.IFFT_AUTO_MAX_M == jmds.IFFT_AUTO_MAX_M == 8


# (n, m, subset, method, the decode auto must pick)
CHOICES = [
    (8, 8, [3, 1, 0, 2, 7, 6, 5, 4], "auto", "ifft"),   # full set
    (16, 8, list(range(5, 13)), "auto", "ifft"),         # arc, m = MAX
    (18, 9, list(range(9)), "auto", "solve"),            # arc, m = MAX + 1
    (8, 4, [6, 7, 0, 1], "auto", "ifft"),                # wrapping arc
    (8, 4, [0, 2, 5, 7], "auto", "solve"),               # scattered
    (8, 4, [2, 3, 4, 5], "solve", "solve"),
    (8, 4, [0, 2, 5, 7], "ifft", "ifft"),
]


@pytest.mark.parametrize("n,m,subset,method,chosen", CHOICES)
def test_decode_auto_choice_matches_reference(jref, monkeypatch, n, m,
                                              subset, method, chosen):
    """A spy on each package's two decodes shows which one decode_auto
    took: the same one, and the one the rule names; the results agree."""
    jnp, jmds = jref["jnp"], jref["mds"]
    seen = {"port": [], "ref": []}
    for mod, key in ((tmds, "port"), (jmds, "ref")):
        for name, tag in (("decode_ifft", "ifft"),
                          ("decode_from_subset", "solve")):
            real = getattr(mod, name)
            monkeypatch.setattr(
                mod, name,
                lambda *a, _r=real, _k=key, _t=tag, **kw:
                    (seen[_k].append(_t), _r(*a, **kw))[1])
    c, b = _coded(n, m, 5, seed=m)
    g = tmds.rs_generator(n, m, torch.complex128, CPU)
    got = tmds.decode_auto(g, torch.as_tensor(b), torch.as_tensor(subset),
                           method=method).numpy()
    want = np.asarray(jmds.decode_auto(
        jmds.rs_generator(n, m, jnp.complex128), jnp.asarray(b),
        jnp.asarray(subset), method=method))
    assert seen["port"] == seen["ref"] == [chosen]
    assert _rel([got], [want]) < 1e-8
    assert _rel([got], [c]) < 1e-6


def test_decode_auto_refuses_bad_arguments():
    g = tmds.rs_generator(8, 4, torch.complex128, CPU)
    b = torch.zeros(8, 3, dtype=torch.complex128)
    with pytest.raises(ValueError, match="unknown decode method"):
        tmds.decode_auto(g, b, torch.arange(4), method="lu")
    with pytest.raises(ValueError, match="exactly m=4"):
        tmds.decode_auto(g, b, torch.arange(3))


# ------------------------------------------------------------------ plans
def _decode_cases(n, batch):
    rng = np.random.default_rng(batch)
    masks = np.zeros((max(batch, 1), n), bool)
    for row in masks:
        row[rng.permutation(n)[:n - 2]] = True
    return {
        "default": {},
        "shared_subset": {"subset": np.array([1, 2, 3, 4])},
        "masks": {"mask": masks if batch else masks[0]},
        "subsets": {"subset": np.stack([np.flatnonzero(mk)[:4]
                                        for mk in masks])
                    if batch else np.array([0, 2, 3, 6])},
    }


@pytest.mark.parametrize("method", ["auto", "solve", "ifft"])
@pytest.mark.parametrize("batch", [0, 1, 3])
@pytest.mark.parametrize("case", ["default", "shared_subset", "masks",
                                  "subsets"])
def test_plan_decode_methods_match_reference(jref, method, batch, case):
    """CodedFFT on the kernel backend: decode and run with each method,
    unbatched, a batch of one and a batch of three, against the JAX plan
    and numpy."""
    jnp = jref["jnp"]
    s, m, n = 256, 4, 8
    if case == "subsets" and batch == 0:
        case = "shared_subset"
    kwargs = _decode_cases(n, batch)[case]
    if batch == 1 and case in ("masks", "subsets"):
        kwargs = {k: v[:1] for k, v in kwargs.items()}
    rng = np.random.default_rng(7 + batch)
    shape = (batch, s) if batch else (s,)
    x = _crand(rng, *shape, dtype=np.complex64)
    tp = CodedFFT(s=s, m=m, n_workers=n, device="cpu")
    jp = jref["CodedFFT"](s=s, m=m, n_workers=n, dtype=jnp.complex64)
    b = tp.worker_compute(tp.encode(torch.as_tensor(x)))
    t_kw = {k: torch.as_tensor(v) for k, v in kwargs.items()}
    j_kw = {k: jnp.asarray(v) for k, v in kwargs.items()}
    got = tp.decode(b, method=method, **t_kw).numpy()
    jgot = np.asarray(jp.decode(jnp.asarray(b.numpy()), method=method,
                                **j_kw))
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert got.shape == x.shape
    assert _rel([got], [want]) < PLAN_TOL
    assert _rel([got], [jgot]) < PLAN_TOL
    run = tp.run(torch.as_tensor(x), method=method, **t_kw).numpy()
    assert _rel([run], [want]) < PLAN_TOL


@pytest.mark.parametrize("per_request,method,seen", [
    (False, "auto", ["ifft"]),      # shared default arange(m): an arc
    (True, "auto", ["linalg"]),     # per-request masks: the solve
    (True, "ifft", ["ifft"]),
    (False, "solve", ["solve", "linalg"]),
])
def test_plan_batched_decode_route(monkeypatch, per_request, method, seen):
    """A batch keeps ``method`` for a shared subset (the default arange
    at m=4, N=8 is a contiguous arc: auto takes the transform decode) and
    resolves auto to one batched solve for per-request subsets."""
    got = []
    for mod, name, tag in ((tmds, "decode_ifft_batched", "ifft"),
                           (tmds, "decode_from_subset", "solve"),
                           (torch.linalg, "solve", "linalg")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _t=tag: (
            got.append(_t), _r(*a))[1])
    plan = CodedFFT(s=64, m=4, n_workers=8, device="cpu")
    x = torch.as_tensor(_crand(np.random.default_rng(1), 3, 64,
                               dtype=np.complex64))
    kwargs = {}
    if per_request:
        kwargs["mask"] = torch.tensor([1, 1, 0, 1, 1, 0, 1, 1],
                                      dtype=torch.bool)
    out = plan.run(x, method=method, **kwargs)
    assert got == seen
    assert _rel([out.numpy()], [np.fft.fft(x.numpy().astype(np.complex128),
                                           axis=-1)]) < PLAN_TOL


@pytest.mark.parametrize("kind", ["r2c", "c2r"])
def test_real_plans_ifft_decode_match_reference(jref, kind):
    jnp = jref["jnp"]
    s, m, n, q = 256, 4, 8, 3
    rng = np.random.default_rng(11)
    masks = np.ones((q, n), bool)
    masks[:, [1, 6]] = False
    if kind == "r2c":
        x = rng.standard_normal((q, s)).astype(np.float32)
        tp = CodedRFFT(s=s, m=m, n_workers=n, device="cpu")
        jp = jref["CodedRFFT"](s=s, m=m, n_workers=n)
        want = np.fft.rfft(x.astype(np.float64), axis=-1)
    else:
        x = np.fft.rfft(rng.standard_normal((q, s))).astype(np.complex64)
        tp = CodedIRFFT(s=s, m=m, n_workers=n, device="cpu")
        jp = jref["CodedIRFFT"](s=s, m=m, n_workers=n)
        want = np.fft.irfft(x.astype(np.complex128), n=s, axis=-1)
    got = tp.run(torch.as_tensor(x), mask=torch.as_tensor(masks),
                 method="ifft").numpy()
    jgot = np.asarray(jp.run(jnp.asarray(x), mask=jnp.asarray(masks),
                             method="ifft"))
    assert _rel([got], [want]) < PLAN_TOL
    assert _rel([got], [jgot]) < PLAN_TOL


def test_worker_fn_plan_on_the_streaming_four_step(jref):
    """A CodedFFT whose worker_fn runs fourstep_planar(variant=
    'streaming'), against the JAX plan with the platform FFT worker."""
    jnp = jref["jnp"]
    s, m, n, q = 4096, 4, 8, 3
    rng = np.random.default_rng(5)
    x = _crand(rng, q, s, dtype=np.complex64)
    masks = np.ones((q, n), bool)
    masks[0, :3] = masks[1, 4:7] = masks[2, [0, 7]] = False
    tp = CodedFFT(s=s, m=m, n_workers=n, device="cpu",
                  worker_fn=streaming_worker)
    jp = jref["CodedFFT"](s=s, m=m, n_workers=n, dtype=jnp.complex64,
                          worker_fn=lambda a: jnp.fft.fft(a, axis=-1))
    got = tp.run(torch.as_tensor(x), mask=torch.as_tensor(masks)).numpy()
    jgot = np.asarray(jp.run(jnp.asarray(x), mask=jnp.asarray(masks)))
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert _rel([got], [want]) < PLAN_TOL
    assert _rel([got], [jgot]) < PLAN_TOL


# ---------------------------------------------------------------- service
def _serve_twice(jsvc, tsvc, specs):
    for call in range(2):      # the second call continues the same draws
        xs, kinds, want = _requests(specs, seed=call)
        jout = jsvc.submit_batch(xs, kind=kinds)
        tout = tsvc.submit_batch(xs, kind=kinds)
        for j, t, w in zip(jout, tout, want):
            assert t.shape == w.shape
            assert _rel([t], [w]) < SERVICE_TOL
            assert _rel([t], [np.asarray(j)]) < SERVICE_TOL
    assert tsvc.stats.coded_latency == jsvc.stats.coded_latency
    assert tsvc.stats.requests == jsvc.stats.requests


@pytest.mark.parametrize("method", ["ifft", "solve"])
def test_decode_method_service_matches_reference(jref, method):
    """A pinned decode_method runs every kind on the plan.run executor
    (the plans' kernel backend), output for output with the JAX
    service."""
    JService, JConfig = jref["Service"], jref["Config"]
    jsvc = JService(JConfig(s=512, m=4, n_workers=8, seed=5,
                            decode_method=method))
    tsvc = _port_twin(jsvc)
    assert tsvc.cfg.decode_method == method
    assert not tsvc._kernel_path(512, "c2c")
    _serve_twice(jsvc, tsvc, [("c2c", 512), ("r2c", 512), ("c2c", 2048),
                              ("c2r", 1024), ("c2c", 512)])


def test_worker_fn_service_matches_reference(jref):
    """A worker_fn service (the c2c plug-in: here the streaming four-step)
    against a JAX service with the platform FFT plug-in; a real-kind
    request is refused after its bucket's straggler draw, as in the
    reference, so the two services' draws stay equal."""
    jnp = jref["jnp"]
    JService, JConfig = jref["Service"], jref["Config"]
    jsvc = JService(JConfig(s=1024, m=4, n_workers=8, seed=2,
                            worker_fn=lambda a: jnp.fft.fft(a, axis=-1)))
    jcfg = {f.name: getattr(jsvc.cfg, f.name)
            for f in dataclasses.fields(jsvc.cfg)}
    cfg = dataclasses.replace(config_from_reference(jcfg),
                              worker_fn=streaming_worker)
    tsvc = FFTService(cfg, device="cpu")
    assert tsvc.plan.worker_fn is streaming_worker
    assert tsvc.plan.resolved_backend == "kernel"
    _serve_twice(jsvc, tsvc, [("c2c", 1024), ("c2c", 4096), ("c2c", 1024)])
    with pytest.raises(ValueError, match="worker_fn"):
        tsvc.submit_batch([np.zeros(1024, np.float32)], kind="r2c")
    with pytest.raises(ValueError, match="worker_fn"):
        jsvc.submit_batch([np.zeros(1024, np.float32)], kind="r2c")
    assert tsvc.rng.bit_generator.state == jsvc.rng.bit_generator.state
    assert ((tsvc.stats.requests, tsvc.stats.batches)
            == (jsvc.stats.requests, jsvc.stats.batches))
    _serve_twice(jsvc, tsvc, [("c2c", 1024)])


def test_config_from_reference_maps_the_decode_knobs(jref):
    JConfig = jref["Config"]
    fn = object()
    cfg = config_from_reference(dataclasses.asdict(JConfig(
        decode_method="ifft")) | {"worker_fn": fn})
    assert cfg.decode_method == "ifft" and cfg.worker_fn is fn
    # the strategy zoo's knob maps as it is
    assert config_from_reference(dataclasses.asdict(JConfig(
        strategy_param=3))).strategy_param == 3
    # the fault runtime's knobs map as they are
    assert config_from_reference(dataclasses.asdict(JConfig(
        max_retries=5))).max_retries == 5
    with pytest.raises(ValueError, match="decode_method"):
        FFTService(FFTServiceConfig(decode_method="lu"), device="cpu")


# (s, m, N): past the masked fused gate, within the streaming gate
STREAM_SHAPES = [(16384, 4, 8), (32768, 4, 8), (32768, 16, 32)]


@pytest.mark.parametrize("s,m,n", STREAM_SHAPES)
def test_device_decode_service_streams_past_the_gate(jref, monkeypatch, s,
                                                     m, n):
    """The default (device-decode) service at a c2c length past the fused
    gate takes coded_fft_bucket_streaming_masked (its plain twin here),
    as the reference routes it, and matches the same-seed JAX service
    and numpy.

    At m = 16 of N = 32 a random first-m responder subset is itself
    ill-conditioned: on these draws the JAX service's own error reaches
    5.3 against numpy.  So there the outputs of the service's draws are
    held to the plain twin on the bucket the service drew (both f32, so
    the subset's conditioning does not enter) and to the JAX service's
    latency accounting, and one bucket of evenly spread responders (the
    16th roots of unity, condition number 1) goes through the port's
    staging seam and the JAX bucket executor."""
    jnp = jref["jnp"]
    JService, JConfig = jref["Service"], jref["Config"]
    assert not tops.coded_bucket_fusable(s, m, n)
    assert tops.coded_bucket_streamable(s, m, n)
    calls = []
    real = tops.coded_fft_bucket_streaming_masked
    monkeypatch.setattr(tops, "coded_fft_bucket_streaming_masked",
                        lambda *a: (calls.append(a), real(*a))[1])
    jsvc = JService(JConfig(s=s, m=m, n_workers=n, seed=s + m))
    tsvc = _port_twin(jsvc)
    assert tsvc._device_decode()
    xs, kinds, want = _requests([("c2c", s)] * 3, seed=m)
    tout = tsvc.submit_batch(xs, kind=kinds)
    jout = jsvc.submit_batch(xs, kind=kinds)
    assert len(calls) == 1
    assert tsvc.stats.coded_latency == jsvc.stats.coded_latency
    pr, pi = tcp.bucket_body_masked(*calls[0])
    plain = (pr + 1j * pi).numpy()[:len(xs)]
    assert _rel([np.stack(tout)], [plain]) < SERVICE_TOL
    for t, j, w in zip(tout, jout, want):
        assert t.shape == w.shape and np.isfinite(t).all()
        if m <= 4:
            assert _rel([t], [w]) < SERVICE_TOL
            assert _rel([t], [np.asarray(j)]) < SERVICE_TOL
    spread = np.stack([np.roll(np.arange(n) % (n // m) == 0, i)
                       for i in range(len(xs))])
    bucket, args = tsvc.stage_bucket(s, "c2c", xs, masks=spread)
    got = tsvc.launch_bucket(s, bucket, "c2c", args).numpy()[:len(xs)]
    jgot = np.asarray(jsvc._runner_for(s, bucket, "c2c")(
        jnp.asarray(np.stack(xs)), jnp.asarray(spread)))
    assert len(calls) == 2
    assert _rel([got], [np.stack(want)]) < SERVICE_TOL
    assert _rel([got], [jgot]) < SERVICE_TOL


def test_streaming_masked_twin_is_the_masked_bucket():
    """On the CPU the masked streaming wrapper is bucket_body_masked, on
    adversarial masks too (short rows filled with non-responders)."""
    s, m, n = 16384, 4, 8
    masks = adversarial_masks(n, m)[:4]
    q = len(masks)
    rng = np.random.default_rng(9)
    x = _crand(rng, q, s, dtype=np.complex64)
    g = tmds.rs_generator(n, m, torch.complex64, CPU)
    gr, gi = g.real.contiguous(), g.imag.contiguous()
    xr, xi = _t(x.real, x.imag)
    planes = tops._bucket_planes(s, m, CPU)
    got = tcp.coded_fft_bucket_streaming_masked(
        xr, xi, torch.as_tensor(masks), gr, gi, *planes)
    want = tcp.bucket_body_masked(xr, xi, torch.as_tensor(masks), gr, gi,
                                  *planes)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    full = masks.sum(axis=1) >= m
    truth = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert _rel([(got[0] + 1j * got[1]).numpy()[full]],
                [truth[full]]) < TRUTH_TOL
    with pytest.raises(ValueError, match="inconsistent"):
        tcp.coded_fft_bucket_streaming_masked(
            xr, xi, torch.as_tensor(masks[:, :-1]), gr, gi, *planes)


# -------------------------------------------- recombine_fused, streaming
@pytest.mark.parametrize("s,m", [(64, 4), (4096, 8), (96 * 3, 3)])
def test_recombine_fused_matches_reference(jref, s, m):
    jnp, jops = jref["jnp"], jref["ops"]
    rng = np.random.default_rng(s)
    x = _crand(rng, s, dtype=np.complex64)
    c_hat = np.fft.fft(interleave(torch.as_tensor(x), m).numpy(),
                       axis=-1).astype(np.complex64)
    got = tops.recombine_fused(torch.as_tensor(c_hat), s).numpy()
    jgot = np.asarray(jops.recombine_fused(jnp.asarray(c_hat), s,
                                           interpret=True))
    assert got.shape == (s,) and got.dtype == np.complex64
    assert _rel([got], [jgot]) < RECOMBINE_TOL
    assert _rel([got], [np.fft.fft(x.astype(np.complex128))]) < PAIR_TOL


def test_recombine_twiddle_dft_checks_shapes():
    z = torch.zeros(4, 16)
    w = torch.zeros(4, 16)
    f = torch.zeros(4, 4)
    recombine_twiddle_dft(z, z, w, w, f, f)
    with pytest.raises(ValueError, match="inconsistent"):
        recombine_twiddle_dft(z, z, w[:, :8], w[:, :8], f, f)
    with pytest.raises(ValueError, match="inconsistent"):
        recombine_twiddle_dft(z, z, w, w, f[:3], f[:3])
    got = recombine_twiddle_dft(z + 1, z, w + 1, w, f + 1, f)
    assert all(torch.equal(a, b) for a, b in zip(
        got, recombine_body(z + 1, z, w + 1, w, f + 1, f)))


@pytest.mark.parametrize("batch,ell", [(3, 64), (2, 96), (4, 1024),
                                       (2, 4096)])
def test_fourstep_streaming_matches_numpy_and_reference(jref, batch, ell):
    """fourstep_planar(variant='streaming'): natural order straight out of
    the wrapper, equal to numpy and to the reference's fourstep_body once
    that body's scrambled order is undone."""
    jnp, jfs = jref["jnp"], jref["fs"]
    rng = np.random.default_rng(ell)
    x = _crand(rng, batch, ell, dtype=np.complex64)
    xr, xi = _t(x.real, x.imag)
    outr, outi = tops.fourstep_planar(xr, xi, variant="streaming")
    got = (outr + 1j * outi).numpy()
    truth = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert _rel([got], [truth]) < PAIR_TOL
    a, b = tops.split_factor(ell)
    planes = tops._fourstep_planes(a, b, CPU)
    jr, ji = jfs.fourstep_body(
        *(jnp.asarray(p.reshape(batch, a, b)) for p in (x.real, x.imag)),
        *(jnp.asarray(p.numpy()) for p in planes))
    jnat = (np.asarray(jr) + 1j * np.asarray(ji)).transpose(0, 2, 1)
    assert _rel([got], [jnat.reshape(batch, ell)]) < PAIR_TOL
    sr, si = fourstep_streaming(xr.reshape(batch, a, b),
                                xi.reshape(batch, a, b), *planes)
    assert sr.shape == (batch, b, a)
    assert all(torch.equal(u, v) for u, v in zip(
        (sr, si), fourstep_streaming_body(xr.reshape(batch, a, b),
                                          xi.reshape(batch, a, b),
                                          *planes)))


def test_streaming_variant_routing(monkeypatch):
    """The degenerate-split rule comes first: a near-prime L takes the
    platform FFT, the streaming kernel is not called."""
    calls = []
    real = tops.fourstep_streaming
    monkeypatch.setattr(tops, "fourstep_streaming",
                        lambda *a: (calls.append(1), real(*a))[1])
    assert "streaming" in tops._VARIANTS
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((2, 4099)),
                        dtype=torch.float32)
    outr, outi = tops.fourstep_planar(x, x, variant="streaming")
    assert calls == []
    truth = np.fft.fft(x.numpy().astype(np.float64) * (1 + 1j), axis=-1)
    assert _rel([(outr + 1j * outi).numpy()], [truth]) < PAIR_TOL
    tops.fourstep_planar(x[:, :64], x[:, :64], variant="streaming",
                         factors=(4, 16))
    assert calls == [1]
    with pytest.raises(ValueError, match="inconsistent"):
        fourstep_streaming(torch.zeros(2, 4, 8), torch.zeros(2, 4, 8),
                           *tops._fourstep_planes(4, 4, CPU))


# ------------------------------------------------- the column FFT's schedule
# A sweep of the column FFT (csrc/fft_cols.cuh): small and mixed radices,
# a prime past the unrolled ones (97), 384 and 512, and the largest prime
# and power-of-two A the streaming four-step admits (4093, 4096)
COL_FFT_A = [2, 3, 12, 60, 97, 384, 512, 4093, 4096]


def _table(twr, twi):
    return np.asarray(twr, np.float64) + 1j * np.asarray(twi, np.float64)


def _fft_cols_model(x, n, ld, twr, twi, w=None, g=1, trans=False,
                    dense=False):
    """The column FFT kernel's schedule in numpy, index for index, on
    (batch, n*ld) rows of (n, ld) matrices: per tile of TC =
    fft_cols_tile(n, ld) columns (col0 = tile*TC; columns past ld dead,
    loaded as zero), word a*TC + t holds x[a*ld + col0 + t]; each pass of
    radix R (ns the product of the radices before it, m = n/R) takes
    butterfly j of column col from words (j + r*m)*TC + col, as
    _stockham_model does a row, and writes point (j - j % ns)*R + j % ns
    + c*ns; the last pass multiplies point p of live column col by
    w[p][(col0 + col) // g].  Then the store: transposed (flat
    out[(col0 + t)*n + c]) or de-interleaved (column col = b*g + i to
    flat out[(c*g + i)*(ld//g) + b]).  complex128 on the given table."""
    batch = x.shape[0]
    tab = _table(twr, twi)
    tc = fft_cols_tile(n, ld)
    lg = tc.bit_length() - 1
    tiles = -(-ld // tc)
    col0 = np.arange(tiles) * tc
    pts, cols = np.arange(n), np.arange(tc)
    gcol = col0[:, None, None] + cols[None, None, :]       # (tiles, 1, tc)
    live = np.broadcast_to(gcol < ld, (tiles, n, tc))
    words = ((pts[:, None] << lg) + cols[None, :]).ravel()
    src = np.zeros((batch, tiles, n * tc), np.complex128)
    gather = np.where(live, pts[None, :, None] * ld + gcol, 0)
    src[:, :, words] = np.where(live, x[:, gather], 0).reshape(
        batch, tiles, -1)
    wmul = None
    if w is not None:
        # w at (point, tile, column), 1 on dead columns
        wmul = np.where(live, w[pts[None, :, None],
                                np.minimum(gcol, ld - 1) // g], 1)
        wmul = wmul.transpose(1, 0, 2)                     # (n, tiles, tc)
    plan = fft_rows_plan(n)
    if not plan and wmul is not None:
        src = src * wmul[0][None]
    ns = 1
    for step, radix in enumerate(plan):
        m, unit = n // radix, n // (ns * radix)
        j = np.arange(m)
        k = j % ns
        r = np.arange(radix)
        rd = ((j[None, :, None] + m * r[:, None, None]) << lg) + cols
        v = src[:, :, rd] * tab[r[:, None] * k[None, :] * unit][
            None, None, :, :, None]                         # (z, T, R, m, tc)
        if radix in UNROLLED and not dense:
            cw = tab[(np.outer(r, r) % radix) * m]          # [r, c]
            y = np.einsum("ztrjc,rq->ztqjc", v, cw)
        else:
            y = np.empty_like(v)
            for h in range(radix // 2 + 1):
                t = tab[(r * h * m) % n][None, None, :, None, None]
                y[:, :, h] = (v * t).sum(2)
                if h and 2 * h != radix:
                    y[:, :, radix - h] = (v * np.conj(t)).sum(2)
        point = ((j - k) * radix + k)[None, :] + ns * r[:, None]  # (R, m)
        if step + 1 == len(plan) and wmul is not None:
            y = y * wmul[point].transpose(2, 0, 1, 3)[None]
        dst = np.empty_like(src)
        dst[:, :, (point[:, :, None] << lg) + cols] = y
        src = dst
        ns *= radix
    buf = src.reshape(batch, tiles, n, tc)[:, live]        # (z, live words)
    ti, ci, ki = np.nonzero(live)                          # tile, point, col
    col = col0[ti] + ki
    out = np.empty((batch, n * ld), np.complex128)
    if trans:
        out[:, col * n + ci] = buf
    else:
        bb, ii = col // g, col % g
        out[:, (ci * g + ii) * (ld // g) + bb] = buf
    return out


def _column_fft(x, n, ld, w=None, g=1):
    """The reference: np.fft down the columns, times w[c][col // g]."""
    y = np.fft.fft(x.reshape(-1, n, ld), axis=1)
    if w is not None:
        y = y * w[:, np.arange(ld) // g][None]
    return y


@pytest.mark.parametrize("a", COL_FFT_A)
def test_fft_cols_schedule_and_store_maps_match_numpy(a):
    """The column FFT's schedule on its radix plan and table, over ragged
    tiles: np.fft down the columns to float64 rounding on a float64 table
    (unrolled and dense index maths both) and to f32 twiddle rounding on
    the kernel's own table; with the four-step twiddle, the transposed
    store and the de-interleaved one for m in (1, 3, 4, 16)."""
    b = 2 if a > 512 else 5
    rng = np.random.default_rng(a)
    tab64 = np.cos(-2 * np.pi * np.arange(a) / a), np.sin(
        -2 * np.pi * np.arange(a) / a)
    x = _crand(rng, 1 if a > 512 else 2, a * 3 * b)
    want = _column_fft(x, a, 3 * b).reshape(len(x), -1)
    for dense in (False, True) if a <= 512 else (False,):
        got = _fft_cols_model(x, a, 3 * b, *tab64, dense=dense)
        assert _rel([got], [want]) < 1e-12, dense
    got = _fft_cols_model(x, a, 3 * b, *fft_rows_twiddles(a))
    assert _rel([got], [want]) < 1e-6
    wr, wi = tops._twiddle_planes(a, b)
    w = _table(wr, wi)
    xt = x[:, :a * b]
    got = _fft_cols_model(xt, a, b, *fft_rows_twiddles(a), w=w, trans=True)
    want = _column_fft(xt, a, b, w).transpose(0, 2, 1)
    assert _rel([got], [want.reshape(len(x), -1)]) < 1e-6
    for m in (1, 3, 4, 16):
        xm = _crand(rng, len(x), a * b * m)
        got = _fft_cols_model(xm, a, b * m, *fft_rows_twiddles(a), w=w,
                              g=m)
        want = _column_fft(xm, a, b * m, w, g=m).reshape(len(x), a, b, m)
        assert _rel([got], [want.transpose(0, 1, 3, 2).reshape(
            len(x), -1)]) < 1e-6, m


# (A, B) of the streaming four-step: both passes' tiles ragged or whole,
# and a one-point pass (no butterfly: W applied on its own)
STREAM_FOURSTEP = [(1, 5), (5, 1), (2, 3), (3, 2), (12, 60), (60, 12),
                   (97, 4), (384, 3), (512, 2), (4093, 2), (4096, 2)]


@pytest.mark.parametrize("a,b", STREAM_FOURSTEP)
def test_streaming_fourstep_schedule_matches_body(a, b):
    """fourstep_streaming's two launches as the model runs them -- the
    A-point column FFT over x with W, stored transposed into T1^T
    (batch, B, A), then the B-point column FFT over T1^T stored in place
    -- are np.fft in natural order, and (A <= 512, where the dense F_A
    plane is small) fourstep_streaming_body on the same f32 planes."""
    rng = np.random.default_rng(a * b)
    batch = 2
    x = _crand(rng, batch, a * b, dtype=np.complex64)
    wr, wi = tops._twiddle_planes(a, b)
    t1 = _fft_cols_model(x, a, b, *fft_rows_twiddles(a), w=_table(wr, wi),
                         trans=True)
    got = _fft_cols_model(t1, b, a, *fft_rows_twiddles(b))
    truth = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert _rel([got], [truth]) < 1e-6
    if a <= 512:
        xr, xi = _t(x.real.reshape(batch, a, b), x.imag.reshape(batch, a, b))
        br, bi = fourstep_streaming_body(xr, xi,
                                         *tops._fourstep_planes(a, b, CPU))
        assert _rel([got], [(br + 1j * bi).reshape(batch, -1).numpy()]) \
            < PAIR_TOL


# (s, m, N) of the streaming bucket: the GPU tests' shapes, m not
# dividing the tile width among them
STREAM_BUCKETS = [(96, 3, 7), (768, 4, 6), (2048, 4, 8), (3 * 4096, 3, 7),
                  (16384, 4, 8), (32768, 16, 32)]


@pytest.mark.parametrize("s,m,n", STREAM_BUCKETS)
def test_streaming_bucket_schedule_matches_body(s, m, n):
    """The streaming bucket's phases as the kernels index them: phase 1,
    the A-point column FFT over the request's (A, B*m) view with W by
    column // m and the de-interleaved store, is stage1_body of the m
    interleaved shards in t1's (A, m, B) layout; phase 2, the row FFT of
    t1's A*m B-point rows (_stockham_model), is stage2_body there, so z
    holds Z_i[c][d] at (c*m + i)*B + d; and phase 3 reading z at that
    index (encode, decode, the pre-scrambled twiddle at c*B + d, the
    m-point DFT, out[j*L + c + d*A]) gives bucket_body's output."""
    q = 2
    a, b = tops.split_factor(s // m)
    ell = a * b
    rng = np.random.default_rng(s + m)
    x = _crand(rng, q, s, dtype=np.complex64)
    far, fai, wr, wi, fbr, fbi, twr, twi, fmr, fmi = tops._bucket_planes(
        s, m, CPU)
    t1 = _fft_cols_model(x, a, b * m, *fft_rows_twiddles(a),
                         w=_table(wr, wi), g=m).reshape(q, a, m, b)
    shards = _t(*(p.reshape(q, ell, m).transpose(0, 2, 1).reshape(
        q * m, a, b) for p in (x.real, x.imag)))
    s1r, s1i = stage1_body(*shards, far, fai, wr, wi)
    want = (s1r + 1j * s1i).numpy().reshape(q, m, a, b).transpose(0, 2, 1, 3)
    assert _rel([t1], [want]) < 1e-5
    z = _stockham_model(t1.reshape(-1, b), fft_rows_plan(b),
                        *fft_rows_twiddles(b)).reshape(q, a, m, b)
    s2r, s2i = stage2_body(*_t(want.real.astype(np.float32).reshape(q, -1, b),
                               want.imag.astype(np.float32).reshape(q, -1, b)),
                           fbr, fbi)
    assert _rel([z], [(s2r + 1j * s2i).numpy().reshape(q, a, m, b)]) < 1e-5
    masks = (adversarial_masks(n, m)[:q] if m <= 4 else
             np.stack([np.roll(np.arange(n) % (n // m) == 0, i)
                       for i in range(q)]))
    _, _, dr, di = tcp.lagrange_planes_body(
        tcp.mask_subsets(torch.as_tensor(masks), m), n)
    d = (dr + 1j * di).numpy().astype(np.complex128)          # (q, m, n)
    g = tmds.rs_generator(n, m, torch.complex128, CPU).numpy()
    tw = _table(twr, twi)
    fm = _table(fmr, fmi)
    c, dd = np.meshgrid(np.arange(a), np.arange(b), indexing="ij")
    t = z.transpose(0, 2, 1, 3)                          # [q, i, c, d]
    assert np.array_equal(t[:, :, c, dd].ravel(), z.reshape(q, -1)[
        :, ((c[None] * m + np.arange(m)[:, None, None]) * b
            + dd[None])].ravel())
    h = np.einsum("qjr,ri,qicd->qjcd", d, g, t)
    h = h * tw.reshape(m, a, b)[None]                    # tw[j][c*B + d]
    o = np.einsum("pj,qjcd->qpcd", fm, h)
    out = np.empty((q, s), np.complex128)
    out[:, (np.arange(m)[:, None, None] * ell + c + dd * a).ravel()] = \
        o.reshape(q, -1)
    xr, xi = _t(x.real, x.imag)
    plain = tcp.bucket_body(xr, xi, dr, di, *_t(g.real.astype(np.float32),
                                                g.imag.astype(np.float32)),
                            far, fai, wr, wi, fbr, fbi, twr, twi, fmr, fmi)
    assert _rel([out], [(plain[0] + 1j * plain[1]).numpy()]) < PAIR_TOL
    full = masks.sum(axis=1) >= m
    truth = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert _rel([out[full]], [truth[full]]) < TRUTH_TOL


# (batch, A, B) of fourstep_stage1's column FFT: A = 1 (no pass: W
# alone), a prime A (61: the dense pass), the mixed radix 384, A = 8 over
# a prime B (256-column tiles, the last ragged) and A = 4096 (TC = 1)
STAGE1_MODEL = [(3, 1, 5), (2, 61, 67), (1, 384, 24), (2, 8, 4093),
                (1, 4096, 2)]


@pytest.mark.parametrize("batch,a,b", STAGE1_MODEL)
def test_stage1_column_fft_matches_body(batch, a, b):
    """fourstep_stage1's one launch as the model runs it -- the A-point
    column FFT over the batch's (A, B) matrices, ld = B, W in the last
    pass and the plain store (g = 1: point c of column d to word
    c*B + d) -- is stage1_body on the same f32 planes, and np.fft down
    the columns times W."""
    rng = np.random.default_rng(a * b + batch)
    x = _crand(rng, batch, a * b, dtype=np.complex64)
    wr, wi = tops._twiddle_planes(a, b)
    got = _fft_cols_model(x, a, b, *fft_rows_twiddles(a), w=_table(wr, wi))
    want = _column_fft(x, a, b, _table(wr, wi)).reshape(batch, -1)
    assert _rel([got], [want]) < 1e-6
    if a <= 512:
        xr, xi = _t(x.real.reshape(batch, a, b), x.imag.reshape(batch, a, b))
        far, fai, wr_, wi_, _, _ = tops._fourstep_planes(a, b, CPU)
        s1r, s1i = stage1_body(xr, xi, far, fai, wr_, wi_)
        assert _rel([got], [(s1r + 1j * s1i).reshape(batch, -1).numpy()]) \
            < PAIR_TOL


def _encode_rows_model(t1, g, m, a, b):
    """The folded encode's launch 2 in numpy, address for address, on the
    flat t1 (q, m, A, B): block (q, tile) takes C =
    encode_rows_per_block(m, a, b) rows c from c0 = tile*C; word
    i*C*B + w of its buffer holds t1 at (q*m + i)*A*B + c0*B + w for w
    under the live rows' C'*B (C' = min(C, A - c0)), zero past them; the
    row FFT's schedule (_stockham_model) runs on the m*C rows of B; the
    store writes sum_i G[k, i] * word i*C*B + w to out (q, N, A, B) at
    (q*N + k)*A*B + c0*B + w for w < C'*B.  Asserts every output is
    written once."""
    n = g.shape[0]
    flat = t1.reshape(-1)
    q = flat.size // (m * a * b)
    cb = encode_rows_per_block(m, a, b)
    out = np.zeros(q * n * a * b, np.complex128)
    hits = np.zeros(out.size, int)
    i = np.arange(m)[:, None]
    w = np.arange(cb * b)[None, :]
    k = np.arange(n)[:, None]
    for qq in range(q):
        for c0 in range(0, a, cb):
            live = min(cb, a - c0) * b
            src = (qq * m + i) * a * b + c0 * b + np.minimum(w, live - 1)
            buf = np.where(w < live, flat[src], 0)           # (m, C*B)
            z = _stockham_model(buf.reshape(m * cb, b), fft_rows_plan(b),
                                *fft_rows_twiddles(b)).reshape(m, cb * b)
            dst = (qq * n + k) * a * b + c0 * b + w[:, :live]
            out[dst] = (g @ z)[:, :live]
            hits[dst] += 1
    assert (hits == 1).all()
    return out


# (q, m, N, A, B) of the encode: the row block's C = 1 (m*B = 2048), 2
# with A ragged (m = 3, B = 384: C*m*B = 2304), 16 and 64 rows c (A = 1:
# C capped at A), a prime A and B, m = 16 folded (B = 8) and past the
# fold (B = 512), and m = 64 as the host path's stage route gives it
ENCODE_MODEL = [(1, 4, 8, 3, 512), (2, 3, 7, 5, 384), (2, 4, 8, 16, 32),
                (2, 4, 8, 1, 31), (2, 4, 8, 61, 67), (2, 16, 32, 8, 8),
                (1, 16, 32, 2, 512), (1, 64, 128, 8, 8)]


@pytest.mark.parametrize("q,m,n,a,b", ENCODE_MODEL)
def test_encode_schedule_matches_body(q, m, n, a, b):
    """The encode's launches as the kernels index them: launch 1, the
    A-point column FFT of the q*m shards (ld = B, W in the last pass, the
    g = 1 store), is stage1_body of every shard; then, on the fold
    (_encode_rows_model: the row block's m source runs at stride A*B,
    the row FFT, G in the store at out[q, k, c, d]) -- or past it the row
    FFT of every row and the G apply --, encode_fourstep_body on the same
    f32 planes (PAIR_TOL) and np.fft of the coded shards G @ c."""
    rng = np.random.default_rng(q * m * a * b)
    c = _crand(rng, q * m, a * b, dtype=np.complex64)
    wr, wi = tops._twiddle_planes(a, b)
    t1 = _fft_cols_model(c, a, b, *fft_rows_twiddles(a), w=_table(wr, wi))
    cr, ci = _t(c.real.reshape(q, m, a, b), c.imag.reshape(q, m, a, b))
    planes = tops._fourstep_planes(a, b, CPU)
    s1r, s1i = stage1_body(cr.reshape(-1, a, b), ci.reshape(-1, a, b),
                           *planes[:4])
    assert _rel([t1], [(s1r + 1j * s1i).reshape(q * m, -1).numpy()]) \
        < PAIR_TOL
    g32 = tmds.rs_generator(n, m, torch.complex64, CPU)
    g = g32.numpy().astype(np.complex128)
    if encode_rows_fold(m, a, b):
        out = _encode_rows_model(t1, g, m, a, b)
    else:
        z = _stockham_model(t1.reshape(-1, b), fft_rows_plan(b),
                            *fft_rows_twiddles(b)).reshape(q, m, -1)
        out = np.einsum("km,qml->qkl", g, z).reshape(-1)
    br, bi = encode_fourstep_body(cr, ci, g32.real.contiguous(),
                                  g32.imag.contiguous(), *planes)
    assert _rel([out], [(br + 1j * bi).reshape(-1).numpy()]) < PAIR_TOL
    coded = np.einsum("km,qml->qkl", g, c.reshape(q, m, -1))
    truth = np.fft.fft(coded, axis=-1).reshape(q, n, b, a).transpose(
        0, 1, 3, 2)
    assert _rel([out], [truth.reshape(-1)]) < 1e-5


def test_encode_rows_layout_is_the_fold_gate():
    """The folded encode's working set, one reckoning: C = ceil(2048 /
    (m*B)) rows c a block, at most A; two buffers of m*C*B points and the
    table of B, each plane padded one word in 32.  The fold holds exactly
    where m*B <= 4096 points, and there the layout fits a block's shared
    memory, with room for two blocks an SM; the service's m = 4 at
    B = 512 (C = 1) and the m = 64 stage code at B = 8 (C = 4) fold, m = 16
    at B = 512 and m = 64 at B = 128 take the three-launch route."""
    for m in (1, 2, 3, 4, 8, 16, 64):
        for b in range(1, 4097):
            for a in (1, 3, 4096):
                cb = encode_rows_per_block(m, a, b)
                assert cb == min(a, max(1, -(-2048 // (m * b))))
                x, y, tab, total = encode_rows_layout(m, a, b)
                last = m * cb * b - 1
                assert x == 0 and y == tab - y
                assert y >= 2 * (last + last // 32 + 1)
                assert total - tab >= 2 * (b - 1 + (b - 1) // 32 + 1)
                fold = encode_rows_fold(m, a, b)
                assert fold == (m * b <= 4096), (m, a, b)
                if fold:
                    assert m * cb * b <= 4096
                    assert 2 * 4 * total <= 233_472    # the SM's 228 KB
    assert [encode_rows_per_block(m, 512, b) for m, b in
            ((4, 512), (64, 8), (3, 384))] == [1, 4, 2]
    assert encode_rows_fold(4, 512, 512) and encode_rows_fold(64, 8, 8)
    assert not encode_rows_fold(16, 512, 512)
    assert not encode_rows_fold(64, 4, 128)


def test_fft_cols_layout_fits_every_streaming_length():
    """The column FFT's working set, one reckoning: within a block's
    shared memory for every A (and B) up to 4096, which bounds both
    factors fourstep_route(variant="streaming") admits, at TC = 8 for A =
    512 and 384 and TC = 1 past 2048; the streaming bucket's column FFT
    of A over B*m columns and row FFT of B fit wherever
    coded_bucket_streamable admits (s, m, N); past 4096 the route takes
    the platform FFT, and at 16384 points the plan record -- what the
    wrapper launches with -- refuses."""
    for n in range(1, 4097):
        for ld in (1, 3, n, 1 << 20):
            tc = fft_cols_tile(n, ld)
            assert tc & (tc - 1) == 0 and 1 <= tc <= 256
            assert tc * n <= 4096 or tc == 1
            assert tc >= min(ld, 4096 // n, 256) or 2 * tc * n > 4096
            x, y, tab, total = fft_cols_layout(n, ld)
            last = tc * n - 1
            assert x == 0 and y == tab - y and y >= 2 * (last + last // 32
                                                         + 1)
            assert total - tab >= 2 * (n - 1 + (n - 1) // 32 + 1)
            assert 4 * total <= _build.SMEM_PER_BLOCK_OPTIN, (n, ld)
    assert [fft_cols_tile(n, n) for n in (512, 384, 4093, 4096)] == \
        [8, 8, 1, 1]
    for ell in (1 << 18, 4093 * 4, 384 * 384, 4096 * 4096):
        variant, (a, b) = tops.fourstep_route(ell, variant="streaming")
        assert variant == "streaming" and max(a, b) <= 4096
        fft_cols_spec("x", a, b)
        fft_cols_spec("x", b, a)
    assert tops.fourstep_route(4 * 16384, variant="streaming",
                               factors=(16384, 4)) == ("xla", None)
    for s, m, n in STREAM_BUCKETS + [(1 << 20, 4, 8), (1 << 20, 32, 64)]:
        if tops.coded_bucket_streamable(s, m, n):
            a, b = tops.split_factor(s // m)
            assert fft_cols_spec("x", a, b * m).n == a
            assert fft_rows_spec("x", b).n == b
    with pytest.raises(ValueError, match="shared memory"):
        fft_cols_spec("fourstep_streaming", 16384, 4)
    with pytest.raises(ValueError, match="shared memory"):
        fft_rows_spec("coded_fft_bucket_streaming", 16384)


# ------------------------------------------------------------- refusals
def test_service_refuses_stage_codes_at_construction():
    """A code whose cfg.s bucket takes the stage route with N*m > 29,056
    is refused when the service is built, on the device-decode path too,
    naming the ROADMAP item; the reference backend serves it."""
    for kwargs in ({"s": 1 << 15, "m": 32, "n_workers": 1024},
                   {"s": 1 << 15, "m": 32, "n_workers": 1024,
                    "device_decode": False}):
        with pytest.raises(NotImplementedError,
                           match="Queue 2 item 7") as err:
            FFTService(FFTServiceConfig(**kwargs), device="cpu")
        assert "N=1024" in str(err.value) and "ROADMAP.md" in str(err.value)
        svc = FFTService(FFTServiceConfig(**kwargs, use_reference=True),
                         device="cpu")
        assert svc.plan.resolved_backend == "reference"


def test_service_serves_a_fusing_length_and_refuses_a_longer_one():
    """m=32, N=1024 at s=4096: the masked bucket stages only the subset's
    m rows, so the bucket fuses and serves; a 2^15-point c2c request of
    the same service would take the stage route and is refused in
    bucket_key, before the straggler draw."""
    s, m, n = 4096, 32, 1024
    assert tops.coded_bucket_fusable(s, m, n)
    svc = FFTService(FFTServiceConfig(s=s, m=m, n_workers=n), device="cpu")
    q = 2
    x = _crand(np.random.default_rng(4), q, s, dtype=np.complex64)
    # evenly spread responders (the 32nd roots of unity): condition 1
    spread = np.stack([np.roll(np.arange(n) % (n // m) == 0, i)
                       for i in range(q)])
    bucket, args = svc.stage_bucket(s, "c2c", list(x), masks=spread)
    out = svc.launch_bucket(s, bucket, "c2c", args).numpy()
    assert _rel([out[:q]], [np.fft.fft(x.astype(np.complex128),
                                       axis=-1)]) < TRUTH_TOL
    state = svc.rng.bit_generator.state
    batches = svc.stats.batches
    with pytest.raises(NotImplementedError, match="Queue 2 item 7"):
        svc.submit_batch([np.zeros(1 << 15, np.complex64)])
    with pytest.raises(NotImplementedError, match="Queue 2 item 7"):
        svc.stage_bucket(1 << 15, "c2c", [np.zeros(1 << 15, np.complex64)])
    assert svc.rng.bit_generator.state == state
    assert svc.stats.batches == batches


@pytest.mark.parametrize("cls", [CodedFFT, CodedRFFT, CodedIFFT,
                                 CodedIRFFT])
def test_kernel_plans_refuse_codes_mds_apply_cannot_hold(cls):
    with pytest.raises(NotImplementedError, match="Queue 2 item 7") as err:
        cls(s=2048, m=32, n_workers=1024, device="cpu")
    assert "mds_apply" in str(err.value) and "N=1024" in str(err.value)
    assert cls(s=2048, m=32, n_workers=1024, device="cpu",
               backend="reference").resolved_backend == "reference"
    assert cls(s=2048, m=32, n_workers=1024, device="cpu",
               dtype=torch.complex128).resolved_backend == "reference"
    cls(s=2048, m=32, n_workers=908, device="cpu")       # N*m = 29,056


@pytest.mark.parametrize("s,m,n,kind,masked,route", [
    (4096, 4, 8, "c2c", True, "fused"),
    (16384, 4, 8, "c2c", True, "streaming"),
    (1 << 20, 4, 8, "c2c", False, "streaming"),
    (1 << 21, 4, 8, "c2c", True, "stage"),
    (4096, 64, 128, "c2c", False, "stage"),
    (4096, 4, 8, "r2c", True, "fused"),
    (1 << 20, 4, 8, "r2c", True, "stage"),
    (1 << 20, 4, 8, "c2r", False, "stage"),
])
def test_bucket_route_is_the_gates(s, m, n, kind, masked, route):
    """ops.bucket_route: the kind's whole-bucket gate, then (c2c only)
    the streaming gate, else the stage kernels."""
    gate = {"c2c": tops.coded_bucket_fusable,
            "r2c": tops.coded_rbucket_fusable,
            "c2r": tops.coded_irbucket_fusable}[kind]
    assert gate(s, m, n, masked=masked) == (route == "fused")
    assert (route == "streaming") == (
        not gate(s, m, n, masked=masked) and kind == "c2c"
        and tops.coded_bucket_streamable(s, m, n))
    assert tops.bucket_route(s, m, n, kind, masked=masked) == route


def test_check_stage_code_is_the_kernels_bound():
    tops.check_stage_code(908, 32, "x")
    with pytest.raises(NotImplementedError, match="N=909, m=32"):
        tops.check_stage_code(909, 32, "x")
    tops.check_stage_code(130, 65, "x")
    with pytest.raises(NotImplementedError, match="m=65"):
        tops.check_stage_code(130, 65, "x", recombine=True)


# ------------------------------------------------------------------ gpu
@pytest.mark.gpu
@pytest.mark.parametrize("s,m,n", STREAM_SHAPES + [(3 * 4096, 3, 7),
                                                   (32 * 1024, 32, 64)])
def test_gpu_streaming_masked_bucket_matches_plain(cuda, s, m, n):
    """The masked streaming bucket kernel (four launches) against its
    plain twin on the card, short rows (fewer than m responders, filled
    with the first non-responders) included, and (narrow codes' full
    rows, or evenly spread responders) against numpy."""
    if m <= 4:
        masks = adversarial_masks(n, m)
        full = masks.sum(axis=1) >= m
        masks = np.concatenate([masks[full][:4], masks[~full]])
    else:
        masks = np.stack([np.roll(np.arange(n) % (n // m) == 0, i)
                          for i in range(3)])
    q = len(masks)
    x = _crand(np.random.default_rng(s + m), q, s, dtype=np.complex64)
    xr, xi = _t(x.real, x.imag, device=cuda)
    g = tmds.rs_generator(n, m, torch.complex64, cuda)
    gr, gi = g.real.contiguous(), g.imag.contiguous()
    mk = torch.as_tensor(masks, device=cuda)
    planes = tops._bucket_planes(s, m, cuda)
    before = _build.launch_counts().get("coded_fft_bucket_streaming_masked",
                                        0)
    got = tcp.coded_fft_bucket_streaming_masked(xr, xi, mk, gr, gi, *planes)
    torch.cuda.synchronize()
    assert (_build.launch_counts()["coded_fft_bucket_streaming_masked"]
            == before + 4)
    plain = tcp.bucket_body_masked(xr, xi, mk, gr, gi, *planes)
    got = [o.cpu() for o in got]
    assert _rel(got, [p.cpu() for p in plain]) < PAIR_TOL
    full = masks.sum(axis=1) >= m
    assert full.sum() >= 3 and (m > 4 or (~full).sum() == 2)
    truth = np.fft.fft(x.astype(np.complex128), axis=-1)[full]
    assert _rel([o[torch.as_tensor(full)] for o in got],
                [truth.real, truth.imag]) < TRUTH_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("batch,a,b", [(3, 64, 128), (2, 100, 37),
                                       (4, 512, 512), (2, 384, 384),
                                       (2, 4093, 4), (1, 4096, 4),
                                       (1, 4, 4096), (2, 1, 64),
                                       (2, 64, 1)])
def test_gpu_fourstep_streaming_matches_plain(cuda, batch, a, b):
    """The streaming four-step (two launches of the column FFT) against
    its plain twin and numpy: mixed radices, a prime A (one dense pass),
    A = 4096 (one column a tile), B = 4096, and one-point passes."""
    x = _crand(np.random.default_rng(a + b), batch, a * b,
               dtype=np.complex64)
    xr, xi = _t(x.real.reshape(batch, a, b), x.imag.reshape(batch, a, b),
                device=cuda)
    planes = tops._fourstep_planes(a, b, cuda)
    before = _build.launch_counts().get("fourstep_streaming", 0)
    got = fourstep_streaming(xr, xi, *planes)
    torch.cuda.synchronize()
    assert _build.launch_counts()["fourstep_streaming"] == before + 2
    plain = fourstep_streaming_body(xr, xi, *planes)
    got = [o.cpu() for o in got]
    assert got[0].shape == (batch, b, a)
    assert _rel(got, [p.cpu() for p in plain]) < PAIR_TOL
    truth = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert _rel([(got[0] + 1j * got[1]).reshape(batch, a * b).numpy()],
                [truth]) < PAIR_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("s,m", [(1 << 16, 4), (64 * 96, 64)])
def test_gpu_recombine_single_matches_plain(cuda, s, m):
    ell = s // m
    rng = np.random.default_rng(s + m)
    args = _t(rng.standard_normal((m, ell)).astype(np.float32),
              rng.standard_normal((m, ell)).astype(np.float32),
              *tops._recombine_planes(s, m), device=cuda)
    before = _build.launch_counts().get("recombine_twiddle_dft", 0)
    got = recombine_twiddle_dft(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts()["recombine_twiddle_dft"] == before + 1
    want = recombine_body(*args)
    assert _rel([o.cpu() for o in got], [w.cpu() for w in want]) \
        < RECOMBINE_TOL
    x = _crand(rng, s, dtype=np.complex64)
    c_hat = torch.fft.fft(interleave(torch.as_tensor(x, device=cuda), m),
                          dim=-1)
    _build.reset_launch_counts()
    out = tops.recombine_fused(c_hat, s)
    assert _build.launch_counts() == {"recombine_twiddle_dft": 1}
    assert _rel([out.cpu().numpy()],
                [np.fft.fft(x.astype(np.complex128))]) < PAIR_TOL


@pytest.mark.gpu
def test_gpu_device_service_streams_past_the_gate(cuda):
    """A default-config c2c bucket at s=2^15: exactly the masked streaming
    kernel's four launches, within 1e-3 of numpy."""
    s = 1 << 15
    svc = FFTService(FFTServiceConfig(s=s))
    assert not tops.coded_bucket_fusable(s, 4, 8)
    xs, kinds, want = _requests([("c2c", s)] * 4, seed=8)
    _build.reset_launch_counts()
    out = svc.submit_batch(xs, kind=kinds)
    assert _build.launch_counts() == {"coded_fft_bucket_streaming_masked": 4}
    assert max(_rel([o], [w]) for o, w in zip(out, want)) < TRUTH_TOL
