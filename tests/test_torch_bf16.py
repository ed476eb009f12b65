"""bf16 planes: the port's ``precision="bf16"`` against the JAX package.

``precision="bf16"`` builds the constant planes -- DFT, twiddle,
recombine, split and message planes -- in bfloat16 while the payload, G
and the decode stay f32 and every product accumulates in f32.  The
service resolves it per ``(s, m, kind)`` with a probe whose verdict the
autotune table keeps.

CPU tests: the same numpy inputs, made from a seed, go through both
packages.  Stated tolerances:

* the bf16 planes of every plane table equal the reference's bit for bit;
* each bucket op and ``fourstep_planar`` at ``precision="bf16"`` (the
  plain twins on the planes widened to f32) against the JAX op run as
  its own tests run it (Pallas interpret mode; direct mode for the
  streaming bucket at s=16384, which jax cannot trace in interpret
  mode): within 2e-5 of the largest magnitude of the numpy truth; each
  within ``ops.BF16_RTOL`` of ``numpy.fft``; each different from its own
  f32 output;
* bf16 services against same-seed JAX services (c2c, r2c, c2r, both
  decode paths, a fault plan, the streaming front-end): the same
  verdicts, rng states, counters and LRU counts, outputs within
  ``BF16_RTOL`` of numpy.

GPU tests (marker ``gpu``, skipped without a CUDA device): each bf16
kernel entry against its plain twin and complex128 ``torch.fft`` within
``BF16_RTOL``, launched and counted under its ``[bf16]`` name, and
different from its f32 entry.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_kernels import private_autotune_table  # noqa: F401

from repro_torch.convert import config_from_reference, generator_from_reference
from repro_torch.core import mds as tmds
from repro_torch.kernels import _build, autotune
from repro_torch.kernels import ops as tops
from repro_torch.kernels.fourstep_fft import fft_twiddles_on
from repro_torch.serving import (
    DecodeMatrixCache,
    FFTService,
    FFTServiceConfig,
    StreamConfig,
    StreamingFFTService,
)

CPU = torch.device("cpu")
BF16 = torch.bfloat16
# tests/test_properties.py's bucket configs (s, m, N)
BF16_CONFIGS = [(64, 2, 5), (96, 3, 7), (256, 4, 8), (2048, 4, 8)]
# port against the JAX op, relative to the numpy truth's largest magnitude
PAIR_TOL = 2e-5
KINDS = ("c2c", "r2c", "c2r")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jref():
    jnp = pytest.importorskip("jax.numpy")
    from repro import distributed as jdist
    from repro import serving as jserving
    from repro.kernels import autotune as jautotune
    from repro.kernels import ops as jops

    return dict(jnp=jnp, ops=jops, autotune=jautotune, dist=jdist,
                serving=jserving)


@pytest.fixture
def jtable(jref, private_autotune_table):  # noqa: F811
    """Both packages' autotune tables private and empty (the JAX
    package's in-memory table too), restored afterwards."""
    jat = jref["autotune"]
    tables, loaded = dict(jat._TABLES), set(jat._LOADED)
    jat._TABLES.clear()
    jat._LOADED.clear()
    yield jat
    jat._TABLES.clear()
    jat._TABLES.update(tables)
    jat._LOADED.clear()
    jat._LOADED.update(loaded)


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


def _bits(a) -> np.ndarray:
    """A bf16 array's raw 16-bit patterns (either package's)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


# ------------------------------------------------------------- the planes
# (plane table, its shape arguments, the sign where one is passed)
_TABLES_CASES = [
    ("_dft_planes", (12,), None),
    ("_dft_planes", (64,), None),
    ("_dft_planes", (7,), 1.0),
    ("_twiddle_planes", (8, 12), None),
    ("_twiddle_planes", (32, 64), None),
    ("_recombine_planes", (2048, 4), None),
    ("_recombine_planes", (96, 3), 1.0),
    ("_half_dft_planes", (5,), None),
    ("_split_planes", (512,), None),
    ("_split_planes", (96,), 1.0),
    ("_r2c_postdecode_planes", (2048, 4), None),
    ("_c2r_message_planes", (96, 3), None),
    ("_recombine_planes_scrambled", (256, 4, 8, 8), None),
    ("_multistep_planes", ((16, 4, 4),), None),
]


@pytest.mark.parametrize("name,args,sign", _TABLES_CASES)
def test_bf16_planes_equal_reference(jref, name, args, sign):
    """Every plane table at bf16: the port's planes (its f32 values
    rounded to nearest even) are the reference's ``astype(bfloat16)``
    planes bit for bit."""
    tail = () if sign is None else (sign,)
    jt = getattr(jref["ops"], name)(*args, jref["jnp"].bfloat16, *tail)
    tt = tops._on_device(getattr(tops, name), (*args, np.float32, *tail),
                         CPU, BF16)
    assert len(tt) == len(jt)
    for t, j in zip(tt, jt):
        assert t.dtype == BF16 and t.shape == np.asarray(j).shape
        np.testing.assert_array_equal(_bits(t), _bits(j))


@pytest.mark.parametrize("a,b", [(8, 12), (32, 32), (1, 7), (16, 64)])
def test_bf16_tables_are_the_plane_entries(a, b):
    """The bf16 tables the cards' bf16 entries read: the L-point table
    holds every entry of F_A, W and F_B, the B-point table every entry of
    F_B, bit for bit (the tables and the planes round the same f32
    values)."""
    ell = a * b
    tr, ti = fft_twiddles_on(ell, CPU, BF16)
    tbr, tbi = fft_twiddles_on(b, CPU, BF16)
    far, fai, wr, wi, fbr, fbi = tops._fourstep_planes(a, b, CPU, BF16)
    ja, ka = np.meshgrid(np.arange(a), np.arange(a), indexing="ij")
    jb, kb = np.meshgrid(np.arange(b), np.arange(b), indexing="ij")
    c, d = np.meshgrid(np.arange(a), np.arange(b), indexing="ij")
    for plane, table, idx in (
            ((far, fai), (tr, ti), (b * ja * ka) % ell),
            ((wr, wi), (tr, ti), (c * d) % ell),
            ((fbr, fbi), (tr, ti), (a * jb * kb) % ell),
            ((fbr, fbi), (tbr, tbi), (jb * kb) % b)):
        for p, t in zip(plane, table):
            np.testing.assert_array_equal(_bits(p), _bits(t)[idx])


def test_plane_dtype_refuses_unknown_precision():
    assert tops._plane_dtype("bf16") == BF16
    assert tops._plane_dtype("f32") == tops._plane_dtype(None) == \
        torch.float32
    with pytest.raises(ValueError, match="unknown plane precision 'fp8'"):
        tops.coded_bucket_masked(*_t(np.zeros((1, 64), np.float32),
                                     np.zeros((1, 64), np.float32),
                                     np.ones((1, 5), bool)),
                                 *_gen(5, 2), 64, precision="fp8")
    assert tops.BF16_RTOL == 2e-2


# ---------------------------------------------------------------- the ops
def _gen(n, m):
    g = tmds.rs_generator(n, m, torch.complex64, CPU)
    return g.real.contiguous(), g.imag.contiguous()


def _bucket_case(kind, s, m, n, seed, q=3):
    """(request planes, masks, scatter decode planes, G planes, numpy
    truth) of one bucket of ``kind``: ``q`` requests, m random responders
    each."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((q, n), bool)
    for r in range(q):
        masks[r, rng.choice(n, size=m, replace=False)] = True
    x = rng.standard_normal((q, s))
    if kind == "c2c":
        xi = rng.standard_normal((q, s))
        data = (x.astype(np.float32), xi.astype(np.float32))
        want = [np.fft.fft(x + 1j * xi, axis=-1)]
    elif kind == "r2c":
        data = (x.astype(np.float32),)
        want = [np.fft.rfft(x, axis=-1)]
    else:
        y = np.fft.rfft(x, axis=-1)
        data = (y.real.astype(np.float32), y.imag.astype(np.float32))
        want = [np.fft.irfft(y, n=s, axis=-1)]
    gr, gi = _gen(n, m)
    d = DecodeMatrixCache(gr.numpy() + 1j * gi.numpy()).matrices(masks)
    dplanes = (d.real.astype(np.float32), d.imag.astype(np.float32))
    return data, masks, dplanes, (gr, gi), want


_OPS = {"c2c": ("coded_bucket_masked", "coded_bucket"),
        "r2c": ("coded_rbucket_masked", "coded_rbucket"),
        "c2r": ("coded_irbucket_masked", "coded_irbucket")}


def _outs(out):
    return [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
            for o in (out if isinstance(out, tuple) else (out,))]


def _complexify(planes):
    return [planes[0] + 1j * planes[1]] if len(planes) == 2 else planes


@pytest.mark.parametrize("kind,cfg", [
    *((kind, cfg) for kind in KINDS for cfg in BF16_CONFIGS),
    ("c2c", (16384, 4, 8))])
def test_bf16_buckets_match_reference(jref, kind, cfg):
    """Both bucket ops of ``kind`` at bf16 against the JAX op (interpret
    mode; direct mode for the c2c streaming bucket at s=16384), numpy and
    their own f32 runs."""
    s, m, n = cfg
    jnp, jops = jref["jnp"], jref["ops"]
    if s == 16384:
        assert tops.bucket_route(s, m, n, "c2c") == "streaming"
        assert tops.bucket_route(s, m, n, "c2c", masked=False) == \
            "streaming"
    data, masks, dplanes, (gr, gi), want = _bucket_case(
        kind, s, m, n, s, q=1 if s == 16384 else 3)
    itp = None if s == 16384 else True
    for op_name, decode in zip(_OPS[kind], ((masks,), dplanes)):
        port = getattr(tops, op_name)
        got = _outs(port(*_t(*data), *_t(*decode), gr, gi, s,
                         precision="bf16"))
        jgot = _outs(getattr(jops, op_name)(
            *map(jnp.asarray, data), *map(jnp.asarray, decode),
            jnp.asarray(gr.numpy()), jnp.asarray(gi.numpy()), s,
            interpret=itp, precision="bf16"))
        got_c, jgot_c = _complexify(got), _complexify(jgot)
        scale = max(np.abs(w).max() for w in want)
        assert max(np.abs(g - j).max() for g, j in zip(got_c, jgot_c)) \
            <= PAIR_TOL * scale, (op_name, cfg)
        assert _rel(got_c, want) < tops.BF16_RTOL, (op_name, cfg)
        f32 = _outs(port(*_t(*data), *_t(*decode), gr, gi, s))
        assert max(np.abs(a - b).max() for a, b in zip(got, f32)) > 0


_FOURSTEP_PLANS = {256: (16, 4, 4), 4096: (16, 16, 16)}


@pytest.mark.parametrize("ell", [256, 4096])
@pytest.mark.parametrize("variant", ["fused", "two_pass", "multistep"])
def test_bf16_fourstep_matches_reference(jref, ell, variant):
    """``fourstep_planar`` at bf16, fused, two-pass and a multistep plan,
    against the JAX op in interpret mode, numpy and its own f32 run."""
    jnp, jops = jref["jnp"], jref["ops"]
    rng = np.random.default_rng(ell)
    x = rng.standard_normal((2, ell)) + 1j * rng.standard_normal((2, ell))
    xr, xi = x.real.astype(np.float32), x.imag.astype(np.float32)
    want = [np.fft.fft(x, axis=-1)]
    kw = (dict(variant="fused", factors=_FOURSTEP_PLANS[ell])
          if variant == "multistep" else dict(variant=variant))
    got = _complexify(_outs(tops.fourstep_planar(
        *_t(xr, xi), precision="bf16", **kw)))
    jgot = _complexify(_outs(jops.fourstep_planar(
        jnp.asarray(xr), jnp.asarray(xi), interpret=True, precision="bf16",
        **kw)))
    scale = np.abs(want[0]).max()
    assert np.abs(got[0] - jgot[0]).max() <= PAIR_TOL * scale
    assert _rel(got, want) < tops.BF16_RTOL
    f32 = _complexify(_outs(tops.fourstep_planar(*_t(xr, xi), **kw)))
    assert np.abs(got[0] - f32[0]).max() > 0


def test_bf16_streaming_fourstep_and_stage2_precision():
    """The streaming variant and ``fourstep_stage2``'s table precision:
    bf16 within the budget and different from f32; an unknown precision
    raises."""
    from repro_torch.kernels.fourstep_fft import fourstep_stage2
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1024)) + 1j * rng.standard_normal((2, 1024))
    xr, xi = _t(x.real.astype(np.float32), x.imag.astype(np.float32))
    got = tops.fourstep_planar(xr, xi, variant="streaming",
                               precision="bf16")
    f32 = tops.fourstep_planar(xr, xi, variant="streaming")
    want = np.fft.fft(x, axis=-1)
    assert _rel([got[0].numpy() + 1j * got[1].numpy()], [want]) < \
        tops.BF16_RTOL
    assert (got[0] - f32[0]).abs().max() > 0
    t = xr.reshape(2, 32, 32)
    assert (fourstep_stage2(t, t, precision="bf16")[0]
            - fourstep_stage2(t, t)[0]).abs().max() > 0
    with pytest.raises(ValueError, match="unknown plane precision"):
        fourstep_stage2(t, t, precision="fp8")


# ------------------------------------------------------------ the service
def test_bf16_probe_auto_disables_per_shape(jtable, monkeypatch):
    """The reference's auto-disable test: a failing probe records
    ``{"ok": False}`` and the runner stays f32; the verdict is sticky."""
    svc = FFTService(FFTServiceConfig(s=64, m=2, n_workers=4,
                                      precision="bf16", autotune=False),
                     device="cpu")
    monkeypatch.setattr(FFTService, "_probe_bf16",
                        lambda self, s, kind: False)
    assert svc._precision_for(64, "c2c") == "f32"
    assert autotune.lookup("bf16", backend="cpu", s=64, m=2, k="c2c",
                           mode="plain") == {"ok": False}
    monkeypatch.setattr(FFTService, "_probe_bf16",
                        lambda self, s, kind: True)
    assert svc._precision_for(64, "c2c") == "f32"
    assert svc._precision_for(128, "c2c") == "bf16"


def test_bf16_probe_propagates_errors_and_skips_the_stage_route(
        jtable, monkeypatch):
    """The port's two deliberate differences: a probe that raises (a bf16
    kernel that fails to build or launch) propagates and records
    nothing; a bucket on the stage route resolves to f32 with no probe
    and no verdict.  An f32 service and the n-D kinds never probe."""
    svc = FFTService(FFTServiceConfig(s=256, m=4, n_workers=8,
                                      precision="bf16", autotune=False),
                     device="cpu")

    def broken(*args, precision="f32"):
        if precision == "bf16":
            raise RuntimeError("bf16 entry failed at launch")
        return real(*args, precision=precision)

    real = tops.coded_bucket_masked
    monkeypatch.setattr(tops, "coded_bucket_masked", broken)
    with pytest.raises(RuntimeError, match="failed at launch"):
        svc._precision_for(256, "c2c")
    assert autotune.lookup("bf16", backend="cpu", s=256, m=4, k="c2c",
                           mode="plain") is None
    probed = []
    monkeypatch.setattr(FFTService, "_probe_bf16",
                        lambda self, s, kind: probed.append(s) or True)
    assert svc._route(1 << 20, "r2c") == "stage"
    assert svc._precision_for(1 << 20, "r2c") == "f32"
    assert svc._precision_for((16, 16), "rfftn") == "f32"
    f32 = FFTService(FFTServiceConfig(s=256, m=4, n_workers=8,
                                      autotune=False), device="cpu")
    assert f32._precision_for(256, "c2c") == "f32"
    assert probed == [] and autotune.load_table("cpu") == {}


def _twins(jref, **kw):
    js = jref["serving"]
    jkw = dict(s=256, m=4, n_workers=8, seed=3, autotune=False,
               precision="bf16", max_batch=8)
    jkw.update(kw)
    if "faults" in jkw:
        jd, plan = jref["dist"], jkw["faults"]
        jkw["faults"] = jd.FaultPlan(
            tuple(jd.WorkerFault(*dataclasses.astuple(f))
                  for f in plan.faults), plan.seed)
    jsvc = js.FFTService(js.FFTServiceConfig(**jkw))
    cfg = config_from_reference(
        {f.name: getattr(jsvc.cfg, f.name)
         for f in dataclasses.fields(jsvc.cfg)})
    tsvc = FFTService(cfg, device="cpu")
    tsvc.load_generator(*generator_from_reference(
        np.asarray(jsvc.plan.generator), CPU))
    return jsvc, tsvc


def _requests(kind, s, q, seed):
    rng = np.random.default_rng(seed)
    xs, want = [], []
    for _ in range(q):
        x = rng.standard_normal(s)
        if kind == "c2c":
            x = (x + 1j * rng.standard_normal(s)).astype(np.complex64)
            want.append(np.fft.fft(x.astype(np.complex128)))
        elif kind == "r2c":
            x = x.astype(np.float32)
            want.append(np.fft.rfft(x.astype(np.float64)))
        else:
            x = np.fft.rfft(x).astype(np.complex64)
            want.append(np.fft.irfft(x.astype(np.complex128), n=s))
        xs.append(x)
    return xs, want


_STATS = ("requests", "batches", "coded_latency", "uncoded_latency",
          "stragglers_tolerated", "decode_cache_hits", "decode_cache_misses",
          "retries", "redispatched_shards", "degraded", "host_transfers")


def _verdicts(table, mode):
    return {k.replace(f"mode={mode}", "mode=*"): v for k, v in table.items()
            if k.startswith("bf16|")}


def _assert_twins_agree(jat, jsvc, tsvc):
    for name in _STATS:
        assert getattr(tsvc.stats, name) == getattr(jsvc.stats, name), name
    assert tsvc.rng.bit_generator.state == jsvc.rng.bit_generator.state
    want = _verdicts(jat.load_table(), "direct")
    assert want and _verdicts(autotune.load_table("cpu"), "plain") == want


@pytest.mark.parametrize("device_decode", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_bf16_service_matches_reference(jref, jtable, kind, device_decode):
    """A bf16 service and a same-seed JAX service, two calls of one kind:
    the same verdict (probed once), rng states, counters and LRU counts;
    outputs within ``BF16_RTOL`` of numpy, and the port's different from
    its f32 service's (the bf16 entries served)."""
    jsvc, tsvc = _twins(jref, device_decode=device_decode)
    f32 = FFTService(dataclasses.replace(tsvc.cfg, precision="f32"),
                     device="cpu")
    f32.load_generator(*tsvc.generator_planes())
    s = 256
    for call in range(2):
        xs, want = _requests(kind, s, 5, seed=call)
        jout = jsvc.submit_batch(xs, kind=kind)
        tout = tsvc.submit_batch(xs, kind=kind)
        fout = f32.submit_batch(xs, kind=kind)
        for j, t, f, w in zip(jout, tout, fout, want):
            assert _rel([t], [w]) < tops.BF16_RTOL
            assert _rel([np.asarray(j)], [w]) < tops.BF16_RTOL
            assert np.abs(t - f).max() > 0
        _assert_twins_agree(jtable, jsvc, tsvc)
    assert len(_verdicts(autotune.load_table("cpu"), "plain")) == 1
    assert tsvc._precision_for(s, kind) == "bf16"


def test_bf16_service_fault_plan_matches_reference(jref, jtable):
    """A kill and a delay under ``health=True``: the deadline machine's
    rounds, retries and re-dispatches as the reference's, the bucket on
    the bf16 kernel."""
    from repro_torch.distributed import FaultPlan
    plan = FaultPlan(seed=2).kill(1, rounds=2).delay(5, 3.0, rounds=1)
    jsvc, tsvc = _twins(jref, faults=plan, health=True)
    xs, want = _requests("c2c", 256, 6, seed=9)
    for _ in range(2):
        jout = jsvc.submit_batch(xs)
        tout = tsvc.submit_batch(xs)
        for j, t, w in zip(jout, tout, want):
            assert _rel([t], [w]) < tops.BF16_RTOL
            assert _rel([np.asarray(j)], [w]) < tops.BF16_RTOL
        _assert_twins_agree(jtable, jsvc, tsvc)
    assert tsvc.health.summary() == jsvc.health.summary()
    assert tsvc._precision_for(256, "c2c") == "bf16"


def test_bf16_streaming_service_matches_reference(jref, jtable):
    """The open-loop front-end on a bf16 service: fills only, the same
    buckets, counters and verdicts as the reference's."""
    js = jref["serving"]
    jsvc, tsvc = _twins(jref, max_batch=4)
    xs, want = _requests("c2c", 256, 8, seed=4)
    with StreamingFFTService(tsvc, StreamConfig(slack_s=30.0)) as stream:
        futs = [stream.submit(x) for x in xs]
        outs = [f.result(timeout=120) for f in futs]
    with js.StreamingFFTService(jsvc, js.StreamConfig(slack_s=30.0)) as st:
        for f in [st.submit(x) for x in xs]:
            f.result(timeout=240)
    for t, w in zip(outs, want):
        assert _rel([t], [w]) < tops.BF16_RTOL
    for name in ("fill_dispatches", "deadline_dispatches"):
        assert getattr(tsvc.stats, name) == getattr(jsvc.stats, name)
    _assert_twins_agree(jtable, jsvc, tsvc)


# ------------------------------------------------------------------- GPU
_GPU_BUCKETS = [("c2c", 4096, 4, 8), ("r2c", 4096, 4, 8), ("c2r", 4096, 4, 8),
                ("c2c", 1 << 18, 4, 8)]
_NAMES = {"coded_bucket_masked": "coded_fft_bucket_masked",
          "coded_bucket": "coded_fft_bucket",
          "coded_rbucket_masked": "coded_rfft_bucket_masked",
          "coded_rbucket": "coded_rfft_bucket",
          "coded_irbucket_masked": "coded_irfft_bucket_masked",
          "coded_irbucket": "coded_irfft_bucket"}


@pytest.mark.gpu
@pytest.mark.parametrize("kind,s,m,n", _GPU_BUCKETS)
def test_gpu_bf16_buckets(cuda, kind, s, m, n):
    """Each bucket op's bf16 entry on the card: one counted ``[bf16]``
    launch (or the streaming kernel's), within ``BF16_RTOL`` of its plain
    twin and of numpy, different from its f32 entry."""
    data, masks, dplanes, (gr, gi), want = _bucket_case(kind, s, m, n, 1)
    route = tops.bucket_route(s, m, n, kind)
    for op_name, decode in zip(_OPS[kind], ((masks,), dplanes)):
        op = getattr(tops, op_name)
        name = _NAMES[op_name]
        if route == "streaming":
            name = ("coded_fft_bucket_streaming_masked"
                    if op_name.endswith("masked")
                    else "coded_fft_bucket_streaming")
        args = (*_t(*data, device=cuda), *_t(*decode, device=cuda),
                gr.to(cuda), gi.to(cuda), s)
        _build.reset_launch_counts()
        got = _outs(tuple(o.cpu() for o in _as_tuple(
            op(*args, precision="bf16"))))
        counts = _build.launch_counts()
        assert set(counts) == {f"{name}[bf16]"}, counts
        f32 = _outs(tuple(o.cpu() for o in _as_tuple(op(*args))))
        plain = _outs(op(*_t(*data), *_t(*decode), gr, gi, s,
                         precision="bf16"))
        assert _rel(_complexify(got), _complexify(plain)) < tops.BF16_RTOL
        assert _rel(_complexify(got), want) < tops.BF16_RTOL
        assert max(np.abs(a - b).max() for a, b in zip(got, f32)) > 0


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.gpu
@pytest.mark.parametrize("ell,kw,name,launches", [
    (1024, dict(variant="fused"), "fourstep_fused", 1),
    (1 << 18, dict(variant="two_pass"), None, 2),
    (1 << 18, dict(variant="streaming"), "fourstep_streaming", 2),
    (1024, dict(variant="fused", factors=(16, 16, 4)), "multistep_fused", 1),
    (1 << 18, dict(variant="fused", factors=(64, 64, 64)),
     "multistep_fused", 3),
])
def test_gpu_bf16_fourstep(cuda, ell, kw, name, launches):
    """``fourstep_planar`` at bf16 on the card: the wrappers' bf16
    entries counted, within ``BF16_RTOL`` of the plain twins and of
    complex128 ``torch.fft``, different from f32."""
    rng = np.random.default_rng(ell)
    x = rng.standard_normal((8, ell)) + 1j * rng.standard_normal((8, ell))
    xr, xi = x.real.astype(np.float32), x.imag.astype(np.float32)
    _build.reset_launch_counts()
    got = tops.fourstep_planar(*_t(xr, xi, device=cuda), precision="bf16",
                               **kw)
    counts = _build.launch_counts()
    want = ({"fourstep_stage1[bf16]": 1, "fourstep_stage2[bf16]": 1}
            if name is None else {f"{name}[bf16]": launches})
    assert counts == want
    got = [g.cpu().numpy() for g in got]
    f32 = [g.cpu().numpy() for g in tops.fourstep_planar(
        *_t(xr, xi, device=cuda), **kw)]
    plain = _outs(tops.fourstep_planar(*_t(xr, xi), precision="bf16", **kw))
    truth = torch.fft.fft(torch.as_tensor(x), dim=-1).numpy()
    assert _rel(_complexify(got), _complexify(plain)) < tops.BF16_RTOL
    assert _rel(_complexify(got), [truth]) < tops.BF16_RTOL
    assert np.abs(got[0] - f32[0]).max() > 0


@pytest.mark.gpu
def test_gpu_bf16_service_probes_and_serves(cuda, private_autotune_table):  # noqa: F811
    """A bf16 service on the card: the probe launches the bf16 entry and
    records ``ok``, and the bucket serves on the ``[bf16]`` kernel."""
    svc = FFTService(FFTServiceConfig(s=4096, precision="bf16",
                                      autotune=False), device=cuda)
    xs, want = _requests("c2c", 4096, 16, seed=2)
    _build.reset_launch_counts()
    out = svc.submit_batch(xs)
    assert _build.launch_counts() == {"coded_fft_bucket_masked": 1,
                                      "coded_fft_bucket_masked[bf16]": 2}
    assert autotune.lookup("bf16", backend=autotune.backend_of(cuda),
                           s=4096, m=4, k="c2c", mode="kernel") == \
        {"ok": True}
    for t, w in zip(out, want):
        assert _rel([t], [w]) < tops.BF16_RTOL
