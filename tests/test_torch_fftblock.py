"""The one-block four-step kernel's layout, routes and index maps.

``csrc/fft_block.cuh`` runs both ``fourstep_fused`` and the block mode of
``multistep_fused``: each block takes whole rows into shared memory, runs
the row FFT's passes over them (natural order) and stores each row in the
plan's scrambled digit order, ``out[(c1, ..., ck)] = X[c1 + f1*c2 + ...]``.
Its working set is ``fourstep_fft.fft_block_layout``; the routes' gates
stay the dense design's reckonings (``fourstep_layout``,
``multistep_layout``).  CPU tests: that layout counted by hand; its fit
wherever either gate admits a row; ``ops.fourstep_route`` and
``multistep_mode`` frozen at the parent's answers; the store's exact
reciprocal division; and a numpy model of the kernel, index for index
(padded load, natural-order rows, the scrambled read of each output word,
the banks of a warp's reads), held against the plain twins
``fourstep_body`` and ``multistep_body``, ``numpy.fft`` and the JAX
kernels in interpret mode.  Stated tolerances, relative to the largest
output magnitude: ``TWIN_TOL`` = 1e-4 against a twin (a float64 model
against f32 dense sums); against the complex128 ``numpy.fft`` the
existing ``PAIR_TOL`` = 1e-5 (two factors) and ``LONG_TOL`` = 1e-4 (more
stages) of the plan and multistep tests.

GPU tests (marker ``gpu``, skipped without a CUDA device): one traced call
of each entry at each of the layout's three regimes is one launch of
``fft_block_kernel`` and nothing else, against its twin at 1e-4.
"""

import hashlib
import math
import time

import numpy as np
import pytest
import torch
from test_torch_kernels import _rand, _rel, _t
from test_torch_kernels import private_autotune_table  # noqa: F401

from repro_torch.kernels import _build, autotune
from repro_torch.kernels import ops as tops
from repro_torch.kernels.fourstep_fft import (
    MAX_STAGES,
    _parse_stage_planes,
    fft_block_layout,
    fft_rows_layout,
    fft_rows_per_block,
    fft_rows_plan,
    fourstep_body,
    fourstep_fused,
    multistep_body,
    multistep_fused,
    multistep_layout,
    multistep_mode,
)

TWIN_TOL = 1e-4
PAIR_TOL = 1e-5
LONG_TOL = 1e-4
OPTIN = _build.SMEM_PER_BLOCK_OPTIN
# the reciprocal division's exact range (fft_block.cuh, kMaxLength)
MAX_LENGTH = 1 << 15


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
    from repro.kernels import fourstep_fft as jfs

    return jnp, jfs


def _padded(n):
    return n + ((n - 1) >> 5)


# ------------------------------------------------------------ the layout
def test_fft_block_layout_counted_by_hand():
    """L = 1024 (the s = 4096 plan's rows): two rows a block, both buffers
    and the table padded -- the row FFT's own layout.  Past 9392 points
    the table stays in global memory (no words); past 14,088 the buffers
    lose their padding; 14,528 fills the block to the byte."""
    rows = 2 * (2048 + 63)                # two padded 1024-point rows
    assert fft_rows_per_block(1024) == 2
    assert fft_block_layout(1024) == (0, rows, 2 * rows,
                                      2 * rows + 2 * (1024 + 31))
    assert fft_block_layout(1024) == fft_rows_layout(1024) == \
        (0, 4222, 8444, 10554)
    # the last length whose padded table fits, and the first past it
    assert fft_block_layout(9392) == fft_rows_layout(9392)
    assert 4 * fft_rows_layout(9393)[-1] > OPTIN
    assert fft_block_layout(9393) == (0, 2 * 9686, 4 * 9686, 4 * 9686)
    # (96, 100): padded buffers, table in global memory
    assert fft_block_layout(9600) == (0, 19798, 39596, 39596)
    # padding fits up to 14,088; (112, 128) and (120, 121) run bare
    assert fft_block_layout(14088)[1] == 2 * _padded(14088)
    assert fft_block_layout(14089) == (0, 2 * 14089, 4 * 14089, 4 * 14089)
    assert fft_block_layout(14336) == (0, 28672, 57344, 57344)
    assert fft_block_layout(14520)[1] == 2 * 14520
    assert 4 * fft_block_layout(14528)[-1] == OPTIN


def _regime(ell):
    """What the kernel reads from the layout's words: (buffers padded,
    table staged) -- as ``fft_block_kernel`` infers them."""
    x, y, tab, total = fft_block_layout(ell)
    plane = (y - x) // 2
    return plane > fft_rows_per_block(ell) * ell, total > tab


def _check_fits(ell):
    x, y, tab, total = fft_block_layout(ell)
    rows = fft_rows_per_block(ell)
    padded, staged = _regime(ell)
    plane = (y - x) // 2
    assert x == 0 and tab == 2 * y and 4 * total <= OPTIN, ell
    assert plane == (_padded(rows * ell) if padded else rows * ell)
    assert total - tab == (2 * _padded(ell) if staged else 0)
    # the store's reciprocals and the plan record's passes
    assert rows * ell < MAX_LENGTH and len(fft_rows_plan(ell)) <= 16


def test_fft_block_layout_fits_wherever_the_fused_gate_admits():
    """``ops.fourstep_fusable`` admits 16 bytes a point, whatever the split
    (A = 1 and (120, 121) included): every admitted length, 1 to 14,528,
    fits the kernel's layout, in one of three regimes."""
    assert tops.fourstep_fusable(1, 14528)
    assert not tops.fourstep_fusable(1, 14529)
    assert not tops.fourstep_fusable(121, 121)
    for a, b in [(32, 32), (120, 121), (112, 128), (96, 100), (1, 127),
                 (127, 1), (4, 3632)]:
        assert tops.fourstep_fusable(a, b) == tops.fourstep_fusable(1, a * b)
    regimes = {}
    for ell in range(1, 14529):
        assert tops.fourstep_fusable(1, ell)
        _check_fits(ell)
        regimes.setdefault(_regime(ell), []).append(ell)
    assert {k: (v[0], v[-1]) for k, v in regimes.items()} == {
        (True, True): (1, 9392), (True, False): (9393, 14088),
        (False, False): (14089, 14528)}


def _block_plans():
    """Every plan of more than two factors that ``multistep_mode`` runs in
    block mode: the autotune candidates over the multistep tests'
    lengths, and the plans those tests name."""
    lengths = sorted({1 << k for k in range(2, 22)} | {
        960, 3 * 5 * 7 * 11, 4099, 3 * 4099, 6 ** 5, 1000000,
        27 * 125 * 49, 3 << 18})
    plans = {tuple(p) for ell in lengths
             for p in autotune.candidate_factor_plans(ell) if len(p) > 2}
    plans |= {(4, 4, 4), (2, 4, 8), (8, 8, 8), (3, 5, 7), (16, 16, 4),
              (1, 16, 16), (16, 1, 4, 1), (2, 64, 3), (8, 8, 8, 8),
              (16, 16, 32), (5, 12, 20)}
    return sorted(p for p in plans if multistep_mode(p) == "block")


def test_fft_block_layout_fits_every_block_mode_plan():
    """Block mode's gate is the dense 16 bytes a point plus every stage's
    DFT planes, so it admits fewer rows than the fused gate: each plan it
    admits fits the kernel's layout.  The largest are 8192 points."""
    plans = _block_plans()
    for plan in plans:
        assert 4 * multistep_layout(plan)[-1] <= OPTIN
        _check_fits(math.prod(plan))
    top = max(math.prod(p) for p in plans)
    assert top == 8192
    assert {p for p in plans if math.prod(p) == top} >= {
        (16, 16, 16, 2), (64, 64, 2), (32, 32, 8), (16, 16, 32)}


# ------------------------------------------------ the routes, frozen
# ops.fourstep_route(ell) for ell = 2 .. 16384 with an empty autotune
# table, as the parent answered it: "ell:variant:AxB" lines, their sha256
ROUTE_SHA256 = \
    "519e6977ea2535d49a839e8c87c7026ec982821f1b7ac5569aadd0fd9fee76cb"
ROUTE_COUNTS = {"fused": 12941, "xla": 1957, "two_pass": 1485}


def test_fourstep_route_is_frozen(private_autotune_table):
    lines, counts, fused = [], {}, []
    for ell in range(2, 16385):
        variant, factors = tops.fourstep_route(ell)
        lines.append(f"{ell}:{variant}:"
                     f"{'x'.join(map(str, factors)) if factors else ''}")
        counts[variant] = counts.get(variant, 0) + 1
        if variant == "fused":
            fused.append(ell)
    assert counts == ROUTE_COUNTS
    assert (fused[0], fused[-1]) == (2, 14528)
    assert hashlib.sha256("\n".join(lines).encode()).hexdigest() == \
        ROUTE_SHA256


# multistep_mode at the plans tests/test_torch_multistep.py names, as the
# parent answered (None: refused)
FROZEN_MODES = {
    (4, 4, 4): "block", (2, 4, 8): "block", (8, 8, 8): "block",
    (3, 5, 7): "block", (16, 16, 4): "block", (64, 64, 64): "per_stage",
    (64, 64, 8): "per_stage", (64, 5, 100): "per_stage",
    (1, 16, 16): "block", (16, 1, 4, 1): "block", (2, 64, 3): "block",
    (7, 11, 13, 31): "per_stage", (1, 64, 64, 64): "per_stage",
    (300, 7, 1): "per_stage", (8, 8, 8, 8): "block",
    (16, 16, 32): "block", (16, 32, 32): "per_stage",
    (9392, 2, 2): "per_stage", (2, 2, 9392): "per_stage",
    (64, 64, 64, 1): "per_stage", (5, 12, 20): "block",
    (9393, 2, 2): None, (2, 9393, 2): None, (30000, 2, 2): None}


@pytest.mark.parametrize("factors", list(FROZEN_MODES))
def test_multistep_mode_is_frozen(factors):
    want = FROZEN_MODES[factors]
    if want is None:
        with pytest.raises(ValueError, match="shared memory"):
            multistep_mode(factors)
    else:
        assert multistep_mode(factors) == want


# -------------------------------------------- the numpy model of the kernel
def _quot(a, mul):
    """The kernel's ``quot``: ``__umulhi(a << 1, mul)``, on uint64."""
    a = np.asarray(a, np.uint64)
    return ((a << np.uint64(1)) * np.uint64(mul)) >> np.uint64(32)


def _mul(d):
    return ((1 << 31) + d - 1) // d


def test_reciprocal_division_is_exact():
    """``quot(a, ceil(2^31 / d)) == a // d`` for every a < 2^15 and every
    divisor the store can meet: each factor and row length below 2^15
    (all of 1 .. 4096, then a sweep and the primes near the top)."""
    a = np.arange(MAX_LENGTH, dtype=np.uint64)
    divisors = list(range(1, 4097)) + list(range(4097, MAX_LENGTH, 97)) + [
        9391, 9392, 9393, 14087, 14088, 14089, 14503, 14519, 14528,
        MAX_LENGTH - 1]
    for d in divisors:
        assert np.array_equal(_quot(a, _mul(d)), a // np.uint64(d)), d


def _store_plan(factors):
    """``fft_block::Store`` as ``launch`` builds it: factors of 1 dropped,
    each factor's reciprocal and its digit's weight."""
    fs = [f for f in factors if f != 1]
    return fs, [_mul(f) for f in fs], list(np.cumprod([1] + fs)[:-1])


def _quad(factors):
    """``Store.quad``: the last digit's weight where the last factor is a
    multiple of 4, else 0."""
    fs, _, stride = _store_plan(factors)
    return stride[-1] if fs and fs[-1] % 4 == 0 else 0


def _source(e, ell, factors, pb):
    """The shared word that block output word e reads (``source``)."""
    fs, mul, stride = _store_plan(factors)
    e = np.asarray(e, np.int64)
    row = _quot(e, _mul(ell)).astype(np.int64)
    j = e - row * ell
    p = np.zeros_like(e)
    for i in range(len(fs) - 1, 0, -1):
        q = _quot(j, mul[i]).astype(np.int64)
        p += (j - q * fs[i]) * stride[i]
        j = q
    return pb(row * ell + p + j)


def _pads(ell):
    padded, _ = _regime(ell)
    shift = 5 if padded else 31
    return lambda a: a + (np.asarray(a) >> shift)


def _kernel_model(x, factors):
    """``fft_block_kernel`` on (batch, L) complex rows, index for index:
    the block's rows loaded into a padded plane, each row's natural-order
    DFT left in place by the passes (numpy.fft), then output word e read
    at ``source(e)``."""
    batch, ell = x.shape
    rows = fft_rows_per_block(ell)
    x0, y0 = fft_block_layout(ell)[:2]
    plane = (y0 - x0) // 2
    pb = _pads(ell)
    out = np.empty(x.shape, np.complex128)
    for row0 in range(0, batch, rows):
        r = min(rows, batch - row0)
        words = np.arange(r * ell)
        slots = pb(words)
        assert len(np.unique(slots)) == len(words) and slots.max() < plane
        buf = np.zeros(plane, np.complex128)
        buf[slots] = x[row0:row0 + r].reshape(-1)
        buf[slots] = np.fft.fft(buf[slots].reshape(r, ell), axis=1).ravel()
        src = _source(words, ell, factors, pb)
        assert np.array_equal(np.sort(src), np.sort(slots))
        quad = _quad(factors)
        if quad:   # one perm a float4: the words 4t + u at + u * quad
            lead = _source(words[::4], ell, factors, lambda a: a)
            assert np.array_equal(
                src.reshape(-1, 4),
                pb(lead[:, None] + quad * np.arange(4)[None, :]))
        out[row0:row0 + r] = buf[src].reshape(r, ell)
    return out


def _unscramble(out, factors):
    k = len(factors)
    return out.reshape(out.shape[0], *factors).transpose(
        0, *range(k, 0, -1)).reshape(out.shape[0], -1)


def _fourstep_planes(a, b):
    return (*tops._dft_planes(a), *tops._twiddle_planes(a, b),
            *tops._dft_planes(b))


# (1, 127): A = 1 over a prime (one dense pass); (96, 100): the table in
# global memory; (112, 128): unpadded buffers
MODEL_PLANS = [(32, 32), (1, 127), (5, 12, 20), (16, 16, 4), (3, 5, 7),
               (2, 64, 3), (64, 16), (96, 100), (112, 128)]


@pytest.mark.parametrize("factors", MODEL_PLANS)
def test_fft_block_model_matches_twins(factors):
    """The model against ``multistep_body`` (and, for two factors,
    ``fourstep_body``) at 1e-4, and unscrambled against numpy.fft; three
    rows, so blocks of several rows end short."""
    ell, batch = math.prod(factors), 3
    rng = np.random.default_rng(ell)
    xr, xi = _rand(rng, batch, ell), _rand(rng, batch, ell)
    x = xr.astype(np.float64) + 1j * xi
    got = _kernel_model(x, factors)
    truth = np.fft.fft(x, axis=-1)
    flat = _unscramble(got, factors)
    assert _rel([flat.real, flat.imag], [truth.real, truth.imag]) \
        < PAIR_TOL
    stages = _parse_stage_planes(
        factors, [torch.as_tensor(p) for p in tops._multistep_planes(
            tuple(factors))])
    body = multistep_body(*_t(xr, xi), stages)
    assert _rel([got.real, got.imag], body) < TWIN_TOL
    assert _rel([_unscramble(b.numpy(), factors) for b in body],
                [truth.real, truth.imag]) < LONG_TOL
    if len(factors) == 2:
        a, b = factors
        fb = fourstep_body(*_t(xr.reshape(batch, a, b),
                               xi.reshape(batch, a, b),
                               *_fourstep_planes(a, b)))
        fb = [t.reshape(batch, ell) for t in fb]
        assert _rel([got.real, got.imag], fb) < TWIN_TOL
        assert _rel([_unscramble(t.numpy(), factors) for t in fb],
                    [truth.real, truth.imag]) < PAIR_TOL
        # the CPU wrapper is the twin
        fw = fourstep_fused(*_t(xr.reshape(batch, a, b),
                                xi.reshape(batch, a, b),
                                *_fourstep_planes(a, b)))
        assert _rel([t.reshape(batch, ell) for t in fw], fb) == 0.0


def _warp_ways(factors):
    """Worst and mean bank ways of the store's shared reads: thread t of
    a block reads words source(4t + u), u = 0..3, one instruction per u,
    the 32 lanes of a warp on consecutive t; a bank's ways are the
    distinct words it serves."""
    ell = math.prod(factors)
    count = fft_rows_per_block(ell) * ell
    pb = _pads(ell)
    ways = []
    for w0 in range(0, count // 4, 32):
        lanes = np.arange(w0, min(w0 + 32, count // 4))
        for u in range(4):
            addr = _source(4 * lanes + u, ell, factors, pb)
            banks = addr % 32
            ways.append(max(len(np.unique(addr[banks == k]))
                            for k in np.unique(banks)))
    return max(ways), float(np.mean(ways))


# worst ways of a warp's store reads, per plan: the service's shapes
# (the L = 1024 candidates) within 2-way; some autotune candidates
# elsewhere reach 4, and the unpadded buffers past L = 14,088 32
STORE_WAYS = {(32, 32): 1, (64, 16): 1, (16, 16, 4): 2, (16, 64): 1,
              (30, 32): 2, (2, 64, 3): 2, (64, 64): 4, (16, 16, 16): 4,
              (32, 32, 4): 1, (8, 8, 8, 2): 2, (5, 12, 20): 3,
              (96, 100): 4, (112, 128): 32, (120, 121): 31}


@pytest.mark.parametrize("factors", list(STORE_WAYS))
def test_fft_block_store_bank_ways(factors):
    assert _warp_ways(factors)[0] == STORE_WAYS[factors]


@pytest.mark.parametrize("factors", [(32, 32), (16, 16, 4)])
def test_fft_block_model_matches_jax_kernels(jref, factors):
    """The model against the JAX package's Pallas kernels in interpret
    mode: ``fourstep_fused`` for two factors, ``multistep_fused`` for
    every plan."""
    jnp, jfs = jref
    ell, batch = math.prod(factors), 2
    rng = np.random.default_rng(ell + 5)
    xr, xi = _rand(rng, batch, ell), _rand(rng, batch, ell)
    got = _kernel_model(xr.astype(np.float64) + 1j * xi, factors)
    planes = [jnp.asarray(p) for p in tops._multistep_planes(factors)]
    want = jfs.multistep_fused(jnp.asarray(xr), jnp.asarray(xi), planes,
                               factors, block_q=batch, interpret=True)
    assert _rel([got.real, got.imag], want) < TWIN_TOL
    if len(factors) == 2:
        a, b = factors
        want = jfs.fourstep_fused(
            jnp.asarray(xr.reshape(batch, a, b)),
            jnp.asarray(xi.reshape(batch, a, b)),
            *[jnp.asarray(p) for p in _fourstep_planes(a, b)],
            block_q=batch, interpret=True)
        assert _rel([got.real, got.imag],
                    [np.asarray(w).reshape(batch, ell) for w in want]) \
            < TWIN_TOL


def test_fft_block_refuses_beyond_the_plan_record():
    """The store holds at most ``MAX_STAGES`` digits, as the plan record
    does: a longer plan is refused before any launch."""
    with pytest.raises(ValueError, match="factors"):
        multistep_mode((2,) * (MAX_STAGES + 1))


# ------------------------------------------------------------ GPU tests
# (entry, factors, batch): each layout regime (padded with the table,
# the table in global memory, bare buffers) through both entries
GPU_CASES = [("fused", (32, 32), 512), ("fused", (96, 100), 3),
             ("fused", (112, 128), 2), ("fused", (120, 121), 2),
             ("block", (16, 16, 4), 9), ("block", (16, 16, 16, 2), 2),
             ("block", (3, 5, 7), 5)]


def _gpu_case(entry, factors, batch, device):
    """(wrapper name, call, twin) of one case on ``device``."""
    ell = math.prod(factors)
    rng = np.random.default_rng(ell + batch)
    xr, xi = _rand(rng, batch, ell), _rand(rng, batch, ell)
    if entry == "fused":
        a, b = factors
        args = _t(xr.reshape(batch, a, b), xi.reshape(batch, a, b),
                  *_fourstep_planes(a, b), device=device)
        return ("fourstep_fused", lambda: fourstep_fused(*args),
                lambda: fourstep_body(*args))
    x = _t(xr, xi, device=device)
    planes = tops._on_device(tops._multistep_planes, (factors,), device)
    return ("multistep_fused", lambda: multistep_fused(*x, planes, factors),
            lambda: multistep_body(*x, _parse_stage_planes(factors,
                                                           planes)))


def _trace_cases():
    """Each GPU case's call once under ``torch.profiler``, in this
    process: prints one JSON object, per case the launch counts, the
    traced kernels and the error against the twin.  Run in a fresh
    process (``traced``): a process that has run the card for tens of
    seconds lost whole traces on an H100 (every kernel of a call missing,
    with the call 1 s inside the window), one that is seconds old did
    not."""
    import json

    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = torch.device("cuda")
    out = []
    for entry, factors, batch in GPU_CASES:
        if entry == "block":
            assert multistep_mode(factors) == "block"
        name, run, twin = _gpu_case(entry, factors, batch, cuda)
        run()                                      # build and warm
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            got = run()
            torch.cuda.synchronize()
            time.sleep(0.05)
        counts = _build.launch_counts()
        ran = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
        out.append({"name": name, "launches": counts, "ran": ran,
                    "rel": _rel([g.cpu() for g in got],
                                [w.cpu() for w in twin()])})
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
         "import test_torch_fftblock as t; t._trace_cases()"],
        cwd=tests, env=env, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(GPU_CASES)),
                         ids=[f"{e}-{'x'.join(map(str, f))}"
                              for e, f, _ in GPU_CASES])
def test_gpu_fft_block_is_one_launch(traced, case):
    """One traced call is one launch of ``fft_block_kernel`` and of
    nothing else, counted once under its wrapper's name, and matches
    its twin at 1e-4."""
    got = traced[case]
    assert got["launches"] == {got["name"]: 1}
    assert len(got["ran"]) == 1, got["ran"]
    (kernel, n), = got["ran"].items()
    assert "fft_block_kernel" in kernel and n == 1
    assert got["rel"] < TWIN_TOL
