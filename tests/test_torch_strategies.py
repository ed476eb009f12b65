"""The port's strategy zoo against the JAX package's.

* the Remark 4 thresholds; every registry entry's name, order, knobs,
  ``applicable`` and ``recovery_threshold`` at the reference's small
  configurations, beside the JAX registry's;
* every responder subset at those configurations: ``decodable`` iff the
  strategy's claim holds (and equal to the JAX plan's answer), and every
  exactly-threshold subset decodes to ``numpy.fft``;
* the partial plan's every sequential fragment pattern, unfinished rows
  NaN-poisoned; the comm-efficient plan's folded payload;
* ``CodedPartialFFT``, ``CodedCommEffFFT`` and ``UncodedRepetitionFFT``
  against the JAX plans on the same numpy inputs and masks, unbatched and
  batched, at the reference's tiers (5e-3 at complex64 on the kernel
  backend, 1e-8 at complex128), straggler rows NaN-poisoned;
* the module-global registry: a duplicate name raises, and a test's own
  entry is removed again;
* on the card (marker ``gpu``): the kernel-backend plans launch
  ``fourstep_fused``, the two-pass pair and ``cmatmul``.
"""

import itertools

import numpy as np
import pytest
import torch
from test_torch_kernels import private_autotune_table  # noqa: F401

from repro_torch.core import (
    REGISTRY,
    CodedCommEffFFT,
    CodedFFT,
    CodedPartialFFT,
    CodedPlan,
    MDSPlan,
    StrategyEntry,
    UncodedRepetitionFFT,
    coded_fft_threshold,
    make_strategy,
    register_strategy,
    repetition_threshold,
    short_dot_threshold,
)
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops

C64, C128 = torch.complex64, torch.complex128
CPU = "cpu"

# the reference's per-strategy small configs (tests/test_strategies.py)
EXHAUSTIVE_CFGS = [
    ("mds", 16, 2, 4, None),
    ("mds", 24, 3, 5, None),
    ("partial", 16, 2, 4, 2),
    ("partial", 24, 2, 3, 3),
    ("comm_efficient", 16, 2, 5, 2),
    ("comm_efficient", 24, 2, 6, 3),
    ("repetition", 16, 2, 8, None),
]
# the reference's tiers (tests/test_properties.py): (backend, dtype, rtol)
TIERS = [("kernel", C64, 5e-3), ("reference", C128, 1e-8)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jref():
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import strategies as jstrat

    return jnp, jstrat


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _crand(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _subset_mask(n, sub):
    mask = np.zeros(n, bool)
    mask[list(sub)] = True
    return mask


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_threshold_formulas_remark4():
    n, m = 16, 2
    assert coded_fft_threshold(n, m) == 2
    assert repetition_threshold(n, m) == 16 - 4 + 1 == 13
    assert short_dot_threshold(n, m) == 16 - 8 + 2 == 10
    assert (coded_fft_threshold(n, m) < short_dot_threshold(n, m)
            < repetition_threshold(n, m))


def test_registry_matches_reference(jref):
    """Names in the reference's order, with its knobs and texts."""
    _, jstrat = jref
    assert list(REGISTRY) == list(jstrat.REGISTRY) == [
        "mds", "partial", "comm_efficient", "repetition"]
    for name, ent in REGISTRY.items():
        jent = jstrat.REGISTRY[name]
        assert (ent.default_param, ent.kernel_ok, ent.mesh_ok,
                ent.description) == (jent.default_param, jent.kernel_ok,
                                     jent.mesh_ok, jent.description)
        for s, m, n, param in itertools.product(
                (12, 16, 24, 32), (1, 2, 3, 4), (3, 4, 8, 9, 16),
                (None, 2, 3)):
            assert ent.applicable(s, m, n, param) == jent.applicable(
                s, m, n, param), (name, s, m, n, param)


def test_register_strategy_refuses_a_duplicate():
    """The registry is module-global: a duplicate name raises, and an
    entry a test registers is removed again."""
    with pytest.raises(ValueError, match="already registered"):
        register_strategy(REGISTRY["mds"])
    entry = StrategyEntry(
        name="test_only_mds",
        factory=lambda s, m, n, *, dtype, backend, param, device: CodedFFT(
            s, m, n, dtype=dtype, backend=backend, device=device),
        applicable=lambda s, m, n, param: s % m == 0 and n >= m)
    try:
        register_strategy(entry)
        plan = make_strategy("test_only_mds", 16, 2, 4, device=CPU)
        assert isinstance(plan, CodedFFT) and plan.backend == "reference"
    finally:
        REGISTRY.pop("test_only_mds", None)
    assert "test_only_mds" not in REGISTRY
    with pytest.raises(KeyError, match="unknown strategy"):
        make_strategy("test_only_mds", 16, 2, 4, device=CPU)


@pytest.mark.parametrize("name,s,m,n,param", EXHAUSTIVE_CFGS)
def test_registry_entries_registered_and_applicable(jref, name, s, m, n,
                                                    param):
    jnp, jstrat = jref
    assert REGISTRY[name].applicable(s, m, n, param)
    plan = make_strategy(name, s, m, n, dtype=C128, param=param, device=CPU)
    jplan = jstrat.make_strategy(name, s, m, n, dtype=jnp.complex128,
                                 param=param)
    assert type(plan).__name__ == type(jplan).__name__
    assert plan.recovery_threshold == jplan.recovery_threshold >= 1
    assert tuple(plan.worker_shard_shape) == tuple(jplan.worker_shard_shape)
    assert isinstance(plan, CodedPlan)
    assert isinstance(plan, MDSPlan) == (name != "repetition")


@pytest.mark.parametrize("name,s,m,n,param", EXHAUSTIVE_CFGS)
def test_exhaustive_worker_subsets_decodable_iff_threshold(
        jref, name, s, m, n, param):
    """Every one of the 2^N responder subsets: decodable() iff the
    strategy's worker-count claim holds, and as the JAX plan says."""
    jnp, jstrat = jref
    plan = make_strategy(name, s, m, n, dtype=C128, param=param, device=CPU)
    jplan = jstrat.make_strategy(name, s, m, n, dtype=jnp.complex128,
                                 param=param)
    for size in range(n + 1):
        for sub in itertools.combinations(range(n), size):
            mask = _subset_mask(n, sub)
            if name == "repetition":
                want = all(any(plan.block_of_worker(w) == (i, j)
                               for w in sub)
                           for i in range(m) for j in range(m))
            else:
                want = size >= plan.recovery_threshold
            assert plan.decodable(mask) == want == jplan.decodable(mask), \
                (name, sub)


@pytest.mark.parametrize("name,s,m,n,param", EXHAUSTIVE_CFGS)
def test_boundary_subsets_actually_decode(name, s, m, n, param):
    """Every exactly-threshold subset that decodes gives numpy's
    transform, its straggler rows NaN-poisoned."""
    plan = make_strategy(name, s, m, n, dtype=C128, param=param, device=CPU)
    x = _crand(s, 7)
    want = np.fft.fft(x)
    b = plan.worker_compute(plan.encode(torch.as_tensor(x)))
    k = int(plan.recovery_threshold)
    for sub in itertools.combinations(range(n), k):
        mask = _subset_mask(n, sub)
        if not plan.decodable(mask):
            continue    # repetition: only block-covering subsets decode
        poisoned = b.clone()
        poisoned[torch.as_tensor(~mask)] = float("nan")
        got = plan.decode(poisoned, mask=torch.as_tensor(mask))
        assert _rel(got, want) < 1e-6, (name, sub)


def test_partial_exhaustive_fragment_patterns(jref):
    """Every sequential fragment pattern at small (N, r): decodable iff
    total finished fragments >= m*r, and the decode of the NaN-poisoned
    rows equals numpy's and the JAX plan's."""
    jnp, jstrat = jref
    s, m, n, r = 16, 2, 3, 2
    plan = CodedPartialFFT(s=s, m=m, n_workers=n, r=r, dtype=C128,
                           device=CPU)
    jplan = jstrat.CodedPartialFFT(s=s, m=m, n_workers=n, r=r,
                                   dtype=jnp.complex128)
    x = _crand(s, 8)
    want = np.fft.fft(x)
    b = plan.worker_compute(plan.encode(torch.as_tensor(x)))
    jb = np.asarray(jplan.worker_compute(jplan.encode(jnp.asarray(x))))
    assert _rel(b, jb) < 1e-12
    for prefixes in itertools.product(range(r + 1), repeat=n):
        fmask = np.zeros((n, r), bool)
        for w, p in enumerate(prefixes):
            fmask[w, :p] = True
        want_dec = sum(prefixes) >= plan.fragments_needed
        assert plan.decodable(fragment_mask=fmask) == want_dec
        assert jplan.decodable(fragment_mask=fmask) == want_dec
        if want_dec:
            poisoned = b.clone()
            poisoned[torch.as_tensor(~fmask)] = float("nan")
            got = plan.decode(poisoned, fragment_mask=torch.as_tensor(fmask))
            jpois = jb.copy()
            jpois[~fmask] = np.nan
            jgot = jplan.decode(jnp.asarray(jpois),
                                fragment_mask=jnp.asarray(fmask))
            assert _rel(got, want) < 1e-6, prefixes
            assert _rel(got, jgot) < 1e-9, prefixes


def test_partial_code_geometry_matches_reference(jref):
    jnp, jstrat = jref
    plan = CodedPartialFFT(s=48, m=2, n_workers=3, r=3, device=CPU)
    jplan = jstrat.CodedPartialFFT(s=48, m=2, n_workers=3, r=3)
    for attr in ("frag_len", "shard_len", "fragments", "fragments_needed",
                 "code_rows", "recovery_threshold", "payload_scale"):
        assert getattr(plan, attr) == getattr(jplan, attr), attr
    np.testing.assert_array_equal(plan.fragment_fractions,
                                  jplan.fragment_fractions)
    for attr in ("generator", "worker_encode_tensor"):
        np.testing.assert_allclose(getattr(plan, attr).numpy(),
                                   np.asarray(getattr(jplan, attr)),
                                   atol=1e-6)


def test_comm_efficient_payload_is_folded(jref):
    """The comm-efficient worker ships 1/q of the MDS shard; its fold
    weights and widened decode generator are the JAX plan's."""
    jnp, jstrat = jref
    s, m, n, q = 32, 2, 6, 2
    plan = CodedCommEffFFT(s=s, m=m, n_workers=n, q=q, dtype=C128,
                           device=CPU)
    jplan = jstrat.CodedCommEffFFT(s=s, m=m, n_workers=n, q=q,
                                   dtype=jnp.complex128)
    assert plan.worker_shard_shape == (s // m // q,)
    assert plan.stored_shard_shape == (s // m,)
    assert plan.payload_scale == 1.0 / q
    assert plan.recovery_threshold == plan.decode_width == m * q
    for attr in ("generator", "decode_generator", "fold_weights",
                 "worker_encode_tensor"):
        np.testing.assert_allclose(getattr(plan, attr).numpy(),
                                   np.asarray(getattr(jplan, attr)),
                                   atol=1e-12)
    x = _crand(s, 9)
    b = plan.worker_compute(plan.encode(torch.as_tensor(x)))
    assert tuple(b.shape) == (n, s // m // q)
    jb = jplan.worker_compute(jplan.encode(jnp.asarray(x)))
    assert _rel(b, jb) < 1e-12
    rows = torch.tensor([4, 1])
    np.testing.assert_allclose(
        plan.worker_compute_rows(plan.encode(torch.as_tensor(x))[rows],
                                 rows).numpy(), b[rows].numpy(), atol=1e-12)
    assert not plan.decodable(np.arange(n) < m * q - 1)
    with pytest.raises(ValueError):
        plan.decode(b, subset=torch.arange(m * q - 1))


def _masks(n, k, batch, seed):
    """Random availability with k..n responders per request."""
    rng = np.random.default_rng(seed)
    rows = max(batch, 1)
    out = np.zeros((rows, n), bool)
    for r, kk in enumerate(rng.integers(k, n + 1, size=rows)):
        out[r, rng.choice(n, size=int(kk), replace=False)] = True
    return out if batch else out[0]


def _fragment_masks(n, r, need, batch, seed):
    """Random sequential-prefix fragment patterns meeting the coverage
    condition (the reference's property-suite law)."""
    rng = np.random.default_rng(seed)
    rows = max(batch, 1)
    out = np.zeros((rows, n, r), bool)
    for b in range(rows):
        prefix = rng.integers(0, r + 1, size=n)
        while prefix.sum() < need:
            w = int(rng.integers(n))
            prefix[w] = min(r, prefix[w] + 1)
        for w, p in enumerate(prefix):
            out[b, w, :p] = True
    return out if batch else out[0]


def _poisoned(b, mask):
    """NaN into every row the mask does not admit (worker or fragment)."""
    b = b.clone()
    b[torch.as_tensor(~mask)] = float("nan")
    return b


PLAN_CASES = [
    ("partial", "mask"), ("partial", "fragment_mask"),
    ("comm_efficient", "mask"), ("repetition", "mask")]


@pytest.mark.parametrize("batch", [0, 3])
@pytest.mark.parametrize("tier", TIERS, ids=["kernel-c64", "ref-c128"])
@pytest.mark.parametrize("name,how", PLAN_CASES)
def test_plan_matches_jax_plan(jref, name, how, tier, batch):
    """The port's plan and the JAX plan on the same numpy input and
    masks: stage by stage, and the NaN-poisoned decode, within the tier's
    tolerance of each other and of numpy.fft."""
    jnp, jstrat = jref
    backend, dtype, rtol = tier
    jdtype = {C64: jnp.complex64, C128: jnp.complex128}[dtype]
    s, m, n = 32, 2, 8
    kw = {} if name == "repetition" else {"backend": backend}
    plan = make_strategy(name, s, m, n, dtype=dtype, device=CPU, **kw)
    jplan = jstrat.make_strategy(name, s, m, n, dtype=jdtype, **kw)
    npdt = np.complex64 if dtype == C64 else np.complex128
    x = _crand((batch, s) if batch else (s,), batch + 11).astype(npdt)
    a = plan.encode(torch.as_tensor(x))
    ja = np.asarray(jplan.encode(jnp.asarray(x)))
    assert _rel(a, ja) < rtol
    b = plan.worker_compute(a)
    jb = np.asarray(jplan.worker_compute(jnp.asarray(ja)))
    assert _rel(b, jb) < rtol
    if how == "fragment_mask":
        mask = _fragment_masks(n, plan.r, plan.fragments_needed, batch,
                               batch + 5)
        got = plan.decode(_poisoned(b, mask), fragment_mask=mask)
        jpois = jb.copy()
        jpois[~mask] = np.nan
        jgot = jplan.decode(jnp.asarray(jpois),
                            fragment_mask=jnp.asarray(mask))
    else:
        if name == "repetition":
            # each request keeps one replica of every block
            mask = np.ones((max(batch, 1), n), bool)
            mask[:, [0, 5]] = False
            mask = mask if batch else mask[0]
        else:
            mask = _masks(n, plan.recovery_threshold, batch, batch + 5)
        got = plan.decode(_poisoned(b, mask), mask=torch.as_tensor(mask))
        jpois = jb.copy()
        jpois[~mask] = np.nan
        jgot = jplan.decode(jnp.asarray(jpois), mask=jnp.asarray(mask))
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert _rel(got, want) < rtol
    assert _rel(got, jgot) < rtol


def test_repetition_worst_case_and_missing_block():
    """Remark 4's threshold N - N/m^2 + 1 exactly, and a block with no
    live replica refuses."""
    strat = UncodedRepetitionFFT(s=16, m=2, n_workers=8, dtype=C128,
                                 device=CPU)
    assert strat.worst_case_threshold() == repetition_threshold(8, 2) == 7
    assert strat.is_k_recoverable(7) and not strat.is_k_recoverable(6)
    mask = np.ones(8, bool)
    mask[[0, 4]] = False            # both replicas of block (0, 0)
    assert not strat.decodable(mask)
    with pytest.raises(ValueError, match="some block missing"):
        strat.run(torch.as_tensor(_crand(16, 3)), mask=mask)
    x = _crand(16, 4)
    got = strat.run(torch.as_tensor(x), subset=torch.tensor([1, 2, 3, 4]))
    assert _rel(got, np.fft.fft(x)) < 1e-10


@pytest.mark.gpu
@pytest.mark.parametrize("s", [4096, 1 << 18])
@pytest.mark.parametrize("name", ["partial", "comm_efficient"])
def test_gpu_strategy_plans_launch_the_kernels(cuda, name, s):
    """The kernel-backend plans on the card: the worker runs
    ``fourstep_fused`` (s=4096) or the two-pass pair (s=2^18, shards past
    the fused gate), the encode ``torch.fft``; a single comm-efficient
    request decodes on ``cmatmul`` with the widened generator."""
    plan = make_strategy(name, s, 4, 8, backend="kernel", device=cuda)
    ell = plan.frag_len if name == "partial" else plan.shard_len
    fused = tops.fourstep_route(ell, device=cuda)[0] == "fused"
    x = _crand((4, s), s).astype(np.complex64)
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    if name == "partial":
        mask = np.ones((4, 8, 2), bool)
        mask[:, 1::2, 1] = False    # evenly spread finished fragments
        kw = {"fragment_mask": torch.as_tensor(mask, device=cuda)}
    else:
        mask = np.ones((4, 8), bool)
        kw = {"mask": torch.as_tensor(mask, device=cuda)}
    worker = ({"fourstep_fused": 1} if fused
              else {"fourstep_stage1": 1, "fourstep_stage2": 1})
    for xin, one in ((x, False), (x[0], True)):
        kwi = {k: v if not one else v[0] for k, v in kw.items()}
        _build.reset_launch_counts()
        got = plan.run(torch.as_tensor(xin, device=cuda), **kwi)
        counts = _build.launch_counts()
        expect = dict(worker)
        if one and name == "comm_efficient":
            expect["cmatmul"] = 1
        assert counts == expect, counts
        assert _rel(got.cpu(), want if not one else want[0]) < 1e-3
