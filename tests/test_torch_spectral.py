"""The port's spectral mixer (``models/spectral.py``) and the layers the
encoder-decoder added (``sinusoidal_positions``, ``mlp_apply``'s biases)
against the JAX package, on the CPU.

The mixer's parameters are the JAX ``decaying_filter_init``'s, with the
decay and skip perturbed so that each term counts, carried across as
numpy; the input comes from a numpy seed.  At (B, S, D) = (2, 24, 8)
with 8 taps and ``CodedFFT(s=64, m=4, n_workers=6)``:

* ``spectral_apply`` against the JAX function, within 1e-5 of the
  largest magnitude (two f32 platform FFTs);
* ``spectral_apply_coded`` on a ``device="cpu"`` plan (the kernels' plain
  twins) against the JAX function on its kernel-backend plan (the Pallas
  kernels in interpret mode), with workers 1 and 4 down and with no
  mask, within 1e-5;
* the gradients of ``mean(y**2)`` with respect to ``h``, ``decay`` and
  ``skip``, through the port's plain and coded mixers, against
  ``jax.grad`` of the JAX mixer, within 1e-5;
* the gradient with respect to ``x`` (and the filter) through the coded
  mixer at (2, 16, 8), with workers 1 and 4 down and with no mask,
  against ``jax.grad`` of the JAX coded mixer, within 1e-5; its
  backward one more pass through the plan (two ``mds_apply``, one
  worker call, no ``torch.fft``), equal to the plain mixer's gradient;
* every kernel entry of ``kernels/ops.py`` refusing an input that
  requires grad while grad mode is on;
* the coded path's structure: one encode ``mds_apply``, one worker call
  and one decode ``mds_apply`` for all B * D rows, and no ``torch.fft``
  call inside the plan.

``examples/coded_spectral_lm_torch.py`` runs with ``--device cpu`` and
refuses to start without a CUDA device otherwise.
``sinusoidal_positions`` (with an offset start too) within 1e-6 plus two
ulps of each angle, and the gelu MLP with and without its biases within
1e-5 of the reference.
"""

import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import CodedFFT
from repro_torch.kernels import ops
from repro_torch.models import layers as tlayers
from repro_torch.models import spectral as tsp

EXAMPLE = (Path(__file__).resolve().parents[1] / "examples"
           / "coded_spectral_lm_torch.py")
TOL = 1e-5
B, S, D, FILT, PLAN_S = 2, 24, 8, 8, 64
MASK = [True, False, True, True, False, True]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import CodedFFT as JCodedFFT
    from repro.models import layers as jlayers
    from repro.models import spectral as jsp
    return dict(jax=jax, jnp=jnp, CodedFFT=JCodedFFT, layers=jlayers,
                spectral=jsp)


@pytest.fixture(scope="module")
def mixer(jx):
    """The JAX parameters (perturbed decay and skip) and input, and the
    port's copies."""
    jax, jnp = jx["jax"], jx["jnp"]
    p = jax.tree.map(np.asarray, jx["spectral"].decaying_filter_init(
        jax.random.PRNGKey(0), D, FILT))
    rng = np.random.default_rng(0)
    p["decay"] = (0.5 * rng.standard_normal(D)).astype(np.float32)
    p["skip"] = (1.0 + 0.3 * rng.standard_normal(D)).astype(np.float32)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    return {"jp": {k: jnp.asarray(v) for k, v in p.items()},
            "jx_in": jnp.asarray(x),
            "tp": {k: torch.tensor(v) for k, v in p.items()},
            "x": torch.from_numpy(x)}


def _rel(got, want) -> float:
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _plan():
    return CodedFFT(s=PLAN_S, m=4, n_workers=6, device="cpu")


# -- the mixer --------------------------------------------------------------
def test_spectral_apply_matches_jax(jx, mixer):
    want = jx["spectral"].spectral_apply(mixer["jp"], mixer["jx_in"])
    got = tsp.spectral_apply(mixer["tp"], mixer["x"])
    assert got.dtype == torch.float32
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("masked", [True, False])
def test_spectral_apply_coded_matches_jax(jx, mixer, masked):
    jnp = jx["jnp"]
    jplan = jx["CodedFFT"](s=PLAN_S, m=4, n_workers=6)
    jmask = jnp.asarray(MASK) if masked else None
    want = jx["spectral"].spectral_apply_coded(mixer["jp"], mixer["jx_in"],
                                               jplan, mask=jmask)
    plan = _plan()
    assert plan.resolved_backend == "kernel"
    got = tsp.spectral_apply_coded(mixer["tp"], mixer["x"], plan,
                                   mask=torch.tensor(MASK) if masked
                                   else None)
    assert _rel(got, want) < TOL
    assert _rel(got, tsp.spectral_apply(mixer["tp"], mixer["x"])) < TOL


def test_filter_gradients_match_jax(jx, mixer):
    """d mean(y**2) / d (h, decay, skip): the port's plain and coded
    mixers (workers 1 and 4 down) against ``jax.grad``."""
    jax = jx["jax"]
    want = jax.grad(lambda pp: (jx["spectral"].spectral_apply(
        pp, mixer["jx_in"]) ** 2).mean())(mixer["jp"])
    plan, mask = _plan(), torch.tensor(MASK)
    for run in (lambda p: tsp.spectral_apply(p, mixer["x"]),
                lambda p: tsp.spectral_apply_coded(p, mixer["x"], plan,
                                                   mask=mask)):
        p = {k: v.clone().requires_grad_() for k, v in mixer["tp"].items()}
        grads = torch.autograd.grad((run(p) ** 2).mean(),
                                    [p["h"], p["decay"], p["skip"]])
        for name, g in zip(("h", "decay", "skip"), grads):
            assert _rel(g, want[name]) < TOL, name


@pytest.mark.parametrize("masked", [True, False])
def test_input_gradient_matches_jax(jx, mixer, masked):
    """d mean(y**2) / d (x, h, decay, skip) through the coded mixer at the
    probe's (2, 16, 8) with 8 taps, workers 1 and 4 of 6 down or none,
    against ``jax.grad`` of the JAX coded mixer (the Pallas kernels in
    interpret mode), within 1e-5 of each gradient's largest entry."""
    jax, jnp = jx["jax"], jx["jnp"]
    x = np.random.default_rng(3).standard_normal((B, 16, D)).astype(
        np.float32)
    jplan = jx["CodedFFT"](s=PLAN_S, m=4, n_workers=6)
    jmask = jnp.asarray(MASK) if masked else None
    want = jax.grad(lambda xx, pp: (jx["spectral"].spectral_apply_coded(
        pp, xx, jplan, mask=jmask) ** 2).mean(), argnums=(0, 1))(
            jnp.asarray(x), mixer["jp"])
    p = {k: v.clone().requires_grad_() for k, v in mixer["tp"].items()}
    xt = torch.from_numpy(x).requires_grad_()
    y = tsp.spectral_apply_coded(p, xt, _plan(),
                                 mask=torch.tensor(MASK) if masked else None)
    got = torch.autograd.grad((y ** 2).mean(),
                              [xt, p["h"], p["decay"], p["skip"]])
    assert _rel(got[0], want[0]) < TOL
    for name, g in zip(("h", "decay", "skip"), got[1:]):
        assert _rel(g, want[1][name]) < TOL, name


def test_input_gradient_runs_the_plan_again(monkeypatch, mixer):
    """The backward of the coded mixer is one more pass through the plan,
    under the forward's stragglers: one encode and one decode
    ``mds_apply``, one worker call, no ``torch.fft`` inside the plan; its
    gradient equals the plain mixer's."""
    calls = {"mds_apply": 0, "fft_fourstep": 0, "torch.fft": 0}
    for name in ("mds_apply", "fft_fourstep"):
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(ops, name, counted)
    x = mixer["x"].clone().requires_grad_()
    y = tsp.spectral_apply_coded(mixer["tp"], x, _plan(),
                                 mask=torch.tensor(MASK))
    loss = (y ** 2).mean()
    forward = dict(calls)
    real_fft = torch.fft.fft

    def fft_in_plan(*a, **k):
        calls["torch.fft"] += 1
        return real_fft(*a, **k)

    real_run = tsp._run_rows

    def run_rows(*a):
        monkeypatch.setattr(torch.fft, "fft", fft_in_plan)
        try:
            return real_run(*a)
        finally:
            monkeypatch.setattr(torch.fft, "fft", real_fft)

    monkeypatch.setattr(tsp, "_run_rows", run_rows)
    gx, = torch.autograd.grad(loss, x)
    back = {k: calls[k] - forward[k] for k in calls}
    assert forward == {"mds_apply": 2, "fft_fourstep": 1, "torch.fft": 0}
    assert back == {"mds_apply": 2, "fft_fourstep": 1, "torch.fft": 0}
    xp = mixer["x"].clone().requires_grad_()
    gp, = torch.autograd.grad((tsp.spectral_apply(mixer["tp"], xp) ** 2)
                              .mean(), xp)
    assert _rel(gx, gp.numpy()) < TOL


def test_kernel_entries_refuse_an_input_that_requires_grad():
    """A kernel's output has no grad_fn: an ops entry given an input that
    requires grad raises while grad mode is on, and runs without it."""
    g = torch.randn(6, 4, dtype=torch.complex64)
    c = torch.randn(4, 32, dtype=torch.complex64, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.mds_apply(g, c)
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.fft_fourstep(c)
    with torch.no_grad():
        out = ops.mds_apply(g, c)
    assert torch.allclose(out, g @ c.detach(), rtol=1e-5, atol=1e-5)


def test_coded_rows_go_through_the_plan_once(monkeypatch, mixer):
    """All B * D rows in one pass: the encode's and the decode's
    ``mds_apply`` (the ``cmatmul`` launches on the card) and one worker
    call (``fourstep_fused``), each on every row; no ``torch.fft`` inside
    the plan."""
    calls = {"mds_apply": [], "fft_fourstep": [], "torch.fft": 0}
    real_apply, real_fft = ops.mds_apply, ops.fft_fourstep

    def mds_apply(g, c):
        calls["mds_apply"].append((tuple(g.shape), tuple(c.shape)))
        return real_apply(g, c)

    def fft_fourstep(x):
        calls["fft_fourstep"].append(tuple(x.shape))
        return real_fft(x)

    monkeypatch.setattr(ops, "mds_apply", mds_apply)
    monkeypatch.setattr(ops, "fft_fourstep", fft_fourstep)
    real_run = tsp._run_rows

    def counted_run(*args):
        saved = {n: getattr(torch.fft, n) for n in ("fft", "ifft", "rfft",
                                                     "irfft")}

        def counting(fn):
            def wrapped(*a, **kw):
                calls["torch.fft"] += 1
                return fn(*a, **kw)
            return wrapped

        for n, fn in saved.items():
            monkeypatch.setattr(torch.fft, n, counting(fn))
        try:
            return real_run(*args)
        finally:
            for n, fn in saved.items():
                monkeypatch.setattr(torch.fft, n, fn)

    monkeypatch.setattr(tsp, "_run_rows", counted_run)
    plan = _plan()
    tsp.spectral_apply_coded(mixer["tp"], mixer["x"], plan,
                             mask=torch.tensor(MASK))
    rows, ell = B * D, PLAN_S // 4
    assert calls["mds_apply"] == [((6, 4), (4, rows * ell)),
                                  ((4, 4), (4, rows, ell))]
    assert calls["fft_fourstep"] == [(rows * 6, ell)]
    assert calls["torch.fft"] == 0


def test_coded_mixer_refusals(mixer):
    with pytest.raises(ValueError, match="plan.s"):
        tsp.spectral_apply_coded(mixer["tp"], mixer["x"],
                                 CodedFFT(s=16, m=4, n_workers=6,
                                          device="cpu"))
    x = mixer["x"].clone().requires_grad_()
    y = tsp.spectral_apply_coded(mixer["tp"], x, _plan())
    gx, = torch.autograd.grad((y ** 2).mean(), x)
    xp = mixer["x"].clone().requires_grad_()
    gp, = torch.autograd.grad((tsp.spectral_apply(mixer["tp"], xp) ** 2)
                              .mean(), xp)
    assert _rel(gx, gp.numpy()) < TOL
    with torch.no_grad():
        tsp.spectral_apply_coded(mixer["tp"], x, _plan())


def test_example_runs_on_cpu_and_refuses_without_gpu(monkeypatch, capsys):
    main = runpy.run_path(str(EXAMPLE), run_name="example")["main"]
    main(["--device", "cpu"])
    assert "straggler-tolerant spectral layer: OK" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([])


def test_decaying_filter_init_is_seeded():
    a = tsp.decaying_filter_init(torch.Generator().manual_seed(3), D, 32)
    b = tsp.decaying_filter_init(torch.Generator().manual_seed(3), D, 32)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["h"].shape == (D, 32) and a["h"].dtype == torch.float32
    assert not a["decay"].any() and bool((a["skip"] == 1).all())
    # the envelope decays: the last tap's spread is under the first's
    assert float(a["h"][:, -1].abs().max()) < float(a["h"][:, 0].abs().max())
    specs = tsp.spectral_specs(D, 32)
    assert {k: s.shape for k, s in specs.items()} == {
        "h": (D, 32), "decay": (D,), "skip": (D,)}


# -- the layers the encoder-decoder added ----------------------------------
@pytest.mark.parametrize("length, dim", [(1, 8), (24, 64), (1500, 1024)])
def test_sinusoidal_positions_match_reference(jx, length, dim):
    """Within 1e-6 plus two ulps of each angle: the f32 ``exp`` of the
    frequencies may differ by an ulp between the platforms, and the
    angle ``p * scale`` carries that ulp (1.2e-4 at p = 1499)."""
    want = np.asarray(jx["layers"].sinusoidal_positions(length, dim))
    got = tlayers.sinusoidal_positions(length, dim)
    assert got.dtype == torch.float32
    half = dim // 2
    ang = (np.arange(length)[:, None]
           * np.exp(-np.arange(half) * np.log(1e4) / (half - 1))[None])
    tol = 1e-6 + 2 * np.spacing(np.tile(ang.astype(np.float32), 2))
    assert (np.abs(got.numpy() - want) <= tol).all()
    if length > 1:      # rows at an offset are the same rows
        tail = tlayers.sinusoidal_positions(1, dim, start=length - 1)
        assert torch.equal(tail[0], got[-1])


@pytest.mark.parametrize("biases", ["both", "none"])
def test_gelu_mlp_biases_match_reference(jx, biases):
    jnp = jx["jnp"]
    rng = np.random.default_rng(2)
    mk = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(
        np.float32)
    p = {"wi": mk(32, 48), "wo": mk(48, 32)}
    if biases == "both":
        p["bi"] = rng.standard_normal(48).astype(np.float32)
        p["bo"] = rng.standard_normal(32).astype(np.float32)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    want = jx["layers"].mlp_apply(jnp.asarray(x),
                                  {k: jnp.asarray(v) for k, v in p.items()},
                                  "gelu")
    tp = type("P", (), {k: torch.from_numpy(v) for k, v in p.items()})
    got = tlayers.mlp_apply(torch.from_numpy(x), tp, "gelu")
    assert _rel(got, want) < TOL
