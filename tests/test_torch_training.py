"""The port's training core against the JAX package's, on the CPU.

The reference's ``tests/test_training.py`` ported (schedules, AdamW and
its int8 moments, clipping, microbatch accumulation, the trainer's
bit-exact restart), and beside it:

* the four schedules' f32 values against the reference's within 1e-6
  relative (the same f32 sums; ``cos`` and ``pow`` of two libraries);
* ``quantize_moment`` against the reference's, the int8 payload equal
  and the scales within 1e-6;
* one whole training step (``make_train_step``: grads, clip, AdamW) on
  reduced gemma-2b in f32 from the same state, carried across by
  ``convert.train_state_to_reference``, against the reference's
  ``make_train_step``, for exact and int8 AdamW and ``n_micro`` 1 and 2,
  and reduced dbrx-132b with int8 moments at ``n_micro`` 2 (capacity for
  every token; its gradients held against the reference's
  ``accumulate_grads`` and its parameters against the reference's AdamW
  from the port's own clipped gradients, since AdamW's per-entry
  normalisation lifts the MoE step's f32 rounding in a norm scale's
  small entries past TOL of the leaf's largest):
  the loss, the grad norm, every parameter and every exact moment within
  1e-5 of its largest entry (the head in f32 on both sides, as in
  ``tests/test_torch_losses.py``); int8 moments with their scales within
  1e-5 and their payloads off by at most one step in at most 0.1% of the
  entries (a last-bit difference before the rounding), leaving out the
  blocks whose values are subnormal in f32 (XLA on the CPU flushes them
  to zero, torch keeps them); and the port's
  state back through ``convert.train_state_from_reference``;
* the repaired transients bit for bit against the formulas they
  replaced: AdamW's leaf update in slices of rows (a 3-D expert leaf and
  a 2-D leaf, exact and int8) against the whole-leaf formula, and the
  in-place microbatch mean (n_micro 3) and clip against a second tree;
* the synthetic pipeline's tokens, labels and bf16 stubs equal to the
  reference's bit for bit, and the reference's three pipeline tests
  (``tests/test_data_spectral.py``) ported;
* ``SHAPES``, ``cell_runnable``/``iter_cells``, ``input_specs`` and
  ``abstract_train_state`` against the reference's shapes and dtypes;
* the launcher and the example on the CPU; the entry points refuse to
  run without a CUDA device; the modules (the launch tools and
  ``serving/serve_step`` among them) import neither JAX nor the JAX
  package.
"""

import dataclasses
import importlib
import math
import os
import runpy
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import (
    SHAPES,
    ShapeConfig,
    get_reduced_config,
    iter_cells,
)
from repro_torch.data import make_pipeline
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model
from repro_torch.models import losses as tlosses
from repro_torch.models.params import init_params
from repro_torch.optim import adamw, clip_by_global_norm, cosine, global_norm
from repro_torch.optim import constant, linear_warmup, wsd
from repro_torch.optim.adamw import (
    AdamWConfig,
    dequantize_moment,
    quantize_moment,
)
from repro_torch.optim.grad_utils import accumulate_grads
from repro_torch.training import (
    TrainState,
    Trainer,
    TrainerConfig,
    abstract_train_state,
    init_train_state,
    make_train_step,
)

SRC = Path(__file__).resolve().parents[1] / "src"
EXAMPLE = SRC.parent / "examples" / "train_lm_torch.py"
TOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    import repro.configs as jconfigs
    from repro.data import make_pipeline as jpipeline
    from repro.models import build_model as jbuild
    from repro.models import losses as jlosses
    import importlib

    from repro import optim as joptim
    jadamw = importlib.import_module("repro.optim.adamw")
    jgrad_utils = importlib.import_module("repro.optim.grad_utils")
    from repro.training import TrainState as JTrainState
    from repro.training import abstract_train_state as jabstract
    from repro.training import make_train_step as jstep
    return dict(jax=jax, jnp=jnp, configs=jconfigs, pipeline=jpipeline,
                build=jbuild, losses=jlosses, optim=joptim, adamw=jadamw,
                grad_utils=jgrad_utils,
                TrainState=JTrainState, abstract=jabstract, step=jstep)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _rel(got, want) -> float:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------- schedules (the reference's tests) --------------------------
def test_wsd_shape():
    f = wsd(1e-3, total_steps=100, warmup_steps=10)
    lrs = [float(f(s)) for s in range(100)]
    assert lrs[0] < lrs[9] <= lrs[10] * 1.01          # warmup rises
    assert abs(lrs[50] - 1e-3) < 1e-9                 # stable plateau
    assert lrs[-1] < 1e-4                             # decayed at the end
    assert max(lrs) <= 1e-3 + 1e-9


def test_cosine_monotone_decay_after_warmup():
    f = cosine(1e-2, total_steps=50, warmup_steps=5)
    lrs = [float(f(torch.tensor(s))) for s in range(5, 50)]
    assert all(a >= b - 1e-12 for a, b in zip(lrs, lrs[1:]))


def test_schedules_match_reference(jx):
    jo, jnp = jx["optim"], jx["jnp"]
    pairs = [
        (constant(3e-4), jo.constant(3e-4)),
        (linear_warmup(constant(1e-3), 7), jo.linear_warmup(
            jo.constant(1e-3), 7)),
        (cosine(3e-4, 8, 1), jo.cosine(3e-4, 8, 1)),
        (cosine(1e-2, 50, 5, 0.2), jo.cosine(1e-2, 50, 5, 0.2)),
        (wsd(1e-3, 100, 10), jo.wsd(1e-3, 100, 10)),
    ]
    for ours, ref in pairs:
        for s in range(0, 110, 3):
            got, want = ours(s), np.asarray(ref(jnp.asarray(s, jnp.int32)))
            assert got.dtype == torch.float32 and got.dim() == 0
            assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


# ---------------- adamw (the reference's tests) ------------------------------
def test_adamw_reduces_quadratic_loss():
    opt = adamw(0.1, AdamWConfig(weight_decay=0.0))
    p = {"w": torch.tensor([3.0, -2.0])}
    st = opt.init(p)
    for _ in range(60):
        g = {"w": 2 * p["w"]}
        p, st = opt.update(p, g, st)
    assert float(p["w"].abs().max()) < 0.15


def test_quantized_adamw_tracks_exact():
    gen = torch.Generator().manual_seed(0)
    p0 = torch.randn((32, 256), generator=gen)
    exact, quant = adamw(1e-2), adamw(1e-2, AdamWConfig(quantized_state=True))
    pe, pq = {"w": p0.clone()}, {"w": p0.clone()}
    se, sq = exact.init(pe), quant.init(pq)
    for i in range(10):
        g = {"w": torch.randn((32, 256),
                              generator=torch.Generator().manual_seed(i + 1))}
        pe, se = exact.update(pe, g, se)
        pq, sq = quant.update(pq, g, sq)
    drift = float((pe["w"] - pq["w"]).abs().max())
    assert drift < 0.03, drift


def test_quantize_moment_roundtrip_shapes():
    for shape in [(7,), (3, 5), (4, 512), (2, 3, 394)]:
        x = torch.randn(shape, generator=torch.Generator().manual_seed(0))
        qm = quantize_moment(x)
        assert qm.q.shape == shape and qm.q.dtype == torch.int8
        y = dequantize_moment(qm, shape)
        assert y.shape == shape
        assert float((x - y).abs().max() / x.abs().max()) < 0.02


def test_quantize_moment_matches_reference(jx):
    jnp = jx["jnp"]
    rng = np.random.default_rng(0)
    for shape in [(), (3, 5), (4, 512)]:
        x = rng.standard_normal(shape).astype(np.float32)
        if shape == (4, 512):
            x[0, :256] = 0.0                 # an all-zero block: scale 0
        got = quantize_moment(torch.from_numpy(x))
        want = jx["adamw"].quantize_moment(jnp.asarray(x))
        assert np.array_equal(got.q.numpy(), np.asarray(want.q))
        assert _rel(got.scale, want.scale) < 1e-6
        deq = dequantize_moment(got, shape)
        assert _rel(deq, jx["adamw"].dequantize_moment(want, shape)) < 1e-6


# ---------------- grad utils (the reference's tests) -------------------------
def test_clip_by_global_norm():
    tree = {"a": torch.ones(4) * 3.0, "b": torch.ones(2, 2) * 4.0}
    clipped, norm = clip_by_global_norm(tree, 1.0)
    assert abs(float(global_norm(clipped)) - 1.0) < 1e-5
    assert float(norm) > 1.0


def test_accumulate_grads_matches_full_batch():
    class Lin(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.randn(
                (8, 1), generator=torch.Generator().manual_seed(0)))

    def loss_fn(p, batch):
        return ((batch["x"] @ p.w - batch["y"]) ** 2).mean(), {}

    gen = torch.Generator().manual_seed(1)
    p = Lin()
    batch = {"x": torch.randn((16, 8), generator=gen),
             "y": torch.randn((16, 1), generator=gen)}
    l1, _, g1 = accumulate_grads(loss_fn, p, batch, 1)
    l4, _, g4 = accumulate_grads(loss_fn, p, batch, 4)
    np.testing.assert_allclose(float(l1), float(l4), rtol=1e-5)
    np.testing.assert_allclose(g1["w"].numpy(), g4["w"].numpy(),
                               rtol=1e-4, atol=1e-6)


# ---------------- the repaired transients: bit for bit ----------------------
def _whole_leaf_update(p, g, st, lr, cfg, t):
    """AdamW's leaf update as one whole-leaf formula (the form the sliced,
    in-place update replaced): returns (new parameter, new moments)."""
    g = g.float()
    pf = p.float()
    if cfg.quantized_state:
        m = dequantize_moment(st["m"], p.shape)
        v = torch.square(dequantize_moment(st["v"], p.shape))
    else:
        m, v = st["m"], st["v"]
    m = cfg.b1 * m + (1.0 - cfg.b1) * g
    v = cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g)
    mhat = m / (1.0 - cfg.b1 ** t)
    vhat = v / (1.0 - cfg.b2 ** t)
    upd = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * pf
    new_p = (pf - lr * upd).to(p.dtype)
    if cfg.quantized_state:
        return new_p, {"m": quantize_moment(m),
                       "v": quantize_moment(torch.sqrt(v.double()).float())}
    return new_p, {"m": m, "v": v}


def _moments_equal(a, b) -> bool:
    return all(torch.equal(x, y) for k in ("m", "v")
               for x, y in zip(*(((s[k].q, s[k].scale)
                                  if hasattr(s[k], "q") else (s[k],))
                                 for s in (a, b))))


@pytest.mark.parametrize("shape", [(4, 40, 512), (300, 96)],
                         ids=["expert-3d", "2d"])
@pytest.mark.parametrize("quantized", [False, True], ids=["exact", "int8"])
def test_sliced_leaf_update_bit_equal_whole(monkeypatch, shape, quantized):
    """Three steps of ``_leaf_update`` in slices of whole rows (a last
    slice shorter than the rest) against the whole-leaf formula: the
    bf16 parameter and the moments (f32, or int8 ``q`` and ``scale``)
    equal bit for bit."""
    from repro_torch.optim.adamw import _leaf_init, _leaf_update

    tadamw = importlib.import_module("repro_torch.optim.adamw")

    cfg = AdamWConfig(quantized_state=quantized)
    gen = torch.Generator().manual_seed(5)
    p = torch.randn(shape, generator=gen).to(torch.bfloat16)
    p_ref, st, st_ref = p.clone(), _leaf_init(p, quantized), \
        _leaf_init(p, quantized)
    last = shape[-1]
    monkeypatch.setattr(tadamw, "SLICE_VALUES", 7 * last)
    assert (p.numel() // last) % 7   # rows not a multiple of 7
    for i in range(3):
        g = torch.randn(shape, generator=gen) * 10.0 ** -i
        lr, t = torch.tensor(3e-3 / (i + 1)), torch.tensor(float(i + 1))
        out = _leaf_update(p, g, st, lr, cfg, t)
        assert out is st                 # the moments updated in place
        p_ref, st_ref = _whole_leaf_update(p_ref, g, st_ref, lr, cfg, t)
        assert torch.equal(p, p_ref), i
        assert _moments_equal(st, st_ref), i


def test_inplace_accumulate_and_clip_bit_equal():
    """``accumulate_grads`` (f32 sums leaf by leaf, a tensor divisor in
    place) and ``clip_by_global_norm`` (in place) against the formulas
    they replaced -- a second tree of ``g / n_micro`` and a new tree of
    ``(g.float() * scale).to(g.dtype)`` -- bit for bit, on bf16 weights
    at n_micro = 3 (not a power of two) and on f32 and bf16 leaves."""
    cfg = get_reduced_config("gemma-2b")
    model = build_model(cfg, dtype=torch.bfloat16, device="cpu")
    params = model.make_params()
    init_params(params, torch.Generator().manual_seed(0))
    params.requires_grad_(True)
    batch = make_pipeline(cfg, ShapeConfig("t", 8, 6, "train"),
                          device="cpu").batch(0)
    loss, _, grads = accumulate_grads(model.loss, params, batch, 3)
    # the replaced formula: f32 sums, then a new tree divided by the count
    names = [n for n, _ in params.named_parameters()]
    loss_sum, grad_sum = None, None
    for i in range(3):
        mb = {k: x.reshape((3, 2) + tuple(x.shape[1:]))[i]
              for k, x in batch.items()}
        lm, _ = model.loss(params, mb)
        gs = torch.autograd.grad(lm, list(params.parameters()))
        lm = lm.detach().float()
        loss_sum = lm if loss_sum is None else loss_sum + lm
        if grad_sum is None:
            grad_sum = {n: g.float() for n, g in zip(names, gs)}
        else:
            for n, g in zip(names, gs):
                grad_sum[n] += g.float()
    assert torch.equal(loss, loss_sum / 3)
    assert all(torch.equal(grads[n], grad_sum[n] / 3) for n in names)
    # the clip, on the f32 sums and on bf16 copies, scale < 1
    for tree in (grads, {n: g.to(torch.bfloat16) for n, g in grads.items()}):
        wnorm = global_norm(tree)
        scale = torch.clamp(0.5 / torch.clamp(wnorm, min=1e-12), max=1.0)
        want = {n: (g.float() * scale).to(g.dtype) for n, g in tree.items()}
        got, gnorm = clip_by_global_norm(tree, 0.5)
        assert float(wnorm) > 0.5 and torch.equal(gnorm, wnorm)
        assert got is tree
        assert all(torch.equal(got[n], want[n]) for n in names)


# ---------------- one train step against the reference's ---------------------
def _no_drops(cfg):
    """A MoE config with capacity for every token on both sides: the
    port's kept-only capacity scatter is a deliberate difference."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))


@pytest.mark.parametrize("quantized,n_micro,arch", [
    pytest.param(False, 1, "gemma-2b", id="False-1"),
    pytest.param(True, 1, "gemma-2b", id="True-1"),
    pytest.param(False, 2, "gemma-2b", id="False-2"),
    pytest.param(True, 2, "gemma-2b", id="True-2"),
    # the MoE family's int8 moments and accumulation (the full dbrx-132b
    # config's train_4k cell selects int8 moments)
    pytest.param(True, 2, "dbrx-132b", id="dbrx-132b-True-2")])
def test_train_step_matches_reference(jx, monkeypatch, quantized, n_micro,
                                      arch):
    jax, jnp = jx["jax"], jx["jnp"]

    class F32Head:            # the reference's jnp with bf16 read as f32
        def __getattr__(self, name):
            return jnp.float32 if name == "bfloat16" else getattr(jnp, name)

    monkeypatch.setattr(jx["losses"], "jnp", F32Head())
    monkeypatch.setattr(tlosses, "HEAD_DTYPE", torch.float32)
    cfg = _no_drops(get_reduced_config(arch))
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    opt = adamw(cosine(3e-3, 10, 2), AdamWConfig(quantized_state=quantized))
    state = init_train_state(model, opt, torch.Generator().manual_seed(0))
    # a state one step in, so the moments and the count are not zero
    pipe = make_pipeline(cfg, ShapeConfig("t", 16, 4, "train"),
                         device="cpu")
    step = make_train_step(model, opt, n_micro=n_micro)
    state, _ = step(state, pipe.batch(0))
    jmodel = jx["build"](_no_drops(jx["configs"].get_reduced_config(arch)),
                         jnp.float32)
    jopt = jx["optim"].adamw(jx["optim"].cosine(3e-3, 10, 2),
                             jx["adamw"].AdamWConfig(
                                 quantized_state=quantized))
    jstate = jx["TrainState"].from_tree(jax.tree.map(
        jnp.asarray, convert.train_state_to_reference(state.tree(), cfg)))
    batch = pipe.batch(1)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    from_port = None
    if cfg.moe is not None:
        # The MoE step's gradients agree with the reference's within 2e-6
        # of each leaf's largest entry, but AdamW divides each entry by
        # its own RMS: a norm scale's small entries (the leaf ~2 lr after
        # two steps from zero) then carry that f32 rounding into the
        # parameter at ~1.2e-5 of its largest entry.  So the step is held
        # in its two halves at TOL: the gradients against the reference's
        # accumulate_grads, and the parameters against the reference's
        # AdamW from the port's own clipped gradients.
        _, _, pg = accumulate_grads(model.loss, state.params, batch, n_micro)
        _, _, jg = jx["grad_utils"].accumulate_grads(
            jmodel.loss, jstate.params, jbatch, n_micro)
        jg = convert.params_from_reference(jax.tree.map(np.asarray, jg), cfg)
        for name, g in pg.items():
            assert _rel(g, jg[name]) < TOL, name
        pg, _ = clip_by_global_norm(pg, 1.0)
        jparams, _ = jopt.update(jstate.params, jax.tree.map(
            jnp.asarray, convert.params_to_reference(pg, cfg)),
            jstate.opt_state, jstate.step)
        from_port = convert.params_from_reference(
            jax.tree.map(np.asarray, jparams), cfg)
    jnew, jmetrics = jax.jit(jx["step"](jmodel, jopt, n_micro=n_micro))(
        jstate, jbatch)
    new, metrics = step(state, batch)
    assert new.step == int(jnew.step) == 2
    for k in ("loss", "grad_norm", "xent"):
        assert _rel(metrics[k], jmetrics[k]) < TOL, k
    want = convert.train_state_from_reference(
        jax.tree.map(np.asarray, jnew.tree()), cfg)
    got = new.tree()
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        if from_port is not None and name.startswith("params."):
            w = from_port[name[len("params."):]]
        if name.endswith(".q"):
            # blocks whose moments fell below f32's normal range: XLA on
            # the CPU flushes those subnormals to zero, torch keeps them
            base = name[:-2]
            sg, sw = got[base + ".scale"], want[base + ".scale"]
            live = ~((sg < 1e-18) & (sw < 1e-18))
            live = live.repeat_interleave(g.shape[-1] // sg.shape[-1], -1)
            d = (g.int() - w.int()).abs()[live.reshape(g.shape)]
            assert int(d.max()) <= 1 and float((d > 0).float().mean()) \
                <= 1e-3, name
        elif g.dtype in (torch.int32, torch.int64):
            assert torch.equal(g, w), name
        else:
            assert _rel(g, w) < TOL, name


# ---------------- trainer: bit-exact restart (the reference's test) ----------
def test_trainer_restart_bit_exact():
    cfg = get_reduced_config("gemma-2b")
    model = build_model(cfg, device="cpu")
    pipe = make_pipeline(cfg, ShapeConfig("t", 32, 4, "train"),
                         device="cpu")
    opt = adamw(cosine(3e-3, 10, 2))
    quiet = dict(log_fn=lambda *_: None)
    ref_state, ref = Trainer(model, opt, pipe, TrainerConfig(
        total_steps=8, checkpoint_every=100, log_every=100), **quiet).run()
    with tempfile.TemporaryDirectory() as d:
        Trainer(model, opt, pipe, TrainerConfig(
            total_steps=5, checkpoint_every=5, checkpoint_dir=d,
            log_every=100), **quiet).run()
        state, resumed = Trainer(model, opt, pipe, TrainerConfig(
            total_steps=8, checkpoint_every=5, checkpoint_dir=d,
            log_every=100), **quiet).run()
    assert math.isclose(ref["loss"], resumed["loss"], rel_tol=0, abs_tol=0), \
        (ref["loss"], resumed["loss"])
    for name, t in ref_state.tree().items():
        assert torch.equal(t, state.tree()[name]), name


# ---------------- data pipeline ----------------------------------------------
def test_pipeline_random_access_deterministic():
    cfg = get_reduced_config("gemma-2b")
    shape = ShapeConfig("t", 64, 8, "train")
    b1 = make_pipeline(cfg, shape, seed=1, device="cpu").batch(17)
    b2 = make_pipeline(cfg, shape, seed=1, device="cpu").batch(17)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (8, 64) and b1["tokens"].dtype == torch.int32
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


def test_pipeline_host_sharding_partitions_batch():
    cfg = get_reduced_config("gemma-2b")
    shape = ShapeConfig("t", 32, 8, "train")
    full = make_pipeline(cfg, shape, device="cpu").batch(3)
    parts = [make_pipeline(cfg, shape, process_index=i, process_count=4,
                           device="cpu").batch(3) for i in range(4)]
    assert torch.equal(torch.cat([p["tokens"] for p in parts]),
                       full["tokens"])


def test_pipeline_modality_stubs():
    cfgv = get_reduced_config("paligemma-3b")
    sh = ShapeConfig("t", 64, 2, "train")
    b = make_pipeline(cfgv, sh, device="cpu").batch(0)
    assert b["patches"].shape == (2, cfgv.num_prefix_tokens, cfgv.d_model)
    assert b["tokens"].shape[1] == 64 - cfgv.num_prefix_tokens
    cfga = get_reduced_config("whisper-medium")
    b = make_pipeline(cfga, sh, device="cpu").batch(0)
    assert b["frames"].shape == (2, 64, cfga.d_model)
    assert b["frames"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["gemma-2b", "paligemma-3b",
                                  "whisper-medium"])
def test_pipeline_equals_reference_bit_for_bit(jx, arch):
    shape = ShapeConfig("t", 24, 4, "train")
    for proc in (0, 1):
        ours = make_pipeline(get_reduced_config(arch), shape, seed=5,
                             process_index=proc, process_count=2,
                             device="cpu").batch(9)
        ref = jx["pipeline"](jx["configs"].get_reduced_config(arch), shape,
                             seed=5, process_index=proc,
                             process_count=2).batch(9)
        assert set(ours) == set(ref)
        for k, v in ours.items():
            want = np.asarray(ref[k])
            if v.dtype == torch.bfloat16:
                assert np.array_equal(v.float().numpy(),
                                      want.astype(np.float32)), k
            else:
                assert np.array_equal(v.numpy(), want), k


# ---------------- shapes, specs and abstract state ---------------------------
def test_shapes_cells_and_specs_match_reference(jx):
    jc = jx["configs"]
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jc.SHAPES.items()}
    assert list(iter_cells()) == list(jc.iter_cells())
    jnp = jx["jnp"]
    for arch in ("gemma-2b", "paligemma-3b", "whisper-medium"):
        model = build_model(get_reduced_config(arch), device="cpu")
        jmodel = jx["build"](jc.get_reduced_config(arch))
        for kind in ("train", "prefill", "decode"):
            shape = ShapeConfig("t", 32, 2, kind)
            ours, ref = model.input_specs(shape), jmodel.input_specs(
                jc.ShapeConfig("t", 32, 2, kind))
            assert set(ours) == set(ref)
            for k, v in ours.items():
                assert v.device.type == "meta"
                assert tuple(v.shape) == ref[k].shape
                assert str(v.dtype).split(".")[-1] == jnp.dtype(
                    ref[k].dtype).name


def test_abstract_params_and_bytes_match_reference(jx):
    from repro.models import params as jparams

    from repro_torch.models.params import abstract_params, tree_bytes
    for arch, dtype in (("gemma-2b", torch.bfloat16),
                        ("rwkv6-3b", torch.float32)):
        model = build_model(get_reduced_config(arch), dtype=dtype,
                            device="cpu")
        jmodel = jx["build"](jx["configs"].get_reduced_config(arch),
                             jx["jnp"].float32 if dtype == torch.float32
                             else jx["jnp"].bfloat16)
        assert tree_bytes(model.specs, dtype) == jparams.tree_bytes(
            jmodel.specs)
        meta = abstract_params(model.specs, dtype)
        assert meta["embed"].device.type == "meta"
        assert meta["embed"].dtype == dtype
        assert tuple(meta["embed"].shape) == jmodel.specs["embed"].shape


@pytest.mark.parametrize("quantized", [False, True])
def test_abstract_train_state_matches_reference(jx, quantized):
    jax = jx["jax"]
    cfg = get_reduced_config("qwen2.5-14b")
    model = build_model(cfg, device="cpu")
    opt = adamw(1e-3, AdamWConfig(quantized_state=quantized))
    jmodel = jx["build"](jx["configs"].get_reduced_config("qwen2.5-14b"))
    jopt = jx["optim"].adamw(1e-3, jx["adamw"].AdamWConfig(
        quantized_state=quantized))
    ours = abstract_train_state(model, opt).tree()
    assert all(t.device.type == "meta" for t in ours.values())
    ref = jx["abstract"](jmodel.specs, jopt).tree()
    # the reference's tree carried through the converter, shapes only
    want = convert.train_state_from_reference(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), ref), cfg)
    assert set(ours) == set(want)
    for name, t in ours.items():
        assert tuple(t.shape) == tuple(want[name].shape), name
    fresh = init_train_state(model, opt, torch.Generator().manual_seed(0))
    for name, t in fresh.tree().items():
        assert t.dtype == ours[name].dtype and t.shape == ours[name].shape


# ---------------- launcher, example, device, imports -------------------------
def test_launcher_and_example_run_on_cpu(capsys, tmp_path):
    assert train_launch.main(["--arch", "rwkv6-3b", "--reduced", "--device",
                              "cpu", "--steps", "2", "--global-batch", "2",
                              "--seq-len", "16", "--log-every", "1"]) == 0
    assert "[trainer] step 2/2" in capsys.readouterr().out
    main = runpy.run_path(str(EXAMPLE), run_name="example")["main"]
    main(["--steps", "1", "--device", "cpu", "--ckpt-dir",
          str(tmp_path / "ck")])
    assert "[example] final loss" in capsys.readouterr().out
    assert (tmp_path / "ck" / "step_00000001" / "MANIFEST.json").exists()


def test_entry_points_refuse_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced_config("gemma-2b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_pipeline(cfg, ShapeConfig("t", 8, 2, "train"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_launch.main(["--arch", "gemma-2b", "--reduced"])


def test_import_loads_neither_jax_nor_reference():
    code = ("import sys, repro_torch.optim, repro_torch.training, "
            "repro_torch.checkpoint, repro_torch.data, "
            "repro_torch.models.losses, repro_torch.launch.train, "
            "repro_torch.launch.shardings, repro_torch.launch.mesh, "
            "repro_torch.launch.serve, repro_torch.launch.dryrun, "
            "repro_torch.launch.fft_dryrun, repro_torch.launch.roofline, "
            "repro_torch.launch.report, repro_torch.launch.cost_analysis, "
            "repro_torch.serving.serve_step, "
            "repro_torch.optim.gradient_coding, "
            "repro_torch.optim.compression, repro_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m == 'repro' or m.startswith('repro.') "
            "or m.startswith('ml_dtypes')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
