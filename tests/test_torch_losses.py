"""The port's training losses and their gradients against the JAX
package, on the CPU.

* The loss head (``models/losses.py``): the chunked cross-entropy and its
  recomputing backward against ``jax.value_and_grad`` of the reference's
  ``sharded_xent_loss``: the loss within 1e-6 and the gradients equal
  bit for bit except where one side's f32 product rounds to the
  neighbouring bf16 value (at most 1% of the entries, each one bf16 step
  of the entry, or within 1e-4 of the largest entry where a sum cancels
  to a small value).  The reference rounds the head's gradients to bf16 even
  with f32 weights, so that is the agreement two f32 matrix-product
  libraries can reach there.
* Every family's ``BuiltModel.loss`` (dense, vlm, moe, ssm, hybrid,
  encdec on their reduced configs, the port's seeded weights with every
  zero or one vector perturbed, carried to the JAX package by
  ``convert.params_to_reference``) against
  ``jax.grad`` of the reference's loss with f32 weights: the loss and
  every parameter's gradient within 1e-5 of its largest entry, with the
  head in f32 on both sides (``losses.HEAD_DTYPE`` here, the
  reference's ``jnp.bfloat16`` read as float32 there) and RWKV-6's
  chunked WKV streaming f32 on both sides -- the bf16 rounding points
  the reference keeps in an f32 model turn the two libraries' last-bit
  differences into bf16 steps.  RWKV-6's gradients within 1e-3: its
  per-head group norm (eps 64e-5) magnifies last-bit differences where a
  head's output is near zero (position 0 from a zero state), 2.2e-4 at
  the unperturbed init.  The MoE configs run with capacity factor 8 so
  no expert overflows (overflow is where the port keeps the kept tokens
  and the reference overwrites slot 0; ``tests/test_torch_moe.py``).
* With bf16 weights: ``tests/test_torch_losses_bf16.py``.
* The flash backward of ``chunked_attention``:
  ``tests/test_torch_attention.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_reduced_config
from repro_torch.models import build_model
from repro_torch.models import losses as tlosses
from repro_torch.models import rwkv6 as trwkv

TOL = 1e-5
ARCHS = {"dense": "gemma-2b", "vlm": "paligemma-3b", "moe": "dbrx-132b",
         "ssm": "rwkv6-3b", "hybrid": "recurrentgemma-9b",
         "encdec": "whisper-medium"}
B, T = 2, 8


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from repro.configs import get_reduced_config as jreduced
    from repro.models import build_model as jbuild
    from repro.models import losses as jlosses
    from repro.models import rwkv6 as jrwkv
    return dict(jax=jax, jnp=jnp, reduced=jreduced, build=jbuild,
                losses=jlosses, rwkv=jrwkv)


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


# -- the loss head ------------------------------------------------------------
@pytest.mark.parametrize("divisor,s,chunk", [(1.0, 40, 16), (2.5, 24, 256)])
def test_xent_head_matches_jax(jx, divisor, s, chunk):
    jax, jnp = jx["jax"], jx["jnp"]
    rng = np.random.default_rng(int(s))
    d, v = 64, 256
    h = (3 * rng.standard_normal((2, s, d))).astype(np.float32)
    w = rng.standard_normal((d, v)).astype(np.float32)
    lab = rng.integers(0, v, (2, s)).astype(np.int32)
    mask = (rng.random((2, s)) < 0.8).astype(np.float32)

    def jloss(hh, ww):
        total, count = jx["losses"].sharded_xent_loss(
            hh, ww, jnp.asarray(lab), mask=jnp.asarray(mask),
            logit_divisor=divisor, seq_chunk=chunk)
        return total / count

    want, (wgh, wgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    total, count = tlosses.sharded_xent_loss(
        th, tw, torch.from_numpy(lab), mask=torch.from_numpy(mask),
        logit_divisor=divisor, seq_chunk=chunk)
    loss = total / count
    assert float(count) == mask.sum()
    assert abs(float(loss) - float(want)) <= 1e-6 * abs(float(want))
    gh, gw = torch.autograd.grad(loss, [th, tw])
    # each position's hidden gradient is one f32 product rounded to bf16
    # (the unembedding's sums those of the chunks in f32)
    assert np.array_equal(gh.numpy(), gh.numpy().astype(
        jnp.bfloat16).astype(np.float32))
    for got, ref in ((gh, wgh), (gw, wgw)):
        got, ref = got.numpy(), np.asarray(ref)
        diff = got != ref
        assert diff.mean() <= 0.01
        step = np.ldexp(1.0, np.frexp(np.abs(ref[diff]))[1] - 8)  # bf16 ulp
        bound = np.maximum(step * 1.0001, 1e-4 * np.abs(ref).max())
        assert np.all(np.abs(got[diff] - ref[diff]) <= bound)


# -- every family's loss and gradients -----------------------------------------
def _carried(jx, fam, dtype):
    """The port's reduced model of ``fam`` in ``dtype`` from a seeded init
    with every zero or one vector perturbed, and the JAX model carrying
    the same weights (``convert.params_to_reference``, cast to the
    reference's dtypes)."""
    jax, jnp = jx["jax"], jx["jnp"]
    cfg, jcfg = get_reduced_config(ARCHS[fam]), jx["reduced"](ARCHS[fam])
    if cfg.moe is not None:      # capacity for every token: nothing drops
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=8.0))
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jmodel = jx["build"](jcfg, jdtype)
    model = build_model(cfg, dtype=dtype, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in params.parameters():
            if not p.any() or bool((p == 1).all()):
                p += torch.from_numpy(
                    0.2 * rng.standard_normal(p.shape)).to(p.dtype)
    params.requires_grad_(True)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    jparams = jax.tree.map(lambda a, sd: jnp.asarray(a, sd.dtype),
                           convert.params_to_reference(
                               params.state_dict(), cfg), shapes)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)),
             "labels": rng.integers(0, cfg.vocab_size, (B, T))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    if fam == "encdec":
        batch["frames"] = rng.standard_normal((B, T, cfg.d_model))
    if fam == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_prefix_tokens, cfg.d_model))
    for k in ("frames", "patches"):
        if k in batch:
            batch[k] = batch[k].astype(np.float32)
    jbatch = {k: jnp.asarray(v, jdtype if v.dtype == np.float32 else None)
              for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in ("frames", "patches"):
        if k in tbatch:
            tbatch[k] = tbatch[k].to(dtype)
    return dict(cfg=cfg, jmodel=jmodel, jparams=jparams, model=model,
                params=params, jbatch=jbatch, tbatch=tbatch)


def _both(jx, m):
    jax = jx["jax"]
    (want, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        m["jmodel"].loss, has_aux=True))(m["jparams"], m["jbatch"])
    loss, metrics = m["model"].loss(m["params"], m["tbatch"])
    named = list(m["params"].named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    ref = convert.params_from_reference(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jgrads), m["cfg"])
    return (loss, metrics, {n: g for (n, _), g in zip(named, grads)},
            want, jmetrics, ref)


@pytest.mark.parametrize("fam", list(ARCHS))
def test_family_loss_and_grads_match_jax(jx, fam, monkeypatch):
    class F32Head:            # the reference's jnp with bf16 read as f32
        def __getattr__(self, name):
            jnp = jx["jnp"]
            return jnp.float32 if name == "bfloat16" else getattr(jnp, name)

    monkeypatch.setattr(jx["losses"], "jnp", F32Head())
    monkeypatch.setattr(tlosses, "HEAD_DTYPE", torch.float32)
    monkeypatch.setattr(jx["rwkv"], "wkv_chunked", functools.partial(
        jx["rwkv"].wkv_chunked, stream_dtype=jx["jnp"].float32))
    monkeypatch.setattr(trwkv, "wkv_chunked", functools.partial(
        trwkv.wkv_chunked, stream_dtype=torch.float32))
    m = _carried(jx, fam, torch.float32)
    loss, metrics, grads, want, jmetrics, ref = _both(jx, m)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert _rel(loss, want) < TOL
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        assert _rel(metrics[k], jmetrics[k]) < TOL, k
    assert set(grads) == set(ref)
    tol = 1e-3 if fam == "ssm" else TOL
    for name, g in grads.items():
        assert g.dtype == torch.float32
        assert _rel(g, ref[name]) < tol, name
