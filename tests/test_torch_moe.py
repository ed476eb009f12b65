"""The port's MoE family (``models/moe.py`` and the transformer's MoE
layers: dbrx-132b, llama4-maverick-400b-a17b) against the JAX package's,
on the CPU.

The JAX package's seeded weights are carried across by
``convert.transformer_params_from_reference`` (llama4's two superblock
slots, dense and MoE, interleaved into ``layers.<i>``), with the
zero-initialised norm weights perturbed first.  Stated tolerances,
relative to the largest magnitude:

* 1e-5: ``moe_ffn`` (both router styles, with and without the shared
  expert) and its aux loss where no expert overflows; group-local
  dispatch (``_dp_groups`` patched to 2 in both packages); the reduced
  configs with f32 weights: prefill logits, the KV cache and two decode
  steps at 2 x 4 tokens (at most 8 a call: the capacity floor of 8 slots
  drops nothing, so JAX's overflow fault below cannot show);
* 5%: bf16 weights on both sides.

Where an expert overflows, the port writes only its kept assignments
(the capacity buffer's docstring); the JAX package scatters each dropped
one as a zero row at slot 0 of its expert, which on XLA's CPU backend
overwrites the token there.  ``test_overflow_*`` hold the port to a
numpy kept-only reference and show JAX different on exactly the slot-0
rows, by exactly those experts' terms.

The engine's greedy tokens must equal the JAX ``GenerationEngine``'s on
reduced llama4 (batch 3, prompt 8, 8 new tokens, cache 64); parameter
and active-parameter counts the JAX ``build_model``'s for the three full
configs of this slice.  The tests on the card are in
``tests/test_torch_transformer_gpu.py``.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import (MoESettings, get_config,
                                 get_reduced_config)
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.params import ParamModule
from repro_torch.serving import EngineConfig, GenerationEngine

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
from repro.configs import MoESettings as JMoESettings  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import GenerationEngine as JGenerationEngine  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("dbrx-132b", "llama4-maverick-400b-a17b")
TOL = 1e-5
BF16_TOL = 0.05
B, T, CACHE = 2, 4, 32
D, FF = 32, 48


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _rel(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- moe_ffn on its own ---------------------------------------------------
def _settings(style, shared):
    """Llama-4's router is top-1 sigmoid, DBRX's top-k softmax."""
    k = 1 if style == "sigmoid" else 2
    kw = dict(num_experts=4, top_k=k, d_ff_expert=FF,
              num_shared_experts=int(shared))
    return MoESettings(**kw), JMoESettings(**kw)


def _moe_params(moe, seed, bias=0.0):
    """Seeded numpy weights; ``bias`` adds to expert 0's router column,
    which tokens with a positive mean then prefer."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(
        np.float32)
    p = {"router": mk(D, 4), "wi": mk(4, D, FF), "wg": mk(4, D, FF),
         "wo": mk(4, FF, D)}
    p["router"][:, 0] += bias
    if moe.num_shared_experts:
        p.update(shared_wi=mk(D, FF), shared_wg=mk(D, FF),
                 shared_wo=mk(FF, D))
    return p


def _port_params(moe, p):
    mod = ParamModule(tmoe.moe_layer_specs(D, moe), torch.float32, "cpu")
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    return mod


def _inputs(seed, b, s, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, D)) + shift).astype(np.float32)


def _both(x, p, moe, jmoe_cfg, style):
    got, aux = tmoe.moe_ffn(torch.from_numpy(x), _port_params(moe, p), moe,
                            router_style=style)
    want, jaux = jmoe.moe_ffn(jnp.asarray(x),
                              {k: jnp.asarray(v) for k, v in p.items()},
                              jmoe_cfg, router_style=style)
    return got, aux, np.asarray(want), float(jaux)


def _kept_only(x, p, moe, style, groups=1):
    """numpy float64: each token's kept experts' gated FFNs (an expert
    keeps its first ``capacity`` assignments in token order within its
    group) plus the shared expert.  Returns (out (T, D), the rows at slot
    0 of an overflowing expert: {token: [(expert, gated term)]})."""
    x = x.reshape(-1, D).astype(np.float64)
    p = {k: v.astype(np.float64) for k, v in p.items()}
    e, k = moe.num_experts, moe.top_k
    tl = x.shape[0] // groups
    cap = tmoe.moe_capacity(tl, moe)
    silu = lambda v: v / (1.0 + np.exp(-v))
    expert = lambda v, i: (silu(v @ p["wg"][i]) * (v @ p["wi"][i])) @ p["wo"][i]
    out, first = np.zeros_like(x), {}
    for g in range(groups):
        lo = g * tl
        logits = x[lo:lo + tl] @ p["router"]
        if style == "sigmoid":
            idx = np.argsort(-logits, axis=-1, kind="stable")[:, :k]
            gates = 1.0 / (1.0 + np.exp(-np.take_along_axis(logits, idx, -1)))
        else:
            probs = np.exp(logits - logits.max(-1, keepdims=True))
            probs /= probs.sum(-1, keepdims=True)
            idx = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
            gates = np.take_along_axis(probs, idx, -1)
            gates /= gates.sum(-1, keepdims=True)
        count, slot0 = np.zeros(e, int), {}
        for t in range(tl):
            for j in range(k):
                ei = idx[t, j]
                term = gates[t, j] * expert(x[lo + t], ei)
                if count[ei] == 0:
                    slot0[ei] = (lo + t, term)
                if count[ei] < cap:
                    out[lo + t] += term
                count[ei] += 1
        for ei in np.flatnonzero(count > cap):
            t, term = slot0[ei]
            first.setdefault(t, []).append((int(ei), term))
    if moe.num_shared_experts:
        out += (silu(x @ p["shared_wg"]) * (x @ p["shared_wi"])) \
            @ p["shared_wo"]
    return out, first


STYLES = [("softmax", False), ("softmax", True), ("sigmoid", False),
          ("sigmoid", True)]


@pytest.mark.parametrize("style,shared", STYLES)
def test_moe_ffn_matches_jax_without_overflow(style, shared):
    """2 x 4 tokens: every expert's capacity (the floor of 8) holds all
    it gets, so nothing drops in either package."""
    moe, jm = _settings(style, shared)
    p, x = _moe_params(moe, 1), _inputs(2, 2, 4)
    got, aux, want, jaux = _both(x, p, moe, jm, style)
    assert _rel(got, want) < TOL
    assert abs(float(aux) - jaux) < TOL * abs(jaux)
    assert aux.dtype == torch.float32 and aux.shape == ()
    r = tmoe.route_tokens(torch.from_numpy(x).reshape(1, 8, D),
                          torch.from_numpy(p["router"]), moe, 8, style)
    assert bool(r.keep.all())
    np.testing.assert_allclose(got.numpy().reshape(-1, D),
                               _kept_only(x, p, moe, style)[0], rtol=0,
                               atol=TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("style,shared", STYLES)
def test_overflow_port_keeps_only_kept_assignments(style, shared):
    """4 experts over 32 tokens, the router biased to expert 0 (capacity
    20 at top-2, 10 at top-1): expert 0 overflows, and the port equals
    the numpy kept-only reference."""
    moe, _ = _settings(style, shared)
    p, x = _moe_params(moe, 3, bias=0.3), _inputs(4, 1, 32, shift=1.0)
    assert tmoe.moe_capacity(32, moe) == (20 if moe.top_k == 2 else 10)
    got, _ = tmoe.moe_ffn(torch.from_numpy(x), _port_params(moe, p), moe,
                          router_style=style)
    want, first = _kept_only(x, p, moe, style)
    assert 0 in {ei for terms in first.values() for ei, _ in terms}
    assert _rel(got.reshape(-1, D), want) < TOL


@pytest.mark.parametrize("style,shared", STYLES)
def test_overflow_jax_loses_slot_zero_rows(style, shared):
    """At the same overflowing size JAX equals the port on every row but
    the tokens at slot 0 of an overflowing expert, and each of those rows
    is the kept-only row less exactly those experts' gated terms: JAX's
    dropped assignments overwrite slot 0 with zeros."""
    moe, jm = _settings(style, shared)
    p, x = _moe_params(moe, 3, bias=0.3), _inputs(4, 1, 32, shift=1.0)
    got, aux, want, jaux = _both(x, p, moe, jm, style)
    got, want = got.numpy().reshape(-1, D), want.reshape(-1, D)
    kept, first = _kept_only(x, p, moe, style)
    scale = float(np.abs(kept).max())
    rows = sorted(first)
    assert rows, "no expert overflowed"
    others = np.setdiff1d(np.arange(32), rows)
    assert np.abs(got[others] - want[others]).max() < TOL * scale
    for t in rows:
        lost = sum(term for _, term in first[t])
        assert np.abs(want[t] - (kept[t] - lost)).max() < TOL * scale, t
        assert np.abs(got[t] - want[t]).max() > 100 * TOL * scale, t
    assert abs(float(aux) - jaux) < TOL * abs(jaux)


@pytest.mark.parametrize("style,shared", [("softmax", True),
                                          ("sigmoid", False)])
def test_dispatch_groups_are_group_local(monkeypatch, style, shared):
    """``_dp_groups`` patched to 2 in both packages: 2 x 8 tokens as two
    groups of 8 (capacity 8 a group, no drop) equal JAX's; 2 x 32 biased
    tokens (capacity 20 or 10 a group) equal the numpy kept-only
    reference with a capacity per group."""
    monkeypatch.setattr(tmoe, "_dp_groups", lambda n: 2)
    monkeypatch.setattr(jmoe, "_dp_groups", lambda n: 2)
    moe, jm = _settings(style, shared)
    p, x = _moe_params(moe, 5), _inputs(6, 2, 8)
    got, aux, want, jaux = _both(x, p, moe, jm, style)
    assert _rel(got, want) < TOL
    assert abs(float(aux) - jaux) < TOL * abs(jaux)
    p, x = _moe_params(moe, 3, bias=0.3), _inputs(7, 2, 32, shift=1.0)
    got, _ = tmoe.moe_ffn(torch.from_numpy(x), _port_params(moe, p), moe,
                          router_style=style)
    want, first = _kept_only(x, p, moe, style, groups=2)
    assert {t // 32 for t in first} == {0, 1}
    assert _rel(got.reshape(-1, D), want) < TOL
    assert _rel(got.reshape(-1, D), _kept_only(x, p, moe, style)[0]) > 1e-3


def test_moe_capacity_and_router_refusal():
    moe = MoESettings(num_experts=128, top_k=1, d_ff_expert=8)
    assert tmoe.moe_capacity(1024, moe) == 10      # llama4, 2 x 512
    assert tmoe.moe_capacity(2, moe) == 8          # the floor
    assert tmoe.moe_capacity(4, MoESettings(16, 4, 8)) == 8
    assert tmoe.moe_capacity(1024, MoESettings(16, 4, 8)) == 320
    for n, m in ((1024, moe), (7, MoESettings(4, 2, 8))):
        assert tmoe.moe_capacity(n, m) == jmoe.moe_capacity(
            n, JMoESettings(m.num_experts, m.top_k, m.d_ff_expert))
    assert tmoe._dp_groups(64) == 1
    with pytest.raises(ValueError, match="router style"):
        tmoe.route_tokens(torch.zeros((1, 2, D)), torch.zeros((D, 4)),
                          MoESettings(4, 2, 8), 8, "argmax")


# -- the reduced models ---------------------------------------------------
def _carried(jcfg, cfg, dtype, seed=0):
    """The JAX model of ``jcfg`` in ``dtype`` with its norm weights
    perturbed, and the port's model and parameters carrying them."""
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jmodel = jbuild(jcfg, dtype=jdtype)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        if path[-1].key == "w":          # zero-centred: stored as w - 1
            return (0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    model = build_model(cfg, dtype=dtype, device="cpu")
    params = model.make_params()
    params.load_state_dict(convert.transformer_params_from_reference(tree))
    return {"jcfg": jcfg, "cfg": cfg, "jmodel": jmodel,
            "jparams": jax.tree.map(jnp.asarray, tree), "tree": tree,
            "model": model, "params": params,
            "jprefill": jax.jit(jmodel.prefill),
            "jdecode": jax.jit(jmodel.decode_step)}


@pytest.fixture(scope="module", params=ARCHS)
def f32(request):
    return _carried(jget_reduced(request.param),
                    get_reduced_config(request.param), torch.float32)


@pytest.fixture(scope="module", params=ARCHS)
def bf16(request):
    return _carried(jget_reduced(request.param),
                    get_reduced_config(request.param), torch.bfloat16)


@pytest.fixture(scope="module")
def llama4():
    arch = "llama4-maverick-400b-a17b"
    return _carried(jget_reduced(arch), get_reduced_config(arch),
                    torch.float32)


def _check_cache(cache, jcache, step, tol, rows):
    """Layer i of the port's cache is slot i % step, repeat i // step of
    the JAX package's; compared on batch ``rows``."""
    for kv in ("k", "v"):
        got = cache[kv][:, rows]
        want = np.stack([np.asarray(jcache[i % step][kv][i // step])
                         for i in range(got.shape[0])])[:, rows]
        assert _rel(got, want.astype(np.float32)) < tol, kv


NEAR_TIE = 0.1   # router logits: a bf16 rounding's reach at these sizes


@pytest.fixture
def routes(monkeypatch):
    """Each MoE call's f32 router logits (tokens, E), in both packages
    (a test-time wrapper; the JAX side through a debug callback)."""
    rec = {"port": [], "jax": []}
    real, jreal = tmoe.moe_ffn, jmoe.moe_ffn

    def port(x, p, moe, *, router_style="softmax"):
        rec["port"].append((x.reshape(-1, x.shape[-1]).float()
                            @ p.router).numpy())
        return real(x, p, moe, router_style=router_style)

    def jport(x, p, moe, *, router_style="softmax"):
        logits = x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ p["router"]
        jax.debug.callback(lambda v: rec["jax"].append(np.asarray(v)),
                           logits, ordered=True)
        return jreal(x, p, moe, router_style=router_style)

    monkeypatch.setattr(tmoe, "moe_ffn", port)
    monkeypatch.setattr(jmoe, "moe_ffn", jport)
    return rec


def _diverged(routes, k, seq):
    """Batch rows with a token the two packages send to different experts
    in this call; each such token must be a near tie (its k-th and
    (k+1)-th router logits within NEAR_TIE in one package)."""
    jax.effects_barrier()
    port, jx = routes["port"], routes["jax"]
    assert len(port) == len(jx) > 0
    rows = set()
    for lp, lj in zip(port, jx):
        for t in range(lp.shape[0]):
            sp, sj = np.argsort(-lp[t])[:k], np.argsort(-lj[t])[:k]
            if set(sp) != set(sj):
                margin = min(np.sort(lp[t])[-k] - np.sort(lp[t])[-k - 1],
                             np.sort(lj[t])[-k] - np.sort(lj[t])[-k - 1])
                assert margin < NEAR_TIE, (t, lp[t], lj[t])
                rows.add(t // seq)
    port.clear()
    jx.clear()
    return rows


def _run_both(m, steps, tol, seed, routes=None):
    """Prefill 2 x 4 seeded tokens in both packages, then ``steps`` decode
    steps; logits and caches compared after each.  With ``routes``, a
    batch row whose tokens the packages route apart at a near tie (bf16)
    is left out from then on."""
    cfg = m["cfg"]
    step_len = cfg.moe.interleave_step
    live = set(range(B))
    toks = np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (B, T)).astype(np.int32)
    cache = m["model"].init_cache(B, CACHE)
    jcache = m["jmodel"].init_cache(B, CACHE)
    logits, cache = m["model"].prefill(m["params"],
                                       {"tokens": torch.from_numpy(toks)},
                                       cache)
    jlogits, jcache = m["jprefill"](m["jparams"],
                                    {"tokens": jnp.asarray(toks)}, jcache)
    assert logits.dtype == torch.float32 and logits.shape == (B, 1,
                                                              cfg.vocab_size)
    if routes is not None:
        live -= _diverged(routes, cfg.moe.top_k, T)
    rows = sorted(live)
    assert rows
    assert _rel(logits[rows], np.asarray(jlogits)[rows]) < tol
    _check_cache(cache, jcache, step_len, tol, rows)
    rng = np.random.default_rng(seed + 1)
    for i in range(steps):
        tok = rng.integers(1, cfg.vocab_size, (B, 1)).astype(np.int32)
        logits, cache = m["model"].decode_step(
            m["params"], cache, {"tokens": torch.from_numpy(tok)}, T + i)
        jlogits, jcache = m["jdecode"](m["jparams"], jcache,
                                       {"tokens": jnp.asarray(tok)},
                                       jnp.asarray(T + i, jnp.int32))
        if routes is not None:
            live -= _diverged(routes, cfg.moe.top_k, 1)
        rows = sorted(live)
        assert rows
        assert _rel(logits[rows], np.asarray(jlogits)[rows]) < tol, i
        _check_cache(cache, jcache, step_len, tol, rows)
    return live


def test_layers_follow_the_moe_flags(f32):
    cfg, params = f32["cfg"], f32["params"]
    flags = cfg.moe_layer_flags
    assert flags == f32["jcfg"].moe_layer_flags
    assert [layer.is_moe for layer in params.layers] == list(flags)
    for layer, is_moe in zip(params.layers, flags):
        assert hasattr(layer, "moe") == is_moe
        assert hasattr(layer, "mlp") != is_moe
    moe_layer = params.layers[flags.index(True)]
    assert moe_layer.moe.router.dtype == torch.float32
    assert moe_layer.router_style == ("sigmoid" if cfg.moe.top_k == 1
                                      else "softmax")
    assert ("shared_wi" in moe_layer.moe.specs) == bool(
        cfg.moe.num_shared_experts)


def test_moe_layer_matches_jax(f32):
    """One MoE decoder layer (attention, then the MoE FFN) against JAX's
    ``_layer_apply`` on 2 x 4 tokens, the output and the aux loss."""
    from repro.models import layers as jlayers
    from repro.models import transformer as jtf
    from repro_torch.models import layers as tlayers

    m, cfg = f32, f32["cfg"]
    step = cfg.moe.interleave_step
    i = cfg.moe_layer_flags.index(True)
    x = np.random.default_rng(8).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    pos = np.arange(T)
    cos, sin = tlayers.rotary_cos_sin(torch.from_numpy(pos), cfg.head_dim,
                                      cfg.rope_theta)
    jcos, jsin = jlayers.rotary_cos_sin(jnp.asarray(pos), cfg.head_dim,
                                        cfg.rope_theta)
    jlayer = jax.tree.map(lambda a: jnp.asarray(a[i // step]),
                          m["tree"]["blocks"][i % step])
    want, _, jaux = jtf._layer_apply(jlayer, m["jcfg"], jnp.asarray(x), jcos,
                                     jsin, is_moe=True, mode="prefill",
                                     cache=None, step=None, prefix_len=None)
    got, aux = m["params"].layers[i](torch.from_numpy(x), cos, sin,
                                     mode="prefill")
    assert _rel(got, want) < TOL
    assert abs(float(aux) - float(jaux)) < TOL * abs(float(jaux))


def test_f32_prefill_cache_and_decode_match_jax(f32):
    _run_both(f32, steps=2, tol=TOL, seed=5)


def test_bf16_prefill_and_decode_match_jax(bf16, routes):
    """bf16 weights on both sides, within 5%.  A token whose top-k
    router logits tie within a bf16 rounding may go to another expert in
    each package (llama4's top-1 at seed 6: its last token's two best
    logits 0.001 apart in JAX, 0.054 in the port): its batch row is then
    compared up to that call only."""
    layer = bf16["params"].layers[bf16["cfg"].moe_layer_flags.index(True)]
    assert layer.moe.wi.dtype == torch.bfloat16
    assert layer.moe.router.dtype == torch.float32
    _run_both(bf16, steps=2, tol=BF16_TOL, seed=6, routes=routes)


def test_decoder_hidden_sums_the_aux_losses(f32):
    """``with_aux`` returns the MoE layers' summed aux beside the hidden
    state, as the reference's ``decoder_hidden`` does."""
    from repro.models import transformer as jtf

    m, cfg = f32, f32["cfg"]
    toks = np.random.default_rng(9).integers(1, cfg.vocab_size,
                                             (B, T)).astype(np.int32)
    embeds = ttf.embed_tokens(m["params"], torch.from_numpy(toks))
    hidden, aux = ttf.decoder_hidden(m["params"], embeds, mode="prefill",
                                     with_aux=True)
    jhidden, _, jaux = jtf.decoder_hidden(
        m["jparams"], m["jcfg"],
        jtf.embed_tokens(m["jparams"], m["jcfg"], jnp.asarray(toks)),
        mode="train")
    assert _rel(hidden, jhidden) < TOL
    assert abs(float(aux) - float(jaux)) < TOL * abs(float(jaux))
    assert torch.equal(hidden, ttf.decoder_hidden(m["params"], embeds,
                                                  mode="prefill"))


def test_prefill_then_decode_matches_longer_prefill(f32):
    """prefill(8) against prefill(7) and one decode step at 1 x 8 (the
    capacity floor drops nothing): the same next token and logits."""
    m, cfg = f32, f32["cfg"]
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        1, cfg.vocab_size, (1, 8)).astype(np.int32))
    full, _ = ttf.lm_prefill(m["params"], {"tokens": toks},
                             m["model"].init_cache(1, CACHE))
    _, cache = ttf.lm_prefill(m["params"], {"tokens": toks[:, :-1]},
                              m["model"].init_cache(1, CACHE))
    step, _ = ttf.lm_decode_step(m["params"], cache,
                                 {"tokens": toks[:, -1:]}, 7)
    assert torch.equal(full.argmax(-1), step.argmax(-1))
    assert _rel(step, full.numpy()) < 1e-2


# -- the engine -----------------------------------------------------------
def test_engine_greedy_matches_jax_engine(llama4):
    """The prefill of 3 x 8 tokens drops 3 of 24 assignments in each MoE
    layer (capacity 8), so JAX's slot-0 rows differ there; the greedy
    tokens agree all the same."""
    ecfg = dict(batch_size=3, prompt_len=8, max_new_tokens=8, cache_len=64)
    eng = GenerationEngine(llama4["model"], llama4["params"],
                           EngineConfig(**ecfg))
    jeng = JGenerationEngine(llama4["jmodel"], llama4["jparams"],
                             JEngineConfig(**ecfg))
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, llama4["cfg"].vocab_size, n))
               for n in (8, 6, 3)]
    got = eng.generate(prompts)
    assert got == jeng.generate(prompts)
    assert all(len(o) == 8 for o in got)


# -- construction ---------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS + ("recurrentgemma-9b",))
def test_param_counts_match_jax_full_config(arch):
    """Specs only: nothing is allocated."""
    got, want = build_model(get_config(arch), device="cpu"), jbuild(
        jget_config(arch))
    assert (got.n_params, got.n_active_params) == (want.n_params,
                                                   want.n_active_params)
    if arch == "recurrentgemma-9b":
        assert got.n_active_params == got.n_params
    else:
        assert got.n_active_params < got.n_params


@pytest.mark.parametrize("arch", ARCHS + ("recurrentgemma-9b",))
def test_configs_copy_the_reference(arch):
    for got, want in ((get_config(arch), jget_config(arch)),
                      (get_reduced_config(arch), jget_reduced(arch))):
        for f in dataclasses.fields(got):
            w = getattr(want, f.name)
            g = getattr(got, f.name)
            if dataclasses.is_dataclass(w):
                assert dataclasses.asdict(g) == dataclasses.asdict(w), f.name
            else:
                assert g == w, f.name


def test_non_periodic_moe_pattern_is_refused():
    cfg = dataclasses.replace(get_reduced_config(ARCHS[1]), n_layers=3)
    with pytest.raises(ValueError, match="non-periodic"):
        build_model(cfg, device="cpu")


def test_convert_interleaves_superblock_slots(llama4):
    """llama4's slots (dense, MoE) land as layers 0, 2 (dense) and 1, 3
    (MoE); slots of different depths are refused."""
    tree, params = llama4["tree"], llama4["params"]
    for i, layer in enumerate(params.layers):
        slot = tree["blocks"][i % 2]
        if i % 2:
            assert np.array_equal(layer.moe.wi.numpy(),
                                  slot["moe"]["wi"][i // 2])
        else:
            assert np.array_equal(layer.mlp.wi.numpy(),
                                  slot["mlp"]["wi"][i // 2])
    short = jax.tree.map(lambda a: a[:1], tree["blocks"][1])
    with pytest.raises(ValueError, match="superblock"):
        convert.transformer_params_from_reference(
            dict(tree, blocks=[tree["blocks"][0], short]))


def test_entry_points_refuse_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ARCHS + ("recurrentgemma-9b",):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(get_config(arch))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--arch", arch, "--reduced"])


@pytest.mark.parametrize("arch", ARCHS + ("recurrentgemma-9b",))
def test_serve_launcher_runs_on_cpu(capsys, arch):
    assert serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--prompts", "2", "--prompt-len", "10",
                       "--new-tokens", "3", "--cache-len", "16"]) == 0
    assert capsys.readouterr().out.count("generated 3 tokens") == 2


def test_import_loads_neither_jax_nor_reference():
    code = ("import sys, repro_torch.models.moe, repro_torch.models.rglru, "
            "repro_torch.models.model_factory, repro_torch.convert, "
            "repro_torch.configs.dbrx_132b, "
            "repro_torch.configs.llama4_maverick_400b_a17b, "
            "repro_torch.configs.recurrentgemma_9b, "
            "repro_torch.launch.serve; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m == 'repro' or m.startswith('repro.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
