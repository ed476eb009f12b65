"""The port's Griffin hybrid (``models/rglru.py``: recurrentgemma-9b)
against the JAX package's, on the CPU.

The JAX package's seeded weights are carried across by
``convert.griffin_params_from_reference`` (the pattern slots' stacked
layers interleaved into ``layers.<i>``, then the tail), with every zero-
or one-initialised vector perturbed first (the zero-centred norm
weights, ``conv_b``, ``ba``, ``bx``, ``lam``).  Stated tolerances,
relative to the largest magnitude:

* 1e-5: ``rglru_apply``'s doubling scan against JAX's
  ``associative_scan`` (T = 1, 7, 64, 100, with and without a carry-in
  state), prefill then decode steps against the JAX decode,
  ``_causal_conv`` at T < W - 1, one recurrent and one attention layer;
  reduced recurrentgemma-9b with f32 weights: prefill logits, every
  layer's state and decode steps, on a full attention cache and on the
  16-slot ring past its window, after a prefill shorter and one longer
  than the window.  Two f32 implementations of the same sums (the scans
  add in different orders); the head rounds its inputs to bf16 on both
  sides;
* 5%: bf16 weights on both sides.

The engine's greedy tokens must equal the JAX ``GenerationEngine``'s
(batch 3, prompt 8, 8 new tokens, cache 64).  The tests on the card are
in ``tests/test_torch_transformer_gpu.py``.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_reduced_config
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.models import rglru as trg
from repro_torch.serving import EngineConfig, GenerationEngine

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import GenerationEngine as JGenerationEngine  # noqa: E402

ARCH = "recurrentgemma-9b"
TOL = 1e-5
BF16_TOL = 0.05
B, CACHE = 2, 32
C = 24                                   # d_rnn of the standalone tests


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


# -- the RG-LRU and the conv on their own ---------------------------------
@pytest.fixture(scope="module")
def lru():
    rng = np.random.default_rng(0)
    p = {"wa": rng.standard_normal((C, C)) / np.sqrt(C),
         "wx": rng.standard_normal((C, C)) / np.sqrt(C),
         "ba": 0.5 * rng.standard_normal(C), "bx": 0.5 * rng.standard_normal(C),
         "lam": 1.0 + 0.5 * rng.standard_normal(C)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return (types.SimpleNamespace(**{k: torch.from_numpy(v)
                                     for k, v in p.items()}),
            {k: jnp.asarray(v) for k, v in p.items()})


def _x(seed, t, c=C, b=B):
    return np.random.default_rng(seed).standard_normal((b, t, c)).astype(
        np.float32)


@pytest.mark.parametrize("t", [1, 7, 64, 100])
@pytest.mark.parametrize("carry", [False, True])
def test_doubling_scan_matches_associative_scan(lru, t, carry):
    p, jp = lru
    x = _x(t, t)
    h0 = (np.random.default_rng(1).standard_normal((B, C)).astype(np.float32)
          if carry else None)
    got, h = trg.rglru_apply(p, torch.from_numpy(x),
                             None if h0 is None else torch.from_numpy(h0),
                             "prefill")
    want, jh = jrg.rglru_apply(jp, jnp.asarray(x),
                               None if h0 is None else jnp.asarray(h0),
                               "prefill")
    assert _rel(got, want) < TOL and _rel(h, jh) < TOL
    assert h.dtype == torch.float32


def test_doubling_scan_is_the_recurrence():
    """Against a float64 loop h_t = a_t h_{t-1} + b_t, T not a power of
    two; the first output of the products is a_0."""
    rng = np.random.default_rng(2)
    a = rng.uniform(0.2, 1.0, (3, 37, 5))
    b = rng.standard_normal((3, 37, 5))
    a_seq, h_seq = trg.doubling_scan(torch.from_numpy(a),
                                     torch.from_numpy(b))
    h, want, prod = np.zeros((3, 5)), [], np.ones((3, 5))
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        prod = prod * a[:, t]
        want.append(h)
        assert np.allclose(a_seq[:, t].numpy(), prod, rtol=1e-12)
    np.testing.assert_allclose(h_seq.numpy(), np.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


def test_prefill_then_decode_matches_jax_decode(lru):
    p, jp = lru
    x = _x(3, 7)
    h0 = np.zeros((B, C), np.float32)
    _, h = trg.rglru_apply(p, torch.from_numpy(x), torch.from_numpy(h0),
                           "prefill")
    _, jh = jrg.rglru_apply(jp, jnp.asarray(x), jnp.asarray(h0), "prefill")
    for i in range(3):
        xs = _x(10 + i, 1)
        got, h = trg.rglru_apply(p, torch.from_numpy(xs), h, "decode")
        want, jh = jrg.rglru_apply(jp, jnp.asarray(xs), jh, "decode")
        assert got.shape == (B, 1, C)
        assert _rel(got, want) < TOL and _rel(h, jh) < TOL


@pytest.mark.parametrize("t", [1, 2, 5])
def test_causal_conv_matches_jax(t):
    """Prefill at T = 1, 2 (shorter than the W - 1 = 3 history: its cache
    keeps padded zeros) and 5, then a decode step from that cache."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((4, C)).astype(np.float32)
    b = (0.5 * rng.standard_normal(C)).astype(np.float32)
    x = _x(5, t)
    cache0 = np.zeros((B, 3, C), np.float32)
    y, cache = trg._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b), torch.from_numpy(cache0),
                                "prefill")
    jy, jcache = jrg._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), jnp.asarray(cache0),
                                  "prefill")
    assert _rel(y, jy) < TOL
    assert cache.shape == (B, 3, C)
    np.testing.assert_array_equal(cache.numpy(), np.asarray(jcache))
    if t < 3:
        assert not cache[:, :3 - t].any()
    xs = _x(6, 1)
    y, cache = trg._causal_conv(torch.from_numpy(xs), torch.from_numpy(w),
                                torch.from_numpy(b), cache, "decode")
    jy, jcache = jrg._causal_conv(jnp.asarray(xs), jnp.asarray(w),
                                  jnp.asarray(b), jcache, "decode")
    assert _rel(y, jy) < TOL
    np.testing.assert_array_equal(cache.numpy(), np.asarray(jcache))


# -- the reduced model ----------------------------------------------------
def _carried(dtype, seed=0, **overrides):
    import dataclasses

    jcfg = dataclasses.replace(jget_reduced(ARCH), **overrides)
    cfg = dataclasses.replace(get_reduced_config(ARCH), **overrides)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jmodel = jbuild(jcfg, dtype=jdtype)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = path[-1].key
        if name == "w":                  # zero-centred: stored as w - 1
            return (0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
        if name in ("conv_b", "ba", "bx"):
            return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        if name == "lam":
            return (a + 0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    model = build_model(cfg, dtype=dtype, device="cpu")
    params = model.make_params()
    params.load_state_dict(convert.griffin_params_from_reference(tree))
    return {"jcfg": jcfg, "cfg": cfg, "jmodel": jmodel,
            "jparams": jax.tree.map(jnp.asarray, tree), "tree": tree,
            "model": model, "params": params,
            "jprefill": jax.jit(jmodel.prefill),
            "jdecode": jax.jit(jmodel.decode_step)}


@pytest.fixture(scope="module")
def f32():
    return _carried(torch.float32)


@pytest.fixture(scope="module")
def bf16():
    return _carried(torch.bfloat16)


def _jlayer(tree_or_state, cfg, i):
    """Layer ``i`` of a JAX Griffin tree or state: slot i % P at repeat
    i // P of ``blocks``, then ``tail``."""
    pat = cfg.recurrent.block_pattern
    n_blocks = (cfg.n_layers // len(pat)) * len(pat)
    if i < n_blocks:
        return jax.tree.map(lambda a: a[i // len(pat)],
                            tree_or_state["blocks"][i % len(pat)])
    return tree_or_state["tail"][i - n_blocks]


def _check_state(state, jstate, cfg, tol):
    for i, st in enumerate(state):
        want = _jlayer(jstate, cfg, i)
        assert set(st) == set(want), i
        for key, got in st.items():
            w = np.asarray(want[key]).astype(np.float32)
            assert got.dtype == (torch.float32 if key in ("conv", "h")
                                 else state[i][key].dtype)
            assert _rel(got, w) < tol, (i, key)


def _run_both(m, t, steps, tol, cache_len=CACHE, seed=5):
    cfg = m["cfg"]
    toks = np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (B, t)).astype(np.int32)
    state = m["model"].init_cache(B, cache_len)
    jstate = m["jmodel"].init_cache(B, cache_len)
    logits, state = m["model"].prefill(m["params"],
                                       {"tokens": torch.from_numpy(toks)},
                                       state)
    jlogits, jstate = m["jprefill"](m["jparams"],
                                    {"tokens": jnp.asarray(toks)}, jstate)
    assert logits.dtype == torch.float32 and logits.shape == (B, 1,
                                                              cfg.vocab_size)
    assert _rel(logits, jlogits) < tol
    _check_state(state, jstate, cfg, tol)
    rng = np.random.default_rng(seed + 1)
    for i in range(steps):
        tok = rng.integers(1, cfg.vocab_size, (B, 1)).astype(np.int32)
        logits, state = m["model"].decode_step(
            m["params"], state, {"tokens": torch.from_numpy(tok)}, t + i)
        jlogits, jstate = m["jdecode"](m["jparams"], jstate,
                                       {"tokens": jnp.asarray(tok)},
                                       jnp.asarray(t + i, jnp.int32))
        assert _rel(logits, jlogits) < tol, i
        _check_state(state, jstate, cfg, tol)
    return state


def test_layout_and_state_follow_the_pattern(f32):
    cfg, params = f32["cfg"], f32["params"]
    kinds = trg.layer_kinds(cfg)
    assert kinds == ("rec", "rec", "attn", "rec", "rec")
    for layer, kind in zip(params.layers, kinds):
        assert layer.kind == kind and hasattr(layer, kind)
    rec = params.layers[0].rec
    for name in ("conv_w", "conv_b", "ba", "bx", "lam"):
        assert getattr(rec, name).dtype == torch.float32
    state = f32["model"].init_cache(3, 64)
    assert state[2]["k"].shape == (3, cfg.attn_window, cfg.n_kv_heads,
                                   cfg.head_dim)
    assert state[0]["conv"].shape == (3, cfg.recurrent.conv_width - 1,
                                      cfg.recurrent.d_rnn)
    assert state[0]["h"].shape == (3, cfg.recurrent.d_rnn)
    assert f32["model"].init_cache(3, 8)[2]["v"].shape[1] == 8
    with pytest.raises(ValueError, match="cache_len"):
        f32["model"].init_cache(1)


@pytest.mark.parametrize("kind_index", [0, 2])
def test_temporal_layer_matches_jax(f32, kind_index):
    """A recurrent layer and the attention layer (prefill, no state)
    against JAX's ``_temporal_layer``."""
    m, cfg = f32, f32["cfg"]
    kind = trg.layer_kinds(cfg)[kind_index]
    x = _x(7, 12, c=cfg.d_model)
    pos = np.arange(12)
    cos, sin = tlayers.rotary_cos_sin(torch.from_numpy(pos), cfg.head_dim,
                                      cfg.rope_theta)
    jcos, jsin = jlayers.rotary_cos_sin(jnp.asarray(pos), cfg.head_dim,
                                        cfg.rope_theta)
    want, _ = jrg._temporal_layer(
        jax.tree.map(jnp.asarray, _jlayer(m["tree"], cfg, kind_index)),
        m["jcfg"], kind, jnp.asarray(x), None, "prefill", jcos, jsin, None)
    got = m["params"].layers[kind_index](torch.from_numpy(x), cos, sin,
                                         mode="prefill")
    assert _rel(got, want) < TOL


def test_f32_prefill_state_and_decode_match_jax(f32):
    _run_both(f32, t=12, steps=2, tol=TOL)


@pytest.mark.parametrize("t,steps", [(12, 6), (20, 2)])
def test_decode_past_the_window_on_the_ring(f32, t, steps):
    """A 16-slot ring (cache_len 32 > window 16): a 12-token prefill
    decoded past slot 16, and a 20-token prefill that keeps its last 16
    tokens, then decoded."""
    state = _run_both(f32, t=t, steps=steps, tol=TOL, seed=t)
    assert state[2]["k"].shape[1] == f32["cfg"].attn_window


def test_cache_shorter_than_the_window(f32):
    """cache_len 8 < window 16: no ring; decode matches JAX up to the
    cache's end, then raises (the reference would clamp the write)."""
    m = f32
    state = _run_both(m, t=6, steps=2, tol=TOL, cache_len=8, seed=7)
    with pytest.raises(ValueError, match="past the cache"):
        m["model"].decode_step(m["params"], state,
                               {"tokens": torch.ones((B, 1), dtype=torch.int32)},
                               8)


def test_bf16_prefill_and_decode_match_jax(bf16):
    assert bf16["params"].layers[0].rec.wa.dtype == torch.bfloat16
    assert bf16["params"].layers[0].rec.lam.dtype == torch.float32
    assert bf16["model"].init_cache(1, 8)[2]["k"].dtype == torch.bfloat16
    _run_both(bf16, t=12, steps=2, tol=BF16_TOL, seed=8)


def test_prefill_then_decode_matches_longer_prefill(f32):
    """prefill(8) against prefill(7) and one decode step: the conv
    history and h carry into decode exactly (the head's bf16 rounding
    aside)."""
    m, cfg = f32, f32["cfg"]
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        1, cfg.vocab_size, (1, 8)).astype(np.int32))
    full, _ = trg.griffin_prefill(m["params"], {"tokens": toks},
                                  m["model"].init_cache(1, CACHE))
    _, state = trg.griffin_prefill(m["params"], {"tokens": toks[:, :-1]},
                                   m["model"].init_cache(1, CACHE))
    step, _ = trg.griffin_decode_step(m["params"], state,
                                      {"tokens": toks[:, -1:]}, 7)
    assert torch.equal(full.argmax(-1), step.argmax(-1))
    assert _rel(step, full.numpy()) < 1e-2


def test_engine_greedy_matches_jax_engine(f32):
    ecfg = dict(batch_size=3, prompt_len=8, max_new_tokens=8, cache_len=64)
    eng = GenerationEngine(f32["model"], f32["params"], EngineConfig(**ecfg))
    jeng = JGenerationEngine(f32["jmodel"], f32["jparams"],
                             JEngineConfig(**ecfg))
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, f32["cfg"].vocab_size, n))
               for n in (8, 6, 3)]
    got = eng.generate(prompts)
    assert got == jeng.generate(prompts)
    assert all(len(o) == 8 for o in got)


def test_convert_maps_blocks_then_tail(f32):
    tree, params, cfg = f32["tree"], f32["params"], f32["cfg"]
    for i, layer in enumerate(params.layers):
        want = _jlayer(tree, cfg, i)
        mod = getattr(layer, layer.kind)
        assert np.array_equal(mod.wq.numpy() if layer.kind == "attn"
                              else mod.wa.numpy(),
                              want[layer.kind]["wq" if layer.kind == "attn"
                                               else "wa"])
    assert np.array_equal(params.embed.numpy(), tree["embed"])
    assert len(tree["tail"]) == 2 and len(params.layers) == 5
