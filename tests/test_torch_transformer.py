"""The port's decoder-only transformer (families dense and vlm) against
the JAX package's, on the CPU.

The JAX package's seeded weights of each reduced config are carried
across by ``convert.transformer_params_from_reference``, with every
zero-initialised vector perturbed first (the zero-centred norm weights,
the QKV biases) so that each term counts.  Stated tolerances, relative
to the largest magnitude:

* 1e-5: the layers (norms, MLPs, RoPE, one attention block, one decoder
  layer) and, with f32 weights, each reduced config's prefill logits,
  its KV cache and two decode steps; the same for a ring cache
  (``attn_window=8``), layer norms (``norm="ln"``) and the int8 cache
  against the JAX int8 cache.
  Two f32 implementations of the same sums; the head rounds its inputs
  to bf16 on both sides;
* 5%: bf16 weights on both sides (the JAX ``build_model`` default, and
  what the port serves), prefill and two decode steps.

The engine's greedy tokens must equal the JAX ``GenerationEngine``'s on
reduced gemma-2b (batch 3, prompt 16, 8 new tokens, cache 64), EOS
truncation included; parameter counts must equal the JAX
``build_model``'s for the five full configs.  The tests on the card are
in ``tests/test_torch_transformer_gpu.py``, which imports no JAX.
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
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.launch import serve
from repro_torch.models import attention as tatt
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.models.params import count_params
from repro_torch.serving import EngineConfig, GenerationEngine

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.attention import QuantKV as JQuantKV  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import GenerationEngine as JGenerationEngine  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("gemma-2b", "minicpm-2b", "qwen2.5-14b", "qwen1.5-32b",
         "paligemma-3b")
TOL = 1e-5
BF16_TOL = 0.05
B, T, CACHE = 2, 12, 32


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


def _carried(jcfg, cfg, dtype, seed=0):
    """The JAX model of ``jcfg`` in ``dtype`` with its perturbed weights,
    and the port's model and parameters carrying the same weights."""
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jmodel = jbuild(jcfg, dtype=jdtype)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = path[-1].key
        if name == "w":                  # zero-centred: stored as w - 1
            return (0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
        if name in ("bq", "bk", "bv", "b"):
            return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
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
def gemma():
    return _carried(jget_reduced("gemma-2b"), get_reduced_config("gemma-2b"),
                    torch.float32)


def _batch(cfg, seed, t=T, b=B):
    """Seeded tokens (and, for the vlm, patch embeddings): numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (b, t)).astype(
        np.int32)}
    if cfg.num_prefix_tokens:
        batch["patches"] = rng.standard_normal(
            (b, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _jcache_leaves(jcache):
    """The JAX cache's one stacked slot as numpy ``{"k", "v"}``, int8
    caches as (q, scale)."""
    out = {}
    for kv, leaf in jcache[0].items():
        out[kv] = ((np.asarray(leaf.q), np.asarray(leaf.scale))
                   if isinstance(leaf, JQuantKV) else np.asarray(leaf))
    return out


def _check_cache(cache, jcache, tol):
    want = _jcache_leaves(jcache)
    for kv in ("k", "v"):
        got = cache[kv]
        if isinstance(got, tatt.QuantKV):
            jq, js = want[kv]
            deq = got.q.float() * got.scale
            assert _rel(deq, jq.astype(np.float32) * js) < tol, kv
        else:
            assert _rel(got, want[kv].astype(np.float32)) < tol, kv


def _run_both(m, batch, steps, tol, *, quantized=False, cache_len=CACHE,
              decode_seed=99):
    """Prefill ``batch`` on both packages, then ``steps`` decode steps fed
    the same seeded tokens; logits and caches compared after each."""
    cfg = m["cfg"]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    cache = m["model"].init_cache(B, cache_len, quantized=quantized)
    jcache = m["jmodel"].init_cache(B, cache_len, quantized=quantized)
    logits, cache = m["model"].prefill(m["params"], tb, cache)
    jlogits, jcache = m["jprefill"](m["jparams"], jb, jcache)
    assert logits.dtype == torch.float32 and logits.shape == (B, 1,
                                                              cfg.vocab_size)
    assert _rel(logits, jlogits) < tol
    _check_cache(cache, jcache, tol)
    s0 = batch["tokens"].shape[1] + (cfg.num_prefix_tokens
                                     if "patches" in batch else 0)
    rng = np.random.default_rng(decode_seed)
    for i in range(steps):
        tok = rng.integers(1, cfg.vocab_size, (B, 1)).astype(np.int32)
        logits, cache = m["model"].decode_step(
            m["params"], cache, {"tokens": torch.from_numpy(tok)}, s0 + i)
        jlogits, jcache = m["jdecode"](m["jparams"], jcache,
                                       {"tokens": jnp.asarray(tok)},
                                       jnp.asarray(s0 + i, jnp.int32))
        assert _rel(logits, jlogits) < tol, i
        _check_cache(cache, jcache, tol)
    return cache


# -- the layers ---------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (0.2 * rng.standard_normal(64)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    want = np.asarray(jlayers.rms_norm(jx, jnp.asarray(w)).astype(
        jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = tlayers.rms_norm(tx, torch.from_numpy(w))
    assert got.dtype == tx.dtype
    # bf16 out: one rounding of the same f32 value
    assert _rel(got, want) < (TOL if dtype == "float32" else 2 ** -8)


@pytest.mark.parametrize("variant", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_jax(variant):
    rng = np.random.default_rng(2)
    mk = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(
        np.float32)
    p = {"wi": mk(32, 48), "wo": mk(48, 32)}
    if variant != "gelu":
        p["wg"] = mk(32, 48)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    want = jlayers.mlp_apply(jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in p.items()},
                             variant)
    tp = type("P", (), {k: torch.from_numpy(v) for k, v in p.items()})
    got = tlayers.mlp_apply(torch.from_numpy(x), tp, variant)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_rotary_matches_jax(theta):
    pos = np.asarray([0, 1, 7, 100, 511, 1023])
    cos, sin = tlayers.rotary_cos_sin(torch.from_numpy(pos), 16, theta)
    jcos, jsin = jlayers.rotary_cos_sin(jnp.asarray(pos), 16, theta)
    assert _rel(cos, jcos) < TOL and _rel(sin, jsin) < TOL
    x = np.random.default_rng(3).standard_normal((2, 6, 3, 16)).astype(
        np.float32)
    got = tlayers.apply_rotary(torch.from_numpy(x), cos, sin)
    want = jlayers.apply_rotary(jnp.asarray(x), jcos, jsin)
    assert _rel(got, want) < TOL
    # half-split, not interleaved: position 0 leaves x as it is
    np.testing.assert_allclose(got[:, 0].numpy(), x[:, 0], rtol=0, atol=0)


def test_attention_block_and_layer_match_jax(f32):
    """One attention block (prefill) and one decoder layer of each
    reduced config against JAX's ``attn_apply`` / ``_layer_apply``."""
    m, cfg = f32, f32["cfg"]
    x = np.random.default_rng(4).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    pos = np.arange(T)
    cos, sin = tlayers.rotary_cos_sin(torch.from_numpy(pos), cfg.head_dim,
                                      cfg.rope_theta)
    jcos, jsin = jlayers.rotary_cos_sin(jnp.asarray(pos), cfg.head_dim,
                                        cfg.rope_theta)
    jlayer = jax.tree.map(lambda a: jnp.asarray(a[1]),
                          m["tree"]["blocks"][0])
    prefix = cfg.num_prefix_tokens or None
    want, _ = jtf.attn_apply(jlayer["attn"], m["jcfg"], jnp.asarray(x), jcos,
                             jsin, mode="prefill", prefix_len=prefix,
                             window=cfg.attn_window)
    layer = m["params"].layers[1]
    got = ttf.attn_apply(layer.attn, cfg, torch.from_numpy(x), cos, sin,
                         mode="prefill", prefix_len=prefix)
    assert _rel(got, want) < TOL
    want, _, _ = jtf._layer_apply(jlayer, m["jcfg"], jnp.asarray(x), jcos,
                                  jsin, is_moe=False, mode="prefill",
                                  cache=None, step=None, prefix_len=prefix)
    got, aux = layer(torch.from_numpy(x), cos, sin, mode="prefill",
                     prefix_len=prefix)
    assert aux is None
    assert _rel(got, want) < TOL


# -- the whole model ------------------------------------------------------
def test_f32_prefill_cache_and_decode_match_jax(f32):
    _run_both(f32, _batch(f32["cfg"], seed=5), steps=2, tol=TOL)


def test_ring_cache_matches_jax():
    """``attn_window=8`` on reduced gemma-2b: an 8-slot ring cache; the
    12-token prefill keeps its last 8 tokens, decode writes at step mod 8."""
    jcfg = dataclasses.replace(jget_reduced("gemma-2b"), attn_window=8)
    cfg = dataclasses.replace(get_reduced_config("gemma-2b"), attn_window=8)
    m = _carried(jcfg, cfg, torch.float32)
    cache = _run_both(m, _batch(cfg, seed=6), steps=2, tol=TOL)
    assert cache["k"].shape[2] == 8


def test_layer_norm_variant_matches_jax():
    """``norm="ln"`` (layer norm with weight and bias) on reduced
    qwen2.5-14b: prefill, cache and two decode steps."""
    jcfg = dataclasses.replace(jget_reduced("qwen2.5-14b"), norm="ln")
    cfg = dataclasses.replace(get_reduced_config("qwen2.5-14b"), norm="ln")
    m = _carried(jcfg, cfg, torch.float32)
    assert m["params"].layers[0].ln1.b.dtype == torch.float32
    _run_both(m, _batch(cfg, seed=12), steps=2, tol=TOL)


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen2.5-14b"])
def test_int8_cache_matches_jax(arch):
    m = _carried(jget_reduced(arch), get_reduced_config(arch),
                 torch.float32)
    cache = _run_both(m, _batch(m["cfg"], seed=7), steps=2, tol=TOL,
                      quantized=True)
    assert cache["k"].q.dtype == torch.int8


def test_bf16_prefill_and_decode_match_jax(bf16):
    assert bf16["params"].layers[0].attn.wq.dtype == torch.bfloat16
    assert bf16["params"].layers[0].ln1.w.dtype == torch.float32
    _run_both(bf16, _batch(bf16["cfg"], seed=8), steps=2, tol=BF16_TOL)


def test_prefill_then_decode_matches_longer_prefill(f32):
    """prefill(T) against prefill(T-1) and one decode step at T-1: the
    same next token and logits (the head's bf16 rounding aside)."""
    m, cfg = f32, f32["cfg"]
    batch = _batch(cfg, seed=9)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    full, _ = ttf.lm_prefill(m["params"], tb, m["model"].init_cache(B, CACHE))
    short = dict(tb, tokens=tb["tokens"][:, :-1])
    _, cache = ttf.lm_prefill(m["params"], short,
                              m["model"].init_cache(B, CACHE))
    s0 = T - 1 + (cfg.num_prefix_tokens if "patches" in batch else 0)
    step, _ = ttf.lm_decode_step(m["params"], cache,
                                 {"tokens": tb["tokens"][:, -1:]}, s0)
    assert torch.equal(full.argmax(-1), step.argmax(-1))
    assert _rel(step, full.numpy()) < 1e-2


def test_decode_past_the_cache_raises(gemma):
    m = gemma
    cache = m["model"].init_cache(1, 4)
    tok = torch.ones((1, 1), dtype=torch.int32)
    for s in range(4):
        m["model"].decode_step(m["params"], cache, {"tokens": tok}, s)
    with pytest.raises(ValueError, match="past the cache"):
        m["model"].decode_step(m["params"], cache, {"tokens": tok}, 4)
    with pytest.raises(ValueError, match="cache_len"):
        m["model"].init_cache(1)


def test_tied_unembed_is_a_view(gemma):
    p = gemma["params"]
    w = ttf.unembed_matrix(p)
    assert w.data_ptr() == p.embed.data_ptr() and w.shape == p.embed.shape[::-1]
    assert not hasattr(p, "unembed")
    untied = build_model(get_reduced_config("qwen2.5-14b"), device="cpu")
    assert ttf.unembed_matrix(untied.make_params()).shape == (64, 256)


def test_vlm_prefix_is_bidirectional():
    """With patches the prefix attends both ways (a change to the last
    patch moves the first patch's hidden state); the text stays causal (a
    change to the last token moves no earlier position)."""
    cfg = get_reduced_config("paligemma-3b")
    params = build_model(cfg, dtype=torch.float32, device="cpu").init(
        torch.Generator().manual_seed(2))
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=10).items()}

    def hidden(batch):
        embeds, prefix = ttf._prep_embeds(params, batch)
        assert prefix == cfg.num_prefix_tokens
        assert embeds.shape[1] == cfg.num_prefix_tokens + T
        return ttf.decoder_hidden(params, embeds, mode="prefill",
                                  prefix_len=prefix)

    h0 = hidden(tb)
    patches = tb["patches"].clone()
    patches[:, -1] += 1.0
    h1 = hidden(dict(tb, patches=patches))
    assert not torch.allclose(h0[:, 0], h1[:, 0])
    tokens = tb["tokens"].clone()
    tokens[:, -1] = tokens[:, -1] % (cfg.vocab_size - 1) + 1
    h2 = hidden(dict(tb, tokens=tokens))
    assert torch.equal(h0[:, :-1], h2[:, :-1])
    assert not torch.allclose(h0[:, -1], h2[:, -1])


# -- the engine -----------------------------------------------------------
@pytest.fixture(scope="module")
def engines(gemma):
    ecfg = dict(batch_size=3, prompt_len=16, max_new_tokens=8, cache_len=64)
    return (GenerationEngine(gemma["model"], gemma["params"],
                             EngineConfig(**ecfg)),
            JGenerationEngine(gemma["jmodel"], gemma["jparams"],
                              JEngineConfig(**ecfg)))


def _prompts(cfg, seed):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, cfg.vocab_size, n)) for n in (16, 10, 5)]


def test_engine_greedy_matches_jax_engine(gemma, engines):
    eng, jeng = engines
    prompts = _prompts(gemma["cfg"], 0)
    got = eng.generate(prompts)
    assert got == jeng.generate(prompts)
    assert all(len(o) == 8 for o in got)
    assert got == eng.generate(prompts)


def test_engine_eos_truncation_matches_jax_engine(gemma, engines):
    eng, jeng = engines
    prompts = _prompts(gemma["cfg"], 1)
    base = eng.generate(prompts)
    eos = base[0][1]                 # force EOS at row 0's second token
    eng.ecfg.eos_id = jeng.ecfg.eos_id = eos
    try:
        out, jout = eng.generate(prompts), jeng.generate(prompts)
    finally:
        eng.ecfg.eos_id = jeng.ecfg.eos_id = None
    assert out == jout
    for got, want in zip(out, base):
        assert got == (want[:want.index(eos) + 1] if eos in want else want)


# -- construction ---------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_jax_full_config(arch):
    cfg = get_config(arch)
    n = count_params(ttf.transformer_specs(cfg))
    assert n == jbuild(jget_config(arch)).n_params
    assert build_model(get_reduced_config(arch), device="cpu").n_params == \
        sum(p.numel() for p in build_model(get_reduced_config(arch),
                                           device="cpu").make_params()
            .parameters())


def test_init_fills_every_parameter():
    cfg = get_reduced_config("qwen2.5-14b")
    model = build_model(cfg, device="cpu")
    a = model.init(torch.Generator().manual_seed(1))
    b = model.init(torch.Generator().manual_seed(1))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    attn = a.layers[0].attn
    assert attn.wq.dtype == torch.bfloat16 and not attn.bq.any()
    assert a.layers[0].ln1.w.dtype == torch.float32 and not a.layers[0].ln1.w.any()
    assert abs(float(a.embed.float().std()) - 1.0) < 0.05
    assert abs(float(attn.wq.float().std()) * cfg.d_model ** 0.5 - 1.0) < 0.1
    assert not any(p.requires_grad for p in a.parameters())


def test_convert_carries_a_bf16_tree(gemma):
    tree = jax.tree.map(np.asarray, jbuild(gemma["jcfg"]).init(
        jax.random.PRNGKey(1)))
    params = build_model(gemma["cfg"], device="cpu").make_params()
    params.load_state_dict(convert.transformer_params_from_reference(tree))
    wq = tree["blocks"][0]["attn"]["wq"][1]
    assert wq.dtype == jnp.bfloat16
    got = params.layers[1].attn.wq
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), wq.astype(np.float32))
    short = jax.tree.map(lambda a: a[:1], tree["blocks"][0])
    with pytest.raises(ValueError, match="superblock"):
        convert.transformer_params_from_reference(
            dict(tree, blocks=tree["blocks"] + [short]))


def test_entry_points_refuse_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_config("gemma-2b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "gemma-2b", "--reduced"])


@pytest.mark.parametrize("arch", ["gemma-2b", "paligemma-3b"])
def test_serve_launcher_runs_on_cpu(capsys, arch):
    assert serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--prompts", "2", "--prompt-len", "10",
                       "--new-tokens", "3", "--cache-len", "16"]) == 0
    assert capsys.readouterr().out.count("generated 3 tokens") == 2


def test_import_loads_neither_jax_nor_reference():
    code = ("import sys, repro_torch.models.transformer, "
            "repro_torch.models.attention, repro_torch.models.layers, "
            "repro_torch.configs.gemma_2b, repro_torch.configs.minicpm_2b, "
            "repro_torch.configs.qwen2_5_14b, repro_torch.configs.qwen1_5_32b, "
            "repro_torch.configs.paligemma_3b, repro_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m == 'repro' or m.startswith('repro.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
