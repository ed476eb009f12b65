"""The port's encoder-decoder (family encdec, whisper-medium) against the
JAX package's, on the CPU.

The JAX package's seeded weights of reduced whisper-medium are carried
across by ``convert.encdec_params_from_reference``, with every
LayerNorm weight and bias and every MLP bias perturbed first (their
ones and zeros would hide a term).  Inputs come from a numpy seed: frame
embeddings (B, T_enc, D) and tokens.  Stated tolerances, relative to
the largest magnitude:

* 1e-5 with f32 weights: the encoder's output, the prefill's logits, its
  self and cross caches, and each decode step's logits and caches; two
  f32 implementations of the same sums (the head rounds its inputs to
  bf16 on both sides);
* 5% with bf16 weights and bf16 frames (the JAX ``build_model`` default
  and what the port serves).

Greedy decoding: 4 steps after a prefill, the tokens equal to a JAX loop
of ``prefill``/``decode_step``.  The cross cache takes the encoder's
length whatever ``cache_len`` is (24 frames, an 8-token prompt and 16
slots; 10 frames); decode past the cache raises ``ValueError``; a
tokens-only prefill raises ``KeyError`` in both packages (so neither
package's ``GenerationEngine`` serves the family); f32 frames on bf16
weights are cast to bf16 (the reference promotes to f32); the full
config's parameter count is the reference's, from specs.
"""

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
from repro_torch.models import build_model
from repro_torch.models import encdec as ted
from repro_torch.models.params import count_params
from repro_torch.serving import EngineConfig, GenerationEngine

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH = "whisper-medium"
TOL = 1e-5
BF16_TOL = 0.05
B, T_ENC, T, CACHE = 2, 24, 8, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from repro.configs import get_config as jget_config
    from repro.configs import get_reduced_config as jget_reduced
    from repro.models import build_model as jbuild
    from repro.models import encdec as jed
    from repro.models import layers as jlayers
    return dict(jax=jax, jnp=jnp, get_config=jget_config,
                get_reduced=jget_reduced, build=jbuild, encdec=jed,
                layers=jlayers)


def _rel(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _carried(jx, dtype, seed=0):
    """The JAX model in ``dtype`` with its perturbed weights, and the
    port's model and parameters carrying the same weights."""
    jax, jnp = jx["jax"], jx["jnp"]
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcfg = jx["get_reduced"](ARCH)
    jmodel = jx["build"](jcfg, dtype=jdtype)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = path[-1].key
        if name == "w":                  # LayerNorm weights: ones
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
        if name in ("b", "bi", "bo"):
            return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    cfg = get_reduced_config(ARCH)
    model = build_model(cfg, dtype=dtype, device="cpu")
    params = model.make_params()
    params.load_state_dict(convert.encdec_params_from_reference(tree))
    return {"jx": jx, "cfg": cfg, "dtype": dtype, "jdtype": jdtype,
            "jmodel": jmodel, "jparams": jax.tree.map(jnp.asarray, tree),
            "tree": tree, "model": model, "params": params,
            "jprefill": jax.jit(jmodel.prefill),
            "jdecode": jax.jit(jmodel.decode_step),
            "tol": TOL if dtype == torch.float32 else BF16_TOL}


@pytest.fixture(scope="module")
def f32(jx):
    return _carried(jx, torch.float32)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def carried(request, jx):
    if request.param == "float32":
        return request.getfixturevalue("f32")
    return _carried(jx, torch.bfloat16)


def _inputs(m, seed, t_enc=T_ENC, t=T):
    """Seeded frames (in the weights' dtype on both sides) and tokens:
    the port's batch and the JAX batch."""
    jnp = m["jx"]["jnp"]
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, t_enc, m["cfg"].d_model)).astype(
        np.float32)
    tokens = rng.integers(1, m["cfg"].vocab_size, (B, t)).astype(np.int32)
    jframes = jnp.asarray(frames, m["jdtype"])
    tb = {"frames": torch.from_numpy(frames).to(m["dtype"]),
          "tokens": torch.from_numpy(tokens)}
    return tb, {"frames": jframes, "tokens": jnp.asarray(tokens)}


def _check_cache(cache, jcache, tol):
    for part in ("self", "cross"):
        for kv in ("k", "v"):
            want = np.asarray(jcache["layers"][part][kv]).astype(np.float32)
            assert _rel(cache[part][kv], want) < tol, (part, kv)


def _prefill_both(m, tb, jb, cache_len=CACHE):
    cache = m["model"].init_cache(B, cache_len)
    jcache = m["jmodel"].init_cache(B, cache_len)
    logits, cache = m["model"].prefill(m["params"], tb, cache)
    jlogits, jcache = m["jprefill"](m["jparams"], jb, jcache)
    return logits, cache, jlogits, jcache


# -- the encoder, the prefill and decode ----------------------------------
def test_encode_matches_jax(carried):
    m = carried
    tb, jb = _inputs(m, seed=1)
    got = ted.encode(m["params"], tb["frames"])
    want = m["jx"]["encdec"].encode(m["jparams"], m["jmodel"].cfg,
                                    jb["frames"])
    assert got.dtype == m["dtype"]
    assert _rel(got, np.asarray(want.astype(np.float32))) < m["tol"]


def test_prefill_logits_and_caches_match_jax(carried):
    m = carried
    tb, jb = _inputs(m, seed=2)
    logits, cache, jlogits, jcache = _prefill_both(m, tb, jb)
    assert logits.dtype == torch.float32
    assert logits.shape == (B, 1, m["cfg"].vocab_size)
    assert _rel(logits, jlogits) < m["tol"]
    _check_cache(cache, jcache, m["tol"])


def test_greedy_decode_matches_jax_loop(carried):
    """Prefill, then 4 greedy decode steps in each package, each step's
    logits and caches compared; the tokens must be equal."""
    m, jnp = carried, carried["jx"]["jnp"]
    tb, jb = _inputs(m, seed=3)
    logits, cache, jlogits, jcache = _prefill_both(m, tb, jb)
    tok = logits.argmax(-1).to(torch.int32)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    toks, jtoks = [tok], [np.asarray(jtok)]
    for i in range(4):
        logits, cache = m["model"].decode_step(m["params"], cache,
                                               {"tokens": tok}, T + i)
        jlogits, jcache = m["jdecode"](m["jparams"], jcache,
                                       {"tokens": jtok},
                                       jnp.asarray(T + i, jnp.int32))
        assert _rel(logits, jlogits) < m["tol"], i
        _check_cache(cache, jcache, m["tol"])
        tok = logits.argmax(-1).to(torch.int32)
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        toks.append(tok)
        jtoks.append(np.asarray(jtok))
    assert [t.numpy().tolist() for t in toks] == [t.tolist() for t in jtoks]


@pytest.mark.parametrize("t_enc", [T_ENC, 10])
def test_cross_cache_takes_the_encoder_length(f32, t_enc):
    """``init_encdec_cache`` makes cross K/V of ``cache_len`` slots; the
    prefill returns them at the encoder's length (24 frames > 16 slots,
    10 < 16), as the reference does, and decode attends over exactly
    those frames.  The caller's cache dict keeps its placeholder."""
    m, jnp = f32, f32["jx"]["jnp"]
    cache0 = m["model"].init_cache(B, CACHE)
    shape = (m["cfg"].n_layers, B, CACHE, m["cfg"].n_kv_heads,
             m["cfg"].head_dim)
    assert cache0["cross"]["k"].shape == shape
    jcache0 = m["jmodel"].init_cache(B, CACHE)
    assert jcache0["layers"]["cross"]["k"].shape == shape
    tb, jb = _inputs(m, seed=4, t_enc=t_enc)
    logits, cache = m["model"].prefill(m["params"], tb, cache0)
    jlogits, jcache = m["jprefill"](m["jparams"], jb, jcache0)
    want = shape[:2] + (t_enc,) + shape[3:]
    for kv in ("k", "v"):
        assert cache["cross"][kv].shape == want
        assert jcache["layers"]["cross"][kv].shape == want
    assert cache0["cross"]["k"].shape == shape
    assert cache["self"]["k"] is cache0["self"]["k"]     # written in place
    tok = {"tokens": logits.argmax(-1).to(torch.int32)}
    got, _ = m["model"].decode_step(m["params"], cache, tok, T)
    wantl, _ = m["jdecode"](m["jparams"], jcache,
                            {"tokens": jnp.asarray(tok["tokens"].numpy())},
                            jnp.asarray(T, jnp.int32))
    assert _rel(got, wantl) < TOL


def test_decode_past_the_cache_raises(f32):
    m = f32
    tb, _ = _inputs(m, seed=5)
    _, cache = m["model"].prefill(m["params"], tb,
                                  m["model"].init_cache(B, 10))
    tok = {"tokens": torch.ones((B, 1), dtype=torch.int32)}
    for s in (T, T + 1):
        m["model"].decode_step(m["params"], cache, tok, s)
    with pytest.raises(ValueError, match="past the cache"):
        m["model"].decode_step(m["params"], cache, tok, 10)
    with pytest.raises(ValueError, match="does not fit"):
        m["model"].prefill(m["params"], tb, m["model"].init_cache(B, T - 1))
    with pytest.raises(ValueError, match="cache_len"):
        m["model"].init_cache(B)


def test_tokens_only_prefill_raises_key_error(f32):
    """Both packages' prefill needs ``frames``; the tokens-only engine
    and launcher therefore fail on the family, as the reference's do."""
    m = f32
    tb, jb = _inputs(m, seed=6)
    with pytest.raises(KeyError, match="frames"):
        m["model"].prefill(m["params"], {"tokens": tb["tokens"]},
                           m["model"].init_cache(B, CACHE))
    with pytest.raises(KeyError, match="frames"):
        m["jmodel"].prefill(m["jparams"], {"tokens": jb["tokens"]},
                            m["jmodel"].init_cache(B, CACHE))
    engine = GenerationEngine(m["model"], m["params"], EngineConfig(
        batch_size=B, prompt_len=T, max_new_tokens=2, cache_len=CACHE))
    with pytest.raises(KeyError, match="frames"):
        engine.generate([[1, 2, 3], [4, 5]])
    with pytest.raises(KeyError, match="frames"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--prompts", "2", "--prompt-len", "8",
                    "--new-tokens", "2", "--cache-len", "16"])


def test_f32_frames_on_bf16_weights_are_cast(jx):
    """f32 frames on bf16 weights: the port casts them to bf16 first
    (the same logits as bf16 frames, bit for bit); the reference promotes
    the encoder to f32, within 5% of the port."""
    m = _carried(jx, torch.bfloat16, seed=1)
    jnp = jx["jnp"]
    rng = np.random.default_rng(7)
    frames = rng.standard_normal((B, T_ENC, m["cfg"].d_model)).astype(
        np.float32)
    tokens = rng.integers(1, m["cfg"].vocab_size, (B, T)).astype(np.int32)
    tb = {"frames": torch.from_numpy(frames),
          "tokens": torch.from_numpy(tokens)}
    got, cache = m["model"].prefill(m["params"], tb,
                                    m["model"].init_cache(B, CACHE))
    cast, _ = m["model"].prefill(
        m["params"], dict(tb, frames=tb["frames"].to(torch.bfloat16)),
        m["model"].init_cache(B, CACHE))
    assert torch.equal(got, cast)
    assert cache["cross"]["k"].dtype == torch.bfloat16
    want, _ = m["jprefill"](m["jparams"], {"frames": jnp.asarray(frames),
                                           "tokens": jnp.asarray(tokens)},
                            m["jmodel"].init_cache(B, CACHE))
    assert want.dtype == jnp.float32
    assert _rel(got, want) < BF16_TOL


# -- construction ---------------------------------------------------------
def test_param_count_matches_jax_full_config(jx):
    """Counted from specs, nothing allocated."""
    n = count_params(ted.encdec_specs(get_config(ARCH)))
    assert n == 758_248_448
    assert n == jx["build"](jx["get_config"](ARCH)).n_params
    reduced = build_model(get_reduced_config(ARCH), device="cpu")
    assert reduced.n_params == sum(
        p.numel() for p in reduced.make_params().parameters())


def test_convert_carries_a_bf16_tree(f32, jx):
    jax = jx["jax"]
    tree = jax.tree.map(np.asarray, jx["build"](
        jx["get_reduced"](ARCH)).init(jax.random.PRNGKey(1)))
    params = build_model(f32["cfg"], device="cpu").make_params()
    params.load_state_dict(convert.encdec_params_from_reference(tree))
    for stack, part in (("enc_layers", "attn"), ("dec_layers",
                                                 "cross_attn")):
        wq = tree[stack][part]["wq"][1]
        got = getattr(params, stack)[1].get_submodule(part).wq
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.float().numpy(), wq.astype(np.float32))
    assert params.enc_ln_post.w.dtype == torch.float32
    assert params.dec_layers[0].mlp.bi.dtype == torch.bfloat16


def test_entry_points_refuse_without_gpu(monkeypatch):
    assert build_model(get_config(ARCH), device="cpu").cfg.family == "encdec"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_config(ARCH))


def test_import_loads_neither_jax_nor_reference():
    code = ("import sys, repro_torch.models.encdec, "
            "repro_torch.models.spectral, repro_torch.configs.whisper_medium, "
            "repro_torch.models.model_factory, repro_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m == 'repro' or m.startswith('repro.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
