"""The port's RWKV-6 generation path against the JAX package.

CPU tests on the reduced rwkv6 config with f32 parameters on both sides;
the JAX package's seeded weights are carried across by
``convert.rwkv_params_from_reference``, with every zero- or one-initialised
vector (the mixes, the decay base, the bonus, the norms) perturbed first
so that each term of the layer counts.  Stated tolerances, relative to the
largest magnitude:

* 1e-5: two f32 implementations of the same sums (the time mix, channel
  mix and layer in decode mode against JAX's; the port's prefill on the
  WKV kernel's twin against the port's own exact decode loop, states);
* 5e-5: the port's prefill against a loop of the JAX exact decode step,
  states.  Two f32 runs of the whole model with other matrix-product
  libraries: on these weights the two packages' exact decode loops alone
  differ by up to 1.1e-5 (the per-head group norm, eps 64e-5, magnifies
  differences where a head's output is small);
* 1e-2: the logits of those comparisons (the head rounds its inputs to
  bf16, so a state difference of 1e-6 may move a rounding);
* 5%: against the JAX prefill, whose WKV streams r/k/v in bf16 (the
  reference's bf16 bound, ``tests/test_data_spectral.py``); and, with
  bf16 weights on both sides (the JAX ``build_model`` default, and what
  the port serves), the port's prefill and decode steps against JAX's.

On the card (marker ``gpu``): the head's bf16 product with f32
accumulation against the same product in f32 (1e-5), and the reduced
model in bf16 on the card against the CPU (5%).

The engine's greedy tokens must equal a greedy loop over the JAX decode
step; EOS truncation under the one-step-behind fetch mirrors
``tests/test_serving.py``.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_kernels import private_autotune_table  # noqa: F401

from repro_torch import convert
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.kernels import _build
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.layers import layer_norm
from repro_torch.models.params import count_params
from repro_torch.serving import EngineConfig, GenerationEngine, sample_token

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")
PAIR_TOL = 1e-5
MODEL_TOL = 5e-5
LOGIT_TOL = 1e-2
BF16_TOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _carried(jax, jnp, jcfg, cfg, dtype):
    """The JAX reduced rwkv6 in ``dtype`` with its perturbed weights, as a
    numpy tree and as JAX arrays, and the port's model and parameters
    carrying the same weights."""
    from repro.models import build_model as jbuild

    jmodel = jbuild(jcfg, dtype=jnp.float32 if dtype == torch.float32
                    else jnp.bfloat16)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def perturb(path, a):
        name = path[-1].key
        if name in ("maa_base", "maa_x", "mix_k", "mix_r"):
            return rng.uniform(0.0, 1.0, a.shape).astype(np.float32)
        if name == "decay_base":
            # RWKV-6's own time_decay init spans [-6, -1]
            return rng.uniform(-6.0, -1.0, a.shape).astype(np.float32)
        if name in ("u", "gn_b", "b"):
            return (0.5 * rng.standard_normal(a.shape)).astype(np.float32)
        if name in ("gn_w", "w"):
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(
                np.float32)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    model = build_model(cfg, dtype=dtype, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    params.load_state_dict(convert.rwkv_params_from_reference(tree))
    return {"tree": tree, "jparams": jax.tree.map(jnp.asarray, tree),
            "model": model, "params": params}


@pytest.fixture(scope="module")
def jref():
    """The JAX reduced rwkv6 (f32 params), its perturbed weights as numpy,
    and the port's model with the same weights."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_reduced_config as jget
    from repro.models import rwkv6 as jrwkv

    jcfg = jget("rwkv6-3b")
    cfg = get_reduced_config("rwkv6-3b")
    return {"jax": jax, "jnp": jnp, "jrwkv": jrwkv, "jcfg": jcfg, "cfg": cfg,
            **_carried(jax, jnp, jcfg, cfg, torch.float32)}


@pytest.fixture(scope="module")
def jref_bf16(jref):
    """The same, in bf16: the JAX ``build_model`` default and the dtype
    the port serves in."""
    return {**jref, **_carried(jref["jax"], jref["jnp"], jref["jcfg"],
                               jref["cfg"], torch.bfloat16)}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _layer_tree(tree, i):
    return {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict)
                else v[i]) for k, v in tree["layers"].items()}


def _tokens(cfg, b, t, seed):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=(b, t)).astype(np.int32)


def _state_inputs(cfg, b, t, seed):
    rng = np.random.default_rng(seed)
    h, hs, d = cfg.n_heads, cfg.rwkv.head_size, cfg.d_model
    mk = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return mk(b, t, d), mk(b, d), mk(b, h, hs, hs)


def _jax_greedy(j, tokens, steps):
    """Prefill by a loop of the JAX exact decode step, then greedy decode:
    the logits after the prompt, the state, and ``steps`` tokens."""
    jnp, jrwkv, cfg, p = j["jnp"], j["jrwkv"], j["jcfg"], j["jparams"]
    state = jrwkv.init_rwkv_state(cfg, tokens.shape[0])
    for t in range(tokens.shape[1]):
        logits, state = jrwkv.rwkv_decode_step(
            p, cfg, state, {"tokens": jnp.asarray(tokens[:, t:t + 1])}, t)
    first = (np.asarray(logits), jax_np(j, state))
    out = []
    tok = np.argmax(np.asarray(logits), axis=-1).astype(np.int32)
    for t in range(steps):
        out.append(tok[:, 0])
        logits, state = jrwkv.rwkv_decode_step(
            p, cfg, state, {"tokens": jnp.asarray(tok)}, t)
        tok = np.argmax(np.asarray(logits), axis=-1).astype(np.int32)
    return first, np.stack(out, axis=1) if out else None


def jax_np(j, tree):
    return j["jax"].tree.map(np.asarray, tree)


# -- the mixers and the layer, decode mode -----------------------------------
def test_time_mix_decode_matches_jax(jref):
    j, cfg = jref, jref["cfg"]
    x, last, state = _state_inputs(cfg, 2, 1, seed=1)
    jp = _layer_tree(j["tree"], 1)["time_mix"]
    want = j["jrwkv"]._time_mix(
        j["jax"].tree.map(j["jnp"].asarray, jp), j["jcfg"], j["jnp"].asarray(x),
        j["jnp"].asarray(last), j["jnp"].asarray(state), "decode")
    got = j["params"].layers[1].time_mix(
        torch.from_numpy(x), torch.from_numpy(last), torch.from_numpy(state),
        "decode")
    for g, w in zip(got, want):
        assert _rel(g, w) < PAIR_TOL


@pytest.mark.parametrize("t", [1, 6])
def test_channel_mix_matches_jax(jref, t):
    j, cfg = jref, jref["cfg"]
    x, last, _ = _state_inputs(cfg, 2, t, seed=2 + t)
    jp = _layer_tree(j["tree"], 0)["channel_mix"]
    want = j["jrwkv"]._channel_mix(
        j["jax"].tree.map(j["jnp"].asarray, jp), j["jcfg"], j["jnp"].asarray(x),
        j["jnp"].asarray(last))
    got = j["params"].layers[0].channel_mix(torch.from_numpy(x),
                                            torch.from_numpy(last))
    for g, w in zip(got, want):
        assert _rel(g, w) < PAIR_TOL


def test_layer_decode_matches_jax(jref):
    j, cfg = jref, jref["cfg"]
    x, tm_last, state = _state_inputs(cfg, 3, 1, seed=4)
    cm_last = np.random.default_rng(5).standard_normal(tm_last.shape).astype(
        np.float32)
    st = {"tm_last": tm_last, "cm_last": cm_last, "wkv": state}
    jp = _layer_tree(j["tree"], 1)
    jx, jst = j["jrwkv"]._layer_apply(
        j["jax"].tree.map(j["jnp"].asarray, jp), j["jcfg"], j["jnp"].asarray(x),
        {k: j["jnp"].asarray(v) for k, v in st.items()}, "decode")
    tx, tst = j["params"].layers[1](
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in st.items()},
        "decode")
    assert _rel(tx, jx) < PAIR_TOL
    for k in st:
        assert _rel(tst[k], jst[k]) < PAIR_TOL


# -- the whole model ------------------------------------------------------
def _port_decode_loop(j, toks):
    cfg = j["cfg"]
    state = trwkv.init_rwkv_state(cfg, toks.shape[0])
    for t in range(toks.shape[1]):
        logits, state = trwkv.rwkv_decode_step(
            j["params"], state, {"tokens": toks[:, t:t + 1]})
    return logits, state


@pytest.mark.parametrize("t", [24, 13])
def test_prefill_matches_decode_loop(jref, t):
    """The port's prefill (the WKV kernel's twin, T padded to 8) against
    the port's own exact recurrence, token by token: the same projections,
    so only the WKV's chunked form and the padding differ."""
    j, cfg = jref, jref["cfg"]
    toks = torch.from_numpy(_tokens(cfg, 2, t, seed=t))
    logits, state = trwkv.rwkv_prefill(j["params"], {"tokens": toks},
                                       trwkv.init_rwkv_state(cfg, 2))
    want_logits, want = _port_decode_loop(j, toks)
    for k in ("wkv", "tm_last", "cm_last"):
        assert _rel(state[k], want[k]) < PAIR_TOL, k
    assert _rel(logits, want_logits) < LOGIT_TOL


@pytest.mark.parametrize("t", [24, 13])
def test_prefill_matches_jax_decode_loop(jref, t):
    """The port's prefill against the JAX exact recurrence, token by
    token.  States at ``MODEL_TOL``: the two packages' decode loops alone
    differ by up to 1.1e-5 here (other matrix-product libraries)."""
    j, cfg = jref, jref["cfg"]
    toks = _tokens(cfg, 2, t, seed=t)
    logits, state = trwkv.rwkv_prefill(
        j["params"], {"tokens": torch.from_numpy(toks)},
        trwkv.init_rwkv_state(cfg, 2))
    (jlogits, jstate), _ = _jax_greedy(j, toks, 0)
    for k in ("wkv", "tm_last", "cm_last"):
        assert _rel(state[k], jstate[k]) < MODEL_TOL, k
    assert logits.dtype == torch.float32
    assert _rel(logits, jlogits) < LOGIT_TOL


def test_prefill_matches_jax_prefill(jref):
    """Against the JAX prefill, which streams the WKV in bf16."""
    j, cfg = jref, jref["cfg"]
    toks = _tokens(cfg, 2, 24, seed=9)
    logits, state = trwkv.rwkv_prefill(
        j["params"], {"tokens": torch.from_numpy(toks)},
        trwkv.init_rwkv_state(cfg, 2))
    jlogits, jstate = j["jrwkv"].rwkv_prefill(
        j["jparams"], j["jcfg"], {"tokens": j["jnp"].asarray(toks)},
        j["jrwkv"].init_rwkv_state(j["jcfg"], 2))
    assert _rel(logits, jlogits) < BF16_TOL
    for k in ("wkv", "tm_last", "cm_last"):
        assert _rel(state[k], jstate[k]) < BF16_TOL, k


def test_prefill_then_decode_matches_longer_prefill(jref):
    """prefill(T) against prefill(T-1) and one decode step: the same next
    token and the same logits, up to the head's bf16 rounding."""
    j, cfg = jref, jref["cfg"]
    toks = torch.from_numpy(_tokens(cfg, 2, 16, seed=3))
    full, _ = trwkv.rwkv_prefill(j["params"], {"tokens": toks},
                                 trwkv.init_rwkv_state(cfg, 2))
    _, st = trwkv.rwkv_prefill(j["params"], {"tokens": toks[:, :-1]},
                               trwkv.init_rwkv_state(cfg, 2))
    step, _ = trwkv.rwkv_decode_step(j["params"], st,
                                     {"tokens": toks[:, -1:]})
    assert torch.equal(full.argmax(-1), step.argmax(-1))
    assert _rel(step, full) < LOGIT_TOL


@pytest.mark.parametrize("t", [24, 13])
def test_bf16_prefill_and_decode_match_jax(jref_bf16, t):
    """bf16 weights on both sides: the port's prefill, then three decode
    steps fed the same tokens, against the JAX prefill and decode steps,
    logits and states at the reference's bf16 bound."""
    j, cfg = jref_bf16, jref_bf16["cfg"]
    jnp, jrwkv, jcfg = j["jnp"], j["jrwkv"], j["jcfg"]
    assert j["params"].layers[0].time_mix.wr.dtype == torch.bfloat16
    toks = _tokens(cfg, 2, t + 3, seed=20 + t)
    logits, state = trwkv.rwkv_prefill(
        j["params"], {"tokens": torch.from_numpy(toks[:, :t])},
        trwkv.init_rwkv_state(cfg, 2))
    jlogits, jstate = jrwkv.rwkv_prefill(
        j["jparams"], jcfg, {"tokens": jnp.asarray(toks[:, :t])},
        jrwkv.init_rwkv_state(jcfg, 2))
    for i in range(4):
        assert logits.dtype == torch.float32
        assert _rel(logits, jlogits) < BF16_TOL, i
        for k in ("wkv", "tm_last", "cm_last"):
            assert _rel(state[k], jstate[k]) < BF16_TOL, (i, k)
        if i == 3:
            break
        tok = toks[:, t + i:t + i + 1]
        logits, state = trwkv.rwkv_decode_step(
            j["params"], state, {"tokens": torch.from_numpy(tok)})
        jlogits, jstate = jrwkv.rwkv_decode_step(
            j["jparams"], jcfg, jstate, {"tokens": jnp.asarray(tok)}, t + i)


def test_bf16_prefill_then_decode_matches_longer_prefill(jref_bf16):
    """The check ``chip_smoke.py`` runs on the card, in bf16 here: prefill(T)
    against prefill(T-1) and one decode step, the same next token and
    logits within the bf16 bound."""
    j, cfg = jref_bf16, jref_bf16["cfg"]
    toks = torch.from_numpy(_tokens(cfg, 2, 16, seed=3))
    full, fst = trwkv.rwkv_prefill(j["params"], {"tokens": toks},
                                   trwkv.init_rwkv_state(cfg, 2))
    _, st = trwkv.rwkv_prefill(j["params"], {"tokens": toks[:, :-1]},
                               trwkv.init_rwkv_state(cfg, 2))
    step, sst = trwkv.rwkv_decode_step(j["params"], st,
                                       {"tokens": toks[:, -1:]})
    assert torch.equal(full.argmax(-1), step.argmax(-1))
    assert _rel(step, full) < BF16_TOL
    assert _rel(sst["wkv"][0], fst["wkv"][0]) < PAIR_TOL


# -- the engine -----------------------------------------------------------
@pytest.fixture(scope="module")
def engine(jref):
    return GenerationEngine(jref["model"], jref["params"], EngineConfig(
        batch_size=3, prompt_len=12, max_new_tokens=6))


def _prompts(cfg, seed):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, cfg.vocab_size, n)) for n in (12, 9, 5)]


def test_engine_greedy_matches_jax_decode_loop(jref, engine):
    cfg = jref["cfg"]
    prompts = _prompts(cfg, 0)
    got = engine.generate(prompts)
    padded = engine._pad_prompts(prompts)
    _, want = _jax_greedy(jref, padded, engine.ecfg.max_new_tokens)
    assert got == want.tolist()


def test_engine_greedy_is_deterministic(jref, engine):
    prompts = _prompts(jref["cfg"], 1)
    out1 = engine.generate(prompts)
    out2 = engine.generate(prompts)
    assert out1 == out2
    assert all(len(o) == engine.ecfg.max_new_tokens for o in out1)


def test_engine_eos_truncation_with_overlapped_fetch(jref, engine):
    """The one-step-behind fetch must not change WHAT is generated: EOS
    still truncates each row at its first occurrence, and rows without an
    EOS are untouched."""
    prompts = _prompts(jref["cfg"], 2)
    base = engine.generate(prompts)
    eos = base[0][1]                 # force EOS at row 0's second token
    old = engine.ecfg.eos_id
    engine.ecfg.eos_id = eos
    try:
        out = engine.generate(prompts)
    finally:
        engine.ecfg.eos_id = old
    for got, want in zip(out, base):
        expect = want[:want.index(eos) + 1] if eos in want else want
        assert got == expect


def test_engine_temperature_draws_from_generator(jref, engine):
    """At temperature > 0 the tokens come from the caller's generator: the
    same seed gives the same tokens, each in the vocabulary."""
    prompts = _prompts(jref["cfg"], 3)
    old = engine.ecfg.temperature
    engine.ecfg.temperature = 1.0
    try:
        a = engine.generate(prompts, torch.Generator().manual_seed(5))
        b = engine.generate(prompts, torch.Generator().manual_seed(5))
    finally:
        engine.ecfg.temperature = old
    assert a == b
    assert all(0 <= t < jref["cfg"].vocab_size for row in a for t in row)


def test_sample_token_temperature_zero_is_argmax():
    logits = torch.tensor([[[0.1, 3.0, -1.0]]])
    t = sample_token(logits, torch.Generator().manual_seed(0), 0.0)
    assert t.dtype == torch.int32 and int(t[0, 0]) == 1


# -- construction ---------------------------------------------------------
@pytest.mark.parametrize("family", ["encdec"])
def test_build_model_refuses_other_families(family):
    cfg = dataclasses.replace(get_reduced_config("rwkv6-3b"), family=family)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model(cfg, device="cpu")


def test_param_count_matches_jax_full_config(jref):
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild

    n = count_params(trwkv.rwkv_specs(get_config("rwkv6-3b")))
    assert n == jbuild(jget("rwkv6-3b")).n_params
    assert 3.0e9 < n < 3.2e9
    assert build_model(jref["cfg"], device="cpu").n_params == sum(
        p.numel() for p in jref["params"].parameters())


def test_convert_carries_a_bf16_tree(jref):
    """The JAX package's default dtype: bf16 leaves (ml_dtypes arrays)
    land bit for bit in the port's bf16 parameters, f32 leaves as f32."""
    jax, jnp = jref["jax"], jref["jnp"]
    from repro.models import build_model as jbuild

    tree = jax.tree.map(np.asarray, jbuild(jref["jcfg"]).init(
        jax.random.PRNGKey(1)))
    params = build_model(jref["cfg"], device="cpu").init(
        torch.Generator().manual_seed(0))
    params.load_state_dict(convert.rwkv_params_from_reference(tree))
    wr = tree["layers"]["time_mix"]["wr"][1]
    assert wr.dtype == jnp.bfloat16
    got = params.layers[1].time_mix.wr
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), wr.astype(np.float32))
    assert params.layers[1].time_mix.u.dtype == torch.float32


def test_init_follows_the_reference_scheme():
    cfg = get_reduced_config("rwkv6-3b")
    model = build_model(cfg, device="cpu")
    a = model.init(torch.Generator().manual_seed(1))
    b = model.init(torch.Generator().manual_seed(1))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert a.embed.dtype == torch.bfloat16
    tm = a.layers[0].time_mix
    assert tm.u.dtype == torch.float32 and not tm.u.any()
    assert torch.equal(tm.gn_w, torch.ones_like(tm.gn_w))
    assert abs(float(a.embed.float().std()) - 1.0) < 0.05
    d = cfg.d_model
    assert abs(float(tm.wr.float().std()) * d ** 0.5 - 1.0) < 0.1
    assert not any(p.requires_grad for p in a.parameters())


def test_entry_points_refuse_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced_config("rwkv6-3b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced"])
    assert build_model(cfg, device="cpu").device == CPU


def test_serve_launcher_runs_on_cpu(capsys):
    assert serve.main(["--reduced", "--device", "cpu", "--prompts", "2",
                       "--prompt-len", "10", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert out.count("generated 3 tokens") == 2
    assert serve.main(["--fft", "--device", "cpu", "--s", "256",
                       "--requests", "2"]) == 0
    assert "worst abs error" in capsys.readouterr().out


def test_cpu_prefill_counts_no_launch(jref):
    _build.reset_launch_counts()
    trwkv.rwkv_prefill(jref["params"],
                       {"tokens": torch.ones((1, 8), dtype=torch.int32)},
                       trwkv.init_rwkv_state(jref["cfg"], 1))
    assert _build.launch_counts() == {}


def test_import_loads_neither_jax_nor_reference_lm():
    code = ("import sys, repro_torch.models, repro_torch.configs, "
            "repro_torch.launch.serve, repro_torch.serving.engine, "
            "repro_torch.kernels.wkv, repro_torch.convert, "
            "repro_torch.models.transformer, repro_torch.models.attention; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m == 'repro' or m.startswith('repro.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- on the card (marker ``gpu``, skipped without a CUDA device) ---------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_head_matches_f32_product(cuda):
    """The card's head (bf16 inputs, f32 accumulation in one product)
    against the same product in f32: products of bf16 values are exact in
    f32, so only the order of the sums differs (1e-5)."""
    cfg = get_reduced_config("rwkv6-3b")
    params = build_model(cfg, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    x = torch.randn((3, 2, cfg.d_model), device=cuda).to(torch.bfloat16)
    got = trwkv._head(params, x)
    xn = layer_norm(x, params.final_norm.w, params.final_norm.b)
    want = xn.to(torch.bfloat16).float() @ params.unembed.float()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.cpu(), want.cpu()) < PAIR_TOL


@pytest.mark.gpu
def test_gpu_bf16_prefill_and_decode_match_cpu(cuda):
    """The reduced model in bf16 on the card (the wkv kernel, the card's
    head) against the same weights on the CPU (the twin, held against the
    JAX package above): prefill, then three decode steps fed the same
    tokens, logits and states at the bf16 bound."""
    cfg = get_reduced_config("rwkv6-3b")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(3))
    on_card = build_model(cfg, device=cuda).make_params()
    on_card.load_state_dict(params.state_dict())
    toks = torch.from_numpy(_tokens(cfg, 2, 16, seed=7))
    runs = []
    for prm, dev in ((params, CPU), (on_card, cuda)):
        logits, st = trwkv.rwkv_prefill(
            prm, {"tokens": toks[:, :13].to(dev)},
            trwkv.init_rwkv_state(cfg, 2, dev))
        seq = [(logits, st)]
        for i in range(13, 16):
            logits, st = trwkv.rwkv_decode_step(
                prm, st, {"tokens": toks[:, i:i + 1].to(dev)})
            seq.append((logits, st))
        runs.append(seq)
    for (lc, sc), (lg, sg) in zip(*runs):
        assert _rel(lg.cpu(), lc) < BF16_TOL
        for k in sc:
            assert _rel(sg[k].cpu(), sc[k]) < BF16_TOL, k
