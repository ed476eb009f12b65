"""The port's decoder-only transformer, MoE and hybrid models on the card
(marker ``gpu``, skipped without a CUDA device; no JAX import, so the
file runs where only torch is installed).

* Reduced gemma-2b, qwen2.5-14b, minicpm-2b, qwen1.5-32b and
  paligemma-3b (behind its patch embeddings) with f32 weights and TF32
  off, on the card against the same weights on the CPU (which
  ``tests/test_torch_transformer.py`` holds against the JAX package):
  prefill and two decode steps, logits and caches within 1e-4, and
  reduced gemma-2b the same way on 1,100 tokens and 2,100 slots (past
  one attention chunk and one decode chunk); reduced
  dbrx-132b, llama4-maverick-400b-a17b and recurrentgemma-9b the same
  way (``test_torch_moe.py``, ``test_torch_rglru.py`` against JAX),
  with the head's f32 input in place of the logits and every cache or
  recurrent state, within 1e-4;
* the RG-LRU's doubling scan at d_rnn = 4096 and T = 512 against a
  sequential f32 loop of the recurrence on the card, within 1e-5;
* the head's bf16 product with f32 accumulation, the tied unembedding
  read as ``embed.T``, against the same product in f32 (1e-5: products
  of bf16 values are exact in f32, only the order of the sums differs).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.models import build_model
from repro_torch.models import rglru as trg
from repro_torch.models import transformer as ttf

B, CACHE = 2, 32


def _rel(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    assert got.shape == want.shape, (got.shape, want.shape)
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _leaves(cache):
    """A cache's tensors by name: the transformer's ``{"k", "v"}``, the
    hybrid's list of per-layer dicts."""
    if isinstance(cache, dict):
        return dict(cache)
    return {f"{i}.{k}": v for i, st in enumerate(cache) for k, v in st.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("arch,t,cache", [
    pytest.param("gemma-2b", 11, CACHE, id="gemma-2b"),
    pytest.param("qwen2.5-14b", 11, CACHE, id="qwen2.5-14b"),
    pytest.param("minicpm-2b", 11, CACHE, id="minicpm-2b"),
    pytest.param("qwen1.5-32b", 11, CACHE, id="qwen1.5-32b"),
    pytest.param("paligemma-3b", 11, CACHE, id="paligemma-3b"),
    pytest.param("gemma-2b", 1100, 2100, id="gemma-2b-past-attn-chunk")])
def test_gpu_f32_model_matches_cpu(cuda, arch, t, cache):
    """Reduced model, f32 weights, on the card against the CPU: prefill
    of ``t - 2`` tokens (after the vlm's seeded patch embeddings) and two
    decode steps, logits and caches within 1e-4; at t = 1,100 the
    prefill spans two attention chunks and the decode two 2,048-slot
    chunks of its 2,100."""
    cfg = get_reduced_config(arch)
    cpu = build_model(cfg, dtype=torch.float32, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(3))
    card = build_model(cfg, dtype=torch.float32, device=cuda)
    on_card = card.make_params()
    on_card.load_state_dict(params.state_dict())
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (B, t)).astype(np.int32))
    n_pre = cfg.num_prefix_tokens
    patches = torch.from_numpy(rng.standard_normal(
        (B, n_pre, cfg.d_model)).astype(np.float32))
    runs = []
    for mdl, prm, dev in ((cpu, params, torch.device("cpu")),
                          (card, on_card, cuda)):
        kv = mdl.init_cache(B, cache)
        batch = {"tokens": toks[:, :t - 2].to(dev)}
        if n_pre:
            batch["patches"] = patches.to(dev)
        logits, kv = mdl.prefill(prm, batch, kv)
        seq = [logits]
        for i in range(t - 2, t):
            logits, kv = mdl.decode_step(
                prm, kv, {"tokens": toks[:, i:i + 1].to(dev)}, n_pre + i)
            seq.append(logits)
        runs.append((seq, kv))
    (lc, cc), (lg, cg) = runs
    for a, b in zip(lg, lc):
        assert _rel(a, b) < 1e-4
    for kv in ("k", "v"):
        assert _rel(cg[kv], cc[kv]) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b",
                                  "recurrentgemma-9b"])
def test_gpu_f32_moe_and_hybrid_match_cpu(cuda, arch, monkeypatch):
    """Reduced MoE and hybrid models, f32 weights, on the card against
    the CPU: prefill and two decode steps, the f32 hidden state handed
    to the head and every cache or state within 1e-4.  The head rounds
    that state to bf16, which turns a difference of a few 1e-6 into up
    to 2e-4 of the logits (reduced dbrx, its weights scaled by 1 + 1e-6
    noise on the CPU alone), so the logits are held to the head's own
    test above."""
    heads = []
    real = ttf.bf16_logits

    def recorded(hidden, w):
        heads.append(hidden.detach().cpu())
        return real(hidden, w)

    monkeypatch.setattr(ttf, "bf16_logits", recorded)
    cfg = get_reduced_config(arch)
    cpu = build_model(cfg, dtype=torch.float32, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(3))
    card = build_model(cfg, dtype=torch.float32, device=cuda)
    on_card = card.make_params()
    on_card.load_state_dict(params.state_dict())
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        1, cfg.vocab_size, (B, 11)).astype(np.int32))
    runs = []
    for mdl, prm, dev in ((cpu, params, torch.device("cpu")),
                          (card, on_card, cuda)):
        heads.clear()
        cache = mdl.init_cache(B, CACHE)
        logits, cache = mdl.prefill(prm, {"tokens": toks[:, :9].to(dev)},
                                    cache)
        for i in range(9, 11):
            logits, cache = mdl.decode_step(
                prm, cache, {"tokens": toks[:, i:i + 1].to(dev)}, i)
            assert bool(torch.isfinite(logits).all())
        runs.append((list(heads), _leaves(cache)))
    (hc, cc), (hg, cg) = runs
    assert len(hc) == len(hg) == 3
    for a, b in zip(hg, hc):
        assert _rel(a, b) < 1e-4
    assert cc.keys() == cg.keys()
    for name in cc:
        assert _rel(cg[name], cc[name]) < 1e-4, name


@pytest.mark.gpu
def test_gpu_doubling_scan_matches_sequential_loop(cuda):
    """The RG-LRU's scan at recurrentgemma-9b's width (d_rnn 4096) over
    T = 512, its a and b from the RG-LRU's formulas on seeded inputs,
    against h_t = a_t h_{t-1} + b_t step by step in f32 (1e-5)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    b_, t, c = 2, 512, 4096
    r = torch.sigmoid(torch.randn((b_, t, c), device=cuda, generator=g))
    lam = 1.0 + 0.5 * torch.randn((c,), device=cuda, generator=g)
    log_a = -8.0 * torch.nn.functional.softplus(lam) * r
    a = torch.exp(log_a)
    x = torch.randn((b_, t, c), device=cuda, generator=g)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                       1e-12)) * x
    h0 = torch.randn((b_, c), device=cuda, generator=g)
    a_seq, b_seq = trg.doubling_scan(a, gated)
    got = a_seq * h0[:, None] + b_seq
    h, want = h0, []
    for i in range(t):
        h = a[:, i] * h + gated[:, i]
        want.append(h)
    assert _rel(got, torch.stack(want, 1)) < 1e-5


@pytest.mark.gpu
def test_gpu_head_matches_f32_product(cuda):
    """The card's head (bf16 inputs, f32 accumulation in one product,
    the tied unembed read as ``embed.T``) against the same product in
    f32: products of bf16 values are exact in f32 (1e-5)."""
    cfg = get_reduced_config("gemma-2b")
    params = build_model(cfg, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    x = torch.randn((3, 2, cfg.d_model), device=cuda).to(torch.bfloat16)
    got = ttf._head(params, x)
    want = x.float() @ params.embed.float().T
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) < 1e-5
