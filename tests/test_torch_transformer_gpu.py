"""The port's decoder-only transformer on the card (marker ``gpu``,
skipped without a CUDA device; no JAX import, so the file runs where
only torch is installed).

* Reduced gemma-2b and qwen2.5-14b with f32 weights and TF32 off, on
  the card against the same weights on the CPU (which
  ``tests/test_torch_transformer.py`` holds against the JAX package):
  prefill and two decode steps, logits and caches within 1e-4;
* the head's bf16 product with f32 accumulation, the tied unembedding
  read as ``embed.T``, against the same product in f32 (1e-5: products
  of bf16 values are exact in f32, only the order of the sums differs).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.models import build_model
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


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma-2b", "qwen2.5-14b"])
def test_gpu_f32_model_matches_cpu(cuda, arch):
    """Reduced model, f32 weights, on the card against the CPU: prefill
    and two decode steps, logits and caches within 1e-4."""
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
        cache = mdl.init_cache(B, CACHE)
        logits, cache = mdl.prefill(prm, {"tokens": toks[:, :9].to(dev)},
                                    cache)
        seq = [logits]
        for i in range(9, 11):
            logits, cache = mdl.decode_step(
                prm, cache, {"tokens": toks[:, i:i + 1].to(dev)}, i)
            seq.append(logits)
        runs.append((seq, cache))
    (lc, cc), (lg, cg) = runs
    for a, b in zip(lg, lc):
        assert _rel(a, b) < 1e-4
    for kv in ("k", "v"):
        assert _rel(cg[kv], cc[kv]) < 1e-4


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
