"""The port's encoder-decoder and coded spectral mixer on the card
(marker ``gpu``, skipped without a CUDA device; no JAX import, so the
file runs where only torch is installed).

* Reduced whisper-medium with f32 weights and TF32 off, on the card
  against the same weights on the CPU (which ``tests/test_torch_encdec.py``
  holds against the JAX package): the encoder's output, then a prefill
  and two decode steps -- the f32 hidden state handed to the head and
  both caches within 1e-4 (the head's bf16 rounding is held apart by
  ``test_torch_transformer_gpu.py``'s head test);
* the coded spectral mixer on a CUDA plan (``CodedFFT(s=256, m=4,
  n_workers=6)``, workers 1 and 4 down) at (2, 96, 32), 32 taps: exactly
  two ``cmatmul`` launches and one ``fourstep_fused``, within 1e-5 of the
  plain ``torch.fft`` mixer on the card (max-abs over the largest
  magnitude) and its filter gradient within 1e-5.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.core import CodedFFT
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import build_model
from repro_torch.models import encdec as ted
from repro_torch.models import spectral as tsp
from repro_torch.models import transformer as ttf

B, T_ENC, T, CACHE = 2, 24, 11, 32


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
def test_gpu_f32_encdec_matches_cpu(cuda, monkeypatch):
    heads = []
    real = ttf.bf16_logits

    def recorded(hidden, w):
        heads.append(hidden.detach().cpu())
        return real(hidden, w)

    monkeypatch.setattr(ttf, "bf16_logits", recorded)
    cfg = get_reduced_config("whisper-medium")
    cpu = build_model(cfg, dtype=torch.float32, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(3))
    card = build_model(cfg, dtype=torch.float32, device=cuda)
    on_card = card.make_params()
    on_card.load_state_dict(params.state_dict())
    rng = np.random.default_rng(11)
    frames = torch.from_numpy(rng.standard_normal(
        (B, T_ENC, cfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, T)).astype(
        np.int32))
    runs = []
    for mdl, prm, dev in ((cpu, params, torch.device("cpu")),
                          (card, on_card, cuda)):
        heads.clear()
        enc = ted.encode(prm, frames.to(dev))
        cache = mdl.init_cache(B, CACHE)
        logits, cache = mdl.prefill(prm, {"frames": frames.to(dev),
                                          "tokens": toks[:, :9].to(dev)},
                                    cache)
        for i in range(9, 11):
            logits, cache = mdl.decode_step(
                prm, cache, {"tokens": toks[:, i:i + 1].to(dev)}, i)
            assert bool(torch.isfinite(logits).all())
        runs.append((enc, list(heads), cache))
    (ec, hc, cc), (eg, hg, cg) = runs
    assert _rel(eg, ec) < 1e-4
    assert len(hc) == len(hg) == 3
    for a, b in zip(hg, hc):
        assert _rel(a, b) < 1e-4
    for part in ("self", "cross"):
        for kv in ("k", "v"):
            assert cg[part][kv].shape[2] == (CACHE if part == "self"
                                             else T_ENC)
            assert _rel(cg[part][kv], cc[part][kv]) < 1e-4, (part, kv)


@pytest.mark.gpu
def test_gpu_coded_spectral_mixer_runs_the_kernels(cuda):
    p = tsp.decaying_filter_init(torch.Generator(device=cuda).manual_seed(0),
                                 32, 32, device=cuda)
    x = torch.randn((2, 96, 32), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    plan = CodedFFT(s=256, m=4, n_workers=6, device=cuda)
    mask = torch.tensor([True, False, True, True, False, True], device=cuda)
    torch.cuda.synchronize()
    reset_launch_counts()
    y = tsp.spectral_apply_coded(p, x, plan, mask=mask)
    torch.cuda.synchronize()
    assert launch_counts() == {"cmatmul": 2, "fourstep_fused": 1}
    assert _rel(y, tsp.spectral_apply(p, x)) < 1e-5

    def grad_h(mixer):
        pp = {k: v.clone().requires_grad_() for k, v in p.items()}
        return torch.autograd.grad((mixer(pp) ** 2).mean(), pp["h"])[0]

    assert _rel(grad_h(lambda pp: tsp.spectral_apply_coded(
        pp, x, plan, mask=mask)), grad_h(lambda pp: tsp.spectral_apply(
            pp, x))) < 1e-5
