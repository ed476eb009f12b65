"""The port's training step and the coded mixer's input gradient on the
card (marker ``gpu``, skipped without a CUDA device; no JAX import, so
the file runs where only torch is installed).

* One ``make_train_step`` step (exact AdamW) of every family's reduced
  config with f32 weights and TF32 off, on the card against the same
  weights and batch on the CPU (which ``tests/test_torch_training.py``
  and ``tests/test_torch_losses.py`` hold against the JAX package),
  with the loss head and RWKV-6's WKV streams in f32 as those tests
  hold them: the loss and the grad norm within 1e-4, every gradient
  within 1e-4 of its largest entry (RWKV-6 1e-3, its group norm, as
  against JAX), and AdamW's update on the card from the CPU's
  gradients within 1e-5 of the CPU's.  (The updated parameters are not
  compared after each device's own gradients: AdamW's first step moves
  a parameter by about lr * sign(g), so a gradient within the two
  devices' rounding of zero moves it by 2 lr on one and not the other.)
* the same step of reduced dbrx-132b with int8 moments at n_micro = 3
  (capacity for every token), its moments from the CPU's gradients
  equal to the CPU's bit for bit;
* AdamW's sliced leaf update against the whole-leaf update on a
  (16, 512, 1024) expert leaf, exact and int8, bit for bit; the in-place
  clip against the new-tree formula, and the microbatch mean's tensor
  divisor against the CPU's division, bit for bit;
* two int8 AdamW steps (``quantized_state=True``) of reduced gemma-2b's
  f32 parameters from the same seeded gradients on the card and on the
  CPU: after each step every moment's int8 payload ``q`` and f32
  ``scale`` are equal bit for bit (the scale divides by a tensor, as the
  CPU and the reference do);
* the coded spectral mixer's gradient with respect to ``x`` on a CUDA
  plan (``CodedFFT(s=256, m=4, n_workers=6)``, workers 1 and 4 down) at
  (2, 96, 32), 32 taps: the backward launches exactly two ``cmatmul``
  and one ``fourstep_fused``, and the gradient is within 1e-5 of the
  plain ``torch.fft`` mixer's on the card.
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_reduced_config
from repro_torch.core import CodedFFT
from repro_torch.data import make_pipeline
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import build_model
from repro_torch.models import losses as tlosses
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models import spectral as tsp
from repro_torch.models.params import init_params
from repro_torch.optim import AdamWConfig, adamw, cosine
from repro_torch.optim.adamw import _leaf_init, _leaf_update
from repro_torch.optim.grad_utils import (accumulate_grads,
                                          clip_by_global_norm, global_norm)
from repro_torch.training import TrainState, make_train_step

tadamw = importlib.import_module("repro_torch.optim.adamw")
ARCHS = ("gemma-2b", "paligemma-3b", "dbrx-132b", "rwkv6-3b",
         "recurrentgemma-9b", "whisper-medium")


def _rel(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    assert got.shape == want.shape, (got.shape, want.shape)
    return float((got - want).abs().max() / max(float(want.abs().max()),
                                                1e-30))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch,int8,n_micro", [
    *(pytest.param(a, False, 1, id=a) for a in ARCHS),
    # int8 moments and three microbatches (a count that is not a power
    # of two: the gradient sums divided by a tensor on the card)
    pytest.param("dbrx-132b", True, 3, id="dbrx-132b-int8-n_micro3")])
def test_gpu_train_step_matches_cpu(cuda, arch, int8, n_micro, monkeypatch):
    # f32 head and WKV streams: bf16 rounding points would turn the two
    # devices' last-bit differences into bf16 steps
    monkeypatch.setattr(tlosses, "HEAD_DTYPE", torch.float32)
    monkeypatch.setattr(trwkv, "wkv_chunked", functools.partial(
        trwkv.wkv_chunked, stream_dtype=torch.float32))
    cfg = get_reduced_config(arch)
    if cfg.moe is not None:      # capacity for every token: nothing drops
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    opt = adamw(cosine(3e-3, 10, 2), AdamWConfig(quantized_state=int8))
    shape = ShapeConfig("t", 24, 2 * n_micro if n_micro > 1 else 4, "train")
    runs = []
    for dev in (torch.device("cpu"), cuda):
        model = build_model(cfg, dtype=torch.float32, device=dev)
        params = model.make_params()
        if not runs:
            init_params(params, torch.Generator().manual_seed(0))
            init = {k: v.clone() for k, v in params.state_dict().items()}
        else:                        # the CPU's initial values, carried
            params.load_state_dict(init)
        params.requires_grad_(True)
        batch = make_pipeline(cfg, shape, seed=2, device=dev).batch(0)
        state = TrainState(step=0, params=params, opt_state=opt.init(params))
        _, metrics = make_train_step(model, opt, n_micro=n_micro)(state,
                                                                 batch)
        params.load_state_dict(init)
        _, _, grads = accumulate_grads(model.loss, params, batch, n_micro)
        runs.append((model, params, {k: float(v) for k, v in metrics.items()},
                     grads))
    (_, p_cpu, m_cpu, g_cpu), (_, p_gpu, m_gpu, g_gpu) = runs
    for k in ("loss", "grad_norm"):
        assert abs(m_gpu[k] - m_cpu[k]) <= 1e-4 * abs(m_cpu[k]), k
    tol = 1e-3 if arch == "rwkv6-3b" else 1e-4
    for name, g in g_cpu.items():
        assert _rel(g_gpu[name], g) < tol, name
    # the AdamW update on the card from the CPU's gradients
    states = [opt.update(params, grads, opt.init(params), 0)[1]
              for params, grads in ((p_cpu, g_cpu), (p_gpu, {
                  k: v.to(cuda) for k, v in g_cpu.items()}))]
    for (name, want), got in zip(p_cpu.named_parameters(),
                                 p_gpu.parameters()):
        assert _rel(got.detach(), want.detach()) < 1e-5, name
    if int8:         # the moments from the same gradients, bit for bit
        for name, mv in states[0]["mu"].items():
            for k in ("m", "v"):
                got = states[1]["mu"][name][k]
                assert torch.equal(got.q.cpu(), mv[k].q), (name, k)
                assert torch.equal(got.scale.cpu(), mv[k].scale), (name, k)


@pytest.mark.gpu
def test_gpu_int8_adamw_moments_bit_equal_cpu(cuda):
    cfg = get_reduced_config("gemma-2b")
    opt = adamw(cosine(3e-3, 10, 2), AdamWConfig(quantized_state=True))
    rng = np.random.default_rng(0)
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    p_cpu = model.make_params()
    init_params(p_cpu, torch.Generator().manual_seed(0))
    grads = [{n: torch.from_numpy(rng.standard_normal(tuple(p.shape))
                                  .astype(np.float32) * 1e-2)
              for n, p in p_cpu.named_parameters()} for _ in range(2)]
    p_gpu = build_model(cfg, dtype=torch.float32, device=cuda).make_params()
    p_gpu.load_state_dict(p_cpu.state_dict())
    st_cpu, st_gpu = opt.init(p_cpu), opt.init(p_gpu)
    for i, g in enumerate(grads):
        _, st_cpu = opt.update(p_cpu, g, st_cpu, i)
        _, st_gpu = opt.update(p_gpu, {k: v.to(cuda) for k, v in g.items()},
                               st_gpu, i)
        for name, mv in st_cpu["mu"].items():
            for k in ("m", "v"):
                want, got = mv[k], st_gpu["mu"][name][k]
                assert torch.equal(got.q.cpu(), want.q), (i, name, k)
                assert torch.equal(got.scale.cpu(), want.scale), (i, name, k)


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [False, True], ids=["exact", "int8"])
def test_gpu_sliced_leaf_update_bit_equal_whole(cuda, quantized,
                                                monkeypatch):
    """Three AdamW steps of a (16, 512, 1024) bf16 expert leaf on the card,
    updated in slices of 700 rows (a last slice shorter) against the
    same leaf updated whole: the parameter and the moments (f32, or int8
    ``q`` and ``scale``) equal bit for bit."""
    cfg = AdamWConfig(quantized_state=quantized)
    gen = torch.Generator(device=cuda).manual_seed(3)
    shape = (16, 512, 1024)
    p = torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
    runs = [(p.clone(), _leaf_init(p, quantized), 700 * 1024),
            (p.clone(), _leaf_init(p, quantized), p.numel())]
    for i in range(3):
        g = torch.randn(shape, generator=gen, device=cuda) * 10.0 ** -i
        lr = torch.tensor(3e-3 / (i + 1), device=cuda)
        t = torch.tensor(float(i + 1), device=cuda)
        for leaf, st, slice_values in runs:
            monkeypatch.setattr(tadamw, "SLICE_VALUES", slice_values)
            _leaf_update(leaf, g, st, lr, cfg, t)
        (a, sa, _), (b, sb, _) = runs
        assert torch.equal(a, b), i
        for k in ("m", "v"):
            xs = ((sa[k].q, sb[k].q), (sa[k].scale, sb[k].scale)) \
                if quantized else ((sa[k], sb[k]),)
            assert all(torch.equal(x, y) for x, y in xs), (i, k)


@pytest.mark.gpu
def test_gpu_inplace_clip_and_microbatch_mean_bit_equal(cuda):
    """On the card: the in-place clip equals the new-tree formula it
    replaced bit for bit (f32 and bf16 leaves), and the microbatch mean's
    division by a tensor on the card equals the CPU's division bit for bit
    at n_micro = 3 (CUDA turns a Python scalar divisor into a product with
    its reciprocal)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    tree = {"w": torch.randn((1024, 1024), generator=gen, device=cuda) * 3,
            "b": torch.randn((4096,), generator=gen, device=cuda)}
    for t in (tree, {k: v.to(torch.bfloat16) for k, v in tree.items()}):
        wn = global_norm(t)
        scale = torch.clamp(1.0 / torch.clamp(wn, min=1e-12), max=1.0)
        want = {k: (g.float() * scale).to(g.dtype) for k, g in t.items()}
        got, gn = clip_by_global_norm(t, 1.0)
        assert float(wn) > 1.0 and torch.equal(gn, wn)
        assert all(torch.equal(got[k], want[k]) for k in t)
    sums = torch.randn((1 << 20,), generator=gen, device=cuda)
    on_card = sums.clone().div_(sums.new_tensor(3.0))
    assert torch.equal(on_card.cpu(), sums.cpu() / 3)


@pytest.mark.gpu
def test_gpu_coded_mixer_input_gradient(cuda):
    b, s, d, taps = 2, 96, 32, 32
    p = tsp.decaying_filter_init(torch.Generator(device=cuda).manual_seed(0),
                                 d, taps, device=cuda)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (b, s, d)).astype(np.float32)).to(cuda)
    plan = CodedFFT(s=256, m=4, n_workers=6)
    mask = torch.tensor([True, False, True, True, False, True], device=cuda)
    xc = x.clone().requires_grad_()
    loss = (tsp.spectral_apply_coded(p, xc, plan, mask=mask) ** 2).mean()
    torch.cuda.synchronize()
    reset_launch_counts()
    gx, = torch.autograd.grad(loss, xc)
    torch.cuda.synchronize()
    assert launch_counts() == {"cmatmul": 2, "fourstep_fused": 1}
    xp = x.clone().requires_grad_()
    gp, = torch.autograd.grad((tsp.spectral_apply(p, xp) ** 2).mean(), xp)
    assert _rel(gx, gp) < 1e-5
