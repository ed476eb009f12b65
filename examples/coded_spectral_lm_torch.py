"""Coded FFT inside a model, on the PyTorch port: a spectral long-conv
mixer whose sequence FFT runs under the paper's coded computation plan.

The mixer computes y = irfft(rfft(x) * rfft(h)) per channel; because the
DFT is linear, running it through the (N, m)-MDS coded plan gives the
layer straggler tolerance for free (paper §III-B linearity argument).  We
knock out N - m workers and show the layer's output -- and its filter
gradient -- are unchanged.  On the card the plan runs the ``cmatmul``
encode and decode and the ``fourstep_fused`` worker; their launches are
printed.  It runs on the card unless ``--device cpu`` asks for the CPU.

Run:  PYTHONPATH=src python examples/coded_spectral_lm_torch.py
      PYTHONPATH=src python examples/coded_spectral_lm_torch.py --device cpu
"""

import argparse

import torch

from repro_torch.core import CodedFFT
from repro_torch.core.plan import resolve_device
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models.spectral import (
    decaying_filter_init,
    spectral_apply,
    spectral_apply_coded,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, raising without one)")
    dev = resolve_device(ap.parse_args(argv).device)
    d_model, seq, filt = 32, 96, 32
    p = decaying_filter_init(torch.Generator(device=dev).manual_seed(0),
                             d_model, filt, device=dev)
    x = torch.randn((2, seq, d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))

    # plain spectral mixer (what an FNO/Hyena-style block computes)
    y_plain = spectral_apply(p, x)

    # the same mixer, FFT executed via the coded plan with 2/6 workers dead
    plan = CodedFFT(s=256, m=4, n_workers=6, device=dev)
    mask = torch.tensor([True, False, True, True, False, True], device=dev)
    reset_launch_counts()
    y_coded = spectral_apply_coded(p, x, plan, mask=mask)
    launches = launch_counts()

    err = float((y_plain - y_coded).abs().max())
    print(f"[spectral] coded vs plain mixer output err: {err:.2e} "
          f"(2/{plan.n_workers} workers down; kernel launches {launches})")
    assert err < 1e-3

    # the filter's gradient is the same through the coded path
    def filter_grad(mixer):
        pp = {k: v.clone().requires_grad_() for k, v in p.items()}
        return torch.autograd.grad((mixer(pp) ** 2).mean(), pp["h"])[0]

    g1 = filter_grad(lambda pp: spectral_apply(pp, x))
    g2 = filter_grad(lambda pp: spectral_apply_coded(pp, x, plan, mask=mask))
    gerr = float((g1 - g2).abs().max())
    print(f"[spectral] filter-gradient err coded vs plain: {gerr:.2e}")
    assert gerr < 1e-4
    print("[spectral] straggler-tolerant spectral layer: OK")


if __name__ == "__main__":
    main()
