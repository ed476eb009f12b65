"""Spectral long-convolution token mixer: the coded FFT inside a model.

An FFT-based global-convolution layer (FNO/Hyena-style): each channel
owns a causal long filter h_d, and mixing is ``y[:, :, d] = (x[:, :, d]
* h_d)[:S]``, computed as ``irfft(rfft(pad(x)) . rfft(pad(h)))``.  With
:func:`spectral_apply_coded` the sequence FFT runs through the coded
plan (``CodedFFT``: the ``cmatmul`` encode and decode, the four-step
worker kernels), so the layer inherits the plan's straggler tolerance by
the linearity of the DFT (paper §III-B).

The JAX package's ``models/spectral.py``.  The filter's own transforms
and the inverse transform are ``torch.fft``, outside any kernel, where
the reference uses ``jnp.fft``; the filter's gradients (``h``,
``decay``, ``skip``) flow through them.  The gradient with respect to
``x`` runs the coded plan once more: the plan computes the length-s DFT
F whatever the responders, F is symmetric, so its adjoint is ``F^H g =
conj(F conj(g))`` -- the forward's kernels (the ``cmatmul`` encode and
decode, one worker pass) on the conjugated gradient, with the same
responders.  Parameters are a dict of tensors, as
``decaying_filter_init`` makes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import mds
from repro_torch.core.coded_fft import CodedFFT
from repro_torch.kernels import ops
from repro_torch.models.params import Spec

__all__ = ["decaying_filter_init", "spectral_apply", "spectral_apply_coded",
           "spectral_specs"]


def spectral_specs(d_model: int, filter_len: int,
                   dtype=torch.float32) -> dict:
    """Per-channel causal filters (d_model, filter_len), a decay rate and
    a skip gain a channel."""
    return {
        "h": Spec((d_model, filter_len), ("p_fsdp", None), init="zeros",
                  dtype=dtype),
        "decay": Spec((d_model,), ("p_fsdp",), init="zeros", dtype=dtype),
        "skip": Spec((d_model,), ("p_fsdp",), init="ones", dtype=dtype),
    }


def decaying_filter_init(generator: torch.Generator, d_model: int,
                         filter_len: int, dtype=torch.float32,
                         device=None) -> dict:
    """Smooth exponentially decaying filters, drawn from ``generator``
    (on ``device``): rates uniform in [0.001, 0.1), then a standard
    normal draw times 0.02; zero decay and unit skip."""
    t = torch.arange(filter_len, dtype=torch.float32, device=device)
    rates = torch.rand((d_model, 1), generator=generator,
                       device=device) * (0.1 - 0.001) + 0.001
    noise = torch.randn((d_model, filter_len), generator=generator,
                        device=device)
    base = torch.exp(-rates * t) * noise * 0.02
    return {
        "h": base.to(dtype),
        "decay": torch.zeros(d_model, dtype=dtype, device=device),
        "skip": torch.ones(d_model, dtype=dtype, device=device),
    }


def _effective_filter(p: dict, filter_len: int) -> torch.Tensor:
    """The learned filter times a learned per-channel decay envelope,
    (D, F) f32."""
    t = torch.arange(filter_len, dtype=torch.float32, device=p["h"].device)
    env = torch.exp(-F.softplus(p["decay"].float())[:, None] * t[None, :])
    return p["h"].float() * env


def _skip(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x.float() * p["skip"].float()


def spectral_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Causal FFT long convolution, (B, S, D) -> (B, S, D) in ``x``'s
    dtype, on ``torch.fft`` (the reference's unused ``fft_fn`` argument
    is not carried)."""
    s = x.shape[1]
    h = _effective_filter(p, p["h"].shape[-1])           # (D, F)
    n = 1
    while n < s + h.shape[-1]:                           # linear (causal)
        n *= 2
    xf = torch.fft.rfft(x.float(), n=n, dim=1)           # (B, n/2+1, D)
    hf = torch.fft.rfft(h, n=n, dim=-1).T[None]          # (1, n/2+1, D)
    y = torch.fft.irfft(xf * hf, n=n, dim=1)[:, :s]
    return (y + _skip(p, x)).to(x.dtype)


def _run_rows(plan: CodedFFT, rows: torch.Tensor,
              mask: Optional[torch.Tensor]) -> torch.Tensor:
    """``jax.vmap(lambda r: plan.run(r, mask=mask))(rows)`` as one
    batched call: one encode and one worker pass over every row, then
    every row decoded as an unbatched request decodes -- one shared
    subset (the first m available workers), and on the kernel backend
    ``inv(G[subset])`` applied by ONE ``mds_apply`` (``cmatmul``) with
    the rows folded into its payload.  (The plan's batched ``run``
    decodes a shared mask per request with ``torch.linalg.solve``, the
    reference's batched dispatch.)"""
    b = plan.worker_compute(plan.encode(rows))           # (R, N, L)
    if mask is None:
        subset = torch.arange(plan.m, device=plan.device)
    else:
        subset = mds.first_available(
            plan._as_tensor(mask).bool().reshape(-1), plan.m)
    if plan.resolved_backend != "kernel":
        return plan.decode(b, subset=subset)
    dmat = mds.subset_decode_matrix(plan.decode_generator, subset).to(
        plan.dtype)
    c_hat = ops.mds_apply(dmat, b[:, subset].transpose(0, 1))  # (m, R, L)
    return plan.postdecode(c_hat.transpose(0, 1))


class _CodedRows(torch.autograd.Function):
    """:func:`_run_rows` with its adjoint: the backward is the same plan
    on ``conj(g)``, conjugated (``F^H g = conj(F conj(g))``)."""

    @staticmethod
    def forward(ctx, rows, plan, mask):
        ctx.plan, ctx.mask = plan, mask
        return _run_rows(plan, rows, mask)

    @staticmethod
    def backward(ctx, g):
        with torch.no_grad():
            out = _run_rows(ctx.plan, torch.conj_physical(g), ctx.mask)
        return torch.conj_physical(out), None, None


def spectral_apply_coded(p: dict, x: torch.Tensor, plan: CodedFFT,
                         mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The same mixer with the forward sequence FFT under the coded plan:
    each (batch, channel) row, zero-padded to ``plan.s`` points, is one
    transform request, and all B * D of them go through the plan at once
    (:func:`_run_rows`), responders picked by the shared ``mask`` (N,);
    the gradient with respect to ``x`` runs them through the plan again
    (:class:`_CodedRows`).  Returns (B, S, D) in ``x``'s dtype."""
    b, s, d = x.shape
    h = _effective_filter(p, p["h"].shape[-1])
    n = plan.s
    if n < s + h.shape[-1]:
        raise ValueError(f"plan.s={n} must cover the linear convolution's "
                         f"{s + h.shape[-1]} points")
    rows = x.to(torch.complex64).movedim(1, -1).reshape(b * d, s)
    rows = F.pad(rows, (0, n - s))
    xf = _CodedRows.apply(rows, plan, mask).reshape(b, d, n)   # coded FFT
    hf = torch.fft.fft(h, n=n, dim=-1)[None]             # (1, D, n)
    y = torch.fft.ifft(xf * hf, dim=-1).real[..., :s]    # (B, D, S)
    return (y.movedim(1, -1) + _skip(p, x)).to(x.dtype)
