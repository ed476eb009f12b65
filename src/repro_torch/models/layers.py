"""Shared building blocks of the port's models: the norms, the MLPs, RoPE
and the logit soft cap, with the JAX package's rounding points (f32
inside where the reference computes in f32, cast back to the input's
dtype)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["apply_rotary", "layer_norm", "mlp_apply", "rms_norm",
           "rotary_cos_sin", "softcap"]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = True) -> torch.Tensor:
    """RMSNorm over the last axis in f32, cast back to ``x``'s dtype.
    ``zero_centered`` follows the Gemma/Griffin convention of storing
    ``weight - 1``."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if zero_centered:
        w = w + 1.0
    return (xf * w).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis, computed in f32 and cast back to
    ``x``'s dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * weight.float() + bias.float()).to(x.dtype)


def mlp_apply(x: torch.Tensor, p, variant: str) -> torch.Tensor:
    """Gated or plain MLP in the weights' dtype.  ``p`` has attributes
    ``wi``, ``wo`` and, gated, ``wg``.

    variant: swiglu (silu gate) | geglu (tanh-gelu gate) | gelu (plain
    two-layer, tanh-gelu)."""
    if variant in ("swiglu", "geglu"):
        h = x @ p.wi
        g = x @ p.wg
        act = F.silu(g) if variant == "swiglu" else F.gelu(g,
                                                           approximate="tanh")
        h = act * h
    elif variant == "gelu":
        h = F.gelu(x @ p.wi, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp variant {variant!r}")
    return h @ p.wo


def rotary_cos_sin(positions: torch.Tensor, head_dim: int,
                   theta: float = 10000.0
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """RoPE tables for integer ``positions`` (any shape) -> f32
    (..., head_dim/2)."""
    half = head_dim // 2
    exps = -torch.arange(half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = theta ** exps
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """RoPE on the half-split layout (not interleaved), in f32.  ``x``:
    (..., positions, heads, head_dim); cos/sin (positions, head_dim/2)
    broadcast over the heads."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s],
                     dim=-1).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap
