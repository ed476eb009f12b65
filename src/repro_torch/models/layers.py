"""Shared building blocks of the port's models (what RWKV-6 needs)."""

from __future__ import annotations

import torch

__all__ = ["layer_norm"]


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis, computed in f32 and cast back to
    ``x``'s dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * weight.float() + bias.float()).to(x.dtype)
