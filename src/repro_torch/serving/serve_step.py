"""Token sampling: greedy or temperature-categorical over the last-token
logits."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["sample_token"]


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 temperature: float = 0.0) -> torch.Tensor:
    """(B, 1, V) logits -> (B, 1) int32 tokens.  At ``temperature > 0``
    draws from ``generator`` (on the logits' device): torch's draws, not
    the JAX package's."""
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    flat = (logits / temperature).reshape(-1, logits.shape[-1]).float()
    toks = torch.multinomial(torch.softmax(flat, dim=-1), 1,
                             generator=generator)
    return toks.reshape(logits.shape[:-1]).to(torch.int32)
