"""Serving steps: prefill + single-token decode for every family, and
token sampling.

``make_serve_fns`` returns ``(prefill_fn, decode_fn)`` closed over a
``BuiltModel``, with the JAX package's signatures; there they are the
functions its launcher jits with explicit shardings, here plain closures
over the eager model (a captured decode step is not built).  Sampling is
greedy or temperature-categorical over the last-token logits.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["make_serve_fns", "sample_token"]


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


def make_serve_fns(model) -> tuple[Callable, Callable]:
    """``(prefill_fn, decode_fn)`` of ``model`` (a ``BuiltModel``):
    ``prefill_fn(params, batch, cache)`` and ``decode_fn(params, cache,
    tokens, step)``, which wraps the (B, 1) tokens as ``{"tokens":
    tokens}``; each returns (logits, cache)."""

    def prefill_fn(params, batch: dict, cache):
        return model.prefill(params, batch, cache)

    def decode_fn(params, cache, tokens: torch.Tensor, step):
        return model.decode_step(params, cache, {"tokens": tokens}, step)

    return prefill_fn, decode_fn
