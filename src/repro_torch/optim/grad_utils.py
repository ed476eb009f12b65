"""Gradient utilities: global-norm clipping and microbatch accumulation.

Gradients are dicts keyed by parameter name (``named_parameters``
order); the norm and the clip compute in f32 as the JAX package's do.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

__all__ = ["global_norm", "clip_by_global_norm", "accumulate_grads"]

F32 = torch.float32


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in f32."""
    total = sum(torch.sum(torch.square(g.float())) for g in tree.values())
    return torch.sqrt(torch.as_tensor(total, dtype=F32))


def clip_by_global_norm(tree: dict, max_norm: float
                        ) -> tuple[dict, torch.Tensor]:
    """Scale every leaf so the global norm is at most ``max_norm``, IN
    PLACE: each leaf scaled in f32 and written back in its dtype (the
    reference's ``(g.float() * scale).astype(g.dtype)`` bit for bit, one
    leaf's f32 transient alive instead of a second tree).  Returns
    (``tree``, the norm before)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in tree.values():
        if g.dtype == F32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return tree, norm


def _grads(loss: torch.Tensor, params: nn.Module) -> dict:
    named = [(n, p) for n, p in params.named_parameters() if p.requires_grad]
    gs = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(named, gs)}


def accumulate_grads(loss_fn: Callable, params: nn.Module, batch: dict,
                     n_micro: int):
    """Mean loss and gradients over ``n_micro`` microbatches.

    ``batch`` leaves have a leading ``global_batch`` axis, split into
    ``n_micro`` contiguous microbatches run one after another, so peak
    activation memory is one microbatch's.  The loss and the gradients
    are summed in f32 and divided by ``n_micro``; ``n_micro=1`` takes the
    gradients in the parameters' dtype.  Returns (loss, the last
    microbatch's metrics, {name: gradient})."""
    if n_micro == 1:
        loss, metrics = loss_fn(params, batch)
        return loss, metrics, _grads(loss, params)
    for x in batch.values():
        if x.shape[0] % n_micro:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"into {n_micro} microbatches")
    loss_sum, grad_sum, metrics = None, None, None
    for i in range(n_micro):
        mb = {k: x.reshape((n_micro, x.shape[0] // n_micro)
                           + tuple(x.shape[1:]))[i]
              for k, x in batch.items()}
        loss, metrics = loss_fn(params, mb)
        grads = _grads(loss, params)
        loss = loss.detach().float()
        loss_sum = loss if loss_sum is None else loss_sum + loss
        # leaf by leaf, each microbatch gradient dropped once it is added:
        # the f32 sums and one microbatch's gradients alive, no more
        # (adding a bf16 leaf into f32 in place casts it exactly, as
        # ``g.float()`` does)
        if grad_sum is None:
            grad_sum = {k: grads.pop(k).float() for k in list(grads)}
        else:
            for k in list(grads):
                grad_sum[k].add_(grads.pop(k))
        del grads
    metrics = {k: v.detach() for k, v in metrics.items()}
    # a tensor divisor on the sums' device: CUDA turns a division by a
    # Python scalar into a product with its reciprocal, one rounding off
    # the division for a count that is not a power of two; in place, so
    # no second tree of f32 gradients is made
    div = loss_sum.new_tensor(float(n_micro))
    for g in grad_sum.values():
        g.div_(div)
    return loss_sum / div, metrics, grad_sum
