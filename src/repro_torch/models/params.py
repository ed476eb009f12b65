"""Parameter descriptors: shape, init and dtype of every parameter.

A model lists its parameters as :class:`Spec` trees (nested dicts and
lists); :class:`ParamModule` materialises one flat dict of them as the
parameters of an ``nn.Module``, and :func:`init_params` fills every such
module from one explicit ``torch.Generator``, by the JAX package's scheme:
a normal draw times 1/sqrt(fan_in) (``fan_in`` the first dimension unless
named; an ``embed`` at scale 1), or zeros, or ones.  The draws are
torch's, so a same-seed init differs from the JAX package's:
``convert.rwkv_params_from_reference`` carries its weights across.

The port serves and does not train yet, so parameters are created with
``requires_grad=False``.  One device needs no sharding: the reference's
logical axes stay out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

__all__ = ["ParamModule", "Spec", "count_params", "init_params"]


@dataclasses.dataclass(frozen=True)
class Spec:
    """Descriptor for one parameter tensor (``dtype=None``: the model's)."""

    shape: tuple[int, ...]
    init: str = "normal"             # normal | zeros | ones | embed
    fan_in: Optional[int] = None     # for 1/sqrt(fan_in) scaling
    dtype: Optional[torch.dtype] = None


def _leaves(tree):
    if isinstance(tree, Spec):
        yield tree
    elif isinstance(tree, dict):
        for sub in tree.values():
            yield from _leaves(sub)
    else:
        for sub in tree:
            yield from _leaves(sub)


def count_params(tree) -> int:
    """Elements of every Spec in a tree of dicts and lists."""
    return sum(math.prod(s.shape) for s in _leaves(tree))


class ParamModule(nn.Module):
    """An ``nn.Module`` whose own parameters are one flat dict of Specs,
    allocated (uninitialised) in ``dtype`` unless a Spec names its own."""

    def __init__(self, specs: dict, dtype: torch.dtype, device):
        super().__init__()
        self.specs = specs
        for name, spec in specs.items():
            data = torch.empty(spec.shape, dtype=spec.dtype or dtype,
                               device=device)
            self.register_parameter(
                name, nn.Parameter(data, requires_grad=False))


def _draw(spec: Spec, param: torch.Tensor, generator) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros_like(param)
    if spec.init == "ones":
        return torch.ones_like(param)
    fan_in = spec.fan_in
    if fan_in is None:
        fan_in = spec.shape[0] if len(spec.shape) > 1 else spec.shape[-1]
    scale = 1.0 if spec.init == "embed" else 1.0 / math.sqrt(max(fan_in, 1))
    # scaled in place: one f32 draw alive at a time (an expert stack's
    # draw alone is 21 GB at llama4-maverick's width)
    return torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                       device=param.device).mul_(scale)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every :class:`ParamModule` under ``module`` (module order, then
    Spec order) from ``generator``, which lies on the parameters' device."""
    for sub in module.modules():
        if isinstance(sub, ParamModule):
            for name, spec in sub.specs.items():
                param = getattr(sub, name)
                param.copy_(_draw(spec, param, generator))
    return module
