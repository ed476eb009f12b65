"""Parameter descriptors: shape, logical sharding axes, init and dtype
of every parameter.

A model lists its parameters as :class:`Spec` trees (nested dicts and
lists); :class:`ParamModule` materialises one flat dict of them as the
parameters of an ``nn.Module`` and keeps each Spec, so
:func:`named_specs` gives a built model's Spec by parameter name.
:func:`param_pspecs` maps a tree's logical axes through a rules table
(``distributed.sharding``) to the port's PartitionSpec tuples, so the
sharding plan derives from the same descriptors as the values.  A
Spec's axes are the JAX package's for the same tensor, less the leading
``"layers"`` axis where the reference stacks the layers: the port keeps
one entry a layer.  :func:`init_params` fills every ParamModule
from one explicit ``torch.Generator``, by the JAX package's scheme:
a normal draw times 1/sqrt(fan_in) (``fan_in`` the first dimension unless
named; an ``embed`` at scale 1), or zeros, or ones.  The draws are
torch's, so a same-seed init differs from the JAX package's:
``convert.rwkv_params_from_reference`` carries its weights across.

Parameters are created with ``requires_grad=False``, so serving builds
no autograd graph; ``training.init_train_state`` turns them on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from repro_torch.distributed.sharding import AxisRules, logical_spec

__all__ = ["ParamModule", "Spec", "abstract_params", "count_params",
           "init_params", "named_specs", "param_pspecs", "tree_bytes"]


@dataclasses.dataclass(frozen=True)
class Spec:
    """Descriptor for one parameter tensor (``dtype=None``: the model's)."""

    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]  # logical axis names, len == len(shape)
    init: str = "normal"             # normal | zeros | ones | embed
    fan_in: Optional[int] = None     # for 1/sqrt(fan_in) scaling
    dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


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


def _map(tree, fn):
    if isinstance(tree, Spec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return [_map(v, fn) for v in tree]


def abstract_params(tree, dtype: torch.dtype = torch.bfloat16):
    """The Spec tree as ``device="meta"`` tensors (shape and dtype, no
    storage): the reference's ShapeDtypeStruct mirror.  ``dtype`` is the
    model's, for Specs that name none."""
    return _map(tree, lambda s: torch.empty(s.shape, dtype=s.dtype or dtype,
                                            device="meta"))


def tree_bytes(tree, dtype: torch.dtype = torch.bfloat16) -> int:
    """Bytes of every Spec in the tree (``dtype`` for those naming none)."""
    return sum(math.prod(s.shape) * (s.dtype or dtype).itemsize
               for s in _leaves(tree))


def param_pspecs(tree, rules: Optional[AxisRules] = None):
    """The PartitionSpec tuple of every Spec, in the tree's structure (a
    Spec tree, or :func:`named_specs`' flat dict), under ``rules`` (the
    active rules when None; ``()`` without any)."""
    return _map(tree, lambda s: logical_spec(s.axes, rules))


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


def named_specs(module: nn.Module) -> dict:
    """``{parameter name: Spec}`` of every :class:`ParamModule` under
    ``module``, in ``named_parameters`` order."""
    return {(f"{prefix}.{name}" if prefix else name): spec
            for prefix, sub in module.named_modules()
            if isinstance(sub, ParamModule)
            for name, spec in sub.specs.items()}


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
