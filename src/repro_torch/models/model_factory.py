"""Uniform model API over the architecture families the port builds.

``build_model(cfg)`` returns a ``BuiltModel`` exposing:

* ``init(generator)``       materialised parameters (an ``nn.Module``)
* ``prefill / decode_step`` (params, ...) functions
* ``init_cache(batch)``     the decode state (RWKV-6's does not grow with
  the sequence)
* ``n_params``              for 6·N·D bookkeeping

The port builds family ``"ssm"`` (RWKV-6); the others raise, naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.plan import resolve_device
from repro_torch.models import rwkv6
from repro_torch.models.params import count_params, init_params

__all__ = ["BuiltModel", "build_model"]


@dataclasses.dataclass
class BuiltModel:
    cfg: ArchConfig
    prefill: Callable                    # (params, batch, cache) -> (logits, cache)
    decode_step: Callable                # (params, cache, batch) -> (logits, cache)
    init_cache: Callable                 # (batch,) -> cache
    n_params: int
    device: torch.device
    make_params: Callable                # () -> uninitialised parameters

    def init(self, generator: torch.Generator):
        """The parameters, drawn from ``generator`` (on ``device``)."""
        return init_params(self.make_params(), generator)


def build_model(cfg: ArchConfig, dtype=torch.bfloat16,
                device=None) -> BuiltModel:
    """The model of ``cfg`` on ``device`` (``None``: CUDA, raising without
    one; ``"cpu"`` runs the kernels' plain twins)."""
    fam = cfg.family
    if fam != "ssm":
        raise NotImplementedError(
            f"model family {fam!r} ({cfg.name}) is not built by the PyTorch "
            f"port yet -- see ROADMAP.md, Queue 1, the seed LM stack")
    device = resolve_device(device)
    return BuiltModel(
        cfg=cfg,
        prefill=rwkv6.rwkv_prefill,
        decode_step=rwkv6.rwkv_decode_step,
        init_cache=lambda batch: rwkv6.init_rwkv_state(cfg, batch, device),
        n_params=count_params(rwkv6.rwkv_specs(cfg)),
        device=device,
        make_params=lambda: rwkv6.RWKV6(cfg, dtype, device),
    )
