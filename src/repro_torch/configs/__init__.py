"""Architecture registry of the port.

Each architecture the port builds is a frozen ``ArchConfig`` in its own
module (the published numbers), registered here under its ``--arch`` id;
``REDUCED`` is the same family at a small size, for CPU tests.  The
registry lists only the configurations whose family the port builds
(``models.model_factory``).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

__all__ = [
    "ARCH_IDS",
    "ArchConfig",
    "RWKVSettings",
    "get_config",
    "get_reduced_config",
]


@dataclasses.dataclass(frozen=True)
class RWKVSettings:
    head_size: int = 64
    decay_lora: int = 64
    mix_lora: int = 32


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """The fields the port's builders read; a family ported later brings
    its own."""

    name: str
    family: str                    # ssm (built) | dense | moe | hybrid | ...
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab_size: int
    rwkv: Optional[RWKVSettings] = None


_MODULES = {
    "rwkv6-3b": "rwkv6_3b",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port has "
                       f"{sorted(_MODULES)} (see ROADMAP.md, Queue 1, the "
                       f"seed LM stack)")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_reduced_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).REDUCED
