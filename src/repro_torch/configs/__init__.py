"""Architecture registry of the port.

Each architecture the port builds is a frozen ``ArchConfig`` in its own
module (the published numbers), registered here under its ``--arch`` id;
``REDUCED`` is the same family at a small size, for CPU tests.  The
registry holds every architecture of the JAX package's registry, each
family built by ``models.model_factory``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

__all__ = [
    "ARCH_IDS",
    "ArchConfig",
    "MoESettings",
    "RWKVSettings",
    "RecurrentSettings",
    "SHAPES",
    "ShapeConfig",
    "cell_runnable",
    "get_config",
    "get_reduced_config",
    "iter_cells",
]


@dataclasses.dataclass(frozen=True)
class MoESettings:
    num_experts: int
    top_k: int
    d_ff_expert: int
    interleave_step: int = 1      # 1 = every layer MoE; 2 = alternate dense/MoE
    num_shared_experts: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class RWKVSettings:
    head_size: int = 64
    decay_lora: int = 64
    mix_lora: int = 32


@dataclasses.dataclass(frozen=True)
class RecurrentSettings:
    """Griffin/RG-LRU hybrid settings."""

    d_rnn: int
    conv_width: int = 4
    block_pattern: tuple[str, ...] = ("rec", "rec", "attn")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """The fields the port's models read, with the reference's defaults.
    ``n_kv_heads`` and ``head_dim`` are required by the transformer
    families and the encoder-decoder (the ssm family reads
    ``rwkv.head_size``)."""

    name: str
    family: str                    # ssm | dense | vlm | moe | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab_size: int
    n_kv_heads: Optional[int] = None
    head_dim: Optional[int] = None
    mlp_variant: str = "swiglu"    # swiglu | geglu | gelu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    emb_multiplier: float = 1.0    # gemma: sqrt(d_model); minicpm: 12
    logit_divisor: float = 1.0     # minicpm: d_model / 256
    depth_scale: Optional[float] = None  # minicpm residual scale: v/sqrt(L)
    attn_window: Optional[int] = None
    logit_cap: Optional[float] = None
    norm: str = "rms"              # rms | ln
    moe: Optional[MoESettings] = None
    rwkv: Optional[RWKVSettings] = None
    recurrent: Optional[RecurrentSettings] = None
    encoder_layers: int = 0        # enc-dec only
    num_prefix_tokens: int = 0     # vlm: SigLIP patch count (stub frontend)
    frontend: Optional[str] = None  # "audio_frames" | "vision_patches" | None
    supports_long_context: bool = False
    kv_quant_decode: bool = False  # int8 KV for decode cells (memory fit)
    notes: str = ""

    @property
    def moe_layer_flags(self) -> tuple[bool, ...]:
        """Which layers are MoE: every ``interleave_step``-th, offset
        ``step - 1`` (the HF llama4 convention); none without ``moe``."""
        if self.moe is None:
            return tuple(False for _ in range(self.n_layers))
        step = self.moe.interleave_step
        return tuple((i % step) == (step - 1) for i in range(self.n_layers))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

_MODULES = {
    "recurrentgemma-9b": "recurrentgemma_9b",
    "qwen1.5-32b": "qwen1_5_32b",
    "minicpm-2b": "minicpm_2b",
    "qwen2.5-14b": "qwen2_5_14b",
    "gemma-2b": "gemma_2b",
    "whisper-medium": "whisper_medium",
    "dbrx-132b": "dbrx_132b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "rwkv6-3b": "rwkv6_3b",
    "paligemma-3b": "paligemma_3b",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_reduced_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).REDUCED


def cell_runnable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is this (arch x shape) cell runnable, and why not if not."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full quadratic attention at 512k context "
                       "(see DESIGN.md §4)")
    return True, ""


def iter_cells():
    """All 40 (arch, shape) cells with runnability verdicts."""
    for arch_id in ARCH_IDS:
        cfg = get_config(arch_id)
        for shape in SHAPES.values():
            ok, reason = cell_runnable(cfg, shape)
            yield arch_id, shape.name, ok, reason
