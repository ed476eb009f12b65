"""Uniform model API over the architecture families the port builds.

``build_model(cfg)`` returns a ``BuiltModel`` exposing:

* ``init(generator)``       materialised parameters (an ``nn.Module``)
* ``prefill(params, batch, cache)`` and
  ``decode_step(params, cache, batch, step)`` (``step`` the absolute
  position of the decoded token)
* ``init_cache(batch, cache_len=None, quantized=False)``  the decode
  state: the transformer's KV cache (``cache_len`` slots, int8 when
  ``quantized``); the hybrid's attention K/V (``cache_len`` slots, at
  most ``attn_window``) and recurrent states; RWKV-6's state does not
  grow with the sequence and ignores both
* ``n_params / n_active_params``  for 6·N·D bookkeeping (the active
  count leaves out the experts a token does not reach)

The port builds families ``"ssm"`` (RWKV-6), ``"dense"``, ``"moe"`` and
``"vlm"`` (the decoder-only transformer) and ``"hybrid"`` (Griffin);
``"encdec"`` raises, naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.plan import resolve_device
from repro_torch.models import rglru, rwkv6, transformer
from repro_torch.models.params import count_params, init_params

__all__ = ["BuiltModel", "build_model"]


@dataclasses.dataclass
class BuiltModel:
    cfg: ArchConfig
    prefill: Callable                    # (params, batch, cache) -> (logits, cache)
    decode_step: Callable                # (params, cache, batch, step) -> (logits, cache)
    init_cache: Callable                 # (batch, cache_len, quantized) -> cache
    n_params: int
    n_active_params: int
    device: torch.device
    make_params: Callable                # () -> uninitialised parameters

    def init(self, generator: torch.Generator):
        """The parameters, drawn from ``generator`` (on ``device``)."""
        return init_params(self.make_params(), generator)


def _count_active(cfg: ArchConfig, total: int) -> int:
    """``total`` less the expert weights (wi, wg, wo) of the experts a
    token does not reach: (E - k) of them in each MoE layer."""
    if cfg.moe is None:
        return total
    moe = cfg.moe
    expert_params_per_layer = 3 * cfg.d_model * moe.d_ff_expert
    n_moe_layers = sum(cfg.moe_layer_flags)
    return total - (n_moe_layers * (moe.num_experts - moe.top_k)
                    * expert_params_per_layer)


def build_model(cfg: ArchConfig, dtype=torch.bfloat16,
                device=None) -> BuiltModel:
    """The model of ``cfg`` on ``device`` (``None``: CUDA, raising without
    one; ``"cpu"`` runs the kernels' plain twins)."""
    fam = cfg.family
    if fam not in ("ssm", "dense", "moe", "vlm", "hybrid"):
        raise NotImplementedError(
            f"model family {fam!r} ({cfg.name}) is not built by the PyTorch "
            f"port yet -- see ROADMAP.md, Queue 1, the seed LM stack")
    device = resolve_device(device)
    if fam == "ssm":
        n = count_params(rwkv6.rwkv_specs(cfg))
        return BuiltModel(
            cfg=cfg,
            prefill=rwkv6.rwkv_prefill,
            decode_step=lambda p, c, b, step: rwkv6.rwkv_decode_step(p, c, b),
            init_cache=lambda batch, cache_len=None, quantized=False:
                rwkv6.init_rwkv_state(cfg, batch, device),
            n_params=n,
            n_active_params=n,
            device=device,
            make_params=lambda: rwkv6.RWKV6(cfg, dtype, device),
        )
    if fam == "hybrid":
        n = count_params(rglru.griffin_specs(cfg))
        return BuiltModel(
            cfg=cfg,
            prefill=rglru.griffin_prefill,
            decode_step=rglru.griffin_decode_step,
            init_cache=lambda batch, cache_len=None, quantized=False:
                rglru.init_griffin_state(cfg, batch, cache_len, dtype=dtype,
                                         device=device),
            n_params=n,
            n_active_params=n,
            device=device,
            make_params=lambda: rglru.Griffin(cfg, dtype, device),
        )
    n = count_params(transformer.transformer_specs(cfg))
    return BuiltModel(
        cfg=cfg,
        prefill=transformer.lm_prefill,
        decode_step=transformer.lm_decode_step,
        init_cache=lambda batch, cache_len=None, quantized=False:
            transformer.init_kv_cache(cfg, batch, cache_len,
                                      quantized=quantized, dtype=dtype,
                                      device=device),
        n_params=n,
        n_active_params=_count_active(cfg, n),
        device=device,
        make_params=lambda: transformer.Transformer(cfg, dtype, device),
    )
