"""Uniform model API over the architecture families the port builds.

``build_model(cfg)`` returns a ``BuiltModel`` exposing:

* ``init(generator)``       materialised parameters (an ``nn.Module``)
* ``loss(params, batch)``   (mean next-token loss, metrics): the family's
  training loss, which autograd differentiates
* ``prefill(params, batch, cache)`` and
  ``decode_step(params, cache, batch, step)`` (``step`` the absolute
  position of the decoded token)
* ``init_cache(batch, cache_len=None, quantized=False)``  the decode
  state: the transformer's KV cache (``cache_len`` slots, int8 when
  ``quantized``); the hybrid's attention K/V (``cache_len`` slots, at
  most ``attn_window``) and recurrent states; the encoder-decoder's self
  and cross K/V (``cache_len`` slots; the prefill replaces the cross
  K/V with the encoder's length); RWKV-6's state does not grow with the
  sequence and ignores both
* ``n_params / n_active_params``  for 6·N·D bookkeeping (the active
  count leaves out the experts a token does not reach)
* ``specs`` the Spec tree (``params.abstract_params`` gives it as
  ``device="meta"`` tensors) and ``input_specs(shape)`` a batch's inputs
  as meta tensors

The port builds every family of the JAX package: ``"ssm"`` (RWKV-6),
``"dense"``, ``"moe"`` and ``"vlm"`` (the decoder-only transformer),
``"hybrid"`` (Griffin) and ``"encdec"`` (Whisper, whose prefill needs
``batch["frames"]``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.core.plan import resolve_device
from repro_torch.models import encdec, rglru, rwkv6, transformer
from repro_torch.models.params import count_params, init_params

__all__ = ["BuiltModel", "build_model"]


@dataclasses.dataclass
class BuiltModel:
    cfg: ArchConfig
    loss: Callable                       # (params, batch) -> (loss, metrics)
    prefill: Callable                    # (params, batch, cache) -> (logits, cache)
    decode_step: Callable                # (params, cache, batch, step) -> (logits, cache)
    init_cache: Callable                 # (batch, cache_len, quantized) -> cache
    n_params: int
    n_active_params: int
    device: torch.device
    make_params: Callable                # (device=None) -> uninitialised params
    specs: dict                          # the Spec tree
    dtype: torch.dtype                   # the weights' (Specs naming none)

    def init(self, generator: torch.Generator):
        """The parameters, drawn from ``generator`` (on ``device``)."""
        return init_params(self.make_params(), generator)

    def input_specs(self, shape: ShapeConfig) -> dict:
        """A batch of ``shape`` as ``device="meta"`` tensors: int32 tokens
        (and labels for training), bf16 frames (encdec) or patches
        (vlm; the text trimmed so the total is ``seq_len``)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def tok(*sh):
            return torch.empty(sh, dtype=torch.int32, device="meta")

        def emb(*sh):
            return torch.empty(sh, dtype=torch.bfloat16, device="meta")

        if shape.kind == "decode":     # one new token against the cache
            return {"tokens": tok(b, 1)}
        train = shape.kind == "train"
        if cfg.family == "encdec":
            out = {"frames": emb(b, s, cfg.d_model), "tokens": tok(b, s)}
        elif cfg.family == "vlm":
            text = s - cfg.num_prefix_tokens
            out = {"patches": emb(b, cfg.num_prefix_tokens, cfg.d_model),
                   "tokens": tok(b, text)}
        else:
            out = {"tokens": tok(b, s)}
        if train:
            out["labels"] = tok(*out["tokens"].shape)
        return out


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
    if fam not in ("ssm", "dense", "moe", "vlm", "hybrid", "encdec"):
        raise ValueError(f"unknown family {fam}")
    device = resolve_device(device)
    if fam == "ssm":
        specs, module = rwkv6.rwkv_specs(cfg), rwkv6.RWKV6
        loss, prefill = rwkv6.rwkv_loss, rwkv6.rwkv_prefill
        decode = lambda p, c, b, step: rwkv6.rwkv_decode_step(p, c, b)
        init_cache = lambda batch, cache_len=None, quantized=False: \
            rwkv6.init_rwkv_state(cfg, batch, device)
    elif fam == "hybrid":
        specs, module = rglru.griffin_specs(cfg), rglru.Griffin
        loss, prefill = rglru.griffin_loss, rglru.griffin_prefill
        decode = rglru.griffin_decode_step
        init_cache = lambda batch, cache_len=None, quantized=False: \
            rglru.init_griffin_state(cfg, batch, cache_len, dtype=dtype,
                                     device=device)
    elif fam == "encdec":
        specs, module = encdec.encdec_specs(cfg), encdec.EncDec
        loss, prefill = encdec.encdec_loss, encdec.encdec_prefill
        decode = encdec.encdec_decode_step
        init_cache = lambda batch, cache_len=None, quantized=False: \
            encdec.init_encdec_cache(cfg, batch, cache_len, dtype=dtype,
                                     device=device)
    else:
        specs, module = transformer.transformer_specs(cfg), \
            transformer.Transformer
        loss, prefill = transformer.lm_loss, transformer.lm_prefill
        decode = transformer.lm_decode_step
        init_cache = lambda batch, cache_len=None, quantized=False: \
            transformer.init_kv_cache(cfg, batch, cache_len,
                                      quantized=quantized, dtype=dtype,
                                      device=device)
    n = count_params(specs)
    return BuiltModel(
        cfg=cfg,
        loss=loss,
        prefill=prefill,
        decode_step=decode,
        init_cache=init_cache,
        n_params=n,
        n_active_params=_count_active(cfg, n),
        device=device,
        make_params=lambda on=None: module(cfg, dtype,
                                           device if on is None else on),
        specs=specs,
        dtype=dtype,
    )
