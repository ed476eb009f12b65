"""Batched generation engine: prefill a padded batch, then a decode loop.

Requests are left-padded into a fixed (batch, prompt_len) bucket and the
request list is padded to the fixed batch (``pad_requests``).  Tokens are
fetched ONE STEP BEHIND the decode launches: step t+1's decode is queued
on the device before token t crosses to the host, so the blocking fetch
and the per-token EOS bookkeeping overlap the next step's device work.
An EOS found on the host discards the already-launched step: wasted work
for one step, never a wrong token.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.models.model_factory import BuiltModel
from repro_torch.serving.batching import pad_requests
from repro_torch.serving.serve_step import sample_token

__all__ = ["EngineConfig", "GenerationEngine"]


@dataclasses.dataclass
class EngineConfig:
    batch_size: int = 4
    prompt_len: int = 32       # fixed prefill bucket
    max_new_tokens: int = 16
    cache_len: int = 128       # KV slots (the transformer; RWKV-6 ignores it)
    temperature: float = 0.0
    eos_id: Optional[int] = None
    seed: int = 0


def _fetch_async(tokens: torch.Tensor):
    """Start the copy of ``tokens`` to the host.  Returns (tokens, host
    copy, event to wait on before reading it, or None on the CPU)."""
    if tokens.device.type == "cpu":
        return tokens, tokens, None
    host = torch.empty(tokens.shape, dtype=tokens.dtype, pin_memory=True)
    host.copy_(tokens, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return tokens, host, done


class GenerationEngine:
    """Generation on a ``BuiltModel``'s device (CUDA unless the model was
    built for the CPU)."""

    def __init__(self, model: BuiltModel, params, ecfg: EngineConfig):
        self.model = model
        self.params = params
        self.ecfg = ecfg

    def _pad_prompts(self, prompts: Sequence[Sequence[int]]) -> np.ndarray:
        e = self.ecfg
        out = np.zeros((len(prompts), e.prompt_len), np.int32)
        for i, p in enumerate(prompts):
            p = list(p)[-e.prompt_len:]
            out[i, e.prompt_len - len(p):] = p  # left-pad
        return out

    @torch.inference_mode()
    def generate(self, prompts: Sequence[Sequence[int]],
                 generator: Optional[torch.Generator] = None
                 ) -> list[list[int]]:
        """Greedy/temperature generation for a batch of prompts."""
        e = self.ecfg
        dev = self.model.device
        prompts, n_live = pad_requests(list(prompts), e.batch_size,
                                       lambda: [0])
        tokens = torch.as_tensor(self._pad_prompts(prompts), device=dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(e.seed)

        cache = self.model.init_cache(e.batch_size, e.cache_len)
        logits, cache = self.model.prefill(self.params, {"tokens": tokens},
                                           cache)
        pending = _fetch_async(sample_token(logits, generator, e.temperature))

        outs: list[list[int]] = [[] for _ in range(e.batch_size)]
        done = np.zeros(e.batch_size, bool)
        step0 = e.prompt_len
        for t in range(e.max_new_tokens):
            spec = None
            if t + 1 < e.max_new_tokens:
                # queue step t+1 before token t is read on the host; the
                # token decoded sits at absolute position prompt_len + t
                logits, cache = self.model.decode_step(
                    self.params, cache, {"tokens": pending[0]}, step0 + t)
                spec = _fetch_async(
                    sample_token(logits, generator, e.temperature))
            _, host, ready = pending
            if ready is not None:
                ready.synchronize()
            toks = host.numpy().reshape(-1)
            for i in range(n_live):
                if not done[i]:
                    outs[i].append(int(toks[i]))
                    if e.eos_id is not None and toks[i] == e.eos_id:
                        done[i] = True
            if done[:n_live].all() or spec is None:
                break
            pending = spec
        return [outs[i] for i in range(n_live)]
