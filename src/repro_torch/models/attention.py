"""Chunked (flash-style) attention in plain PyTorch: the JAX package's
``chunked_attention`` forward, the same sums in the same order.

* a running softmax over KV chunks in f32 (O(Sq * chunk) scores);
* GQA/MQA by grouping the queries as (B, KH, G, Sq, D), query head
  h = kv_head * G + g, with no KV repeated in memory;
* causal, bidirectional, prefix-LM and sliding-window masks from position
  vectors, so ring-buffer caches (positions out of slot order) just work;
  KV is padded to a multiple of the chunk with position -1 (masked), and
  a fully masked query row gives 0, not a uniform average;
* int8-quantized KV chunks dequantized on the fly (per-token, per-head
  scales, through bf16 as in the reference).

No finished attention kernel (``scaled_dot_product_attention`` and the
like) is called: those sum in another order, and the tests hold the
port to the reference's chunked sums.  The reference's flash backward
belongs to training and is not ported yet.

Layouts: q (B, Sq, H, D); k, v (B, Skv, KH, D); output (B, Sq, H, D).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.models.layers import softcap

__all__ = ["QuantKV", "chunked_attention", "dequantize_kv", "quantize_kv",
           "ring_positions"]

_NEG_INF = -0.7 * torch.finfo(torch.float32).max


@dataclasses.dataclass
class QuantKV:
    """Int8 values and a per-(token, head) f32 scale."""

    q: torch.Tensor       # int8, (..., D)
    scale: torch.Tensor   # f32,  (..., 1)

    def __getitem__(self, idx) -> "QuantKV":
        return QuantKV(self.q[idx], self.scale[idx])


def quantize_kv(x: torch.Tensor) -> QuantKV:
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return QuantKV(q=q, scale=scale)


def dequantize_kv(x: Union[torch.Tensor, QuantKV],
                  dtype=torch.bfloat16) -> torch.Tensor:
    if isinstance(x, QuantKV):
        return (x.q.float() * x.scale).to(dtype)
    return x


def ring_positions(step: int, window: int, device=None) -> torch.Tensor:
    """Absolute positions held by each ring-buffer slot after ``step``
    writes: slot i holds p = step-1 - ((step-1-i) mod W); -1 where the
    slot has not been written yet (masked out)."""
    i = torch.arange(window, device=device)
    last = step - 1
    p = last - torch.remainder(last - i, window)
    return torch.where(p >= 0, p, -1)


def _pad_seq(x, pad: int):
    """Pad axis 1 of a (B, S, ...) tensor or QuantKV with ``pad`` zeros."""
    if isinstance(x, QuantKV):
        return QuantKV(_pad_seq(x.q, pad), _pad_seq(x.scale, pad))
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))


def chunked_attention(
    q: torch.Tensor,
    k: Union[torch.Tensor, QuantKV],
    v: Union[torch.Tensor, QuantKV],
    *,
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len: Optional[int] = None,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    chunk: int = 1024,
    logit_cap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash-style attention over KV chunks.  See the module docstring."""
    b, sq, h, d = q.shape
    kt = k.q if isinstance(k, QuantKV) else k
    skv, kh = kt.shape[1], kt.shape[2]
    if h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} KV heads")
    g = h // kh
    if scale is None:
        scale = d ** -0.5
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(sq, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(skv, device=dev)

    chunk = min(chunk, skv)
    pad = (-skv) % chunk
    if pad:                  # padded slots are masked by position -1
        k, v = _pad_seq(k, pad), _pad_seq(v, pad)
        kv_positions = F.pad(kv_positions, (0, pad), value=-1)
    n_chunks = (skv + pad) // chunk

    # (B, KH, G*Sq, D): one matrix product a chunk for every group
    qf = (q.reshape(b, sq, kh, g, d).permute(0, 2, 3, 1, 4).float()
          * scale).reshape(b, kh, g * sq, d)
    qpos = q_positions.to(torch.int64)[:, None]

    acc = torch.zeros((b, kh, g, sq, d), dtype=torch.float32, device=dev)
    m_run = torch.full((b, kh, g, sq), _NEG_INF, dtype=torch.float32,
                       device=dev)
    l_run = torch.zeros((b, kh, g, sq), dtype=torch.float32, device=dev)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        kc = dequantize_kv(k[:, sl]).float().permute(0, 2, 3, 1)  # (B,KH,D,C)
        vc = dequantize_kv(v[:, sl]).float().permute(0, 2, 1, 3)  # (B,KH,C,D)
        scores = torch.matmul(qf, kc).reshape(b, kh, g, sq, chunk)
        scores = softcap(scores, logit_cap)
        pc = kv_positions[sl][None, :]
        allowed = pc >= 0                                   # (1, C)
        if causal:
            allowed = allowed & (pc <= qpos)
        if window is not None:
            allowed = allowed & (pc > qpos - window)
        if prefix_len is not None:
            allowed = allowed | ((pc < prefix_len) & (pc >= 0))
        scores = torch.where(allowed, scores, _NEG_INF)
        m_new = torch.maximum(m_run, scores.amax(-1))
        alpha = torch.exp(m_run - m_new)
        # explicit zeroing keeps fully masked rows at p == 0 (not uniform)
        p = torch.exp(scores - m_new[..., None]) * allowed
        l_run = l_run * alpha + p.sum(-1)
        pv = torch.matmul(p.reshape(b, kh, g * sq, chunk), vc)
        acc = acc * alpha[..., None] + pv.reshape(b, kh, g, sq, d)
        m_run = m_new
    out = acc / torch.clamp(l_run[..., None], min=1e-20)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
