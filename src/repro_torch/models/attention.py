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
port to the reference's chunked sums.

The flash backward (the reference's ``custom_vjp``) is a
``torch.autograd.Function``: where a gradient is wanted, natural
positions and unquantized K/V, the forward keeps only q, k, v, the f32
output and the log-sum-exp, and the backward recomputes each KV chunk's
scores.  Int8 K/V is decode-only and refuses a gradient.

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
    if scale is None:
        scale = d ** -0.5
    needs_grad = torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in (q, k, v))
    quant = isinstance(k, QuantKV) or isinstance(v, QuantKV)
    if needs_grad and quant:
        raise ValueError("int8 K/V is decode-only: no gradient flows "
                         "through a QuantKV")
    if needs_grad and q_positions is None and kv_positions is None:
        return _Flash.apply(q, k, v, (causal, window, prefix_len, chunk,
                                      logit_cap, float(scale)))
    out5, _ = _forward(q, k, v, causal=causal, window=window,
                       prefix_len=prefix_len, q_positions=q_positions,
                       kv_positions=kv_positions, chunk=chunk,
                       logit_cap=logit_cap, scale=scale)
    return _merge_heads(out5, q.dtype)


def _merge_heads(out5: torch.Tensor, dtype) -> torch.Tensor:
    """(B, KH, G, Sq, D) -> (B, Sq, H, D) in ``dtype``."""
    b, kh, g, sq, d = out5.shape
    return out5.permute(0, 3, 1, 2, 4).reshape(b, sq, kh * g, d).to(dtype)


def _group_queries(x: torch.Tensor, kh: int) -> torch.Tensor:
    """(B, Sq, H, D) -> (B, KH, G, Sq, D) f32."""
    b, sq, h, d = x.shape
    return x.reshape(b, sq, kh, h // kh, d).permute(0, 2, 3, 1, 4).float()


def _allowed(pc, qpos, causal, window, prefix_len):
    """(Sq, C) mask from the chunk's positions (1, C) and the queries'
    (Sq, 1); slots at position -1 are padding."""
    allowed = pc >= 0
    if causal:
        allowed = allowed & (pc <= qpos)
    if window is not None:
        allowed = allowed & (pc > qpos - window)
    if prefix_len is not None:
        allowed = allowed | ((pc < prefix_len) & (pc >= 0))
    return allowed


def _padded(k, v, kv_positions, chunk):
    """K/V and their positions padded to a multiple of ``chunk`` (padded
    slots at position -1, masked); returns them and the chunk count."""
    skv = (k.q if isinstance(k, QuantKV) else k).shape[1]
    pad = (-skv) % chunk
    if pad:
        k, v = _pad_seq(k, pad), _pad_seq(v, pad)
        kv_positions = F.pad(kv_positions, (0, pad), value=-1)
    return k, v, kv_positions, (skv + pad) // chunk


def _forward(q, k, v, *, causal, window, prefix_len, q_positions,
             kv_positions, chunk, logit_cap, scale):
    """The running-softmax scan.  Returns the f32 output (B, KH, G, Sq,
    D) and the log-sum-exp (B, KH, G, Sq)."""
    b, sq, h, d = q.shape
    kt = k.q if isinstance(k, QuantKV) else k
    skv, kh = kt.shape[1], kt.shape[2]
    g = h // kh
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(sq, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(skv, device=dev)
    chunk = min(chunk, skv)
    k, v, kv_positions, n_chunks = _padded(k, v, kv_positions, chunk)

    # (B, KH, G*Sq, D): one matrix product a chunk for every group
    qf = (_group_queries(q, kh) * scale).reshape(b, kh, g * sq, d)
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
        allowed = _allowed(kv_positions[sl][None, :], qpos, causal, window,
                           prefix_len)
        scores = torch.where(allowed, scores, _NEG_INF)
        m_new = torch.maximum(m_run, scores.amax(-1))
        alpha = torch.exp(m_run - m_new)
        # explicit zeroing keeps fully masked rows at p == 0 (not uniform)
        p = torch.exp(scores - m_new[..., None]) * allowed
        l_run = l_run * alpha + p.sum(-1)
        pv = torch.matmul(p.reshape(b, kh, g * sq, chunk), vc)
        acc = acc * alpha[..., None] + pv.reshape(b, kh, g, sq, d)
        m_run = m_new
    l_safe = torch.clamp(l_run, min=1e-20)
    return acc / l_safe[..., None], m_run + torch.log(l_safe)


class _Flash(torch.autograd.Function):
    """Attention at natural positions with the reference's flash
    backward: the scores recomputed a KV chunk at a time from q, k, v,
    the output and the log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, cfg):
        causal, window, prefix_len, chunk, logit_cap, scale = cfg
        out5, lse = _forward(q, k, v, causal=causal, window=window,
                             prefix_len=prefix_len, q_positions=None,
                             kv_positions=None, chunk=chunk,
                             logit_cap=logit_cap, scale=scale)
        ctx.save_for_backward(q, k, v, out5, lse)
        ctx.cfg = cfg
        return _merge_heads(out5, q.dtype)

    @staticmethod
    def backward(ctx, dout):
        causal, window, prefix_len, chunk, logit_cap, scale = ctx.cfg
        q, k, v, out5, lse = ctx.saved_tensors
        b, sq, h, d = q.shape
        skv, kh = k.shape[1], k.shape[2]
        g = h // kh
        dev = q.device
        chunk = min(chunk, skv)
        kp, vp, kv_pos, n_chunks = _padded(
            k, v, torch.arange(skv, device=dev), chunk)
        qf = _group_queries(q, kh)                       # (B,KH,G,Sq,D)
        do5 = _group_queries(dout, kh)
        delta = (do5 * out5).sum(-1)                     # (B,KH,G,Sq)
        qs = (qf * scale).reshape(b, kh, g * sq, d)
        qflat = qf.reshape(b, kh, g * sq, d)
        doflat = do5.reshape(b, kh, g * sq, d)
        qpos = torch.arange(sq, device=dev)[:, None]
        dq = torch.zeros((b, kh, g * sq, d), dtype=torch.float32, device=dev)
        dks, dvs = [], []
        for i in range(n_chunks):
            sl = slice(i * chunk, (i + 1) * chunk)
            kc = kp[:, sl].float().permute(0, 2, 1, 3)   # (B,KH,C,D)
            vc = vp[:, sl].float().permute(0, 2, 1, 3)
            raw = torch.matmul(qs, kc.transpose(-1, -2))
            sc = softcap(raw, logit_cap).reshape(b, kh, g, sq, chunk)
            allowed = _allowed(kv_pos[sl][None, :], qpos, causal, window,
                               prefix_len)
            s = torch.where(allowed, sc, _NEG_INF)
            p = torch.exp(s - lse[..., None]) * allowed
            pflat = p.reshape(b, kh, g * sq, chunk)
            dvs.append(torch.matmul(pflat.transpose(-1, -2), doflat))
            dp = torch.matmul(doflat, vc.transpose(-1, -2)).reshape(p.shape)
            ds = p * (dp - delta[..., None])
            if logit_cap is not None:
                # d softcap(x)/dx = 1 - (capped / cap)^2 from the unmasked
                # scores (masked entries already have ds == 0 through p)
                ds = ds * (1.0 - torch.square(sc / logit_cap))
            dsflat = ds.reshape(b, kh, g * sq, chunk)
            dq = dq + torch.matmul(dsflat, kc) * scale
            dks.append(torch.matmul(dsflat.transpose(-1, -2), qflat) * scale)
        dq = _merge_heads(dq.reshape(b, kh, g, sq, d), q.dtype)
        # (B, KH, S', D) -> (B, S, KH, D)
        dk = torch.cat(dks, 2)[:, :, :skv].transpose(1, 2).to(k.dtype)
        dv = torch.cat(dvs, 2)[:, :, :skv].transpose(1, 2).to(v.dtype)
        return dq, dk, dv, None
