"""Sequence-chunked cross-entropy: the JAX package's ``sharded_xent_loss``.

The unembedding runs a sequence chunk at a time, so the (B, S, V) logits
are never held whole: each chunk's logits are a bf16 product with f32
accumulation (``transformer.bf16_logits``), divided by
``logit_divisor``; the label logit is picked out and ``logsumexp``
reduces in f32.  The sequence is zero-padded to a multiple of
``seq_chunk`` (the padding masked out).

The loss is a ``torch.autograd.Function`` whose backward recomputes each
chunk's logits from the saved hidden states, the unembedding and the
per-token log-sum-exp: autograd would otherwise keep every chunk's f32
logits alive (about 1 GB a chunk at gemma-2b's 256,000-word vocabulary
and a batch of 4).  The backward rounds as the reference's does: the
hidden states' and the unembedding's gradients are the f32 products of
the logits' gradient with the other bf16 operand, rounded to bf16 and
cast to their own dtype, the unembedding's summed over chunks (last
first, as the reference's transposed scan) in its dtype.  Those bf16
roundings are :data:`HEAD_DTYPE`'s; the tests set it to float32 on both
packages to hold the rest of an f32 model's backward to f32 sums.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["HEAD_DTYPE", "sharded_xent_loss"]

F32 = torch.float32
HEAD_DTYPE = torch.bfloat16   # the head's operands and gradient rounding


def _chunk_logits(h: torch.Tensor, wb: torch.Tensor,
                  logit_divisor: float) -> torch.Tensor:
    from repro_torch.models.transformer import bf16_logits

    if wb.dtype == F32:
        return (h.float() @ wb) / logit_divisor
    return bf16_logits(h, wb) / logit_divisor


class _ChunkedXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, unembed, labels, mask, logit_divisor,
                seq_chunk):
        wb = unembed.to(HEAD_DTYPE)
        loss_sum = torch.zeros((), dtype=F32, device=hidden.device)
        count = torch.zeros((), dtype=F32, device=hidden.device)
        lses = []
        for i in range(hidden.shape[1] // seq_chunk):
            sl = slice(i * seq_chunk, (i + 1) * seq_chunk)
            logits = _chunk_logits(hidden[:, sl], wb, logit_divisor)
            lse = torch.logsumexp(logits, dim=-1)
            label_logit = logits.gather(-1, labels[:, sl, None])[..., 0]
            del logits
            token_loss = (lse - label_logit) * mask[:, sl]
            loss_sum = loss_sum + token_loss.sum()
            count = count + mask[:, sl].sum()
            lses.append(lse)
        ctx.save_for_backward(hidden, unembed, labels, mask,
                              torch.cat(lses, dim=1))
        ctx.logit_divisor, ctx.seq_chunk = logit_divisor, seq_chunk
        ctx.mark_non_differentiable(count)
        return loss_sum, count

    @staticmethod
    def backward(ctx, g_sum, g_count):
        hidden, unembed, labels, mask, lse = ctx.saved_tensors
        div, c = ctx.logit_divisor, ctx.seq_chunk
        want_h, want_w = ctx.needs_input_grad[:2]
        dt = HEAD_DTYPE
        wb = unembed.to(dt)
        wf = wb.float()
        dh = torch.zeros_like(hidden) if want_h else None
        dw = torch.zeros_like(unembed) if want_w else None
        # last chunk first, as the reference's transposed scan sums them
        for i in reversed(range(hidden.shape[1] // c)):
            sl = slice(i * c, (i + 1) * c)
            # d loss / d logits = g * mask * (softmax - onehot), in place
            dlog = _chunk_logits(hidden[:, sl], wb, div)
            dlog.sub_(lse[:, sl, None]).exp_()
            lab = labels[:, sl, None]
            dlog.scatter_(-1, lab, dlog.gather(-1, lab) - 1.0)
            dlog.mul_((g_sum * mask[:, sl])[..., None] / div)
            flat = dlog.reshape(-1, dlog.shape[-1])
            if want_h:
                dh[:, sl] = (flat @ wf.T).to(dt).reshape(
                    dh[:, sl].shape).to(dh.dtype)
            if want_w:
                hb = hidden[:, sl].to(dt).float()
                dw += (hb.reshape(-1, hb.shape[-1]).T @ flat).to(dt).to(
                    dw.dtype)
            del dlog, flat
        return dh, dw, None, None, None, None


def sharded_xent_loss(hidden: torch.Tensor, unembed: torch.Tensor,
                      labels: torch.Tensor, *,
                      mask: Optional[torch.Tensor] = None,
                      logit_divisor: float = 1.0,
                      seq_chunk: int = 256
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of the token losses, token count), both f32 scalars -- the
    caller divides.  ``hidden`` (B, S, D), ``unembed`` (D, V),
    ``labels`` (B, S) integers, ``mask`` (B, S) {0, 1} or None."""
    b, s, _ = hidden.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=F32, device=hidden.device)
    labels = labels.long()
    mask = mask.to(F32)
    seq_chunk = min(seq_chunk, s)
    pad = (-s) % seq_chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    return _ChunkedXent.apply(hidden, unembed, labels, mask,
                              float(logit_divisor), seq_chunk)
