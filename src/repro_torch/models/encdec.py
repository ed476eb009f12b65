"""Whisper-style encoder-decoder (arXiv:2212.04356) for serving and
training (:func:`encdec_loss`): family ``encdec``.

The conv frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings ``batch["frames"]`` (B, T, d_model).  Both
stacks are pre-LN transformers with LayerNorm, a GELU MLP with biases
and sinusoidal positions added to their inputs (no RoPE); the head is
the tied embedding.

The JAX package's ``models/encdec.py`` as an ``nn.Module`` tree of
:class:`ParamModule`s: ``embed``, ``enc_ln_post``, ``dec_ln_post`` and
the layers as ``enc_layers.<i>`` and ``dec_layers.<i>`` (the reference
scans two layer-stacked trees; ``convert.encdec_params_from_reference``
splits them).  Serving goes through the model API only, as in the
reference: ``encdec_prefill(params, {"frames", "tokens"}, cache)``, then
``encdec_decode_step``; a prefill without ``frames`` raises ``KeyError``,
so the tokens-only ``GenerationEngine`` cannot serve the family.

The decode cache is ``{"self": {"k", "v"}, "cross": {"k", "v"}}``, each
(layers, B, C, KH, hd) in the model's dtype.  The self-attention K/V are
written IN PLACE at fixed shapes (``cache_len`` slots).  The prefill
computes each layer's cross K/V once from the encoder output and
returns them in a new cache dict, as long as the encoder's output (the
``cache_len`` long cross arrays of ``init_encdec_cache`` are a
placeholder, as in the reference), so decode attends over exactly the
frames.

Rounding points, as in the reference: the projections and the MLP in the
weights' dtype, the norms and attention in f32 and cast back, the head a
bf16 product with f32 logits.  Frames are cast to the weights' dtype
first (the reference promotes the encoder to f32 for f32 frames on bf16
weights; see ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.attention import chunked_attention
from repro_torch.models.layers import (
    layer_norm,
    mlp_apply,
    sinusoidal_positions,
)
from repro_torch.models.losses import sharded_xent_loss
from repro_torch.models.params import ParamModule, Spec

__all__ = [
    "DEC_CHUNK",
    "ENC_CHUNK",
    "EncDec",
    "encdec_decode_step",
    "encdec_loss",
    "encdec_prefill",
    "encdec_specs",
    "encode",
    "init_encdec_cache",
]

# the reference's KV chunks: encoder, prefill and cross attention; the
# decode step's self-attention
ENC_CHUNK = 1024
DEC_CHUNK = 2048
F32 = torch.float32


# --------------------------------------------------------------------------
# parameter specs
# --------------------------------------------------------------------------
def _ln(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    return {"w": Spec((d,), (None,), init="ones", dtype=F32),
            "b": Spec((d,), (None,), init="zeros", dtype=F32)}


def _mlp_bias_specs(cfg: ArchConfig) -> dict:
    sp = transformer._mlp_specs(cfg)
    sp["bi"] = Spec((cfg.d_ff,), ("p_mlp",), init="zeros")
    sp["bo"] = Spec((cfg.d_model,), (None,), init="zeros")
    return sp


def _enc_layer(cfg: ArchConfig) -> dict:
    return {"ln1": _ln(cfg), "attn": transformer._attn_specs(cfg),
            "ln2": _ln(cfg), "mlp": _mlp_bias_specs(cfg)}


def _dec_layer(cfg: ArchConfig) -> dict:
    return {"ln1": _ln(cfg), "self_attn": transformer._attn_specs(cfg),
            "ln_x": _ln(cfg), "cross_attn": transformer._attn_specs(cfg),
            "ln2": _ln(cfg), "mlp": _mlp_bias_specs(cfg)}


def encdec_specs(cfg: ArchConfig) -> dict:
    """The model's Spec tree; ``enc_layers`` and ``dec_layers`` are
    lists, one entry a layer."""
    if cfg.n_kv_heads is None or cfg.head_dim is None:
        raise ValueError(f"{cfg.name}: the encoder-decoder needs n_kv_heads "
                         f"and head_dim")
    return {
        "embed": Spec((cfg.vocab_size, cfg.d_model), ("p_vocab", "p_fsdp"),
                      init="embed"),
        "enc_ln_post": _ln(cfg),
        "dec_ln_post": _ln(cfg),
        "enc_layers": [_enc_layer(cfg) for _ in range(cfg.encoder_layers)],
        "dec_layers": [_dec_layer(cfg) for _ in range(cfg.n_layers)],
    }


# --------------------------------------------------------------------------
# attention (no RoPE: the positions are added to the inputs)
# --------------------------------------------------------------------------
def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bsd,dhk->bshk", x, w)


def _out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", o, w)


def _ln_apply(p: ParamModule, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, p.w, p.b)


def _kv(p: ParamModule, x: torch.Tensor):
    return _proj(x, p.wk), _proj(x, p.wv)


def _attend(p: ParamModule, xq: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    """Bidirectional attention of ``xq`` over every position of ``k``,
    ``v``: the encoder's self-attention and the decoder's
    cross-attention."""
    out = chunked_attention(_proj(xq, p.wq), k, v, causal=False,
                            chunk=ENC_CHUNK)
    return _out(out, p.wo)


def _self_attn(p: ParamModule, xn: torch.Tensor, *, mode: str, cache=None,
               step=None) -> torch.Tensor:
    """Causal self-attention of the decoder.  ``cache``: this layer's
    ``{"k", "v"}`` (B, C, KH, hd), written in place: prefill attends over
    the new K/V, then stores them at slots 0..T-1; decode stores the one
    new token at ``step``, then attends over the whole cache."""
    q, (k, v) = _proj(xn, p.wq), _kv(p, xn)
    if mode in ("train", "prefill"):
        out = chunked_attention(q, k, v, causal=True, chunk=ENC_CHUNK)
        if cache is not None:
            t = xn.shape[1]
            cache["k"][:, :t] = k.to(cache["k"].dtype)
            cache["v"][:, :t] = v.to(cache["v"].dtype)
    else:
        kc, vc = cache["k"], cache["v"]
        kc[:, step:step + 1] = k.to(kc.dtype)
        vc[:, step:step + 1] = v.to(vc.dtype)
        dev = xn.device
        out = chunked_attention(
            q, kc, vc, causal=True,
            q_positions=torch.arange(step, step + 1, device=dev),
            kv_positions=torch.arange(kc.shape[1], device=dev),
            chunk=DEC_CHUNK)
    return _out(out, p.wo)


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------
class _Layer(nn.Module):
    """A layer's parameter groups (``ln1``, ``attn``, ...), one
    :class:`ParamModule` each, named as the reference's subtrees."""

    def __init__(self, specs: dict, dtype, device):
        super().__init__()
        for name, sub in specs.items():
            setattr(self, name, ParamModule(sub, dtype, device))


class EncoderLayer(_Layer):
    """Pre-LN bidirectional self-attention, then the GELU MLP."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xn = _ln_apply(self.ln1, x)
        x = x + _attend(self.attn, xn, *_kv(self.attn, xn))
        return x + mlp_apply(_ln_apply(self.ln2, x), self.mlp, "gelu")


class DecoderLayer(_Layer):
    """Pre-LN causal self-attention, cross-attention over the encoder's
    K/V, then the GELU MLP."""

    def cross_kv(self, enc_out: torch.Tensor):
        """This layer's cross K/V of the encoder output (B, T, KH, hd)."""
        return _kv(self.cross_attn, enc_out)

    def forward(self, x, cross_k, cross_v, *, mode, cache=None, step=None):
        x = x + _self_attn(self.self_attn, _ln_apply(self.ln1, x),
                           mode=mode, cache=cache, step=step)
        x = x + _attend(self.cross_attn, _ln_apply(self.ln_x, x), cross_k,
                        cross_v)
        return x + mlp_apply(_ln_apply(self.ln2, x), self.mlp, "gelu")


class EncDec(ParamModule):
    """The whole model's parameters: ``embed`` (the head's too),
    ``enc_ln_post``, ``dec_ln_post``, ``enc_layers`` and ``dec_layers``
    (state-dict names as the JAX package's tree paths, one entry a
    layer)."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        specs = encdec_specs(cfg)
        super().__init__({"embed": specs["embed"]}, dtype, device)
        self.cfg = cfg
        self.enc_ln_post = ParamModule(specs["enc_ln_post"], dtype, device)
        self.dec_ln_post = ParamModule(specs["dec_ln_post"], dtype, device)
        self.enc_layers = nn.ModuleList(
            EncoderLayer(ls, dtype, device) for ls in specs["enc_layers"])
        self.dec_layers = nn.ModuleList(
            DecoderLayer(ls, dtype, device) for ls in specs["dec_layers"])


# --------------------------------------------------------------------------
# the stacks, the cache and the model API
# --------------------------------------------------------------------------
def encode(params: EncDec, frames: torch.Tensor) -> torch.Tensor:
    """The encoder over frame embeddings (B, T, D), cast to the weights'
    dtype; returns (B, T, D) after ``enc_ln_post``."""
    x = frames.to(params.embed.dtype)
    x = x + sinusoidal_positions(x.shape[1], x.shape[2],
                                 device=x.device).to(x.dtype)
    for layer in params.enc_layers:
        x = layer(x)
    return _ln_apply(params.enc_ln_post, x)


def _layer_cache(cache: dict, i: int) -> dict:
    return {kv: cache["self"][kv][i] for kv in ("k", "v")}


def _decoder(params: EncDec, tokens: torch.Tensor, cache: dict, *, mode: str,
             enc_out=None, step=None):
    """The decoder stack on ``tokens`` (B, S) at positions 0..S-1
    (train, no cache, or prefill; cross K/V from ``enc_out``) or at
    ``step`` (decode, cross
    K/V from the cache); ``dec_ln_post`` applied.  Returns the hidden
    states and, in prefill, the new cross K/V ``{"k", "v"}`` (layers, B,
    T_enc, KH, hd) in the cache's dtype."""
    x = params.embed[tokens.long()]
    cross = None
    if mode == "train":
        pos = sinusoidal_positions(x.shape[1], x.shape[2], device=x.device)
    elif mode == "prefill":
        c_len = cache["self"]["k"].shape[2]
        t = x.shape[1]
        if t > c_len:
            raise ValueError(f"a prompt of {t} tokens does not fit the "
                             f"cache's {c_len} slots")
        pos = sinusoidal_positions(t, x.shape[2], device=x.device)
        b, t_enc = enc_out.shape[:2]
        kc = cache["self"]["k"]
        cross = {kv: torch.empty((len(params.dec_layers), b, t_enc)
                                 + tuple(kc.shape[3:]),
                                 dtype=kc.dtype, device=kc.device)
                 for kv in ("k", "v")}
    elif mode == "decode":
        if step >= cache["self"]["k"].shape[2]:
            # the reference's dynamic_slice/dynamic_update_slice would
            # clamp the position and the write onto the last slot
            raise ValueError(f"decode step {step} past the cache's "
                             f"{cache['self']['k'].shape[2]} slots")
        pos = sinusoidal_positions(1, x.shape[2], start=step, device=x.device)
    else:
        raise ValueError(f"unknown mode {mode!r} (train | prefill | decode)")
    x = x + pos.to(x.dtype)
    for i, layer in enumerate(params.dec_layers):
        if mode == "decode":
            ck, cv = cache["cross"]["k"][i], cache["cross"]["v"][i]
        else:
            ck, cv = layer.cross_kv(enc_out)
            if mode == "prefill":
                cross["k"][i], cross["v"][i] = ck, cv
        x = layer(x, ck, cv, mode=mode,
                  cache=None if cache is None else _layer_cache(cache, i),
                  step=step)
    return _ln_apply(params.dec_ln_post, x), cross


def _head(params: EncDec, x: torch.Tensor) -> torch.Tensor:
    """The tied bf16 head with f32 accumulation: f32 logits."""
    return transformer.bf16_logits(x, params.embed.T)


def init_encdec_cache(cfg: ArchConfig, batch: int, cache_len, *,
                      dtype=torch.bfloat16, device=None) -> dict:
    """Zeroed cache ``{"self": {"k", "v"}, "cross": {"k", "v"}}``, each
    (layers, B, ``cache_len``, KH, hd) in ``dtype``; the prefill replaces
    the cross arrays with the encoder's length."""
    if cache_len is None:
        raise ValueError("the encoder-decoder's cache needs a cache_len")
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)

    def zeros():
        return torch.zeros(shape, dtype=dtype, device=device)

    return {part: {"k": zeros(), "v": zeros()} for part in ("self", "cross")}


def encdec_loss(params: EncDec, batch: dict):
    """Encode ``batch["frames"]`` (cast to the weights' dtype), then the
    mean next-token cross-entropy of the decoder on ``batch["tokens"]``
    against ``batch["labels"]`` through the tied head.  Returns (loss,
    {"xent"})."""
    enc_out = encode(params, batch["frames"])
    x, _ = _decoder(params, batch["tokens"], None, mode="train",
                    enc_out=enc_out)
    loss_sum, count = sharded_xent_loss(x, params.embed.T, batch["labels"],
                                        mask=batch.get("mask"))
    loss = loss_sum / torch.clamp(count, min=1.0)
    return loss, {"xent": loss}


@torch.no_grad()
def encdec_prefill(params: EncDec, batch: dict, cache: dict):
    """Encode ``batch["frames"]`` (B, T_enc, D), then prefill
    ``batch["tokens"]`` (B, T) into ``cache``'s self K/V (in place).
    Returns the last position's logits (B, 1, V) f32 and a new cache dict
    holding the cross K/V of length T_enc."""
    enc_out = encode(params, batch["frames"])
    x, cross = _decoder(params, batch["tokens"], cache, mode="prefill",
                        enc_out=enc_out)
    return _head(params, x[:, -1:]), dict(cache, cross=cross)


@torch.no_grad()
def encdec_decode_step(params: EncDec, cache: dict, batch: dict, step):
    """One decode step: ``batch["tokens"]`` (B, 1) at absolute position
    ``step`` (an int).  Returns (B, 1, V) f32 logits and the cache."""
    x, _ = _decoder(params, batch["tokens"], cache, mode="decode",
                    step=int(step))
    return _head(params, x), cache
