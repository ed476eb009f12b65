"""Decoder-only transformer LM for serving: families ``dense``, ``moe``
(the MoE FFN of ``models/moe.py`` on the layers ``moe_layer_flags``
marks) and ``vlm`` (a prefix-LM over stub patch embeddings on the same
stack).

The JAX package's ``models/transformer.py`` as an ``nn.Module`` tree of
:class:`ParamModule`s, layers as ``layers.<i>`` in layer order (the
reference scans a stacked tree of superblock slots, layer ``r * step +
s`` in slot ``s`` at repeat ``r``; ``convert.transformer_params_from_
reference`` splits it).  Prefill fills a KV cache, then decode steps
attend over it: a full cache written at slot ``step``, a ring cache of
``attn_window`` slots when the config sets a window, or an int8
:class:`QuantKV` cache.  Both write the new K/V into the cache IN PLACE
and return it (the reference's engine donates the cache the same way).

Rounding points, as in the reference: q/k/v, the attention output
projection, the MLP and the expert products in the weights' dtype (bf16
on the card); the norms, RoPE, attention and the MoE router in f32,
cast back; the cache in its own dtype; the head a bf16 product with f32
logits (``torch.mm(..., out_dtype=torch.float32)`` on the card), then
divided by ``logit_divisor``.  Attention is plain tensor code
(``models/attention.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs import ArchConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import (
    QuantKV,
    chunked_attention,
    quantize_kv,
    ring_positions,
)
from repro_torch.models.layers import (
    apply_rotary,
    layer_norm,
    mlp_apply,
    rms_norm,
    rotary_cos_sin,
)
from repro_torch.models.params import ParamModule, Spec

__all__ = [
    "ATTN_CHUNK",
    "DecoderLayer",
    "Transformer",
    "attn_apply",
    "bf16_logits",
    "decoder_hidden",
    "embed_tokens",
    "init_kv_cache",
    "lm_decode_step",
    "lm_prefill",
    "norm_apply",
    "transformer_specs",
    "unembed_matrix",
]

ATTN_CHUNK = 1024
F32 = torch.float32


# --------------------------------------------------------------------------
# parameter specs
# --------------------------------------------------------------------------
def _attn_specs(cfg: ArchConfig) -> dict:
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sp = {
        "wq": Spec((d, h, hd), fan_in=d),
        "wk": Spec((d, kh, hd), fan_in=d),
        "wv": Spec((d, kh, hd), fan_in=d),
        "wo": Spec((h, hd, d), fan_in=h * hd),
    }
    if cfg.qkv_bias:
        sp["bq"] = Spec((h, hd), init="zeros")
        sp["bk"] = Spec((kh, hd), init="zeros")
        sp["bv"] = Spec((kh, hd), init="zeros")
    return sp


def _mlp_specs(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_variant in ("swiglu", "geglu"):
        return {"wi": Spec((d, f), fan_in=d), "wg": Spec((d, f), fan_in=d),
                "wo": Spec((f, d), fan_in=f)}
    return {"wi": Spec((d, f), fan_in=d), "wo": Spec((f, d), fan_in=f)}


def _norm_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    if cfg.norm == "ln":
        return {"w": Spec((d,), init="ones", dtype=F32),
                "b": Spec((d,), init="zeros", dtype=F32)}
    # zero-centred RMSNorm: the weight is stored as w - 1
    return {"w": Spec((d,), init="zeros", dtype=F32)}


def _layer_specs(cfg: ArchConfig, is_moe: bool) -> dict:
    sp = {"ln1": _norm_specs(cfg), "attn": _attn_specs(cfg),
          "ln2": _norm_specs(cfg)}
    if is_moe:
        sp["moe"] = moe_lib.moe_layer_specs(cfg.d_model, cfg.moe)
    else:
        sp["mlp"] = _mlp_specs(cfg)
    return sp


def _check_periodic(cfg: ArchConfig) -> None:
    """The reference scans superblocks of ``interleave_step`` layers, so
    the MoE layers must repeat with that period over the whole depth."""
    if cfg.moe is None:
        return
    flags, step = cfg.moe_layer_flags, cfg.moe.interleave_step
    if flags != flags[:step] * (cfg.n_layers // step):
        raise ValueError(f"{cfg.name}: non-periodic MoE pattern ("
                         f"{cfg.n_layers} layers, interleave_step {step})")


def transformer_specs(cfg: ArchConfig) -> dict:
    """The model's Spec tree; ``layers`` is a list, one entry a layer."""
    if cfg.n_kv_heads is None or cfg.head_dim is None:
        raise ValueError(f"{cfg.name}: the transformer needs n_kv_heads "
                         f"and head_dim")
    _check_periodic(cfg)
    sp = {
        "embed": Spec((cfg.vocab_size, cfg.d_model), init="embed"),
        "final_norm": _norm_specs(cfg),
        "layers": [_layer_specs(cfg, is_moe)
                   for is_moe in cfg.moe_layer_flags],
    }
    if not cfg.tie_embeddings:
        sp["unembed"] = Spec((cfg.d_model, cfg.vocab_size),
                             fan_in=cfg.d_model)
    return sp


def norm_apply(p: ParamModule, cfg: ArchConfig,
               x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "ln":
        return layer_norm(x, p.w, p.b)
    return rms_norm(x, p.w, zero_centered=True)


def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as the reference's
    ``jnp.asarray(value, dtype)`` before a product."""
    return float(torch.tensor(value, dtype=dtype))


# --------------------------------------------------------------------------
# attention with cache handling
# --------------------------------------------------------------------------
def _write(cache_kv, new: torch.Tensor, idx) -> None:
    """Store (B, S, KH, hd) rows at sequence slots ``idx`` of one layer's
    cache (B, C, KH, hd), in place; quantized when the cache is."""
    if isinstance(cache_kv, QuantKV):
        qn = quantize_kv(new)
        cache_kv.q[:, idx] = qn.q
        cache_kv.scale[:, idx] = qn.scale
    else:
        cache_kv[:, idx] = new.to(cache_kv.dtype)


def attn_apply(p: ParamModule, cfg: ArchConfig, x: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor, *, mode: str,
               cache=None, step=None, prefix_len=None) -> torch.Tensor:
    """Self-attention of (B, S, D) ``x`` (a sliding window where the
    config sets ``attn_window``).  ``cache``: this layer's
    ``{"k": ..., "v": ...}`` (each (B, C, KH, hd) or a QuantKV), written
    in place; ``mode`` prefill (attend over the new K/V, then store them)
    or decode (store the one new token at ``step``, then attend over the
    whole cache)."""
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)

    s, window = x.shape[1], cfg.attn_window
    if mode == "prefill":
        out = chunked_attention(q, k, v, causal=True, window=window,
                                prefix_len=prefix_len, chunk=ATTN_CHUNK,
                                logit_cap=cfg.logit_cap)
        if cache is not None:
            c_len = _cache_len(cache)
            if c_len >= s:
                _write(cache["k"], k, slice(0, s))
                _write(cache["v"], v, slice(0, s))
            else:    # sliding-window ring cache: keep the last c_len tokens
                idx = torch.arange(s - c_len, s, device=x.device) % c_len
                _write(cache["k"], k[:, s - c_len:], idx)
                _write(cache["v"], v[:, s - c_len:], idx)
    elif mode == "decode":
        if cache is None or step is None:
            raise ValueError("decode needs the layer's cache and the step")
        c_len = _cache_len(cache)
        ring = window is not None and c_len == window
        if not ring and step >= c_len:
            # the reference's dynamic_update_slice would clamp the write
            # onto the last slot; refuse instead
            raise ValueError(f"decode step {step} past the cache's "
                             f"{c_len} slots (no attn_window ring)")
        slot = step % c_len if ring else step
        _write(cache["k"], k, slice(slot, slot + 1))
        _write(cache["v"], v, slice(slot, slot + 1))
        kv_pos = (ring_positions(step + 1, c_len, x.device) if ring
                  else torch.arange(c_len, device=x.device))
        out = chunked_attention(
            q, cache["k"], cache["v"], causal=True, window=window,
            prefix_len=prefix_len,
            q_positions=torch.arange(step, step + 1, device=x.device),
            kv_positions=kv_pos, chunk=min(2048, c_len),
            logit_cap=cfg.logit_cap)
    else:
        raise ValueError(f"unknown mode {mode!r} (prefill | decode)")
    return torch.einsum("bshk,hkd->bsd", out, p.wo)


def _cache_len(cache: dict) -> int:
    kc = cache["k"]
    return (kc.q if isinstance(kc, QuantKV) else kc).shape[1]


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------
class DecoderLayer(nn.Module):
    """Pre-norm attention, then the MLP or (an MoE layer) the MoE FFN,
    each residual branch scaled by ``depth_scale / sqrt(n_layers)`` where
    the config sets it.  Returns (x, the MoE aux loss or None)."""

    def __init__(self, cfg: ArchConfig, specs: dict, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = ParamModule(specs["ln1"], dtype, device)
        self.attn = ParamModule(specs["attn"], dtype, device)
        self.ln2 = ParamModule(specs["ln2"], dtype, device)
        self.is_moe = "moe" in specs
        if self.is_moe:
            self.moe = ParamModule(specs["moe"], dtype, device)
            # the reference's router by top_k: Llama-4's sigmoid top-1
            self.router_style = "sigmoid" if cfg.moe.top_k == 1 else "softmax"
        else:
            self.mlp = ParamModule(specs["mlp"], dtype, device)
        self.resid_scale = (None if cfg.depth_scale is None else
                            _rounded(cfg.depth_scale / cfg.n_layers ** 0.5,
                                     dtype))

    def forward(self, x, cos, sin, *, mode, cache=None, step=None,
                prefix_len=None):
        cfg = self.cfg
        h = attn_apply(self.attn, cfg, norm_apply(self.ln1, cfg, x), cos,
                       sin, mode=mode, cache=cache, step=step,
                       prefix_len=prefix_len)
        if self.resid_scale is not None:
            h = h * self.resid_scale
        x = x + h
        hn = norm_apply(self.ln2, cfg, x)
        aux = None
        if self.is_moe:
            h2, aux = moe_lib.moe_ffn(hn, self.moe, cfg.moe,
                                      router_style=self.router_style)
        else:
            h2 = mlp_apply(hn, self.mlp, cfg.mlp_variant)
        if self.resid_scale is not None:
            h2 = h2 * self.resid_scale
        return x + h2, aux


class Transformer(ParamModule):
    """The whole model's parameters: ``embed`` (and ``unembed`` when the
    embeddings are untied), ``final_norm`` and ``layers`` (state-dict
    names as the JAX package's tree paths, one entry a layer)."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        specs = transformer_specs(cfg)
        super().__init__({k: specs[k] for k in ("embed", "unembed")
                          if k in specs}, dtype, device)
        self.cfg = cfg
        self.final_norm = ParamModule(specs["final_norm"], dtype, device)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, ls, dtype, device) for ls in specs["layers"])
        self.emb_multiplier = _rounded(cfg.emb_multiplier, dtype)


# --------------------------------------------------------------------------
# the stack, embeddings and heads
# --------------------------------------------------------------------------
def decoder_hidden(params: Transformer, embeds: torch.Tensor, *, mode: str,
                   cache=None, step=None, prefix_len=None,
                   with_aux: bool = False):
    """Run the stack on (B, S, D) ``embeds`` at positions 0..S-1, or at
    ``step`` in decode; the final norm applied.  ``cache``
    (``init_kv_cache``'s) is written in place.  With ``with_aux``,
    returns (hidden, the MoE layers' summed f32 aux loss)."""
    cfg = params.cfg
    dev = embeds.device
    positions = (torch.arange(step, step + 1, device=dev) if mode == "decode"
                 else torch.arange(embeds.shape[1], device=dev))
    cos, sin = rotary_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    x = embeds
    aux_sum = torch.zeros((), dtype=F32, device=dev) if with_aux else None
    for i, layer in enumerate(params.layers):
        x, aux = layer(x, cos, sin, mode=mode,
                       cache=None if cache is None else {
                           kv: cache[kv][i] for kv in ("k", "v")},
                       step=step, prefix_len=prefix_len)
        if with_aux and aux is not None:
            aux_sum = aux_sum + aux
    hidden = norm_apply(params.final_norm, cfg, x)
    return (hidden, aux_sum) if with_aux else hidden


def embed_tokens(params: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``embed`` times the multiplier rounded to their dtype."""
    return params.embed[tokens.long()] * params.emb_multiplier


def unembed_matrix(params: Transformer) -> torch.Tensor:
    """(D, V): ``embed.T`` (a view, no copy) when tied, else ``unembed``."""
    if params.cfg.tie_embeddings:
        return params.embed.T
    return params.unembed


def bf16_logits(hidden: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., D) ``hidden`` and the (D, V) unembedding, both rounded to
    bf16, in one product with f32 accumulation: f32 logits (..., V)."""
    xb = hidden.to(torch.bfloat16).reshape(-1, hidden.shape[-1])
    wb = w.to(torch.bfloat16)
    if xb.is_cuda:
        logits = torch.mm(xb, wb, out_dtype=F32)
    else:
        # a product of two bf16 values is exact in f32: the same sums
        logits = xb.float() @ wb.float()
    return logits.reshape(*hidden.shape[:-1], -1)


def _head(params: Transformer, hidden: torch.Tensor) -> torch.Tensor:
    """The bf16 head against ``unembed_matrix``, divided by
    ``logit_divisor``."""
    return (bf16_logits(hidden, unembed_matrix(params))
            / params.cfg.logit_divisor)


def _prep_embeds(params: Transformer, batch: dict):
    """Token embeddings, after the vlm's patch prefix where the config
    has one and the batch carries ``patches`` (B, P, D).  Returns
    (embeds, prefix_len or None)."""
    cfg = params.cfg
    tok_emb = embed_tokens(params, batch["tokens"])
    if cfg.num_prefix_tokens and "patches" in batch:
        prefix = batch["patches"].to(tok_emb.dtype)
        return torch.cat([prefix, tok_emb], dim=1), cfg.num_prefix_tokens
    return tok_emb, None


def init_kv_cache(cfg: ArchConfig, batch_size: int, cache_len, *,
                  quantized: bool = False, dtype=torch.bfloat16,
                  device=None) -> dict:
    """Zeroed KV cache, ``{"k": ..., "v": ...}``, each (layers, B, C, KH,
    hd) in ``dtype`` or a QuantKV (int8 values, f32 scales); C is
    ``cache_len``, or ``attn_window`` where that is shorter."""
    if cache_len is None:
        raise ValueError("the transformer's cache needs a cache_len")
    c_len = min(cache_len, cfg.attn_window) if cfg.attn_window else cache_len
    shape = (cfg.n_layers, batch_size, c_len, cfg.n_kv_heads, cfg.head_dim)

    def one():
        if quantized:
            return QuantKV(
                q=torch.zeros(shape, dtype=torch.int8, device=device),
                scale=torch.zeros(shape[:-1] + (1,), dtype=F32,
                                  device=device))
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"k": one(), "v": one()}


def lm_prefill(params: Transformer, batch: dict, cache: dict):
    """Prefill ``batch["tokens"]`` (B, T) (after ``batch["patches"]`` for
    the vlm) into ``cache``.  Returns the last position's logits (B, 1,
    V) f32 and the cache."""
    embeds, prefix_len = _prep_embeds(params, batch)
    hidden = decoder_hidden(params, embeds, mode="prefill", cache=cache,
                            prefix_len=prefix_len)
    return _head(params, hidden[:, -1:]), cache


def lm_decode_step(params: Transformer, cache: dict, batch: dict, step):
    """One decode step: ``batch["tokens"]`` (B, 1) at absolute position
    ``step`` (an int).  Returns (B, 1, V) f32 logits and the cache."""
    step = int(step)
    embeds = embed_tokens(params, batch["tokens"])
    hidden = decoder_hidden(params, embeds, mode="decode", cache=cache,
                            step=step,
                            prefix_len=params.cfg.num_prefix_tokens or None)
    return _head(params, hidden), cache
