"""Griffin / RecurrentGemma hybrid (arXiv:2402.19427) for serving:
family ``hybrid``.

Temporal-mixing layers follow the config's ``block_pattern`` (rec, rec,
attn), repeated, then a tail of the pattern's first kinds (38 layers of
recurrentgemma-9b = 12 x (rec, rec, attn) + 2 rec):

* recurrent block: GeLU(x W_gate) * RG-LRU(conv1d(x W_in)) -> W_out
  - RG-LRU: a_t = exp(-c softplus(lam) r_t), r_t = sigmoid(x W_a + b_a),
    i_t = sigmoid(x W_x + b_x), h_t = a_t h_{t-1} + sqrt(1 - a_t^2)
    (i_t x_t); in prefill a Hillis-Steele doubling scan over time
    (log2(T) elementwise passes), in decode one step;
  - causal depthwise conv1d (width 4) with a history of W-1 steps;
* local-attention block: the transformer's ``attn_apply`` (sliding
  window of ``attn_window``; a ring cache when the cache is that long);
* every temporal block is followed by a GeGLU MLP block.

The JAX package's ``models/rglru.py`` as an ``nn.Module`` tree of
:class:`ParamModule`s, layers as ``layers.<i>`` in layer order (the
reference scans one stacked tree a pattern slot, then the tail;
``convert.griffin_params_from_reference`` splits it).  The decode state
is a list, one dict a layer: ``{"k", "v"}`` (B, C, KH, hd) in the
model's dtype for attention layers, ``{"conv"}`` (B, W-1, d_rnn) and
``{"h"}`` (B, d_rnn) in f32 for recurrent ones; prefill and decode write
it IN PLACE and return it.  The conv, the RG-LRU (its ``wa``/``wx``
products FP32, TF32 off as torch's default) and the norms run in f32
and cast back; the head is the transformer's bf16 product against the
embedding (always tied), with f32 logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.layers import mlp_apply, rms_norm, rotary_cos_sin
from repro_torch.models.params import ParamModule, Spec

__all__ = [
    "Griffin",
    "TemporalLayer",
    "doubling_scan",
    "griffin_decode_step",
    "griffin_prefill",
    "griffin_specs",
    "init_griffin_state",
    "layer_kinds",
    "rglru_apply",
]

F32 = torch.float32
_C = 8.0  # Griffin's fixed recurrence sharpness


# --------------------------------------------------------------------------
# specs
# --------------------------------------------------------------------------
def _rec_block_specs(cfg: ArchConfig) -> dict:
    d, dr = cfg.d_model, cfg.recurrent.d_rnn
    w = cfg.recurrent.conv_width
    return {
        "w_gate": Spec((d, dr), fan_in=d),
        "w_in": Spec((d, dr), fan_in=d),
        "w_out": Spec((dr, d), fan_in=dr),
        "conv_w": Spec((w, dr), dtype=F32),
        "conv_b": Spec((dr,), init="zeros", dtype=F32),
        "wa": Spec((dr, dr), fan_in=dr),
        "ba": Spec((dr,), init="zeros", dtype=F32),
        "wx": Spec((dr, dr), fan_in=dr),
        "bx": Spec((dr,), init="zeros", dtype=F32),
        "lam": Spec((dr,), init="ones", dtype=F32),
    }


def _norm(cfg: ArchConfig) -> dict:
    # zero-centred RMSNorm: the weight is stored as w - 1
    return {"w": Spec((cfg.d_model,), init="zeros", dtype=F32)}


def _temporal_layer_specs(cfg: ArchConfig, kind: str) -> dict:
    body = ({"attn": transformer._attn_specs(cfg)} if kind == "attn"
            else {"rec": _rec_block_specs(cfg)})
    return {"ln1": _norm(cfg), **body, "ln2": _norm(cfg),
            "mlp": transformer._mlp_specs(cfg)}


def layer_kinds(cfg: ArchConfig) -> tuple[str, ...]:
    """Each layer's kind, in layer order: the pattern's whole repeats,
    then a tail of its first kinds."""
    pat = cfg.recurrent.block_pattern
    repeats = cfg.n_layers // len(pat)
    return pat * repeats + pat[:cfg.n_layers - repeats * len(pat)]


def griffin_specs(cfg: ArchConfig) -> dict:
    """The model's Spec tree; ``layers`` is a list, one entry a layer."""
    if cfg.recurrent is None:
        raise ValueError(f"{cfg.name}: the hybrid needs recurrent settings")
    return {
        "embed": Spec((cfg.vocab_size, cfg.d_model), init="embed"),
        "final_norm": _norm(cfg),
        "layers": [_temporal_layer_specs(cfg, kind)
                   for kind in layer_kinds(cfg)],
    }


# --------------------------------------------------------------------------
# RG-LRU + conv
# --------------------------------------------------------------------------
def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 cache, mode: str):
    """Depthwise causal conv1d in f32, cast back.  x: (B, T, C); w: (W,
    C); cache: (B, W-1, C) f32.  Returns (y, the new cache: the last W-1
    (zero-padded) inputs after a prefill, None without a cache)."""
    width = w.shape[0]
    xf = x.float()
    if mode == "decode":
        hist = torch.cat([cache, xf], dim=1)                 # (B, W, C)
        y = torch.einsum("bwc,wc->bc", hist, w)[:, None] + b
        return y.to(x.dtype), hist[:, 1:]
    t = x.shape[1]
    prev = F.pad(xf, (0, 0, width - 1, 0))
    y = prev[:, 0:t] * w[0]
    for i in range(1, width):            # the reference's sum order
        y = y + prev[:, i:i + t] * w[i]
    y = y + b
    new_cache = prev[:, prev.shape[1] - (width - 1):] if cache is not None \
        else None
    return y.to(x.dtype), new_cache


def doubling_scan(a: torch.Tensor, b: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of h_t = a_t h_{t-1} + b_t over axis 1 (from h = 0)
    as a Hillis-Steele doubling: log2(T) passes of ``b <- b + a *
    shift(b)``, ``a <- a * shift(a)``, ``shift`` by 1, 2, 4, ... steps
    with ``a`` padded by 1 and ``b`` by 0.  Returns (the products of a,
    the h sequence); h with a carry-in h0 is ``a_seq * h0 + b_seq``."""
    t, d = a.shape[1], 1
    while d < t:
        pad = (0, 0, d, 0)
        b = b + a * F.pad(b[:, :t - d], pad)
        a = a * F.pad(a[:, :t - d], pad, value=1.0)
        d *= 2
    return a, b


def rglru_apply(p, x: torch.Tensor, h0, mode: str):
    """RG-LRU over (B, T, C) ``x`` with carry-in state ``h0`` (B, C) f32
    (or None).  Returns (h sequence in ``x``'s dtype, the last h f32)."""
    xf = x.float()
    r = torch.sigmoid(xf @ p.wa.float() + p.ba)
    i = torch.sigmoid(xf @ p.wx.float() + p.bx)
    log_a = -_C * F.softplus(p.lam) * r                  # (B, T, C) <= 0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                       1e-12)) * (i * xf)
    if mode == "decode":
        h = a[:, 0] * h0 + gated[:, 0]
        return h[:, None].to(x.dtype), h
    a_seq, b_seq = doubling_scan(a, gated)
    h_seq = b_seq if h0 is None else a_seq * h0[:, None] + b_seq
    return h_seq.to(x.dtype), h_seq[:, -1]


def _rec_block(p, x, st, mode):
    gate = F.gelu(x @ p.w_gate, approximate="tanh")
    u = x @ p.w_in
    u, conv_cache = _causal_conv(u, p.conv_w, p.conv_b,
                                 None if st is None else st["conv"], mode)
    u, h_last = rglru_apply(p, u, None if st is None else st["h"], mode)
    if st is not None:
        st["conv"].copy_(conv_cache)
        st["h"].copy_(h_last)
    return (gate * u) @ p.w_out


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------
class TemporalLayer(nn.Module):
    """Pre-norm temporal block (``rec`` or ``attn``), then the MLP."""

    def __init__(self, cfg: ArchConfig, kind: str, specs: dict, dtype,
                 device):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        self.ln1 = ParamModule(specs["ln1"], dtype, device)
        setattr(self, kind, ParamModule(specs[kind], dtype, device))
        self.ln2 = ParamModule(specs["ln2"], dtype, device)
        self.mlp = ParamModule(specs["mlp"], dtype, device)

    def forward(self, x, cos, sin, *, mode, state=None, step=None):
        cfg = self.cfg
        xn = rms_norm(x, self.ln1.w)
        if self.kind == "attn":
            h = transformer.attn_apply(self.attn, cfg, xn, cos, sin,
                                       mode=mode, cache=state, step=step)
        else:
            h = _rec_block(self.rec, xn, state, mode)
        x = x + h
        return x + mlp_apply(rms_norm(x, self.ln2.w), self.mlp,
                             cfg.mlp_variant)


class Griffin(ParamModule):
    """The whole model's parameters: ``embed`` (the head's too),
    ``final_norm`` and ``layers`` (state-dict names as the JAX package's
    tree paths, one entry a layer)."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        specs = griffin_specs(cfg)
        super().__init__({"embed": specs["embed"]}, dtype, device)
        self.cfg = cfg
        self.final_norm = ParamModule(specs["final_norm"], dtype, device)
        self.layers = nn.ModuleList(
            TemporalLayer(cfg, kind, ls, dtype, device)
            for kind, ls in zip(layer_kinds(cfg), specs["layers"]))
        self.emb_multiplier = transformer._rounded(cfg.emb_multiplier, dtype)


def init_griffin_state(cfg: ArchConfig, batch: int, cache_len,
                       dtype=torch.bfloat16, device=None) -> list:
    """Zeroed decode state, one dict a layer: attention K/V of
    ``min(cache_len, attn_window)`` slots in ``dtype``; the conv history
    (B, W-1, d_rnn) and ``h`` (B, d_rnn) in f32."""
    if cache_len is None:
        raise ValueError("the hybrid's attention cache needs a cache_len")
    c_len = min(cache_len, cfg.attn_window or cache_len)
    dr, cw = cfg.recurrent.d_rnn, cfg.recurrent.conv_width
    kv = (batch, c_len, cfg.n_kv_heads, cfg.head_dim)

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return [{"k": zeros(kv, dtype), "v": zeros(kv, dtype)} if kind == "attn"
            else {"conv": zeros((batch, cw - 1, dr), F32),
                  "h": zeros((batch, dr), F32)}
            for kind in layer_kinds(cfg)]


def _stack(params: Griffin, x, state, mode, step):
    cfg = params.cfg
    dev = x.device
    positions = (torch.arange(step, step + 1, device=dev) if mode == "decode"
                 else torch.arange(x.shape[1], device=dev))
    cos, sin = rotary_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    for i, layer in enumerate(params.layers):
        x = layer(x, cos, sin, mode=mode,
                  state=None if state is None else state[i], step=step)
    return x


def griffin_prefill(params: Griffin, batch: dict, state: list):
    """Prefill ``batch["tokens"]`` (B, T) into ``state``.  Returns the last
    position's logits (B, 1, V) f32 and the state."""
    x = transformer.embed_tokens(params, batch["tokens"])
    x = _stack(params, x, state, "prefill", None)
    x = rms_norm(x[:, -1:], params.final_norm.w)
    return transformer.bf16_logits(x, params.embed.T), state


def griffin_decode_step(params: Griffin, state: list, batch: dict, step):
    """One decode step: ``batch["tokens"]`` (B, 1) at absolute position
    ``step`` (an int).  Returns (B, 1, V) f32 logits and the state."""
    step = int(step)
    x = transformer.embed_tokens(params, batch["tokens"])
    x = _stack(params, x, state, "decode", step)
    x = rms_norm(x, params.final_norm.w)
    return transformer.bf16_logits(x, params.embed.T), state
