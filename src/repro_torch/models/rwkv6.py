"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free token mixing with
data-dependent decay, for serving (prefill and decode).

Recurrence per head (state S in R^{K x V}, head size 64):

    o_t = r_t · (diag(u)·k_t v_t^T + S_{t-1})
    S_t = diag(w_t)·S_{t-1} + k_t v_t^T

with w_t = exp(-exp(decay_base + lora(x_t))) (data-dependent decay) and
DDLerp token-shift mixing for the r/k/v/w/g projections.

The prefill runs the WKV of every layer on one launch of the ``wkv``
kernel (``kernels/wkv.py``): f32 r/k/v/logw, T padded to a multiple of 8
with zeros.  Decode is the exact single-step recurrence in torch ops.
The projections and the head are plain matrix products in the model
dtype (bf16 on the card) with the reference's f32 islands: the WKV
inputs and the decay, the group norm, the head's f32 accumulation and
the carried state.

``wkv_scan_reference`` and ``wkv_chunked`` are the JAX package's two WKV
forms in plain torch: the oracles the tests hold the kernel path against.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import ArchConfig
from repro_torch.kernels.wkv import CT, wkv
from repro_torch.models.layers import layer_norm
from repro_torch.models.params import ParamModule, Spec

__all__ = [
    "ChannelMix",
    "RWKV6",
    "RWKVLayer",
    "TimeMix",
    "init_rwkv_state",
    "rwkv_decode_step",
    "rwkv_prefill",
    "rwkv_specs",
    "wkv_chunked",
    "wkv_scan_reference",
]

_CHUNK = 16
F32 = torch.float32


# --------------------------------------------------------------------------
# specs
# --------------------------------------------------------------------------
def _norm_specs(d: int) -> dict:
    return {"w": Spec((d,), init="ones", dtype=F32),
            "b": Spec((d,), init="zeros", dtype=F32)}


def _layer_specs(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    h, hs = cfg.n_heads, cfg.rwkv.head_size
    lw, lm = cfg.rwkv.decay_lora, cfg.rwkv.mix_lora
    tm = {
        # DDLerp token-shift: base mixes + data-dependent delta LoRA
        "maa_base": Spec((5, d), init="zeros", dtype=F32),
        "maa_x": Spec((d,), init="zeros", dtype=F32),
        "maa_w1": Spec((d, 5 * lm)),
        "maa_w2": Spec((5, lm, d)),
        "wr": Spec((d, h, hs), fan_in=d),
        "wk": Spec((d, h, hs), fan_in=d),
        "wv": Spec((d, h, hs), fan_in=d),
        "wg": Spec((d, h, hs), fan_in=d),
        "wo": Spec((h, hs, d), fan_in=d),
        # data-dependent decay
        "decay_base": Spec((h, hs), init="zeros", dtype=F32),
        "decay_w1": Spec((d, lw)),
        "decay_w2": Spec((lw, h, hs)),
        # bonus
        "u": Spec((h, hs), init="zeros", dtype=F32),
        # per-head group norm
        "gn_w": Spec((d,), init="ones", dtype=F32),
        "gn_b": Spec((d,), init="zeros", dtype=F32),
    }
    cm = {
        "mix_k": Spec((d,), init="zeros", dtype=F32),
        "mix_r": Spec((d,), init="zeros", dtype=F32),
        "wk": Spec((d, f), fan_in=d),
        "wv": Spec((f, d), fan_in=f),
        "wr": Spec((d, d), fan_in=d),
    }
    return {"ln1": _norm_specs(d), "ln2": _norm_specs(d), "time_mix": tm,
            "channel_mix": cm}


def rwkv_specs(cfg: ArchConfig) -> dict:
    """The model's Spec tree; ``layers`` is a list, one entry a layer."""
    d = cfg.d_model
    return {
        "embed": Spec((cfg.vocab_size, d), init="embed"),
        "unembed": Spec((d, cfg.vocab_size), fan_in=d),
        "ln_in": _norm_specs(d),
        "final_norm": _norm_specs(d),
        "layers": [_layer_specs(cfg) for _ in range(cfg.n_layers)],
    }


# --------------------------------------------------------------------------
# WKV core
# --------------------------------------------------------------------------
def wkv_scan_reference(r, k, v, logw, u, state):
    """Exact per-token recurrence (oracle for tests).

    r/k/v/logw: (B, T, H, K) f32 (logw = log decay, <= 0); u: (H, K);
    state: (B, H, K, V=K).
    """
    s = state
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, lwt = r[:, t], k[:, t], v[:, t], logw[:, t]
        bonus = torch.einsum("bhk,bhv->bhkv", kt * u[None], vt)
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, s + bonus))
        s = s * torch.exp(lwt)[..., None] + torch.einsum("bhk,bhv->bhkv",
                                                         kt, vt)
    return torch.stack(outs, dim=1), s


def wkv_chunked(r, k, v, logw, u, state, chunk: int = _CHUNK,
                stream_dtype=torch.bfloat16):
    """The JAX package's chunked parallel form (``models/rwkv6.py``) in
    plain torch: r/k/v stream in ``stream_dtype`` (bf16 by default, its
    TPU traffic choice; f32 makes it exact up to rounding), the decay and
    the state stay f32, the intra-chunk factorisation is re-centred at
    the mid-chunk cumsum and the scores masked by selection."""
    b, t, h, kdim = r.shape
    pad = (-t) % chunk
    if pad:
        r, k, v, logw = (F.pad(x, (0, 0, 0, 0, 0, pad))
                         for x in (r, k, v, logw))
    n = (t + pad) // chunk
    rs, ks, vs = (x.to(stream_dtype) for x in (r, k, v))
    idx = torch.arange(chunk, device=r.device)
    mask = idx[:, None] > idx[None, :]
    s = state
    outs = []
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        rc, kc, vc, lwc = rs[:, sl], ks[:, sl], vs[:, sl], logw[:, sl]
        p = torch.cumsum(lwc, dim=1)                 # (B, C, H, K)
        pm1 = torch.cat([torch.zeros_like(p[:, :1]), p[:, :-1]], dim=1)
        r0 = (rc.float() * torch.exp(pm1)).to(stream_dtype)
        o_inter = torch.einsum("bthk,bhkv->bthv", r0, s.to(stream_dtype))
        c = p[:, chunk // 2][:, None]                # (B, 1, H, K)
        r_dec = (rc.float() * torch.exp(pm1 - c)).to(stream_dtype)
        k_grow = (kc.float() * torch.exp(c - p)).to(stream_dtype)
        scores = torch.einsum("bthk,bshk->bhts", r_dec, k_grow)
        scores = torch.where(mask, scores, 0).to(stream_dtype)
        o_intra = torch.einsum("bhts,bshv->bthv", scores, vc)
        coef = torch.einsum("bthk,bthk,hk->bth", rc.float(), kc.float(), u)
        o_diag = coef[..., None] * vc.float()
        pe = p[:, -1]                                # (B, H, K)
        kdec = (kc.float() * torch.exp(pe[:, None] - p)).to(stream_dtype)
        s = s * torch.exp(pe)[..., None] + torch.einsum(
            "bshk,bshv->bhkv", kdec, vc).float()
        outs.append((o_inter.float() + o_intra.float() + o_diag)
                    .to(stream_dtype))
    o = torch.cat(outs, dim=1).float()
    return o[:, :t], s


def _wkv_prefill(r, k, v, logw, u, state):
    """The prefill's WKV on the kernel: (B, T, H, K) -> planar (B*H, T', K)
    rows (b-major, u tiled to match), T padded to T' = a multiple of
    ``CT`` with zeros (logw too: a padded step leaves the state as it
    is), the padded outputs sliced off."""
    b, t, h, kd = r.shape
    pad = (-t) % CT

    def rows(x):
        x = x.transpose(1, 2)                        # (B, H, T, K)
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
        return x.reshape(b * h, t + pad, kd).contiguous()

    o, s = wkv(rows(r), rows(k), rows(v), rows(logw),
               u.repeat(b, 1).contiguous(),
               state.reshape(b * h, kd, kd).contiguous())
    o = o.reshape(b, h, t + pad, kd)[:, :, :t].transpose(1, 2)
    return o, s.reshape(b, h, kd, kd)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
def _token_shift(x, last):
    """x_{t-1} with ``last`` filling position 0.  x: (B, T, D); last: (B, D)."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


class TimeMix(ParamModule):
    """DDLerp token shift, the r/k/v/g projections, the data-dependent
    decay, the WKV and the per-head group norm."""

    def __init__(self, cfg: ArchConfig, specs: dict, dtype, device):
        super().__init__(specs, dtype, device)
        self.cfg = cfg

    def forward(self, x, last_x, state, mode: str):
        """x (B, T, D) in the model dtype, last_x (B, D) and state
        (B, H, K, K) f32.  Returns (out, x[:, -1] in f32, new state)."""
        b, t, d = x.shape
        h, hs = self.cfg.n_heads, self.cfg.rwkv.head_size
        dt = x.dtype
        # the mixing chain stays in the model dtype; only the WKV inputs
        # and the decay are promoted to f32 (the state dynamics)
        prev = _token_shift(x, last_x.to(dt))
        xx = prev - x
        xxx = x + xx * self.maa_x.to(dt)
        lora = torch.einsum("btd,dm->btm", xxx, self.maa_w1)
        lora = torch.tanh(lora.reshape(b, t, 5, -1).float()).to(dt)
        delta = torch.einsum("btfm,fmd->btfd", lora, self.maa_w2)
        mixes = self.maa_base[None, None].to(dt) + delta    # (B, T, 5, D)
        xw, xk, xv, xr, xg = (x + xx * mixes[:, :, i] for i in range(5))

        r = torch.einsum("btd,dhk->bthk", xr, self.wr).float()
        k = torch.einsum("btd,dhk->bthk", xk, self.wk).float()
        v = torch.einsum("btd,dhk->bthk", xv, self.wv).float()
        g = torch.einsum("btd,dhk->bthk", xg, self.wg)

        dlora = torch.tanh(torch.einsum("btd,dl->btl", xw, self.decay_w1))
        dd = torch.einsum("btl,lhk->bthk", dlora, self.decay_w2).float()
        # log decay clamped to [-8, ~0): the same in prefill and decode,
        # and what bounds the kernel's factor exponents
        logw = -torch.exp(torch.clamp(self.decay_base[None, None] + dd,
                                      -10.0, 4.0))
        logw = torch.clamp(logw, min=-8.0)

        u = self.u
        if mode == "decode":
            rt, kt, vt, lwt = r[:, 0], k[:, 0], v[:, 0], logw[:, 0]
            bonus = torch.einsum("bhk,bhv->bhkv", kt * u[None], vt)
            o = torch.einsum("bhk,bhkv->bhv", rt, state + bonus)[:, None]
            new_state = state * torch.exp(lwt)[..., None] + torch.einsum(
                "bhk,bhv->bhkv", kt, vt)
        elif mode == "prefill":
            o, new_state = _wkv_prefill(r, k, v, logw, u, state)
        else:
            raise ValueError(f"unknown mode {mode!r} (prefill | decode)")

        # per-head group norm == layer norm over each head's slice
        mu = o.mean(-1, keepdim=True)
        var = o.var(-1, keepdim=True, unbiased=False)
        o = (o - mu) * torch.rsqrt(var + 64e-5)
        o = o.reshape(b, t, d) * self.gn_w + self.gn_b
        o = o.to(dt) * F.silu(g).reshape(b, t, d)
        out = torch.einsum("bthk,hkd->btd", o.reshape(b, t, h, hs), self.wo)
        return out, x[:, -1].float(), new_state


class ChannelMix(ParamModule):
    """Token-shift mixing and the squared-ReLU MLP with a receptance gate."""

    def forward(self, x, last_x):
        dt = x.dtype
        prev = _token_shift(x, last_x.to(dt))
        xx = prev - x
        xk = x + xx * self.mix_k.to(dt)
        xr = x + xx * self.mix_r.to(dt)
        k = torch.square(torch.relu(xk @ self.wk))
        out = torch.sigmoid(xr @ self.wr) * (k @ self.wv)
        return out, x[:, -1].float()


class RWKVLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, specs: dict, dtype, device):
        super().__init__()
        self.ln1 = ParamModule(specs["ln1"], dtype, device)
        self.ln2 = ParamModule(specs["ln2"], dtype, device)
        self.time_mix = TimeMix(cfg, specs["time_mix"], dtype, device)
        self.channel_mix = ChannelMix(specs["channel_mix"], dtype, device)

    def forward(self, x, st: dict, mode: str):
        """One layer on (B, T, D); ``st`` holds this layer's ``tm_last``,
        ``cm_last`` and ``wkv``.  Returns (x, the layer's new state)."""
        h, tm_last, wkv_state = self.time_mix(
            layer_norm(x, self.ln1.w, self.ln1.b), st["tm_last"], st["wkv"],
            mode)
        x = x + h
        h2, cm_last = self.channel_mix(
            layer_norm(x, self.ln2.w, self.ln2.b), st["cm_last"])
        x = x + h2
        return x, {"tm_last": tm_last, "cm_last": cm_last, "wkv": wkv_state}


class RWKV6(ParamModule):
    """The whole model's parameters: ``embed``, ``unembed``, ``ln_in``,
    ``final_norm`` and ``layers`` (state-dict names as the JAX package's
    tree paths, one entry a layer)."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        specs = rwkv_specs(cfg)
        super().__init__({"embed": specs["embed"],
                          "unembed": specs["unembed"]}, dtype, device)
        self.cfg = cfg
        self.ln_in = ParamModule(specs["ln_in"], dtype, device)
        self.final_norm = ParamModule(specs["final_norm"], dtype, device)
        self.layers = nn.ModuleList(
            RWKVLayer(cfg, ls, dtype, device) for ls in specs["layers"])


# --------------------------------------------------------------------------
# model application
# --------------------------------------------------------------------------
def init_rwkv_state(cfg: ArchConfig, batch: int, device=None) -> dict:
    h, hs, d = cfg.n_heads, cfg.rwkv.head_size, cfg.d_model
    ell = cfg.n_layers
    return {
        "tm_last": torch.zeros((ell, batch, d), dtype=F32, device=device),
        "cm_last": torch.zeros((ell, batch, d), dtype=F32, device=device),
        "wkv": torch.zeros((ell, batch, h, hs, hs), dtype=F32, device=device),
    }


def _stack_forward(params: RWKV6, x, state: dict, mode: str):
    new = {key: [] for key in state}
    for i, layer in enumerate(params.layers):
        x, st = layer(x, {key: val[i] for key, val in state.items()}, mode)
        for key in new:
            new[key].append(st[key])
    return x, {key: torch.stack(vals) for key, vals in new.items()}


def _embed(params: RWKV6, tokens):
    e = params.embed[tokens.long()]
    return layer_norm(e, params.ln_in.w, params.ln_in.b)


def _head(params: RWKV6, x):
    """Final norm, then bf16 inputs against the bf16 unembedding with f32
    accumulation and f32 logits."""
    x = layer_norm(x, params.final_norm.w, params.final_norm.b)
    xb = x.to(torch.bfloat16).reshape(-1, x.shape[-1])
    wb = params.unembed.to(torch.bfloat16)
    if xb.is_cuda:
        logits = torch.mm(xb, wb, out_dtype=F32)
    else:
        # a product of two bf16 values is exact in f32: the same sums
        logits = xb.float() @ wb.float()
    return logits.reshape(*x.shape[:-1], -1)


def rwkv_prefill(params: RWKV6, batch: dict, state: dict):
    """Prefill ``batch["tokens"]`` (B, T) from ``state``.  Returns the last
    position's logits (B, 1, V) f32 and the new state."""
    x = _embed(params, batch["tokens"])
    x, new_state = _stack_forward(params, x, state, "prefill")
    return _head(params, x[:, -1:]), new_state


def rwkv_decode_step(params: RWKV6, state: dict, batch: dict):
    """One token (B, 1) through the exact recurrence (position-free).
    Returns (B, 1, V) logits and the new state."""
    x = _embed(params, batch["tokens"])
    x, new_state = _stack_forward(params, x, state, "decode")
    return _head(params, x), new_state
