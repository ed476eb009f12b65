"""Mixture-of-Experts FFN with group-local sort-based capacity dispatch.

The JAX package's ``models/moe.py`` on tensors: flatten the token ->
expert assignments, sort them by expert (a stable sort, so that within
an expert the earlier assignments come first), find each assignment's
position within its expert from a searchsorted offset, write the kept
ones into a (G, E, C, D) capacity buffer (an expert's assignments past
its capacity C are dropped), run the expert FFNs as batched products
over E and combine back with an ``index_add_`` over tokens.  Tokens are
viewed as (G, T/G, D) with G the data-parallel degree of the active
mesh's ``tokens`` rule (1 without a mesh), so dispatch stays within a
group.

Router styles: ``"softmax"`` (DBRX: softmax over all experts, the top-k
renormalised) and ``"sigmoid"`` (Llama-4: a sigmoid gate on the top-1
logit).  The router runs in f32 (an FP32 product: TF32 is off, torch's
default for matrix products); the expert products in the weights' dtype.

**Kept-only dispatch.** The reference scatters every assignment,
dropped ones as a zero row at slot 0 of their expert (``mode="drop"``
drops only out-of-bounds indices), so where an expert overflows its
slot 0 is written twice and, on XLA's CPU backend, ends as zeros: the
token in that slot loses the expert's term.  The port writes only kept
assignments (dropped ones go to a scratch slot past the buffer), which
is what the reference's docstring describes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs import MoESettings
from repro_torch.distributed.sharding import current_mesh, current_rules
from repro_torch.models.params import Spec

__all__ = ["Dispatch", "moe_capacity", "moe_ffn", "moe_layer_specs",
           "route_tokens"]

F32 = torch.float32


def moe_capacity(n_tokens: int, moe: MoESettings) -> int:
    """Slots an expert has in a dispatch group of ``n_tokens`` tokens."""
    cap = int(math.ceil(n_tokens * moe.top_k * moe.capacity_factor
                        / moe.num_experts))
    return max(8, min(cap, n_tokens))


def _dp_groups(n_tokens: int) -> int:
    """Dispatch-group count = data-parallel degree of the token axis on
    the active mesh (1 without one, or where it does not divide
    ``n_tokens``)."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None:
        return 1
    entry = rules.get("tokens")
    if entry is None:
        return 1
    names = entry if isinstance(entry, (tuple, list)) else (entry,)
    dims = tuple(mesh.mesh_dim_names or ())
    g = 1
    for a in names:
        g *= mesh.size(dims.index(a))
    return g if (g > 1 and n_tokens % g == 0) else 1


def moe_layer_specs(d_model: int, moe: MoESettings) -> dict:
    """The router (f32) and the expert weights, expert axis leading;
    the always-on shared expert where ``num_shared_experts`` is set."""
    e, f = moe.num_experts, moe.d_ff_expert
    sp = {
        "router": Spec((d_model, e), dtype=F32),
        "wi": Spec((e, d_model, f)),
        "wg": Spec((e, d_model, f)),
        "wo": Spec((e, f, d_model)),
    }
    if moe.num_shared_experts:
        fs = f * moe.num_shared_experts
        sp["shared_wi"] = Spec((d_model, fs))
        sp["shared_wg"] = Spec((d_model, fs))
        sp["shared_wo"] = Spec((fs, d_model))
    return sp


class Dispatch(NamedTuple):
    """One call's routing, each (G, T/G * k) but ``probs`` (G, T/G, E)
    and ``top_idx``/``gates`` (G, T/G, k): assignments in expert order
    (``order`` into the token-major flattening), their expert ``se``,
    slot ``pos`` within it, ``keep = pos < capacity`` and ``token``."""

    probs: torch.Tensor
    top_idx: torch.Tensor
    gates: torch.Tensor
    order: torch.Tensor
    se: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    token: torch.Tensor


def route_tokens(xf: torch.Tensor, router: torch.Tensor, moe: MoESettings,
                 cap: int, router_style: str = "softmax") -> Dispatch:
    """Route (G, T/G, D) tokens with the f32 ``router`` (D, E)."""
    g, tl, _ = xf.shape
    e, k = moe.num_experts, moe.top_k
    logits = torch.einsum("gtd,de->gte", xf.float(), router)
    # jax.lax.top_k breaks ties by the lower index; torch.topk promises
    # no order for ties (random f32 logits make them rare)
    if router_style == "sigmoid":
        top_vals, top_idx = torch.topk(logits, k, dim=-1)
        gates = torch.sigmoid(top_vals)
        probs = torch.softmax(logits, dim=-1)
    elif router_style == "softmax":
        probs = torch.softmax(logits, dim=-1)
        top_vals, top_idx = torch.topk(probs, k, dim=-1)
        gates = top_vals / top_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    else:
        raise ValueError(f"unknown router style {router_style!r}")

    flat_e = top_idx.reshape(g, tl * k)
    # stable: capacity keeps an expert's earliest assignments
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, -1, order)
    experts = torch.arange(e, device=xf.device).expand(g, e).contiguous()
    starts = torch.searchsorted(se, experts)
    pos = (torch.arange(tl * k, device=xf.device)[None]
           - torch.gather(starts, -1, se))
    return Dispatch(probs, top_idx, gates, order, se, pos, pos < cap,
                    torch.div(order, k, rounding_mode="floor"))


def moe_ffn(x: torch.Tensor, p, moe: MoESettings, *,
            router_style: str = "softmax"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, D) ``x`` through the MoE layer of parameters ``p``
    (``moe_layer_specs``'s attributes).  Returns (output (B, S, D), the
    f32 Switch load-balance aux loss over the first choices)."""
    b, s, d = x.shape
    t = b * s
    e, k = moe.num_experts, moe.top_k
    g = _dp_groups(t)
    tl = t // g
    cap = moe_capacity(tl, moe)
    xf = x.reshape(g, tl, d)
    r = route_tokens(xf, p.router, moe, cap, router_style)

    # ---- load-balance aux loss (Switch-style, over all tokens) ----------
    frac_tokens = F.one_hot(r.top_idx[..., 0], e).to(F32).mean(dim=(0, 1))
    frac_prob = r.probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens * frac_prob)

    # ---- dispatch: kept assignments into (G, E*C + 1, D), the last row
    # a scratch slot that takes every dropped one ---------------------------
    slot = torch.where(r.keep, r.se * cap + r.pos,
                       torch.full_like(r.pos, e * cap))
    gathered = torch.gather(xf, 1, r.token[..., None].expand(-1, -1, d))
    buf = x.new_zeros((g, e * cap + 1, d))
    buf.scatter_(1, slot[..., None].expand(-1, -1, d), gathered)
    buf = buf[:, :e * cap].reshape(g, e, cap, d)

    # ---- expert FFN: batched products over E in the weights' dtype ------
    h = torch.einsum("gecd,edf->gecf", buf, p.wi)
    hg = torch.einsum("gecd,edf->gecf", buf, p.wg)
    y = torch.einsum("gecf,efd->gecd", F.silu(hg) * h, p.wo)

    # ---- combine: gather at (se, pos), gate, add over tokens ------------
    pos_c = torch.where(r.keep, r.pos, torch.zeros_like(r.pos))
    vals = torch.gather(y.reshape(g, e * cap, d), 1,
                        (r.se * cap + pos_c)[..., None].expand(-1, -1, d))
    flat_g = r.gates.reshape(g, tl * k).to(x.dtype)
    w = torch.gather(flat_g, -1, r.order) * r.keep.to(x.dtype)
    vals = vals * w[..., None]
    rows = (r.token + torch.arange(g, device=x.device)[:, None] * tl)
    out = x.new_zeros((g * tl, d)).index_add_(0, rows.reshape(-1),
                                              vals.reshape(-1, d))
    out = out.reshape(g, tl, d)

    # ---- shared expert (dense, always on) -------------------------------
    if "shared_wi" in p.specs:
        hs = xf @ p.shared_wi
        gs = xf @ p.shared_wg
        out = out + (F.silu(gs) * hs) @ p.shared_wo

    return out.reshape(b, s, d), aux
