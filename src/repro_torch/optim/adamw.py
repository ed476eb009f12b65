"""AdamW with optional int8 block-quantized moments: the JAX package's
``optim/adamw.py`` on dicts of tensors.

The optimizer is an (init, update) pair over an ``nn.Module``'s
parameters; its state is ``{"count": int32 scalar, "mu": {name: {"m",
"v"}}}`` keyed by parameter name.  ``update`` writes the new values into
the parameters IN PLACE (under ``torch.no_grad()``, the counterpart of
the reference's buffer donation) and returns (params, new state); the
moments, exact or int8, are updated in place too, so one copy of them is
alive.  The update runs in f32 and casts back to the parameter's dtype.
A large leaf is updated in slices of whole rows along its leading axes
(``SLICE_VALUES`` values a slice): the update is elementwise and the
int8 blocks lie along the last axis, so every value and every block is
what the whole-leaf update gives, bit for bit, while the f32 and f64
transients stay one slice's (XLA fuses the reference's whole-leaf
formula; eager torch would hold each of its ten or so f32 intermediates
for the whole leaf).

The int8 mode stores both moments as int8 blocks with one f32 scale a
block (the block the largest power-of-two divisor of the last axis up to
256), the payload in the parameter's own shape; rounding is to nearest,
ties to even (``torch.round`` and ``jnp.round`` agree), and the second
moment is stored as sqrt(v) to tame its range.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.optim.schedules import Schedule, constant

__all__ = ["AdamWConfig", "Optimizer", "adamw", "QuantMoment",
           "moment_block", "quantize_moment", "dequantize_moment",
           "SLICE_VALUES"]

_BLOCK = 256
F32 = torch.float32
# values a slice of one leaf's update: 2^25 keeps each f32 transient at
# 128 MiB (an H100 step's ~12 of them and the f64 root ~2 GB) and a
# dbrx-132b expert stack (1.06e9 values) at 32 slices
SLICE_VALUES = 1 << 25


class QuantMoment(NamedTuple):
    """Param-shaped int8 payload and per-block f32 scales (shape ``lead +
    (last / block,)``)."""

    q: torch.Tensor       # int8, param shape
    scale: torch.Tensor   # f32, lead + (nblk,)


def moment_block(last: int) -> int:
    """The largest power-of-two divisor of ``last``, at most 256."""
    b = 1
    while b < _BLOCK and last % (b * 2) == 0:
        b *= 2
    return b


def quantize_moment(x: torch.Tensor) -> QuantMoment:
    x = x.float()
    if x.dim() == 0:
        x = x.reshape(1)
    last = x.shape[-1]
    b = moment_block(last)
    lead = tuple(x.shape[:-1])
    xb = x.reshape(lead + (last // b, b))
    amax = xb.abs().amax(-1)
    # a tensor divisor: CUDA turns a division by a Python scalar into a
    # product with its reciprocal, one rounding off the reference's
    scale = amax / amax.new_tensor(127.0)
    safe = torch.where(scale > 0, scale, 1.0)
    q = torch.clamp(torch.round(xb / safe[..., None]), -127, 127).to(
        torch.int8)
    return QuantMoment(q=q.reshape(x.shape), scale=scale)


def dequantize_moment(qm: QuantMoment, shape: tuple[int, ...]
                      ) -> torch.Tensor:
    shape = tuple(shape)
    work = shape if shape else (1,)
    nblk = qm.scale.shape[-1]
    b = work[-1] // nblk
    xb = qm.q.reshape(work[:-1] + (nblk, b)).float()
    return (xb * qm.scale[..., None]).reshape(shape)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    quantized_state: bool = False   # int8 block-quantized moments


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """(init, update) pair.  ``update(params, grads, state, step=None)``
    updates ``params`` in place and returns (params, new state)."""

    init: Callable
    update: Callable
    config: AdamWConfig


def _named(params) -> list[tuple[str, torch.Tensor]]:
    if isinstance(params, nn.Module):
        return list(params.named_parameters())
    return list(params.items())


def _leaf_init(p: torch.Tensor, quantized: bool) -> dict:
    z = torch.zeros(p.shape, dtype=F32, device=p.device)
    if quantized:
        return {"m": quantize_moment(z), "v": quantize_moment(z)}
    return {"m": z, "v": torch.zeros_like(z)}


def _leaf_update(p, g, st, lr, cfg: AdamWConfig, t):
    """One parameter's step, the reference's sums in f32: writes ``p``
    and its moments in place, a slice of at most ``SLICE_VALUES`` values
    (whole rows of the last axis) at a time, and returns the moments."""
    last = p.shape[-1] if p.dim() else 1
    rows = p.numel() // last
    step = max(1, SLICE_VALUES // last)

    def by_rows(x):      # an int8 moment's scales: a column a block
        return x.view(rows, -1)

    pv, gv = by_rows(p), g.reshape(rows, last)
    mv = {k: (QuantMoment(by_rows(x.q), by_rows(x.scale))
              if isinstance(x, QuantMoment) else by_rows(x))
          for k, x in st.items()}
    for i in range(0, rows, step):
        sl = slice(i, i + step)
        _update_slice(pv[sl], gv[sl], {
            k: (QuantMoment(x.q[sl], x.scale[sl])
                if isinstance(x, QuantMoment) else x[sl])
            for k, x in mv.items()}, lr, cfg, t)
    return st


def _update_slice(p, g, st, lr, cfg: AdamWConfig, t) -> None:
    """The update of a slice of one leaf's rows, in place."""
    g = g.float()
    pf = p.float()
    if cfg.quantized_state:
        m = dequantize_moment(st["m"], p.shape)
        # v is stored as sqrt(v) for range; squared on load
        v = torch.square(dequantize_moment(st["v"], p.shape))
        m = cfg.b1 * m + (1.0 - cfg.b1) * g
        v = cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g)
    else:   # in place, the same roundings
        m = st["m"].mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        v = st["v"].mul_(cfg.b2).add_((1.0 - cfg.b2) * torch.square(g))
    del g
    mhat = m / (1.0 - cfg.b1 ** t)
    vhat = v / (1.0 - cfg.b2 ** t)
    upd = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * pf
    del mhat, vhat
    p.copy_((pf - lr * upd).to(p.dtype))
    if cfg.quantized_state:
        for k, x in (("m", m), ("v", _sqrt_rn(v))):
            qm = quantize_moment(x)
            st[k].q.copy_(qm.q.reshape(st[k].q.shape))
            st[k].scale.copy_(qm.scale.reshape(st[k].scale.shape))


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The f32 square root rounded to nearest on every device.  CUDA's f32
    ``torch.sqrt`` is not correctly rounded (it left 6,533 of 2^20 values
    one rounding off the CPU's on an H100); through f64 it is, since a
    square root rounded to 53 bits rounds to the same 24-bit value as the
    exact one.  The round trip makes an int8 leaf's eager step about 1.1x
    slower on an H100 (``tools/int8_adamw_sqrt_ab.py``); it is kept so
    the stored moments are the reference's on every device."""
    return torch.sqrt(x.double()).float()


def adamw(lr: Schedule | float = 1e-3,
          config: Optional[AdamWConfig] = None) -> Optimizer:
    cfg = config or AdamWConfig()
    lr_fn = lr if callable(lr) else constant(lr)

    def init(params) -> dict:
        named = _named(params)
        dev = named[0][1].device if named else "cpu"
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": {n: _leaf_init(p, cfg.quantized_state)
                       for n, p in named}}

    @torch.no_grad()
    def update(params, grads: dict, state: dict, step=None):
        t = state["count"] + 1
        lr_t = lr_fn(t if step is None else step)
        tf = t.float()
        new_mu = {}
        for name, p in _named(params):
            lr_p = lr_t.to(p.device)
            new_mu[name] = _leaf_update(p, grads[name], state["mu"][name],
                                        lr_p, cfg, tf.to(p.device))
        return params, {"count": t, "mu": new_mu}

    return Optimizer(init=init, update=update, config=cfg)
