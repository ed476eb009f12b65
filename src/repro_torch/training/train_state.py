"""Training state: the step, the model's parameters (an ``nn.Module``)
and the optimizer state, with a flat name -> tensor view for the
checkpoint store and a ``device="meta"`` mirror that allocates nothing.

The flat view's names: ``step``, ``params.<parameter name>``,
``opt_state.count`` and ``opt_state.mu.<parameter name>.<m|v>`` (int8
moments as ``....<m|v>.q`` and ``.scale``).  :func:`train_state_pspecs`
gives the state's PartitionSpecs under the same names.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.models.params import Spec, named_specs, param_pspecs
from repro_torch.optim.adamw import Optimizer, QuantMoment, moment_block

__all__ = ["TrainState", "init_train_state", "abstract_train_state",
           "train_state_pspecs"]


@dataclasses.dataclass
class TrainState:
    step: int
    params: nn.Module
    opt_state: dict

    def tree(self) -> dict:
        """Every tensor of the state, flat, by name (the tensors
        themselves, detached: copy before they change)."""
        dev = self.opt_state["count"].device
        out = {"step": torch.tensor(self.step, dtype=torch.int32,
                                    device=dev)}
        for name, p in self.params.named_parameters():
            out[f"params.{name}"] = p.detach()
        out["opt_state.count"] = self.opt_state["count"]
        for name, st in self.opt_state["mu"].items():
            for mv in ("m", "v"):
                x = st[mv]
                if isinstance(x, QuantMoment):
                    out[f"opt_state.mu.{name}.{mv}.q"] = x.q
                    out[f"opt_state.mu.{name}.{mv}.scale"] = x.scale
                else:
                    out[f"opt_state.mu.{name}.{mv}"] = x
        return out

    @classmethod
    def from_tree(cls, tree: dict, params: nn.Module) -> "TrainState":
        """The state of a flat ``tree`` (``tree()``'s names), its
        parameter values copied into ``params`` in place."""
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.copy_(tree[f"params.{name}"])
        mu = {}
        for name, _ in params.named_parameters():
            st = {}
            for mv in ("m", "v"):
                key = f"opt_state.mu.{name}.{mv}"
                st[mv] = (QuantMoment(tree[key + ".q"], tree[key + ".scale"])
                          if key + ".q" in tree else tree[key])
            mu[name] = st
        return cls(step=int(tree["step"]), params=params,
                   opt_state={"count": tree["opt_state.count"], "mu": mu})


def init_train_state(model, optimizer: Optimizer,
                     generator: torch.Generator) -> TrainState:
    """Fresh parameters drawn from ``generator`` (on ``model.device``),
    made trainable, and the optimizer's zero state."""
    params = model.init(generator)
    params.requires_grad_(True)
    return TrainState(step=0, params=params,
                      opt_state=optimizer.init(params))


def _moment_abstract(p: torch.Tensor, quantized: bool) -> dict:
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if not quantized:
        return {"m": meta(p.shape, torch.float32),
                "v": meta(p.shape, torch.float32)}
    work = tuple(p.shape) if p.dim() else (1,)
    b = moment_block(work[-1])

    def qm():
        return QuantMoment(q=meta(work, torch.int8),
                           scale=meta(work[:-1] + (work[-1] // b,),
                                      torch.float32))

    return {"m": qm(), "v": qm()}


def abstract_train_state(model, optimizer: Optimizer) -> TrainState:
    """The state's shapes and dtypes on ``device="meta"``, no storage."""
    params = model.make_params("meta")
    quant = optimizer.config.quantized_state
    return TrainState(
        step=0, params=params,
        opt_state={"count": torch.empty((), dtype=torch.int32,
                                        device="meta"),
                   "mu": {n: _moment_abstract(p, quant)
                          for n, p in params.named_parameters()}})


def _moment_pspec(spec: Spec, ps: tuple, quantized: bool) -> dict:
    if not quantized:
        return {"m": ps, "v": ps}
    # the int8 payload has the parameter's shape: EXACTLY its spec; the
    # scales the same lead axes, the block axis replicated
    ndim = max(len(spec.shape), 1)
    entries = list(ps) + [None] * (ndim - len(ps))
    scale = (*entries[:-1], None)
    return {"m": QuantMoment(q=ps, scale=scale),
            "v": QuantMoment(q=ps, scale=scale)}


def train_state_pspecs(model, optimizer: Optimizer,
                       rules=None) -> TrainState:
    """The state's PartitionSpec tuples, keyed as the state: ``step`` and
    ``count`` replicated (``()``), each parameter's spec from its Spec's
    axes under ``rules`` (the active rules when None), each moment its
    parameter's (int8 moments: ``q`` the parameter's, ``scale`` its lead
    entries with the last ``None``).  ``params`` is a dict by name."""
    specs = named_specs(model.make_params("meta"))
    quant = optimizer.config.quantized_state
    params = param_pspecs(specs, rules)
    mu = {n: _moment_pspec(specs[n], ps, quant) for n, ps in params.items()}
    return TrainState(step=(), params=params,
                      opt_state={"count": (), "mu": mu})
