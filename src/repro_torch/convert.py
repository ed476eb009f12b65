"""Carry state across from the JAX package, as plain numpy and dicts.

The coded FFT has no weights: its state is the (N, m) generator G and the
seeded straggler masks.  A language model's state is its parameter
tree.
These helpers take what the JAX package exposes (numpy arrays, dicts,
dataclass fields) without importing it, so the port computes with exactly
the reference's G, configuration and weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.distributed.faults import FaultPlan, WorkerFault
from repro_torch.distributed.straggler import StragglerModel
from repro_torch.serving.fft_service import FFTServiceConfig

__all__ = ["generator_from_reference", "config_from_reference",
           "griffin_params_from_reference",
           "fault_plan_from_reference", "rwkv_params_from_reference",
           "transformer_params_from_reference"]

_DTYPES = {"complex64": torch.complex64, "complex128": torch.complex128}

_FAULT_FIELDS = ("worker", "kind", "start_round", "rounds", "delay_s")


def generator_from_reference(g: np.ndarray, device) -> tuple[torch.Tensor,
                                                             torch.Tensor]:
    """A reference plan's complex ``(N, m)`` generator (as numpy) -> the
    port's float32 ``(gr, gi)`` planes on ``device``."""
    g = np.asarray(g)
    if g.ndim != 2 or not np.iscomplexobj(g):
        raise ValueError(f"expected a complex (N, m) generator, got "
                         f"{g.dtype} {g.shape}")
    return (torch.as_tensor(np.ascontiguousarray(g.real, np.float32),
                            device=device),
            torch.as_tensor(np.ascontiguousarray(g.imag, np.float32),
                            device=device))


def _straggler(value) -> StragglerModel:
    if isinstance(value, StragglerModel):
        return value
    if isinstance(value, dict):
        return StragglerModel(**value)
    return StragglerModel(t0=value.t0, mu=value.mu, wire_frac=value.wire_frac)


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def fault_plan_from_reference(value) -> FaultPlan | None:
    """A reference ``FaultPlan`` (the object, or its ``dataclasses.asdict``
    dict) -> the port's: the same faults and seed, so the same draws."""
    if value is None or isinstance(value, FaultPlan):
        return value
    faults = tuple(WorkerFault(**{k: _field(f, k) for k in _FAULT_FIELDS})
                   for f in _field(value, "faults"))
    return FaultPlan(faults, int(_field(value, "seed")))


def config_from_reference(cfg_fields: dict) -> FFTServiceConfig:
    """Map the reference ``FFTServiceConfig``'s fields (a dict, e.g. from
    ``dataclasses.asdict`` or ``vars``) onto the port's config.

    The dtype maps by name, the straggler model by its three parameters,
    a fault plan by its faults and seed; ``decode_method``, ``worker_fn``
    (which must take and return torch tensors on the port's side),
    ``strategy``, ``strategy_param`` and ``precision`` (``"bf16"`` served
    as the reference serves it: probed per shape) map as they are; an
    unknown field raises ValueError.
    """
    own = {f.name for f in dataclasses.fields(FFTServiceConfig)}
    kwargs = {}
    for name, value in cfg_fields.items():
        if name in own:
            if name == "dtype":
                value = _DTYPES[np.dtype(value).name]
            elif name == "straggler":
                value = _straggler(value)
            elif name == "faults":
                value = fault_plan_from_reference(value)
            kwargs[name] = value
        else:
            raise ValueError(f"unknown reference config field {name!r}")
    return FFTServiceConfig(**kwargs)


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes: no numpy kernel
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def _flatten(tree: dict, prefix: str, out: dict) -> None:
    for name, value in tree.items():
        if isinstance(value, dict):
            _flatten(value, f"{prefix}{name}.", out)
        else:
            out[prefix + name] = value


def _split_layers(flat: dict, slots: list, tail: list = ()) -> dict:
    """Add the leaves of layer-stacked superblock ``slots`` to ``flat``,
    split per layer as ``layers.<i>.<path>`` (layer ``r * len(slots) +
    s`` from slot ``s`` at repeat ``r``), then the unstacked ``tail``
    layers in order; returns the port's state dict."""
    stacked = []
    for slot in slots:
        leaves: dict = {}
        _flatten(slot, "", leaves)
        stacked.append(leaves)
    depth = {int(np.shape(a)[0]) for leaves in stacked for a in leaves.values()}
    if len(depth) > 1:
        raise ValueError(f"the superblock slots' layer leaves disagree on "
                         f"the depth: {sorted(depth)}")
    repeats = depth.pop() if depth else 0
    for r in range(repeats):
        for s, leaves in enumerate(stacked):
            for path, a in leaves.items():
                flat[f"layers.{r * len(slots) + s}.{path}"] = np.asarray(a)[r]
    for j, layer in enumerate(tail):
        _flatten(layer, f"layers.{repeats * len(slots) + j}.", flat)
    return {name: _tensor(a) for name, a in flat.items()}


def rwkv_params_from_reference(tree: dict) -> dict[str, torch.Tensor]:
    """A JAX RWKV-6 parameter tree (nested dicts of numpy arrays, the
    ``layers`` subtree stacked on a leading layer axis) -> the port's
    ``RWKV6`` state dict (CPU tensors, split per layer as
    ``layers.<i>.<path>``), for ``load_state_dict``."""
    flat: dict = {}
    _flatten({k: v for k, v in tree.items() if k != "layers"}, "", flat)
    return _split_layers(flat, [tree["layers"]])


def transformer_params_from_reference(tree: dict) -> dict[str, torch.Tensor]:
    """A JAX decoder-only transformer tree (``embed``, ``final_norm``,
    ``blocks`` -- one layer-stacked subtree a superblock slot: one for the
    dense and vlm families, ``interleave_step`` for an interleaved MoE --
    and ``unembed`` when untied; numpy leaves, bf16 included) -> the
    port's ``Transformer`` state dict (CPU tensors, layer ``r * step + s``
    from slot ``s`` at repeat ``r``, as ``layers.<i>.<path>``), for
    ``load_state_dict``."""
    flat: dict = {}
    _flatten({k: v for k, v in tree.items() if k != "blocks"}, "", flat)
    return _split_layers(flat, list(tree["blocks"]))


def griffin_params_from_reference(tree: dict) -> dict[str, torch.Tensor]:
    """A JAX Griffin tree (``embed``, ``final_norm``, ``blocks`` -- one
    layer-stacked subtree a pattern slot -- and the unstacked ``tail``
    layers) -> the port's ``Griffin`` state dict (the blocks' layers as
    for the transformer, then the tail in order)."""
    flat: dict = {}
    _flatten({k: v for k, v in tree.items() if k not in ("blocks", "tail")},
             "", flat)
    return _split_layers(flat, list(tree["blocks"]), list(tree["tail"]))
