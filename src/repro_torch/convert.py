"""Carry state across from the JAX package, as plain numpy and dicts.

The coded FFT has no weights: its state is the (N, m) generator G and the
seeded straggler masks.  A language model's state is its parameter
tree, and in training its AdamW moments (exact, or int8 ``QuantMoment``
pairs) beside it: :func:`train_state_from_reference` and
:func:`train_state_to_reference` carry a training state either way.
These helpers take what the JAX package exposes (numpy arrays, dicts,
dataclass fields) without importing it, so the port computes with exactly
the reference's G, configuration and weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.distributed.faults import FaultPlan, WorkerFault
from repro_torch.optim.adamw import QuantMoment
from repro_torch.distributed.straggler import StragglerModel
from repro_torch.serving.fft_service import FFTServiceConfig

__all__ = ["generator_from_reference", "config_from_reference",
           "encdec_params_from_reference", "griffin_params_from_reference",
           "fault_plan_from_reference", "params_from_reference",
           "params_to_reference", "rwkv_params_from_reference",
           "train_state_from_reference", "train_state_to_reference",
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


def _split_layers(flat: dict, slots: list, tail: list = (),
                  prefix: str = "layers") -> dict:
    """Add the leaves of layer-stacked superblock ``slots`` to ``flat``,
    split per layer as ``<prefix>.<i>.<path>`` (layer ``r * len(slots) +
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
                flat[f"{prefix}.{r * len(slots) + s}.{path}"] = \
                    np.asarray(a)[r]
    for j, layer in enumerate(tail):
        _flatten(layer, f"{prefix}.{repeats * len(slots) + j}.", flat)
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


def encdec_params_from_reference(tree: dict) -> dict[str, torch.Tensor]:
    """A JAX encoder-decoder tree (``embed``, ``enc_ln_post``,
    ``dec_ln_post``, and ``enc_layers`` and ``dec_layers``, each stacked
    on a leading layer axis; numpy leaves, bf16 included) -> the port's
    ``EncDec`` state dict (CPU tensors, the layers split as
    ``enc_layers.<i>.<path>`` and ``dec_layers.<i>.<path>``), for
    ``load_state_dict``."""
    flat: dict = {}
    _flatten({k: v for k, v in tree.items()
              if k not in ("enc_layers", "dec_layers")}, "", flat)
    state = _split_layers(flat, [tree["enc_layers"]], prefix="enc_layers")
    state.update(_split_layers({}, [tree["dec_layers"]], prefix="dec_layers"))
    return state


def params_from_reference(tree: dict, cfg) -> dict[str, torch.Tensor]:
    """A JAX parameter tree of ``cfg``'s family -> the port's state dict
    (the family's ``*_params_from_reference``)."""
    fam = cfg.family
    if fam == "ssm":
        return rwkv_params_from_reference(tree)
    if fam == "hybrid":
        return griffin_params_from_reference(tree)
    if fam == "encdec":
        return encdec_params_from_reference(tree)
    return transformer_params_from_reference(tree)


def _stacks(cfg) -> list[tuple[str, str, int, int, bool]]:
    """The reference's layer stacks of ``cfg``'s family: (the port's
    prefix, the reference's key, superblock slots, repeats, whether the
    slots are a list)."""
    fam, n = cfg.family, cfg.n_layers
    if fam == "ssm":
        return [("layers", "layers", 1, n, False)]
    if fam == "encdec":
        return [("enc_layers", "enc_layers", 1, cfg.encoder_layers, False),
                ("dec_layers", "dec_layers", 1, n, False)]
    if fam == "hybrid":
        pat = len(cfg.recurrent.block_pattern)
        return [("layers", "blocks", pat, n // pat, True)]
    step = cfg.moe.interleave_step if cfg.moe is not None else 1
    return [("layers", "blocks", step, n // step, True)]


def _numpy(t) -> np.ndarray:
    """A copy as numpy (never sharing memory with a parameter that an
    optimizer step will update in place); bf16 as its f32 values."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return np.array((t.float() if t.dtype == torch.bfloat16 else t)
                        .numpy())
    return np.array(t)


def _nest(flat: dict) -> dict:
    out: dict = {}
    for name, a in flat.items():
        *head, last = name.split(".")
        node = out
        for part in head:
            node = node.setdefault(part, {})
        node[last] = a
    return out


def _stack_trees(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def params_to_reference(state: dict, cfg) -> dict:
    """The port's state dict (names -> tensors) -> the JAX package's
    nested tree of ``cfg``'s family (layers stacked on a leading axis,
    superblock slots and the hybrid's tail as the reference has them):
    numpy leaves, bf16 tensors as their exact float32 values."""
    flat = {k: _numpy(v) for k, v in state.items()}
    layers: dict = {}
    rest = {}
    prefixes = {prefix for prefix, *_ in _stacks(cfg)}
    for name, a in flat.items():
        head, _, tail = name.partition(".")
        if head in prefixes:
            idx, _, path = tail.partition(".")
            layers.setdefault(head, {}).setdefault(int(idx), {})[path] = a
        else:
            rest[name] = a
    out = _nest(rest)
    for prefix, key, slots, repeats, as_list in _stacks(cfg):
        per = {i: _nest(v) for i, v in layers.get(prefix, {}).items()}
        stacked = [_stack_trees([per[r * slots + s] for r in range(repeats)])
                   for s in range(slots)]
        out[key] = stacked if as_list else stacked[0]
        if cfg.family == "hybrid":
            out["tail"] = [per[i] for i in range(repeats * slots,
                                                  cfg.n_layers)]
    return out


def _is_quant(x) -> bool:
    return isinstance(x, tuple) and getattr(x, "_fields", None) == (
        "q", "scale")


def _pick(tree, key):
    """The tree of ``tree``'s moment leaves ``{"m", "v"}`` at ``key``, or
    of its QuantMoment leaves' field ``key``."""
    if _is_quant(tree):
        return getattr(tree, key)
    if isinstance(tree, dict):
        if set(tree) == {"m", "v"}:
            return tree[key]
        return {k: _pick(v, key) for k, v in tree.items()}
    return [_pick(v, key) for v in tree]


def _has_quant(tree) -> bool:
    if _is_quant(tree):
        return True
    if isinstance(tree, dict):
        return any(_has_quant(v) for v in tree.values())
    if isinstance(tree, list):
        return any(_has_quant(v) for v in tree)
    return False


def train_state_from_reference(tree: dict, cfg) -> dict[str, torch.Tensor]:
    """A JAX ``TrainState.tree()`` (``step``, ``params``, ``opt_state``
    with ``count`` and ``mu``; numpy leaves, QuantMoments as namedtuples
    of numpy) -> the port's flat ``TrainState.tree()`` dict (CPU tensors),
    for ``TrainState.from_tree``."""
    out = {"step": torch.tensor(np.asarray(tree["step"]).astype(np.int32))}
    for name, t in params_from_reference(tree["params"], cfg).items():
        out[f"params.{name}"] = t
    opt = tree["opt_state"]
    out["opt_state.count"] = torch.tensor(
        np.asarray(opt["count"]).astype(np.int32))
    quant = _has_quant(opt["mu"])
    for mv in ("m", "v"):
        moments = _pick(opt["mu"], mv)
        parts = (("q", "scale") if quant else (None,))
        for part in parts:
            leaves = _pick(moments, part) if part else moments
            suffix = f".{part}" if part else ""
            for name, t in params_from_reference(leaves, cfg).items():
                out[f"opt_state.mu.{name}.{mv}{suffix}"] = t
    return out


def _zip_trees(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _zip_trees(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_zip_trees(fn, *parts) for parts in zip(*trees)]
    return fn(*trees)


def train_state_to_reference(flat: dict, cfg) -> dict:
    """The port's flat ``TrainState.tree()`` -> the JAX package's
    ``TrainState.tree()`` layout (``params_to_reference`` for the
    parameters and for each moment; int8 moments as the port's
    ``QuantMoment`` of numpy arrays, which JAX flattens as its own)."""
    params = {k[len("params."):]: v for k, v in flat.items()
              if k.startswith("params.")}
    names = list(params)
    quant = f"opt_state.mu.{names[0]}.m.q" in flat

    def moments(mv, part=None):
        suffix = f".{part}" if part else ""
        return params_to_reference(
            {n: flat[f"opt_state.mu.{n}.{mv}{suffix}"] for n in names}, cfg)

    mu = {}
    for mv in ("m", "v"):
        mu[mv] = (_zip_trees(QuantMoment, moments(mv, "q"),
                             moments(mv, "scale"))
                  if quant else moments(mv))
    return {
        "step": _numpy(flat["step"]).astype(np.int32),
        "params": params_to_reference(params, cfg),
        "opt_state": {
            "count": _numpy(flat["opt_state.count"]).astype(np.int32),
            "mu": _zip_trees(lambda m, v: {"m": m, "v": v}, mu["m"],
                             mu["v"]),
        },
    }
