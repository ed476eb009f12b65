"""Roofline accounting of a step as PyTorch dispatches it.

The twin of the JAX package's ``launch/hlo_analysis.py``, which re-derives
FLOPs, HBM bytes and collective bytes from a compiled XLA module's text,
multiplying each while-loop body by its trip count.  The port has no
compiled module: :func:`analyze` runs the step under a
``TorchDispatchMode`` and counts every op as it is dispatched -- on meta
tensors (nothing computes, nothing is allocated) or on real ones.
Dispatch sees every op that runs, loops included, so no trip-count
correction is needed.

* **FLOPs** -- matmuls and convolutions only (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``convolution`` and their backward ops), 2 a
  multiply-add, as the reference counts dots and convolutions; the
  elementwise work belongs to the bytes.  ``flops_by_dtype`` splits
  them by their operands' dtype (``"bfloat16"``, ``"float32"``,
  ``"complex64"``, ...), since the card runs each at its own peak.
* **Bytes** -- operands plus results of every op that is not a view or
  metadata (``empty``, ``detach``, ...).  This is what eager PyTorch
  really moves: no op is fused, so every intermediate crosses memory.
  It differs on purpose from the reference's fusion-normalised count
  (elementwise ops costed at their result only).
* **Collectives** -- the ``c10d`` ops issued inside the window (the
  process group's own and the functional ones), their result bytes, with
  the reference's wire factors: all-reduce counts 2 (reduce-scatter plus
  all-gather), the others 1; their result bytes also count as bytes.
* **Kernels** -- the port's ctypes kernels are invisible to the
  dispatcher, so each wrapper a counted step reaches reports its name,
  flops and bytes through ``kernels._build.report_cost`` (on CUDA
  tensors where it launches, on meta tensors where it only shapes its
  outputs); they add to ``flops`` (as ``"float32"``: the port's kernels
  compute in f32) and ``bytes_accessed`` and are listed by name in
  ``kernels``.  On the CPU a wrapper runs its plain twin,
  whose ops dispatch and count themselves.
* **Live bytes** -- the largest sum of op results alive at once (each
  fresh result counted until its tensor is freed; inputs, views and
  in-place results not), the twin of ``memory_analysis``'s temp size.

Every quantity is for the step as run: a global step counts the global
work, not a chip's.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build

__all__ = ["StepCost", "CostCounter", "analyze", "COLLECTIVE_WIRE_FACTOR"]

aten = torch.ops.aten

# the matmul and convolution ops, by the flop counter's own formulas
_FLOP_OPS = {op: flop_registry[op] for op in (
    aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution,
    aten._convolution, aten.convolution_backward)}

# ops that move no data: allocation, aliasing, metadata
_NO_BYTES = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "lift_fresh_copy", "_unsafe_view",
    "set_", "resize_", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size", "_local_scalar_dense",
    "record_stream", "_has_compatible_shallow_copy_type",
}

# c10d op name -> the reference's collective name
_COLLECTIVE_NAMES = {
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "broadcast", "broadcast": "broadcast",
}
COLLECTIVE_WIRE_FACTOR = {
    "all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
    "all-to-all": 1.0, "collective-permute": 1.0, "broadcast": 1.0,
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


@dataclasses.dataclass
class StepCost:
    flops: float = 0.0                 # matmul + conv (+ reported kernels)
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    bytes_accessed: float = 0.0        # operands + results, eager
    collective_result_bytes: dict = dataclasses.field(default_factory=dict)
    collective_wire_bytes: float = 0.0
    collective_counts: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    peak_live_bytes: int = 0
    ops: int = 0

    def add_flops(self, dtype: str, flops: float) -> None:
        self.flops += flops
        self.flops_by_dtype[dtype] = self.flops_by_dtype.get(dtype, 0) + flops

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "bytes_accessed": self.bytes_accessed,
            "collective_result_bytes": dict(self.collective_result_bytes),
            "collective_wire_bytes": self.collective_wire_bytes,
            "collective_counts": dict(self.collective_counts),
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
            "peak_live_bytes": self.peak_live_bytes,
            "ops": self.ops,
        }


class CostCounter(TorchDispatchMode):
    """Counts every op dispatched inside ``with CostCounter() as c:`` into
    ``c.cost`` (a :class:`StepCost`)."""

    def __init__(self):
        super().__init__()
        self.cost = StepCost()
        self._live = 0
        self._sink = _build.cost_sink(self._kernel)

    def __enter__(self):
        self._sink.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        self._sink.__exit__(*exc)
        return super().__exit__(*exc)

    def _kernel(self, name: str, flops: float, nbytes: float) -> None:
        c = self.cost
        c.add_flops("float32", flops)
        c.bytes_accessed += nbytes
        k = c.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                        "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def _freed(self, nbytes: int) -> None:
        self._live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.cost
        c.ops += 1
        kind, arg = _classify(func)
        if kind is _SKIP:
            return out
        if kind is _COLLECTIVE:
            res = _tensors(out) if func.namespace != "c10d" else []
            if not res:              # in place: the output buffer is arg 0
                res = _tensors(args[0])
            b = sum(_nbytes(t) for t in res)
            c.collective_result_bytes[arg] = (
                c.collective_result_bytes.get(arg, 0) + b)
            c.collective_counts[arg] = c.collective_counts.get(arg, 0) + 1
            c.collective_wire_bytes += b * COLLECTIVE_WIRE_FACTOR[arg]
            c.bytes_accessed += b
            return out
        ins = _flat_tensors(args)
        if kind is _FLOPS:
            c.add_flops(_dtype_name(ins[0].dtype),
                        arg(*args, **kwargs, out_val=out))
        if kwargs:
            ins += _flat_tensors(kwargs.values())
        res = [out] if isinstance(out, torch.Tensor) else _flat_tensors(
            out if isinstance(out, (tuple, list)) else ())
        nb = 0
        for t in ins:
            nb += _nbytes(t)
        # live intermediates: fresh results, until their tensor is freed
        for t in res:
            b = _nbytes(t)
            nb += b
            if any(t is x for x in ins):
                continue
            self._live += b
            weakref.finalize(t, self._freed, b)
        c.bytes_accessed += nb
        if self._live > c.peak_live_bytes:
            c.peak_live_bytes = self._live
        return out


_SKIP, _COLLECTIVE, _FLOPS, _BYTES = "skip", "collective", "flops", "bytes"
_CLASSES: dict = {}


def _classify(func) -> tuple:
    """(what the counter does with ``func``, its argument), cached."""
    got = _CLASSES.get(func)
    if got is None:
        packet = func.overloadpacket
        name, ns = packet.__name__, func.namespace
        if ns in ("c10d", "_c10d_functional", "c10d_functional"):
            kind = _COLLECTIVE_NAMES.get(name)
            got = (_SKIP, None) if kind is None else (_COLLECTIVE, kind)
        elif packet in _FLOP_OPS:
            got = (_FLOPS, _FLOP_OPS[packet])
        elif func.is_view or name in _NO_BYTES or ns == "prim":
            got = (_SKIP, None)
        else:
            got = (_BYTES, None)
        _CLASSES[func] = got
    return got


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _flat_tensors(items) -> list[torch.Tensor]:
    """The tensors among ``items`` and one level of lists inside them."""
    out = []
    for x in items:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            out.extend(y for y in x if isinstance(y, torch.Tensor))
    return out


def analyze(fn: Callable, *args, **kwargs) -> tuple[object, StepCost]:
    """Run ``fn(*args, **kwargs)`` under a :class:`CostCounter`; returns
    (its result, the cost)."""
    with CostCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.cost
