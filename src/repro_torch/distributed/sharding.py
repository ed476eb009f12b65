"""Logical-axis sharding rules (MaxText-style) for the whole framework.

Model code annotates activations/params with *logical* axis names; a rules
table maps those to physical mesh axes.  Outside a mesh context every
annotation is a no-op, so the same model code runs in one process and on a
mesh unchanged.

The port's ``PartitionSpec`` is a plain tuple with one entry per tensor
dimension: ``None`` (not sharded), a mesh dimension name, or a tuple of
names.  Its ``NamedSharding`` is the list of DTensor placements, one per
mesh dimension: ``Shard(d)`` where a name of the spec's entry ``d`` is
that dimension's, ``Replicate()`` elsewhere.

Activation axes:
  batch      -> (pod, data)     sequence stays unsharded
  heads/kv_heads/mlp/vocab/experts -> model   (tensor parallelism)
Param axes:
  p_fsdp     -> data            (ZeRO-3: gathered per-layer inside the scan)
  p_heads/p_kv/p_mlp/p_vocab/p_experts -> model
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (
    DTensor,
    Placement,
    Replicate,
    Shard,
    distribute_tensor,
)

__all__ = [
    "AxisRules",
    "SINGLE_POD_RULES",
    "MULTI_POD_RULES",
    "use_rules",
    "current_rules",
    "current_mesh",
    "logical_spec",
    "lshard",
    "named_sharding",
]

AxisRules = dict[str, Optional[object]]

# Physical axes: ("data", "model") or ("pod", "data", "model").
SINGLE_POD_RULES: AxisRules = {
    "batch": "data",
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "kv_seq": None,   # KV-cache context parallelism
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,   # expert-internal ff dim (EP owns "model")
    "expert_cap": None,
    "tokens": "data",     # flattened (batch*seq) token axis in MoE dispatch
    "state": None,
    "layers": None,
    "p_fsdp": "data",
    "p_heads": "model",
    "p_kv": "model",
    "p_mlp": "model",
    "p_vocab": "model",
    "p_experts": "model",
    "p_expert_mlp": None,
    "p_none": None,
    "workers": "data",  # coded-FFT worker axis in the FFT service
}

MULTI_POD_RULES: AxisRules = dict(
    SINGLE_POD_RULES,
    batch=("pod", "data"),
    tokens=("pod", "data"),
)


class _State(threading.local):
    def __init__(self):
        self.rules: Optional[AxisRules] = None
        self.mesh: Optional[DeviceMesh] = None


_STATE = _State()


@contextlib.contextmanager
def use_rules(mesh: Optional[DeviceMesh], rules: Optional[AxisRules] = None):
    """Activate a mesh + logical-rules table for model annotations."""
    if rules is None and mesh is not None:
        rules = (MULTI_POD_RULES if "pod" in (mesh.mesh_dim_names or ())
                 else SINGLE_POD_RULES)
    prev = (_STATE.rules, _STATE.mesh)
    _STATE.rules, _STATE.mesh = rules, mesh
    try:
        yield
    finally:
        _STATE.rules, _STATE.mesh = prev


def current_rules() -> Optional[AxisRules]:
    return _STATE.rules


def current_mesh() -> Optional[DeviceMesh]:
    return _STATE.mesh


def logical_spec(axes: tuple, rules: Optional[AxisRules] = None) -> tuple:
    """Logical axis names -> the port's PartitionSpec (a tuple) under the
    active rules."""
    rules = rules if rules is not None else _STATE.rules
    if rules is None:
        return ()
    return tuple(None if name is None else rules.get(name) for name in axes)


def spec_placements(spec: tuple, mesh: DeviceMesh) -> list[Placement]:
    """A PartitionSpec tuple -> DTensor placements on ``mesh``: ``Shard(d)``
    on each mesh dimension named by entry ``d``, ``Replicate()`` on the
    rest.  Every name must be one of the mesh's dimensions."""
    names = tuple(mesh.mesh_dim_names or ())
    placements: list[Placement] = [Replicate()] * mesh.ndim
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            if name not in names:
                raise ValueError(f"mesh axis {name!r} is not one of the "
                                 f"mesh's {names}")
            placements[names.index(name)] = Shard(d)
    return placements


def named_sharding(axes: tuple, mesh: Optional[DeviceMesh] = None,
                   rules: Optional[AxisRules] = None
                   ) -> Optional[list[Placement]]:
    """The placements of logical ``axes`` on ``mesh`` (the active mesh by
    default), or ``None`` without a mesh."""
    mesh = mesh if mesh is not None else _STATE.mesh
    if mesh is None:
        return None
    return spec_placements(logical_spec(axes, rules), mesh)


def lshard(x: torch.Tensor, *axes) -> torch.Tensor:
    """Place ``x`` on the active mesh as its logical ``axes`` say: a no-op
    when no mesh is active.  A plain tensor is every rank's copy of the
    whole value; a DTensor is moved through its global value
    (``elastic.reshard``'s path)."""
    placements = named_sharding(tuple(axes))
    if placements is None:
        return x
    if isinstance(x, DTensor):
        x = global_tensor(x)
    return place(x, _STATE.mesh, placements)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards of ``mesh`` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def place(x: torch.Tensor, mesh: DeviceMesh,
          placements: list[Placement]) -> DTensor:
    """A DTensor on ``mesh`` from ``x``, the whole value every rank holds:
    each rank keeps its own slice, with no collective."""
    return distribute_tensor(x.to(mesh_device(mesh)), mesh, placements,
                             src_data_rank=None)


def _local_slices(shape: tuple, mesh: DeviceMesh, placements,
                  coord: list[int]) -> tuple[slice, ...]:
    """Where this rank's shard sits in the global tensor: DTensor's
    ``Shard`` split (``torch.chunk`` sizes), mesh dimension by mesh
    dimension."""
    start = [0] * len(shape)
    length = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            d, k = p.dim, mesh.size(i)
            chunk = -(-length[d] // k)
            lo = min(coord[i] * chunk, length[d])
            start[d] += lo
            length[d] = min(lo + chunk, length[d]) - lo
    return tuple(slice(a, a + n) for a, n in zip(start, length))


def global_tensor(x: DTensor) -> torch.Tensor:
    """The whole value of ``x`` on EVERY rank of the default group, each
    of which must call this.

    One rank a shard (the replicas at coordinate 0 of each replicated
    dimension) writes its shard into zeros of the global shape, and one
    ``all_reduce`` over the default group sums the bytes: each byte has
    one writer, so the sum is the value bit for bit, and it reaches ranks
    outside ``x``'s mesh too.  DTensor's own collectives
    (``full_tensor``, ``redistribute``) are not used: on ``gloo`` with
    CUDA tensors they crash in torch 2.11, where the c10d collectives
    work."""
    mesh = x.device_mesh
    placements = x.placements
    if any(p.is_partial() for p in placements):
        raise ValueError("a Partial placement holds no global value to move")
    full = torch.zeros(x.shape, dtype=x.dtype, device=mesh_device(mesh))
    coord = mesh.get_coordinate()
    if coord is not None and all(
            c == 0 for c, p in zip(coord, placements) if p.is_replicate()):
        full[_local_slices(tuple(x.shape), mesh, placements, coord)] = \
            x.to_local()
    flat = full.reshape(-1)
    if flat.is_complex():
        flat = torch.view_as_real(flat)
    dist.all_reduce(flat.view(torch.uint8))
    return full
