"""Mesh helpers for tests and small-scale runs.

The JAX package builds its test meshes over forced host devices; the port
builds a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
default process group -- one process a device -- with named dimensions.
Starting that group is the caller's job (``init_process_group`` with a
``file://`` or ``tcp://localhost`` init method), as creating the devices
is in the JAX package.  Every rank of the group calls :func:`test_mesh`
with the same arguments: building a mesh creates its dimension groups,
which is collective over the whole group.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["test_mesh", "device_count_at_least"]


def _world_size() -> int:
    """Ranks of the default process group; 0 when none is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 0


def device_count_at_least(n: int) -> bool:
    """Is the world (the default group's size, 1 without a group) at
    least ``n`` ranks?"""
    return max(_world_size(), 1) >= n


def test_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh of ``shape`` with dimension names ``axes`` over the first
    ``prod(shape)`` ranks of the default group, in rank order.  Its device
    type is ``device_type``, else ``"cuda"`` on an NCCL group and
    ``"cpu"`` otherwise."""
    need = math.prod(shape)
    have = _world_size()
    if have < need:
        raise RuntimeError(
            f"test mesh {shape} needs {need} devices, have {have} "
            "(start a torch.distributed process group of that many ranks "
            "first)")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(need).reshape(shape),
                      mesh_dim_names=tuple(axes))
