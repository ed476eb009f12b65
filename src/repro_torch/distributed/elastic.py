"""Elastic scaling: worker membership + resharding state between meshes.

Two mechanisms live here:

* ``reshard`` / ``reshard_like`` move a tree of tensors (nested dicts,
  lists and tuples) from its current layout onto the equivalent logical
  layout over a new ``torch.distributed`` device mesh.  Every leaf moves
  through its global value, so the transfer is exact between meshes of
  any size (4 -> 2 -> 4 ranks round-trips bit for bit, including specs
  naming axes the new mesh lacks).
* ``ElasticWorkerPool`` tracks coded-FFT worker membership between rounds:
  workers ``join``/``leave`` live while the recovery threshold ``m`` stays
  fixed.  The paper's MDS property makes departure a *latency event* --
  any ``m`` of the live workers still decode -- so a leave is just a mask
  flip.  Joins first refill departed slots (same RS evaluation node, no
  new code); joins beyond capacity grow the code to ``N+1`` nodes, which
  with root-of-unity nodes re-derives the node set, so consumers key
  their plan, generator and decode-cache state by ``pool.capacity``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree

from repro_torch.distributed.sharding import (
    global_tensor,
    place,
    spec_placements,
)

__all__ = ["ElasticWorkerPool", "reshard", "reshard_like"]


def _resolve(spec_leaf, mesh) -> tuple:
    """A PartitionSpec tuple with the axis names ``mesh`` lacks dropped
    (e.g. "pod" after a shrink); anything but a tuple is replicated,
    ``()``.  ``mesh``: a DeviceMesh or its dimension names."""
    names = tuple(getattr(mesh, "mesh_dim_names", mesh) or ())
    spec = spec_leaf if isinstance(spec_leaf, tuple) else ()
    cleaned = []
    for entry in spec:
        if entry is None:
            cleaned.append(None)
        elif isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            cleaned.append(kept if kept else None)
        else:
            cleaned.append(entry if entry in names else None)
    return tuple(cleaned)


def reshard(tree: Any, mesh, pspecs: Any) -> Any:
    """Place ``tree`` onto ``mesh`` under the ``pspecs`` tree.

    ``pspecs`` has the tree's structure down to its leaves, a
    PartitionSpec tuple at each (``None`` replicates every leaf); axes
    missing from the target mesh are silently dropped (pod removal).  A
    DTensor leaf moves through its global value, which reaches every rank
    (:func:`~repro_torch.distributed.sharding.global_tensor`); a plain
    tensor or array is every rank's copy of the whole value.  Every rank
    of the default group calls this with the same tree; the leaves come
    back as DTensors on ``mesh``.
    """
    flat, treedef = pytree.tree_flatten(tree)
    specs = (treedef.flatten_up_to(pspecs) if pspecs is not None
             else [()] * len(flat))
    out = [place(_global_value(leaf), mesh,
                 spec_placements(_resolve(spec, mesh), mesh))
           for leaf, spec in zip(flat, specs)]
    return pytree.tree_unflatten(out, treedef)


def _global_value(leaf) -> torch.Tensor:
    if isinstance(leaf, DTensor):
        return global_tensor(leaf)
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.as_tensor(np.asarray(leaf))


def _spec_of(x) -> tuple:
    """A DTensor's PartitionSpec, read back from its placements and its
    mesh's dimension names; a plain tensor is replicated, ``()``."""
    if not isinstance(x, DTensor):
        return ()
    names = x.device_mesh.mesh_dim_names or ()
    entries: list = [None] * x.ndim
    for name, p in zip(names, x.placements):
        if p.is_shard():
            prev = entries[p.dim]
            entries[p.dim] = name if prev is None else (
                (prev if isinstance(prev, tuple) else (prev,)) + (name,))
    return tuple(entries)


def reshard_like(tree: Any, mesh) -> Any:
    """Reshard keeping each leaf's current PartitionSpec (mesh swap
    only)."""
    flat, treedef = pytree.tree_flatten(tree)
    return reshard(tree, mesh, pytree.tree_unflatten(
        [_spec_of(x) for x in flat], treedef))


class ElasticWorkerPool:
    """Live worker membership for a coded plan with fixed threshold ``m``.

    The pool owns CAPACITY (the code size ``N``: how many RS evaluation
    nodes exist) and LIVENESS (which slots currently have a worker behind
    them).  Invariants, enforced here:

    * ``m`` never changes: recovery always needs exactly ``m`` responses.
    * ``leave`` only flips liveness; node assignment of every other slot
      is untouched, so in-flight plans stay valid (departed rows masked).
    * ``join`` reuses the lowest departed slot when one exists (same node,
      no new code); otherwise it appends slot ``capacity`` and
      grows the code by one node.  Each capacity value is a distinct code,
      so ``capacity`` is the cache key for plans/generators -- growth
      changes it, refills don't.
    * ``version`` increments on every membership change; consumers snapshot
      ``(capacity, version)`` per round to detect mid-round churn.
    """

    def __init__(self, n_workers: int, m: int):
        if m < 1 or n_workers < m:
            raise ValueError(f"need n_workers >= m >= 1, got N={n_workers} m={m}")
        self.m = int(m)
        self._alive = [True] * int(n_workers)
        self.version = 0
        self.joined = 0
        self.departed = 0

    # -- state ------------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Code size N: number of RS evaluation nodes / worker slots."""
        return len(self._alive)

    @property
    def n_live(self) -> int:
        return sum(self._alive)

    def mask(self) -> np.ndarray:
        """Boolean ``(capacity,)`` liveness mask (copy; safe to keep)."""
        return np.asarray(self._alive, dtype=bool)

    def is_live(self, worker: int) -> bool:
        return bool(self._alive[worker])

    def can_decode(self) -> bool:
        """At least m live workers: a round can still meet the threshold."""
        return self.n_live >= self.m

    # -- membership -------------------------------------------------------
    def leave(self, worker: int) -> None:
        """Remove a worker: mask flip only, node assignments untouched."""
        if not 0 <= worker < self.capacity:
            raise IndexError(f"worker {worker} out of range [0, {self.capacity})")
        if not self._alive[worker]:
            return
        self._alive[worker] = False
        self.departed += 1
        self.version += 1

    def join(self) -> int:
        """Add a worker; returns its slot id.

        Refills the lowest departed slot if any (cheap path), else appends
        a new slot, growing ``capacity`` -- and thus the plan cache key.
        """
        for w, alive in enumerate(self._alive):
            if not alive:
                self._alive[w] = True
                self.joined += 1
                self.version += 1
                return w
        self._alive.append(True)
        self.joined += 1
        self.version += 1
        return self.capacity - 1

    def summary(self) -> dict:
        return {
            "capacity": self.capacity,
            "n_live": self.n_live,
            "m": self.m,
            "version": self.version,
            "joined": self.joined,
            "departed": self.departed,
            "departed_slots": [w for w, a in enumerate(self._alive) if not a],
        }
