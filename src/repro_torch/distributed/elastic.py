"""Elastic worker membership for the coded service.

``ElasticWorkerPool`` tracks coded-FFT worker membership between rounds:
workers ``join``/``leave`` live while the recovery threshold ``m`` stays
fixed.  The paper's MDS property makes departure a *latency event* --
any ``m`` of the live workers still decode -- so a leave is just a mask
flip.  Joins first refill departed slots (same RS evaluation node, no
new code); joins beyond capacity grow the code to ``N+1`` nodes, which
with root-of-unity nodes re-derives the node set, so consumers key
their plan, generator and decode-cache state by ``pool.capacity``.

The JAX package's module also moves parameter trees from one device
mesh onto another (``reshard`` / ``reshard_like``).  Those wait for the
port's multi-device runtime (ROADMAP.md, Queue 1 item 8); here they
raise ``NotImplementedError`` naming it.
"""

from __future__ import annotations

from typing import Any

import numpy as np

__all__ = ["ElasticWorkerPool", "reshard", "reshard_like"]

_MULTI_DEVICE = "ROADMAP.md, Queue 1 item 8 (the multi-device runtime)"


def reshard(tree: Any, mesh: Any, pspecs: Any) -> Any:
    """Place ``tree`` onto ``mesh`` under ``pspecs``: not served by the
    port yet -- it needs the multi-device runtime."""
    raise NotImplementedError(
        f"reshard is not served by the PyTorch port yet -- see "
        f"{_MULTI_DEVICE}")


def reshard_like(tree: Any, mesh: Any) -> Any:
    """Reshard keeping each leaf's layout (mesh swap only): not served by
    the port yet -- it needs the multi-device runtime."""
    raise NotImplementedError(
        f"reshard_like is not served by the PyTorch port yet -- see "
        f"{_MULTI_DEVICE}")


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
