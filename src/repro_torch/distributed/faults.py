"""Seeded, deterministic fault injection for the coded worker runtime.

The paper's robustness claims (any ``m`` of ``N`` responses recover the
output; ``k`` responses detect ``k - m`` / correct ``floor((k - m)/2)``
Byzantine workers) are only claims until the runtime is exercised under
actual failures.  This module turns failure modes into data:

* ``WorkerFault`` -- one scheduled fault: ``kill`` (worker never responds
  for ``rounds`` consecutive rounds), ``delay`` (worker responds
  ``delay_s`` seconds late), or ``corrupt`` (worker responds on time with
  arbitrarily wrong rows -- the Byzantine case).
* ``FaultPlan`` -- an immutable schedule of faults plus a seed.  Either
  hand-built (``FaultPlan.single(...)``, chained ``.kill/.delay/.corrupt``)
  or drawn (``FaultPlan.random(...)``) -- both fully deterministic, so a
  failing run reproduces from its seed alone.
* ``FaultInjector`` -- the runtime view: ``faults_for(round)`` projects the
  plan onto one round as a ``RoundFaults`` (killed/delayed/corrupt sets),
  ``corrupt_array`` applies seeded, round- and worker-keyed garbage to
  worker output rows, and ``perturb_latencies`` folds kill/delay into a
  vector of (simulated or measured) completion times.

Everything here is numpy on the host, draw for draw the JAX package's
module: the same plan and seed give the same faults and the same
corrupted values, bit for bit.  Injection is an opt-in hook:
``FFTServiceConfig(faults=...)`` threads a plan through; with no plan
every code path is the fault-free one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Iterable, Sequence, Tuple

import numpy as np

__all__ = [
    "FAULT_KINDS",
    "WorkerFault",
    "RoundFaults",
    "FaultPlan",
    "FaultInjector",
]

FAULT_KINDS = ("kill", "delay", "corrupt")


@dataclasses.dataclass(frozen=True)
class WorkerFault:
    """One scheduled fault against one worker.

    Active for rounds ``start_round <= r < start_round + rounds``.
    ``delay_s`` only applies to ``kind == "delay"``.
    """

    worker: int
    kind: str
    start_round: int = 0
    rounds: int = 1
    delay_s: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"fault kind must be one of {FAULT_KINDS}, got {self.kind!r}")
        if self.rounds < 1:
            raise ValueError("fault must span >= 1 round")
        if self.kind == "delay" and self.delay_s < 0:
            raise ValueError("delay_s must be >= 0")

    def active(self, round_idx: int) -> bool:
        return self.start_round <= round_idx < self.start_round + self.rounds


@dataclasses.dataclass(frozen=True)
class RoundFaults:
    """Projection of a FaultPlan onto a single round."""

    killed: FrozenSet[int] = frozenset()
    delays: Tuple[Tuple[int, float], ...] = ()  # (worker, seconds), sorted
    corrupt: FrozenSet[int] = frozenset()

    @property
    def delay_map(self) -> Dict[int, float]:
        return dict(self.delays)

    @property
    def any(self) -> bool:
        return bool(self.killed or self.delays or self.corrupt)


_EMPTY_ROUND = RoundFaults()


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, seeded schedule of worker faults.

    ``seed`` keys the corruption noise (and ``FaultPlan.random`` draws), so
    two runs with the same plan inject bit-identical faults.
    """

    faults: Tuple[WorkerFault, ...] = ()
    seed: int = 0

    # -- builders ---------------------------------------------------------
    def kill(self, worker: int, *, start_round: int = 0, rounds: int = 1) -> "FaultPlan":
        return self._with(WorkerFault(worker, "kill", start_round, rounds))

    def delay(self, worker: int, delay_s: float, *, start_round: int = 0,
              rounds: int = 1) -> "FaultPlan":
        return self._with(WorkerFault(worker, "delay", start_round, rounds, delay_s))

    def corrupt(self, worker: int, *, start_round: int = 0, rounds: int = 1) -> "FaultPlan":
        return self._with(WorkerFault(worker, "corrupt", start_round, rounds))

    def _with(self, fault: WorkerFault) -> "FaultPlan":
        return dataclasses.replace(self, faults=self.faults + (fault,))

    @staticmethod
    def single(worker: int, kind: str, *, delay_s: float = 0.0,
               start_round: int = 0, rounds: int = 1, seed: int = 0) -> "FaultPlan":
        return FaultPlan((WorkerFault(worker, kind, start_round, rounds, delay_s),), seed)

    @staticmethod
    def random(n_workers: int, rate: float, *, kinds: Sequence[str] = FAULT_KINDS,
               rounds: int = 1, horizon: int = 64, delay_s: float = 0.05,
               seed: int = 0) -> "FaultPlan":
        """Draw a seeded schedule: each (round, worker) faults w.p. ``rate``.

        ``rate`` is the per-round per-worker fault probability, so
        ``rate=1/N`` means on average one faulty worker per round (the
        bench's fault-rate axis).  Faults drawn at round ``r`` last
        ``rounds`` rounds.
        """
        if not 0.0 <= rate <= 1.0:
            raise ValueError("rate must be in [0, 1]")
        for k in kinds:
            if k not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        rng = np.random.default_rng(seed)
        faults = []
        for r in range(horizon):
            hit = rng.random(n_workers) < rate
            for w in np.flatnonzero(hit):
                kind = kinds[int(rng.integers(len(kinds)))]
                d = float(delay_s * (0.5 + rng.random())) if kind == "delay" else 0.0
                faults.append(WorkerFault(int(w), kind, r, rounds, d))
        return FaultPlan(tuple(faults), seed)

    # -- queries ----------------------------------------------------------
    def faults_for(self, round_idx: int) -> RoundFaults:
        killed, corrupt, delays = set(), set(), {}
        for f in self.faults:
            if not f.active(round_idx):
                continue
            if f.kind == "kill":
                killed.add(f.worker)
            elif f.kind == "corrupt":
                corrupt.add(f.worker)
            else:
                delays[f.worker] = max(delays.get(f.worker, 0.0), f.delay_s)
        if not (killed or corrupt or delays):
            return _EMPTY_ROUND
        return RoundFaults(frozenset(killed), tuple(sorted(delays.items())),
                           frozenset(corrupt))

    @property
    def horizon(self) -> int:
        return max((f.start_round + f.rounds for f in self.faults), default=0)


class FaultInjector:
    """Runtime view of a FaultPlan: per-round fault sets + seeded corruption.

    Stateless with respect to rounds -- every method takes ``round_idx`` so
    replays and retries see identical faults.  Corruption noise is keyed by
    ``(plan.seed, round_idx, worker)``: deterministic, but distinct per
    round and per worker (adversarial patterns in tests rely on this).
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def faults_for(self, round_idx: int) -> RoundFaults:
        return self.plan.faults_for(round_idx)

    def corrupt_array(self, b: np.ndarray, workers: Iterable[int],
                      round_idx: int, *, worker_axis: int = -2) -> np.ndarray:
        """Return ``b`` with ``workers`` rows along ``worker_axis`` garbaged.

        The corruption is large-magnitude seeded noise -- arbitrary
        (Byzantine), not zeroing, so an unverified decode that includes a
        corrupt row produces visibly wrong output rather than small error.
        """
        workers = sorted(set(int(w) for w in workers))
        if not workers:
            return b
        out = np.array(b)  # copy; never corrupt the caller's buffer in place
        mv = np.moveaxis(out, worker_axis, 0)  # view: writes go through
        for w in workers:
            if not 0 <= w < mv.shape[0]:
                continue
            mv[w] = self.corrupt_payload(np.asarray(mv[w]), w, round_idx)
        return out

    def corrupt_payload(self, arr: np.ndarray, worker: int,
                        round_idx: int) -> np.ndarray:
        """The garbage one corrupt worker ships for this round.

        Keyed by ``(seed, round, worker)`` only, so the simulated service
        path and the measured thread runtime inject the same noise."""
        rng = np.random.default_rng((self.plan.seed, round_idx, worker))
        scale = max(float(np.abs(arr).max()), 1.0)
        noise = rng.standard_normal(arr.shape)
        if np.iscomplexobj(arr):
            noise = noise + 1j * rng.standard_normal(arr.shape)
        return (noise * (7.3 * scale)).astype(arr.dtype)

    def corrupt_flags(self, n_workers: int, round_idx: int) -> np.ndarray:
        """Boolean ``(n_workers,)`` corrupt mask for in-trace injection."""
        flags = np.zeros(n_workers, dtype=bool)
        for w in self.faults_for(round_idx).corrupt:
            if w < n_workers:
                flags[w] = True
        return flags

    def perturb_latencies(self, lat: np.ndarray, round_idx: int) -> np.ndarray:
        """Fold kill/delay faults into completion times ``(..., n_workers)``.

        Killed workers never finish (``inf``); delayed workers finish late.
        """
        rf = self.faults_for(round_idx)
        if not rf.any:
            return lat
        out = np.array(lat, dtype=np.float64)
        n = out.shape[-1]
        for w, d in rf.delays:
            if w < n:
                out[..., w] += d
        for w in rf.killed:
            if w < n:
                out[..., w] = np.inf
        return out
