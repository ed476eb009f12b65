"""Per-worker health tracking, deadline-derived masks, model calibration.

A real master does not know the straggler distribution: it observes
completion times and must decide, per round, how long to wait.
``WorkerHealthTracker`` is that decision state:

* ``observe`` / ``observe_round`` feed measured (or injected-simulation)
  per-worker completion times into per-worker EWMAs plus running min /
  mean / count aggregates.
* ``deadline(m)`` derives the round's wait budget: the m-th fastest
  *estimated* completion time times ``1 + slack_frac``.  The availability
  mask is then simply ``times <= deadline`` (``mask_from_times``) -- a
  mechanism (measured arrival vs deadline) rather than a simulator input.
* Workers whose corrupted output was caught by the Byzantine verifier
  are flagged via ``flag_byzantine``; flagged workers are excluded from
  re-dispatch targets and reported in ``summary()``.
* ``calibrate`` fits the shifted-exponential ``StragglerModel`` (t0, mu)
  from the observed aggregates by moment matching -- for ``T = w*(t0 +
  Exp(mu))``, ``min T -> w*t0`` and ``mean T - min T -> w/mu``.

The tracker is plain numpy and cheap (O(N) per round), the JAX package's
tracker line for line; the service owns one per ``FFTService`` and the
measured worker runtime shares it.  ``fragment_mask_from_times`` gates
each fragment of a partial-work worker on its own.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.distributed.straggler import StragglerModel

__all__ = ["WorkerHealthTracker"]


class WorkerHealthTracker:
    """EWMA completion-time state for ``n_workers`` slots.

    ``alpha``: EWMA smoothing factor (weight of the newest sample).
    ``slack_frac``: deadline headroom over the m-th fastest estimate.
    ``default_s``: prior completion-time estimate used for slots with no
    observations yet (also the bootstrap deadline scale of round 0).
    """

    def __init__(self, n_workers: int, *, alpha: float = 0.2,
                 slack_frac: float = 0.5, default_s: float = 1e-3):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        if slack_frac < 0.0:
            raise ValueError("slack_frac must be >= 0")
        self.alpha = float(alpha)
        self.slack_frac = float(slack_frac)
        self.default_s = float(default_s)
        self._ewma = np.full(n_workers, np.nan)
        self._min = np.full(n_workers, np.inf)
        self._sum = np.zeros(n_workers)
        self._count = np.zeros(n_workers, dtype=np.int64)
        self._missed = np.zeros(n_workers, dtype=np.int64)
        self._byzantine = np.zeros(n_workers, dtype=bool)
        self.rounds = 0

    # -- sizing -----------------------------------------------------------
    @property
    def n_workers(self) -> int:
        return int(self._ewma.shape[0])

    def grow(self, n_workers: int) -> None:
        """Extend state to ``n_workers`` slots (elastic joins keep history)."""
        extra = n_workers - self.n_workers
        if extra <= 0:
            return
        self._ewma = np.concatenate([self._ewma, np.full(extra, np.nan)])
        self._min = np.concatenate([self._min, np.full(extra, np.inf)])
        self._sum = np.concatenate([self._sum, np.zeros(extra)])
        self._count = np.concatenate([self._count, np.zeros(extra, np.int64)])
        self._missed = np.concatenate([self._missed, np.zeros(extra, np.int64)])
        self._byzantine = np.concatenate([self._byzantine, np.zeros(extra, bool)])

    # -- observations -----------------------------------------------------
    def observe(self, worker: int, seconds: float) -> None:
        """Record one measured completion time for ``worker``."""
        if not (0 <= worker < self.n_workers):
            raise IndexError(f"worker {worker} out of range")
        if not math.isfinite(seconds) or seconds < 0:
            return
        prev = self._ewma[worker]
        self._ewma[worker] = (seconds if np.isnan(prev)
                              else (1 - self.alpha) * prev + self.alpha * seconds)
        self._min[worker] = min(self._min[worker], seconds)
        self._sum[worker] += seconds
        self._count[worker] += 1

    def observe_round(self, times: Sequence[float]) -> None:
        """Record one round: per-worker times, NaN/inf = did not respond."""
        times = np.asarray(times, dtype=np.float64)
        if times.shape != (self.n_workers,):
            raise ValueError(f"expected ({self.n_workers},) times, got {times.shape}")
        for w in range(self.n_workers):
            t = times[w]
            if math.isfinite(t):
                self.observe(w, float(t))
            else:
                self._missed[w] += 1
        self.rounds += 1

    def flag_byzantine(self, worker: int) -> None:
        self._byzantine[worker] = True

    def clear_byzantine(self, worker: int) -> None:
        self._byzantine[worker] = False

    @property
    def byzantine(self) -> np.ndarray:
        return self._byzantine.copy()

    # -- derived state ----------------------------------------------------
    def estimates(self) -> np.ndarray:
        """Per-worker completion-time estimates (prior where unobserved).

        A slot that has ONLY ever missed is estimated infinitely slow:
        letting the fast default prior stand for a dead worker would drag
        the m-th-fastest deadline below what any live worker can meet.
        """
        est = np.where(np.isnan(self._ewma), self.default_s, self._ewma)
        never = (self._count == 0) & (self._missed > 0)
        return np.where(never, np.inf, est).astype(np.float64)

    def deadline(self, m: int, *, alive: Optional[np.ndarray] = None) -> float:
        """Wait budget for a round needing ``m`` responses.

        The m-th fastest estimated completion among ``alive`` workers,
        stretched by ``1 + slack_frac``.  Monotone in the estimates, so a
        slowing fleet automatically relaxes the deadline while a healthy
        one keeps it tight.
        """
        est = self.estimates()
        if alive is not None:
            alive = np.asarray(alive, dtype=bool)
            est = est[alive[: est.shape[0]]]
        if est.shape[0] < m:
            return float("inf")
        kth = float(np.sort(est)[m - 1])
        return kth * (1.0 + self.slack_frac)

    def mask_from_times(self, times: np.ndarray, deadline: float) -> np.ndarray:
        """Availability mask: measured arrival beat the deadline."""
        times = np.asarray(times, dtype=np.float64)
        with np.errstate(invalid="ignore"):
            return np.where(np.isfinite(times), times <= deadline, False)

    def fragment_mask_from_times(self, times: np.ndarray, deadline: float,
                                 fractions: Sequence[float]) -> np.ndarray:
        """Per-fragment availability for partial-work plans.

        A partial-work worker emits fragment ``f`` at ``times * fractions
        [f]`` of its full-shard completion (fragments are sequential, so
        ``fractions`` is increasing, e.g. ``(f+1)/r``).  The deadline then
        gates each fragment separately: a worker that misses the round
        deadline overall still lands the prefix of fragments whose scaled
        times beat it.  ``times``: ``(..., N)`` -> mask ``(..., N, F)``.
        """
        times = np.asarray(times, dtype=np.float64)
        ft = times[..., None] * np.asarray(fractions, dtype=np.float64)
        with np.errstate(invalid="ignore"):
            return np.where(np.isfinite(ft), ft <= deadline, False)

    # -- calibration ------------------------------------------------------
    def calibrate(self, workload: float = 1.0, *,
                  wire_frac: float = 0.0) -> StragglerModel:
        """Fit a StragglerModel (t0, mu) from the observed aggregates.

        Moment matching on the pooled samples of ``T = w*(t0 + Exp(mu))``:
        ``t0_hat = min(T)/w`` and ``mu_hat = w / (mean(T) - min(T))``.
        ``wire_frac`` is pass-through (timing observations cannot split
        compute from wire; callers that know the split provide it).
        """
        seen = self._count > 0
        if not seen.any():
            raise ValueError("no observations to calibrate from")
        total = float(self._sum[seen].sum())
        count = int(self._count[seen].sum())
        t_min = float(self._min[seen].min())
        t_mean = total / count
        t0 = t_min / workload
        tail = max(t_mean - t_min, 1e-12)
        mu = workload / tail
        return StragglerModel(t0=t0, mu=mu, wire_frac=wire_frac)

    def summary(self) -> dict:
        seen = self._count > 0
        return {
            "n_workers": self.n_workers,
            "rounds": self.rounds,
            "observed_workers": int(seen.sum()),
            "ewma_s": [None if np.isnan(v) else float(v) for v in self._ewma],
            "missed": self._missed.tolist(),
            "byzantine": np.flatnonzero(self._byzantine).tolist(),
        }
