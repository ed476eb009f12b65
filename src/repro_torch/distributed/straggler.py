"""Shifted-exponential straggler model (numpy only).

A worker processing a ``w`` fraction of the input finishes at

    T_i = w * (t0 * (1 - wire_frac + wire_frac * payload_scale) + X_i),
    X_i ~ Exp(rate mu) i.i.d.

``wire_frac`` is the share of ``t0`` spent shipping the result shard back
to the master, scaled by each draw's ``payload_scale`` (inert at the
default 1).  A strategy waiting for the k-th fastest of N workers
completes at the k-th order statistic,

    E[T_(k)] = w * (t0 + (H_N - H_{N-k}) / mu),   H_n = sum_{i<=n} 1/i.

Draws take a caller-owned ``numpy.random.Generator``: the service's draws
are bit-identical to the reference service's for the same seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["StragglerModel", "harmonic", "expected_kth_completion",
           "empirical_completion"]


def harmonic(n: int) -> float:
    return float(np.sum(1.0 / np.arange(1, n + 1))) if n > 0 else 0.0


@dataclasses.dataclass(frozen=True)
class StragglerModel:
    t0: float = 1.0         # deterministic seconds per unit workload
    mu: float = 1.0         # exponential rate of the tail
    wire_frac: float = 0.25  # share of t0 that is result-shipping wire time

    def _t0_eff(self, payload_scale: float) -> float:
        return self.t0 * (1.0 - self.wire_frac
                          + self.wire_frac * payload_scale)

    def sample(self, n, workload: float, rng: np.random.Generator,
               *, payload_scale: float = 1.0) -> np.ndarray:
        """Finish times of workers each processing ``workload`` units.

        ``n``: worker count or a shape tuple (e.g. ``(requests, workers)``
        for one vectorized draw per bucket).
        """
        return workload * (self._t0_eff(payload_scale)
                           + rng.exponential(1.0 / self.mu, size=n))

    def expected_kth(self, n: int, k: int, workload: float,
                     payload_scale: float = 1.0) -> float:
        return expected_kth_completion(
            self._t0_eff(payload_scale), self.mu, n, k, workload)


def expected_kth_completion(t0: float, mu: float, n: int, k: int,
                            workload: float) -> float:
    """E[k-th order statistic of n shifted-exponential finish times]."""
    if k > n:
        return float("inf")
    return workload * (t0 + (harmonic(n) - harmonic(n - k)) / mu)


def empirical_completion(latencies: np.ndarray, k: int) -> float:
    """Completion time waiting for the k fastest workers."""
    if k > latencies.shape[-1]:
        return float("inf")
    return float(np.sort(latencies, axis=-1)[..., k - 1])
