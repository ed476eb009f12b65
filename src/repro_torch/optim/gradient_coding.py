"""Coded gradient aggregation: straggler-tolerant data parallelism.

The paper's MDS idea reapplied to the *gradient sum*, in the spirit of
gradient coding (Tandon et al.), as the JAX package's
``optim/gradient_coding.py`` has it.  The global batch is split into N
partitions; worker k computes the gradients of the partitions of its
cyclic support {k, ..., k + s} (mod N) and sends ONE message, their sum
weighted by row k of the coding matrix B.  Any N - s messages combine
linearly into the full-batch gradient sum, so up to s stragglers are
tolerated a step with no information lost.

Gradients are the port's trees: dicts keyed by parameter name (as
``optim.grad_utils`` returns them), or nested dicts and lists of
tensors.  Messages and decodes compute in f32, in the reference's order:
an encode adds the ``B[k, j] * g_j`` terms in support order, a decode
the ``a_i * msg_i`` terms in subset order, each weight a Python float
applied to an f32 tensor (so rounded to f32, as the reference's numpy
weights are with x64 off).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

__all__ = ["CyclicGradientCode", "coded_weights"]


def coded_weights(n_workers: int, n_stragglers: int) -> np.ndarray:
    """(N, N) cyclic coding matrix B (Tandon et al., Algorithm 2 ``B_cyc``).

    Row k has support {k, ..., k + s} (mod N), s = n_stragglers.  Pick a
    random H in R^{s x N} with H @ 1 = 0; choose each row b_k in null(H)
    with the prescribed support (solve the s x s system pinning
    b_k[k] = 1).  Then every row lies in the (N-s)-dim null(H), which
    contains the all-ones vector, and any N-s rows span it generically --
    so EVERY (N-s)-subset of workers can linearly combine to 1^T and
    recover the full gradient sum.  The draws are the JAX package's
    (numpy's ``default_rng(0)``), so B is its matrix bit for bit.
    """
    n, s = n_workers, n_stragglers
    if s == 0:
        return np.eye(n)
    rng = np.random.default_rng(0)
    # H: s x n random Gaussian with columns summing to zero per row
    H = rng.standard_normal((s, n))
    H[:, -1] = -H[:, :-1].sum(axis=1)          # H @ 1 = 0
    B = np.zeros((n, n))
    for k in range(n):
        support = [(k + j) % n for j in range(s + 1)]
        rest = support[1:]
        # b[k]=1; solve H[:, rest] y = -H[:, k]  (s x s, generically
        # invertible)
        y = np.linalg.solve(H[:, rest], -H[:, k])
        B[k, k] = 1.0
        B[k, rest] = y
    return B


def _weighted_sum(weights, trees):
    """sum_i w_i * trees[i], leaf by leaf, the terms added in order, in
    f32 (one leaf's term alive at a time)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _weighted_sum(weights, [t[k] for t in trees])
                for k in first}
    if isinstance(first, (list, tuple)):
        return [_weighted_sum(weights, [t[i] for t in trees])
                for i in range(len(first))]
    out = None
    for w, g in zip(weights, trees):
        term = g.float() * float(w)
        out = term if out is None else out.add_(term)
    return out


@dataclasses.dataclass(frozen=True)
class CyclicGradientCode:
    """Coded gradient aggregation plan: N workers, tolerate s stragglers."""

    n_workers: int
    n_stragglers: int

    def __post_init__(self):
        if not 0 <= self.n_stragglers < self.n_workers:
            raise ValueError("need 0 <= s < N")

    @property
    def recovery_threshold(self) -> int:
        return self.n_workers - self.n_stragglers

    @functools.cached_property
    def matrix(self) -> np.ndarray:
        return coded_weights(self.n_workers, self.n_stragglers)

    def worker_partitions(self, k: int) -> list[int]:
        """Partitions worker k must run (its coded support)."""
        d = self.n_stragglers + 1
        return [(k + j) % self.n_workers for j in range(d)]

    def encode_worker_grad(self, k: int, partition_grads: list):
        """Worker k's message: sum_j B[k,j] * g_j over its support, f32."""
        support = self.worker_partitions(k)
        return _weighted_sum([self.matrix[k, j] for j in support],
                             [partition_grads[j] for j in support])

    def decode_vector(self, subset: np.ndarray) -> np.ndarray:
        """a with a^T B[subset] = 1^T: the aggregation weights for
        ``subset``."""
        B = self.matrix[np.asarray(subset)]
        ones = np.ones(self.n_workers)
        a, res, rank, _ = np.linalg.lstsq(B.T, ones, rcond=None)
        if res.size and res[0] > 1e-12 * self.n_workers:
            raise np.linalg.LinAlgError(
                f"subset {subset} not decodable (residual {res[0]:.2e})")
        # verify exactly (lstsq silently accepts rank-deficient fits)
        if not np.allclose(a @ B, ones, atol=1e-6):
            raise np.linalg.LinAlgError(f"subset {subset} not decodable")
        return a

    def decode(self, subset: np.ndarray, worker_msgs: list):
        """Full-batch gradient sum from any ``recovery_threshold`` messages.

        ``worker_msgs[i]`` is the message of worker ``subset[i]``.
        """
        return _weighted_sum(self.decode_vector(subset), worker_msgs)
