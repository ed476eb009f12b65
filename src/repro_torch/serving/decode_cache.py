"""LRU cache of per-straggler-mask MDS decode matrices.

The service's host decode-matrix path: taken when a config pins
``device_decode=False``, or picks a code wider than the closed-form
Lagrange decode serves (``m > mds.LAGRANGE_MAX_M``), where f32 planes
cannot carry the subset inverse's conditioning and a complex128 host
inverse is the right tool.

Each request of a bucket contributes its own ``(m, N)`` *scatter decode
matrix* ``D`` with ``D[:, subset] = inv(G[subset, :])`` and zero columns
elsewhere, so that ``c_hat = D @ b`` recovers the message shards from the
full worker-result block without gathering responder rows first.

Straggler masks repeat heavily under any realistic latency model (the
same fast workers keep winning), so the ``O(m^3)`` subset inversion is
cached, keyed by the mask byte pattern.  Inverses are computed once in
complex128 on the host and cast to complex64 for the f32 planes; a novel
mask pays one host inversion and then hits the cache until evicted by
churn, after which it is recomputed, never answered wrongly.

numpy only: the same class as the JAX package's
``serving/decode_cache.py``, so a same-seed service of either package
counts the same hits and misses.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

__all__ = ["DecodeMatrixCache"]


class DecodeMatrixCache:
    """LRU of straggler-mask byte patterns -> ``(m, N)`` decode matrices.

    One cache per ``(N, m)`` generator: the generator (hence every
    per-mask matrix) does not depend on the transform length or the
    bucket kind, so the service shares one instance across all its
    ``(s, kind)`` buckets, and a mask seen in any bucket is a hit in every
    other.  Keying is strictly by mask byte pattern: two masks equal as
    first-``m`` subsets but different as patterns occupy distinct entries.
    ``maxsize`` bounds host memory at ``maxsize * m * N * 8`` bytes.
    """

    def __init__(self, generator: np.ndarray, maxsize: int = 64):
        g = np.asarray(generator)
        self.generator = g.astype(np.complex128)
        self.n, self.m = g.shape
        self.maxsize = int(maxsize)
        if self.maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.hits = 0
        self.misses = 0
        # mask bytes -> (scatter (m, N), inv (m, m), subset (m,))
        self._store: OrderedDict[bytes, tuple] = OrderedDict()

    def __len__(self) -> int:
        return len(self._store)

    @staticmethod
    def subset_of(mask: np.ndarray, m: int) -> np.ndarray:
        """First ``m`` available workers in index order (a stable
        argsort): the subset the decode inverts."""
        mask = np.asarray(mask, bool)
        order = np.argsort(~mask, kind="stable")
        return order[:m]

    def _entry(self, mask: np.ndarray) -> tuple:
        mask = np.asarray(mask, bool)
        if mask.shape != (self.n,):
            raise ValueError(f"mask must have shape ({self.n},), got "
                             f"{mask.shape}")
        key = mask.tobytes()
        cached = self._store.get(key)
        if cached is not None:
            self.hits += 1
            self._store.move_to_end(key)
            return cached
        self.misses += 1
        entry = self._compute(mask)
        self._store[key] = entry
        if len(self._store) > self.maxsize:
            self._store.popitem(last=False)
        return entry

    def matrix(self, mask: np.ndarray) -> np.ndarray:
        """The ``(m, N)`` complex64 scatter decode matrix for ``mask``."""
        return self._entry(mask)[0]

    def matrices(self, masks: np.ndarray) -> np.ndarray:
        """Stacked ``(B, m, N)`` scatter decode matrices for a bucket."""
        return np.stack([self.matrix(row) for row in np.asarray(masks, bool)])

    def compact(self, masks: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Stacked ``(B, m, m)`` compact inverses + ``(B, m)`` subsets:
        the gather-then-matmul form of the same decode."""
        entries = [self._entry(row) for row in np.asarray(masks, bool)]
        return (np.stack([e[1] for e in entries]),
                np.stack([e[2] for e in entries]))

    def _compute(self, mask: np.ndarray) -> tuple:
        if int(mask.sum()) < self.m:
            raise ValueError(
                f"need >= m={self.m} responders, mask has {int(mask.sum())}")
        subset = self.subset_of(mask, self.m)
        inv = np.linalg.inv(self.generator[subset, :])
        d = np.zeros((self.m, self.n), np.complex128)
        d[:, subset] = inv
        return (d.astype(np.complex64), inv.astype(np.complex64),
                subset.astype(np.int32))
