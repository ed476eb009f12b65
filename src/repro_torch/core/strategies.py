"""Baseline computation strategies compared against coded FFT (Remark 4),
and the strategy registry.

The paper's comparison:

* **coded FFT** (this work):          K* = m
* **uncoded repetition**:             K  = N - N/m^2 + 1
* **short-dot / short-MDS [9],[13]**: K  = N - N/m + m

Uncoded repetition is implemented in full: without the DFT's recursive
structure, the generic approach block-partitions the DFT *matrix* into an
m x m grid -- worker w stores one contiguous input chunk ``x_j`` (1/m of
the input) and returns one partial product ``P_ij = F_ij @ x_j`` (s/m
outputs).  The master must collect ALL m^2 distinct blocks; with each
block replicated N/m^2 times, an adversary can erase every copy of one
block using only N/m^2 erasures, so the worst-case threshold is
``N - N/m^2 + 1`` exactly.  Short-dot is reported analytically.

``UncodedRepetitionFFT`` satisfies the :class:`CodedPlan` protocol but
not ``MDSPlan``: its replication code is not subset-decodable.  Its
worker applies the dense (s/m)^2 DFT blocks with ``torch.matmul``, and
its decode assembles blocks on the host's index logic.

The registry maps one name to a factory and an applicability predicate
for every computation strategy: ``FFTService(strategy=...)`` resolves its
bucket plans here, and the tests verify every entry.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.core.coded_fft import CodedFFT
from repro_torch.core.comm_efficient import CodedCommEffFFT
from repro_torch.core.partial import CodedPartialFFT
from repro_torch.core.plan import batch_shape, resolve_device

__all__ = [
    "UncodedRepetitionFFT",
    "CodedPartialFFT",
    "CodedCommEffFFT",
    "StrategyEntry",
    "REGISTRY",
    "register_strategy",
    "make_strategy",
    "coded_fft_threshold",
    "repetition_threshold",
    "short_dot_threshold",
]


def coded_fft_threshold(n: int, m: int) -> int:
    """Theorem 1: K* = m."""
    return m


def repetition_threshold(n: int, m: int) -> int:
    """Remark 4: uncoded repetition needs N - N/m^2 + 1 (worst case)."""
    assert n % (m * m) == 0, "repetition baseline needs m^2 | N"
    return n - n // (m * m) + 1


def short_dot_threshold(n: int, m: int) -> int:
    """Remark 4: short-dot / short-MDS [9],[13] needs N - N/m + m."""
    assert n % m == 0
    return n - n // m + m


def _host_mask(mask) -> np.ndarray:
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    return np.asarray(mask).astype(bool)


@dataclasses.dataclass(frozen=True)
class UncodedRepetitionFFT:
    """Generic block-partitioned DFT with replication (no coding).

    N workers, m^2 | N.  Worker ``w`` is assigned block
    ``(i, j) = divmod(w % m^2, m)`` -- it stores input chunk ``x_j``
    (contiguous, length s/m) and computes ``P_ij = F[i-block, j-block] @
    x_j``.  ``device=None`` means CUDA, and raises when there is none.
    """

    s: int
    m: int
    n_workers: int
    dtype: torch.dtype = torch.complex64
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.s % self.m != 0:
            raise ValueError("m | s required")
        if self.n_workers % (self.m * self.m) != 0:
            raise ValueError("m^2 | N required for the repetition baseline")
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def shard_len(self) -> int:
        return self.s // self.m

    @property
    def n_blocks(self) -> int:
        return self.m * self.m

    @property
    def replicas(self) -> int:
        return self.n_workers // self.n_blocks

    # -- CodedPlan shape metadata --------------------------------------------
    @property
    def input_shape(self) -> tuple[int, ...]:
        return (self.s,)

    @property
    def output_shape(self) -> tuple[int, ...]:
        return (self.s,)

    @property
    def worker_shard_shape(self) -> tuple[int, ...]:
        return (self.shard_len,)

    @property
    def recovery_threshold(self) -> int:
        """Worst-case threshold (Remark 4) -- contrast with MDS plans' m."""
        return self.worst_case_threshold()

    def block_of_worker(self, w: int) -> tuple[int, int]:
        return divmod(w % self.n_blocks, self.m)

    def _dft_block(self, i: int, j: int) -> np.ndarray:
        ell = self.shard_len
        rows = np.arange(i * ell, (i + 1) * ell)
        cols = np.arange(j * ell, (j + 1) * ell)
        return np.exp(-2j * np.pi * (np.outer(rows, cols) % self.s) / self.s)

    @functools.cached_property
    def _worker_blocks(self) -> torch.Tensor:
        """Stacked per-worker DFT blocks, shape (N, s/m, s/m): one block
        per distinct (i, j), gathered per worker."""
        blocks = torch.stack([
            torch.as_tensor(self._dft_block(i, j), device=self.device)
            .to(self.dtype)
            for i in range(self.m) for j in range(self.m)])
        idx = torch.as_tensor([w % self.n_blocks
                               for w in range(self.n_workers)],
                              device=self.device)
        return blocks[idx]

    @functools.cached_property
    def _chunk_of_worker(self) -> torch.Tensor:
        return torch.as_tensor(
            [self.block_of_worker(w)[1] for w in range(self.n_workers)],
            device=self.device)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Worker storage ``(*B, N, s/m)`` -- worker w stores chunk x_{j_w}."""
        x = torch.as_tensor(x, device=self.device).to(self.dtype)
        chunks = x.reshape(tuple(x.shape[:-1]) + (self.m, self.shard_len))
        return chunks[..., self._chunk_of_worker, :]

    def worker_compute(self, a: torch.Tensor) -> torch.Tensor:
        """Worker w returns F_{i_w, j_w} @ x_{j_w}; leading axes map
        through (one ``torch.matmul`` over every worker)."""
        a = torch.as_tensor(a, device=self.device)
        return torch.matmul(self._worker_blocks.to(a.dtype),
                            a[..., None])[..., 0]

    def decodable(self, mask) -> bool:
        """Master can finish iff every (i, j) block has >= 1 live replica."""
        got = {self.block_of_worker(int(w))
               for w in np.nonzero(_host_mask(mask))[0]}
        return len(got) == self.n_blocks

    def decode(self, b: torch.Tensor, subset=None, mask=None
               ) -> torch.Tensor:
        """Assemble X from one live replica per block.

        ``b``: ``(*B, N, s/m)`` worker results; ``mask``: ``(N,)`` or
        ``(*B, N)`` availability (``subset`` of responder ids is accepted
        for protocol uniformity and converted to a mask).  Raises if any
        block lost all replicas.
        """
        if subset is not None:
            if mask is not None:
                raise ValueError("pass at most one of subset / mask")
            if isinstance(subset, torch.Tensor):
                subset = subset.cpu().numpy()
            mask = np.zeros(self.n_workers, bool)
            mask[np.asarray(subset)] = True
        mask = (np.ones(self.n_workers, bool) if mask is None
                else _host_mask(mask))
        b = torch.as_tensor(b, device=self.device)
        batch = batch_shape(b, 2, "worker results")
        if not batch:
            return self._decode1(b, mask)
        flat = b.reshape((-1,) + tuple(b.shape[len(batch):]))
        masks = np.broadcast_to(mask, batch + (self.n_workers,)).reshape(
            flat.shape[0], -1)
        out = torch.stack([self._decode1(bi, mi)
                           for bi, mi in zip(flat, masks)])
        return out.reshape(batch + (self.s,))

    def _decode1(self, b: torch.Tensor, mask: np.ndarray) -> torch.Tensor:
        if not self.decodable(mask):
            raise ValueError(
                "not enough workers responded: some block missing")
        ell = self.shard_len
        x_out = torch.zeros(self.s, dtype=self.dtype, device=self.device)
        seen = set()
        for w in np.nonzero(mask)[0]:
            i, j = self.block_of_worker(int(w))
            if (i, j) in seen:
                continue
            seen.add((i, j))
            x_out[i * ell:(i + 1) * ell] += b[int(w)].to(self.dtype)
        return x_out

    def run(self, x: torch.Tensor, subset=None, mask=None) -> torch.Tensor:
        return self.decode(self.worker_compute(self.encode(x)),
                           subset=subset, mask=mask)

    # -- empirical threshold verification ------------------------------------
    def worst_case_threshold(self) -> int:
        """Smallest k such that EVERY k-subset is decodable: the adversary
        kills all replicas of one block (N/m^2 workers), so the threshold
        is N - N/m^2 + 1."""
        return self.n_workers - self.replicas + 1

    def is_k_recoverable(self, k: int,
                         subsets: Optional[Iterable] = None) -> bool:
        """Check decodability of every k-subset (exhaustive -- small N
        only)."""
        if subsets is None:
            subsets = itertools.combinations(range(self.n_workers), k)
        for sub in subsets:
            mask = np.zeros(self.n_workers, bool)
            mask[list(sub)] = True
            if not self.decodable(mask):
                return False
        return True


# -- the strategy registry ---------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StrategyEntry:
    """One computation strategy the runtime can execute.

    ``factory(s, m, n_workers, *, dtype, backend, param, device)`` builds
    the plan (``param`` is the strategy's own knob -- ``r`` fragments for
    partial, ``q`` fold for comm-efficient -- ``None`` means the entry's
    default).  ``applicable(s, m, n_workers, param)`` is the cheap
    predicate the service's bucket selection and the tests filter on; the
    factory's own ValueError stays the authoritative gate.
    """

    name: str
    factory: Callable
    applicable: Callable[[int, int, int, Optional[int]], bool]
    default_param: Optional[int] = None
    kernel_ok: bool = False
    mesh_ok: bool = True
    description: str = ""

    def build(self, s: int, m: int, n_workers: int, *,
              dtype=torch.complex64, backend: str = "reference",
              param: Optional[int] = None, device=None):
        return self.factory(s, m, n_workers, dtype=dtype, backend=backend,
                            param=self.default_param if param is None
                            else param, device=device)


REGISTRY: dict[str, StrategyEntry] = {}


def register_strategy(entry: StrategyEntry) -> StrategyEntry:
    if entry.name in REGISTRY:
        raise ValueError(f"strategy {entry.name!r} already registered")
    REGISTRY[entry.name] = entry
    return entry


def make_strategy(name: str, s: int, m: int, n_workers: int, *,
                  dtype=torch.complex64, backend: str = "reference",
                  param: Optional[int] = None, device=None):
    """Build a registered strategy's plan; raises KeyError on unknown
    names and the plan's own ValueError on inapplicable (s, m, N)."""
    if name not in REGISTRY:
        raise KeyError(
            f"unknown strategy {name!r}; registered: {sorted(REGISTRY)}")
    return REGISTRY[name].build(s, m, n_workers, dtype=dtype,
                                backend=backend, param=param, device=device)


register_strategy(StrategyEntry(
    name="mds",
    factory=lambda s, m, n, *, dtype, backend, param, device: CodedFFT(
        s, m, n, dtype=dtype, backend=backend, device=device),
    applicable=lambda s, m, n, param: s % m == 0 and n >= m,
    kernel_ok=True,
    mesh_ok=True,
    description="the paper's (N, m) MDS code: threshold m (optimal), "
                "full s/m payload per worker",
))

register_strategy(StrategyEntry(
    name="partial",
    factory=lambda s, m, n, *, dtype, backend, param, device:
        CodedPartialFFT(s, m, n, r=param, dtype=dtype, backend=backend,
                        device=device),
    applicable=lambda s, m, n, param:
        s % (m * (param or 2)) == 0 and n >= m,
    default_param=2,
    kernel_ok=False,
    mesh_ok=True,
    description="Wang et al. 1804.09791: r sequentially-useful fragments "
                "per worker, decode from any m*r fragments -- slow-but-"
                "alive workers contribute prefixes",
))

register_strategy(StrategyEntry(
    name="comm_efficient",
    factory=lambda s, m, n, *, dtype, backend, param, device:
        CodedCommEffFFT(s, m, n, q=param, dtype=dtype, backend=backend,
                        device=device),
    applicable=lambda s, m, n, param:
        s % m == 0 and (s // m) % (param or 2) == 0
        and n >= m * (param or 2),
    default_param=2,
    kernel_ok=False,
    mesh_ok=True,
    description="Jeong et al. 1805.09891: ship a 1/q folded payload "
                "(payload_scale 1/q) at threshold m*q -- wins when the "
                "wire dominates",
))

register_strategy(StrategyEntry(
    name="repetition",
    factory=lambda s, m, n, *, dtype, backend, param, device:
        UncodedRepetitionFFT(s, m, n, dtype=dtype, device=device),
    applicable=lambda s, m, n, param: s % m == 0 and n % (m * m) == 0,
    kernel_ok=False,
    mesh_ok=False,
    description="Remark-4 uncoded baseline: block-partitioned DFT with "
                "replication, worst-case threshold N - N/m^2 + 1",
))
