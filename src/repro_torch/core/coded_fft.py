"""Coded FFT -- the paper's optimal computation strategy (Theorem 1).

Pipeline (paper §III-B):

  1. ``interleave``     : x -> (c_0, ..., c_{m-1}),  c_i[j] = x[i + j*m]
  2. ``encode``         : (N, m)-MDS code over the shards -> a_0..a_{N-1}
  3. ``worker_compute`` : b_k = DFT_{s/m}(a_k)
  4. ``decode``         : any m of the b_k -> all C_i = DFT(c_i)
  5. ``recombine``      : twiddle + length-m DFTs -> X

The recovery threshold is exactly ``m``.  On the default kernel backend
(complex64) the encode and the unbatched decode run the ``cmatmul``
kernel and the worker the four-step kernels (``kernels/ops.py``).
:class:`CodedFFTND` is the n-D plan (paper Theorem 3): the n-D
interleave, the same code, the four-step kernels swept over each shard
axis, and the n-D recombine; :func:`plan_factors` splits ``m`` across
the axes.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import torch

from repro_torch.core import mds
from repro_torch.core.interleave import interleave_nd
from repro_torch.core.plan import MDSPlanBase, resolve_device
from repro_torch.core.recombine import recombine, recombine_nd
from repro_torch.core.rfft import require_even_shards
from repro_torch.kernels import ops

__all__ = ["CodedFFT", "CodedFFTND", "plan_factors"]


def _default_fft(a: torch.Tensor) -> torch.Tensor:
    """Reference worker computation: length-L FFT along the last axis."""
    return torch.fft.fft(a, dim=-1)


@dataclasses.dataclass(frozen=True)
class CodedFFT(MDSPlanBase):
    """1-D coded FFT computation strategy.

    Args:
      s: transform length.
      m: storage fraction parameter -- each worker stores/processes s/m.
      n_workers: N >= m workers.
      dtype: complex dtype of the computation.
      worker_fn: explicit per-worker DFT plug-in; must transform the LAST
        axis and map over any leading axes.  ``None`` (default)
        dispatches on ``backend``: the four-step kernels for complex64
        plans, ``torch.fft.fft`` otherwise.
      backend: ``"kernel"`` (default; complex64 only) or ``"reference"``.
      device: where the plan computes; ``None`` means CUDA, and raises when
        there is none (pass ``"cpu"`` to run the plain versions).
    """

    s: int
    m: int
    n_workers: int
    dtype: torch.dtype = torch.complex64
    worker_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    backend: str = "kernel"
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.s % self.m != 0:
            raise ValueError(f"m={self.m} must divide s={self.s}")
        if self.n_workers < self.m:
            raise ValueError(f"need N >= m for recoverability, got "
                             f"N={self.n_workers} m={self.m}")
        if self.backend not in ("kernel", "reference"):
            raise ValueError(f"unknown backend {self.backend!r}")
        object.__setattr__(self, "device", resolve_device(self.device))
        self._check_kernel_code()

    @property
    def shard_len(self) -> int:
        return self.s // self.m

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
        """Theorem 1: K* = m."""
        return self.m

    @functools.cached_property
    def generator(self) -> torch.Tensor:
        return mds.rs_generator(self.n_workers, self.m, self.dtype,
                                self.device)

    # -- batched stage cores -------------------------------------------------
    def _message(self, x: torch.Tensor) -> torch.Tensor:
        # c_i[j] = x[i + j*m] on the last axis: (*B, s) -> (*B, m, L)
        lead = tuple(x.shape[:-1])
        return x.reshape(lead + (self.shard_len, self.m)).transpose(-1, -2)

    def _postdecode(self, c_hat: torch.Tensor) -> torch.Tensor:
        return recombine(c_hat, self.s)

    # back-compat alias: `encode` IS the fast path
    def encode_fast(self, x: torch.Tensor) -> torch.Tensor:
        """O(N log N)-per-column encode (alias of :meth:`encode`)."""
        return self.encode(x)

    # -- stage 3: worker computation -----------------------------------------
    @property
    def resolved_worker_fn(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """The active worker: explicit plug-in > kernel backend > torch."""
        if self.worker_fn is not None:
            return self.worker_fn
        if self.resolved_backend == "kernel":
            return ops.make_kernel_worker_fn()
        return _default_fft

    def worker_compute(self, a: torch.Tensor) -> torch.Tensor:
        """Each worker FFTs its own coded shard; any leading axes allowed."""
        return self.resolved_worker_fn(self._as_tensor(a))


def plan_factors(shape: tuple[int, ...], m: int,
                 even_last_shard: bool = False) -> tuple[int, ...]:
    """Pick per-axis interleave factors with ``prod(m_k) = m``,
    ``m_k | s_k``.

    Greedy: peel the prime factors of ``m`` off, largest first, each onto
    the axis with the largest remaining quotient that admits it (the
    first such axis on a tie).  Raises ValueError where ``m`` cannot be
    factored across the axes.

    ``even_last_shard=True`` (the real n-D kinds) places the factors on
    the shape with its LAST axis halved, so the result satisfies the
    pair-packing constraint ``2 * factors[-1] | shape[-1]`` wherever a
    valid placement exists.  It needs an even last axis (the ``2m | s``
    ValueError otherwise).
    """
    if even_last_shard:
        if shape[-1] % 2 != 0:
            require_even_shards(shape[-1], 1, axis=len(shape) - 1)
        return plan_factors(tuple(shape[:-1]) + (shape[-1] // 2,), m)
    factors = [1] * len(shape)
    caps = list(shape)
    primes = []
    d, r = 2, m
    while d * d <= r:
        while r % d == 0:
            primes.append(d)
            r //= d
        d += 1
    if r > 1:
        primes.append(r)
    for p in sorted(primes, reverse=True):
        best = None
        for k in range(len(shape)):
            if caps[k] % (factors[k] * p) == 0:
                q = caps[k] // (factors[k] * p)
                if best is None or q > best[1]:
                    best = (k, q)
        if best is None:
            raise ValueError(f"cannot split m={m} across shape {shape}")
        factors[best[0]] *= p
    assert math.prod(factors) == m
    return tuple(factors)


@dataclasses.dataclass(frozen=True)
class CodedFFTND(MDSPlanBase):
    """n-D coded FFT (paper Theorem 3): ``(*B, *shape)`` complex ->
    ``(*B, *shape)``, ``fftn`` over the trailing axes.

    ``factors[k]`` divides ``shape[k]`` and ``prod(factors) = m``.  Each
    worker holds one coded ``(s_0/m_0, ..., s_{n-1}/m_{n-1})`` shard; on
    the kernel backend (complex64) its n-D FFT is the four-step kernels
    swept over each shard axis (``ops.make_kernel_fftn_fn``).
    ``device=None`` means CUDA, and raises when there is none.
    """

    shape: tuple[int, ...]
    factors: tuple[int, ...]
    n_workers: int
    dtype: torch.dtype = torch.complex64
    backend: str = "kernel"
    device: Optional[torch.device] = None

    def __post_init__(self):
        if len(self.shape) != len(self.factors):
            raise ValueError(
                f"factors {self.factors} must match shape {self.shape}")
        for sk, mk in zip(self.shape, self.factors):
            if mk < 1 or sk % mk != 0:
                raise ValueError(f"factor {mk} must divide dim {sk}")
        if self.n_workers < self.m:
            raise ValueError(f"need N >= m, got N={self.n_workers} "
                             f"m={self.m}")
        if self.backend not in ("kernel", "reference"):
            raise ValueError(f"unknown backend {self.backend!r}")
        object.__setattr__(self, "shape", tuple(self.shape))
        object.__setattr__(self, "factors", tuple(self.factors))
        object.__setattr__(self, "device", resolve_device(self.device))
        self._check_kernel_code()

    @property
    def m(self) -> int:
        return math.prod(self.factors)

    @property
    def shard_shape(self) -> tuple[int, ...]:
        return tuple(sk // mk for sk, mk in zip(self.shape, self.factors))

    @property
    def input_shape(self) -> tuple[int, ...]:
        return self.shape

    @property
    def output_shape(self) -> tuple[int, ...]:
        return self.shape

    @property
    def worker_shard_shape(self) -> tuple[int, ...]:
        return self.shard_shape

    @property
    def recovery_threshold(self) -> int:
        return self.m

    @functools.cached_property
    def generator(self) -> torch.Tensor:
        return mds.rs_generator(self.n_workers, self.m, self.dtype,
                                self.device)

    def _message(self, t: torch.Tensor) -> torch.Tensor:
        return interleave_nd(t, self.factors)        # (*B, m, *shard)

    def _postdecode(self, c_hat: torch.Tensor) -> torch.Tensor:
        return recombine_nd(c_hat, self.shape, self.factors)

    def worker_compute(self, a: torch.Tensor) -> torch.Tensor:
        """n-D FFT of each coded tensor over the trailing shard axes."""
        return self._fftn_worker(a, len(self.shape))
