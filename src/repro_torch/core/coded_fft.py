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
``CodedFFTND`` and ``plan_factors`` are a later slice of the port.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from repro_torch.core import mds
from repro_torch.core.plan import MDSPlanBase, resolve_device
from repro_torch.core.recombine import recombine
from repro_torch.kernels import ops

__all__ = ["CodedFFT"]


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
