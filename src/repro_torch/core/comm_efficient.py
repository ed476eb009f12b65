"""Communication-efficient coded FFT: trade recovery threshold for wire.

Jeong et al. (arXiv 1805.09891) observe that in the MDS construction each
worker ships its FULL transformed shard (s/m symbols) even though the
master only needs s in total -- when the wire, not the FLOPs, is the
bottleneck, the coded round pays an m-fold communication overhead.  Their
fix: each worker FOLDS its result before shipping, sending ``1/q`` of the
payload, at the price of a higher recovery threshold ``m*q``.

Construction, on top of the (N, m) coded-FFT pipeline:

  1. encode as :class:`~repro_torch.core.coded_fft.CodedFFT`: worker ``k``
     stores ``a_k = sum_i omega_N^{ki} c_i`` (length ``L = s/m``);
  2. worker ``k`` computes ``b_k = fft(a_k)``, splits it into ``q``
     contiguous blocks ``b_k^{(t)}`` of length ``L/q``, and ships only
     the fold ``d_k = sum_t omega_N^{k*m*t} b_k^{(t)}`` (L/q symbols);
  3. the fold's exponents ``{i + m*t}`` sweep ``0..m*q-1`` bijectively,
     so ``d_k`` is row ``k`` of the WIDER ``(N, m*q)`` RS code on the
     message ``u_{i+m*t} = C_i^{(t)}`` with ``C_i = fft(c_i)``;
  4. the master decodes ``u`` from ANY ``m*q`` responders (needs
     ``m*q <= N``), un-permutes ``u -> C`` and recombines as usual.

``q = 1`` degenerates to the MDS plan.  Per-worker wire payload is
``L/q`` (``payload_scale = 1/q`` under the straggler model's wire share)
while the threshold rises from ``m`` to ``m*q``.

Decode is :class:`~repro_torch.core.plan.MDSPlanBase`'s through the
``decode_generator`` / ``decode_width`` hooks: on the kernel backend a
single request decodes through ``inv(G'[subset])`` and ``cmatmul`` on
the widened generator, and the worker runs the four-step kernels; the
encode is always the zero-padded DFT, as in the reference.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core import mds
from repro_torch.core.plan import MDSPlanBase, resolve_device
from repro_torch.core.recombine import recombine
from repro_torch.kernels import ops

__all__ = ["CodedCommEffFFT"]


@dataclasses.dataclass(frozen=True)
class CodedCommEffFFT(MDSPlanBase):
    """1-D coded FFT shipping a ``1/q`` folded payload per worker.

    Args:
      s: transform length.
      m: storage fraction parameter -- each worker stores/computes s/m.
      n_workers: N >= m*q workers (the widened code needs m*q rows).
      q: fold factor; per-worker wire payload is ``s/(m*q)`` and the
        recovery threshold is ``m*q``.
      dtype: complex dtype of the computation.
      backend: ``"reference"`` (default) or ``"kernel"``, which runs the
        worker DFT on the four-step kernels and a single request's decode
        on ``cmatmul`` for complex64.
      device: where the plan computes; ``None`` means CUDA, and raises
        when there is none.
    """

    s: int
    m: int
    n_workers: int
    q: int = 2
    dtype: torch.dtype = torch.complex64
    backend: str = "reference"
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.q < 1:
            raise ValueError(f"need q >= 1, got q={self.q}")
        if self.s % self.m != 0:
            raise ValueError(f"m={self.m} must divide s={self.s}")
        if (self.s // self.m) % self.q != 0:
            raise ValueError(
                f"q={self.q} must divide the shard length "
                f"s/m={self.s // self.m} (the fold splits it into q blocks)")
        if self.n_workers < self.m * self.q:
            raise ValueError(
                f"need N >= m*q for recoverability, got N={self.n_workers} "
                f"m*q={self.m * self.q}")
        if self.backend not in ("kernel", "reference"):
            raise ValueError(f"unknown backend {self.backend!r}")
        object.__setattr__(self, "device", resolve_device(self.device))
        self._check_kernel_code()

    def _check_kernel_code(self) -> None:
        """The kernel backend's ``mds_apply`` holds the (m*q, m*q) decode
        matrix (the encode is the DFT)."""
        if self.resolved_backend == "kernel":
            ops.check_stage_code(self.decode_width, self.decode_width,
                                 "CodedCommEffFFT's mds_apply")

    # -- code geometry -------------------------------------------------------
    @property
    def shard_len(self) -> int:
        """Symbols each worker stores and transforms: s/m."""
        return self.s // self.m

    @property
    def payload_len(self) -> int:
        """Symbols each worker SHIPS: s/(m*q)."""
        return self.shard_len // self.q

    @property
    def input_shape(self) -> tuple[int, ...]:
        return (self.s,)

    @property
    def output_shape(self) -> tuple[int, ...]:
        return (self.s,)

    @property
    def worker_shard_shape(self) -> tuple[int, ...]:
        """What a worker SHIPS (the folded payload): the decode's shape."""
        return (self.payload_len,)

    @property
    def stored_shard_shape(self) -> tuple[int, ...]:
        """What a worker STORES and transforms (the full coded shard)."""
        return (self.shard_len,)

    @property
    def recovery_threshold(self) -> int:
        """m*q responders instead of m."""
        return self.m * self.q

    @property
    def payload_scale(self) -> float:
        """1/q of the MDS wire payload per worker."""
        return 1.0 / self.q

    @functools.cached_property
    def generator(self) -> torch.Tensor:
        """The ``(N, m)`` ENCODE generator: storage as in the MDS plan."""
        return mds.rs_generator(self.n_workers, self.m, self.dtype,
                                self.device)

    @functools.cached_property
    def decode_generator(self) -> torch.Tensor:
        """The widened ``(N, m*q)`` system the folded responses are rows
        of (same roots-of-unity nodes, more columns)."""
        return mds.rs_generator(self.n_workers, self.m * self.q, self.dtype,
                                self.device)

    @property
    def decode_width(self) -> int:
        return self.m * self.q

    @property
    def worker_encode_tensor(self) -> torch.Tensor:
        """Per-worker encode rows ``(N, 1, m)`` (one stored fragment per
        worker)."""
        return self.generator[:, None, :]

    @functools.cached_property
    def fold_weights(self) -> torch.Tensor:
        """``(N, q)`` fold coefficients ``omega_N^{k*m*t}``, read off the
        decode generator's columns ``m*t`` so the root convention cannot
        drift from the system decode solves."""
        return self.decode_generator[:, :: self.m]

    # -- stage cores ---------------------------------------------------------
    def _message(self, x: torch.Tensor) -> torch.Tensor:
        # c_i[j] = x[i + j*m] on the last axis: (*B, s) -> (*B, m, L)
        lead = tuple(x.shape[:-1])
        return x.reshape(lead + (self.shard_len, self.m)).transpose(-1, -2)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Input -> stored worker shards ``(*B, N, s/m)``, always the
        zero-padded DFT encode: this plan ships a different shape than it
        stores, which the base plan's kernel branch does not model."""
        c = self.message(x)
        return torch.fft.fft(c, n=self.n_workers, dim=-2).to(self.dtype)

    def worker_compute(self, a: torch.Tensor) -> torch.Tensor:
        """Full per-shard DFT, then the 1/q fold: ``(*B, N, s/m) ->
        (*B, N, s/(m*q))``.  Worker-INDEX-aware (the fold weight is
        ``omega^{kmt}``), so the worker axis must be at -2 spanning all N
        workers; :meth:`worker_compute_rows` serves a subset of rows."""
        return self.worker_compute_rows(
            a, torch.arange(self.n_workers, device=self.device))

    def worker_compute_rows(self, a: torch.Tensor,
                            rows: torch.Tensor) -> torch.Tensor:
        """:meth:`worker_compute` for the workers in ``rows`` only, the row
        axis at -2; returns the same layout with the last axis folded to
        ``s/(m*q)``."""
        b = self._fft1_worker(a)
        blocks = b.reshape(tuple(b.shape[:-1]) + (self.q, self.payload_len))
        w = self.fold_weights[self._as_tensor(rows).long()]
        return torch.einsum("...nql,nq->...nl", blocks, w.to(blocks.dtype))

    def _postdecode(self, u: torch.Tensor) -> torch.Tensor:
        # u[i + m*t] = C_i^{(t)}: un-permute the widened message into the
        # m shard transforms, then the standard twiddle recombine
        lead = tuple(u.shape[:-2])
        c_hat = (u.reshape(lead + (self.q, self.m, self.payload_len))
                 .transpose(-3, -2)
                 .reshape(lead + (self.m, self.shard_len)))
        return recombine(c_hat, self.s)
