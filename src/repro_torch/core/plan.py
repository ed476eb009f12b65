"""The MDS plan machinery: batched encode / worker / decode / run.

Canonical shapes (``B* = any leading batch axes``):

* ``encode``         : ``(*B, *input_shape) -> (*B, N, *worker_shard_shape)``
* ``worker_compute`` : ``(*B, N, *shard)    -> (*B, N, *shard)``
* ``decode``         : ``(*B, N, *shard)    -> (*B, *output_shape)`` with a
  per-request straggler ``mask`` ``(*B, N)`` or ``subset`` ``(*B, m)``.

Backend rule (as in the reference): plans default to ``backend="kernel"``,
which applies only to complex64 plans; ``complex128`` plans and
``backend="reference"`` resolve to the plain PyTorch path.  The kernel
backend runs the encode as ONE ``mds_apply`` (``cmatmul``) with the batch
folded into the payload columns, the worker on the four-step kernels
(the plan's ``worker_compute``), and the decode of an unbatched request
(or a batch of one) as ``inv(G[subset])`` through ``mds_apply``.  Any
other decode follows the reference's ``decode_auto`` dispatch (see
:meth:`MDSPlanBase.decode`).  A kernel-backend plan refuses at
construction a code whose (N, m) generator ``mds_apply`` cannot hold.
The strategy zoo's partial and communication-efficient plans default to
``backend="reference"`` and always encode with the DFT, as the
reference's do.  The batched service does not use plan stages on its bucket-kernel path
-- it runs the bucket kernels directly.

Every plan satisfies the :class:`CodedPlan` protocol, and the MDS plans
(all but ``UncodedRepetitionFFT``) :class:`MDSPlan`: ``message`` and ``postdecode``
split the master's two stages, so ``encode = encode_dft(message(x))``
and ``decode = postdecode(mds_subset_decode(b))``.
"""

from __future__ import annotations

import math
from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import mds
from repro_torch.kernels import ops

__all__ = ["CodedPlan", "MDSPlan", "MDSPlanBase", "batch_shape",
           "resolve_device"]

_METHODS = ("auto", "solve", "ifft")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  With no GPU, ``device=None`` raises instead of silently
    running the plain versions on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels")
        return torch.device("cuda")
    return torch.device(device)


def batch_shape(arr: torch.Tensor, core_ndim: int,
                what: str) -> tuple[int, ...]:
    """Leading batch dims of ``arr`` given its core (unbatched) rank."""
    extra = arr.ndim - core_ndim
    if extra < 0:
        raise ValueError(
            f"{what} must have rank >= {core_ndim}, got shape "
            f"{tuple(arr.shape)}")
    return tuple(arr.shape[:extra])


@runtime_checkable
class CodedPlan(Protocol):
    """The contract every computation strategy satisfies: ``CodedFFT``,
    ``CodedFFTND`` and ``CodedFFTMultiInput`` (complex), ``CodedRFFT``,
    ``CodedIFFT`` and ``CodedIRFFT`` (1-D real and inverse),
    ``CodedRFFTN`` and ``CodedIRFFTN`` (n-D real), and the strategy zoo's
    ``CodedPartialFFT``, ``CodedCommEffFFT`` and
    ``UncodedRepetitionFFT`` (the one plan that is not an ``MDSPlan``)."""

    n_workers: int

    @property
    def recovery_threshold(self) -> int:
        """How many responders the master waits for (``m`` for every MDS
        plan)."""
        ...

    @property
    def input_shape(self) -> tuple[int, ...]:
        """Core (unbatched) request shape."""
        ...

    @property
    def output_shape(self) -> tuple[int, ...]:
        """Core (unbatched) result shape; the real kinds' differs from
        ``input_shape``."""
        ...

    @property
    def worker_shard_shape(self) -> tuple[int, ...]:
        """What ONE worker stores, transforms and ships."""
        ...

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Input -> coded worker shards ``(*B, N, *worker_shard_shape)``."""
        ...

    def worker_compute(self, a: torch.Tensor) -> torch.Tensor:
        """The per-worker transform over the trailing shard axes."""
        ...

    def decode(self, b, subset=None, mask=None):
        """Worker results -> output from any ``recovery_threshold``
        responders (``subset`` indices or a boolean ``mask``)."""
        ...

    def run(self, x, subset=None, mask=None):
        """``decode(worker_compute(encode(x)))``."""
        ...


@runtime_checkable
class MDSPlan(CodedPlan, Protocol):
    """A plan on the (N, m) complex Reed-Solomon code: decodable from ANY
    ``m`` responders, and split into per-worker encode rows."""

    @property
    def m(self) -> int:
        """Each worker holds ``1/m`` of the input; the recovery
        threshold."""
        ...

    @property
    def generator(self) -> torch.Tensor:
        """The ``(N, m)`` generator ``G[k, i] = omega_N^{ki}``."""
        ...

    def message(self, x: torch.Tensor) -> torch.Tensor:
        """Input -> the ``m`` uncoded message shards."""
        ...

    def postdecode(self, c_hat: torch.Tensor) -> torch.Tensor:
        """Decoded message-shard transforms -> final output."""
        ...


class MDSPlanBase:
    """Shared batched encode/decode/run for the MDS-coded plans.

    Subclasses provide ``n_workers``, ``m``, ``dtype``, ``backend``,
    ``device``, ``generator``, the shape properties, the batched stage
    cores ``_message`` and ``_postdecode``, and a trailing-axes
    ``worker_compute``.
    """

    def _message(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _check_kernel_code(self) -> None:
        """Refuse, on the kernel backend, a code whose (N, m) generator the
        ``mds_apply`` kernel cannot hold (called at construction)."""
        if self.resolved_backend == "kernel":
            ops.check_stage_code(self.n_workers, self.m,
                                 f"{type(self).__name__}'s mds_apply")

    def _postdecode(self, c_hat: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def worker_compute(self, a: torch.Tensor) -> torch.Tensor:
        """Each worker transforms its own coded shard (trailing axes)."""
        raise NotImplementedError

    # -- the decode system ---------------------------------------------------
    @property
    def decode_generator(self) -> torch.Tensor:
        """Generator of the linear system decode solves: the encode
        generator for every MDS plan."""
        return self.generator

    @property
    def decode_width(self) -> int:
        """Responder rows decode needs: the column count of
        ``decode_generator`` (``m``)."""
        return self.m

    def decodable(self, mask=None) -> bool:
        """Host-side check: can the master finish from these responders?
        For an any-subset-decodable code, a count against
        ``recovery_threshold``."""
        if mask is None:
            return self.n_workers >= self.recovery_threshold
        if isinstance(mask, torch.Tensor):
            mask = mask.cpu().numpy()
        return int(np.asarray(mask).sum()) >= self.recovery_threshold

    @property
    def resolved_backend(self) -> str:
        """``"kernel"`` only when requested AND the dtype is complex64."""
        if self.backend == "kernel" and ops.kernel_backend_supported(
                self.dtype):
            return "kernel"
        return "reference"

    def _as_tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _fft1_worker(self, a: torch.Tensor,
                     inverse: bool = False) -> torch.Tensor:
        """Backend-dispatched 1-D (i)FFT along the last axis: the worker
        of the real and inverse plans.  Kernel backend: the four-step
        kernels (``ops.make_kernel_worker_fn``); else ``torch.fft``."""
        a = self._as_tensor(a)
        if self.resolved_backend == "kernel":
            return ops.make_kernel_worker_fn(inverse=inverse)(a)
        fn = torch.fft.ifft if inverse else torch.fft.fft
        return fn(a, dim=-1)

    def _fftn_worker(self, a: torch.Tensor, nd: int) -> torch.Tensor:
        """Backend-dispatched n-D FFT over the trailing ``nd`` axes: the
        worker of the n-D and multi-input plans.  Kernel backend: the
        four-step kernels swept over each axis
        (``ops.make_kernel_fftn_fn``); else ``torch.fft.fftn``."""
        a = self._as_tensor(a)
        if self.resolved_backend == "kernel":
            return ops.make_kernel_fftn_fn(nd)(a)
        return torch.fft.fftn(a, dim=tuple(range(-nd, 0)))

    def _ifftn_worker(self, a: torch.Tensor, nd: int) -> torch.Tensor:
        """Backend-dispatched n-D inverse FFT over the trailing ``nd``
        axes: the worker of the n-D real-output plan.  Kernel backend: the
        forward sweep through ``ifftn(a) = conj(fftn(conj(a))) / prod(L)``;
        else ``torch.fft.ifftn``."""
        a = self._as_tensor(a)
        if self.resolved_backend == "kernel":
            scale = math.prod(a.shape[-nd:])
            return torch.conj_physical(ops.make_kernel_fftn_fn(nd)(
                torch.conj_physical(a))) / scale
        return torch.fft.ifftn(a, dim=tuple(range(-nd, 0)))

    # -- public pipeline -----------------------------------------------------
    def _cast_input(self, x: torch.Tensor) -> torch.Tensor:
        """The plan's input dtype; a real-input plan overrides this."""
        return x.to(self.dtype)

    def message(self, x: torch.Tensor) -> torch.Tensor:
        """Input -> uncoded message shards ``(*B, m, *worker_shard_shape)``."""
        x = self._cast_input(self._as_tensor(x))
        batch_shape(x, len(self.input_shape), "plan input")
        return self._message(x)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Input -> coded worker shards.

        Reference backend: the O(N log N) zero-padded DFT encode over the
        shard axis.  Kernel backend: ONE ``mds_apply`` (``G @ c``) with
        the whole batch folded into the payload columns.
        """
        c = self.message(x)
        shard = tuple(self.worker_shard_shape)
        if self.resolved_backend == "kernel":
            batch = tuple(c.shape[:c.ndim - 1 - len(shard)])
            payload = math.prod(shard)
            flat = c.reshape(-1, self.m, payload)
            # (nb, m, P) -> (m, nb*P): a copy, so the kernel reads
            # contiguous planes
            folded = flat.transpose(0, 1).reshape(self.m, -1)
            coded = ops.mds_apply(self.generator, folded)
            out = coded.reshape(self.n_workers, flat.shape[0],
                                payload).transpose(0, 1)
            return out.reshape(batch + (self.n_workers,) + shard)
        return torch.fft.fft(c, n=self.n_workers,
                             dim=-1 - len(shard)).to(self.dtype)

    def encode_dense(self, x: torch.Tensor) -> torch.Tensor:
        """Reference O(N*m) matrix encode ``G @ c`` (kept for tests)."""
        c = self.message(x)
        shard = tuple(self.worker_shard_shape)
        lead = tuple(c.shape[:c.ndim - 1 - len(shard)])
        coded = self.generator.to(c.dtype) @ c.reshape(lead + (self.m, -1))
        return coded.reshape(lead + (self.n_workers,) + shard)

    def postdecode(self, c_hat: torch.Tensor) -> torch.Tensor:
        """Decoded message-shard transforms ``(*B, m, *worker_shard_shape)``
        -> final output ``(*B, *output_shape)``."""
        c_hat = self._as_tensor(c_hat)
        batch_shape(c_hat, 1 + len(self.worker_shard_shape),
                    "decoded shards")
        return self._postdecode(c_hat)

    def decode(self, b: torch.Tensor, subset: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None, *,
               method: str = "auto") -> torch.Tensor:
        """Worker results -> output, per-request straggler handling.

        At most one of ``subset`` (responder indices, ``(*B, m)`` or shared
        ``(m,)``) or ``mask`` (availability, ``(*B, N)`` or shared
        ``(N,)``).  Rows outside each request's subset are never read.
        ``method`` (``"auto"``, ``"solve"`` or ``"ifft"``) picks the MDS
        decode, with the reference's dispatch:

        * an unbatched request, or a batch of one, goes through
          ``mds.decode_auto`` -- on the kernel backend with ``"auto"``,
          through ``inv(G[subset])`` and ``mds_apply`` instead;
        * a shared ``(m,)`` subset, or the default ``arange(m)``, keeps
          ``method`` for every request of a batch;
        * per-request subsets (a batched subset or any mask) resolve
          ``"auto"`` to the backward-stable ``"solve"``; ``"ifft"`` runs
          per request.
        """
        if subset is not None and mask is not None:
            raise ValueError("pass at most one of subset / mask")
        if method not in _METHODS:
            raise ValueError(f"unknown decode method {method!r}")
        m, n = self.decode_width, self.n_workers
        if subset is not None and self._as_tensor(subset).shape[-1] != m:
            raise ValueError(f"subset must have exactly m={m} entries")
        shard = tuple(self.worker_shard_shape)
        b = self._as_tensor(b)
        batch = batch_shape(b, 1 + len(shard), "worker results")
        flat = b.reshape((-1, n) + shard)
        nb = flat.shape[0]
        if not batch or nb == 1:
            if subset is not None:
                subset1 = self._as_tensor(subset).long().reshape(m)
            elif mask is not None:
                subset1 = mds.first_available(
                    self._as_tensor(mask).bool().reshape(-1)[-n:], m)
            else:
                subset1 = torch.arange(m, device=self.device)
            if self.resolved_backend == "kernel" and method == "auto":
                out = self._decode_kernel(flat[0], subset1)
            else:
                out = self._postdecode(mds.decode_auto(
                    self.decode_generator, flat[0], subset1, method=method))
            return out.reshape(batch + tuple(out.shape))
        if subset is None and mask is None:
            shared = torch.arange(m, device=self.device)
        elif subset is not None and self._as_tensor(subset).ndim == 1:
            shared = self._as_tensor(subset).long()
        else:
            shared = None
        if shared is not None:
            # one subset for the whole batch: the batch folds into the
            # payload, each column decoded exactly as alone
            c_hat = mds.decode_auto(self.decode_generator,
                                    flat.transpose(0, 1),
                                    shared, method=method).transpose(0, 1)
        else:
            if subset is not None:
                subsets = self._as_tensor(subset).long()
                subsets = subsets.broadcast_to(batch + (m,)).reshape(nb, m)
            else:
                masks = self._as_tensor(mask).bool()
                masks = masks.broadcast_to(batch + (n,)).reshape(nb, n)
                subsets = mds.first_available(masks, m)
            c_hat = self._decode_per_request(
                flat, subsets, "solve" if method == "auto" else method)
        out = self._postdecode(c_hat)
        return out.reshape(batch + tuple(out.shape[1:]))

    def _decode_per_request(self, flat: torch.Tensor, subsets: torch.Tensor,
                            method: str) -> torch.Tensor:
        """``(nb, N, *shard)`` worker results with per-request subsets
        ``(nb, m)`` -> decoded shards ``(nb, m, *shard)``: the dense solve
        or the transform decode of every request at once."""
        nb, m = subsets.shape
        if method == "ifft":
            return mds.decode_ifft_batched(flat, subsets, self.n_workers)
        rows = flat[torch.arange(nb, device=flat.device)[:, None], subsets]
        gsub = self.decode_generator[subsets].to(flat.dtype)  # (nb, m, m)
        c_hat = torch.linalg.solve(gsub, rows.reshape(nb, m, -1))
        return c_hat.reshape(rows.shape)

    def _decode_kernel(self, b: torch.Tensor,
                       subset: torch.Tensor) -> torch.Tensor:
        """One request's decode on the kernel backend: invert the subset
        generator once (payload-independent) and stream the responder
        rows through ``mds_apply``.  Rows outside the subset are never
        read, so straggler garbage stays out."""
        rows = b[subset]
        dmat = mds.subset_decode_matrix(self.decode_generator, subset).to(
            self.dtype)
        c_hat = ops.mds_apply(dmat, rows)
        return self._postdecode(c_hat)

    def run(self, x: torch.Tensor, subset: Optional[torch.Tensor] = None,
            mask: Optional[torch.Tensor] = None, *,
            method: str = "auto") -> torch.Tensor:
        """``decode(worker_compute(encode(x)))`` -- the single-process
        end-to-end path."""
        b = self.worker_compute(self.encode(x))
        return self.decode(b, subset=subset, mask=mask, method=method)
