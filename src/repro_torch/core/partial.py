"""Partial-work coded FFT: stragglers contribute PREFIXES, not holes.

Wang et al. (arXiv 1804.09791) show the MDS construction's blind spot:
a worker that finishes 90% of its shard before the deadline contributes
NOTHING -- the master discards partial work wholesale.  The fix is to make
partial work *sequentially useful*: split each worker's job into ``r``
fragments, each a codeword row of a FINER code, so every finished fragment
is one more decodable symbol.

Construction:

  1. interleave ``x`` into ``m*r`` message shards of length ``s/(m*r)``;
  2. encode with the ``(N*r, m*r)`` complex-RS code on the ``(N*r)``-th
     roots of unity -- one zero-padded DFT, as in the base plan;
  3. worker ``w`` owns coded rows ``{f*N + w : f < r}`` and transforms them
     IN ORDER ``f = 0, 1, ...`` -- a worker cut off at any point has
     produced a prefix of complete fragments;
  4. the master decodes as soon as ANY ``m*r`` fragments (across all
     workers) have arrived -- every subset of distinct roots-of-unity rows
     is a Vandermonde system, so the coverage condition is a pure count:
     ``total fragments >= m*r``;
  5. recombine the ``m*r`` decoded message transforms with the standard
     twiddle + DFT stage.

``r = 1`` degenerates to the base MDS plan.  The recovery threshold in
WORKER units stays ``m``; the win is that ``m`` *complete* workers are no
longer required.  Per-worker storage, compute and total wire payload are
unchanged (``payload_scale = 1``).

Decode runs over the flat ``(N*r, m*r)`` generator: the row of fragment
``f`` of worker ``w`` is ``f*N + w``, fragment masks ``(N, r)`` flatten
to row masks of length ``N*r``, and the first ``m*r`` available rows are
GATHERED before any product, so unfinished rows (NaN included) are never
read.  On the kernel backend the worker runs the four-step kernels; the
encode is always the zero-padded DFT and the decode the plain solve or
transform decode, as in the reference.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import mds
from repro_torch.core.plan import (
    _METHODS,
    MDSPlanBase,
    batch_shape,
    resolve_device,
)
from repro_torch.core.recombine import recombine

__all__ = ["CodedPartialFFT"]


@dataclasses.dataclass(frozen=True)
class CodedPartialFFT(MDSPlanBase):
    """1-D coded FFT with ``r`` sequentially-useful fragments per worker.

    Args:
      s: transform length.
      m: storage fraction parameter -- each worker stores/processes s/m.
      n_workers: N >= m workers.
      r: fragments per worker; the code is ``(N*r, m*r)`` and the master
        decodes from any ``m*r`` finished fragments.
      dtype: complex dtype of the computation.
      backend: ``"reference"`` (default) or ``"kernel"``, which runs the
        per-fragment worker DFT on the four-step kernels for complex64.
      device: where the plan computes; ``None`` means CUDA, and raises
        when there is none.
    """

    s: int
    m: int
    n_workers: int
    r: int = 2
    dtype: torch.dtype = torch.complex64
    backend: str = "reference"
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.r < 1:
            raise ValueError(f"need r >= 1 fragments, got r={self.r}")
        if self.s % (self.m * self.r) != 0:
            raise ValueError(
                f"m*r={self.m * self.r} must divide s={self.s} "
                f"(fragment shards must tile the input)")
        if self.n_workers < self.m:
            raise ValueError(
                f"need N >= m for recoverability, got N={self.n_workers} "
                f"m={self.m}")
        if self.backend not in ("kernel", "reference"):
            raise ValueError(f"unknown backend {self.backend!r}")
        object.__setattr__(self, "device", resolve_device(self.device))

    # -- code geometry -------------------------------------------------------
    @property
    def frag_len(self) -> int:
        """Symbols per fragment: s / (m*r)."""
        return self.s // (self.m * self.r)

    @property
    def shard_len(self) -> int:
        """Symbols per worker (all r fragments): s/m, as in the MDS plan."""
        return self.s // self.m

    @property
    def fragments(self) -> int:
        return self.r

    @property
    def fragments_needed(self) -> int:
        """The coverage condition: decode iff this many fragments (across
        all workers) have arrived."""
        return self.m * self.r

    @property
    def code_rows(self) -> int:
        return self.n_workers * self.r

    @property
    def input_shape(self) -> tuple[int, ...]:
        return (self.s,)

    @property
    def output_shape(self) -> tuple[int, ...]:
        return (self.s,)

    @property
    def worker_shard_shape(self) -> tuple[int, ...]:
        return (self.r, self.frag_len)

    @property
    def recovery_threshold(self) -> int:
        """In WORKER units: any m complete workers suffice."""
        return self.m

    @property
    def payload_scale(self) -> float:
        """Total wire payload matches the MDS plan's."""
        return 1.0

    @property
    def fragment_fractions(self) -> np.ndarray:
        """Fraction of a worker's full shard time at which each fragment
        completes (equal-cost, sequential): (f+1)/r."""
        return np.arange(1, self.r + 1) / self.r

    @functools.cached_property
    def generator(self) -> torch.Tensor:
        """The FLAT ``(N*r, m*r)`` fragment-code generator; row ``f*N + w``
        is fragment ``f`` of worker ``w``."""
        return mds.rs_generator(self.code_rows, self.fragments_needed,
                                self.dtype, self.device)

    @property
    def worker_encode_tensor(self) -> torch.Tensor:
        """Per-worker encode rows ``(N, r, m*r)``:
        ``tensor[w, f] = generator[f*N + w]``."""
        return self.generator.reshape(
            self.r, self.n_workers, self.fragments_needed).transpose(0, 1)

    # -- stage cores ---------------------------------------------------------
    def _message(self, x: torch.Tensor) -> torch.Tensor:
        # c_i[j] = x[i + j*m*r]: (*B, s) -> (*B, m*r, L')
        lead = tuple(x.shape[:-1])
        return x.reshape(lead + (self.frag_len, self.fragments_needed)
                         ).transpose(-1, -2)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Input -> per-worker fragment stacks ``(*B, N, r, L')``: one
        zero-padded DFT over the (N*r)-th roots evaluates every flat row
        ``f*N + w``, regrouped per worker.  Always the DFT encode: the
        base plan's kernel branch assumes the (N, m) layout."""
        c = self.message(x)
        lead = tuple(c.shape[:-2])
        a = torch.fft.fft(c, n=self.code_rows, dim=-2)
        a = a.reshape(lead + (self.r, self.n_workers, self.frag_len))
        return a.transpose(-2, -3).to(self.dtype)

    def worker_compute(self, a: torch.Tensor) -> torch.Tensor:
        """Per-fragment DFT along the last axis: a worker interrupted
        after fragment f has rows 0..f complete."""
        return self._fft1_worker(a)

    def _postdecode(self, c_hat: torch.Tensor) -> torch.Tensor:
        return recombine(c_hat, self.s)                    # m*r shards

    def postdecode(self, c_hat: torch.Tensor) -> torch.Tensor:
        """Decoded fragment transforms ``(*B, m*r, L')`` -> ``(*B, s)``."""
        c_hat = self._as_tensor(c_hat)
        batch_shape(c_hat, 2, "decoded shards")
        return self._postdecode(c_hat)

    # -- fragment-weighted decode --------------------------------------------
    def _row_mask(self, batch: tuple[int, ...], subset, mask,
                  fragment_mask) -> torch.Tensor:
        """Resolve subset / worker mask / fragment mask to a flat row mask
        ``(*B, N*r)`` in ``f*N + w`` row order."""
        n, r = self.n_workers, self.r
        if fragment_mask is not None:
            fm = self._as_tensor(fragment_mask).bool()
            fm = fm.broadcast_to(batch + (n, r))
            return fm.transpose(-1, -2).reshape(batch + (n * r,))
        if mask is not None:
            wm = self._as_tensor(mask).bool().broadcast_to(batch + (n,))
        elif subset is not None:
            wm = torch.zeros(n, dtype=torch.bool, device=self.device)
            wm[self._as_tensor(subset).long().reshape(-1)] = True
            wm = wm.broadcast_to(batch + (n,))
        else:
            wm = (torch.arange(n, device=self.device) < self.m
                  ).broadcast_to(batch + (n,))
        return wm[..., None, :].broadcast_to(batch + (r, n)).reshape(
            batch + (n * r,))

    def _flat_rows(self, b: torch.Tensor) -> torch.Tensor:
        """(*B, N, r, L') worker results -> (*B, N*r, L') flat code rows."""
        batch = tuple(b.shape[:-3])
        return b.transpose(-2, -3).reshape(
            batch + (self.code_rows, self.frag_len))

    def decodable(self, mask=None, fragment_mask=None) -> bool:
        """The coverage condition: total finished fragments >= m*r (a
        worker mask counts r fragments per live worker)."""
        if fragment_mask is not None:
            return (int(torch.as_tensor(fragment_mask).sum())
                    >= self.fragments_needed)
        if mask is None:
            return self.n_workers >= self.m
        return (int(torch.as_tensor(mask).sum()) * self.r
                >= self.fragments_needed)

    def decode(self, b: torch.Tensor, subset=None, mask=None, *,
               fragment_mask=None, method: str = "auto") -> torch.Tensor:
        """Worker results -> output from any fragment set meeting the
        coverage condition.

        At most one of ``subset`` (worker indices), ``mask`` (worker
        availability ``(*B, N)``) or ``fragment_mask`` (per-fragment
        availability ``(*B, N, r)``: True means fragment f of worker w
        finished).  Unfinished fragment rows are never read (they may
        hold NaN).  An unbatched request, or a batch of one, keeps
        ``decode_auto``'s dispatch; per-request rows resolve ``"auto"``
        to the backward-stable ``"solve"``.
        """
        if sum(v is not None for v in (subset, mask, fragment_mask)) > 1:
            raise ValueError(
                "pass at most one of subset / mask / fragment_mask")
        if method not in _METHODS:
            raise ValueError(f"unknown decode method {method!r}")
        k = self.fragments_needed
        b = self._as_tensor(b)
        batch = batch_shape(b, 3, "worker results")
        rows_mask = self._row_mask(batch, subset, mask, fragment_mask)
        bf = self._flat_rows(b)
        gen = self.generator

        def decode1(bi, rmk, mth):
            rows = mds.first_available(rmk, k)
            return self._postdecode(mds.decode_auto(gen, bi, rows,
                                                    method=mth))

        if not batch:
            return decode1(bf, rows_mask, method)
        flat = bf.reshape((-1, self.code_rows, self.frag_len))
        mflat = rows_mask.reshape(flat.shape[0], -1)
        nb = flat.shape[0]
        if nb == 1:
            out = decode1(flat[0], mflat[0], method)
            return out.reshape(batch + tuple(out.shape))
        subsets = mds.first_available(mflat, k)
        if method == "ifft":
            c_hat = mds.decode_ifft_batched(flat, subsets, self.code_rows)
        else:
            rows = flat[torch.arange(nb, device=flat.device)[:, None],
                        subsets]
            c_hat = torch.linalg.solve(gen[subsets].to(flat.dtype), rows)
        out = self._postdecode(c_hat)
        return out.reshape(batch + tuple(out.shape[1:]))

    def run(self, x: torch.Tensor, subset=None, mask=None, *,
            fragment_mask=None, method: str = "auto") -> torch.Tensor:
        b = self.worker_compute(self.encode(x))
        return self.decode(b, subset=subset, mask=mask,
                           fragment_mask=fragment_mask, method=method)
