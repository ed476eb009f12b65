"""Coded FFT with multiple inputs (paper §VI, Theorem 5).

``q`` input tensors of shape ``s_0 x ... x s_{n-1}``; each worker stores a
``1/m`` fraction of the total ``q*s`` elements, with ``m = m_tilde *
prod(m_k)``, ``m_tilde | q`` and ``m_k | s_k``.

The q inputs are bundled into ``m_tilde`` disjoint groups of ``q/m_tilde``;
within a group, the interleaved tensors that share an index tuple
``(i_0..i_{n-1})`` form one message symbol.  The ``m`` symbols are
encoded with the (N, m) Reed-Solomon code; every worker transforms all
coded tensors of its symbol (the four-step kernels swept over each
spatial axis on the kernel backend).  Any ``m`` responders suffice.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from repro_torch.core import mds
from repro_torch.core.interleave import interleave_nd
from repro_torch.core.plan import MDSPlanBase, resolve_device
from repro_torch.core.recombine import recombine_nd

__all__ = ["CodedFFTMultiInput"]


@dataclasses.dataclass(frozen=True)
class CodedFFTMultiInput(MDSPlanBase):
    """``(*B, q, *shape)`` complex -> the ``fftn`` of each of the ``q``
    inputs over its trailing axes.  ``device=None`` means CUDA and raises
    when there is none."""

    q: int
    shape: tuple[int, ...]
    m_tilde: int
    factors: tuple[int, ...]
    n_workers: int
    dtype: torch.dtype = torch.complex64
    backend: str = "kernel"
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.q % self.m_tilde != 0:
            raise ValueError("m_tilde must divide q")
        if len(self.shape) != len(self.factors):
            raise ValueError(
                f"factors {self.factors} must match shape {self.shape}")
        for sk, mk in zip(self.shape, self.factors):
            if mk < 1 or sk % mk != 0:
                raise ValueError(f"factor {mk} must divide dim {sk}")
        if self.n_workers < self.m:
            raise ValueError("need N >= m")
        if self.backend not in ("kernel", "reference"):
            raise ValueError(f"unknown backend {self.backend!r}")
        object.__setattr__(self, "shape", tuple(self.shape))
        object.__setattr__(self, "factors", tuple(self.factors))
        object.__setattr__(self, "device", resolve_device(self.device))
        self._check_kernel_code()

    @property
    def m_spatial(self) -> int:
        return math.prod(self.factors)

    @property
    def m(self) -> int:
        return self.m_tilde * self.m_spatial

    @property
    def recovery_threshold(self) -> int:
        return self.m

    @property
    def group_size(self) -> int:
        return self.q // self.m_tilde

    @property
    def shard_shape(self) -> tuple[int, ...]:
        return tuple(sk // mk for sk, mk in zip(self.shape, self.factors))

    @property
    def input_shape(self) -> tuple[int, ...]:
        return (self.q,) + self.shape

    @property
    def output_shape(self) -> tuple[int, ...]:
        return (self.q,) + self.shape

    @property
    def worker_shard_shape(self) -> tuple[int, ...]:
        return (self.group_size,) + self.shard_shape

    @functools.cached_property
    def generator(self) -> torch.Tensor:
        return mds.rs_generator(self.n_workers, self.m, self.dtype,
                                self.device)

    def _message(self, t: torch.Tensor) -> torch.Tensor:
        """``(*B, q, *shape)`` -> message symbols
        ``(*B, m, q/m_tilde, *shard_shape)``."""
        core = len(self.input_shape)
        if tuple(t.shape[t.ndim - core:]) != self.input_shape:
            raise ValueError(f"expected {self.input_shape}, got "
                             f"{tuple(t.shape)}")
        lead = tuple(t.shape[:t.ndim - core])
        nb = len(lead)
        c = interleave_nd(t, self.factors)         # (*B, q, m_sp, *shard)
        c = c.reshape(lead + (self.m_tilde, self.group_size, self.m_spatial)
                      + self.shard_shape)
        # symbols = (m_tilde, m_sp) row-major -> (*B, m, group, *shard)
        return c.transpose(nb + 1, nb + 2).reshape(
            lead + (self.m, self.group_size) + self.shard_shape)

    def _postdecode(self, sym: torch.Tensor) -> torch.Tensor:
        """Decoded symbols ``(*B, m, group, *shard)`` -> the outputs
        ``(*B, q, *shape)``."""
        lead = tuple(sym.shape[:sym.ndim - 2 - len(self.shape)])
        nb = len(lead)
        sym = sym.reshape(lead + (self.m_tilde, self.m_spatial,
                                  self.group_size) + self.shard_shape)
        sym = sym.transpose(nb + 1, nb + 2).reshape(
            lead + (self.q, self.m_spatial) + self.shard_shape)
        return recombine_nd(sym, self.shape, self.factors)

    def worker_compute(self, a: torch.Tensor) -> torch.Tensor:
        """n-D FFT of every coded tensor over the trailing spatial axes."""
        return self._fftn_worker(a, len(self.shape))
