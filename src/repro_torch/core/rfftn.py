"""n-D real-input and real-output coded transforms.

:class:`CodedRFFTN` and :class:`CodedIRFFTN` are MDS plans over the SAME
``(N, m)`` Reed-Solomon code as every other plan.  They compose the 1-D
pair packing of :mod:`repro_torch.core.rfft` with the n-D interleave and
recombine, so workers transform and ship shards whose last axis is
halved.

The forward composition (r2c):

1. ``interleave_nd`` the real tensor by ``factors`` (paper eq. 28) into
   ``m = prod(factors)`` real shards ``(L_0, ..., L_{n-1})``;
2. pair-pack each shard along its LAST axis,
   ``z[..., j] = c[..., 2j] + 1j*c[..., 2j+1]``;
3. workers run the ordinary n-D FFT over the trailing shard axes (the
   four-step kernels swept over each axis on the kernel backend);
4. postdecode runs the generalized split butterfly: for packed n-D real
   data the 1-D identity ``E_p = (Z_p + conj(Z_{n2-p}))/2`` picks up a
   frequency negation on every OTHER shard axis, because ``fftn(c)`` of a
   real ``c`` is Hermitian jointly across all axes
   (``fftn(c)[-q, -p] = conj(fftn(c)[q, p])``).  The joint Hermitian
   extension has the same negation.  Both are anti-linear: master-side
   only, after decode, never inside the code;
5. ``recombine_nd`` (paper eq. 31), then the ``shape[-1]//2 + 1``
   non-redundant last-axis bins: ``numpy.fft.rfftn``.

:class:`CodedIRFFTN` is the adjoint.  The master averages the endpoint
last-axis bins with their negated-frequency conjugates (which reproduces
``numpy.fft.irfftn`` exactly, even on input that is not Hermitian),
runs the per-axis adjoint of the recombine butterfly
(:func:`adjoint_fold_nd`), packs each shard's Hermitian spectrum
(:func:`pack_half_nd`); workers ``ifftn`` the packed coded shards, and
postdecode unpacks the pairs and de-interleaves.

Both need an EVEN last shard axis (``2*factors[-1] | shape[-1]``):
:func:`repro_torch.core.rfft.require_even_shards` raises the documented
``ValueError`` otherwise.  Every function here takes leading batch axes;
``axes`` and ``rest_axes`` name the axes they act on.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import mds
from repro_torch.core.interleave import deinterleave_nd, interleave_nd
from repro_torch.core.plan import MDSPlanBase, resolve_device
from repro_torch.core.recombine import dft_matrix, recombine_nd
from repro_torch.core.rfft import (
    _REAL,
    pack_pairs,
    require_even_shards,
    unpack_pairs,
)

__all__ = [
    "CodedRFFTN",
    "CodedIRFFTN",
    "neg_freq",
    "split_packed_nd",
    "hermitian_extend_nd",
    "pack_half_nd",
    "adjoint_fold_nd",
]


# -- symmetry ops -----------------------------------------------------------
def neg_freq(a: torch.Tensor, axes: tuple[int, ...]) -> torch.Tensor:
    """Frequency negation ``q -> (-q) mod L`` along each axis in ``axes``:
    the index map conjugation induces on every non-halved axis of a real
    signal's n-D spectrum."""
    for ax in axes:
        a = torch.roll(torch.flip(a, dims=(ax,)), 1, dims=ax)
    return a


def _phase(n: int, ell: int, sign: float, like: torch.Tensor
           ) -> torch.Tensor:
    """``exp(sign * 2j*pi*p/ell)`` for ``p <= n``, in ``like``'s dtype and
    on its device (built in float64, as the reference's planes are)."""
    return torch.as_tensor(np.exp(sign * 2j * np.pi * np.arange(n + 1) / ell),
                           device=like.device).to(like.dtype)


def split_packed_nd(z_hat: torch.Tensor, ell: int,
                    rest_axes: tuple[int, ...]) -> torch.Tensor:
    """Generalized split butterfly: packed n-D spectra -> half spectra.

    ``z_hat``: ``(..., L/2)``, the transform of ``z = pack_pairs(c)``
    along the last axis of a real ``c``; ``rest_axes``: the non-halved
    transform axes.  Returns ``(..., L/2 + 1)``: the transform of ``c`` at
    the non-redundant last-axis bins.  Anti-linear: master-side only.
    """
    n2 = z_hat.shape[-1]
    zext = torch.cat([z_hat, z_hat[..., :1]], dim=-1)
    zrev = torch.conj(neg_freq(torch.flip(zext, dims=(-1,)), rest_axes))
    even = 0.5 * (zext + zrev)
    odd = -0.5j * (zext - zrev)
    return even + odd * _phase(n2, ell, -1.0, z_hat)


def hermitian_extend_nd(c_half: torch.Tensor,
                        rest_axes: tuple[int, ...]) -> torch.Tensor:
    """Joint Hermitian extension ``C[-q, L-p] = conj(C[q, p])`` along the
    last axis: ``(..., L/2 + 1) -> (..., L)``."""
    n2 = c_half.shape[-1] - 1
    tail = torch.conj(neg_freq(torch.flip(c_half[..., 1:n2], dims=(-1,)),
                               rest_axes))
    return torch.cat([c_half, tail], dim=-1)


def pack_half_nd(c_full: torch.Tensor, ell: int,
                 rest_axes: tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`split_packed_nd`: the jointly Hermitian n-D
    spectrum ``(..., L)`` of a real signal -> the packed spectrum
    ``(..., L/2)`` whose ``ifftn`` is the pair-packed signal."""
    n2 = ell // 2
    ch = c_full[..., : n2 + 1]
    crev = torch.conj(neg_freq(torch.flip(ch, dims=(-1,)), rest_axes))
    even = 0.5 * (ch + crev)
    odd = 0.5 * (ch - crev) * _phase(n2, ell, 1.0, ch)
    return (even + 1j * odd)[..., :n2]


def adjoint_fold_nd(full: torch.Tensor, shape: tuple[int, ...],
                    factors: tuple[int, ...], dtype) -> torch.Tensor:
    """Adjoint of :func:`repro_torch.core.recombine.recombine_nd`.

    ``full``: ``(*B, s_0, ..., s_{n-1})`` full n-D spectra.  Returns the
    ``(*B, m, L_0, ..., L_{n-1})`` folded shard spectra

        ``folded_k[t] = sum_r full[t_d + r_d L_d]
                        prod_d omega_{m_d}^{+k_d r_d} omega_{s_d}^{+k_d t_d}``

    -- per axis, a +sign ``m_d``-point DFT across the fold, then the
    conjugate recombine twiddle -- so that ``ifftn(folded_k)`` is the
    ``k``-th interleave shard of ``ifftn(full) * m``.
    """
    n = len(shape)
    ells = tuple(sd // md for sd, md in zip(shape, factors))
    lead = tuple(full.shape[:full.ndim - n])
    nb = len(lead)
    rs: list[int] = []
    for sd, md in zip(shape, factors):
        rs.extend([md, sd // md])
    c = full.reshape(lead + tuple(rs))         # (*B, m_0, L_0, m_1, L_1..)
    c = c.permute(list(range(nb)) + [nb + 2 * k for k in range(n)]
                  + [nb + 2 * k + 1 for k in range(n)])
    for d in range(n):
        md, sd, ld = factors[d], shape[d], ells[d]
        f = dft_matrix(md, dtype, sign=+1.0, device=full.device)
        c = torch.tensordot(f, c, dims=([1], [nb + d])).movedim(0, nb + d)
        tw = torch.as_tensor(
            np.exp(2j * np.pi * np.outer(np.arange(md), np.arange(ld)) / sd),
            device=full.device).to(dtype)
        bshape = [1] * (2 * n)
        bshape[d] = md
        bshape[n + d] = ld
        c = c * tw.reshape(bshape)
    return c.reshape(lead + (math.prod(factors),) + ells)


# -- the plans ----------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _RSNDRealPlanBase(MDSPlanBase):
    """Fields and validation shared by the n-D real plans.

    ``factors[k]`` divides ``shape[k]``, ``prod(factors) = m``, and the
    LAST shard axis must be even (``2*factors[-1] | shape[-1]``).
    ``device=None`` means CUDA and raises when there is none.
    """

    shape: tuple[int, ...]
    factors: tuple[int, ...]
    n_workers: int
    dtype: torch.dtype = torch.complex64
    backend: str = "kernel"
    device: Optional[torch.device] = None

    def __post_init__(self):
        if not self.shape or len(self.shape) != len(self.factors):
            raise ValueError(
                f"factors {self.factors} must match shape {self.shape}")
        for sk, mk in zip(self.shape[:-1], self.factors[:-1]):
            if mk < 1 or sk % mk != 0:
                raise ValueError(f"factor {mk} must divide dim {sk}")
        require_even_shards(self.shape[-1], self.factors[-1],
                            axis=len(self.shape) - 1)
        if self.n_workers < self.m:
            raise ValueError(
                f"need N >= m, got N={self.n_workers} m={self.m}")
        if self.backend not in ("kernel", "reference"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.dtype not in _REAL:
            raise ValueError(f"dtype must be complex64 or complex128, got "
                             f"{self.dtype}")
        object.__setattr__(self, "shape", tuple(self.shape))
        object.__setattr__(self, "factors", tuple(self.factors))
        object.__setattr__(self, "device", resolve_device(self.device))
        self._check_kernel_code()

    @property
    def m(self) -> int:
        return math.prod(self.factors)

    @property
    def nd(self) -> int:
        return len(self.shape)

    @property
    def shard_shape(self) -> tuple[int, ...]:
        """Per-worker TIME-domain shard shape (the shipped packed payload
        halves the last axis)."""
        return tuple(sk // mk for sk, mk in zip(self.shape, self.factors))

    @property
    def worker_shard_shape(self) -> tuple[int, ...]:
        ells = self.shard_shape
        return ells[:-1] + (ells[-1] // 2,)

    @property
    def real_dtype(self) -> torch.dtype:
        return _REAL[self.dtype]

    @property
    def recovery_threshold(self) -> int:
        return self.m

    @functools.cached_property
    def generator(self) -> torch.Tensor:
        return mds.rs_generator(self.n_workers, self.m, self.dtype,
                                self.device)

    @property
    def _rest_axes(self) -> tuple[int, ...]:
        """The non-halved transform axes of any ``(..., L_0, ..., L_{n-1})``
        tensor: every trailing spatial axis but the packed last one."""
        return tuple(range(-self.nd, -1))


@dataclasses.dataclass(frozen=True)
class CodedRFFTN(_RSNDRealPlanBase):
    """n-D real-input coded FFT: ``(*B, *shape)`` real -> the half
    spectrum ``(*B, *shape[:-1], shape[-1]//2 + 1)``, as
    ``numpy.fft.rfftn``.

    Workers transform pair-packed shards with a halved last axis: half
    the per-worker payload of :class:`~repro_torch.core.coded_fft.CodedFFTND`
    at the same ``(shape, m)``.
    """

    kind: str = dataclasses.field(default="rfftn", init=False)

    @property
    def input_shape(self) -> tuple[int, ...]:
        return self.shape

    @property
    def output_shape(self) -> tuple[int, ...]:
        return self.shape[:-1] + (self.shape[-1] // 2 + 1,)

    def _cast_input(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_complex():
            x = x.real
        return x.to(self.real_dtype)

    def _message(self, t: torch.Tensor) -> torch.Tensor:
        c = interleave_nd(t, self.factors)           # (*B, m, *ells) real
        return pack_pairs(c, self.dtype)             # (*B, m, ..., L/2)

    def _postdecode(self, z_hat: torch.Tensor) -> torch.Tensor:
        rest = self._rest_axes
        c_half = split_packed_nd(z_hat, self.shard_shape[-1], rest)
        full = recombine_nd(hermitian_extend_nd(c_half, rest), self.shape,
                            self.factors)
        return full[..., : self.shape[-1] // 2 + 1]

    def worker_compute(self, a: torch.Tensor) -> torch.Tensor:
        return self._fftn_worker(a, self.nd)


@dataclasses.dataclass(frozen=True)
class CodedIRFFTN(_RSNDRealPlanBase):
    """n-D inverse real coded FFT: the half spectrum
    ``(*B, *shape[:-1], shape[-1]//2 + 1)`` -> ``(*B, *shape)`` real, as
    ``numpy.fft.irfftn``: the adjoint of :class:`CodedRFFTN`.

    The message stage averages each endpoint last-axis bin with its
    negated-frequency conjugate (``numpy.fft.irfftn`` drops the endpoints'
    anti-Hermitian parts after the other axes' inverse transforms, which
    this reproduces in the spectral domain), folds with the per-axis
    adjoint butterfly and pair-packs; workers ``ifftn`` half-size shards,
    and postdecode is a relabelling.
    """

    kind: str = dataclasses.field(default="irfftn", init=False)

    @property
    def input_shape(self) -> tuple[int, ...]:
        return self.shape[:-1] + (self.shape[-1] // 2 + 1,)

    @property
    def output_shape(self) -> tuple[int, ...]:
        return self.shape

    def _message(self, y: torch.Tensor) -> torch.Tensor:
        rest = self._rest_axes
        head = 0.5 * (y[..., :1] + torch.conj(neg_freq(y[..., :1], rest)))
        last = 0.5 * (y[..., -1:] + torch.conj(neg_freq(y[..., -1:], rest)))
        mid = y[..., 1:-1]
        tail = torch.flip(torch.conj(neg_freq(mid, rest)), dims=(-1,))
        full = torch.cat([head, mid, last, tail], dim=-1)
        folded = adjoint_fold_nd(full, self.shape, self.factors, self.dtype)
        return pack_half_nd(folded, self.shard_shape[-1], rest)

    def _postdecode(self, z_hat: torch.Tensor) -> torch.Tensor:
        o = unpack_pairs(z_hat, self.real_dtype) / self.m   # (*B, m, *ells)
        return deinterleave_nd(o, self.factors, self.shape)

    def worker_compute(self, a: torch.Tensor) -> torch.Tensor:
        return self._ifftn_worker(a, self.nd)
