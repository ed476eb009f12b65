"""Real-input and inverse coded transforms as plans of their own.

The coded pipeline is linear in its input, so it serves real signals and
the inverse transform unchanged: only what the shards carry differs.
All three plans use the SAME ``(N, m)`` Reed-Solomon code as
:class:`~repro_torch.core.coded_fft.CodedFFT`, and a plain (i)FFT along
the last axis as the worker, so encode, decode and the kernels are
shared.

* :class:`CodedRFFT` (r2c): real ``(s,)`` -> half spectrum
  ``(s//2+1,)``.  The real interleave shards ``c_i`` (length ``L``) are
  pair-packed into complex shards ``z_i[j] = c_i[2j] + 1j*c_i[2j+1]`` of
  length ``L/2``: workers transform half-length shards and ship half the
  payload.  After decode the master splits each packed spectrum
  (:func:`split_packed`, anti-linear, so never inside the code),
  Hermitian-extends it and recombines only the non-redundant rows
  (:func:`~repro_torch.core.recombine.recombine_half`).
* :class:`CodedIFFT` (inverse c2c): the same interleave and code, an
  ``ifft`` worker, and the recombine butterfly with its twiddle
  conjugated and a ``1/m`` scale.
* :class:`CodedIRFFT` (c2r): the adjoint of :class:`CodedRFFT`.  The
  master Hermitian-extends the half spectrum (endpoint imaginary parts
  dropped, as ``numpy.fft.irfft`` does), folds it with the adjoint
  butterfly, packs each shard's half spectrum (:func:`pack_half`);
  workers ``ifft`` the packed shards; postdecode unpacks the pairs.

The real kinds need ``2m | s`` (an even shard length).  Every function
here takes batched ``(*B, ...)`` tensors.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import mds
from repro_torch.core.plan import MDSPlanBase, resolve_device
from repro_torch.core.recombine import (
    dft_matrix,
    recombine,
    recombine_half,
    twiddle,
)

__all__ = [
    "CodedRFFT",
    "CodedIFFT",
    "CodedIRFFT",
    "pack_pairs",
    "unpack_pairs",
    "split_packed",
    "pack_half",
    "hermitian_extend",
    "require_even_shards",
]

_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def require_even_shards(s: int, m: int, axis: Optional[int] = None) -> None:
    """Check the real-kind packing constraint ``2m | s`` (even shards).

    Raises a ``ValueError`` whose message always contains ``"2m | s"``,
    rather than letting a reshape fail deeper in the pipeline.
    """
    if s < 2 * m or s % (2 * m) != 0:
        where = "" if axis is None else f" along axis {axis}"
        raise ValueError(
            f"real packing needs 2m | s (an even shard length s/m){where}: "
            f"got s={s}, m={m}; pad s to a multiple of {2 * m} or lower m")


# -- symmetry ops on the last axis ----------------------------------------
def pack_pairs(c: torch.Tensor, dtype=torch.complex64) -> torch.Tensor:
    """Real ``(..., L)`` -> packed ``(..., L/2)``:
    ``z[j] = c[2j] + 1j*c[2j+1]``."""
    pairs = c.reshape(tuple(c.shape[:-1]) + (c.shape[-1] // 2, 2))
    return torch.complex(pairs[..., 0], pairs[..., 1]).to(dtype)


def unpack_pairs(z: torch.Tensor, real_dtype) -> torch.Tensor:
    """Inverse of :func:`pack_pairs`: ``(..., n)`` -> real ``(..., 2n)``."""
    pairs = torch.stack([z.real.to(real_dtype), z.imag.to(real_dtype)],
                        dim=-1)
    return pairs.reshape(tuple(z.shape[:-1]) + (2 * z.shape[-1],))


def split_packed(z_hat: torch.Tensor, ell: int) -> torch.Tensor:
    """Packed spectrum ``fft_{L/2}(z)`` -> half spectrum ``rfft_L(c)``.

    ``E_p = (Z_p + conj(Z_{n-p}))/2``, ``O_p = -j(Z_p - conj(Z_{n-p}))/2``,
    ``C_p = E_p + O_p * omega_L^p`` for ``p <= n = L/2``.  Returns
    ``(..., L/2 + 1)``.
    """
    n = z_hat.shape[-1]
    zext = torch.cat([z_hat, z_hat[..., :1]], dim=-1)
    zrev = torch.conj(torch.flip(zext, dims=(-1,)))
    even = 0.5 * (zext + zrev)
    odd = -0.5j * (zext - zrev)
    w = torch.as_tensor(np.exp(-2j * np.pi * np.arange(n + 1) / ell),
                        device=z_hat.device).to(z_hat.dtype)
    return even + odd * w


def pack_half(c_half: torch.Tensor, ell: int) -> torch.Tensor:
    """Inverse of :func:`split_packed`: the half spectrum ``(..., L/2+1)``
    of a real length-``ell`` signal -> the packed spectrum ``(..., L/2)``
    with ``ifft_{L/2}(Z)[j] = c[2j] + 1j*c[2j+1]``."""
    n = c_half.shape[-1] - 1
    crev = torch.conj(torch.flip(c_half, dims=(-1,)))
    even = 0.5 * (c_half + crev)
    w = torch.as_tensor(np.exp(2j * np.pi * np.arange(n + 1) / ell),
                        device=c_half.device).to(c_half.dtype)
    odd = 0.5 * (c_half - crev) * w
    return (even + 1j * odd)[..., :n]


def hermitian_extend(c_half: torch.Tensor) -> torch.Tensor:
    """Half spectrum ``(..., L/2+1)`` -> full ``(..., L)`` with
    ``C[L-p] = conj(C[p])``."""
    n = c_half.shape[-1] - 1
    mirror = torch.conj(torch.flip(c_half[..., 1:n], dims=(-1,)))
    return torch.cat([c_half, mirror], dim=-1)


# -- the plans --------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _RS1DPlanBase(MDSPlanBase):
    """Fields and shapes shared by the 1-D real and inverse plans.

    ``_EVEN_SHARDS`` (a class attribute): the real kinds pair-pack, so
    their shard length ``L = s/m`` must be even.  ``device=None`` means
    CUDA and raises when there is none.
    """

    s: int
    m: int
    n_workers: int
    dtype: torch.dtype = torch.complex64
    backend: str = "kernel"
    device: Optional[torch.device] = None

    _EVEN_SHARDS = False

    def __post_init__(self):
        if self._EVEN_SHARDS:
            require_even_shards(self.s, self.m)
        elif self.s % self.m != 0:
            raise ValueError(f"m={self.m} must divide s={self.s}")
        if self.n_workers < self.m:
            raise ValueError(f"need N >= m, got N={self.n_workers} "
                             f"m={self.m}")
        if self.backend not in ("kernel", "reference"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.dtype not in _REAL:
            raise ValueError(f"dtype must be complex64 or complex128, got "
                             f"{self.dtype}")
        object.__setattr__(self, "device", resolve_device(self.device))
        self._check_kernel_code()

    @property
    def shard_len(self) -> int:
        """The time-domain shard length ``L`` (the real kinds ship packed
        payloads of ``L/2``)."""
        return self.s // self.m

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

    def _interleave(self, x: torch.Tensor) -> torch.Tensor:
        # c_i[j] = x[i + j*m] on the last axis: (*B, s) -> (*B, m, L)
        lead = tuple(x.shape[:-1])
        return x.reshape(lead + (self.shard_len, self.m)).transpose(-1, -2)


@dataclasses.dataclass(frozen=True)
class CodedRFFT(_RS1DPlanBase):
    """Real-input coded FFT: ``(*B, s)`` real -> ``(*B, s//2+1)`` complex.

    Worker shards are the pair-packed message spectra, ``L/2`` complex
    values each: half the payload and half the transform length of
    :class:`~repro_torch.core.coded_fft.CodedFFT` on the same ``(s, m)``.
    """

    kind: str = dataclasses.field(default="r2c", init=False)

    _EVEN_SHARDS = True

    @property
    def input_shape(self) -> tuple[int, ...]:
        return (self.s,)

    @property
    def output_shape(self) -> tuple[int, ...]:
        return (self.s // 2 + 1,)

    @property
    def worker_shard_shape(self) -> tuple[int, ...]:
        return (self.shard_len // 2,)

    def _cast_input(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_complex():
            x = x.real
        return x.to(self.real_dtype)

    def _message(self, x: torch.Tensor) -> torch.Tensor:
        return pack_pairs(self._interleave(x), self.dtype)  # (*B, m, L/2)

    def _postdecode(self, z_hat: torch.Tensor) -> torch.Tensor:
        c_half = split_packed(z_hat, self.shard_len)        # (*B, m, L/2+1)
        return recombine_half(hermitian_extend(c_half), self.s)

    def worker_compute(self, a: torch.Tensor) -> torch.Tensor:
        return self._fft1_worker(a)


@dataclasses.dataclass(frozen=True)
class CodedIFFT(_RS1DPlanBase):
    """Inverse coded FFT (c2c): ``(*B, s)`` spectrum -> ``(*B, s)``.

    Workers ``ifft`` their coded shards (supplying ``1/L``); the
    recombine butterfly conjugates its twiddles and carries the
    remaining ``1/m``.
    """

    kind: str = dataclasses.field(default="c2c_inv", init=False)

    @property
    def input_shape(self) -> tuple[int, ...]:
        return (self.s,)

    @property
    def output_shape(self) -> tuple[int, ...]:
        return (self.s,)

    @property
    def worker_shard_shape(self) -> tuple[int, ...]:
        return (self.shard_len,)

    def _message(self, x: torch.Tensor) -> torch.Tensor:
        return self._interleave(x)

    def _postdecode(self, c_hat: torch.Tensor) -> torch.Tensor:
        return recombine(c_hat, self.s, sign=+1.0) / self.m

    def worker_compute(self, a: torch.Tensor) -> torch.Tensor:
        return self._fft1_worker(a, inverse=True)


@dataclasses.dataclass(frozen=True)
class CodedIRFFT(_RS1DPlanBase):
    """Inverse real coded FFT (c2r): ``(*B, s//2+1)`` half spectrum ->
    ``(*B, s)`` real, the adjoint of :class:`CodedRFFT`.

    The endpoint bins ``Y[0]`` and ``Y[s/2]`` lose their imaginary parts,
    as in ``numpy.fft.irfft``.
    """

    kind: str = dataclasses.field(default="c2r", init=False)

    _EVEN_SHARDS = True

    @property
    def input_shape(self) -> tuple[int, ...]:
        return (self.s // 2 + 1,)

    @property
    def output_shape(self) -> tuple[int, ...]:
        return (self.s,)

    @property
    def worker_shard_shape(self) -> tuple[int, ...]:
        return (self.shard_len // 2,)

    def _message(self, y: torch.Tensor) -> torch.Tensor:
        s, m, ell = self.s, self.m, self.shard_len
        lead = tuple(y.shape[:-1])
        head = y[..., :1].real.to(self.dtype)
        tail = y[..., -1:].real.to(self.dtype)
        mid = y[..., 1:-1]
        full = torch.cat([head, mid, tail,
                          torch.conj(torch.flip(mid, dims=(-1,)))], dim=-1)
        # adjoint recombine: fold_i[t] = sum_r X[t + r*L] omega_m^{+ir}
        #                                * omega_s^{+it}
        fp = dft_matrix(m, self.dtype, sign=+1.0, device=y.device)
        folded = fp @ full.reshape(lead + (m, ell))
        folded = folded * torch.conj(twiddle(s, m, self.dtype,
                                             device=y.device))
        return pack_half(folded[..., : ell // 2 + 1], ell)  # (*B, m, L/2)

    def _postdecode(self, z_hat: torch.Tensor) -> torch.Tensor:
        o = unpack_pairs(z_hat, self.real_dtype) / self.m   # (*B, m, L)
        lead = tuple(o.shape[:-2])
        return o.transpose(-1, -2).reshape(lead + (self.s,))

    def worker_compute(self, a: torch.Tensor) -> torch.Tensor:
        return self._fft1_worker(a, inverse=True)
