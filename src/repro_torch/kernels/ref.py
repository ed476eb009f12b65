"""Planar helpers and plain-PyTorch oracles for the kernels.

The kernels work on *planar* complex data (separate real/imag float32
planes), the layout of the JAX package's Pallas kernels, so a port and its
reference take the same arrays.  The oracles compute each kernel's
mathematical answer in natural complex arithmetic (``torch.fft`` included)
and are used by the tests only -- never by a kernel path.
"""

from __future__ import annotations

import torch

__all__ = [
    "planar",
    "unplanar",
    "fft_ref_complex",
    "fourstep_fft_ref",
    "cmatmul_ref",
    "bcmatmul_ref",
    "encode_worker_ref",
    "recombine_ref",
    "recombine_batched_ref",
]


def planar(z: torch.Tensor, dtype=torch.float32
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex tensor -> contiguous (real, imag) planes of ``dtype``."""
    if not z.is_complex():
        return z.to(dtype).contiguous(), torch.zeros_like(z, dtype=dtype)
    return z.real.to(dtype).contiguous(), z.imag.to(dtype).contiguous()


def unplanar(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """(real, imag) planes -> complex64."""
    return torch.complex(re.to(torch.float32), im.to(torch.float32))


def fft_ref_complex(x: torch.Tensor) -> torch.Tensor:
    """Ground-truth FFT along the last axis."""
    return torch.fft.fft(x, dim=-1)


def fourstep_fft_ref(xr, xi, a: int, b: int):
    """Four-step oracle on planar ``(batch, L)`` data (``L = a*b``): the
    mathematical answer, independent of the factorization."""
    return planar(torch.fft.fft(unplanar(xr, xi), dim=-1), xr.dtype)


def cmatmul_ref(ar, ai, br, bi):
    """Planar complex matmul oracle: (M, K) @ (K, N)."""
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def bcmatmul_ref(ar, ai, br, bi):
    """Batched planar complex matmul oracle: (q, M, K) @ (q, K, L)."""
    mm = lambda x, y: torch.einsum("qmk,qkl->qml", x, y)
    return mm(ar, br) - mm(ai, bi), mm(ar, bi) + mm(ai, br)


def encode_worker_ref(cr, ci, g):
    """Encode-then-FFT oracle: (q, m, L) message planes and an (n, m)
    complex generator -> (q, n, L) planes of ``fft(G @ c)``."""
    c = unplanar(cr, ci)
    a = torch.einsum("nm,qml->qnl", g.to(c.dtype), c)
    return planar(torch.fft.fft(a, dim=-1), cr.dtype)


def recombine_ref(cr, ci, wr, wi, fr, fi):
    """Twiddle + DFT oracle: ``F @ (C * W)`` on planar (m, L) data."""
    tr = cr * wr - ci * wi
    ti = cr * wi + ci * wr
    return fr @ tr - fi @ ti, fr @ ti + fi @ tr


def recombine_batched_ref(cr, ci, wr, wi, fr, fi):
    """Batched twiddle + DFT oracle on planar (q, m, L) data."""
    tr = cr * wr[None] - ci * wi[None]
    ti = cr * wi[None] + ci * wr[None]
    mm = lambda f, t: torch.einsum("jm,qml->qjl", f, t)
    return mm(fr, tr) - mm(fi, ti), mm(fr, ti) + mm(fi, tr)
