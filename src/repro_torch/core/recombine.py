"""Master-side recombination for the coded FFT (paper eq. 23/24).

Given the decoded sub-transforms ``C`` with ``C[k] = DFT_{s/m}(c_k)``,

    X[i + j*(s/m)] = sum_k C[k, i] * omega_s^{ik} * omega_m^{jk}

an elementwise twiddle followed by ``s/m`` length-m DFTs along the shard
axis.  ``sign=+1`` with a caller-applied ``1/m`` recombines inverse
sub-transforms; :func:`recombine_half` computes only the non-redundant
half spectrum of a real input.  The n-D variant is a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["twiddle", "dft_matrix", "recombine", "recombine_half"]


def dft_matrix(m: int, dtype=torch.complex64, sign: float = -1.0,
               device=None) -> torch.Tensor:
    """Dense ``m x m`` DFT matrix ``F[j, k] = exp(sign*2j*pi*j*k/m)``."""
    jk = np.outer(np.arange(m), np.arange(m))
    return torch.as_tensor(np.exp(sign * 2j * np.pi * jk / m),
                           device=device).to(dtype)


def twiddle(s: int, m: int, dtype=torch.complex64, sign: float = -1.0,
            device=None) -> torch.Tensor:
    """Twiddle plane ``W[k, i] = omega_s^{ik}``, shape ``(m, s/m)``."""
    ki = np.outer(np.arange(m), np.arange(s // m))
    return torch.as_tensor(np.exp(sign * 2j * np.pi * ki / s),
                           device=device).to(dtype)


def recombine(c_hat: torch.Tensor, s: int, sign: float = -1.0) -> torch.Tensor:
    """``(*B, m, s/m)`` decoded sub-transforms -> ``(*B, s)`` output."""
    m = c_hat.shape[-2]
    w = twiddle(s, m, c_hat.dtype, sign, c_hat.device)
    f = dft_matrix(m, c_hat.dtype, sign, c_hat.device)
    x_mat = f @ (c_hat * w)                      # (*B, m, s/m)
    return x_mat.reshape(tuple(c_hat.shape[:-2]) + (s,))


def recombine_half(c_full: torch.Tensor, s: int) -> torch.Tensor:
    """Symmetry-aware butterfly: ``(*B, m, s/m)`` Hermitian sub-transforms
    of REAL shards -> the ``(*B, s//2 + 1)`` bins ``X[0..s/2]``.

    Only the DFT rows ``j <= m//2`` are computed (an output index
    ``u = i + j*L <= s/2`` never needs a higher row), then the flattened
    block is cut to the non-redundant bins.
    """
    m, ell = c_full.shape[-2:]
    w = twiddle(s, m, c_full.dtype, device=c_full.device)
    rows = m // 2 + 1
    f_half = dft_matrix(m, c_full.dtype, device=c_full.device)[:rows]
    x_mat = f_half @ (c_full * w)                # (*B, m//2 + 1, s/m)
    lead = tuple(c_full.shape[:-2])
    return x_mat.reshape(lead + (rows * ell,))[..., : s // 2 + 1]
