"""Master-side recombination for the coded FFT (paper eq. 23/24).

Given the decoded sub-transforms ``C`` with ``C[k] = DFT_{s/m}(c_k)``,

    X[i + j*(s/m)] = sum_k C[k, i] * omega_s^{ik} * omega_m^{jk}

an elementwise twiddle followed by ``s/m`` length-m DFTs along the shard
axis.  ``sign=+1`` with a caller-applied ``1/m`` recombines inverse
sub-transforms; :func:`recombine_half` computes only the non-redundant
half spectrum of a real input; :func:`recombine_nd` is the n-D
butterfly (paper eq. 31), master-side glue in plain PyTorch as in the
reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.interleave import deinterleave_nd

__all__ = ["twiddle", "dft_matrix", "recombine", "recombine_half",
           "recombine_nd"]


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


def recombine_nd(c_hat: torch.Tensor, shape: tuple[int, ...],
                 factors: tuple[int, ...]) -> torch.Tensor:
    """n-D recombination (paper eq. 31).

    ``c_hat``: ``(*B, m, L_0, ..., L_{n-1})`` decoded sub-transforms
    indexed by the row-major shard tuple ``(k_0..k_{n-1})``; returns the
    ``(*B, *shape)`` n-D transforms

        T[..., i_d + j_d*L_d, ...] = sum_{k} C[(k), (i)] *
            prod_d omega_{s_d}^{i_d k_d} * omega_{m_d}^{j_d k_d}

    -- per axis, the twiddle ``omega_{s_d}^{i_d k_d}`` and an
    ``m_d``-point DFT over ``k_d``, then a de-interleave with factors
    ``L_d``.
    """
    n = len(shape)
    ells = tuple(sd // md for sd, md in zip(shape, factors))
    lead = tuple(c_hat.shape[:c_hat.ndim - 1 - n])
    nb = len(lead)
    dt, dev = c_hat.dtype, c_hat.device
    # (*B, m_0..m_{n-1}, L_0..L_{n-1})
    c = c_hat.reshape(lead + tuple(factors) + ells)
    for d in range(n):
        md, sd, ld = factors[d], shape[d], ells[d]
        tw = torch.as_tensor(
            np.exp(-2j * np.pi * np.outer(np.arange(md), np.arange(ld)) / sd),
            device=dev).to(dt)
        bshape = [1] * (2 * n)
        bshape[d] = md
        bshape[n + d] = ld
        c = c * tw.reshape(bshape)
        # length-m_d DFT along axis d: k_d -> j_d
        f = dft_matrix(md, dt, device=dev)
        c = torch.tensordot(f, c, dims=([1], [nb + d])).movedim(0, nb + d)
    # c[(j_0..j_{n-1}), (i_0..i_{n-1})] holds T[..., i_d + j_d*L_d, ...]:
    # an interleave of T with factors L_d (outer index j_d in m_d, inner
    # i_d in L_d), so deinterleave_nd with factors ells inverts it
    c = c.permute(list(range(nb)) + list(range(nb + n, nb + 2 * n))
                  + list(range(nb, nb + n)))             # (*B, i.., j..)
    return deinterleave_nd(c.reshape(lead + (-1,) + tuple(factors)), ells,
                           tuple(shape))
