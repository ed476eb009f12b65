"""Interleaving (decimation in time) for the 1-D coded FFT.

``c_i[j] = x[i + j*m]`` for ``i < m``, ``j < s/m`` (paper eq. 20).  The
transform axis is axis 0, as in the reference; the n-D pair
(``interleave_nd``/``deinterleave_nd``) is a later slice.
"""

from __future__ import annotations

import torch

__all__ = ["interleave", "deinterleave"]


def interleave(x: torch.Tensor, m: int) -> torch.Tensor:
    """Split ``x`` (transform axis 0, length ``s``) into ``m`` interleaved
    vectors: shape ``(m, s // m, *rest)``."""
    s = x.shape[0]
    if s % m != 0:
        raise ValueError(f"m={m} must divide s={s}")
    # x[i + j*m] == x.reshape(s//m, m)[j, i]
    return x.reshape((s // m, m) + tuple(x.shape[1:])).transpose(0, 1)


def deinterleave(c: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`interleave`: ``(m, L, *rest) -> (m*L, *rest)``."""
    m, ell = c.shape[0], c.shape[1]
    return c.transpose(0, 1).reshape((m * ell,) + tuple(c.shape[2:]))
