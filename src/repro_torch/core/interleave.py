"""Interleaving (decimation in time) for the coded FFT.

1-D (paper eq. 20): ``c_i[j] = x[i + j*m]`` for ``i < m``, ``j < s/m``;
the transform axis is axis 0, as in the reference.

n-D (paper eq. 28, with the stride along axis ``k`` being ``m_k``):

    c_{(i_0..i_{n-1})}[j_0..j_{n-1}] = t[i_0 + j_0*m_0, ..., i_{n-1} + j_{n-1}*m_{n-1}]

The ``prod(m_k) = m`` interleaved tensors are stacked along a shard axis
in row-major order of ``(i_0, ..., i_{n-1})``.  The n-D pair acts on the
trailing ``len(factors)`` axes, so leading batch axes map through.
"""

from __future__ import annotations

import math

import torch

__all__ = ["interleave", "deinterleave", "interleave_nd", "deinterleave_nd"]


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


def interleave_nd(t: torch.Tensor, factors: tuple[int, ...]) -> torch.Tensor:
    """Interleave the trailing n axes of ``t`` by ``m_k`` along axis ``k``.

    ``t``: ``(*B, s_0, ..., s_{n-1})``; ``factors``: ``(m_0, ..., m_{n-1})``
    with ``m_k | s_k``.  Returns ``(*B, m, s_0/m_0, ..., s_{n-1}/m_{n-1})``
    with ``m = prod(m_k)`` and the shard axis enumerating
    ``(i_0..i_{n-1})`` in row-major order.
    """
    n = len(factors)
    if t.ndim < n:
        raise ValueError(f"tensor rank {t.ndim} < len(factors) {n}")
    lead = tuple(t.shape[:t.ndim - n])
    nb = len(lead)
    shape = []
    for sk, mk in zip(t.shape[nb:], factors):
        if sk % mk != 0:
            raise ValueError(f"factor {mk} must divide dim {sk}")
        shape.extend([sk // mk, mk])
    # (*B, L_0, m_0, L_1, m_1, ...) -> (*B, m_0..m_{n-1}, L_0..L_{n-1})
    r = t.reshape(lead + tuple(shape))
    perm = (list(range(nb)) + [nb + 2 * k + 1 for k in range(n)]
            + [nb + 2 * k for k in range(n)])
    ells = tuple(shape[0::2])
    return r.permute(perm).reshape(lead + (math.prod(factors),) + ells)


def deinterleave_nd(c: torch.Tensor, factors: tuple[int, ...],
                    out_shape: tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`interleave_nd`: ``(*B, m, L_0, ..., L_{n-1})`` ->
    ``(*B, *out_shape)``."""
    n = len(factors)
    ells = tuple(sk // mk for sk, mk in zip(out_shape, factors))
    lead = tuple(c.shape[:c.ndim - 1 - n])
    nb = len(lead)
    r = c.reshape(lead + tuple(factors) + ells)
    # (*B, m_0..m_{n-1}, L_0..L_{n-1}) -> (*B, L_0, m_0, L_1, m_1, ...)
    perm = list(range(nb))
    for k in range(n):
        perm.extend([nb + n + k, nb + k])
    return r.permute(perm).reshape(lead + tuple(out_shape))
