"""Complex Reed-Solomon MDS codes for coded computation (PyTorch).

Over ``C`` the ``(N, m)`` code is the Vandermonde generator at the N-th
roots of unity::

    G[k, i] = alpha_k ** i,   alpha_k = exp(-2j * pi * k / N),   i < m

Every ``m x m`` submatrix is a Vandermonde matrix on distinct unit-circle
nodes, hence invertible: the code is MDS and the recovery threshold is
exactly ``m``.  Encoding is a zero-padded length-N DFT over the shard axis.

Message ``c`` has shape ``(m, *payload)`` and codeword ``a``
``(n, *payload)``.  Every function takes an explicit ``device`` where it
creates tensors; the others follow their inputs.

``inv(G[subset])`` has a closed form (the Lagrange basis coefficients at
the subset's nodes): :func:`lagrange_inverse` builds it in O(m^2) with
no ``linalg.inv``, which is what lets the service's bucket kernel form
per-request decode matrices on the device.  The same coefficients give
the O(s log N) transform decode (:func:`decode_ifft`); :func:`decode_auto`
picks it or the dense solve.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = [
    "rs_nodes",
    "rs_generator",
    "encode",
    "encode_dft",
    "subset_decode_matrix",
    "decode_from_subset",
    "first_available",
    "decode_masked",
    "lagrange_decode_coeffs",
    "lagrange_inverse",
    "lagrange_decode_matrix",
    "lagrange_decode_matrices",
    "LAGRANGE_MAX_M",
    "decode_ifft",
    "decode_ifft_batched",
    "is_contiguous_subset",
    "contiguous_flag",
    "IFFT_AUTO_MAX_M",
    "decode_auto",
]

# Largest m served by the device-resident Lagrange decode; past ~32 the
# f32 planes the kernels decode in cannot carry adversarial (contiguous
# arc) subset conditioning, and the reference falls back to a host
# complex128 decode-matrix cache (a later slice of the port).
LAGRANGE_MAX_M = 32

def _exp_i(ang: np.ndarray, dtype, device) -> torch.Tensor:
    """``exp(1j * ang)`` computed in complex128, cast to ``dtype``."""
    return torch.as_tensor(np.exp(1j * ang), device=device).to(dtype)


def _polar(ang: torch.Tensor, dtype) -> torch.Tensor:
    """``exp(1j * ang)`` for a float64 angle tensor, cast to ``dtype``."""
    return torch.polar(torch.ones_like(ang), ang).to(dtype)


def rs_nodes(n: int, dtype=torch.complex64, device=None) -> torch.Tensor:
    """The ``n`` evaluation nodes ``exp(-2j*pi*k/n)``, ``k < n``."""
    return _exp_i(-2.0 * np.pi * np.arange(n) / n, dtype, device)


def rs_generator(n: int, m: int, dtype=torch.complex64,
                 device=None) -> torch.Tensor:
    """``(n, m)`` Vandermonde generator ``G[k, i] = alpha_k**i``."""
    if m > n:
        raise ValueError(f"need n >= m, got n={n} m={m}")
    nodes = np.exp(-2j * np.pi * np.arange(n) / n)
    g = nodes[:, None] ** np.arange(m)[None, :]
    return torch.as_tensor(g, device=device).to(dtype)


def _flatten_payload(c: torch.Tensor):
    return c.reshape(c.shape[0], -1), tuple(c.shape[1:])


def encode(generator: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Encode ``m`` message shards into ``n`` coded shards: ``a = G @ c``."""
    flat, payload = _flatten_payload(c)
    coded = generator.to(flat.dtype) @ flat
    return coded.reshape((generator.shape[0],) + payload)


def encode_dft(c: torch.Tensor, n: int) -> torch.Tensor:
    """Fast encode for the roots-of-unity generator: evaluating the message
    polynomial at all ``n`` roots of unity is a zero-padded length-``n``
    DFT along the shard axis."""
    m = c.shape[0]
    if n < m:
        raise ValueError(f"need n >= m, got n={n} m={m}")
    return torch.fft.fft(c, n=n, dim=0)


def subset_decode_matrix(generator: torch.Tensor,
                         subset: torch.Tensor) -> torch.Tensor:
    """Inverse of the ``m x m`` generator submatrix picked by ``subset``."""
    return torch.linalg.inv(generator[subset.long()])


def decode_from_subset(generator: torch.Tensor, b: torch.Tensor,
                       subset: torch.Tensor) -> torch.Tensor:
    """Recover the ``m`` message shards from the coded results in
    ``subset``.  Rows outside ``subset`` are never read, so stragglers may
    hold garbage (NaN included)."""
    m = generator.shape[1]
    if subset.shape[0] != m:
        raise ValueError(f"subset must have exactly m={m} entries")
    flat, payload = _flatten_payload(b)
    subset = subset.long()
    rows = flat[subset]
    sub = generator[subset].to(flat.dtype)
    return torch.linalg.solve(sub, rows).reshape((m,) + payload)


def first_available(mask: torch.Tensor, m: int) -> torch.Tensor:
    """Indices of the first ``m`` available workers (stable order):
    responders first, in index order, then non-responders."""
    order = torch.argsort(torch.logical_not(mask).to(torch.uint8), dim=-1,
                          stable=True)
    return order[..., :m]


def decode_masked(generator: torch.Tensor, b: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Decode from whichever ``m`` workers are available per ``mask``."""
    m = generator.shape[1]
    return decode_from_subset(generator, b, first_available(mask, m))


def _locator(nodes: torch.Tensor, m: int) -> torch.Tensor:
    """Ascending coefficients of ``prod_j (z - nodes_j)``, batched over
    leading axes of ``nodes (..., m)``, factors multiplied in a shuffled
    static order (arc order blows the partial products up)."""
    a = torch.zeros(nodes.shape[:-1] + (m + 1,), dtype=nodes.dtype,
                    device=nodes.device)
    a[..., 0] = 1.0
    for i in np.random.default_rng(0).permutation(m):
        shifted = torch.cat([torch.zeros_like(a[..., :1]), a[..., :m]], -1)
        a = shifted - nodes[..., i:i + 1] * a
    return a


def lagrange_decode_coeffs(subset: torch.Tensor, n: int, m: int,
                           dtype=torch.complex128):
    """Payload-independent decode precompute for the nodes in ``subset``:
    ``(a, dinv)`` with ``a`` the (m+1,) locator coefficients and ``dinv``
    (m,) = ``1 / A'(omega^{subset_j})``.  Leading axes of ``subset (...,
    m)`` batch both."""
    nodes = rs_nodes(n, dtype, subset.device)[subset.long()]
    diff = nodes[..., :, None] - nodes[..., None, :]
    diff = diff + torch.eye(m, dtype=dtype, device=subset.device)
    dinv = 1.0 / torch.prod(diff, dim=-1)
    return _locator(nodes, m), dinv


def lagrange_inverse(subset: torch.Tensor, n: int,
                     dtype=torch.complex64) -> torch.Tensor:
    """Closed-form ``inv(rs_generator(n, m)[subset])`` -- O(m^2).

    ``subset``: ``(..., m)`` integer worker indices (distinct per row).
    Returns the ``(..., m, m)`` compact decode matrices.
    """
    m = subset.shape[-1]
    dev = subset.device
    sub = subset.long()
    # exact node powers P[j, d] = x_j^d via the root-of-unity closed form
    ang = (sub[..., :, None] * torch.arange(m, device=dev)) % n
    p = _polar(-2.0 * np.pi * ang.double() / n, dtype)
    nodes = _polar(-2.0 * np.pi * sub.double() / n, dtype)
    a = _locator(nodes, m)
    # deflation, suffix form: T[i, d] = a[i + d + 1] (0 past the end);
    # q[i, j] = sum_d T[i, d] x_j^d are the coefficients of A(z)/(z - x_j)
    ii, dd = np.indices((m, m))
    hi = ii + dd + 1
    keep = torch.as_tensor(hi <= m, device=dev).to(dtype)
    t = a[..., torch.as_tensor(np.minimum(hi, m), device=dev)] * keep
    q = t @ p.transpose(-1, -2)
    # A'(x_j) = Q_j(x_j) = sum_i q[i, j] x_j^i
    aprime = torch.einsum("...ij,...ji->...j", q, p)
    return q / aprime[..., None, :]


def lagrange_decode_matrix(mask: torch.Tensor, m: int,
                           dtype=torch.complex64) -> torch.Tensor:
    """Per-mask ``(m, n)`` SCATTER decode matrix: columns of the first
    ``m`` available workers hold ``inv(G[subset])``, straggler columns are
    zero, so ``c_hat = D @ b`` never reads their rows."""
    return lagrange_decode_matrices(mask[None], m, dtype)[0]


def lagrange_decode_matrices(masks: torch.Tensor, m: int,
                             dtype=torch.complex64) -> torch.Tensor:
    """Batched :func:`lagrange_decode_matrix`: ``(B, n)`` -> ``(B, m, n)``."""
    n = masks.shape[-1]
    subsets = first_available(masks, m)
    inv = lagrange_inverse(subsets, n, dtype)
    onehot = (subsets[..., :, None]
              == torch.arange(n, device=masks.device)).to(inv.dtype)
    return inv @ onehot


def decode_ifft_batched(b: torch.Tensor, subsets: torch.Tensor,
                        n: Optional[int] = None) -> torch.Tensor:
    """:func:`decode_ifft` of ``nb`` requests at once: ``b (nb, n,
    *payload)`` with per-request responder indices ``subsets (nb, m)``
    -> ``(nb, m, *payload)``.  Each request's arithmetic is exactly the
    single-request decode's."""
    nb = b.shape[0]
    n = b.shape[1] if n is None else n
    m = subsets.shape[-1]
    payload = tuple(b.shape[2:])
    flat = b.reshape(nb, b.shape[1], -1)
    dtype = flat.dtype
    if m == n:
        # full response set (any subset is a permutation of it): the
        # literal inverse of the zero-padded DFT encode -- exact, stable at
        # any m, one FFT
        c = torch.fft.ifft(flat.transpose(1, 2), dim=-1)[..., :m]
        return c.transpose(1, 2).reshape((nb, m) + payload).to(dtype)
    subsets = subsets.long()
    a, dinv = lagrange_decode_coeffs(subsets, n, m, dtype)
    # work in (P, n) layout so both FFTs run along the contiguous last axis
    rows = flat[torch.arange(nb, device=flat.device)[:, None], subsets]
    g = rows.transpose(1, 2) * dinv[:, None, :]                 # (nb, P, m)
    g_grid = torch.zeros((nb, flat.shape[2], n), dtype=dtype,
                         device=flat.device)
    g_grid.scatter_(2, subsets[:, None, :].expand(g.shape), g)
    big = torch.fft.fft(g_grid, dim=-1)[..., :m]                # G_d, d < m
    # c_u = sum_t a_t G_{t-1-u} == linear_conv(a, reverse(G))[u + m]
    two_m = 2 * m
    a_hat = torch.fft.fft(a, n=two_m, dim=-1)
    conv = torch.fft.ifft(
        a_hat[:, None, :] * torch.fft.fft(torch.flip(big, dims=(-1,)),
                                          n=two_m, dim=-1), dim=-1)
    c = conv[..., m:two_m].transpose(1, 2)
    return c.reshape((nb, m) + payload).to(dtype)


def decode_ifft(b: torch.Tensor, subset: torch.Tensor,
                n: Optional[int] = None) -> torch.Tensor:
    """O(s log N) subset decode via the inverse zero-padded DFT mapping.

    ``b``: ``(n, *payload)`` worker results (rows outside ``subset`` are
    never read, so stragglers may hold garbage/NaN); ``subset``: ``(m,)``
    responder indices.  Exact in exact arithmetic for ANY subset (the
    Lagrange erasure formula); in floats its error tracks the subset's
    interpolation conditioning, which for contiguous arcs grows
    exponentially in ``m`` -- hence :func:`decode_auto` routes here only
    for small ``m`` or the exactly-stable full set.  The platform FFTs
    here are the reference's too: this is no kernel site.
    """
    return decode_ifft_batched(b[None], subset[None], n)[0]


def is_contiguous_subset(subset, n: int) -> bool:
    """Does ``subset`` form one contiguous run mod ``n``?"""
    got = np.zeros(n, bool)
    got[np.asarray(subset) % n] = True
    boundaries = int(np.sum(got & ~np.roll(got, -1)))
    return boundaries <= 1


def contiguous_flag(subset: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`is_contiguous_subset` as a tensor function: a 0-d bool
    tensor on ``subset``'s device."""
    got = torch.zeros(n, dtype=torch.bool, device=subset.device)
    got[subset.long() % n] = True
    return torch.sum(got & ~torch.roll(got, -1)) <= 1


# Largest m for which the transform decode is routed to automatically on a
# contiguous (non-full) arc: up to here its float error stays within a
# small factor of the dense solve's on the same (intrinsically worsening)
# arcs.
IFFT_AUTO_MAX_M = 8


def decode_auto(generator: torch.Tensor, b: torch.Tensor,
                subset: torch.Tensor, *, method: str = "auto"
                ) -> torch.Tensor:
    """Subset decode with fast-path dispatch.

    ``method``: ``"solve"`` forces the dense Vandermonde solve, ``"ifft"``
    forces the O(s log N) transform decode, ``"auto"`` picks ``ifft`` when
    it is numerically safe -- the full set (m == N, exact at any size) or
    a contiguous-mod-N subset with ``m <= IFFT_AUTO_MAX_M`` -- and the
    backward-stable ``solve`` otherwise.  A batch with per-request subsets
    resolves ``auto`` to ``solve`` in the plans, as the reference does.
    """
    n, m = generator.shape
    if subset.shape[0] != m:
        raise ValueError(f"subset must have exactly m={m} entries")
    if method == "solve":
        return decode_from_subset(generator, b, subset)
    if method == "ifft":
        return decode_ifft(b, subset, n)
    if method != "auto":
        raise ValueError(f"unknown decode method {method!r}")
    if m == n:
        return decode_ifft(b, subset, n)
    if m > IFFT_AUTO_MAX_M:
        return decode_from_subset(generator, b, subset)
    if bool(contiguous_flag(subset, n)):
        return decode_ifft(b, subset, n)
    return decode_from_subset(generator, b, subset)
