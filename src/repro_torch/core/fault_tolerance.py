"""Byzantine fault detection/correction for coded FFT (paper Remark 3).

Because the worker results form an (N, m)-MDS codeword (per payload column),
receiving ``k`` results allows *detecting* up to ``k - m`` arbitrarily wrong
workers and *correcting* up to ``floor((k - m) / 2)`` of them -- the classic
MDS-distance argument, which the paper points out carries over to coded FFT.

Over F = C with Vandermonde/RS codes, error location is done with Prony's
method on the syndrome sequence (the complex-field analogue of
Berlekamp-Massey):

* generalized-RS syndromes at arbitrary distinct nodes ``{a_j}``:
      S_r = sum_j  r_j * u_j * a_j^r ,   r < k - m,
      u_j = 1 / prod_{l != j} (a_j - a_l)
  vanish for every valid codeword (divided-difference identity: the r-th
  syndrome is the leading coefficient of the degree-(k-1) interpolant of
  ``x^r * p(x)``, zero whenever ``deg p < m`` and ``r < k - m``).
* with ``e`` errors the syndromes become a sum of ``e`` exponentials
  ``S_r = sum_t w_t z_t^r`` whose Prony annihilator roots ``z_t`` are the
  error nodes; 2e syndromes determine them, hence ``e <= (k - m)/2``.

The syndrome and Prony math is master-side and tiny (k <= N): it stays
complex128 numpy on the host, as in the JAX package.  Only the final
decode from the clean rows runs through the plan's own ``decode(subset=
...)`` on the plan's device (on the kernel backend: ``inv(G[subset])``
through ``cmatmul``, then the recombine).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import mds
from repro_torch.core.coded_fft import CodedFFT

__all__ = [
    "lagrange_weights",
    "syndromes",
    "detect_errors",
    "locate_errors",
    "correct_errors",
    "RobustDecodeResult",
    "robust_decode",
    "RobustCodedFFT",
]


def lagrange_weights(nodes: np.ndarray) -> np.ndarray:
    """u_j = 1 / prod_{l != j}(a_j - a_l) for distinct nodes."""
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    return 1.0 / np.prod(diff, axis=1)


def syndromes(nodes: np.ndarray, received: np.ndarray, m: int) -> np.ndarray:
    """Syndrome matrix, shape ``(k - m, L)`` for received values ``(k, L)``."""
    k = nodes.shape[0]
    u = lagrange_weights(nodes)
    powers = np.vander(nodes, N=k - m, increasing=True).T  # (k-m, k)
    return (powers * u[None, :]) @ received


def detect_errors(
    nodes: np.ndarray, received: np.ndarray, m: int, tol: float = 1e-6
) -> bool:
    """True iff the received rows are NOT a valid codeword (some worker lied).

    Detects up to ``k - m`` arbitrary errors (any fewer errors cannot produce
    another codeword, by MDS distance).
    """
    s = syndromes(nodes, received, m)
    scale = max(np.abs(received).max(), 1.0)
    return bool(np.abs(s).max() > tol * scale)


def locate_errors(
    nodes: np.ndarray,
    received: np.ndarray,
    m: int,
    tol: float = 1e-6,
) -> Optional[np.ndarray]:
    """Return indices (into the received subset) of erroneous workers.

    Tries error counts e = 0, 1, ..., floor((k-m)/2) and returns the first
    hypothesis whose corrected word passes the syndrome check; None if no
    consistent hypothesis exists (more errors than correctable).
    """
    k = nodes.shape[0]
    n_syn = k - m
    e_max = n_syn // 2
    syn = syndromes(nodes, received, m)  # (n_syn, L)
    scale = max(np.abs(received).max(), 1.0)
    if np.abs(syn).max() <= tol * scale:
        return np.zeros((0,), dtype=np.int64)
    # random projection across payload columns -> scalar syndrome sequence;
    # error positions are column-independent so a generic projection keeps them.
    rng = np.random.default_rng(0)
    rho = rng.normal(size=syn.shape[1]) + 1j * rng.normal(size=syn.shape[1])
    s = syn @ rho  # (n_syn,)
    for e in range(1, e_max + 1):
        if n_syn < 2 * e:
            break
        # Prony: solve Hankel system for monic annihilator Lambda of degree e
        rows = n_syn - e
        a_mat = np.stack([s[i : i + e] for i in range(rows)])  # (rows, e)
        rhs = -s[e : e + rows]
        coeffs, *_ = np.linalg.lstsq(a_mat, rhs, rcond=None)
        # Lambda(x) = x^e + coeffs[e-1] x^{e-1} + ... + coeffs[0]
        poly = np.concatenate([[1.0 + 0j], coeffs[::-1]])
        roots = np.roots(poly)
        # match roots to nearest received node
        idx = np.unique(np.argmin(np.abs(roots[:, None] - nodes[None, :]), axis=1))
        if idx.shape[0] != e:
            continue
        # hypothesis check: solve error values per column, verify residual
        basis = np.vander(nodes[idx], N=n_syn, increasing=True).T  # (n_syn, e)
        u = lagrange_weights(nodes)
        design = basis * u[idx][None, :]
        vals, *_ = np.linalg.lstsq(design, syn, rcond=None)  # (e, L)
        resid = syn - design @ vals
        if np.abs(resid).max() <= max(tol * scale, 1e-9):
            return idx.astype(np.int64)
    return None


def correct_errors(
    nodes: np.ndarray,
    received: np.ndarray,
    m: int,
    tol: float = 1e-6,
) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Return ``(corrected rows, error indices)``, or None if uncorrectable.

    The returned indices are the ones ``locate_errors`` found, so callers
    never need a second Prony pass to learn who lied.
    """
    err_idx = locate_errors(nodes, received, m, tol)
    if err_idx is None:
        return None
    if err_idx.shape[0] == 0:
        return received, err_idx
    k = nodes.shape[0]
    n_syn = k - m
    syn = syndromes(nodes, received, m)
    u = lagrange_weights(nodes)
    basis = np.vander(nodes[err_idx], N=n_syn, increasing=True).T
    design = basis * u[err_idx][None, :]
    weighted_err, *_ = np.linalg.lstsq(design, syn, rcond=None)  # (e, L)
    corrected = received.copy()
    corrected[err_idx] -= weighted_err
    return corrected, err_idx


@dataclasses.dataclass
class RobustDecodeResult:
    output: Optional[np.ndarray]
    n_errors_corrected: int
    error_worker_indices: np.ndarray  # global worker ids found erroneous
    ok: bool


def _host_rows(b) -> np.ndarray:
    """Worker rows as complex128 numpy on the host."""
    if isinstance(b, torch.Tensor):
        b = b.detach().cpu().numpy()
    return np.asarray(b, dtype=np.complex128)


def robust_decode(
    strategy: CodedFFT,
    b,
    recv_idx: np.ndarray,
    tol: float = 1e-6,
) -> RobustDecodeResult:
    """Decode coded-FFT worker results with Byzantine workers present.

    ``b``: ``(N, *shard)`` results (a tensor or an array), of which only
    rows ``recv_idx`` (k of them) arrived; up to floor((k - m)/2) of those
    may be arbitrarily corrupted.  Works for any MDS plan whose evaluation
    nodes are ``mds.rs_nodes(n_workers)`` -- the syndrome math runs on
    rows flattened per payload column, the final decode on the original
    shard shape, through ``strategy.decode`` on the plan's device.
    """
    recv_idx = np.asarray(recv_idx, dtype=np.int64)
    nodes = mds.rs_nodes(strategy.n_workers, torch.complex128).numpy()[
        recv_idx]
    b_np = _host_rows(b)
    received = b_np[recv_idx].reshape(recv_idx.shape[0], -1)  # (k, L_flat)
    result = correct_errors(nodes, received, strategy.m, tol)
    if result is None:
        return RobustDecodeResult(None, 0, np.zeros(0, np.int64), ok=False)
    corrected, err_local = result  # one Prony pass: indices ride along
    n_err = int(err_local.shape[0])
    # decode from the first m *clean* received rows (global indexing)
    err_set = set(err_local.tolist())
    clean_local = [i for i in range(len(recv_idx)) if i not in err_set]
    use_local = np.asarray(clean_local[: strategy.m])
    subset = torch.as_tensor(recv_idx[use_local], device=strategy.device)
    b_full = b_np.copy()
    b_full[recv_idx] = corrected.reshape((recv_idx.shape[0],) + b_np.shape[1:])
    x = strategy.decode(
        torch.as_tensor(b_full, device=strategy.device).to(strategy.dtype),
        subset=subset)
    err_global = recv_idx[err_local] if n_err else np.zeros(0, np.int64)
    return RobustDecodeResult(x.cpu().numpy(), n_err, err_global, ok=True)


@dataclasses.dataclass(frozen=True)
class RobustCodedFFT:
    """Coded FFT with Byzantine-fault correction layered on top (Remark 3)."""

    strategy: CodedFFT
    tol: float = 1e-6

    def max_correctable(self, k_received: int) -> int:
        return (k_received - self.strategy.m) // 2

    def max_detectable(self, k_received: int) -> int:
        return k_received - self.strategy.m

    def run(self, x: torch.Tensor, recv_idx: np.ndarray) -> RobustDecodeResult:
        b = self.strategy.worker_compute(self.strategy.encode(x))
        return robust_decode(self.strategy, b, recv_idx, self.tol)
