"""Planar complex matmul: the ``cmatmul`` and ``bcmatmul`` kernels.

``cmatmul`` is the plan's ``mds_apply``: a small ``(M, K)`` code matrix
against a wide ``(K, L)`` payload -- the encode ``G @ c`` with the batch
folded into the payload columns, and the unbatched decode
``inv(G[subset]) @ b``.  ``bcmatmul`` is the per-request decode apply of
the service's stage route: every request in a bucket carries its OWN
(m, N) scatter decode matrix, so the contraction is a batched
``(q, m, N) @ (q, N, L)``.  CUDA sources ``csrc/cmatmul.cu`` (the
kernel of ``csrc/common.cuh``) and ``csrc/bcmatmul.cu`` (its own kernel:
the live columns of each decode matrix only, in the thread map
:func:`bcmatmul_map` picks); plain twins :func:`cmatmul_body` and
:func:`bcmatmul_body`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["cmatmul_body", "cmatmul", "bcmatmul_body", "bcmatmul",
           "bcmatmul_map", "check_left_fits"]

# csrc/bcmatmul.cu: a wide thread owns 4 payload columns of a 256-thread
# block and keeps at most 16 output rows in registers
WIDE_MIN_L = 4 * 256
WIDE_MAX_M = 16


def cmatmul_body(ar, ai, br, bi):
    """Planar complex matmul ``(M, K) @ (K, L)``: 4 real matmuls, f32."""
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def bcmatmul_body(ar, ai, br, bi):
    """Batched planar complex matmul ``(q, M, K) @ (q, K, L)``."""
    return (torch.matmul(ar, br) - torch.matmul(ai, bi),
            torch.matmul(ar, bi) + torch.matmul(ai, br))


def check_left_fits(what: str, m: int, k: int) -> None:
    """Raise unless an ``(m, k)`` left matrix fits the bcmatmul kernel's
    shared memory: its planes (2*m*k floats) against the card's opt-in
    per-block limit, which the launch opts in to past 48 KB."""
    if 2 * m * k * 4 > _build.SMEM_PER_BLOCK_OPTIN:
        raise ValueError(f"{what}: left matrix ({m}, {k}) needs "
                         f"{2 * m * k * 4} bytes of shared memory, over "
                         f"{_build.SMEM_PER_BLOCK_OPTIN}")


@functools.lru_cache(maxsize=None)
def _cmatmul_lib():
    fn = _build.load("cmatmul").cmatmul_f32
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 6 + [i32, i32, ctypes.c_longlong, vp]
    fn.restype = ctypes.c_int
    return fn


def cmatmul(ar, ai, br, bi):
    """Planar complex matmul ``(M, K) @ (K, L) -> (M, L)``.

    CPU tensors run :func:`cmatmul_body`; CUDA tensors launch the kernel
    (one launch) or raise.
    """
    m, k = ar.shape
    if br.ndim != 2 or br.shape[0] != k or ai.shape != ar.shape \
            or bi.shape != br.shape:
        raise ValueError(f"cmatmul: shapes {tuple(ar.shape)} @ "
                         f"{tuple(br.shape)} do not contract")
    if ar.device.type == "cpu":
        return cmatmul_body(ar, ai, br, bi)
    dev = _build.check_planes("cmatmul", ar=ar, ai=ai, br=br, bi=bi)
    check_left_fits("cmatmul", m, k)
    ell = br.shape[1]
    cr = torch.empty((m, ell), dtype=torch.float32, device=dev)
    ci = torch.empty_like(cr)
    p = _build.ptr
    _build.check(_cmatmul_lib()(p(ar), p(ai), p(br), p(bi), p(cr), p(ci),
                                m, k, ell, _build.stream_of(dev)), "cmatmul")
    _build.count_launch("cmatmul")
    return cr, ci


def bcmatmul_map(m: int, ell: int) -> str:
    """The bcmatmul kernel's thread map for ``m`` output rows and ``ell``
    payload columns: ``"wide"`` (a thread owns 4 columns and every row's
    accumulators, B and C streamed once) where the payload fills at least
    one block and ``m <= 16``, else ``"narrow"`` (16 x 64 output tiles)."""
    return "wide" if ell >= WIDE_MIN_L and m <= WIDE_MAX_M else "narrow"


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("bcmatmul")
    fn = lib.bcmatmul_f32
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp] * 6 + [i32, i32, i32, i64, i32, i32, vp]
    fn.restype = ctypes.c_int
    return fn


def bcmatmul(ar, ai, br, bi):
    """Batched planar complex matmul ``(q, M, K) @ (q, K, L) -> (q, M, L)``.

    CPU tensors run :func:`bcmatmul_body`; CUDA tensors launch the kernel
    (one launch) or raise.  The kernel skips every column k of ``A[q]``
    that is exactly zero in both planes (a scatter decode matrix's
    straggler columns), so ``B[q][k]`` is never read there: the same
    result for finite B, and no NaN from a non-finite straggler row,
    where the plain product gives one.  The CPU route skips them too: it
    zeroes those rows of B before the plain product.
    """
    q, m, k = ar.shape
    if br.shape[:2] != (q, k) or ai.shape != ar.shape or bi.shape != br.shape:
        raise ValueError(f"bcmatmul: shapes {tuple(ar.shape)} @ "
                         f"{tuple(br.shape)} do not contract")
    if ar.device.type == "cpu":
        live = ((ar != 0) | (ai != 0)).any(dim=1)[:, :, None]   # (q, k, 1)
        zero = br.new_zeros(())
        return bcmatmul_body(ar, ai, torch.where(live, br, zero),
                             torch.where(live, bi, zero))
    dev = _build.check_planes("bcmatmul", ar=ar, ai=ai, br=br, bi=bi)
    check_left_fits("bcmatmul", m, k)
    if q > _build.MAX_GRID_YZ:
        raise ValueError(f"bcmatmul: batch q={q} exceeds the grid's "
                         f"{_build.MAX_GRID_YZ}")
    ell = br.shape[2]
    cr = torch.empty((q, m, ell), dtype=torch.float32, device=dev)
    ci = torch.empty_like(cr)
    wide = bcmatmul_map(m, ell) == "wide"
    vec = ell % 4 == 0 and all(t.data_ptr() % 16 == 0
                               for t in (br, bi, cr, ci))
    p = _build.ptr
    _build.check(_lib()(p(ar), p(ai), p(br), p(bi), p(cr), p(ci), q, m, k,
                        ell, int(wide), int(vec), _build.stream_of(dev)),
                 "bcmatmul")
    _build.count_launch("bcmatmul")
    return cr, ci
