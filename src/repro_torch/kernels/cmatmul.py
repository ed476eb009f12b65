"""Planar complex matmul: the plain bodies and the ``bcmatmul`` kernel.

``bcmatmul`` is the per-request decode apply of the service's stage
route: every request in a bucket carries its OWN (m, N) scatter decode
matrix, so the contraction is a batched ``(q, m, N) @ (q, N, L)``.  The
CUDA kernel is ``csrc/bcmatmul.cu``; its plain twin is
:func:`bcmatmul_body`.  ``cmatmul`` (the plan-level ``mds_apply``) is a
later slice; :func:`cmatmul_body` is here because the other plain bodies
use it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["cmatmul_body", "bcmatmul_body", "bcmatmul"]

# the left matrix lives in shared memory: cap it at the static 48 KB
_MAX_LEFT_BYTES = 48 * 1024


def cmatmul_body(ar, ai, br, bi):
    """Planar complex matmul ``(M, K) @ (K, L)``: 4 real matmuls, f32."""
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def bcmatmul_body(ar, ai, br, bi):
    """Batched planar complex matmul ``(q, M, K) @ (q, K, L)``."""
    return (torch.matmul(ar, br) - torch.matmul(ai, bi),
            torch.matmul(ar, bi) + torch.matmul(ai, br))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("bcmatmul")
    fn = lib.bcmatmul_f32
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp, vp, i64, vp, vp, vp, vp, i32, i32, i32, i64, vp]
    fn.restype = ctypes.c_int
    return fn


def bcmatmul(ar, ai, br, bi):
    """Batched planar complex matmul ``(q, M, K) @ (q, K, L) -> (q, M, L)``.

    CPU tensors run :func:`bcmatmul_body`; CUDA tensors launch the kernel
    (one launch) or raise.
    """
    q, m, k = ar.shape
    if br.shape[:2] != (q, k) or ai.shape != ar.shape or bi.shape != br.shape:
        raise ValueError(f"bcmatmul: shapes {tuple(ar.shape)} @ "
                         f"{tuple(br.shape)} do not contract")
    if ar.device.type == "cpu":
        return bcmatmul_body(ar, ai, br, bi)
    dev = _build.check_planes("bcmatmul", ar=ar, ai=ai, br=br, bi=bi)
    if 2 * m * k * 4 > _MAX_LEFT_BYTES:
        raise ValueError(f"bcmatmul: left matrix ({m}, {k}) exceeds the "
                         f"kernel's shared-memory tile")
    ell = br.shape[2]
    cr = torch.empty((q, m, ell), dtype=torch.float32, device=dev)
    ci = torch.empty_like(cr)
    p = _build.ptr
    _build.check(_lib()(p(ar), p(ai), m * k, p(br), p(bi), p(cr), p(ci),
                        q, m, k, ell, _build.stream_of(dev)), "bcmatmul")
    _build.count_launch("bcmatmul")
    return cr, ci
