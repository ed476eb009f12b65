"""Fused twiddle + length-m DFT recombination: plain body and kernel.

The master's second decode stage (paper eq. 24) is

    X[i + j*(s/m)] = sum_k C[k, i] * omega_s^{ik} * omega_m^{jk}

an elementwise twiddle ``T = C * W`` fused with a dense length-m DFT
``F_m @ T``.  ``recombine_twiddle_dft_batched`` runs it on a whole bucket
``(q, m, L)``: the CUDA kernel is ``csrc/recombine.cu``, its plain twin
:func:`recombine_batched_body`.  The single-request kernel
(``recombine_twiddle_dft``) is a later slice.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["recombine_batched_body", "recombine_twiddle_dft_batched",
           "MAX_M"]

# the kernel unrolls the shard axis to a compile-time bound: the host
# decode path's widest code (m = 64, N = 128) included
MAX_M = 64


def recombine_batched_body(cr, ci, wr, wi, fr, fi):
    """Batched recombine on planar (q, m, L) data; the twiddle/DFT planes
    are shared across the bucket, so the batch folds into the columns."""
    bq, m, bl = cr.shape
    tr = cr * wr[None] - ci * wi[None]
    ti = cr * wi[None] + ci * wr[None]
    tr = tr.transpose(0, 1).reshape(m, bq * bl)
    ti = ti.transpose(0, 1).reshape(m, bq * bl)
    outr = fr @ tr - fi @ ti
    outi = fr @ ti + fi @ tr
    return (outr.reshape(m, bq, bl).transpose(0, 1),
            outi.reshape(m, bq, bl).transpose(0, 1))


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _build.load("recombine").recombine_batched_f32
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp] * 8 + [i32, i32, i64, vp]
    fn.restype = ctypes.c_int
    return fn


def recombine_twiddle_dft_batched(cr, ci, wr, wi, fr, fi):
    """Batched fused ``F @ (C * W)`` on planar (q, m, L) data.

    ``wr/wi`` (m, L) and ``fr/fi`` (m, m) are shared across the bucket.
    CPU tensors run :func:`recombine_batched_body`; CUDA tensors launch
    the kernel (one launch, ``m <= MAX_M``) or raise.
    """
    q, m, ell = cr.shape
    if (ci.shape != cr.shape or wr.shape != (m, ell) or wi.shape != (m, ell)
            or fr.shape != (m, m) or fi.shape != (m, m)):
        raise ValueError("recombine_twiddle_dft_batched: inconsistent shapes")
    if cr.device.type == "cpu":
        return recombine_batched_body(cr, ci, wr, wi, fr, fi)
    dev = _build.check_planes("recombine_twiddle_dft_batched", cr=cr, ci=ci,
                              wr=wr, wi=wi, fr=fr, fi=fi)
    if m > MAX_M:
        raise NotImplementedError(
            f"recombine_twiddle_dft_batched: m={m} > {MAX_M}, the kernel's "
            f"unrolled shard bound")
    outr = torch.empty_like(cr)
    outi = torch.empty_like(cr)
    p = _build.ptr
    _build.check(_lib()(p(cr), p(ci), p(wr), p(wi), p(fr), p(fi), p(outr),
                        p(outi), q, m, ell, _build.stream_of(dev)),
                 "recombine_twiddle_dft_batched")
    _build.count_launch("recombine_twiddle_dft_batched")
    return outr, outi
