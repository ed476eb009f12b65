"""Fused twiddle + length-m DFT recombination: plain body and kernel.

The master's second decode stage (paper eq. 24) is

    X[i + j*(s/m)] = sum_k C[k, i] * omega_s^{ik} * omega_m^{jk}

an elementwise twiddle ``T = C * W`` fused with a dense length-m DFT
``F_m @ T``.  ``recombine_twiddle_dft_batched`` runs it on a whole bucket
``(q, m, L)`` and ``recombine_twiddle_dft`` on one request ``(m, L)``,
the same launch of ``csrc/recombine.cu`` on a bucket of one, counted
under its own name.  Their plain twins are :func:`recombine_batched_body`
and :func:`recombine_body`.  The kernel has two designs, a thread per
column for narrow codes and a block per tile of positions for wide ones;
:func:`recombine_design` routes by m.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["recombine_body", "recombine_twiddle_dft",
           "recombine_batched_body", "recombine_twiddle_dft_batched",
           "recombine_design", "MAX_M", "TILE_MIN_M"]

# the kernel unrolls the shard axis to a compile-time bound: the host
# decode path's widest code (m = 64, N = 128) included
MAX_M = 64
# the narrowest code the tile design takes (see recombine_design)
TILE_MIN_M = 16


def recombine_design(m: int) -> str:
    """The kernel design that recombines an m-shard code:
    ``"column"`` (one thread per (request, position) column, the m
    values in its registers) below :data:`TILE_MIN_M`, ``"tile"`` (one
    block per request and tile of 32 positions, the outputs split over
    its warps) from there.  A route by m, not a fallback: both designs
    serve every m and payload length.  The crossover is timed
    (``chip_smoke.py``'s ``recombine_designs`` phase, both designs forced
    at m = 4, 8, 16, 32, 64): on an H100 the column design led at m <= 8
    and the tile design from m = 16, both for 64 requests of s = 4096
    (L = s / m, 64 to 1024) and for 16 of s = 2^20 (L = 2^14 to 2^18), so
    the payload length does not move it."""
    return "tile" if m >= TILE_MIN_M else "column"


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


def recombine_body(cr, ci, wr, wi, fr, fi):
    """One request's recombine on planar (m, L) data: ``F @ (C * W)``,
    the batched body on a bucket of one."""
    outr, outi = recombine_batched_body(cr[None], ci[None], wr, wi, fr, fi)
    return outr[0], outi[0]


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _build.load("recombine").recombine_batched_f32
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp] * 8 + [i32, i32, i64, i32, vp]
    fn.restype = ctypes.c_int
    return fn


def _check_m(what: str, m: int) -> None:
    if m > MAX_M:
        raise NotImplementedError(
            f"{what}: m={m} > {MAX_M}, the kernel's unrolled shard bound")


def _check_shapes(name, cr, ci, wr, wi, fr, fi):
    """(q, m, L) data, (m, L) twiddle and (m, m) DFT planes, or raise."""
    if cr.dim() != 3 or ci.shape != cr.shape:
        raise ValueError(f"{name}: inconsistent shapes")
    q, m, ell = cr.shape
    if (wr.shape != (m, ell) or wi.shape != (m, ell)
            or fr.shape != (m, m) or fi.shape != (m, m)):
        raise ValueError(f"{name}: inconsistent shapes")


def _launch(name, cr, ci, wr, wi, fr, fi, design=None):
    """Launch the kernel once on (q, m, L) planes, counted under
    ``name``, in ``design`` (default: :func:`recombine_design`'s)."""
    q, m, ell = cr.shape
    dev = _build.check_planes(name, cr=cr, ci=ci, wr=wr, wi=wi, fr=fr, fi=fi)
    _check_m(name, m)
    design = design or recombine_design(m)
    if design not in ("column", "tile"):
        raise ValueError(f"{name}: no recombine design {design!r}")
    outr = torch.empty_like(cr)
    outi = torch.empty_like(cr)
    p = _build.ptr
    _build.check(_lib()(p(cr), p(ci), p(wr), p(wi), p(fr), p(fi), p(outr),
                        p(outi), q, m, ell, int(design == "tile"),
                        _build.stream_of(dev)), name)
    _build.count_launch(name)
    return outr, outi


def recombine_twiddle_dft(cr, ci, wr, wi, fr, fi):
    """One request's fused ``F @ (C * W)`` on planar (m, L) data.

    ``wr/wi`` (m, L) twiddle, ``fr/fi`` (m, m) DFT.  Returns (m, L)
    planes.  CPU tensors run :func:`recombine_body`; CUDA tensors launch
    the kernel on a bucket of one (one launch, ``m <= MAX_M``) or raise.
    """
    _check_shapes("recombine_twiddle_dft", cr[None], ci[None], wr, wi, fr, fi)
    if cr.device.type == "cpu":
        return recombine_body(cr, ci, wr, wi, fr, fi)
    outr, outi = _launch("recombine_twiddle_dft", cr[None], ci[None], wr, wi,
                         fr, fi)
    return outr[0], outi[0]


def recombine_twiddle_dft_batched(cr, ci, wr, wi, fr, fi):
    """Batched fused ``F @ (C * W)`` on planar (q, m, L) data.

    ``wr/wi`` (m, L) and ``fr/fi`` (m, m) are shared across the bucket.
    CPU tensors run :func:`recombine_batched_body`; CUDA tensors launch
    the kernel (one launch, ``m <= MAX_M``) or raise.
    """
    _check_shapes("recombine_twiddle_dft_batched", cr, ci, wr, wi, fr, fi)
    if cr.device.type == "cpu":
        return recombine_batched_body(cr, ci, wr, wi, fr, fi)
    return _launch("recombine_twiddle_dft_batched", cr, ci, wr, wi, fr, fi)
