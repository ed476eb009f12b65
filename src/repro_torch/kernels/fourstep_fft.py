"""Four-step DFT bodies and the fused encode + worker kernel.

The per-worker hot loop of coded FFT is a length-L DFT of a coded shard.
Factor ``L = A * B`` and compute

    out[c, d] = ((F_A @ M) * W) @ F_B,     M[a, b] = x[a*B + b]
    X[c + d*A] = out[c, d]

two dense DFT matmuls and one elementwise twiddle on planar f32 data.
``encode_fourstep_fused`` folds the MDS encode in: the generator
contraction acts across shards and the DFT within each, so the kernel
transforms the m MESSAGE shards and encodes after (an N/m saving).  Its
CUDA kernel is ``csrc/encode_fourstep.cu``; its plain twin
:func:`encode_fourstep_body`.  ``fourstep_fused`` and the two-pass and
streaming four-step kernels are later slices.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["fourstep_body", "encode_fourstep_body", "encode_fourstep_fused"]


def _cmul_mm(ar, ai, br, bi):
    """Complex matmul on planes (4 real matmuls, f32 accumulation)."""
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def fourstep_body(xr, xi, far, fai, wr, wi, fbr, fbi):
    """The four-step math on a (bq, A, B) block: ((F_A @ M) * W) @ F_B,
    output in the scrambled order ``X[c + d*A] = out[c, d]``."""
    bq, a, b = xr.shape
    mr = xr.transpose(0, 1).reshape(a, bq * b)
    mi = xi.transpose(0, 1).reshape(a, bq * b)
    t1r, t1i = _cmul_mm(far, fai, mr, mi)
    t1r = t1r.reshape(a, bq, b)
    t1i = t1i.reshape(a, bq, b)
    wr = wr[:, None, :]
    wi = wi[:, None, :]
    t2r = t1r * wr - t1i * wi
    t2i = t1r * wi + t1i * wr
    rr = t2r.transpose(0, 1).reshape(bq * a, b)
    ri = t2i.transpose(0, 1).reshape(bq * a, b)
    t3r, t3i = _cmul_mm(rr, ri, fbr, fbi)
    return t3r.reshape(bq, a, b), t3i.reshape(bq, a, b)


def encode_fourstep_body(cr, ci, gr, gi, far, fai, wr, wi, fbr, fbi):
    """Fused MDS encode + four-step DFT on MESSAGE shards.

    ``c``: (bq, m, A, B) message planes; ``g``: (n, m) generator planes.
    Returns (bq, n, A, B) planes in the scrambled four-step order.
    """
    bq, m, a, b = cr.shape
    n = gr.shape[0]
    # stage 1: column DFTs of every message shard -- contract A
    mr = cr.permute(2, 0, 1, 3).reshape(a, bq * m * b)
    mi = ci.permute(2, 0, 1, 3).reshape(a, bq * m * b)
    t1r, t1i = _cmul_mm(far, fai, mr, mi)
    t1r = t1r.reshape(a, bq, m, b)
    t1i = t1i.reshape(a, bq, m, b)
    # stage 2: twiddle, shared across batch and shard index
    wr = wr[:, None, None, :]
    wi = wi[:, None, None, :]
    t2r = t1r * wr - t1i * wi
    t2i = t1r * wi + t1i * wr
    # stage 3: row DFTs -- contract B
    t3r, t3i = _cmul_mm(t2r.reshape(-1, b), t2i.reshape(-1, b), fbr, fbi)
    # stage 4: MDS encode -- contract the shard axis m with G
    t3r = t3r.reshape(a, bq, m, b).permute(2, 1, 0, 3).reshape(m, -1)
    t3i = t3i.reshape(a, bq, m, b).permute(2, 1, 0, 3).reshape(m, -1)
    er, ei = _cmul_mm(gr, gi, t3r, t3i)
    return (er.reshape(n, bq, a, b).transpose(0, 1),
            ei.reshape(n, bq, a, b).transpose(0, 1))


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _build.load("encode_fourstep").encode_fourstep_f32
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 16 + [i32] * 5 + [vp]
    fn.restype = ctypes.c_int
    return fn


# CUDA grid limit on the batch axis of the GEMM passes
_MAX_GRID_Z = 65535


def encode_fourstep_fused(cr, ci, gr, gi, far, fai, wr, wi, fbr, fbi):
    """Fused encode + worker DFT: message planes -> coded worker spectra.

    ``cr, ci``: (q, m, A, B) planes of the m message shards,
    ``M_i[a, b] = c_i[a*B + b]``; ``gr, gi``: (n, m) generator planes.
    Returns (q, n, A, B) planes of ``out[k, c, d]`` with
    ``B_k[c + d*A] = out[k, c, d]``.

    CPU tensors run :func:`encode_fourstep_body`; CUDA tensors launch the
    kernel -- three launches (column pass, row pass, encode), each counted
    -- or raise.
    """
    q, m, a, b = cr.shape
    n = gr.shape[0]
    if (ci.shape != cr.shape or gr.shape != (n, m) or gi.shape != (n, m)
            or far.shape != (a, a) or fai.shape != (a, a)
            or wr.shape != (a, b) or wi.shape != (a, b)
            or fbr.shape != (b, b) or fbi.shape != (b, b)):
        raise ValueError("encode_fourstep_fused: inconsistent shapes")
    if cr.device.type == "cpu":
        return encode_fourstep_body(cr, ci, gr, gi, far, fai, wr, wi,
                                    fbr, fbi)
    dev = _build.check_planes(
        "encode_fourstep_fused", cr=cr, ci=ci, gr=gr, gi=gi, far=far,
        fai=fai, wr=wr, wi=wi, fbr=fbr, fbi=fbi)
    if q * m > _MAX_GRID_Z:
        raise ValueError(f"encode_fourstep_fused: batch q*m={q * m} exceeds "
                         f"the grid's {_MAX_GRID_Z}")
    t1r = torch.empty_like(cr)
    t1i = torch.empty_like(cr)
    zr = torch.empty_like(cr)
    zi = torch.empty_like(cr)
    outr = torch.empty((q, n, a, b), dtype=torch.float32, device=dev)
    outi = torch.empty_like(outr)
    p = _build.ptr
    _build.check(_lib()(
        p(cr), p(ci), p(gr), p(gi), p(far), p(fai), p(wr), p(wi), p(fbr),
        p(fbi), p(t1r), p(t1i), p(zr), p(zi), p(outr), p(outi),
        q, m, n, a, b, _build.stream_of(dev)), "encode_fourstep_fused")
    _build.count_launch("encode_fourstep_fused", 3)
    return outr, outi
