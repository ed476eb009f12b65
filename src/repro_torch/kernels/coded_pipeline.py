"""The whole masked c2c coded-FFT bucket: plain bodies and the kernel.

Per request the service's hot path is

    c   = interleave(x)                 c_i[j] = x[i + j*m]
    t   = ((F_A @ c) * W) @ F_B         four-step DFT of the m message shards
    b   = G @ t                         MDS encode (commutes with the DFT)
    c^  = D_q @ b                       per-request scatter decode matrix,
                                        built from the raw responder mask
    X   = F_m @ (c^ * W_s)              recombine butterfly

``coded_fft_bucket_masked`` runs all of it in one CUDA launch
(``csrc/coded_bucket.cu``); :func:`bucket_body_masked` is its plain twin.
The decode matrices come from :func:`mask_subsets` (first-m responders,
short rows filled with the first non-responders) and
:func:`lagrange_planes_body` (the closed-form Lagrange inverse on f32
planes).  The unmasked ``coded_fft_bucket`` kernel and the real-kind
buckets are later slices.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import SMEM_PER_BLOCK_OPTIN
from repro_torch.kernels.cmatmul import bcmatmul_body, cmatmul_body
from repro_torch.kernels.fourstep_fft import encode_fourstep_body

__all__ = [
    "lagrange_planes_body",
    "mask_subsets",
    "bucket_body",
    "bucket_body_masked",
    "bucket_layout",
    "bucket_smem_bytes",
    "coded_fft_bucket_masked",
    "MAX_M",
    "SMEM_PER_BLOCK_OPTIN",
]

# the kernel unrolls the shard axis to a compile-time bound
MAX_M = 32



@functools.lru_cache(maxsize=None)
def _locator_perm(m: int) -> np.ndarray:
    # balanced (shuffled static) multiplication order keeps the locator's
    # partial products O(1); the f32 conditioning depends on it, so it is
    # exactly the reference's order
    return np.random.default_rng(0).permutation(m)


def lagrange_planes_body(subsets: torch.Tensor, n: int):
    """Per-request decode matrices from responder subsets, on f32 planes.

    ``subsets``: ``(bq, m)`` int -- each request's first-m available
    workers.  Returns ``(ivr, ivi, dr, di)``: the compact ``(bq, m, m)``
    inverse planes and the scatter ``(bq, m, n)`` planes with zero
    straggler columns.
    """
    bq, m = subsets.shape
    dev = subsets.device
    f32 = torch.float32
    subsets = subsets.to(torch.int64)
    tau = 2.0 * np.pi / n
    # exact node powers P[b, j, d] = x_j^d = omega^(subset_j * d mod n)
    d_iota = torch.arange(m, device=dev)[None, None, :]
    angp = (-tau) * ((subsets[:, :, None] * d_iota) % n).to(f32)
    pr, pi_ = torch.cos(angp), torch.sin(angp)
    angn = (-tau) * (subsets % n).to(f32)
    nr, ni = torch.cos(angn), torch.sin(angn)                # nodes (bq, m)
    # locator A(z) = prod (z - x_j), in the reference's shuffled order
    ar = torch.cat([torch.ones((bq, 1), dtype=f32, device=dev),
                    torch.zeros((bq, m), dtype=f32, device=dev)], 1)
    ai = torch.zeros((bq, m + 1), dtype=f32, device=dev)
    zero = torch.zeros((bq, 1), dtype=f32, device=dev)
    for i in _locator_perm(m):
        sr = torch.cat([zero, ar[:, :m]], dim=1)             # z * A(z)
        si = torch.cat([zero, ai[:, :m]], dim=1)
        xr_, xi_ = nr[:, i:i + 1], ni[:, i:i + 1]
        ar, ai = sr - (xr_ * ar - xi_ * ai), si - (xr_ * ai + xi_ * ar)
    # deflation in suffix form: T[i, d] = a[i+d+1] (0 past m), selected by
    # S[t, (i, d)] = [t == i+d+1]
    ii = torch.arange(m, device=dev)[:, None]
    dd = torch.arange(m, device=dev)[None, :]
    tsel = torch.arange(m + 1, device=dev)[:, None, None]
    sel = (tsel == (ii + dd + 1)[None]).to(f32).reshape(m + 1, m * m)
    tr = (ar @ sel).reshape(bq, m, m)
    ti = (ai @ sel).reshape(bq, m, m)
    # q = T @ P^T: the coefficients of A(z)/(z - x_j) for every j at once
    prT = pr.transpose(1, 2)
    piT = pi_.transpose(1, 2)
    qr = tr @ prT - ti @ piT
    qi = tr @ piT + ti @ prT                                 # (bq, i, j)
    # A'(x_j) = Q_j(x_j) = sum_i q[i, j] x_j^i
    qrT = qr.transpose(1, 2)
    qiT = qi.transpose(1, 2)                                 # (bq, j, i)
    apr = torch.sum(qrT * pr - qiT * pi_, dim=2)
    api = torch.sum(qrT * pi_ + qiT * pr, dim=2)             # (bq, j)
    den = apr * apr + api * api
    cr = (apr / den)[:, None, :]
    ci = (-api / den)[:, None, :]                            # 1 / A'(x_j)
    ivr = qr * cr - qi * ci
    ivi = qr * ci + qi * cr                                  # inv (bq, m, m)
    # scatter inv columns to worker slots: D[:, subset] = inv
    k_iota = torch.arange(n, device=dev)[None, None, :]
    onehot = (subsets[:, :, None] == k_iota).to(f32)        # (bq, m, n)
    return ivr, ivi, ivr @ onehot, ivi @ onehot


def mask_subsets(masks: torch.Tensor, m: int) -> torch.Tensor:
    """First-``m`` responder indices per request: a stable argsort of the
    ``(B, N)`` masks (nonzero = responded; responders first, in index
    order, so short rows fill with the first non-responders).  ``(B, m)``
    int32."""
    order = torch.argsort(torch.logical_not(masks).to(torch.uint8),
                          dim=-1, stable=True)
    return order[..., :m].to(torch.int32)


def bucket_body(xr, xi, dr, di, gr, gi, far, fai, wr, wi, fbr, fbi,
                twr, twi, fmr, fmi):
    """The full pipeline on a (bq, s) block of requests with given scatter
    decode planes ``(bq, m, n)``.  The four-step spectra stay in the
    scrambled order through decode; ``twr/twi`` must be the recombine
    twiddle pre-permuted to that order, and one transpose at the end
    restores natural order."""
    bq, s = xr.shape
    n, m = gr.shape
    a = far.shape[0]
    b = fbr.shape[0]
    ell = a * b
    # interleave: c_i[j] = x[i + j*m]
    cr = xr.reshape(bq, ell, m).transpose(1, 2).reshape(bq, m, a, b)
    ci = xi.reshape(bq, ell, m).transpose(1, 2).reshape(bq, m, a, b)
    er, ei = encode_fourstep_body(cr, ci, gr, gi, far, fai, wr, wi, fbr, fbi)
    # per-request decode (batched contraction over N), scrambled payload
    hr, hi = bcmatmul_body(dr, di, er.reshape(bq, n, ell),
                           ei.reshape(bq, n, ell))
    # recombine twiddle (pre-scrambled) + length-m DFT
    ur = hr * twr[None] - hi * twi[None]
    ui = hr * twi[None] + hi * twr[None]
    ur = ur.transpose(0, 1).reshape(m, bq * ell)
    ui = ui.transpose(0, 1).reshape(m, bq * ell)
    outr, outi = cmatmul_body(fmr, fmi, ur, ui)
    # X_q[j*L + c + d*A] lives at out[j, q, c, d] -> (q, j, d, c)
    outr = outr.reshape(m, bq, a, b).permute(1, 0, 3, 2).reshape(bq, s)
    outi = outi.reshape(m, bq, a, b).permute(1, 0, 3, 2).reshape(bq, s)
    return outr, outi


def bucket_body_masked(xr, xi, masks, gr, gi, far, fai, wr, wi, fbr, fbi,
                       twr, twi, fmr, fmi):
    """:func:`bucket_body` with the decode matrices built from the raw
    ``(bq, n)`` responder masks."""
    n, m = gr.shape
    _, _, dr, di = lagrange_planes_body(mask_subsets(masks, m), n)
    return bucket_body(xr, xi, dr, di, gr, gi, far, fai, wr, wi, fbr, fbi,
                       twr, twi, fmr, fmi)


def bucket_layout(m: int, a: int, b: int) -> tuple[int, ...]:
    """Word offsets of the bucket kernel's shared arrays, then the total.

    The kernel takes these offsets at launch (``Layout`` in
    ``csrc/coded_bucket.cu``, same order), so this is the one reckoning of
    its working set, and the fused gate.
    """
    sizes = (
        2 * a * a,               # fa: F_A planes
        2 * b * b,               # fb: F_B planes
        2 * a * b,               # w: four-step twiddle
        2 * a * b,               # msg: one message shard
        2 * a * b,               # t1: column-pass result
        2 * m * a * (b + 1),     # z: m shard spectra, pitch B+1
        2 * m * m,               # gs: G rows of the subset
        2 * m * m,               # fm: F_m planes
        2 * m * m,               # pw: node powers x_j^d
        2 * m * m,               # qm: deflation, then the inverse
        2 * (m + 1),             # loc: locator coefficients
        2 * m,                   # nodes, then 1/A'(x_j)
        m,                       # sub: the subset (int)
    )
    return tuple(itertools.accumulate(sizes, initial=0))


def bucket_smem_bytes(m: int, a: int, b: int) -> int:
    """Shared memory one block of the bucket kernel needs, in bytes."""
    return 4 * bucket_layout(m, a, b)[-1]


@functools.lru_cache(maxsize=None)
def _perm_on(m: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_locator_perm(m).astype(np.int32), device=device)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("coded_bucket")
    fn = lib.coded_bucket_masked_f32
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 18 + [i32] * 5 + [ctypes.c_float, vp, vp]
    fn.restype = ctypes.c_int
    return fn


def device_smem_optin(device_index: int = 0) -> int:
    """``cudaDevAttrMaxSharedMemoryPerBlockOptin`` of a CUDA device, to
    check :data:`SMEM_PER_BLOCK_OPTIN` against (needs the CUDA build)."""
    fn = _build.load("coded_bucket").device_smem_per_block_optin
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    value = int(fn(device_index))
    if value < 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed on device "
                           f"{device_index}")
    return value


def coded_fft_bucket_masked(xr, xi, masks, gr, gi, far, fai, wr, wi,
                            fbr, fbi, twr, twi, fmr, fmi):
    """The whole masked c2c bucket: (q, s) request planes + (q, N) raw
    responder masks -> (q, s) output planes of ``fft(x)``.

    ``gr, gi``: (N, m) generator; ``far/wr/fbr``: four-step planes for
    ``L = s/m = A*B``; ``twr, twi``: (m, L) recombine twiddle pre-permuted
    to the four-step order; ``fmr, fmi``: (m, m) DFT.  CPU tensors run
    :func:`bucket_body_masked`; CUDA tensors launch the kernel (one
    launch) or raise.  The caller checks the shared-memory gate
    (``ops.coded_bucket_fusable``).
    """
    q, s = xr.shape
    n, m = gr.shape
    a, b = far.shape[0], fbr.shape[0]
    ell = a * b
    if (xi.shape != xr.shape or masks.shape != (q, n) or m * ell != s
            or twr.shape != (m, ell) or fmr.shape != (m, m)):
        raise ValueError("coded_fft_bucket_masked: inconsistent shapes")
    if xr.device.type == "cpu":
        return bucket_body_masked(xr, xi, masks, gr, gi, far, fai, wr, wi,
                                  fbr, fbi, twr, twi, fmr, fmi)
    mk = masks.to(torch.float32).contiguous()
    dev = _build.check_planes(
        "coded_fft_bucket_masked", xr=xr, xi=xi, masks=mk, gr=gr, gi=gi,
        far=far, fai=fai, wr=wr, wi=wi, fbr=fbr, fbi=fbi, twr=twr, twi=twi,
        fmr=fmr, fmi=fmi)
    if m > MAX_M:
        raise NotImplementedError(
            f"coded_fft_bucket_masked: m={m} > {MAX_M} (the in-kernel "
            f"Lagrange decode serves m <= LAGRANGE_MAX_M)")
    layout = bucket_layout(m, a, b)
    if 4 * layout[-1] > SMEM_PER_BLOCK_OPTIN:
        raise ValueError(
            f"coded_fft_bucket_masked: (s={s}, m={m}) needs {4 * layout[-1]} "
            f"bytes of shared memory per block, over {SMEM_PER_BLOCK_OPTIN}; "
            f"route it to the stage kernels")
    perm = _perm_on(m, dev)
    outr = torch.empty_like(xr)
    outi = torch.empty_like(xr)
    ntau = float(np.float32(-2.0 * math.pi / n))
    p = _build.ptr
    _build.check(_lib()(
        p(xr), p(xi), p(mk), p(perm), p(gr), p(gi), p(far), p(fai), p(wr),
        p(wi), p(fbr), p(fbi), p(twr), p(twi), p(fmr), p(fmi), p(outr),
        p(outi), q, n, m, a, b, ntau,
        (ctypes.c_longlong * len(layout))(*layout), _build.stream_of(dev)),
        "coded_fft_bucket_masked")
    _build.count_launch("coded_fft_bucket_masked")
    return outr, outi
