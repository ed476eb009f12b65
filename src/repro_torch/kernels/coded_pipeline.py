"""The whole masked c2c coded-FFT bucket: plain bodies and the kernel.

Per request the service's hot path is

    c   = interleave(x)                 c_i[j] = x[i + j*m]
    t   = ((F_A @ c) * W) @ F_B         four-step DFT of the m message shards
    b   = G @ t                         MDS encode (commutes with the DFT)
    c^  = D_q @ b                       per-request scatter decode matrix,
                                        built from the raw responder mask
    X   = F_m @ (c^ * W_s)              recombine butterfly

``coded_fft_bucket_masked`` runs all of it in one CUDA launch
(``csrc/coded_bucket.cu``: an L-point FFT of each shard in place of the
four-step's dense passes, its working set :func:`bucket_fft_layout`);
:func:`bucket_body_masked` is its plain twin.
The decode matrices come from :func:`mask_subsets` (first-m responders,
short rows filled with the first non-responders) and
:func:`lagrange_planes_body` (the closed-form Lagrange inverse on f32
planes).

The real kinds carry HALF-length payloads through the same stages:

* r2c (``coded_rfft_bucket_masked``, ``csrc/coded_rbucket.cu``; twin
  :func:`rbucket_body_masked`): the real request relabels into
  pair-packed shards (:func:`pack_real_planes`), a DFT over L/2 (on the
  card an L/2-point FFT of each shard, the working set
  :func:`bucket_fft_layout` with m//2+1 DFT rows), encode, decode, then
  the symmetry postdecode
  (:func:`half_postdecode_body`: split, Hermitian extension, the
  m//2+1 recombine rows that feed the bins X[0..s/2]);
* c2r (``coded_irfft_bucket_masked``, ``csrc/coded_irbucket.cu``; twin
  :func:`irbucket_body_masked`): the adjoint message stage
  (:func:`ir_message_body`), the ifft worker through the forward
  four-step by conjugation, decode, and the pair unpack
  (:func:`ir_unpack_body`) into one real plane.

Each kind also has a *planes* kernel (``coded_fft_bucket``,
``coded_rfft_bucket``, ``coded_irfft_bucket``; twins :func:`bucket_body`,
:func:`rbucket_body`, :func:`irbucket_body`): the service's host
decode-matrix path, where every request brings its own ``(m, N)``
scatter decode planes ``D`` built on the host (``serving.decode_cache``).
It runs the same pipeline with ``D`` in place of the in-kernel Lagrange
decode, in the same CUDA source as the kind's masked kernel.

A c2c bucket past the whole-bucket kernel's shared memory streams
(``csrc/coded_bucket_streaming.cu``): ``coded_fft_bucket_streaming`` on
host-built decode planes (twin :func:`bucket_body`) is the same function
as three launches -- the column FFT (the twiddle in its last pass, the
shards de-interleaved by its store), the row FFT, and the code and
recombine -- with device-memory intermediates no wider than the request;
``coded_fft_bucket_streaming_masked`` (twin :func:`bucket_body_masked`)
runs one decode launch first that builds every request's (m, N) scatter
decode planes from its raw mask, then the same three.

Precision: every bucket wrapper takes its constant planes (F_A, W, F_B,
the recombine twiddle, F_m, the r2c split twiddle and DFT rows, the c2r
message rows and pack twiddle) in float32 or, under the dispatch
layer's ``precision="bf16"``, all in bfloat16; the payload, G and the
decode are float32 either way.  CPU tensors run the plain twin on the
planes widened to f32; CUDA tensors launch the kernel's ``*_bf16`` entry
on the bf16 tables of ``fourstep_fft.fft_twiddles_on`` and the bf16
planes, counted as ``<name>[bf16]``.

The ``*_body_fftworker`` functions are the JAX package's direct
(off-accelerator) bucket executors in plain PyTorch: the worker DFT on
``torch.fft`` and a gathered compact (m, m) decode.  No kernel runs
them and the service does not route to them (``ops.coded_bucket_direct``
and its real twins export them).
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
from repro_torch.kernels.fourstep_fft import (
    FftSpec,
    _padded,
    _widened,
    encode_fourstep_body,
    fft_cols_spec,
    fft_rows_plan,
    fft_rows_spec,
    fft_twiddles_on,
)

__all__ = [
    "lagrange_planes_body",
    "mask_subsets",
    "bucket_body",
    "bucket_body_masked",
    "bucket_body_fftworker",
    "bucket_fft_group",
    "bucket_fft_layout",
    "bucket_layout",
    "bucket_smem_bytes",
    "coded_fft_bucket",
    "coded_fft_bucket_masked",
    "streaming_smem_bytes",
    "coded_fft_bucket_streaming",
    "coded_fft_bucket_streaming_masked",
    "pack_real_planes",
    "half_postdecode_body",
    "rbucket_body",
    "rbucket_body_masked",
    "rbucket_body_fftworker",
    "rbucket_layout",
    "coded_rfft_bucket",
    "coded_rfft_bucket_masked",
    "ir_message_body",
    "ir_unpack_body",
    "irbucket_body",
    "irbucket_body_masked",
    "irbucket_body_fftworker",
    "irbucket_layout",
    "coded_irfft_bucket",
    "coded_irfft_bucket_masked",
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


def _gather_rows(er, ei, subsets):
    """Each request's responder rows: ``(bq, n, L)`` planes and ``(bq,
    m)`` subsets -> ``(bq, m, L)``; only those rows are read."""
    idx = subsets.long()[:, :, None].expand(-1, -1, er.shape[-1])
    return torch.gather(er, 1, idx), torch.gather(ei, 1, idx)


def _code_rows(tr, ti, gr, gi, bq):
    """``(m, bq*L)`` message planes -> ``(bq, n, L)`` coded planes: the
    MDS encode as one shared matmul, the batch folded into the columns."""
    n = gr.shape[0]
    er, ei = cmatmul_body(gr, gi, tr, ti)
    return (er.reshape(n, bq, -1).transpose(0, 1),
            ei.reshape(n, bq, -1).transpose(0, 1))


def bucket_body_fftworker(xr, xi, dvr, dvi, subsets, gr, gi,
                          twr, twi, fmr, fmi):
    """The direct (off-accelerator) c2c bucket: :func:`bucket_body`'s
    stages with the worker DFT on the platform FFT (``torch.fft``) and
    the decode as gathered COMPACT ``(m, m)`` inverses ``dvr/dvi``
    applied to each request's ``subsets`` rows; ``twr/twi`` the
    natural-order recombine twiddle.  Plain PyTorch, the JAX package's
    direct lowering: no kernel runs it."""
    bq, s = xr.shape
    n, m = gr.shape
    ell = s // m
    # interleave on planes: c_i[j] = x[i + j*m]
    cr = xr.reshape(bq, ell, m).transpose(1, 2)
    ci = xi.reshape(bq, ell, m).transpose(1, 2)
    # worker DFT of the m message shards (linear: commutes with encode)
    spec = torch.fft.fft(torch.complex(cr, ci), dim=-1)
    tr = spec.real.to(xr.dtype).transpose(0, 1).reshape(m, bq * ell)
    ti = spec.imag.to(xr.dtype).transpose(0, 1).reshape(m, bq * ell)
    er, ei = _code_rows(tr, ti, gr, gi, bq)               # (bq, N, L)
    hr, hi = bcmatmul_body(dvr, dvi, *_gather_rows(er, ei, subsets))
    # recombine twiddle (natural order) + length-m DFT
    ur = hr * twr[None] - hi * twi[None]
    ui = hr * twi[None] + hi * twr[None]
    ur = ur.transpose(0, 1).reshape(m, bq * ell)
    ui = ui.transpose(0, 1).reshape(m, bq * ell)
    outr, outi = cmatmul_body(fmr, fmi, ur, ui)
    return (outr.reshape(m, bq, ell).transpose(0, 1).reshape(bq, s),
            outi.reshape(m, bq, ell).transpose(0, 1).reshape(bq, s))


def _code_words(m: int, n: int, masked: bool):
    """Words of a bucket block's code and decode state: ``(gs, (pw, qm,
    loc, nodes, sub))``, the layouts' shared part.

    Masked: the subset's m generator rows and the Lagrange scratch (node
    powers x_j^d, the deflation then the inverse, the locator, the nodes
    then 1/A'(x_j), the subset).  Planes: all N generator rows in ``gs``
    and the request's (m, N) decode matrix D in ``qm``; the Lagrange
    arrays take no room.
    """
    if masked:
        return 2 * m * m, (2 * m * m, 2 * m * m, 2 * (m + 1), 2 * m, m)
    if n < 1:
        raise ValueError("a planes layout needs the code's N workers")
    return 2 * n * m, (0, 2 * m * n, 0, 0, 0)


def bucket_layout(m: int, a: int, b: int, *, n: int = 0,
                  masked: bool = True) -> tuple[int, ...]:
    """Word offsets of the dense-DFT c2c bucket's shared arrays, then the
    total; ``masked=False`` is the planes variant's (it needs ``n``).

    This is the working set of the first port of ``csrc/coded_bucket.cu``
    (F_A, F_B, W, a message shard, the column pass and the m spectra at
    pitch B+1), kept as the fused route's boundary:
    ``ops.coded_bucket_fusable`` and ``ops.bucket_route`` answer from it,
    so the kernel's FFT redesign moved no bucket between the fused and
    the streaming routes.  The kernel itself lays out
    :func:`bucket_fft_layout`, which fits one block wherever this does.
    """
    gs, decode = _code_words(m, n, masked)
    sizes = (
        2 * a * a,               # fa: F_A planes
        2 * b * b,               # fb: F_B planes
        2 * a * b,               # w: four-step twiddle
        2 * a * b,               # msg: one message shard
        2 * a * b,               # t1: column-pass result
        2 * m * a * (b + 1),     # z: m shard spectra, pitch B+1
        gs,                      # gs: G rows (the subset's, or all N)
        2 * m * m,               # fm: F_m planes
        *decode,                 # pw, qm (inverse or D), loc, nodes, sub
    )
    return tuple(itertools.accumulate(sizes, initial=0))


def bucket_smem_bytes(m: int, a: int, b: int, *, n: int = 0,
                      masked: bool = True) -> int:
    """Shared memory of :func:`bucket_layout`, in bytes: the fused gate's
    measure."""
    return 4 * bucket_layout(m, a, b, n=n, masked=masked)[-1]


def _fft_layout(m: int, ell: int, rows: int, n: int, masked: bool,
                dft_rows: int | None, side: int = 0) -> tuple[int, ...]:
    # the spectra: groups of `rows` shards, each group a padded plane, the
    # last one only as long as its shards
    groups = -(-m // rows)
    gp = _padded(rows * ell)
    zp = (groups - 1) * gp + _padded((m - (groups - 1) * rows) * ell)
    gs, decode = _code_words(m, n, masked)
    sizes = (
        2 * zp,                  # z: the m shards, then their spectra
        2 * gp,                  # y: the passes' ping-pong, one group
        2 * _padded(ell),        # tab: the f32 table of w_ell^t
        gs,                      # gs: G rows (the subset's, or all N)
        2 * (m if dft_rows is None else dft_rows) * m,  # fm, fh or fp
        *decode,                 # pw, qm (inverse or D), loc, nodes, sub
        *((side,) if side else ()),  # the c2r kernel's T_i[ell]
    )
    return tuple(itertools.accumulate(sizes, initial=0))


@functools.lru_cache(maxsize=None)
def bucket_fft_group(m: int, ell: int, *, n: int = 0, masked: bool = True,
                     dft_rows: int | None = None, side: int = 0) -> int:
    """Shards one group of a bucket kernel's FFT phase takes: all m
    where the block holds them, so each radix pass runs once over every
    shard with the block's threads busy (a 1024-point shard alone has
    128 radix-8 butterflies for 512 threads), and fewer while the
    working set would pass :data:`SMEM_PER_BLOCK_OPTIN`: a group's
    ping-pong buffer is the cost, and at m = 32, L = 256 and N = 282 on
    the c2c planes kernel four shards a group fit where five do not.
    ``dft_rows`` and ``side`` as in :func:`bucket_fft_layout`."""
    rows = m
    while rows > 1 and (4 * _fft_layout(m, ell, rows, n, masked,
                                        dft_rows, side)[-1]
                        > SMEM_PER_BLOCK_OPTIN):
        rows -= 1
    return rows


def bucket_fft_layout(m: int, ell: int, *, n: int = 0, masked: bool = True,
                      dft_rows: int | None = None,
                      side: int = 0) -> tuple[int, ...]:
    """Word offsets of a bucket kernel's shared arrays, then the total,
    for shards of ``ell`` points; ``masked=False`` is the planes
    kernel's (it needs ``n``).  ``dft_rows``: the rows of the m-point
    DFT the block stages, m (the default) for the c2c kernel's F_m and
    the c2r kernel's +sign F_m, m//2+1 for the r2c kernel's half rows;
    the real kinds' shards are the packed ``ell = L/2`` points.
    ``side``: words of one more array after the decode state, 2*m for
    the c2r kernel's T_i[ell] (its message stage writes T_i[t < ell]
    into shard i's own words and the last point there).

    The kernels take these offsets at launch (``Layout`` in
    ``csrc/coded_bucket.cu``, ``csrc/coded_rbucket.cu`` and
    ``csrc/coded_irbucket.cu``, same order), so this is the one
    reckoning of their working sets: the spectra in groups of
    :func:`bucket_fft_group` shards, shard i at point j in word
    ``(i // rows) * gp + pad((i % rows) * ell + j)`` of each plane
    (``gp``, a full group's padded words), one group's ping-pong buffer,
    the ell-point table, the G rows, the DFT rows, the decode state of
    :func:`bucket_layout`, then the side array.  The wrappers hold it
    against :data:`SMEM_PER_BLOCK_OPTIN`; it fits wherever the gates,
    :func:`bucket_layout`, :func:`rbucket_layout` and
    :func:`irbucket_layout`, admit a bucket.
    """
    rows = bucket_fft_group(m, ell, n=n, masked=masked, dft_rows=dft_rows,
                            side=side)
    return _fft_layout(m, ell, rows, n, masked, dft_rows, side)


@functools.lru_cache(maxsize=None)
def _perm_on(m: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_locator_perm(m).astype(np.int32), device=device)


# -- shared by the six bucket wrappers ---------------------------------------
def _check_launch(what: str, m: int, layout: tuple[int, ...], s: int):
    if m > MAX_M:
        raise NotImplementedError(
            f"{what}: m={m} > {MAX_M}, the kernel's unrolled shard bound; "
            f"route it to the stage kernels")
    if 4 * layout[-1] > SMEM_PER_BLOCK_OPTIN:
        raise ValueError(
            f"{what}: (s={s}, m={m}) needs {4 * layout[-1]} bytes of shared "
            f"memory per block, over {SMEM_PER_BLOCK_OPTIN}; route it to the "
            f"stage kernels")


def _ntau(n: int) -> float:
    return float(np.float32(-2.0 * math.pi / n))


@functools.lru_cache(maxsize=None)
def _fft_bucket_lib(name: str, symbol: str, n_ptrs: int, masked: bool):
    # the bucket entries of every kind: pointers, (q, n, m, ell), the masked
    # entry's ntau, the radices, (passes, rows), layout, stream
    fn = getattr(_build.load(name), symbol)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([vp] * n_ptrs + [i32] * 4
                   + ([ctypes.c_float] if masked else [])
                   + [ctypes.POINTER(i32), i32, i32,
                      ctypes.POINTER(ctypes.c_longlong), vp])
    fn.restype = ctypes.c_int
    return fn


def _c2c_launch(what: str, symbol: str, xr, xi, decode, gr, gi, fmr, fmi,
                q: int, n: int, m: int, s: int, masked: bool, dev):
    """One launch of the c2c bucket kernel on checked CUDA planes;
    ``decode``: the masked entry's (masks, perm), or the planes entry's
    (dr, di).  bf16 planes launch the ``*_bf16`` entry."""
    bf16 = _build.is_bf16(fmr)
    ell = s // m
    layout = bucket_fft_layout(m, ell, n=n, masked=masked)
    _check_launch(what, m, layout, s)
    rows = bucket_fft_group(m, ell, n=n, masked=masked)
    plan = fft_rows_plan(ell)
    outr = torch.empty_like(xr)
    outi = torch.empty_like(xr)
    p = _build.ptr
    _build.check(_fft_bucket_lib(
        "coded_bucket", _build.entry(symbol, bf16), 14, masked)(
        p(xr), p(xi), *(p(t) for t in decode), p(gr), p(gi),
        *(p(t) for n_ in (ell, s)
          for t in fft_twiddles_on(n_, dev, fmr.dtype)), p(fmr), p(fmi),
        p(outr), p(outi), q, n, m, ell, *([_ntau(n)] if masked else []),
        (ctypes.c_int * max(1, len(plan)))(*plan), len(plan), rows,
        (ctypes.c_longlong * len(layout))(*layout), _build.stream_of(dev)),
        what)
    _build.count_launch(_build.launch_name(what, bf16))
    return outr, outi


def _check_decode_planes(what, dr, di, q, m, n):
    if dr.shape != (q, m, n) or di.shape != (q, m, n):
        raise ValueError(f"{what}: decode planes {tuple(dr.shape)} / "
                         f"{tuple(di.shape)}, expected {(q, m, n)}")


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


def coded_fft_bucket(xr, xi, dr, di, gr, gi, far, fai, wr, wi, fbr, fbi,
                     twr, twi, fmr, fmi):
    """The whole c2c bucket on host-built decode planes: (q, s) request
    planes + (q, m, N) scatter decode planes -> (q, s) output planes of
    ``fft(x)``.

    The other planes as :func:`coded_fft_bucket_masked` takes them.  CPU
    tensors run :func:`bucket_body`; CUDA tensors launch the kernel (one
    launch, counted) or raise, reading what
    :func:`coded_fft_bucket_masked` reads.  The caller checks the gate
    (``ops.coded_bucket_fusable(..., masked=False)``).
    """
    q, s = xr.shape
    n, m = gr.shape
    a, b = far.shape[0], fbr.shape[0]
    ell = a * b
    if (xi.shape != xr.shape or m * ell != s or twr.shape != (m, ell)
            or fmr.shape != (m, m)):
        raise ValueError("coded_fft_bucket: inconsistent shapes")
    _check_decode_planes("coded_fft_bucket", dr, di, q, m, n)
    if xr.device.type == "cpu":
        return bucket_body(xr, xi, dr, di, gr, gi, *_widened(
            far, fai, wr, wi, fbr, fbi, twr, twi, fmr, fmi))
    dev = _build.check_planes(
        "coded_fft_bucket", xr=xr, xi=xi, dr=dr, di=di, gr=gr, gi=gi,
        tables=dict(far=far, fai=fai, wr=wr, wi=wi, fbr=fbr, fbi=fbi,
                    twr=twr, twi=twi, fmr=fmr, fmi=fmi))
    return _c2c_launch("coded_fft_bucket", "coded_bucket_f32", xr, xi,
                       (dr, di), gr, gi, fmr, fmi, q, n, m, s, False, dev)


def coded_fft_bucket_masked(xr, xi, masks, gr, gi, far, fai, wr, wi,
                            fbr, fbi, twr, twi, fmr, fmi):
    """The whole masked c2c bucket: (q, s) request planes + (q, N) raw
    responder masks -> (q, s) output planes of ``fft(x)``.

    ``gr, gi``: (N, m) generator; ``far/wr/fbr``: four-step planes for
    ``L = s/m = A*B``; ``twr, twi``: (m, L) recombine twiddle pre-permuted
    to the four-step order; ``fmr, fmi``: (m, m) DFT.  CPU tensors run
    :func:`bucket_body_masked`; CUDA tensors launch the kernel (one
    launch, counted) or raise, also where its working set
    (:func:`bucket_fft_layout`) is past one block.  The card computes the
    shard DFTs from the f32 table of L and takes the recombine twiddle of
    shard j at natural l from the f32 table of s at j*l
    (``fourstep_fft.fft_rows_twiddles``), whose entries are those of the
    planes: it reads G and F_m, not ``far``, ``wr``, ``fbr`` or ``twr``.
    With bf16 planes it reads the bf16 tables and F_m (the ``*_bf16``
    entry, counted as ``coded_fft_bucket_masked[bf16]``).  The caller
    checks the shared-memory gate (``ops.coded_bucket_fusable``).
    """
    q, s = xr.shape
    n, m = gr.shape
    a, b = far.shape[0], fbr.shape[0]
    ell = a * b
    if (xi.shape != xr.shape or masks.shape != (q, n) or m * ell != s
            or twr.shape != (m, ell) or fmr.shape != (m, m)):
        raise ValueError("coded_fft_bucket_masked: inconsistent shapes")
    if xr.device.type == "cpu":
        return bucket_body_masked(xr, xi, masks, gr, gi, *_widened(
            far, fai, wr, wi, fbr, fbi, twr, twi, fmr, fmi))
    mk = masks.to(torch.float32).contiguous()
    dev = _build.check_planes(
        "coded_fft_bucket_masked", xr=xr, xi=xi, masks=mk, gr=gr, gi=gi,
        tables=dict(far=far, fai=fai, wr=wr, wi=wi, fbr=fbr, fbi=fbi,
                    twr=twr, twi=twi, fmr=fmr, fmi=fmi))
    return _c2c_launch("coded_fft_bucket_masked", "coded_bucket_masked_f32",
                       xr, xi, (mk, _perm_on(m, dev)), gr, gi, fmr, fmi, q,
                       n, m, s, True, dev)


def streaming_smem_bytes(m: int, n: int) -> int:
    """Shared memory one block of the streaming bucket's code launch
    needs, in bytes: G (N, m), one request's D (m, N) and F_m (m, m),
    planar (``launch_code`` in ``csrc/coded_bucket_streaming.cu``)."""
    return 4 * (4 * n * m + 2 * m * m)


@functools.lru_cache(maxsize=None)
def _streaming_lib(bf16: bool = False):
    fn = getattr(_build.load("coded_bucket_streaming"),
                 _build.entry("coded_bucket_streaming_f32", bf16))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    spec = ctypes.POINTER(FftSpec)
    fn.argtypes = [vp] * 22 + [i32] * 3 + [spec, spec, vp]
    fn.restype = ctypes.c_int
    return fn


def _check_streaming(what: str, m: int, n: int, q: int, a: int, b: int):
    """The streaming bucket's bounds, then its two FFT plans: the column
    FFT of A over the request's (A, B*m) view, the row FFT of B."""
    if m > MAX_M:
        raise NotImplementedError(
            f"{what}: m={m} > {MAX_M}, the kernel's unrolled shard bound; "
            f"route it to the stage kernels")
    if streaming_smem_bytes(m, n) > SMEM_PER_BLOCK_OPTIN:
        raise ValueError(
            f"{what}: (m={m}, N={n}) needs {streaming_smem_bytes(m, n)} "
            f"bytes of shared memory per block, over {SMEM_PER_BLOCK_OPTIN}")
    if q > _build.MAX_GRID_YZ:
        raise ValueError(f"{what}: batch q={q} exceeds the grid's "
                         f"{_build.MAX_GRID_YZ}")
    return fft_cols_spec(what, a, b * m), fft_rows_spec(what, b)


def _fft_tables(a: int, b: int, dev, dtype) -> list[int]:
    """Pointers of the tables of A and B (f32 or bf16) the two FFT
    launches read."""
    return [_build.ptr(t) for n in (a, b)
            for t in fft_twiddles_on(n, dev, dtype)]


def coded_fft_bucket_streaming(xr, xi, dr, di, gr, gi, far, fai, wr, wi,
                               fbr, fbi, twr, twi, fmr, fmi):
    """The c2c bucket on host-built decode planes past the whole-bucket
    kernel's shared memory: the arguments, result and plain twin
    (:func:`bucket_body`) of :func:`coded_fft_bucket`.

    CUDA tensors run three launches (column FFT, row FFT, code and
    recombine), each counted, with two (q, s) plane pairs of device
    scratch; or raise.  The card computes the DFTs from the tables of A
    and B (``fourstep_fft.fft_rows_twiddles``, f32 or bf16 as the planes
    are), whose entries are those of the DFT planes: it reads W, not
    ``far`` or ``fbr``.  The caller checks the gate
    (``ops.coded_bucket_streamable``).
    """
    q, s = xr.shape
    n, m = gr.shape
    a, b = far.shape[0], fbr.shape[0]
    ell = a * b
    if (xi.shape != xr.shape or m * ell != s or twr.shape != (m, ell)
            or fmr.shape != (m, m)):
        raise ValueError("coded_fft_bucket_streaming: inconsistent shapes")
    _check_decode_planes("coded_fft_bucket_streaming", dr, di, q, m, n)
    if xr.device.type == "cpu":
        return bucket_body(xr, xi, dr, di, gr, gi, *_widened(
            far, fai, wr, wi, fbr, fbi, twr, twi, fmr, fmi))
    dev = _build.check_planes(
        "coded_fft_bucket_streaming", xr=xr, xi=xi, dr=dr, di=di, gr=gr,
        gi=gi, tables=dict(far=far, fai=fai, wr=wr, wi=wi, fbr=fbr, fbi=fbi,
                           twr=twr, twi=twi, fmr=fmr, fmi=fmi))
    bf16 = _build.is_bf16(far)
    spec_a, spec_b = _check_streaming("coded_fft_bucket_streaming", m, n, q,
                                      a, b)
    t1r, t1i, zr, zi, outr, outi = (torch.empty_like(xr) for _ in range(6))
    p = _build.ptr
    _build.check(_streaming_lib(bf16)(
        p(xr), p(xi), p(dr), p(di), p(gr), p(gi), p(wr), p(wi),
        *_fft_tables(a, b, dev, far.dtype), p(twr), p(twi), p(fmr), p(fmi),
        p(t1r), p(t1i), p(zr), p(zi), p(outr), p(outi), q, n, m,
        ctypes.byref(spec_a), ctypes.byref(spec_b), _build.stream_of(dev)),
        "coded_fft_bucket_streaming")
    _build.count_launch(
        _build.launch_name("coded_fft_bucket_streaming", bf16), 3)
    return outr, outi


@functools.lru_cache(maxsize=None)
def _streaming_masked_lib(bf16: bool = False):
    fn = getattr(_build.load("coded_bucket_streaming"),
                 _build.entry("coded_bucket_streaming_masked_f32", bf16))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    spec = ctypes.POINTER(FftSpec)
    fn.argtypes = [vp] * 24 + [i32] * 3 + [ctypes.c_float, spec, spec, vp]
    fn.restype = ctypes.c_int
    return fn


def coded_fft_bucket_streaming_masked(xr, xi, masks, gr, gi, far, fai, wr,
                                      wi, fbr, fbi, twr, twi, fmr, fmi):
    """The masked c2c bucket past the whole-bucket kernel's shared memory:
    the arguments, result and plain twin (:func:`bucket_body_masked`) of
    :func:`coded_fft_bucket_masked`.

    CUDA tensors run four launches, each counted: the decode (one block
    per request: its raw mask row -> its (m, N) scatter decode planes,
    into a (q, m, N) device scratch), then the three of
    :func:`coded_fft_bucket_streaming` on those planes; or raise.  The
    caller checks the gate (``ops.coded_bucket_streamable``).
    """
    q, s = xr.shape
    n, m = gr.shape
    a, b = far.shape[0], fbr.shape[0]
    ell = a * b
    if (xi.shape != xr.shape or masks.shape != (q, n) or m * ell != s
            or twr.shape != (m, ell) or fmr.shape != (m, m)):
        raise ValueError(
            "coded_fft_bucket_streaming_masked: inconsistent shapes")
    if xr.device.type == "cpu":
        return bucket_body_masked(xr, xi, masks, gr, gi, *_widened(
            far, fai, wr, wi, fbr, fbi, twr, twi, fmr, fmi))
    mk = masks.to(torch.float32).contiguous()
    dev = _build.check_planes(
        "coded_fft_bucket_streaming_masked", xr=xr, xi=xi, masks=mk, gr=gr,
        gi=gi, tables=dict(far=far, fai=fai, wr=wr, wi=wi, fbr=fbr, fbi=fbi,
                           twr=twr, twi=twi, fmr=fmr, fmi=fmi))
    bf16 = _build.is_bf16(far)
    spec_a, spec_b = _check_streaming("coded_fft_bucket_streaming_masked", m,
                                      n, q, a, b)
    dr = torch.empty((q, m, n), dtype=torch.float32, device=dev)
    di = torch.empty_like(dr)
    t1r, t1i, zr, zi, outr, outi = (torch.empty_like(xr) for _ in range(6))
    p = _build.ptr
    _build.check(_streaming_masked_lib(bf16)(
        p(xr), p(xi), p(mk), p(_perm_on(m, dev)), p(gr), p(gi), p(wr),
        p(wi), *_fft_tables(a, b, dev, far.dtype), p(twr), p(twi), p(fmr),
        p(fmi),
        p(dr), p(di), p(t1r), p(t1i), p(zr), p(zi), p(outr), p(outi), q, n,
        m, _ntau(n), ctypes.byref(spec_a), ctypes.byref(spec_b),
        _build.stream_of(dev)), "coded_fft_bucket_streaming_masked")
    _build.count_launch(
        _build.launch_name("coded_fft_bucket_streaming_masked", bf16), 4)
    return outr, outi


# -- the r2c bucket ---------------------------------------------------------
def pack_real_planes(xr, m):
    """Real request plane -> packed message planes, a pure relabeling.

    ``(bq, s)`` real -> ``(bq, m, L/2)`` planes of
    ``z_i[j] = x[i + 2jm] + 1j*x[i + (2j+1)m]``.
    """
    bq, s = xr.shape
    if s < 2 * m or s % (2 * m) != 0:
        # the contract of core.rfft.require_even_shards (the kernel layer
        # never imports upward into core)
        raise ValueError(
            f"real packing needs 2m | s (an even shard length s/m): "
            f"got s={s}, m={m}")
    n2 = s // m // 2
    x3 = xr.reshape(bq, n2, 2, m)
    return x3[:, :, 0, :].transpose(1, 2), x3[:, :, 1, :].transpose(1, 2)


def half_postdecode_body(hr, hi, swr, swi, twr, twi, fhr, fhi, s):
    """Decoded packed spectra -> half-spectrum output planes.

    ``hr, hi``: ``(bq, m, L/2)`` NATURAL-order planes of ``fft(z_i)``;
    ``swr, swi``: ``(1, L/2+1)`` split twiddle ``omega_L^p``; ``twr,
    twi``: ``(m, L)`` recombine twiddle; ``fhr, fhi``: ``(m//2+1, m)`` DFT
    rows.  Returns ``(bq, s//2+1)`` planes of ``rfft(x)``.  Conjugation is
    a sign flip on the imaginary plane.
    """
    bq, m, n2 = hr.shape
    ell = 2 * n2
    # split: Zext[p] = Z[p mod n2], Zrev[p] = conj(Zext[n2-p])
    hre = torch.cat([hr, hr[..., :1]], dim=-1)
    hie = torch.cat([hi, hi[..., :1]], dim=-1)
    rre = torch.flip(hre, dims=(-1,))
    rie = -torch.flip(hie, dims=(-1,))
    er = 0.5 * (hre + rre)
    ei = 0.5 * (hie + rie)
    our = 0.5 * (hie - rie)
    oui = -0.5 * (hre - rre)
    sw_r = swr[0][None, None, :]
    sw_i = swi[0][None, None, :]
    cr = er + our * sw_r - oui * sw_i            # C = E + O * omega_L^p
    ci = ei + our * sw_i + oui * sw_r            # (bq, m, n2+1)
    # Hermitian extension: C[L-p] = conj(C[p])
    cfr = torch.cat([cr, torch.flip(cr[..., 1:n2], dims=(-1,))], dim=-1)
    cfi = torch.cat([ci, -torch.flip(ci[..., 1:n2], dims=(-1,))], dim=-1)
    # recombine twiddle + the m//2+1 non-redundant DFT rows
    ur = cfr * twr[None] - cfi * twi[None]
    ui = cfr * twi[None] + cfi * twr[None]
    ur = ur.transpose(0, 1).reshape(m, bq * ell)
    ui = ui.transpose(0, 1).reshape(m, bq * ell)
    outr, outi = cmatmul_body(fhr, fhi, ur, ui)  # (m//2+1, bq*L)
    rows = m // 2 + 1
    sh = s // 2 + 1
    outr = outr.reshape(rows, bq, ell).transpose(0, 1).reshape(bq, -1)
    outi = outi.reshape(rows, bq, ell).transpose(0, 1).reshape(bq, -1)
    return outr[:, :sh], outi[:, :sh]


def _unscramble(hr, a, b):
    # the four-step's scrambled slot c*B + d holds natural index d*A + c
    bq, m, _ = hr.shape
    return hr.reshape(bq, m, a, b).transpose(2, 3).reshape(bq, m, a * b)


def rbucket_body(xr, dr, di, gr, gi, far, fai, wr, wi, fbr, fbi,
                 swr, swi, twr, twi, fhr, fhi, s):
    """The r2c pipeline on a (bq, s) block of REAL requests with given
    scatter decode planes ``(bq, m, n)``: :func:`bucket_body`'s stages on
    half-length payloads (L/2 = A*B), then the symmetry postdecode.  The
    scrambled four-step order is undone BEFORE the butterfly, which needs
    natural reversed indexing."""
    bq = xr.shape[0]
    n, m = gr.shape
    a, b = far.shape[0], fbr.shape[0]
    n2 = a * b
    zr, zi = pack_real_planes(xr, m)
    er, ei = encode_fourstep_body(
        zr.reshape(bq, m, a, b), zi.reshape(bq, m, a, b),
        gr, gi, far, fai, wr, wi, fbr, fbi)      # (bq, n, a, b) scrambled
    hr, hi = bcmatmul_body(dr, di, er.reshape(bq, n, n2),
                           ei.reshape(bq, n, n2))
    return half_postdecode_body(_unscramble(hr, a, b), _unscramble(hi, a, b),
                                swr, swi, twr, twi, fhr, fhi, s)


def rbucket_body_masked(xr, masks, gr, gi, far, fai, wr, wi, fbr, fbi,
                        swr, swi, twr, twi, fhr, fhi, s):
    """:func:`rbucket_body` with the decode matrices built from the raw
    ``(bq, n)`` responder masks."""
    n, m = gr.shape
    _, _, dr, di = lagrange_planes_body(mask_subsets(masks, m), n)
    return rbucket_body(xr, dr, di, gr, gi, far, fai, wr, wi, fbr, fbi,
                        swr, swi, twr, twi, fhr, fhi, s)


def rbucket_body_fftworker(xr, dvr, dvi, subsets, gr, gi,
                           swr, swi, twr, twi, fhr, fhi, s):
    """The direct r2c bucket: the platform FFT on the packed half-length
    shards, the gathered compact decode (cf.
    :func:`bucket_body_fftworker`), the symmetry postdecode.  Plain
    PyTorch."""
    bq = xr.shape[0]
    m = gr.shape[1]
    n2 = s // m // 2
    zr, zi = pack_real_planes(xr, m)                       # (bq, m, n2)
    spec = torch.fft.fft(torch.complex(zr, zi), dim=-1)
    tr = spec.real.to(xr.dtype).transpose(0, 1).reshape(m, bq * n2)
    ti = spec.imag.to(xr.dtype).transpose(0, 1).reshape(m, bq * n2)
    er, ei = _code_rows(tr, ti, gr, gi, bq)
    hr, hi = bcmatmul_body(dvr, dvi, *_gather_rows(er, ei, subsets))
    return half_postdecode_body(hr, hi, swr, swi, twr, twi, fhr, fhi, s)


def rbucket_layout(m: int, a: int, b: int, *, n: int = 0,
                   masked: bool = True) -> tuple[int, ...]:
    """Word offsets of the dense-DFT r2c bucket's shared arrays, then the
    total, for packed shards of ``L/2 = a*b``; ``masked=False`` is the
    planes variant's (it needs ``n``).

    This is the working set of the first port of ``csrc/coded_rbucket.cu``
    (F_A, F_B, W, a packed shard, the column pass and the m spectra at
    pitch B+1), kept as the fused route's boundary:
    ``ops.coded_rbucket_fusable`` and ``ops.bucket_route`` answer from
    it, so the kernel's FFT redesign moved no r2c bucket between the
    fused and the stage routes.  It lays out no kernel: the kernel takes
    :func:`bucket_fft_layout` with ``dft_rows=m // 2 + 1``, which fits
    one block wherever this does.
    """
    gs, decode = _code_words(m, n, masked)
    sizes = (
        2 * a * a,                 # fa: F_A planes
        2 * b * b,                 # fb: F_B planes
        2 * a * b,                 # w: four-step twiddle
        2 * a * b,                 # msg: one packed shard
        2 * a * b,                 # t1: column-pass result
        2 * m * a * (b + 1),       # z: m shard spectra, then decoded
        gs,                        # gs: G rows (the subset's, or all N)
        2 * (m // 2 + 1) * m,      # fh: the m//2+1 DFT rows
        *decode,                   # pw, qm (inverse or D), loc, nodes, sub
    )
    return tuple(itertools.accumulate(sizes, initial=0))


def _r2c_launch(what: str, symbol: str, xr, decode, gr, gi, swr, swi, twr,
                twi, fhr, fhi, q: int, n: int, m: int, s: int, masked: bool,
                dev):
    """One launch of the r2c bucket kernel on checked CUDA planes;
    ``decode``: the masked entry's (masks, perm), or the planes entry's
    (dr, di).  bf16 planes launch the ``*_bf16`` entry."""
    bf16 = _build.is_bf16(swr)
    n2 = s // m // 2
    dft_rows = m // 2 + 1
    layout = bucket_fft_layout(m, n2, n=n, masked=masked, dft_rows=dft_rows)
    _check_launch(what, m, layout, s)
    rows = bucket_fft_group(m, n2, n=n, masked=masked, dft_rows=dft_rows)
    plan = fft_rows_plan(n2)
    sh = s // 2 + 1
    outr = torch.empty((q, sh), dtype=torch.float32, device=dev)
    outi = torch.empty((q, sh), dtype=torch.float32, device=dev)
    p = _build.ptr
    _build.check(_fft_bucket_lib(
        "coded_rbucket", _build.entry(symbol, bf16), 15, masked)(
        p(xr), *(p(t) for t in decode), p(gr), p(gi),
        *(p(t) for t in fft_twiddles_on(n2, dev, swr.dtype)), p(swr),
        p(swi), p(twr), p(twi), p(fhr), p(fhi), p(outr), p(outi), q, n, m,
        n2, *([_ntau(n)] if masked else []),
        (ctypes.c_int * max(1, len(plan)))(*plan), len(plan), rows,
        (ctypes.c_longlong * len(layout))(*layout), _build.stream_of(dev)),
        what)
    _build.count_launch(_build.launch_name(what, bf16))
    return outr, outi


def coded_rfft_bucket(xr, dr, di, gr, gi, far, fai, wr, wi, fbr, fbi,
                      swr, swi, twr, twi, fhr, fhi, s):
    """The whole r2c bucket on host-built decode planes: (q, s) REAL
    request plane + (q, m, N) scatter decode planes -> (q, s//2+1) planes
    of ``rfft(x)``.

    The other planes as :func:`coded_rfft_bucket_masked` takes them.  CPU
    tensors run :func:`rbucket_body`; CUDA tensors launch the kernel (one
    launch, counted) or raise, reading what
    :func:`coded_rfft_bucket_masked` reads.  The caller checks the gate
    (``ops.coded_rbucket_fusable(..., masked=False)``).
    """
    q, s_ = xr.shape
    n, m = gr.shape
    a, b = far.shape[0], fbr.shape[0]
    n2 = a * b
    if (s_ != s or 2 * m * n2 != s or swr.shape != (1, n2 + 1)
            or twr.shape != (m, 2 * n2) or fhr.shape != (m // 2 + 1, m)):
        raise ValueError("coded_rfft_bucket: inconsistent shapes")
    _check_decode_planes("coded_rfft_bucket", dr, di, q, m, n)
    if xr.device.type == "cpu":
        return rbucket_body(xr, dr, di, gr, gi, *_widened(
            far, fai, wr, wi, fbr, fbi, swr, swi, twr, twi, fhr, fhi), s)
    dev = _build.check_planes(
        "coded_rfft_bucket", xr=xr, dr=dr, di=di, gr=gr, gi=gi, tables=dict(
            far=far, fai=fai, wr=wr, wi=wi, fbr=fbr, fbi=fbi, swr=swr,
            swi=swi, twr=twr, twi=twi, fhr=fhr, fhi=fhi))
    return _r2c_launch("coded_rfft_bucket", "coded_rbucket_f32", xr,
                       (dr, di), gr, gi, swr, swi, twr, twi, fhr, fhi, q, n,
                       m, s, False, dev)


def coded_rfft_bucket_masked(xr, masks, gr, gi, far, fai, wr, wi, fbr, fbi,
                             swr, swi, twr, twi, fhr, fhi, s):
    """The whole masked r2c bucket: (q, s) REAL request plane + (q, N) raw
    responder masks -> (q, s//2+1) planes of ``rfft(x)``.

    ``far/wr/fbr``: four-step planes for the HALF length ``L/2 = A*B``;
    ``swr, swi``: (1, L/2+1) split twiddle; ``twr, twi``: (m, L)
    recombine twiddle, natural order; ``fhr, fhi``: (m//2+1, m) DFT rows.
    ``masks``: bool, or any dtype whose nonzero entries responded (the
    card reads a bool mask in place, one byte a worker, and converts any
    other first).  CPU tensors run :func:`rbucket_body_masked`; CUDA
    tensors launch the kernel (one launch, counted) or raise, also where
    its working set (:func:`bucket_fft_layout` with m//2+1 DFT rows) is
    past one block.
    The card computes the packed shards' DFTs from the f32 table of L/2
    (``fourstep_fft.fft_rows_twiddles``), whose entries are those of the
    planes: it reads G, ``swr``, ``twr`` and ``fhr``, not ``far``,
    ``wr`` or ``fbr``.  The caller checks the shared-memory gate
    (``ops.coded_rbucket_fusable``).
    """
    q, s_ = xr.shape
    n, m = gr.shape
    a, b = far.shape[0], fbr.shape[0]
    n2 = a * b
    if (s_ != s or 2 * m * n2 != s or masks.shape != (q, n)
            or swr.shape != (1, n2 + 1) or twr.shape != (m, 2 * n2)
            or fhr.shape != (m // 2 + 1, m)):
        raise ValueError("coded_rfft_bucket_masked: inconsistent shapes")
    if xr.device.type == "cpu":
        return rbucket_body_masked(xr, masks, gr, gi, *_widened(
            far, fai, wr, wi, fbr, fbi, swr, swi, twr, twi, fhr, fhi), s)
    dev = _build.check_planes(
        "coded_rfft_bucket_masked", xr=xr, gr=gr, gi=gi, tables=dict(
            far=far, fai=fai, wr=wr, wi=wi, fbr=fbr, fbi=fbi, swr=swr,
            swi=swi, twr=twr, twi=twi, fhr=fhr, fhi=fhi))
    if masks.device != dev:
        raise ValueError(f"coded_rfft_bucket_masked: masks are on "
                         f"{masks.device}, the planes on {dev}")
    # the kernel reads one byte a worker, nonzero = responded (as
    # mask_subsets reads them): a bool mask is viewed, not converted
    mk = (masks if masks.dtype == torch.bool else masks != 0).contiguous()
    mk = mk.view(torch.uint8)
    return _r2c_launch("coded_rfft_bucket_masked", "coded_rbucket_masked_f32",
                       xr, (mk, _perm_on(m, dev)), gr, gi, swr, swi, twr, twi,
                       fhr, fhi, q, n, m, s, True, dev)


# -- the c2r bucket ---------------------------------------------------------
def ir_message_body(yr, yi, fpr, fpi, ctwr, ctwi, pwr, pwi, s, m):
    """c2r message stage on planes, the adjoint of the r2c postdecode.

    ``yr, yi``: (bq, s//2+1) half-spectrum request planes.  Hermitian-
    extends them (endpoint imaginary parts dropped, as numpy.fft.irfft
    does), applies the adjoint recombine butterfly (``fpr``: (m, m) +sign
    DFT planes, ``ctwr``: (m, L) conjugate twiddle), and packs each
    shard's Hermitian half spectrum (``pwr``: (1, L/2+1) pack twiddle
    ``omega_L^{+p}``) into the (bq, m, L/2) packed message planes.
    """
    bq, h = yr.shape
    ell = s // m
    n2 = ell // 2
    zeros = torch.zeros((bq, 1), dtype=yr.dtype, device=yr.device)
    midr, midi = yr[:, 1:h - 1], yi[:, 1:h - 1]
    fullr = torch.cat([yr[:, :1], midr, yr[:, h - 1:],
                       torch.flip(midr, dims=(-1,))], dim=-1)
    fulli = torch.cat([zeros, midi, zeros,
                       -torch.flip(midi, dims=(-1,))], dim=-1)  # (bq, s)
    xr3 = fullr.reshape(bq, m, ell).transpose(0, 1).reshape(m, -1)
    xi3 = fulli.reshape(bq, m, ell).transpose(0, 1).reshape(m, -1)
    fr_, fi_ = cmatmul_body(fpr, fpi, xr3, xi3)            # +sign m-DFT
    foldr = fr_.reshape(m, bq, ell).transpose(0, 1)
    foldi = fi_.reshape(m, bq, ell).transpose(0, 1)
    tr = foldr * ctwr[None] - foldi * ctwi[None]
    ti = foldr * ctwi[None] + foldi * ctwr[None]           # (bq, m, L)
    # pack_half on planes: E + 1j * (0.5*(M - conj(M_rev)) * omega_L^{+p})
    mr, mi = tr[..., :n2 + 1], ti[..., :n2 + 1]
    rvr = torch.flip(mr, dims=(-1,))
    rvi = -torch.flip(mi, dims=(-1,))
    er = 0.5 * (mr + rvr)
    ei = 0.5 * (mi + rvi)
    dr_ = 0.5 * (mr - rvr)
    di_ = 0.5 * (mi - rvi)
    pw_r = pwr[0][None, None, :]
    pw_i = pwi[0][None, None, :]
    our = dr_ * pw_r - di_ * pw_i
    oui = dr_ * pw_i + di_ * pw_r
    return (er - oui)[..., :n2], (ei + our)[..., :n2]       # (bq, m, L/2)


def ir_unpack_body(hr, hi):
    """Decoded packed interleave planes ``(bq, m, L/2)`` (``m`` times
    ``ifft(z_i)`` with ``z_i[j] = o_i[2j] + 1j*o_i[2j+1]``) -> the real
    output plane ``(bq, s)``."""
    bq, m, n2 = hr.shape
    op = torch.stack([hr, hi], dim=-1).reshape(bq, m, 2 * n2) / m
    return op.transpose(1, 2).reshape(bq, 2 * m * n2)


def irbucket_body(yr, yi, dr, di, gr, gi, far, fai, wr, wi, fbr, fbi,
                  fpr, fpi, ctwr, ctwi, pwr, pwi, s):
    """The c2r pipeline on a (bq, s//2+1) block of half-spectrum requests
    with given scatter decode planes ``(bq, m, n)``: the adjoint message
    stage, the fused encode + half-length ifft worker -- the forward
    four-step by the conj trick, ``ifft(G @ z) = conj(fft(conj(G) @
    conj(z))) / (L/2)`` -- decode, unscramble and the pair unpack.
    Returns ONE real (bq, s) plane."""
    bq = yr.shape[0]
    n, m = gr.shape
    a, b = far.shape[0], fbr.shape[0]
    n2 = a * b
    zr, zi = ir_message_body(yr, yi, fpr, fpi, ctwr, ctwi, pwr, pwi, s, m)
    er, ei = encode_fourstep_body(
        zr.reshape(bq, m, a, b), (-zi).reshape(bq, m, a, b), gr, -gi,
        far, fai, wr, wi, fbr, fbi)              # (bq, n, a, b) scrambled
    er = er.reshape(bq, n, n2) / n2
    ei = ei.reshape(bq, n, n2) / (-n2)           # conj + 1/(L/2): the ifft
    hr, hi = bcmatmul_body(dr, di, er, ei)
    return ir_unpack_body(_unscramble(hr, a, b), _unscramble(hi, a, b))


def irbucket_body_masked(yr, yi, masks, gr, gi, far, fai, wr, wi, fbr, fbi,
                         fpr, fpi, ctwr, ctwi, pwr, pwi, s):
    """:func:`irbucket_body` with the decode matrices built from the raw
    ``(bq, n)`` responder masks."""
    n, m = gr.shape
    _, _, dr, di = lagrange_planes_body(mask_subsets(masks, m), n)
    return irbucket_body(yr, yi, dr, di, gr, gi, far, fai, wr, wi, fbr, fbi,
                         fpr, fpi, ctwr, ctwi, pwr, pwi, s)


def irbucket_body_fftworker(yr, yi, dvr, dvi, subsets, gr, gi,
                            fpr, fpi, ctwr, ctwi, pwr, pwi, s):
    """The direct c2r bucket: the message stage on planes, the platform
    ifft on the packed half-length coded shards, the gathered compact
    decode, the relabel unpack.  Returns ONE real plane (bq, s).  Plain
    PyTorch."""
    bq = yr.shape[0]
    n, m = gr.shape
    n2 = s // m // 2
    zr, zi = ir_message_body(yr, yi, fpr, fpi, ctwr, ctwi, pwr, pwi, s, m)
    tr = zr.transpose(0, 1).reshape(m, bq * n2)
    ti = zi.transpose(0, 1).reshape(m, bq * n2)
    ar_, ai_ = cmatmul_body(gr, gi, tr, ti)
    spec = torch.fft.ifft(torch.complex(ar_, ai_).reshape(n, bq, n2),
                          dim=-1)
    er = spec.real.to(yr.dtype).transpose(0, 1)
    ei = spec.imag.to(yr.dtype).transpose(0, 1)
    hr, hi = bcmatmul_body(dvr, dvi, *_gather_rows(er, ei, subsets))
    return ir_unpack_body(hr, hi)


def irbucket_layout(m: int, a: int, b: int, *, n: int = 0,
                    masked: bool = True) -> tuple[int, ...]:
    """Word offsets of the dense-DFT c2r bucket's shared arrays, then the
    total, for packed shards of ``L/2 = a*b``; ``masked=False`` is the
    planes variant's (it needs ``n``).

    This is the working set of the first port of
    ``csrc/coded_irbucket.cu`` (F_A, F_B, W, a packed shard, the column
    pass, the m spectra at pitch B+1 and the folded half spectra), kept
    as the fused route's boundary, and its gate only:
    ``ops.coded_irbucket_fusable`` and ``ops.bucket_route`` answer from
    it, so the kernel's FFT redesign moved no c2r bucket between the
    fused and the stage routes.  It lays out no kernel: the kernel takes
    :func:`bucket_fft_layout` with ``side=2 * m``, which fits one block
    wherever this does.
    """
    gs, decode = _code_words(m, n, masked)
    sizes = (
        2 * a * a,                 # fa: F_A planes
        2 * b * b,                 # fb: F_B planes
        2 * a * b,                 # w: four-step twiddle
        2 * a * b,                 # msg: one packed shard
        2 * a * b,                 # t1: column-pass result
        2 * m * a * (b + 1),       # z: m shard spectra
        2 * m * (a * b + 1),       # tt: folded half spectra, t <= L/2
        gs,                        # gs: G rows (the subset's, or all N)
        2 * m * m,                 # fp: +sign m-point DFT
        *decode,                   # pw, qm (inverse or D), loc, nodes, sub
    )
    return tuple(itertools.accumulate(sizes, initial=0))


def _c2r_launch(what: str, symbol: str, yr, yi, decode, gr, gi, fpr, fpi,
                ctwr, ctwi, pwr, pwi, q: int, n: int, m: int, s: int,
                masked: bool, dev):
    """One launch of the c2r bucket kernel on checked CUDA planes;
    ``decode``: the masked entry's (masks, perm), or the planes entry's
    (dr, di).  bf16 planes launch the ``*_bf16`` entry."""
    bf16 = _build.is_bf16(fpr)
    n2 = s // m // 2
    layout = bucket_fft_layout(m, n2, n=n, masked=masked, side=2 * m)
    _check_launch(what, m, layout, s)
    rows = bucket_fft_group(m, n2, n=n, masked=masked, side=2 * m)
    plan = fft_rows_plan(n2)
    out = torch.empty((q, s), dtype=torch.float32, device=dev)
    p = _build.ptr
    _build.check(_fft_bucket_lib(
        "coded_irbucket", _build.entry(symbol, bf16), 15, masked)(
        p(yr), p(yi), *(p(t) for t in decode), p(gr), p(gi),
        *(p(t) for t in fft_twiddles_on(n2, dev, fpr.dtype)), p(fpr),
        p(fpi), p(ctwr), p(ctwi), p(pwr), p(pwi), p(out), q, n, m, n2,
        *([_ntau(n)] if masked else []),
        (ctypes.c_int * max(1, len(plan)))(*plan), len(plan), rows,
        (ctypes.c_longlong * len(layout))(*layout), _build.stream_of(dev)),
        what)
    _build.count_launch(_build.launch_name(what, bf16))
    return out


def coded_irfft_bucket(yr, yi, dr, di, gr, gi, far, fai, wr, wi, fbr, fbi,
                       fpr, fpi, ctwr, ctwi, pwr, pwi, s):
    """The whole c2r bucket on host-built decode planes: (q, s//2+1)
    half-spectrum planes + (q, m, N) scatter decode planes -> the (q, s)
    real plane of ``irfft(y, n=s)``.

    The other planes as :func:`coded_irfft_bucket_masked` takes them.
    CPU tensors run :func:`irbucket_body`; CUDA tensors launch the kernel
    (one launch, counted) or raise, reading what
    :func:`coded_irfft_bucket_masked` reads.  The caller checks the gate
    (``ops.coded_irbucket_fusable(..., masked=False)``).
    """
    q, h = yr.shape
    n, m = gr.shape
    a, b = far.shape[0], fbr.shape[0]
    n2 = a * b
    if (yi.shape != yr.shape or h != s // 2 + 1 or 2 * m * n2 != s
            or fpr.shape != (m, m) or ctwr.shape != (m, 2 * n2)
            or pwr.shape != (1, n2 + 1)):
        raise ValueError("coded_irfft_bucket: inconsistent shapes")
    _check_decode_planes("coded_irfft_bucket", dr, di, q, m, n)
    if yr.device.type == "cpu":
        return irbucket_body(yr, yi, dr, di, gr, gi, *_widened(
            far, fai, wr, wi, fbr, fbi, fpr, fpi, ctwr, ctwi, pwr, pwi), s)
    dev = _build.check_planes(
        "coded_irfft_bucket", yr=yr, yi=yi, dr=dr, di=di, gr=gr, gi=gi,
        tables=dict(far=far, fai=fai, wr=wr, wi=wi, fbr=fbr, fbi=fbi,
                    fpr=fpr, fpi=fpi, ctwr=ctwr, ctwi=ctwi, pwr=pwr,
                    pwi=pwi))
    return _c2r_launch("coded_irfft_bucket", "coded_irbucket_f32", yr, yi,
                       (dr, di), gr, gi, fpr, fpi, ctwr, ctwi, pwr, pwi, q, n,
                       m, s, False, dev)


def coded_irfft_bucket_masked(yr, yi, masks, gr, gi, far, fai, wr, wi,
                              fbr, fbi, fpr, fpi, ctwr, ctwi, pwr, pwi, s):
    """The whole masked c2r bucket: (q, s//2+1) half-spectrum planes +
    (q, N) raw responder masks -> the (q, s) real plane of
    ``irfft(y, n=s)``.

    ``far/wr/fbr``: four-step planes for the HALF length ``L/2 = A*B``;
    ``fpr, fpi``: (m, m) +sign DFT; ``ctwr, ctwi``: (m, L) conjugate
    recombine twiddle; ``pwr, pwi``: (1, L/2+1) pack twiddle.
    ``masks``: bool, or any dtype whose nonzero entries responded (the
    card reads a bool mask in place, one byte a worker, and converts any
    other first).  CPU tensors run :func:`irbucket_body_masked`; CUDA
    tensors launch the kernel (one launch, counted) or raise, also where
    its working set (:func:`bucket_fft_layout` with ``side=2 * m``) is
    past one block.
    The card computes the packed shards' DFTs from the f32 table of L/2
    (``fourstep_fft.fft_rows_twiddles``), whose entries are those of the
    planes: it reads G, ``fpr``, ``ctwr`` (positions t <= L/2) and
    ``pwr``, not ``far``, ``wr`` or ``fbr``.  The caller checks the
    shared-memory gate (``ops.coded_irbucket_fusable``).
    """
    q, h = yr.shape
    n, m = gr.shape
    a, b = far.shape[0], fbr.shape[0]
    n2 = a * b
    if (yi.shape != yr.shape or h != s // 2 + 1 or 2 * m * n2 != s
            or masks.shape != (q, n) or fpr.shape != (m, m)
            or ctwr.shape != (m, 2 * n2) or pwr.shape != (1, n2 + 1)):
        raise ValueError("coded_irfft_bucket_masked: inconsistent shapes")
    if yr.device.type == "cpu":
        return irbucket_body_masked(yr, yi, masks, gr, gi, *_widened(
            far, fai, wr, wi, fbr, fbi, fpr, fpi, ctwr, ctwi, pwr, pwi), s)
    dev = _build.check_planes(
        "coded_irfft_bucket_masked", yr=yr, yi=yi, gr=gr, gi=gi,
        tables=dict(far=far, fai=fai, wr=wr, wi=wi, fbr=fbr, fbi=fbi,
                    fpr=fpr, fpi=fpi, ctwr=ctwr, ctwi=ctwi, pwr=pwr,
                    pwi=pwi))
    if masks.device != dev:
        raise ValueError(f"coded_irfft_bucket_masked: masks are on "
                         f"{masks.device}, the planes on {dev}")
    # the kernel reads one byte a worker, nonzero = responded (as
    # mask_subsets reads them): a bool mask is viewed, not converted
    mk = (masks if masks.dtype == torch.bool else masks != 0).contiguous()
    mk = mk.view(torch.uint8)
    return _c2r_launch("coded_irfft_bucket_masked",
                       "coded_irbucket_masked_f32", yr, yi,
                       (mk, _perm_on(m, dev)), gr, gi, fpr, fpi, ctwr, ctwi,
                       pwr, pwi, q, n, m, s, True, dev)
