"""Four-step DFT kernels: the plan's worker and the fused encode + worker.

The per-worker hot loop of coded FFT is a length-L DFT of a coded shard.
Factor ``L = A * B`` and compute

    out[c, d] = ((F_A @ M) * W) @ F_B,     M[a, b] = x[a*B + b]
    X[c + d*A] = out[c, d]

two DFT passes (dense matmuls in the plain twins) and one elementwise
twiddle on planar f32 data.

* ``fourstep_fused`` -- one launch, each batch row whole in one block's
  shared memory: on the card the row FFT's passes over the row, then the
  store in the scrambled order (the one-block kernel, its working set
  :func:`fft_block_layout`; the fused gate stays
  :func:`fourstep_layout`);
* ``fourstep_stage1`` / ``fourstep_stage2`` -- the two-pass route for
  shards too long for one block: the column pass with the twiddle, then
  the row pass, the intermediate in device memory.  Neither takes a DFT
  plane on the card: the row pass is a B-point FFT of every row (a
  shared-memory Stockham FFT, its radix plan :func:`fft_rows_plan`,
  working set :func:`fft_rows_layout` and twiddle table
  :func:`fft_rows_twiddles`), the column pass the same schedule down
  tiles of columns (the column FFT below) with W in its last pass;
* ``fourstep_streaming`` -- the four-step behind one entry with no dense
  DFT: both passes are the column FFT (the row FFT's Stockham schedule
  down a tile of columns, its tile :func:`fft_cols_tile`, working set
  :func:`fft_cols_layout`), the first storing transposed, so the output
  is in natural order ``(batch, B, A)``, no unscramble after it;
* ``encode_fourstep_fused`` -- the MDS encode folded in: the generator
  contraction acts across shards and the DFT within each, so the kernel
  transforms the m MESSAGE shards and encodes after (an N/m saving).  On
  the card: the column FFT of every shard, then the row FFT of row c of
  all m shards at once with G applied as it stores (its working set
  :func:`encode_rows_layout`, the gate :func:`encode_rows_fold`), or past
  that gate the row FFT and a separate G apply;
* ``multistep_fused`` -- the mixed-radix four-step, ``L = f1 * ... *
  fk``: where the row fits one block (the gate :func:`multistep_layout`)
  the one-block kernel of ``fourstep_fused`` with the k-digit store, else
  one FFT launch per stage (the column FFT, the row FFT for the last;
  :func:`multistep_stage_plan`).

Precision: the wrappers of the first five (and ``multistep_fused``'s both
modes) take the constant planes in float32 or, under the dispatch
layer's ``precision="bf16"``, in bfloat16, and dispatch on their dtype.
CPU tensors run the plain twin on the planes widened to f32 (the
reference's dense arithmetic on the same rounded constants); CUDA
tensors launch the kernel's ``*_bf16`` entry, which reads the bf16
tables of :func:`fft_twiddles_on` (each entry that of the bf16 plane,
bit for bit) and the caller's bf16 twiddle W, widening each to f32 as it
loads.  Its launches count as ``<name>[bf16]``.  The encode stays f32,
as in the reference.

CUDA sources: ``csrc/fourstep.cu`` (the first four; the row FFT in
``csrc/fft_rows.cuh``, the column FFT in ``csrc/fft_cols.cuh``, the
one-block kernel in ``csrc/fft_block.cuh``), ``csrc/encode_fourstep.cu``
and ``csrc/multistep.cu``; the plain twins
are :func:`fourstep_body`, :func:`stage1_body`, :func:`stage2_body`,
:func:`fourstep_streaming_body`, :func:`encode_fourstep_body` and
:func:`multistep_body`.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cmatmul import check_left_fits

__all__ = [
    "fourstep_body",
    "fourstep_fused",
    "fourstep_layout",
    "stage1_body",
    "stage2_body",
    "fourstep_stage1",
    "fourstep_stage2",
    "fft_cols_layout",
    "fft_cols_spec",
    "fft_cols_tile",
    "fft_block_layout",
    "fft_rows_layout",
    "fft_rows_plan",
    "fft_rows_spec",
    "fft_rows_twiddles",
    "fft_twiddles_on",
    "fourstep_streaming_body",
    "fourstep_streaming",
    "encode_fourstep_body",
    "encode_fourstep_fused",
    "encode_rows_fold",
    "encode_rows_layout",
    "encode_rows_per_block",
    "encode_rows_spec",
    "multistep_body",
    "multistep_fused",
    "multistep_layout",
    "multistep_mode",
    "multistep_stage_plan",
]


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


def stage1_body(xr, xi, far, fai, wr, wi):
    """Column pass on a (bq, A, B) block: ``(F_A @ M) * W`` per row."""
    bq, a, b = xr.shape
    mr = xr.transpose(0, 1).reshape(a, bq * b)
    mi = xi.transpose(0, 1).reshape(a, bq * b)
    t1r, t1i = _cmul_mm(far, fai, mr, mi)
    t1r = t1r.reshape(a, bq, b)
    t1i = t1i.reshape(a, bq, b)
    wr = wr[:, None, :]
    wi = wi[:, None, :]
    return ((t1r * wr - t1i * wi).transpose(0, 1),
            (t1r * wi + t1i * wr).transpose(0, 1))


def stage2_body(tr, ti, fbr, fbi):
    """Row pass on a (bq, A, B) block: ``T @ F_B`` per row."""
    bq, a, b = tr.shape
    t3r, t3i = _cmul_mm(tr.reshape(bq * a, b), ti.reshape(bq * a, b),
                        fbr, fbi)
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
    vp, spec = ctypes.c_void_p, ctypes.POINTER(FftSpec)
    fn.argtypes = [vp] * 16 + [ctypes.c_int] * 3 + [spec, spec,
                                                     ctypes.c_int, vp]
    fn.restype = ctypes.c_int
    return fn


def encode_fourstep_fused(cr, ci, gr, gi, far, fai, wr, wi, fbr, fbi):
    """Fused encode + worker DFT: message planes -> coded worker spectra.

    ``cr, ci``: (q, m, A, B) planes of the m message shards,
    ``M_i[a, b] = c_i[a*B + b]``; ``gr, gi``: (n, m) generator planes.
    Returns (q, n, A, B) planes of ``out[k, c, d]`` with
    ``B_k[c + d*A] = out[k, c, d]``.

    CPU tensors run :func:`encode_fourstep_body`; CUDA tensors launch the
    kernel or raise.  Launch 1 is the column FFT of every shard with W
    (the A-point table of :func:`fft_rows_twiddles`); where the row block
    fits (:func:`encode_rows_fold`) launch 2 is the row FFT of row c of
    all m shards with G applied as it stores, else the row FFT over every
    row into device scratch, then the G apply (three launches).  Each
    launch is counted.  The card reads G, W and the f32 tables of A and
    B, not ``far`` or ``fbr``.
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
    _build.check_planes(
        "encode_fourstep_fused", cr=cr, ci=ci, gr=gr, gi=gi, far=far,
        fai=fai, wr=wr, wi=wi, fbr=fbr, fbi=fbi)
    check_left_fits("encode_fourstep_fused", n, m)     # the G apply
    return _encode_on_card(cr, ci, gr, gi, wr, wi,
                           encode_rows_fold(m, a, b))


def _encode_on_card(cr, ci, gr, gi, wr, wi, fold: bool):
    """The encode's launches on checked CUDA planes: the folded route
    (two launches) where ``fold``, else the row FFT and the G apply
    (three).  :func:`encode_fourstep_fused` passes its gate's decision;
    a caller may force either route where its working set fits, to time
    one against the other."""
    q, m, a, b = cr.shape
    n = gr.shape[0]
    dev = cr.device
    if not fold and q > _build.MAX_GRID_YZ:
        raise ValueError(f"encode_fourstep_fused: q={q} requests exceed the "
                         f"G apply's grid of {_build.MAX_GRID_YZ}")
    spec_a = fft_cols_spec("encode_fourstep_fused", a, b)
    spec_b = (encode_rows_spec(m, a, b) if fold
              else fft_rows_spec("encode_fourstep_fused", b))
    t1r = torch.empty_like(cr)
    t1i = torch.empty_like(cr)
    outr = torch.empty((q, n, a, b), dtype=torch.float32, device=dev)
    outi = torch.empty_like(outr)
    if q == 0:
        return outr, outi
    # Z, the row FFT's output, reaches device memory only past the fold
    zr, zi = ((None, None) if fold
              else (torch.empty_like(cr), torch.empty_like(cr)))
    p = _build.ptr
    _build.check(_lib()(
        p(cr), p(ci), p(gr), p(gi), p(wr), p(wi),
        *(p(t) for t in fft_twiddles_on(a, dev)),
        *(p(t) for t in fft_twiddles_on(b, dev)), p(t1r), p(t1i),
        *(None if t is None else p(t) for t in (zr, zi)), p(outr), p(outi),
        q, m, n, ctypes.byref(spec_a), ctypes.byref(spec_b), int(fold),
        _build.stream_of(dev)), "encode_fourstep_fused")
    _build.count_launch("encode_fourstep_fused", 2 if fold else 3)
    return outr, outi


# -- the plan's worker: fused and two-pass four-step ----------------------
def fourstep_layout(a: int, b: int) -> tuple[int, ...]:
    """Word offsets of the first port's dense fused four-step kernel's
    shared arrays (the row's A x B matrix and its column pass), then the
    total: 16 bytes a point.

    No kernel lays this out any more: it is the fused route's boundary
    (``ops.fourstep_fusable``), kept so that the one-block redesign moved
    no length between the fused and two-pass routes.  The kernel lays out
    :func:`fft_block_layout`, which fits one block wherever this does.
    """
    sizes = (
        2 * a * b,               # x: the row's A x B matrix
        2 * a * b,               # t1: column-pass result
    )
    return tuple(itertools.accumulate(sizes, initial=0))


def _check_fourstep(what, xr, xi, **planes):
    """Shape check of a four-step wrapper: (batch, A, B) planes and the
    (A, A), (A, B), (B, B) constant planes it names."""
    _, a, b = xr.shape
    want = {"far": (a, a), "fai": (a, a), "wr": (a, b), "wi": (a, b),
            "fbr": (b, b), "fbi": (b, b)}
    if xi.shape != xr.shape or any(t.shape != want[k]
                                   for k, t in planes.items()):
        raise ValueError(f"{what}: inconsistent shapes")


def _widened(*planes):
    """The planes as the plain twins take them: f32 (a bf16 plane widened,
    exactly)."""
    return tuple(p.float() for p in planes)


@functools.lru_cache(maxsize=None)
def _fused_lib(bf16: bool = False):
    fn = getattr(_build.load("fourstep"),
                 _build.entry("fourstep_fused_f32", bf16))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp] * 6 + [i64, i32, i32, ctypes.POINTER(i32), i32, i32,
                              ctypes.POINTER(i64), vp]
    fn.restype = ctypes.c_int
    return fn


def _block_plan(what: str, ell: int):
    """The one-block kernel's launch arguments for ``ell``-point rows: the
    row FFT's radices and their count, the rows a block takes and the
    layout words (:func:`fft_block_layout`).  Raises ValueError, naming
    ``what``, where the layout is past one block's shared memory."""
    layout = fft_block_layout(ell)
    if 4 * layout[-1] > _build.SMEM_PER_BLOCK_OPTIN:
        raise ValueError(
            f"{what}: rows of {ell} points need {4 * layout[-1]} bytes of "
            f"shared memory per block, over {_build.SMEM_PER_BLOCK_OPTIN}")
    plan = fft_rows_plan(ell)
    return ((ctypes.c_int * max(1, len(plan)))(*plan), len(plan),
            fft_rows_per_block(ell),
            (ctypes.c_longlong * len(layout))(*layout))


def fourstep_fused(xr, xi, far, fai, wr, wi, fbr, fbi):
    """Batched fused four-step FFT: one launch.

    ``xr, xi``: (batch, A, B) planes of ``M[a, b] = x[a*B + b]``.  Returns
    (batch, A, B) planes of ``out[c, d]`` with ``X[c + d*A] = out[c, d]``.
    CPU tensors run :func:`fourstep_body`; CUDA tensors launch the kernel
    (counted) or raise -- also where the fused gate refuses (A, B): the
    dense design's working set, :func:`fourstep_layout`, past one block's
    shared memory.  The card runs the one-block kernel: the row FFT over
    each whole row from the L-point table of :func:`fft_rows_twiddles`
    (f32, or bf16 for bf16 planes), stored in the scrambled order.  It
    reads none of the six planes: their entries are the table's, bit for
    bit.
    """
    batch, a, b = xr.shape
    _check_fourstep("fourstep_fused", xr, xi, far=far, fai=fai, wr=wr,
                    wi=wi, fbr=fbr, fbi=fbi)
    if xr.device.type == "cpu":
        return fourstep_body(xr, xi, *_widened(far, fai, wr, wi, fbr, fbi))
    dev = _build.check_planes(
        "fourstep_fused", xr=xr, xi=xi, tables=dict(
            far=far, fai=fai, wr=wr, wi=wi, fbr=fbr, fbi=fbi))
    bf16 = _build.is_bf16(far)
    gate = fourstep_layout(a, b)
    if 4 * gate[-1] > _build.SMEM_PER_BLOCK_OPTIN:
        raise ValueError(
            f"fourstep_fused: ({a}, {b}) needs {4 * gate[-1]} bytes of "
            f"shared memory per block, over {_build.SMEM_PER_BLOCK_OPTIN}; "
            f"route it to the two-pass kernels")
    ell = a * b
    block = _block_plan("fourstep_fused", ell)
    outr = torch.empty_like(xr)
    outi = torch.empty_like(xr)
    p = _build.ptr
    _build.check(_fused_lib(bf16)(
        p(xr), p(xi), *(p(t) for t in fft_twiddles_on(ell, dev, far.dtype)),
        p(outr), p(outi), batch, a, b, *block, _build.stream_of(dev)),
        "fourstep_fused")
    _build.count_launch(_build.launch_name("fourstep_fused", bf16))
    return outr, outi


@functools.lru_cache(maxsize=None)
def _stage1_lib(bf16: bool = False):
    fn = getattr(_build.load("fourstep"),
                 _build.entry("fourstep_stage1_f32", bf16))
    vp = ctypes.c_void_p
    fn.argtypes = [vp] * 8 + [ctypes.c_longlong, ctypes.c_int,
                              ctypes.POINTER(FftSpec), vp]
    fn.restype = ctypes.c_int
    return fn


def fourstep_stage1(xr, xi, far, fai, wr, wi):
    """Column pass of the two-pass four-step: ``(F_A @ M) * W`` per row.

    ``xr, xi``: (batch, A, B) planes of ``M[a, b] = x[a*B + b]``.  Returns
    the twiddled column DFT as (batch, A, B) planes.  CPU tensors run
    :func:`stage1_body`; CUDA tensors launch the column FFT (A points
    over B columns, W folded into its last pass, the plain store: one
    launch for any batch, counted) or raise -- also where a tile's
    working set (:func:`fft_cols_layout`) exceeds one block's shared
    memory.  The card computes the DFT from the table of A
    (:func:`fft_rows_twiddles`, f32 or bf16 as the planes are): it reads
    W, not ``far``.
    """
    batch, a, b = xr.shape
    _check_fourstep("fourstep_stage1", xr, xi, far=far, fai=fai, wr=wr,
                    wi=wi)
    if xr.device.type == "cpu":
        return stage1_body(xr, xi, *_widened(far, fai, wr, wi))
    dev = _build.check_planes("fourstep_stage1", xr=xr, xi=xi, tables=dict(
        far=far, fai=fai, wr=wr, wi=wi))
    bf16 = _build.is_bf16(far)
    spec = fft_cols_spec("fourstep_stage1", a, b)
    outr = torch.empty_like(xr)
    outi = torch.empty_like(xr)
    if batch == 0:
        return outr, outi
    p = _build.ptr
    _build.check(_stage1_lib(bf16)(
        p(xr), p(xi), p(wr), p(wi),
        *(p(t) for t in fft_twiddles_on(a, dev, far.dtype)), p(outr),
        p(outi), batch, b, ctypes.byref(spec), _build.stream_of(dev)),
        "fourstep_stage1")
    _build.count_launch(_build.launch_name("fourstep_stage1", bf16))
    return outr, outi


# -- the two-pass route's row pass: a Stockham FFT of every row ------------
# Rows of one block: ceil(FFT_ROWS_TILE / B), at least one
FFT_ROWS_TILE = 2048


@functools.lru_cache(maxsize=None)
def fft_rows_plan(b: int) -> tuple[int, ...]:
    """The radix plan of the B-point row FFT, in pass order: an 8 for each
    three factors of two, the one or two left over as a 2 or a 4 (4, 4 in
    place of 8, 2), then the odd prime factors in ascending order.  The
    kernel unrolls radices 2, 4, 8, 3, 5 and 7 in registers and runs any
    other prime as a dense pass.  ``prod == b``; empty for b = 1."""
    if b < 1:
        raise ValueError(f"fft_rows_plan: length {b} < 1")
    twos = (b & -b).bit_length() - 1
    eights, rest = divmod(twos, 3)
    if rest == 1 and eights:
        eights -= 1
        head = (4, 4)
    else:
        head = {0: (), 1: (2,), 2: (4,)}[rest]
    plan = [8] * eights + list(head)
    n = b >> twos
    p = 3
    while n > 1:
        while n % p == 0:
            plan.append(p)
            n //= p
        p += 2
        if p * p > n > 1:
            plan.append(n)
            break
    return tuple(plan)


def fft_rows_per_block(b: int) -> int:
    """Rows one block of the row FFT takes: ``ceil(2048 / b)``, >= 1."""
    return max(1, -(-FFT_ROWS_TILE // b))


def _padded(n: int) -> int:
    """Words of an n-word shared plane padded one word in 32: the
    kernels' ``pad(n - 1) + 1``."""
    return n + ((n - 1) >> 5)


def fft_rows_layout(b: int) -> tuple[int, ...]:
    """Word offsets of the row FFT's shared arrays, then the total: two
    planar buffers of a block's rows, then the twiddle table's two planes,
    each plane padded one word in 32 (``pad(a) = a + a // 32``) against
    bank conflicts.

    The kernel takes these offsets at launch (``Layout`` in
    ``csrc/fft_rows.cuh``, same order), so this is the one reckoning of
    its working set, which :func:`fourstep_stage2` holds against
    :data:`_build.SMEM_PER_BLOCK_OPTIN`: every B up to 4096 fits.
    """
    rows = _padded(fft_rows_per_block(b) * b)
    return tuple(itertools.accumulate((2 * rows, 2 * rows, 2 * _padded(b)),
                                      initial=0))


def fft_block_layout(ell: int) -> tuple[int, ...]:
    """Word offsets of the one-block kernel's shared arrays, then the
    total, for rows of ``ell`` points (``fourstep_fused`` and
    ``multistep_fused``'s block mode, ``csrc/fft_block.cuh``): the two
    planar row buffers of a block's :func:`fft_rows_per_block` rows, then
    the table's two planes -- the order of ``Layout`` in
    ``csrc/fft_rows.cuh``.

    Per length, what fits one block's shared memory: where
    :func:`fft_rows_layout` fits (L up to 9392) it is this layout; past
    that the table stays in global memory (``tab == total``: no words)
    and the buffers keep their padding up to L = 14,088; past that they
    are unpadded (plane words == rows * L), up to L = 14,528, the largest
    row the gates (:func:`fourstep_layout`, :func:`multistep_layout`)
    admit.  The kernel reads both choices from these offsets.
    """
    full = fft_rows_layout(ell)
    if 4 * full[-1] <= _build.SMEM_PER_BLOCK_OPTIN:
        return full
    words = fft_rows_per_block(ell) * ell
    plane = _padded(words)
    if 16 * plane > _build.SMEM_PER_BLOCK_OPTIN:
        plane = words
    return (0, 2 * plane, 4 * plane, 4 * plane)


@functools.lru_cache(maxsize=None)
def fft_rows_twiddles(b: int):
    """The row FFT's twiddle table ``w^t``, t < b, as f32 (re, im):
    built in float64 from the integer-reduced angle, exactly as the DFT
    plane tables are, so ``F_B[j][k] == table[(j*k) % b]`` bit for bit."""
    ang = -1.0 * 2.0 * np.pi * np.arange(b) / b
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_from_twiddles(b: int, dtype=torch.float32):
    """The (b, b) DFT planes F_B[j][k] = table[(j*k) % b] in ``dtype``
    (the bf16 planes are the f32 ones rounded), widened to f32: the CPU
    twin of :func:`fourstep_stage2`."""
    jk = np.outer(np.arange(b), np.arange(b)) % b
    return tuple(torch.as_tensor(t[jk]).to(dtype).float()
                 for t in fft_rows_twiddles(b))


@functools.lru_cache(maxsize=None)
def fft_twiddles_on(b: int, device: torch.device, dtype=torch.float32):
    """:func:`fft_rows_twiddles` as two tensors on ``device``: f32, or
    (``dtype=torch.bfloat16``, the bf16 entries' tables) the f32 values
    rounded to nearest even, each entry that of the bf16 DFT plane, bit
    for bit."""
    return tuple(torch.as_tensor(t).to(dtype).to(device)
                 for t in fft_rows_twiddles(b))


# -- the column FFT: the same schedule down a tile of columns ---------------
# Points of one block's tile at most: TC * n <= FFT_COLS_TILE
FFT_COLS_TILE = 4096
# Widest tile, in columns
FFT_COLS_MAX_TC = 256
# Passes a plan record holds (csrc/fft_rows.cuh, kMaxPasses)
FFT_MAX_PASSES = 16


def fft_cols_tile(n: int, ld: int) -> int:
    """Columns TC of one tile of the n-point column FFT over ``ld``
    columns: a power of two, doubled while ``2 * TC * n`` stays within
    :data:`FFT_COLS_TILE`, TC stays under :data:`FFT_COLS_MAX_TC` and the
    tile is narrower than ``ld``.  So n = 512 takes 8 columns (32-byte
    runs), n = 384 8, n > 2048 one."""
    tc = 1
    while tc < ld and 2 * tc * n <= FFT_COLS_TILE and tc < FFT_COLS_MAX_TC:
        tc *= 2
    return tc


def fft_cols_layout(n: int, ld: int) -> tuple[int, ...]:
    """Word offsets of the column FFT's shared arrays, then the total: two
    planar buffers of one tile (``fft_cols_tile(n, ld) * n`` points),
    then the twiddle table's two planes, each plane padded one word in 32
    as :func:`fft_rows_layout` pads.

    The kernel takes these offsets at launch (``FftSpec.layout`` in
    ``csrc/fft_cols.cuh``), so this is the one reckoning of its working
    set, which :func:`fft_cols_spec` holds against
    :data:`_build.SMEM_PER_BLOCK_OPTIN`: every n up to 4096 fits.
    """
    tile = _padded(fft_cols_tile(n, ld) * n)
    return tuple(itertools.accumulate((2 * tile, 2 * tile, 2 * _padded(n)),
                                      initial=0))


class FftSpec(ctypes.Structure):
    """``fft_cols::FftSpec`` of ``csrc/fft_cols.cuh``: one transform's
    length, tile (log2 of a column tile's TC, or a row block's rows),
    radix plan and shared-memory layout, passed to a launch by pointer."""

    _fields_ = [("n", ctypes.c_int), ("tile", ctypes.c_int),
                ("passes", ctypes.c_int),
                ("radix", ctypes.c_int * FFT_MAX_PASSES),
                ("layout", ctypes.c_longlong * 4)]


def _fft_spec(what: str, n: int, tile: int, layout) -> FftSpec:
    plan = fft_rows_plan(n)
    if 4 * layout[-1] > _build.SMEM_PER_BLOCK_OPTIN:
        raise ValueError(
            f"{what}: a {n}-point FFT needs {4 * layout[-1]} bytes of "
            f"shared memory per block, over {_build.SMEM_PER_BLOCK_OPTIN}")
    return FftSpec(n, tile, len(plan),
                   (ctypes.c_int * FFT_MAX_PASSES)(*plan),
                   (ctypes.c_longlong * 4)(*layout))


@functools.lru_cache(maxsize=None)
def fft_cols_spec(what: str, n: int, ld: int) -> FftSpec:
    """The column FFT's plan record for n points over ``ld`` columns.
    Raises ValueError, naming ``what``, where its working set
    (:func:`fft_cols_layout`) exceeds one block's shared memory."""
    return _fft_spec(what, n, fft_cols_tile(n, ld).bit_length() - 1,
                     fft_cols_layout(n, ld))


@functools.lru_cache(maxsize=None)
def fft_rows_spec(what: str, n: int) -> FftSpec:
    """The row FFT's plan record for n-point rows (tile: the rows a
    block takes).  Raises ValueError as :func:`fft_cols_spec` does."""
    return _fft_spec(what, n, fft_rows_per_block(n), fft_rows_layout(n))


# -- the encode's row FFT with the generator folded into its store ---------
def encode_rows_per_block(m: int, a: int, b: int) -> int:
    """Rows c one block of the folded encode takes: row c of each of the
    m shards is one block row, so ``ceil(2048 / (m*b))`` of them fill
    the row FFT's 2048-point tile, at least one and at most A."""
    return min(a, max(1, -(-FFT_ROWS_TILE // (m * b))))


def encode_rows_layout(m: int, a: int, b: int) -> tuple[int, ...]:
    """Word offsets of the folded encode's shared arrays, then the total:
    two planar buffers of a block's ``m * encode_rows_per_block`` rows of
    B points, then the table's two planes, each plane padded one word in
    32 as :func:`fft_rows_layout` pads (``Layout`` of
    ``csrc/fft_rows.cuh``, the order the kernel takes)."""
    rows = _padded(m * encode_rows_per_block(m, a, b) * b)
    return tuple(itertools.accumulate((2 * rows, 2 * rows, 2 * _padded(b)),
                                      initial=0))


def encode_rows_fold(m: int, a: int, b: int) -> bool:
    """Does the encode fold G into its row FFT (two launches, else
    three)?  Where the m rows of one c, which a block must hold to apply
    G as it stores, are at most :data:`FFT_COLS_TILE` points -- 67 KB of
    buffers, so that two or more blocks share an SM -- and
    :func:`encode_rows_layout` fits one block's shared memory.  So m = 4
    and m = 8 fold at B = 512, m = 64 at B = 8; m = 16 at B = 512 (8192
    points, 139 KB: one block an SM) does not.  The cap is measured: on
    an H100 (700 W) at (q, m, N, A, B) = (4, 16, 32, 512, 512) the folded
    route took 0.883 ms and the three launches 0.716 (``chip_smoke.py``,
    phase ``encode_fold_fork``)."""
    return (m * b <= FFT_COLS_TILE
            and 4 * encode_rows_layout(m, a, b)[-1]
            <= _build.SMEM_PER_BLOCK_OPTIN)


@functools.lru_cache(maxsize=None)
def encode_rows_spec(m: int, a: int, b: int) -> FftSpec:
    """The folded encode's row plan record: B points, its tile the rows c
    a block takes (:func:`encode_rows_per_block`), its layout
    :func:`encode_rows_layout`."""
    return _fft_spec("encode_fourstep_fused", b,
                     encode_rows_per_block(m, a, b),
                     encode_rows_layout(m, a, b))


@functools.lru_cache(maxsize=None)
def _stage2_lib(bf16: bool = False):
    fn = getattr(_build.load("fourstep"),
                 _build.entry("fourstep_stage2_f32", bf16))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp] * 6 + [i64, i32, ctypes.POINTER(i32), i32, i32,
                              ctypes.POINTER(i64), vp]
    fn.restype = ctypes.c_int
    return fn


def fourstep_stage2(tr, ti, *, precision: str = "f32"):
    """Row pass of the two-pass four-step: the B-point DFT of every row,
    ``T @ F_B`` per (batch, A) row.

    ``tr, ti``: (batch, A, B) planes from :func:`fourstep_stage1`.
    Returns (batch, A, B) planes of ``out[c, d] = X[c + d*A]``.  It takes
    no plane: ``precision`` (``"f32"`` or ``"bf16"``) is that of its
    table, the DFT of B's entries.  CPU tensors run :func:`stage2_body`
    with the DFT planes of B in that precision; CUDA tensors launch the
    row FFT (one launch, its ``*_bf16`` entry for bf16) or raise -- also
    when a block's working set (:func:`fft_rows_layout`) exceeds its
    shared memory.
    """
    if tr.ndim != 3 or ti.shape != tr.shape:
        raise ValueError("fourstep_stage2: inconsistent shapes")
    if precision not in ("f32", "bf16"):
        raise ValueError(f"unknown plane precision {precision!r}")
    bf16 = precision == "bf16"
    dtype = torch.bfloat16 if bf16 else torch.float32
    batch, a, b = tr.shape
    if tr.device.type == "cpu":
        return stage2_body(tr, ti, *_dft_from_twiddles(b, dtype))
    dev = _build.check_planes("fourstep_stage2", tr=tr, ti=ti)
    layout = fft_rows_layout(b)
    if 4 * layout[-1] > _build.SMEM_PER_BLOCK_OPTIN:
        raise ValueError(
            f"fourstep_stage2: rows of {b} points need {4 * layout[-1]} "
            f"bytes of shared memory per block, over "
            f"{_build.SMEM_PER_BLOCK_OPTIN}")
    plan = fft_rows_plan(b)
    twr, twi = fft_twiddles_on(b, dev, dtype)
    outr = torch.empty_like(tr)
    outi = torch.empty_like(tr)
    p = _build.ptr
    _build.check(_stage2_lib(bf16)(
        p(tr), p(ti), p(twr), p(twi), p(outr), p(outi), batch * a, b,
        (ctypes.c_int * max(1, len(plan)))(*plan), len(plan),
        fft_rows_per_block(b), (ctypes.c_longlong * len(layout))(*layout),
        _build.stream_of(dev)), "fourstep_stage2")
    _build.count_launch(_build.launch_name("fourstep_stage2", bf16))
    return outr, outi


def fourstep_streaming_body(xr, xi, far, fai, wr, wi, fbr, fbi):
    """The streaming four-step on a (bq, A, B) block: the column pass, the
    row pass, then the one transpose to natural order (bq, B, A),
    ``out[d, c] = X[d*A + c]``."""
    outr, outi = stage2_body(*stage1_body(xr, xi, far, fai, wr, wi),
                             fbr, fbi)
    return (outr.transpose(-1, -2).contiguous(),
            outi.transpose(-1, -2).contiguous())


@functools.lru_cache(maxsize=None)
def _streaming_lib(bf16: bool = False):
    fn = getattr(_build.load("fourstep"),
                 _build.entry("fourstep_streaming_f32", bf16))
    vp = ctypes.c_void_p
    spec = ctypes.POINTER(FftSpec)
    fn.argtypes = [vp] * 12 + [ctypes.c_longlong, spec, spec, vp]
    fn.restype = ctypes.c_int
    return fn


def fourstep_streaming(xr, xi, far, fai, wr, wi, fbr, fbi):
    """Batched four-step FFT of rows past one block, natural order out.

    ``xr, xi``: (batch, A, B) planes of ``M[a, b] = x[a*B + b]``.  Returns
    (batch, B, A) planes with ``out[d, c] = X[d*A + c]``: flattened, the
    spectrum in natural order.  CPU tensors run
    :func:`fourstep_streaming_body`; CUDA tensors launch the kernel -- two
    launches of the column FFT (A points over B columns with W, stored
    transposed; B points over A columns), counted, with a (batch, B, A)
    plane pair of device scratch -- or raise, also where a tile's working
    set (:func:`fft_cols_layout`) exceeds one block's shared memory.  The
    card computes the DFTs from the tables of A and B
    (:func:`fft_rows_twiddles`, f32 or bf16 as the planes are), whose
    entries are those of the DFT planes: it reads W, not ``far`` or
    ``fbr``.
    """
    batch, a, b = xr.shape
    _check_fourstep("fourstep_streaming", xr, xi, far=far, fai=fai, wr=wr,
                    wi=wi, fbr=fbr, fbi=fbi)
    if xr.device.type == "cpu":
        return fourstep_streaming_body(
            xr, xi, *_widened(far, fai, wr, wi, fbr, fbi))
    dev = _build.check_planes(
        "fourstep_streaming", xr=xr, xi=xi, tables=dict(
            far=far, fai=fai, wr=wr, wi=wi, fbr=fbr, fbi=fbi))
    bf16 = _build.is_bf16(far)
    spec_a = fft_cols_spec("fourstep_streaming", a, b)
    spec_b = fft_cols_spec("fourstep_streaming", b, a)
    t1r, t1i, outr, outi = (
        torch.empty((batch, b, a), dtype=torch.float32, device=dev)
        for _ in range(4))
    if batch == 0:
        return outr, outi
    p = _build.ptr
    _build.check(_streaming_lib(bf16)(
        p(xr), p(xi), p(wr), p(wi),
        *(p(t) for n in (a, b) for t in fft_twiddles_on(n, dev, far.dtype)),
        p(t1r), p(t1i), p(outr), p(outi), batch, ctypes.byref(spec_a),
        ctypes.byref(spec_b), _build.stream_of(dev)), "fourstep_streaming")
    _build.count_launch(_build.launch_name("fourstep_streaming", bf16), 2)
    return outr, outi


# -- the mixed-radix (multistep) four-step -------------------------------
# Stages the kernel's plan holds (csrc/multistep.cu, kMaxStages)
MAX_STAGES = 32


def _parse_stage_planes(factors, planes):
    """Group the flat plane list into per-stage ``(fr, fi, twr, twi)``.

    The flat order is per stage: the (f, f) DFT planes, then -- for every
    stage but the last, whose ``rest`` is 1 and whose twiddle is
    identically one -- the (f, rest) twiddle planes.
    """
    stages = []
    idx = 0
    for i, _ in enumerate(factors):
        fr, fi = planes[idx], planes[idx + 1]
        idx += 2
        twr = twi = None
        if i + 1 < len(factors):
            twr, twi = planes[idx], planes[idx + 1]
            idx += 2
        stages.append((fr, fi, twr, twi))
    return stages


def multistep_body(xr, xi, stages):
    """Mixed-radix four-step on (bq, L) planes.

    ``stages``: per-factor ``(fr, fi, twr, twi)`` from
    :func:`_parse_stage_planes`.  Each stage splits the remaining length
    as ``f * rest``, contracts ``f`` with the dense (f, f) DFT (batch and
    the digits already done folded into the columns), twiddles by the
    (f, rest) plane and pushes the new digit onto the lead axis:
    ``out[lead, c, r] = sum_j F[c, j] x[lead, j, r] tw[c, r]``.  Returns
    the scrambled order ``X[c1 + f1*c2 + f1*f2*c3 + ...]`` at flat
    position ``(c1, ..., ck)``; for two factors that is
    :func:`fourstep_body`'s ``out[c, d] = X[c + d*A]``.
    """
    bq, total = xr.shape
    lead = bq
    tr, ti = xr, xi
    for fr, fi, twr, twi in stages:
        f = fr.shape[0]
        rest = total // f
        mr = tr.reshape(lead, f, rest).transpose(0, 1).reshape(f, lead * rest)
        mi = ti.reshape(lead, f, rest).transpose(0, 1).reshape(f, lead * rest)
        t1r, t1i = _cmul_mm(fr, fi, mr, mi)
        t1r = t1r.reshape(f, lead, rest)
        t1i = t1i.reshape(f, lead, rest)
        if twr is not None:
            wr_ = twr[:, None, :]
            wi_ = twi[:, None, :]
            t1r, t1i = t1r * wr_ - t1i * wi_, t1r * wi_ + t1i * wr_
        tr = t1r.transpose(0, 1).reshape(lead * f, rest)
        ti = t1i.transpose(0, 1).reshape(lead * f, rest)
        lead *= f
        total = rest
    return tr.reshape(bq, -1), ti.reshape(bq, -1)


def multistep_layout(factors) -> tuple[int, ...]:
    """Word offsets of the first port's dense block-mode kernel's shared
    arrays, then the total: the row and its ping-pong buffer (two L-point
    complex planes each), then each stage's (f, f) DFT planes.

    No kernel lays this out any more: it is the block mode's boundary
    (:func:`multistep_mode`), kept so that the one-block redesign moved
    no plan between the modes.  Block mode lays out
    :func:`fft_block_layout`, which fits one block wherever this does.
    """
    ell = math.prod(factors)
    sizes = (2 * ell, 2 * ell, *(2 * f * f for f in factors))
    return tuple(itertools.accumulate(sizes, initial=0))


def multistep_stage_plan(factors, batch: int) -> list[tuple]:
    """The per-stage mode's launches, in order, for ``batch`` rows: one
    ``(kind, batch, n, ld, tile)`` a stage.  Stage i < k is ``"cols"``,
    the column FFT of ``fft_cols.cuh`` -- n = f_i points down the ld =
    rest columns of each of ``batch * f_1 * ... * f_(i-1)`` matrices,
    tiles of ``tile`` columns (:func:`fft_cols_tile`), the (f, rest)
    twiddle applied as it stores; the last stage is ``"rows"``, the row
    FFT of ``fft_rows.cuh`` over that many rows of f_k points (ld = 1),
    ``tile`` rows a block (:func:`fft_rows_per_block`)."""
    factors = tuple(int(f) for f in factors)
    lead, rest, plan = batch, math.prod(factors), []
    for i, f in enumerate(factors):
        rest //= f
        if i + 1 < len(factors):
            plan.append(("cols", lead, f, rest, fft_cols_tile(f, rest)))
        else:
            plan.append(("rows", lead, f, 1, fft_rows_per_block(f)))
        lead *= f
    return plan


def _stage_specs(factors) -> list[FftSpec]:
    """Each stage's plan record (:func:`fft_cols_spec`, and
    :func:`fft_rows_spec` for the last): raises ValueError where a
    stage's tile is past one block's shared memory."""
    return [fft_cols_spec("multistep_fused", n, ld) if kind == "cols"
            else fft_rows_spec("multistep_fused", n)
            for kind, _, n, ld, _ in multistep_stage_plan(factors, 1)]


def multistep_mode(factors) -> str:
    """How ``multistep_fused`` runs a plan on the card, from the plan
    alone: ``"block"`` (one launch of the one-block kernel, each row in
    one block's shared memory) when the route's boundary,
    :func:`multistep_layout` -- the dense design's working set, no longer
    the kernel's layout --, fits :data:`_build.SMEM_PER_BLOCK_OPTIN`,
    else ``"per_stage"`` (one FFT
    launch per stage through a device ping-pong,
    :func:`multistep_stage_plan`).  Raises ValueError for a plan the
    kernel cannot take: more than :data:`MAX_STAGES` stages, or a stage
    whose FFT tile (:func:`fft_cols_layout`, :func:`fft_rows_layout`)
    exceeds one block's shared memory -- a factor past 9392 points, the
    largest whose one-column tile, its ping-pong buffer and its table
    fit (a factor of 1 runs as a copy, or the twiddle alone)."""
    factors = tuple(int(f) for f in factors)
    if not 1 <= len(factors) <= MAX_STAGES or min(factors) < 1:
        raise ValueError(f"multistep_fused: plan {factors} needs 1 to "
                         f"{MAX_STAGES} positive factors")
    if 4 * multistep_layout(factors)[-1] <= _build.SMEM_PER_BLOCK_OPTIN:
        return "block"
    _stage_specs(factors)
    return "per_stage"


@functools.lru_cache(maxsize=None)
def _multistep_block_lib(bf16: bool = False):
    fn = getattr(_build.load("multistep"),
                 _build.entry("multistep_block_f32", bf16))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp] * 6 + [ctypes.POINTER(i32), i32, i64,
                              ctypes.POINTER(i32), i32, i32,
                              ctypes.POINTER(i64), vp]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _multistep_stages_lib(bf16: bool = False):
    fn = getattr(_build.load("multistep"),
                 _build.entry("multistep_stages_f32", bf16))
    vp = ctypes.c_void_p
    fn.argtypes = [vp] * 6 + [ctypes.POINTER(vp), ctypes.POINTER(vp),
                              ctypes.POINTER(FftSpec), ctypes.c_int,
                              ctypes.c_longlong, vp]
    fn.restype = ctypes.c_int
    return fn


def multistep_fused(xr, xi, planes, factors):
    """Batched mixed-radix four-step FFT.

    ``xr, xi``: (batch, L) planes of x in natural order; ``planes``: the
    flat per-stage DFT and twiddle planes (:func:`_parse_stage_planes`,
    ``ops._multistep_planes``); ``factors``: the radix plan, ``prod ==
    L``.  Returns (batch, L) planes in the scrambled digit order
    (:func:`multistep_body`).

    CPU tensors run :func:`multistep_body`; CUDA tensors launch the
    kernel or raise: one launch in block mode, one per stage in
    per-stage mode (:func:`multistep_mode`), each counted.  Block mode
    runs the one-block kernel of :func:`fourstep_fused` with the k-digit
    store: the row FFT from the L-point table
    (:func:`fft_rows_twiddles`), reading none of the planes.  The
    per-stage mode computes each stage's DFT from the table of its
    factor, bit for bit the entries of its DFT plane: it reads the
    twiddle planes, not the DFT planes.  The tables are f32, or bf16
    (the ``*_bf16`` entries, counted as ``multistep_fused[bf16]``) for
    bf16 planes.
    """
    factors = tuple(int(f) for f in factors)
    batch, ell = xr.shape
    if xi.shape != xr.shape or math.prod(factors) != ell:
        raise ValueError(f"multistep_fused: planes {tuple(xr.shape)} / "
                         f"{tuple(xi.shape)} do not fit plan {factors}")
    if len(planes) != 4 * len(factors) - 2:
        raise ValueError(f"multistep_fused: {len(planes)} planes for "
                         f"{len(factors)} stages")
    stages = _parse_stage_planes(factors, planes)
    rest = ell
    for f, (fr, fi, twr, twi) in zip(factors, stages):
        rest //= f
        if fr.shape != (f, f) or fi.shape != (f, f) or (
                twr is not None and (twr.shape != (f, rest)
                                     or twi.shape != (f, rest))):
            raise ValueError(f"multistep_fused: stage planes do not fit "
                             f"plan {factors}")
    if xr.device.type == "cpu":
        return multistep_body(xr, xi, _parse_stage_planes(
            factors, _widened(*planes)))
    dev = _build.check_planes(
        "multistep_fused", xr=xr, xi=xi,
        tables={f"plane{i}": p for i, p in enumerate(planes)})
    bf16 = _build.is_bf16(planes[0])
    dtype = planes[0].dtype
    name = _build.launch_name("multistep_fused", bf16)
    mode = multistep_mode(factors)
    outr = torch.empty_like(xr)
    outi = torch.empty_like(xr)
    p = _build.ptr
    vps = lambda ts: (ctypes.c_void_p * len(ts))(*(p(t) for t in ts))
    if mode == "block":
        block = _block_plan("multistep_fused", ell)
        _build.check(_multistep_block_lib(bf16)(
            p(xr), p(xi), p(outr), p(outi),
            *(p(t) for t in fft_twiddles_on(ell, dev, dtype)),
            (ctypes.c_int * len(factors))(*factors), len(factors), batch,
            *block, _build.stream_of(dev)), "multistep_fused")
        _build.count_launch(name)
        return outr, outi
    specs = _stage_specs(factors)
    scr = torch.empty_like(xr)
    sci = torch.empty_like(xr)
    tables = [t for f in factors for t in fft_twiddles_on(f, dev, dtype)]
    twiddles = [t for _, _, twr, twi in stages[:-1] for t in (twr, twi)]
    _build.check(_multistep_stages_lib(bf16)(
        p(xr), p(xi), p(outr), p(outi), p(scr), p(sci), vps(tables),
        vps(twiddles) if twiddles else None,
        (FftSpec * len(specs))(*specs), len(factors), batch,
        _build.stream_of(dev)), "multistep_fused")
    _build.count_launch(name, len(factors))
    return outr, outi
