"""Dispatch layer: the entry points the plans and the service call.

Most take and return planar f32 planes, pick factorizations, build the
constant DFT/twiddle planes and route to the kernel wrappers; the plan
entry points (``fft_fourstep``, ``mds_apply``, ``make_kernel_worker_fn``)
take and return complex tensors.

The real kinds (r2c, c2r) have their own whole-bucket kernels and
gates, and stage helpers whose glue is plain PyTorch around the same
``encode_worker`` and ``decode_apply`` kernels.  Each kind's whole
bucket comes in two variants: *masked* (raw responder masks, the decode
built in the kernel) and *planes* (host-built (q, m, N) scatter decode
planes, the service's host decode-matrix path), each with its gate.  A
c2c bucket of either variant past its gate streams
(``coded_bucket_streamable``), as the reference routes it; the real
kinds have no streaming bucket, in the reference either.  A bucket past
those takes the stage kernels, whose code bounds
:func:`check_stage_code` states.  :func:`bucket_route` is that rule.

Mode rule: the tensor's device.  A wrapper given CPU tensors runs its
kernel's plain PyTorch twin (the tests' path); given CUDA tensors it
launches the hand-written kernel or raises -- no fallback, no copy to the
host.  The route decisions (``coded_bucket_fusable``,
``fourstep_fusable``, ``fourstep_fft.multistep_mode``) depend on shapes
only, so the CPU tests take the same routes as the card.  The one
measured input is the four-step's autotune table (``kernels/autotune.py``,
one per device): ``fourstep_planar(variant=None)`` reads its variant and
radix plan there, and routes by shape on a miss.

Precision: ``fourstep_planar`` and the six bucket ops take
``precision="f32"`` or ``"bf16"`` (:func:`_plane_dtype`), as in the
reference: bf16 builds the constant planes (DFT, twiddle, recombine,
split, message) in bfloat16, the f32 values rounded to nearest even --
bit for bit the reference's bf16 planes -- while the payload, G and the
decode stay f32 and every product accumulates in f32.  The wrappers
dispatch on the planes' dtype (``fourstep_fft``, ``coded_pipeline``).
The stage route, the direct executors, ``fft_fourstep`` and the n-D
sweep take no precision, as in the reference; :data:`BF16_RTOL` is the
error budget the service's probe holds bf16 to.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.kernels import autotune, coded_pipeline, ref
from repro_torch.kernels.cmatmul import bcmatmul, check_left_fits, cmatmul
from repro_torch.kernels.coded_pipeline import (
    SMEM_PER_BLOCK_OPTIN,
    bucket_body_fftworker,
    bucket_smem_bytes,
    coded_fft_bucket,
    coded_fft_bucket_masked,
    coded_fft_bucket_streaming,
    coded_fft_bucket_streaming_masked,
    coded_irfft_bucket,
    coded_irfft_bucket_masked,
    coded_rfft_bucket,
    coded_rfft_bucket_masked,
    half_postdecode_body,
    ir_message_body,
    ir_unpack_body,
    irbucket_body_fftworker,
    lagrange_planes_body,
    mask_subsets,
    pack_real_planes,
    rbucket_body_fftworker,
    streaming_smem_bytes,
)
from repro_torch.kernels.fourstep_fft import (
    encode_fourstep_fused,
    fourstep_fused,
    fourstep_layout,
    fourstep_stage1,
    fourstep_stage2,
    fourstep_streaming,
    multistep_fused,
    multistep_mode,
)
from repro_torch.kernels.recombine import MAX_M as RECOMBINE_MAX_M
from repro_torch.kernels.recombine import (
    recombine_twiddle_dft,
    recombine_twiddle_dft_batched,
)

__all__ = [
    "BF16_RTOL",
    "SMEM_PER_BLOCK_OPTIN",
    "MAX_PLANE_ELEMS",
    "kernel_backend_supported",
    "split_factor",
    "fourstep_layout",
    "fourstep_fusable",
    "fourstep_route",
    "fourstep_planar",
    "fft_fourstep",
    "mds_apply",
    "make_kernel_worker_fn",
    "make_kernel_fftn_fn",
    "encode_worker",
    "decode_apply",
    "recombine_planar",
    "recombine_fused",
    "check_stage_code",
    "mask_subsets",
    "lagrange_compact_planes",
    "lagrange_scatter_planes",
    "coded_bucket_fusable",
    "coded_bucket_streamable",
    "bucket_route",
    "coded_bucket",
    "coded_bucket_masked",
    "coded_bucket_direct",
    "pack_real_planes",
    "coded_rbucket_fusable",
    "coded_rbucket",
    "coded_rbucket_masked",
    "coded_rbucket_direct",
    "rfft_postdecode_planar",
    "coded_irbucket_fusable",
    "coded_irbucket",
    "coded_irbucket_masked",
    "coded_irbucket_direct",
    "irfft_message_planar",
    "irfft_unpack_planar",
]

# Largest dense DFT plane (elements) the two-factor four-step kernels
# take.  A near-prime shard length factors as (1, L) and would need an
# (L, L) plane: fourstep_planar gives it the platform FFT (or a tuned
# multistep plan), encode_worker its two-pass branch.
MAX_PLANE_ELEMS = 1 << 24
# The reference's VMEM budget of one plane (ops._FUSED_MAX_ELEMS), which
# its streaming gate applies to the DFT planes and the recombine twiddle
_STREAM_MAX_ELEMS = 512 * 512
# bf16-plane mode: the relative error budget (max abs error over the
# largest magnitude, against the f32 run of the same op) the service's
# per-shape probe holds a bf16 bucket to, as the reference does
BF16_RTOL = 2e-2


def _plane_dtype(precision: str) -> torch.dtype:
    """The constant planes' dtype for a ``precision`` knob."""
    if precision == "bf16":
        return torch.bfloat16
    if precision in (None, "f32", "float32"):
        return torch.float32
    raise ValueError(f"unknown plane precision {precision!r}")


def kernel_backend_supported(dtype) -> bool:
    """The planar kernels compute in f32 planes: complex64 plans only."""
    return dtype == torch.complex64


def split_factor(n: int) -> tuple[int, int]:
    """Factor ``n = a * b`` with a, b as close as possible (a <= b).

    For powers of two this returns (2^floor(k/2), 2^ceil(k/2)); primes
    give (1, n).
    """
    a = int(math.isqrt(n))
    while a > 1 and n % a != 0:
        a -= 1
    return a, n // a


# -- constant planes: memoized numpy tables, converted once per device ----
@functools.lru_cache(maxsize=None)
def _dft_planes(n: int, dtype=np.float32, sign: float = -1.0):
    jk = np.outer(np.arange(n), np.arange(n))
    ang = sign * 2.0 * np.pi * (jk % n) / n
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


@functools.lru_cache(maxsize=None)
def _twiddle_planes(a: int, b: int, dtype=np.float32):
    # W[c, b] = omega_{a*b}^{c*b}
    cb = np.outer(np.arange(a), np.arange(b))
    ang = -2.0 * np.pi * (cb % (a * b)) / (a * b)
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


@functools.lru_cache(maxsize=None)
def _recombine_planes(s: int, m: int, dtype=np.float32, sign: float = -1.0):
    # recombine twiddle W[k, i] = omega_s^{ik} plus the length-m DFT planes
    ki = np.outer(np.arange(m), np.arange(s // m))
    ang = sign * 2.0 * np.pi * (ki % s) / s
    return (np.cos(ang).astype(dtype), np.sin(ang).astype(dtype),
            *_dft_planes(m, dtype, sign))


@functools.lru_cache(maxsize=None)
def _half_dft_planes(m: int, dtype=np.float32):
    # the m//2 + 1 non-redundant butterfly rows of the length-m DFT
    jk = np.outer(np.arange(m // 2 + 1), np.arange(m))
    ang = -2.0 * np.pi * (jk % m) / m
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


@functools.lru_cache(maxsize=None)
def _split_planes(ell: int, dtype=np.float32, sign: float = -1.0):
    # r2c split twiddle exp(sign*2j*pi*p/L), p <= L/2, as (1, L/2+1);
    # sign=+1 is the c2r pack twiddle
    ang = sign * 2.0 * np.pi * np.arange(ell // 2 + 1) / ell
    return (np.cos(ang)[None, :].astype(dtype),
            np.sin(ang)[None, :].astype(dtype))


@functools.lru_cache(maxsize=None)
def _r2c_postdecode_planes(s: int, m: int, dtype=np.float32):
    # split twiddle, natural-order recombine twiddle, half DFT rows
    return (*_split_planes(s // m, dtype), *_recombine_planes(s, m, dtype)[:2],
            *_half_dft_planes(m, dtype))


@functools.lru_cache(maxsize=None)
def _c2r_message_planes(s: int, m: int, dtype=np.float32):
    # +sign m-DFT, conjugate recombine twiddle, pack twiddle
    ctwr, ctwi, fpr, fpi = _recombine_planes(s, m, dtype, sign=1.0)
    pwr, pwi = _split_planes(s // m, dtype, sign=1.0)
    return fpr, fpi, ctwr, ctwi, pwr, pwi


@functools.lru_cache(maxsize=None)
def _recombine_planes_scrambled(s: int, m: int, a: int, b: int,
                                dtype=np.float32):
    """Recombine planes with the twiddle permuted to the four-step payload
    order ``l' = c*B + d`` for natural ``l = c + d*A``."""
    twr, twi, fr, fi = _recombine_planes(s, m, dtype)
    perm = lambda t: np.ascontiguousarray(
        t.reshape(m, b, a).transpose(0, 2, 1).reshape(m, a * b))
    return perm(twr), perm(twi), fr, fi


@functools.lru_cache(maxsize=None)
def _multistep_planes(factors: tuple, dtype=np.float32):
    """Flat plane list of the mixed-radix multistep kernel: per stage the
    (f, f) DFT planes, then (every stage but the last) the (f, rest)
    inter-stage twiddle, ``rest`` the product of the later factors -- the
    order ``fourstep_fft._parse_stage_planes`` regroups."""
    rest = math.prod(factors)
    planes: list = []
    for idx, f in enumerate(factors):
        rest //= f
        planes.extend(_dft_planes(f, dtype))
        if idx < len(factors) - 1:
            planes.extend(_twiddle_planes(f, rest, dtype))
    return tuple(planes)


@functools.lru_cache(maxsize=None)
def _on_device(table, args: tuple, device: torch.device,
               dtype: torch.dtype = torch.float32):
    """A memoized numpy table's f32 planes on ``device`` in ``dtype``: a
    bf16 plane is the f32 one rounded to nearest even, as the reference's
    ``astype(bfloat16)`` rounds it."""
    return tuple(torch.as_tensor(p).to(dtype).to(device)
                 for p in table(*args))


def _fourstep_planes(a: int, b: int, device,
                     dtype: torch.dtype = torch.float32):
    if max(a, b) ** 2 > MAX_PLANE_ELEMS:
        raise NotImplementedError(
            f"four-step split ({a}, {b}) needs a dense {max(a, b)}-point DFT "
            f"plane, past MAX_PLANE_ELEMS: no two-factor kernel takes it "
            f"(fourstep_planar and encode_worker route such lengths "
            f"elsewhere)")
    return (*_on_device(_dft_planes, (a,), device, dtype),
            *_on_device(_twiddle_planes, (a, b), device, dtype),
            *_on_device(_dft_planes, (b,), device, dtype))


# -- the plan's kernels: four-step worker and mds_apply ----------------
def fourstep_fusable(a: int, b: int) -> bool:
    """Does an (A, B) four-step row take the fused route?

    The route's boundary: the first port's dense working set
    (:func:`fourstep_layout`, 16 bytes a point) against
    :data:`SMEM_PER_BLOCK_OPTIN`, so rows up to L = 14,528 fuse.  It is no
    longer the kernel's layout: the one-block kernel lays out
    ``fourstep_fft.fft_block_layout``, which fits wherever this admits,
    and the boundary stays put until the two routes are timed against
    each other at the lengths near it.
    """
    return 4 * fourstep_layout(a, b)[-1] <= SMEM_PER_BLOCK_OPTIN


_VARIANTS = ("fused", "two_pass", "streaming", "xla")


def fourstep_route(ell: int, *, variant: str | None = None,
                   fused: bool | None = None, factors=None,
                   device="cpu") -> tuple[str, tuple[int, ...] | None]:
    """The plan :func:`fourstep_planar` runs for length-``ell`` rows on
    ``device``: ``(variant, factors)``, with ``factors`` the two-factor
    split, a multistep plan (``variant="fused"`` with more than two
    factors) or None for ``"xla"``.  Shapes and the autotune table only:
    no launch.

    ``variant=None`` (and ``fused=None``) reads ``variant`` and
    ``factors`` from the device's autotune table
    (``autotune.lookup("fourstep", L=ell, mode=...)``); on a miss it
    routes by the port's own limits: fused when the balanced split's row
    fits one block (:func:`fourstep_fusable`), else two-pass.  A
    two-factor split whose dense DFT plane exceeds
    :data:`MAX_PLANE_ELEMS` (a near-prime L, which factors as (1, L))
    takes the platform FFT whatever the variant; a multistep plan is not
    held to that limit.  Other factor counts than two outside a fused
    multistep plan are ignored for the balanced split, as in the
    reference.  Raises ValueError where the port refuses the request
    before any launch: an unknown variant, factors whose product is not
    ``ell``, a fused split past the fused kernel's block, or a multistep
    plan past ``multistep_fused``'s bounds.
    """
    if variant is None and fused is not None:
        variant = "fused" if fused else "two_pass"
    if variant is None:
        ent = autotune.lookup("fourstep", backend=autotune.backend_of(device),
                              L=ell, mode=autotune.mode_of(device))
        if ent:
            variant = ent.get("variant")
            if factors is None and ent.get("factors"):
                factors = ent["factors"]
    if variant is not None and variant not in _VARIANTS:
        raise ValueError(f"unknown four-step variant {variant!r}")
    if factors is not None:
        factors = tuple(int(f) for f in factors)
        if math.prod(factors) != ell:
            raise ValueError(f"factors {factors} do not multiply to L={ell}")
    a, b = split_factor(ell)
    if variant is None:
        variant = ("xla" if max(a, b) ** 2 > MAX_PLANE_ELEMS
                   else "fused" if fourstep_fusable(a, b) else "two_pass")
    if variant == "fused" and factors is not None and len(factors) > 2:
        multistep_mode(factors)          # its ValueError: past the kernel
        return variant, factors
    if factors is not None and len(factors) == 2:
        a, b = factors
    if variant == "xla" or max(a, b) ** 2 > MAX_PLANE_ELEMS:
        return "xla", None
    if variant == "fused" and not fourstep_fusable(a, b):
        raise ValueError(
            f"fourstep_planar: ({a}, {b}) does not fit the fused kernel's "
            f"block; use variant='two_pass'")
    return variant, (a, b)


def fourstep_planar(xr: torch.Tensor, xi: torch.Tensor, *,
                    variant: str | None = None, fused: bool | None = None,
                    factors=None, precision: str = "f32"):
    """Batched planar FFT along the last axis via the four-step kernels.

    ``xr, xi``: (batch, L) f32 planes.  Returns natural-order (batch, L)
    planes of ``fft(x)``.  ``variant``: ``"fused"`` (one launch of
    ``fourstep_fused``, or of ``multistep_fused`` when ``factors`` has
    more than two entries), ``"two_pass"`` (``fourstep_stage1`` then
    ``fourstep_stage2``), ``"streaming"`` (``fourstep_streaming``, whose
    output is already in natural order) or ``"xla"`` (the platform FFT,
    as in the JAX package, no kernel); the legacy ``fused`` bool maps onto
    the first two.  ``factors``: an explicit ``(A, B)`` split or radix
    plan.  :func:`fourstep_route` resolves the plan (``variant=None``
    reads the autotune table, and routes by shape on a miss).
    ``precision="bf16"`` runs every kernel variant on bf16 DFT and twiddle
    planes (f32 accumulation, the f32 payload); ``"xla"`` ignores it, as
    in the reference.

    The JAX package gates on a TPU's VMEM instead (fused up to A*B =
    512^2, the platform FFT past B^2 = 512^2), so at some lengths the port
    runs a kernel where the reference on a TPU would not, and the
    reverse: both compute the same transform.  The one unscramble is a
    transpose of the last two axes, or for a multistep plan of k factors
    one reversed-axes permute.
    """
    batch, ell = xr.shape
    variant, factors = fourstep_route(ell, variant=variant, fused=fused,
                                      factors=factors, device=xr.device)
    if variant == "xla":
        z = torch.fft.fft(torch.complex(xr, xi), dim=-1)
        return z.real.contiguous(), z.imag.contiguous()
    dt = _plane_dtype(precision)
    if len(factors) > 2:
        planes = _on_device(_multistep_planes, (factors,), xr.device, dt)
        outr, outi = multistep_fused(xr.contiguous(), xi.contiguous(),
                                     planes, factors)
        # digit-reversed X[c1 + f1*c2 + ...] at (c1, ..., ck): reverse
        k = len(factors)
        perm = (0, *range(k, 0, -1))
        return (outr.reshape(batch, *factors).permute(perm).reshape(batch,
                                                                    ell),
                outi.reshape(batch, *factors).permute(perm).reshape(batch,
                                                                    ell))
    a, b = factors
    far, fai, wr, wi, fbr, fbi = _fourstep_planes(a, b, xr.device, dt)
    x3r = xr.contiguous().reshape(batch, a, b)
    x3i = xi.contiguous().reshape(batch, a, b)
    if variant == "streaming":
        # natural-order (batch, B, A) output: flat X, no unscramble
        outr, outi = fourstep_streaming(x3r, x3i, far, fai, wr, wi, fbr, fbi)
        return outr.reshape(batch, ell), outi.reshape(batch, ell)
    if variant == "fused":
        outr, outi = fourstep_fused(x3r, x3i, far, fai, wr, wi, fbr, fbi)
    else:
        t1r, t1i = fourstep_stage1(x3r, x3i, far, fai, wr, wi)
        outr, outi = fourstep_stage2(t1r.contiguous(), t1i.contiguous(),
                                     precision=precision)
    # out[c, d] holds X[c + d*A] -> transpose to (d, c) and flatten
    return (outr.transpose(-1, -2).reshape(batch, ell),
            outi.transpose(-1, -2).reshape(batch, ell))


def fft_fourstep(x: torch.Tensor, *, fused: bool | None = None
                 ) -> torch.Tensor:
    """Batched FFT along the last axis via the four-step kernels.

    ``x``: (..., L) complex; a 1-D input is promoted to a batch of one.
    Returns complex64 matching ``torch.fft.fft(x, dim=-1)`` up to f32
    planar precision.
    """
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    lead, ell = tuple(x.shape[:-1]), x.shape[-1]
    xr, xi = ref.planar(x.reshape(-1, ell))
    outr, outi = fourstep_planar(xr, xi, fused=fused)
    out = ref.unplanar(outr, outi).reshape(lead + (ell,))
    return out[0] if squeeze else out


def mds_apply(g: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Kernel-backed ``G @ c`` for the MDS encode and decode apply.

    ``g``: (n, m) complex code matrix; ``c``: (m, *payload).  Returns
    complex64 (n, *payload): one ``cmatmul`` launch.
    """
    gr, gi = ref.planar(g)
    payload = tuple(c.shape[1:])
    cr, ci = ref.planar(c.reshape(c.shape[0], -1))
    outr, outi = cmatmul(gr, gi, cr, ci)
    return ref.unplanar(outr, outi).reshape((g.shape[0],) + payload)


def make_kernel_worker_fn(inverse: bool = False):
    """A ``CodedFFT.worker_fn`` on the four-step kernels.

    Transforms the LAST axis and maps over any leading axes, which are
    collapsed into the kernels' batch: a batch of requests costs one
    launch per pass, not one per request.  ``inverse=True`` gives the
    inverse transform through ``ifft(a) = conj(fft(conj(a))) / L`` --
    sign flips on the imaginary plane, same kernels.
    """

    def worker_fn(a: torch.Tensor) -> torch.Tensor:
        lead, ell = tuple(a.shape[:-1]), a.shape[-1]
        flat = a.reshape(-1, ell)
        if inverse:
            out = torch.conj_physical(
                fft_fourstep(torch.conj_physical(flat))) / ell
        else:
            out = fft_fourstep(flat)
        return out.reshape(lead + (ell,))

    return worker_fn


def make_kernel_fftn_fn(nd: int):
    """An n-D worker on the four-step kernels: the 1-D FFT swept over the
    last ``nd`` axes (the multidimensional DFT is separable).

    Each axis is moved last and made contiguous, then every row of every
    leading axis (requests, workers and the other shard axes) goes
    through ONE :func:`fft_fourstep` call: a launch per pass and axis,
    whatever the batch.  Each axis length routes on its own
    (:func:`fourstep_route`, the autotune table first).
    """

    def worker_fn(a: torch.Tensor) -> torch.Tensor:
        for ax in range(a.ndim - nd, a.ndim):
            moved = a.movedim(ax, -1).contiguous()
            a = fft_fourstep(moved).movedim(-1, ax)
        return a

    return worker_fn


# -- stage route ---------------------------------------------------------
def encode_worker(cr: torch.Tensor, ci: torch.Tensor,
                  gr: torch.Tensor, gi: torch.Tensor):
    """Message planes -> coded worker spectra: ``B = fft(G @ c)``.

    ``cr, ci``: (q, m, L) planes of the message shards; ``gr, gi``: (n, m)
    generator planes.  Returns natural-order (q, n, L) planes.  One call
    of the fused encode + four-step kernel (two launches, or three past
    its fold: ``fourstep_fft.encode_rows_fold``), then the unscramble --
    unless the balanced split's dense DFT
    plane is past :data:`MAX_PLANE_ELEMS` (a near-prime L), where the
    reference's two-pass branch runs: the encode as one ``cmatmul``
    launch with the batch folded into the payload columns, then
    :func:`fourstep_planar` on the (q*N, L) coded rows (the autotune
    table's plan, else the platform FFT).
    """
    q, m, ell = cr.shape
    n = gr.shape[0]
    a, b = split_factor(ell)
    if max(a, b) ** 2 > MAX_PLANE_ELEMS:
        er, ei = cmatmul(
            gr, gi, cr.transpose(0, 1).reshape(m, q * ell).contiguous(),
            ci.transpose(0, 1).reshape(m, q * ell).contiguous())
        br_, bi_ = fourstep_planar(
            er.reshape(n, q, ell).transpose(0, 1).reshape(q * n, ell),
            ei.reshape(n, q, ell).transpose(0, 1).reshape(q * n, ell))
        return br_.reshape(q, n, ell), bi_.reshape(q, n, ell)
    planes = _fourstep_planes(a, b, cr.device)
    br_, bi_ = encode_fourstep_fused(
        cr.contiguous().reshape(q, m, a, b),
        ci.contiguous().reshape(q, m, a, b), gr, gi, *planes)
    # out[k, c, d] holds B_k[c + d*A] -> transpose to (d, c) and flatten
    return (br_.transpose(-1, -2).reshape(q, n, ell),
            bi_.transpose(-1, -2).reshape(q, n, ell))


def decode_apply(dr: torch.Tensor, di: torch.Tensor,
                 br: torch.Tensor, bi: torch.Tensor):
    """Per-request scatter decode matrices ``(q, m, N)`` applied to the
    worker spectra ``(q, N, L)`` as one batched matmul -> ``(q, m, L)``."""
    return bcmatmul(dr.contiguous(), di.contiguous(), br.contiguous(),
                    bi.contiguous())


def lagrange_compact_planes(subsets: torch.Tensor, n: int):
    """Per-request compact ``(B, m, m)`` inverse planes from subsets: the
    gathered-decode form of the direct bucket executors."""
    ivr, ivi, _, _ = lagrange_planes_body(subsets, n)
    return ivr, ivi


def lagrange_scatter_planes(subsets: torch.Tensor, n: int):
    """Per-request scatter ``(B, m, N)`` decode planes (zero straggler
    columns) from subsets -- the form :func:`decode_apply` contracts."""
    _, _, dr, di = lagrange_planes_body(subsets, n)
    return dr, di


def recombine_fused(c_hat: torch.Tensor, s: int) -> torch.Tensor:
    """Kernel-backed master recombination of one request: decoded
    ``(m, s/m)`` complex sub-transforms -> the ``(s,)`` spectrum, one
    launch of ``recombine_twiddle_dft``."""
    m = c_hat.shape[0]
    cr, ci = ref.planar(c_hat)
    wr, wi, fr, fi = _on_device(_recombine_planes, (s, m), cr.device)
    outr, outi = recombine_twiddle_dft(cr, ci, wr, wi, fr, fi)
    return ref.unplanar(outr, outi).reshape(s)


def check_stage_code(n: int, m: int, what: str, *,
                     recombine: bool = False) -> None:
    """Refuse an (N, m) code the stage kernels cannot carry.

    The stage route (``encode_fourstep_fused``, ``bcmatmul``,
    ``recombine_twiddle_dft_batched``) and the plans' ``mds_apply``
    (``cmatmul``) keep a whole (N, m) G or (m, N) D in one block's shared
    memory -- the ``check_left_fits`` those wrappers make at launch,
    N*m <= 29,056 -- and the recombine unrolls m up to its ``MAX_M``
    (``recombine=True``).  Raises NotImplementedError naming ROADMAP.md
    Queue 2 item 7, so a caller can refuse before any work; the plain
    twins the CPU runs have no such bounds.
    """
    item = ("see ROADMAP.md, Queue 2 item 7 (the stage kernels past m=64 "
            "or N*m > 29,056)")
    if recombine and m > RECOMBINE_MAX_M:
        raise NotImplementedError(
            f"{what}: m={m} (the stage recombine serves m <= "
            f"{RECOMBINE_MAX_M}) is not served by the PyTorch port yet -- "
            f"{item}")
    try:
        check_left_fits(what, n, m)
    except ValueError as err:
        raise NotImplementedError(
            f"the (N={n}, m={m}) code is not served by the PyTorch port yet "
            f"({err}) -- {item}") from None


def recombine_planar(cr: torch.Tensor, ci: torch.Tensor, s: int):
    """Batched master recombination on planes: (q, m, s/m) -> (q, s)."""
    q, m, ell = cr.shape
    wr, wi, fr, fi = _on_device(_recombine_planes, (s, m), cr.device)
    outr, outi = recombine_twiddle_dft_batched(
        cr.contiguous(), ci.contiguous(), wr, wi, fr, fi)
    return outr.reshape(q, s), outi.reshape(q, s)


# -- whole-bucket route --------------------------------------------------
def coded_bucket_fusable(s: int, m: int, n: int, *,
                         masked: bool = True) -> bool:
    """Does the whole c2c bucket fit one block of its kernel?

    The kernel's shared-memory working set (``bucket_smem_bytes``, the
    exact reckoning of ``csrc/coded_bucket.cu``) against
    :data:`SMEM_PER_BLOCK_OPTIN`, and m within the kernel's unrolled
    shard bound.  Masked (the default): ``n`` does not enter, only the m
    subset rows of G are staged.  Planes (``masked=False``): all N rows
    of G and the request's (m, N) decode planes are, so ``n`` counts.
    """
    if s % m != 0 or m > coded_pipeline.MAX_M:
        return False
    a, b = split_factor(s // m)
    return (bucket_smem_bytes(m, a, b, n=n, masked=masked)
            <= SMEM_PER_BLOCK_OPTIN)


def coded_bucket_streamable(s: int, m: int, n: int) -> bool:
    """Can a c2c bucket past :func:`coded_bucket_fusable` run the
    streaming bucket kernel (either mode)?

    The reference's gate (its DFT planes and the (m, L) recombine
    twiddle within its VMEM budget, and a split with A > 1 to tile
    over), then the kernel's own bounds: m within its unrolled shard
    bound and one block's G, D and F_m within the shared memory.
    """
    if s % m != 0 or m > coded_pipeline.MAX_M:
        return False
    ell = s // m
    a, b = split_factor(ell)
    return (a > 1 and a * a <= _STREAM_MAX_ELEMS
            and b * b <= _STREAM_MAX_ELEMS
            and m * ell <= 4 * _STREAM_MAX_ELEMS
            and streaming_smem_bytes(m, n) <= SMEM_PER_BLOCK_OPTIN)


@functools.lru_cache(maxsize=None)
def bucket_route(s: int, m: int, n: int, kind: str, *,
                 masked: bool = True) -> str:
    """How a kernel-path ``(s, kind)`` bucket of an (N, m) code runs:
    ``"fused"`` (one launch of the kind's whole-bucket kernel, under its
    gate for the decode variant), ``"streaming"`` (a c2c bucket past that
    gate which :func:`coded_bucket_streamable` admits), else ``"stage"``
    (the stage kernels, whose code bounds :func:`check_stage_code`
    states).  The real kinds have no streaming bucket."""
    gate = {"c2c": coded_bucket_fusable, "r2c": coded_rbucket_fusable,
            "c2r": coded_irbucket_fusable}[kind]
    if gate(s, m, n, masked=masked):
        return "fused"
    if kind == "c2c" and coded_bucket_streamable(s, m, n):
        return "streaming"
    return "stage"


def _bucket_planes(s: int, m: int, device,
                   dtype: torch.dtype = torch.float32):
    a, b = split_factor(s // m)
    return (*_fourstep_planes(a, b, device, dtype),
            *_on_device(_recombine_planes_scrambled, (s, m, a, b), device,
                        dtype))


def coded_bucket(xr: torch.Tensor, xi: torch.Tensor, dr: torch.Tensor,
                 di: torch.Tensor, gr: torch.Tensor, gi: torch.Tensor,
                 s: int, *, precision: str = "f32"):
    """The host decode-matrix path's whole c2c bucket: (q, s) request
    planes + (q, m, N) scatter decode planes -> (q, s) output planes.
    One launch of the planes bucket kernel on the ``"fused"``
    :func:`bucket_route` (``masked=False``), else the streaming bucket
    kernel, as the reference routes it; the caller checks that the route
    is not ``"stage"``.  ``precision="bf16"``: both routes on bf16 planes
    (the kernels' bf16 entries)."""
    n, m = gr.shape
    planes = _bucket_planes(s, m, xr.device, _plane_dtype(precision))
    if bucket_route(s, m, n, "c2c", masked=False) == "streaming":
        return coded_fft_bucket_streaming(xr, xi, dr, di, gr, gi, *planes)
    return coded_fft_bucket(xr, xi, dr, di, gr, gi, *planes)


def coded_bucket_masked(xr: torch.Tensor, xi: torch.Tensor,
                        masks: torch.Tensor, gr: torch.Tensor,
                        gi: torch.Tensor, s: int, *,
                        precision: str = "f32"):
    """The service's whole-bucket hot path: (q, s) request planes + raw
    (q, N) responder masks -> (q, s) output planes, subset selection and
    Lagrange decode inside the kernel.  One launch of the masked bucket
    kernel on the ``"fused"`` :func:`bucket_route`, else the masked
    streaming bucket kernel, as the reference routes it; the caller
    checks that the route is not ``"stage"``.  ``precision`` as
    :func:`coded_bucket` takes it."""
    n, m = gr.shape
    planes = _bucket_planes(s, m, xr.device, _plane_dtype(precision))
    if bucket_route(s, m, n, "c2c") == "streaming":
        return coded_fft_bucket_streaming_masked(xr, xi, masks, gr, gi,
                                                 *planes)
    return coded_fft_bucket_masked(xr, xi, masks, gr, gi, *planes)


def coded_bucket_direct(xr: torch.Tensor, xi: torch.Tensor,
                        dvr: torch.Tensor, dvi: torch.Tensor,
                        subsets: torch.Tensor, gr: torch.Tensor,
                        gi: torch.Tensor, s: int):
    """The JAX package's off-accelerator c2c bucket executor: the
    pipeline of :func:`coded_bucket` with the worker DFT on ``torch.fft``
    and the decode as gathered compact ``(m, m)`` products (``dvr/dvi``
    inverses of each request's ``subsets`` rows, e.g. from
    ``DecodeMatrixCache.compact`` or :func:`lagrange_compact_planes`).
    Plain PyTorch at any bucket shape; the service does not route here
    (it runs the card's routes on every device)."""
    m = gr.shape[1]
    return bucket_body_fftworker(
        xr, xi, dvr, dvi, subsets, gr, gi,
        *_on_device(_recombine_planes, (s, m), xr.device))


# -- real kinds: r2c and c2r buckets ---------------------------------------
def _real_fusable(layout, s: int, m: int, n: int, masked: bool) -> bool:
    if s < 2 * m or s % (2 * m) != 0 or m > coded_pipeline.MAX_M:
        return False
    a, b = split_factor(s // m // 2)
    return (4 * layout(m, a, b, n=n, masked=masked)[-1]
            <= SMEM_PER_BLOCK_OPTIN)


def coded_rbucket_fusable(s: int, m: int, n: int, *,
                          masked: bool = True) -> bool:
    """Does the r2c bucket take the whole-bucket kernel's route?

    The dense design's shared working set
    (``coded_pipeline.rbucket_layout``, for packed shards of L/2) against
    :data:`SMEM_PER_BLOCK_OPTIN`, m within the unrolled bound, and
    ``2m | s``: the route's boundary, kept where it was when the kernel
    took the FFT layout ``coded_pipeline.bucket_fft_layout``, which fits
    one block wherever this admits.  ``n`` enters only the planes
    variant (``masked=False``), which stages all N rows of G and the
    (m, N) decode planes.
    """
    return _real_fusable(coded_pipeline.rbucket_layout, s, m, n, masked)


def coded_irbucket_fusable(s: int, m: int, n: int, *,
                           masked: bool = True) -> bool:
    """Does the whole c2r bucket fit one block of its kernel?
    (``coded_pipeline.irbucket_layout`` against
    :data:`SMEM_PER_BLOCK_OPTIN`, as :func:`coded_rbucket_fusable`.)"""
    return _real_fusable(coded_pipeline.irbucket_layout, s, m, n, masked)


def _half_fourstep_planes(s: int, m: int, device,
                          dtype: torch.dtype = torch.float32):
    return _fourstep_planes(*split_factor(s // m // 2), device, dtype)


def _rbucket_planes(s: int, m: int, device,
                    dtype: torch.dtype = torch.float32):
    return (*_half_fourstep_planes(s, m, device, dtype),
            *_on_device(_r2c_postdecode_planes, (s, m), device, dtype))


def _irbucket_planes(s: int, m: int, device,
                     dtype: torch.dtype = torch.float32):
    return (*_half_fourstep_planes(s, m, device, dtype),
            *_on_device(_c2r_message_planes, (s, m), device, dtype))


def coded_rbucket_masked(xr: torch.Tensor, masks: torch.Tensor,
                         gr: torch.Tensor, gi: torch.Tensor, s: int, *,
                         precision: str = "f32"):
    """The r2c whole-bucket path: the (q, s) REAL request plane + raw
    (q, N) masks -> (q, s//2+1) half-spectrum planes, one kernel launch.
    Caller checks :func:`coded_rbucket_fusable`.  ``precision="bf16"``:
    bf16 four-step, split, recombine and DFT-row planes."""
    return coded_rfft_bucket_masked(
        xr.contiguous(), masks, gr, gi,
        *_rbucket_planes(s, gr.shape[1], xr.device,
                         _plane_dtype(precision)), s)


def coded_rbucket(xr: torch.Tensor, dr: torch.Tensor, di: torch.Tensor,
                  gr: torch.Tensor, gi: torch.Tensor, s: int, *,
                  precision: str = "f32"):
    """The host decode-matrix path's whole r2c bucket: the (q, s) REAL
    request plane + (q, m, N) scatter decode planes -> (q, s//2+1)
    half-spectrum planes, one kernel launch.  Caller checks
    :func:`coded_rbucket_fusable` with ``masked=False``.  ``precision``
    as :func:`coded_rbucket_masked` takes it."""
    return coded_rfft_bucket(
        xr.contiguous(), dr, di, gr, gi,
        *_rbucket_planes(s, gr.shape[1], xr.device,
                         _plane_dtype(precision)), s)


def coded_irbucket_masked(yr: torch.Tensor, yi: torch.Tensor,
                          masks: torch.Tensor, gr: torch.Tensor,
                          gi: torch.Tensor, s: int, *,
                          precision: str = "f32"):
    """The c2r whole-bucket path: (q, s//2+1) half-spectrum planes + raw
    (q, N) masks -> the (q, s) real plane, one kernel launch.  Caller
    checks :func:`coded_irbucket_fusable`.  ``precision="bf16"``: bf16
    four-step and message planes."""
    return coded_irfft_bucket_masked(
        yr, yi, masks, gr, gi,
        *_irbucket_planes(s, gr.shape[1], yr.device,
                          _plane_dtype(precision)), s)


def coded_irbucket(yr: torch.Tensor, yi: torch.Tensor, dr: torch.Tensor,
                   di: torch.Tensor, gr: torch.Tensor, gi: torch.Tensor,
                   s: int, *, precision: str = "f32"):
    """The host decode-matrix path's whole c2r bucket: (q, s//2+1)
    half-spectrum planes + (q, m, N) scatter decode planes -> the (q, s)
    real plane, one kernel launch.  Caller checks
    :func:`coded_irbucket_fusable` with ``masked=False``.  ``precision``
    as :func:`coded_irbucket_masked` takes it."""
    return coded_irfft_bucket(
        yr, yi, dr, di, gr, gi,
        *_irbucket_planes(s, gr.shape[1], yr.device,
                          _plane_dtype(precision)), s)


def coded_rbucket_direct(xr: torch.Tensor, dvr: torch.Tensor,
                         dvi: torch.Tensor, subsets: torch.Tensor,
                         gr: torch.Tensor, gi: torch.Tensor, s: int):
    """Off-accelerator r2c bucket executor: ``torch.fft`` on the packed
    half-length shards, the gathered compact decode, the symmetry
    postdecode (cf. :func:`coded_bucket_direct`).  Plain PyTorch."""
    return rbucket_body_fftworker(
        xr, dvr, dvi, subsets, gr, gi,
        *_on_device(_r2c_postdecode_planes, (s, gr.shape[1]), xr.device),
        s)


def coded_irbucket_direct(yr: torch.Tensor, yi: torch.Tensor,
                          dvr: torch.Tensor, dvi: torch.Tensor,
                          subsets: torch.Tensor, gr: torch.Tensor,
                          gi: torch.Tensor, s: int):
    """Off-accelerator c2r bucket executor: the message stage on planes,
    ``torch.fft.ifft`` on the packed half-length shards, the gathered
    compact decode, the relabel unpack.  Returns ONE real plane (q, s).
    Plain PyTorch."""
    return irbucket_body_fftworker(
        yr, yi, dvr, dvi, subsets, gr, gi,
        *_on_device(_c2r_message_planes, (s, gr.shape[1]), yr.device), s)


def rfft_postdecode_planar(hr: torch.Tensor, hi: torch.Tensor, s: int):
    """Stage-route r2c postdecode: decoded packed-spectrum planes
    ``(q, m, L/2)``, natural order -> half-spectrum planes
    ``(q, s//2+1)``.  Plain PyTorch, as in the reference in every mode:
    an elementwise butterfly and one (m//2+1, m) contraction."""
    m = hr.shape[1]
    return half_postdecode_body(
        hr, hi, *_on_device(_r2c_postdecode_planes, (s, m), hr.device), s)


def irfft_message_planar(yr: torch.Tensor, yi: torch.Tensor, s: int,
                         m: int):
    """Stage-route c2r message stage: half-spectrum request planes
    ``(q, s//2+1)`` -> packed message planes ``(q, m, L/2)`` (adjoint
    butterfly and Hermitian pack, plain PyTorch)."""
    return ir_message_body(
        yr, yi, *_on_device(_c2r_message_planes, (s, m), yr.device), s, m)


def irfft_unpack_planar(hr: torch.Tensor, hi: torch.Tensor):
    """Stage-route c2r postdecode: decoded packed interleave planes
    ``(q, m, L/2)`` -> the real output plane ``(q, s)``."""
    return ir_unpack_body(hr, hi)
