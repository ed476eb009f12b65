"""Dispatch layer: the entry points the plans and the service call.

They take and return planar f32 planes, pick factorizations, build the
constant DFT/twiddle planes and route to the kernel wrappers.

Mode rule: the tensor's device.  A wrapper given CPU tensors runs its
kernel's plain PyTorch twin (the tests' path); given CUDA tensors it
launches the hand-written kernel or raises -- no fallback, no copy to the
host.  The route decisions (``coded_bucket_fusable``) depend on shapes
only, so the CPU tests take the same routes as the card.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.kernels import coded_pipeline
from repro_torch.kernels.cmatmul import bcmatmul
from repro_torch.kernels.coded_pipeline import (
    SMEM_PER_BLOCK_OPTIN,
    bucket_smem_bytes,
    coded_fft_bucket_masked,
    lagrange_planes_body,
    mask_subsets,
)
from repro_torch.kernels.fourstep_fft import encode_fourstep_fused
from repro_torch.kernels.recombine import recombine_twiddle_dft_batched

__all__ = [
    "SMEM_PER_BLOCK_OPTIN",
    "MAX_PLANE_ELEMS",
    "kernel_backend_supported",
    "split_factor",
    "encode_worker",
    "decode_apply",
    "recombine_planar",
    "mask_subsets",
    "lagrange_scatter_planes",
    "coded_bucket_fusable",
    "coded_bucket_masked",
]

# Largest dense DFT plane (elements) the four-step kernels take.  A
# near-prime shard length factors as (1, L) and would need an (L, L)
# plane; the mixed-radix kernel that serves those is a later slice.
MAX_PLANE_ELEMS = 1 << 24


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
def _recombine_planes_scrambled(s: int, m: int, a: int, b: int,
                                dtype=np.float32):
    """Recombine planes with the twiddle permuted to the four-step payload
    order ``l' = c*B + d`` for natural ``l = c + d*A``."""
    twr, twi, fr, fi = _recombine_planes(s, m, dtype)
    perm = lambda t: np.ascontiguousarray(
        t.reshape(m, b, a).transpose(0, 2, 1).reshape(m, a * b))
    return perm(twr), perm(twi), fr, fi


@functools.lru_cache(maxsize=None)
def _on_device(table, args: tuple, device: torch.device):
    return tuple(torch.as_tensor(p, device=device) for p in table(*args))


def _fourstep_planes(a: int, b: int, device):
    if max(a, b) ** 2 > MAX_PLANE_ELEMS:
        raise NotImplementedError(
            f"four-step split ({a}, {b}) needs a dense {max(a, b)}-point DFT "
            f"plane; near-prime shard lengths wait for the mixed-radix "
            f"kernel (ROADMAP.md Queue 2, multistep_fused)")
    return (*_on_device(_dft_planes, (a,), device),
            *_on_device(_twiddle_planes, (a, b), device),
            *_on_device(_dft_planes, (b,), device))


# -- stage route ---------------------------------------------------------
def encode_worker(cr: torch.Tensor, ci: torch.Tensor,
                  gr: torch.Tensor, gi: torch.Tensor):
    """Message planes -> coded worker spectra: ``B = fft(G @ c)``.

    ``cr, ci``: (q, m, L) planes of the message shards; ``gr, gi``: (n, m)
    generator planes.  Returns natural-order (q, n, L) planes.  One call
    of the fused encode + four-step kernel (intermediates in device
    memory, any L), then the unscramble.
    """
    q, m, ell = cr.shape
    n = gr.shape[0]
    a, b = split_factor(ell)
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


def lagrange_scatter_planes(subsets: torch.Tensor, n: int):
    """Per-request scatter ``(B, m, N)`` decode planes (zero straggler
    columns) from subsets -- the form :func:`decode_apply` contracts."""
    _, _, dr, di = lagrange_planes_body(subsets, n)
    return dr, di


def recombine_planar(cr: torch.Tensor, ci: torch.Tensor, s: int):
    """Batched master recombination on planes: (q, m, s/m) -> (q, s)."""
    q, m, ell = cr.shape
    wr, wi, fr, fi = _on_device(_recombine_planes, (s, m), cr.device)
    outr, outi = recombine_twiddle_dft_batched(
        cr.contiguous(), ci.contiguous(), wr, wi, fr, fi)
    return outr.reshape(q, s), outi.reshape(q, s)


# -- whole-bucket route --------------------------------------------------
def coded_bucket_fusable(s: int, m: int, n: int) -> bool:
    """Does the whole masked bucket fit one block of the bucket kernel?

    The kernel's shared-memory working set (``bucket_smem_bytes``, the
    exact reckoning of ``csrc/coded_bucket.cu``) against
    :data:`SMEM_PER_BLOCK_OPTIN`, and m within the kernel's unrolled
    shard bound.  ``n`` does not enter: only the m subset rows of G are
    staged.
    """
    if s % m != 0 or m > coded_pipeline.MAX_M:
        return False
    a, b = split_factor(s // m)
    return bucket_smem_bytes(m, a, b) <= SMEM_PER_BLOCK_OPTIN


def coded_bucket_masked(xr: torch.Tensor, xi: torch.Tensor,
                        masks: torch.Tensor, gr: torch.Tensor,
                        gi: torch.Tensor, s: int):
    """The service's whole-bucket hot path: (q, s) request planes + raw
    (q, N) responder masks -> (q, s) output planes, one kernel launch
    (subset selection and Lagrange decode inside).  Caller checks
    :func:`coded_bucket_fusable`."""
    n, m = gr.shape
    a, b = split_factor(s // m)
    dev = xr.device
    planes = (*_fourstep_planes(a, b, dev),
              *_on_device(_recombine_planes_scrambled, (s, m, a, b), dev))
    return coded_fft_bucket_masked(xr, xi, masks, gr, gi, *planes)
