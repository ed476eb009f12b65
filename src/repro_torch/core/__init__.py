"""Coded FFT core library (Yu, Maddah-Ali, Avestimehr 2017) in PyTorch.

Ported so far: the 1-D complex plan (``CodedFFT``) on its kernel and
reference backends, the (N, m) Reed-Solomon code with the closed-form
Lagrange decode, interleave and recombine.
"""

from repro_torch.core.coded_fft import CodedFFT
from repro_torch.core.interleave import deinterleave, interleave
from repro_torch.core.mds import (
    LAGRANGE_MAX_M,
    decode_from_subset,
    decode_masked,
    encode,
    encode_dft,
    first_available,
    lagrange_decode_matrices,
    lagrange_decode_matrix,
    lagrange_inverse,
    rs_generator,
    rs_nodes,
    subset_decode_matrix,
)
from repro_torch.core.plan import MDSPlanBase, resolve_device
from repro_torch.core.recombine import dft_matrix, recombine, twiddle

__all__ = [
    "CodedFFT",
    "LAGRANGE_MAX_M",
    "MDSPlanBase",
    "decode_from_subset",
    "decode_masked",
    "deinterleave",
    "dft_matrix",
    "encode",
    "encode_dft",
    "first_available",
    "interleave",
    "lagrange_decode_matrices",
    "lagrange_decode_matrix",
    "lagrange_inverse",
    "recombine",
    "resolve_device",
    "rs_generator",
    "rs_nodes",
    "subset_decode_matrix",
    "twiddle",
]
