"""Coded FFT core library (Yu, Maddah-Ali, Avestimehr 2017) in PyTorch.

Ported so far: the 1-D plans -- complex (``CodedFFT``), real-input
(``CodedRFFT``), inverse (``CodedIFFT``) and real-output
(``CodedIRFFT``) -- on their kernel and reference backends, the (N, m)
Reed-Solomon code with the closed-form Lagrange decode and the
transform decode's dispatch (``decode_auto``), interleave and recombine
(full and half spectrum).
"""

from repro_torch.core.coded_fft import CodedFFT
from repro_torch.core.interleave import deinterleave, interleave
from repro_torch.core.mds import (
    IFFT_AUTO_MAX_M,
    LAGRANGE_MAX_M,
    decode_auto,
    decode_from_subset,
    decode_ifft,
    decode_masked,
    encode,
    encode_dft,
    first_available,
    is_contiguous_subset,
    lagrange_decode_matrices,
    lagrange_decode_matrix,
    lagrange_inverse,
    rs_generator,
    rs_nodes,
    subset_decode_matrix,
)
from repro_torch.core.plan import MDSPlanBase, resolve_device
from repro_torch.core.recombine import (
    dft_matrix,
    recombine,
    recombine_half,
    twiddle,
)
from repro_torch.core.rfft import (
    CodedIFFT,
    CodedIRFFT,
    CodedRFFT,
    hermitian_extend,
    pack_half,
    pack_pairs,
    require_even_shards,
    split_packed,
    unpack_pairs,
)

__all__ = [
    "CodedFFT",
    "CodedIFFT",
    "CodedIRFFT",
    "CodedRFFT",
    "IFFT_AUTO_MAX_M",
    "LAGRANGE_MAX_M",
    "MDSPlanBase",
    "decode_auto",
    "decode_from_subset",
    "decode_ifft",
    "decode_masked",
    "deinterleave",
    "dft_matrix",
    "encode",
    "encode_dft",
    "first_available",
    "hermitian_extend",
    "interleave",
    "is_contiguous_subset",
    "lagrange_decode_matrices",
    "lagrange_decode_matrix",
    "lagrange_inverse",
    "pack_half",
    "pack_pairs",
    "recombine",
    "recombine_half",
    "require_even_shards",
    "resolve_device",
    "rs_generator",
    "rs_nodes",
    "split_packed",
    "subset_decode_matrix",
    "twiddle",
    "unpack_pairs",
]
