"""Coded FFT core library (Yu, Maddah-Ali, Avestimehr 2017) in PyTorch.

Ported so far: the 1-D plans -- complex (``CodedFFT``), real-input
(``CodedRFFT``), inverse (``CodedIFFT``) and real-output
(``CodedIRFFT``) --, the n-D plans -- complex (``CodedFFTND``, its
factors from ``plan_factors``), real-input (``CodedRFFTN``), real-output
(``CodedIRFFTN``) and multi-input (``CodedFFTMultiInput``) -- on their
kernel and reference backends, all of them ``CodedPlan`` and ``MDSPlan``
instances; the (N, m) Reed-Solomon code with the closed-form Lagrange
decode and the transform decode's dispatch (``decode_auto``), interleave
and recombine (1-D, n-D and half spectrum); the Byzantine detection and
correction of paper Remark 3 (``robust_decode``, ``RobustCodedFFT``);
the strategy zoo -- partial work (``CodedPartialFFT``), the folded
payload (``CodedCommEffFFT``), the uncoded repetition baseline
(``UncodedRepetitionFFT``), the Remark 4 thresholds and the strategy
registry (``REGISTRY``, ``make_strategy``).
"""

from repro_torch.core.coded_fft import CodedFFT, CodedFFTND, plan_factors
from repro_torch.core.fault_tolerance import RobustCodedFFT, robust_decode
from repro_torch.core.interleave import (
    deinterleave,
    deinterleave_nd,
    interleave,
    interleave_nd,
)
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
from repro_torch.core.multi_input import CodedFFTMultiInput
from repro_torch.core.plan import (
    CodedPlan,
    MDSPlan,
    MDSPlanBase,
    resolve_device,
)
from repro_torch.core.recombine import (
    dft_matrix,
    recombine,
    recombine_half,
    recombine_nd,
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
from repro_torch.core.rfftn import (
    CodedIRFFTN,
    CodedRFFTN,
    adjoint_fold_nd,
    hermitian_extend_nd,
    neg_freq,
    pack_half_nd,
    split_packed_nd,
)
from repro_torch.core.strategies import (
    REGISTRY,
    CodedCommEffFFT,
    CodedPartialFFT,
    StrategyEntry,
    UncodedRepetitionFFT,
    coded_fft_threshold,
    make_strategy,
    register_strategy,
    repetition_threshold,
    short_dot_threshold,
)

__all__ = [
    "CodedCommEffFFT",
    "CodedFFT",
    "CodedFFTMultiInput",
    "CodedFFTND",
    "CodedIFFT",
    "CodedIRFFT",
    "CodedIRFFTN",
    "CodedPartialFFT",
    "CodedPlan",
    "CodedRFFT",
    "CodedRFFTN",
    "IFFT_AUTO_MAX_M",
    "LAGRANGE_MAX_M",
    "MDSPlan",
    "MDSPlanBase",
    "REGISTRY",
    "RobustCodedFFT",
    "StrategyEntry",
    "UncodedRepetitionFFT",
    "adjoint_fold_nd",
    "coded_fft_threshold",
    "decode_auto",
    "decode_from_subset",
    "decode_ifft",
    "decode_masked",
    "deinterleave",
    "deinterleave_nd",
    "dft_matrix",
    "encode",
    "encode_dft",
    "first_available",
    "hermitian_extend",
    "hermitian_extend_nd",
    "interleave",
    "interleave_nd",
    "is_contiguous_subset",
    "lagrange_decode_matrices",
    "lagrange_decode_matrix",
    "lagrange_inverse",
    "make_strategy",
    "neg_freq",
    "pack_half",
    "pack_half_nd",
    "pack_pairs",
    "plan_factors",
    "recombine",
    "recombine_half",
    "recombine_nd",
    "register_strategy",
    "repetition_threshold",
    "require_even_shards",
    "resolve_device",
    "robust_decode",
    "rs_generator",
    "rs_nodes",
    "short_dot_threshold",
    "split_packed",
    "split_packed_nd",
    "subset_decode_matrix",
    "twiddle",
    "unpack_pairs",
]
