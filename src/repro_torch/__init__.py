"""PyTorch/CUDA port of the coded-FFT system, for NVIDIA Hopper (sm_90a).

A second package beside the JAX one (``repro``), with the same layout:
``core`` (plans and the MDS code), ``kernels`` (hand-written CUDA kernels
and their plain PyTorch twins), ``serving`` (the batched FFT service and
the LM generation engine, the open-loop streaming front-end),
``distributed`` (the straggler model and the fault runtime: fault
plans, worker health, the elastic pool, the measured worker runtime),
``configs`` and ``models`` (RWKV-6, whose prefill runs the ``wkv``
kernel) and ``launch`` (``python -m repro_torch.launch.serve``).  It
imports ``torch`` and
``numpy`` only.  Entry points run on CUDA unless the caller passes
``device="cpu"``.

``FFTService`` serves c2c requests on four kernels: the whole masked
bucket, the fused encode + four-step, the batched decode apply and the
batched recombine.  Its real kinds (r2c, c2r) run two more whole-bucket
kernels, or the same encode and decode kernels on their stage route.  On
the host decode-matrix path (``device_decode=False``, or ``m > 32``) each
kind's bucket runs a planes whole-bucket kernel, or the stage kernels.
``CodedFFT`` and the real and inverse plans (``CodedRFFT``,
``CodedIFFT``, ``CodedIRFFT``) run their default kernel backend on
three more: the ``cmatmul`` encode and decode apply, and the four-step
worker, fused or two-pass.  The n-D plans (``CodedFFTND``,
``CodedRFFTN``, ``CodedIRFFTN``, ``CodedFFTMultiInput``), and the
service's rfftn and irfftn kinds through them, run the same kernels, the
four-step swept over each shard axis.  The service's fault-tolerant path
feeds deadline-derived masks to the same bucket kernels, and its
Byzantine verify path and measured workers compute rows with ``cmatmul``
and the four-step kernels.  The strategy zoo (``core.strategies``: the
partial-work and communication-efficient plans, the uncoded repetition
baseline, the registry) serves through ``FFTServiceConfig(strategy=...)``
on ``torch.fft`` and the batched solve, as the reference does; on the
kernel backend its plans run the four-step kernels and ``cmatmul``.
"""

from repro_torch.core import (
    CodedFFT,
    CodedFFTMultiInput,
    CodedFFTND,
    CodedIFFT,
    CodedIRFFT,
    CodedIRFFTN,
    CodedRFFT,
    CodedRFFTN,
)
from repro_torch.distributed import StragglerModel
from repro_torch.serving import FFTService, FFTServiceConfig, ServiceStats

__all__ = ["CodedFFT", "CodedFFTMultiInput", "CodedFFTND", "CodedIFFT",
           "CodedIRFFT", "CodedIRFFTN", "CodedRFFT", "CodedRFFTN",
           "FFTService", "FFTServiceConfig", "ServiceStats",
           "StragglerModel"]
