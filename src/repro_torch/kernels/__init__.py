"""Hand-written Hopper kernels of the port, with their plain twins.

Kernels ported so far (CUDA C++ for ``sm_90a``, sources in ``csrc/``):

* ``coded_fft_bucket_masked`` -- the whole masked c2c bucket in one
  launch (``coded_pipeline.py``);
* ``coded_rfft_bucket_masked``, ``coded_irfft_bucket_masked`` -- the
  whole masked r2c and c2r buckets, one launch each
  (``coded_pipeline.py``);
* ``coded_fft_bucket``, ``coded_rfft_bucket``, ``coded_irfft_bucket`` --
  the same three buckets on host-built decode planes (the service's host
  decode-matrix path), one launch each (``coded_pipeline.py``);
* ``coded_fft_bucket_streaming``, ``coded_fft_bucket_streaming_masked``
  -- the c2c bucket past the whole-bucket kernel's shared memory, on
  host-built decode planes (three launches) or raw masks (four: a decode
  launch first) (``coded_pipeline.py``);
* ``encode_fourstep_fused``   -- fused MDS encode + four-step worker DFT:
  a column FFT, then a row FFT with the generator applied as it stores
  (``fourstep_fft.py``);
* ``bcmatmul``                -- per-request decode apply (``cmatmul.py``);
* ``recombine_twiddle_dft_batched``, ``recombine_twiddle_dft`` --
  twiddle + length-m DFT of a bucket or of one request
  (``recombine.py``; ``ops.recombine_fused`` runs the second);
* ``fourstep_fused``, ``fourstep_stage1`` / ``fourstep_stage2``,
  ``fourstep_streaming`` -- the plan's four-step worker, fused, two-pass
  or streaming with natural-order output (``fourstep_fft.py``);
* ``cmatmul``                 -- the plan's ``mds_apply`` (``cmatmul.py``);
* ``multistep_fused``         -- the mixed-radix four-step of a tuned or
  explicit radix plan, one launch or one per stage
  (``fourstep_fft.py``);
* ``wkv``                     -- the RWKV-6 WKV recurrence of the model's
  prefill, chunked and factorised (``wkv.py``).

The buckets and the four-step kernels (not the encode, ``bcmatmul``,
the recombine or ``cmatmul``) also have a ``*_bf16`` entry on bfloat16
tables and planes, which ``precision="bf16"`` reaches; its launches
count as ``<name>[bf16]``.

``ops`` is the dispatch layer; ``autotune`` the four-step's measured
table; ``ref`` holds the planar helpers and the test oracles; ``_build``
compiles the libraries and counts launches.  ``ops`` also exports the
JAX package's direct (off-accelerator) bucket executors in plain
PyTorch -- ``coded_bucket_direct``, ``coded_rbucket_direct``,
``coded_irbucket_direct`` with ``lagrange_compact_planes`` -- which run
no kernel and which the service does not route to.
"""

from repro_torch.kernels import autotune
from repro_torch.kernels._build import launch_counts, reset_launch_counts
from repro_torch.kernels.fourstep_fft import multistep_fused
from repro_torch.kernels.wkv import wkv
from repro_torch.kernels.ops import (
    coded_bucket,
    coded_bucket_direct,
    coded_bucket_fusable,
    coded_bucket_masked,
    coded_bucket_streamable,
    coded_irbucket,
    coded_irbucket_direct,
    coded_irbucket_fusable,
    coded_irbucket_masked,
    coded_rbucket,
    coded_rbucket_direct,
    coded_rbucket_fusable,
    coded_rbucket_masked,
    decode_apply,
    encode_worker,
    fft_fourstep,
    fourstep_fusable,
    fourstep_planar,
    kernel_backend_supported,
    lagrange_compact_planes,
    make_kernel_fftn_fn,
    make_kernel_worker_fn,
    mds_apply,
    recombine_fused,
    recombine_planar,
    split_factor,
)

__all__ = [
    "autotune",
    "coded_bucket",
    "coded_bucket_direct",
    "coded_bucket_fusable",
    "coded_bucket_masked",
    "coded_bucket_streamable",
    "coded_irbucket",
    "coded_irbucket_direct",
    "coded_irbucket_fusable",
    "coded_irbucket_masked",
    "coded_rbucket",
    "coded_rbucket_direct",
    "coded_rbucket_fusable",
    "coded_rbucket_masked",
    "decode_apply",
    "encode_worker",
    "fft_fourstep",
    "fourstep_fusable",
    "fourstep_planar",
    "kernel_backend_supported",
    "lagrange_compact_planes",
    "launch_counts",
    "make_kernel_fftn_fn",
    "make_kernel_worker_fn",
    "mds_apply",
    "multistep_fused",
    "recombine_fused",
    "recombine_planar",
    "reset_launch_counts",
    "split_factor",
    "wkv",
]
