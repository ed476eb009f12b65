#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, in parallel), holds each kernel against its
plain PyTorch version on the card at the shapes the service uses, then
drives the service's c2c main path twice -- the default config (whole-
bucket kernel) and a 2^20-point transform (stage kernels) -- checking the
spectra against ``torch.fft.fft`` in complex128 and that each path
launched its kernels.  Prints one JSON object per phase, the kernels
table, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
when there is no CUDA device or any check fails.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (dense, no sparsity): HBM3 bytes/s and FP32
# (non-tensor) flop/s -- the rates the bounds below divide by
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
F32 = 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def fft_flops(n: int) -> float:
    """FP32 flops of one n-point complex FFT, by the usual 5 n log2(n)
    count: the least work a DFT needs, whatever the kernel does."""
    return 5.0 * n * math.log2(n) if n > 1 else 0.0


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FP32_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def spin_cycles_per_ms(torch) -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(20_000_000)
    stop.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(stop)


def time_ms(torch, fn, reps: int, spin_rate: float) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls,
    after two warm-up calls (CUDA events).

    A spin kernel queued first keeps the card busy while the host queues
    the calls, so the time is the card's and not the host's launch
    overhead, which exceeds a short kernel's time on a shared host.
    """
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one_call_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1.5 * reps * one_call_ms * spin_rate) + 1)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare(torch, got, want) -> tuple[float, float]:
    """(max abs err, max abs err / max |want|) over planar pairs."""
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want) or 1.0
    return err, err / scale


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch import FFTService, FFTServiceConfig
    from repro_torch.kernels import _build, coded_pipeline, ops
    from repro_torch.kernels.cmatmul import bcmatmul, bcmatmul_body
    from repro_torch.kernels.fourstep_fft import (
        encode_fourstep_body,
        encode_fourstep_fused,
    )
    from repro_torch.kernels.recombine import (
        recombine_batched_body,
        recombine_twiddle_dft_batched,
    )

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    # -- 1. device --------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": {"matmul": False, "cudnn": False}})

    # -- 2. build (parallel nvcc, one per source) -------------------------
    t0 = time.perf_counter()
    built = _build.build()
    optin = coded_pipeline.device_smem_optin(0)
    if optin != ops.SMEM_PER_BLOCK_OPTIN:
        fail(f"cudaDevAttrMaxSharedMemoryPerBlockOptin {optin} != the "
             f"gate's SMEM_PER_BLOCK_OPTIN {ops.SMEM_PER_BLOCK_OPTIN}")
    ptxas = {}
    for name in _build.SOURCES:
        log = _build.log_path(name)
        if log.exists():
            ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln or "spill" in ln][:8]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(built), "dir": str(_build.build_dir().name),
          "smem_per_block_optin": optin, "ptxas": ptxas})

    rng = np.random.default_rng(0)
    spin_rate = spin_cycles_per_ms(torch)

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev)

    def service_masks(q, n, m):
        # the service's own mask law: the fastest m of n shifted-exponential
        # draws respond
        lat = rng.exponential(1.0, size=(q, n))
        kth = np.sort(lat, axis=1)[:, m - 1:m]
        return torch.as_tensor(lat <= kth, device=dev)

    table = []

    def kernel_row(name, source, replaces, run, plain, library, tol, nbytes,
                   flops, reps, shape, yardsticks=(), **info):
        """Check ``run`` against ``plain``, time both, the library call
        and each named yardstick, and add the kernel's row.  ``info``
        adds plain values to the row."""
        got = run()
        want = plain()
        torch.cuda.synchronize()
        abs_err, rel_err = compare(torch, got, want)
        if not rel_err < tol:
            fail(f"{name}: kernel vs plain rel err {rel_err} >= {tol}")
        ms = time_ms(torch, run, reps, spin_rate)
        plain_ms = time_ms(torch, plain, reps, spin_rate)
        library_ms = (time_ms(torch, library, reps, spin_rate) if library
                      else None)
        bound_ms, bound_by = bound(nbytes, flops)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0, "max_abs_err": abs_err,
               "max_rel_err": rel_err, "tol": tol, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms,
               "shape": shape, **info,
               **{k: time_ms(torch, f, reps, spin_rate)
                  for k, f in yardsticks}}
        emit({"phase": "kernel", **row})
        table.append(row)

    csrc = "src/repro_torch/kernels/csrc/"
    # -- 3. each kernel against its plain version, at the service shapes --
    # (a) whole bucket: the default config, 64 requests of s=4096, m=4, N=8
    q, s, m, n = 64, 4096, 4, 8
    a, b = ops.split_factor(s // m)
    ell = a * b
    from repro_torch.core import mds
    from repro_torch.kernels import ref
    gr, gi = ref.planar(mds.rs_generator(n, m, device=dev))
    xr, xi = randn(q, s), randn(q, s)
    masks = service_masks(q, n, m)
    planes = (*ops._fourstep_planes(a, b, dev),
              *ops._on_device(ops._recombine_planes_scrambled,
                              (s, m, a, b), dev))
    xc = torch.complex(xr, xi)
    # least work: the m shard FFTs, then per payload position the m
    # responders' coded results, the decode, the twiddle and an m-point FFT
    flops = q * (m * fft_flops(ell)
                 + ell * (2 * 8 * m * m + 6 * m + fft_flops(m)))
    nbytes = F32 * (4 * q * s + q * n + 2 * n * m
                    + 2 * (a * a + b * b + a * b + m * ell + m * m))
    kernel_row(
        "coded_fft_bucket_masked", csrc + "coded_bucket.cu",
        "src/repro/kernels/coded_pipeline.py:857",
        lambda: coded_pipeline.coded_fft_bucket_masked(
            xr, xi, masks, gr, gi, *planes),
        lambda: coded_pipeline.bucket_body_masked(
            xr, xi, masks.to(torch.float32), gr, gi, *planes),
        lambda: torch.fft.fft(xc, dim=-1), 3e-4, nbytes, flops, 50,
        [q, s, m, n])

    # (b)-(d) the stage route of the 2^20-point service phase: 16 requests
    q, s, m, n = 16, 1 << 20, 4, 8
    a, b = ops.split_factor(s // m)
    ell = a * b
    cr, ci = randn(q, m, a, b), randn(q, m, a, b)
    fplanes = ops._fourstep_planes(a, b, dev)
    # least work: an FFT of each message shard, then the (N, m) encode
    flops = q * m * fft_flops(ell) + q * 8 * n * m * ell
    msg = torch.complex(cr, ci).reshape(q, m, ell)
    nbytes = F32 * (2 * q * m * ell + 2 * n * m + 2 * (a * a + b * b + a * b)
                    + 2 * q * n * ell)
    kernel_row(
        "encode_fourstep_fused", csrc + "encode_fourstep.cu",
        "src/repro/kernels/fourstep_fft.py:187",
        lambda: encode_fourstep_fused(cr, ci, gr, gi, *fplanes),
        lambda: encode_fourstep_body(cr, ci, gr, gi, *fplanes),
        None, 1e-4, nbytes, flops, 5, [q, m, a, b, n],
        # the FFT work the two dense DFT passes stand in for (no encode)
        yardsticks=[("fft_ms", lambda: torch.fft.fft(msg, dim=-1))])
    del cr, ci, msg

    subsets = ops.mask_subsets(service_masks(q, n, m), m)
    dr, di = ops.lagrange_scatter_planes(subsets, n)
    br, bi = randn(q, n, ell), randn(q, n, ell)
    dc, bc = torch.complex(dr, di), torch.complex(br, bi)
    # a sparse product: each request's decode matrix is zero in its
    # straggler columns, so only the responders' spectra are needed
    live = int(((dr != 0) | (di != 0)).any(dim=1).sum())
    kernel_row(
        "bcmatmul", csrc + "bcmatmul.cu", "src/repro/kernels/cmatmul.py:81",
        lambda: bcmatmul(dr, di, br, bi),
        lambda: bcmatmul_body(dr, di, br, bi),
        lambda: torch.bmm(dc, bc), 1e-5,
        F32 * 2 * (q * m * n + live * ell + q * m * ell),
        8 * m * live * ell, 20, [q, m, n, ell], live_columns=live)
    del br, bi, bc

    hr, hi = randn(q, m, ell), randn(q, m, ell)
    rplanes = ops._on_device(ops._recombine_planes, (s, m), dev)
    kernel_row(
        "recombine_twiddle_dft_batched", csrc + "recombine.cu",
        "src/repro/kernels/recombine.py:91",
        lambda: recombine_twiddle_dft_batched(hr, hi, *rplanes),
        lambda: recombine_batched_body(hr, hi, *rplanes),
        None, 1e-5,
        F32 * 2 * (2 * q * m * ell + m * ell + m * m),
        q * ell * (6 * m + fft_flops(m)), 20, [q, m, ell])
    del hr, hi
    torch.cuda.empty_cache()

    # -- 4./5. the service main path --------------------------------------
    def drive(s, n_req, expect, rel_tol):
        svc = FFTService(FFTServiceConfig(s=s, m=4, n_workers=8))
        svc.warmup(buckets=[n_req])
        xs = [(rng.standard_normal(s) + 1j * rng.standard_normal(s))
              .astype(np.complex64) for _ in range(n_req)]
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = svc.submit_batch(xs)
        dt = time.perf_counter() - t0
        counts = _build.launch_counts()
        for name in expect:
            if counts.get(name, 0) < 1:
                fail(f"s={s}: kernel {name} was not launched ({counts})")
        stage = {"encode_fourstep_fused", "bcmatmul",
                 "recombine_twiddle_dft_batched"}
        others = (stage if "coded_fft_bucket_masked" in expect
                  else {"coded_fft_bucket_masked"})
        if any(counts.get(k, 0) for k in others):
            fail(f"s={s}: took the wrong route ({counts})")
        x64 = torch.as_tensor(np.stack(xs), device=dev).to(torch.complex128)
        want = torch.fft.fft(x64, dim=-1)
        got = torch.as_tensor(np.stack(out), device=dev).to(torch.complex128)
        rel = float((got - want).abs().max() / want.abs().max())
        if not (np.isfinite(rel) and rel < rel_tol):
            fail(f"s={s}: service rel err {rel} >= {rel_tol}")
        # steady-state rate: three more identical calls, wall clock, split
        # into staging + launch (dispatch) and wait + fetch (sync)
        d0, s0 = svc.stats.dispatch_s, svc.stats.sync_s
        t1 = time.perf_counter()
        for _ in range(3):
            svc.submit_batch(xs)
        steady = (time.perf_counter() - t1) / 3
        dispatch = (svc.stats.dispatch_s - d0) / 3
        sync = (svc.stats.sync_s - s0) / 3
        emit({"phase": "service", "s": s, "m": 4, "n_workers": 8,
              "requests": n_req, "route": ("whole_bucket"
                                           if s <= 4096 else "stage"),
              "launches": counts, "rel_err": rel, "rel_tol": rel_tol,
              "first_call_s": dt, "steady_call_s": steady,
              "steady_dispatch_s": dispatch, "steady_sync_s": sync,
              "req_per_s": n_req / steady, "stats": svc.stats.summary()})
        return counts

    # default config: the whole-bucket kernel; bound from the reference's
    # masked-bucket tolerance (tests/test_lagrange_decode.py:153)
    counts = drive(4096, 64, ["coded_fft_bucket_masked"], 3e-4)
    table[0]["launches"] = counts["coded_fft_bucket_masked"]
    # a 2^20-point transform: 128 MiB in and 256 MiB of coded spectra per
    # bucket, past the whole-bucket gate, so the stage kernels run (bound
    # from tests/test_kernel_pipeline.py:113).  The JAX package would
    # stream this bucket through one launch; the port's streaming kernel is
    # a later slice.
    torch.cuda.empty_cache()
    counts = drive(1 << 20, 16, ["encode_fourstep_fused", "bcmatmul",
                                 "recombine_twiddle_dft_batched"], 1e-3)
    for row in table[1:]:
        row["launches"] = counts[row["name"]]

    emit({"kernels": table})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
