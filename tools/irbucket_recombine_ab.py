#!/usr/bin/env python3
"""Time the c2r bucket and recombine entries of one tree of the port on a GPU.

    python3 tools/irbucket_recombine_ab.py [--src DIR] [--windows 7]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``), so a
parent commit unpacked elsewhere (``git archive``) is timed by the same
harness as the change.  At the shapes of ``chip_smoke.py``'s kernel rows
it times

- ``coded_irfft_bucket_masked`` (64 requests, s = 4096, m = 4, N = 8, the
  service's bool masks) and ``coded_irfft_bucket`` (the same on the
  masks' scatter decode planes);
- ``recombine_twiddle_dft_batched`` at q = 64, m = 64, L = 64 (the host
  path's m = 64 bucket) and at q = 16, m = 4, L = 2^18 (the 2^20-point
  stage route);
- ``recombine_twiddle_dft`` at m = 4, L = 2^18, L2-cold: every call after
  a 128 MiB write, the write's own time subtracted, as ``chip_smoke.py``
  times it.

Each call is first held against its plain twin (relative error under
1e-4 for the buckets, 1e-5 for the recombine), then timed in
``--windows`` windows with ``chip_smoke.time_ms`` (CUDA events, a spin
kernel queued first).  Prints one JSON line per entry (median, min and
max ms of the windows, the twin's error) and one with the card's name
and power limit.  To compare two trees, run them in turns in one
machine: parent, change, change, parent.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--windows", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("irbucket_recombine_ab: no CUDA device available",
              file=sys.stderr)
        return 2
    import numpy as np

    # the harness's timing helpers from this checkout; chip_smoke puts
    # this checkout's src first on the path, so --src goes in after it
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import mds
    from repro_torch.kernels import coded_pipeline as cp
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import recombine as rc

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    spin = chip_smoke.spin_cycles_per_ms(torch)

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev)

    cases = []
    # the c2r bucket: the service default's bucket, its mask law
    q, s, m, n = 64, 4096, 4, 8
    gr, gi = ref.planar(mds.rs_generator(n, m, device=dev))
    lat = rng.exponential(1.0, size=(q, n))
    masks = torch.as_tensor(lat <= np.sort(lat, axis=1)[:, m - 1:m],
                            device=dev)
    dr, di = ops.lagrange_scatter_planes(ops.mask_subsets(masks, m), n)
    yhalf = torch.fft.rfft(randn(q, s), dim=-1)
    c2r = (yhalf.real.contiguous(), yhalf.imag.contiguous(), masks,
           masks.to(torch.float32), dr, di, gr, gi,
           ops._irbucket_planes(s, m, dev), s)

    def masked(yr, yi, mk, fmk, dr, di, gr, gi, planes, s):
        return (lambda: cp.coded_irfft_bucket_masked(yr, yi, mk, gr, gi,
                                                     *planes, s),
                lambda: cp.irbucket_body_masked(yr, yi, fmk, gr, gi,
                                                *planes, s))

    def on_planes(yr, yi, mk, fmk, dr, di, gr, gi, planes, s):
        return (lambda: cp.coded_irfft_bucket(yr, yi, dr, di, gr, gi,
                                              *planes, s),
                lambda: cp.irbucket_body(yr, yi, dr, di, gr, gi, *planes,
                                         s))

    cases.append(("coded_irfft_bucket_masked", [q, s, m, n], 1e-4, None,
                  *masked(*c2r), 50))
    cases.append(("coded_irfft_bucket", [q, s, m, n], 1e-4, None,
                  *on_planes(*c2r), 50))

    # the recombine: the host path's m = 64 bucket, the stage route at
    # 2^20 points, and one 2^20-point request L2-cold
    def batched(hr, hi, planes):
        return (lambda: rc.recombine_twiddle_dft_batched(hr, hi, *planes),
                lambda: rc.recombine_batched_body(hr, hi, *planes))

    def single(hr, hi, planes):
        return (lambda: rc.recombine_twiddle_dft(hr, hi, *planes),
                lambda: rc.recombine_body(hr, hi, *planes))

    for q, s, m in ((64, 4096, 64), (16, 1 << 20, 4)):
        ell = s // m
        cases.append((
            "recombine_twiddle_dft_batched", [q, m, ell], 1e-5, None,
            *batched(randn(q, m, ell), randn(q, m, ell),
                     ops._on_device(ops._recombine_planes, (s, m), dev)),
            20))
    s, m = 1 << 20, 4
    ell = s // m
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    cases.append((
        "recombine_twiddle_dft", [m, ell], 1e-5, flush,
        *single(randn(m, ell), randn(m, ell),
                ops._on_device(ops._recombine_planes, (s, m), dev)), 20))

    src = str(Path(args.src).resolve().relative_to(ROOT)
              if Path(args.src).resolve().is_relative_to(ROOT)
              else Path(args.src).resolve())
    for name, shape, tol, fl, run, plain, reps in cases:
        got, want = run(), plain()
        if isinstance(got, torch.Tensor):
            got, want = [got], [want]
        torch.cuda.synchronize()
        _, rel = chip_smoke.compare(torch, got, want)
        if not rel < tol:
            print(f"irbucket_recombine_ab: {name} {shape}: rel err {rel}",
                  file=sys.stderr)
            return 1

        def timed():
            if fl is None:
                return chip_smoke.time_ms(torch, run, reps, spin)
            return (chip_smoke.time_ms(torch, lambda: (fl.zero_(), run()),
                                       reps, spin)
                    - chip_smoke.time_ms(torch, fl.zero_, reps, spin))

        ts = sorted(timed() for _ in range(args.windows))
        print(json.dumps({"src": src, "name": name, "shape": shape,
                          "l2_cold": fl is not None,
                          "ms": ts[len(ts) // 2], "ms_min": ts[0],
                          "ms_max": ts[-1], "windows": args.windows,
                          "reps": reps, "max_rel_err": rel}), flush=True)
    print(json.dumps({"src": src, "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": chip_smoke.nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
