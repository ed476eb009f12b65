#!/usr/bin/env python3
"""Time the one-block four-step entries of one tree of the port on a GPU.

    python3 tools/fourstep_block_ab.py [--src DIR] [--windows 7] [--reps 50]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``), so a
parent commit unpacked elsewhere (``git archive``) is timed by the same
harness as the change.  On the s = 4096 plan's 512 worker rows of
L = 1024 it times ``fourstep_fused`` at each two-factor split the
autotune search tries, (32, 32) and (64, 16), ``multistep_fused`` in the
(16, 16, 4) plan, and the row FFT alone on the same rows, stored in
natural order (``fourstep_stage2`` on (512, 1, 1024), ``fft_rows.cuh``'s
kernel): each call is first held against its plain twin
(relative error under 1e-4), then timed in ``--windows`` windows of
``--reps`` calls with ``chip_smoke.time_ms`` (CUDA events, a spin kernel
queued first).  Prints one JSON line per entry (median, min and max ms of
the windows, the twin's error) and one with the card's name and power
limit.  To compare two trees, run them in turns in one machine: parent,
change, change, parent.  Exits 2 without a CUDA device.
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
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("fourstep_block_ab: no CUDA device available", file=sys.stderr)
        return 2
    import numpy as np

    # the harness's timing helpers from this checkout; chip_smoke puts
    # this checkout's src first on the path, so --src goes in after it
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import fourstep_fft as fs
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    spin = chip_smoke.spin_cycles_per_ms(torch)
    rows, ell = 512, 1024
    x = [torch.as_tensor(rng.standard_normal((rows, ell)).astype(np.float32),
                         device=dev) for _ in range(2)]
    cases = []
    for a, b in ((32, 32), (64, 16)):
        planes = ops._fourstep_planes(a, b, dev)
        x3 = [t.reshape(rows, a, b) for t in x]
        cases.append((f"fourstep_fused {a}x{b}",
                      lambda x3=x3, p=planes: fs.fourstep_fused(*x3, *p),
                      lambda x3=x3, p=planes: fs.fourstep_body(*x3, *p)))
    factors = (16, 16, 4)
    mplanes = ops._on_device(ops._multistep_planes, (factors,), dev)
    stages = fs._parse_stage_planes(factors, mplanes)
    cases.append(("multistep_fused 16x16x4 block",
                  lambda: fs.multistep_fused(*x, mplanes, factors),
                  lambda: fs.multistep_body(*x, stages)))
    # the row FFT alone on the same rows, natural order out
    x1 = [t.reshape(rows, 1, ell) for t in x]
    fbr, fbi = ops._on_device(ops._dft_planes, (ell,), dev)
    cases.append(("fourstep_stage2 1x1024 row FFT",
                  lambda: fs.fourstep_stage2(*x1),
                  lambda: fs.stage2_body(*x1, fbr, fbi)))
    src = str(Path(args.src).resolve().relative_to(ROOT)
              if Path(args.src).resolve().is_relative_to(ROOT)
              else Path(args.src).resolve())
    for name, run, plain in cases:
        got, want = run(), plain()
        torch.cuda.synchronize()
        _, rel = chip_smoke.compare(torch, got, want)
        if not rel < 1e-4:
            print(f"fourstep_block_ab: {name}: rel err {rel}",
                  file=sys.stderr)
            return 1
        ts = sorted(chip_smoke.time_ms(torch, run, args.reps, spin)
                    for _ in range(args.windows))
        print(json.dumps({"src": src, "name": name, "rows": rows,
                          "ms": ts[len(ts) // 2], "ms_min": ts[0],
                          "ms_max": ts[-1], "windows": args.windows,
                          "reps": args.reps, "max_rel_err": rel}),
              flush=True)
    print(json.dumps({"src": src, "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": chip_smoke.nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
