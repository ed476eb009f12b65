#!/usr/bin/env python3
"""How often a ``torch.profiler`` trace of a short call loses its kernels.

    python3 tools/trace_window_probe.py [--traces 1200] [--margins-ms 0 25]

The profiler maps each kernel's device timestamp onto the host's clock
and drops a kernel that lands outside its capture window.  This script
traces two calls of the port many times -- the m = 64 encode (64
requests, 64 shards of 8 x 8 points, N = 128: two launches) and
``multistep_fused`` per stage (128 rows of (64, 64, 64): three
launches) -- with the call placed each margin into the window (a host
sleep before it and after it), the margins interleaved call by call so
that a passing disturbance meets each alike.  Per call and margin it
prints the traces that lacked a route kernel and the spread of the
first kernel's device start less its launch's host start (negative: the
mapping put the kernel before its own launch).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traces", type=int, default=1200)
    ap.add_argument("--margins-ms", type=float, nargs="+", default=[0, 25])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("trace_window_probe: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import mds
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fourstep_fft import (encode_fourstep_fused,
                                                  multistep_fused)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    q, m, a, b, n = 64, 64, 8, 8, 128
    cr, ci = randn(q, m, a, b), randn(q, m, a, b)
    fplanes = ops._fourstep_planes(a, b, dev)
    gr, gi = ref.planar(mds.rs_generator(n, m, device=dev))
    factors = (64, 64, 64)
    xr, xi = randn(128, 1 << 18), randn(128, 1 << 18)
    mplanes = ops._on_device(ops._multistep_planes, (factors,), dev)
    calls = {
        "encode [64, 64, 8, 8, 128]": (
            lambda: encode_fourstep_fused(cr, ci, gr, gi, *fplanes),
            ("fft_cols_kernel", "encode_rows_kernel")),
        "multistep_fused per stage [128, (64, 64, 64)]": (
            lambda: multistep_fused(xr, xi, mplanes, factors),
            ("fft_cols_kernel", "fft_rows_kernel")),
    }

    def trace(fn, margin_s):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(margin_s)
            fn()
            torch.cuda.synchronize()
            time.sleep(margin_s)
        ran = {e.key for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0}
        events = prof.events()
        launches = [e.time_range.start for e in events
                    if e.name == "cudaLaunchKernel"]
        kernels = sorted(e.time_range.start for e in events
                         if e.device_type == torch.autograd.DeviceType.CUDA)
        skew = (kernels[0] - launches[0]) if kernels and launches else None
        return ran, skew

    report = {}
    for name, (fn, route) in calls.items():
        fn()
        fn()
        lost = {ms: 0 for ms in args.margins_ms}
        skews = {ms: [] for ms in args.margins_ms}
        for _ in range(args.traces):
            for ms in args.margins_ms:
                ran, skew = trace(fn, ms / 1e3)
                lost[ms] += any(not any(f in k for k in ran) for f in route)
                if skew is not None:
                    skews[ms].append(skew)
        report[name] = {
            f"margin {ms:g} ms": {
                "traces": args.traces, "lost_a_route_kernel": lost[ms],
                "first_kernel_skew_us_min_median_max": (
                    [min(sk), sorted(sk)[len(sk) // 2], max(sk)]
                    if (sk := skews[ms]) else None)}
            for ms in args.margins_ms}
        print(json.dumps({name: report[name]}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
