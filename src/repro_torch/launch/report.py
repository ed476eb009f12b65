"""Render the dry-run and roofline tables from the port's dry-run records.

The twin of the JAX package's ``launch/report.py``, for one H100 of 80 GB
(``roofline.HBM_PER_CHIP``).  ``python -m repro_torch.launch.report``
writes ``experiments/torch/dryrun_table.md`` and
``experiments/torch/roofline_table.md`` from
``experiments/torch/dryrun/*.json`` and prints both.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

from repro_torch.configs import SHAPES
from repro_torch.launch.roofline import (DRYRUN_DIR, HBM_PER_CHIP,
                                         load_records, render_table, terms)

__all__ = ["dryrun_table", "main"]

OUT_DIR = os.path.join("experiments", "torch")


def dryrun_table(dryrun_dir: str = DRYRUN_DIR,
                 variant: str = "baseline") -> str:
    """One row an (arch x shape), the meshes side by side (``single /
    multi``): bytes a rank (arguments, temp), whether they fit one card,
    FLOPs a chip, the terms (the compute term's FP32 part beside it), the
    dominant one and the host seconds the
    count took; then the skipped cells, by reason."""
    recs = {}
    for r in load_records(dryrun_dir):
        if r.get("variant", "baseline") == variant and r.get("kind") != "fft":
            recs.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    order = {s: i for i, s in enumerate(SHAPES)}
    meshes = ("single", "multi")
    lines = [
        f"| arch | shape | args GB/chip | temp GB/chip | fits "
        f"{HBM_PER_CHIP / 1e9:.0f} GB | TFLOP/chip | compute ms | "
        f"of it fp32 ms | memory ms | dominant | count s |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    skipped: dict = {}
    for (arch, shape), by in sorted(
            recs.items(), key=lambda kv: (kv[0][0], order.get(kv[0][1], 9))):
        rows = [by.get(m) for m in meshes]
        if any(r is None or r.get("skipped") for r in rows):
            reason = next((r["skipped"] for r in rows
                           if r is not None and r.get("skipped")), "missing")
            skipped.setdefault(reason, []).append(f"{arch} × {shape}")
            continue
        t = [terms(r) for r in rows]

        def both(fmt, fn):
            return " / ".join(fmt.format(fn(i)) for i in range(2))

        mem = [r["memory"] for r in rows]
        lines.append(
            f"| {arch} | {shape} | "
            + both("{:.3f}", lambda i: mem[i]["argument_size_in_bytes"] / 1e9)
            + " | " + both("{:.2f}", lambda i: (
                mem[i].get("temp_size_in_bytes") or 0) / 1e9)
            + " | " + both("{}", lambda i: "yes" if rows[i]["fits_hbm"]
                           else "NO")
            + " | " + both("{:.4g}", lambda i: rows[i]["cost"]["flops"] / 1e12)
            + " | " + both("{:.4g}", lambda i: t[i]["compute_s"] * 1e3)
            + " | " + both("{:.4g}", lambda i: t[i]["compute_fp32_s"] * 1e3)
            + " | " + both("{:.4g}", lambda i: t[i]["memory_s"] * 1e3)
            + " | " + both("{}", lambda i: t[i]["dominant"])
            + " | " + both("{:.1f}", lambda i: rows[i].get(
                "count_seconds", 0)) + " |")
    for reason, cells in skipped.items():
        lines.append(f"\nSkipped ({reason}): {', '.join(cells)}.")
    return "\n".join(lines)


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=DRYRUN_DIR)
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    dt = dryrun_table(args.dir)
    with open(os.path.join(args.out, "dryrun_table.md"), "w") as f:
        f.write(dt + "\n")
    rt = render_table(args.dir, "single", "baseline")
    with open(os.path.join(args.out, "roofline_table.md"), "w") as f:
        f.write(rt + "\n")
    print(dt)
    print()
    print(rt)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
