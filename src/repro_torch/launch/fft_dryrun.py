"""Production-mesh dry run of the paper's own workload, counted on meta.

The twin of the JAX package's ``launch/fft_dryrun.py``: a coded FFT of a
length-2^28 vector, m=256 (each worker holds 1/256), N=512 coded workers
over 256 ranks (2 coded shards a rank -- the paper's N > m redundancy).
The worker is the four-step matmul FFT in torch ops (:func:`matmul_fft`,
the reference's ``matmul_fft``), so the counter sees its FLOPs.

Variants:
  baseline   -- ``DistributedCodedPlan.run``: the paper-literal
                replicated master, one all-gather of all N results to
                every rank, decode everywhere.
  a2a-decode -- ``DistributedCodedPlan.run_sharded``: one all-to-all
                moves each worker's output columns to their rank; decode
                and recombine on (m, L/P) blocks locally.

Where the reference compiles the sharded program for 256 placeholder
devices, the port runs it as rank 0 of a 256-rank fake process group
(``torch.testing._internal.distributed.fake_pg``: every collective
returns at once, nothing moves) on meta tensors, under
``launch/cost_analysis``'s counter.  What rank 0 dispatches is one
chip's share, so the counts are a chip's, as the reference's
post-partitioning HLO is.  The collectives are the runtime's own; their
symbols as the runtime records them (``last_collectives``) are kept
beside the counter's bytes.  The plan is the reference-backend
``CodedFFT`` on ``device="meta"``: its encode is the plain product (the
``cmatmul`` kernel's shared-memory bound refuses m=256), and its
twiddle and DFT planes are shaped on meta, not built (the twiddles of
2^28 points would take 4 GB of host numpy).

Napkin math (s=2^28, m=256, N=512, L = s/m, P=256 ranks, c64):
  baseline  wire/chip = N x L x 8   = 512 * 2^20 * 8 B = 4.3 GB  -> 9.5 ms
  a2a       wire/chip = N x L/P x 8 = 512 * 2^12 * 8 B = 16.8 MB -> 0.037 ms
at 450 GB/s of NVLink: the baseline is collective-bound, and the
all-to-all moves P times fewer bytes.  (The reference's docstring puts
the all-to-all at about 2.1 GB, half the gather; its own lowered
all-to-all is the P-th part, as ``tests/test_torch_launch.py`` checks.)

    python -m repro_torch.launch.fft_dryrun            # both variants
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.coded_fft import CodedFFT
from repro_torch.core.recombine import dft_matrix
from repro_torch.distributed.coded_runtime import DistributedCodedPlan
from repro_torch.launch.cost_analysis import analyze
from repro_torch.launch.roofline import DRYRUN_DIR, terms

__all__ = ["RANKS", "VARIANTS", "matmul_fft", "run_cell", "main"]

RANKS = 256
VARIANTS = ("baseline", "a2a-decode")
_SYMBOL_BYTES = 8          # complex64


def matmul_fft(x: torch.Tensor) -> torch.Tensor:
    """Four-step FFT of the last axis as two DFT matmuls and a twiddle.

    x: (..., L) complex, L = A*B; output X[q*B + r] in natural order.
    """
    lead, ell = tuple(x.shape[:-1]), x.shape[-1]
    a = 1 << ((ell.bit_length() - 1) // 2)
    b = ell // a
    x3 = x.reshape(-1, b, a).transpose(1, 2)          # x3[a', b'] = x[a' + A b']
    y = torch.einsum("nab,bk->nak", x3,
                     dft_matrix(b, x.dtype, device=x.device))
    ang = (-2.0 * np.pi / ell) * torch.outer(
        torch.arange(a, device=x.device, dtype=torch.float64),
        torch.arange(b, device=x.device, dtype=torch.float64))
    tw = torch.polar(torch.ones_like(ang), ang).to(x.dtype)
    y = y * tw[None]
    z = torch.einsum("qa,nak->nqk", dft_matrix(a, x.dtype, device=x.device),
                     y)                                # length-A DFTs
    return z.reshape(lead + (ell,))


def _fake_world(ranks: int) -> bool:
    """Make this process rank 0 of a ``ranks``-rank fake group; False if
    a group already exists (then it is used as it is)."""
    if dist.is_initialized():
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)
    return True


def run_cell(s: int, m: int, n_workers: int, variant: str, out_dir: str,
             ranks: int = RANKS) -> dict:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: one of {VARIANTS}")
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh("meta", list(range(ranks)),
                      mesh_dim_names=("workers",))
    plan = CodedFFT(s=s, m=m, n_workers=n_workers, worker_fn=matmul_fft,
                    backend="reference", device="meta")
    runtime = DistributedCodedPlan(plan, mesh)
    x = torch.empty((s,), dtype=torch.complex64, device="meta")
    mask = torch.empty((n_workers,), dtype=torch.bool, device="meta")
    fn = runtime.run_sharded if variant == "a2a-decode" else runtime.run
    t0 = time.time()
    _, cost = analyze(fn, x, mask)
    seconds = time.time() - t0
    hc = cost.as_dict()
    recorded = [dict(c, send_bytes=c["send_symbols"] * _SYMBOL_BYTES,
                     recv_bytes=c["recv_symbols"] * _SYMBOL_BYTES)
                for c in runtime.last_collectives]
    rec = {
        "arch": "coded-fft-service",
        "shape": f"s2^{s.bit_length() - 1}_m{m}_N{n_workers}",
        "mesh": "single", "variant": variant, "chips": ranks,
        "kind": "fft",
        "count_seconds": round(seconds, 2),
        "cost": hc,
        "recorded_collectives": recorded,
        # useful work: one length-s FFT, 5 s log2 s flops (complex radix-2)
        "model_flops": {"total": 5.0 * s * (s.bit_length() - 1)},
    }
    rec["terms"] = terms(rec)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"coded-fft--{rec['shape']}--{variant}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    t = rec["terms"]
    print(f"[{variant:>10}] counted in {seconds:.2f}s | "
          f"compute {t['compute_s'] * 1e3:.3f}ms  memory "
          f"{t['memory_s'] * 1e3:.3f}ms  collective "
          f"{t['collective_s'] * 1e3:.3f}ms | wire/chip "
          f"{hc['collective_wire_bytes']:.4e} B | colls "
          f"{hc['collective_counts']}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--s", type=int, default=1 << 28)
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--workers", type=int, default=512)
    ap.add_argument("--out", default=DRYRUN_DIR)
    ap.add_argument("--variant", choices=VARIANTS + ("both",),
                    default="both")
    args = ap.parse_args(argv)
    variants = VARIANTS if args.variant == "both" else (args.variant,)
    made = _fake_world(RANKS)
    try:
        recs = [run_cell(args.s, args.m, args.workers, v, args.out)
                for v in variants]
    finally:
        if made:
            dist.destroy_process_group()
    if len(recs) == 2:
        w = [r["cost"]["collective_wire_bytes"] for r in recs]
        print(json.dumps({"wire_bytes_per_chip": dict(zip(variants, w)),
                          "baseline_over_a2a": w[0] / w[1]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
