"""The paper's own application end to end on the PyTorch port: a
straggler-tolerant FFT service.

Submits a batch of transform requests; each request's workers draw
shifted-exponential latencies, the service answers after the fastest m,
and every answer is checked against ``numpy.fft``.  It runs on the card
unless ``--device cpu`` asks for the CPU.  ``--mesh`` starts a 4-rank
``torch.distributed`` world over ``gloo`` (its ranks sharing the card,
or on the CPU with ``--device cpu``) and serves through
``FFTService(mesh=)``:
each rank encodes and transforms its own 2 of the 8 coded shards, one
all-gather fans them in, and every rank decodes the same answers.

Run:  PYTHONPATH=src python examples/fft_service_demo_torch.py
      PYTHONPATH=src python examples/fft_service_demo_torch.py --device cpu
      PYTHONPATH=src python examples/fft_service_demo_torch.py --mesh
      PYTHONPATH=src python examples/fft_service_demo_torch.py --mesh \
          --device cpu
"""

import argparse
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.plan import resolve_device
from repro_torch.distributed import StragglerModel
from repro_torch.serving import FFTService, FFTServiceConfig

RANKS = 4


def serve(device, requests: int, mesh=None) -> dict:
    """Serve ``requests`` seeded requests; check each answer; return the
    service's summary."""
    svc = FFTService(
        FFTServiceConfig(s=4096, m=4, n_workers=8,
                         straggler=StragglerModel(t0=1.0, mu=1.0)),
        device=device, mesh=mesh)
    rng = np.random.default_rng(0)
    xs = [(rng.standard_normal(4096) + 1j * rng.standard_normal(4096))
          .astype(np.complex64) for _ in range(requests)]
    for x, y in zip(xs, svc.submit_batch(xs)):
        err = float(np.abs(y - np.fft.fft(x.astype(np.complex128))).max())
        assert err < 1e-2, err
    return svc.stats.summary()


def report(st: dict) -> None:
    print(f"[demo] {st['requests']} requests all correct "
          f"({st['batches']} scheduler batch(es))")
    print(f"[demo] mean latency: coded {st['mean_coded_latency']:.3f}s, "
          f"wait-for-all {st['mean_uncoded_latency']:.3f}s "
          f"-> {st['speedup']:.2f}x faster")
    print(f"[demo] stragglers tolerated (worker-requests never waited on): "
          f"{st['stragglers_tolerated']}")


def rank_main(rank: int, device: str, requests: int, rendezvous: str):
    from repro_torch.distributed import test_mesh

    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=RANKS)
    try:
        mesh = test_mesh((RANKS,), ("workers",), device_type=device)
        st = serve(device, requests, mesh)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(f"[demo] {RANKS} ranks on a ('workers',) mesh over gloo, "
              f"2 coded shards each")
        report(st)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", action="store_true",
                    help=f"serve through a {RANKS}-rank mesh")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    ap.add_argument("--requests", type=int, default=12)
    args = ap.parse_args()
    if not args.mesh:
        report(serve(args.device, args.requests))
        return
    device = resolve_device(args.device).type
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(device, args.requests, f"{tmp}/pg"),
                 nprocs=RANKS, join=True)


if __name__ == "__main__":
    main()
