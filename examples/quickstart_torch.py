"""Coded FFT quickstart on the PyTorch port -- the paper's construction,
then the service.

Part 1 walks the four plan stages by hand (encode -> worker -> straggle
-> decode) with 4 of 8 workers down; part 2 serves an n-D REAL transform
through the batched FFTService front end (half-payload worker shards).
Inputs come from numpy with a seed; every answer is checked against
``numpy.fft``.  It runs on the card unless ``--device cpu`` asks for the
CPU (the kernels' plain twins).

Run:  PYTHONPATH=src python examples/quickstart_torch.py
      PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.core import CodedFFT, repetition_threshold
from repro_torch.core.plan import resolve_device
from repro_torch.serving import FFTService, FFTServiceConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, raising without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # Problem: X = F{x} for a length-4096 vector on N=8 workers that can
    # each hold 1/4 of the input (m=4).  Theorem 1: any 4 workers suffice.
    s, m, n_workers = 4096, 4, 8
    plan = CodedFFT(s=s, m=m, n_workers=n_workers, device=device)
    print(f"recovery threshold: coded={plan.recovery_threshold} "
          f"(repetition would need {repetition_threshold(16, m)} of 16)")

    rng = np.random.default_rng(0)
    x_np = (rng.standard_normal(s) + 1j * rng.standard_normal(s)
            ).astype(np.complex64)
    x = torch.from_numpy(x_np).to(device)

    # 1. the master encodes: interleave into m shards, apply the (N, m)
    #    complex Reed-Solomon code -> one coded shard per worker
    a = plan.encode(x)                      # (8, 1024)

    # 2. the workers each FFT their own shard (linearity => the results
    #    stay RS-coded)
    b = plan.worker_compute(a)              # (8, 1024)

    # 3. four workers straggle -- TWO MORE than uncoded could ever lose.
    #    Their rows are garbage; the master never reads them.
    b = b.clone()
    b[torch.tensor([0, 3, 5, 6], device=device)] = float("nan")
    mask = torch.tensor([False, True, True, False, True, False, False,
                         True], device=device)

    # 4. the master decodes from the fastest m=4 workers and recombines
    #    (Cooley-Tukey)
    big_x = plan.decode(b, mask=mask)

    want = np.fft.fft(x_np.astype(np.complex128))
    err = float(np.abs(big_x.cpu().numpy() - want).max())
    print(f"max |coded FFT - numpy.fft.fft| with 4/8 workers down: "
          f"{err:.2e}")
    assert err < 1e-2, "decode failed"
    print("straggler-tolerant FFT: OK")

    # ---- part 2: the service front end, serving an n-D REAL transform --
    # The batched FFTService buckets requests by (s, m, kind), simulates
    # per-request stragglers, and answers from the fastest m workers.
    # Real kinds pair-pack their shards, so each worker ships HALF the
    # payload of the complex plan -- here a 2-D rfftn request.
    svc = FFTService(FFTServiceConfig(s=s, m=m, n_workers=n_workers),
                     device=device)
    t = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)
    big_t = svc.submit_rfftn(t)             # == numpy.fft.rfftn(t), (64, 33)
    err = float(np.abs(big_t - np.fft.rfftn(t.astype(np.float64))).max())
    print(f"service rfftn (64, 64) -> {big_t.shape}: max err vs numpy "
          f"{err:.2e}")
    assert err < 1e-2, "rfftn service decode failed"
    st = svc.stats.summary()
    print(f"coded latency {st['mean_coded_latency']:.3f}s vs uncoded "
          f"{st['mean_uncoded_latency']:.3f}s "
          f"({st['stragglers_tolerated']} stragglers tolerated)")
    print("n-D real coded FFT service: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
