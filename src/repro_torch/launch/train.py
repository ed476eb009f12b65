"""Training launcher.

Two modes:

* default -- trains on one device, a reduced-family model (``--reduced``)
  or any full config the card can hold.  Fault-tolerant: checkpoints land
  in ``--ckpt-dir`` and a restarted process resumes from the newest
  complete one, bit for bit.
* ``--lower-only`` -- the dry run of one cell (``--mesh``, ``--shape``):
  ``launch.dryrun.run_cell(..., variant="train-launcher")`` counts the
  step on meta tensors against the mesh's plan, writes its record under
  ``experiments/torch/dryrun`` and prints its verdict, without running
  anything on a device.  The JAX package's launcher lowers and compiles
  the step on the production mesh here; the port has no compiler to ask.

Examples::

    # gemma-2b at full width and depth on the CUDA device
    python -m repro_torch.launch.train --arch gemma-2b --steps 100 \\
        --global-batch 4 --seq-len 512 --ckpt-dir build/ckpt-gemma

    # a reduced config on the CPU (the kernels' plain twins)
    python -m repro_torch.launch.train --arch minicpm-2b --reduced \\
        --device cpu --steps 200

    # the dry run of dbrx-132b's train step on the multi-pod mesh
    python -m repro_torch.launch.train --arch dbrx-132b --lower-only \\
        --mesh multi

The default mode runs on CUDA and raises without a device unless
``--device`` names another.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, get_config, \
    get_reduced_config


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced same-family config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", choices=("cosine", "wsd"), default="cosine")
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, raising without one)")
    ap.add_argument("--lower-only", action="store_true",
                    help="dry run of one cell on meta tensors, no training")
    ap.add_argument("--mesh", choices=("single", "multi", "card"),
                    default="single")
    ap.add_argument("--shape", choices=tuple(SHAPES), default="train_4k")
    args = ap.parse_args(argv)

    if args.lower_only:
        from repro_torch.launch.dryrun import run_cell, write_record
        from repro_torch.launch.roofline import DRYRUN_DIR

        rec = run_cell(args.arch, args.shape, args.mesh, DRYRUN_DIR,
                       variant="train-launcher")
        if rec.get("skipped"):
            print(f"skipped: {rec['skipped']}")
            return 0
        write_record(DRYRUN_DIR, rec)
        print(f"dry run OK: {rec['terms']['dominant']}-bound, "
              f"{'fits' if rec['fits_hbm'] else 'does NOT fit'} one card")
        return 0

    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine, wsd
    from repro_torch.training import Trainer, TrainerConfig

    cfg = get_reduced_config(args.arch) if args.reduced else get_config(
        args.arch)
    model = build_model(cfg, device=args.device)
    shape = ShapeConfig("cli", args.seq_len, args.global_batch, "train")
    pipe = make_pipeline(cfg, shape, seed=args.seed, device=model.device)
    warm = max(args.steps // 20, 1)
    sched = (wsd(args.lr, args.steps, warm) if args.schedule == "wsd"
             else cosine(args.lr, args.steps, warm))
    print(f"[train] {cfg.name}: {model.n_params:,} params "
          f"({model.n_active_params:,} active), {args.steps} steps, "
          f"batch {args.global_batch} x seq {args.seq_len} on {model.device}")
    trainer = Trainer(model, adamw(sched), pipe, TrainerConfig(
        total_steps=args.steps, checkpoint_every=args.ckpt_every,
        checkpoint_dir=args.ckpt_dir, log_every=args.log_every,
        n_micro=args.n_micro, seed=args.seed))
    _, metrics = trainer.run()
    print(f"[train] done: {metrics}")
    if model.device.type == "cuda":
        import torch

        print(f"[train] max_memory_allocated "
              f"{torch.cuda.max_memory_allocated(model.device) / 1e9:.3f} GB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
