"""End-to-end LM training with the PyTorch port: the synthetic data
pipeline -> model -> AdamW (WSD) -> the fault-tolerant trainer with
async checkpoints.  The twin of ``examples/train_lm.py``.

Default is a ~15M-parameter MiniCPM-family model for 60 steps;
``--params-100m --steps 300`` gives the larger model (the same code
path).  Stop it mid-run and rerun: it resumes bit for bit from the last
checkpoint.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps N]
      [--params-100m] [--device cpu]

Runs on the CUDA device and refuses to start without one unless
``--device`` names another.
"""

import argparse
import dataclasses
import math
import os

from repro_torch.configs import ShapeConfig, get_reduced_config
from repro_torch.data import make_pipeline
from repro_torch.models import build_model
from repro_torch.optim import adamw, wsd
from repro_torch.training import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--params-100m", action="store_true",
                    help="~100M-param config (the same code path)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        "build", "train_lm_torch"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, raising without one)")
    args = ap.parse_args(argv)

    cfg = get_reduced_config("minicpm-2b")
    if args.params_100m:
        cfg = dataclasses.replace(
            cfg, name="minicpm-100m", n_layers=12, d_model=512, n_heads=8,
            n_kv_heads=8, head_dim=64, d_ff=2048, vocab_size=32768)
    else:
        cfg = dataclasses.replace(
            cfg, name="minicpm-15m", n_layers=6, d_model=256, n_heads=4,
            n_kv_heads=4, head_dim=64, d_ff=1024, vocab_size=8192)

    model = build_model(cfg, device=args.device)
    print(f"[example] {cfg.name}: {model.n_params / 1e6:.1f}M params on "
          f"{model.device}")
    shape = ShapeConfig("example", seq_len=256, global_batch=8, kind="train")
    pipe = make_pipeline(cfg, shape, device=model.device)
    opt = adamw(wsd(3e-3, args.steps, max(args.steps // 10, 1)))
    trainer = Trainer(model, opt, pipe, TrainerConfig(
        total_steps=args.steps, checkpoint_every=20,
        checkpoint_dir=args.ckpt_dir, log_every=10, n_micro=2))
    _, metrics = trainer.run()
    print(f"[example] final loss {metrics['loss']:.4f} "
          f"(start was ~ln(vocab)={math.log(cfg.vocab_size):.2f})")


if __name__ == "__main__":
    main()
