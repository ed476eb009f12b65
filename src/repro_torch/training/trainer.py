"""Fault-tolerant training loop: checkpoint/restart and async saves.

* restart-safe: resumes from the newest complete checkpoint; the
  synthetic data is random-access by step, so the resumed run consumes
  exactly the batches the stopped run would have -- bit-exact
  continuation on a deterministic device;
* async checkpointing: the device -> host snapshot is synchronous, the
  file write overlaps the next steps;
* straggler accounting: each step's wall time feeds an EWMA; steps slower
  than ``straggler_factor`` x the EWMA are counted in the metrics.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
)
from repro_torch.data import SyntheticLMData
from repro_torch.optim.adamw import Optimizer
from repro_torch.training.train_state import TrainState, init_train_state
from repro_torch.training.train_step import make_train_step

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_last: int = 3
    log_every: int = 10
    n_micro: int = 1
    clip_norm: float = 1.0
    straggler_factor: float = 2.0
    seed: int = 0


class Trainer:
    def __init__(self, model, optimizer: Optimizer, data: SyntheticLMData,
                 tcfg: TrainerConfig, *,
                 train_step: Optional[Callable] = None,
                 log_fn: Callable[[str], None] = print):
        self.model = model
        self.optimizer = optimizer
        self.data = data
        self.tcfg = tcfg
        self.log = log_fn
        self.train_step = train_step or make_train_step(
            model, optimizer, n_micro=tcfg.n_micro,
            clip_norm=tcfg.clip_norm)
        self.ckpt = (AsyncCheckpointer(tcfg.checkpoint_dir, tcfg.keep_last)
                     if tcfg.checkpoint_dir else None)
        self.straggler_steps = 0

    def init_or_restore(self) -> TrainState:
        """Fresh state from the seed, replaced by the newest complete
        checkpoint in ``checkpoint_dir`` when there is one."""
        gen = torch.Generator(device=self.model.device).manual_seed(
            self.tcfg.seed)
        state = init_train_state(self.model, self.optimizer, gen)
        d = self.tcfg.checkpoint_dir
        if d and latest_step(d) is not None:
            step, tree = restore_checkpoint(d, state.tree())
            state = TrainState.from_tree(tree, state.params)
            self.log(f"[trainer] resumed from checkpoint step {step}")
        return state

    def run(self, state: Optional[TrainState] = None
            ) -> tuple[TrainState, dict]:
        tcfg = self.tcfg
        if state is None:
            state = self.init_or_restore()
        start = state.step
        ewma = None
        last_metrics: dict = {}
        for step in range(start, tcfg.total_steps):
            batch = self.data.batch(step)
            t0 = time.perf_counter()
            state, metrics = self.train_step(state, batch)
            last_metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > tcfg.straggler_factor * ewma and step > start + 2:
                self.straggler_steps += 1
            if (step + 1) % tcfg.log_every == 0 or step + 1 == tcfg.total_steps:
                self.log(f"[trainer] step {step + 1}/{tcfg.total_steps} "
                         f"loss {last_metrics['loss']:.4f} "
                         f"gnorm {last_metrics['grad_norm']:.3f} "
                         f"{dt * 1e3:.0f} ms")
            if self.ckpt and (step + 1) % tcfg.checkpoint_every == 0:
                self.ckpt.save(step + 1, state.tree(),
                               metadata={"loss": last_metrics["loss"]})
        if self.ckpt:
            self.ckpt.save(tcfg.total_steps, state.tree(),
                           metadata=last_metrics)
            self.ckpt.wait()
        last_metrics["straggler_steps"] = self.straggler_steps
        return state, last_metrics
