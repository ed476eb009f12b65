"""Deterministic synthetic LM batches, the JAX package's
``data/pipeline.py``: the same draws, so the same tokens bit for bit.

Row r of the global batch at step t is a pure function of (seed, t, r):
numpy's ``default_rng(SeedSequence([seed, t, r]))`` draws its seq_len + 1
tokens, so any host sharding of the rows, and a restart at any step,
reads exactly the rows a single-host run reads.  The encoder-decoder's
frames and the vlm's patches are the reference's f32 standard-normal
draws rounded to bf16.  ``batch(step)`` returns torch tensors on the
pipeline's ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.core.plan import resolve_device

__all__ = ["SyntheticLMData", "make_pipeline"]


@dataclasses.dataclass(frozen=True)
class SyntheticLMData:
    """Random-access synthetic LM batches: ``tokens``/``labels`` (int32)
    and the modality stubs, on ``device``."""

    cfg: ArchConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    # host sharding: this process holds rows [row_start, row_start+rows)
    row_start: int = 0
    rows: Optional[int] = None
    device: torch.device = torch.device("cpu")

    @property
    def local_rows(self) -> int:
        return self.rows if self.rows is not None else self.global_batch

    def _tokens(self, step: int, rows: int, offset: int) -> np.ndarray:
        out = np.empty((rows, self.seq_len + 1), np.int32)
        for i in range(rows):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, offset + i]))
            out[i] = rng.integers(0, self.cfg.vocab_size,
                                  size=self.seq_len + 1, dtype=np.int64)
        return out

    def _stub(self, seed: int, step: int, shape) -> torch.Tensor:
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, step, self.row_start]))
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(x).to(self.device).to(torch.bfloat16)

    def batch(self, step: int) -> dict:
        """Batch for ``step`` (this host's rows only)."""
        cfg = self.cfg
        toks = torch.from_numpy(
            self._tokens(step, self.local_rows, self.row_start)).to(
                self.device)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "encdec":
            out["frames"] = self._stub(
                self.seed + 7, step,
                (self.local_rows, self.seq_len, cfg.d_model))
        if cfg.family == "vlm" and cfg.num_prefix_tokens:
            out["patches"] = self._stub(
                self.seed + 13, step,
                (self.local_rows, cfg.num_prefix_tokens, cfg.d_model))
            # the backbone sees [patches ; tokens]: trim the text so the
            # total is seq_len
            text = self.seq_len - cfg.num_prefix_tokens
            out["tokens"] = out["tokens"][:, :text]
            out["labels"] = out["labels"][:, :text]
        return out


def make_pipeline(cfg: ArchConfig, shape: ShapeConfig, *, seed: int = 0,
                  process_index: int = 0, process_count: int = 1,
                  global_batch: Optional[int] = None,
                  device=None) -> SyntheticLMData:
    """Host-sharded pipeline: each process reads its contiguous row block,
    as tensors on ``device`` (``None``: CUDA, raising without one)."""
    gb = global_batch if global_batch is not None else shape.global_batch
    if gb % process_count:
        raise ValueError(f"global batch {gb} does not split over "
                         f"{process_count} processes")
    rows = gb // process_count
    return SyntheticLMData(
        cfg=cfg, seq_len=shape.seq_len, global_batch=gb, seed=seed,
        row_start=process_index * rows, rows=rows,
        device=resolve_device(device))
