"""The training step: microbatched gradients -> global-norm clip ->
AdamW, the parameters updated in place."""

from __future__ import annotations

from typing import Callable

from repro_torch.optim.adamw import Optimizer
from repro_torch.optim.grad_utils import accumulate_grads, clip_by_global_norm
from repro_torch.training.train_state import TrainState

__all__ = ["make_train_step"]


def make_train_step(model, optimizer: Optimizer, *, n_micro: int = 1,
                    clip_norm: float = 1.0) -> Callable:
    """``(state, batch) -> (state, metrics)`` for ``model`` (a
    ``BuiltModel``): the metrics are ``loss``, ``grad_norm`` (before the
    clip) and the loss's own, as f32 scalar tensors on the device."""
    loss_fn = model.loss

    def train_step(state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        loss, metrics, grads = accumulate_grads(loss_fn, state.params,
                                                batch, n_micro)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        _, new_opt = optimizer.update(state.params, grads, state.opt_state,
                                      state.step)
        del grads
        out = {"loss": loss.detach().float(), "grad_norm": gnorm.float()}
        for k, v in (metrics or {}).items():
            out[k] = v.detach().float()
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=new_opt), out

    return train_step
