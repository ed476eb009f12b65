"""The optimizer of the port: AdamW (exact or int8 moments), the
learning-rate schedules and the gradient utilities, as the JAX package's
``optim`` has them."""

from repro_torch.optim.adamw import AdamWConfig, Optimizer, adamw
from repro_torch.optim.grad_utils import (
    accumulate_grads,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.schedules import constant, cosine, linear_warmup, wsd

__all__ = [
    "AdamWConfig", "Optimizer", "adamw",
    "accumulate_grads", "clip_by_global_norm", "global_norm",
    "constant", "cosine", "linear_warmup", "wsd",
]
