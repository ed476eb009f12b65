"""The optimizer of the port: AdamW (exact or int8 moments), the
learning-rate schedules, the gradient utilities, and coded and
compressed gradient aggregation, as the JAX package's ``optim`` has
them."""

from repro_torch.optim.adamw import AdamWConfig, Optimizer, adamw
from repro_torch.optim.compression import (
    CompressedGrad,
    compress,
    compressed_psum,
    compression_ratio,
    decompress,
    init_residual,
)
from repro_torch.optim.grad_utils import (
    accumulate_grads,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.gradient_coding import CyclicGradientCode, coded_weights
from repro_torch.optim.schedules import constant, cosine, linear_warmup, wsd

__all__ = [
    "AdamWConfig", "Optimizer", "adamw",
    "accumulate_grads", "clip_by_global_norm", "global_norm",
    "constant", "cosine", "linear_warmup", "wsd",
    "CyclicGradientCode", "coded_weights",
    "CompressedGrad", "compress", "decompress", "init_residual",
    "compressed_psum", "compression_ratio",
]
