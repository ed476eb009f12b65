"""MiniCPM-2B [dense] — 40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753,
llama-like with muP-style scaling + WSD schedule.  [arXiv:2404.06395; hf]

MiniCPM specifics implemented: scale_emb=12 on the embedding output,
residual branch scale scale_depth/sqrt(L) = 1.4/sqrt(40), logits divided by
d_model/dim_base = 2304/256 = 9, tied embeddings.  The WSD (warmup-stable-
decay) LR schedule belongs to training, which the port has not yet.
"""

import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    mlp_variant="swiglu",
    tie_embeddings=True,
    emb_multiplier=12.0,
    logit_divisor=2304 / 256,
    depth_scale=1.4,
    notes="WSD schedule (training); muP-ish scaling",
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="minicpm-2b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    logit_divisor=64 / 256,
)
