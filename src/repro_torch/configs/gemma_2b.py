"""Gemma-2B [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000,
GeGLU, head_dim=256, sqrt(d_model) embedding scaling.  [arXiv:2403.08295; hf]
"""

import dataclasses
import math

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_variant="geglu",
    tie_embeddings=True,
    emb_multiplier=math.sqrt(2048.0),
    notes="GeGLU; MQA; head_dim 256; zero-centered RMSNorm",
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="gemma-2b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    emb_multiplier=math.sqrt(64.0),
)
