"""PaliGemma-3B [vlm] — SigLIP vision tower (STUB) + Gemma-2B backbone:
18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216.  [arXiv:2407.07726; hf]

The SigLIP frontend is a stub per the assignment: ``input_specs`` provides
256 precomputed patch embeddings (B, 256, d_model) prepended to the text
tokens with PaliGemma's prefix-LM mask (bidirectional prefix, causal suffix).
"""

import dataclasses
import math

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    mlp_variant="geglu",
    tie_embeddings=True,
    emb_multiplier=math.sqrt(2048.0),
    num_prefix_tokens=256,
    frontend="vision_patches",
    notes="SigLIP stub + gemma backbone; prefix-LM attention",
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="paligemma-3b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    emb_multiplier=math.sqrt(64.0),
    num_prefix_tokens=8,
)
