"""Qwen2.5-14B [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064, QKV bias.  [hf:Qwen/Qwen2.5 family; hf-verified small sibling]
"""

import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    mlp_variant="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    notes="GQA kv=8; QKV bias",
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="qwen2.5-14b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
)
