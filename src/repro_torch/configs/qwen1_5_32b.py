"""Qwen1.5-32B [dense] — 64L d_model=5120 40H (GQA kv=40 == MHA) d_ff=27392
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-32B family; hf-verified small sibling]

``kv_quant_decode``: the reference serves this config's decode cells
from an int8 KV cache (``init_cache(..., quantized=True)``); at batch 128
and a 32k context its bf16 cache would hold 64 x 40 x 128 x 2 values a
token, 5.5 TB in all.
"""

import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    mlp_variant="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    kv_quant_decode=True,
    notes="QKV bias; MHA (kv=40)",
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="qwen1.5-32b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    kv_quant_decode=False,
)
