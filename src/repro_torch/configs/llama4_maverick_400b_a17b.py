"""Llama-4 Maverick 400B-A17B [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 (expert) vocab=202048, MoE 128 experts top-1 + 1 shared expert,
MoE on every second layer (interleave_moe_layer_step=2), early fusion.
[hf:meta-llama/Llama-4-* family]

About 400B parameters (800 GB in bf16): one 80 GB card holds a cut of its
depth, not the whole model.
"""

import dataclasses

from repro_torch.configs import ArchConfig, MoESettings

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,                   # dense layers' FFN width
    vocab_size=202048,
    mlp_variant="swiglu",
    rope_theta=500_000.0,
    moe=MoESettings(
        num_experts=128,
        top_k=1,
        d_ff_expert=8192,
        interleave_step=2,         # alternate dense / MoE
        num_shared_experts=1,
    ),
    notes="MoE 128e top-1 + shared expert, alternating layers; early fusion",
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="llama4-maverick-reduced",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=256,
    moe=MoESettings(
        num_experts=4, top_k=1, d_ff_expert=128, interleave_step=2,
        num_shared_experts=1,
    ),
)
