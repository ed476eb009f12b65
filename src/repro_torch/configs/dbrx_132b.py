"""DBRX-132B [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4 (fine-grained).  [hf:databricks/dbrx-base]
"""

import dataclasses

from repro_torch.configs import ArchConfig, MoESettings

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    mlp_variant="swiglu",
    rope_theta=500_000.0,
    moe=MoESettings(
        num_experts=16,
        top_k=4,
        d_ff_expert=10752,
        interleave_step=1,
    ),
    notes="16 experts top-4, every layer MoE",
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="dbrx-132b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    moe=MoESettings(num_experts=4, top_k=2, d_ff_expert=128, interleave_step=1),
)
