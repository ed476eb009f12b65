"""RecurrentGemma-9B [hybrid] — 38L d_model=4096 16H (MQA kv=1, head_dim 256)
d_ff=12288 vocab=256000.  RG-LRU + local attention, pattern (rec, rec, attn).
[arXiv:2402.19427 (Griffin) + RecurrentGemma report]

38 = 12 x (rec, rec, attn) + 2 trailing rec layers.  Local attention window
2048; RG-LRU width = d_model; GeGLU MLP; sqrt(d) embedding scale.
"""

import dataclasses
import math

from repro_torch.configs import ArchConfig, RecurrentSettings

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    mlp_variant="geglu",
    tie_embeddings=True,
    emb_multiplier=math.sqrt(4096.0),
    attn_window=2048,
    recurrent=RecurrentSettings(
        d_rnn=4096,
        conv_width=4,
        block_pattern=("rec", "rec", "attn"),
    ),
    notes="RG-LRU + local attn 1:2; window 2048",
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="recurrentgemma-9b-reduced",
    n_layers=5,                   # (rec, rec, attn) + 2 rec tail
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    emb_multiplier=math.sqrt(64.0),
    attn_window=16,
    recurrent=RecurrentSettings(d_rnn=64, conv_width=4),
)
