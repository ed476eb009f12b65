"""Whisper-medium [audio] — enc-dec, 24+24L d_model=1024 16H (kv=16)
d_ff=4096 vocab=51865.  [arXiv:2212.04356]

Pre-LN transformer, LayerNorm (not RMS), GELU MLP with biases,
sinusoidal positions in both stacks, no RoPE, tied unembedding.  The
conv frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings (B, T, d_model); the real model's window is
1500 frames and its text context 448 tokens.
"""

import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,                 # decoder layers
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    mlp_variant="gelu",
    norm="ln",
    tie_embeddings=True,
    frontend="audio_frames",
    notes="enc-dec; conv frontend stubbed to precomputed frame embeddings",
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="whisper-medium-reduced",
    n_layers=2,
    encoder_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
)
