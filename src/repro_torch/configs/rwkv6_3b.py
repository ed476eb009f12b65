"""RWKV6-3B "Finch" [ssm] — 32L d_model=2560, attention-free, d_ff=8960
vocab=65536, data-dependent decay.  [arXiv:2404.05892; hf]

head_size 64 -> 40 heads; token-shift DDLerp mixing; decay LoRA; the
channel mix is a squared-ReLU MLP.
"""

import dataclasses

from repro_torch.configs import ArchConfig, RWKVSettings

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,                  # d_model / head_size
    d_ff=8960,
    vocab_size=65536,
    rwkv=RWKVSettings(head_size=64, decay_lora=64, mix_lora=32),
    supports_long_context=True,
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="rwkv6-3b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    d_ff=128,
    vocab_size=256,
    rwkv=RWKVSettings(head_size=16, decay_lora=16, mix_lora=8),
)
