"""The port's language models for serving (prefill and decode) and
training (each family's loss): RWKV-6, the decoder-only transformer
(families dense, moe and vlm), the Griffin hybrid and the
encoder-decoder."""

from repro_torch.models.model_factory import BuiltModel, build_model

__all__ = ["BuiltModel", "build_model"]
