"""The port's language models for serving (prefill and decode): RWKV-6,
the decoder-only transformer (families dense, moe and vlm) and the
Griffin hybrid."""

from repro_torch.models.model_factory import BuiltModel, build_model

__all__ = ["BuiltModel", "build_model"]
