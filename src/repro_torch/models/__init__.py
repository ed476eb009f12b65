"""The port's language models for serving (prefill and decode): RWKV-6
and the decoder-only transformer (families dense and vlm)."""

from repro_torch.models.model_factory import BuiltModel, build_model

__all__ = ["BuiltModel", "build_model"]
