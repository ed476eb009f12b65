"""The port's language models: RWKV-6 for serving (prefill and decode)."""

from repro_torch.models.model_factory import BuiltModel, build_model

__all__ = ["BuiltModel", "build_model"]
