"""The port's synthetic LM data pipeline."""

from repro_torch.data.pipeline import SyntheticLMData, make_pipeline

__all__ = ["SyntheticLMData", "make_pipeline"]
