"""The batched straggler-tolerant FFT service (the 1-D kinds c2c, r2c
and c2r), and the LM generation engine (RWKV-6)."""

from repro_torch.serving.batching import (
    LatencyHistogram,
    bucket_size,
    pad_requests,
)
from repro_torch.serving.decode_cache import DecodeMatrixCache
from repro_torch.serving.engine import EngineConfig, GenerationEngine
from repro_torch.serving.fft_service import (
    FFTService,
    FFTServiceConfig,
    ServiceStats,
)
from repro_torch.serving.serve_step import sample_token

__all__ = [
    "DecodeMatrixCache",
    "EngineConfig",
    "FFTService",
    "FFTServiceConfig",
    "GenerationEngine",
    "LatencyHistogram",
    "ServiceStats",
    "bucket_size",
    "pad_requests",
    "sample_token",
]
