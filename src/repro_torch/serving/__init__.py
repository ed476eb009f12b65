"""The batched straggler-tolerant FFT service (the 1-D kinds c2c, r2c
and c2r and the n-D kinds rfftn and irfftn), its fault-tolerant path
(typed failures, degraded results), the open-loop streaming front-end,
and the LM generation engine (RWKV-6 and the decoder-only
transformer)."""

from repro_torch.serving.batching import (
    LatencyHistogram,
    bucket_size,
    pad_requests,
)
from repro_torch.serving.decode_cache import DecodeMatrixCache
from repro_torch.serving.engine import EngineConfig, GenerationEngine
from repro_torch.serving.fft_service import (
    FAILURE_REASONS,
    DegradedResult,
    FFTService,
    FFTServiceConfig,
    ServiceError,
    ServiceStats,
)
from repro_torch.serving.serve_step import sample_token
from repro_torch.serving.streaming import (
    AdmissionError,
    StreamConfig,
    StreamingFFTService,
)

__all__ = [
    "AdmissionError",
    "DecodeMatrixCache",
    "DegradedResult",
    "EngineConfig",
    "FAILURE_REASONS",
    "FFTService",
    "FFTServiceConfig",
    "GenerationEngine",
    "LatencyHistogram",
    "ServiceError",
    "ServiceStats",
    "StreamConfig",
    "StreamingFFTService",
    "bucket_size",
    "pad_requests",
    "sample_token",
]
