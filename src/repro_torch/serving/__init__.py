"""The batched straggler-tolerant FFT service (the 1-D kinds c2c, r2c
and c2r)."""

from repro_torch.serving.batching import (
    LatencyHistogram,
    bucket_size,
    pad_requests,
)
from repro_torch.serving.decode_cache import DecodeMatrixCache
from repro_torch.serving.fft_service import (
    FFTService,
    FFTServiceConfig,
    ServiceStats,
)

__all__ = [
    "DecodeMatrixCache",
    "FFTService",
    "FFTServiceConfig",
    "LatencyHistogram",
    "ServiceStats",
    "bucket_size",
    "pad_requests",
]
