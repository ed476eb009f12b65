"""The batched straggler-tolerant FFT service (c2c slice of the port)."""

from repro_torch.serving.batching import (
    LatencyHistogram,
    bucket_size,
    pad_requests,
)
from repro_torch.serving.fft_service import (
    FFTService,
    FFTServiceConfig,
    ServiceStats,
)

__all__ = [
    "FFTService",
    "FFTServiceConfig",
    "LatencyHistogram",
    "ServiceStats",
    "bucket_size",
    "pad_requests",
]
