"""Request-batching helpers for the serving layer.

The FFT service pads variable request counts into power-of-two buckets so
the set of bucket shapes stays O(log cap) per request length; padded rows
are masked rather than blocking the batch.

:class:`LatencyHistogram` is a per-request latency aggregate with
log-spaced bins, so p50/p99 queries stay O(bins) without keeping
per-request samples alive.
"""

from __future__ import annotations

import math

__all__ = ["LatencyHistogram", "bucket_size", "pad_requests"]


class LatencyHistogram:
    """Log-spaced latency histogram with O(1) record and O(bins) quantiles.

    Bins cover ``LO``..``HI`` seconds at ``PER_DECADE`` bins per decade
    (~15% bin width -- one bin edge per 10^(1/16)x); out-of-range samples
    clamp to the edge bins.  Percentiles return the geometric midpoint of
    the winning bin, which is plenty for SLO reporting (p50/p99 good to a
    bin width) without the memory of a per-request sample list.  The TOP
    bin is the exception: samples past ``HI`` clamp into it, so its
    midpoint would silently underreport an outlier (a 2000 s stall as
    ~760 s); a percentile landing there reports the tracked ``max``
    instead.
    """

    LO = 1e-6          # 1 us
    HI = 1e3           # 1000 s
    PER_DECADE = 16

    def __init__(self):
        decades = int(round(math.log10(self.HI / self.LO)))
        self.counts = [0] * (decades * self.PER_DECADE + 1)
        self.n = 0
        self.total = 0.0
        self.max = 0.0

    def record(self, seconds: float) -> None:
        s = max(float(seconds), 0.0)
        if s > 0.0:
            b = int((math.log10(s) - math.log10(self.LO)) * self.PER_DECADE)
            b = min(max(b, 0), len(self.counts) - 1)
        else:
            b = 0
        self.counts[b] += 1
        self.n += 1
        self.total += s
        self.max = max(self.max, s)

    def percentile(self, q: float) -> float:
        """The ``q``-th percentile (0..100) in seconds (NaN when empty)."""
        if self.n == 0:
            return float("nan")
        rank = max(1, math.ceil(q / 100.0 * self.n))
        seen = 0
        for b, cnt in enumerate(self.counts):
            seen += cnt
            if seen >= rank:
                if b == len(self.counts) - 1:
                    # clamp bin: anything >= HI lands here, so the bin
                    # midpoint is a lie -- report the true maximum
                    return self.max
                lo = self.LO * 10 ** (b / self.PER_DECADE)
                return lo * 10 ** (0.5 / self.PER_DECADE)
        return self.max

    def summary(self) -> dict:
        return {
            "count": self.n,
            "mean_s": self.total / self.n if self.n else float("nan"),
            "p50_s": self.percentile(50.0),
            "p99_s": self.percentile(99.0),
            "max_s": self.max,
        }


def bucket_size(n: int, cap: int) -> int:
    """Smallest power-of-two >= ``n``, clamped to ``cap``.

    Keeps the set of bucket shapes to O(log cap) per request shape.
    """
    if n <= 0:
        raise ValueError("need at least one request")
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def pad_requests(requests: list, bucket: int, filler):
    """Pad ``requests`` to ``bucket`` entries with ``filler()`` copies.

    Returns ``(padded_list, n_live)``.  Raises if the bucket is too small.
    """
    n_live = len(requests)
    if n_live > bucket:
        raise ValueError(f"{n_live} requests exceed bucket size {bucket}")
    return list(requests) + [filler() for _ in range(bucket - n_live)], n_live
