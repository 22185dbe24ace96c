"""Per-tenant token-bucket rate limiting.

Port of ``predictionio_tpu/tenancy/quota.py``.  One bucket per tenant:
``rate_qps`` tokens refill per second up to ``burst``; a query costs one
token.  A tenant that exhausts its bucket is answered a structured 429
(``QuotaExceeded``) at admission, before any device work queues, so one
tenant's traffic spike cannot turn into another tenant's queue wait.
Monotonic-clock arithmetic, no background thread.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

__all__ = ["TokenBucket"]


class TokenBucket:
    """Token bucket on the monotonic clock; ``clock`` is injectable so
    quota tests are deterministic."""

    def __init__(self, rate_qps: float, burst: float | None = None,
                 clock: Callable[[], float] = time.monotonic):
        if rate_qps <= 0:
            raise ValueError(f"rate_qps must be > 0, got {rate_qps}")
        self.rate_qps = float(rate_qps)
        # default burst: one second of rate, at least 1 so a sub-1-QPS
        # tenant can serve at all
        self.burst = float(burst) if burst is not None else max(
            self.rate_qps, 1.0
        )
        if self.burst < 1.0:
            raise ValueError(f"burst must be >= 1, got {self.burst}")
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = self.burst
        self._last = clock()
        self.acquired = 0
        self.rejected = 0

    def try_acquire(self, n: float = 1.0) -> bool:
        """Take ``n`` tokens if available; never blocks."""
        now = self._clock()
        with self._lock:
            elapsed = max(now - self._last, 0.0)
            self._last = now
            self._tokens = min(
                self.burst, self._tokens + elapsed * self.rate_qps
            )
            if self._tokens >= n:
                self._tokens -= n
                self.acquired += 1
                return True
            self.rejected += 1
            return False

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "rateQps": self.rate_qps,
                "burst": self.burst,
                "tokens": round(self._tokens, 3),
                "acquired": self.acquired,
                "rejected": self.rejected,
            }
