"""Token-bucket rate limiter for strict-mode read/write budgets
(reference: lib/common/common/src/rate_limiting.rs RateLimiter)."""

from __future__ import annotations

import threading
import time


class RateLimiter:
    """Continuous-refill token bucket: `rate_per_minute` tokens capacity,
    refilled at rate/60 per second. `try_consume` is thread-safe."""

    def __init__(self, rate_per_minute: int):
        self.rate = float(rate_per_minute)
        self.capacity = float(rate_per_minute)
        self.tokens = self.capacity
        self.updated = time.monotonic()
        self._lock = threading.Lock()

    def try_consume(self, n: float = 1.0) -> bool:
        with self._lock:
            now = time.monotonic()
            self.tokens = min(
                self.capacity, self.tokens + (now - self.updated) * self.rate / 60.0
            )
            self.updated = now
            if self.tokens >= n:
                self.tokens -= n
                return True
            return False
