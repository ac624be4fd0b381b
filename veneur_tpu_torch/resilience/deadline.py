"""Flush-interval deadline propagation.

A ``Deadline`` is a point in monotonic time created once per flush and
threaded through the forwarder so that *no* retry loop can push a flush
past the interval boundary: every backoff sleep is clamped to
``remaining()`` and every per-attempt socket timeout is clamped with
``clamp()``. The clock is injectable so backoff and expiry tests run in
milliseconds. Port of ``veneur_tpu/resilience/deadline.py``.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

# a socket timeout of exactly 0 means non-blocking (instant failure with
# a confusing error); an expired deadline clamps to this floor instead
# so the failure surfaces as an ordinary timeout
_MIN_TIMEOUT = 1e-3


class Deadline:
    """An absolute point in (monotonic) time a flush must not cross."""

    __slots__ = ("_at", "_clock")

    def __init__(self, at: Optional[float],
                 clock: Callable[[], float] = time.monotonic):
        self._at = at
        self._clock = clock

    @classmethod
    def after(cls, seconds: float,
              clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return cls(clock() + seconds, clock)

    def remaining(self) -> float:
        if self._at is None:
            return float("inf")
        return max(0.0, self._at - self._clock())

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def clamp(self, timeout: float) -> float:
        """A per-attempt timeout that cannot outlive the deadline."""
        return max(_MIN_TIMEOUT, min(timeout, self.remaining()))
