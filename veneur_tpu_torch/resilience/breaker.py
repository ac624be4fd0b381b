"""A destination's circuit breaker.

Classic closed → open → half-open automaton: ``failure_threshold``
consecutive failures trip the breaker; while open every ``allow()`` is
rejected instantly (a black-holed destination costs nothing per flush
instead of a full timeout); after ``reset_timeout`` the breaker admits
``half_open_max`` probe requests — one success closes it, one failure
re-opens it and restarts the timer.

Port of ``veneur_tpu/resilience/breaker.py``: the breaker the HTTP
forwarder uses, and the registry of breakers by name that the compute
ladder keys by kernel (``resilience/compute.py``). The state reads as a
gauge: 0 closed, 1 half-open, 2 open.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Tuple

log = logging.getLogger("veneur.resilience.breaker")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_GAUGE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


class CircuitBreaker:
    """One destination's failure automaton. Thread-safe; the forwarder
    shares its breaker across per-flush threads."""

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout: float = 30.0, half_open_max: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = ""):
        self.failure_threshold = max(1, failure_threshold)
        self.reset_timeout = reset_timeout
        self.half_open_max = max(1, half_open_max)
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probes = 0
        # lifetime counters for tests and telemetry
        self.rejections = 0
        self.trips = 0

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def state_gauge(self) -> float:
        """0 = closed, 1 = half-open, 2 = open."""
        return _STATE_GAUGE[self.state]

    def _maybe_half_open(self) -> None:
        # caller holds self._lock
        if (self._state == OPEN
                and self._clock() - self._opened_at >= self.reset_timeout):
            self._state = HALF_OPEN
            self._probes = 0

    def _trip(self) -> None:
        # caller holds self._lock
        self._state = OPEN
        self._opened_at = self._clock()
        self._probes = 0
        self.trips += 1
        log.warning("circuit breaker for %s opened after %d consecutive "
                    "failures", self.name or "destination", self._failures)

    def allow(self) -> bool:
        """May a request go out right now? Counts half-open probes."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and self._probes < self.half_open_max:
                self._probes += 1
                return True
            self.rejections += 1
            return False

    def blocked(self) -> bool:
        """True iff the breaker is OPEN (not ready for a probe). Unlike
        ``allow`` this never consumes a half-open probe, so the forwarder
        can reject BEFORE paying serialization cost. Counted as a
        rejection when True."""
        with self._lock:
            self._maybe_half_open()
            if self._state == OPEN:
                self.rejections += 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state != CLOSED:
                log.info("circuit breaker for %s closed",
                         self.name or "destination")
            self._state = CLOSED

    def record_failure(self) -> None:
        with self._lock:
            self._maybe_half_open()
            if self._state == HALF_OPEN:
                # a failed probe re-opens and restarts the reset timer
                self._trip()
                return
            self._failures += 1
            if self._state == CLOSED and \
                    self._failures >= self.failure_threshold:
                self._trip()


class BreakerRegistry:
    """Breakers by name, created on demand with one configuration (the
    compute ladder keys it by kernel)."""

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout: float = 30.0, half_open_max: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self.half_open_max = half_open_max
        self._clock = clock
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}

    def get(self, name: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(name)
            if b is None:
                b = CircuitBreaker(
                    failure_threshold=self.failure_threshold,
                    reset_timeout=self.reset_timeout,
                    half_open_max=self.half_open_max,
                    clock=self._clock, name=name)
                self._breakers[name] = b
            return b

    def retain(self, names) -> None:
        """Drop the breakers of names no longer in ``names`` (the proxy
        calls it on each discovery refresh, so ring churn cannot grow
        the registry without bound)."""
        keep = set(names)
        with self._lock:
            for name in list(self._breakers):
                if name not in keep:
                    del self._breakers[name]

    def states(self) -> List[Tuple[str, float]]:
        """(name, state gauge) of every breaker consulted so far."""
        with self._lock:
            breakers = list(self._breakers.items())
        return [(name, b.state_gauge()) for name, b in breakers]
