"""Retry with exponential backoff and full jitter, bounded by a deadline.

The retry loop of the port's egress (the HTTP forwarder): attempt,
sleep ``uniform(0, min(cap, base * 2**n))``, re-attempt — never sleeping
past the flush deadline and never exceeding the attempt budget.
Sleep/clock/rng are injectable so tests run in milliseconds. Port of
``veneur_tpu/resilience/retry.py``.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

from veneur_tpu_torch.resilience.deadline import Deadline

log = logging.getLogger("veneur.resilience.retry")

# module-level rng for jitter; callers needing determinism pass their own
_jitter_rng = random.Random()
_jitter_lock = threading.Lock()


class TransientStatusError(Exception):
    """An HTTP status worth retrying (5xx, 429) raised by an attempt
    closure so ``call_with_retry`` treats it like a transport error."""

    def __init__(self, status: int):
        super().__init__(f"transient HTTP status {status}")
        self.status = status


def is_transient_status(status: int) -> bool:
    return status == 429 or 500 <= status < 600


@dataclass(frozen=True)
class RetryPolicy:
    """Attempt budget + backoff shape. ``max_attempts`` counts the first
    try: 1 means no retries at all."""

    max_attempts: int = 3
    base_interval: float = 0.1
    max_interval: float = 10.0

    def backoff(self, retry_index: int, rng=None) -> float:
        """Full-jitter sleep before retry ``retry_index`` (0-based):
        uniform over [0, min(max_interval, base * 2**n)]."""
        cap = min(self.max_interval, self.base_interval * (2 ** retry_index))
        if rng is None:
            with _jitter_lock:
                return _jitter_rng.uniform(0.0, cap)
        return rng.uniform(0.0, cap)

    @classmethod
    def from_config(cls, cfg) -> "RetryPolicy":
        """Policy from the shared config knobs (retry_max is the number
        of RE-tries)."""
        retries = getattr(cfg, "retry_max", 2)
        if retries is None or retries < 0:  # unset sentinel
            retries = 2
        base = getattr(cfg, "retry_base_interval_seconds", 0.1) or 0.1
        return cls(max_attempts=retries + 1, base_interval=base)


def call_with_retry(fn: Callable, policy: RetryPolicy, *,
                    deadline: Optional[Deadline] = None,
                    retryable: Tuple[Type[BaseException], ...] = (OSError,),
                    retry_if: Optional[Callable[[BaseException], bool]] = None,
                    on_retry: Optional[Callable] = None,
                    rng=None, sleep: Callable[[float], None] = time.sleep):
    """Run ``fn`` with up to ``policy.max_attempts`` attempts.

    Retries only exceptions matching ``retryable`` (and ``retry_if``,
    when given); anything else propagates immediately. Backoff sleeps
    are clamped to ``deadline.remaining()`` and an expired deadline
    re-raises the last attempt's exception rather than attempting again
    — a flush must degrade, never overrun its interval. ``on_retry``
    (if given) is called as ``on_retry(retry_index, exc, pause)`` before
    each backoff sleep; the forwarder uses it to count its retries.
    """
    attempts = max(1, policy.max_attempts)
    attempt = 0
    while True:
        try:
            return fn()
        except retryable as e:
            if retry_if is not None and not retry_if(e):
                raise
            attempt += 1
            if attempt >= attempts:
                raise
            if deadline is not None and deadline.expired():
                raise
            pause = policy.backoff(attempt - 1, rng)
            if deadline is not None:
                pause = min(pause, deadline.remaining())
            if on_retry is not None:
                on_retry(attempt - 1, e, pause)
            sleep(pause)
            if deadline is not None and deadline.expired():
                raise


def post_with_retry(call: Callable[[], int], policy: RetryPolicy, *,
                    deadline: Optional[Deadline] = None,
                    on_retry: Optional[Callable] = None,
                    rng=None,
                    sleep: Callable[[float], None] = time.sleep) -> int:
    """Retry an HTTP POST closure returning a status code.

    Transport errors (``OSError``, which covers ``urllib.error.URLError``)
    and transient statuses (5xx/429) retry; the final status — transient
    or not — is RETURNED so call sites keep their existing
    log-the-status error handling, while a final transport error still
    raises.
    """

    def attempt() -> int:
        status = call()
        if is_transient_status(status):
            raise TransientStatusError(status)
        return status

    try:
        return call_with_retry(
            attempt, policy, deadline=deadline,
            retryable=(OSError, TransientStatusError),
            on_retry=on_retry, rng=rng, sleep=sleep)
    except TransientStatusError as e:
        return e.status
