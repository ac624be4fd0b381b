"""Egress resilience of the port: retries with backoff inside a flush
deadline, and a circuit breaker for the forward destination. Port of the
part of ``veneur_tpu/resilience/`` that the HTTP and native forwarders
use."""

from veneur_tpu_torch.resilience.breaker import CircuitBreaker
from veneur_tpu_torch.resilience.deadline import Deadline
from veneur_tpu_torch.resilience.retry import (RetryPolicy,
                                               call_with_retry,
                                               is_transient_status,
                                               post_with_retry)

__all__ = [
    "CircuitBreaker",
    "Deadline",
    "RetryPolicy",
    "call_with_retry",
    "is_transient_status",
    "post_with_retry",
]
