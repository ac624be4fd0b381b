"""Resilience of the port: retries with backoff inside a flush deadline,
circuit breakers (the forward destination's, and the compute breaker of
the flush kernel's compute ladder), and seeded fault injection. Port of
``veneur_tpu/resilience/``; see each module for what it covers."""

from veneur_tpu_torch.resilience.breaker import (BreakerRegistry,
                                                 CircuitBreaker)
from veneur_tpu_torch.resilience.compute import ComputeBreaker
from veneur_tpu_torch.resilience.deadline import Deadline
from veneur_tpu_torch.resilience.faults import FaultInjector
from veneur_tpu_torch.resilience.retry import (RetryPolicy,
                                               call_with_retry,
                                               is_transient_status,
                                               post_with_retry)

__all__ = [
    "BreakerRegistry",
    "CircuitBreaker",
    "ComputeBreaker",
    "Deadline",
    "FaultInjector",
    "RetryPolicy",
    "call_with_retry",
    "is_transient_status",
    "post_with_retry",
]
