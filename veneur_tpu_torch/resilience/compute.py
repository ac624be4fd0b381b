"""The compute breaker: the flush kernel's ladder.

Port of ``veneur_tpu/resilience/compute.py``. A failure of the t-digest
merge kernel (``ops/tdigest_cuda.py``, K1/K2) at launch must delay the
interval, not lose it:

    rung 1  the CUDA kernel             (breaker closed, or its
                                         half-open probe)
    rung 3  re-merge the retired        (``MetricStore._requeue_group``:
            generation into the live     the interval emits late, at the
            store                        next flush; the checkpoint
                                         persists it on its cadence)

The JAX package's rung 2 (the same program on XLA instead of Pallas)
has no counterpart: a CUDA tensor reaches the kernel or nothing, so a
broken kernel shows as a requeued interval and a degraded readiness,
never as a quiet switch to a slower path.

``failure_threshold`` consecutive rung-1 failures open the kernel's
breaker: later flushes re-merge their digest groups without a launch.
After ``reset_timeout`` one flush probes the kernel again, and a success
closes the breaker, emitting every interval held meanwhile. Rung 3 is
counted in ``requeued_total``, a generation that no rung saved in
``lost_total``. ``Server.degradation()`` names an open breaker.

What the ladder cannot cover: the kernel library is loaded when a
Server starts on the card, so a build or load failure raises there; and
a fault inside a running kernel (an illegal address) poisons the CUDA
context, so the re-merge fails too and the last checkpoint bounds the
loss.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Tuple

from veneur_tpu_torch.resilience.breaker import BreakerRegistry

# the one governed kernel family: the t-digest merge every digest drain
# and flush launches
KERNEL_TDIGEST = "compute.tdigest_merge"

DEFAULT_FAILURE_THRESHOLD = 2
DEFAULT_RESET_TIMEOUT = 60.0


class ComputeBreaker:
    """Thread-safe per-kernel breakers plus the ladder's tallies."""

    def __init__(self, failure_threshold: int = DEFAULT_FAILURE_THRESHOLD,
                 reset_timeout: float = DEFAULT_RESET_TIMEOUT,
                 clock: Callable[[], float] = time.monotonic):
        self._registry = BreakerRegistry(
            failure_threshold=max(1, failure_threshold),
            reset_timeout=reset_timeout, half_open_max=1, clock=clock)
        self._lock = threading.Lock()
        # deterministic fault hook (resilience/faults.py): when set,
        # ``preflight`` consults it before every rung-1 launch
        self.injector = None
        self.requeued_total = 0   # rung 3: generations re-merged, late
        self.lost_total = 0       # every rung failed

    def probe(self, kernel: str = KERNEL_TDIGEST) -> bool:
        """May this flush try the kernel now? Consumes the half-open
        probe, so only the flush path calls it."""
        return self._registry.get(kernel).allow()

    def preflight(self, kernel: str = KERNEL_TDIGEST) -> None:
        """Raise the scheduled injected fault, if an injector is armed,
        before the launch."""
        inj = self.injector
        if inj is not None:
            inj.maybe_fail(kernel)

    def record_success(self, kernel: str = KERNEL_TDIGEST) -> None:
        self._registry.get(kernel).record_success()

    def record_failure(self, kernel: str = KERNEL_TDIGEST) -> None:
        self._registry.get(kernel).record_failure()

    def count_requeued(self, n: int = 1) -> None:
        with self._lock:
            self.requeued_total += n

    def count_lost(self, n: int = 1) -> None:
        with self._lock:
            self.lost_total += n

    def states(self) -> List[Tuple[str, float]]:
        """(kernel, state gauge) pairs; empty until a kernel has been
        consulted once."""
        return self._registry.states()

    def snapshot(self) -> dict:
        return {"kernels": dict(self.states()),
                "requeued_total": self.requeued_total,
                "lost_total": self.lost_total}


def from_config(cfg, clock: Callable[[], float] = time.monotonic
                ) -> ComputeBreaker:
    """The configured compute breaker (always on: the keys only tune
    it)."""
    return ComputeBreaker(
        failure_threshold=cfg.compute_breaker_failure_threshold,
        reset_timeout=cfg.compute_breaker_reset_timeout_seconds,
        clock=clock)
