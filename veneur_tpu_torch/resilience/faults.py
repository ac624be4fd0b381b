"""Deterministic, seeded fault injection.

Port of ``veneur_tpu/resilience/faults.py``: the schedule is a pure
function of ``(seed, call index)``, so two runs with the same seed see
the same faults at the same calls whatever the pass/fail pattern in
between. ``scope`` substring-filters the operation names callers pass
(``checkpoint.write``, ``flush.deadline``, ``compute.tdigest_merge``).

What the port wires:

* a Server's config keys ``fault_injection_*`` build one injector
  (:func:`from_config`) for the two host-resource faults: ``disk_full``
  on the checkpoint commit (:meth:`FaultInjector.wrap_write`) and
  ``deadline_pressure`` on the flush's egress budget
  (:meth:`FaultInjector.scale_deadline`);
* a proxy's build one for membership churn (``member_add``,
  ``member_remove``, ``partition``): :meth:`FaultInjector.mangle_members`
  on each discovery refresh (``proxy/proxy.py``, and
  ``discovery.RingWatcher`` when a caller passes it one),
  :meth:`FaultInjector.is_partitioned` before each fan-out send;
* ``config.py`` refuses the other kinds, whose hooks (the transports'
  ``wrap_post``, the ingest mangle) are not ported yet;
* the compute ladder's ``preflight`` (``resilience/compute.py``) raises
  through :meth:`FaultInjector.maybe_fail` when a caller arms the
  breaker's ``injector``, as the JAX package's tests do.

The four kind vocabularies are kept whole: the kind tuple indexes the
seeded schedule, so a kind set reproduces the JAX package's schedule.
"""

from __future__ import annotations

import errno
import logging
import random
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

log = logging.getLogger("veneur.resilience.faults")

KIND_CONNECT = "connect"
KIND_TIMEOUT = "timeout"
KIND_HTTP_5XX = "http_5xx"
KIND_PARTIAL_WRITE = "partial_write"
ALL_KINDS = (KIND_CONNECT, KIND_TIMEOUT, KIND_HTTP_5XX, KIND_PARTIAL_WRITE)
INGEST_KINDS = ("truncate", "burst")
KIND_MEMBER_ADD = "member_add"
KIND_MEMBER_REMOVE = "member_remove"
KIND_PARTITION = "partition"
CHURN_KINDS = (KIND_MEMBER_ADD, KIND_MEMBER_REMOVE, KIND_PARTITION)
# refreshes (mangle_members calls) a partition black-holes its member
PARTITION_INTERVALS = 3
KIND_DISK_FULL = "disk_full"
KIND_DEADLINE_PRESSURE = "deadline_pressure"
SOAK_KINDS = (KIND_DISK_FULL, KIND_DEADLINE_PRESSURE)
KNOWN_KINDS = ALL_KINDS + INGEST_KINDS + CHURN_KINDS + SOAK_KINDS
# the kinds the port may arm (see the module docstring): a Server's
# config the soak kinds, a proxy's the churn kinds (its discovery refresh)
SERVER_KINDS = SOAK_KINDS
PROXY_KINDS = CHURN_KINDS
PORTED_KINDS = CHURN_KINDS + SOAK_KINDS
# an interval under deadline_pressure keeps this share of its budget
DEADLINE_PRESSURE_FACTOR = 0.05


class InjectedFault(Exception):
    """Marker mixin so logs can tell injected from real faults."""


class InjectedConnectError(InjectedFault, ConnectionRefusedError):
    pass


class InjectedTimeout(InjectedFault, TimeoutError):
    pass


class InjectedPartialWrite(InjectedFault, BrokenPipeError):
    pass


class FaultInjector:
    """A seeded fault schedule over a stream of operations."""

    def __init__(self, rate: float, seed: int = 0,
                 kinds: Sequence[str] = ALL_KINDS, scope: str = ""):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"fault rate must be in [0, 1], got {rate}")
        bad = [k for k in kinds if k not in KNOWN_KINDS]
        if bad:
            raise ValueError(f"unknown fault kinds {bad}; known: "
                             f"{list(KNOWN_KINDS)}")
        self.rate = rate
        self.seed = seed
        self.kinds = tuple(kinds) or ALL_KINDS
        self.scope = scope
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.calls = 0
        self.injected: Dict[str, int] = {k: 0 for k in self.kinds}
        # partitioned member -> refreshes left before it heals
        self._partitions: Dict[str, int] = {}

    def should_fail(self, op: str) -> Optional[str]:
        """The kind to inject for this call, or None. Exactly two rng
        draws per in-scope call, fail or not, so the schedule depends
        only on the seed and the call index."""
        if self.scope and self.scope not in op:
            return None
        with self._lock:
            self.calls += 1
            roll = self._rng.random()
            kind = self.kinds[self._rng.randrange(len(self.kinds))]
            if roll >= self.rate:
                return None
            self.injected[kind] += 1
        log.debug("injecting %s fault into %s (call %d)", kind, op,
                  self.calls)
        return kind

    def maybe_fail(self, op: str) -> None:
        """Raise the scheduled transport fault, if any (an injected 5xx
        as an OSError). Ingest, churn and soak kinds pass through: a
        mixed-kind injector must not turn them into a transport error."""
        kind = self.should_fail(op)
        if kind is None or kind not in ALL_KINDS:
            return
        if kind == KIND_CONNECT:
            raise InjectedConnectError(f"injected connect error ({op})")
        if kind == KIND_TIMEOUT:
            raise InjectedTimeout(f"injected timeout ({op})")
        if kind == KIND_PARTIAL_WRITE:
            raise InjectedPartialWrite(f"injected partial write ({op})")
        raise OSError(f"injected upstream 5xx ({op})")

    def mangle_members(self, op: str, members: List[str]) -> List[str]:
        """One discovery refresh's membership as the ring consumer should
        see it under the scheduled churn fault: ``member_add`` appends a
        synthetic black-hole member, ``member_remove`` drops a seeded
        member (never the last), ``partition`` leaves the list as it is
        but black-holes a seeded member for ``PARTITION_INTERVALS``
        refreshes (:meth:`is_partitioned`). One call is one refresh:
        live partitions tick down here. Other kinds pass through."""
        with self._lock:
            for dest in list(self._partitions):
                self._partitions[dest] -= 1
                if self._partitions[dest] <= 0:
                    del self._partitions[dest]
        kind = self.should_fail(op)
        if kind == KIND_MEMBER_ADD:
            with self._lock:
                idx = self._rng.randrange(1 << 16)
            return list(members) + [f"fault://injected-{idx}"]
        if kind == KIND_MEMBER_REMOVE and len(members) > 1:
            with self._lock:
                idx = self._rng.randrange(len(members))
            return [m for i, m in enumerate(members) if i != idx]
        if kind == KIND_PARTITION and members:
            with self._lock:
                idx = self._rng.randrange(len(members))
                self._partitions[members[idx]] = PARTITION_INTERVALS
        return list(members)

    def is_partitioned(self, dest: str) -> bool:
        """Whether a scheduled ``partition`` black-holes ``dest`` now."""
        with self._lock:
            return dest in self._partitions

    def wrap_write(self, write: Callable[..., int],
                   op: str) -> Callable[..., int]:
        """Wrap a ``write_atomic``-style callable (``persist/format.py``):
        a scheduled ``disk_full`` raises ENOSPC before any byte touches
        the file system; other kinds pass through."""

        def wrapped(*args, **kwargs) -> int:
            if self.should_fail(op) == KIND_DISK_FULL:
                raise OSError(errno.ENOSPC, f"injected disk full ({op})")
            return write(*args, **kwargs)

        return wrapped

    def scale_deadline(self, op: str, budget: float) -> float:
        """One interval's egress budget: as configured, or
        ``DEADLINE_PRESSURE_FACTOR`` of it when a scheduled
        ``deadline_pressure`` fires (one call an interval)."""
        if self.should_fail(op) == KIND_DEADLINE_PRESSURE:
            log.warning("deadline pressure injected: flush budget "
                        "%.2fs -> %.2fs (%s)", budget,
                        budget * DEADLINE_PRESSURE_FACTOR, op)
            return budget * DEADLINE_PRESSURE_FACTOR
        return budget

    def schedule(self, n: int) -> Tuple[Optional[str], ...]:
        """The next ``n`` outcomes, consumed (tests assert determinism)."""
        return tuple(self.should_fail("schedule") for _ in range(n))


def from_config(cfg) -> Optional[FaultInjector]:
    """The configured injector, or None when fault injection is off (the
    default: rate 0). The kinds keep their CSV order, which indexes the
    seeded schedule."""
    rate = float(cfg.fault_injection_rate or 0.0)
    if rate <= 0.0:
        return None
    kinds = tuple(k.strip() for k in
                  (cfg.fault_injection_kinds or "").split(",")
                  if k.strip()) or ALL_KINDS
    injector = FaultInjector(rate=rate, seed=int(cfg.fault_injection_seed),
                             kinds=kinds, scope=cfg.fault_injection_scope)
    log.warning("fault injection ACTIVE: rate=%.2f seed=%d kinds=%s "
                "scope=%r; this instance will deliberately fail",
                injector.rate, injector.seed, ",".join(injector.kinds),
                injector.scope)
    return injector
