"""Deterministic, seeded fault injection.

Port of ``veneur_tpu/resilience/faults.py``: the schedule is a pure
function of ``(seed, call index)``, so two runs with the same seed see
the same faults at the same calls whatever the pass/fail pattern in
between. ``scope`` substring-filters the operation names callers pass
(``forward.http``, ``sink.datadog``, ``proxy.post``, ``ingest.statsd``,
``checkpoint.write``, ...), so a run can target one path at a time.

What the port wires, where the JAX package does, each consumer with an
injector of its own built from the same ``fault_injection_*`` keys:

* the transports (``connect``, ``timeout``, ``http_5xx``,
  ``partial_write``): :meth:`FaultInjector.wrap_post` around the HTTP
  forward's POST (``forward.http``), the Datadog sink's
  (``sink.datadog``), the SignalFx sink's submits (``sink.signalfx``)
  and the proxy's fan-out (``proxy.post``); :meth:`FaultInjector.maybe_fail`
  before each gRPC frame (``forward.grpc``) and each ``native://``
  attempt (``forward.native``). An injected fault rides the same retry,
  breaker and deadline as a real one;
* the ingest kinds (``truncate``, ``burst``):
  :meth:`FaultInjector.mangle_packet` on each datagram of a Server's
  per-datagram Python path (``Server.handle_packet``); the ingest lanes
  and the C++ reader pools do not take them;
* membership churn (``member_add``, ``member_remove``, ``partition``):
  :meth:`FaultInjector.mangle_members` on each discovery refresh of the
  proxy and of a global's handoff ``RingWatcher``, and
  :meth:`FaultInjector.is_partitioned` before each fan-out, handoff and
  replication send;
* the host-resource kinds: ``disk_full`` on the checkpoint and handoff
  spool commits (:meth:`FaultInjector.wrap_write`) and
  ``deadline_pressure`` on the flush's egress budget
  (:meth:`FaultInjector.scale_deadline`);
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
# the ingest kinds (mangle_packet): a datagram cut mid-line, and one
# datagram amplified into a burst
KIND_TRUNCATE = "truncate"
KIND_BURST = "burst"
INGEST_KINDS = (KIND_TRUNCATE, KIND_BURST)
BURST_MAX_COPIES = 8
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
# an interval under deadline_pressure keeps this share of its budget
DEADLINE_PRESSURE_FACTOR = 0.05

# the status wrap_post returns for an injected 5xx
INJECTED_STATUS = 503


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

    def wrap_post(self, post: Callable[..., int],
                  op: str) -> Callable[..., int]:
        """Wrap a post-style callable returning an HTTP status: an
        injected 5xx returns ``INJECTED_STATUS`` without touching the
        real transport; connect, timeout and partial write raise before
        it. Other kinds pass through to the real post."""

        def wrapped(*args, **kwargs) -> int:
            kind = self.should_fail(op)
            if kind == KIND_HTTP_5XX:
                return INJECTED_STATUS
            if kind == KIND_CONNECT:
                raise InjectedConnectError(f"injected connect error ({op})")
            if kind == KIND_TIMEOUT:
                raise InjectedTimeout(f"injected timeout ({op})")
            if kind == KIND_PARTIAL_WRITE:
                raise InjectedPartialWrite(f"injected partial write ({op})")
            return post(*args, **kwargs)

        return wrapped

    def mangle_packet(self, op: str, data: bytes) -> List[bytes]:
        """The datagram(s) the pipeline should see under the scheduled
        ingest fault: ``[data]`` untouched without one, the datagram cut
        at a seeded offset under ``truncate`` (mid-line, as the OS cuts
        it), 2..``BURST_MAX_COPIES`` copies under ``burst``. Other kinds
        pass the datagram through. An applied fault takes one more
        seeded draw (the cut or the copy count) under the same lock, so
        the schedule holds across thread interleavings."""
        kind = self.should_fail(op)
        if kind == KIND_TRUNCATE and len(data) > 1:
            with self._lock:
                cut = self._rng.randrange(1, len(data))
            return [data[:cut]]
        if kind == KIND_BURST:
            with self._lock:
                copies = self._rng.randrange(2, BURST_MAX_COPIES + 1)
            return [data] * copies
        return [data]

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


def _configured_kinds(cfg) -> Tuple[str, ...]:
    # CSV order: the kind tuple indexes the seeded schedule
    return tuple(k.strip() for k in (cfg.fault_injection_kinds or "")
                 .split(",") if k.strip())


def armed_for(cfg, family: Sequence[str]) -> Optional[FaultInjector]:
    """An injector of its own for the consumer of one kind family
    (``INGEST_KINDS``, ``CHURN_KINDS`` or ``SOAK_KINDS``), or None: built
    from the ``fault_injection_*`` keys only when the rate is above 0 and
    a configured kind is of ``family``, as the JAX package arms its
    ingest, soak and churn injectors."""
    kinds = _configured_kinds(cfg)
    if cfg.fault_injection_rate <= 0 or not any(k in family for k in kinds):
        return None
    return FaultInjector(rate=cfg.fault_injection_rate,
                         seed=cfg.fault_injection_seed, kinds=kinds,
                         scope=cfg.fault_injection_scope)


def from_config(cfg) -> Optional[FaultInjector]:
    """The configured injector, or None when fault injection is off (the
    default: rate 0). The kinds keep their CSV order, which indexes the
    seeded schedule."""
    rate = float(cfg.fault_injection_rate or 0.0)
    if rate <= 0.0:
        return None
    kinds = _configured_kinds(cfg) or ALL_KINDS
    injector = FaultInjector(rate=rate, seed=int(cfg.fault_injection_seed),
                             kinds=kinds, scope=cfg.fault_injection_scope)
    log.warning("fault injection ACTIVE: rate=%.2f seed=%d kinds=%s "
                "scope=%r; this instance will deliberately fail",
                injector.rate, injector.seed, ",".join(injector.kinds),
                injector.scope)
    return injector
