"""Hot-path overload governance: admission watermarks + quarantine ledger.

Port of ``veneur_tpu/overload.py``. When the pipeline saturates, the
cheapest-to-lose work is shed first and every drop is counted. The
ladder, lowest priority first:

    1. freshly-seen series   (level >= 1: first-sight series spill to the
                              per-group overflow row; existing series
                              keep aggregating)
    2. raw spans             (level >= 2: SSF datagrams and spans shed at
                              the reader loop and the span channel)
    3. statsd datagrams      (level >= 3, the hard ceiling: aggregate
                              traffic sheds at the socket)

Forwarded sketch state (the import pool has its own bounded queue and
429 shedding) is never governed here.

The pressure signal is the max of the span-channel fill ratio, the span
sinks' ingest-lane fill ratios, every ingest fleet's backlog ratio, and
each store group's occupancy against its ``max_series`` cap (clamped to
the freeze tier). All reads are lock-free snapshots, and the level is
recomputed at most every ``recompute_interval`` seconds, so ``admit_*``
costs an attribute read on the packet path.

The shed, spill and quarantine tallies live on the objects
(``OverloadController.shed``, each group's ``spilled``, the store's
``Quarantine``); the port has no self-telemetry to emit them yet.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict

log = logging.getLogger("veneur.overload")

# the single per-group spill row new series collapse into past max_series
OVERFLOW_NAME = "veneur.overload.overflow"

# series under this prefix are the operator's view into an overload: the
# first-sight freeze (level >= 1) never applies to them; the hard
# per-group cap still does
SELF_TELEMETRY_PREFIX = "veneur."


def freeze_exempt(name: str) -> bool:
    """True when a first-sight series must survive the admission freeze
    (the ``veneur.*`` carve-out)."""
    return name.startswith(SELF_TELEMETRY_PREFIX)


# the float32 bound the quarantine enforces: past it a value would
# launder into inf in digest staging
F32_ABS_MAX = 3.4028235e38
# smallest admissible sample rate: below it the float32 reciprocal
# weight (1/rate) overflows to inf
MIN_SAMPLE_RATE = 1e-38

LEVEL_NORMAL = 0
LEVEL_SHED_NEW_SERIES = 1
LEVEL_SHED_SPANS = 2
LEVEL_SHED_PACKETS = 3

DEFAULT_LOW_WATERMARK = 0.7
DEFAULT_HIGH_WATERMARK = 0.85
DEFAULT_HARD_WATERMARK = 0.97
DEFAULT_MAX_SERIES = 1 << 20
DEFAULT_MAX_TAG_LENGTH = 1024


class Quarantine:
    """Per-reason counters of input that was caught instead of laundered
    into sketch state: the groups, the batch path and the ingest lanes'
    ledgers count into it. Thread-safe; the reasons are a small fixed
    vocabulary."""

    REASONS = ("not_finite", "out_of_range", "bad_rate", "oversized_tags")

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {r: 0 for r in self.REASONS}

    def count(self, reason: str, n: int = 1) -> None:
        with self._lock:
            self._counts[reason] = self._counts.get(reason, 0) + n

    def total(self) -> int:
        with self._lock:
            return sum(self._counts.values())

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


class OverloadController:
    """Watermark-based admission ladder over a cheap pressure signal.

    ``attach(server)`` wires the pressure sources (span channel, span
    lanes, ingest fleets, store groups); until then pressure is 0 and
    everything is admitted, so stores built without a server run
    ungoverned."""

    def __init__(self, low: float = DEFAULT_LOW_WATERMARK,
                 high: float = DEFAULT_HIGH_WATERMARK,
                 hard: float = DEFAULT_HARD_WATERMARK,
                 clock: Callable[[], float] = time.monotonic,
                 recompute_interval: float = 0.1):
        if not 0.0 < low < high < hard <= 1.0:
            raise ValueError(
                f"overload watermarks must satisfy 0 < low < high < hard "
                f"<= 1, got {low}/{high}/{hard}")
        self.low, self.high, self.hard = low, high, hard
        self._clock = clock
        self._recompute_interval = recompute_interval
        self._lock = threading.Lock()
        self._level = LEVEL_NORMAL
        self._pressure = 0.0
        self._next_recompute = 0.0
        self._server = None
        # drops by lane (cumulative)
        self.shed: Dict[str, int] = {"statsd": 0, "ssf": 0, "spans": 0}
        self.level_changes = 0

    def attach(self, server) -> "OverloadController":
        self._server = server
        return self

    # -- pressure ----------------------------------------------------------

    def _compute_pressure(self) -> float:
        srv = self._server
        if srv is None:
            return 0.0
        p = 0.0
        chan = getattr(srv, "span_chan", None)
        if chan is not None and chan.maxsize > 0:
            p = max(p, chan.qsize() / chan.maxsize)
        workers = getattr(srv, "_span_workers", None) or ()
        for w in workers[:1]:  # the lanes are shared by every worker
            for lane in w.lanes:
                q = lane.queue
                if q.maxsize > 0:
                    p = max(p, q.qsize() / q.maxsize)
        for fleet in getattr(srv, "ingest_fleets", None) or ():
            # sealed chunks backing up against the merger read as
            # pipeline pressure, as a full span channel does
            p = max(p, fleet.pressure())
        store = getattr(srv, "store", None)
        if store is not None:
            occ = 0.0
            for name in store._GEN_GROUPS:
                g = getattr(store, name, None)
                ms = getattr(g, "max_series", 0)
                if g is not None and ms:
                    occ = max(occ, len(g) / ms)
            # cardinality pressure only ever reaches the FREEZE tier: the
            # per-group cap already bounds memory (spill), so a full
            # group must not shed spans or datagrams
            p = max(p, min(occ, (self.low + self.high) / 2.0))
        return min(p, 1.0)

    def pressure(self) -> float:
        self._maybe_recompute()
        return self._pressure

    def _maybe_recompute(self) -> None:
        now = self._clock()
        if now < self._next_recompute:
            return
        with self._lock:
            if now < self._next_recompute:
                return
            self._next_recompute = now + self._recompute_interval
            self._pressure = p = self._compute_pressure()
            if p >= self.hard:
                level = LEVEL_SHED_PACKETS
            elif p >= self.high:
                level = LEVEL_SHED_SPANS
            elif p >= self.low:
                level = LEVEL_SHED_NEW_SERIES
            else:
                level = LEVEL_NORMAL
            if level != self._level:
                self.level_changes += 1
                log.warning(
                    "overload level %d -> %d (pressure %.2f; watermarks "
                    "%.2f/%.2f/%.2f)", self._level, level, p, self.low,
                    self.high, self.hard)
                self._level = level

    def level(self) -> int:
        self._maybe_recompute()
        return self._level

    def level_nowait(self) -> int:
        """Lock-free level snapshot for the ingest-lane hot path: no
        recompute and no lock. The fleet merger drives ``level()`` on its
        tick, so this is at most one tick stale."""
        return self._level

    def account_shed(self, lane: str, n: int) -> None:
        """Fold lane-local shed tallies into the shared ledger (the
        merger's roll-up; lanes count their own sheds lock-free)."""
        with self._lock:
            self.shed[lane] = self.shed.get(lane, 0) + n

    # -- admission ---------------------------------------------------------

    def freeze_new_series(self) -> bool:
        """True while first-sight series spill to the overflow row
        regardless of the per-group cap (level >= 1)."""
        return self.level() >= LEVEL_SHED_NEW_SERIES

    def admit_span(self, n: int = 1) -> bool:
        """Raw external spans (the SSF stream and native lanes)."""
        if self.level() >= LEVEL_SHED_SPANS:
            with self._lock:
                self.shed["spans"] += n
            return False
        return True

    def admit_packet(self, lane: str) -> bool:
        """One datagram on a reader loop; ``lane`` is statsd or ssf. SSF
        datagrams shed with the spans tier, statsd only at the hard
        ceiling (aggregate traffic is memory-bounded by the caps)."""
        level = self.level()
        threshold = (LEVEL_SHED_SPANS if lane == "ssf"
                     else LEVEL_SHED_PACKETS)
        if level >= threshold:
            with self._lock:
                self.shed[lane] = self.shed.get(lane, 0) + 1
            return False
        return True

    def shed_total(self) -> int:
        with self._lock:
            return sum(self.shed.values())

    def snapshot(self) -> dict:
        """Best-effort state dump."""
        return {"level": self.level(), "pressure": round(self._pressure, 4),
                "watermarks": [self.low, self.high, self.hard],
                "shed": dict(self.shed),
                "level_changes": self.level_changes}


def from_config(cfg, clock: Callable[[], float] = time.monotonic
                ) -> OverloadController:
    """The configured controller (0 watermarks take the defaults)."""
    return OverloadController(
        low=getattr(cfg, "overload_low_watermark", DEFAULT_LOW_WATERMARK)
        or DEFAULT_LOW_WATERMARK,
        high=getattr(cfg, "overload_high_watermark",
                     DEFAULT_HIGH_WATERMARK) or DEFAULT_HIGH_WATERMARK,
        hard=getattr(cfg, "overload_hard_watermark",
                     DEFAULT_HARD_WATERMARK) or DEFAULT_HARD_WATERMARK,
        clock=clock)
