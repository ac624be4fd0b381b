"""The cross-hop trace contract: one context, one header, every hop.

Port of ``veneur_tpu/obs/tracectx.py`` (host Python, copied). A
:class:`TraceContext` (the SSF trace id and the parent span id, in the
63-bit id space of ``trace/``, and the **ingest-era stamp**: the wall
clock ns of the oldest sample riding the body) is stamped into every
cross-hop body:

    local forward  -> ``POST /import``   (forward/http_forward.py, the
                                         gRPC forward's metadata)
    proxy fan-out  -> ``POST /import``   (proxy/proxy.py, re-parented)
    resharding     -> ``POST /handoff``  (fleet/handoff.py)
    replication    -> ``POST /replicate`` (fleet/standby.py)

carried by ONE header, ``X-Veneur-Trace``, and adopted by the receiving
side: the receiver's :class:`HopLog` parks the hop until its next flush
publishes it under the sender's span, so ``GET /debug/trace?id=...``
(``obs/fleet.py``) stitches local flush -> proxy fan-out -> global
import -> global flush into one distributed trace. The ingest stamp
survives every hop; at the global's sink 2xx it becomes
``veneur.fleet.e2e_age_ns``, the fleet's ingest-to-emission freshness.

Wire format (ASCII, order-insensitive, unknown fields ignored so the
contract can grow):

    X-Veneur-Trace: trace=<u63>;parent=<u63>;ingest=<unix ns>

The stamp is WALL clock (monotonic clocks do not compare across hosts),
so freshness inherits the fleet's clock skew.
"""

from __future__ import annotations

import collections
import random
import threading
import time
from typing import Dict, List, Optional

HEADER = "X-Veneur-Trace"
_HEADER_LOWER = HEADER.lower()

# every HTTP route that carries (or must accept) the X-Veneur-Trace
# header
TRACED_ROUTES = ("/import", "/handoff")


def new_span_id() -> int:
    """A fresh 63-bit span id, the SSF id space (``trace/``)."""
    return random.getrandbits(63)


class TraceContext:
    """One hop's trace baggage: the distributed trace this body belongs
    to (``trace_id``), the span the receiving hop parents under
    (``parent_id``), and the wall-clock ns of the oldest sample aboard
    (``ingest_ns``; 0 = unknown)."""

    __slots__ = ("trace_id", "parent_id", "ingest_ns")

    def __init__(self, trace_id: int = 0, parent_id: int = 0,
                 ingest_ns: int = 0):
        self.trace_id = int(trace_id)
        self.parent_id = int(parent_id)
        self.ingest_ns = int(ingest_ns)

    def encode(self) -> str:
        return (f"trace={self.trace_id};parent={self.parent_id};"
                f"ingest={self.ingest_ns}")

    @classmethod
    def decode(cls, value: str) -> Optional["TraceContext"]:
        """Parse a header value; None on anything unusable. Unknown
        ``k=v`` fields are ignored (forward compatibility)."""
        if not value:
            return None
        fields: Dict[str, int] = {}
        for part in value.split(";"):
            key, sep, raw = part.strip().partition("=")
            if not sep:
                continue
            try:
                fields[key] = int(raw)
            except ValueError:
                continue
        tid = fields.get("trace", 0)
        if tid <= 0:
            return None
        return cls(trace_id=tid, parent_id=max(0, fields.get("parent", 0)),
                   ingest_ns=max(0, fields.get("ingest", 0)))

    @classmethod
    def from_headers(cls, headers) -> Optional["TraceContext"]:
        """Extract from any mapping of header names, case-insensitively
        (gRPC metadata keys are lowercase, http.client keeps case)."""
        if headers is None:
            return None
        value = None
        get = getattr(headers, "get", None)
        if get is not None:
            value = get(HEADER) or get(_HEADER_LOWER)
        if not value:
            for key in headers:
                if str(key).lower() == _HEADER_LOWER:
                    value = headers[key]
                    break
        return cls.decode(value) if value else None

    def child(self, parent_id: int) -> "TraceContext":
        """The context the NEXT hop carries: same trace, same ingest
        stamp, re-parented under this hop's span (the proxy does this, so
        the global's import parents under the fan-out, not under the
        local flush it already left)."""
        return TraceContext(self.trace_id, parent_id, self.ingest_ns)

    def __repr__(self):
        return f"TraceContext({self.encode()})"


class HopLog:
    """Bounded buffer of completed cross-hop records on the RECEIVING
    side: merges (``POST /import``, the gRPC import, ``POST /handoff``,
    ``POST /replicate``) land between flushes, when no interval recorder
    is active, so they park here and the next flush drains them into its
    published timeline entry (as off-path stages carrying ``trace_id``),
    stamping the entry with the contributing trace ids
    (``import_traces``).

    Also the fleet-freshness accumulator: every recorded context's
    ``ingest_ns`` folds into a min, read and reset once a flush: the
    oldest sample whose state this instance aggregated since the last
    emission."""

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self._hops: "collections.deque" = collections.deque(
            maxlen=max(16, capacity))
        self._oldest_ingest_ns: Optional[int] = None
        self.recorded_total = 0
        self.dropped_total = 0

    def record(self, hop: str, ctx: Optional[TraceContext],
               wall_start: float, wall_end: float, **attrs) -> dict:
        """One completed hop (wall-clock seconds, like timeline entries).
        ``ctx`` None still records (an untraced sender's import is real
        work), just unstitchable."""
        rec = dict(attrs)
        rec["hop"] = hop
        rec["span_id"] = new_span_id()
        rec["wall_start"] = wall_start
        rec["wall_end"] = wall_end
        rec["duration_ns"] = max(0, int((wall_end - wall_start) * 1e9))
        if ctx is not None:
            rec["trace_id"] = ctx.trace_id
            rec["parent_span_id"] = ctx.parent_id
            if ctx.ingest_ns:
                rec["ingest_ns"] = ctx.ingest_ns
        with self._lock:
            if len(self._hops) == self._hops.maxlen:
                self.dropped_total += 1
            self._hops.append(rec)
            self.recorded_total += 1
            if ctx is not None and ctx.ingest_ns:
                if (self._oldest_ingest_ns is None
                        or ctx.ingest_ns < self._oldest_ingest_ns):
                    self._oldest_ingest_ns = ctx.ingest_ns
        return rec

    def drain(self) -> List[dict]:
        """Take every pending hop (the flusher, once an interval)."""
        with self._lock:
            out = list(self._hops)
            self._hops.clear()
        return out

    def peek(self) -> List[dict]:
        """Read without consuming (``/debug/trace`` between flushes)."""
        with self._lock:
            return list(self._hops)

    def take_oldest_ingest_ns(self) -> Optional[int]:
        """Read and reset the freshness min (once a flush, at the swap;
        the next interval accumulates its own)."""
        with self._lock:
            oldest, self._oldest_ingest_ns = self._oldest_ingest_ns, None
        return oldest

    def snapshot(self) -> dict:
        with self._lock:
            return {"pending": len(self._hops),
                    "recorded_total": self.recorded_total,
                    "dropped_total": self.dropped_total,
                    "oldest_ingest_ns": self._oldest_ingest_ns}


def wall_to_mono_ns(rec, wall_s: float) -> int:
    """Map a wall-clock time onto a recorder's monotonic clock (hop
    records carry wall time; ``StageRecorder.record_abs`` takes the
    recorder's own ns base)."""
    return rec.t0_ns + int((wall_s - rec.wall_start) * 1e9)


def now_ns() -> int:
    return time.time_ns()
