"""Self-tracing: Trace spans, the nonblocking client, metric reporting.

Port of ``veneur_tpu/trace/__init__.py``: the server traces itself the
way the reference does (its ``trace/`` package). A flush runs under a
:class:`Trace` span recorded through a :class:`Client` into an upstream
veneur (UDP or UNIX SSF) or into the server's own span channel, so its
samples re-enter the pipeline as ``veneur.*`` rows. Spans are the
port's protobuf-free :class:`~veneur_tpu_torch.protocol.ssf.SSFSpan`.
``trace/opentracing.py`` is the OpenTracing API over it.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, Optional

from veneur_tpu_torch.protocol.ssf import SSFSample, SSFSpan
from veneur_tpu_torch.trace.client import (Client, FlushError, NoClientError,
                                     WouldBlockError, flush,
                                     neutralize_client, new_backend_client,
                                     new_channel_client, record,
                                     send_client_statistics)

# Tag keys (trace/trace.go:43-53)
RESOURCE_KEY = "resource"
ERROR_MESSAGE_TAG = "error.msg"
ERROR_TYPE_TAG = "error.type"
ERROR_STACK_TAG = "error.stack"

# The service name stamped on every span (trace/trace.go's package var)
SERVICE = ""

# The default client used by module-level recording (client.go:414-421)
default_client: Optional[Client] = None

_disabled = False
_disabled_lock = threading.Lock()


def enable() -> None:
    global _disabled
    with _disabled_lock:
        _disabled = False


def disable() -> None:
    global _disabled
    with _disabled_lock:
        _disabled = True


def disabled() -> bool:
    with _disabled_lock:
        return _disabled


def set_default_client(client: Optional[Client]) -> None:
    """Swap the default client, closing the old one (client.go:392-402)."""
    global default_client
    old = default_client
    default_client = client
    if old is not None:
        old.close()


class Trace:
    """A span under construction (trace/trace.go:58-96)."""

    def __init__(self, trace_id: int = 0, span_id: int = 0,
                 parent_id: int = 0, resource: str = "", name: str = ""):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.resource = resource
        self.name = name
        self.start = time.time()
        self.end: Optional[float] = None
        self.status = SSFSample.OK
        self.tags: Dict[str, str] = {}
        self.samples = []
        self._error = False
        self.indicator = False

    # -- construction -------------------------------------------------------

    @classmethod
    def start_trace(cls, resource: str) -> "Trace":
        """Root span: trace id == span id (trace.go:302-317)."""
        tid = random.getrandbits(63)
        return cls(trace_id=tid, span_id=tid, parent_id=0, resource=resource)

    def start_child_span(self) -> "Trace":
        """A child span of this one (trace.go:319-330)."""
        child = Trace(trace_id=self.trace_id,
                      span_id=random.getrandbits(63),
                      parent_id=self.span_id, resource=self.resource)
        return child

    # -- recording ----------------------------------------------------------

    def finish(self) -> None:
        if self.end is None:
            self.end = time.time()

    @property
    def duration(self) -> float:
        return -1.0 if self.end is None else self.end - self.start

    def error(self, exc: BaseException) -> None:
        """Mark errored with the standard error tags (trace.go:207-224)."""
        self.status = SSFSample.CRITICAL
        self._error = True
        self.tags[ERROR_MESSAGE_TAG] = str(exc)
        self.tags[ERROR_TYPE_TAG] = type(exc).__name__ or "error"
        self.tags[ERROR_STACK_TAG] = str(exc)

    def add(self, *samples) -> None:
        self.samples.extend(samples)

    def ssf_span(self) -> SSFSpan:
        """Convert to the wire form; sets duration from start/end
        (trace.go:139-161)."""
        tags = dict(self.tags)
        if self.resource:
            tags[RESOURCE_KEY] = self.resource
        return SSFSpan(
            start_timestamp=int(self.start * 1e9),
            end_timestamp=int((self.end if self.end is not None
                               else self.start) * 1e9),
            error=self._error, trace_id=self.trace_id, id=self.span_id,
            parent_id=self.parent_id, name=self.name, service=SERVICE,
            indicator=self.indicator, metrics=self.samples, tags=tags)

    def client_record(self, cl: Optional[Client], name: str = "",
                      tags: Optional[Dict[str, str]] = None) -> None:
        """Finish and submit on a client (trace.go:181-205). Never raises
        for backpressure: a full client drops the span."""
        self.tags.update(tags or {})
        self.finish()
        span = self.ssf_span()
        if name:
            span.name = name
        try:
            record(cl, span)
        except (NoClientError, WouldBlockError):
            pass

    def record(self, name: str = "",
               tags: Optional[Dict[str, str]] = None) -> None:
        self.client_record(default_client, name, tags)

    # -- propagation --------------------------------------------------------

    def context_as_parent(self) -> Dict[str, str]:
        """Baggage headers for cross-process propagation
        (trace.go:290-299, opentracing inject/extract)."""
        return {"traceid": str(self.trace_id),
                "parentid": str(self.span_id),
                RESOURCE_KEY: self.resource}


def from_headers(headers: Dict[str, str], resource: str = "") -> Trace:
    """Rebuild a child span from propagated baggage (the opentracing
    extract path, trace/opentracing.go)."""
    t = Trace(resource=headers.get(RESOURCE_KEY, resource) or resource)
    try:
        t.trace_id = int(headers.get("traceid", "0"))
        t.parent_id = int(headers.get("parentid", "0"))
    except ValueError:
        pass
    if not t.trace_id:
        t.trace_id = random.getrandbits(63)
    t.span_id = random.getrandbits(63)
    return t
