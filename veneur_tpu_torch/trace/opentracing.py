"""An OpenTracing-compatible layer over the SSF trace core.

Port of ``veneur_tpu/trace/opentracing.py`` (after the reference's
``trace/opentracing.go``), so code written against the OpenTracing API
emits SSF spans through the port's tracer:

* ``Tracer.start_span`` with ``child_of`` or ``references`` (child-of
  and follows-from are treated alike, opentracing.go:384-426), tags, an
  explicit start time, and an implicit active-span parent (the
  contextvars analogue of Go's ``Span.Attach(ctx)``).
* ``SpanContext``: baggage items with case-insensitive int64 views of
  traceid, parentid and spanid (opentracing.go:109-181).
* The standard tags: ``error`` marks the SSF span errored (status
  CRITICAL, :class:`~veneur_tpu_torch.protocol.ssf.Status`), ``name``
  renames it (opentracing.go:446-452); ``log_kv`` and ``log_fields``
  record log lines, reported as ``log.*`` tags.
* Inject and extract over TEXT_MAP and HTTP_HEADERS carriers and the
  BINARY format, whose bytes are an SSF span in the port's codec
  (``protocol/ssf.py``; opentracing.go:501-601). Extract tries the
  Envoy, OpenTracing, Ruby and veneur header pairs in that order
  (opentracing.go:29-52).
* A process-global tracer, registered at import (opentracing.go:53-58).

As in the JAX package, ``extract`` returns ``None`` where the parse
fails, and a root span's name defaults to the operation name.
"""

from __future__ import annotations

import contextvars
import random
import time
from typing import Any, Dict, List, Optional, Tuple, Union

from veneur_tpu_torch import trace as vtrace
from veneur_tpu_torch.protocol import ssf

FORMAT_TEXT_MAP = "text_map"
FORMAT_HTTP_HEADERS = "http_headers"
FORMAT_BINARY = "binary"

# Tried in order on extract; first pair with a nonzero id wins
# (opentracing.go:29-52: Envoy sits nearest, so it goes first).
HEADER_FORMATS: List[Tuple[str, str]] = [
    ("x-request-id", "x-client-trace-id"),   # Envoy
    ("trace-id", "span-id"),                 # OpenTracing
    ("x-trace-id", "x-span-id"),             # Ruby
    ("traceid", "spanid"),                   # veneur
]

REF_CHILD_OF = "child_of"
REF_FOLLOWS_FROM = "follows_from"


class Reference:
    """A causal reference to another span's context
    (opentracing.go:412-426: child-of and follows-from are merged the
    same way)."""

    __slots__ = ("type", "referenced_context")

    def __init__(self, type: str, referenced_context: "SpanContext"):
        self.type = type
        self.referenced_context = referenced_context


def child_of(ctx: Union["SpanContext", "Span"]) -> Reference:
    return Reference(REF_CHILD_OF, _as_context(ctx))


def follows_from(ctx: Union["SpanContext", "Span"]) -> Reference:
    return Reference(REF_FOLLOWS_FROM, _as_context(ctx))


def _as_context(obj) -> "SpanContext":
    return obj.context if isinstance(obj, Span) else obj


class SpanContext:
    """Propagation-relevant identity of a span: a bag of baggage items
    with case-insensitive int64 views for the ids
    (opentracing.go:109-181)."""

    def __init__(self, trace_id: int = 0, span_id: int = 0,
                 resource: str = "",
                 baggage_items: Optional[Dict[str, str]] = None):
        self.baggage_items: Dict[str, str] = dict(baggage_items or {})
        if trace_id:
            self.baggage_items.setdefault("traceid", str(trace_id))
        if span_id:
            self.baggage_items.setdefault("spanid", str(span_id))
            self.baggage_items.setdefault("parentid", str(span_id))
        if resource:
            self.baggage_items.setdefault(vtrace.RESOURCE_KEY, resource)

    def _int_item(self, key: str) -> int:
        for k, v in self.baggage_items.items():
            if k.lower() == key:
                try:
                    return int(v)
                except ValueError:
                    return 0
        return 0

    @property
    def trace_id(self) -> int:
        return self._int_item("traceid")

    @property
    def span_id(self) -> int:
        return self._int_item("spanid") or self._int_item("parentid")

    @property
    def parent_id(self) -> int:
        return self._int_item("parentid")

    @property
    def resource(self) -> str:
        for k, v in self.baggage_items.items():
            if k.lower() == vtrace.RESOURCE_KEY:
                return v
        return ""

    def with_baggage_item(self, key: str, value: str) -> "SpanContext":
        items = dict(self.baggage_items)
        items[key] = value
        return SpanContext(baggage_items=items)

    def foreach_baggage_item(self, handler) -> None:
        """Call ``handler(k, v)`` per item; a falsy return stops the
        iteration (opentracing.go:120-132)."""
        for k, v in self.baggage_items.items():
            if not handler(k, v):
                return

    def baggage(self) -> Dict[str, str]:
        return dict(self.baggage_items)


class Span:
    """An OpenTracing span wrapping a Trace (opentracing.go:183-334)."""

    def __init__(self, tracer: "Tracer", trace: "vtrace.Trace"):
        self._tracer = tracer
        self._trace = trace
        self._tags: Dict[str, str] = {}
        self._baggage: Dict[str, str] = {}
        self._log_lines: List[Dict[str, str]] = []
        self._error = False
        self._finished = False

    @property
    def context(self) -> SpanContext:
        items = {"traceid": str(self._trace.trace_id),
                 "spanid": str(self._trace.span_id),
                 "parentid": str(self._trace.span_id),
                 vtrace.RESOURCE_KEY: self._trace.resource}
        items.update(self._baggage)
        return SpanContext(baggage_items=items)

    @property
    def tracer(self) -> "Tracer":
        return self._tracer

    def set_operation_name(self, name: str) -> "Span":
        # the reference points SetOperationName at the trace's
        # *resource* (opentracing.go:259-262); the span name rides the
        # "name" tag. Keep both coherent for the common rename case.
        self._trace.resource = name
        self._trace.name = name
        return self

    def set_tag(self, key: str, value: Any) -> "Span":
        # standard-tag mapping: "error" flags the SSF span errored,
        # "name" renames it (opentracing.go:446-452 + samples.go
        # error indicator)
        if key == "error":
            self._error = bool(value) and str(value).lower() != "false"
            return self
        val = value if isinstance(value, str) else str(value)
        if key == "name":
            self._trace.name = val
        self._tags[key] = val
        return self

    def log_kv(self, kv: Dict[str, Any]) -> "Span":
        self._log_lines.append({k: str(v) for k, v in kv.items()})
        for k, v in kv.items():
            self._tags.setdefault(f"log.{k}", str(v))
        return self

    # opentracing-python calls the structured form log_fields; the
    # reference parks both in s.logLines (opentracing.go:293-303)
    log_fields = log_kv

    def set_baggage_item(self, key: str, value: str) -> "Span":
        self._baggage[key] = value
        return self

    def baggage_item(self, key: str) -> Optional[str]:
        return self._baggage.get(key)

    def finish(self, finish_time: Optional[float] = None,
               log_records: Optional[List[Dict[str, Any]]] = None):
        if self._finished:  # explicit finish inside a with-block
            return
        self._finished = True
        for rec in log_records or ():
            self.log_kv(rec)
        if self._error:
            # the standard "error" tag (set_tag path): flag the SSF
            # span errored without synthesizing an exception
            self._trace.status = ssf.Status.CRITICAL
            self._trace._error = True
        self._trace.finish()
        if finish_time is not None:
            self._trace.end = finish_time
        self._trace.client_record(self._tracer.client,
                                  tags=self._tags or None)

    # FinishWithOptions under its opentracing-python spelling
    def finish_with_options(self, finish_time: Optional[float] = None,
                            log_records=None):
        self.finish(finish_time, log_records)

    def attach(self):
        """Make this span the implicit parent for spans started without
        an explicit reference — the contextvars analogue of the
        reference's ``Span.Attach(ctx)`` (opentracing.go:287-291).
        Returns a token for ``detach``; also usable via ``with
        span.attach_scope():``."""
        return _ACTIVE_SPAN.set(self)

    def detach(self, token) -> None:
        _ACTIVE_SPAN.reset(token)

    def attach_scope(self):
        return _ActiveScope(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None:
            self._trace.error(exc)
        self.finish()


_ACTIVE_SPAN: "contextvars.ContextVar[Optional[Span]]" = \
    contextvars.ContextVar("veneur_active_span", default=None)


def active_span() -> Optional[Span]:
    return _ACTIVE_SPAN.get()


class _ActiveScope:
    def __init__(self, span: Span):
        self._span = span
        self._token = None

    def __enter__(self) -> Span:
        self._token = self._span.attach()
        return self._span

    def __exit__(self, exc_type, exc, tb):
        self._span.detach(self._token)


class Tracer:
    """start_span / inject / extract (opentracing.go:336-601)."""

    def __init__(self, client=None):
        self.client = client

    def start_span(self, operation_name: str = "",
                   child_of: Optional[Union[SpanContext, Span]] = None,
                   references: Optional[List[Reference]] = None,
                   tags: Optional[Dict[str, Any]] = None,
                   start_time: Optional[float] = None,
                   ignore_active_span: bool = False) -> Span:
        refs = list(references or ())
        if child_of is not None:
            refs.insert(0, Reference(REF_CHILD_OF, _as_context(child_of)))
        if not refs and not ignore_active_span:
            implicit = active_span()
            if implicit is not None:
                refs = [Reference(REF_CHILD_OF, implicit.context)]

        if not refs:
            t = vtrace.Trace.start_trace(operation_name)
        else:
            # child-of and follows-from merge identically
            # (opentracing.go:412-426): last reference with a usable
            # context wins, matching the reference's loop order
            parent_ctx = None
            for ref in refs:
                if ref.type in (REF_CHILD_OF, REF_FOLLOWS_FROM) and \
                        isinstance(ref.referenced_context, SpanContext):
                    parent_ctx = ref.referenced_context
            if parent_ctx is None:
                t = vtrace.Trace.start_trace(operation_name)
            else:
                t = vtrace.Trace(
                    resource=parent_ctx.resource or operation_name)
                t.trace_id = parent_ctx.trace_id
                t.parent_id = parent_ctx.span_id
                t.span_id = random.getrandbits(63)
        t.name = operation_name
        t.start = start_time if start_time is not None else time.time()
        span = Span(self, t)
        for k, v in (tags or {}).items():
            span.set_tag(k, v)
        return span

    def inject(self, span_context: Union[SpanContext, Span], format: str,
               carrier) -> None:
        ctx = _as_context(span_context)
        if format in (FORMAT_TEXT_MAP, FORMAT_HTTP_HEADERS):
            try:
                for k, v in ctx.baggage_items.items():
                    carrier[k] = v
            except TypeError as e:
                raise ValueError(
                    f"carrier is not a mutable mapping: {e}") from e
            return
        if format == FORMAT_BINARY:
            # the binary carrier is an SSF span protobuf
            # (opentracing.go:513-531)
            span = ssf.SSFSpan(
                trace_id=ctx.trace_id, id=ctx.span_id,
                parent_id=ctx.parent_id,
                tags=({vtrace.RESOURCE_KEY: ctx.resource}
                      if ctx.resource else None))
            try:
                carrier.write(ssf.encode_span(span))
            except AttributeError as e:
                raise ValueError(
                    f"binary carrier is not writable: {e}") from e
            return
        raise ValueError(f"unsupported carrier format {format!r}")

    def extract(self, format: str, carrier) -> Optional[SpanContext]:
        if format in (FORMAT_TEXT_MAP, FORMAT_HTTP_HEADERS):
            try:
                lowered = {k.lower(): v for k, v in carrier.items()}
            except AttributeError as e:
                raise ValueError(
                    f"carrier is not a mapping: {e}") from e
            trace_id = span_id = 0
            for tkey, skey in HEADER_FORMATS:
                try:
                    trace_id = int(lowered.get(tkey, "0") or "0")
                except ValueError:
                    trace_id = 0
                try:
                    span_id = int(lowered.get(skey, "0") or "0")
                except ValueError:
                    span_id = 0
                if trace_id and span_id:
                    break
            # the veneur wire dialect historically sends traceid +
            # parentid (trace/__init__.py:158-163); accept it so both
            # in-house carriers round-trip
            if not span_id:
                try:
                    span_id = int(lowered.get("parentid", "0") or "0")
                except ValueError:
                    span_id = 0
            if not trace_id:
                return None
            if not span_id:
                return None
            return SpanContext(
                trace_id, span_id,
                lowered.get(vtrace.RESOURCE_KEY, ""))
        if format == FORMAT_BINARY:
            try:
                data = carrier.read()
            except AttributeError as e:
                raise ValueError(
                    f"binary carrier is not readable: {e}") from e
            try:
                span = ssf.decode_span(data)
            except ssf.DecodeError:
                return None
            if not span.trace_id:
                return None
            return SpanContext(span.trace_id, span.id,
                               span.tags.get(vtrace.RESOURCE_KEY, ""))
        raise ValueError(f"unsupported carrier format {format!r}")


# the reference registers its GlobalTracer at package init
# (opentracing.go:53-58)
GlobalTracer = Tracer()
_global_tracer = GlobalTracer


def set_global_tracer(tracer: Tracer):
    global _global_tracer
    _global_tracer = tracer


def global_tracer() -> Tracer:
    return _global_tracer
