"""The port's OpenTracing layer (``trace/opentracing.py``): the cases
of JAX ``tests/test_trace_propagation.py`` ``TestOpenTracingShim`` on the
port, and its carriers against the JAX package's: the BINARY carrier's
bytes decode with JAX ``sample_pb2`` to the span the JAX tracer writes
for the same context, each tracer extracts the other's carriers, and an
errored span records the critical status.
"""

import io
import queue

import pytest

class TestOpenTracingShim:
    def test_span_lifecycle_records_to_client(self):
        from veneur_tpu_torch.trace import new_channel_client
        from veneur_tpu_torch.trace import opentracing as ot

        chan = queue.Queue()
        tracer = ot.Tracer(client=new_channel_client(chan))
        with tracer.start_span("op.outer") as sp:
            sp.set_tag("k", "v")
        recorded = chan.get(timeout=2)
        assert recorded.name == "op.outer"

    def test_inject_extract_roundtrip_http(self):
        from veneur_tpu_torch.trace import opentracing as ot

        tracer = ot.Tracer()
        span = tracer.start_span("parent")
        carrier = {}
        tracer.inject(span.context, ot.FORMAT_HTTP_HEADERS, carrier)
        ctx = tracer.extract(ot.FORMAT_HTTP_HEADERS,
                             {k.upper(): v for k, v in carrier.items()})
        assert ctx.trace_id == span.context.trace_id
        assert ctx.span_id == span.context.span_id
        child = tracer.start_span("child", child_of=ctx)
        assert child.context.trace_id == span.context.trace_id

    def test_extract_garbage_returns_none(self):
        from veneur_tpu_torch.trace import opentracing as ot

        tracer = ot.Tracer()
        assert tracer.extract(ot.FORMAT_TEXT_MAP, {"traceid": "zzz"}) is None
        assert tracer.extract(ot.FORMAT_TEXT_MAP, {}) is None
        with pytest.raises(ValueError):
            tracer.extract("binary", {})  # dict is not a binary carrier

    def test_references_child_of_and_follows_from(self):
        """Child-of and follows-from merge identically
        (opentracing.go:412-426)."""
        from veneur_tpu_torch.trace import opentracing as ot

        tracer = ot.Tracer()
        parent = tracer.start_span("parent")
        for mk in (ot.child_of, ot.follows_from):
            child = tracer.start_span("child", references=[mk(parent)])
            assert child.context.trace_id == parent.context.trace_id
            assert child.context.parent_id != parent.context.parent_id
            assert child._trace.parent_id == parent.context.span_id

    def test_start_span_tags_and_standard_mappings(self):
        from veneur_tpu_torch.trace import new_channel_client
        from veneur_tpu_torch.trace import opentracing as ot

        chan = queue.Queue()
        tracer = ot.Tracer(client=new_channel_client(chan))
        span = tracer.start_span("op", tags={"route": "r1", "name": "other"})
        span.set_tag("error", True)
        span.finish()
        rec = chan.get(timeout=2)
        assert rec.name == "other"          # "name" tag renames the span
        assert rec.error is True            # "error" tag flags the span
        assert rec.tags["route"] == "r1"

    def test_log_kv_and_finish_with_options(self):
        from veneur_tpu_torch.trace import new_channel_client
        from veneur_tpu_torch.trace import opentracing as ot

        chan = queue.Queue()
        tracer = ot.Tracer(client=new_channel_client(chan))
        span = tracer.start_span("op.log")
        span.log_kv({"event": "cache_miss", "key": "k1"})
        span.finish_with_options(log_records=[{"event": "retry"}])
        rec = chan.get(timeout=2)
        assert rec.tags["log.event"] == "cache_miss"
        assert len(span._log_lines) == 2

    def test_baggage_items_propagate(self):
        from veneur_tpu_torch.trace import opentracing as ot

        tracer = ot.Tracer()
        span = tracer.start_span("op")
        span.set_baggage_item("tenant", "acme")
        assert span.baggage_item("tenant") == "acme"
        carrier = {}
        tracer.inject(span.context, ot.FORMAT_TEXT_MAP, carrier)
        assert carrier["tenant"] == "acme"
        ctx2 = span.context.with_baggage_item("extra", "1")
        assert ctx2.baggage()["extra"] == "1"
        assert ctx2.trace_id == span.context.trace_id
        seen = {}
        ctx2.foreach_baggage_item(lambda k, v: seen.setdefault(k, v) or True)
        assert seen["tenant"] == "acme"

    def test_extract_header_dialects(self):
        """Envoy, OpenTracing, Ruby and veneur header pairs all extract
        (opentracing.go:29-52), case-insensitively, tried in order."""
        from veneur_tpu_torch.trace import opentracing as ot

        tracer = ot.Tracer()
        for tkey, skey in (("X-Request-Id", "X-Client-Trace-Id"),
                           ("Trace-Id", "Span-Id"),
                           ("X-Trace-Id", "X-Span-Id"),
                           ("TraceId", "SpanId")):
            ctx = tracer.extract(ot.FORMAT_HTTP_HEADERS,
                                 {tkey: "123", skey: "456",
                                  "resource": "res"})
            assert ctx.trace_id == 123 and ctx.span_id == 456, tkey
            assert ctx.resource == "res"
        # Envoy wins over a later dialect when both are present
        ctx = tracer.extract(ot.FORMAT_HTTP_HEADERS,
                             {"x-request-id": "1", "x-client-trace-id": "2",
                              "trace-id": "3", "span-id": "4"})
        assert (ctx.trace_id, ctx.span_id) == (1, 2)

    def test_binary_inject_extract_roundtrip(self):
        import io

        from veneur_tpu_torch.trace import opentracing as ot

        tracer = ot.Tracer()
        span = tracer.start_span("binop")
        buf = io.BytesIO()
        tracer.inject(span.context, ot.FORMAT_BINARY, buf)
        buf.seek(0)
        ctx = tracer.extract(ot.FORMAT_BINARY, buf)
        assert ctx.trace_id == span.context.trace_id
        assert ctx.span_id == span.context.span_id
        # garbage binary returns None, not an exception
        assert tracer.extract(ot.FORMAT_BINARY,
                              io.BytesIO(b"\xff\xfe~garbage")) is None

    def test_active_span_implicit_parent(self):
        """The contextvars analogue of the reference's Span.Attach
        (opentracing.go:287-291): an attached span parents spans started
        without an explicit reference."""
        from veneur_tpu_torch.trace import opentracing as ot

        tracer = ot.Tracer()
        outer = tracer.start_span("outer")
        assert ot.active_span() is None
        with outer.attach_scope():
            assert ot.active_span() is outer
            inner = tracer.start_span("inner")
            assert inner.context.trace_id == outer.context.trace_id
            assert inner._trace.parent_id == outer.context.span_id
            solo = tracer.start_span("solo", ignore_active_span=True)
            assert solo.context.trace_id != outer.context.trace_id
        assert ot.active_span() is None

    def test_global_tracer_registration(self):
        from veneur_tpu_torch.trace import opentracing as ot

        assert ot.global_tracer() is ot.GlobalTracer
        t = ot.Tracer()
        ot.set_global_tracer(t)
        try:
            assert ot.global_tracer() is t
        finally:
            ot.set_global_tracer(ot.GlobalTracer)


def _context_pair(trace_id=123456789, span_id=987654321, resource="res"):
    from veneur_tpu.trace import opentracing as jot
    from veneur_tpu_torch.trace import opentracing as ot

    return (ot.SpanContext(trace_id, span_id, resource),
            jot.SpanContext(trace_id, span_id, resource))


@pytest.mark.parametrize("resource", ["", "res", "r/ü"])
def test_binary_carrier_bytes_equal_the_jax_tracers(resource):
    from veneur_tpu.protocol.gen.ssf import sample_pb2
    from veneur_tpu.trace import opentracing as jot
    from veneur_tpu_torch.trace import opentracing as ot

    ours, theirs = _context_pair(resource=resource)
    a, b = io.BytesIO(), io.BytesIO()
    ot.Tracer().inject(ours, ot.FORMAT_BINARY, a)
    jot.Tracer().inject(theirs, jot.FORMAT_BINARY, b)
    assert a.getvalue() == b.getvalue()
    span = sample_pb2.SSFSpan()
    span.ParseFromString(a.getvalue())
    assert (span.trace_id, span.id, span.parent_id) == (
        123456789, 987654321, 987654321)
    assert dict(span.tags) == ({"resource": resource} if resource else {})


@pytest.mark.parametrize("fmt", ["text_map", "http_headers", "binary"])
def test_each_tracer_extracts_the_others_carrier(fmt):
    from veneur_tpu.trace import opentracing as jot
    from veneur_tpu_torch.trace import opentracing as ot

    ours, theirs = _context_pair()
    for inject, ctx, extract in ((ot.Tracer(), ours, jot.Tracer()),
                                 (jot.Tracer(), theirs, ot.Tracer())):
        carrier = io.BytesIO() if fmt == "binary" else {}
        inject.inject(ctx, fmt, carrier)
        if fmt == "binary":
            carrier.seek(0)
        got = extract.extract(fmt, carrier)
        assert (got.trace_id, got.span_id, got.resource) == (
            123456789, 987654321, "res")


def test_error_tag_records_the_critical_status():
    from veneur_tpu_torch.protocol import ssf
    from veneur_tpu_torch.trace import new_channel_client
    from veneur_tpu_torch.trace import opentracing as ot

    chan = queue.Queue()
    tracer = ot.Tracer(client=new_channel_client(chan))
    span = tracer.start_span("op.err")
    span.set_tag("error", "true")
    span.finish()
    assert span._trace.status == ssf.Status.CRITICAL
    assert chan.get(timeout=2).error is True
