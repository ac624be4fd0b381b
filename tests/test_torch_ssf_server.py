"""SSF, events and service checks through the port's Server, against the
JAX package's Server, on the CPU.

The same seeded spans (histograms in two scopes, counters at odd rates,
gauges, sets, STATUS samples, invalid samples, and every span an
indicator span) go to a JAX ``Server`` and a port ``Server(device="cpu")``
over each SSF rung: Python UDP readers (``native_ingest: false``), framed
streams over UNIX and TCP, and the C++ reader pool; DogStatsD event and
service-check lines go to both statsd listeners. Held, with the bounds
of tests/test_torch_server.py:

* the flushed rows: counters, gauges, status rows (value, message and
  hostname), histogram count/min/max exact, sum rtol 1e-6, set estimates
  rtol 1e-6 (one float32 ulp of the log), percentiles within
  0.02 x (max - min) of the JAX package's; the port's rungs among
  themselves bit for bit;
* the same events in every metric sink's ``flush_other_samples``;
* every span in the span sinks, every sample merged or counted invalid;
* the native ``decode_spans`` columns and slow-lane samples equal the
  JAX package's; and the indicator timer's value, a float32 on the
  Python path and a double on the C++ lane (pinned), flushes the same.

The native library builds with g++ on first use; without g++ the native
rung's tests skip.
"""

import os
import shutil
import socket
import tempfile
import time

import numpy as np
import pytest

from veneur_tpu import native as jnative
from veneur_tpu.config import Config as JConfig
from veneur_tpu.protocol.gen.ssf import sample_pb2 as pb
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.server import Server as JServer
from veneur_tpu.sinks import ChannelMetricSink as JChannelMetricSink
from veneur_tpu.sinks import ChannelSpanSink as JChannelSpanSink
from veneur_tpu_torch import native as tnative
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.protocol import ssf, wire
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink, ChannelSpanSink

PCTS = [0.5, 0.99]
AGGS = ["min", "max", "count", "sum"]
TIMER = "ssf.indicator"
RUNGS = ("python", "unix", "tcp", "native")
N_SPANS = 48
EVENT_LINES = [b"_e{5,4}:title|text|d:1700000000|#k:v",
               b"_e{3,2}:ev2|t2|d:1700000001|h:host|p:low|t:error",
               b"_sc|svc.check|1|h:web1|#k:v|m:slow",
               b"_sc|svc.check2|2|d:1700000000|#veneurlocalonly"]


def _needs_gxx(rung):
    if rung == "native" and shutil.which("g++") is None:
        pytest.skip("g++ not found: the native library cannot be built")


def _spans(seed: int = 81):
    """The seeded spans (protobuf) and what each path must count: valid
    samples, invalid samples and indicator timers."""
    rng = np.random.default_rng(seed)
    spans, invalid = [], 0
    for i in range(N_SPANS):
        start = 1_700_000_000_000_000_000 + i
        dur = int(10 ** rng.uniform(3, 10))
        span = pb.SSFSpan(
            version=1, trace_id=1000 + i, id=2000 + i, parent_id=i,
            start_timestamp=start, end_timestamp=start + dur,
            error=bool(i % 2), service=f"svc{i % 4}", name=f"op.{i}",
            indicator=True)
        span.tags["env"] = "prod"
        for j in range(6):
            k = (i * 6 + j) % 20
            m = span.metrics.add(metric=pb.SSFSample.HISTOGRAM,
                                 name=f"ssf.h.{k}",
                                 value=float(rng.gamma(2.0, 10.0)),
                                 sample_rate=1.0 if k % 3 else 0.5)
            m.tags["az"] = f"z{k % 3}"
            if k % 5 == 0:
                m.tags["veneurlocalonly"] = ""
        c = span.metrics.add(metric=pb.SSFSample.COUNTER,
                             name=f"ssf.c.{i % 7}",
                             value=float(rng.integers(1, 9)),
                             sample_rate=[0.0, 0.5, 0.25][i % 3])
        if i % 4 == 0:
            c.tags["veneurglobalonly"] = ""
        span.metrics.add(metric=pb.SSFSample.GAUGE, name=f"ssf.g.{i % 5}",
                         value=float(rng.normal(0, 100)))
        s = span.metrics.add(metric=pb.SSFSample.SET, name=f"ssf.s.{i % 3}",
                             message=f"u{int(rng.integers(0, 40))}")
        s.tags["k"] = "v"
        st = span.metrics.add(metric=pb.SSFSample.STATUS,
                              name=f"ssf.st.{i % 6}", status=i % 4,
                              message=f"m{i}")
        st.tags["role"] = "db"
        if i % 8 == 3:
            span.metrics.add(metric=pb.SSFSample.COUNTER, name="",
                             value=1.0)  # no name: invalid
            invalid += 1
        spans.append(span)
    valid = N_SPANS * 10
    return spans, valid, invalid


SPANS, VALID, INVALID = _spans()


def _ssf_addr(rung, tmp):
    return {"python": "udp://127.0.0.1:0", "native": "udp://127.0.0.1:0",
            "unix": f"unix://{tmp}/ssf.sock", "tcp": "tcp://127.0.0.1:0"}[rung]


def _send(rung, addr, statsd_port, raws):
    if rung in ("python", "native"):
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
            for i, raw in enumerate(raws):
                tx.sendto(raw, addr)
                if i % 16 == 15:
                    time.sleep(0.002)
    else:
        family = socket.AF_UNIX if rung == "unix" else socket.AF_INET
        with socket.socket(family, socket.SOCK_STREAM) as tx:
            tx.connect(addr)
            tx.sendall(b"".join(wire.FRAME_HEADER.pack(0, len(r)) + r
                                for r in raws))
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
        tx.sendto(b"\n".join(EVENT_LINES), ("127.0.0.1", statsd_port))


def _wait(cond, what, timeout=60.0):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def _config_kw(rung, tmp):
    return dict(statsd_listen_addresses=["udp://127.0.0.1:0"],
                ssf_listen_addresses=[_ssf_addr(rung, tmp)],
                native_ingest=rung == "native",
                indicator_span_timer_name=TIMER, interval="3600s",
                percentiles=PCTS, aggregates=AGGS, hostname="test")


def _run(rung, jax: bool):
    """One server of either package on ``rung``: the spans and the
    event/service-check lines, then one flush. Returns (rows by key,
    events, the traffic's span ids in the span sink, the server). The
    JAX server also sends its own flush spans to its span sinks."""
    tmp = tempfile.mkdtemp(prefix="vssf")
    kw = _config_kw(rung, tmp)
    n_lines = 2  # the service checks
    if jax:
        class EventSink(JChannelMetricSink):
            def flush_other_samples(self, samples):
                self.other = list(samples)

        sink, span_sink = EventSink(), JChannelSpanSink()
        server = JServer(JConfig(**kw), metric_sinks=[sink],
                         span_sinks=[span_sink])
    else:
        sink, span_sink = ChannelMetricSink(), ChannelSpanSink()
        server = Server(Config(**kw), metric_sinks=[sink],
                        span_sinks=[span_sink], device="cpu")
    server.start()
    try:
        ssf_addr = server.ssf_addrs[0]
        statsd_port = server.statsd_addrs[0][1]
        if not jax:
            assert [r for _, r, _ in server.ssf_listeners] == [
                "stream" if rung in ("unix", "tcp") else rung]
        _send(rung, ssf_addr, statsd_port,
              [s.SerializeToString() for s in SPANS])
        want = VALID + N_SPANS + n_lines
        _wait(lambda: server.store.processed >= want
              and span_sink.queue.qsize() >= N_SPANS, "the spans")
        time.sleep(0.1)
        server.flush()
        rows = sink.get_flush(timeout=30)
        events = (sink.other if jax
                  else sink.get_other_samples(timeout=30))
    finally:
        server.shutdown()
    return ({(m.name, tuple(m.tags), m.type.value):
             (m.value, m.message, m.hostname) for m in rows},
            sorted((e.name, e.message, e.timestamp, tuple(sorted(
                e.tags.items()))) for e in events),
            sorted(s.id for s in list(span_sink.queue.queue)
                   if s.service.startswith("svc")), server)


@pytest.fixture(scope="module")
def port_runs():
    out = {}
    for rung in RUNGS:
        if rung == "native" and shutil.which("g++") is None:
            continue
        out[rung] = _run(rung, jax=False)
    return out


def _assert_rows_match(got, exp):
    assert set(got) == set(exp)
    for key, (value, message, hostname) in exp.items():
        gv, gm, gh = got[key]
        assert (gm, gh) == (message, hostname), key
        name, tags, mtype = key
        base, _, suffix = name.rpartition(".")
        if suffix == "sum" or name.startswith("ssf.s."):
            np.testing.assert_allclose(gv, value, rtol=1e-6)
        elif suffix.endswith("percentile"):
            lo = exp[(f"{base}.min", tags, "gauge")][0]
            hi = exp[(f"{base}.max", tags, "gauge")][0]
            assert abs(gv - value) <= 0.02 * (hi - lo) + 1e-6, key
        else:
            assert gv == value, key


@pytest.mark.parametrize("rung", RUNGS)
def test_rung_matches_jax_server(rung, port_runs):
    _needs_gxx(rung)
    rows, events, spans, server = port_runs[rung]
    jrows, jevents, jspans, _ = _run(rung, jax=True)
    _assert_rows_match(rows, jrows)
    assert events == jevents and len(events) == 2
    assert spans == jspans == [2000 + i for i in range(N_SPANS)]
    # a service check's row carries its message and hostname; an SSF
    # STATUS sample's message stays behind, as in the reference
    # (parseMetricSSF carries only the status) and the JAX package
    assert rows[("svc.check", ("k:v",), "status")] == (1.0, "slow", "web1")
    assert rows[("ssf.st.1", ("role:db",), "status")] == (3.0, "", "")
    assert ("svc.check2", (), "status") in rows
    # every sample merged or counted invalid; nothing shed
    assert server.spans_dropped == server.overload.shed_total() == 0
    if rung == "native":
        assert server.packet_errors == INVALID
    else:
        assert server.extraction_sink.invalid_samples == INVALID
        assert server.packet_errors == 0


def test_port_rungs_agree(port_runs):
    """Python UDP, UNIX and TCP run the same per-sample path: bit for bit.
    The native lane stages the same samples through process_batch."""
    runs = {r: v[0] for r, v in port_runs.items()}
    assert runs["unix"] == runs["python"] == runs["tcp"]
    if "native" in runs:
        assert runs["native"] == runs["python"]
    timers = {k: v for k, v in runs["python"].items()
              if k[0].startswith(TIMER + ".") and k[0].endswith("count")}
    assert sum(v[0] for v in timers.values()) == N_SPANS


def test_indicator_timer_float32_vs_double():
    """The Python path's indicator timer passes through the sample's float
    field (float32: 123456789 ns reads 123456792); the C++ lane writes
    the duration as a double. Pinned in both packages; the digest stages
    float32, so both flush 123456792."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native library cannot be built")
    span = pb.SSFSpan(trace_id=1, id=2, start_timestamp=1,
                      end_timestamp=123456790, service="s", indicator=True)
    raw = span.SerializeToString()
    for native, parser, decoded in (
            (tnative, tparser, ssf.decode_span(raw)),
            (jnative, jparser, span)):
        (m,) = parser.convert_indicator_metrics(decoded, TIMER)
        assert m.value == 123456792.0
        b = native.decode_spans([raw], TIMER)
        assert b.metrics.count == 1 and b.metrics.value[0] == 123456789.0
        assert int(b.metrics.digest[0]) == m.digest
    assert float(np.float32(123456789.0)) == 123456792.0


def _small_spans():
    """SPANS cut to three histogram samples, the STATUS sample and any
    invalid one: four records a span with the indicator timer, inside
    decode_spans' sizing of nine a span."""
    out = []
    for s in SPANS:
        t = pb.SSFSpan()
        t.CopyFrom(s)
        del t.metrics[3:9]
        out.append(t.SerializeToString())
    return out


def test_heavy_tailed_timers_match_jax():
    """Indicator timers spread over seven decades (10^U(3, 10) ns): the
    dense store's percentiles sit up to a few percent off in rank, in
    the JAX package as in the port; the port's equal the JAX package's
    within the asin polynomial's rounding (rtol 1e-5), so the rank error
    is inherited, not the port's."""
    from veneur_tpu.core import store as jstore
    from veneur_tpu.samplers.intermetric import HistogramAggregates as JA
    from veneur_tpu_torch.core import store as tstore
    from veneur_tpu_torch.samplers.intermetric import HistogramAggregates

    rng = np.random.default_rng(91)
    n = 64 * 120
    durs = np.floor(10.0 ** rng.uniform(3.0, 10.0, n)).astype(np.int64)
    js, ts = jstore.MetricStore(), tstore.MetricStore(device="cpu")
    for k, d in enumerate(durs.tolist()):
        span = ssf.SSFSpan(start_timestamp=1, end_timestamp=1 + d,
                           service=f"svc{k % 32}", error=bool(k % 64 >= 32),
                           indicator=True)
        (m,) = tparser.convert_indicator_metrics(span, TIMER)
        ts.process_metric(m)
        jspan = pb.SSFSpan(start_timestamp=1, end_timestamp=1 + d,
                           service=span.service, error=span.error,
                           indicator=True)
        (jm,) = jparser.convert_indicator_metrics(jspan, TIMER)
        js.process_metric(jm)
    got = {(m.name, tuple(m.tags)): m.value for m in ts.flush(
        PCTS, HistogramAggregates.from_names(AGGS), 0)[0].to_intermetrics()}
    want = {(m.name, tuple(m.tags)): m.value for m in js.flush(
        PCTS, JA.from_names(AGGS), is_local=False, now=0, forward=False)[0]}
    assert set(got) == set(want) and len(got) == 64 * 6
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-5, err_msg=key)


def test_decode_spans_matches_jax():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native library cannot be built")
    raws = _small_spans() + [b"\x0c\x01", b""]
    got = tnative.decode_spans(raws, TIMER)
    want = jnative.decode_spans(raws, TIMER)
    assert got.metrics.count == 4 * N_SPANS and got.decode_errors == 1
    assert (got.count, got.decode_errors, got.invalid_samples) == (
        want.count, want.decode_errors, want.invalid_samples)
    for col in ("trace_id", "span_id", "parent_id", "start", "end", "error",
                "indicator", "raw_off", "raw_len"):
        port_col = {"start": "start_ns", "end": "end_ns"}.get(col, col)
        np.testing.assert_array_equal(getattr(got, port_col),
                                      getattr(want, "_" + col))
    assert got.arena == want._arena
    assert got.slow_samples == want.slow_samples
    assert len(got.slow_samples) == N_SPANS  # the STATUS samples
    for col in ("type", "scope", "value", "sample_rate", "digest",
                "name_off", "name_len", "tags_off", "tags_len"):
        np.testing.assert_array_equal(getattr(got.metrics, col),
                                      getattr(want.metrics, col))
    assert got.metrics.arena == want.metrics.arena
    for i in (0, got.count - 1):
        a, b = got.span(i), want.span(i)
        for f in ("trace_id", "id", "service", "name", "error",
                  "indicator"):
            assert getattr(a, f) == getattr(b, f)
        assert dict(a.tags) == dict(b.tags)  # decoded on first touch
        assert a.SerializeToString() == b.SerializeToString()


def test_full_record_column_skips_indicator_timers_uncounted():
    """Inherited from the C++ lane, in both packages: once a batch's
    record column is full, samples spill to the slow lane (then count
    as invalid), but an indicator timer is skipped and counted nowhere.
    decode_spans sizes nine records a span; SPANS carry 11-12 and a
    timer, so the column fills."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native library cannot be built")
    raws = [s.SerializeToString() for s in SPANS]
    got = tnative.decode_spans(raws, TIMER)
    want = jnative.decode_spans(raws, TIMER)
    for b in (got, want):
        names = [b.metrics.arena[o:o + n] for o, n in zip(
            b.metrics.name_off.tolist(), b.metrics.name_len.tolist())]
        timers = names.count(TIMER.encode())
        records = b.metrics.count + len(b.slow_samples) + b.invalid_samples
        # every sample is recorded, spilled or counted ...
        assert records - timers == VALID + INVALID
        # ... but not every span's timer
        assert b.count == N_SPANS and timers < N_SPANS
    assert (got.metrics.count, got.invalid_samples, len(got.slow_samples)) \
        == (want.metrics.count, want.invalid_samples,
            len(want.slow_samples))


def test_slow_lane_and_heavy_hitters_are_counted():
    """STATUS samples take the C++ slow lane into the status group; a
    heavy-hitter set lands in the heavy-hitter group, with its member
    name, on the native and the Python rung alike; an undecodable
    datagram is a packet error."""
    span = pb.SSFSpan(trace_id=1, id=2, start_timestamp=1, end_timestamp=9)
    top = span.metrics.add(metric=pb.SSFSample.SET, name="top", message="a")
    top.tags["veneurtopk"] = ""
    span.metrics.add(metric=pb.SSFSample.STATUS, name="chk", status=2,
                     message="down")
    rungs = ["python"] + (["native"] if shutil.which("g++") else [])
    for rung in rungs:
        sink = ChannelMetricSink()
        server = Server(Config(ssf_listen_addresses=["udp://127.0.0.1:0"],
                               native_ingest=rung == "native",
                               interval="3600s", hostname="t"),
                        metric_sinks=[sink], device="cpu")
        server.start()
        try:
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
                tx.sendto(span.SerializeToString(), server.ssf_addrs[0])
                tx.sendto(b"\x0c", server.ssf_addrs[0])
            _wait(lambda: server.packet_errors == 1
                  and server.store.processed == 2, rung)
            server.flush()
            rows = sink.get_flush(timeout=10)
        finally:
            server.shutdown()
        assert sorted((m.name, m.value, m.type.value, tuple(m.tags))
                      for m in rows) == [
            ("chk", 2.0, "status", ()),
            ("top.topk", 1.0, "counter", ("veneurtopk:", "key:a"))], rung


def test_full_span_channel_sheds_and_counts():
    server = Server(Config(span_channel_capacity=2, hostname="t"),
                    device="cpu")  # not started: nothing drains
    for i in range(5):
        server.handle_ssf(ssf.SSFSpan(id=i))
    server.handle_ssf_batch([ssf.SSFSpan(id=9)] * 3)
    assert server.spans_dropped == 3 + 3
    with pytest.raises(ValueError, match="span_channel_capacity"):
        Config(span_channel_capacity=-1)
    assert Config().span_channel_capacity == 100


def test_stream_framing_error_closes_the_connection():
    """A bad frame version poisons a stream: counted once, connection
    closed; a frame whose body does not decode is counted and skipped."""
    tmp = tempfile.mkdtemp(prefix="vssf")
    path = os.path.join(tmp, "s.sock")
    sink = ChannelMetricSink()
    server = Server(Config(ssf_listen_addresses=[f"unix://{path}"],
                           interval="3600s", hostname="t"),
                    metric_sinks=[sink], device="cpu")
    server.start()
    try:
        good = ssf.SSFSpan(id=1, metrics=[ssf.SSFSample(
            metric=ssf.SSFSample.COUNTER, name="c", value=2.0)])
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as tx:
            tx.connect(path)
            tx.sendall(wire.FRAME_HEADER.pack(0, 1) + b"\x0c"
                       + wire.frame_bytes(good) + b"\x07junk"
                       + wire.frame_bytes(good))
            _wait(lambda: server.packet_errors == 2, "the errors")
        _wait(lambda: server.store.processed == 1, "the good span")
        server.flush()
        assert [(m.name, m.value) for m in sink.get_flush(10)] == [
            ("c", 2.0)]
    finally:
        server.shutdown()


def test_span_accounting_under_contention():
    """Sixteen producer threads offer spans to a small span channel that
    twelve span workers drain into one span sink, with a short switch
    interval: every span is delivered, shed by the overload controller
    (the full channel reads as pressure past the high watermark), shed
    at the channel or shed at the sink's lane, and each is counted
    exactly once."""
    import sys
    import threading

    producers, per = 16, 400
    span_sink = ChannelSpanSink()
    server = Server(Config(span_channel_capacity=4, num_span_workers=12,
                           interval="3600s", hostname="t"),
                    span_sinks=[span_sink], device="cpu")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        server.start()
        start = threading.Barrier(producers)

        def produce(k):
            start.wait(10)
            for i in range(per):
                if i % 4:
                    server.handle_ssf(ssf.SSFSpan(id=k * per + i))
                else:
                    server.handle_ssf_batch([ssf.SSFSpan(id=k * per + i)])

        threads = [threading.Thread(target=produce, args=(k,))
                   for k in range(producers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        server.shutdown()
    finally:
        sys.setswitchinterval(old)
    lanes = server._span_lanes
    delivered = span_sink.queue.qsize()
    lane_shed = sum(lane.ingest_timeouts for lane in lanes
                    if lane.sink is span_sink)
    admission_shed = server.overload.shed["spans"]
    assert (delivered + lane_shed + server.spans_dropped + admission_shed
            == producers * per)
    assert sorted(s.id for s in list(span_sink.queue.queue)) == sorted(
        set(s.id for s in list(span_sink.queue.queue)))
    assert sum(w.ingested for w in server._span_workers) == \
        producers * per - server.spans_dropped - admission_shed


def test_wedged_span_sink_flush_is_skipped_and_counted(monkeypatch):
    """A span sink whose flush blocks holds only its own flush thread: a
    flush waits for it at most ``SPAN_JOIN_TIMEOUT`` (its span_join
    stage, shortened here), the next interval's span flush is skipped
    and counted, the metric flush goes on."""
    import threading

    from veneur_tpu_torch import flusher
    from veneur_tpu_torch.sinks.base import SpanSink

    monkeypatch.setattr(flusher, "SPAN_JOIN_TIMEOUT", 0.5)

    release = threading.Event()

    class Wedged(SpanSink):
        name = "wedged"
        flushes = 0

        def ingest(self, span):
            pass

        def flush(self):
            self.flushes += 1
            release.wait(30)

    sink, wedged = ChannelMetricSink(), Wedged()
    server = Server(Config(interval="3600s", hostname="t"),
                    metric_sinks=[sink], span_sinks=[wedged], device="cpu")
    server.start()
    try:
        server.flush()
        _wait(lambda: wedged.flushes == 1, "the first span flush")
        server.flush()
        assert server.span_flush_skipped == 1
        # no customer rows: at most the first flush's own self-metrics,
        # when its span reached the store before the second flush
        while not sink.queue.empty():
            assert all(m.name.startswith("veneur.")
                       for m in sink.get_flush(timeout=1))
        assert sink.get_other_samples(10) == sink.get_other_samples(10) == []
    finally:
        release.set()
        server.shutdown()
    # the shutdown's final flush flushes the span sinks once more
    _wait(lambda: wedged.flushes == 2, "the final span flush")
