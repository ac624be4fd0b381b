"""The port's self-tracing client (``veneur_tpu_torch/trace/``) against the
JAX package's (``veneur_tpu/trace/``).

* The SSF sample constructors build the same samples: each package's
  sample, encoded, decodes (with the port's codec and with protobuf's)
  to the same fields, for every constructor on seeded values.
* A ``Trace`` built by each package with the same ids, times, tags and
  samples gives spans that decode to the same fields; a child span and
  the propagation headers follow the same rules.
* The client's backpressure statistics: a channel client over a bounded
  queue counts the same successes and failures in both packages,
  ``send_client_statistics`` reports and resets them the same way; the
  packet (UDP) and stream (UNIX) backends deliver spans a listener
  decodes, and a flush of the buffered stream backend lands its frames.
"""

import io
import queue
import socket
import struct
import threading

import numpy as np
import pytest

import veneur_tpu.trace as jtrace
from veneur_tpu.protocol.gen.ssf import sample_pb2 as pb
from veneur_tpu.trace import client as jclient
from veneur_tpu.trace import samples as jsamples
import veneur_tpu_torch.trace as ttrace
from veneur_tpu_torch.protocol import ssf, wire
from veneur_tpu_torch.trace import backend as tbackend
from veneur_tpu_torch.trace import client as tclient
from veneur_tpu_torch.trace import metrics as tmetrics
from veneur_tpu_torch.trace import samples as tsamples

SAMPLE_FIELDS = ("metric", "name", "value", "timestamp", "message",
                 "status", "sample_rate", "unit")
SPAN_FIELDS = ("version", "trace_id", "id", "parent_id", "start_timestamp",
               "end_timestamp", "error", "service", "indicator", "name")


def _bits(v: float) -> bytes:
    return struct.pack("<f", v)


def _sample_tuple(s):
    return tuple(_bits(getattr(s, f)) if f in ("value", "sample_rate")
                 else getattr(s, f) for f in SAMPLE_FIELDS) + (
        dict(s.tags),)


def _span_tuple(span):
    return (tuple(getattr(span, f) for f in SPAN_FIELDS), dict(span.tags),
            [_sample_tuple(s) for s in span.metrics])


def _constructed(mod, rng):
    """One sample of every constructor, from seeded values."""
    tags = {f"k{i}": f"v{int(rng.integers(0, 100))}"
            for i in range(int(rng.integers(0, 3)))}
    v = float(rng.gamma(2.0, 10.0))
    return [
        mod.count("veneur.c", v, tags),
        mod.gauge("veneur.g", -v, tags, timestamp=int(rng.integers(1, 1e9))),
        mod.histogram("veneur.h", v, tags, unit="ms"),
        mod.set_sample("veneur.s", f"m{int(rng.integers(0, 50))}", tags),
        mod.timing("veneur.t", v / 1e3, tags),
        mod.timing("veneur.t_us", v / 1e3, tags, resolution=1e-6),
        mod.status("veneur.st", mod.CRITICAL, tags, message="down"),
    ]


@pytest.mark.parametrize("seed", range(6))
def test_sample_constructors_match(seed):
    got = _constructed(tsamples, np.random.default_rng(seed))
    want = _constructed(jsamples, np.random.default_rng(seed))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        raw_g, raw_w = g.SerializeToString(), w.SerializeToString()
        assert _sample_tuple(ssf.decode_sample(raw_w)) == _sample_tuple(g)
        back = pb.SSFSample()
        back.ParseFromString(raw_g)
        assert _sample_tuple(back) == _sample_tuple(w)
        assert _sample_tuple(ssf.decode_sample(raw_g)) == \
            _sample_tuple(ssf.decode_sample(raw_w))


def test_randomly_sample_scales_rates():
    kept = tsamples.randomly_sample(1.0, tsamples.count("a", 1.0),
                                    tsamples.count("b", 2.0))
    assert [s.sample_rate for s in kept] == [1.0, 1.0]
    assert tsamples.randomly_sample(0.0, tsamples.count("a", 1.0)) == []


def _trace(mod, rng):
    t = mod.Trace(trace_id=int(rng.integers(1, 2 ** 62)),
                  span_id=int(rng.integers(1, 2 ** 62)),
                  parent_id=int(rng.integers(0, 2 ** 62)),
                  resource="veneur.flush", name="flush")
    t.start = 1_700_000_000.0 + float(rng.integers(0, 1000))
    t.end = t.start + float(rng.random())
    t.tags["stage"] = "store"
    samples = tsamples if mod is ttrace else jsamples
    t.add(*_constructed(samples, rng))
    if rng.random() < 0.5:
        t.error(RuntimeError("kernel failed"))
    return t


@pytest.mark.parametrize("seed", range(4))
def test_span_of_each_package_decodes_the_same(seed):
    span_t = _trace(ttrace, np.random.default_rng(seed)).ssf_span()
    span_j = _trace(jtrace, np.random.default_rng(seed)).ssf_span()
    via_port = ssf.decode_span(span_j.SerializeToString())
    assert _span_tuple(via_port) == _span_tuple(span_t)
    back = pb.SSFSpan()
    back.ParseFromString(span_t.SerializeToString())
    assert _span_tuple(back) == _span_tuple(span_j)


def test_child_span_and_headers_follow_the_reference():
    for mod in (ttrace, jtrace):
        root = mod.Trace.start_trace("veneur.flush")
        assert root.trace_id == root.span_id and root.parent_id == 0
        child = root.start_child_span()
        assert (child.trace_id, child.parent_id, child.resource) == (
            root.trace_id, root.span_id, "veneur.flush")
        headers = child.context_as_parent()
        assert headers == {"traceid": str(child.trace_id),
                           "parentid": str(child.span_id),
                           "resource": "veneur.flush"}
        again = mod.from_headers(headers)
        assert (again.trace_id, again.parent_id) == (child.trace_id,
                                                     child.span_id)
        bad = mod.from_headers({"traceid": "x"}, resource="r")
        assert bad.trace_id and bad.resource == "r"


@pytest.mark.parametrize("capacity,records", [(1, 3), (4, 4), (3, 9)])
def test_channel_client_statistics_match(capacity, records):
    """Records past the queue's bound fail (WouldBlockError), in both
    packages alike; the statistics report, then reset."""
    stats = {}
    for name, mod, cmod, make in (
            ("port", ttrace, tclient, lambda i: ssf.SSFSpan(id=i)),
            ("jax", jtrace, jclient, lambda i: pb.SSFSpan(id=i))):
        q = queue.Queue(capacity)
        cl = mod.new_channel_client(q)
        failed = 0
        for i in range(records):
            try:
                mod.record(cl, make(i))
            except cmod.WouldBlockError:
                failed += 1
        assert q.qsize() == min(capacity, records)
        got = {}
        mod.send_client_statistics(cl, got.__setitem__)
        again = {}
        mod.send_client_statistics(cl, again.__setitem__)
        assert set(again.values()) == {0.0}
        stats[name] = (failed, got)
        cl.close()
    assert stats["port"] == stats["jax"]
    assert stats["port"][1]["trace_client.records_failed_total"] == \
        max(0, records - capacity)


def test_client_record_swallows_backpressure():
    q = queue.Queue(1)
    cl = ttrace.new_channel_client(q)
    for _ in range(3):
        ttrace.Trace.start_trace("r").client_record(cl, name="n")
    assert q.qsize() == 1 and q.get().name == "n"
    ttrace.Trace.start_trace("r").client_record(None)  # no client: dropped
    tclient.neutralize_client(cl)
    with pytest.raises(tclient.WouldBlockError):
        tclient.record(cl, ssf.SSFSpan())
    with pytest.raises(tclient.NoClientError):
        tclient.record(None, ssf.SSFSpan())


def test_packet_backend_delivers_datagrams():
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(5)
    port = rx.getsockname()[1]
    cl = tclient.Client(address=f"udp://127.0.0.1:{port}", capacity=8,
                        parallelism=1)
    try:
        span = _trace(ttrace, np.random.default_rng(9)).ssf_span()
        tclient.record(cl, span)
        got = ssf.decode_span(rx.recv(65536))
        assert _span_tuple(got) == _span_tuple(span)
    finally:
        cl.close()
        rx.close()


def test_stream_backend_buffers_until_flush(tmp_path):
    path = str(tmp_path / "ssf.sock")
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(1)
    received = io.BytesIO()

    def accept():
        conn, _ = srv.accept()
        with conn:
            while True:
                data = conn.recv(65536)
                if not data:
                    return
                received.write(data)

    t = threading.Thread(target=accept, daemon=True)
    t.start()
    backend = tbackend.StreamBackend(tbackend.BackendParams(
        f"unix://{path}", buffer_size=1 << 20))
    cl = tclient.new_backend_client(backend, capacity=4)
    try:
        spans = [ssf.SSFSpan(id=i + 1, name=f"s{i}") for i in range(3)]
        for span in spans:
            tclient.record(cl, span)
        tclient.flush(cl)
    finally:
        cl.close()
    t.join(5)
    srv.close()
    stream = io.BytesIO(received.getvalue())
    got = [wire.read_ssf(stream) for _ in spans]
    assert [s.id for s in got] == [1, 2, 3]
    stats = {}
    tclient.send_client_statistics(cl, stats.__setitem__)
    assert stats["trace_client.flushes_succeeded_total"] == 1.0
    assert stats["trace_client.records_succeeded_total"] == 3.0


def test_metrics_report_rides_a_span():
    q = queue.Queue(4)
    cl = ttrace.new_channel_client(q)
    batch = tsamples.Samples()
    batch.add(tsamples.count("a", 1.0), tsamples.gauge("b", 2.0))
    tmetrics.report(cl, batch)
    span = q.get()
    assert [s.name for s in span.metrics] == ["a", "b"]
    with pytest.raises(tmetrics.NoMetricsError):
        tmetrics.report_batch(cl, [])
