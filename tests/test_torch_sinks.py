"""The port's remaining sinks, the S3 plugin and the sink factory against
the JAX package's, on the CPU.

Each sink of the port and of the JAX package gets a fake transport that
records what it would send, and the same seeded input: a flush of the
same DogStatsD lines (each package's store), the same ``EmissionBlock``s
or the same spans. Held:

* SignalFx: given the same blocks, byte-identical ``/v2/datapoint``
  bodies from the C++ serializer (with the host dimension renamed or
  excluded, common dimensions and excluded tags); each store's columnar
  and per-row flushes, the ``vary_by`` fan-out to per-tag clients, and
  the events, equal to the JAX sink's;
* the Datadog span sink's ring and its ``PUT /v0.3/traces`` body;
* Kafka: the metric messages; the span messages (protobuf bytes equal
  to ``sample_pb2.SSFSpan.SerializeToString``, and a native reader's
  ``LazySpan`` hands over its datagram; JSON equal to the JAX sink's);
  sampling by tag and by rate keeping the same traces;
* LightStep: each tracer's converted spans (the round robin by trace id);
* gRPC: the port's span sink into the JAX ``SpanSinkServer`` and the JAX
  sink into the port's decode to the spans sent;
* the S3 plugin's objects (per row and columnar) with a stub client;
* ``create_sinks``: the same sinks, span sinks and plugins, by name and
  in order, as the JAX factory for a table of configs;
* the CLI's ``config_sinks`` hands them all to the Server.
"""

import gzip
import json
import logging

import numpy as np
import pytest

from veneur_tpu.config import Config as JConfig
from veneur_tpu.core import MetricStore as JStore
from veneur_tpu.core.columnar import ColumnarFlush as JColumnarFlush
from veneur_tpu.plugins.s3 import S3Plugin as JS3Plugin
from veneur_tpu.protocol.gen.ssf import sample_pb2 as pb
from veneur_tpu.resilience import RetryPolicy as JRetryPolicy
from veneur_tpu.samplers import HistogramAggregates as JAggs
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.sinks import factory as jfactory
from veneur_tpu.sinks.datadog import DatadogSpanSink as JDatadogSpanSink
from veneur_tpu.sinks.grpsink import GRPCSpanSink as JGRPCSpanSink
from veneur_tpu.sinks.grpsink import SpanSinkServer as JSpanSinkServer
from veneur_tpu.sinks.kafka import KafkaMetricSink as JKafkaMetricSink
from veneur_tpu.sinks.kafka import KafkaSpanSink as JKafkaSpanSink
from veneur_tpu.sinks.lightstep import LightStepSpanSink as JLightStep
from veneur_tpu.sinks.signalfx import SignalFxSink as JSignalFxSink
from veneur_tpu_torch import native
from veneur_tpu_torch.cli import server as cli
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.core.columnar import ColumnarFlush
from veneur_tpu_torch.core.store import MetricStore
from veneur_tpu_torch.native import egress
from veneur_tpu_torch.plugins.s3 import S3Plugin
from veneur_tpu_torch.protocol import ssf
from veneur_tpu_torch.resilience import RetryPolicy
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates
from veneur_tpu_torch.sinks import factory
from veneur_tpu_torch.sinks.datadog import DatadogSpanSink
from veneur_tpu_torch.sinks.grpsink import GRPCSpanSink, SpanSinkServer
from veneur_tpu_torch.sinks.kafka import KafkaMetricSink, KafkaSpanSink
from veneur_tpu_torch.sinks.lightstep import LightStepSpanSink
from veneur_tpu_torch.sinks.signalfx import SignalFxSink

AGG_NAMES = ["min", "max", "count"]
PCTS = [0.5, 0.9]


def _lines(seed: int = 11) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(40):
        tags = ("|#host:h%d,role:web,drop_me:x" % (i % 3) if i % 4 == 0
                else "|#role:db" if i % 2 else "")
        out.append(f"c.{i}:{int(rng.integers(1, 9))}|c{tags}")
        out.append(f"g.{i}:{rng.normal(0, 50):.3f}|g{tags}")
        out += [f"h.{i}:{int(rng.integers(0, 100))}|h{tags}"
                for _ in range(5)]
        out.append(f"s.{i}:u{i % 7}|s{tags}")
    out.append("_sc|chk.a|1|#role:web|m:hello")
    out.append("_sc|chk.b|2|h:otherhost")
    return [ln.encode() for ln in out]


def _stores(columnar: bool):
    """(port flush, JAX flush) of the same lines at timestamp 1000."""
    t = MetricStore(initial_capacity=64, chunk=256, device="cpu")
    j = JStore(initial_capacity=64, chunk=256)
    for line in _lines():
        if line.startswith(b"_sc"):
            t.process_metric(tparser.parse_service_check(line))
            j.process_metric(jparser.parse_service_check(line))
        else:
            t.process_metric(tparser.parse_metric(line))
            j.process_metric(jparser.parse_metric(line))
    tfin, _ = t.flush(PCTS, HistogramAggregates.from_names(AGG_NAMES), 1000,
                      columnar=columnar)
    jfin, _, _ = j.flush(PCTS, JAggs.from_names(AGG_NAMES), is_local=False,
                         now=1000, forward=False, columnar=columnar)
    return tfin, jfin


@pytest.fixture(scope="module")
def flushes():
    if not egress.available():
        pytest.skip("no native toolchain")
    return {"columnar": _stores(True), "rows": _stores(False)}


# --- SignalFx ---------------------------------------------------------------


class FakeSfxClient:
    """Records what a SignalFxClient would POST and answers 200."""

    def __init__(self):
        self.points, self.raw, self.events = [], [], []

    def submit(self, points):
        self.points.extend(points)
        return 200

    def submit_raw(self, body):
        self.raw.append(body)
        return 200

    def submit_event(self, event):
        self.events.append(event)
        return 200

    def datapoints(self):
        """Every datapoint sent, raw bodies and per-row alike."""
        out = [{k: v for k, v in p.items() if k != "_sfx_type"}
               | {"type": p["_sfx_type"]} for p in self.points]
        for body in self.raw:
            for kind, pts in json.loads(body).items():
                out += [p | {"type": kind} for p in pts]
        return sorted(out, key=lambda p: json.dumps(p, sort_keys=True))


SFX_VARIANTS = {
    "plain": dict(hostname_tag="host"),
    "common_and_excluded": dict(hostname_tag="host",
                                common_dimensions={"env": "prod",
                                                   "role": "over"},
                                excluded_tags=["drop_me", "env"]),
    "host_excluded": dict(hostname_tag="hn", excluded_tags=["hn"]),
}


def _sfx_pair(**kw):
    tclient, jclient = FakeSfxClient(), FakeSfxClient()
    kw.setdefault("hostname", "box")
    tsink = SignalFxSink(client=tclient,
                         retry_policy=RetryPolicy(max_attempts=1), **kw)
    jsink = JSignalFxSink(client=jclient,
                          retry_policy=JRetryPolicy(max_attempts=1), **kw)
    return (tsink, tclient), (jsink, jclient)


@pytest.mark.parametrize("variant", sorted(SFX_VARIANTS))
def test_signalfx_same_blocks_give_identical_bodies(variant, flushes):
    tfin, _ = flushes["columnar"]
    (tsink, tc), (jsink, jc) = _sfx_pair(**SFX_VARIANTS[variant])
    tsink.flush_columnar(ColumnarFlush(1000, blocks=tfin.blocks))
    jsink.flush_columnar(JColumnarFlush(1000, blocks=tfin.blocks))
    assert len(tc.raw) == len(tfin.blocks) >= 4
    assert sorted(tc.raw) == sorted(jc.raw)
    rows = sum(len(b) for b in tfin.blocks)
    assert tsink.metrics_flushed == jsink.metrics_flushed == rows
    assert len(tc.datapoints()) == rows
    dims = [p["dimensions"] for p in tc.datapoints()]
    excluded = SFX_VARIANTS[variant].get("excluded_tags", [])
    assert not any(k in d for d in dims for k in excluded)


@pytest.mark.parametrize("variant", sorted(SFX_VARIANTS))
def test_signalfx_flushes_match_jax(variant, flushes):
    """Each store's columnar flush (blocks and per-row extras) and its
    per-row flush send the JAX sink's datapoints."""
    (tsink, tc), (jsink, jc) = _sfx_pair(**SFX_VARIANTS[variant])
    tfin, jfin = flushes["columnar"]
    tsink.flush_columnar(tfin)
    jsink.flush_columnar(jfin)
    assert tc.datapoints() == jc.datapoints()
    assert {p["metric"] for p in tc.points} == {"chk.a", "chk.b"}
    (tsink, trows), (jsink, jrows) = _sfx_pair(**SFX_VARIANTS[variant])
    tfin, jfin = flushes["rows"]
    tsink.flush(tfin.to_intermetrics())
    jsink.flush(jfin)
    assert trows.datapoints() == jrows.datapoints() == tc.datapoints()


def test_signalfx_vary_by_fans_out_like_jax(flushes):
    """With vary_by the value of the tag picks the client: the columnar
    flush takes the per-row path, one submission a client."""
    tfin, jfin = flushes["columnar"]
    clients = {}
    for pkg in ("t", "j"):
        clients[pkg] = {"web": FakeSfxClient(), "db": FakeSfxClient()}
    (tsink, tc), (jsink, jc) = _sfx_pair(
        hostname_tag="host", vary_by="role")
    tsink.clients_by_tag_value = clients["t"]
    jsink.clients_by_tag_value = clients["j"]
    tsink.flush_columnar(tfin)
    jsink.flush_columnar(jfin)
    assert not tc.raw and tc.datapoints() == jc.datapoints()
    for role in ("web", "db"):
        got = clients["t"][role].datapoints()
        assert got == clients["j"][role].datapoints()
        assert got and all(p["dimensions"]["role"] == role for p in got)


def test_signalfx_events_match_jax():
    lines = [b"_e{5,4}:title|text|#a:b,c",
             b"_e{2,2}:t2|x2|d:1500|h:evhost|k:agg|p:low|t:warning|s:src"]
    (tsink, tc), (jsink, jc) = _sfx_pair(
        hostname_tag="host", common_dimensions={"dc": "x"},
        excluded_tags=["a"])
    tsink.flush_other_samples([tparser.parse_event(ln, now=5)
                               for ln in lines])
    jsink.flush_other_samples([jparser.parse_event(ln, now=5)
                               for ln in lines])
    assert tc.events == jc.events and len(tc.events) == 2
    assert tc.events[1]["dimensions"]["host"] == "evhost"
    assert tsink.events_reported == 2


# --- spans -----------------------------------------------------------------


def _span_fields(rng, i: int) -> dict:
    start = 1_700_000_000_000_000_000 + int(rng.integers(0, 10 ** 9))
    tags = {"resource": f"/r{i % 3}"} if i % 2 else {"k": f"v{i % 5}"}
    return dict(version=1, trace_id=100 + i % 7, id=1000 + i,
                parent_id=int(rng.integers(-1, 3)),
                start_timestamp=start,
                end_timestamp=start + int(rng.integers(1, 10 ** 6)),
                error=bool(i % 3 == 0), service=f"svc{i % 4}",
                name=f"op.{i}" if i % 5 else "", indicator=bool(i % 2),
                tags=tags)


def _span_pairs(n: int = 24, seed: int = 5):
    """(port spans, protobuf spans) of the same seeded fields, each with
    an embedded sample."""
    rng = np.random.default_rng(seed)
    ours, theirs = [], []
    for i in range(n):
        f = _span_fields(rng, i)
        sample = dict(metric=i % 4, name=f"m.{i}", value=float(i) / 3,
                      sample_rate=1.0, tags={"t": str(i)})
        span = ssf.SSFSpan(metrics=[ssf.SSFSample(**sample)], **f)
        p = pb.SSFSpan(**{k: v for k, v in f.items() if k != "tags"})
        p.tags.update(f["tags"])
        s = p.metrics.add(**{k: v for k, v in sample.items()
                             if k != "tags"})
        s.tags.update(sample["tags"])
        ours.append(span)
        theirs.append(p)
    return ours, theirs


def test_datadog_span_sink_matches_jax():
    """The newest buffer_size spans, grouped by trace, PUT without
    deflate."""
    ours, theirs = _span_pairs()
    posts = {"t": [], "j": []}

    def recorder(key):
        def post(url, payload, compress=True, method="POST",
                 precompressed=False):
            posts[key].append((url, payload, compress, method))
            return 202
        return post

    tsink = DatadogSpanSink("http://agent:8126/", buffer_size=16,
                            post=recorder("t"))
    jsink = JDatadogSpanSink("http://agent:8126/", buffer_size=16,
                             post=recorder("j"))
    for a, b in zip(ours, theirs):
        tsink.ingest(a)
        jsink.ingest(b)
    with pytest.raises(ValueError):
        tsink.ingest(ssf.SSFSpan(trace_id=1))
    tsink.flush()
    jsink.flush()
    assert posts["t"] == posts["j"]
    ((url, traces, compress, method),) = posts["t"]
    assert (url, compress, method) == ("http://agent:8126/v0.3/traces",
                                       False, "PUT")
    assert sorted(s["span_id"] for t in traces for s in t) == [
        1000 + i for i in range(8, 24)]
    assert all(len({s["trace_id"] for s in t}) == 1 for t in traces)
    assert tsink.spans_flushed == jsink.spans_flushed == 16
    tsink.flush()  # an empty ring posts nothing
    assert len(posts["t"]) == 1


class FakeProducer:
    def __init__(self):
        self.messages = []

    def produce(self, topic, value):
        self.messages.append((topic, value))


def test_kafka_metric_messages_match_jax(flushes):
    tfin, jfin = flushes["rows"]
    tp, jp = FakeProducer(), FakeProducer()
    tsink = KafkaMetricSink("b:9092", "metrics", "checks", "events",
                            producer=tp)
    jsink = JKafkaMetricSink("b:9092", "metrics", "checks", "events",
                             producer=jp)
    rows = tfin.to_intermetrics()
    tsink.flush(rows)
    jsink.flush(jfin)
    assert sorted(tp.messages) == sorted(jp.messages)
    assert len(tp.messages) == len(rows) == tsink.metrics_flushed
    assert {t for t, _ in tp.messages} == {"metrics"}
    assert {json.loads(v)["type"] for _, v in tp.messages} == {
        "counter", "gauge", "status"}


@pytest.mark.parametrize("fmt", ["protobuf", "json"])
def test_kafka_span_messages_match_jax(fmt):
    ours, theirs = _span_pairs()
    tp, jp = FakeProducer(), FakeProducer()
    tsink = KafkaSpanSink("b:9092", "spans", serialization_format=fmt,
                          producer=tp)
    jsink = JKafkaSpanSink("b:9092", "spans", serialization_format=fmt,
                           producer=jp)
    for a, b in zip(ours, theirs):
        tsink.ingest(a)
        jsink.ingest(b)
    if fmt == "protobuf":
        assert [v for _, v in tp.messages] == [
            p.SerializeToString() for p in theirs]
    else:
        assert [json.loads(v) for _, v in tp.messages] == [
            json.loads(v) for _, v in jp.messages]
    assert tp.messages == jp.messages
    assert tsink.spans_flushed == len(ours)


def test_kafka_lazy_span_bytes_are_its_datagram():
    """A native reader's LazySpan hands the Kafka sink the bytes it
    received, and every sink reads it as the decoded span."""
    if not native.available():
        pytest.skip("no native toolchain")
    _, theirs = _span_pairs(8)
    raws = [p.SerializeToString() for p in theirs]
    lazy = native.decode_spans(raws).spans()
    tp = FakeProducer()
    sink = KafkaSpanSink("b:9092", "spans", producer=tp)
    for span in lazy:
        sink.ingest(span)
    assert [v for _, v in tp.messages] == raws
    tj = FakeProducer()
    KafkaSpanSink("b:9092", "spans", serialization_format="json",
                  producer=tj).ingest(lazy[3])
    tk = FakeProducer()
    KafkaSpanSink("b:9092", "spans", serialization_format="json",
                  producer=tk).ingest(ssf.decode_span(raws[3]))
    assert tj.messages == tk.messages


@pytest.mark.parametrize("tag,rate", [("", 30), ("k", 100), ("k", 50),
                                      ("resource", 10)])
def test_kafka_sampling_keeps_the_jax_traces(tag, rate):
    ours, theirs = _span_pairs(200, seed=9)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        a.trace_id = b.trace_id = 10_000 + 7919 * i
    tp, jp = FakeProducer(), FakeProducer()
    kw = dict(sample_tag=tag, sample_rate_percentage=rate)
    tsink = KafkaSpanSink("b:9092", "spans", producer=tp, **kw)
    jsink = JKafkaSpanSink("b:9092", "spans", producer=jp, **kw)
    for a, b in zip(ours, theirs):
        tsink.ingest(a)
        jsink.ingest(b)
    assert tp.messages == jp.messages
    assert tsink.spans_dropped == jsink.spans_dropped
    assert 0 < len(tp.messages) < len(ours) or (tag == "k" and rate == 100)


def test_lightstep_conversion_and_round_robin_match_jax():
    ours, theirs = _span_pairs(30)
    reports = {"t": [], "j": []}

    def factory_of(key):
        def make(**kw):
            box = []
            reports[key].append(box)

            class Tracer:
                def report(self, span):
                    box.append(span)
            return Tracer()
        return make

    kw = dict(collector="http://ls:9000", num_clients=3, maximum_spans=64)
    tsink = LightStepSpanSink(tracer_factory=factory_of("t"), **kw)
    jsink = JLightStep(tracer_factory=factory_of("j"), **kw)
    for a, b in zip(ours, theirs):
        tsink.ingest(a)
        jsink.ingest(b)
    assert reports["t"] == reports["j"]
    assert all(s["trace_id"] % 3 == i for i, box in enumerate(reports["t"])
               for s in box)
    assert (tsink.host, tsink.port, tsink.plaintext) == ("ls", 9000, True)
    tsink.flush()


def test_lightstep_buffering_tracer_drops_oldest():
    ours, _ = _span_pairs(12)
    sink = LightStepSpanSink("ls", maximum_spans=5)
    for span in ours:
        sink.ingest(span)
    (tracer,) = sink.tracers
    assert [s["span_id"] for s in tracer.drain()] == [
        1000 + i for i in range(7, 12)]
    assert tracer.dropped == 7 and sink.port == 8080


def test_grpc_span_sinks_interoperate():
    """The port's sink into the JAX SpanSinkServer, and the JAX sink into
    the port's: each side decodes the spans the other sent."""
    ours, theirs = _span_pairs(10)
    jserver, tserver = JSpanSinkServer(), SpanSinkServer()
    jport, tport = jserver.start("127.0.0.1:0"), tserver.start(
        "127.0.0.1:0")
    tsink = GRPCSpanSink(f"127.0.0.1:{jport}", name="falconer")
    jsink = JGRPCSpanSink(f"127.0.0.1:{tport}")
    try:
        for a, b in zip(ours, theirs):
            tsink.ingest(a)
            jsink.ingest(b)
        assert [s.SerializeToString() for s in jserver.spans] == [
            p.SerializeToString() for p in theirs]
        assert tserver.spans == ours
        assert (tsink.name, tsink.sent_count, tsink.drop_count) == (
            "falconer", 10, 0)
    finally:
        for closer in (tsink.close, jsink.close, jserver.stop,
                       tserver.stop):
            closer()


def test_grpc_span_sink_counts_drops_and_logs_once(caplog):
    ours, _ = _span_pairs(4)
    sink = GRPCSpanSink("127.0.0.1:1", timeout=0.2)
    try:
        with caplog.at_level(logging.ERROR, logger="veneur.sinks.grpc"):
            for span in ours:
                sink.ingest(span)
        assert sink.drop_count == 4 and sink.sent_count == 0
        assert 1 <= len(caplog.records) < 4
    finally:
        sink.close()


# --- the S3 plugin and the factory -----------------------------------------


class StubS3:
    def __init__(self):
        self.puts = []

    def put_object(self, Bucket, Key, Body):  # noqa: N803 - boto3's names
        self.puts.append((Bucket, Key, Body))


def test_s3_plugin_objects_match_jax(flushes):
    tfin, jfin = flushes["columnar"]
    ts, js = StubS3(), StubS3()
    tplug = S3Plugin("hostA", bucket="b", interval=10, svc=ts)
    jplug = JS3Plugin("hostA", bucket="b", interval=10, svc=js)
    tplug.flush_columnar(tfin)
    jplug.flush_columnar(jfin)
    trows, jrows = flushes["rows"]
    tplug.flush(trows.to_intermetrics())
    jplug.flush(jrows)
    assert len(ts.puts) == len(js.puts) == 2
    for (tb, tk, tbody), (jb, jk, jbody) in zip(ts.puts, js.puts):
        assert tb == jb == "b"
        assert tk.split("/")[:4] == jk.split("/")[:4]
        assert tk.split("/")[3] == "hostA" and tk.endswith(".tsv.gz")
        got, want = gzip.decompress(tbody), gzip.decompress(jbody)
        assert sorted(got.splitlines()) == sorted(want.splitlines())
        # every row but the two status checks, which TSV leaves out
        assert got.count(b"\n") == len(trows.to_intermetrics()) - 2
    from veneur_tpu_torch.plugins.s3 import S3ClientUninitializedError

    with pytest.raises(S3ClientUninitializedError):
        S3Plugin("h").flush([])


FACTORY_CONFIGS = {
    "none": {},
    "everything": dict(
        signalfx_api_key="k", signalfx_endpoint_base="http://sfx",
        signalfx_per_tag_api_keys=[{"name": "web", "api_key": "kw"}],
        datadog_api_key="k", datadog_api_hostname="http://dd",
        datadog_trace_api_address="http://agent:8126",
        lightstep_collector_host="http://ls:8080",
        falconer_address="127.0.0.1:1", kafka_broker="127.0.0.1:1",
        kafka_metric_topic="m", kafka_span_topic="s",
        debug_flushed_metrics=True, debug_ingested_spans=True,
        aws_s3_bucket="bkt", flush_file="/dev/null"),
    "kafka_spans_only": dict(kafka_broker="127.0.0.1:1",
                             kafka_span_topic="s"),
    "deprecated_lightstep": dict(
        trace_lightstep_collector_host="ls:1", datadog_api_key="k",
        datadog_api_hostname="http://dd", ssf_buffer_size=7,
        datadog_trace_api_address="http://agent:1"),
}


def _names(built):
    return tuple([type(x).__name__ + ":" + x.name for x in part]
                 for part in built)


@pytest.mark.parametrize("case", sorted(FACTORY_CONFIGS))
def test_create_sinks_matches_jax(case):
    data = dict(FACTORY_CONFIGS[case], hostname="h", tags=["env:prod"])
    jcfg = JConfig(**data)
    jcfg.apply_defaults()
    ours = factory.create_sinks(Config(**data))
    theirs = jfactory.create_sinks(jcfg)
    try:
        assert _names(ours) == _names(theirs)
        assert factory.span_sinks_configured(Config(**data)) == \
            jfactory.span_sinks_configured(jcfg) == bool(ours[1])
        for sink in ours[1]:
            if type(sink).__name__ == "DatadogSpanSink":
                assert sink.buffer_size == theirs[1][0].buffer_size
    finally:
        for sink in ours[0] + ours[1] + theirs[0] + theirs[1]:
            if hasattr(sink, "close"):
                sink.close()


def test_cli_hands_every_sink_to_the_server(monkeypatch, tmp_path):
    """``config_sinks`` gives the factory's three lists, which the CLI
    passes to its Server as the config-driven ones (a SIGHUP reload
    rebuilds them), with no injected sink and the CLI's device."""
    path = tmp_path / "c.yaml"
    path.write_text("hostname: h\ndatadog_trace_api_address: "
                    "http://agent:1\nsignalfx_api_key: k\n"
                    "signalfx_endpoint_base: http://sfx\n")
    built = {}

    class StopAfterInit(Exception):
        pass

    def fake_server(config, metric_sinks=None, span_sinks=None,
                    plugins=None, device=None, config_sinks=None):
        assert (metric_sinks, span_sinks, plugins) == (None, None, None)
        built.update(zip(("metric", "span", "plugins"), config_sinks),
                     device=device)
        raise StopAfterInit

    monkeypatch.setattr(cli, "Server", fake_server)
    with pytest.raises(StopAfterInit):
        cli.main(["-f", str(path), "--device", "cpu"])
    assert [s.name for s in built["metric"]] == ["signalfx"]
    assert [s.name for s in built["span"]] == ["datadog"]
    assert built["plugins"] == [] and built["device"] == "cpu"
    assert tuple(map(len, cli.config_sinks(Config(hostname="h")))) == (
        0, 0, 0)
