"""The port's Datadog metric sink against the JAX package's, with a fake
``post`` that records every request.

The same seeded DogStatsD lines go into a port store and a JAX store;
each sink gets its own store's flush. Its columnar bodies
(``flush_columnar``), its streamed chunk bodies (``flush_chunk``) and
its per-row bodies (``flush``) parse to the same series as the JAX
sink's: names, tags, types, hosts, devices and intervals exact, values
exact too (counters, gauges, histogram min/max/count, set estimates of
a few members). Given the SAME emission blocks, the two sinks post
byte-identical deflated bodies. Events and service checks post the
same JSON payloads.
"""

import json
import zlib

import numpy as np
import pytest

from veneur_tpu.core import MetricStore as JStore
from veneur_tpu.core.pipeline import FlushChunk as JChunk
from veneur_tpu.resilience import RetryPolicy as JRetryPolicy
from veneur_tpu.samplers import HistogramAggregates as JAggs
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.sinks.datadog import DatadogMetricSink as JSink
from veneur_tpu_torch.core.pipeline import FlushChunk
from veneur_tpu_torch.core.store import MetricStore
from veneur_tpu_torch.native import egress
from veneur_tpu_torch.resilience import RetryPolicy
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates
from veneur_tpu_torch.sinks.datadog import DatadogMetricSink

AGG_NAMES = ["min", "max", "count"]
TAGS = ["team:core", "dc:x"]


@pytest.fixture(autouse=True)
def native_egress():
    if not egress.available():
        pytest.skip("no native toolchain")


class Recorder:
    """A fake ``post``: records (path, payload, how) and answers 202."""

    def __init__(self):
        self.requests = []

    def __call__(self, url, payload, compress=True, method="POST",
                 precompressed=False, out_info=None):
        path = url.split("?", 1)[0].split("http://dd", 1)[1]
        self.requests.append((path, payload, precompressed, compress))
        return 202

    def series(self):
        out = []
        for path, payload, pre, _ in self.requests:
            if path != "/api/v1/series":
                continue
            body = json.loads(zlib.decompress(payload)) if pre else payload
            out.extend(body["series"])
        return out

    def payloads(self, path):
        return [p for q, p, _, _ in self.requests if q == path]


def _lines(seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(60):
        tags = ("|#host:h%d,device:d%d,role:web" % (i % 3, i % 2)
                if i % 5 == 0 else "|#role:db" if i % 2 else "")
        out.append(f"c.{i}:{int(rng.integers(1, 9))}|c{tags}")
        out.append(f"g.{i}:{rng.normal(0, 50):.3f}|g{tags}")
        for _ in range(4):
            out.append(f"h.{i}:{int(rng.integers(0, 100))}|h{tags}")
        out.append(f"s.{i}:u{i % 7}|s{tags}")
    out.append("_sc|chk.a|1|#role:web|m:hello")
    out.append("_sc|chk.b|2|h:otherhost")
    return [ln.encode() for ln in out]


def _stores(columnar: bool):
    """(port flush, JAX flush) of the same lines, timestamp 1000."""
    t = MetricStore(initial_capacity=64, chunk=256, device="cpu")
    j = JStore(initial_capacity=64, chunk=256)
    for line in _lines():
        if line.startswith(b"_sc"):
            t.process_metric(tparser.parse_service_check(line))
            j.process_metric(jparser.parse_service_check(line))
        else:
            t.process_metric(tparser.parse_metric(line))
            j.process_metric(jparser.parse_metric(line))
    tfin, _ = t.flush([], HistogramAggregates.from_names(AGG_NAMES), 1000,
                      columnar=columnar)
    jfin, _, _ = j.flush([], JAggs.from_names(AGG_NAMES), is_local=False,
                         now=1000, forward=False, columnar=columnar)
    return tfin, jfin


def _sinks(max_per_body=25):
    tpost, jpost = Recorder(), Recorder()
    kw = dict(interval=10, flush_max_per_body=max_per_body, hostname="h0",
              tags=TAGS, dd_hostname="http://dd", api_key="k")
    tsink = DatadogMetricSink(post=tpost,
                              retry_policy=RetryPolicy(max_attempts=1),
                              **kw)
    jsink = JSink(post=jpost, retry_policy=JRetryPolicy(max_attempts=1),
                  **kw)
    return (tsink, tpost), (jsink, jpost)


def _key(s):
    return (s["metric"], tuple(s["tags"]), s["type"], s["host"],
            s.get("device_name", ""), s["interval"],
            tuple(tuple(p) for p in s["points"]))


def _sorted_series(series):
    return sorted(_key(s) for s in series)


def test_columnar_bodies_parse_like_jax():
    tfin, jfin = _stores(columnar=True)
    (tsink, tpost), (jsink, jpost) = _sinks()
    tsink.flush_columnar(tfin)
    jsink.flush_columnar(jfin)
    got = _sorted_series(tpost.series())
    assert got == _sorted_series(jpost.series())
    # counter, gauge, set estimate and min/max/count a series
    assert len(got) == sum(len(b) for b in tfin.blocks) == 60 * 6
    # the service checks rode the extras, per row
    assert tpost.payloads("/api/v1/check_run") == jpost.payloads(
        "/api/v1/check_run")
    assert {c["check"] for c in tpost.payloads("/api/v1/check_run")[0]} \
        == {"chk.a", "chk.b"}
    assert tsink.metrics_flushed == jsink.metrics_flushed


def test_same_blocks_post_byte_identical_bodies():
    """Given the same EmissionBlocks, both sinks post the same bytes,
    through the batch and the streamed path alike."""
    tfin, _ = _stores(columnar=True)
    (tsink, tpost), (jsink, jpost) = _sinks(max_per_body=7)
    tsink.flush_columnar(tfin)
    jsink.flush_columnar(tfin)
    tbodies = sorted(p for p in tpost.payloads("/api/v1/series"))
    assert tbodies == sorted(jpost.payloads("/api/v1/series"))
    (tsink, tpost), (jsink, jpost) = _sinks(max_per_body=7)
    for seq, blk in enumerate(tfin.blocks):
        tsink.flush_chunk(FlushChunk(seq, "g", [blk], len(blk), 1000))
        jsink.flush_chunk(JChunk(seq, "g", [blk], len(blk), 1000))
    assert tpost.payloads("/api/v1/series") == jpost.payloads(
        "/api/v1/series")
    assert sorted(tpost.payloads("/api/v1/series")) == tbodies
    rows = sum(len(b) for b in tfin.blocks)
    assert tsink.chunk_rows_acked == jsink.chunk_rows_acked == rows


def test_chunked_bodies_parse_like_columnar():
    tfin, _ = _stores(columnar=True)
    (tsink, tpost), _ = _sinks(max_per_body=4)
    for seq, blk in enumerate(tfin.blocks):
        tsink.flush_chunk(FlushChunk(seq, "g", [blk], len(blk), 1000))
    (csink, cpost), _ = _sinks(max_per_body=4)
    csink.flush_columnar(tfin)
    assert _sorted_series(tpost.series()) == _sorted_series(cpost.series())
    assert all(len(json.loads(zlib.decompress(p))["series"]) <= 4
               for p in tpost.payloads("/api/v1/series"))


def test_per_row_bodies_parse_like_jax_and_columnar():
    tfin, jfin = _stores(columnar=False)
    (tsink, tpost), (jsink, jpost) = _sinks()
    tsink.flush(tfin.to_intermetrics())
    jsink.flush(jfin)
    got = _sorted_series(tpost.series())
    assert got == _sorted_series(jpost.series())
    assert tpost.payloads("/api/v1/check_run") == jpost.payloads(
        "/api/v1/check_run")
    # per-row dicts keep an empty device_name; the native bodies omit it
    tcol, _ = _stores(columnar=True)
    (csink, cpost), _ = _sinks()
    csink.flush_columnar(tcol)
    assert got == _sorted_series(cpost.series())
    # equal-size parts of at most flush_max_per_body (datadog.go:127-146)
    sizes = [len(p["series"]) for p in tpost.payloads("/api/v1/series")]
    assert max(sizes) <= 25 and max(sizes) - min(sizes) <= 1


def test_events_post_like_jax():
    lines = [b"_e{5,4}:title|text|#a:b,c",
             b"_e{2,2}:t2|x2|d:1500|h:evhost|k:agg|p:low|t:warning|"
             b"s:src|#z"]
    (tsink, tpost), (jsink, jpost) = _sinks()
    tsink.flush_other_samples([tparser.parse_event(ln, now=5)
                               for ln in lines])
    jsink.flush_other_samples([jparser.parse_event(ln, now=5)
                               for ln in lines])
    # the JAX sample's tags are a protobuf map: compare them as sets

    def events(post):
        (payload,) = post.payloads("/intake")
        return [{**e, "tags": sorted(e["tags"])}
                for e in payload["events"]["api"]]

    assert events(tpost) == events(jpost)
    (payload,) = tpost.payloads("/intake")
    event, other = payload["events"]["api"]
    assert event["host"] == "h0" and other["host"] == "evhost"
    assert other["alert_type"] == "warning" and event["tags"][-2:] == TAGS
    tsink.flush_other_samples([])  # nothing to send, no request
    assert len(tpost.requests) == 1
