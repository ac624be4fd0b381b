"""The default flush shape end to end: a port ``Server`` with the JAX
package's defaults (``flush_columnar: true``, ``flush_pipeline_depth:
2``, ``flush_streaming: true``), its Datadog sink and local-file plugin
built from the config by the CLI's factory.

- A port Server and a JAX Server fed the same seeded DogStatsD lines
  post Datadog bodies that parse to the same series (names, tags, types,
  hosts exact; values exact but percentiles, within 0.02 x (max - min),
  and set estimates, rtol 1e-6), the same service checks and events,
  and append the same local-file TSV rows. Every row is posted exactly
  once, across the streamed chunks and the extras, and no InterMetric is
  built for a block.
- Depth 0 and depth 2, streaming and batch, and the per-row path
  (``flush_columnar: false``) give identical rows.
- A ``veneursinkonly:`` group falls back to per-row emission and keeps
  its routing.
- A forwarding local streams its digest groups as parts of their own;
  a port global merges them to the same weights as the batch forward.
  A part that fails re-merges into the local's live store and forwards
  with the next interval.
- The config keys of this slice load at their ``example.yaml`` values
  and refuse what the JAX package refuses.
"""

import csv
import gzip
import json
import threading
import time
import zlib
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import yaml

from veneur_tpu.config import Config as JConfig
from veneur_tpu.server import Server as JServer
from veneur_tpu_torch.cli import server as cli
from veneur_tpu_torch.config import (Config, UnsupportedConfig,
                                     config_from_dict)
from veneur_tpu_torch.core import columnar
from veneur_tpu_torch.native import egress
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

ROOT = Path(__file__).resolve().parents[1]
PCTS = [0.5, 0.99]
AGGS = ["min", "max", "count", "sum"]


@pytest.fixture(autouse=True)
def native_egress():
    if not egress.available():
        pytest.skip("no native toolchain")


class Recorder:
    """A fake Datadog ``post``: records (path, payload) and answers 202."""

    def __init__(self):
        self.requests = []

    def __call__(self, url, payload, compress=True, method="POST",
                 precompressed=False, out_info=None):
        path = url.split("?", 1)[0].split("http://dd", 1)[1]
        if precompressed:
            payload = json.loads(zlib.decompress(payload))
        self.requests.append((path, payload))
        return 202

    def payloads(self, path):
        return [p for q, p in self.requests if q == path]

    def series(self):
        return [s for p in self.payloads("/api/v1/series")
                for s in p["series"]]


def _lines(seed=21, n=48):
    rng = np.random.default_rng(seed)
    scopes = ("", "|#veneurlocalonly", "|#veneurglobalonly", "|#role:web",
              "|#host:h7,device:sda,env:prod")
    out = []
    for i in range(n):
        sc = scopes[i % len(scopes)]
        out.append(f"req.{i}:{int(rng.integers(1, 9))}|c|@0.5{sc}")
        out.append(f"mem.{i}:{rng.normal(0, 100):.4f}|g{sc}")
        for _ in range(5):
            out.append(f"lat.{i}:{rng.gamma(2.0, 8.0):.4f}|ms{sc}")
            out.append(f"size.{i}:{rng.gamma(3.0, 50.0):.3f}|h{sc}")
        out.append(f"users.{i}:u{int(rng.integers(0, 9))}|s{sc}")
    out += [f"_sc|check.{i}|{i % 4}|#role:web|m:msg{i}" for i in range(4)]
    out += ["_e{5,4}:title|text|#a:b", "_e{2,2}:t2|x2|h:evhost|t:warning"]
    return [ln.encode() for ln in out]


LINES = _lines()


def _cfg(tmp, **kw):
    base = dict(statsd_listen_addresses=[], interval="10s",
                percentiles=PCTS, aggregates=AGGS, hostname="h0",
                tags=["team:core"], datadog_api_key="k",
                datadog_api_hostname="http://dd",
                flush_file=str(Path(tmp) / "flush.tsv.gz"),
                store_initial_capacity=64, store_chunk=256)
    base.update(kw)
    return base


def _port_server(tmp, extra_sinks=(), **kw):
    cfg = Config(**_cfg(tmp, **kw))
    sinks, _, plugins = cli.config_sinks(cfg)
    dd = sinks[0]
    dd.post = Recorder()
    server = Server(cfg, metric_sinks=[dd, *extra_sinks], plugins=plugins,
                    device="cpu")
    return server, dd


def _feed(server, lines=LINES):
    for line in lines:
        assert server.handle_metric_packet(line), line


def _tsv(tmp):
    with gzip.open(Path(tmp) / "flush.tsv.gz", "rt") as f:
        rows = list(csv.reader(f, delimiter="\t"))
    # Name, Tags, MetricType, VeneurHostname, Interval, Timestamp, Value,
    # Partition: the timestamp columns depend on the flush's second
    return [(r[0], r[1], r[2], r[3], r[4], float(r[6])) for r in rows]


def _series_key(s):
    return (s["metric"], tuple(s.get("tags", [])), s["type"], s["host"],
            s.get("device_name", ""), s["interval"])


def _by_key(series):
    out = {}
    for s in series:
        key = _series_key(s)
        assert key not in out, f"posted twice: {key}"
        out[key] = s["points"][0][1]
    return out


def _assert_values_close(got: dict, want: dict):
    """Exact but for percentiles (within 0.02 x (max - min) of the
    series) and set estimates (rtol 1e-6)."""
    assert set(got) == set(want)
    for key, value in want.items():
        name = key[0]
        base, _, suffix = name.rpartition(".")
        if suffix.endswith("percentile"):
            span = (want[(f"{base}.max",) + key[1:]]
                    - want[(f"{base}.min",) + key[1:]])
            assert abs(got[key] - value) <= 0.02 * span + 1e-9, key
        elif name.startswith("users."):
            assert got[key] == pytest.approx(value, rel=1e-6), key
        else:
            assert got[key] == value, key


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Server's posts and TSV for LINES."""
    tmp = tmp_path_factory.mktemp("jax")
    server = JServer(JConfig(**_cfg(tmp)))
    (dd,) = server.metric_sinks
    dd.post = Recorder()
    _feed(server)
    server.flush()
    return dd.post, _tsv(tmp)


def test_server_matches_jax_server(tmp_path, jax_run, monkeypatch):
    jpost, jtsv = jax_run

    def no_rows(self):
        raise AssertionError("a block was materialized as InterMetrics")

    monkeypatch.setattr(columnar.ColumnarFlush, "to_intermetrics", no_rows)
    server, dd = _port_server(tmp_path)
    blocks = []
    real = server.store.flush

    def flush(*args, **kwargs):
        final = real(*args, **kwargs)
        blocks.append(final[0])
        return final

    server.store.flush = flush
    _feed(server)
    assert server.flush() > 0
    (col,) = blocks
    assert isinstance(col, columnar.ColumnarFlush)
    got = dd.post.series()
    # every row once: the streamed chunks carry the blocks, the fan-out
    # the extras (the status rows, posted as service checks)
    block_rows = sum(len(b) for b in col.blocks)
    assert dd.chunks_flushed >= 3 and dd.chunk_rows_acked == block_rows
    assert dd.chunk_rows_pending() == 0
    # the extras: the status rows (service checks) and, after the
    # stream, the global-only counters and gauges (per row, as in JAX)
    extras = Counter(m.type.value for m in col.extras)
    assert extras["status"] == 4
    assert len(got) == block_rows + len(col.extras) - 4
    _assert_values_close(_by_key(got),
                         {k: v for k, v in _by_key(jpost.series()).items()
                          if not k[0].startswith("veneur.")})

    def checks(post):  # the two servers flushed in different seconds
        return [{**c, "timestamp": None}
                for p in post.payloads("/api/v1/check_run") for c in p]

    assert checks(dd.post) == checks(jpost) and len(checks(jpost)) == 4

    def events(post):
        return [{**e, "tags": sorted(e["tags"]), "timestamp": None}
                for p in post.payloads("/intake")
                for e in p["events"]["api"]]

    assert events(dd.post) == events(jpost) and len(events(jpost)) == 2
    tsv = _tsv(tmp_path)
    assert Counter(r[:5] for r in tsv) == Counter(r[:5] for r in jtsv)
    _assert_values_close(
        {(r[0], r[1], r[2]): r[5] for r in tsv},
        {(r[0], r[1], r[2]): r[5] for r in jtsv
         if not r[0].startswith("veneur.")})


def _rows_of(tmp, **kw):
    """(series posted by key, TSV rows) of one port Server flush."""
    server, dd = _port_server(tmp, **kw)
    _feed(server)
    server.flush()
    tsv = sorted(_tsv(tmp))
    return _by_key(dd.post.series()), tsv, dd


def test_depths_streaming_and_per_row_give_identical_rows(tmp_path):
    """The same interval through every flush shape: the same rows, the
    same values, bit for bit (the same retired generation on the same
    device); the per-row path holds the columnar rows as a multiset."""
    runs = {}
    for name, kw in (("default", {}),
                     ("depth0", dict(flush_pipeline_depth=0)),
                     ("batch", dict(flush_streaming=False)),
                     ("per_row", dict(flush_columnar=False))):
        sub = tmp_path / name
        sub.mkdir()
        runs[name] = _rows_of(sub, **kw)
    series, tsv, dd = runs["default"]
    assert series and dd.chunks_flushed >= 3
    for name in ("depth0", "batch", "per_row"):
        assert runs[name][0] == series, name
        assert runs[name][1] == tsv, name
    # only the streaming shapes streamed
    assert runs["depth0"][2].chunks_flushed == 0
    assert runs["batch"][2].chunks_flushed == 0
    assert runs["per_row"][2].chunks_flushed == 0


def test_sink_routed_group_falls_back_to_per_row(tmp_path):
    chan = ChannelMetricSink()
    server, dd = _port_server(tmp_path, extra_sinks=[chan])
    routed = [f"r.{i}:{i}|h|#veneursinkonly:datadog".encode()
              for i in range(4)]
    _feed(server, routed + [b"plain:1|h", b"c:2|c"])
    captured = []
    real = server.store.flush
    server.store.flush = lambda *a, **k: captured.append(real(*a, **k)) \
        or captured[-1]
    server.flush()
    col = captured[0][0]
    # the routed histogram group went per row (extras), the counters
    # stayed a block
    assert {m.name.split(".")[0] for m in col.extras} == {"r", "plain"}
    assert [b.suffixes for b in col.blocks] == [[b""]]
    assert all(m.sinks == frozenset({"datadog"}) for m in col.extras
               if m.name.startswith("r."))
    to_dd = {s["metric"] for s in dd.post.series()}
    to_chan = {m.name for m in chan.get_flush(timeout=10)}
    assert {f"r.{i}.max" for i in range(4)} <= to_dd
    assert not any(n.startswith("r.") for n in to_chan)
    assert "plain.max" in to_chan and "c" in to_chan


def _wait(cond, timeout=30.0):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, "timed out"
        time.sleep(0.02)


@pytest.fixture(scope="module")
def pair():
    """One port global (HTTP /import) and two port locals forwarding to
    it, one streaming (the default) and one batch (``flush_streaming:
    false``), shared by the forward tests: each test's flushes leave
    every store empty, so they run one after another on the same
    servers."""
    gsink = ChannelMetricSink()
    small = dict(store_initial_capacity=64, store_chunk=256)
    glob = Server(Config(http_address="127.0.0.1:0", interval="3600s",
                         percentiles=PCTS, aggregates=AGGS, hostname="g",
                         **small),
                  metric_sinks=[gsink], device="cpu")
    glob.start()
    locals_ = {}
    try:
        for name, kw in (("streamed", {}),
                         ("batch", dict(flush_streaming=False))):
            # a CPU flush under load can take seconds: the streamed
            # parts' budget (it starts with the flush) gets room for it
            local = Server(Config(
                interval="3600s", percentiles=PCTS, aggregates=AGGS,
                hostname="l", retry_max=0, forward_timeout="120s",
                forward_address=f"http://127.0.0.1:{glob.ops_server.port}",
                **small, **kw), device="cpu")
            local.start()
            locals_[name] = local
        yield glob, gsink, locals_
    finally:
        for local in locals_.values():
            local.shutdown()
        glob.shutdown()


def _customer_names(names):
    return sum(not n.startswith("veneur.") for n in names)


def _global_counts(pair, name, fail_first_part=False):
    """The ``name`` local of ``pair``, fed LINES, forwards to the
    global over HTTP; returns the global's flushed rows by (name, tags),
    but the servers' own self-metrics (``veneur.*``: each flush's span
    re-enters its server, and a local forwards its ``veneur.*`` timers
    with its next flush), and the number of POSTs the local made."""
    glob, gsink, locals_ = pair
    local = locals_[name]
    merged0 = glob.ops_server.import_pool.merged_batches
    real = local.forward_fn
    failed = []
    posts = []

    def forward(state, deadline=None):
        if fail_first_part and not failed and (
                state.histograms_columnar is not None):
            # the part's names arenas: (blob, offsets, lengths)
            blob, offs, lens = state.histograms_columnar[0]
            failed.append(_customer_names(
                bytes(blob[o:o + n]).decode() for o, n in zip(offs, lens)))
            return False
        ok = real(state, deadline=deadline)
        posts.append(ok)
        return ok

    local.forward_fn = forward
    try:
        _feed(local)
        local.flush()
        assert local.wait_forward(30) is True
        if fail_first_part:
            # re-merged into the live store, forwarded next interval
            assert failed and _customer_names(
                local.store.histograms.interner.names) == failed[0]
            local.flush()
            assert local.wait_forward(30) is True
            assert _customer_names(
                local.store.histograms.interner.names) == 0
    finally:
        local.forward_fn = real
    _wait(lambda: glob.ops_server.import_pool.merged_batches
          == merged0 + len(posts))
    glob.flush()
    rows = gsink.get_flush(timeout=10)
    return {(m.name, tuple(m.tags)): m.value for m in rows
            if not m.name.startswith("veneur.")}, len(posts)


@pytest.fixture(scope="module")
def streamed_forward(pair):
    """The global's rows after a default (streaming) local's forward."""
    return _global_counts(pair, "streamed")


def test_streamed_forward_merges_like_batch_forward(pair, streamed_forward):
    """Each digest group's planes arrive in a body of their own: the
    global merges the same digests, so it emits the same percentiles,
    set estimates and global counters and gauges, bit for bit."""
    streamed, posts = streamed_forward
    batch, batch_posts = _global_counts(pair, "batch")
    assert batch_posts == 1 and posts == 3  # histograms, timers, the rest
    assert streamed == batch
    assert any(k[0].startswith("size.") and k[0].endswith("percentile")
               for k in batch)


def test_failed_part_forwards_next_interval(pair, streamed_forward):
    """The failed histograms part re-merges into the local's live store
    and forwards with the next flush: the global ends with every sample
    once, as with no failure."""
    clean, _ = streamed_forward
    requeued, _ = _global_counts(pair, "streamed", fail_first_part=True)
    assert requeued == clean


def test_config_keys_of_this_slice():
    """Every key this slice adds that example.yaml sets loads at its
    example value; nonsense values are refused as the JAX package
    refuses them; the Datadog span sink stays refused."""
    example = yaml.safe_load((ROOT / "example.yaml").read_text())
    keys = ("flush_columnar", "flush_pipeline_depth", "flush_streaming",
            "sink_requeue_max_bytes", "datadog_api_hostname",
            "datadog_api_key", "datadog_flush_max_per_body", "flush_file")
    cfg = config_from_dict({k: example[k] for k in keys})
    jcfg = JConfig(**{k: example[k] for k in keys})
    jcfg.apply_defaults()
    jcfg.validate()
    for k in keys:
        assert getattr(cfg, k) == getattr(jcfg, k), k
    assert (cfg.flush_columnar, cfg.flush_pipeline_depth,
            cfg.flush_streaming) == (True, 2, True)
    assert cfg.sink_requeue_max_bytes == 32 * 1048576
    assert cfg.datadog_flush_max_per_body == 25000
    # the deprecated spelling maps over, as in the JAX package
    old, jold = Config(flush_max_per_body=77), JConfig(flush_max_per_body=77)
    jold.apply_defaults()
    assert old.datadog_flush_max_per_body == jold.datadog_flush_max_per_body \
        == 77
    for bad in ({"flush_pipeline_depth": -1},
                {"sink_requeue_max_bytes": -1}):
        with pytest.raises(ValueError, match=next(iter(bad))):
            JConfig(**bad).validate()
        with pytest.raises(ValueError, match=next(iter(bad))):
            Config(**bad)
    # the span sink's key loads to the JAX package's value; a key neither
    # package knows is refused
    assert config_from_dict({"datadog_trace_api_address": "http://x:8126"}) \
        .datadog_trace_api_address == JConfig(
            datadog_trace_api_address="http://x:8126") \
        .datadog_trace_api_address
    with pytest.raises(UnsupportedConfig, match="datadog_bogus_address"):
        config_from_dict({"datadog_bogus_address": "http://x:8126"})
    # the CLI's factory: a Datadog sink iff both keys are set, the plugin
    # iff flush_file is
    assert cli.config_sinks(Config(hostname="h")) == ([], [], [])
    sinks, _, plugins = cli.config_sinks(Config(
        hostname="h", datadog_api_key="k", datadog_api_hostname="http://dd/",
        flush_file="/dev/null"))
    assert [s.name for s in sinks] == ["datadog"]
    assert sinks[0].dd_hostname == "http://dd"
    assert [p.name for p in plugins] == ["localfile"]


def test_default_config_streams_through_a_real_http_sink(tmp_path):
    """The default post over a real socket: a stdlib receiver on
    127.0.0.1 inflates every series body."""
    got = []

    class Receiver(BaseHTTPRequestHandler):
        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            if self.headers.get("Content-Encoding") == "deflate":
                body = zlib.decompress(body)
            got.append((self.path.split("?")[0], json.loads(body)))
            self.send_response(202)
            self.end_headers()

        def log_message(self, *args):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Receiver)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        cfg = Config(**_cfg(
            tmp_path, datadog_api_hostname=(
                f"http://127.0.0.1:{httpd.server_address[1]}")))
        sinks, _, plugins = cli.config_sinks(cfg)
        server = Server(cfg, metric_sinks=sinks, plugins=plugins,
                        device="cpu")
        _feed(server)
        server.flush()
    finally:
        httpd.shutdown()
        httpd.server_close()
    series = [s for path, body in got if path == "/api/v1/series"
              for s in body["series"]]
    # the blocks in streamed chunks, the global-only rows per row
    assert len(series) == sinks[0].metrics_flushed > sinks[0].chunk_rows_acked
    assert sinks[0].flush_errors == 0 and sinks[0].chunk_rows_acked > 0
    assert {p for p, _ in got} == {"/api/v1/series", "/api/v1/check_run",
                                   "/intake"}
