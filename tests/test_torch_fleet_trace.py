"""The port's fleet trace plane (``veneur_tpu_torch/obs/tracectx.py``,
``obs/fleet.py``, the ``X-Veneur-Trace`` hops, ``veneur.fleet.*`` and the
fleet's self-metrics) against the JAX package's.

* The primitives on the same seeded input (numpy seed 17):
  ``TraceContext`` encode and decode (malformed and unknown fields
  included), ``from_headers`` case-insensitively, ``HopLog``'s bound and
  freshness min, and ``stitch_trace`` over the same entries give equal
  results in both packages.
* Cross-package hops over HTTP and gRPC, both ways: a JAX local into a
  port global and a port local into a JAX global; the header crosses,
  the receiving global's ``/debug/trace`` (the local among its
  ``fleet_peers``) stitches ``local.flush``, ``global.import`` and
  ``global.flush`` under the local's trace id in wall order, and a port
  global's next flush emits ``veneur.fleet.e2e_age_ns``, each value
  within the time from the first UDP send to the sink's receipt.
* The proxy re-parents: the global's import hangs under the
  ``proxy.fan_out`` hop, not under the local's flush.
* ``FleetAggregator`` keeps a dead peer's last good pull, stale, as the
  JAX one does; the handoff's and the replication's hops are recorded
  and counted in ``veneur.trace.hops_total``.
* The fleet's self-metric samples (``veneur.handoff.*``, ``veneur.ha.*``,
  ``veneur.checkpoint.*``, ``veneur.fleet.*``) equal the JAX flusher's
  on the same counters, and the config keys load as the JAX ones do.

Every Server runs on the CPU (``device="cpu"``); forwards have at most a
60 s budget.
"""

import json
import socket
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from veneur_tpu import flusher as jflusher
from veneur_tpu.config import Config as JConfig
from veneur_tpu.config import read_config as jread_config
from veneur_tpu.discovery import RingWatcher as JRingWatcher
from veneur_tpu.discovery import StaticDiscoverer as JStatic
from veneur_tpu.obs import HopLog as JHopLog
from veneur_tpu.obs import TraceContext as JContext
from veneur_tpu.obs import fleet as jfleet
from veneur_tpu.obs import tracectx as jtracectx
from veneur_tpu.server import Server as JServer
from veneur_tpu.sinks import ChannelMetricSink as JChannel
from veneur_tpu_torch import flusher as tflusher
from veneur_tpu_torch.config import (Config, read_config,
                                     read_proxy_config)
from veneur_tpu_torch.discovery import RingWatcher, StaticDiscoverer
from veneur_tpu_torch.fleet.handoff import encode_handoff
from veneur_tpu_torch.fleet.standby import StandbyManager
from veneur_tpu_torch.obs import (HopLog, StageRecorder, TraceContext,
                                  fleet, tracectx)
from veneur_tpu_torch.proxy.proxy import Proxy
from veneur_tpu_torch.config import ProxyConfig
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

from tests.test_torch_handoff import (MutableDiscoverer, fill_store,
                                      make_handoff_global, make_store)

SEED = 17
FWD_TIMEOUT = "60s"
SMALL = dict(interval="86400s", percentiles=[0.5, 0.99],
             aggregates=["count"], store_initial_capacity=32,
             store_chunk=128)


def _wait(cond, timeout=60.0, what="condition"):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, json.loads(r.read())


# -- the primitives, one seeded input through both packages --------------


def _header_values(rng):
    out = []
    for _ in range(64):
        t, p, i = (int(x) for x in rng.integers(0, 1 << 62, 3))
        out.append(f"trace={t};parent={p};ingest={i}")
        out.append(f" ingest={i} ; future=x;trace={t};parent={p};extra=7")
        out.append(f"parent={p};ingest={i}")          # no trace
        out.append(f"trace=-{t};parent={p}")          # negative trace
        out.append(f"trace={t};parent=-5;ingest=junk")
    return out + ["", "garbage", "trace=", "trace=0", ";;;", "trace=1",
                  "trace=12;parent", "trace=0x10"]


def _fields(ctx):
    return None if ctx is None else (ctx.trace_id, ctx.parent_id,
                                     ctx.ingest_ns)


def test_trace_context_codec_matches_jax():
    rng = np.random.default_rng(SEED)
    for value in _header_values(rng):
        got, want = TraceContext.decode(value), JContext.decode(value)
        assert _fields(got) == _fields(want), value
        if got is not None:
            assert got.encode() == want.encode()
            assert _fields(TraceContext.decode(got.encode())) == \
                _fields(got)
            child = got.child(99)
            assert _fields(child) == (got.trace_id, 99, got.ingest_ns)
    assert tracectx.HEADER == jtracectx.HEADER == "X-Veneur-Trace"
    assert tracectx.TRACED_ROUTES == jtracectx.TRACED_ROUTES


def test_from_headers_is_case_insensitive_like_jax():
    import email.message

    value = "trace=5;parent=6;ingest=7"
    msg = email.message.Message()
    msg["x-VENEUR-trace"] = value
    for headers in ({"X-Veneur-Trace": value}, {"x-veneur-trace": value},
                    {"X-VENEUR-TRACE": value}, msg,
                    [("x-veneur-trace", value)], {}, None,
                    {"x-veneur-trace": "bogus"}):
        if isinstance(headers, list):  # gRPC metadata, as the server reads
            headers = dict(headers)
        got = TraceContext.from_headers(headers)
        assert _fields(got) == _fields(JContext.from_headers(headers))
    assert _fields(TraceContext.from_headers(msg)) == (5, 6, 7)


def test_hop_log_bound_and_freshness_min_match_jax():
    rng = np.random.default_rng(SEED + 1)
    logs = (HopLog(capacity=16), JHopLog(capacity=16))
    for batch in range(3):
        for _ in range(int(rng.integers(5, 30))):
            kind = int(rng.integers(0, 3))
            t, p = (int(x) for x in rng.integers(1, 1 << 40, 2))
            ingest = int(rng.integers(0, 1 << 50)) if kind else 0
            start = float(rng.uniform(1e9, 2e9))
            end = start + float(rng.uniform(0, 2))
            for log, ctx_t in zip(logs, (TraceContext, JContext)):
                ctx = None if kind == 2 and ingest % 2 else ctx_t(t, p,
                                                                  ingest)
                log.record("global.import", ctx, start, end, metrics=batch)
        got, want = (lg.snapshot() for lg in logs)
        assert got == want and got["pending"] <= 16
        assert [{k: v for k, v in h.items() if k != "span_id"}
                for h in logs[0].peek()] == \
            [{k: v for k, v in h.items() if k != "span_id"}
             for h in logs[1].peek()]
        oldest = [lg.take_oldest_ingest_ns() for lg in logs]
        assert oldest[0] == oldest[1]
        assert [lg.take_oldest_ingest_ns() for lg in logs] == [None, None]
        if batch == 1:
            assert len(logs[0].drain()) == len(logs[1].drain())
    assert logs[0].dropped_total == logs[1].dropped_total > 0


def _stitch_sources(rng, tid):
    """Seeded timeline entries and pending hops across three origins:
    entries published under ``tid`` (with an off-path forward stage),
    entries whose ``import_traces`` hold it, stages stamped with it (a
    drained hop with its true wall times, or relative ones), noise."""
    sources = []
    for origin in ("self", "10.0.0.1:8127", "10.0.0.2:8127"):
        entries, pending = [], []
        for _ in range(int(rng.integers(2, 6))):
            w0 = float(1.7e9 + rng.uniform(0, 30))
            dur = float(rng.uniform(0.01, 3))
            owner = int(rng.choice([tid, tid + 1, 0]))
            stages = [{"name": "store", "start_ns": 1000,
                       "duration_ns": int(dur * 5e8)}]
            if owner == tid:
                stages.append({"name": "forward", "off_path": True,
                               "start_ns": int(dur * 9e8),
                               "duration_ns": int(rng.integers(1, 1e9))})
            if rng.random() < 0.5:
                hop = {"name": "global.import", "off_path": True,
                       "trace_id": int(rng.choice([tid, tid + 1])),
                       "start_ns": 0, "duration_ns": int(2e8),
                       "ingest_ns": int(w0 * 1e9) - int(rng.integers(
                           1, 5e9)), "metrics": 3}
                if rng.random() < 0.5:
                    hop["wall_start"] = w0 - 1.0
                    hop["wall_end"] = w0 - 0.5
                stages.append(hop)
            entry = {"wall_start": w0, "wall_end": w0 + dur,
                     "total_duration_ns": int(dur * 1e9),
                     "coverage_ratio": 0.9, "interval": len(entries),
                     "stages": stages}
            if owner:
                entry.update(trace_id=owner, span_id=int(rng.integers(
                    1, 1 << 62)), hop="local.flush")
            if rng.random() < 0.4:
                entry["import_traces"] = sorted({tid, tid + 7})
            entries.append(entry)
        for _ in range(int(rng.integers(0, 3))):
            w0 = float(1.7e9 + rng.uniform(0, 30))
            pending.append({"hop": "handoff.receive", "trace_id": tid,
                            "wall_start": w0, "wall_end": w0 + 0.1,
                            "duration_ns": int(1e8)})
        sources.append((origin, entries, pending))
    return sources


def test_stitch_trace_matches_jax():
    rng = np.random.default_rng(SEED + 2)
    for round_ in range(20):
        tid = int(rng.integers(1, 1 << 40))
        sources = _stitch_sources(rng, tid)
        for which in (tid, tid + 1, tid + 7, 12345):
            got = fleet.stitch_trace(which, sources)
            assert got == jfleet.stitch_trace(which, sources), round_
            if got["hops"]:
                assert 0.0 < got["hop_coverage_ratio"] <= 1.0
                starts = [h["wall_start"] for h in got["hops"]]
                assert starts == sorted(starts)


def test_adopt_without_span_id_and_wall_to_mono_match_jax():
    rec = StageRecorder()
    rec.adopt_trace(41, hop="handoff.send")
    assert rec.span_id > 0 and rec.trace_id == 41
    for wall in (rec.wall_start - 3.5, rec.wall_start, rec.wall_start + 2):
        assert tracectx.wall_to_mono_ns(rec, wall) == \
            jtracectx.wall_to_mono_ns(rec, wall)
    entry = rec.finish()
    assert (entry["trace_id"], entry["hop"]) == (41, "handoff.send")


# -- the header on the forwarders -------------------------------------------


class _Capture(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        self.server.captured.append(dict(self.headers))
        self.send_response(202)
        self.send_header("Content-Length", "0")
        self.end_headers()


def test_http_forward_sends_the_jax_headers():
    from veneur_tpu.trace import Trace as JTrace
    from veneur_tpu_torch.forward import HTTPForwarder
    from veneur_tpu_torch.trace import Trace

    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Capture)
    srv.captured = []
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        addr = f"127.0.0.1:{srv.server_address[1]}"
        store = make_store()
        fill_store(store, n=4)
        _, state = store.flush([0.5], tflusher_aggs(), 0, is_local=True,
                               forward=True)
        ctx = TraceContext(11, 12, 13)
        assert HTTPForwarder(addr, timeout=10.0).forward(
            state, parent_span=Trace.start_trace("f"), trace_ctx=ctx)
        assert HTTPForwarder(addr, timeout=10.0).forward(state)
        got, bare = srv.captured
        assert got["X-Veneur-Trace"] == "trace=11;parent=12;ingest=13"
        assert "X-Veneur-Trace" not in bare
        # the flush span's parent context: the JAX span's header names
        want = {k.lower() for k in JTrace.start_trace("f")
                .context_as_parent()}
        assert want and want <= {k.lower() for k in got}
        assert not want & {k.lower() for k in bare}
    finally:
        srv.shutdown()
        srv.server_close()


def tflusher_aggs():
    from veneur_tpu_torch.samplers.intermetric import HistogramAggregates

    return HistogramAggregates.from_names(["count"])


# -- cross-package hops: one trace id from a local's flush to the global's


def _udp_send(port, lines):
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
        for i in range(0, len(lines), 8):
            tx.sendto(b"\n".join(lines[i:i + 8]), ("127.0.0.1", port))


def _lines():
    rng = np.random.default_rng(SEED + 3)
    out = [b"local.only:1|c"]
    for i in range(12):
        out.append(f"fleet.c.{i}:{int(rng.integers(1, 9))}|c|"
                   "#veneurglobalonly".encode())
        out.append(f"fleet.h.{i}:{rng.gamma(2.0, 8.0):.4f}|h".encode())
    return out


def _global(pkg, proto, peers_file):
    cfg = dict(SMALL, http_address="127.0.0.1:0",
               fleet_peers=f"file://{peers_file}", fleet_pull_timeout="10s")
    if proto == "grpc":
        cfg["grpc_address"] = "127.0.0.1:0"
    if pkg == "port":
        sink = ChannelMetricSink()
        return Server(Config(**cfg), metric_sinks=[sink],
                      device="cpu"), sink
    sink = JChannel()
    return JServer(JConfig(**cfg), metric_sinks=[sink]), sink


def _local(pkg, proto, glob):
    if proto == "grpc":
        fwd = dict(forward_address=f"127.0.0.1:{glob.import_server.port}",
                   forward_use_grpc=True)
    else:
        fwd = dict(forward_address=f"http://127.0.0.1:"
                                   f"{glob.ops_server.port}")
    cfg = dict(SMALL, http_address="127.0.0.1:0",
               forward_timeout=FWD_TIMEOUT, **fwd)
    if pkg == "port":
        sink = ChannelMetricSink()
        return Server(Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                             **cfg), metric_sinks=[sink],
                      device="cpu"), sink
    sink = JChannel()
    return JServer(JConfig(statsd_listen_addresses=[], **cfg),
                   metric_sinks=[sink]), sink


def _feed_and_flush(local, lsink, port_local: bool):
    """The lines into the local (over its UDP lanes on a port local, so
    each chunk carries an ingest stamp), one local flush; returns the
    wall second of the first send and the local's timeline entry."""
    lines = _lines()
    t_send = time.time()
    if port_local:
        _udp_send(local.statsd_addrs[0][1], lines)
        _wait(lambda: local.store.processed >= len(lines), what="ingest")
    else:
        for line in lines:
            local.handle_metric_packet(line)
    local.flush()
    lsink.get_flush(timeout=60)
    return t_send, local.obs_timeline.entries()[-1]


def _imports_of(glob, tid):
    return [h for h in glob.obs_hops.peek()
            if h["hop"] == "global.import" and h.get("trace_id") == tid]


def _settled(get, quiet=1.0):
    """``get()`` once it is not empty and its length held for ``quiet``
    seconds (a streamed forward's parts land one by one)."""
    _wait(get, what="the first hop")
    n, since = -1, time.time()
    while time.time() - since < quiet:
        got = get()
        if len(got) != n:
            n, since = len(got), time.time()
        time.sleep(0.05)
    return got


def _settled_imports(glob, tid):
    return _settled(lambda: _imports_of(glob, tid))


@pytest.mark.parametrize("way", ["jax->port", "port->jax"])
@pytest.mark.parametrize("proto", ["http", "grpc"])
def test_cross_package_hop_stitches_one_trace(way, proto, tmp_path):
    local_pkg, global_pkg = way.split("->")
    peers = tmp_path / "peers"
    peers.write_text("")
    glob, gsink = _global(global_pkg, proto, peers)
    glob.start()
    try:
        local, lsink = _local(local_pkg, proto, glob)
        local.start()
        try:
            peers.write_text(f"127.0.0.1:{local.ops_server.port}\n")
            t_send, lentry = _feed_and_flush(local, lsink,
                                             local_pkg == "port")
            assert lentry["hop"] == "local.flush"
            tid = lentry["trace_id"]
            # the forward runs off the flush path; each merged body or
            # frame parks its global.import hop under the local's trace
            hops = _settled_imports(glob, tid)
            assert all(h["parent_span_id"] == lentry["span_id"]
                       for h in hops)
            assert all(h["protocol"] == proto for h in hops)
            glob.flush()
            rows = gsink.get_flush(timeout=60)
            t_recv = time.time()
            gentry = glob.obs_timeline.entries()[-1]
            # the same trace id in both timelines
            assert gentry["hop"] == "global.flush"
            assert tid in gentry["import_traces"]
            assert gentry["e2e_age_ns"] > 0
            status, data = _get(glob.ops_server.port,
                                f"/debug/trace?id={tid}")
            assert status == 200 and data["trace_id"] == tid
            names = [h["hop"] for h in data["hops"]]
            for hop in ("local.flush", "global.import", "global.flush"):
                assert hop in names, (hop, names)
            assert names.index("local.flush") < \
                names.index("global.import") < names.index("global.flush")
            assert 0.0 < data["hop_coverage_ratio"] <= 1.0
            assert {r.name for r in rows if not r.name.startswith(
                "veneur.")} >= {"fleet.c.0", "fleet.h.0.50percentile"}
            if global_pkg == "port":
                glob.flush()   # the e2e sample's rows: the next flush
                by = {r.name: r for r in gsink.get_flush(timeout=60)}
                assert by["veneur.fleet.e2e_age_ns.count"].value >= 1
                assert "stage:e2e" in by[
                    "veneur.fleet.e2e_age_ns.50percentile"].tags
                if local_pkg == "port":
                    # the lanes' stamp: not before the first send, and
                    # aged no more than until the sink had the rows
                    bound = (t_recv - t_send) * 1e9
                    for s in ("min", "max", "50percentile"):
                        v = by[f"veneur.fleet.e2e_age_ns.{s}"].value
                        assert 0 < v <= bound, (s, v, bound)
        finally:
            local.shutdown()
    finally:
        glob.shutdown()


def test_port_pair_freshness_is_taken_at_the_swap():
    """A hop recorded after the swap ages the NEXT interval: the stamp
    the first flush read is the lanes' and the first import's, and a
    late import's stamp waits for the second."""
    srv = Server(Config(statsd_listen_addresses=[], **SMALL), device="cpu",
                 metric_sinks=[ChannelMetricSink()])
    srv.start()
    try:
        srv.obs_hops.record("global.import", TraceContext(1, 2, 1000),
                            time.time(), time.time())
        real = srv.store.flush

        def flush(*a, **kw):
            out = real(*a, **kw)
            # lands mid-flush, after the swap
            srv.obs_hops.record("global.import", TraceContext(3, 4, 500),
                                time.time(), time.time())
            return out

        srv.store.flush = flush
        srv.flush()
        srv.store.flush = real
        # both hops publish with the interval that drained them, but the
        # freshness min was read before the late one landed
        assert srv.obs_timeline.entries()[-1]["import_traces"] == [1, 3]
        assert srv._interval_oldest_ingest_ns == 1000
        srv.flush()
        entry = srv.obs_timeline.entries()[-1]
        assert srv._interval_oldest_ingest_ns == 500
        assert "import_traces" not in entry and entry["e2e_age_ns"] > 0
    finally:
        srv.shutdown()


# -- the proxy re-parents ------------------------------------------------


def test_proxy_reparents_the_import_under_its_fan_out(tmp_path):
    peers = tmp_path / "peers"
    peers.write_text("")
    glob, gsink = _global("port", "http", peers)
    glob.start()
    proxy = Proxy(ProxyConfig(
        http_address="127.0.0.1:0",
        forward_address=f"http://127.0.0.1:{glob.ops_server.port}",
        forward_timeout=FWD_TIMEOUT))
    proxy.start()
    try:
        lsink = ChannelMetricSink()
        local = Server(Config(
            statsd_listen_addresses=["udp://127.0.0.1:0"],
            http_address="127.0.0.1:0", forward_timeout=FWD_TIMEOUT,
            forward_address=f"http://127.0.0.1:{proxy.port}", **SMALL),
            metric_sinks=[lsink], device="cpu")
        local.start()
        try:
            peers.write_text(f"127.0.0.1:{local.ops_server.port}\n"
                             f"127.0.0.1:{proxy.port}\n")
            _, lentry = _feed_and_flush(local, lsink, True)
            tid = lentry["trace_id"]
            assert local.wait_forward(60) is True
            # a fan-out a POST the local made (its streamed parts too),
            # and an import a fan-out
            fans = _settled(proxy.obs_timeline.entries)
            _wait(lambda: len(_imports_of(glob, tid)) == len(fans),
                  what="the import hops")
            fan_spans = {e["span_id"] for e in fans}
            for e in fans:
                assert (e["trace_id"], e["hop"]) == (tid, "proxy.fan_out")
                assert e["parent_span_id"] == lentry["span_id"]
                assert [s["name"] for s in e["stages"]] == [
                    f"post.http://127.0.0.1:{glob.ops_server.port}"]
            for h in _imports_of(glob, tid):
                assert h["parent_span_id"] in fan_spans
                assert h["parent_span_id"] != lentry["span_id"]
            # an untraced batch publishes no hop
            proxy.proxy_metrics([{"name": "x", "type": "counter",
                                  "tags": [], "value": 1}])
            assert len(proxy.obs_timeline.entries()) == len(fans)
            glob.flush()
            gsink.get_flush(timeout=60)
            _, data = _get(glob.ops_server.port, f"/debug/trace?id={tid}")
            names = [h["hop"] for h in data["hops"]]
            order = [names.index(n) for n in (
                "local.flush", "proxy.fan_out", "global.import",
                "global.flush")]
            assert order == sorted(order), names
        finally:
            local.shutdown()
    finally:
        proxy.shutdown()
        glob.shutdown()


# -- the fleet aggregator ------------------------------------------------


class _Peer(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_GET(self):
        path = self.path.partition("?")[0]
        if path == "/debug/flush-timeline":
            body = {"published_total": 3, "instance_uid": "peer-uid",
                    "intervals": [{"interval": 2, "hop": "local.flush",
                                   "trace_id": 77, "span_id": 5,
                                   "wall_start": 1.7e9,
                                   "wall_end": 1.7e9 + 1,
                                   "total_duration_ns": 10 ** 9,
                                   "coverage_ratio": 0.95,
                                   "stages": []}]}
        elif path == "/debug/vars":
            body = {"time": 1}
        else:
            self.send_response(404)
            self.end_headers()
            return
        data = json.dumps(body).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


def test_aggregator_keeps_a_dead_peers_last_good_pull_like_jax():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Peer)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    peer = f"127.0.0.1:{srv.server_address[1]}"
    aggs = (fleet.FleetAggregator(
        watcher=RingWatcher(StaticDiscoverer([peer]), "t"),
        pull_timeout=2.0, pull_interval=3600.0),
        jfleet.FleetAggregator(
            watcher=JRingWatcher(JStatic([peer]), "t"), pull_timeout=2.0,
            pull_interval=3600.0))

    def views():
        out = []
        for agg in aggs:
            status, body, _ = agg.fleet_route({"refresh": "1"})
            assert status == 200
            data = json.loads(body)
            for p in data["peers"].values():
                p.pop("pulled_at")
            out.append(data)
        return out

    try:
        got, want = views()
        assert got == want and got["peers"][peer]["ok"] is True
        status, body, _ = aggs[0].trace_route({"id": "77"})
        assert status == 200 and json.loads(body)["hops"][0]["origin"] \
            == peer
    finally:
        srv.shutdown()
        srv.server_close()
    got, want = views()
    assert got == want
    summary = got["peers"][peer]
    assert (summary["ok"], summary["stale"]) == (False, True)
    assert summary["last_interval"]["interval"] == 2
    assert got["pull_errors_total"] == 1
    # a forced miss refresh at most once a window: an unknown id 404s
    status, _, _ = aggs[0].trace_route({"id": "5"})
    assert status == 404 and aggs[0].pull_errors_total == 2
    status, _, _ = aggs[0].trace_route({"id": "6"})
    assert status == 404 and aggs[0].pull_errors_total == 2
    assert aggs[0].trace_route({"id": "x"})[0] == 400


def test_debug_fleet_serves_a_stopped_local_stale(tmp_path):
    peers = tmp_path / "peers"
    glob = Server(Config(statsd_listen_addresses=[],
                         http_address="127.0.0.1:0",
                         fleet_peers=f"file://{peers}",
                         fleet_pull_interval="1ms", **SMALL),
                  device="cpu")
    local = Server(Config(statsd_listen_addresses=[],
                          http_address="127.0.0.1:0", **SMALL),
                   device="cpu")
    glob.start()
    local.start()
    addr = f"127.0.0.1:{local.ops_server.port}"
    peers.write_text(addr + "\n")
    try:
        local.flush()
        _, data = _get(glob.ops_server.port, "/debug/fleet?refresh=1")
        assert data["peers"][addr]["ok"] and not data["peers"][addr][
            "stale"]
        local.shutdown()
        _, data = _get(glob.ops_server.port, "/debug/fleet?refresh=1")
        assert data["peers"][addr]["stale"] is True
        assert data["peers"][addr]["published_total"] >= 1
        _, dvars = _get(glob.ops_server.port, "/debug/vars")
        assert dvars["obs"]["fleet"]["pull_errors_total"] >= 1
        assert dvars["obs"]["hops"]["pending"] == 0
    finally:
        glob.shutdown()


# -- the handoff's and the replication's hops ------------------------------


def test_handoff_hop_stitches_sender_to_receiver():
    recv, _, addr_r = make_handoff_global("fr")
    send, _, addr_s = make_handoff_global("fs")
    try:
        disc = MutableDiscoverer([addr_s])
        mgr = send.handoff_manager
        mgr.watcher = RingWatcher(disc, "t")
        assert mgr.refresh()["adopted"] == [addr_s]
        fill_store(send.store, n=16, seed=4)
        disc.members = [addr_s, addr_r]
        summary = mgr.refresh()
        assert summary["sent"] == [addr_r]
        sent = send.obs_timeline.entries()[-1]
        assert (sent["hop"], sent["kind"]) == ("handoff.send", "handoff")
        assert {"handoff.extract", "handoff.stream"} <= {
            s["name"] for s in sent["stages"]}
        (hop,) = recv.obs_hops.peek()
        assert hop["hop"] == "handoff.receive"
        assert (hop["trace_id"], hop["parent_span_id"]) == (
            sent["trace_id"], sent["span_id"])
        assert hop["series"] == summary["moved_series"]
        # the receiver's /debug/trace, the sender among its peers
        recv.fleet_aggregator.watcher = RingWatcher(
            StaticDiscoverer([addr_s]), "t")
        _, data = _get(recv.ops_server.port,
                       f"/debug/trace?id={sent['trace_id']}")
        assert [h["hop"] for h in data["hops"]] == [
            "handoff.send", "handoff.receive"]
        # an untraced POST /handoff records nothing
        assert recv.handoff_manager.handle_handoff(
            encode_handoff({}, {"id": "bare", "sender": "x", "epoch": 1,
                                "series": 0}, time.time()))[0] == 200
        assert len(recv.obs_hops.peek()) == 1
    finally:
        send.shutdown()
        recv.shutdown()


def test_replication_hop_counted_in_hops_total():
    sink = ChannelMetricSink()
    sby_srv = Server(Config(statsd_listen_addresses=[], **SMALL),
                     metric_sinks=[sink], device="cpu")
    sby_srv.start()
    try:
        # the standby's receiver, recording into the Server's hop log
        standby = StandbyManager(make_store(), "http://b", [],
                                 hop_log=sby_srv.obs_hops)
        store = make_store()
        fill_store(store, n=8, seed=6)
        active = StandbyManager(store, "http://a", ["http://b"])
        active.is_leader = True
        # the JAX package's standby reads the same header off the same
        # stream
        from veneur_tpu.fleet.standby import StandbyManager as JStandby
        from veneur_tpu.core.store import MetricStore as JStore

        jlog = JHopLog()
        jstandby = JStandby(JStore(initial_capacity=32, chunk=128), "http://j",
                            [], hop_log=jlog)
        sent = []

        def post(url, blob, timeout, out, ctx=None):
            headers = {tracectx.HEADER: ctx.encode()}
            sent.append(jstandby.handle_replicate(blob, headers=headers)[0])
            return standby.handle_replicate(blob, headers=headers)[0]

        active._post_blob = post
        groups, epoch = store.snapshot_state()
        active.capture(groups, epoch, trace_ctx=TraceContext(9, 10))
        assert active.dispatch()["sent"] == ["http://b"] and sent == [200]
        (hop,) = sby_srv.obs_hops.peek()
        assert (hop["hop"], hop["trace_id"], hop["sender"]) == (
            "ha.replicate", 9, "http://a")
        (jhop,) = jlog.peek()
        assert {k: jhop[k] for k in ("hop", "trace_id", "parent_span_id",
                                     "series", "sender")} == \
            {k: hop[k] for k in ("hop", "trace_id", "parent_span_id",
                                 "series", "sender")}
        sby_srv.flush()
        _wait(lambda: "veneur.trace.hops_total" in
              sby_srv.store.counters.interner.names, what="the span")
        sby_srv.flush()
        rows = [r for r in sink.get_flush(timeout=60)
                if r.name == "veneur.trace.hops_total"]
        assert [(r.value, r.tags) for r in rows] == [
            (1.0, ["hop:ha.replicate"])]
    finally:
        sby_srv.shutdown()


# -- the fleet's self-metrics -----------------------------------------------


def _samples(fn, server):
    return sorted(
        (s.name, int(s.metric), round(float(s.value), 6),
         tuple(sorted(dict(s.tags).items()))) for s in fn(server))


def _counters(rng, names):
    return {n: int(rng.integers(0, 100)) for n in names}


def test_fleet_self_metric_samples_match_jax():
    rng = np.random.default_rng(SEED + 4)
    breakers = types.SimpleNamespace(states=lambda: [("http://b", 1.0)])
    for _ in range(3):
        mgr = types.SimpleNamespace(
            epoch=int(rng.integers(1, 1 << 30)),
            last_duration_ns=int(rng.integers(0, 2)) * 5 * 10 ** 8,
            breakers=breakers, **_counters(rng, (
                "resizes_total", "moved_series_total", "sent_total",
                "send_failures_total", "requeued_series_total",
                "received_series_total", "duplicates_total",
                "retries_total", "requeue_retries_total",
                "spool_errors_total")))
        sby = types.SimpleNamespace(
            is_leader=bool(rng.integers(0, 2)), lease_epoch=3,
            replication_age_seconds=lambda: 1.25, breakers=breakers,
            **_counters(rng, (
                "replicated_total", "replicated_series_total",
                "replicate_failures_total", "dropped_epochs_total",
                "received_series_total", "duplicates_total", "stale_total",
                "fenced_total", "promotions_total",
                "promoted_series_total", "retries_total")))
        elector = types.SimpleNamespace(**_counters(rng, (
            "acquires_total", "demotions_total", "renew_failures_total")))
        ckpt = types.SimpleNamespace(
            last_write_duration_s=0.5, last_write_bytes=4096,
            age_seconds=lambda: 2.0, **_counters(rng, (
                "restore_total", "discard_total", "write_errors")))
        store = types.SimpleNamespace(mesh=object(),
                                      last_fleet_occupancy=[5, 7, 0, 9])
        # each package keeps its own last-reported marks: twin servers
        servers = [types.SimpleNamespace(
            handoff_manager=types.SimpleNamespace(**vars(mgr)),
            standby_manager=types.SimpleNamespace(**vars(sby)),
            lease_elector=types.SimpleNamespace(**vars(elector)),
            checkpointer=types.SimpleNamespace(**vars(ckpt)),
            store=store) for _ in range(2)]
        for name in ("_handoff_samples", "_ha_samples",
                     "_checkpoint_samples", "_fleet_samples"):
            for _ in range(2):  # the second read: the interval deltas
                got = _samples(getattr(tflusher, name), servers[0])
                assert got == _samples(getattr(jflusher, name),
                                       servers[1]), name
                assert got
    bare = types.SimpleNamespace(handoff_manager=None, standby_manager=None,
                                 lease_elector=None, checkpointer=None,
                                 store=types.SimpleNamespace(
                                     mesh=None, last_fleet_occupancy=None))
    for name in ("_handoff_samples", "_ha_samples", "_checkpoint_samples",
                 "_fleet_samples"):
        assert getattr(tflusher, name)(bare) == []


# -- the config keys --------------------------------------------------------


def test_fleet_and_crash_keys_load_like_jax(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text("fleet_peers: 'a:1,b:2'\nfleet_pull_interval: 250ms\n"
                    "fleet_pull_timeout: 3s\n"
                    "sentry_dsn: 'https://key@sentry.example/7'\n"
                    "enable_profiling: true\n")
    got, want = read_config(str(path)), jread_config(str(path))
    for key in ("fleet_peers", "sentry_dsn", "enable_profiling",
                "fleet_pull_interval_seconds", "fleet_pull_timeout_seconds"):
        assert getattr(got, key) == getattr(want, key), key
    assert (got.fleet_pull_interval_seconds,
            got.fleet_pull_timeout_seconds) == (0.25, 3.0)
    defaults = Config()
    assert (defaults.fleet_pull_interval_seconds,
            defaults.fleet_pull_timeout_seconds) == (5.0, 2.0)
    with pytest.raises(ValueError):
        Config(fleet_pull_timeout="soon")
    path.write_text("http_address: 127.0.0.1:0\nforward_address: g:1\n"
                    "stats_address: localhost:8125\n"
                    "sentry_dsn: 'https://key@sentry.example/7'\n")
    proxy = read_proxy_config(str(path))
    assert (proxy.stats_address, proxy.sentry_dsn) == (
        "localhost:8125", "https://key@sentry.example/7")


@pytest.mark.parametrize("peers,handoff,want", [
    ("a:1, b:2", "", ["a:1", "b:2"]),
    ("", "c:3,d:4", ["c:3", "d:4"]),
    ("FILE", "", ["e:5", "f:6"]),
    ("", "", None)])
def test_fleet_watcher_from_peers_like_jax(peers, handoff, want, tmp_path):
    if peers == "FILE":
        (tmp_path / "p").write_text("e:5\nf:6\n")
        peers = f"file://{tmp_path / 'p'}"
    kw = dict(fleet_peers=peers, handoff_peers=handoff)
    got = Server._build_fleet_watcher(Config(**kw))
    jgot = JServer._build_fleet_watcher(JConfig(**kw))
    if want is None:
        assert got is None and jgot is None
        return
    got.refresh()
    jgot.refresh()
    assert sorted(got.members) == sorted(jgot.members) == want
