"""The SIGHUP reload on a port Server (JAX ``tests/test_server_e2e.py``
``TestSighupReload``), and its flush held to a JAX Server's after the
same reload.

* tunables (interval, percentiles, aggregates, tags) swap while the
  sockets and the store stay; frozen keys keep their old values;
* injected sinks survive a reload; config-driven ones are rebuilt: a
  new one is started, a replaced one closes at the next reload (its
  flush in flight may still hold it) and at shutdown;
* the forwarder is rebuilt, and the role (local or global) is kept;
* the first flush after a reload takes the new percentile count down
  to the digest kernel's plain version (no layer caches it) and the
  rebuilt Datadog sink POSTs to its new endpoint with the new tag;
* the flush after a reload equals a JAX Server's after the same reload
  on the same seeded lines.
"""

import json
import socket
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from veneur_tpu.config import Config as JConfig
from veneur_tpu.server import Server as JServer
from veneur_tpu.sinks import ChannelMetricSink as JChannel
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks import factory
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

BASE = dict(statsd_listen_addresses=["udp://127.0.0.1:0"],
            interval="86400s", store_initial_capacity=32, store_chunk=128)


def make_server(**kw):
    cfg = dict(BASE, aggregates=["min", "max", "count"])
    cfg.update(kw)
    sink = ChannelMetricSink()
    server = Server(Config(**cfg), metric_sinks=[sink], device="cpu")
    server.start()
    return server, sink


def test_reload_swaps_tunables_and_keeps_sockets():
    server, sink = make_server(percentiles=[0.5], tags=["env:a"])
    try:
        old_addrs = list(server.statsd_addrs)
        old_store = server.store
        server.store.process_metric(tparser.parse_metric(b"pre:1|c"))
        new_cfg = Config(**dict(
            BASE, interval="7s", percentiles=[0.9], tags=["env:b"],
            aggregates=["count"],
            # frozen keys: refused, not applied
            digest_storage="slab", native_import_address="127.0.0.1:45678",
            tdigest_compression=50.0))
        server.reload(new_cfg)
        assert server.config.native_import_address == ""
        assert server.config.tdigest_compression == 100.0
        assert server.interval == 7.0
        assert server.histogram_percentiles == [0.9]
        assert server.tags == ["env:b"]
        assert server.statsd_addrs == old_addrs
        assert server.store is old_store
        assert server.config.digest_storage == "dense"
        assert sink in server.metric_sinks
        server.flush()
        assert "pre" in {m.name for m in sink.get_flush()}
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.sendto(b"post:1|c", server.statsd_addrs[0])
        s.close()
        deadline = time.time() + 10
        while server.store.processed < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert server.store.processed >= 1
    finally:
        server.shutdown()


def test_reload_sink_lifecycle(monkeypatch):
    """Config-driven sinks from a reload are started; the ones they
    replace close at the NEXT reload and at shutdown; injected ones
    survive."""

    class FakeSink:
        name = "fake"

        def __init__(self, gen):
            self.gen = gen
            self.started = False
            self.closed = False

        def start(self):
            self.started = True

        def close(self):
            self.closed = True

        def flush(self, metrics):
            pass

        def flush_other_samples(self, samples):
            pass

    made = []

    def fake_create(config):
        s = FakeSink(len(made))
        made.append(s)
        return [s], [], []

    server, injected = make_server()
    try:
        monkeypatch.setattr(factory, "create_sinks", fake_create)
        cfg = Config(**BASE)
        server.reload(cfg)
        assert made[0].started and made[0] in server.metric_sinks
        assert injected in server.metric_sinks
        assert not made[0].closed
        server.reload(cfg)
        assert made[1].started and not made[1].closed
        assert made[0] not in server.metric_sinks
        assert not made[0].closed  # retired, closes at the next reload
        server.reload(cfg)
        assert made[0].closed and not made[1].closed
    finally:
        server.shutdown()
    assert made[1].closed  # shutdown closes the retired ones


def test_reload_rebuilds_forwarder_and_keeps_the_role():
    server, _ = make_server(forward_address="127.0.0.1:1",
                            forward_use_grpc=True)
    try:
        first = server.forwarder
        assert first is not None
        server.reload(Config(**dict(BASE, forward_address="127.0.0.1:2",
                                    forward_use_grpc=True)))
        assert server.forwarder is not None
        assert server.forwarder is not first
        assert server.forward_fn is not None
        server.reload(Config(**BASE))  # a global's file: refused
        assert server.config.forward_address == "127.0.0.1:2"
        assert server.is_local()
    finally:
        server.shutdown()
    global_, _ = make_server()
    try:
        global_.reload(Config(**dict(BASE, forward_address="127.0.0.1:3")))
        assert not global_.is_local() and global_.forwarder is None
    finally:
        global_.shutdown()


class _Receiver:
    """A stdlib stand-in for the Datadog API: keeps every series body."""

    def __init__(self):
        self.series = []
        series = self.series

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                if self.headers.get("Content-Encoding") == "deflate":
                    body = zlib.decompress(body)
                if self.path.startswith("/api/v1/series"):
                    series.extend(json.loads(body)["series"])
                self.send_response(202)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_reload_repoints_the_config_sinks_and_the_percentiles():
    """A Server built from a Config through the factory: a reload points
    its Datadog sink at receiver B with one more tag and four
    percentiles. B gets every row of the next flush, each digest row
    with the four percentile columns and the new tag; A gets nothing
    more; A's sink is retired and closes at the next reload."""
    a, b = _Receiver(), _Receiver()
    rng = np.random.default_rng(5)
    vals = np.round(rng.gamma(2.0, 10.0, (64, 4)), 3)
    lines = [f"rl.{i}:{v}|h".encode() for i in range(64) for v in vals[i]]

    def cfg(url, pcts, tags):
        return Config(**dict(BASE, percentiles=pcts, tags=tags,
                             datadog_api_key="k", datadog_api_hostname=url,
                             hostname="h"))

    first = cfg(a.url, [0.5, 0.99], ["env:a"])
    server = Server(first, device="cpu",
                    config_sinks=factory.create_sinks(first))
    server.start()
    try:
        for line in lines:
            assert server.handle_metric_packet(line)
        server.flush()
        n_a = len(a.series)
        assert {s["metric"] for s in a.series} >= {"rl.0.50percentile",
                                                   "rl.0.99percentile"}
        old = server.metric_sinks[0]
        closed = []
        old.close = lambda: closed.append(True)
        server.reload(cfg(b.url, [0.5, 0.75, 0.9, 0.99],
                          ["env:a", "reload:2"]))
        assert old in server._retired_sinks and not closed
        for line in lines:
            assert server.handle_metric_packet(line)
        server.flush()
        assert len(a.series) == n_a
        names = {s["metric"] for s in b.series}
        for i in range(64):
            for p in ("50", "75", "90", "99"):
                assert f"rl.{i}.{p}percentile" in names, (i, p)
        assert all("reload:2" in s["tags"] for s in b.series)
        server.reload(cfg(b.url, [0.5], ["env:a"]))
        assert closed == [True]
    finally:
        server.shutdown()
        a.close()
        b.close()


LINES_SEED = 17


def _lines(shift=0.0):
    rng = np.random.default_rng(LINES_SEED)
    out = []
    for i in range(40):
        for v in rng.gamma(2.0, 10.0, 8) + shift:
            out.append(f"r.h.{i}:{v:.4f}|h|#k:{i % 3}".encode())
        out.append(f"r.c.{i}:{i + 1}|c".encode())
        out.append(f"r.g.{i}:{rng.normal(0, 5):.3f}|g".encode())
        for m in range(i % 7 + 1):
            out.append(f"r.s.{i}:m{m}|s".encode())
    return out


def test_flush_after_reload_matches_the_jax_server():
    """The same seeded lines before and after the same reload into a JAX
    Server and a port Server: the flush after it emits the same rows
    (counters, gauges, counts, extrema and set estimates exact or rtol
    1e-6; the new percentiles within 0.02 x each series' span)."""
    before = dict(interval="86400s", percentiles=[0.5],
                  aggregates=["min", "max", "count"], hostname="h")
    after = dict(interval="86400s", percentiles=[0.1, 0.5, 0.9, 0.99],
                 aggregates=["count", "max", "sum"], tags=["env:r"],
                 hostname="h")
    rows = {}
    for side in ("jax", "port"):
        if side == "jax":
            sink = JChannel()
            server = JServer(JConfig(**before), metric_sinks=[sink])
        else:
            sink = ChannelMetricSink()
            server = Server(Config(**before), metric_sinks=[sink],
                            device="cpu")
        for line in _lines():
            server.handle_metric_packet(line)
        server.flush()
        sink.get_flush()
        server.reload((JConfig if side == "jax" else Config)(**after))
        for line in _lines(shift=100.0):
            server.handle_metric_packet(line)
        server.flush()
        rows[side] = {(m.name, tuple(m.tags)): m.value
                      for m in sink.get_flush() if m.name.startswith("r.")}
    assert set(rows["port"]) == set(rows["jax"])
    assert any(k[0].endswith(".10percentile") for k in rows["port"])
    raw = {}
    for line in _lines(shift=100.0):
        name, _, rest = line.decode().partition(":")
        if name.startswith("r.h."):
            raw.setdefault(name, []).append(float(rest.split("|")[0]))
    for key, want in rows["jax"].items():
        have = rows["port"][key]
        if "percentile" in key[0]:
            base = key[0].rsplit(".", 1)[0]
            span = max(raw[base]) - min(raw[base])
            assert abs(have - want) <= 0.02 * span + 1e-6, key
        else:
            assert have == pytest.approx(want, rel=1e-6), key
