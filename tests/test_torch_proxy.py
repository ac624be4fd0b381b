"""The port's proxy tier (HTTP and gRPC veneur-proxy) against the JAX
package's, on the CPU.

* Routing: the port's ``Proxy`` and ``GRPCProxyServer`` over a static
  ring send every series of a seeded list (numpy seed 11: 400 series of
  mixed types and tags) to the destination the JAX package's proxies
  send it to, and the two transports hash one series to one member.
* The MetricList splitter (``protocol/mlist.py``): each span's key and
  the re-decoded concatenation of every span equal the input's metrics
  (``forward_pb2`` of the JAX package reads them), the ``topk`` field
  dropped; truncated bytes raise.
* The JAX package's ``tests/test_proxy.py``, run on the port: zero
  destinations refused, a failed refresh keeps the last good ring, a
  local through the HTTP and through the gRPC proxy into two globals
  (every metric on exactly one, both used), the ring swap under
  concurrent ingest conserving counts, an unreachable destination
  counted, trace spans partitioned by trace id, ``/spans`` refused
  without a trace ring, the gRPC listener seeded from the shared
  refresh and following it, ``GET /debug/vars``.
* The config: ``example_proxy.yaml`` loads through ``read_proxy_config``,
  unported keys and transport fault kinds are refused, the churn kinds
  drive the refresh and black-hole a partitioned member, and
  ``python -m veneur_tpu_torch.cli.proxy`` starts both listeners from a
  file and stops on SIGTERM.

Counts are exact; the fan-outs run on a 5 s forward timeout.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from veneur_tpu.config import ProxyConfig as JProxyConfig
from veneur_tpu.discovery import StaticDiscoverer as JStatic
from veneur_tpu.protocol import forward_pb2
from veneur_tpu.proxy.grpc_proxy import GRPCProxyServer as JGRPCProxy
from veneur_tpu.proxy.proxy import Proxy as JProxy
from veneur_tpu_torch import flusher as tflusher
from veneur_tpu_torch.config import (ProxyConfig, UnsupportedConfig,
                                     proxy_config_from_dict,
                                     read_proxy_config)
from veneur_tpu_torch.core import store as tstore
from veneur_tpu_torch.discovery import StaticDiscoverer
from veneur_tpu_torch.forward import grpc_forward as tg
from veneur_tpu_torch.forward.http_forward import post_helper
from veneur_tpu_torch.native import egress as tegress
from veneur_tpu_torch.protocol import mlist
from veneur_tpu_torch.proxy import GRPCProxyServer, Proxy
from veneur_tpu_torch.proxy.proxy import metric_ring_key
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

ROOT = pathlib.Path(__file__).resolve().parents[1]
MEMBERS = ["http://10.0.0.1:8127", "http://10.0.0.2:8127",
           "http://10.0.0.3:8127"]
TYPES = ("counter", "gauge", "histogram", "set", "timer")


def _wait(cond, timeout=10.0):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, "timed out"
        time.sleep(0.01)


def _series(seed=11, n=400):
    """(name, type, tags) of a seeded series list."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        tags = sorted(f"t{int(k)}:v{int(rng.integers(0, 9))}"
                      for k in rng.choice(6, int(rng.integers(0, 4)),
                                          replace=False))
        out.append((f"svc.m{int(rng.integers(0, 10 ** 6))}.{i}",
                    TYPES[int(rng.integers(0, 5))], tags))
    return out


def _metric_list(series, topk=False):
    """A serialized MetricList of the series (each a counter, gauge, set
    or digest by its type), optionally with a top-k sketch."""
    ms = []
    for i, (name, mtype, tags) in enumerate(series):
        if mtype == "counter":
            ms.append(mlist.counter(name, tags, i))
        elif mtype == "gauge":
            ms.append(mlist.gauge(name, tags, i * 0.5))
        elif mtype == "set":
            ms.append(mlist.set_metric(name, tags, bytes([i % 256]) * 4))
        else:
            ms.append(mlist.digest(
                name, tags, mlist.TIMER if mtype == "timer"
                else mlist.HISTOGRAM, [1.0, float(i)], [2.0, 1.0], 1.0,
                float(i)))
    sketch = mlist.topk_sketch(np.ones((2, 4), np.float32),
                               [("hh", ["a:b"], [(0, 7)], ["u"])]) \
        if topk else None
    return mlist.metric_list(ms, sketch)


# ---------------------------------------------------------------------------
# routing against the JAX package
# ---------------------------------------------------------------------------


def test_http_proxy_routes_like_jax():
    """The same seeded JSON metrics through both packages' HTTP proxies
    over a static ring of the same members: each destination receives
    the same series."""
    series = _series()
    metrics = [{"name": n, "type": t, "tags": tags, "value": 1}
               for n, t, tags in series]
    got = {}
    for label, cls, cfg, disc in (
            ("port", Proxy, ProxyConfig, StaticDiscoverer),
            ("jax", JProxy, JProxyConfig, JStatic)):
        proxy = cls(cfg(http_address="127.0.0.1:0", retry_max=0),
                    discoverer=disc(MEMBERS))
        proxy.refresh_destinations()
        sent = got[label] = {}
        lock = threading.Lock()

        def fake_post(url, batch, sent=sent, lock=lock, **kw):
            with lock:
                sent.setdefault(url, set()).update(
                    (m["name"], m["type"], tuple(m["tags"])) for m in batch)
            return 202

        proxy._post = fake_post
        proxy.proxy_metrics(metrics)
        assert proxy.proxied == len(series) and proxy.forward_errors == 0
    assert got["port"] == got["jax"]
    assert len(got["port"]) == len(MEMBERS)


def test_grpc_proxy_routes_like_jax():
    """The same seeded MetricList through both packages' gRPC proxies:
    each destination receives the same series, and the two transports
    (HTTP key, gRPC key) send each series to the same member."""
    series = _series()
    data = _metric_list(series, topk=True)
    got = {}
    port_proxy = GRPCProxyServer(MEMBERS)
    jax_proxy = JGRPCProxy(MEMBERS)
    for label, proxy, arg in (
            ("port", port_proxy, data),
            ("jax", jax_proxy, forward_pb2.MetricList.FromString(data))):
        sent = got[label] = {}
        lock = threading.Lock()

        def fake_forward(dest, batch, *rest, sent=sent, lock=lock):
            if isinstance(batch, bytes):
                batch = forward_pb2.MetricList.FromString(batch).metrics
            with lock:
                sent.setdefault(dest, set()).update(
                    (m.name, m.type, tuple(m.tags)) for m in batch)

        proxy._forward = fake_forward
        proxy.send_metrics(arg)
    assert got["port"] == got["jax"] and len(got["port"]) == len(MEMBERS)
    http = Proxy(ProxyConfig(http_address="127.0.0.1:0"),
                 discoverer=StaticDiscoverer(MEMBERS))
    http.refresh_destinations()
    pb = {"counter": 0, "gauge": 1, "histogram": 2, "set": 3, "timer": 4}
    for name, mtype, tags in series:
        owner = http.ring.get(metric_ring_key(
            {"name": name, "type": mtype, "tags": tags}))
        assert (name, pb[mtype], tuple(tags)) in got["port"][owner]


def test_http_and_grpc_ring_keys_match():
    """Both transports hash one series to one key (the JAX test of the
    same name), read here from the splitter's span."""
    (span,) = mlist.split_metric_list(mlist.metric_list([mlist.digest(
        "lat", ["env:prod", "svc:a"], mlist.TIMER, [1.0], [1.0], 1.0,
        1.0)]))
    from veneur_tpu_torch.forward.convert import type_name

    assert span.name + type_name(span.type) + ",".join(span.tags) == \
        metric_ring_key({"name": "lat", "type": "timer",
                         "tags": ["env:prod", "svc:a"]})


def test_splitter_spans_reassemble_the_metrics():
    """Every span's key equals the metric's; the spans joined (all, or a
    subset) decode to those metrics, and the top-k sketch is dropped."""
    series = _series(n=60)
    data = _metric_list(series, topk=True)
    spans = mlist.split_metric_list(data)
    want = forward_pb2.MetricList.FromString(data)
    assert want.HasField("topk")
    assert [(s.name, s.type, s.tags) for s in spans] == \
        [(m.name, m.type, list(m.tags)) for m in want.metrics]
    whole = forward_pb2.MetricList.FromString(
        b"".join(data[s.start:s.end] for s in spans))
    assert not whole.HasField("topk")
    assert list(whole.metrics) == list(want.metrics)
    odd = forward_pb2.MetricList.FromString(
        b"".join(data[s.start:s.end] for s in spans[1::2]))
    assert list(odd.metrics) == list(want.metrics)[1::2]
    assert mlist.split_metric_list(b"") == []
    with pytest.raises(mlist.DecodeError):
        mlist.split_metric_list(data[:spans[3].end - 2])


# ---------------------------------------------------------------------------
# the JAX package's proxy tests, on the port
# ---------------------------------------------------------------------------


def test_refuses_zero_destinations():
    proxy = Proxy(ProxyConfig(http_address="127.0.0.1:0"),
                  discoverer=StaticDiscoverer([]))
    with pytest.raises(RuntimeError):
        proxy.start()


def test_refresh_keeps_last_good_ring():
    class Flaky:
        def __init__(self):
            self.calls = 0

        def get_destinations_for_service(self, name):
            self.calls += 1
            if self.calls > 1:
                raise OSError("consul down")
            return ["http://10.0.0.1:8127"]

    proxy = Proxy(ProxyConfig(http_address="127.0.0.1:0",
                              consul_forward_service_name="veneur",
                              retry_max=0),
                  discoverer=Flaky())
    proxy.refresh_destinations()
    assert len(proxy.ring) == 1
    proxy.refresh_destinations()  # fails: the ring stays
    assert len(proxy.ring) == 1 and proxy.refresh_failures == 1


@pytest.fixture()
def two_globals():
    """Two port global Servers, each with /import and a gRPC import."""
    out = []
    for _ in range(2):
        sink = ChannelMetricSink()
        server = Server(Config(http_address="127.0.0.1:0",
                               grpc_address="127.0.0.1:0",
                               interval="3600s", percentiles=[0.5],
                               aggregates=["count"], hostname="g",
                               store_initial_capacity=32, store_chunk=128),
                        metric_sinks=[sink], device="cpu")
        server.start()
        out.append(server)
    try:
        yield out
    finally:
        for server in out:
            server.shutdown()


def _local_forward(address, n=40, prefix="series", **cfg):
    """A port local Server with n global-only counters forwards once. It
    stops without the final flush (``crash_stop``): that flush would
    forward again, the local's own ``veneur.*`` timers of the first."""
    local = Server(Config(interval="3600s", hostname="l",
                          forward_address=address, forward_timeout="10s",
                          **cfg), metric_sinks=[ChannelMetricSink()],
                   device="cpu")
    local.start()
    try:
        for i in range(n):
            local.store.process_metric(tparser.parse_metric(
                f"{prefix}{i}:1|c|#veneurglobalonly".encode()))
        tflusher.flush_once(local)
        assert local.wait_forward(30) is True
        assert local.forwarder.errors == 0
    finally:
        local.crash_stop()


def test_local_to_http_proxy_to_two_globals(two_globals):
    g1, g2 = two_globals
    dests = [f"http://127.0.0.1:{g.ops_server.port}" for g in two_globals]
    proxy = Proxy(ProxyConfig(http_address="127.0.0.1:0",
                              forward_timeout="5s"),
                  discoverer=StaticDiscoverer(dests))
    proxy.start()
    try:
        _local_forward(f"http://127.0.0.1:{proxy.port}")
        _wait(lambda: g1.store.imported + g2.store.imported >= 40)
        # every metric reached exactly one global, and both were used
        assert g1.store.imported + g2.store.imported == 40
        assert g1.store.imported > 0 and g2.store.imported > 0
        _wait(lambda: proxy.proxied == 40)
    finally:
        proxy.shutdown()


def test_local_to_grpc_proxy_to_two_globals():
    if not tegress.available():
        pytest.skip("the native egress library does not build here")
    stores = [tstore.MetricStore(chunk=128, device="cpu") for _ in range(2)]
    servers = [tg.ImportServer(s) for s in stores]
    ports = [s.start("127.0.0.1:0") for s in servers]
    proxy = GRPCProxyServer([f"127.0.0.1:{p}" for p in ports],
                            forward_timeout=5.0)
    pport = proxy.start("127.0.0.1:0")
    try:
        _local_forward(f"127.0.0.1:{pport}", prefix="g",
                       forward_use_grpc=True)
        _wait(lambda: sum(s.received for s in servers) >= 40)
        assert sum(s.received for s in servers) == 40
        assert all(s.received > 0 for s in servers)
        _wait(lambda: proxy.proxied == 40)
        assert proxy.forward_errors == proxy.dropped == 0
    finally:
        proxy.stop()
        for s in servers:
            s.stop()


def test_proxy_starts_grpc_flavor_from_config(two_globals):
    """grpc_forward_address starts the gRPC listener, seeded from the
    same refresh as the HTTP ring; a local over gRPC and one over HTTP
    put each series on the same global (grpc_dial maps each member, the
    global's HTTP address, to its gRPC import); a membership change
    reaches the gRPC ring too; /debug/vars shows both."""
    dests = [f"http://127.0.0.1:{g.ops_server.port}" for g in two_globals]
    dial = {d: f"127.0.0.1:{g.import_server.port}"
            for d, g in zip(dests, two_globals)}
    proxy = Proxy(ProxyConfig(http_address="127.0.0.1:0",
                              grpc_forward_address="127.0.0.1:0",
                              forward_timeout="5s"),
                  discoverer=StaticDiscoverer(dests), grpc_dial=dial.get)
    proxy.start()
    try:
        g = proxy.grpc_server
        assert g is not None and g.port
        assert len(g.ring) == len(proxy.ring) == 2
        _local_forward(f"127.0.0.1:{g.port}", prefix="pg",
                       forward_use_grpc=True)
        _wait(lambda: g.proxied == 40)
        _local_forward(f"http://127.0.0.1:{proxy.port}", prefix="pg")
        _wait(lambda: proxy.proxied == 40)
        _wait(lambda: sum(srv.store.imported for srv in two_globals)
              == 80)
        # each series reached one global from both transports: a global's
        # imports are twice its gRPC ones, and both globals took some
        grpc_in = [srv.import_server.received for srv in two_globals]
        assert sum(grpc_in) == 40 and min(grpc_in) > 0
        assert [srv.store.imported for srv in two_globals] == \
            [2 * n for n in grpc_in]
        body = json.loads(_get(proxy.port, "/debug/vars"))
        assert body["ring"]["proxied"] == 40
        assert body["grpc"]["proxied"] == 40
        proxy._refresh_ring(StaticDiscoverer(dests[:1]), "static",
                            proxy.ring)
        assert len(g.ring) == 1
    finally:
        proxy.shutdown()


def _get(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as resp:
        return resp.read()


def test_ring_swap_conserves_counts_under_concurrent_ingest():
    """While the membership swaps back and forth, every proxied metric
    is delivered to exactly one destination: no double POST, no drop."""
    proxy = Proxy(ProxyConfig(http_address="127.0.0.1:0",
                              forward_timeout="5s", retry_max=0),
                  discoverer=StaticDiscoverer(["d1", "d2"]))
    proxy.refresh_destinations()
    delivered = []
    dlock = threading.Lock()

    def fake_post(url, batch, **kw):
        with dlock:
            delivered.append((url, [m["id"] for m in batch]))
        return 202

    proxy._post = fake_post
    sent = []
    slock = threading.Lock()
    stop = threading.Event()

    def ingest(tid):
        i = 0
        while not stop.is_set():
            batch = [{"name": f"series{(i + j) % 16}", "type": "counter",
                      "tags": [], "id": f"{tid}:{i}:{j}"} for j in range(8)]
            with slock:
                sent.extend(m["id"] for m in batch)
            proxy.proxy_metrics(batch)
            i += 1

    threads = [threading.Thread(target=ingest, args=(t,), daemon=True)
               for t in range(3)]
    for t in threads:
        t.start()
    for _ in range(60):
        proxy.ring.set_members(["d1", "d2", "d3"])
        time.sleep(0.001)
        proxy.ring.set_members(["d1", "d2"])
        time.sleep(0.001)
    stop.set()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    got = [mid for _, ids in delivered for mid in ids]
    assert sorted(got) == sorted(sent)
    assert proxy.forward_errors == 0


def test_unreachable_destination_counted():
    proxy = Proxy(ProxyConfig(http_address="127.0.0.1:0",
                              forward_timeout="500ms"),
                  discoverer=StaticDiscoverer(["http://127.0.0.1:1"]))
    proxy.start()
    try:
        proxy.proxy_metrics([{"name": "x", "type": "counter", "tags": [],
                              "value": 1}])
        assert proxy.forward_errors == 1
        # and a metric without a key is dropped, counted
        proxy.proxy_metrics([{"type": "counter"}])
        assert proxy.dropped == 1
    finally:
        proxy.shutdown()


class _SpanRecorder(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
        if self.path == "/spans":
            self.server.batches.append(json.loads(body))
            self.send_response(202)
        else:
            self.send_response(404)
        self.send_header("Content-Length", "0")
        self.end_headers()


def test_spans_fan_out_partitioned_by_trace_id():
    """POST /spans partitions Datadog trace spans by trace id over the
    trace ring (proxy.go:393-434): a trace on one downstream only."""
    downstreams = []
    for _ in range(2):
        httpd = HTTPServer(("127.0.0.1", 0), _SpanRecorder)
        httpd.batches = []
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        downstreams.append(httpd)
    trace_dests = [f"http://127.0.0.1:{d.server_address[1]}"
                   for d in downstreams]

    class PerService:
        def get_destinations_for_service(self, name):
            if name == "veneur-trace":
                return trace_dests
            return ["http://127.0.0.1:9"]

    proxy = Proxy(ProxyConfig(http_address="127.0.0.1:0",
                              consul_forward_service_name="veneur",
                              consul_trace_service_name="veneur-trace",
                              forward_timeout="5s"),
                  discoverer=PerService())
    proxy.start()
    try:
        spans = [{"trace_id": tid, "span_id": 2 * tid + j, "parent_id": 0,
                  "service": "svc", "name": "op", "resource": "r",
                  "start": 1, "duration": 2, "error": 0, "type": "web",
                  "meta": {}, "metrics": {}}
                 for tid in range(1, 21) for j in range(2)]
        assert post_helper(f"http://127.0.0.1:{proxy.port}/spans", spans,
                           compress=False) == 202
        _wait(lambda: sum(len(b) for d in downstreams
                          for b in d.batches) >= 40)
        got = [[s for b in d.batches for s in b] for d in downstreams]
        assert sum(len(g) for g in got) == 40
        assert all(len(g) > 0 for g in got)
        tids = [set(s["trace_id"] for s in g) for g in got]
        assert not (tids[0] & tids[1])
        _wait(lambda: proxy.traces_proxied == 40)
    finally:
        proxy.shutdown()
        for d in downstreams:
            d.shutdown()
            d.server_close()


def test_spans_404_when_not_accepting_traces():
    proxy = Proxy(ProxyConfig(http_address="127.0.0.1:0"),
                  discoverer=StaticDiscoverer(["http://127.0.0.1:9"]))
    proxy.start()
    try:
        assert post_helper(f"http://127.0.0.1:{proxy.port}/spans", [],
                           compress=False) == 404
        assert post_helper(f"http://127.0.0.1:{proxy.port}/import", [],
                           compress=False) == 400
        assert _get(proxy.port, "/healthcheck") == b"ok"
    finally:
        proxy.shutdown()


# ---------------------------------------------------------------------------
# the config and the binary
# ---------------------------------------------------------------------------


def test_proxy_config_loads_and_refuses_unported():
    """example_proxy.yaml loads (and matches the JAX package's defaults);
    keys the port does not implement, set, raise; transport fault kinds
    raise, the churn kinds load."""
    from veneur_tpu.config import read_proxy_config as jread

    t = read_proxy_config(str(ROOT / "example_proxy.yaml"))
    j = jread(str(ROOT / "example_proxy.yaml"))
    for name in ("http_address", "grpc_forward_address",
                 "consul_refresh_interval", "forward_timeout", "retry_max",
                 "retry_base_interval", "breaker_failure_threshold",
                 "breaker_reset_timeout", "forward_timeout_seconds",
                 "breaker_reset_timeout_seconds"):
        assert getattr(t, name) == getattr(j, name), name
    # accepted and not read, as the JAX package's proxy does
    for key in ("trace_api_address", "ssf_destination_address"):
        assert getattr(proxy_config_from_dict({key: "x:1"}), key) == \
            getattr(JProxyConfig(**{key: "x:1"}).finalize(), key) == "x:1"
    # accepted and not read, as the JAX package's proxy does
    loaded = proxy_config_from_dict({
        "stats_address": "x:1", "sentry_dsn": "https://k@h/1",
        "enable_profiling": True})
    assert (loaded.stats_address, loaded.enable_profiling) == ("x:1", True)
    with pytest.raises(UnsupportedConfig, match="bogus"):
        proxy_config_from_dict({"bogus": 1})
    # a transport kind loads and wraps the fan-out's post, as the JAX
    # proxy's does
    http = proxy_config_from_dict({"fault_injection_rate": 0.5,
                                   "fault_injection_kinds": "http_5xx",
                                   "forward_address": "127.0.0.1:1"})
    assert Proxy(http).fault_injector.kinds == ("http_5xx",)
    assert Proxy(http).churn_injector is None
    assert proxy_config_from_dict({
        "fault_injection_rate": 0.5,
        "fault_injection_kinds": "member_add,partition"}) \
        .fault_injection_rate == 0.5


def test_churn_faults_drive_the_proxy():
    """member_add on the refresh puts a synthetic member on the ring; a
    partition black-holes its member's sends (counted as errors)."""
    add = Proxy(ProxyConfig(http_address="127.0.0.1:0",
                            fault_injection_rate=1.0, fault_injection_seed=1,
                            fault_injection_kinds="member_add"),
                discoverer=StaticDiscoverer(["a", "b"]))
    add.refresh_destinations()
    assert len(add.ring) == 3
    assert any(m.startswith("fault://") for m in add.ring.members())
    part = Proxy(ProxyConfig(http_address="127.0.0.1:0", retry_max=0,
                             fault_injection_rate=1.0, fault_injection_seed=3,
                             fault_injection_kinds="partition"),
                 discoverer=StaticDiscoverer(MEMBERS))
    part.refresh_destinations()
    hit = [m for m in MEMBERS if part.churn_injector.is_partitioned(m)]
    assert len(hit) == 1
    part._post = lambda url, batch, **kw: 202
    metrics = [{"name": n, "type": t, "tags": tags}
               for n, t, tags in _series(n=60)]
    part.proxy_metrics(metrics)
    lost = sum(1 for m in metrics
               if part.ring.get(metric_ring_key(m)) == hit[0])
    assert part.forward_errors == 1 and part.proxied == len(metrics) - lost


def test_cli_starts_both_listeners(tmp_path):
    """python -m veneur_tpu_torch.cli.proxy -f file: the HTTP and the gRPC
    listener come up from the file; SIGTERM stops it with exit 0."""
    cfg = tmp_path / "proxy.yaml"
    cfg.write_text("http_address: 127.0.0.1:0\n"
                   "grpc_forward_address: 127.0.0.1:0\n"
                   "forward_address: http://127.0.0.1:9\n"
                   "consul_refresh_interval: 10s\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "veneur_tpu_torch.cli.proxy", "-f", str(cfg)],
        cwd=tmp_path, env=env, stderr=subprocess.PIPE, text=True)
    try:
        lines = []
        deadline = time.time() + 60
        while time.time() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            lines.append(line)
            if "Starting proxy" in line:
                break
        assert "Starting proxy" in lines[-1], lines
        http_port = int(lines[-1].split("HTTP port ")[1].split(",")[0])
        assert "gRPC port" in lines[-1]
        assert _get(http_port, "/healthcheck") == b"ok"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
