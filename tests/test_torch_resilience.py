"""The port's egress resilience and import backpressure against the JAX
package's: the HTTP forwarder's retries and breaker, the config knobs
behind them, and /import's bounded merge queue.

Counts are compared exactly (retries, errors, forwarded, shed and
merged batches, HTTP statuses); no tolerance applies.
"""

import json
import socket
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from veneur_tpu.config import Config as JConfig
from veneur_tpu.core import store as jstore
from veneur_tpu.forward.http_forward import HTTPForwarder as JForwarder
from veneur_tpu.httpserv import OpsServer as JOpsServer
from veneur_tpu.resilience import CircuitBreaker as JBreaker
from veneur_tpu.resilience import RetryPolicy as JRetryPolicy
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.samplers.intermetric import HistogramAggregates as JAggs
from veneur_tpu_torch import httpserv
from veneur_tpu_torch.config import Config, UnsupportedConfig
from veneur_tpu_torch.core import store as tstore
from veneur_tpu_torch.forward.http_forward import HTTPForwarder
from veneur_tpu_torch.httpserv import OpsServer
from veneur_tpu_torch.resilience import CircuitBreaker, RetryPolicy
from veneur_tpu_torch.resilience.breaker import CLOSED, HALF_OPEN, OPEN
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates


class _Scripted(BaseHTTPRequestHandler):
    """Answers each POST with the next scripted status (202 after)."""

    def log_message(self, *args):
        pass

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
        if self.headers.get("Content-Encoding") == "deflate":
            body = zlib.decompress(body)
        with self.server.lock:
            status = (self.server.statuses.pop(0) if self.server.statuses
                      else 202)
            if 200 <= status < 300:
                self.server.received.append(json.loads(body))
        self.send_response(status)
        self.send_header("Content-Length", "0")
        self.end_headers()


def scripted_server(statuses):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Scripted)
    srv.daemon_threads = True
    srv.statuses, srv.received, srv.lock = list(statuses), [], threading.Lock()
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def dead_port() -> int:
    """A port with nothing listening: instant connection-refused."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def states():
    """(JAX, port) ForwardableStates of one global-only counter."""
    line = b"gctr:5|c|#veneurglobalonly"
    j = jstore.MetricStore(initial_capacity=32, chunk=128)
    j.process_metric(jparser.parse_metric(line))
    _, jfwd, _ = j.flush([0.5], JAggs.from_names(["count"]), is_local=True,
                         now=0)
    t = tstore.MetricStore(initial_capacity=32, chunk=128, device="cpu")
    t.process_metric(tparser.parse_metric(line))
    _, tfwd = t.flush([0.5], HistogramAggregates.from_names(["count"]), 0,
                      is_local=True)
    return jfwd, tfwd


def _counts(f):
    return f.forwarded, f.errors, f.retries


@pytest.mark.parametrize("statuses", [[503, 503, 202], [500, 202],
                                      [429, 503, 502], [400], [202]])
def test_retries_counted_like_jax(statuses):
    """Transient statuses (5xx, 429) retry up to the policy's attempts;
    a 4xx does not; the final status decides success. Both forwarders
    count the same retries, errors and forwarded metrics, and deliver
    the same counter."""
    got = {}
    for pkg, state in zip(("jax", "port"), states()):
        srv = scripted_server(statuses)
        try:
            cls, policy = ((JForwarder, JRetryPolicy) if pkg == "jax"
                           else (HTTPForwarder, RetryPolicy))
            f = cls(f"127.0.0.1:{srv.server_address[1]}",
                    retry_policy=policy(max_attempts=3, base_interval=0.005,
                                        max_interval=0.02))
            ok = f.forward(state)
            got[pkg] = (ok, _counts(f),
                        [[(d["name"], d["value"]) for d in body]
                         for body in srv.received])
        finally:
            srv.shutdown()
            srv.server_close()
    assert got["port"] == got["jax"]
    assert got["port"][1][2] == min(2, sum(
        s == 429 or s >= 500 for s in statuses))


def test_breaker_opens_after_threshold(fake_clock):
    """Three refused connections trip a threshold-3 breaker; the next
    forward is rejected without a connect attempt; after the reset
    timeout one half-open probe goes out. The JAX breaker, fed the same
    outcomes, walks the same states."""
    port = dead_port()
    seq = {}
    for pkg, state in zip(("jax", "port"), states()):
        cls, bcls, policy = ((JForwarder, JBreaker, JRetryPolicy)
                             if pkg == "jax"
                             else (HTTPForwarder, CircuitBreaker,
                                   RetryPolicy))
        breaker = bcls(failure_threshold=3, reset_timeout=30.0,
                       clock=fake_clock, name="up")
        f = cls(f"127.0.0.1:{port}", timeout=0.3,
                retry_policy=policy(max_attempts=1), breaker=breaker)
        states_seen = []
        for _ in range(3):
            f.forward(state)
            states_seen.append(breaker.state)
        t0 = time.perf_counter()
        f.forward(state)
        assert time.perf_counter() - t0 < 0.25   # rejected, no connect
        fake_clock.advance(31.0)
        states_seen.append(breaker.state)
        f.forward(state)                          # the probe fails
        states_seen.append(breaker.state)
        seq[pkg] = (states_seen, f.errors, breaker.trips,
                    breaker.rejections)
    assert seq["port"][0] == [CLOSED, CLOSED, OPEN, HALF_OPEN, OPEN]
    assert seq["port"] == seq["jax"]


def test_persistent_4xx_does_not_trip_the_breaker(fake_clock):
    """A destination that answers 400 is alive: counted as errors, never
    tripped (only transport errors and 5xx/429 count)."""
    srv = scripted_server([400] * 6)
    try:
        breaker = CircuitBreaker(failure_threshold=2, clock=fake_clock)
        f = HTTPForwarder(f"127.0.0.1:{srv.server_address[1]}",
                          retry_policy=RetryPolicy(max_attempts=1),
                          breaker=breaker)
        state = states()[1]
        for _ in range(4):
            assert not f.forward(state)
        assert f.errors == 4 and breaker.state == CLOSED
    finally:
        srv.shutdown()
        srv.server_close()


def _post(port, body: bytes, encoding=None):
    headers = {"Content-Type": "application/json"}
    if encoding:
        headers["Content-Encoding"] = encoding
    req = urllib.request.Request(f"http://127.0.0.1:{port}/import",
                                 data=body, headers=headers, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        e.close()
        return e.code


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_import_answers_429_when_pool_full(pkg):
    """One merge worker blocked on a batch and a queue of one: the third
    POST is shed with 429; released, the two accepted batches merge."""
    release, merged = threading.Event(), []

    def handle(metrics):
        release.wait(10)
        merged.append(len(metrics))
        return len(metrics)

    cls = JOpsServer if pkg == "jax" else OpsServer
    ops = cls("127.0.0.1:0", import_fn=handle, import_workers=1,
              import_queue=1)
    ops.start()
    try:
        body = json.dumps([{"name": "c", "type": "counter", "tags": [],
                            "value": 1}]).encode()
        first = _post(ops.port, body)
        deadline = time.time() + 10
        while ops.import_pool.qsize() and time.time() < deadline:
            time.sleep(0.01)   # the worker took the first batch
        codes = [first, _post(ops.port, body), _post(ops.port, body)]
        assert codes == [202, 202, 429]
        assert ops.import_pool.shed == 1
        release.set()
        deadline = time.time() + 10
        while ops.import_pool.merged_batches < 2 and time.time() < deadline:
            time.sleep(0.01)
        assert merged == [1, 1]
    finally:
        release.set()
        ops.stop()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_import_rejects_bad_bodies(pkg):
    """unmarshalMetricsFromHTTP's 400s, GET /healthcheck and 404s."""
    cls = JOpsServer if pkg == "jax" else OpsServer
    ops = cls("127.0.0.1:0", import_fn=lambda metrics: len(metrics))
    ops.start()
    try:
        assert _post(ops.port, b"") == 400
        assert _post(ops.port, b"{not json") == 400
        assert _post(ops.port, b"{}") == 400
        assert _post(ops.port, b"[]") == 400
        assert _post(ops.port, b"\x00garbage", "deflate") == 400
        assert _post(ops.port, b"[1]", "gzip") == 400
        assert _post(ops.port, zlib.compress(b"[1]"), "deflate") == 202
        with urllib.request.urlopen(
                f"http://127.0.0.1:{ops.port}/healthcheck", timeout=10) as r:
            assert r.read() == b"ok"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{ops.port}/nope",
                                   timeout=10)
    finally:
        ops.stop()


def test_bounded_inflate_caps_the_output():
    bomb = zlib.compress(b"[" + b"0," * 5000 + b"0]")
    with pytest.raises(httpserv.ImportError400, match="limit"):
        httpserv.bounded_inflate(bomb, limit=1000)
    assert len(httpserv.bounded_inflate(bomb)) == 1 + 2 * 5000 + 2


def test_config_knobs_match_jax_defaults(monkeypatch):
    """Defaults and validation of the egress knobs follow
    veneur_tpu/config.py; retry_max counts RE-tries."""
    j = JConfig()
    j.apply_defaults()
    t = Config(hostname="h")
    for name in ("forward_timeout_seconds", "retry_max",
                 "retry_base_interval_seconds", "breaker_failure_threshold",
                 "breaker_reset_timeout_seconds", "forward_packed_digests",
                 "forward_reference_compatible"):
        assert getattr(t, name) == getattr(j, name), name
    assert RetryPolicy.from_config(t) == RetryPolicy(max_attempts=3,
                                                     base_interval=0.1)
    assert RetryPolicy.from_config(Config(hostname="h", retry_max=0)) \
        .max_attempts == 1
    with pytest.raises(ValueError, match="breaker_failure_threshold"):
        Config(hostname="h", breaker_failure_threshold=-1)
    # the gRPC transport is ported: the key builds a GRPCForwarder with
    # the same retry policy and breaker; without grpcio it raises
    from veneur_tpu_torch.forward import configure_forwarding
    from veneur_tpu_torch.forward.grpc_forward import GRPCForwarder

    class Srv:
        forward_fn = None
        config = Config(hostname="h", forward_address="127.0.0.1:1",
                        forward_use_grpc=True)

    fwd = configure_forwarding(Srv())
    assert isinstance(fwd, GRPCForwarder)
    assert fwd.retry_policy == RetryPolicy.from_config(Srv.config)
    assert fwd.breaker.failure_threshold == 5
    fwd.close()
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "grpc", None)
        with pytest.raises(UnsupportedConfig, match="grpcio"):
            Config(hostname="h", forward_address="x:1", forward_use_grpc=True)
    # the framed-TCP lane is ported: native:// is a forward address
    assert Config(hostname="h", forward_address="native://x:1") \
        .forward_address == "native://x:1"
    with pytest.raises(ValueError, match="duration"):
        Config(hostname="h", forward_timeout="ten seconds")
