"""The port's crash surface (``veneur_tpu_torch/crash.py``) against the
JAX package's (``veneur_tpu/crash.py``).

* ``SentryReporter`` POSTs the same Sentry v7 event to a stub DSN
  endpoint as the JAX reporter does (the same endpoint path, auth
  header and event keys); a malformed DSN raises, in the reporter and
  in a ``Config`` (``read_config`` too), as JAX ``config.py:400-403``.
* ``guarded`` reports, then rethrows; ``install_excepthook`` reports an
  uncaught exception of a thread the server did not wrap, once.
* A port Server with ``sentry_dsn`` reports a thread of its own that
  dies, and with ``enable_profiling`` writes a pstats file at shutdown.
"""

import http.server
import json
import os
import pstats
import threading
import time

import pytest

from veneur_tpu import crash as jcrash
from veneur_tpu.config import Config as JConfig
from veneur_tpu_torch import crash
from veneur_tpu_torch.config import Config, read_config
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink


class _SentryCapture(http.server.BaseHTTPRequestHandler):
    events = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        _SentryCapture.events.append(
            (self.path, dict(self.headers), json.loads(body)))
        self.send_response(200)
        self.end_headers()
        self.wfile.write(b"{}")

    def log_message(self, *a):
        pass


@pytest.fixture
def sentry():
    _SentryCapture.events = []
    srv = http.server.HTTPServer(("127.0.0.1", 0), _SentryCapture)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://pubkey@127.0.0.1:{srv.server_port}/42"
    srv.shutdown()
    srv.server_close()


@pytest.fixture
def hook():
    """Put the process-wide excepthook state back after the test (a
    Server's start installs it)."""
    saved = (threading.excepthook, crash._hook_installed,
             crash._current_reporter)
    yield
    (threading.excepthook, crash._hook_installed,
     crash._current_reporter) = saved


def _wait_events(n, timeout=5.0):
    deadline = time.time() + timeout
    while len(_SentryCapture.events) < n:
        assert time.time() < deadline, "no event reached the stub"
        time.sleep(0.02)


def _raise(exc):
    try:
        raise exc
    except Exception as e:
        return e


def test_report_posts_the_jax_event(sentry):
    for reporter in (crash.SentryReporter(sentry),
                     jcrash.SentryReporter(sentry)):
        assert reporter.report(_raise(RuntimeError("boom in flush")),
                               "flush-ticker")
    _wait_events(2)
    (path, headers, event), (jpath, jheaders, jevent) = \
        _SentryCapture.events
    assert path == jpath == "/api/42/store/"
    assert "sentry_key=pubkey" in headers["X-Sentry-Auth"]
    assert set(event) == set(jevent)
    exc = event["exception"]["values"][0]
    assert (exc["type"], exc["value"]) == ("RuntimeError", "boom in flush")
    assert exc["stacktrace"]["frames"]
    assert event["tags"] == {"thread": "flush-ticker"}
    assert event["level"] == jevent["level"] == "fatal"


@pytest.mark.parametrize("dsn", ["not-a-dsn", "https://x", "http://h/1",
                                 "http://key@h"])
def test_malformed_dsn_raises_like_jax(dsn, tmp_path):
    with pytest.raises(ValueError):
        crash.SentryReporter(dsn)
    with pytest.raises(ValueError):
        jcrash.SentryReporter(dsn)
    with pytest.raises(ValueError, match="DSN"):
        Config(sentry_dsn=dsn)
    with pytest.raises(ValueError):
        JConfig(sentry_dsn=dsn).validate()
    path = tmp_path / "c.yaml"
    path.write_text(f"sentry_dsn: '{dsn}'\n")
    with pytest.raises(ValueError, match="DSN"):
        read_config(str(path))


def test_guarded_reports_then_rethrows(sentry):
    rep = crash.SentryReporter(sentry)

    def bad():
        raise KeyError("panic")

    with pytest.raises(KeyError) as e:
        crash.guarded(bad, rep)()
    assert e.value._veneur_reported
    _wait_events(1)
    assert _SentryCapture.events[0][2]["exception"]["values"][0][
        "type"] == "KeyError"
    with pytest.raises(ZeroDivisionError):
        crash.guarded(lambda: 1 // 0, None)()
    assert crash.guarded(lambda x: x + 1, rep)(1) == 2


def test_excepthook_reports_an_unwrapped_thread_once(sentry, hook):
    rep = crash.SentryReporter(sentry)
    crash.install_excepthook(rep)
    t = threading.Thread(target=lambda: 1 // 0, name="stray")
    t.start()
    t.join(5)
    _wait_events(1)
    # a guarded thread's exception was reported already: not again
    t = threading.Thread(
        target=crash.guarded(lambda: [][1], rep), name="guarded")
    t.start()
    t.join(5)
    _wait_events(2)
    time.sleep(0.2)
    tags = [e[2]["tags"]["thread"] for e in _SentryCapture.events]
    assert tags == ["stray", "guarded"]


def test_server_thread_death_reaches_sentry(sentry, hook):
    server = Server(Config(statsd_listen_addresses=[], interval="86400s",
                           sentry_dsn=sentry, aggregates=["count"]),
                    metric_sinks=[ChannelMetricSink()], device="cpu")
    server.start()
    try:
        assert server._sentry is not None
        t = threading.Thread(target=server._guard(
            lambda: (_ for _ in ()).throw(RuntimeError("worker died"))),
            name="test-worker", daemon=True)
        t.start()
        t.join(5)
        _wait_events(1)
        event = _SentryCapture.events[0][2]
        assert event["exception"]["values"][0]["value"] == "worker died"
        assert event["tags"]["thread"] == "test-worker"
    finally:
        server.shutdown()


def test_profiling_writes_stats(tmp_path, monkeypatch, hook):
    monkeypatch.chdir(tmp_path)
    server = Server(Config(statsd_listen_addresses=[], interval="86400s",
                           enable_profiling=True, aggregates=["count"]),
                    metric_sinks=[ChannelMetricSink()], device="cpu")
    server.start()
    server.shutdown()
    path = tmp_path / "veneur-profile.pstats"
    assert os.path.exists(path)
    stats = pstats.Stats(str(path))  # parseable
    # the flush ticker ran under its own profiler and was merged in
    assert any(fn[2] == "_flush_loop" for fn in stats.stats)
