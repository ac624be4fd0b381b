"""The port's live debug endpoints (``veneur_tpu_torch/debug.py``) against
the JAX package's (``veneur_tpu/debug.py``).

* ``dump_threads`` and ``sample_profile`` on a running process: every
  thread named, the collapsed-stack format, the sampler left out of its
  own profile, one profile at a time.
* A port Server's ops server and a JAX Server's answer ``/debug/threads``,
  ``/debug/profile`` (with its ``Content-Disposition``), ``/debug/vars``,
  ``/debug/flush-timeline`` and ``/debug/xprof`` alike: the same vars
  sections (the fleet trace plane's ``obs.hops`` and ``obs.fleet``
  included), the same timeline schema and ``?n=`` limit, the same 400s
  for bad parameters.
* The proxy mounts ``/debug/threads``, ``/debug/profile``,
  ``/debug/vars`` (its ring counters beside the time and thread count)
  and its own ``/debug/flush-timeline`` (the fleet trace plane's hops).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from veneur_tpu import debug as jdebug
from veneur_tpu.config import Config as JConfig
from veneur_tpu.server import Server as JServer
from veneur_tpu.sinks import ChannelMetricSink as JChannel
from veneur_tpu_torch import debug as tdebug
from veneur_tpu_torch.config import Config, ProxyConfig
from veneur_tpu_torch.discovery import StaticDiscoverer
from veneur_tpu_torch.proxy import Proxy
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, r.read().decode(), dict(r.headers)


def _status(port, path):
    try:
        return _get(port, path)[0]
    except urllib.error.HTTPError as e:
        return e.code


def test_dump_threads_names_every_thread():
    ev = threading.Event()
    t = threading.Thread(target=ev.wait, name="debug-probe", daemon=True)
    t.start()
    try:
        dump = tdebug.dump_threads()
        assert "[debug-probe] daemon" in dump
        assert "[MainThread]" in dump
        # every Python thread, and threads Python did not start (a test
        # runner's) beside them
        assert dump.count("--- thread") >= len(threading.enumerate())
    finally:
        ev.set()
        t.join()


def _spin(stop):
    while not stop.is_set():
        sum(range(1000))


def test_sample_profile_is_collapsed_stacks_without_the_sampler():
    stop = threading.Event()
    t = threading.Thread(target=_spin, args=(stop,), daemon=True)
    t.start()
    try:
        for mod in (tdebug, jdebug):
            out = mod.sample_profile(0.2, hz=100)
            head, *lines = out.strip().split("\n")
            assert head.startswith("# ") and "sampling rounds" in head
            assert any("_spin" in ln for ln in lines)
            assert not any("sample_profile" in ln for ln in lines)
            for ln in lines:
                stack, count = ln.rsplit(" ", 1)
                assert int(count) > 0 and stack
    finally:
        stop.set()
        t.join()
    assert tdebug._profile_lock.acquire(blocking=False)
    try:
        assert tdebug.sample_profile(0.1).startswith("another profile")
    finally:
        tdebug._profile_lock.release()


def _run(server, sink):
    server.start()
    try:
        for _ in range(2):
            server.handle_metric_packet(b"dbg.h:3.5|h")
            server.handle_metric_packet(b"dbg.c:1|c")
            server.flush()
            sink.get_flush(timeout=30)
        port = server.ops_server.port
        out = {"vars": json.loads(_get(port, "/debug/vars")[1]),
               "timeline": json.loads(
                   _get(port, "/debug/flush-timeline?n=1")[1]),
               "threads": _get(port, "/debug/threads"),
               "profile": _get(port, "/debug/profile?seconds=0.1"),
               "bad": [_status(port, p) for p in (
                   "/debug/flush-timeline?n=x", "/debug/xprof?seconds=x",
                   "/debug/profile?seconds=x", "/debug/nothing")]}
    finally:
        server.shutdown()
    return out


@pytest.fixture(scope="module")
def both():
    cfg = dict(statsd_listen_addresses=[], interval="86400s",
               http_address="127.0.0.1:0", percentiles=[0.5],
               store_initial_capacity=32, store_chunk=128)
    tsink, jsink = ChannelMetricSink(), JChannel()
    port = _run(Server(Config(**cfg), metric_sinks=[tsink], device="cpu"),
                tsink)
    jax = _run(JServer(JConfig(**cfg), metric_sinks=[jsink]), jsink)
    return port, jax


# the JAX package's obs sections the port lacks: none since the fleet
# trace plane landed
PINNED_OBS = set()


def test_vars_sections_match_jax(both):
    port, jax = both
    assert set(port["vars"]) == set(jax["vars"])
    assert set(jax["vars"]["obs"]) - set(port["vars"]["obs"]) == PINNED_OBS
    assert set(port["vars"]["obs"]) == {"kernels", "timeline", "hops",
                                        "fleet"}
    for key in ("store", "overload"):
        assert set(port["vars"][key]) == set(jax["vars"][key]), key
    assert set(port["vars"]["store"]["groups"]) == \
        set(jax["vars"]["store"]["groups"])
    assert port["vars"]["obs"]["timeline"]["published_total"] == 2
    dispatches = port["vars"]["obs"]["kernels"]["dispatches"]
    assert dispatches["flush.digest.dense"] >= 2


def test_flush_timeline_route_matches_jax(both):
    port, jax = both
    for got in (port["timeline"], jax["timeline"]):
        assert got["published_total"] == 2 and len(got["intervals"]) == 1
        (entry,) = got["intervals"]
        assert entry["interval"] == 1
        assert {"total_duration_ns", "coverage_ratio", "stages",
                "tree"} <= set(entry)
    names = {s["name"] for s in port["timeline"]["intervals"][0]["stages"]}
    want = {s["name"] for s in jax["timeline"]["intervals"][0]["stages"]}
    assert names == want


def test_threads_and_profile_routes(both):
    for got in both:
        status, body, _ = got["threads"]
        assert status == 200 and "--- thread" in body
        status, body, headers = got["profile"]
        assert status == 200 and body.startswith("# ")
        assert "veneur-profile.collapsed" in headers["Content-Disposition"]


def test_bad_parameters_answer_like_jax(both):
    port, jax = both
    assert port["bad"] == jax["bad"] == [400, 400, 400, 404]


def test_proxy_mounts_the_debug_routes():
    proxy = Proxy(ProxyConfig(http_address="127.0.0.1:0"),
                  discoverer=StaticDiscoverer(["http://127.0.0.1:9"]))
    proxy.start()
    try:
        status, body, _ = _get(proxy.port, "/debug/threads")
        assert status == 200 and "--- thread" in body
        data = json.loads(_get(proxy.port, "/debug/vars")[1])
        assert {"time", "threads"} <= set(data)
        assert set(proxy.vars()) <= set(data)
        # the proxy's own timeline of trace-bearing fan-outs: none yet
        status, body, _ = _get(proxy.port, "/debug/flush-timeline")
        assert status == 200 and json.loads(body)["intervals"] == []
    finally:
        proxy.shutdown()
