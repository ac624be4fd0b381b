"""The port's fault hooks against the JAX package's, call for call.

* ``wrap_post``, ``maybe_fail`` and ``mangle_packet`` give the JAX
  injector's outcomes for seeded kinds, rates and scopes;
* each hooked op (``forward.http``, ``forward.grpc``,
  ``forward.native``, ``sink.datadog``, ``sink.signalfx``,
  ``proxy.post``) injects at the same call indices as the JAX package's
  under one config, through the same retry ladder, with the same
  retries and errors;
* a port Datadog sink with 30% of its POSTs faulted delivers every one
  of 20 intervals (JAX ``tests/test_resilience.py``);
* a port local forwarding under faults lands at a port global the rows
  a JAX local lands at a JAX global under the same seed;
* the ingest kinds on ``Server.handle_packet`` leave the port Server's
  counters and error counts equal to the JAX Server's for the same
  datagrams.
"""

import struct
import time

import numpy as np
import pytest

from veneur_tpu.config import Config as JConfig
from veneur_tpu.config import ProxyConfig as JProxyConfig
from veneur_tpu.discovery import StaticDiscoverer as JStatic
from veneur_tpu.forward import grpc_forward as jgrpc
from veneur_tpu.forward import http_forward as jhttp
from veneur_tpu.forward import native_transport as jnative
from veneur_tpu.proxy.proxy import Proxy as JProxy
from veneur_tpu.resilience import Deadline as JDeadline
from veneur_tpu.resilience import RetryPolicy as JRetry
from veneur_tpu.resilience import faults as jfaults
from veneur_tpu.samplers import intermetric as jim
from veneur_tpu.server import Server as JServer
from veneur_tpu.sinks import ChannelMetricSink as JChannel
from veneur_tpu.sinks import datadog as jdd
from veneur_tpu.sinks import signalfx as jsfx
from veneur_tpu.core import store as jstore
from veneur_tpu_torch import flusher as tflusher
from veneur_tpu_torch.config import Config, ProxyConfig
from veneur_tpu_torch.core import store as tstore
from veneur_tpu_torch.discovery import StaticDiscoverer
from veneur_tpu_torch.forward import grpc_forward as tgrpc
from veneur_tpu_torch.forward import http_forward as thttp
from veneur_tpu_torch.forward import native_transport as tnative
from veneur_tpu_torch.proxy import proxy as tproxy
from veneur_tpu_torch.resilience import Deadline, RetryPolicy
from veneur_tpu_torch.resilience import faults as rfaults
from veneur_tpu_torch.samplers import intermetric as tim
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks import datadog as tdd
from veneur_tpu_torch.sinks import signalfx as tsfx
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

SIDES = {"jax": jfaults, "port": rfaults}


def _outcome(fn):
    """What one hooked call did: its return value, or its exception's
    class name (the injected classes share names across packages)."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the outcome is the point
        return ("raised", type(e).__name__)


# -- the injector, call for call -------------------------------------------


@pytest.mark.parametrize("seed,rate,kinds,scope", [
    (1, 0.3, jfaults.ALL_KINDS, ""),
    (7, 0.5, ("http_5xx", "connect", "truncate", "burst"), ""),
    (11, 0.9, ("truncate", "burst", "timeout"), "ingest"),
    (13, 0.2, ("partial_write", "burst", "disk_full", "member_add"),
     "forward"),
])
def test_hooks_equal_the_jax_injectors(seed, rate, kinds, scope):
    """One seeded stream of wrap_post, maybe_fail and mangle_packet calls
    over mixed ops: every outcome, the injected counts and the call count
    equal the JAX injector's."""
    rng = np.random.default_rng(seed)
    ops = ["forward.http", "ingest.statsd", "forward.native", "sink.x"]
    script = [(int(rng.integers(0, 3)), ops[int(rng.integers(0, 4))],
               bytes(rng.integers(97, 123, int(rng.integers(1, 40)))
                     .astype(np.uint8)))
              for _ in range(400)]
    out = {}
    for side, mod in SIDES.items():
        inj = mod.FaultInjector(rate, seed=seed, kinds=kinds, scope=scope)
        post = inj.wrap_post(lambda data: 202, "forward.http")
        seq = []
        for hook, op, data in script:
            if hook == 0:
                seq.append(_outcome(lambda: post(data)))
            elif hook == 1:
                seq.append(_outcome(lambda: inj.maybe_fail(op)))
            else:
                seq.append(inj.mangle_packet(op, data))
        out[side] = (seq, inj.injected, inj.calls)
    assert out["port"] == out["jax"]
    assert sum(out["port"][1].values()) > 0
    assert rfaults.INJECTED_STATUS == jfaults.INJECTED_STATUS
    assert rfaults.BURST_MAX_COPIES == jfaults.BURST_MAX_COPIES
    assert rfaults.INGEST_KINDS == jfaults.INGEST_KINDS


def test_every_kind_loads_in_a_config():
    """Each known kind loads in a Server's and a proxy's config, as in
    the JAX package's."""
    assert set(rfaults.KNOWN_KINDS) == set(
        jfaults.ALL_KINDS + jfaults.INGEST_KINDS + jfaults.CHURN_KINDS
        + jfaults.SOAK_KINDS)
    for kind in rfaults.KNOWN_KINDS:
        Config(fault_injection_rate=0.5, fault_injection_kinds=kind)
        ProxyConfig(fault_injection_rate=0.5, fault_injection_kinds=kind,
                    forward_address="127.0.0.1:1")


# -- each hooked op, through its own retry ladder ---------------------------

FAULT_CFG = dict(fault_injection_rate=0.35, fault_injection_seed=5,
                 fault_injection_kinds="http_5xx,connect,timeout,"
                 "partial_write")
CALLS = 24


def _policy(side):
    return (JRetry if side == "jax" else RetryPolicy)(
        max_attempts=3, base_interval=0.0001, max_interval=0.0002)


def _recorded(inj):
    """Record every scheduling decision of ``inj`` (call index order)."""
    seen = []
    real = inj.should_fail

    def should_fail(op):
        kind = real(op)
        seen.append((op, kind))
        return kind

    inj.should_fail = should_fail
    return seen


def _injector(side):
    mod = SIDES[side]
    cfg = (JConfig if side == "jax" else Config)(**FAULT_CFG)
    return mod.from_config(cfg)


def _state(side):
    mod = jstore if side == "jax" else tstore
    return mod.ForwardableState(counters=[("fault.c", ["k:v"], 3)])


def _op_forward_http(side, monkeypatch):
    mod = jhttp if side == "jax" else thttp
    real = []
    monkeypatch.setattr(mod, "post_helper", lambda *a, **k: real.append(1)
                        or 202)
    inj = _injector(side)
    seen = _recorded(inj)
    fwd = mod.HTTPForwarder("http://127.0.0.1:1", retry_policy=_policy(side),
                            fault_injector=inj)
    results = [fwd.forward(_state(side)) for _ in range(CALLS)]
    return seen, results, (fwd.retries, fwd.errors, len(real))


def _op_forward_grpc(side, monkeypatch):
    mod = jgrpc if side == "jax" else tgrpc
    inj = _injector(side)
    seen = _recorded(inj)
    fwd = mod.GRPCForwarder("127.0.0.1:1", retry_policy=_policy(side),
                            fault_injector=inj)
    real = []
    fake = lambda payload, timeout=None, metadata=None: real.append(1)  # noqa
    if side == "jax":
        fwd._send_raw = fake
    else:
        fwd._send = fake
    for _ in range(CALLS):
        fwd.forward(_state(side))  # the JAX forward returns nothing
    fwd.close()
    return seen, [], (fwd.retries, fwd.errors, len(real))


class _AckingSocket:
    """A connected socket whose peer acks every frame as merged."""

    def __init__(self, sent):
        self.sent = sent

    def sendall(self, data):
        self.sent.append(len(data))

    def recv_into(self, view, n):
        view[:4] = struct.pack(">I", 1)
        return 4

    def settimeout(self, t):
        pass

    def close(self):
        pass


def _op_forward_native(side, monkeypatch):
    mod = jnative if side == "jax" else tnative
    inj = _injector(side)
    seen = _recorded(inj)
    fwd = mod.NativeForwarder("native://127.0.0.1:1",
                              retry_policy=_policy(side),
                              fault_injector=inj)
    sent = []
    fwd._connect = lambda deadline=None: _AckingSocket(sent)
    for _ in range(CALLS):
        fwd.forward(_state(side))  # the JAX forward returns nothing
    return seen, [], (fwd.retries, fwd.errors, len(sent))


def _rows(side, i):
    im = jim if side == "jax" else tim
    return [im.InterMetric(name=f"m{i}", timestamp=i, value=1.0,
                           type=im.MetricType.GAUGE)]


def _flush_sink(side, sink):
    for i in range(CALLS):
        sink.set_flush_deadline((JDeadline if side == "jax"
                                 else Deadline).after(5.0))
        sink.flush(_rows(side, i))


def _op_sink_datadog(side, monkeypatch):
    mod = jdd if side == "jax" else tdd
    inj = _injector(side)
    seen = _recorded(inj)
    real = []
    sink = mod.DatadogMetricSink(
        interval=10.0, flush_max_per_body=1000, hostname="h", tags=[],
        dd_hostname="http://dd.test", api_key="k",
        post=lambda *a, **k: real.append(1) or 202,
        retry_policy=_policy(side), fault_injector=inj)
    _flush_sink(side, sink)
    return seen, [], (sink.retries, sink.flush_errors, len(real))


def _op_sink_signalfx(side, monkeypatch):
    mod = jsfx if side == "jax" else tsfx
    real = []

    class Client:
        def submit(self, points):
            real.append(len(points))
            return 200

        def submit_event(self, event):
            return 200

    inj = _injector(side)
    seen = _recorded(inj)
    sink = mod.SignalFxSink(hostname_tag="host", hostname="h",
                            client=Client(), retry_policy=_policy(side),
                            fault_injector=inj)
    _flush_sink(side, sink)
    return seen, [], (sink.retries, sink.flush_errors, len(real))


def _op_proxy_post(side, monkeypatch):
    real = []
    if side == "jax":
        from veneur_tpu.proxy import proxy as mod
        cfg = JProxyConfig(http_address="127.0.0.1:0", retry_max=2,
                           retry_base_interval="1ms", **FAULT_CFG)
    else:
        mod = tproxy
        cfg = ProxyConfig(http_address="127.0.0.1:0", retry_max=2,
                          retry_base_interval="1ms", **FAULT_CFG)
    monkeypatch.setattr(mod, "post_helper",
                        lambda *a, **k: real.append(1) or 202)
    proxy = (JProxy if side == "jax" else tproxy.Proxy)(
        cfg, discoverer=(JStatic if side == "jax" else StaticDiscoverer)(
            ["127.0.0.1:9"]))
    seen = _recorded(proxy.fault_injector)
    for i in range(CALLS):
        proxy._post_batch_inner("127.0.0.1:9", [{"name": f"m{i}"}],
                                "/import", True, "proxied", "metrics",
                                None)
    return seen, [], (proxy.forward_retries, proxy.forward_errors,
                      len(real))


OPS = {"forward.http": _op_forward_http, "forward.grpc": _op_forward_grpc,
       "forward.native": _op_forward_native,
       "sink.datadog": _op_sink_datadog, "sink.signalfx": _op_sink_signalfx,
       "proxy.post": _op_proxy_post}


@pytest.mark.parametrize("op", sorted(OPS))
def test_hooked_op_injects_at_the_jax_call_indices(op, monkeypatch):
    """One config on both sides: the port's hook draws the JAX package's
    schedule at the same attempts (op name and kind, call for call), the
    forwarders return the same outcomes, and the retries, errors and
    real sends agree."""
    got = {side: OPS[op](side, monkeypatch) for side in SIDES}
    assert got["port"] == got["jax"]
    seen, _, (retries, _, real) = got["port"]
    assert {o for o, _ in seen} == {op}
    assert any(kind is not None for _, kind in seen) and retries > 0
    assert real > 0


# -- the Datadog sink's acceptance loop (JAX tests/test_resilience.py) ------


def test_thirty_percent_faults_twenty_intervals_all_delivered():
    """With 30% of its POSTs faulted, a port Datadog sink delivers each
    of 20 intervals (the retries land inside the deadline) and the
    flusher's self-metrics carry its retries."""
    delivered = []
    inj = rfaults.FaultInjector(rate=0.3, seed=11)
    sink = tdd.DatadogMetricSink(
        interval=10.0, flush_max_per_body=1000, hostname="h", tags=[],
        dd_hostname="http://dd.test", api_key="k",
        post=lambda url, payload, **kw: delivered.append(url) or 202,
        retry_policy=RetryPolicy(max_attempts=6, base_interval=0.001,
                                 max_interval=0.004),
        fault_injector=inj)
    for i in range(20):
        sink.set_flush_deadline(Deadline.after(5.0))
        sink.flush(_rows("port", i))
    assert len(delivered) == 20
    assert sink.retries > 0 and sum(inj.injected.values()) > 0
    assert sink.flush_errors == 0

    class Stub:
        metric_sinks = [sink]

    samples = {s.name: s for s in tflusher._sink_samples(Stub(), {})}
    assert samples["veneur.sink.datadog.retries_total"].value == sink.retries


# -- a local and a global under forward faults -------------------------------

PCTS = [0.5, 0.9]
LOCAL_CFG = dict(interval="3600s", percentiles=PCTS,
                 aggregates=["min", "max", "count"], flush_streaming=False,
                 forward_timeout="60s", retry_max=8,
                 retry_base_interval="1ms", fault_injection_rate=0.3,
                 fault_injection_seed=3,
                 fault_injection_kinds="http_5xx,connect,timeout",
                 fault_injection_scope="forward.http")


def _lines(seed=3):
    rng = np.random.default_rng(seed)
    out, raw = [], {}
    for i in range(48):
        for v in np.round(rng.gamma(2.0, 10.0, 12), 3):
            out.append(f"f.h.{i}:{v}|h".encode())
            raw.setdefault(f"f.h.{i}", []).append(float(v))
        out.append(f"f.c.{i}:{i + 1}|c|#veneurglobalonly".encode())
        for m in range(int(rng.integers(1, 30))):
            out.append(f"f.s.{i}:m{m}|s".encode())
    return out, raw


def _wait(pred, timeout=60.0):
    deadline = time.time() + timeout
    while not pred():
        if time.time() > deadline:
            raise AssertionError("timed out")
        time.sleep(0.02)


def _forwarded_rows(side, lines):
    """A local of ``side`` forwards two flushes under the faults to a
    global of ``side``; returns the global's f.* rows by key and the
    local forwarder's injected counts and retries."""
    if side == "jax":
        gsink = JChannel()
        glob = JServer(JConfig(http_address="127.0.0.1:0", interval="3600s",
                               percentiles=PCTS, hostname="g"),
                       metric_sinks=[gsink])
    else:
        gsink = ChannelMetricSink()
        glob = Server(Config(http_address="127.0.0.1:0", interval="3600s",
                             percentiles=PCTS, hostname="g"),
                      metric_sinks=[gsink], device="cpu")
    glob.start()
    try:
        addr = f"http://127.0.0.1:{glob.ops_server.port}"
        if side == "jax":
            local = JServer(JConfig(forward_address=addr, hostname="l",
                                    **LOCAL_CFG), metric_sinks=[JChannel()])
        else:
            local = Server(Config(forward_address=addr, hostname="l",
                                  **LOCAL_CFG),
                           metric_sinks=[ChannelMetricSink()], device="cpu")
        local.start()
        try:
            for interval in range(2):
                for line in lines:
                    assert local.handle_metric_packet(line)
                local.flush()
                _wait(lambda: glob.ops_server.import_pool.merged_batches
                      >= interval + 1)
            fwd = local._forwarder if side == "jax" else local.forwarder
            got = (dict(fwd._faults.injected), fwd._faults.calls,
                   fwd.retries, fwd.errors)
            glob.flush()
            rows = [m for m in gsink.get_flush(timeout=30)
                    if m.name.startswith("f.")]
        finally:
            local.shutdown()
    finally:
        glob.shutdown()
    return {(m.name, tuple(m.tags)): m.value for m in rows}, got


def test_faulted_forward_lands_the_jax_rows():
    """30% http_5xx/connect/timeout on forward.http, retries enough to
    deliver: the port pair's global emits the JAX pair's rows (counters
    exact, set estimates rtol 1e-6, percentiles within 0.02 x the
    samples' span), after the same injected faults, attempts and
    retries, and no forward error."""
    lines, raw = _lines()
    port, port_faults = _forwarded_rows("port", lines)
    jax, jax_faults = _forwarded_rows("jax", lines)
    assert port_faults == jax_faults
    injected, calls, retries, errors = port_faults
    assert sum(injected.values()) > 0 and retries > 0 and errors == 0
    # a counter, a set and two percentiles a series (the local emits the
    # aggregates)
    assert set(port) == set(jax) and len(port) == 48 * 4
    for (name, tags), want in jax.items():
        have = port[(name, tags)]
        if "percentile" in name:
            base = name.rsplit(".", 1)[0]
            span = max(raw[base]) - min(raw[base])
            assert abs(have - want) <= 0.02 * span + 1e-6, name
        elif name.startswith("f.s."):
            np.testing.assert_allclose(have, want, rtol=1e-6, err_msg=name)
        else:
            assert have == pytest.approx(want, rel=1e-6), name


# -- the ingest kinds ----------------------------------------------------------


def test_ingest_kinds_equal_the_jax_server():
    """truncate and burst on the per-datagram path: the same datagrams
    through handle_packet leave the port Server's counter and histogram
    rows, its packet errors and quarantines, and its injector's schedule
    equal to the JAX Server's."""
    rng = np.random.default_rng(21)
    grams = []
    for i in range(600):
        lines = [f"i.c.{i % 37}:{int(rng.integers(1, 9))}|c",
                 f"i.h.{i % 23}:{rng.gamma(2.0, 10.0):.3f}|h"]
        grams.append("\n".join(lines).encode())
    cfg = dict(interval="3600s", percentiles=[0.5],
               aggregates=["min", "max", "count"],
               fault_injection_rate=0.25, fault_injection_seed=8,
               fault_injection_kinds="truncate,burst,http_5xx")
    out = {}
    for side in SIDES:
        if side == "jax":
            sink = JChannel()
            server = JServer(JConfig(**cfg), metric_sinks=[sink])
        else:
            sink = ChannelMetricSink()
            server = Server(Config(**cfg), metric_sinks=[sink],
                            device="cpu")
        for g in grams:
            server.handle_packet(g)
        server.flush()
        rows = {(m.name, tuple(m.tags)): m.value for m in sink.get_flush()
                if m.name.startswith("i.")}
        inj = server.ingest_injector
        errors = (server.packet_errors, server.quarantine.total()
                  if side == "jax" else server.quarantined)
        out[side] = (rows, errors, dict(inj.injected), inj.calls)
    assert out["port"][1:] == out["jax"][1:]
    assert set(out["port"][0]) == set(out["jax"][0])
    for key, want in out["jax"][0].items():
        if "percentile" not in key[0]:
            assert out["port"][0][key] == pytest.approx(want), key
    injected = out["port"][2]
    assert injected["truncate"] > 0 and injected["burst"] > 0
    # every truncated line that no longer parses is one error
    assert out["port"][1][0] > 0
