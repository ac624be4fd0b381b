"""The port's gRPC forward and import against the JAX package's.

A local with ``forward_use_grpc: true`` sends its ForwardableState as
MetricList frames (the ``native://`` lane's, ``encode_forwardable_frames``)
over raw-bytes gRPC ``Forward.SendMetrics``; a global with
``grpc_address`` decodes each request in C++ and merges it through
``MetricStore.import_columnar``. Held here, on the CPU, at a few hundred
series from the seeded traffic of ``tests/test_torch_native_forward.py``
(numpy seed 3):

* interop both ways, packed, dense (``forward_packed_digests: false``)
  and ``forward_reference_compatible``: the port's GRPCForwarder into
  the JAX ImportServer and the JAX GRPCForwarder into the port's; each
  global's rows against the same package's own pair: counters, gauges
  and counts exact (the count is the digest mass, so mass within rtol
  1e-6 holds a fortiori), set estimates within one float32 ulp (the
  packages' HLL estimators round differently by one ulp), percentiles
  within 0.02 x (max - min) of the raw samples; and the port's global
  against the JAX global fed the same port local: percentiles within
  rtol 1e-5, everything else exact;
* the frames: a gRPC global's rows equal a ``native://`` global's bit
  for bit when both take the same encoded frames;
* Servers end to end: a port local over ``forward_use_grpc`` into a port
  global's ``grpc_address`` emits what the same traffic over HTTP emits
  (the tolerances above), and ``grpc_address`` on a slab and on a tiered
  global emits what a dense store fed the same frames emits;
* the dryrun's shape (``__graft_entry__._dryrun_serving``, numpy seed
  5): two port locals over gRPC into a port mesh global (4 x 2 on the
  CPU, ``mesh_hosts: 2``) against the JAX package's run of the same
  input: percentiles within rtol 1e-5, the counter exact;
* the lane's edges: a request that fails whole (INTERNAL, one import
  error, no retry), an unreachable global (retries, then one
  error), the breaker gate, ``retarget``, no protobuf fallback without
  the egress library, and a missing grpcio raising ``UnsupportedConfig``.

Every forwarder in these tests has a timeout of at most 10 s.
"""

import socket
import sys
import time

import numpy as np
import pytest
import torch

from veneur_tpu.config import Config as JConfig
from veneur_tpu.core import store as jstore
from veneur_tpu.forward import grpc_forward as jg
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.server import Server as JServer
from veneur_tpu.sinks import ChannelMetricSink as JChannelSink
from veneur_tpu_torch import flusher as tflusher
from veneur_tpu_torch.config import (Config, ProxyConfig, UnsupportedConfig,
                                     config_from_dict)
from veneur_tpu_torch.core import store as tstore
from veneur_tpu_torch.forward import configure_forwarding
from veneur_tpu_torch.forward import grpc_forward as tg
from veneur_tpu_torch.forward import native_transport as tnt
from veneur_tpu_torch.native import egress as tegress
from veneur_tpu_torch.parallel.mesh import fleet_mesh
from veneur_tpu_torch.resilience import (CircuitBreaker, Deadline,
                                         RetryPolicy)
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

from tests.test_torch_native_forward import (AGGS, CHUNK, LINES, PCTS, TOPK,
                                             assert_global_rows_match,
                                             by_key, jax_flush,
                                             jax_global_rows, jax_local,
                                             port_flush, port_global_rows,
                                             port_local)

TIMEOUT = 10.0


@pytest.fixture(scope="module", autouse=True)
def egress_libraries():
    """Both packages' egress libraries (g++ and zlib.h)."""
    from veneur_tpu.native import egress as jegress

    if not (tegress.available() and jegress.available()):
        pytest.skip("the native egress library does not build here")


def _wait(cond, timeout=TIMEOUT):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, "timed out"
        time.sleep(0.01)


def _global(pkg):
    if pkg == "jax":
        return jstore.MetricStore(chunk=CHUNK, **TOPK)
    return tstore.MetricStore(chunk=CHUNK, device="cpu", **TOPK)


def _local_state(pkg, layout):
    fmt = "packed" if layout == "packed" else "dense"
    if pkg == "port":
        return port_flush(port_local(), fmt)
    return jax_flush(jax_local(), fmt)


def _send(src, dst, gstore, state, compat=False):
    """One forward over loopback gRPC from package ``src``'s forwarder
    into package ``dst``'s ImportServer; returns the merged count."""
    srv = (tg.ImportServer if dst == "port" else jg.ImportServer)(gstore)
    port = srv.start("127.0.0.1:0")
    fwd = (tg.GRPCForwarder if src == "port" else jg.GRPCForwarder)(
        f"127.0.0.1:{port}", timeout=TIMEOUT, reference_compat=compat)
    try:
        ok = fwd.forward(state)
        assert ok in (True, None) and fwd.errors == 0
    finally:
        fwd.close()
        srv.stop()
    assert srv.import_errors == 0 and srv.received > 0
    return srv.received


def _rows(pkg, gstore):
    return port_global_rows(gstore) if pkg == "port" \
        else jax_global_rows(gstore)


@pytest.mark.parametrize("layout", ["packed", "dense", "compat"])
def test_interop_both_ways(layout):
    """Each package's local into each package's global over gRPC: the
    cross-package globals emit what the same package's pair emits, and
    the port's and the JAX global fed the same port local agree within
    rtol 1e-5 (the module docstring's tolerances)."""
    compat = layout == "compat"
    rows, received = {}, {}
    for src in ("port", "jax"):
        for dst in ("port", "jax"):
            g = _global(dst)
            received[src, dst] = _send(src, dst, g, _local_state(
                src, "dense" if compat else layout), compat)
            rows[src, dst] = _rows(dst, g)
    # every series of the traffic merged: 240 digests, 30 sets, 24
    # counters, 24 gauges (the top-k sketch travels but for compat)
    assert set(received.values()) == {240 + 30 + 48 + (0 if compat else 1)}
    assert_global_rows_match(rows["port", "jax"], rows["port", "port"])
    assert_global_rows_match(rows["jax", "port"], rows["jax", "jax"])
    assert_global_rows_match(rows["port", "port"], rows["jax", "jax"])
    got, want = by_key(rows["port", "port"]), by_key(rows["port", "jax"])
    assert set(got) == set(want)
    for key, value in want.items():
        if key[0].rpartition(".")[2].endswith("percentile"):
            assert got[key] == pytest.approx(value, rel=1e-5), key
        elif key[0].startswith("s."):
            assert abs(got[key] - value) <= np.spacing(np.float32(value))
        else:
            assert got[key] == value, key


def test_grpc_global_equals_native_global_bit_for_bit():
    """The same encoded frames into a gRPC global and a native:// global
    (the send_frames path): every emitted row equal."""
    frames = tnt.encode_forwardable_frames(
        port_flush(port_local()), 100.0, False, tg.GRPCForwarder.CHUNK_BYTES)
    stores = {}
    for lane in ("grpc", "native"):
        g = stores[lane] = _global("port")
        srv = (tg.ImportServer if lane == "grpc"
               else tnt.NativeImportServer)(g)
        port = srv.start("127.0.0.1:0")
        try:
            if lane == "grpc":
                fwd = tg.GRPCForwarder(f"127.0.0.1:{port}", timeout=TIMEOUT)
                assert fwd.send_frames(frames) is True
                assert fwd.post_content_lengths == [len(f) for f, _ in
                                                    frames]
            else:
                fwd = tnt.NativeForwarder(f"native://127.0.0.1:{port}",
                                          timeout=TIMEOUT)
                assert fwd._forward_frames(list(frames), [],
                                           Deadline.after(TIMEOUT))
            assert fwd.forwarded == sum(rows for _, rows in frames)
            fwd.close()
        finally:
            srv.stop()
        assert srv.received == 240 + 30 + 48 + 1
    assert by_key(port_global_rows(stores["grpc"])) == \
        by_key(port_global_rows(stores["native"]))


def test_failed_request_is_counted_not_retried():
    """A request the store cannot merge: INTERNAL, one import error,
    nothing merged, and the forwarder neither retries it (it could merge
    twice) nor trips its breaker (a permanent status proves the global
    alive); a metric of an unknown type counts its error and the rest
    merges; junk merges nothing."""
    from veneur_tpu_torch.protocol import mlist

    g = _global("port")
    srv = tg.ImportServer(g)
    port = srv.start("127.0.0.1:0")
    breaker = CircuitBreaker(failure_threshold=1)
    fwd = tg.GRPCForwarder(f"127.0.0.1:{port}", timeout=TIMEOUT,
                           retry_policy=RetryPolicy(max_attempts=3,
                                                    base_interval=0.01),
                           breaker=breaker)
    ok_metric = mlist.counter("ok", [], 2)
    real = g.import_columnar
    try:
        g.import_columnar = lambda dec, data: 1 / 0
        assert fwd.send_frames([(mlist.metric_list([ok_metric]), 1)]) \
            is False
        assert (fwd.errors, fwd.retries, fwd.forwarded) == (1, 0, 0)
        assert breaker.state == "closed"
        assert (srv.import_errors, srv.received) == (1, 0)
        g.import_columnar = real
        assert fwd.send_frames([(mlist.metric_list(
            [mlist.metric("x", [], 9, 5, b""), ok_metric]), 2)]) is True
        assert (srv.import_errors, srv.received) == (2, 1)
        assert fwd.send_frames([(b"junk!", 0)]) is True
        assert (srv.import_errors, srv.received) == (2, 1)
    finally:
        fwd.close()
        srv.stop()
    assert by_key(port_global_rows(g)) == {("ok", (), "counter"): 2.0}


def test_unreachable_global_retries_then_fails():
    """No listener: UNAVAILABLE is retried inside the deadline, then the
    forward fails once and the breaker counts it."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    breaker = CircuitBreaker(failure_threshold=1)
    fwd = tg.GRPCForwarder(f"127.0.0.1:{port}", timeout=2.0,
                           retry_policy=RetryPolicy(max_attempts=3,
                                                    base_interval=0.01),
                           breaker=breaker)
    try:
        assert fwd.forward(port_flush(port_local())) is False
        assert (fwd.errors, fwd.retries) == (1, 2)
        assert breaker.state == "open"
        # an open breaker skips the next forward before its encode
        encodes = len(fwd.encode_durations)
        assert fwd.forward(port_flush(port_local())) is False
        assert fwd.errors == 2 and len(fwd.encode_durations) == encodes
    finally:
        fwd.close()


def test_retarget_moves_the_channel():
    stores = [_global("port") for _ in range(2)]
    servers = [tg.ImportServer(s) for s in stores]
    ports = [s.start("127.0.0.1:0") for s in servers]
    fwd = tg.GRPCForwarder(f"grpc://127.0.0.1:{ports[0]}", timeout=TIMEOUT)
    try:
        assert fwd.addr == f"127.0.0.1:{ports[0]}"
        fwd.retarget(f"127.0.0.1:{ports[1]}")
        assert fwd.forward(port_flush(port_local())) is True
    finally:
        fwd.close()
        for s in servers:
            s.stop()
    assert servers[0].received == 0 and servers[1].received > 0


def test_no_fallback_without_the_egress_library(monkeypatch):
    """The import decodes in C++ only: a library that cannot load makes
    start() raise (the JAX package would fall back to protobuf)."""
    def broken():
        raise RuntimeError("native egress unavailable: test")

    monkeypatch.setattr(tegress, "load", broken)
    srv = tg.ImportServer(_global("port"))
    with pytest.raises(RuntimeError, match="egress"):
        srv.start("127.0.0.1:0")
    with pytest.raises(ValueError, match="store"):
        tg.ImportServer(None)


def test_grpc_keys_accepted_and_missing_grpcio_refused(monkeypatch):
    """forward_use_grpc and grpc_address load and build the gRPC lanes
    (packed by default, dense with forward_packed_digests: false, no
    top-k and dense for a reference global); with grpc blocked from
    import every gRPC key raises UnsupportedConfig naming grpcio."""
    class Srv:
        forward_fn = None

    for packed in (True, False):
        srv = Srv()
        srv.config = Config(hostname="h", forward_address="127.0.0.1:1",
                            forward_use_grpc=True,
                            forward_packed_digests=packed)
        fwd = configure_forwarding(srv)
        assert isinstance(fwd, tg.GRPCForwarder)
        assert fwd.wants_packed_digests is packed and fwd.supports_topk
        assert srv.forward_fn == fwd.forward
        fwd.close()
    srv = Srv()
    srv.config = Config(hostname="h", forward_address="127.0.0.1:1",
                        forward_use_grpc=True,
                        forward_reference_compatible=True)
    fwd = configure_forwarding(srv)
    assert not fwd.wants_packed_digests and not fwd.supports_topk
    fwd.close()
    assert config_from_dict({"grpc_address": "127.0.0.1:0"}).grpc_address \
        == "127.0.0.1:0"
    monkeypatch.setitem(sys.modules, "grpc", None)
    for kw in ({"forward_address": "h:1", "forward_use_grpc": True},
               {"grpc_address": "127.0.0.1:0"}):
        with pytest.raises(UnsupportedConfig, match="grpcio"):
            Config(hostname="h", **kw)
    with pytest.raises(UnsupportedConfig, match="grpcio"):
        ProxyConfig(forward_address="h:1",
                    grpc_forward_address="127.0.0.1:0").finalize()


# ---------------------------------------------------------------------------
# Servers end to end
# ---------------------------------------------------------------------------


def _send_lines(server, lines=LINES):
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
        for i in range(0, len(lines), 8):
            tx.sendto(b"\n".join(lines[i:i + 8]),
                      ("127.0.0.1", server.statsd_addrs[0][1]))
    _wait(lambda: server.store.processed == len(lines), 30)


def _through(glob, gsink, address, **cfg):
    """LINES into a fresh port local Server forwarding to ``address``;
    the global then flushes. Returns its rows but the servers' own
    self-metrics (``veneur.*``: each flush's span re-enters its server),
    and the metrics the local's final (shutdown) flush forwarded: its
    own ``veneur.*`` timers of the first flush."""
    local = Server(Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                          interval="3600s", percentiles=PCTS,
                          aggregates=AGGS, hostname="l",
                          forward_address=address, forward_timeout="60s",
                          **TOPK, **cfg),
                   metric_sinks=[ChannelMetricSink()], device="cpu")
    local.start()
    imported0 = glob.imported_metrics + glob.import_errors
    try:
        _send_lines(local)
        tflusher.flush_once(local)
        assert local.wait_forward(30) is True
        assert local.forwarder.errors == 0
        forwarded = local.forwarder.forwarded
        if address.startswith("http://"):
            # every metric forwarded is merged (the POST's 202 comes
            # before its merge)
            _wait(lambda: glob.imported_metrics + glob.import_errors
                  - imported0 == forwarded, 30)
        tflusher.flush_once(glob)
        rows = [m for m in gsink.get_flush(timeout=10)
                if not m.name.startswith("veneur.")]
    finally:
        local.shutdown()
    return rows, local.forwarder.forwarded - forwarded


@pytest.mark.parametrize("packed", [True, False])
def test_servers_grpc_matches_http(packed):
    """A port local with forward_use_grpc into a port global's
    grpc_address emits what the same traffic over HTTP/JSON emits; the
    global's import server stops with it."""
    gsink = ChannelMetricSink()
    glob = Server(Config(http_address="127.0.0.1:0",
                         grpc_address="127.0.0.1:0", interval="3600s",
                         percentiles=PCTS, aggregates=AGGS, hostname="g",
                         **TOPK), metric_sinks=[gsink], device="cpu")
    glob.start()
    try:
        assert isinstance(glob.import_server, tg.ImportServer)
        http, _ = _through(glob, gsink,
                           f"http://127.0.0.1:{glob.ops_server.port}")
        grpc_rows, own = _through(glob, gsink,
                                  f"127.0.0.1:{glob.import_server.port}",
                                  forward_use_grpc=True,
                                  forward_packed_digests=packed)
        assert glob.import_server.import_errors == 0
        assert own > 0
        assert glob.import_server.received == 240 + 30 + 48 + 1 + own
        assert_global_rows_match(grpc_rows, http)
    finally:
        glob.shutdown()


# ---------------------------------------------------------------------------
# the dryrun's shape: two locals over gRPC into a mesh global
# ---------------------------------------------------------------------------

DRY_QS = [0.5, 0.99]


def _dry_values():
    """__graft_entry__._dryrun_serving's traffic: two locals, 6 timer
    series x 200 gamma(2, 30) samples each, and a global-only counter."""
    rng = np.random.default_rng(5)
    return [[rng.gamma(2.0, 30.0, 200) for _ in range(6)] for _ in range(2)]


def _dry_lines(vals):
    lines = [f"fleet.lat{i}:{v:.4f}|ms".encode()
             for i, series in enumerate(vals) for v in series]
    return lines + [b"fleet.req:7|c|#veneurglobalonly"]


def _dry_port(values):
    gsink = ChannelMetricSink()
    mesh = fleet_mesh([torch.device("cpu")] * 8, hosts=2)
    glob = Server(Config(interval="86400s", grpc_address="127.0.0.1:0",
                         percentiles=DRY_QS, aggregates=["count"],
                         hostname="g", store_initial_capacity=32,
                         store_chunk=128, mesh_enabled=True, mesh_hosts=2),
                  metric_sinks=[gsink], device="cpu", mesh=mesh)
    glob.start()
    try:
        for vals in values:
            local = Server(Config(
                interval="86400s", aggregates=["count"], hostname="l",
                forward_address=f"127.0.0.1:{glob.import_server.port}",
                forward_use_grpc=True, store_initial_capacity=32,
                store_chunk=128, forward_timeout="60s"),
                metric_sinks=[ChannelMetricSink()], device="cpu")
            local.start()
            try:
                for line in _dry_lines(vals):
                    local.store.process_metric(tparser.parse_metric(line))
                tflusher.flush_once(local)
                assert local.wait_forward(60) is True
            finally:
                local.shutdown()
        tflusher.flush_once(glob)
        # the traffic's rows (the Servers add their self-telemetry)
        rows = {m.name: m.value for m in gsink.get_flush(timeout=30)
                if m.name.startswith("fleet.")}
        store = glob.store
        assert store.compute.requeued_total == store.compute.lost_total == 0
        assert type(store.histograms).__name__ == "MeshDigestGroup"
    finally:
        glob.shutdown()
    return rows


def _dry_jax(values):
    gsink = JChannelSink()
    glob = JServer(JConfig(statsd_listen_addresses=[], interval="86400s",
                           grpc_address="127.0.0.1:0", percentiles=DRY_QS,
                           aggregates=["count"], store_initial_capacity=32,
                           store_chunk=128, mesh_enabled=True, mesh_hosts=2),
                   metric_sinks=[gsink])
    glob.start()
    try:
        for li, vals in enumerate(values):
            # the JAX mesh global compiles its import programs on the
            # first call: under a loaded test run that outlasts the
            # default 10 s forward budget, as the port local's 60 s
            local = JServer(JConfig(
                statsd_listen_addresses=[], interval="86400s",
                forward_address=f"127.0.0.1:{glob.import_server.port}",
                forward_use_grpc=True, aggregates=["count"],
                store_initial_capacity=32, store_chunk=128,
                forward_timeout="60s"),
                metric_sinks=[JChannelSink()])
            local.start()
            try:
                for line in _dry_lines(vals):
                    local.store.process_metric(jparser.parse_metric(line))
                local.flush()
                _wait(lambda: glob.store.imported >= 7 * (li + 1), 60)
            finally:
                local.shutdown()
        glob.flush()
        # the traffic's rows (the JAX Server adds its self-telemetry)
        return {m.name: m.value for m in gsink.get_flush()
                if m.name.startswith("fleet.")}
    finally:
        glob.shutdown()


def test_dryrun_shape_two_locals_over_grpc_into_a_mesh_global():
    """The JAX dryrun's serving path on the port: the mesh global's
    percentiles equal the JAX mesh global's within rtol 1e-5 on the same
    seeded input, the fleet counter is exact, and each percentile is
    within 0.10 of the span of the exact quantile (the dryrun's bound)."""
    values = _dry_values()
    got, want = _dry_port(values), _dry_jax(values)
    assert set(got) == set(want) and len(got) == 6 * len(DRY_QS) + 1
    assert got["fleet.req"] == want["fleet.req"] == 14.0
    for i in range(6):
        vals = np.concatenate([v[i] for v in values])
        span = vals.max() - vals.min()
        for q in DRY_QS:
            name = f"fleet.lat{i}.{int(q * 100)}percentile"
            assert got[name] == pytest.approx(want[name], rel=1e-5), name
            assert abs(got[name] - np.quantile(vals, q)) / span < 0.10


@pytest.mark.parametrize("storage", ["slab", "tiered"])
def test_grpc_import_into_slab_and_tiered_globals(storage):
    """grpc_address on a slab and on a tiered global Server: the same
    port local's state over gRPC merges whole (every metric received, no
    error) and emits what a dense global's store emits for the same
    frames (the module docstring's tolerances)."""
    frames = tnt.encode_forwardable_frames(
        port_flush(port_local()), 100.0, False, tg.GRPCForwarder.CHUNK_BYTES)
    dense = _global("port")
    for data, _ in frames:
        tnt.import_metric_list(dense, data)
    gsink = ChannelMetricSink()
    glob = Server(Config(grpc_address="127.0.0.1:0", interval="3600s",
                         percentiles=PCTS, aggregates=AGGS, hostname="g",
                         digest_storage=storage, slab_rows=256,
                         store_chunk=CHUNK, **TOPK),
                  metric_sinks=[gsink], device="cpu")
    glob.start()
    try:
        fwd = tg.GRPCForwarder(f"127.0.0.1:{glob.import_server.port}",
                               timeout=TIMEOUT)
        try:
            assert fwd.send_frames(frames) is True
        finally:
            fwd.close()
        srv = glob.import_server
        assert (srv.received, srv.import_errors) == (240 + 30 + 48 + 1, 0)
        tflusher.flush_once(glob)
        # the global's own rows (its import spans' veneur.import.*
        # samples re-enter its pipeline) are not the local's data
        rows = [m for m in gsink.get_flush(timeout=10)
                if not m.name.startswith("veneur.")]
    finally:
        glob.shutdown()
    assert_global_rows_match(rows, port_global_rows(dense))
