"""The port's UDP server end to end, on the CPU.

The port ``Server`` listens on ``udp://127.0.0.1:0`` with a channel sink;
datagrams go over a real socket; one flush. The emitted rows must match
what the JAX package's MetricStore emits for the same lines, with the
bounds of tests/test_torch_store.py: counters, gauges and histogram
count/min/max exact; sum rtol 1e-6; set estimates rtol 1e-6 (one float32
ulp of the log); percentiles within 0.02 x (max - min).

Also: the configuration refuses what the slice does not implement;
events reach the event worker and service checks the status group;
unported (heavy-hitter) or malformed lines are counted, never silently
dropped.
"""

import socket
import time

import numpy as np
import pytest

from veneur_tpu.config import Config as JConfig
from veneur_tpu.core import store as jstore
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.samplers.intermetric import HistogramAggregates as JAggs
from veneur_tpu_torch.cli import server as cli
from veneur_tpu_torch.config import (Config, UnsupportedConfig,
                                     config_from_dict, read_config)
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

PCTS = [0.5, 0.99]
AGGS = ["min", "max", "count", "sum"]


def _lines(seed=5):
    rng = np.random.default_rng(seed)
    scopes = ("", "|#veneurlocalonly", "|#veneurglobalonly", "|#role:web")
    out = []
    for n in range(10):
        for i in range(40):
            scope = scopes[i % 4]
            out.append(f"svc.req.{i}:{int(rng.integers(1, 5))}|c|@0.5{scope}")
            out.append(f"svc.mem.{i}:{n * 1.5}|g{scope}")
            out.append(f"svc.lat.{i}:{rng.gamma(2.0, 8.0):.5f}|ms{scope}")
            out.append(f"svc.size.{i}:{rng.gamma(3.0, 50.0):.3f}|h{scope}")
            out.append(f"svc.users.{i}:u{int(rng.integers(0, 25))}|s{scope}")
    return [ln.encode() for ln in out]


def _send(port, lines, per_datagram=6):
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
        for i in range(0, len(lines), per_datagram):
            tx.sendto(b"\n".join(lines[i:i + per_datagram]),
                      ("127.0.0.1", port))


def _wait(cond, timeout=30.0):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, "timed out"
        time.sleep(0.02)


def _by_key(rows):
    return {(m.name, tuple(m.tags), m.type.value): m.value for m in rows}


def test_udp_server_matches_jax_store():
    sink = ChannelMetricSink()
    cfg = Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                 interval="3600s", percentiles=PCTS, aggregates=AGGS,
                 hostname="test", num_readers=2)
    server = Server(cfg, metric_sinks=[sink], device="cpu")
    lines = _lines()
    server.start()
    try:
        assert len({a[1] for a in server.statsd_addrs}) == 1
        _send(server.statsd_addrs[0][1], lines)
        _wait(lambda: server.store.processed == len(lines))
        assert server.flush() > 0
        rows = sink.get_flush(timeout=10)
    finally:
        server.shutdown()
    assert server.last_flush_ok and server.packet_errors == 0

    ref = jstore.MetricStore()
    for line in lines:
        ref.process_metric(jparser.parse_metric(line))
    want, _, _ = ref.flush(PCTS, JAggs.from_names(AGGS), is_local=False,
                           now=0, forward=False)
    got, exp = _by_key(rows), _by_key(want)
    assert set(got) == set(exp)
    for key, value in exp.items():
        name = key[0]
        base, _, suffix = name.rpartition(".")
        if name.startswith("svc.users."):
            np.testing.assert_allclose(got[key], value, rtol=1e-6)
        elif suffix == "sum":
            np.testing.assert_allclose(got[key], value, rtol=1e-6)
        elif suffix.endswith("percentile"):
            lo = exp[(f"{base}.min", key[1], "gauge")]
            hi = exp[(f"{base}.max", key[1], "gauge")]
            assert abs(got[key] - value) <= 0.02 * (hi - lo) + 1e-6, key
        else:
            assert got[key] == value, key


def test_rejected_lines_are_counted():
    server = Server(Config(hostname="test"), device="cpu")
    server.handle_packet(b"a:1|c\n_e{1,1}:t|x\n_sc|svc|0\nbad\nn:nan|h\n"
                         b"top:a|s|#veneurtopk\n")
    # the counter, the service check and the heavy-hitter set reach the
    # store, the event the event worker
    assert server.store.processed == 3
    assert len(server.store.local_status_checks) == 1
    assert len(server.store.heavy_hitters) == 1
    assert [e.name for e in server.event_worker.flush()] == ["t"]
    assert (server.packet_errors, server.quarantined) == (1, 1)


def test_config_is_loud_about_unported_keys(tmp_path):
    # the gRPC keys are ported (the import server and the forwarder:
    # tests/test_torch_grpc.py); without grpcio each raises
    cfg = config_from_dict({"grpc_address": "127.0.0.1:0"})
    server = Server(cfg, device="cpu")
    server.start()
    try:
        assert type(server.import_server).__name__ == "ImportServer"
        assert server.import_server.port > 0
    finally:
        server.shutdown()
    assert config_from_dict({"forward_address": "x:1",
                             "forward_use_grpc": True}).forward_use_grpc
    import sys

    real = sys.modules.get("grpc")
    sys.modules["grpc"] = None
    try:
        for data in ({"grpc_address": "127.0.0.1:1"},
                     {"forward_address": "x:1", "forward_use_grpc": True}):
            with pytest.raises(UnsupportedConfig, match="grpcio"):
                config_from_dict(data)
    finally:
        if real is None:
            del sys.modules["grpc"]
        else:
            sys.modules["grpc"] = real
    # digest_storage is ported (dense, slab, tiered); another is an error
    assert config_from_dict({"digest_storage": "slab"}).digest_storage == \
        "slab"
    with pytest.raises(ValueError, match="digest_storage"):
        config_from_dict({"digest_storage": "sparse"})
    # mesh_enabled is ported with dense storage and with tiered (the
    # mesh tiered store, fleet/mesh_tiered.py)
    assert config_from_dict({"mesh_enabled": True}).mesh_enabled
    cfg = config_from_dict({"mesh_enabled": True, "mesh_hosts": 1,
                            "digest_storage": "tiered"})
    from veneur_tpu_torch.fleet.mesh_tiered import MeshTieredDigestGroup

    store = Server(cfg, device="cpu").store
    assert isinstance(store.histograms, MeshTieredDigestGroup)
    assert isinstance(store.timers, MeshTieredDigestGroup)
    # a handoff or standby key on a local raises, as the JAX package's
    # validate does
    for data in ({"handoff_enabled": True, "handoff_self": "a:1",
                  "handoff_peers": "a:1", "http_address": "127.0.0.1:0"},
                 {"standby_peers": "b:1", "http_address": "127.0.0.1:0"},
                 {"lease_path": "file:///tmp/lease"}):
        with pytest.raises(ValueError, match="GLOBAL"):
            config_from_dict(dict(data, forward_address="http://g:1"))
    with pytest.raises(UnsupportedConfig, match="ssf_listen_addresses"):
        config_from_dict({"ssf_listen_addresses": ["http://127.0.0.1:1"]})
    # these keys load to the JAX package's values; a statsd scheme
    # neither package listens on is refused
    jcfg = JConfig(debug_ingested_spans=True,
                   statsd_listen_addresses=["tcp://127.0.0.1:1"])
    jcfg.apply_defaults()
    cfg = config_from_dict({"debug_ingested_spans": True,
                            "statsd_listen_addresses": ["tcp://127.0.0.1:1"]})
    assert (cfg.debug_ingested_spans, cfg.statsd_listen_addresses) == (
        jcfg.debug_ingested_spans, jcfg.statsd_listen_addresses)
    with pytest.raises(UnsupportedConfig, match="udp"):
        config_from_dict({"statsd_listen_addresses": ["unix:///tmp/s"]})
    # switched-off keys pass
    cfg = config_from_dict({"digest_storage": "dense", "grpc_address": "",
                            "mesh_enabled": False, "interval": "250ms",
                            "percentiles": [0.5]})
    assert cfg.interval_seconds == 0.25 and cfg.aggregates == ["min", "max",
                                                               "count"]
    path = tmp_path / "c.yaml"
    path.write_text("statsd_listen_addresses: ['udp://127.0.0.1:0']\n"
                    "interval: 1s\ntdigest_compression: 50\n")
    cfg = read_config(str(path))
    assert cfg.tdigest_compression == 50 and cfg.interval_seconds == 1.0
    path.write_text("datadog_span_buffer_size: 16\n")
    assert read_config(str(path)).datadog_span_buffer_size == 16
    path.write_text("datadog_span_buffer_sizes: 16\n")
    with pytest.raises(UnsupportedConfig):
        read_config(str(path))
    assert cli.main(["-f", str(path)]) == 1
    assert cli.main(["-f", str(tmp_path / "missing.yaml")]) == 1


PARSE_CASES = [
    b"a.b:1|c", b"a.b:1.5|c|@0.5|#x:y,a:b", b"g:-3e2|g|#veneurglobalonly",
    b"h:12|h|#veneurlocalonly,env:prod", b"t:5|ms|@0.1", b"s:member|s|#k:v",
    b"h:1e39|h", b"c:nan|c", b"c:1|c|@0", b"c:1|c|@2", b"c:1|c|@x",
    b"noval", b":1|c", b"x:1", b"x:1|", b"x:1|q", b"x:abc|c",
    b"x:1|c||#a", b"x:1|c|@0.5|@0.5", b"x:1|c|#a|#b", b"x:1|c|zzz",
    "ü.name:2|h|#tag:ü".encode(), b"x:1|c|#veneurlocalonlyz,b",
]


@pytest.mark.parametrize("line", PARSE_CASES)
def test_parser_matches_jax(line):
    """Every field of a parsed line, and the class of every rejection,
    equal the JAX package's parser."""
    from veneur_tpu_torch.samplers import parser as tp

    try:
        want = jparser.parse_metric(line)
    except jparser.ParseError as e:
        with pytest.raises(tp.ParseError) as got:
            tp.parse_metric(line)
        assert type(got.value).__name__ == type(e).__name__
        assert getattr(got.value, "reason", None) == getattr(e, "reason",
                                                             None)
        return
    got = tp.parse_metric(line)
    assert (got.key.name, got.key.type, got.key.joined_tags) == \
        (want.key.name, want.key.type, want.key.joined_tags)
    assert (got.digest, got.value, got.sample_rate, got.tags, got.scope) == \
        (want.digest, want.value, want.sample_rate, want.tags, want.scope)


RUNGS = {"lanes": {}, "native": {"ingest_lanes": -1},
         "python": {"ingest_lanes": -1, "native_ingest": False}}


def _rung_run(rung, lines, extra):
    """One server on the CPU whose listener takes ``rung``: the datagrams
    over one socket, then one flush."""
    sink = ChannelMetricSink()
    cfg = Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                 interval="3600s", percentiles=PCTS, aggregates=AGGS,
                 hostname="test", **RUNGS[rung])
    server = Server(cfg, metric_sinks=[sink], device="cpu")
    server.start()
    try:
        assert [r for _, r, _ in server.listeners] == [rung]
        native = rung != "python"
        assert server.using_native is native
        assert server.using_recvmmsg is native
        _send(server.statsd_addrs[0][1], lines + extra)
        _wait(lambda: server.store.processed >= len(lines) + 6
              and server.packet_errors + server.quarantined == 4)
        server.flush()
        rows = sink.get_flush(timeout=10)
        events = sink.get_other_samples(timeout=10)
    finally:
        server.shutdown()
    return _by_key(rows), (server.packet_errors + server.quarantined,
                           sorted((e.name, e.message) for e in events))


def test_listener_rungs_flush_the_same_rows():
    """The lane fleet (the default), the C++ reader pool with
    ``ingest_lanes: -1``, and the Python readers with ``native_ingest:
    false`` too: the same datagrams flush to identical rows (the service
    checks as status rows), the same events reach flush_other_samples,
    and each rejected line is counted once; the heavy-hitter lines flush
    as one ``.topk`` row on every rung."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native rungs cannot be built")
    lines = _lines(seed=11)
    extra = [b"_e{5,4}:title|text", b"_sc|svc.check|0",
             b"top:a|s|#veneurtopk"] * 3 + [
        b"bad.c:nan|c", b"bad.h:1e308|h", b"bad.r:1|c|@0", b"no_type:1"]
    out = {rung: _rung_run(rung, lines, extra) for rung in RUNGS}
    rows, counts = out["python"]
    assert len(rows) > 500
    assert counts == (4, [("title", "text")] * 3)
    assert rows[("svc.check", (), "status")] == 0.0
    assert rows[("top.topk", ("veneurtopk", "key:a"), "counter")] == 3.0
    assert out["lanes"] == (rows, counts)
    # process_batch interns a series before scrubbing its value, as the
    # JAX package's does: the rejected 1e308 histogram leaves an empty
    # row, which emits its percentiles (ROADMAP section 3)
    native_rows, native_counts = out["native"]
    empty = {k: v for k, v in native_rows.items()
             if k[0].startswith("bad.h.")}
    assert sorted(k[0] for k in empty) == sorted(
        f"bad.h.{int(p * 100)}percentile" for p in PCTS)
    assert {k: v for k, v in native_rows.items() if k not in empty} == rows
    assert native_counts == counts


def test_ingest_lanes_validation():
    assert Config(ingest_lanes=4).ingest_lanes == 4
    with pytest.raises(ValueError, match="ingest_lanes"):
        Config(ingest_lanes=-2)
    cfg = config_from_dict({"ingest_lanes": -1, "native_ingest": False})
    assert (cfg.ingest_lanes, cfg.native_ingest) == (-1, False)


def test_shutdown_flushes_lane_residue():
    """A record a lane has received but not yet merged at shutdown rides
    the final flush: the fleet stops and merges before the store's last
    drain."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native rungs cannot be built")
    sink = ChannelMetricSink()
    server = Server(Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                           interval="3600s", hostname="test"),
                    metric_sinks=[sink], device="cpu")
    server.start()
    try:
        fleet = server.ingest_fleets[0]
        _send(server.statsd_addrs[0][1], [b"residue:3|c"])
        _wait(lambda: fleet.totals()["packets"] == 1)
    finally:
        server.shutdown()
    rows = sink.get_flush(timeout=10)
    assert [(m.name, m.value) for m in rows] == [("residue", 3.0)]
    assert fleet.balance()["ok"]
