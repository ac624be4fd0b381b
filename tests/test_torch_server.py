"""The port's UDP server end to end, on the CPU.

The port ``Server`` listens on ``udp://127.0.0.1:0`` with a channel sink;
datagrams go over a real socket; one flush. The emitted rows must match
what the JAX package's MetricStore emits for the same lines, with the
bounds of tests/test_torch_store.py: counters, gauges and histogram
count/min/max exact; sum rtol 1e-6; set estimates rtol 1e-6 (one float32
ulp of the log); percentiles within 0.02 x (max - min).

Also: the configuration refuses what the slice does not implement, and
unported or malformed lines are counted, never silently dropped.
"""

import socket
import time

import numpy as np
import pytest

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
    assert server.store.processed == 1
    assert (server.not_ported, server.packet_errors,
            server.quarantined) == (3, 1, 1)


def test_config_is_loud_about_unported_keys(tmp_path):
    with pytest.raises(UnsupportedConfig, match="forward_address"):
        config_from_dict({"forward_address": "http://x:1"})
    with pytest.raises(UnsupportedConfig, match="digest_storage"):
        config_from_dict({"digest_storage": "slab"})
    with pytest.raises(UnsupportedConfig, match="mesh_enabled"):
        config_from_dict({"mesh_enabled": True})
    with pytest.raises(UnsupportedConfig, match="ssf_listen_addresses"):
        config_from_dict({"ssf_listen_addresses": ["udp://127.0.0.1:1"]})
    with pytest.raises(UnsupportedConfig, match="udp"):
        config_from_dict({"statsd_listen_addresses": ["tcp://127.0.0.1:1"]})
    # switched-off keys pass
    cfg = config_from_dict({"digest_storage": "dense", "forward_address": "",
                            "mesh_enabled": False, "interval": "250ms",
                            "percentiles": [0.5]})
    assert cfg.interval_seconds == 0.25 and cfg.aggregates == ["min", "max",
                                                               "count"]
    path = tmp_path / "c.yaml"
    path.write_text("statsd_listen_addresses: ['udp://127.0.0.1:0']\n"
                    "interval: 1s\ntdigest_compression: 50\n")
    cfg = read_config(str(path))
    assert cfg.tdigest_compression == 50 and cfg.interval_seconds == 1.0
    path.write_text("sentry_dsn: https://x\n")
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
