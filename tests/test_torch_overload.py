"""The port's default-config bounds and overload ladder against the JAX
package's, on the CPU.

* F1, the tag-length cap: a line of 40 tags of 43-44 bytes (1,789 bytes
  joined) keys the same cut tag set (987 bytes) in both packages on
  every rung (per-line, ``process_batch``, an ingest lane, SSF), and
  each cut counts one ``oversized_tags``;
* F2, the series cap: with a small ``max_series`` both packages emit the
  same rows on every rung, the ``veneur.overload.overflow`` row tagged
  ``group:<name>`` included, with the same ``spilled`` count;
* the first-sight freeze and its ``veneur.*`` exemption, and the shed
  ladder (levels, admission priorities, lane sheds rolled into the
  controller), driven by a fake clock;
* the config keys' defaults and refusals against veneur_tpu.config.

Every comparison is exact: these paths move integers and strings.
"""

import queue
import shutil
import socket
import time

import pytest

from veneur_tpu import native as jnative
from veneur_tpu import overload as joverload
from veneur_tpu.config import Config as JConfig
from veneur_tpu.core import store as jstore
from veneur_tpu.ingest.lanes import IngestFleet as JFleet
from veneur_tpu.protocol.addr import resolve_addr as jresolve
from veneur_tpu.protocol.gen.ssf import sample_pb2 as pb
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.samplers.intermetric import HistogramAggregates as JAggs
from veneur_tpu_torch import native as tnative
from veneur_tpu_torch import overload as toverload
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.core import store as tstore
from veneur_tpu_torch.ingest import IngestFleet
from veneur_tpu_torch.protocol import ssf
from veneur_tpu_torch.protocol.addr import resolve_addr
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates
from veneur_tpu_torch.server import Server, calculate_tick_delay

AGG = ["min", "max", "count"]
TAGS40 = [f"t{i}:" + "x" * 40 for i in range(40)]
F1_LINE = b"m:1|c|#" + ",".join(TAGS40).encode()
RUNGS = ["per_line", "batch", "lanes", "ssf"]


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native library cannot be built")
    assert tnative.available() and jnative.available()


def _feed(pkg, store, rung, lines, ssf_samples=()):
    """Feed ``lines`` (DogStatsD) or ``ssf_samples`` ((name, metric,
    value, tags) tuples) to a store of package ``pkg`` through ``rung``,
    as the server's statsd path would (the per-line parse with the
    store's tag cap)."""
    if rung == "per_line":
        parse = tparser.parse_metric if pkg == "port" else \
            jparser.parse_metric
        for line in lines:
            store.process_metric(parse(
                line, max_tag_length=store.max_tag_length,
                quarantine=store.quarantine))
    elif rung == "batch":
        nat = tnative if pkg == "port" else jnative
        store.process_batch(nat.parse_lines(b"\n".join(lines)))
    elif rung == "lanes":
        if pkg == "port":
            fleet = IngestFleet(store, resolve_addr("udp://127.0.0.1:0"), 1,
                                1 << 20, 4096, chunk_records=256)
        else:
            fleet = JFleet(store, jresolve("udp://127.0.0.1:0"), 1, 1 << 20,
                           4096, chunk_records=256)
        try:
            for i in range(0, len(lines), 50):
                fleet.lanes[0]._stage_native(lines[i:i + 50])
            fleet.lanes[0]._seal()
            fleet.merge_sealed()
        finally:
            fleet.shutdown()
    else:
        for name, metric, value, tags in ssf_samples:
            if pkg == "port":
                m = tparser.parse_metric_ssf(ssf.SSFSample(
                    metric=getattr(ssf.SSFSample, metric), name=name,
                    value=value, tags=tags))
            else:
                m = jparser.parse_metric_ssf(pb.SSFSample(
                    metric=getattr(pb.SSFSample, metric), name=name,
                    value=value, tags=tags))
            store.process_metric(m)


def _rows_port(store):
    final, _ = store.flush([0.5], HistogramAggregates.from_names(AGG), 0)
    return _by_key(final.to_intermetrics())


def _rows_jax(store):
    final, _, _ = store.flush([0.5], JAggs.from_names(AGG), is_local=False,
                              now=0)
    return _by_key(final)


def _by_key(final):
    out = {}
    for m in final:
        key = (m.name, tuple(m.tags), m.type.value)
        assert key not in out, key
        out[key] = m.value
    return out


def _oversized(store):
    return store.quarantine.snapshot()["oversized_tags"]


@pytest.mark.parametrize("rung", RUNGS)
def test_f1_tag_cap_on_every_rung(gxx, rung):
    """The 40-tag line at the default cap (1024): both packages key the
    same 987-byte cut, and each line of a new series counts one
    oversized_tags (the batch and lane paths cut once a series, at its
    first intern; the per-line paths once a line)."""
    cap = Config().max_tag_length
    assert cap == 1024
    lines = [F1_LINE, F1_LINE.replace(b"m:1", b"n:2"),
             b"short:1|c|#a:b"]
    tags = {t.split(":")[0]: "x" * 40 for t in TAGS40}
    samples = [("m", "COUNTER", 1.0, tags), ("n", "COUNTER", 2.0, tags)]
    t = tstore.MetricStore(max_tag_length=cap, device="cpu")
    j = jstore.MetricStore(max_tag_length=cap)
    _feed("port", t, rung, lines, samples)
    _feed("jax", j, rung, lines, samples)
    assert t.counters.interner.joined == j.counters.interner.joined
    cut = t.counters.interner.joined[0]
    assert len(cut) == 987 and len(",".join(TAGS40)) == 1789
    assert cut == ",".join(sorted(TAGS40))[:987]
    assert _oversized(t) == _oversized(j) == 2
    assert _rows_port(t) == _rows_jax(j)


def test_f1_server_default_config(gxx):
    """A port Server on its default config cuts the F1 line as the JAX
    Server does, and counts it in ``quarantined``."""
    from veneur_tpu.server import Server as JServer

    t = Server(Config(hostname="t"), device="cpu")
    j = JServer(JConfig(hostname="t"))
    t.handle_packet(F1_LINE)
    j.handle_packet(F1_LINE)
    assert t.store.counters.interner.joined == \
        j.store.counters.interner.joined
    assert len(t.store.counters.interner.joined[0]) == 987
    assert t.quarantined == 1 == j.quarantine.total()


def _f2_traffic():
    lines, samples = [], []
    for i in range(40):
        lines.append(f"cap.c{i}:{i + 1}|c".encode())
        lines.append(f"cap.h{i % 24}:{i}|h|#k:v".encode())
        lines.append(f"cap.s{i % 30}:m{i}|s".encode())
        lines.append(f"cap.top{i % 20}:k{i % 3}|s|#veneurtopk".encode())
        samples.append((f"ssf.c{i}", "COUNTER", float(i + 1), {}))
        samples.append((f"ssf.h{i % 24}", "HISTOGRAM", float(i), {"k": "v"}))
    return lines, samples


@pytest.mark.parametrize("rung", RUNGS)
def test_f2_series_cap_on_every_rung(gxx, rung):
    """max_series 8 (7 series + the overflow row): both packages emit the
    same rows, overflow rows and all, with the same spilled counts;
    no group holds more than 8 rows."""
    lines, samples = _f2_traffic()
    t = tstore.MetricStore(max_series=8, initial_capacity=4, chunk=64,
                           device="cpu")
    j = jstore.MetricStore(max_series=8, initial_capacity=4, chunk=64)
    _feed("port", t, rung, lines, samples)
    _feed("jax", j, rung, lines, samples)
    for name in tstore.MetricStore._GEN_GROUPS:
        assert len(getattr(t, name)) <= 8
        assert getattr(t, name).spilled == getattr(j, name).spilled, name
    assert t.counters.spilled == 33
    rows = _rows_port(t)
    assert rows == _rows_jax(j)
    overflow = {k: v for k, v in rows.items()
                if k[0].startswith("veneur.overload.overflow")}
    prefix = "ssf" if rung == "ssf" else "cap"
    # the counter overflow row holds the spilled samples' sum: 8..40
    assert overflow[("veneur.overload.overflow", ("group:counters",),
                     "counter")] == sum(range(8, 41))
    # the histogram overflow row holds every sample of the series past
    # the first seven (i % 24 >= 7)
    assert rows[("veneur.overload.overflow.count", ("group:histograms",),
                 "counter")] == sum(i % 24 >= 7 for i in range(40))
    kept = [k for k in rows if k[0].startswith(f"{prefix}.c")]
    assert len(kept) == 7


def test_freeze_spills_first_sight_but_not_veneur(fake_clock):
    """Level 1 (a span channel 80% full): a known series keeps its row, a
    new one spills, a ``veneur.*`` one is exempt; the two packages
    agree row for row."""
    out = []
    for pkg in ("port", "jax"):
        if pkg == "port":
            store = tstore.MetricStore(max_series=1000, device="cpu")
            ctl = toverload.OverloadController(clock=fake_clock,
                                               recompute_interval=0.0)
            parse = tparser.parse_metric
        else:
            store = jstore.MetricStore(max_series=1000)
            ctl = joverload.OverloadController(clock=fake_clock,
                                               recompute_interval=0.0)
            parse = jparser.parse_metric
        harness = _Harness(store)
        ctl.attach(harness)
        store.set_overload(ctl)
        store.process_metric(parse(b"known:1|c"))
        for _ in range(8):
            harness.span_chan.put_nowait(object())
        fake_clock.advance(1)
        assert ctl.freeze_new_series()
        for line in (b"known:1|c", b"fresh:1|c", b"veneur.self:1|c",
                     b"fresh.h:3|h"):
            store.process_metric(parse(line))
        names = set(store.counters.interner.names)
        assert {"known", "veneur.self", "veneur.overload.overflow"} <= names
        assert "fresh" not in names
        assert (store.counters.spilled, store.histograms.spilled) == (1, 1)
        out.append(_rows_port(store) if pkg == "port" else _rows_jax(store))
    assert out[0] == out[1]


class _Harness:
    """Just enough of a server for OverloadController.attach: a bounded
    span channel, no span workers, the store's groups."""

    def __init__(self, store, cap=10):
        self.store = store
        self.span_chan = queue.Queue(cap)
        self._span_workers = []


def test_shed_ladder_with_fake_clock(fake_clock):
    """Levels follow the watermarks over channel fill and group occupancy
    (occupancy clamps at the freeze tier); spans shed before statsd, and
    every drop is counted, as in the JAX controller step for step."""
    trace = {}
    for pkg, mod, mk in (("port", toverload, lambda: tstore.MetricStore(
            max_series=10, device="cpu")),
            ("jax", joverload, lambda: jstore.MetricStore(max_series=10))):
        store = mk()
        harness = _Harness(store)
        ctl = mod.OverloadController(clock=fake_clock,
                                     recompute_interval=0.0).attach(harness)
        steps = [ctl.level()]
        parse = tparser.parse_metric if pkg == "port" else \
            jparser.parse_metric
        for i in range(10):  # a full group still only freezes
            store.process_metric(parse(b"s%d:1|c" % i))
        fake_clock.advance(1)
        steps.append(ctl.level())
        for _ in range(9):  # span channel 9/10
            harness.span_chan.put_nowait(object())
        fake_clock.advance(1)
        steps += [ctl.level(), ctl.admit_span(), ctl.admit_span(3),
                  ctl.admit_packet("ssf"), ctl.admit_packet("statsd")]
        harness.span_chan.put_nowait(object())  # 10/10 >= hard
        fake_clock.advance(1)
        steps += [ctl.level(), ctl.admit_packet("statsd"),
                  ctl.freeze_new_series()]
        while not harness.span_chan.empty():
            harness.span_chan.get_nowait()
        fake_clock.advance(1)
        steps += [ctl.level(), ctl.admit_span(), dict(ctl.shed),
                  ctl.shed_total(), ctl.level_changes]
        trace[pkg] = steps
    assert trace["port"] == trace["jax"]
    assert trace["port"] == [
        0, 1, 2, False, False, False, True, 3, False, True, 1, True,
        {"statsd": 1, "ssf": 1, "spans": 4}, 6, 4]
    with pytest.raises(ValueError):
        toverload.OverloadController(low=0.9, high=0.8)


def test_lanes_shed_at_the_socket_and_roll_up(gxx, fake_clock):
    """At LEVEL_SHED_PACKETS a lane sheds whole recv batches before
    decode (read lock-free through level_nowait); the merger's roll-up
    lands them in the controller's ``shed["statsd"]``; back at level 0
    the lane ingests again."""
    store = tstore.MetricStore(device="cpu")
    harness = _Harness(store, cap=4)
    ctl = toverload.OverloadController(clock=fake_clock,
                                       recompute_interval=0.0)
    ctl.attach(harness)
    fleet = IngestFleet(store, resolve_addr("udp://127.0.0.1:0"), 1,
                        1 << 20, 4096, chunk_records=256, overload=ctl)
    lane = fleet.lanes[0]
    try:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        port = fleet.bound[0][1]
        for _ in range(4):
            harness.span_chan.put_nowait(object())
        fake_clock.advance(1)
        assert ctl.level() == toverload.LEVEL_SHED_PACKETS
        for i in range(5):
            tx.sendto(b"shed:%d|c" % i, ("127.0.0.1", port))
        _ingest_until(lane, 5)
        assert lane.shed_packets == 5 and lane.parsed == 0
        fleet._rollup_sheds()
        assert ctl.shed["statsd"] == 5
        while not harness.span_chan.empty():
            harness.span_chan.get_nowait()
        fake_clock.advance(1)
        assert ctl.level() == toverload.LEVEL_NORMAL
        tx.sendto(b"kept:1|c", ("127.0.0.1", port))
        _ingest_until(lane, 6)
        lane._seal()
        fleet.merge_sealed()
        fleet._rollup_sheds()
        tx.close()
    finally:
        fleet.shutdown()
    assert ctl.shed["statsd"] == 5 and lane.parsed == 1
    assert [m.name for m in store.flush([], HistogramAggregates(),
                                        0)[0].to_intermetrics()] == ["kept"]


def _ingest_until(lane, packets, timeout=10.0):
    deadline = time.monotonic() + timeout
    while lane.packets < packets:
        assert time.monotonic() < deadline, "datagrams did not arrive"
        lane._ingest_once()


def test_server_sheds_spans_and_statsd(gxx):
    """A Server whose span channel is forced full reaches levels 2 and 3:
    spans (handle_ssf, handle_ssf_batch) and then Python-reader statsd
    datagrams are shed and counted in ``overload.shed``, none lost
    uncounted; the pressure falls with the channel."""
    server = Server(Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                           ingest_lanes=-1, native_ingest=False,
                           hostname="t", interval="3600s"), device="cpu")
    ctl = server.overload
    ctl._recompute_interval = 0.0
    server.start()
    # a span channel forced full: the span workers drain the real one, so
    # the pressure source is swapped for a queue nobody drains
    chan = server.span_chan = queue.Queue(10)
    try:
        for _ in range(9):
            chan.put_nowait(ssf.SSFSpan(id=0))
        assert ctl.level() == toverload.LEVEL_SHED_SPANS
        server.handle_ssf(ssf.SSFSpan(id=1))
        server.handle_ssf_batch([ssf.SSFSpan(id=2), ssf.SSFSpan(id=3)])
        assert ctl.shed["spans"] == 3 and server.spans_dropped == 0
        chan.put_nowait(ssf.SSFSpan(id=0))
        assert ctl.level() == toverload.LEVEL_SHED_PACKETS
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
            for i in range(6):
                tx.sendto(b"c:%d|c" % i, server.statsd_addrs[0])
        deadline = time.monotonic() + 10
        while ctl.shed["statsd"] < 6:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert server.store.processed == 0
        while not chan.empty():
            chan.get_nowait()
    finally:
        server.shutdown()
    assert ctl.level() == toverload.LEVEL_NORMAL
    assert ctl.shed == {"statsd": 6, "ssf": 0, "spans": 3}


def test_config_defaults_match_jax():
    """0 means the default for each key, as the JAX Config's
    apply_defaults; the other new keys take the JAX defaults."""
    t = Config(hostname="h")
    j = JConfig(hostname="h")
    j.apply_defaults()
    for key in ("max_series", "max_tag_length", "overload_low_watermark",
                "overload_high_watermark", "overload_hard_watermark",
                "store_chunk", "store_initial_capacity",
                "http_import_workers", "http_import_queue", "topk_depth",
                "topk_width", "topk_k", "synchronize_with_interval",
                "omit_empty_hostname"):
        assert getattr(t, key) == getattr(j, key), key
    assert (t.max_series, t.max_tag_length) == (1 << 20, 1024)
    assert Config(max_tag_length=0).max_tag_length == 1024
    assert Config(omit_empty_hostname=True).hostname == ""
    server = Server(Config(hostname="h", max_series=64, topk_k=8,
                           store_chunk=256, store_initial_capacity=16),
                    device="cpu")
    hh = server.store.heavy_hitters
    assert (server.store.counters.max_series, hh.k, hh.chunk,
            hh.capacity) == (64, 8, 256, 16)
    assert calculate_tick_delay(10.0, 1234.5) == pytest.approx(5.5)


@pytest.mark.parametrize("kw", [
    {"max_series": -1},
    {"max_tag_length": -5},
    {"overload_low_watermark": 0.9, "overload_high_watermark": 0.8},
    {"overload_hard_watermark": 1.5},
    {"overload_low_watermark": 0.9},
])
def test_config_refusals_match_jax(kw):
    j = JConfig(hostname="h", **kw)
    with pytest.raises(ValueError):
        j.validate()
    with pytest.raises(ValueError):
        Config(hostname="h", **kw)


def test_unknown_zero_values_are_not_off():
    """The keys are known now: ``max_tag_length: 0`` reads as the 1024
    default, never as an unported key switched off."""
    from veneur_tpu_torch.config import config_from_dict

    cfg = config_from_dict({"max_tag_length": 0, "max_series": 0,
                            "http_import_workers": 4,
                            "http_import_queue": 8})
    assert (cfg.max_tag_length, cfg.max_series) == (1024, 1 << 20)
    assert (cfg.http_import_workers, cfg.http_import_queue) == (4, 8)


def test_overflow_survives_the_flush_swap():
    """The fresh twins of a flush keep the cap and the ledger."""
    t = tstore.MetricStore(max_series=3, device="cpu")
    for gen in range(2):
        for i in range(6):
            t.process_metric(tparser.parse_metric(b"g%d.%d:1|c" % (gen, i)))
        assert len(t.counters) == 3 and t.counters.spilled == 4
        rows = _rows_port(t)
        assert rows[("veneur.overload.overflow", ("group:counters",),
                     "counter")] == 4.0
    assert t.counters._quarantine is t.quarantine
