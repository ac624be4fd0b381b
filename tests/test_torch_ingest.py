"""The port's batch ingest and ingest lanes against the JAX package's.

* ``MetricStore.process_batch``: the same seeded datagrams, parsed by each
  package's native parser, go into a port store and a JAX store (CPU;
  the JAX side's default XLA path). Their flushes match with the bounds
  of tests/test_torch_store.py: counters, gauges and histogram
  count/min/max exact; sum/avg rtol 1e-6; set estimates rtol 1e-6;
  percentiles and median within 0.02 x (max - min). HLL registers match
  bit for bit. The port's batch path and its per-line path
  (``process_metric``) give identical emissions.
* ``IngestFleet``: lanes over loopback UDP into a CPU store conserve
  every record they receive; raw lines reach the handler; heavy-hitter
  records land in the heavy-hitter group. The JAX package's intern-remap,
  backlog and shutdown cases, ported.
* The three places the paths could part: set-member hashing, counter
  truncation, and where each rejected record is counted.

The native library builds with g++ on first use; without g++ these tests
skip.
"""

import shutil
import socket
import threading
import time

import numpy as np
import pytest

from veneur_tpu import native as jnative
from veneur_tpu.core import store as jstore
from veneur_tpu.samplers.intermetric import HistogramAggregates as JAggs
from veneur_tpu_torch import native as tnative
from veneur_tpu_torch.core import store as tstore
from veneur_tpu_torch.ingest import IngestFleet
from veneur_tpu_torch.ops import tdigest as ttd
from veneur_tpu_torch.protocol.addr import resolve_addr
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates

PCTS = [0.5, 0.9, 0.99]
AGGS = ["min", "max", "count", "sum", "avg", "median"]
CHUNK = 64
SCOPES = ("", "|#veneurlocalonly", "|#veneurglobalonly", "|#env:a,zone:b")


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native library cannot be built")
    assert tnative.available() and jnative.available()


def stream(seed: int, step: bool):
    """One interval of metric lines: counters with fractional values and
    odd rates, gauges, histograms and timers with rates, sets, in every
    scope, plus events and service checks. With ``step`` the histograms
    get a burst of shifted samples that trips the shift guard."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(60):
        for _ in range(int(rng.integers(1, 6))):
            rate = ("", "|@0.5", "|@0.3", "|@0.1")[int(rng.integers(0, 4))]
            v = float(np.round(rng.uniform(-3, 9), 1))
            lines.append(f"c.{i}:{v}|c{rate}{SCOPES[i % 4]}")
    for i in range(40):
        for _ in range(3):
            lines.append(f"g.{i}:{rng.normal(0, 100):.6f}|g{SCOPES[i % 4]}")
    for kind, t in (("h", "h"), ("t", "ms")):
        for i in range(40):
            for _ in range(int(rng.integers(10, 20))):
                rate = "|@0.5" if i % 3 == 0 else ("|@0.3" if i % 5 == 0
                                                   else "")
                lines.append(f"{kind}.{i}:{rng.gamma(2.0, 10.0):.6f}|{t}"
                             f"{rate}{SCOPES[i % 4]}")
    for i in range(30):
        for _ in range(25):
            lines.append(f"s.{i}:m{int(rng.integers(0, 30 + 10 * i))}|s"
                         f"{SCOPES[i % 4]}")
    lines += ["_e{5,4}:title|text", "_sc|svc.check|0|#k:v"] * 3
    order = rng.permutation(len(lines))
    lines = [lines[j] for j in order]
    if step:
        for i in range(40):
            lines.extend(f"h.{i}:{500 + x:.6f}|h{SCOPES[i % 4]}"
                         for x in rng.gamma(2.0, 10.0, 4))
    return [ln.encode() for ln in lines]


def pack(lines, per=7):
    return [b"\n".join(lines[i:i + per]) for i in range(0, len(lines), per)]


def _flush_port(store):
    return store.flush(PCTS, HistogramAggregates.from_names(AGGS),
                       0)[0].to_intermetrics()


def _flush_jax(store):
    return store.flush(PCTS, JAggs.from_names(AGGS), is_local=False, now=0,
                       forward=False)[0]


def _by_key(metrics):
    out = {}
    for m in metrics:
        key = (m.name, tuple(m.tags), m.type.value)
        assert key not in out, key
        out[key] = m.value
    return out


def assert_flushes_match(port_rows, jax_rows):
    p, j = _by_key(port_rows), _by_key(jax_rows)
    assert set(p) == set(j)
    for key, want in j.items():
        name, tags, _ = key
        got = p[key]
        base, _, suffix = name.rpartition(".")
        if name.startswith(("c.", "g.")):
            assert got == want, key
        elif name.startswith("s."):
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=key)
        elif suffix in ("count", "min", "max"):
            assert got == want, key
        elif suffix in ("sum", "avg"):
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=key)
        else:
            assert suffix == "median" or suffix.endswith("percentile"), key
            lo = j[(f"{base}.min", tags, "gauge")]
            hi = j[(f"{base}.max", tags, "gauge")]
            assert abs(got - want) <= 0.02 * (hi - lo) + 1e-6, key


def _registers(store, group_name):
    """{(name, joined tags): registers as bytes} of one set group, its
    staging drained first."""
    group = getattr(store, group_name)
    with store._lock:
        group._drain_staging()
    regs = np.asarray(group.registers).astype(np.int8)
    return {(k.name, k.joined_tags): regs[row].tobytes()
            for k, row in group.interner.rows.items()}


def _per_line(store, lines):
    for line in lines:
        if line.startswith((b"_e{", b"_sc")):
            continue
        store.process_metric(tparser.parse_metric(line))


def test_process_batch_matches_jax_and_per_line(gxx, monkeypatch):
    drains = []
    real_drain = ttd.drain_temp

    def counting_drain(*args):
        drains.append(1)
        return real_drain(*args)

    monkeypatch.setattr(ttd, "drain_temp", counting_drain)
    # every store starts at full capacity: a group that grows drains its
    # staging first, and the batch path interns a batch's new series
    # before staging its samples, so growth would cut the per-line and
    # batch paths' drains at different samples (the same samples binned
    # in other chunks; the lane tests below grow)
    port = tstore.MetricStore(initial_capacity=64, chunk=CHUNK,
                              device="cpu")
    jax = jstore.MetricStore(initial_capacity=64, chunk=CHUNK)
    by_line = tstore.MetricStore(initial_capacity=64, chunk=CHUNK,
                                 device="cpu")
    for interval, step in ((0, False), (1, True)):
        drains.clear()
        lines = stream(200 + interval, step)
        raws, jraws = [], []
        for d in pack(lines):
            raws += port.process_batch(tnative.parse_lines(d))
            jraws += jax.process_batch(jnative.parse_lines(d))
        _per_line(by_line, lines)
        assert raws == jraws and len(raws) == 6
        n_metrics = len(lines) - 6
        assert port.processed == by_line.processed == n_metrics
        for name in ("sets", "local_sets"):
            assert _registers(port, name) == _registers(jax, name)
            assert _registers(port, name) == _registers(by_line, name)
        rows = _flush_port(port)
        if step:
            assert drains, "the distribution step did not trip the guard"
        assert_flushes_match(rows, _flush_jax(jax))
        assert _by_key(rows) == _by_key(_flush_port(by_line))
    assert port.flush_epoch == 2


def test_process_batch_heavy_hitters_match_jax(gxx):
    """Heavy-hitter records land in the heavy-hitter group, as in the JAX
    package's process_batch: both emit the same ``{name}.topk`` rows
    exactly, member names from the batch's member bytes. Events and
    service checks come back raw, and the service check then flushes as
    a status row through process_metric."""
    text = (b"top:a|s|#veneurtopk\ntop:b|s|#veneurtopk\ntop:a|s|#veneurtopk"
            b"\ns:a|s\n_e{1,1}:a|b\n_sc|chk|1")
    store = tstore.MetricStore(device="cpu")
    jax = jstore.MetricStore()
    assert store.process_batch(tnative.parse_lines(text)) == [
        b"_e{1,1}:a|b", b"_sc|chk|1"]
    jax.process_batch(jnative.parse_lines(text))
    # a record that comes back raw counts when it is re-parsed
    assert store.processed == 4 and len(store.heavy_hitters) == 1
    assert tparser.parse_event(b"_e{1,1}:a|b").name == "a"
    store.process_metric(tparser.parse_service_check(b"_sc|chk|1"))
    rows = _flush_port(store)
    assert sorted((m.name, m.type.value) for m in rows) == [
        ("chk", "status"), ("s", "gauge"), ("top.topk", "counter"),
        ("top.topk", "counter")]
    topk = _by_key(m for m in rows if m.name == "top.topk")
    assert topk == _by_key(m for m in _flush_jax(jax)
                           if m.name == "top.topk")
    assert topk == {("top.topk", ("veneurtopk", "key:a"), "counter"): 2.0,
                    ("top.topk", ("veneurtopk", "key:b"), "counter"): 1.0}


# ---------------------------------------------------------------------------
# the lane fleet
# ---------------------------------------------------------------------------


def make_store(**kw):
    kw.setdefault("initial_capacity", 32)
    kw.setdefault("chunk", 128)
    return tstore.MetricStore(device="cpu", **kw)


def make_fleet(store, lanes=1, **kw):
    kw.setdefault("chunk_records", 256)
    return IngestFleet(store, resolve_addr("udp://127.0.0.1:0"), lanes,
                       1 << 20, 4096, **kw)


def flush_map(store):
    return {m.name: m for m in store.flush([], HistogramAggregates(),
                                           0)[0].to_intermetrics()}


def _stage(lane, lines):
    if lane.using_native:
        lane._stage_native(lines)
    else:
        lane._stage_python(lines)


def _wire_lines(seed):
    """Every kind, raw lines, heavy hitters and poison, with the numpy
    reference of the counters."""
    rng = np.random.default_rng(seed)
    lines, counters = [], {}
    for i in range(300):
        v = int(rng.integers(1, 9))
        counters[f"w.c.{i % 20}"] = counters.get(f"w.c.{i % 20}", 0) + v
        lines += [f"w.c.{i % 20}:{v}|c", f"w.h.{i % 11}:{i}|h|@0.5",
                  f"w.t.{i % 7}:{i}|ms|#veneurlocalonly",
                  f"w.s.{i % 5}:m{i % 37}|s", f"w.g.{i % 3}:{i}|g"]
    lines += ["_e{5,4}:title|text", "_sc|svc.check|0"] * 10
    lines += ["top:a|s|#veneurtopk"] * 7
    lines += ["bad.c:nan|c", "bad.h:1e308|h", "no_type:1"] * 3
    order = rng.permutation(len(lines))
    return [lines[j].encode() for j in order], counters


@pytest.mark.parametrize("lanes", [1, 4])
def test_fleet_over_udp_conserves_counts(gxx, lanes):
    lines, counters = _wire_lines(lanes)
    datagrams = pack(lines, 5)
    store = make_store()
    raws = []
    fleet = make_fleet(store, lanes=lanes, drain_tick=0.005,
                       raw_handler=raws.append)
    fleet.start()
    socks = []
    try:
        assert all(lane.using_native and lane.using_recvmmsg
                   for lane in fleet.lanes)
        port = fleet.bound[0][1]
        # distinct source ports, so SO_REUSEPORT spreads across lanes
        for _ in range(16):
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.connect(("127.0.0.1", port))
            socks.append(s)
        for i, d in enumerate(datagrams):
            socks[i % 16].send(d)
            if i % 64 == 63:
                time.sleep(0.005)
        deadline = time.monotonic() + 20
        while (fleet.totals()["packets"] < len(datagrams)
               and time.monotonic() < deadline):
            time.sleep(0.02)
    finally:
        fleet.shutdown()
        for s in socks:
            s.close()
    t = fleet.totals()
    assert t["packets"] == len(datagrams)
    assert fleet.balance()["ok"], fleet.balance()
    assert t["backlog"] == 0 and t["shed_records"] == 0
    # every line is merged, handed back raw, or rejected, exactly once
    assert (t["merged"] + t["raws"] + t["parse_errors"] + t["quarantined"]
            == len(lines))
    assert (t["parse_errors"], t["quarantined"]) == (6, 3)
    assert store.quarantine.total() == 3
    assert len(raws) == t["merged_raws"] == 20
    # the heavy-hitter records merge like every other kind
    assert store.processed == t["merged"]
    # the raw lines are the events and service checks, which a Server
    # routes to its event worker and to the status group
    events = [tparser.parse_event(r) for r in raws if r.startswith(b"_e{")]
    for r in raws:
        if r.startswith(b"_sc"):
            store.process_metric(tparser.parse_service_check(r))
    assert [(e.name, e.message) for e in events] == [("title", "text")] * 10
    if lanes > 1:
        assert sum(lane.packets > 0 for lane in fleet.lanes) > 1
    fm = flush_map(store)
    for name, total in counters.items():
        assert fm[name].value == total, name
    assert "top" not in fm and "bad.c" not in fm and "bad.h" not in fm
    assert (fm["top.topk"].value, fm["top.topk"].tags) == (
        7.0, ["veneurtopk", "key:a"])
    assert (fm["svc.check"].type.value, fm["svc.check"].value) == (
        "status", 0.0)
    assert {n.split(".")[1] for n in fm if n.startswith("w.")} == {
        "c", "h", "t", "s", "g"}


def test_cross_lane_row_collisions_resolve_by_name(gxx):
    # both lanes assign rows 0/1 in OPPOSITE order for the same two
    # series: the per-lane resolvers keep them apart
    store = make_store()
    fleet = make_fleet(store, lanes=2)
    a, b = fleet.lanes
    _stage(a, [b"first:1|c", b"second:10|c"])
    _stage(b, [b"second:100|c", b"first:1000|c"])
    a._seal()
    b._seal()
    fleet.merge_sealed()
    fm = flush_map(store)
    assert fm["first"].value == 1001
    assert fm["second"].value == 110
    fleet.shutdown()


def test_gen_rollover_never_aliases_rows(gxx):
    store = make_store()
    fleet = make_fleet(store, lanes=1, intern_limit=1024)
    lane = fleet.lanes[0]
    _stage(lane, [b"old:5|c"])
    lane._seal()
    # force the bounded-memory rollover: row 0 is minted again for a
    # DIFFERENT series under a new generation
    lane._intern_total = lane._intern_limit
    _stage(lane, [b"fresh:7|c"])
    lane._seal()
    fleet.merge_sealed()
    fm = flush_map(store)
    assert fm["old"].value == 5
    assert fm["fresh"].value == 7
    assert lane.gen == 1
    fleet.shutdown()


def test_flush_epoch_bump_rebuilds_remap(gxx):
    store = make_store()
    fleet = make_fleet(store, lanes=1)
    lane = fleet.lanes[0]
    _stage(lane, [b"x:1|c"])
    lane._seal()
    fleet.merge_sealed()
    assert flush_map(store)["x"].value == 1  # the flush bumps the epoch
    # same lane rows, new store generation: the stale remap is dropped
    # and rebuilt by re-interning the registry
    _stage(lane, [b"x:2|c"])
    lane._seal()
    fleet.merge_sealed()
    assert flush_map(store)["x"].value == 2
    fleet.shutdown()


def test_idle_series_not_resurrected_after_flush(gxx):
    # the lane's lifetime registry is NOT re-interned whole into every
    # fresh generation: a series that stops arriving stops being emitted
    store = make_store()
    fleet = make_fleet(store, lanes=1)
    lane = fleet.lanes[0]
    _stage(lane, [b"once:1|c", b"steady:1|c"])
    lane._seal()
    fleet.merge_sealed()
    assert set(flush_map(store)) >= {"once", "steady"}
    _stage(lane, [b"steady:2|c"])
    lane._seal()
    fleet.merge_sealed()
    fm = flush_map(store)
    assert fm["steady"].value == 2
    assert "once" not in fm
    # ...but the row still resolves when the series comes back
    _stage(lane, [b"once:5|c"])
    lane._seal()
    fleet.merge_sealed()
    assert flush_map(store)["once"].value == 5
    fleet.shutdown()


@pytest.mark.parametrize("use_native", [None, False])
def test_all_kinds_flow_through_merge(gxx, use_native):
    store = make_store()
    fleet = make_fleet(store, lanes=1, use_native=use_native)
    lane = fleet.lanes[0]
    assert lane.using_native is (use_native is None)
    _stage(lane, [b"c:3|c", b"g:2.5|g", b"h:1.5|h", b"t:12|ms",
                  b"s:member|s|#veneurlocalonly", b"gc:4|c|#veneurglobalonly",
                  b"top:a|s|#veneurtopk", b"_sc|chk|0"])
    lane._seal()
    fleet.merge_sealed()
    flushed, fwd = store.flush([0.5], HistogramAggregates(), 0,
                               is_local=True)
    final = flushed.to_intermetrics()
    fm = {m.name: m for m in final}
    assert fm["c"].value == 3
    assert fm["g"].value == 2.5
    assert fm["s"].value == pytest.approx(1, rel=0.01)
    assert any(m.name.startswith("h.") for m in final)
    assert any(m.name.startswith("t.") for m in final)
    assert fwd.counters == [("gc", [], 4)]
    # the heavy-hitter record reaches its group with its member name,
    # forwarded by this local as the sketch
    assert [(s[0], s[1], s[3]) for s in fwd.topk[1]] == [
        ("top", ["veneurtopk"], ["a"])]
    # the service check is handed back raw (no raw_handler here)
    assert fleet.unrouted_raws == [b"_sc|chk|0"]
    fleet.shutdown()


def test_backlog_cap_sheds_payload_not_interns(gxx):
    store = make_store()
    fleet = make_fleet(store, lanes=1, max_backlog=2)
    lane = fleet.lanes[0]
    for i in range(5):
        _stage(lane, [b"series.%d:1|c" % i])
        lane._seal()
    # chunks 3..5 exceeded the backlog: payload shed, entries shipped
    assert lane.shed_chunks == 3 and lane.shed_records == 3
    fleet.merge_sealed()
    bal = fleet.balance()
    assert bal["ok"], bal
    assert bal["lanes"][0]["merged"] == 2
    assert bal["lanes"][0]["shed"] == 3
    # shed chunks still taught the resolver their intern entries, so a
    # LATER chunk referencing an earlier-minted row merges right
    _stage(lane, [b"series.4:7|c"])
    lane._seal()
    fleet.merge_sealed()
    assert flush_map(store)["series.4"].value == 7
    fleet.shutdown()


def test_full_backlog_sheds_packets_before_decode(gxx):
    store = make_store()
    fleet = make_fleet(store, lanes=1, max_backlog=1)
    lane = fleet.lanes[0]
    _stage(lane, [b"a:1|c"])
    lane._seal()
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
        tx.sendto(b"b:1|c\nc:1|c", fleet.bound[0])
        deadline = time.monotonic() + 10
        while lane._ingest_once() == 0:
            assert time.monotonic() < deadline
    assert lane.shed_packets == 1 and lane.parsed == 1
    fleet.merge_sealed()
    assert fleet.balance()["ok"]
    assert set(flush_map(store)) == {"a"}
    fleet.shutdown()


def test_shutdown_flushes_staged_residue(gxx):
    store = make_store()
    fleet = make_fleet(store, lanes=1, drain_tick=0.005)
    fleet.start()
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.connect(fleet.bound[0])
        s.send(b"residue:3|c")
        deadline = time.monotonic() + 10
        while (fleet.totals()["packets"] < 1
               and time.monotonic() < deadline):
            time.sleep(0.02)
    fleet.shutdown()  # the lane seals its residue; the final merge takes it
    assert flush_map(store)["residue"].value == 3
    assert fleet.balance()["ok"]


def test_concurrent_merges_never_double_count(gxx):
    """Drainers racing the lane over many sealed chunks: every staged
    record is merged exactly once (the JAX package's exactly-once
    case, with a shortened switch interval)."""
    import sys

    store = make_store()
    fleet = make_fleet(store, lanes=1)
    lane = fleet.lanes[0]
    stop = threading.Event()
    errors = []

    def drain():
        while not stop.is_set():
            try:
                fleet.merge_sealed()
            except Exception as e:  # pragma: no cover - reported below
                errors.append(e)
                return

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    drainers = [threading.Thread(target=drain) for _ in range(4)]
    try:
        for t in drainers:
            t.start()
        for i in range(2000):
            _stage(lane, [b"x:1|c", b"lat.%d:%d|ms" % (i % 7, i)])
        lane._seal()
    finally:
        stop.set()
        for t in drainers:
            t.join(timeout=30)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in drainers) and not errors
    fleet.merge_sealed()
    bal = fleet.balance()
    assert bal["ok"] and bal["lanes"][0]["merged"] == 4000, bal
    assert flush_map(store)["x"].value == 2000
    fleet.shutdown()


# ---------------------------------------------------------------------------
# where the paths could part
# ---------------------------------------------------------------------------


def _paths(lines):
    """The same lines through the per-line path, process_batch and one
    lane, each into its own CPU store. Returns {path: (store, rejected)},
    ``rejected`` summing every counter a rejected record can land in on
    that path."""
    out = {}
    store = make_store()
    rejected = 0
    for line in lines:
        try:
            store.process_metric(tparser.parse_metric(line))
        except tparser.ParseError:
            rejected += 1
    out["per_line"] = (store, rejected + store.quarantine.total())
    store = make_store()
    pb = tnative.parse_lines(b"\n".join(lines))
    assert store.process_batch(pb) == []
    out["batch"] = (store, pb.parse_errors + store.quarantine.total())
    store = make_store()
    fleet = make_fleet(store, lanes=1)
    _stage(fleet.lanes[0], pack(lines, 3))
    fleet.lanes[0]._seal()
    fleet.merge_sealed()
    t = fleet.totals()
    assert fleet.balance()["ok"]
    assert store.quarantine.total() == t["quarantined"]
    out["lane"] = (store, t["parse_errors"] + t["quarantined"])
    fleet.shutdown()
    return out


@pytest.mark.parametrize("members", [
    ["alice", "bob", "m42"], ["ü", "naïve", "日本語"], [""],
    ["x" * 65, "é" * 40]], ids=["ascii", "utf8", "empty", "long"])
def test_set_members_same_registers_on_every_path(gxx, members):
    lines = [f"s.{i % 2}:{m}|s".encode() for i, m in enumerate(members * 3)]
    regs = {path: _registers(store, "sets")
            for path, (store, _) in _paths(lines).items()}
    jax = jstore.MetricStore(initial_capacity=32, chunk=128)
    jax.process_batch(jnative.parse_lines(b"\n".join(lines)))
    assert regs["per_line"] == regs["batch"] == regs["lane"] \
        == _registers(jax, "sets")


def _go_contrib(line: bytes) -> int:
    """int64(value) * int64(float32(1)/float32(rate)) of a counter line."""
    text, _, rest = line.decode().partition("|c")
    rate = float(rest[2:]) if rest else 1.0
    return int(float(text[2:])) * int(np.float32(1) / np.float32(rate))


# A rejected counter: the per-line and lane paths reject it before its
# series is interned, the batch path after (its series emits 0), as the
# JAX package's paths do (ROADMAP section 3). Within 4096 of 2^63 the
# per-line path admits a sample the batch bound (backed off by f64's
# spacing there) rejects.
ACCEPTED = {"per_line": "ok", "batch": "ok", "lane": "ok"}
REJECTED = {"per_line": None, "batch": 0.0, "lane": None}
COUNTER_CASES = [
    (b"c:1.7|c", ACCEPTED), (b"c:-1.7|c", ACCEPTED),
    (b"c:3|c|@0.3", ACCEPTED), (b"c:7.9|c|@0.3", ACCEPTED),
    (b"c:5|c|@0.1", ACCEPTED), (b"c:-2.5|c|@0.7", ACCEPTED),
    (b"c:9223372036854771712|c", dict(REJECTED, per_line="ok")),
    (b"c:4611686018427387904|c|@0.5", REJECTED),
    (b"c:9223372036854775807|c", REJECTED),
]


def _jax_counter(line: bytes, per_line: bool):
    from veneur_tpu.samplers import parser as jparser

    store = jstore.MetricStore(initial_capacity=32, chunk=128)
    if per_line:
        try:
            store.process_metric(jparser.parse_metric(line))
        except jparser.ParseError:
            pass
    else:
        store.process_batch(jnative.parse_lines(line))
    fm = {m.name: m.value for m in store.flush(
        [], JAggs(), is_local=False, now=0, forward=False)[0]}
    return fm.get("c")


@pytest.mark.parametrize("line,expect", COUNTER_CASES,
                         ids=[c[0].decode() for c in COUNTER_CASES])
def test_counter_truncation_on_every_path(gxx, line, expect):
    """int64(value) * int64(float32(1)/float32(rate)) on every path, and
    every path equals its JAX counterpart (the lane's is the batch
    path's staging with the per-line path's interning)."""
    for path, (store, rejected) in _paths([line]).items():
        fm = flush_map(store)
        got = fm["c"].value if "c" in fm else None
        want = _go_contrib(line) if expect[path] == "ok" else expect[path]
        assert (got, rejected) == (want, int(expect[path] != "ok")), path
    assert _jax_counter(line, per_line=True) == (
        _go_contrib(line) if expect["per_line"] == "ok" else None)
    assert _jax_counter(line, per_line=False) == (
        _go_contrib(line) if expect["batch"] == "ok" else 0.0)


# (line, True where the batch path interns the series before rejecting
# the value: the C++ parser rejects non-finite values and bad rates
# itself, the batch scrub rejects what parses but does not fit)
POISON = [(b"p:nan|c", False), (b"p:inf|g", False), (b"p:-inf|h", False),
          (b"p:NaN|ms", False), (b"p:1|c|@0", False), (b"p:1|h|@-1", False),
          (b"p:1e308|h", True), (b"p:1e308|ms|@0.5", True),
          (b"p:1e19|c", True)]


@pytest.mark.parametrize("line,batch_interns", POISON,
                         ids=[x[0].decode() for x in POISON])
def test_poison_lands_in_exactly_one_counter(gxx, line, batch_interns):
    """Each poisoned record is counted once on every path (a parse error
    or a quarantine reason) and never reaches state; a series the batch
    path interned emits only what an empty series does (a counter's 0,
    no digest row)."""
    for path, (store, rejected) in _paths([line]).items():
        assert rejected == 1, path
        interned = sum(len(getattr(store, g)) for g in store._GEN_GROUPS)
        assert interned == (path == "batch" and batch_interns), path
        values = [m.value for m in flush_map(store).values()]
        zero = interned and line.endswith(b"|c")
        assert values == ([0.0] if zero else []), path


def test_lane_fallback_is_visible(gxx, caplog, monkeypatch):
    """Without the native library a lane decodes in Python, says so in
    the log, and reports it on ``using_native``."""
    from veneur_tpu_torch.ingest import lanes as lanes_mod

    monkeypatch.setattr(lanes_mod.native, "available", lambda: False)
    store = make_store()
    with caplog.at_level("WARNING", logger="veneur.ingest"):
        fleet = make_fleet(store, lanes=2)
    assert not any(lane.using_native for lane in fleet.lanes)
    assert "Python parser" in caplog.text
    _stage(fleet.lanes[0], [b"a:2|c|@0.5", b"h:1|h"])
    fleet.lanes[0]._seal()
    fleet.merge_sealed()
    assert flush_map(store)["a"].value == 4
    fleet.shutdown()
