"""The port's elastic resharding (``veneur_tpu_torch/fleet/handoff.py``,
``MetricStore.handoff_extract``) against the JAX package's, on the CPU.

* Wire parity, exact: ``encode_handoff`` of the same snapshot dict gives
  the JAX package's bytes, and ``pack_digest_snapshot`` its arrays; each
  package decodes the other's blob; ``RingTransition`` names the JAX
  package's owner key for key.
* Interop both ways over HTTP: a JAX ``HandoffManager`` hands moved
  ranges to a port global's ``POST /handoff``, and a port one to a JAX
  global's. Counters exact, digest mass within rtol 1e-6 (the wire's
  bfloat16 weights are exact on these unit weights), set registers
  exact, and every series on exactly one side.
* The extraction equals the JAX package's on the same seeded input: the
  same moved names per destination and group, scalars and set registers
  exact, per-row digest mass within rtol 1e-6.
* The JAX package's ``tests/test_handoff.py`` run on the port: the
  split and the pack, extraction and conservation under concurrent
  ingest, the HTTP stream's id and epoch guards, the failure ladder
  (requeue, spool, ENOSPC, partition, the retry on the refresh cadence),
  config skew, the hybrid epoch, the kept re-merge that prefers a live
  gauge, and grow 2 -> 3 then shrink 3 -> 2 under ingest with exact
  conservation.
* Both SIGKILL cases of ``tests/test_handoff_e2e.py``: a port Server
  subprocess (``device="cpu"``) killed mid-handoff on the sending and on
  the receiving end; every counter and timer sample emitted once.
"""

import json
import os
import select
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from veneur_tpu.config import Config as JConfig
from veneur_tpu.core.store import MetricStore as JStore
from veneur_tpu.discovery import RingWatcher as JRingWatcher
from veneur_tpu.fleet import RingTransition as JRingTransition
from veneur_tpu.fleet import handoff as jho
from veneur_tpu.samplers.intermetric import HistogramAggregates as JAggs
from veneur_tpu.samplers.parser import MetricKey as JKey
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.core.store import MetricStore
from veneur_tpu_torch.discovery import RingWatcher
from veneur_tpu_torch.fleet import RingTransition, ring_key
from veneur_tpu_torch.fleet.handoff import (HandoffManager, HybridEpoch,
                                            decode_handoff, encode_handoff,
                                            pack_digest_snapshot,
                                            split_group_snapshot,
                                            unpack_digest_snapshot)
from veneur_tpu_torch.persist import CheckpointInvalid, write_atomic
from veneur_tpu_torch.proxy.consistent import ConsistentRing
from veneur_tpu_torch.resilience import RetryPolicy
from veneur_tpu_torch.resilience import faults as rfaults
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates
from veneur_tpu_torch.samplers.parser import MetricKey, parse_metric
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

AGG = HistogramAggregates.from_names(["min", "max", "count"])
JAGG = JAggs.from_names(["min", "max", "count"])


def make_store(**kw):
    kw.setdefault("initial_capacity", 32)
    kw.setdefault("chunk", 128)
    return MetricStore(device="cpu", **kw)


def jax_store(**kw):
    kw.setdefault("initial_capacity", 32)
    kw.setdefault("chunk", 128)
    return JStore(**kw)


def fill_store(store, n=30, seed=0, key=MetricKey):
    """Ring-routable state in either package's store: imported global
    counters, timer digests (mass = centroid weight) and HLL sets.
    Returns (counter total, digest weight total)."""
    rng = np.random.default_rng(seed)
    ctotal, wtotal = 0, 0.0
    for i in range(n):
        store.import_counter(key(name=f"m{i}", type="counter",
                                 joined_tags=""), [], 10 + i)
        ctotal += 10 + i
        vals = np.sort(rng.normal(100.0, 10.0, 20))
        store.import_digest(key(name=f"t{i}", type="timer", joined_tags=""),
                            [], vals, np.ones(20), float(vals[0]),
                            float(vals[-1]))
        wtotal += 20.0
        regs = np.zeros(1 << store.sets.precision, np.uint8)
        regs[i % 100] = 3
        store.import_set(key(name=f"s{i}", type="set", joined_tags=""),
                         [], regs)
    return ctotal, wtotal


def flush_totals(store):
    """A forwarding flush of a port store: (counter total of m*, digest
    weight total, {set name: registers})."""
    _, fwd = store.flush([0.5], AGG, 0, is_local=True, forward=True)
    fwd.materialize_digests()
    ctotal = sum(v for name, _, v in fwd.counters if name.startswith("m"))
    wtotal = sum(float(np.sum(w)) for _, _, _, w, _, _ in
                 fwd.histograms + fwd.timers)
    return ctotal, wtotal, {name: regs for name, _, regs, _ in fwd.sets}


def jax_flush_totals(store):
    _, fwd, _ = store.flush([0.5], JAGG, is_local=True, now=0, forward=True,
                            columnar=False)
    ctotal = sum(v for name, _, v in fwd.counters if name.startswith("m"))
    wtotal = sum(float(np.sum(w)) for _, _, _, w, _, _ in
                 fwd.histograms + fwd.timers)
    return ctotal, wtotal, {name: np.asarray(regs)
                            for name, _, regs, _ in fwd.sets}


def snapshot_dict(seed=3, n=12):
    """A seeded handoff group dict of plain numpy arrays (the shapes a
    store snapshot has): digests with float64 runs, scalars, sets."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int32), 5)
    means = np.concatenate([np.sort(rng.gamma(2.0, 10.0, 5))
                            for _ in range(n)])
    return {
        "timers": {"kind": "digest", "names": [f"t{i}" for i in range(n)],
                   "joined": ["a:b"] * n, "rows": rows,
                   "means": means.astype(np.float64),
                   "weights": rng.integers(1, 9, len(rows)).astype(
                       np.float64),
                   **{k: rng.random(n).astype(np.float32) for k in (
                       "mins", "maxs", "count", "vsum", "vmin", "vmax",
                       "recip")}},
        "global_counters": {"kind": "scalar",
                            "names": [f"m{i}" for i in range(n)],
                            "joined": [""] * n,
                            "values": np.arange(n, dtype=np.int64)},
        "sets": {"kind": "set", "names": ["s0"], "joined": [""],
                 "precision": 14,
                 "registers": rng.integers(0, 9, (1, 1 << 14)).astype(
                     np.uint8)}}


# -- wire parity ----------------------------------------------------------------


class TestWireParity:
    def test_encode_bytes_equal_jax(self):
        meta = {"id": "h1", "sender": "a", "epoch": 3, "epoch_ctr": 1,
                "incarnation": "x", "dest": "b", "series": 25}
        got = encode_handoff(snapshot_dict(), meta, 123.0)
        want = jho.encode_handoff(snapshot_dict(), meta, 123.0)
        assert got == want

    def test_pack_arrays_equal_jax(self):
        got = pack_digest_snapshot(dict(snapshot_dict()["timers"]))
        want = jho.pack_digest_snapshot(dict(snapshot_dict()["timers"]))
        for k in ("means_q", "weights_bf", "pmin", "pspan", "rows"):
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k
        back = unpack_digest_snapshot(got)
        jback = jho.unpack_digest_snapshot(want)
        assert np.array_equal(back["means"], jback["means"])
        assert np.array_equal(back["weights"], jback["weights"])

    @pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
    def test_each_decodes_the_others_blob(self, direction):
        meta = {"id": "x1", "sender": "s", "epoch": 9}
        enc, dec = ((jho.encode_handoff, decode_handoff)
                    if direction == "jax->port"
                    else (encode_handoff, jho.decode_handoff))
        groups, got_meta = dec(enc(snapshot_dict(), meta, 5.0))
        assert got_meta == meta
        want = snapshot_dict()
        assert sorted(groups) == sorted(want)
        assert np.array_equal(groups["global_counters"]["values"],
                              want["global_counters"]["values"])
        assert np.array_equal(groups["sets"]["registers"],
                              want["sets"]["registers"])
        t = groups["timers"]
        assert np.array_equal(t["weights"], want["timers"]["weights"])
        span = want["timers"]["means"].max() - want["timers"]["means"].min()
        assert np.max(np.abs(t["means"] - want["timers"]["means"])) \
            <= span / 65535

    def test_ring_transition_equals_jax(self):
        old, new = ["g1:1", "g2:1"], ["g1:1", "g2:1", "g3:1"]
        tr, jtr = RingTransition(old, new), JRingTransition(old, new)
        names = [f"api.{i}" for i in range(500)]
        joined = ["env:a" if i % 2 else "" for i in range(500)]
        assert tr.new_owners(names, "timer", joined) == \
            jtr.new_owners(names, "timer", joined)
        for n, j in zip(names[:100], joined[:100]):
            assert tr.new_owner(n, "timer", j) == jtr.new_owner(n, "timer", j)
            assert tr.old_owner(n, "timer", j) == jtr.old_owner(n, "timer", j)
            assert tr.moved(n, "timer", j) == jtr.moved(n, "timer", j)
        for m in old + new + ["g9:1"]:
            assert tr.loses_ranges(m) == jtr.loses_ranges(m)

    def test_config_keys_parse_as_jax(self):
        kw = dict(http_address="127.0.0.1:0", handoff_enabled=True,
                  handoff_self="a:1", handoff_peers="a:1,b:1",
                  standby_peers="b:1", lease_path="file:///tmp/l",
                  lease_ttl="6s", handoff_timeout="3s")
        cfg, jcfg = Config(**kw), JConfig(**kw)
        jcfg.apply_defaults()
        for attr in ("handoff_refresh_interval_seconds",
                     "handoff_timeout_seconds", "lease_ttl_seconds",
                     "lease_renew_interval_seconds"):
            assert getattr(cfg, attr) == getattr(jcfg, attr), attr
        assert cfg.standby_shadow_epochs == jcfg.standby_shadow_epochs == 2
        bare, jbare = Config(), JConfig()
        jbare.apply_defaults()
        assert bare.handoff_timeout_seconds == jbare.handoff_timeout_seconds
        assert bare.lease_renew_interval_seconds == \
            jbare.lease_renew_interval_seconds
        for bad, match in ((dict(handoff_enabled=True), "handoff_self"),
                           (dict(handoff_enabled=True, handoff_self="a"),
                            "membership"),
                           (dict(handoff_enabled=True, handoff_self="a",
                                 handoff_peers="a"), "http_address"),
                           (dict(standby_peers="b"), "http_address"),
                           (dict(lease_path="zk://x"), "lease_path"),
                           (dict(standby_shadow_epochs=-1), "shadow")):
            with pytest.raises(ValueError, match=match):
                Config(**bad)


# -- the split, the pack and the extraction ------------------------------------


class TestSplitAndPack:
    def test_split_partitions_every_row_exactly_once(self):
        store = make_store()
        fill_store(store, n=40)
        snap = store.timers.snapshot_state()
        parts = split_group_snapshot(
            snap, "timer",
            lambda name, t, j: None if int(name[1:]) % 3 == 0
            else f"dest{int(name[1:]) % 3}")
        names = [n for p in parts.values() for n in p["names"]]
        assert sorted(names) == sorted(snap["names"])
        total_w = sum(float(np.sum(p.get("weights", ())))
                      for p in parts.values())
        assert total_w == pytest.approx(float(np.sum(snap["weights"])),
                                        rel=1e-12)
        for p in parts.values():
            assert len(p["count"]) == len(p["names"])

    def test_veneur_series_always_kept(self):
        store = make_store()
        store.import_counter(MetricKey(name="veneur.something",
                                       type="counter", joined_tags=""),
                             [], 5)
        parts = split_group_snapshot(store.global_counters.snapshot_state(),
                                     "counter", lambda *a: "elsewhere")
        assert list(parts) == [None]

    def test_pack_unpack_round_trip(self):
        store = make_store()
        fill_store(store, n=10)
        snap = store.timers.snapshot_state()
        orig_means = np.asarray(snap["means"], np.float64).copy()
        orig_weights = np.asarray(snap["weights"], np.float64).copy()
        packed = pack_digest_snapshot(dict(snap))
        assert packed["packed"] and "means" not in packed
        assert packed["means_q"].dtype == np.uint16
        assert packed["weights_bf"].dtype == np.uint16
        out = unpack_digest_snapshot(packed)
        assert np.all(np.abs(out["means"] - orig_means)
                      <= (orig_means.max() - orig_means.min()) / 65000
                      + 1e-9)
        assert np.array_equal(out["weights"], orig_weights)
        rows = np.asarray(out["rows"], np.int64)
        for r in np.unique(rows):
            assert np.all(np.diff(out["means"][rows == r]) >= 0)

    def test_wire_round_trip_and_corruption(self):
        store = make_store()
        fill_store(store, n=8)
        groups = {"timers": store.timers.snapshot_state(),
                  "global_counters": store.global_counters.snapshot_state()}
        blob = encode_handoff(groups, {"id": "h1", "sender": "a",
                                       "epoch": 3}, created_at=123.0)
        out_groups, out_meta = decode_handoff(blob)
        assert out_meta["id"] == "h1" and out_meta["epoch"] == 3
        assert sorted(out_groups) == ["global_counters", "timers"]
        assert "means" in out_groups["timers"]
        with pytest.raises(CheckpointInvalid):
            decode_handoff(blob[:-7])
        with pytest.raises(CheckpointInvalid):
            decode_handoff(b"garbage" + blob[7:])


class TestStoreExtract:
    def test_extract_everything_then_restore_conserves(self):
        store = make_store()
        ctotal, wtotal = fill_store(store)
        moved, n = store.handoff_extract(lambda *a: "dest")
        assert n > 0 and list(moved) == ["dest"]
        c0, w0, _ = flush_totals(store)
        assert c0 == 0 and w0 == 0.0
        store.restore_state(moved["dest"])
        c1, w1, _ = flush_totals(store)
        assert c1 == ctotal
        assert w1 == pytest.approx(wtotal, rel=1e-6)

    def test_kept_rows_survive_in_place(self):
        store = make_store()
        ctotal, wtotal = fill_store(store)
        moved, _ = store.handoff_extract(
            lambda name, t, j: None if int(name[1:]) % 2 == 0 else "dest")
        c_live, w_live, _ = flush_totals(store)
        recv = make_store()
        recv.restore_state(moved["dest"])
        c_moved, w_moved, _ = flush_totals(recv)
        assert c_live + c_moved == ctotal
        assert w_live + w_moved == pytest.approx(wtotal, rel=1e-6)
        assert c_live > 0 and c_moved > 0

    def test_epoch_bumps_and_tallies_recredit(self):
        store = make_store()
        fill_store(store, n=5)
        processed0, imported0 = store.processed, store.imported
        epoch0 = store.flush_epoch
        store.handoff_extract(lambda *a: None)
        assert store.flush_epoch == epoch0 + 1
        assert (store.imported, store.processed) == (imported0, processed0)

    def test_concurrent_ingest_conserved(self):
        """Samples racing the extraction land in the retired generation
        (and move or stay with it) or in the fresh live one: never both,
        never neither."""
        store = make_store()
        stop = threading.Event()
        sent = [0]

        def ingest():
            i = 0
            while not stop.is_set():
                store.import_counter(MetricKey(name=f"m{i % 50}",
                                               type="counter",
                                               joined_tags=""), [], 1)
                sent[0] += 1
                i += 1

        t = threading.Thread(target=ingest, daemon=True)
        t.start()
        time.sleep(0.05)
        moved_all = []
        for _ in range(4):
            moved, _ = store.handoff_extract(
                lambda name, ty, j: "dest" if int(name[1:]) % 2 else None)
            moved_all.append(moved)
            time.sleep(0.02)
        stop.set()
        t.join(timeout=5)
        recv = make_store()
        for moved in moved_all:
            if "dest" in moved:
                recv.restore_state(moved["dest"])
        c_live, _, _ = flush_totals(store)
        c_recv, _, _ = flush_totals(recv)
        assert c_live + c_recv == sent[0]

    def test_extract_equals_jax(self):
        """The same seeded stores extract the same moved ranges: names
        per destination and group equal, scalars and registers exact,
        per-row digest mass within rtol 1e-6."""
        store, jstore = make_store(), jax_store()
        fill_store(store, n=40, seed=5)
        fill_store(jstore, n=40, seed=5, key=JKey)
        tr = RingTransition(["a"], ["a", "b", "c"])

        def route(name, t, j):
            owner = tr.new_owner(name, t, j)
            return None if owner == "a" else owner

        moved, n = store.handoff_extract(route)
        jmoved, jn = jstore.handoff_extract(route)
        assert n == jn > 0 and sorted(moved) == sorted(jmoved)
        for dest in moved:
            assert sorted(moved[dest]) == sorted(jmoved[dest])
            for g, snap in moved[dest].items():
                jsnap = jmoved[dest][g]
                assert snap["names"] == jsnap["names"], g
                if snap["kind"] == "scalar":
                    assert np.array_equal(snap["values"], jsnap["values"])
                elif snap["kind"] == "set":
                    assert np.array_equal(snap["registers"],
                                          jsnap["registers"])
                elif snap["kind"] == "digest":
                    k = len(snap["names"])
                    w = np.bincount(snap["rows"], snap["weights"], k)
                    jw = np.bincount(jsnap["rows"], jsnap["weights"], k)
                    np.testing.assert_allclose(w, jw, rtol=1e-6)


# -- the manager over HTTP -----------------------------------------------------


def _wait(predicate, timeout=20.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


class MutableDiscoverer:
    def __init__(self, members):
        self.members = list(members)

    def get_destinations_for_service(self, service_name):
        return list(self.members)


HANDOFF_KW = dict(statsd_listen_addresses=[], interval="86400s",
                  http_address="127.0.0.1:0", percentiles=[0.5],
                  aggregates=["count"], store_initial_capacity=32,
                  store_chunk=128, flush_columnar=False,
                  handoff_enabled=True, handoff_refresh_interval="86400s",
                  handoff_timeout="5s", retry_max=1,
                  retry_base_interval="10ms")


def make_handoff_global(tag, **kw):
    cfg = Config(handoff_self=f"pending-{tag}",
                 handoff_peers=f"pending-{tag}", **HANDOFF_KW, **kw)
    sink = ChannelMetricSink()
    server = Server(cfg, metric_sinks=[sink], device="cpu")
    server.start()
    addr = f"127.0.0.1:{server.ops_server.port}"
    server.handoff_manager.self_addr = addr
    return server, sink, addr


def make_jax_handoff_global(tag):
    from veneur_tpu.server import Server as JServer
    from veneur_tpu.sinks import ChannelMetricSink as JSink

    cfg = JConfig(handoff_self=f"pending-{tag}",
                  handoff_peers=f"pending-{tag}", **HANDOFF_KW)
    server = JServer(cfg, metric_sinks=[JSink()])
    server.start()
    addr = f"127.0.0.1:{server.ops_server.port}"
    server.handoff_manager.self_addr = addr
    return server, addr


def drain_flush_totals(server, sink):
    if not server.flush():  # an empty flush reaches no sink
        return 0, 0
    metrics = sink.get_flush()
    ctotal = sum(m.value for m in metrics
                 if m.type.name == "COUNTER" and m.name.startswith("gc"))
    tcount = sum(m.value for m in metrics if m.name.endswith(".count")
                 and not m.name.startswith("veneur."))
    return ctotal, tcount


def _post(url, blob):
    req = urllib.request.Request(url, data=blob, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        body = e.read()
        e.close()
        return e.code, json.loads(body or b"{}")


class TestManagerHTTP:
    def test_handoff_over_http_and_idempotency(self):
        a, _, addr_a = make_handoff_global("a")
        b, _, addr_b = make_handoff_global("b")
        try:
            disc = MutableDiscoverer([addr_a])
            mgr = a.handoff_manager
            mgr.watcher = RingWatcher(disc, "test")
            assert mgr.refresh()["adopted"] == [addr_a]
            ctotal, wtotal = fill_store(a.store, n=30)
            disc.members = [addr_a, addr_b]
            summary = mgr.refresh()
            assert summary["moved_series"] > 0
            assert summary["sent"] == [addr_b] and summary["requeued"] == []
            assert b.handoff_manager.received_series_total \
                == summary["moved_series"]
            assert set(mgr.last_stages) == {"extract", "encode", "stream"}
            c_a, w_a, s_a = flush_totals(a.store)
            c_b, w_b, s_b = flush_totals(b.store)
            assert c_a + c_b == ctotal and c_b > 0
            assert w_a + w_b == pytest.approx(wtotal, rel=1e-6)
            assert not set(s_a) & set(s_b)
            assert len(s_a) + len(s_b) == 30
        finally:
            a.shutdown()
            b.shutdown()

    def test_duplicate_post_acks_without_remerging(self):
        b, _, addr_b = make_handoff_global("dup")
        try:
            store = make_store()
            fill_store(store, n=6)
            blob = encode_handoff(
                {"global_counters": store.global_counters.snapshot_state()},
                {"id": "dup-1", "sender": "x", "epoch": 1}, 0.0)
            status, body = _post(f"http://{addr_b}/handoff", blob)
            assert status == 200 and body["merged"] == 6
            status, body = _post(f"http://{addr_b}/handoff", blob)
            assert status == 200 and body.get("duplicate") is True
            assert b.handoff_manager.duplicates_total == 1
            c, _, _ = flush_totals(b.store)
            assert c == sum(10 + i for i in range(6))
            for hid, want in (("dup-1", True), ("nope", False)):
                with urllib.request.urlopen(
                        f"http://{addr_b}/handoff-status?id={hid}",
                        timeout=10) as resp:
                    assert json.loads(resp.read())["complete"] is want
        finally:
            b.shutdown()

    def test_stale_epoch_rejected(self):
        b, _, addr_b = make_handoff_global("stale")
        try:
            store = make_store()
            fill_store(store, n=3)
            groups = {"global_counters":
                      store.global_counters.snapshot_state()}

            def post(hid, epoch):
                return _post(f"http://{addr_b}/handoff", encode_handoff(
                    groups, {"id": hid, "sender": "s", "epoch": epoch},
                    0.0))[0]

            assert post("e5", 5) == 200
            assert post("e4", 4) == 409
            assert b.handoff_manager.stale_total == 1
        finally:
            b.shutdown()

    def test_malformed_body_400(self):
        b, _, addr_b = make_handoff_global("bad")
        try:
            req = urllib.request.Request(f"http://{addr_b}/handoff",
                                         data=b"not a handoff",
                                         method="POST")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=10)
            assert ei.value.code == 400
            ei.value.close()
        finally:
            b.shutdown()


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_interop_handoff_over_http(direction):
    """One package's manager hands moved ranges to the other package's
    global over POST /handoff: counters exact, mass within rtol 1e-6,
    registers exact, every series on exactly one side."""
    if direction == "jax->port":
        recv, _, addr_r = make_handoff_global("pr")
        src = jax_store()
        fill_store(src, n=24, seed=9, key=JKey)
        mgr = jho.HandoffManager(src, "jsend",
                                 JRingWatcher(MutableDiscoverer(["jsend"]),
                                              "t"), timeout=10.0)
        totals, recv_totals = jax_flush_totals, flush_totals
    else:
        recv, addr_r = make_jax_handoff_global("jr")
        src = make_store()
        fill_store(src, n=24, seed=9)
        mgr = HandoffManager(src, "psend",
                             RingWatcher(MutableDiscoverer(["psend"]), "t"),
                             timeout=10.0)
        totals, recv_totals = flush_totals, jax_flush_totals
    try:
        want = jax_store()
        ctotal, wtotal = fill_store(want, n=24, seed=9, key=JKey)
        _, _, want_sets = jax_flush_totals(want)
        assert "adopted" in mgr.refresh()
        mgr.watcher.discoverer.members = [mgr.self_addr, addr_r]
        summary = mgr.refresh()
        assert summary["sent"] == [addr_r] and summary["moved_series"] > 0
        c_s, w_s, sets_s = totals(src)
        c_r, w_r, sets_r = recv_totals(recv.store)
        assert c_s + c_r == ctotal and c_r > 0
        assert w_s + w_r == pytest.approx(wtotal, rel=1e-6)
        assert not set(sets_s) & set(sets_r)
        for name, regs in {**sets_s, **sets_r}.items():
            assert np.array_equal(np.asarray(regs), want_sets[name]), name
    finally:
        recv.shutdown()


# -- the failure ladder -----------------------------------------------------------


def _dead_addr():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    return addr


def _manager(store, members, **kw):
    kw.setdefault("timeout", 2.0)
    kw.setdefault("retry_policy", RetryPolicy(max_attempts=2,
                                              base_interval=0.01))
    return HandoffManager(store, "self",
                          RingWatcher(MutableDiscoverer(members), "t"), **kw)


class TestFailureLadder:
    def test_unreachable_destination_requeues(self, tmp_path):
        store = make_store()
        ctotal, wtotal = fill_store(store)
        dead = _dead_addr()
        mgr = _manager(store, ["self"], spool_prefix=str(tmp_path / "v.ckpt"))
        assert mgr.refresh()["adopted"] == ["self"]
        mgr.watcher.discoverer.members = ["self", dead]
        summary = mgr.refresh()
        assert summary["requeued"] == [dead]
        assert mgr.send_failures_total == 1
        assert mgr.requeued_series_total == summary["moved_series"]
        assert not list(tmp_path.glob("*.handoff.*"))
        c, w, _ = flush_totals(store)
        assert c == ctotal and w == pytest.approx(wtotal, rel=1e-6)

    def test_spool_enospc_degrades_but_handoff_continues(self, tmp_path):
        store = make_store()
        ctotal, wtotal = fill_store(store)
        dead = _dead_addr()
        inj = rfaults.FaultInjector(rate=1.0, seed=5, kinds=("disk_full",))
        mgr = _manager(store, ["self"], spool_prefix=str(tmp_path / "v.ckpt"),
                       spool_write_fn=inj.wrap_write(write_atomic,
                                                     "handoff.spool"))
        assert mgr.refresh()["adopted"] == ["self"]
        mgr.watcher.discoverer.members = ["self", dead]
        summary = mgr.refresh()
        assert mgr.spool_errors_total == 1
        assert "disk full" in mgr.last_spool_error
        assert not list(tmp_path.glob("*.handoff.*"))
        assert summary["requeued"] == [dead]
        assert mgr.requeued_series_total == summary["moved_series"]
        c, w, _ = flush_totals(store)
        assert c == ctotal and w == pytest.approx(wtotal, rel=1e-6)
        assert mgr.snapshot()["spool_errors_total"] == 1

    def test_spool_error_degrades_the_servers_readiness(self):
        a, _, _ = make_handoff_global("deg")
        try:
            a.handoff_manager.last_spool_error = "disk full"
            assert any("handoff spool" in d for d in a.degradation())
        finally:
            a.shutdown()

    def test_requeued_handoff_retries_on_next_refresh_cadence(self):
        a, _, addr_a = make_handoff_global("rqa")
        b, _, addr_b = make_handoff_global("rqb")
        try:
            inj = rfaults.FaultInjector(0.0, kinds=rfaults.CHURN_KINDS)
            inj._partitions[addr_b] = 100
            disc = MutableDiscoverer([addr_a])
            mgr = a.handoff_manager
            mgr.watcher = RingWatcher(disc, "test")
            mgr.injector = inj
            mgr.retry_policy = RetryPolicy(max_attempts=1,
                                           base_interval=0.01)
            assert mgr.refresh()["adopted"] == [addr_a]
            ctotal, wtotal = fill_store(a.store, n=30)
            disc.members = [addr_a, addr_b]
            summary = mgr.refresh()
            assert summary["requeued"] == [addr_b] and mgr.retry_pending
            moved_first = summary["moved_series"]
            assert mgr.requeued_series_total == moved_first > 0
            breaker = mgr.breakers.get(addr_b)
            for _ in range(breaker.failure_threshold):
                breaker.record_failure()
            assert breaker.blocked()
            assert mgr.refresh() is None
            assert mgr.requeue_retries_total == 0
            breaker.record_success()
            inj._partitions.clear()
            summary = mgr.refresh()
            assert summary is not None
            assert summary["sent"] == [addr_b] and summary["requeued"] == []
            assert not mgr.retry_pending and mgr.requeue_retries_total == 1
            assert summary["moved_series"] == moved_first
            assert b.handoff_manager.received_series_total \
                == summary["moved_series"]
            c_a, w_a, _ = flush_totals(a.store)
            c_b, w_b, _ = flush_totals(b.store)
            assert c_a + c_b == ctotal and c_b > 0
            assert w_a + w_b == pytest.approx(wtotal, rel=1e-6)
            assert mgr.refresh() is None
        finally:
            a.shutdown()
            b.shutdown()

    def test_partition_fault_blackholes_then_requeues(self):
        store = make_store()
        ctotal, _ = fill_store(store, n=10)
        inj = rfaults.FaultInjector(0.0, kinds=rfaults.CHURN_KINDS)
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        try:
            dest = f"127.0.0.1:{s.getsockname()[1]}"
            inj._partitions[dest] = 10
            mgr = _manager(store, ["self"], timeout=1.0, injector=inj,
                           retry_policy=RetryPolicy(max_attempts=1,
                                                    base_interval=0.01))
            mgr.refresh()
            mgr.watcher.discoverer.members = ["self", dest]
            summary = mgr.refresh()
            assert summary["requeued"] == [dest]
            assert "injected partition" in mgr.last_error
            c, _, _ = flush_totals(store)
            assert c == ctotal
        finally:
            s.close()

    def test_spool_recovery_merges_and_cleans(self, tmp_path):
        store, donor = make_store(), make_store()
        ctotal, wtotal = fill_store(donor)
        groups = {"global_counters": donor.global_counters.snapshot_state(),
                  "timers": donor.timers.snapshot_state()}
        blob = encode_handoff(groups, {"id": "sp1", "sender": "s",
                                       "epoch": 2, "dest": "127.0.0.1:9"},
                              0.0)
        prefix = str(tmp_path / "v.ckpt")
        write_atomic(prefix + ".handoff.2.0", blob)
        (tmp_path / "v.ckpt.handoff.2.1.tmp").write_bytes(b"partial")
        mgr = _manager(store, ["self"], spool_prefix=prefix, timeout=1.0,
                       retry_policy=RetryPolicy(max_attempts=1,
                                                base_interval=0.01))
        assert mgr.recover_spool() > 0
        assert not list(tmp_path.glob("*.handoff.*"))
        c, w, _ = flush_totals(store)
        assert c == ctotal and w == pytest.approx(wtotal, rel=1e-6)

    def test_spool_recovery_resends_by_id_no_double_merge(self, tmp_path):
        b, _, addr_b = make_handoff_global("spdup")
        try:
            donor = make_store()
            fill_store(donor, n=6)
            blob = encode_handoff(
                {"global_counters": donor.global_counters.snapshot_state()},
                {"id": "sp-dup", "sender": "s", "epoch": 3,
                 "dest": addr_b}, 0.0)
            assert _post(f"http://{addr_b}/handoff", blob)[0] == 200
            prefix = str(tmp_path / "v.ckpt")
            write_atomic(prefix + ".handoff.3.0", blob)
            sender_store = make_store()
            mgr = _manager(sender_store, ["s"], spool_prefix=prefix,
                           timeout=5.0)
            assert mgr.recover_spool() == 0
            assert mgr.spool_resent_total == 1
            assert b.handoff_manager.duplicates_total == 1
            assert not list(tmp_path.glob("*.handoff.*"))
            c, _, _ = flush_totals(b.store)
            assert c == sum(10 + i for i in range(6))
            assert flush_totals(sender_store)[0] == 0
        finally:
            b.shutdown()

    def test_config_skew_rejected_whole_and_requeued(self):
        b, _, addr_b = make_handoff_global("skew")
        try:
            donor = make_store(hll_precision=12)
            fill_store(donor, n=5)
            groups = {"global_counters":
                      donor.global_counters.snapshot_state(),
                      "sets": donor.sets.snapshot_state()}
            status, body, _ = b.handoff_manager.handle_handoff(
                encode_handoff(groups, {"id": "skew-1", "sender": "s",
                                        "epoch": 1, "series": 10}, 0.0))
            assert status == 422 and "precision" in body
            assert b.handoff_manager.rejected_total == 1
            assert flush_totals(b.store)[0] == 0
            with urllib.request.urlopen(
                    f"http://{addr_b}/handoff-status?id=skew-1",
                    timeout=10) as resp:
                assert json.loads(resp.read())["complete"] is False
        finally:
            b.shutdown()

    def test_epoch_monotonic_across_incarnations(self):
        store = make_store()
        mgr1 = _manager(store, ["s"])
        assert mgr1.epoch >= int(time.time()) - 5
        mgr2 = _manager(store, ["s"])
        assert mgr2.epoch >= mgr1.epoch + 3 - 5
        assert mgr1.incarnation != mgr2.incarnation

    def test_hybrid_epoch_monotone_under_backwards_clock(self):
        t = [50_000.0]
        ep, jep = HybridEpoch(clock=lambda: t[0]), \
            jho.HybridEpoch(clock=lambda: t[0])
        seen, jseen = [], []
        for skew in (10.0, -3000.0, 5.0, -1.0, 2.0):
            t[0] += skew
            seen.append(ep.advance())
            jseen.append(jep.advance())
        assert seen == jseen == sorted(seen)
        assert len(set(seen)) == len(seen)

    def test_restart_onto_skewed_backwards_clock_not_stale(self):
        recv = _manager(make_store(), ["r"])
        donor = make_store()
        fill_store(donor, n=3)
        groups = {"global_counters": donor.global_counters.snapshot_state()}
        t = int(time.time())

        def hand(hid, epoch, ctr, inc):
            return recv.handle_handoff(encode_handoff(
                groups, {"id": hid, "sender": "s", "epoch": epoch,
                         "epoch_ctr": ctr, "incarnation": inc}, 0.0))

        assert hand("life-a-7", t, 7, "aaaa")[0] == 200
        assert hand("life-b-1", t - 1000, 1, "bbbb")[0] == 200
        assert recv.stale_total == 0
        status, body, _ = hand("life-a-3", t, 3, "aaaa")
        assert status == 409 and "stale" in body and recv.stale_total == 1

    def test_kept_remerge_prefers_live_gauge(self):
        store = make_store()
        k = MetricKey(name="g1", type="gauge", joined_tags="")
        store.import_gauge(k, [], 5.0)
        snap = {"global_gauges": store.global_gauges.snapshot_state()}
        store.import_gauge(k, [], 7.0)
        store.restore_state(snap, prefer_live_scalars=True)
        _, fwd = store.flush([], AGG, 0, is_local=True, forward=True)
        assert dict((n, v) for n, _t, v in fwd.gauges)["g1"] == 7.0
        kc = MetricKey(name="c1", type="counter", joined_tags="")
        store.import_counter(kc, [], 3)
        snap = {"global_counters": store.global_counters.snapshot_state()}
        store.import_counter(kc, [], 4)
        store.restore_state(snap, prefer_live_scalars=True)
        _, fwd = store.flush([], AGG, 0, is_local=True, forward=True)
        assert dict((n, v) for n, _t, v in fwd.counters)["c1"] == 10

    def test_shutdown_quiesces_an_inflight_handoff(self):
        a, _, _ = make_handoff_global("q")
        try:
            mgr = a.handoff_manager
            mgr._busy.acquire()
            assert mgr.quiesce(timeout=0.05) is False
            mgr._busy.release()
            assert mgr.quiesce(timeout=0.05) is True
        finally:
            a.shutdown()


class TestResizeAcceptance:
    def test_grow_then_shrink_conserves_under_ingest(self):
        a, sink_a, addr_a = make_handoff_global("ra")
        b, sink_b, addr_b = make_handoff_global("rb")
        c, sink_c, addr_c = make_handoff_global("rc")
        servers = {addr_a: a, addr_b: b, addr_c: c}
        sinks = {addr_a: sink_a, addr_b: sink_b, addr_c: sink_c}
        try:
            disc = {addr: MutableDiscoverer([addr_a, addr_b])
                    for addr in servers}
            for addr, srv in servers.items():
                srv.handoff_manager.watcher = RingWatcher(disc[addr], "t")
            for addr in (addr_a, addr_b):
                servers[addr].handoff_manager.refresh()
            members_lock = threading.Lock()
            members = [addr_a, addr_b]
            stop = threading.Event()
            sent = {"c": 0, "t": 0}

            def ingest():
                i = 0
                with members_lock:
                    ring = ConsistentRing(list(members))
                while not stop.is_set():
                    if i % 64 == 0:
                        with members_lock:
                            ring = ConsistentRing(list(members))
                    name = f"gc{i % 40}"
                    owner = ring.get(ring_key(name, "counter", ""))
                    servers[owner].store.process_metric(parse_metric(
                        f"{name}:2|c|#veneurglobalonly".encode()))
                    sent["c"] += 2
                    tname = f"lat{i % 40}"
                    towner = ring.get(ring_key(tname, "timer", ""))
                    servers[towner].store.process_metric(parse_metric(
                        f"{tname}:{(i % 50) + 1}|ms".encode()))
                    sent["t"] += 1
                    i += 1
                    if i % 200 == 0:
                        time.sleep(0.001)

            t = threading.Thread(target=ingest, daemon=True)
            t.start()
            time.sleep(0.3)
            for d in disc.values():
                d.members = [addr_a, addr_b, addr_c]
            servers[addr_c].handoff_manager.refresh()
            sum_a = servers[addr_a].handoff_manager.refresh()
            sum_b = servers[addr_b].handoff_manager.refresh()
            with members_lock:
                members[:] = [addr_a, addr_b, addr_c]
            assert sum_a["requeued"] == [] and sum_b["requeued"] == []
            assert sum_a["moved_series"] + sum_b["moved_series"] > 0
            time.sleep(0.3)
            for d in disc.values():
                d.members = [addr_a, addr_b]
            with members_lock:
                members[:] = [addr_a, addr_b]
            time.sleep(0.05)
            sum_c = servers[addr_c].handoff_manager.refresh()
            servers[addr_a].handoff_manager.refresh()
            servers[addr_b].handoff_manager.refresh()
            assert sum_c["requeued"] == [] and sum_c["moved_series"] > 0
            time.sleep(0.2)
            stop.set()
            t.join(timeout=10)
            assert not t.is_alive()
            got_c = got_t = 0.0
            for addr, srv in servers.items():
                cc, tc = drain_flush_totals(srv, sinks[addr])
                got_c += cc
                got_t += tc
            assert got_c == sent["c"]
            assert got_t == sent["t"]
            assert a.handoff_manager.last_duration_ns > 0
        finally:
            for srv in servers.values():
                srv.shutdown()


# -- SIGKILL mid-handoff: real port Server subprocesses -----------------------


SERVER_SCRIPT = """
import signal, sys, threading
from veneur_tpu_torch.cli.server import config_sinks
from veneur_tpu_torch.config import read_config
from veneur_tpu_torch.server import Server

cfg = read_config(sys.argv[1])
sinks, span_sinks, plugins = config_sinks(cfg)
srv = Server(cfg, metric_sinks=sinks, span_sinks=span_sinks,
             plugins=plugins, device="cpu")
done = threading.Event()
signal.signal(signal.SIGTERM, lambda s, f: done.set())
srv.start()
print("READY", srv.statsd_addrs[0][1], flush=True)
done.wait()
srv.shutdown()
print("CLEAN", flush=True)
"""

E2E_CONFIG = """
statsd_listen_addresses: ["udp://127.0.0.1:0"]
interval: "600s"
percentiles: [0.5]
aggregates: ["min", "max", "count"]
hostname: "e2e"
http_address: "{http_address}"
checkpoint_path: "{ckpt}"
checkpoint_interval: "250ms"
checkpoint_max_age_intervals: 10.0
flush_file: "{flush}"
store_initial_capacity: 32
store_chunk: 128
flush_columnar: false
handoff_enabled: true
handoff_self: "{self_addr}"
handoff_peers: "file://{peers}"
handoff_refresh_interval: "250ms"
handoff_timeout: "{handoff_timeout}"
retry_max: {retry_max}
retry_base_interval: "100ms"
"""

N_SERIES = 40


class Proc:
    def __init__(self, tmp_path, config_path, tag):
        self.log = open(tmp_path / f"server-{tag}.log", "wb")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
            + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        self.p = subprocess.Popen(
            [sys.executable, "-c", SERVER_SCRIPT, str(config_path)],
            stdout=subprocess.PIPE, stderr=self.log, env=env)

    def wait_ready(self, timeout=120.0):
        deadline = time.time() + timeout
        buf = b""
        os.set_blocking(self.p.stdout.fileno(), False)
        while time.time() < deadline:
            if self.p.poll() is not None:
                raise AssertionError(f"server exited rc={self.p.returncode}")
            r, _, _ = select.select([self.p.stdout], [], [], 0.25)
            if r:
                buf += self.p.stdout.read(4096) or b""
                if b"\n" in buf:
                    line = buf.split(b"\n")[0].decode()
                    assert line.startswith("READY"), line
                    return int(line.split()[1])
        raise AssertionError("the server never came up")

    def sigkill(self):
        self.p.kill()
        self.p.wait(timeout=30)

    def sigterm_clean(self):
        self.p.send_signal(signal.SIGTERM)
        self.p.wait(timeout=120)
        assert self.p.returncode == 0

    def close(self):
        if self.p.poll() is None:
            self.p.kill()
            self.p.wait(timeout=30)
        self.log.close()


def write_e2e_config(tmp_path, peers, self_addr, handoff_timeout="60s",
                     retry_max=2, http_address="127.0.0.1:0"):
    ckpt, flush = tmp_path / "v.ckpt", tmp_path / "flush.tsv.gz"
    config = tmp_path / "cfg.yaml"
    config.write_text(E2E_CONFIG.format(
        ckpt=ckpt, flush=flush, peers=peers, self_addr=self_addr,
        handoff_timeout=handoff_timeout, retry_max=retry_max,
        http_address=http_address))
    return ckpt, flush, config


def send_fleet_shape(port, prefix):
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        for i in range(N_SERIES):
            s.sendto(f"{prefix}.c{i}:2|c|#veneurglobalonly".encode(),
                     ("127.0.0.1", port))
            s.sendto(f"{prefix}.lat{i}:{i + 1}|ms".encode(),
                     ("127.0.0.1", port))


def read_flush_rows(path):
    import csv
    import gzip
    import io

    with gzip.open(path, "rt") as f:
        text = f.read()
    return [{"name": r[0], "type": r[2], "interval": float(r[4]),
             "value": float(r[6])}
            for r in csv.reader(io.StringIO(text), delimiter="\t")]


def assert_conserved(flush, prefix):
    rows = read_flush_rows(flush)
    got_c = sum(r["value"] * r["interval"] for r in rows
                if r["type"] == "rate" and r["name"].startswith(f"{prefix}.c"))
    got_t = sum(r["value"] * r["interval"] for r in rows
                if r["type"] == "rate"
                and r["name"].startswith(f"{prefix}.lat")
                and r["name"].endswith(".count"))
    assert got_c == pytest.approx(2.0 * N_SERIES)
    assert got_t == pytest.approx(float(N_SERIES))


def wait_checkpointed(ckpt, prefix, timeout=60.0):
    from veneur_tpu_torch.persist import deserialize, read_file

    deadline = time.time() + timeout
    while time.time() < deadline:
        blob = read_file(str(ckpt))
        if blob:
            groups, _ = deserialize(blob)
            if (f"{prefix}.c0" in groups["global_counters"]["names"]
                    and f"{prefix}.lat0" in groups["timers"]["names"]):
                return
        time.sleep(0.1)
    raise AssertionError("the data never reached the checkpoint")


def test_sigkill_sender_midhandoff_recovers_from_checkpoints(tmp_path):
    """The losing instance is killed while its stream hangs on a half-open
    peer: the post-swap checkpoint restores the kept half, the spool the
    moved half, and the clean shutdown emits everything exactly once."""
    peers = tmp_path / "peers"
    peers.write_text("sender-a\n")
    ckpt, flush, config = write_e2e_config(tmp_path, peers, "sender-a")
    blackhole = socket.socket()
    blackhole.bind(("127.0.0.1", 0))
    blackhole.listen(1)
    dead_addr = f"127.0.0.1:{blackhole.getsockname()[1]}"
    p1 = Proc(tmp_path, config, "sender-crash")
    try:
        port = p1.wait_ready()
        send_fleet_shape(port, "crash")
        wait_checkpointed(ckpt, "crash")
        peers.write_text(f"sender-a\n{dead_addr}\n")
        deadline = time.time() + 90
        while not [p for p in os.listdir(tmp_path)
                   if ".handoff." in p and not p.endswith(".tmp")]:
            assert time.time() < deadline, "no handoff spool appeared"
            time.sleep(0.05)
        p1.sigkill()
    finally:
        p1.close()
        blackhole.close()
    assert not flush.exists()
    peers.write_text("sender-a\n")
    p2 = Proc(tmp_path, config, "sender-recover")
    try:
        p2.wait_ready()
        p2.sigterm_clean()
    finally:
        p2.close()
    assert_conserved(flush, "crash")
    assert not [p for p in os.listdir(tmp_path) if ".handoff." in p]


def test_sigkill_receiver_midhandoff_sender_requeues(tmp_path):
    """The receiver dies before merging: the stream and the completion
    probe fail, the moved ranges re-queue, and the sender emits
    everything once; the dead receiver emits nothing."""
    recv_addr = _dead_addr()
    recv_port = int(recv_addr.rsplit(":", 1)[1])
    recv_dir = tmp_path / "recv"
    recv_dir.mkdir()
    (recv_dir / "peers").write_text(f"{recv_addr}\n")
    _, rflush, rconfig = write_e2e_config(
        recv_dir, recv_dir / "peers", recv_addr,
        http_address=f"127.0.0.1:{recv_port}")
    pr = Proc(recv_dir, rconfig, "receiver")
    try:
        pr.wait_ready()
        pr.sigkill()
    finally:
        pr.close()
    send_http = int(_dead_addr().rsplit(":", 1)[1])
    send_dir = tmp_path / "send"
    send_dir.mkdir()
    peers = send_dir / "peers"
    peers.write_text("sender-a\n")
    ckpt, flush, config = write_e2e_config(
        send_dir, peers, "sender-a", handoff_timeout="2s", retry_max=1,
        http_address=f"127.0.0.1:{send_http}")
    p1 = Proc(send_dir, config, "sender")
    try:
        port = p1.wait_ready()
        send_fleet_shape(port, "keep")
        wait_checkpointed(ckpt, "keep")
        peers.write_text(f"sender-a\n{recv_addr}\n")
        # the port has no /debug/vars: the sender's handoff counts are
        # not reachable from here, so the requeue shows in its log line
        log = send_dir / "server-sender.log"
        deadline = time.time() + 120
        while b"re-merged" not in log.read_bytes():
            assert time.time() < deadline, "the moved ranges never requeued"
            time.sleep(0.2)
        p1.sigterm_clean()
    finally:
        p1.close()
    assert_conserved(flush, "keep")
    assert not rflush.exists()
