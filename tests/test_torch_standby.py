"""The port's global HA (``veneur_tpu_torch/fleet/standby.py``,
``veneur_tpu_torch/discovery/lease.py``) against the JAX package's, on
the CPU.

* The lease: the fencing epoch bumps per holding life, never on renewal;
  a live lease refuses other holders; release expires it now and keeps
  the epoch; a corrupt record is an expired lease; the elector promotes
  on acquisition, demotes on loss, keeps the last good state across a
  backend error; ``LeaderDiscoverer`` follows the holder. A lease file
  written by one package is read, renewed and taken over by the other
  (the record format is the same); the same clock gives both packages'
  electors the same transitions. Everything here is exact.
* Replication: a round trip lands in the shadow, not the live store; the
  id, stale-epoch and lease-epoch guards; depth-1 drop-oldest capture;
  promotion merges every group but the counters (digest mass within rtol
  1e-6 of what was replicated, set registers exact); the replication
  age; a follower and a peerless active replicate nothing.
* Interop over HTTP both ways: a JAX active replicates to a port
  standby's ``POST /replicate``, a port active to a JAX standby's; after
  promotion the standby's store holds the replicated state (counters
  excluded; mass within rtol 1e-6, registers exact).
* A real pair of port Servers: the flusher captures only while leading
  and with peers, each flush replicates, a crash (no lease release)
  hands the lease to the standby after the ttl, which promotes and
  flushes the active's last replicated gauges, sets and digests (mass
  within rtol 1e-6) and no replicated counter; a clean shutdown
  releases the lease.
"""

import json
import time
import urllib.request

import numpy as np
import pytest

from veneur_tpu.core.store import MetricStore as JStore
from veneur_tpu.discovery import lease as jlease
from veneur_tpu.fleet import standby as jsb
from veneur_tpu.samplers.intermetric import HistogramAggregates as JAggs
from veneur_tpu.samplers.parser import MetricKey as JKey
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.core.store import MetricStore
from veneur_tpu_torch.discovery import (LeaderDiscoverer, LeaseElector,
                                        lease_backend_from_url)
from veneur_tpu_torch.discovery.lease import ConsulLease, FileLease
from veneur_tpu_torch.fleet.handoff import encode_handoff
from veneur_tpu_torch.fleet.standby import (PROMOTABLE_GROUPS,
                                            StandbyManager)
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates
from veneur_tpu_torch.samplers.parser import MetricKey, parse_metric
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

AGG = HistogramAggregates.from_names(["min", "max", "count"])


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def make_store(**kw):
    kw.setdefault("initial_capacity", 32)
    kw.setdefault("chunk", 128)
    return MetricStore(device="cpu", **kw)


def fill_store(store, n=10, key=MetricKey):
    """Counters, timer digests, sets and gauges in either package's
    store. Returns (counter total, digest weight total)."""
    rng = np.random.default_rng(7)
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
        regs[i % 50] = 3
        store.import_set(key(name=f"s{i}", type="set", joined_tags=""),
                         [], regs)
        store.import_gauge(key(name=f"g{i}", type="gauge", joined_tags=""),
                           [], float(i) + 0.5)
    return ctotal, wtotal


def forward_of(store):
    _, fwd = store.flush([0.5], AGG, 0, is_local=True, forward=True)
    fwd.materialize_digests()
    return fwd


def digest_weight(fwd):
    return sum(float(np.sum(w)) for _, _, _, w, _, _ in
               fwd.histograms + fwd.timers)


# -- the lease --------------------------------------------------------------------


class TestFileLease:
    def test_epoch_bumps_per_holding_life_not_renewal(self, tmp_path):
        clk = FakeClock()
        lease = FileLease(str(tmp_path / "lease"), clock=clk)
        assert lease.acquire_or_renew("A", ttl=10.0).epoch == 1
        clk.t += 5.0
        assert lease.acquire_or_renew("A", ttl=10.0).epoch == 1
        clk.t += 20.0
        assert lease.acquire_or_renew("A", ttl=10.0).epoch == 2
        clk.t += 20.0
        assert lease.acquire_or_renew("B", ttl=10.0).epoch == 3

    def test_live_lease_rejects_other_holders(self, tmp_path):
        clk = FakeClock()
        lease = FileLease(str(tmp_path / "lease"), clock=clk)
        assert lease.acquire_or_renew("A", ttl=10.0) is not None
        assert lease.acquire_or_renew("B", ttl=10.0) is None
        clk.t += 11.0
        assert lease.acquire_or_renew("B", ttl=10.0) is not None

    def test_release_expires_now_but_keeps_epoch(self, tmp_path):
        clk = FakeClock()
        lease = FileLease(str(tmp_path / "lease"), clock=clk)
        lease.acquire_or_renew("A", ttl=300.0)
        lease.release("A")
        st = lease.read()
        assert st.expired(clk()) and st.epoch == 1
        assert lease.acquire_or_renew("B", ttl=10.0).epoch == 2

    def test_corrupt_record_is_expired_not_fatal(self, tmp_path):
        path = tmp_path / "lease"
        path.write_bytes(b"\x00garbage{{{")
        lease = FileLease(str(path), clock=FakeClock())
        assert lease.read() is None
        assert lease.acquire_or_renew("A", ttl=10.0) is not None

    def test_backend_url_parsing(self, tmp_path):
        assert isinstance(lease_backend_from_url(f"file://{tmp_path}/l"),
                          FileLease)
        assert isinstance(lease_backend_from_url("consul://veneur/lead"),
                          ConsulLease)
        with pytest.raises(ValueError):
            lease_backend_from_url("zk://nope")

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_lease_file_crosses_packages(self, tmp_path, writer):
        """One package writes the record, the other reads it, refuses it
        while live, renews nothing of it, and takes it over after expiry
        with the next fencing epoch."""
        clk = FakeClock()
        path = str(tmp_path / "lease")
        ours = FileLease(path, clock=clk)
        theirs = jlease.FileLease(path, clock=clk)
        first, second = (theirs, ours) if writer == "jax" else (ours, theirs)
        assert first.acquire_or_renew("A", ttl=10.0).epoch == 1
        st = second.read()
        assert (st.holder, st.epoch, st.expires_at) == ("A", 1, 1010.0)
        assert second.acquire_or_renew("B", ttl=10.0) is None
        clk.t += 4.0
        assert second.acquire_or_renew("A", ttl=10.0).epoch == 1  # renewal
        assert first.read().expires_at == 1014.0
        clk.t += 11.0
        assert second.acquire_or_renew("B", ttl=10.0).epoch == 2
        assert first.read().holder == "B"


class TestLeaseElector:
    def _pair(self, tmp_path, clk, mod=None):
        events = []
        if mod is None:
            lease, cls = FileLease(str(tmp_path / "lease"), clock=clk), \
                LeaseElector
        else:
            lease, cls = mod.FileLease(str(tmp_path / "lease"), clock=clk), \
                mod.LeaseElector

        def elector(name):
            return cls(lease, holder=name, ttl=10.0, renew_interval=3.0,
                       on_promote=lambda ep: events.append((name, "up", ep)),
                       on_demote=lambda why: events.append((name, "down")),
                       clock=clk)
        return elector("A"), elector("B"), events

    def test_promote_on_acquire_demote_on_loss(self, tmp_path):
        clk = FakeClock()
        a, b, events = self._pair(tmp_path, clk)
        assert a.poll() is True and b.poll() is False
        assert events == [("A", "up", 1)]
        clk.t += 11.0
        assert b.poll() is True and ("B", "up", 2) in events
        assert a.poll() is False
        assert a.demotions_total == 1 and events[-1] == ("A", "down")

    def test_keep_last_good_across_backend_errors(self, tmp_path):
        clk = FakeClock()
        a, _b, _events = self._pair(tmp_path, clk)
        assert a.poll() is True

        class Flaky:
            def acquire_or_renew(self, holder, ttl):
                raise OSError("shared disk blip")

        a.backend = Flaky()
        clk.t += 5.0
        assert a.poll() is True
        assert a.renew_failures_total == 1 and a.demotions_total == 0
        clk.t += 6.0
        assert a.poll() is False and a.demotions_total == 1

    def test_transitions_equal_the_jax_electors(self, tmp_path):
        """The same poll schedule on the same clock: both packages'
        electors promote and demote at the same polls, with the same
        epochs."""
        seqs = []
        for mod in (None, jlease):
            d = tmp_path / ("p" if mod is None else "j")
            d.mkdir()
            clk = FakeClock()
            a, b, events = self._pair(d, clk, mod)
            polls = []
            for step in (0, 2, 4, 11, 1, 3, 15, 2):
                clk.t += step
                polls.append((a.poll(), b.poll(), a.lease_epoch,
                              b.lease_epoch))
            seqs.append((polls, events))
        assert seqs[0] == seqs[1]

    def test_release_is_skipped_by_a_follower(self, tmp_path):
        clk = FakeClock()
        a, b, _ = self._pair(tmp_path, clk)
        a.poll()
        b.poll()
        b.release()  # a follower releases nothing
        assert a.backend.read().holder == "A"
        a.release()
        assert a.backend.read().expired(clk()) and not a.is_leader


class TestLeaderDiscoverer:
    def test_routes_follow_the_lease(self, tmp_path):
        clk = FakeClock()
        lease = FileLease(str(tmp_path / "lease"), clock=clk)
        disc = LeaderDiscoverer(lease, clock=clk)
        with pytest.raises(RuntimeError):
            disc.get_destinations_for_service("veneur-global")
        lease.acquire_or_renew("http://a:8100", ttl=10.0)
        assert disc.get_destinations_for_service("x") == ["http://a:8100"]
        lease.release("http://a:8100")
        with pytest.raises(RuntimeError):
            disc.get_destinations_for_service("x")
        lease.acquire_or_renew("http://b:8100", ttl=10.0)
        assert disc.get_destinations_for_service("x") == ["http://b:8100"]


# -- replication ----------------------------------------------------------------------


def wire_pair(monkeypatch, sby, active):
    """Route the active's send straight into the standby's receiver (the
    real encode and decode, no sockets)."""
    statuses = []

    def fake_send(dest, blob, rid, ctx=None):
        status, _body, _ct = sby.handle_replicate(blob)
        statuses.append(status)
        return status == 200

    monkeypatch.setattr(active, "_send", fake_send)
    return statuses


class TestReplication:
    def _pair(self, monkeypatch):
        store_a, store_b = make_store(), make_store()
        active = StandbyManager(store_a, "http://a", ["http://b"])
        active.is_leader, active.lease_epoch = True, 1
        sby = StandbyManager(store_b, "http://b", [])
        return store_a, store_b, active, sby, \
            wire_pair(monkeypatch, sby, active)

    def test_round_trip_lands_in_shadow_not_store(self, monkeypatch):
        store_a, store_b, active, sby, statuses = self._pair(monkeypatch)
        fill_store(store_a)
        groups, epoch = store_a.snapshot_state()
        active.capture(groups, epoch)
        summary = active.dispatch()
        assert statuses == [200] and summary["sent"] == ["http://b"]
        assert sby.receives_total == 1
        assert sby.shadow.series_held() == summary["series"] > 0
        assert active.last_replicate_bytes > 0
        fwd = forward_of(store_b)
        assert not fwd.counters and not fwd.timers and not fwd.gauges

    def test_duplicate_id_acked_once(self, monkeypatch):
        store_a, _, active, sby, _ = self._pair(monkeypatch)
        fill_store(store_a)
        groups, epoch = store_a.snapshot_state()
        active.capture(groups, epoch)
        active.dispatch()
        held = sby.shadow.series_held()
        ring = sby.shadow._epochs["http://a"]
        blob = encode_handoff(ring[-1][1], dict(ring[-1][2]), time.time())
        status, body, _ = sby.handle_replicate(blob)
        assert status == 200 and json.loads(body)["duplicate"] is True
        assert sby.duplicates_total == 1
        assert sby.shadow.series_held() == held

    def test_stale_flush_epoch_rejected(self, monkeypatch):
        store_a, _, active, sby, statuses = self._pair(monkeypatch)
        fill_store(store_a)
        groups, _ = store_a.snapshot_state()
        active.capture(groups, 5)
        active.dispatch()
        active.capture(groups, 5)
        active.dispatch()
        assert statuses == [200, 409]
        assert sby.stale_total == 1 and active.replicate_failures_total == 1

    def test_first_epoch_zero_is_not_stale(self, monkeypatch):
        store_a, _, active, sby, statuses = self._pair(monkeypatch)
        fill_store(store_a, n=2)
        groups, _ = store_a.snapshot_state()
        active.capture(groups, 0)
        active.dispatch()
        assert statuses == [200]
        assert sby.stale_total == 0 and sby.receives_total == 1

    def test_deposed_active_fenced_by_lease_epoch(self, monkeypatch):
        store_a, _, active, sby, _ = self._pair(monkeypatch)
        fill_store(store_a)
        groups, _ = store_a.snapshot_state()
        active.lease_epoch = 2
        active.capture(groups, 1)
        active.dispatch()
        old = StandbyManager(make_store(), "http://old", ["http://b"])
        old.is_leader, old.lease_epoch = True, 1
        wire_pair(monkeypatch, sby, old)
        fill_store(old.store, n=3)
        g2, _ = old.store.snapshot_state()
        old.capture(g2, 99)
        old.dispatch()
        assert sby.fenced_total == 1
        assert sby.shadow.latest().keys() == {"http://a"}

    def test_config_skew_rejected_whole(self, monkeypatch):
        _, _, active, sby, statuses = self._pair(monkeypatch)
        donor = make_store(hll_precision=12)
        fill_store(donor, n=3)
        groups, _ = donor.snapshot_state()
        active.capture(groups, 1)
        active.dispatch()
        assert statuses == [422] and sby.rejected_total == 1
        assert sby.shadow.series_held() == 0

    def test_drop_oldest_capture_never_backpressures(self, monkeypatch):
        store_a, _, active, sby, _ = self._pair(monkeypatch)
        fill_store(store_a, n=2)
        groups, _ = store_a.snapshot_state()
        active.capture(groups, 1)
        active.capture(groups, 2)
        assert active.dropped_epochs_total == 1
        active.dispatch()
        assert [e for e, *_ in sby.shadow._epochs["http://a"]] == [2]

    def test_promote_merges_non_counter_groups_only(self, monkeypatch):
        store_a, store_b, active, sby, _ = self._pair(monkeypatch)
        _, wtotal = fill_store(store_a)
        groups, epoch = store_a.snapshot_state()
        active.capture(groups, epoch)
        active.dispatch()
        assert sby.promote(lease_epoch=2) > 0 and sby.promoted
        assert "global_counters" not in PROMOTABLE_GROUPS
        assert PROMOTABLE_GROUPS == jsb.PROMOTABLE_GROUPS
        fwd = forward_of(store_b)
        assert not [n for n, _t, _v in fwd.counters if n.startswith("m")]
        assert digest_weight(fwd) == pytest.approx(wtotal, rel=1e-6)
        assert {n for n, *_ in fwd.sets} == {f"s{i}" for i in range(10)}
        assert dict((n, v) for n, _t, v in fwd.gauges) == {
            f"g{i}": i + 0.5 for i in range(10)}

    def test_replication_age_gauge(self, monkeypatch):
        clk = FakeClock()
        store_a, store_b = make_store(), make_store()
        active = StandbyManager(store_a, "http://a", ["http://b"])
        active.is_leader, active.lease_epoch = True, 1
        sby = StandbyManager(store_b, "http://b", [], clock=clk)
        wire_pair(monkeypatch, sby, active)
        assert sby.replication_age_seconds() == -1.0
        fill_store(store_a, n=2)
        groups, epoch = store_a.snapshot_state()
        active.capture(groups, epoch)
        active.dispatch()
        assert sby.replication_age_seconds() == pytest.approx(0.0)
        clk.t += 7.5
        assert sby.replication_age_seconds() == pytest.approx(7.5)

    def test_follower_and_peerless_dispatch_no_op(self):
        mgr = StandbyManager(make_store(), "http://a", ["http://b"])
        groups = {"global_counters": {"names": ["x"]}}
        mgr.capture(groups, 1)
        assert mgr.dispatch() is None
        lone = StandbyManager(make_store(), "http://a", [])
        lone.is_leader = True
        lone.capture(groups, 1)
        assert lone.dispatch() is None

    def test_peers_file_is_reread(self, tmp_path):
        peers = tmp_path / "peers"
        peers.write_text("# standbys\nhttp://b\nhttp://a\n")
        mgr = StandbyManager(make_store(), "http://a", f"file://{peers}")
        assert mgr._resolve_peers() == ["http://b"]
        peers.write_text("http://c\n")
        assert mgr._resolve_peers() == ["http://c"]
        peers.unlink()
        assert mgr._resolve_peers() == ["http://c"]  # keep-last-good
        assert "peers file" in mgr.last_error


# -- over HTTP, across the packages -----------------------------------------------------


def standby_server(tmp_path, tag="standby", **kw):
    cfg = Config(statsd_listen_addresses=[], http_address="127.0.0.1:0",
                 interval="86400s", store_initial_capacity=32,
                 store_chunk=128, aggregates=["count"], percentiles=[0.5],
                 lease_path=f"file://{tmp_path}/lease", lease_ttl="86400s",
                 handoff_self=tag, flush_columnar=False, **kw)
    server = Server(cfg, metric_sinks=[ChannelMetricSink()], device="cpu")
    server.start()
    return server


def jax_standby_server(tmp_path):
    from veneur_tpu.config import Config as JConfig
    from veneur_tpu.server import Server as JServer
    from veneur_tpu.sinks import ChannelMetricSink as JSink

    cfg = JConfig(statsd_listen_addresses=[], http_address="127.0.0.1:0",
                  interval="86400s", store_initial_capacity=32,
                  store_chunk=128, aggregates=["count"], percentiles=[0.5],
                  lease_path=f"file://{tmp_path}/lease", lease_ttl="86400s",
                  handoff_self="jstandby")
    server = JServer(cfg, metric_sinks=[JSink()])
    server.start()
    return server


class TestReplicateOverHTTP:
    def test_active_streams_to_a_real_standby_server(self, tmp_path):
        # the lease is held elsewhere: this standby stays a follower
        FileLease(str(tmp_path / "lease")).acquire_or_renew("other", 3600)
        standby = standby_server(tmp_path)
        try:
            port = standby.ops_server.port
            active = StandbyManager(make_store(), "http://a",
                                    [f"http://127.0.0.1:{port}"],
                                    timeout=5.0)
            active.is_leader, active.lease_epoch = True, 7
            fill_store(active.store, n=4)
            groups, epoch = active.store.snapshot_state()
            active.capture(groups, epoch)
            summary = active.dispatch()
            assert summary["failed"] == [] and active.replicated_total == 1
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/ha-status") as r:
                st = json.loads(r.read())
            assert st["receives_total"] == 1 and not st["is_leader"]
            assert st["received_series_total"] == summary["series"]
            assert st["shadow_series_held"] == summary["series"]
        finally:
            standby.shutdown()

    @pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
    def test_interop_replicate_then_promote(self, tmp_path, direction):
        """One package's active replicates to the other's standby over
        HTTP; the standby's promotion merges it (counters excluded): mass
        within rtol 1e-6, registers exact, gauges exact."""
        FileLease(str(tmp_path / "lease")).acquire_or_renew("other", 3600)
        if direction == "jax->port":
            standby = standby_server(tmp_path)
            src = JStore(initial_capacity=32, chunk=128)
            _, wtotal = fill_store(src, key=JKey)
            active = jsb.StandbyManager(
                src, "http://ja", [f"http://127.0.0.1:"
                                   f"{standby.ops_server.port}"],
                timeout=10.0)
        else:
            standby = jax_standby_server(tmp_path)
            src = make_store()
            _, wtotal = fill_store(src)
            active = StandbyManager(
                src, "http://pa", [f"http://127.0.0.1:"
                                   f"{standby.ops_server.port}"],
                timeout=10.0)
        try:
            active.is_leader, active.lease_epoch = True, 3
            groups, epoch = src.snapshot_state()
            active.capture(groups, epoch)
            assert active.dispatch()["failed"] == []
            assert standby.standby_manager.promote(4) > 0
            if direction == "jax->port":
                fwd = forward_of(standby.store)
                sets = {n: r for n, _, r, _ in fwd.sets}
            else:
                _, fwd, _ = standby.store.flush(
                    [0.5], JAggs.from_names(["count"]), is_local=True,
                    now=0, forward=True, columnar=False)
                sets = {n: np.asarray(r) for n, _, r, _ in fwd.sets}
            assert not [n for n, _t, _v in fwd.counters if n.startswith("m")]
            assert digest_weight(fwd) == pytest.approx(wtotal, rel=1e-6)
            assert dict((n, v) for n, _t, v in fwd.gauges) == {
                f"g{i}": i + 0.5 for i in range(10)}
            for i in range(10):
                want = np.zeros(1 << 14, np.uint8)
                want[i % 50] = 3
                assert np.array_equal(sets[f"s{i}"], want)
        finally:
            standby.shutdown()


# -- a real active / standby pair of port Servers ---------------------------------------


def pair_config(tmp_path, tag, **kw):
    return Config(statsd_listen_addresses=[], http_address="127.0.0.1:0",
                  interval="86400s", store_initial_capacity=32,
                  store_chunk=128, percentiles=[0.5],
                  aggregates=["min", "max", "count"], flush_columnar=False,
                  lease_path=f"file://{tmp_path}/lease", lease_ttl="600ms",
                  lease_renew_interval="100ms", handoff_self=tag, **kw)


def _wait(pred, timeout=30.0, what="condition"):
    deadline = time.time() + timeout
    while not pred():
        assert time.time() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def feed(store, base, n=12):
    for i in range(n):
        for v in range(8):
            store.process_metric(parse_metric(
                f"h{i}:{base + v + i}|h".encode()))
        store.process_metric(parse_metric(
            f"c{i}:{i + 1}|c|#veneurglobalonly".encode()))
        store.process_metric(parse_metric(
            f"g{i}:{base + i}|g|#veneurglobalonly".encode()))
        store.process_metric(parse_metric(f"s{i}:m{base}|s".encode()))


class TestFailover:
    def test_crash_hands_the_lease_to_a_promoting_standby(self, tmp_path):
        sby_sink = ChannelMetricSink()
        standby = Server(pair_config(tmp_path, "standby"),
                         metric_sinks=[sby_sink], device="cpu")
        active_sink = ChannelMetricSink()
        # the active takes the lease first
        FileLease(str(tmp_path / "lease")).acquire_or_renew("active", 60)
        active = None
        try:
            standby.start()
            sby = standby.standby_manager
            peer = f"127.0.0.1:{standby.ops_server.port}"
            active = Server(pair_config(tmp_path, "active",
                                        standby_peers=peer),
                            metric_sinks=[active_sink], device="cpu")
            active.start()
            _wait(lambda: active.lease_elector.is_leader, what="the lease")
            assert not standby.lease_elector.is_leader
            for interval in range(2):
                feed(active.store, 10 * interval)
                active.flush()
                active_sink.get_flush()
                _wait(lambda: sby.receives_total == interval + 1,
                      what="replication")
                assert len(standby.store.histograms) == 0
            groups = sby.shadow.latest()["active"][1]
            want_w = float(np.sum(groups["histograms"]["weights"]))
            t_kill = time.time()
            active.crash_stop()
            _wait(lambda: sby.promoted, what="the promotion")
            took = time.time() - t_kill
            assert took >= 0.3  # the ttl ran out: nothing was released
            assert standby.lease_elector.lease_epoch == 2
            snap, _ = standby.store.snapshot_state()
            assert float(np.sum(snap["histograms"]["weights"])) == \
                pytest.approx(want_w, rel=1e-6)
            standby.flush()
            rows = {m.name: m.value for m in sby_sink.get_flush()}
            assert not [n for n in rows if n.startswith("c")]
            assert {n: v for n, v in rows.items() if n.startswith("g")} == \
                {f"g{i}": 10.0 + i for i in range(12)}
            assert {n for n in rows if n.startswith("s")} == \
                {f"s{i}" for i in range(12)}
            assert rows["h3.count"] == 8.0
            # the deposed active's late replicate is fenced
            blob = encode_handoff(
                {"global_gauges": groups["global_gauges"]},
                {"kind": "replicate", "id": "late", "sender": "active",
                 "epoch": 99, "lease_epoch": 1, "incarnation": "x"},
                time.time())
            status, _, _ = sby.handle_replicate(blob)
            assert status == 409 and sby.fenced_total == 1
        finally:
            standby.shutdown()

    def test_clean_shutdown_releases_the_lease(self, tmp_path):
        server = Server(pair_config(tmp_path, "solo"), device="cpu")
        server.start()
        _wait(lambda: server.lease_elector.is_leader, what="the lease")
        assert server.standby_manager.is_leader
        server.shutdown()
        st = FileLease(str(tmp_path / "lease")).read()
        assert st.holder == "solo" and st.expired(time.time())

    def test_capture_only_while_leading_with_peers(self, tmp_path):
        server = Server(pair_config(tmp_path, "cap",
                                    standby_peers="127.0.0.1:9"),
                        device="cpu")
        sby = server.standby_manager
        taken = []
        sby.capture = lambda groups, epoch, trace_ctx=None: \
            taken.append(epoch)
        feed(server.store, 1, n=2)
        server.flush()  # a follower: no capture
        sby.is_leader = True
        feed(server.store, 2, n=2)
        server.flush()
        sby.peers = []
        feed(server.store, 3, n=2)
        server.flush()  # no peers: no capture
        assert len(taken) == 1

    def test_no_election_replicates_unconditionally(self):
        server = Server(Config(statsd_listen_addresses=[],
                               http_address="127.0.0.1:0",
                               standby_peers="127.0.0.1:9"), device="cpu")
        assert server.lease_elector is None
        assert server.standby_manager.is_leader
        assert server.standby_manager.peers == ["127.0.0.1:9"]
