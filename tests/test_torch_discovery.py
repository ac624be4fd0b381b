"""The port's discovery (``veneur_tpu_torch/discovery``) and membership-
churn faults against the JAX package's, on the CPU.

The JAX package's ``tests/test_discovery.py`` and its Consul cases of
``tests/test_proxy.py``, run on the port: ``RingWatcher`` (first
refresh, no-op refresh, diffs, keep-last-good on a failure or an empty
result, order and duplicates normalized, the single-member cases),
``FilePeersDiscoverer``, ``ConsulDiscoverer`` against a local fake
Consul HTTP server (payload parsing, 500 and a timeout keeping the last
good membership, one change a transition), ``RetryingDiscoverer``, and
the churn kinds (``mangle_members``, ``is_partitioned``). The moved
ranges are counted on the port's ``ConsistentRing`` (the port's
``RingTransition``, which the handoff routes by, is held to the JAX
package's in ``tests/test_torch_handoff.py``). Parity:
the same seed gives the same churn schedule and mangled memberships as
the JAX package's injector, and the same refresh sequence gives the
same ``MembershipChange`` diffs. Everything here is exact.
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from veneur_tpu import discovery as jdisc
from veneur_tpu.resilience import faults as jfaults
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.discovery import (ConsulDiscoverer,
                                        FilePeersDiscoverer,
                                        KubernetesDiscoverer,
                                        MembershipChange,
                                        RetryingDiscoverer, RingWatcher,
                                        StaticDiscoverer)
from veneur_tpu_torch.proxy.consistent import ConsistentRing, ring_key
from veneur_tpu_torch.resilience import RetryPolicy
from veneur_tpu_torch.resilience import faults as rfaults


class MutableDiscoverer:
    """A discoverer whose membership the test changes between refreshes."""

    def __init__(self, members):
        self.members = list(members)
        self.fail = False

    def get_destinations_for_service(self, service_name):
        if self.fail:
            raise OSError("discovery down")
        return list(self.members)


def _moved(old, new, n=200):
    """Keys of n counter series whose owner differs between two rings."""
    a, b = ConsistentRing(old), ConsistentRing(new)
    return [i for i in range(n)
            if a.get(ring_key(f"m{i}", "counter", ""))
            != b.get(ring_key(f"m{i}", "counter", ""))]


class TestRingWatcher:
    def test_first_refresh_adopts(self):
        w = RingWatcher(StaticDiscoverer(["a", "b"]), "svc")
        change = w.refresh()
        assert isinstance(change, MembershipChange)
        assert change.old == [] and change.new == ["a", "b"]
        assert w.members == ["a", "b"]

    def test_noop_refresh_returns_none(self):
        w = RingWatcher(StaticDiscoverer(["a", "b"]), "svc")
        assert w.refresh() is not None
        assert w.refresh() is None
        assert w.changes == 1 and w.refreshes == 2

    def test_membership_change_diff(self):
        d = MutableDiscoverer(["a", "b"])
        w = RingWatcher(d, "svc")
        w.refresh()
        d.members = ["a", "b", "c"]
        change = w.refresh()
        assert change.added == ["c"] and change.removed == []
        d.members = ["a", "c"]
        change = w.refresh()
        assert change.added == [] and change.removed == ["b"]

    def test_failure_keeps_last_good(self):
        d = MutableDiscoverer(["a", "b"])
        w = RingWatcher(d, "svc")
        w.refresh()
        d.fail = True
        assert w.refresh() is None
        assert w.members == ["a", "b"] and w.failures == 1

    def test_empty_result_keeps_last_good(self):
        d = MutableDiscoverer(["a", "b"])
        w = RingWatcher(d, "svc")
        w.refresh()
        d.members = []
        assert w.refresh() is None
        assert w.members == ["a", "b"] and w.failures == 1

    def test_duplicate_and_order_normalized(self):
        d = MutableDiscoverer(["b", "a", "b"])
        w = RingWatcher(d, "svc")
        assert w.refresh().new == ["a", "b"]
        d.members = ["a", "b"]
        assert w.refresh() is None

    def test_single_member_degenerate(self):
        d = MutableDiscoverer(["a"])
        w = RingWatcher(d, "svc")
        w.refresh()
        d.members = ["a", "b"]
        change = w.refresh()
        assert 0 < len(_moved(change.old, change.new)) < 200
        d.members = ["a"]
        change = w.refresh()
        ring = ConsistentRing(change.new)
        assert all(ring.get(ring_key(f"m{i}", "counter", "")) == "a"
                   for i in range(50))

    def test_diffs_equal_the_jax_watchers(self):
        """The same refresh sequence through both packages' watchers
        gives the same transitions."""
        seq = [["a", "b"], ["a", "b"], ["b", "c", "a"], [], ["c"],
               ["c", "d", "d"]]
        out = []
        for mod in (jdisc, None):
            d = MutableDiscoverer(seq[0])
            w = (mod.RingWatcher if mod else RingWatcher)(d, "svc")
            got = []
            for members in seq:
                d.members = members
                c = w.refresh()
                got.append(None if c is None else (c.old, c.new, c.added,
                                                   c.removed))
            out.append((got, w.members, w.failures, w.changes))
        assert out[0] == out[1]


class TestFilePeers:
    def test_reads_one_address_per_line(self, tmp_path):
        p = tmp_path / "peers"
        p.write_text("# the global fleet\na:8127\n\nb:8127\n")
        d = FilePeersDiscoverer(str(p))
        assert d.get_destinations_for_service("x") == ["a:8127", "b:8127"]

    def test_missing_file_keeps_last_good_through_watcher(self, tmp_path):
        p = tmp_path / "peers"
        p.write_text("a:8127\n")
        w = RingWatcher(FilePeersDiscoverer(str(p)), "svc")
        assert w.refresh().new == ["a:8127"]
        p.unlink()
        assert w.refresh() is None
        assert w.members == ["a:8127"]

    def test_rewrite_is_one_transition(self, tmp_path):
        p = tmp_path / "peers"
        p.write_text("a:8127\n")
        w = RingWatcher(FilePeersDiscoverer(str(p)), "svc")
        w.refresh()
        p.write_text("a:8127\nb:8127\n")
        change = w.refresh()
        assert change.added == ["b:8127"]
        assert w.refresh() is None


class _FakeConsul(BaseHTTPRequestHandler):
    """GET /v1/health/service/<name>?passing off ``server.payload``: a list
    renders as Consul health JSON, an int as that HTTP status, "hang"
    sleeps past the client's timeout."""

    def log_message(self, *a):
        pass

    def do_GET(self):
        payload = self.server.payload
        self.server.paths.append(self.path)
        if payload == "hang":
            time.sleep(1.0)
            payload = 500
        if isinstance(payload, int):
            self.send_response(payload)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        body = json.dumps(payload).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture()
def fake_consul():
    httpd = HTTPServer(("127.0.0.1", 0), _FakeConsul)
    httpd.payload = []
    httpd.paths = []
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd
    httpd.shutdown()
    httpd.server_close()


def _entries(pairs):
    return [{"Service": {"Address": a, "Port": p}} for a, p in pairs]


class TestConsul:
    def _url(self, fake):
        return f"http://127.0.0.1:{fake.server_address[1]}"

    def test_parses_health_entries_like_jax(self, fake_consul):
        fake_consul.payload = [
            {"Node": {"Address": "10.0.0.1"},
             "Service": {"Address": "10.1.1.1", "Port": 8127}},
            {"Node": {"Address": "10.0.0.2"},
             "Service": {"Address": "", "Port": 8127}},
            {"Node": {"Address": "10.0.0.3"}, "Service": {}},
            {"Service": {"Address": "", "Port": 1}},
        ]
        got = ConsulDiscoverer(self._url(fake_consul)) \
            .get_destinations_for_service("veneur-global")
        assert got == ["http://10.1.1.1:8127", "http://10.0.0.2:8127",
                       "http://10.0.0.3"]
        assert got == jdisc.ConsulDiscoverer(self._url(fake_consul)) \
            .get_destinations_for_service("veneur-global")
        assert fake_consul.paths[0] == \
            "/v1/health/service/veneur-global?passing"

    def test_error_propagates(self, fake_consul):
        fake_consul.payload = 500
        with pytest.raises(Exception):
            ConsulDiscoverer(self._url(fake_consul)) \
                .get_destinations_for_service("veneur-global")

    def test_healthy_refresh_adopts_passing_instances(self, fake_consul):
        fake_consul.payload = _entries([("10.0.0.1", 8127),
                                        ("10.0.0.2", 8127)])
        w = RingWatcher(ConsulDiscoverer(self._url(fake_consul)),
                        "veneur-global")
        change = w.refresh()
        assert change.new == ["http://10.0.0.1:8127",
                              "http://10.0.0.2:8127"]
        assert w.members == change.new

    def test_consul_500_and_timeout_keep_last_good(self, fake_consul):
        fake_consul.payload = _entries([("10.0.0.1", 8127)])
        w = RingWatcher(ConsulDiscoverer(self._url(fake_consul),
                                         timeout=0.2), "veneur-global")
        w.refresh()
        fake_consul.payload = 500
        assert w.refresh() is None
        fake_consul.payload = "hang"
        assert w.refresh() is None
        assert w.members == ["http://10.0.0.1:8127"] and w.failures == 2

    def test_change_fires_once_per_transition(self, fake_consul):
        fake_consul.payload = _entries([("10.0.0.1", 8127)])
        w = RingWatcher(ConsulDiscoverer(self._url(fake_consul)),
                        "veneur-global")
        w.refresh()
        fake_consul.payload = _entries([("10.0.0.1", 8127),
                                        ("10.0.0.2", 8127)])
        change = w.refresh()
        assert change.added == ["http://10.0.0.2:8127"]
        assert change.removed == []
        assert w.refresh() is None
        assert w.changes == 2
        assert 0 < len(_moved(change.old, change.new)) < 200


def test_retrying_discoverer_retries_then_raises():
    class Flaky:
        calls = 0

        def get_destinations_for_service(self, name):
            Flaky.calls += 1
            if Flaky.calls < 3:
                raise OSError("flaky")
            return ["a"]

    seen = []
    d = RetryingDiscoverer(Flaky(), RetryPolicy(max_attempts=3,
                                                base_interval=0.001),
                           budget=5.0, on_retry=lambda *a: seen.append(a))
    assert d.get_destinations_for_service("svc") == ["a"]
    assert d.retries == 2 and len(seen) == 2
    dead = RetryingDiscoverer(MutableDiscoverer([]), RetryPolicy(
        max_attempts=2, base_interval=0.001), budget=5.0)
    dead._inner.fail = True
    with pytest.raises(OSError):
        dead.get_destinations_for_service("svc")
    assert dead.retries == 1


def test_kubernetes_needs_the_cluster(monkeypatch):
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    with pytest.raises(RuntimeError, match="Kubernetes"):
        KubernetesDiscoverer()


class TestChurnFaults:
    def test_churn_kinds_ported_apart_from_the_transport_kinds(self):
        for k in rfaults.CHURN_KINDS:
            assert k not in rfaults.ALL_KINDS
            assert k in rfaults.KNOWN_KINDS
        assert rfaults.CHURN_KINDS == jfaults.CHURN_KINDS
        assert rfaults.PARTITION_INTERVALS == jfaults.PARTITION_INTERVALS
        # a Server's config takes them, as the JAX package's does: a
        # global's handoff watcher arms a churn injector of its own
        cfg = Config(hostname="h", fault_injection_rate=0.5,
                     fault_injection_kinds="member_add")
        inj = rfaults.armed_for(cfg, rfaults.CHURN_KINDS)
        assert inj.kinds == ("member_add",)
        assert rfaults.armed_for(cfg, rfaults.INGEST_KINDS) is None

    @pytest.mark.parametrize("seed", [7, 8])
    def test_seeded_schedules_equal_the_jax_injectors(self, seed):
        """Same seed, same kinds, same refreshes: the same mangled
        memberships and the same partitions as the JAX package's."""
        members = ["m1", "m2", "m3"]
        out = []
        for mod in (jfaults, rfaults):
            inj = mod.FaultInjector(0.5, seed=seed, kinds=mod.CHURN_KINDS)
            seq = []
            for _ in range(30):
                got = inj.mangle_members("discovery.refresh", members)
                seq.append((got, [m for m in members
                                  if inj.is_partitioned(m)]))
            out.append((seq, inj.injected, inj.calls))
        assert out[0] == out[1]

    def test_member_add_appends_synthetic(self):
        inj = rfaults.FaultInjector(1.0, seed=1,
                                    kinds=(rfaults.KIND_MEMBER_ADD,))
        out = inj.mangle_members("discovery.refresh", ["a", "b"])
        assert out[:2] == ["a", "b"] and len(out) == 3
        assert out[2].startswith("fault://injected-")

    def test_member_remove_never_empties(self):
        inj = rfaults.FaultInjector(1.0, seed=2,
                                    kinds=(rfaults.KIND_MEMBER_REMOVE,))
        assert len(inj.mangle_members("discovery.refresh", ["a", "b"])) == 1
        assert inj.mangle_members("discovery.refresh", ["a"]) == ["a"]

    def test_partition_blackholes_then_heals(self):
        inj = rfaults.FaultInjector(1.0, seed=3,
                                    kinds=(rfaults.KIND_PARTITION,))
        members = ["a", "b", "c"]
        assert inj.mangle_members("discovery.refresh", members) == members
        hit = [m for m in members if inj.is_partitioned(m)]
        assert len(hit) == 1
        inj.rate = 0.0
        for _ in range(rfaults.PARTITION_INTERVALS):
            assert inj.is_partitioned(hit[0])
            inj.mangle_members("discovery.refresh", members)
        assert not inj.is_partitioned(hit[0])

    def test_transport_hook_passes_churn_through(self):
        inj = rfaults.FaultInjector(1.0, seed=4, kinds=rfaults.CHURN_KINDS)
        inj.maybe_fail("forward.http")  # must not raise

    def test_watcher_applies_churn(self):
        inj = rfaults.FaultInjector(1.0, seed=5,
                                    kinds=(rfaults.KIND_MEMBER_ADD,))
        w = RingWatcher(StaticDiscoverer(["a", "b"]), "svc", injector=inj)
        change = w.refresh()
        assert any(m.startswith("fault://") for m in change.new)

    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError):
            rfaults.FaultInjector(0.1, kinds=("member_addd",))
