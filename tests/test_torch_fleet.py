"""The port's fleet routing and mesh configuration against the JAX
package's, on the CPU.

* Ownership: ``ring_key``, the consistent ring, ``ShardRouter.shard_for``,
  ``ShardPlacement`` (assign, grow, perm, to_phys, occupancy) and
  ``route_stack`` equal the JAX package's key for key and row for row.
* ``build_mesh``, ``fleet_snapshot``, ``sum_shard_occupancy`` and
  ``balance_ratio`` against the JAX package's on the same store traffic.
* The config surface: ``mesh_enabled`` and ``mesh_hosts`` load; slab or
  tiered with a mesh, a mesh on a local and a mesh over two distinct
  devices are refused.
* The id contract of the mesh groups: a cached row survives a grow, and
  an in-place flush resets the placement.
* Two port locals into a mesh global ``Server`` (4 x 2 on the CPU) over
  HTTP and ``native://``: its rows equal a dense global's fed the same
  forwards, percentiles within rtol 1e-5 (the JAX package's
  mesh-against-single-device bound), everything else exact.
"""

import socket
import time

import numpy as np
import pytest
import torch

from veneur_tpu import fleet as jfleet
from veneur_tpu.config import Config as JConfig
from veneur_tpu.core import store as jstore
from veneur_tpu.fleet import router as jrouter
from veneur_tpu.parallel.mesh import fleet_mesh as jfleet_mesh
from veneur_tpu.proxy import consistent as jconsistent
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.samplers.intermetric import HistogramAggregates as JHAggs
from veneur_tpu_torch import fleet as tfleet
from veneur_tpu_torch import flusher as tflusher
from veneur_tpu_torch.config import Config, UnsupportedConfig, \
    config_from_dict
from veneur_tpu_torch.core import store as tstore
from veneur_tpu_torch.core.mesh_store import MeshDigestGroup
from veneur_tpu_torch.fleet import router as trouter
from veneur_tpu_torch.parallel.mesh import ShardMesh, fleet_mesh
from veneur_tpu_torch.proxy import consistent as tconsistent
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates as THAggs
from veneur_tpu_torch.samplers.parser import MetricKey
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

CPU = torch.device("cpu")
PCTS = [0.5, 0.9, 0.99]
AGGS = ["min", "max", "count", "sum"]


def _mesh(hosts=2):
    return fleet_mesh([CPU] * 8, hosts=hosts)


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    types = ["counter", "gauge", "histogram", "timer", "set"]
    out = []
    for i in range(n):
        tags = ",".join(sorted(f"t{j}:{int(rng.integers(0, 9))}"
                               for j in range(int(rng.integers(0, 3)))))
        out.append((f"m.{int(rng.integers(0, 1 << 30))}.{i}",
                    types[i % len(types)], tags))
    return out


# -- ownership ---------------------------------------------------------------


def test_ring_key_and_ring_equal_jax():
    keys = _keys(500)
    assert all(tconsistent.ring_key(*k) == jconsistent.ring_key(*k)
               for k in keys)
    members = [f"10.0.0.{i}:8127" for i in range(7)]
    tr, jr = (tconsistent.ConsistentRing(members),
              jconsistent.ConsistentRing(members))
    rk = [jconsistent.ring_key(*k) for k in keys]
    assert tr.get_many(rk) == jr.get_many(rk)
    tr.set_members(members[:5])
    jr.set_members(members[:5])
    assert [tr.get(k) for k in rk] == [jr.get(k) for k in rk]
    assert tr.version == jr.version


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_shard_router_equals_jax(shards):
    tr, jr = trouter.ShardRouter(shards), jrouter.ShardRouter(shards)
    got = [tr.shard_for(*k) for k in _keys(2000, seed=shards)]
    assert got == [jr.shard_for(*k) for k in _keys(2000, seed=shards)]
    if shards > 1:
        assert len(set(got)) == shards


def test_shard_placement_equals_jax():
    """assign, full, grow, perm, to_phys and occupancy row for row, with
    growth whenever the routed shard is full (the groups' rule)."""
    router = trouter.ShardRouter(4)
    places = (trouter.ShardPlacement(4, 8), jrouter.ShardPlacement(4, 8))
    grows = 0
    for i, key in enumerate(_keys(300, seed=5)):
        shard = router.shard_for(*key)
        while places[0].full(shard):
            assert places[1].full(shard)
            for pl in places:
                pl.grow()
            grows += 1
        assert places[0].assign(i, shard) == places[1].assign(i, shard)
    assert grows >= 3
    t, j = places
    np.testing.assert_array_equal(t.perm(), j.perm())
    np.testing.assert_array_equal(t.perm(17), j.perm(17))
    rows = np.array([0, 5, 299, 300, 1000, t.capacity], np.int32)
    np.testing.assert_array_equal(t.to_phys(rows, t.capacity),
                                  j.to_phys(rows, j.capacity))
    assert t.occupancy() == j.occupancy()
    assert (t.capacity, t.block, len(t)) == (j.capacity, j.block, len(j))
    np.testing.assert_array_equal(
        trouter.inverse_perm(t.perm(), t.capacity),
        jrouter.inverse_perm(j.perm(), j.capacity))


def test_route_stack_equals_jax():
    rng = np.random.default_rng(9)
    rows = np.sort(rng.integers(0, 64, 300)).astype(np.int32)
    rows[-5:] = 64  # padding rows clamp to the last shard
    shard = np.minimum(rows // 16, 3)
    a = rng.normal(0, 1, 300).astype(np.float32)
    b = rng.integers(0, 9, (300, 4)).astype(np.int8)
    for width in (8, 256):
        got = trouter.route_stack(4, shard, rows, [a, b], 64, width)
        want = jrouter.route_stack(4, shard, rows, [a, b], 64, width)
        np.testing.assert_array_equal(got[0], want[0])
        for g, w in zip(got[1], want[1]):
            np.testing.assert_array_equal(g, w)


# -- mesh construction and the mesh section ------------------------------------


def test_fleet_mesh_shapes():
    assert _mesh().shape == dict(jfleet_mesh(hosts=2).shape)
    assert fleet_mesh([CPU] * 8).shape == dict(jfleet_mesh().shape)
    assert fleet_mesh([CPU] * 6, hosts=3).shape == {"series": 2,
                                                    "hosts": 3}
    with pytest.raises(ValueError, match="divisible"):
        fleet_mesh([CPU] * 8, hosts=3)
    with pytest.raises(UnsupportedConfig, match="distinct"):
        fleet_mesh([torch.device("cpu"), torch.device("meta")])


def test_build_mesh_follows_mesh_hosts():
    for hosts, n, want in ((0, 8, (4, 2)), (4, 8, (2, 4)), (0, 1, (1, 1)),
                           (0, 3, (3, 1))):
        cfg = Config(hostname="h", mesh_enabled=True, mesh_hosts=hosts)
        mesh = tfleet.build_mesh(cfg, [CPU] * n)
        assert (mesh.series, mesh.hosts) == want
        assert mesh.device == CPU
    with pytest.raises(ValueError, match="divisible"):
        tfleet.build_mesh(Config(hostname="h", mesh_enabled=True,
                                 mesh_hosts=2), [CPU])


def _fleet_lines(seed=2):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(40):
        lines += [f"fl.h{i}:{v:.4f}|h".encode()
                  for v in rng.normal(50 + i, 4, 6)]
    lines += [f"fl.c{i}:{i + 1}|c".encode() for i in range(30)]
    lines += [f"fl.g{i}:{i}|g|#veneurglobalonly".encode() for i in range(9)]
    lines += [f"fl.s{i % 7}:m{i}|s".encode() for i in range(60)]
    lines += [f"fl.k{i % 3}:x{i % 5}|s|#veneurtopk".encode()
              for i in range(20)]
    return lines


def test_fleet_snapshot_equals_jax():
    jmesh = jfleet_mesh(hosts=2)
    js = jstore.MetricStore(initial_capacity=16, chunk=64, mesh=jmesh,
                            topk_width=1 << 10, topk_k=8)
    ts = tstore.MetricStore(initial_capacity=16, chunk=64, mesh=_mesh(),
                            topk_width=1 << 10, topk_k=8)
    assert tfleet.fleet_snapshot(tstore.MetricStore(
        initial_capacity=16, device="cpu")) == {}
    for ln in _fleet_lines():
        js.process_metric(jparser.parse_metric(ln))
        ts.process_metric(tparser.parse_metric(ln))
    got, want = tfleet.fleet_snapshot(ts), jfleet.fleet_snapshot(js)
    # the JAX store's self-telemetry group is not placed: no difference
    assert got == want
    occ = tfleet.sum_shard_occupancy(
        getattr(ts, g) for g in ts._GEN_GROUPS)
    assert occ == got["shard_occupancy"] and sum(occ) == 40 + 30 + 9 + 7 + 3
    assert tfleet.balance_ratio(occ) == jfleet.balance_ratio(occ)
    assert tfleet.balance_ratio([0, 0]) == 1.0
    # the swap stamps the retired interval's occupancy
    ts.flush(PCTS, THAggs.from_names(AGGS), 1)
    js.flush(PCTS, JHAggs.from_names(AGGS), is_local=False, now=1)
    assert ts.last_fleet_occupancy == js.last_fleet_occupancy == occ
    assert tfleet.fleet_snapshot(ts)["groups"]["histograms"]["rows"] == 0


# -- configuration -------------------------------------------------------------


def test_config_accepts_mesh_keys():
    cfg = config_from_dict({"hostname": "h", "mesh_enabled": True,
                            "mesh_hosts": 2})
    assert cfg.mesh_enabled and cfg.mesh_hosts == 2
    jcfg = JConfig(hostname="h", mesh_enabled=True, mesh_hosts=2)
    assert (cfg.mesh_enabled, cfg.mesh_hosts) == (jcfg.mesh_enabled,
                                                  jcfg.mesh_hosts)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(digest_storage="slab"), ValueError, "slab"),
    (dict(digest_storage="tiered", forward_address="http://127.0.0.1:1"),
     ValueError, "forward_address"),
    (dict(forward_address="http://127.0.0.1:1"), ValueError,
     "forward_address"),
    (dict(mesh_hosts=-1), ValueError, "mesh_hosts")],
    ids=["slab", "tiered", "local", "hosts"])
def test_config_refusals(kw, exc, match):
    with pytest.raises(exc, match=match):
        Config(hostname="h", mesh_enabled=True, **kw)


def test_store_and_server_refusals():
    with pytest.raises(ValueError, match="slab"):
        tstore.MetricStore(mesh=_mesh(), digest_storage="slab")
    # tiered is no refusal: it builds the mesh tiered store for the
    # mesh's groups (the local-only ones stay single-card tiered)
    from veneur_tpu_torch.core.tiered import TieredDigestGroup
    from veneur_tpu_torch.fleet.mesh_tiered import MeshTieredDigestGroup

    ms = tstore.MetricStore(mesh=_mesh(), digest_storage="tiered")
    assert type(ms.histograms) is MeshTieredDigestGroup
    assert type(ms.local_histograms) is TieredDigestGroup
    with pytest.raises(ValueError, match="mesh"):
        tstore.MetricStore(mesh=ShardMesh(4, 2, "cpu"), device="meta")
    with pytest.raises(ValueError, match="mesh_enabled"):
        Server(Config(hostname="h"), mesh=_mesh(), device="cpu")


def test_server_builds_its_mesh_store():
    server = Server(Config(hostname="h", mesh_enabled=True, mesh_hosts=1),
                    device="cpu")
    assert isinstance(server.store.histograms, MeshDigestGroup)
    assert server.store.mesh.shape == {"series": 1, "hosts": 1}
    assert not isinstance(server.store.local_histograms, MeshDigestGroup)
    server = Server(Config(hostname="h", mesh_enabled=True, mesh_hosts=2),
                    device="cpu", mesh=_mesh())
    assert server.store.mesh.shape == {"series": 4, "hosts": 2}
    assert server.store.timers.mesh is server.store.mesh


# -- the id contract -------------------------------------------------------------


def test_cached_rows_survive_grow():
    g = MeshDigestGroup(_mesh(), 8, 16, 100.0, trouter.ShardRouter(4))
    r0 = g._row(MetricKey(name="cache.h0", type="histogram"), [])
    old_cap = g.capacity
    for i in range(60):
        g._row(MetricKey(name=f"cache.x{i}", type="histogram"), [])
    assert g.capacity > old_cap
    g.sample_many(np.full(5, r0, np.int32), np.full(5, 7.0, np.float32),
                  np.ones(5, np.float32))
    interner, out = g.flush([0.5])
    assert interner.names[r0] == "cache.h0"
    assert out["count"][r0] == 5.0
    assert out["count"].sum() == 5.0


def test_inplace_flush_resets_placement():
    router = trouter.ShardRouter(4)
    g = MeshDigestGroup(_mesh(), 16, 32, 100.0, router)
    for i in range(10):
        g.sample(MetricKey(name=f"gen1.h{i}", type="histogram"), [], 1.0,
                 1.0)
    g.flush([0.5])
    assert len(g.placement) == 0
    assert sum(g.placement.occupancy()["per_shard"]) == 0
    g._row(MetricKey(name="gen2.h0", type="histogram"), [])
    want = router.shard_for("gen2.h0", "histogram", "")
    assert g.placement.occupancy()["per_shard"][want] == 1


# -- two locals into a mesh global Server ----------------------------------------


def _wait(cond, timeout=60.0):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, "timed out"
        time.sleep(0.01)


def _local_lines(seed):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(24):
        lines += [f"srv.lat{i}:{v:.4f}|ms".encode()
                  for v in rng.gamma(2.0, 30.0, 40)]
    lines += [f"srv.c{i}:{i + seed}|c|#veneurglobalonly".encode()
              for i in range(12)]
    lines += [f"srv.s{i % 5}:m{int(rng.integers(0, 400))}|s".encode()
              for i in range(150)]
    return lines


@pytest.fixture(scope="module")
def globals_pair():
    """A mesh global Server (4 x 2 on the CPU) and a dense one, each with
    HTTP /import and native:// and a channel sink."""
    out = {}
    for label, mesh in (("mesh", _mesh()), ("dense", None)):
        sink = ChannelMetricSink()
        server = Server(Config(http_address="127.0.0.1:0",
                               native_import_address="127.0.0.1:0",
                               interval="3600s", percentiles=PCTS,
                               aggregates=AGGS, hostname="g",
                               store_initial_capacity=16, store_chunk=256,
                               mesh_enabled=mesh is not None,
                               mesh_hosts=2 if mesh else 0),
                        metric_sinks=[sink], device="cpu", mesh=mesh)
        server.start()
        out[label] = (server, sink)
    try:
        yield out
    finally:
        for server, _ in out.values():
            server.shutdown()


def _forward_two_locals(glob, lane: str):
    """Two port locals (UDP in) forward to ``glob`` over ``lane``; the
    global then flushes. Returns its rows but the servers' own
    self-metrics (``veneur.*``: each flush's span re-enters its server,
    and a local's final flush forwards its ``veneur.*`` timers), and the
    names the global's flush swap had placed on the mesh."""
    server, sink = glob
    if lane == "http":
        address = f"http://127.0.0.1:{server.ops_server.port}"
    else:
        address = f"native://127.0.0.1:{server.native_import_server.port}"
    # every metric a local forwarded (its final flush's too) is merged
    # before the global flushes
    imported0 = server.imported_metrics + server.import_errors
    sent = 0
    for seed in (1, 2):
        local = Server(Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                              interval="3600s", percentiles=PCTS,
                              aggregates=AGGS, hostname="l",
                              forward_address=address,
                              forward_timeout="60s"),
                       metric_sinks=[ChannelMetricSink()], device="cpu")
        local.start()
        try:
            lines = _local_lines(seed)
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
                for i in range(0, len(lines), 8):
                    tx.sendto(b"\n".join(lines[i:i + 8]),
                              ("127.0.0.1", local.statsd_addrs[0][1]))
            _wait(lambda: local.store.processed == len(lines))
            tflusher.flush_once(local)
            assert local.wait_forward(60) is True
        finally:
            local.shutdown()
        sent += local.forwarder.forwarded
    if lane == "http":
        _wait(lambda: server.imported_metrics + server.import_errors
              - imported0 == sent)
    placed = []
    store = server.store
    swap = store._swap_generation

    def recording_swap():
        gen = swap()
        placed.extend(n for attr in store._GEN_GROUPS
                      for g in (getattr(gen, attr),)
                      if getattr(g, "placement", None) is not None
                      for n in g.interner.names)
        return gen

    store._swap_generation = recording_swap
    try:
        tflusher.flush_once(server)
    finally:
        store._swap_generation = swap
    return {(m.name, tuple(m.tags)): m.value
            for m in sink.get_flush(timeout=30)
            if not m.name.startswith("veneur.")}, placed


@pytest.mark.parametrize("lane", ["http", "native"])
def test_two_locals_into_mesh_global(globals_pair, lane):
    """The mesh global's rows equal the dense global's on the same two
    forwards: percentiles within rtol 1e-5, counters, counts, extrema and
    set estimates exact; the mesh store re-merged nothing."""
    mesh_rows, placed = _forward_two_locals(globals_pair["mesh"], lane)
    dense_rows, _ = _forward_two_locals(globals_pair["dense"], lane)
    assert set(mesh_rows) == set(dense_rows)
    assert sum(1 for name, _ in mesh_rows if "percentile" in name) == 72
    for key, want in dense_rows.items():
        got = mesh_rows[key]
        if "percentile" in key[0]:
            assert got == pytest.approx(want, rel=1e-5), key
        else:
            assert got == want, key
    assert mesh_rows[("srv.c3", ())] == 3 + 1 + 3 + 2
    store = globals_pair["mesh"][0].store
    assert store.compute.requeued_total == store.compute.lost_total == 0
    assert sum(store.last_fleet_occupancy) == len(placed)
    assert sum(not n.startswith("veneur.") for n in placed) == 24 + 12 + 5
