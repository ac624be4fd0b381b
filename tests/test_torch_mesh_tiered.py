"""The port's mesh tiered store (``veneur_tpu_torch/fleet/mesh_tiered.py``:
``mesh_enabled`` with ``digest_storage: tiered``) against the JAX
package's ``MeshTieredDigestGroup`` and the port's single-card tiered
store, on the CPU (the port's 4 x 2 and 8 x 1 meshes of one device; the
JAX mesh on the conftest's 8 virtual devices).

* Against the port's single-card tiered store: on an 8 x 1 mesh whose
  series fit one pool slab (the guard sees the same chunks, and the bank
  takes no host slices) the rows are EQUAL, percentiles bit for bit; on
  a 4 x 2 mesh every count is exact and the percentiles within rel 1e-4,
  the JAX package's own oracle bound (``tests/test_fleet.py``); the
  same promotions either way.
* Against the JAX ``MeshTieredDigestGroup`` on the same seeded lines:
  counts exact, percentiles within 0.02 x (max - min) (the kernels'
  Pallas rung against the port's plain versions), the same promotions
  and shard occupancy.
* The sharded pool's guard: the drain decision summed over the shard
  blocks equals the single-card decision; each compaction is ONE K2
  launch over the whole blocked slab at merge width 32, as many as the
  single-card pool takes.
* Placement and lifecycle: the slot-mode bank (no placement, the owner's
  slots), a promotion batch across a bank grow (counts conserved), the
  checkpoint round trip into a fresh mesh tiered store, a dense store
  and the JAX package's (counts exact), fleet occupancy, and a mesh
  tiered Server that boots and flushes.
"""

import time

import numpy as np
import pytest
import torch

from veneur_tpu.config import Config as JConfig
from veneur_tpu.core.store import MetricStore as JStore
from veneur_tpu.parallel.mesh import fleet_mesh as jfleet_mesh
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.samplers.intermetric import HistogramAggregates as JAggs
from veneur_tpu_torch import fleet as tfleet
from veneur_tpu_torch.config import Config, config_from_dict
from veneur_tpu_torch.core.mesh_store import MeshDigestGroup
from veneur_tpu_torch.core.store import MetricStore
from veneur_tpu_torch.core.tiered import (TieredDigestGroup,
                                          _guard_drain_pool,
                                          _init_pool_slab,
                                          _pool_scatter_samples)
from veneur_tpu_torch.fleet import ShardRouter
from veneur_tpu_torch.fleet.mesh_tiered import (MeshTieredDigestGroup,
                                                _mesh_guard_drain)
from veneur_tpu_torch.ops import tdigest_cuda as tc
from veneur_tpu_torch.parallel.mesh import fleet_mesh
from veneur_tpu_torch.samplers import parser as p
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

CPU = torch.device("cpu")
AGGS = ["min", "max", "count"]
AGG = HistogramAggregates.from_names(AGGS)
QS = [0.5, 0.99]
TIER_KW = dict(digest_storage="tiered", slab_rows=64,
               tier_promote_samples=48, tier_promote_intervals=1,
               tier_demote_intervals=2)


def _mesh(hosts=2):
    return fleet_mesh([CPU] * 8, hosts=hosts)


def tiered_store(mesh=None, **kw):
    args = dict(initial_capacity=32, chunk=128, **TIER_KW)
    args.update(kw)
    if mesh is None:
        return MetricStore(device="cpu", **args)
    return MetricStore(mesh=mesh, **args)


def lines(rng, n_hist=24, hot_every=3):
    """Mixed hot and cold traffic (the JAX package's ``_fill``): every
    ``hot_every``-th series crosses the promotion bar; global counters
    and sets beside them. Returns (lines, {series: samples})."""
    out, counts = [], {}
    for i in range(n_hist):
        n = 64 if i % hot_every == 0 else 8
        counts[f"fleet.h{i}"] = counts.get(f"fleet.h{i}", 0) + n
        out += [f"fleet.h{i}:{v:.4f}|h".encode()
                for v in rng.normal(100 + 10 * i, 5 + i, n)]
    out += [f"fleet.c{i}:{i + 1}|c|#veneurglobalonly".encode()
            for i in range(8)]
    out += [f"fleet.s{i}:m{m}|s".encode() for i in range(4)
            for m in range(15 * (i + 1))]
    return out, counts


def feed(store, data, parser=p):
    for ln in data:
        store.process_metric(parser.parse_metric(ln))


def rows(store):
    out, _ = store.flush(QS, AGG, int(time.time()))
    return {m.name: m.value for m in out.to_intermetrics()}


def jax_rows(store):
    out, _, _ = store.flush(QS, JAggs.from_names(AGGS), is_local=False,
                            now=int(time.time()), columnar=False)
    return {m.name: m.value for m in out}


# -- configuration and construction --------------------------------------------


def test_mesh_plus_tiered_validates():
    cfg = config_from_dict({"digest_storage": "tiered",
                            "mesh_enabled": True})
    assert cfg.mesh_enabled and cfg.digest_storage == "tiered"
    jcfg = JConfig(digest_storage="tiered", mesh_enabled=True)
    jcfg.apply_defaults()
    jcfg.validate()


def test_store_builds_mesh_tiered_groups():
    store = tiered_store(_mesh())
    for name in ("histograms", "timers"):
        g = getattr(store, name)
        assert type(g) is MeshTieredDigestGroup
        assert g.router is store.shard_router
        assert g.slab_rows % g.shards == 0
        assert type(g._dense) is MeshDigestGroup and g._dense.placement \
            is None
    assert type(store.local_histograms) is TieredDigestGroup
    assert type(store.histograms.fresh()) is MeshTieredDigestGroup


# -- the oracles ------------------------------------------------------------------


def test_eight_by_one_one_slab_equals_single_card_bit_for_bit():
    data, counts = lines(np.random.default_rng(7), n_hist=40)
    m, s = (tiered_store(_mesh(hosts=1), slab_rows=256),
            tiered_store(slab_rows=256))
    feed(m, data)
    feed(s, data)
    mr, sr = rows(m), rows(s)
    assert mr == sr
    for name, n in counts.items():
        assert mr[f"{name}.count"] == float(n)
    assert m.histograms.directory.promotions == \
        s.histograms.directory.promotions > 0


def test_rows_off_the_twin_are_those_whose_drain_schedule_differs(
        monkeypatch):
    """chip_smoke.py's leg (c) check at a CPU size (16,384 series on
    4 x 2, 1,024-row pool slabs, 4,096-entry staging chunks). Each
    store's pool guard drains, logged against its staging drains, give
    every series its drain schedule. A series that took the twin's
    schedule and stayed in the pool has the twin's percentiles bit for
    bit; every percentile off the twin lies in a series whose schedule
    differs (the mesh's slabs hold other series than the twin's) or that
    was promoted (the bank bins a chunk's host slices apart); and some
    series do take another schedule. The kernels' plain versions stand
    in for the launches, so the check walks the launch path it takes on
    the card; the launch counts are put back after."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "FHA_MESH_CHUNK", 4096)
    monkeypatch.setattr(chip_smoke, "FHA_MESH_FEED", 1024)
    monkeypatch.setattr(tc, "_use_kernel", lambda *a: True)
    monkeypatch.setattr(tc, "_check_kernel_inputs", lambda *a, **k: None)
    monkeypatch.setattr(tc, "launch_compress_presorted",
                        tc.compress_presorted_plain)
    monkeypatch.setattr(tc, "launch_drain_quantile", tc.drain_quantile_plain)
    with chip_smoke._uncounted(tc):
        rec = chip_smoke.run_mesh_tiered(CPU, series=1 << 14,
                                         slab_rows=1024)
    for sch in (rec["schedule0"], rec["schedule1"]):
        assert sch["same_max_rel_err"] == 0.0
        assert sch["same_exact_share"] == 1.0
        assert sch["cells_past_rtol_1e_5"] == (
            sch["cells_past_rtol_1e_5_other"]
            + sch["cells_past_rtol_1e_5_promoted"])
    assert rec["schedule0"]["other_series"] > 0
    assert rec["schedule0"]["cells_past_rtol_1e_5_other"] > 0
    assert rec["schedule1"]["promoted_series"] == 256
    assert rec["promotions"] == [256, 256]
    assert rec["pool_k2_merge_width"] == 32


def test_boot_and_flush_matches_oracle():
    """The JAX package's TestMeshTieredOracle on the port: a 4 x 2 mesh
    tiered store against the single-card tiered store, several pool
    slabs, two intervals."""
    m, s = tiered_store(_mesh()), tiered_store()
    for interval in range(2):
        data, counts = lines(np.random.default_rng(7 + interval))
        feed(m, data)
        feed(s, data)
        mr, sr = rows(m), rows(s)
        assert set(mr) == set(sr)
        for name, want in sr.items():
            assert mr[name] == pytest.approx(want, rel=1e-4, abs=1e-4), name
        for name, n in counts.items():
            assert mr[f"{name}.count"] == float(n)
    assert m.histograms.directory.promotions == \
        s.histograms.directory.promotions > 0


def test_matches_jax_mesh_tiered_store():
    """The same seeded lines into the JAX mesh tiered store (the
    conftest's 8 virtual devices, 4 x 2) and the port's: counts exact,
    percentiles within 0.02 x (max - min), the same promotions and the
    same per-shard occupancy."""
    jstore = JStore(initial_capacity=32, chunk=128,
                    mesh=jfleet_mesh(hosts=2), **TIER_KW)
    tstore = tiered_store(_mesh())
    for interval in range(2):
        data, counts = lines(np.random.default_rng(31 + interval))
        feed(tstore, data)
        feed(jstore, data, jparser)
        if interval == 0:
            occ = tfleet.fleet_snapshot(tstore)["groups"]["histograms"]
            jocc = jstore.histograms.placement.occupancy()
            assert occ["per_shard"] == jocc["per_shard"]
        tr, jr = rows(tstore), jax_rows(jstore)
        assert set(tr) == set(jr)
        for name, want in jr.items():
            base, _, suffix = name.rpartition(".")
            if suffix.endswith("percentile"):
                span = jr[f"{base}.max"] - jr[f"{base}.min"]
                assert abs(tr[name] - want) <= 0.02 * span + 1e-6, name
            else:
                assert tr[name] == want, name
        for name, n in counts.items():
            assert tr[f"{name}.count"] == float(n)
    assert tstore.histograms.directory.promotions == \
        jstore.histograms.directory.promotions > 0


# -- the sharded pool -------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_guard_decision_sums_over_blocks(seed):
    """The mesh guard's decision (masses summed per shard block, then
    over the blocks) equals the single-card guard's on the same chunk,
    and so does the drained slab."""
    rng = np.random.default_rng(seed)
    slab_rows, pk, shards = 256, 16, 4
    pools = [_init_pool_slab(slab_rows, pk, CPU) for _ in range(2)]
    for step in range(6):
        n = 512
        rows_ = torch.from_numpy(rng.integers(0, slab_rows, n))
        vals = torch.from_numpy(
            (rng.gamma(2.0, 10.0, n) + 500.0 * (step % 3 == 2))
            .astype(np.float32))
        wts = torch.ones(n)
        single = _guard_drain_pool(pools[0], rows_, vals, wts, slab_rows,
                                   pk, 14.0)
        mesh = _mesh_guard_drain(pools[1], rows_, vals, wts, slab_rows, pk,
                                 14.0, shards)
        assert single == mesh
        for pool in pools:
            _pool_scatter_samples(pool, rows_, vals, wts, slab_rows, pk,
                                  14.0)
        for a, b in zip(*pools):
            assert torch.equal(a, b)


def test_pool_compaction_is_one_launch_over_the_blocked_slab(monkeypatch):
    """With the kernel path forced (its plain version standing in), every
    pool compaction of the mesh tiered store is one K2 launch over a
    whole slab at merge width 32, and the store takes as many as the
    single-card store on the same input (one slab)."""
    monkeypatch.setattr(tc, "_use_kernel", lambda *t: True)
    calls = []

    def launch(*args):
        calls.append((args[0].shape, args[2].shape))
        return tc.compress_presorted_plain(*args)

    monkeypatch.setattr(tc, "launch_compress_presorted", launch)
    monkeypatch.setattr(tc, "launch_drain_quantile", tc.drain_quantile_plain)
    data, _ = lines(np.random.default_rng(3), n_hist=40)
    got = []
    for store in (tiered_store(_mesh(hosts=1), slab_rows=256),
                  tiered_store(slab_rows=256)):
        tc.compress_presorted.narrow32_launches = 0
        calls.clear()
        feed(store, data)
        rows(store)
        got.append((list(calls), tc.compress_presorted.narrow32_launches))
    (mcalls, mnarrow), (scalls, snarrow) = got
    pool_calls = [c for c in mcalls if c == ((256, 16), (256, 16))]
    assert pool_calls and len(pool_calls) == mnarrow
    assert mcalls == scalls and mnarrow == snarrow


# -- placement and lifecycle -------------------------------------------------------


def test_slot_mode_bank_gathers_the_owners_slots():
    bank = MeshDigestGroup(_mesh(), 16, 128, 100.0, slot_mode=True)
    assert bank.placement is None and bank.router is None
    key = p.MetricKey(name="x", type="histogram", joined_tags="")
    bank.interner.intern(key, [])
    bank._ext_rows = np.array([9], np.int64)
    bank.sample_many(np.array([9, 9], np.int64),
                     np.array([1.0, 3.0], np.float32),
                     np.ones(2, np.float32))
    _, out = bank.flush([0.5], want_stats=("pcts", "count"))
    assert out["count"].tolist() == [2.0]


def test_promotion_batch_across_bank_grow_conserves():
    """One promotion batch fills a shard's bank block mid-batch: the
    bank's blocked grow moves every slot, and the promotion must scatter
    at the post-grow slots (the JAX package's regression)."""
    g = MeshTieredDigestGroup(_mesh(), ShardRouter(4), slab_rows=64,
                              chunk=2048, promote_samples=8,
                              promote_intervals=1, dense_capacity=8)
    rng = np.random.default_rng(9)
    total = 0
    for i in range(24):
        for v in rng.normal(5 * i, 1, 16):
            g.sample(p.MetricKey(name=f"pb.h{i}", type="histogram"), [],
                     float(v), 1.0)
            total += 1
    _, out = g.flush([0.5], want_stats=("pcts", "count"))
    assert g._dense.capacity > 8
    assert float(out["count"].sum()) == float(total)


@pytest.mark.parametrize("target", ["mesh_tiered", "dense", "jax"])
def test_checkpoint_roundtrip_conserves(target):
    store = tiered_store(_mesh())
    data, counts = lines(np.random.default_rng(11), n_hist=12)
    feed(store, data)
    groups, _ = store.snapshot_state()
    if target == "jax":
        fresh = JStore(initial_capacity=32, chunk=128)
        fresh.restore_state(groups)
        by = jax_rows(fresh)
    else:
        fresh = (tiered_store(_mesh()) if target == "mesh_tiered"
                 else MetricStore(initial_capacity=32, chunk=128,
                                  device="cpu"))
        fresh.restore_state(groups)
        by = rows(fresh)
    for name, n in counts.items():
        assert by[f"{name}.count"] == float(n), name


def test_shard_occupancy_balanced_and_observable():
    store = tiered_store(_mesh())
    data, _ = lines(np.random.default_rng(3), n_hist=40)
    feed(store, data)
    snap = tfleet.fleet_snapshot(store)
    assert snap["axes"] == {"series": 4, "hosts": 2}
    occ = snap["shard_occupancy"]
    assert sum(occ) > 0 and min(occ) > 0 and snap["balance_ratio"] < 3.0
    rows(store)
    assert sum(store.last_fleet_occupancy) == sum(occ)


def test_server_boots_mesh_tiered():
    cfg = Config(statsd_listen_addresses=[], interval="86400s",
                 percentiles=QS, aggregates=["count"], mesh_enabled=True,
                 mesh_hosts=2, store_initial_capacity=32, store_chunk=128,
                 digest_storage="tiered", slab_rows=64,
                 tier_promote_samples=48, tier_promote_intervals=1,
                 flush_columnar=False)
    sink = ChannelMetricSink()
    server = Server(cfg, metric_sinks=[sink], mesh=_mesh())
    server.start()
    try:
        assert isinstance(server.store.histograms, MeshTieredDigestGroup)
        rng = np.random.default_rng(2)
        for i in range(12):
            for v in rng.normal(25, 2, 64):
                server.store.process_metric(p.parse_metric(
                    f"boot.h{i}:{v:.4f}|h".encode()))
        server.flush()
        by = {m.name: m.value for m in sink.get_flush()}
        for i in range(12):
            assert by[f"boot.h{i}.count"] == 64.0
            assert by[f"boot.h{i}.50percentile"] == pytest.approx(25, abs=2)
    finally:
        server.shutdown()


def _paced_server(series: int):
    """chip_smoke.py's mesh tiered UDP Server at a CPU size, with its
    seeded lines (``series`` histogram series x 8 samples)."""
    import chip_smoke

    server, sink, _ = chip_smoke._fha_server(
        CPU, "mt-paced", mesh=_mesh(), mesh_enabled=True, mesh_hosts=2,
        digest_storage="tiered", grpc_address="", native_import_address="")
    vals = np.round(np.random.default_rng(73).gamma(2.0, 10.0,
                                                     (series, 8)), 3)
    lines_ = [f"mts.{i}:{v}|h" for i in range(series)
              for v in vals[i].tolist()]
    return chip_smoke, server, sink, lines_


def test_udp_feed_holds_the_backlog_under_the_freeze():
    """The fault behind the mesh tiered Server's missing series on the
    card: a sender paced only on the parsed count outruns a slow merger,
    the lanes' sealed backlog crosses the low watermark, and the
    overload ladder's level 1 spills first-sight series to the overflow
    row, merged and counted but under another name (or, past the hard
    watermark, the lanes shed datagrams). A lane seals a chunk at each
    short recv batch and at each full chunk, so one burst can add many.
    Here the merger sleeps 20 ms a chunk, and the lanes seal 256-record
    chunks and hold at most 10 (level 1 at 7): the paced feed keeps the
    ladder at level 0 and every series lands with its 8 samples."""
    chip_smoke, server, sink, lines_ = _paced_server(1024)
    try:
        for lane in server.ingest_fleets[0].lanes:
            lane._max_backlog, lane._chunk = 10, 256
        real = server.store.import_lane_chunk

        def slow(chunk, res):
            time.sleep(0.02)
            return real(chunk, res)

        server.store.import_lane_chunk = slow
        assert chip_smoke._fha_udp(server, lines_) == len(lines_)
        assert server.overload.level_changes == 0
        assert server.store.histograms.spilled == 0
        blocks, _ = chip_smoke._fha_rows(server, sink, 0)
    finally:
        server.shutdown()
    names, m, sfx = blocks["mts"]
    assert len(names) == 1024
    assert np.all(m[:, sfx.index(".count")] == 8.0)


def test_udp_feed_names_a_spill():
    """Under the admission freeze the lanes merge every record, shed no
    datagram and the kernel drops none, yet the series spill: the feed
    fails and names the spill, where it used to pass and leave the flush
    short of series."""
    chip_smoke, server, sink, lines_ = _paced_server(256)
    try:
        server.overload.freeze_new_series = lambda: True
        with pytest.raises(AssertionError, match="spilled to the overflow"):
            chip_smoke._fha_udp(server, lines_)
        assert server.overload.shed_total() == 0
    finally:
        server.shutdown()
