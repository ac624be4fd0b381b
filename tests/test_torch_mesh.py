"""The port's mesh-sharded global tier against the JAX package's, on the
CPU: the port's 4 x 2 :class:`ShardMesh` (eight CPU devices repeated)
against the JAX mesh over the conftest's 8 virtual CPU devices.

Tolerances (ROADMAP's; the JAX side runs its XLA rung, the port the
plain versions of K1/K2, so across packages only mass and quantiles are
compared after a drain):

* counters, registers, counts, extrema, placement: exact; set estimates
  rtol 1e-6 (one float32 ulp of the log, see ``tests/test_torch_hll.py``);
  sums rtol 1e-6;
* digest mass rtol 1e-6 a row; quantiles within 0.02 x (max - min);
* temp bins before any drain (plain torch on both sides): rtol 1e-6;
* the port's mesh store against the port's dense store (same rung):
  rtol 1e-5 (the JAX package's mesh-against-single-device bound), on
  traffic where every host slice of a chunk holds whole series; where a
  slice splits a series the mesh bins per slice, as the JAX mesh does,
  and the bins follow the JAX mesh's, not the dense store's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from veneur_tpu import persist as jpersist
from veneur_tpu.core import mesh_store as jmesh_store
from veneur_tpu.core import store as jstore
from veneur_tpu.fleet import router as jrouter
from veneur_tpu.ops import tdigest as jtd
from veneur_tpu.parallel import collectives as jcoll
from veneur_tpu.parallel import global_agg as jagg
from veneur_tpu.parallel.mesh import HOSTS_AXIS
from veneur_tpu.parallel.mesh import fleet_mesh as jfleet_mesh
from veneur_tpu.parallel.mesh import shard_map
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.samplers.intermetric import HistogramAggregates as JAggs
from veneur_tpu_torch import persist as tpersist
from veneur_tpu_torch.core import mesh_store as tmesh_store
from veneur_tpu_torch.core import store as tstore
from veneur_tpu_torch.fleet import router as trouter
from veneur_tpu_torch.ops import hll as thll
from veneur_tpu_torch.ops import tdigest as ttd
from veneur_tpu_torch.parallel import collectives as tcoll
from veneur_tpu_torch.parallel import global_agg as tagg
from veneur_tpu_torch.parallel.mesh import fleet_mesh
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates
from veneur_tpu_torch.samplers.parser import MetricKey

CPU = torch.device("cpu")
QS = [0.5, 0.9, 0.99]
C = 100.0
K = ttd.size_bound(C)


def _tmesh(hosts=2):
    return fleet_mesh([CPU] * 8, hosts=hosts)


def _jmesh(hosts=2):
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    n = 8 if 8 % hosts == 0 else hosts * (8 // hosts)
    return jfleet_mesh(jax.devices()[:n], hosts=hosts)


def _close_pcts(got, want, lo, hi, tol=0.02):
    span = (np.asarray(hi, np.float64) - np.asarray(lo, np.float64))[:, None]
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ok = (np.isnan(got) & np.isnan(want)) | (np.abs(got - want)
                                             <= tol * span + 1e-6)
    assert ok.all(), np.abs(got - want)[~ok]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _over_hosts(fn, hosts, *arrays):
    """Run a JAX collective over a 1 x hosts mesh: dim 0 of each array is
    the hosts axis; the result is replicated."""
    mesh = jfleet_mesh(jax.devices()[:hosts], hosts=hosts)
    local = shard_map(lambda *xs: fn(*(x[0] for x in xs)), mesh=mesh,
                      in_specs=tuple(P(HOSTS_AXIS) for _ in arrays),
                      out_specs=P(), check_vma=False)
    return jax.jit(local)(*(jnp.asarray(a) for a in arrays))


# -- collectives ---------------------------------------------------------------


@pytest.mark.parametrize("hosts", [2, 3, 4])
def test_counters_and_registers_exact(hosts):
    rng = np.random.default_rng(hosts)
    ctr = rng.integers(-1000, 1000, (hosts, 50)).astype(np.int32)
    regs = rng.integers(0, 40, (hosts, 6, 64)).astype(np.int32)
    want_c = _over_hosts(lambda x: jcoll.merge_counters(x, HOSTS_AXIS),
                         hosts, ctr)
    want_r = _over_hosts(lambda x: jcoll.merge_registers(x, HOSTS_AXIS),
                         hosts, regs)
    np.testing.assert_array_equal(tcoll.merge_counters(_t(ctr)).numpy(),
                                  np.asarray(want_c))
    np.testing.assert_array_equal(tcoll.merge_registers(_t(regs)).numpy(),
                                  np.asarray(want_r))


def _host_temps(hosts, s=12, n=200, seed=0):
    """Per-host temps the JAX package binned from seeded slices, as
    numpy stacks with the hosts axis first."""
    rng = np.random.default_rng(seed)
    temps = []
    for _ in range(hosts):
        t = jtd.ingest_chunk(
            jtd.init_temp(s, K, C),
            jnp.asarray(rng.integers(0, s + 1, n).astype(np.int32)),
            jnp.asarray(rng.gamma(2.0, 10.0, n).astype(np.float32)),
            jnp.asarray(rng.integers(1, 4, n).astype(np.float32)), C)
        temps.append(t)
    return [np.stack([np.asarray(getattr(t, f)) for t in temps])
            for f in jtd.TempCentroids._fields]


@pytest.mark.parametrize("hosts", [2, 4])
def test_merge_temp_equals_jax(hosts):
    fields = _host_temps(hosts, seed=hosts)
    want = _over_hosts(
        lambda *xs: tuple(jcoll.merge_temp(jtd.TempCentroids(*xs),
                                           HOSTS_AXIS)), hosts, *fields)
    got = tcoll.merge_temp(ttd.TempCentroids(*(_t(f) for f in fields)))
    for name, g, w in zip(ttd.TempCentroids._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   err_msg=name)


def _host_digests(hosts, s=10, n=256, seed=6):
    """One compressed digest a (host, series) from raw samples, built by
    the JAX package (rows ascending, +inf empties): the butterfly's
    inputs on both sides."""
    rng = np.random.default_rng(seed)
    samples = rng.normal(50.0, 10.0, (hosts, s, n)).astype(np.float32)
    out = [[], [], [], []]
    for i in range(hosts):
        d = jtd.merge_samples(jtd.init((s,), C, K), jnp.asarray(samples[i]),
                              jnp.ones((s, n), jnp.float32), C)
        for f, x in zip(out, d):
            f.append(np.asarray(x))
    return [np.stack(f) for f in out], samples


@pytest.mark.parametrize("hosts", [2, 4, 3])
def test_allmerge_digest_matches_jax(hosts):
    """The butterfly (hosts 2, 4: log2 rounds of K2) and the gathered
    re-cluster (hosts 3: from_centroids): mass conserved within rtol
    1e-6, quantiles within 0.02 x span of the JAX package's."""
    (mean, weight, mn, mx), samples = _host_digests(hosts, seed=hosts)
    want = _over_hosts(
        lambda *xs: tuple(jcoll.allmerge_digest(jtd.TDigest(*xs),
                                                HOSTS_AXIS, hosts, C)),
        hosts, mean, weight, mn, mx)
    got = tcoll.allmerge_digest(ttd.TDigest(_t(mean), _t(weight), _t(mn),
                                            _t(mx)), C)
    total = weight.astype(np.float64).sum((0, 2))
    np.testing.assert_allclose(got.weight.double().sum(1).numpy(), total,
                               rtol=1e-6)
    np.testing.assert_array_equal(got.min.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got.max.numpy(), np.asarray(want[3]))
    gq = ttd.quantile(got, QS).numpy()
    wq = np.asarray(jtd.quantile(jtd.TDigest(*want), jnp.asarray(QS)))
    _close_pcts(gq, wq, got.min.numpy(), got.max.numpy())
    flat = samples.transpose(1, 0, 2).reshape(samples.shape[1], -1)
    _close_pcts(gq, np.quantile(flat, QS, axis=1).T, flat.min(1),
                flat.max(1), tol=0.05)


def test_merge_and_from_centroids_match_jax():
    (mean, weight, mn, mx), _ = _host_digests(2, s=16, seed=11)
    ja = jtd.TDigest(*(jnp.asarray(x[0]) for x in (mean, weight, mn, mx)))
    jb = jtd.TDigest(*(jnp.asarray(x[1]) for x in (mean, weight, mn, mx)))
    ta = ttd.TDigest(*(_t(x[0]) for x in (mean, weight, mn, mx)))
    tb = ttd.TDigest(*(_t(x[1]) for x in (mean, weight, mn, mx)))
    got, want = ttd.merge(ta, tb, C), jtd.merge(ja, jb, C)
    np.testing.assert_allclose(got.weight.double().sum(1).numpy(),
                               np.asarray(want.weight, np.float64).sum(1),
                               rtol=1e-6)
    _close_pcts(ttd.quantile(got, QS).numpy(),
                np.asarray(jtd.quantile(want, jnp.asarray(QS))),
                got.min.numpy(), got.max.numpy())
    flat_m = np.concatenate([mean[0], mean[1]], 1)
    flat_w = np.concatenate([weight[0], weight[1]], 1)
    got = ttd.from_centroids(_t(flat_m), _t(flat_w), _t(mn.min(0)),
                             _t(mx.max(0)), C, K)
    want = jtd.from_centroids(jnp.asarray(flat_m), jnp.asarray(flat_w),
                              mn.min(0), mx.max(0), C, K)
    # the same sort-based program on both sides
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight),
                               rtol=1e-6)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                               rtol=1e-5)
    assert got.mean.shape == (16, K)


# -- the standalone interval step ------------------------------------------------


@pytest.mark.parametrize("hosts", [2, 4])
def test_global_aggregator_step_matches_jax(hosts):
    """Two intervals of the sharded step, port against JAX: counters and
    registers exact, estimates rtol 1e-6, digest mass rtol 1e-6, the
    percentiles within 0.02 x span, and within 0.15 x span of the exact
    quantiles (the dryrun's oracle)."""
    s = 64
    tg = tagg.GlobalAggregator(_tmesh(hosts), s)
    jg = jagg.GlobalAggregator(_jmesh(hosts), s)
    ts, js = tg.init_state(), jg.init_state()
    batches = [jagg.make_host_batch(hosts, s, n=512, seed=seed)
               for seed in (3, 4)]
    assert all(np.array_equal(a, b) for a, b in zip(
        batches[0], tagg.make_host_batch(hosts, s, n=512, seed=3)))
    for batch in batches:
        ts, tp, te, tc = tg.step(ts, tg.shard_batch(batch), QS)
        js, jp, je, jc = jg.step(js, jg.shard_batch(batch), QS)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.registers.numpy(),
                                      np.asarray(js.registers))
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6)
        np.testing.assert_allclose(
            ts.digest.weight.double().sum(1).numpy(),
            np.asarray(js.digest.weight, np.float64).sum(1), rtol=1e-6)
        np.testing.assert_array_equal(ts.digest.min.numpy(),
                                      np.asarray(js.digest.min))
        live = ts.digest.weight.sum(1).numpy() > 0
        _close_pcts(tp.numpy()[live], np.asarray(jp)[live],
                    ts.digest.min.numpy()[live],
                    ts.digest.max.numpy()[live])
    want = np.zeros(s, np.int64)
    for b in batches:
        np.add.at(want, b.c_rows.reshape(-1), b.c_incs.reshape(-1))
    np.testing.assert_array_equal(tc.numpy(), want)
    rows = np.concatenate([b.h_rows.reshape(-1) for b in batches])
    vals = np.concatenate([b.h_vals.reshape(-1) for b in batches])
    for row in range(0, s, 5):
        mine = vals[rows == row]
        if len(mine) < 4:
            continue
        span = max(float(mine.max() - mine.min()), 1e-6)
        exact = np.quantile(mine, QS)
        assert np.all(np.abs(tp.numpy()[row] - exact) / span < 0.15), row


@pytest.mark.parametrize("hosts", [2, 4])
def test_merge_forwarded_digests_matches_jax(hosts):
    (mean, weight, mn, mx), _ = _host_digests(hosts, s=8, seed=20 + hosts)
    tg = tagg.GlobalAggregator(_tmesh(hosts), 8)
    jg = jagg.GlobalAggregator(_jmesh(hosts), 8)
    got = tg.merge_forwarded_digests(mean, weight, mn, mx)
    want = jg.merge_forwarded_digests(mean, weight, mn, mx)
    np.testing.assert_allclose(got.weight.double().sum(1).numpy(),
                               weight.astype(np.float64).sum((0, 2)),
                               rtol=1e-6)
    _close_pcts(ttd.quantile(got, QS).numpy(),
                np.asarray(jtd.quantile(want, jnp.asarray(QS))),
                got.min.numpy(), got.max.numpy())
    with pytest.raises(ValueError, match="hosts"):
        tg.merge_forwarded_digests(mean[:1], weight[:1], mn[:1], mx[:1])


# -- the mesh groups ------------------------------------------------------------


def _keys(n, prefix, mtype):
    return [MetricKey(name=f"{prefix}{i}", type=mtype,
                      joined_tags=f"z:{i % 3}") for i in range(n)]


def _groups(kind, cap=16, chunk=64, **kw):
    """The JAX mesh group, the port's mesh group and the port's dense
    group of one kind, all fresh."""
    tm, jm = _tmesh(), _jmesh()
    if kind == "digest":
        return (jmesh_store.MeshDigestGroup(jm, cap, chunk, C,
                                            router=jrouter.ShardRouter(4)),
                tmesh_store.MeshDigestGroup(tm, cap, chunk, C,
                                            trouter.ShardRouter(4)),
                tstore.DigestGroup(cap, chunk, C, "cpu"))
    if kind == "set":
        return (jmesh_store.MeshSetGroup(jm, cap, chunk, 10,
                                         router=jrouter.ShardRouter(4)),
                tmesh_store.MeshSetGroup(tm, cap, chunk, 10,
                                         trouter.ShardRouter(4)),
                tstore.SetGroup(cap, chunk, 10, "cpu"))
    args = (cap, chunk, 4, 1 << 10, 8)
    return (jmesh_store.MeshHeavyHitterGroup(*args, jm,
                                             jrouter.ShardRouter(4)),
            tmesh_store.MeshHeavyHitterGroup(*args, tm,
                                             trouter.ShardRouter(4)),
            tstore.HeavyHitterGroup(*args, device="cpu"))


def _digest_traffic(groups, n=50, seed=1):
    """Series interned through every group's ``_row`` (growing the
    16-row groups past 50), samples staged a series' 8 at a time (every
    32-sample host slice of a 64-sample chunk holds whole series), a
    distribution step for half the series (the guard drains through K2),
    and forwarded centroid runs through the import staging."""
    rng = np.random.default_rng(seed)
    keys = _keys(n, "m.h", "histogram")
    rows = [np.array([g._row(k, []) for k in keys]) for g in groups]
    assert all(np.array_equal(r, rows[0]) for r in rows)
    for step in range(3):
        order = rng.permutation(n)
        r = np.repeat(order, 8).astype(np.int32)
        v = rng.gamma(2.0, 10.0, r.size).astype(np.float32)
        if step == 2:
            v[r % 2 == 0] += 400.0
        w = rng.integers(1, 3, r.size).astype(np.float32)
        for g in groups:
            g.sample_many(r, v, w)
    runs = rng.permutation(n)[:30]
    means, wts, rr = [], [], []
    for row in runs:
        m = np.sort(rng.normal(80, 5, 12)).astype(np.float32)
        means.append(m)
        wts.append(rng.integers(1, 5, 12).astype(np.float32))
        rr.append(np.full(12, row, np.int32))
    rr, means, wts = (np.concatenate(x) for x in (rr, means, wts))
    stat_rows = runs.astype(np.int32)
    smin = np.array([m.min() for m in np.split(means, 30)], np.float32) - 1
    smax = np.array([m.max() for m in np.split(means, 30)], np.float32) + 1
    for g in groups:
        g.import_centroids_bulk(rr, means, wts, stat_rows, smin, smax)
    return keys


def test_mesh_digest_group_matches_jax_and_dense(monkeypatch):
    jg, tg, dg = _groups("digest")
    drains = {"port": 0}
    real = ttd.drain_temp

    def counting(*a, **kw):
        drains["port"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(ttd, "drain_temp", counting)
    _digest_traffic((jg, tg, dg))
    assert tg.capacity == jg.capacity >= 64 and drains["port"] >= 2
    np.testing.assert_array_equal(tg.placement.perm(), jg.placement.perm())
    ti, tout = tg.flush(QS, want_digests=True)
    ji, jout = jg.flush(QS, want_digests=True)
    di, dout = dg.flush(QS, want_digests=True)
    assert ti.names == ji.names == di.names
    for k in ("count", "min", "max"):
        np.testing.assert_array_equal(tout[k], np.asarray(jout[k]), k)
        np.testing.assert_array_equal(tout[k], dout[k], k)
    for k in ("sum", "recip"):
        np.testing.assert_allclose(tout[k], np.asarray(jout[k]), rtol=1e-6)
        np.testing.assert_allclose(tout[k], dout[k], rtol=1e-5)
    mass = tout["digest_weight"].astype(np.float64).sum(1)
    np.testing.assert_allclose(
        mass, np.asarray(jout["digest_weight"], np.float64).sum(1),
        rtol=1e-6)
    np.testing.assert_allclose(mass, dout["digest_weight"].sum(1),
                               rtol=1e-6)
    lo, hi = tout["digest_min"], tout["digest_max"]
    _close_pcts(tout["percentiles"], np.asarray(jout["percentiles"]), lo, hi)
    np.testing.assert_allclose(tout["percentiles"], dout["percentiles"],
                               rtol=1e-5)
    # the placement reset with the interner
    assert len(tg.placement) == 0


def test_host_slices_bin_as_the_jax_mesh():
    """A chunk whose host slices split series: each slice bins on its own
    (anchored on the accumulated bins) and the slices sum, as the JAX
    mesh does; the port's bins equal the JAX mesh group's, and differ
    from the dense group's whole-chunk binning."""
    jg, tg, dg = _groups("digest", cap=64, chunk=256)
    rng = np.random.default_rng(4)
    keys = _keys(20, "b.h", "histogram")
    for g in (jg, tg, dg):
        for k in keys:
            g._row(k, [])
    for _ in range(3):
        r = rng.integers(0, 20, 256).astype(np.int32)
        v = rng.gamma(2.0, 10.0, 256).astype(np.float32)
        for g in (jg, tg, dg):
            g.sample_many(r, v, np.ones(256, np.float32))
    perm = tg.placement.perm()
    got = tg.temp.sum_w[torch.from_numpy(perm)].numpy()
    want = np.asarray(jg.temp.sum_w)[jg.placement.perm()]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert not np.allclose(got, dg.temp.sum_w[:20].numpy())
    np.testing.assert_array_equal(got.sum(1), dg.temp.sum_w[:20].sum(1))


def _set_traffic(groups, seed=2):
    rng = np.random.default_rng(seed)
    keys = _keys(30, "m.s", "set")
    for _ in range(3):
        rows = rng.integers(0, 30, 200)
        hashes = rng.integers(0, np.iinfo(np.uint64).max, 200,
                              dtype=np.uint64, endpoint=True)
        for g in groups:
            r = np.array([g._row(keys[i], []) for i in rows], np.int32)
            g.sample_many(r, hashes)
    for i in range(0, 30, 3):
        regs = rng.integers(0, 12, 1 << 10).astype(np.uint8)
        for g in groups:
            g.import_registers(keys[i], [], regs)


def test_mesh_set_group_matches_jax_and_dense():
    jg, tg, dg = _groups("set")
    _set_traffic((jg, tg, dg))
    assert tg.capacity == jg.capacity
    ti, te, tr = tg.flush(True, True)
    ji, je, jr = jg.flush(True, True)
    di, de, dr = dg.flush(True, True)
    assert ti.names == ji.names == di.names
    np.testing.assert_array_equal(tr, np.asarray(jr))
    np.testing.assert_array_equal(tr, dr)
    np.testing.assert_allclose(te, np.asarray(je), rtol=1e-6)
    np.testing.assert_array_equal(te, de)
    assert len(tg.placement) == 0


def test_mesh_scalar_group_matches_jax_and_dense():
    router, jrt = trouter.ShardRouter(4), jrouter.ShardRouter(4)
    tg = tmesh_store.MeshScalarGroup("counter", 8, _tmesh(), router)
    jg = jmesh_store.MeshScalarGroup("counter", 8, _jmesh(), jrt)
    dg = tstore.ScalarGroup("counter", 8)
    rng = np.random.default_rng(3)
    keys = _keys(40, "m.c", "counter")
    for i in rng.integers(0, 40, 300):
        v = float(rng.integers(1, 50))
        for g in (tg, jg, dg):
            g.sample(keys[i], [], v, 0.5)
    for g in (tg, jg, dg):
        g.combine(keys[3], [], 7.0)
    assert tg.placement.occupancy() == jg.placement.occupancy()
    assert tg.capacity == jg.capacity
    got, want, dense = (g.snapshot_and_reset() for g in (tg, jg, dg))
    assert got[0].names == want[0].names == dense[0].names
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[1], dense[1])
    assert len(tg.placement) == 0
    with pytest.raises(ValueError, match="status"):
        tmesh_store.MeshScalarGroup("status", 8, _tmesh(), router)


def test_mesh_heavy_hitter_group_matches_jax_and_dense():
    jg, tg, dg = _groups("topk")
    rng = np.random.default_rng(5)
    keys = _keys(30, "m.k", "set")
    members = [f"key{i}".encode() for i in range(40)]
    hashes = np.array([thll.hash_member(m) for m in members], np.uint64)
    for _ in range(3):
        rows = rng.integers(0, 30, 256)
        mem = (rng.zipf(1.5, 256) - 1) % 40
        for g in (jg, tg, dg):
            r = np.array([g._row(keys[i], []) for i in rows], np.int32)
            g.sample_many(r, hashes[mem], [members[m] for m in mem])
    table = rng.integers(0, 5, (4, 1 << 10)).astype(np.float32)
    series = [(keys[i], [], [(int(hashes[j] >> np.uint64(32)),
                              int(hashes[j] & np.uint64(0xFFFFFFFF)))
                             for j in (i % 40, (i + 7) % 40)],
               [None, None]) for i in range(0, 30, 4)]
    for g in (jg, tg, dg):
        g.import_sketch(table, series)
    ti, trows, _ = tg.flush()
    ji, jrows, _ = jg.flush()
    di, drows, _ = dg.flush()
    assert ti.names == ji.names == di.names
    assert sorted(trows) == sorted(jrows) == sorted(drows)
    assert len(trows) > 30 and len(tg.placement) == 0


# -- the store: snapshot, restore, the ladder ------------------------------------


def _store_lines(seed=3):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(12):
        lines += [f"c.{i}:{int(rng.integers(1, 9))}|c|@0.5".encode()
                  for _ in range(3)]
        lines.append(f"g.{i}:{rng.normal(0, 50):.4f}|g".encode())
    for kind, t in (("h", "h"), ("t", "ms")):
        for i in range(16):
            scope = ("", "|#veneurlocalonly", "|#zone:b,env:a")[i % 3]
            vals = rng.gamma(2.0, 10.0, 24)
            if i % 4 == 0:
                vals[12:] += 500.0
            lines += [f"{kind}.{i}:{v:.5f}|{t}{scope}".encode()
                      for v in vals]
    lines += [f"s.{i % 6}:m{int(rng.integers(0, 80))}|s".encode()
              for i in range(150)]
    lines += [f"hh.{i % 4}:k{int(rng.zipf(1.5)) % 50}|s|#veneurtopk".encode()
              for i in range(160)]
    return lines


TOPK = dict(topk_depth=4, topk_width=1 << 10, topk_k=8)
AGGS = ["min", "max", "count", "sum", "avg", "hmean"]


def _jax_store(lines=(), **kw):
    s = jstore.MetricStore(initial_capacity=16, chunk=128, mesh=_jmesh(),
                           **TOPK, **kw)
    for ln in lines:
        s.process_metric(jparser.parse_metric(ln))
    return s


def _port_store(lines=(), hosts=2, capacity=16, **kw):
    """The port's store on a mesh of ``hosts`` (8 CPU devices), or dense
    with ``hosts=None``."""
    s = tstore.MetricStore(initial_capacity=capacity, chunk=128,
                           mesh=_tmesh(hosts) if hosts else None,
                           device="cpu", **TOPK, **kw)
    for ln in lines:
        s.process_metric(tparser.parse_metric(ln))
    return s


def _jax_rows(store):
    out, _, _ = store.flush(QS, JAggs.from_names(AGGS), is_local=False,
                            now=7, forward=False, columnar=False)
    return {(m.name, tuple(m.tags)): m.value for m in out}


def _port_rows(store):
    out, _ = store.flush(QS, HistogramAggregates.from_names(AGGS), 7)
    return {(m.name, tuple(m.tags)): m.value for m in out.to_intermetrics()}


def _assert_rows_match(got, want, pct_tol=0.02, rel=1e-4):
    """Percentiles within ``pct_tol`` x (max - min) (None: within rel
    ``rel`` like every other row), every other row within rel ``rel``."""
    assert set(got) == set(want)
    for (name, tags), v in want.items():
        base, _, suffix = name.rpartition(".")
        if suffix.endswith("percentile") and pct_tol is not None:
            span = want[(f"{base}.max", tags)] - want[(f"{base}.min", tags)]
            assert abs(got[(name, tags)] - v) <= pct_tol * span + 1e-6, name
        elif np.isnan(v):
            assert np.isnan(got[(name, tags)]), name
        else:
            assert got[(name, tags)] == pytest.approx(v, rel=rel,
                                                      abs=1e-9), name


def test_mesh_store_matches_jax_mesh_store_and_dense():
    """A 4 x 2 store against the JAX 4 x 2 store (across rungs); an 8 x 1
    store, whose chunks are not sliced, against the dense store within
    rtol 1e-5, both sized so that no group grows (a grow drains the
    staging at another point in each layout, ROADMAP "drain boundaries
    under growth"); the 4 x 2 store against the dense store within the
    cross-path envelope (its host slices split series, so its bins
    follow the JAX mesh's, not the dense store's) with the counts,
    sums and extrema within rtol 1e-5."""
    lines = _store_lines()
    mesh_rows = _port_rows(_port_store(lines))
    _assert_rows_match(mesh_rows, _jax_rows(_jax_store(lines)))
    dense_rows = _port_rows(_port_store(lines, hosts=None))
    _assert_rows_match(_port_rows(_port_store(lines, hosts=1, capacity=256)),
                       _port_rows(_port_store(lines, hosts=None,
                                              capacity=256)),
                       pct_tol=None, rel=1e-5)
    _assert_rows_match(mesh_rows, dense_rows, rel=1e-5)
    assert len(mesh_rows) > 150


def _row_mass(snap):
    return np.bincount(snap["rows"], weights=snap["weights"],
                       minlength=len(snap["names"]))


def test_mesh_snapshot_parity():
    """The port's mesh snapshot against the JAX mesh store's: the same
    groups, names, joined tags and dtypes (so the same VCKP layout),
    scalars, registers and the count-min table exact, digest mass rtol
    1e-6 a row with the stats and extrema exact."""
    lines = _store_lines()
    want, _ = _jax_store(lines).snapshot_state()
    got, _ = _port_store(lines).snapshot_state()
    assert set(want) == set(got)
    for name, g in got.items():
        w = want[name]
        assert (g["kind"], g["names"], g["joined"]) == (
            w["kind"], w["names"], w["joined"]), name
        assert set(g) == set(w), name
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert g[k].dtype == v.dtype, (name, k)
        if g["kind"] == "scalar":
            np.testing.assert_array_equal(g["values"], w["values"])
        elif g["kind"] == "set" and w["names"]:
            np.testing.assert_array_equal(g["registers"], w["registers"])
        elif g["kind"] == "topk" and w["names"]:
            np.testing.assert_array_equal(g["table"], w["table"])
        elif g["kind"] == "digest" and w["names"]:
            for k in ("count", "vmin", "vmax", "mins", "maxs"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            np.testing.assert_allclose(_row_mass(g), _row_mass(w),
                                       rtol=1e-6)
    blob = tpersist.serialize(got, created_at=5.0, interval=10.0)
    assert blob == jpersist.serialize(got, created_at=5.0, interval=10.0)


@pytest.mark.parametrize("src", ["jax", "port"])
def test_mesh_cross_restore(src):
    """A checkpoint of one package's mesh store restores into the other
    package's mesh store and into the port's dense store, which flush the
    rows of the JAX mesh store's restore of the same file."""
    lines = _store_lines(seed=8)
    make = _jax_store if src == "jax" else _port_store
    groups, _ = make(lines).snapshot_state()
    blob = tpersist.serialize(groups, created_at=5.0, interval=10.0)
    jdst = _jax_store()
    jdst.restore_state(jpersist.deserialize(blob)[0])
    want = _jax_rows(jdst)
    for hosts in (2, None):
        dst = _port_store(hosts=hosts)
        n = dst.restore_state(tpersist.deserialize(blob)[0])
        assert n == sum(len(g["names"]) for g in groups.values())
        _assert_rows_match(_port_rows(dst), want)


def test_rung3_re_merges_a_mesh_group(monkeypatch):
    """The compute ladder's rung 3 on a mesh group: a failed flush kernel
    re-merges the retired mesh group into the live one (through its
    placement), and the next flush emits the interval's rows beside the
    next interval's, as a twin that never failed emits them."""
    lines = _store_lines(seed=9)
    store, twin = _port_store(lines), _port_store(lines)
    real = tstore._flush_digests
    calls = []

    def fail_once(*args):
        if not calls:
            calls.append(1)
            raise RuntimeError("injected kernel fault")
        return real(*args)

    monkeypatch.setattr(tstore, "_flush_digests", fail_once)
    first = _port_rows(store)
    assert store.compute.requeued_total == 1
    # the first flush unit, the mesh histograms, re-merged; the local-only
    # (dense) histograms emitted on time
    local = {f"h.{i}.count" for i in range(1, 16, 3)}
    assert {n for n, _ in first if n.startswith("h.")
            and n.endswith(".count")} == local
    twin_first = _port_rows(twin)
    more = _store_lines(seed=10)
    for s in (store, twin):
        for ln in more:
            s.process_metric(tparser.parse_metric(ln))
    late, twin_late = _port_rows(store), _port_rows(twin)
    counts = {k: v for k, v in late.items() if k[0].startswith("h.")
              and k[0].endswith(".count")}
    want = {k: (0 if k[0] in local else twin_first.get(k, 0))
            + twin_late.get(k, 0) for k in counts}
    assert counts == want and len(counts) > 5
    assert store.compute.lost_total == 0
