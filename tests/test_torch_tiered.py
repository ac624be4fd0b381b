"""The port's tiered digest store (``veneur_tpu_torch/core/tiered.py``) and
the pool's ops (``ops/tdigest.py``) against the JAX package's on the CPU.

Inputs are continuous random values made with numpy from a seed. Same
rung (both packages compute the same float32 operations in the same
order):

* ``quantize_centroids``, ``dequantize_centroids``, ``dequantize_host``
  and ``_pack_slab`` on pool rows: bit for bit (u16 means and bfloat16
  weight bits; the divisions are true divisions in both, F3);
* ``bin_pool_samples`` and ``_packed_below_mass``: exact (equal sorted
  samples and bins, equal below-mass sums);
* promotion, demotion and the hysteresis streaks: the same keys, in the
  same intervals.

Across rungs (the JAX CPU path is its XLA rung with the true arcsin,
the port's the plain versions of K1/K2 with the asin polynomial), the
``tests/test_pallas.py`` bounds: counts, sums' inputs and extrema exact,
sums rtol 1e-6, per-row mass rtol 1e-6, percentiles within 0.02 x (max
- min) of the row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.core import slab as jslab
from veneur_tpu.core import store as jstore
from veneur_tpu.core import tiered as jtiered
from veneur_tpu.ops import tdigest as jtd
from veneur_tpu.samplers.parser import MetricKey as JKey
from veneur_tpu_torch.core import slab as tslab
from veneur_tpu_torch.core import store as tstore
from veneur_tpu_torch.core import tiered as ttiered
from veneur_tpu_torch.ops import tdigest as ttd
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates
from veneur_tpu_torch.samplers.parser import MetricKey

QS = [0.25, 0.5, 0.9, 0.99]
PK = 16
PCOMP = 14.0


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


def _u16(t):
    return t.numpy().view(np.uint16)


def _planes(rng, rows, pk=PK, live=0.6):
    """Sorted, gap-carrying centroid planes as a compaction leaves them:
    rows empty, with one live slot, and mixed."""
    m = np.sort(rng.gamma(2.0, 30.0, (rows, pk)), 1).astype(np.float32)
    w = ((rng.random((rows, pk)) < live)
         * rng.integers(1, 9, (rows, pk))).astype(np.float32)
    w[0] = 0.0
    w[1, 1:] = 0.0
    w[2] = np.float32(3.0)
    w[3] *= np.float32(1.37)   # weights that round in bfloat16
    m = np.where(w > 0, m, np.inf).astype(np.float32)
    return m, w


# -- the packed format: bit for bit -------------------------------------------


@pytest.mark.parametrize("seed,rows", [(1, 300), (2, 64), (3, 1000)])
def test_quantize_bits_equal_jax(seed, rows):
    m, w = _planes(np.random.default_rng(seed), rows)
    want = [np.asarray(a) for a in jtd.quantize_centroids(_j(m), _j(w))]
    got = ttd.quantize_centroids(_t(m), _t(w))
    np.testing.assert_array_equal(_u16(got[0]), want[0])
    np.testing.assert_array_equal(_u16(got[1]), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_array_equal(got[3].numpy(), want[3])


@pytest.mark.parametrize("seed", [4, 5])
def test_dequantize_bits_equal_jax(seed):
    m, w = _planes(np.random.default_rng(seed), 400)
    mq, wb, fmin, fmax = (np.asarray(a)
                          for a in jtd.quantize_centroids(_j(m), _j(w)))
    want = [np.asarray(a) for a in jtd.dequantize_centroids(
        _j(mq), _j(wb), _j(fmin), _j(fmax))]
    got = ttd.dequantize_centroids(_t(mq.view(np.int16)),
                                   _t(wb.view(np.int16)), _t(fmin),
                                   _t(fmax))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w_)
    host = ttiered.dequantize_host(mq, wb, fmin, fmax)
    for g, w_ in zip(host, jtiered.dequantize_host(mq, wb, fmin, fmax)):
        np.testing.assert_array_equal(g, w_)


def test_pack_slab_on_pool_rows_bits_equal():
    """The forward pack of a pool flush's [S, PK] planes."""
    rng = np.random.default_rng(6)
    m, w = _planes(rng, 512)
    m = np.maximum.accumulate(np.where(w > 0, m, -np.inf), 1) \
        .astype(np.float32)
    dmin = np.where(w > 0, m, np.inf).min(1).astype(np.float32) - 1.0
    dmax = np.where(w > 0, m, -np.inf).max(1).astype(np.float32) + 1.0
    want = [np.asarray(a) for a in jslab._pack_slab(
        _j(m.reshape(-1)), _j(w.reshape(-1)), _j(dmin), _j(dmax), 512, PK)]
    got = tslab._pack_slab(_t(m), _t(w), _t(dmin), _t(dmax))
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    counts = want[0].astype(np.int64)
    live = np.arange(PK)[None, :] < counts[:, None]
    for g, w_ in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(_u16(g)[live], w_[live])


# -- the pool's binning: exact -------------------------------------------------


def _pool_state(rng, series, fill=0.4):
    """Bins partly filled (rows 0-19 empty) and packed planes beside."""
    bw = np.zeros((series, PK), np.float32)
    bwm = np.zeros((series, PK), np.float32)
    sel = rng.random((series, PK)) < fill
    bw[sel] = rng.integers(1, 5, sel.sum())
    bwm[sel] = bw[sel] * rng.gamma(2.0, 30.0, sel.sum())
    bw[:20] = bwm[:20] = 0.0
    m, w = _planes(rng, series)
    packed = [np.asarray(a)
              for a in jtd.quantize_centroids(_j(m), _j(w))]
    return bw.reshape(-1), bwm.reshape(-1), packed


@pytest.mark.parametrize("mode", ["bins-only", "with-packed", "dominant"])
def test_bin_pool_samples_equal_jax(mode):
    rng = np.random.default_rng({"bins-only": 7, "with-packed": 8,
                                 "dominant": 9}[mode])
    series, n = 300, 2000
    bw, bwm, packed = _pool_state(rng, series)
    rows = rng.integers(0, series, n).astype(np.int32)
    if mode == "dominant":
        rows[:600] = 25   # one row's chunk outweighs what it holds
    rows[-40:] = series   # padding
    vals = rng.gamma(2.0, 30.0, n).astype(np.float32)
    wts = np.where(rows < series, 1.0, 0.0).astype(np.float32)
    jp = [_j(a) for a in packed] if mode != "bins-only" else [None] * 4
    tp = ([_t(packed[0].view(np.int16)), _t(packed[1].view(np.int16)),
           _t(packed[2]), _t(packed[3])] if mode != "bins-only"
          else [None] * 4)
    want = [np.asarray(a) for a in jtd.bin_pool_samples(
        _j(rows), _j(vals), _j(wts), series, PK, PCOMP, _j(bw), _j(bwm),
        *jp)]
    got = ttd.bin_pool_samples(_t(rows), _t(vals), _t(wts), series, PK,
                               PCOMP, _t(bw), _t(bwm), *tp)
    for g, w_, name in zip(got, want, ("rows", "values", "weights",
                                       "bins")):
        np.testing.assert_array_equal(g.numpy(), w_, err_msg=name)


def test_packed_below_mass_equal_jax():
    rng = np.random.default_rng(10)
    series, n = 200, 1500
    _, _, packed = _pool_state(rng, series)
    rows = np.sort(rng.integers(0, series, n)).astype(np.int32)
    vals = rng.gamma(2.0, 30.0, n).astype(np.float32)
    want = [np.asarray(a) for a in jtd._packed_below_mass(
        _j(rows), _j(vals), *(_j(a) for a in packed), series, PK)]
    got = ttd._packed_below_mass(
        _t(rows).long(), _t(vals), _t(packed[0].view(np.int16)),
        _t(packed[1].view(np.int16)), _t(packed[2]), _t(packed[3]),
        series, PK)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w_)


@pytest.mark.parametrize("pk", [8, 16, 32, 64])
def test_pool_bytes_per_row_equal_jax(pk):
    assert ttiered.pool_bytes_per_row(pk) == jtiered.pool_bytes_per_row(pk)


def test_hbm_bytes_equal_jax():
    jg = jtiered.TieredDigestGroup(slab_rows=256, chunk=64,
                                   dense_capacity=32)
    tg = ttiered.TieredDigestGroup(slab_rows=256, chunk=64,
                                   dense_capacity=32, device="cpu")
    for g, key in ((jg, JKey), (tg, MetricKey)):
        for i in range(600):
            g._row(key(f"s{i}", "histogram", ""), [])
        g._assign_dense(3)
    assert tg.hbm_bytes() == jg.hbm_bytes()
    assert tg.hbm_bytes()["pool_bytes_per_row"] == 228


# -- the group against the JAX group ------------------------------------------


def _key(pkg, i):
    cls = JKey if pkg == "jax" else MetricKey
    return cls(name=f"s{i}", type="histogram", joined_tags="")


def _groups(**kw):
    kw.setdefault("slab_rows", 256)
    kw.setdefault("chunk", 64)
    return (jtiered.TieredDigestGroup(**kw),
            ttiered.TieredDigestGroup(device="cpu", **kw))


def _feed(groups, rng, per_row, step=0.0):
    """per_row: {row: samples}, one sample a call as the per-line path
    stages them, the same values into both groups."""
    for i, n in per_row.items():
        vals = (rng.gamma(2.0, 50.0, n) + step).astype(np.float32)
        for v in vals:
            for pkg, g in zip(("jax", "port"), groups):
                g.sample(_key(pkg, i), [], float(v), 1.0)


def _assert_flush_match(got, want, digests=True):
    for k in ("count", "min", "max"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["sum"], want["sum"], rtol=1e-6)
    lo, hi = np.asarray(want["min"], np.float64), np.asarray(want["max"],
                                                             np.float64)
    span = hi - lo
    if "digest_min" in want:   # an import-only row has no sample extrema
        dspan = (np.asarray(want["digest_max"], np.float64)
                 - np.asarray(want["digest_min"], np.float64))
        span = np.where(np.isfinite(span), span, dspan)
    span = np.where(np.isfinite(span), span, 0.0)[:, None]
    d = np.abs(got["percentiles"].astype(np.float64)
               - np.asarray(want["percentiles"], np.float64))
    nan = np.isnan(got["percentiles"]) & np.isnan(want["percentiles"])
    assert (nan | (d <= 0.02 * span + 1e-6)).all()
    if digests:
        np.testing.assert_allclose(
            got["digest_weight"].astype(np.float64).sum(1),
            np.asarray(want["digest_weight"], np.float64).sum(1),
            rtol=1e-6)
        np.testing.assert_array_equal(got["digest_min"],
                                      want["digest_min"])


@pytest.mark.parametrize("scenario", ["sparse", "hot", "multi-slab"])
def test_group_flush_matches_jax(scenario):
    """Sparse rows (singleton bins), hot rows (the guard's compactions
    through K2 at merge width 32, and promotions mid-interval), and rows
    across three pool slabs; three intervals, the second stepped."""
    rng = np.random.default_rng({"sparse": 11, "hot": 12,
                                 "multi-slab": 13}[scenario])
    groups = _groups(promote_samples=40, promote_intervals=1,
                     slab_rows=64 if scenario == "multi-slab" else 256)
    for interval in range(3):
        if scenario == "sparse":
            per_row = {i: int(rng.integers(1, 6)) for i in range(90)}
        elif scenario == "hot":
            per_row = {i: int(rng.integers(20, 90)) for i in range(24)}
        else:
            per_row = {i: int(rng.integers(2, 30)) for i in range(170)}
        _feed(groups, rng, per_row, step=300.0 * (interval == 1))
        assert groups[1].capacity == groups[0].capacity
        assert groups[1]._dense_rows == groups[0]._dense_rows
        _, want = groups[0].flush(QS, want_digests=True)
        _, got = groups[1].flush(QS, want_digests=False)
        _assert_flush_match(got, want, digests=False)
        groups = tuple(g.fresh() for g in groups)
    _feed(groups, rng, {i: 30 for i in range(40)})
    _, want = groups[0].flush(QS, want_digests=True)
    _, got = groups[1].flush(QS, want_digests=True)
    _assert_flush_match(got, want)


def test_import_centroids_lands_in_both_tiers():
    groups = _groups(promote_samples=8, promote_intervals=1, chunk=8)
    rng = np.random.default_rng(14)
    _feed(groups, rng, {0: 20})      # row 0 promotes
    assert [len(g._dense_rows) for g in groups] == [1, 1]
    for i in (0, 1):
        means = np.array([10.0, 20.0, 30.0], np.float32)
        weights = np.array([2.0, 3.0, 5.0], np.float32)
        for pkg, g in zip(("jax", "port"), groups):
            g.import_centroids(_key(pkg, i), [], means, weights, 5.0, 35.0)
    _, want = groups[0].flush(QS, want_digests=True)
    _, got = groups[1].flush(QS, want_digests=True)
    _assert_flush_match(got, want)
    assert got["digest_min"][1] == 5.0 and got["digest_max"][1] == 35.0
    assert got["count"][1] == 0.0     # imports bound the digest only


def test_packed_flush_splices_tiers_like_jax():
    groups = _groups(promote_samples=12, promote_intervals=1)
    rng = np.random.default_rng(15)
    _feed(groups, rng, {i: (30 if i % 4 == 0 else 3) for i in range(40)})
    _, want = groups[0].flush(QS, want_digests="packed")
    _, got = groups[1].flush(QS, want_digests="packed")
    assert len(groups[1]._dense_rows) == 0   # reset by the flush
    np.testing.assert_array_equal(got["digest_min"], want["digest_min"])
    np.testing.assert_array_equal(got["digest_max"], want["digest_max"])
    for out in (got, want):
        counts = out["packed_counts"].astype(np.int64)
        assert int(counts.sum()) == out["packed_means"].size
    ends = np.cumsum(got["packed_counts"].astype(np.int64))
    w = (got["packed_weights"].astype(np.uint32) << 16).view(np.float32)
    for i in range(40):
        run = w[ends[i] - got["packed_counts"][i]:ends[i]]
        assert (run > 0).all()
        assert run.sum() == pytest.approx(got["count"][i], rel=2**-7)
    np.testing.assert_array_equal(got["count"], want["count"])


# -- promotion, demotion, hysteresis: key for key ------------------------------


def _directory_state(g):
    d = g.directory
    return (sorted(d._dense.items()), sorted(d._warm.items()),
            d.promotions, d.demotions)


@pytest.mark.parametrize("pi,di", [(1, 1), (2, 3), (3, 2)])
def test_promotion_sequence_equals_jax(pi, di):
    """Five intervals of series that ramp, oscillate around the bar, go
    idle and come back: after every drain and every flush both
    directories hold the same dense keys (with their idle counts) and
    the same warm streaks, and both groups the same dense rows."""
    rng = np.random.default_rng(16 + pi + di)
    groups = _groups(promote_samples=10, promote_intervals=pi,
                     demote_intervals=di, chunk=16)
    plans = [{0: 30, 1: 30, 2: 3, 3: 12, 4: 0},
             {0: 30, 1: 2, 2: 30, 3: 4, 4: 40},
             {0: 30, 1: 30, 2: 30, 3: 12, 4: 1},
             {0: 1, 1: 30, 2: 2, 3: 5, 4: 1},
             {0: 1, 1: 0, 2: 30, 3: 15, 4: 30}]
    for plan in plans:
        _feed(groups, rng, {i: n for i, n in plan.items() if n})
        assert _directory_state(groups[1]) == _directory_state(groups[0])
        assert groups[1]._dense_rows == groups[0]._dense_rows
        _, want = groups[0].flush(QS, want_digests=False)
        _, got = groups[1].flush(QS, want_digests=False)
        assert _directory_state(groups[1]) == _directory_state(groups[0])
        np.testing.assert_array_equal(got["count"], want["count"])
        groups = tuple(g.fresh() for g in groups)
    d = groups[1].directory
    assert d.promotions > 0 and (d.demotions > 0 or di > 2)


# -- store paths: cap, quarantine, retired twin, snapshot ---------------------


def _store(pkg, **kw):
    kw = dict(initial_capacity=32, chunk=64, digest_storage="tiered",
              slab_rows=256, **kw)
    if pkg == "jax":
        return jstore.MetricStore(**kw)
    return tstore.MetricStore(device="cpu", **kw)


def test_cardinality_cap_and_quarantine_on_the_pool_path():
    """max_series spills first-sight series into the overflow row, which
    keeps their samples; a NaN and a bad rate are quarantined at the
    group. Both packages count alike."""
    from veneur_tpu.samplers import parser as jparser

    lines = [f"h.{i}:{i % 7}.5|h".encode() for i in range(40)] * 3
    seen = []
    for pkg, parser in (("jax", jparser), ("port", tparser)):
        st = _store(pkg, max_series=16)
        for ln in lines:
            st.process_metric(parser.parse_metric(ln))
        g = st.histograms
        g.sample(_key(pkg, 1), [], float("nan"), 1.0)
        g.sample(_key(pkg, 2), [], 1.0, 0.0)
        seen.append((len(g), g.spilled, g.scrubbed, g._overflow_row,
                     dict(st.quarantine.snapshot())))
    assert seen[1] == seen[0]
    assert seen[1][:3] == (16, 25 * 3, 2)
    _, r = g.flush(QS, want_digests=False)
    assert r["count"].sum() == 120.0
    assert r["count"][g._overflow_row] == 75.0


def test_retired_tiered_twin_frees_planes_and_staging():
    st = _store("port", tier_promote_samples=5, tier_promote_intervals=1)
    for i in range(30):
        for _ in range(8):
            st.process_metric(tparser.parse_metric(f"h.{i}:{i}.5|h".encode()))
    retired = st.histograms
    assert len(retired._dense_rows) > 0     # promoted at the drains
    st.flush(QS, HistogramAggregates.from_names(["count"]), 0)
    assert retired.pools == [] and retired._rows is None
    assert retired._dense.digest is None
    assert st.histograms.directory is retired.directory


def test_snapshot_across_tier_assignments_restores_into_any_store():
    """A tiered store with rows in both tiers snapshots; the snapshot
    restores into a dense, a slab and a tiered port store, whose flushes
    hold every count and extremum exactly."""
    src = _store("port", tier_promote_samples=6, tier_promote_intervals=1)
    rng = np.random.default_rng(17)
    lines = []
    for i in range(50):
        n = 12 if i % 5 == 0 else 3
        lines += [f"h.{i}:{v:.4f}|h".encode()
                  for v in rng.gamma(2.0, 20.0, n)]
    for ln in lines:
        src.process_metric(tparser.parse_metric(ln))
    assert 0 < len(src.histograms._dense_rows) < 50   # both tiers
    groups, _ = src.snapshot_state()
    want = src.flush(QS, HistogramAggregates.from_names(
        ["count", "min", "max"]), 0)[0].to_intermetrics()
    want = {(m.name, tuple(m.tags)): m.value for m in want
            if m.name.rpartition(".")[2] in ("count", "min", "max")}
    for storage in ("dense", "slab", "tiered"):
        dst = tstore.MetricStore(initial_capacity=32, chunk=64,
                                 digest_storage=storage, slab_rows=256,
                                 device="cpu")
        assert dst.restore_state(groups) > 0
        got = dst.flush(QS, HistogramAggregates.from_names(
            ["count", "min", "max"]), 0)[0].to_intermetrics()
        got = {(m.name, tuple(m.tags)): m.value for m in got
               if m.name.rpartition(".")[2] in ("count", "min", "max")}
        assert got == want, storage


def test_promotion_landing_mid_snapshot():
    """A promotion between a snapshot's begin and finish does not reach
    the snapshot, which holds the state of its begin."""
    g = ttiered.TieredDigestGroup(slab_rows=256, chunk=8,
                                  promote_samples=10, promote_intervals=1,
                                  device="cpu")
    for v in range(6):
        g.sample(MetricKey("s0", "histogram", ""), [], float(v), 1.0)
    snap, finish = g.snapshot_begin()
    for v in range(20):
        g.sample(MetricKey("s0", "histogram", ""), [], float(v), 1.0)
    assert len(g._dense_rows) == 1
    finish()
    assert snap["count"][0] == 6.0
    assert snap["weights"].sum() == 6.0
    assert g.snapshot_state()["count"][0] == 26.0
