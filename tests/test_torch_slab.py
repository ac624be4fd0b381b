"""The port's slab digest store (``veneur_tpu_torch/core/slab.py``) against
the JAX package's (``veneur_tpu/core/slab.py``) on the CPU.

Inputs are continuous random values made with numpy from a seed, fed to
both packages. Tolerances (``tests/test_pallas.py``'s, across rungs: the
JAX CPU path is its XLA rung with the true arcsin, the port's CPU path
the plain versions of the flush kernels with the asin polynomial):

* counts, sums' inputs, extrema: exact (float32 scatters of the same
  values); sums and reciprocal sums rtol 1e-6 (another summation order);
* per-row digest mass: rtol 1e-6 with float32 planes; with bfloat16
  planes each centroid's weight rounds once, so rtol 2^-8;
* percentiles: within 0.02 x (max - min) of the row;
* ``next_pow2``, ``hbm_bytes``: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.config import Config as JConfig
from veneur_tpu.core import bucketing as jbucketing
from veneur_tpu.core import slab as jslab
from veneur_tpu.core import store as jstore
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.samplers.intermetric import HistogramAggregates as JAggs
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.core import bucketing
from veneur_tpu_torch.core import slab as tslab
from veneur_tpu_torch.core import store as tstore
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates
from veneur_tpu_torch.samplers.parser import MetricKey
from veneur_tpu_torch.server import Server

QS = [0.25, 0.5, 0.9, 0.99]
AGGS = ["min", "max", "count", "sum", "avg", "hmean", "median"]


def _close_pcts(got, want, lo, hi, tol=0.02):
    span = (np.asarray(hi, np.float64) - np.asarray(lo, np.float64))[:, None]
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    both_nan = np.isnan(got) & np.isnan(want)
    ok = both_nan | (np.abs(got - want) <= tol * span + 1e-6)
    assert ok.all(), np.abs(got - want)[~ok]


def _assert_stats(got, want, keys=("count", "min", "max")):
    for k in keys:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 9, 1000, 1 << 20])
def test_next_pow2_equals_jax(n):
    assert bucketing.next_pow2(n) == jbucketing.next_pow2(n)


# -- the bank -----------------------------------------------------------------


def _bank_traffic(rng, n, series, steps=4):
    for step in range(steps):
        rows = rng.integers(0, series, n).astype(np.int32)
        vals = rng.gamma(2.0, 10.0, n).astype(np.float32)
        if step == steps - 1:
            vals += 300.0  # a distribution step: the guard drains (K2)
        yield rows, vals, np.ones(n, np.float32)


@pytest.mark.parametrize("series,slab_rows,dtype", [
    (700, 256, "float32"), (700, 256, "bfloat16"), (520, 512, "float32"),
    (130, 64, "bfloat16")],
    ids=["multi-f32", "multi-bf16", "partial-f32", "partial-bf16"])
def test_local_bank_matches_jax(series, slab_rows, dtype):
    """The local role over several slabs (and a partial last slab): the
    drained digests' mass, the scalar stats and the percentiles."""
    rng = np.random.default_rng(series + slab_rows)
    jb = jslab.SlabDigestBank(series, slab_rows=slab_rows,
                              digest_dtype=jnp.dtype(dtype))
    tb = tslab.SlabDigestBank(series, slab_rows=slab_rows,
                              digest_dtype=dtype, device="cpu")
    assert (tb.slab_rows, tb.num_slabs) == (jb.slab_rows, jb.num_slabs)
    for rows, vals, wts in _bank_traffic(rng, 4 * series, series):
        jb.ingest(rows, vals, wts)
        tb.ingest(rows, vals, wts)
    want = jb.flush(QS, want_digest=True)
    got = tb.flush(QS, want_digest=True)
    _assert_stats(got, want)
    for k in ("sum", "recip"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    _close_pcts(got["percentiles"], want["percentiles"], want["min"],
                want["max"])
    jmass = np.asarray(want["digest_weight"], np.float64).sum(1)
    tmass = np.asarray(got["digest_weight"], np.float64).sum(1)
    np.testing.assert_allclose(tmass, jmass,
                               rtol=1e-6 if dtype == "float32" else 2**-8)
    assert got["digest_weight"].shape == (series, tb.k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_bank_matches_jax(dtype):
    """The merge role: three batches of unsorted imported digests a slab
    through K2's plain version; counts exact (the float32 running count,
    whatever the storage type), extrema exact, percentiles in the
    envelope."""
    rng = np.random.default_rng(11)
    series = 600
    jb = jslab.SlabDigestBank(series, slab_rows=256, mode="merge",
                              digest_dtype=jnp.dtype(dtype))
    tb = tslab.SlabDigestBank(series, slab_rows=256, mode="merge",
                              digest_dtype=dtype, device="cpu")
    assert tb.temps == [None] * tb.num_slabs
    R = tb.slab_rows
    for _ in range(3):
        for i in range(tb.num_slabs):
            # a forwarded batch as bench.py's 2c lane builds it: 104
            # centroids a row, here unsorted and a tenth of them padding
            m = rng.gamma(2.0, 40.0, (R, 104)).astype(np.float32)
            w = (rng.random((R, 104)) > 0.1).astype(np.float32)
            mn = np.where(w > 0, m, np.inf).min(1).astype(np.float32)
            mx = np.where(w > 0, m, -np.inf).max(1).astype(np.float32)
            jb.merge_digests(i, m, w, mn, mx)
            tb.merge_digests(i, m, w, mn, mx)
    want, got = jb.flush(QS), tb.flush(QS)
    assert set(got) == set(want) == {"percentiles", "count", "min", "max"}
    _assert_stats(got, want)
    _close_pcts(got["percentiles"], want["percentiles"], want["min"],
                want["max"])


def test_bank_flush_resets_and_ingest_slab_takes_local_rows():
    tb = tslab.SlabDigestBank(300, slab_rows=128, device="cpu")
    rows = np.array([0, 5, 127, 128, 200], np.int64)   # >= 128: padding
    tb.ingest_slab(1, rows, np.arange(1, 6, dtype=np.float32),
                   np.ones(5, np.float32))
    r = tb.flush(QS)
    assert r["count"][128] == 1.0 and r["count"][133] == 1.0
    assert r["count"][255] == 1.0 and r["count"].sum() == 3.0
    assert tb.flush(QS)["count"].sum() == 0.0


@pytest.mark.parametrize("series,slab_rows,dtype,mode", [
    (4 << 20, 1 << 20, "float32", "local"),
    (10 << 20, 1 << 18, "bfloat16", "local"),
    (10 << 20, 1 << 20, "bfloat16", "merge"),
    (1000, 1 << 20, "float32", "local")])
def test_hbm_bytes_equal_jax(series, slab_rows, dtype, mode, monkeypatch):
    """The capacity plan's accounting, from the constructor's layout
    alone: the plane initializers are stubbed, so nothing is allocated."""
    for mod in (jslab, tslab):
        for init in ("_init_digest_slab", "_init_temp_slab"):
            monkeypatch.setattr(mod, init, lambda *a, **k: None)
    want = jslab.SlabDigestBank(series, slab_rows=slab_rows,
                                digest_dtype=jnp.dtype(dtype),
                                mode=mode).hbm_bytes()
    got = tslab.SlabDigestBank(series, slab_rows=slab_rows,
                               digest_dtype=dtype, mode=mode,
                               device="cpu").hbm_bytes()
    assert got == want


# -- the group ----------------------------------------------------------------


def _key(i):
    return MetricKey(name=f"h{i}", type="histogram", joined_tags="")


def _feed_group(groups, rng, series, per_row, step=0.0, imports=False):
    """The same samples (and imported digests) into every group; returns
    the samples' total weight."""
    rows = np.repeat(np.arange(series, dtype=np.int32), per_row)
    vals = (rng.gamma(2.0, 10.0, len(rows)) + step).astype(np.float32)
    wts = np.where(rng.random(len(rows)) < 0.25, 2.0, 1.0) \
        .astype(np.float32)
    perm = rng.permutation(len(rows))
    for g in groups:
        for i in range(series):
            g._row(_key(i), [])
        g.sample_many(rows[perm], vals[perm], wts[perm])
    if imports:
        for i in range(0, series, 3):
            m = np.sort(rng.gamma(2.0, 12.0, 7)).astype(np.float32)
            w = rng.integers(1, 4, 7).astype(np.float32)
            for g in groups:
                g.import_centroids(_key(i), [], m, w, float(m[0]) - 1.0,
                                   float(m[-1]) + 1.0)
    return float(wts.sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_flush_matches_jax(dtype):
    """SlabDigestGroup across 64-row slabs (it grows as rows intern),
    samples at two weights, imported digests and a distribution step
    over two intervals; the second flush also returns the planes."""
    rng = np.random.default_rng(5)
    jg = jslab.SlabDigestGroup(slab_rows=64, chunk=512,
                               digest_dtype=jnp.dtype(dtype))
    tg = tslab.SlabDigestGroup(slab_rows=64, chunk=512, digest_dtype=dtype,
                               device="cpu")
    for interval in range(2):
        _feed_group([jg, tg], rng, 150, 12, imports=True)
        _feed_group([jg, tg], rng, 150, 6, step=400.0 * interval)
        assert tg.capacity == jg.capacity == 192
        _, want = jg.flush(QS, want_digests=bool(interval))
        _, got = tg.flush(QS, want_digests=bool(interval))
        _assert_stats(got, want)
        np.testing.assert_allclose(got["sum"], want["sum"], rtol=1e-6)
        _close_pcts(got["percentiles"], want["percentiles"], want["min"],
                    want["max"])
        if interval:
            jmass = np.asarray(want["digest_weight"], np.float64).sum(1)
            tmass = got["digest_weight"].astype(np.float64).sum(1)
            np.testing.assert_allclose(
                tmass, jmass, rtol=1e-6 if dtype == "float32" else 2**-8)
            np.testing.assert_array_equal(got["digest_min"],
                                          want["digest_min"])


def test_unfetched_stats_zero_filled():
    rng = np.random.default_rng(8)
    g = tslab.SlabDigestGroup(slab_rows=64, chunk=128, device="cpu")
    total = _feed_group([g], rng, 70, 5)
    _, r = g.flush(QS, want_stats=("count",))
    assert r["count"].sum() == total
    for k in ("sum", "min", "max", "recip", "median"):
        assert not r[k].any() and not r[k].flags.writeable, k
    assert r["percentiles"].shape == (70, len(QS))


class TestRetiredRelease:
    def _retired(self, n):
        g = tslab.SlabDigestGroup(slab_rows=64, chunk=128, device="cpu")
        _feed_group([g], np.random.default_rng(3), n, 3) if n else None
        g._retired = True
        return g

    @pytest.mark.parametrize("n", [100, 0], ids=["with-rows", "empty"])
    def test_retired_slab_twin_frees_planes_and_staging(self, n):
        g = self._retired(n)
        g.flush(QS)
        assert g.digests == [] and g.temps == []
        assert g._rows is None and g._imp_rows is None
        assert g._fill == g._imp_fill == g._imp_stat_fill == 0
        g._drain_staging()   # a stray drain on the dead twin is a no-op

    def test_live_group_keeps_staging(self):
        g = tslab.SlabDigestGroup(slab_rows=64, chunk=128, device="cpu")
        _feed_group([g], np.random.default_rng(4), 100, 3)
        g.flush(QS)
        assert len(g.digests) == 2 and g._rows is not None

    def test_store_flush_releases_the_retired_generation(self):
        store = tstore.MetricStore(initial_capacity=32, chunk=128,
                                   digest_storage="slab", slab_rows=64,
                                   device="cpu")
        for i in range(90):
            store.process_metric(tparser.parse_metric(
                f"h.{i}:{i}.5|h".encode()))
        retired = store.histograms
        store.flush(QS, HistogramAggregates.from_names(AGGS), 0)
        assert retired.digests == [] and retired._rows is None
        assert store.histograms is not retired
        assert len(store.histograms.digests) == 1


def test_snapshot_holds_the_state_of_its_begin():
    """The slab snapshot copies its planes under the lock: samples
    ingested between begin and finish do not reach it."""
    g = tslab.SlabDigestGroup(slab_rows=64, chunk=16, device="cpu")
    rng = np.random.default_rng(2)
    first = _feed_group([g], rng, 80, 4)
    snap, finish = g.snapshot_begin()
    second = _feed_group([g], rng, 80, 4, step=50.0)
    g._drain_staging()
    finish()
    assert snap["count"].sum() == first
    np.testing.assert_allclose(snap["weights"].sum(), first)
    assert g.snapshot_state()["count"].sum() == first + second


# -- the store and the server -------------------------------------------------


def _samples(lines):
    """(name, joined tags) -> (values, weights) of the digest lines."""
    out = {}
    for ln in lines:
        m = tparser.parse_metric(ln)
        if m.key.type in ("histogram", "timer"):
            vals, wts = out.setdefault((m.key.name, m.key.joined_tags),
                                       ([], []))
            vals.append(float(m.value))
            wts.append(1.0 / m.sample_rate)
    return out


def _rank_err(v, q, vals, wts):
    """How far q lies outside the weighted rank bracket of v."""
    order = np.argsort(vals)
    x, w = np.asarray(vals)[order], np.asarray(wts)[order]
    total = w.sum()
    lo = w[x < v].sum() / total
    hi = w[x <= v].sum() / total
    return max(0.0, lo - q, q - hi)


def assert_rank_excess(got, want, samples, limit=0.15):
    """Percentile rows of a tiered store against a dense one: the rank
    error a row's percentile adds over the dense row's, at most
    ``limit`` (bench.py's 2g gate: the pool's k-scale at compression
    PK - 2 = 14 caps a cluster's mass near 2/C)."""
    worst = 0.0
    for (name, tags, _), w in want.items():
        base, _, suffix = name.rpartition(".")
        if suffix == "median":
            q = 0.5
        elif suffix.endswith("percentile"):
            q = float(suffix[:-len("percentile")]) / 100.0
        else:
            continue
        vals, wts = samples[(base, ",".join(tags))]
        excess = (_rank_err(got[(name, tags, "gauge")], q, vals, wts)
                  - _rank_err(w, q, vals, wts))
        worst = max(worst, excess)
    assert worst <= limit, worst
    return worst


def _stream(seed, step):
    """Histograms and timers in every scope, counters and sets beside
    them; with ``step`` a burst of shifted samples (the guard drains)."""
    rng = np.random.default_rng(seed)
    scopes = ("", "|#veneurlocalonly", "|#env:a,zone:b")
    lines = []
    for kind, t in (("h", "h"), ("t", "ms")):
        for i in range(90):
            rate = "|@0.5" if i % 4 == 0 else ""
            lines += [f"{kind}.{i}:{v:.5f}|{t}{rate}{scopes[i % 3]}"
                      for v in rng.gamma(2.0, 10.0, int(rng.integers(4, 30)))]
    lines += [f"c.{i}:{i}|c" for i in range(20)]
    lines += [f"s.{i}:m{j}|s" for i in range(10) for j in range(i + 3)]
    lines = [lines[j] for j in rng.permutation(len(lines))]
    if step:
        lines += [f"h.{i}:{v:.5f}|h{scopes[i % 3]}" for i in range(90)
                  for v in 800.0 + rng.gamma(2.0, 10.0, 6)]
    return [ln.encode() for ln in lines]


def _rows_by_key(rows):
    return {(m.name, tuple(m.tags), m.type.value): m.value for m in rows}


def assert_rows_match(got_rows, want_rows):
    """Store rows: counts, extrema, counters, set estimates exact or at
    float32 rtol 1e-6; sums rtol 1e-6; percentiles in the envelope."""
    got, want = _rows_by_key(got_rows), _rows_by_key(want_rows)
    assert set(got) == set(want)
    for key, w in want.items():
        name, tags, _ = key
        base, _, suffix = name.rpartition(".")
        g = got[key]
        if suffix in ("count", "min", "max") or name.startswith("c."):
            assert g == w, key
        elif suffix in ("sum", "avg", "hmean") or name.startswith("s."):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=str(key))
        else:
            lo = want[(f"{base}.min", tags, "gauge")]
            hi = want[(f"{base}.max", tags, "gauge")]
            assert abs(g - w) <= 0.02 * (hi - lo) + 1e-6, key


def _port_store(storage, initial_capacity=32, **kw):
    return tstore.MetricStore(initial_capacity=initial_capacity, chunk=256,
                              digest_storage=storage, slab_rows=64,
                              device="cpu", **kw)


def _jax_store(storage, initial_capacity=32, **kw):
    return jstore.MetricStore(initial_capacity=initial_capacity, chunk=256,
                              digest_storage=storage, slab_rows=64, **kw)


def _flush_port(store):
    out, _ = store.flush(QS, HistogramAggregates.from_names(AGGS), 0)
    return out.to_intermetrics()


def _flush_jax(store):
    out, _, _ = store.flush(QS, JAggs.from_names(AGGS), is_local=False,
                            now=0, forward=False)
    return out


@pytest.mark.parametrize("storage,kw", [
    ("slab", {}), ("slab", {"digest_dtype": "bfloat16"}),
    ("tiered", {"tier_promote_samples": 10, "tier_promote_intervals": 1})],
    ids=["slab-f32", "slab-bf16", "tiered"])
def test_store_matches_jax(storage, kw):
    """Both packages' MetricStore on the same lines, three intervals (the
    second with the step): the flushed rows."""
    j, t = _jax_store(storage, **kw), _port_store(storage, **kw)
    for interval in range(3):
        for ln in _stream(30 + interval, step=interval == 1):
            j.process_metric(jparser.parse_metric(ln))
            t.process_metric(tparser.parse_metric(ln))
        assert_rows_match(_flush_port(t), _flush_jax(j))


def _rank_excess(got, want, samples) -> dict:
    """Per percentile row: the rank error ``got`` adds over ``want``."""
    out = {}
    for (name, tags, _), w in want.items():
        base, _, suffix = name.rpartition(".")
        if suffix == "median":
            q = 0.5
        elif suffix.endswith("percentile"):
            q = float(suffix[:-len("percentile")]) / 100.0
        else:
            continue
        vals, wts = samples[(base, ",".join(tags))]
        out[name, tags] = (_rank_err(got[(name, tags, "gauge")], q, vals,
                                     wts) - _rank_err(w, q, vals, wts))
    return out


def test_dense_slab_tiered_agree_in_the_port():
    """One port MetricStore a storage on the same lines, two intervals.
    Slab against dense: the cross-rung bounds. Tiered against dense:
    counts and extrema exact, sums rtol 1e-6, and each percentile's rank
    error over the dense row no more than the JAX package's own tiered
    store adds over its dense one, plus 0.02 (the pool keeps PK = 16
    centroids a row at compression 14, so the two storages differ in
    the reference too). The dense groups start at their final capacity:
    a dense group's growth drains its staging and a slab's does not, and
    other drain boundaries bin otherwise (a pinned difference, ROADMAP
    section 3, alike in the JAX package)."""
    kw = dict(initial_capacity=128, tier_promote_samples=10,
              tier_promote_intervals=1)
    stores = {s: _port_store(s, **kw) for s in ("dense", "slab", "tiered")}
    jstores = {s: _jax_store(s, **kw) for s in ("dense", "tiered")}
    for interval in range(2):
        lines = _stream(40 + interval, step=interval == 1)
        for ln in lines:
            for st in stores.values():
                st.process_metric(tparser.parse_metric(ln))
            for st in jstores.values():
                st.process_metric(jparser.parse_metric(ln))
        rows = {s: _flush_port(st) for s, st in stores.items()}
        jrows = {s: _rows_by_key(_flush_jax(st))
                 for s, st in jstores.items()}
        assert_rows_match(rows["slab"], rows["dense"])
        got, want = _rows_by_key(rows["tiered"]), _rows_by_key(rows["dense"])
        assert set(got) == set(want)
        for key, w in want.items():
            suffix = key[0].rpartition(".")[2]
            if suffix in ("count", "min", "max"):
                assert got[key] == w, key
            elif suffix in ("sum", "avg", "hmean"):
                np.testing.assert_allclose(got[key], w, rtol=1e-6)
        samples = _samples(lines)
        ours = _rank_excess(got, want, samples)
        ref = _rank_excess(jrows["tiered"], jrows["dense"], samples)
        assert ours.keys() == ref.keys()
        bad = {k: (v, ref[k]) for k, v in ours.items() if v > ref[k] + 0.02}
        assert not bad, bad


def _forward(storage, lines):
    """A forwarding local of ``storage`` fed ``lines``, flushed with
    packed digests; returns its forwarded digests by series."""
    local = _port_store(storage, initial_capacity=128,
                        tier_promote_samples=10, tier_promote_intervals=1)
    for ln in lines:
        local.process_metric(tparser.parse_metric(ln))
    _, fwd = local.flush(QS, HistogramAggregates.from_names(AGGS), 0,
                         is_local=True, digest_format="packed")
    fwd.materialize_digests()
    return {(t, n, ",".join(tg)): (tg, m, w, lo, hi)
            for t, rows in (("histogram", fwd.histograms),
                            ("timer", fwd.timers))
            for n, tg, m, w, lo, hi in rows}


@pytest.mark.parametrize("storage", ["slab", "tiered"])
def test_packed_forward_imported_by_a_dense_store(storage):
    """A forwarding local of each storage flushes packed digests (u16
    means, bfloat16 weights); a dense port global imports them. Against
    the dense local's forward: the same series, each digest's weight
    within bfloat16 rounding (2^-8), its extrema exact; the global's
    percentiles within 0.02 x the digest's span for slab, within the
    pool's rank envelope for tiered."""
    lines = _stream(50, step=False)
    fwds = {s: _forward(s, lines) for s in ("dense", storage)}
    got, want = fwds[storage], fwds["dense"]
    assert set(got) == set(want) and len(want) > 100
    for key, (_, wm, ww, wlo, whi) in want.items():
        _, gm, gw, glo, ghi = got[key]
        assert gw.sum() == pytest.approx(ww.sum(), rel=2**-8), key
        assert (glo, ghi) == (wlo, whi), key
    rows = {}
    for s, fwd in fwds.items():
        glob = _port_store("dense")
        glob.import_digests_bulk([
            (MetricKey(n, t, j), tg, m, w, lo, hi)
            for (t, n, j), (tg, m, w, lo, hi) in fwd.items()])
        rows[s] = _rows_by_key(_flush_port(glob))
    assert set(rows[storage]) == set(rows["dense"])
    if storage == "tiered":
        assert_rank_excess(rows[storage], rows["dense"], _samples(lines))
        return
    for (name, tags, tname), w in rows["dense"].items():
        base = name.rpartition(".")[0]
        kind = "timer" if base.startswith("t.") else "histogram"
        _, _, _, lo, hi = want[(kind, base, ",".join(tags))]
        assert abs(rows[storage][(name, tags, tname)] - w) <= \
            0.02 * (hi - lo) + 1e-6, name


def _jax_config(**kw):
    cfg = JConfig(**kw)
    cfg.apply_defaults()
    cfg.validate()
    return cfg


def test_config_keys_and_defaults_equal_jax():
    """The seven keys with the JAX package's defaults."""
    keys = ("digest_storage", "digest_dtype", "slab_rows",
            "tier_pool_centroids", "tier_promote_samples",
            "tier_promote_intervals", "tier_demote_intervals")
    got, want = Config(), _jax_config()
    for k in keys:
        assert getattr(got, k) == getattr(want, k), k


BAD = [{"digest_storage": "sparse"}, {"tier_pool_centroids": 12},
       {"tier_pool_centroids": 4}, {"tier_promote_samples": -1},
       {"tier_demote_intervals": -2}, {"digest_dtype": "float16"},
       {"digest_dtype": "bfloat16"},
       {"digest_dtype": "bfloat16", "digest_storage": "tiered"},
       {"slab_rows": 0}]


@pytest.mark.parametrize("kw", BAD, ids=[str(b) for b in BAD])
def test_config_validation_messages_equal_jax(kw):
    with pytest.raises(ValueError) as want:
        _jax_config(**kw)
    with pytest.raises(ValueError) as got:
        Config(**kw)
    assert str(got.value) == str(want.value)


def test_server_threads_the_storage_knobs():
    cfg = Config(digest_storage="slab", digest_dtype="bfloat16",
                 slab_rows=128, store_initial_capacity=16,
                 flush_pipeline_depth=3)
    server = Server(cfg, device="cpu")
    for name in tstore._DIGEST_GROUPS:
        g = getattr(server.store, name)
        assert isinstance(g, tslab.SlabDigestGroup), name
        assert (g.slab_rows, g.digest_dtype) == (128, torch.bfloat16)
        assert g._pipeline_window == 3
    cfg = Config(digest_storage="tiered", slab_rows=1 << 20,
                 tier_pool_centroids=32, tier_promote_samples=5,
                 tier_promote_intervals=4, tier_demote_intervals=6)
    g = Server(cfg, device="cpu").store.timers
    assert (g.slab_rows, g.pk, g.promote_samples) == (1 << 18, 32, 5)
    d = g.directory
    assert (d.promote_intervals, d.demote_intervals) == (4, 6)
    assert g.fresh().directory is d
