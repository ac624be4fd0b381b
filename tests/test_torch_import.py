"""The port's import path (a global merging forwarded state) against the
JAX package's.

The same seeded forwarded state (digests as sorted centroid runs with
their extrema, HLL registers, counters, gauges) is imported into a JAX
MetricStore and a port MetricStore(device="cpu"), both with chunk=64 so
that staging drains and shift-guard drains happen mid-batch, and both
flush once as a global. Tolerances:

* counters, gauges, imported extrema, registers: exact;
* set estimates: rtol 1e-6 (one float32 ulp, as in test_torch_store);
* percentiles: within 0.02 x (max - min) of the series' centroids, the
  cross-rung envelope (the JAX CPU flush is its XLA rung, the port's the
  plain flush-kernel version);
* count/min/max of rows sampled on the global: exact.
"""

import base64

import numpy as np
import pytest

from veneur_tpu.core import store as jstore
from veneur_tpu.forward import convert as jconvert
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.samplers.intermetric import HistogramAggregates as JAggs
from veneur_tpu_torch.core import store as tstore
from veneur_tpu_torch.forward import convert as tconvert
from veneur_tpu_torch.ops import tdigest as ttd
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates

PCTS = [0.25, 0.5, 0.99]
AGGS = ["min", "max", "count", "median"]
CHUNK = 64
P = 10  # HLL precision of these tests: 1 KiB a set


def forwarded_digests(seed, n=120, shift=0.0):
    """[(name, type, tags, means, weights, dmin, dmax)]: sorted centroid
    runs of 0..24 centroids (some empty), weights 1..4."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(0, 25)) if i % 10 else 0
        means = np.sort(shift + rng.gamma(2.0, 10.0, k))
        weights = rng.integers(1, 5, k).astype(np.float64)
        if k:
            dmin = float(means[0] - rng.uniform(0.0, 1.0))
            dmax = float(means[-1] + rng.uniform(0.0, 1.0))
        else:
            dmin, dmax = float("inf"), float("-inf")
        out.append((f"d.{i}", "timer" if i % 3 == 0 else "histogram",
                    [f"k:{i % 4}"], means, weights, dmin, dmax))
    return out


def forwarded_sets(seed, n=20, p=P):
    rng = np.random.default_rng(seed)
    return [(f"s.{i}", [], rng.integers(0, 12, 1 << p).astype(np.uint8))
            for i in range(n)]


def entries(pkg, digests):
    key = (jparser if pkg == "jax" else tparser).MetricKey
    return [(key(name, typ, ",".join(tags)), tags, means, weights, dmin,
             dmax) for name, typ, tags, means, weights, dmin, dmax in digests]


def stores():
    return (jstore.MetricStore(chunk=CHUNK, hll_precision=P),
            tstore.MetricStore(chunk=CHUNK, hll_precision=P, device="cpu"))


def flush_both(j, t, is_local=False):
    jrows, jfwd, _ = j.flush(PCTS, JAggs.from_names(AGGS), is_local=is_local,
                             now=0)
    trows, tfwd = t.flush(PCTS, HistogramAggregates.from_names(AGGS), 0,
                          is_local=is_local)
    return (jrows, jfwd), (trows.to_intermetrics(), tfwd)


def by_key(rows):
    out = {}
    for m in rows:
        key = (m.name, tuple(m.tags), m.type.value)
        assert key not in out, key
        out[key] = m.value
    return out


def assert_globals_match(trows, jrows, spans):
    """Port global vs JAX global emissions; ``spans`` maps a digest name
    to the (min, max) of its merged centroids."""
    p, j = by_key(trows), by_key(jrows)
    assert set(p) == set(j)
    for key, want in j.items():
        name = key[0]
        base, _, suffix = name.rpartition(".")
        got = p[key]
        if name.startswith("s."):
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=key)
        elif np.isnan(want):  # a digest that imported no centroid
            assert np.isnan(got), key
        elif suffix == "median" or suffix.endswith("percentile"):
            lo, hi = spans[base]
            assert abs(got - want) <= 0.02 * (hi - lo) + 1e-6, key
        else:
            assert got == want, key


def spans_of(*digest_lists):
    spans = {}
    for digests in digest_lists:
        for name, _, _, means, _, _, _ in digests:
            if len(means):
                lo, hi = spans.get(name, (np.inf, -np.inf))
                spans[name] = (min(lo, means.min()), max(hi, means.max()))
    return spans


def import_all(store, pkg, digests, sets, bulk):
    key = (jparser if pkg == "jax" else tparser).MetricKey
    if bulk:
        store.import_digests_bulk(entries(pkg, digests))
    else:
        for e in entries(pkg, digests):
            store.import_digest(*e)
    for name, tags, regs in sets:
        store.import_set(key(name, "set", ""), tags, regs)
    for i in range(10):
        store.import_counter(key(f"c.{i}", "counter", ""), [], 7 * i - 20)
        store.import_gauge(key(f"g.{i}", "gauge", ""), [], 0.5 * i)


@pytest.mark.parametrize("bulk", [True, False], ids=["bulk", "single"])
def test_imports_match_jax_global(bulk, monkeypatch):
    """Two forwarded states (the second shifted, so its digests trip the
    shift guard) merge into the same emissions on both packages."""
    drains = []
    real_drain = ttd.drain_temp
    monkeypatch.setattr(ttd, "drain_temp",
                        lambda *a: drains.append(1) or real_drain(*a))
    first, second = forwarded_digests(1), forwarded_digests(2, shift=500.0)
    j, t = stores()
    for digests, seed in ((first, 3), (second, 4)):
        for store, pkg in ((j, "jax"), (t, "port")):
            import_all(store, pkg, digests, forwarded_sets(seed), bulk)
    assert drains, "the shifted import did not trip the guard"
    assert t.imported == j.imported == 2 * (120 + 20 + 20)
    (jrows, _), (trows, _) = flush_both(j, t)
    assert_globals_match(trows, jrows, spans_of(first, second))
    # imported-only rows emit no count/min/max on either package
    assert not [m for m in trows if m.name.endswith((".count", ".min"))]


def test_apply_json_metric_one_at_a_time():
    """apply_json_metric (one entry per call, import_digest for a
    digest) merges a body of both formats as the JAX package's does."""
    rng = np.random.default_rng(13)
    digests = forwarded_digests(6, n=30)
    sets = forwarded_sets(7, n=4)

    def entries_of(conv, ref):
        from veneur_tpu_torch.core.store import ForwardableState

        st = ForwardableState(
            counters=[("c.a", ["x:1"], 5), ("c.b", [], -2)],
            gauges=[("g.a", [], float(rng.normal()))],
            histograms=[(n, t, m, w, lo, hi) for n, typ, t, m, w, lo, hi
                        in digests if typ == "histogram"],
            timers=[(n, t, m, w, lo, hi) for n, typ, t, m, w, lo, hi
                    in digests if typ == "timer"],
            sets=[(n, t, r, P) for n, t, r in sets])
        return (conv.reference_json_metrics_from_state(st) if ref
                else conv.json_metrics_from_state(st))

    for ref in (False, True):
        body = entries_of(tconvert, ref)
        j, t = stores()
        for d in body:
            jconvert.apply_json_metric(j, d)
            tconvert.apply_json_metric(t, d)
        assert t.imported == j.imported == len(body)
        (jrows, _), (trows, _) = flush_both(j, t)
        assert_globals_match(trows, jrows, spans_of(digests))


def test_row_runs_never_straddle_a_drain(monkeypatch):
    """Runs of 20 centroids into a 64-slot staging buffer: a plain fill
    would split every fourth run across two drains. Each row's run lands
    in one drain, and both packages drain the same row sets."""
    seen = {"jax": [], "port": []}
    jreal, treal = jstore._ingest_centroids, tstore._ingest_centroids

    def jspy(digest, temp, dmin, dmax, rows, *rest):
        r = np.asarray(rows)
        seen["jax"].append(sorted(set(r[r < temp.sum_w.shape[0]].tolist())))
        return jreal(digest, temp, dmin, dmax, rows, *rest)

    def tspy(digest, temp, dmin, dmax, rows, *rest):
        r = rows.numpy()
        seen["port"].append(sorted(set(r[r < temp.sum_w.shape[0]].tolist())))
        return treal(digest, temp, dmin, dmax, rows, *rest)

    monkeypatch.setattr(jstore, "_ingest_centroids", jspy)
    monkeypatch.setattr(tstore, "_ingest_centroids", tspy)
    rng = np.random.default_rng(5)
    digests = [(f"r.{i}", "histogram", [], np.sort(rng.gamma(2, 10, 20)),
                np.ones(20), 0.0, 100.0) for i in range(30)]
    j, t = stores()
    j.import_digests_bulk(entries("jax", digests))
    t.import_digests_bulk(entries("port", digests))
    j.histograms._drain_staging()
    t.histograms._drain_staging()
    assert seen["port"] == seen["jax"]
    rows = [r for drain in seen["port"] for r in drain]
    assert sorted(rows) == list(range(30))  # no row in two drains
    assert len(seen["port"]) == 10          # three runs of 20 per drain


def test_pad_sentinels_never_reach_extrema():
    """The stat triples are padded to a power of two with row ==
    capacity and +inf/-inf; the port masks them onto row 0 with the
    identity of min/max, so row 0 (never imported) keeps +inf/-inf."""
    j, t = stores()
    for store, key in ((j, jparser.MetricKey), (t, tparser.MetricKey)):
        store.histograms.sample(key("local", "histogram", ""), [], 1.0, 1.0)
    digests = [(f"x.{i}", "histogram", [], np.array([5.0 + i]),
                np.array([1.0]), -3.0 - i, 40.0 + i) for i in range(5)]
    j.import_digests_bulk(entries("jax", digests))
    t.import_digests_bulk(entries("port", digests))
    j.histograms._drain_staging()
    t.histograms._drain_staging()
    tmin, tmax = t.histograms.dmin.numpy(), t.histograms.dmax.numpy()
    np.testing.assert_array_equal(tmin, np.asarray(j.histograms.dmin))
    np.testing.assert_array_equal(tmax, np.asarray(j.histograms.dmax))
    assert tmin[0] == np.inf and tmax[0] == -np.inf
    np.testing.assert_array_equal(tmin[1:6], -3.0 - np.arange(5))
    assert (tmin[6:] == np.inf).all() and (tmax[6:] == -np.inf).all()


def test_imported_rows_keep_local_stats():
    """update_stats=False: imported centroids never touch count/sum/min/
    max. A row sampled on the global AND imported emits the local
    samples' count/min/max; an imported-only row emits none."""
    j, t = stores()
    local = [1.5, 2.5, 40.0]
    for store, key in ((j, jparser.MetricKey), (t, tparser.MetricKey)):
        for v in local:
            store.histograms.sample(key("mix", "histogram", ""), [], v, 1.0)
    digests = [("mix", "histogram", [], np.array([-7.0, 3.0, 90.0]),
                np.array([2.0, 3.0, 1.0]), -8.0, 95.0),
               ("only", "histogram", [], np.array([10.0, 20.0]),
                np.array([1.0, 1.0]), 9.0, 21.0)]
    j.import_digests_bulk(entries("jax", digests))
    t.import_digests_bulk(entries("port", digests))
    (jrows, _), (trows, _) = flush_both(j, t)
    p = by_key(trows)
    assert p[("mix.count", (), "counter")] == 3.0
    assert p[("mix.min", (), "gauge")] == 1.5
    assert p[("mix.max", (), "gauge")] == 40.0
    assert ("only.count", (), "counter") not in p
    assert ("only.min", (), "gauge") not in p
    assert_globals_match(trows, jrows, {"mix": (-8.0, 95.0),
                                        "only": (9.0, 21.0)})
    # the percentiles still see the imported extrema (dmin/dmax)
    assert p[("mix.25percentile", (), "gauge")] < 1.5


def test_duplicate_set_rows_max_combine():
    """Two imports of one set in the same batch (before the drain) merge
    to their elementwise max, like the JAX package's scatter-max."""
    rng = np.random.default_rng(9)
    a, b = (rng.integers(0, 20, 1 << P).astype(np.uint8) for _ in range(2))
    j, t = stores()
    for store, key in ((j, jparser.MetricKey), (t, tparser.MetricKey)):
        store.import_set(key("dup", "set", ""), [], a)
        store.import_set(key("other", "set", ""), [], b)
        store.import_set(key("dup", "set", ""), [], b)
        store.sets._drain_staging()
    got = t.sets.registers.numpy()[:2].view(np.uint8)
    np.testing.assert_array_equal(got[0], np.maximum(a, b))
    np.testing.assert_array_equal(got[1], b)
    np.testing.assert_array_equal(
        got, np.asarray(j.sets.registers)[:2].view(np.uint8))


def test_precision_mismatch_rejected_per_metric():
    """A set at the wrong precision fails alone; the rest of the body
    merges, with the same counts as the JAX package. A heavy-hitter
    sketch whose count-min table has another shape than the store's is
    one more error in both packages (the import's shape check)."""
    good = [{"name": f"s.{i}", "tags": [], "type": "set",
             "hll": base64.b64encode(tconvert.encode_hll(
                 np.full(1 << P, i + 1, np.uint8), P)).decode()}
            for i in range(4)]
    bad = dict(good[0], name="s.bad",
               hll=base64.b64encode(tconvert.encode_hll(
                   np.ones(1 << (P + 1), np.uint8), P + 1)).decode())
    body = good[:2] + [bad] + good[2:] + [
        {"name": "c", "tags": [], "type": "counter", "value": 5}]
    j, t = stores()
    assert jconvert.apply_json_metric_list(j, body) == (5, 1)
    assert tconvert.apply_json_metric_list(t, body) == (5, 1)
    with pytest.raises(ValueError, match="precision"):
        t.import_set(tparser.MetricKey("s.bad", "set", ""), [],
                     np.ones(1 << (P + 1), np.uint8))
    topk = {"type": "topk_sketch", "name": "veneur.topk", "tags": [],
            "depth": 1, "width": 1, "table": "AAAAAA==", "series": []}
    assert jconvert.apply_json_metric_list(j, [topk]) == (0, 1)
    assert tconvert.apply_json_metric_list(t, [topk]) == (0, 1)
    with pytest.raises(ValueError, match="count-min shape"):
        t.import_topk(np.zeros((1, 1), np.float32), [])
    (jrows, _), (trows, _) = flush_both(j, t)
    assert_globals_match(trows, jrows, {})


def test_concurrent_imports_and_flushes_conserve_counts():
    """Import workers (more threads than cores, a short switch interval)
    merge bodies while another thread flushes over and over: imports
    run under the store lock and the flush drains a retired generation,
    so every imported counter lands in exactly one flush."""
    import sys
    import threading

    workers, bodies = 8, 12
    t = tstore.MetricStore(chunk=CHUNK, hll_precision=P, device="cpu")
    body = [{"name": f"c.{i}", "tags": [], "type": "counter", "value": i + 1}
            for i in range(20)]
    body += [{"name": f"d.{i}", "tags": [], "type": "histogram",
              "digest": {"min": 1.0, "max": 9.0,
                         "centroids": [[1.0, 1.0], [5.0, 2.0], [9.0, 1.0]]}}
             for i in range(10)]
    aggs = HistogramAggregates.from_names(AGGS)
    emitted, errors = [], []
    done = threading.Event()

    def importer():
        try:
            for _ in range(bodies):
                assert tconvert.apply_json_metric_list(t, body) == (30, 0)
        except Exception as e:  # reported below
            errors.append(e)

    def flusher():
        while not done.is_set():
            emitted.extend(t.flush(PCTS, aggs, 0)[0].to_intermetrics())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=importer) for _ in range(workers)]
        flush_thread = threading.Thread(target=flusher)
        flush_thread.start()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        done.set()
        flush_thread.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert not flush_thread.is_alive()
    assert not any(th.is_alive() for th in threads)
    emitted.extend(t.flush(PCTS, aggs, 0)[0].to_intermetrics())
    totals = {}
    for m in emitted:
        if m.name.startswith("c."):
            totals[m.name] = totals.get(m.name, 0) + m.value
    assert totals == {f"c.{i}": (i + 1) * workers * bodies
                      for i in range(20)}
    assert {m.name for m in emitted if m.name.startswith("d.")} == {
        f"d.{i}.{s}" for i in range(10)
        for s in ("median", "25percentile", "50percentile",
                  "99percentile")}
