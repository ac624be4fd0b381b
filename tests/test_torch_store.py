"""The port's MetricStore against the JAX package's MetricStore.

One seeded stream of DogStatsD lines (counters with sample rates, gauges,
histograms, timers and sets, in local, global and default scopes, over a
few hundred series and two flush intervals, the second with a
distribution step that trips the shift guard) is parsed by both parsers
and fed to a JAX MetricStore and a port MetricStore(device="cpu"). The
flushed InterMetrics match by name, tags and type:

* counters, gauges, histogram count/min/max: exact;
* sum/avg/hmean: rtol 1e-6 (float32 sums in another order);
* set estimates: rtol 1e-6 (one float32 ulp: XLA's float32 log is not
  correctly rounded, the port's is);
* percentiles and median: within 0.02 x (max - min) of the series, the
  cross-rung envelope (the JAX CPU path is its XLA rung with the true
  arcsin, the port's CPU path the plain flush-kernel version).

convert.py is held to the same bounds: a JAX group's fetched planes,
loaded into a port group, flush to the same rows.
"""

import numpy as np
import pytest

from veneur_tpu.core import store as jstore
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.samplers.intermetric import HistogramAggregates as JAggs
from veneur_tpu_torch import convert
from veneur_tpu_torch.core import store as tstore
from veneur_tpu_torch.ops import tdigest as ttd
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates

PCTS = [0.5, 0.9, 0.99]
AGGS = ["min", "max", "count", "sum", "avg", "hmean", "median"]
CHUNK = 64
SCOPES = ("", "|#veneurlocalonly", "|#veneurglobalonly", "|#env:a,zone:b")


def stream(seed: int, step: bool):
    """One interval of lines. With ``step`` the digest series get a burst
    of shifted samples after their stationary ones."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(80):
        for _ in range(int(rng.integers(1, 6))):
            rate = ("", "|@0.5", "|@0.25")[int(rng.integers(0, 3))]
            lines.append(f"c.{i}:{int(rng.integers(1, 9))}|c{rate}"
                         f"{SCOPES[i % 4]}")
    for i in range(50):
        for _ in range(3):
            lines.append(f"g.{i}:{rng.normal(0, 100):.6f}|g{SCOPES[i % 4]}")
    for kind, t in (("h", "h"), ("t", "ms")):
        for i in range(60):
            for _ in range(int(rng.integers(10, 20))):
                rate = "|@0.5" if i % 3 == 0 else ""
                lines.append(f"{kind}.{i}:{rng.gamma(2.0, 10.0):.6f}|{t}"
                             f"{rate}{SCOPES[i % 4]}")
    for i in range(50):
        for _ in range(30):
            lines.append(f"s.{i}:m{int(rng.integers(0, 40 + 10 * i))}|s"
                         f"{SCOPES[i % 4]}")
    order = rng.permutation(len(lines))
    lines = [lines[j] for j in order]
    if step:
        for i in range(60):
            v = 500.0 + rng.gamma(2.0, 10.0, 4)
            lines.extend(f"h.{i}:{x:.6f}|h{SCOPES[i % 4]}" for x in v)
    return [ln.encode() for ln in lines]


def _flush_jax(store):
    out, _, _ = store.flush(PCTS, JAggs.from_names(AGGS), is_local=False,
                            now=0, forward=False)
    return out


def _flush_port(store):
    return store.flush(PCTS, HistogramAggregates.from_names(AGGS), 0)


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
        elif suffix in ("sum", "avg", "hmean"):
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=key)
        else:
            assert suffix == "median" or suffix.endswith("percentile"), key
            lo = j[(f"{base}.min", tags, "gauge")]
            hi = j[(f"{base}.max", tags, "gauge")]
            assert abs(got - want) <= 0.02 * (hi - lo) + 1e-6, key


def test_two_intervals_match(monkeypatch):
    drains = []
    real_drain = ttd.drain_temp

    def counting_drain(*args):
        drains.append(args[0].mean.shape)
        return real_drain(*args)

    monkeypatch.setattr(ttd, "drain_temp", counting_drain)
    j = jstore.MetricStore(chunk=CHUNK)
    t = tstore.MetricStore(chunk=CHUNK, device="cpu")
    for interval, step in ((0, False), (1, True)):
        drains.clear()
        for line in stream(100 + interval, step):
            j.process_metric(jparser.parse_metric(line))
            t.process_metric(tparser.parse_metric(line))
        if step:
            assert drains, "the distribution step did not trip the guard"
        assert_flushes_match(_flush_port(t), _flush_jax(j))


def test_swap_generation_never_aliases():
    """The retired generation's planes share no storage with the live
    generation's (what the JAX package's donation-safety pass guards)."""
    t = tstore.MetricStore(initial_capacity=8, chunk=16, device="cpu")
    for line in stream(7, False)[:400]:
        t.process_metric(tparser.parse_metric(line))
    with t._lock:
        gen = t._swap_generation()

    def planes(groups):
        ptrs = set()
        for g in groups:
            if isinstance(g, tstore.DigestGroup):
                ptrs.update(x.data_ptr() for x in (*g.digest, *g.temp,
                                                   g.dmin, g.dmax))
            elif isinstance(g, tstore.SetGroup):
                ptrs.add(g.registers.data_ptr())
        return ptrs

    live = planes(getattr(t, n) for n in t._GEN_GROUPS)
    retired = planes(getattr(gen, n) for n in t._GEN_GROUPS)
    assert live and retired and not live & retired
    # the retired generation still flushes what it held
    assert len(t._flush_generation(gen, PCTS,
                                   HistogramAggregates.from_names(AGGS), 0))


def test_not_ported_lines_raise():
    t = tstore.MetricStore(device="cpu")
    with pytest.raises(tparser.NotPortedError):
        t.process_metric(tparser.parse_metric(b"top:a|s|#veneurtopk"))
    for line in (b"_e{1,1}:a|b", b"_sc|svc|0"):
        with pytest.raises(tparser.NotPortedError):
            (tparser.parse_event if line.startswith(b"_e")
             else tparser.parse_service_check)(line)


def _jax_digest_group():
    rng = np.random.default_rng(31)
    g = jstore.DigestGroup(capacity=32, chunk=CHUNK)
    keys = [jparser.MetricKey(f"d.{i}", "histogram", f"k:{i % 3}")
            for i in range(40)]
    for phase_loc in (0.0, 400.0):   # a step: the guard drains mid-way
        for _ in range(12):
            for key in keys:
                g.sample(key, [key.joined_tags],
                         float(phase_loc + rng.gamma(2.0, 10.0)), 0.5)
    g._drain_staging()
    return g


def test_convert_digest_group():
    g = _jax_digest_group()
    assert float(np.asarray(g.digest.weight).sum()) > 0  # drained part
    planes = {"mean": g.digest.mean, "weight": g.digest.weight,
              "min": g.digest.min, "max": g.digest.max,
              "dmin": g.dmin, "dmax": g.dmax}
    planes.update({f: getattr(g.temp, f) for f in g.temp._fields})
    planes = {k: np.asarray(v) for k, v in planes.items()}
    series = [(k.name, k.type, g.interner.tags[r])
              for k, r in sorted(g.interner.rows.items(),
                                 key=lambda kv: kv[1])]
    pg = tstore.DigestGroup(capacity=8, chunk=CHUNK, device="cpu")
    convert.load_digest_group(pg, planes, series)
    assert pg.interner.names == g.interner.names
    _, jr = g.flush(PCTS)
    _, pr = pg.flush(PCTS)
    for k in ("count", "min", "max"):
        np.testing.assert_array_equal(pr[k], jr[k])
    for k in ("sum", "recip"):
        np.testing.assert_allclose(pr[k], jr[k], rtol=1e-6)
    span = (jr["max"] - jr["min"])[:, None]
    for k in ("percentiles", "median"):
        got, want = np.atleast_2d(pr[k].T).T, np.atleast_2d(jr[k].T).T
        assert (np.abs(got - want) <= 0.02 * span + 1e-6).all(), k


def test_convert_set_group():
    rng = np.random.default_rng(37)
    g = jstore.SetGroup(capacity=16, chunk=CHUNK)
    keys = [jparser.MetricKey(f"s.{i}", "set", "") for i in range(20)]
    for i, key in enumerate(keys):
        for _ in range(50 * (i + 1)):
            g.sample(key, [], f"m{int(rng.integers(0, 10 ** 6))}")
    g._drain_staging()
    series = [(k.name, k.type, []) for k in keys]
    pg = tstore.SetGroup(capacity=4, chunk=CHUNK, device="cpu")
    convert.load_set_group(pg, np.asarray(g.registers), series)
    np.testing.assert_array_equal(pg.registers.numpy()[:20],
                                  np.asarray(g.registers)[:20])
    _, je, _ = g.flush(want_estimates=True, want_registers=False)
    _, pe = pg.flush()
    np.testing.assert_allclose(pe, je, rtol=1e-6)


def test_convert_rejects_mismatched_widths():
    pg = tstore.DigestGroup(capacity=4, device="cpu")
    bad = {k: np.zeros((1, 8), np.float32) for k in
           ("mean", "weight", "sum_w", "sum_wm", "seg_w", "seg_wm")}
    bad.update({k: np.zeros(1, np.float32) for k in
                ("min", "max", "count", "vsum", "vmin", "vmax", "recip",
                 "dmin", "dmax")})
    with pytest.raises(ValueError, match="compression"):
        convert.load_digest_group(pg, bad, [("x", "histogram", [])])
    with pytest.raises(ValueError, match="outside"):
        convert.registers_from_numpy(np.full((1, 16), 200), "cpu")


def test_store_rejects_poisoned_samples():
    """Samples a typed lane cannot hold are counted, never stored."""
    t = tstore.MetricStore(device="cpu")
    key = tparser.MetricKey("x", "histogram", "")
    t.histograms.sample(key, [], float("nan"), 1.0)
    t.histograms.sample(key, [], 1.0, 0.0)
    t.counters.sample(tparser.MetricKey("c", "counter", ""), [], 1e300, 1e-30)
    assert t.histograms.scrubbed == 2 and t.counters.scrubbed == 1
    assert len(t.histograms) == 0
