"""The port's columnar emission (``core/columnar.py``) against the JAX
package's, on the same seeded numpy input.

``build_arenas`` (its fast path and the embedded-NUL slow path),
``scalar_block``, ``digest_block`` under every ``Aggregate`` bit alone
and all together, with empty masks, and ``to_intermetrics``: every
array, blob and row must equal the JAX package's exactly (same dtype,
same bytes, same order). No device is involved: both sides are numpy.
"""

import numpy as np
import pytest

from veneur_tpu.core import columnar as jcol
from veneur_tpu.core import store as jstore
from veneur_tpu.samplers import intermetric as jim
from veneur_tpu.samplers.parser import MetricKey as JKey
from veneur_tpu_torch.core import columnar as tcol
from veneur_tpu_torch.core import store as tstore
from veneur_tpu_torch.samplers import intermetric as tim
from veneur_tpu_torch.samplers.parser import MetricKey as TKey

SEED = 7


def _strings(rng, n, alphabet="abcxyz.:_-é"):
    return ["".join(rng.choice(list(alphabet), int(rng.integers(0, 12))))
            for _ in range(n)]


def _assert_arenas_equal(got, want):
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _assert_blocks_equal(got, want):
    if want is None:
        assert got is None
        return
    _assert_arenas_equal(got.names, want.names)
    _assert_arenas_equal(got.tags, want.tags)
    assert got.suffixes == want.suffixes
    for f in ("rows", "suffix_idx", "values", "type_codes"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        assert np.array_equal(g, w, equal_nan=True), f


@pytest.mark.parametrize("case", ["random", "empty", "one", "nul",
                                  "all_empty"])
def test_build_arenas_matches_jax(case):
    rng = np.random.default_rng(SEED)
    strs = {"random": _strings(rng, 300), "empty": [], "one": ["solo"],
            "nul": ["a", "b\x00c", "", "dé\x00", "z"],
            "all_empty": ["", "", ""]}[case]
    got, want = tcol.build_arenas(strs), jcol.build_arenas(strs)
    _assert_arenas_equal(got, want)
    blob, off, ln = got
    assert [blob[o:o + n].decode() for o, n in zip(off, ln)] == strs
    if case == "nul":
        assert b"\x00" in blob and len(blob) == sum(
            len(s.encode()) for s in strs)  # the NUL-free slow layout


def _interners(rng, n, mtype):
    """A port and a JAX Interner holding the same seeded series."""
    t, j = tstore.Interner(), jstore.Interner()
    for i in range(n):
        tags = sorted(_strings(rng, int(rng.integers(0, 3)), "abc:"))
        joined = ",".join(tags)
        t.intern(TKey(f"m.{i}", mtype, joined), tags)
        j.intern(JKey(f"m.{i}", mtype, joined), tags)
    return t, j


@pytest.mark.parametrize("type_code", [tcol.TYPE_GAUGE, tcol.TYPE_COUNTER])
def test_scalar_block_matches_jax(type_code):
    rng = np.random.default_rng(SEED + type_code)
    t, j = _interners(rng, 50, "counter")
    values = rng.normal(0, 1e3, 64)  # longer than the interner: cut
    _assert_blocks_equal(tcol.scalar_block(t, values, type_code),
                         jcol.scalar_block(j, values, type_code))
    assert tcol.scalar_block(tstore.Interner(), values, type_code) is None


def _digest_result(rng, n, q):
    """A fetched digest flush result of float32 columns, with rows that
    empty every mask: zero sum, zero count, zero recip, infinite
    extrema, NaN percentiles."""
    r = {"max": rng.normal(0, 10, n).astype(np.float32),
         "min": rng.normal(0, 10, n).astype(np.float32),
         "sum": rng.normal(0, 100, n).astype(np.float32),
         "count": rng.integers(0, 5, n).astype(np.float32),
         "recip": rng.random(n).astype(np.float32),
         "median": rng.normal(0, 10, n).astype(np.float32),
         "percentiles": rng.normal(0, 10, (n, q)).astype(np.float32)}
    dead = rng.random(n) < 0.3
    r["max"][dead], r["min"][dead] = -np.inf, np.inf
    r["sum"][dead] = r["count"][dead] = r["recip"][dead] = 0
    r["percentiles"][dead] = np.nan
    return r


AGG_CASES = [a for a in tim.Aggregate] + [
    tim.Aggregate(sum(int(a) for a in tim.Aggregate)), tim.Aggregate(0)]


@pytest.mark.parametrize("agg", AGG_CASES, ids=lambda a: f"agg{int(a)}")
@pytest.mark.parametrize("pcts", [[], [0.5, 0.99]], ids=["nopct", "pct"])
def test_digest_block_matches_jax(agg, pcts):
    rng = np.random.default_rng(SEED + int(agg))
    t, j = _interners(rng, 40, "histogram")
    r = _digest_result(rng, 40, len(pcts))
    names, tags = tcol.build_arenas(t.names), tcol.build_arenas(t.joined)
    got = tcol.digest_block(names, tags, r, agg, pcts)
    want = jcol.digest_block(jcol.build_arenas(j.names),
                             jcol.build_arenas(j.joined), r,
                             jim.Aggregate(int(agg)), pcts)
    _assert_blocks_equal(got, want)


def test_digest_block_with_every_mask_empty():
    """Rows that emit nothing under any mask: only the unmasked columns
    (median, percentiles) remain, as in the JAX package."""
    rng = np.random.default_rng(SEED)
    t, j = _interners(rng, 8, "timer")
    n = 8
    r = {"max": np.full(n, -np.inf, np.float32),
         "min": np.full(n, np.inf, np.float32),
         **{k: np.zeros(n, np.float32)
            for k in ("sum", "count", "recip", "median")},
         "percentiles": np.zeros((n, 1), np.float32)}
    every = tim.Aggregate(sum(int(a) for a in tim.Aggregate))
    masked = every & ~tim.Aggregate.MEDIAN
    for agg, pcts in ((masked, []), (every, [0.5])):
        got = tcol.digest_block(tcol.build_arenas(t.names),
                                tcol.build_arenas(t.joined), r, agg, pcts)
        want = jcol.digest_block(jcol.build_arenas(j.names),
                                 jcol.build_arenas(j.joined), r,
                                 jim.Aggregate(int(agg)), pcts)
        _assert_blocks_equal(got, want)
    assert got.suffixes == [b".median", b".50percentile"]


def test_to_intermetrics_matches_jax_in_order():
    """Blocks materialize suffix-major, then the extras, memoized: the
    same rows in the same order as the JAX package's."""
    rng = np.random.default_rng(SEED)
    t, j = _interners(rng, 30, "histogram")
    r = _digest_result(rng, 30, 2)
    every = tim.Aggregate(sum(int(a) for a in tim.Aggregate))
    got, want = tcol.ColumnarFlush(timestamp=42), jcol.ColumnarFlush(
        timestamp=42)
    got.add_block(tcol.digest_block(tcol.build_arenas(t.names),
                                    tcol.build_arenas(t.joined), r, every,
                                    [0.5, 0.99]))
    got.add_block(tcol.scalar_block(t, r["sum"], tcol.TYPE_COUNTER))
    got.add_block(None)
    want.add_block(jcol.digest_block(jcol.build_arenas(j.names),
                                     jcol.build_arenas(j.joined), r,
                                     jim.Aggregate(int(every)),
                                     [0.5, 0.99]))
    want.add_block(jcol.scalar_block(j, r["sum"], jcol.TYPE_COUNTER))
    got.extras.append(tim.InterMetric(name="chk", timestamp=42, value=1.0,
                                      tags=["a"],
                                      type=tim.MetricType.STATUS))
    want.extras.append(jim.InterMetric(name="chk", timestamp=42, value=1.0,
                                       tags=["a"],
                                       type=jim.MetricType.STATUS))
    assert len(got) == len(want) and len(got.blocks) == 2
    rows_t, rows_j = got.to_intermetrics(), want.to_intermetrics()
    assert got.to_intermetrics() is rows_t  # memoized
    assert [(m.name, m.timestamp, m.tags, m.type.value, m.sinks)
            for m in rows_t] == [(m.name, m.timestamp, m.tags, m.type.value,
                                  m.sinks) for m in rows_j]
    np.testing.assert_array_equal([m.value for m in rows_t],
                                  [m.value for m in rows_j])


def test_has_sink_routing():
    for blob in (b"", b"a:1,b", b"veneursinkonly:datadog",
                 b"x,veneursinkonly:"):
        assert tcol.has_sink_routing(blob) == jcol.has_sink_routing(blob)
