"""The port's packed binary forward and import against the JAX package's.

A local with ``forward_address: native://host:port`` packs its drained
digest planes on the device (``core/slab.py``), writes C++ MetricList
frames (``native/egress.py``) and the rest of its state with the
protobuf-free codec (``protocol/mlist.py``), and sends them over framed
TCP (``forward/native_transport.py``) to a global that decodes them in
C++ and bulk-stages them (``MetricStore.import_columnar``). Held here,
on the CPU, at a few hundred series:

* the pack: the same seeded planes through both packages' ``_pack_slab``
  and ``_fetch_packed``, through both fetch strategies: counts equal,
  live quantized means and bfloat16 weight bits equal bit for bit;
* the codec: the port's MetricList bytes equal ``SerializeToString()``
  of the JAX package's protobuf builder, its C++ digest frames equal the
  JAX package's, and both packages' decoders read the same columns;
* the import: a port global and a JAX global merge the same frames:
  counters and gauges exact, set estimates within one float32 ulp,
  digest mass within rtol 1e-6, quantiles within 0.02 x (max - min)
  (the packages' flush rungs differ by design: the kernels' asin
  polynomial against the true arcsin);
* end to end: port Servers over native:// against the same traffic
  over HTTP/JSON, packed and dense (``forward_packed_digests: false``);
  a port local into the JAX package's NativeImportServer and a JAX local
  into the port's; a frame that fails; the at-most-once rule after a
  frame was acked; no quiet fallback without the egress library.

Every socket the tests open has a timeout of at most 5 s, and every
thread is joined in a ``finally``. The Servers' own forwards run on a
60 s budget (``forward_timeout``): on a loaded host an HTTP forward has
missed the 10 s default.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from veneur_tpu.core import slab as jslab
from veneur_tpu.core import store as jstore
from veneur_tpu.forward import convert as jconvert
from veneur_tpu.forward import native_transport as jnt
from veneur_tpu.native import egress as jegress
from veneur_tpu.protocol import forward_pb2
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.samplers.intermetric import HistogramAggregates as JAggs
from veneur_tpu_torch import flusher as tflusher
from veneur_tpu_torch.config import Config, UnsupportedConfig
from veneur_tpu_torch.core import columnar
from veneur_tpu_torch.core import slab as tslab
from veneur_tpu_torch.core import store as tstore
from veneur_tpu_torch.forward import configure_forwarding
from veneur_tpu_torch.forward import convert as tconvert
from veneur_tpu_torch.forward import native_transport as tnt
from veneur_tpu_torch.native import egress as tegress
from veneur_tpu_torch.protocol import mlist
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

PCTS = [0.1, 0.5, 0.9, 0.99]
AGGS = ["min", "max", "count"]
CHUNK = 256
TOPK = dict(topk_depth=4, topk_width=512, topk_k=8)
SOCK_TIMEOUT = 5.0


@pytest.fixture(scope="module", autouse=True)
def egress_libraries():
    """Both packages' egress libraries (g++ and zlib.h)."""
    if not (tegress.available() and jegress.available()):
        pytest.skip("the native egress library does not build here")


def traffic(seed=3, histos=200, timers=40, sets=30, scalars=24):
    """One interval of DogStatsD lines a local forwards (mixed
    histograms and timers, mixed sets, global-only counters and gauges,
    top-k sets), and each digest series' raw samples by name."""
    rng = np.random.default_rng(seed)
    lines, raw = [], {}
    for kind, n, t in (("h", histos, "h"), ("t", timers, "ms")):
        for i in range(n):
            tags = "|#env:a,zone:b" if i % 3 == 0 else ""
            for _ in range(int(rng.integers(2, 9))):
                v = float(f"{rng.gamma(2.0, 10.0) + 100 * (i % 5):.4f}")
                raw.setdefault(f"{kind}.{i}", []).append(v)
                lines.append(f"{kind}.{i}:{v}|{t}{tags}")
    for i in range(sets):
        for _ in range(12):
            lines.append(f"s.{i}:m{int(rng.integers(0, 20 + 10 * i))}|s")
    for i in range(scalars):
        lines.append(f"c.{i}:{i % 4}|c|#veneurglobalonly")  # c.0 is 0
        lines.append(f"g.{i}:{rng.normal(0, 50):.4f}|g|#veneurglobalonly")
    for i in range(8):
        lines.append(f"hh.{i % 3}:user{int(rng.integers(0, 6))}|s"
                     f"|#veneurtopk")
    return [ln.encode() for ln in lines], raw


LINES, RAW = traffic()


def by_key(rows):
    out = {}
    for m in rows:
        key = (m.name, tuple(m.tags), m.type.value)
        assert key not in out, key
        out[key] = m.value
    return out


def assert_global_rows_match(got_rows, want_rows):
    """A global's rows: counters and gauges exact, set estimates within
    one float32 ulp, percentiles within 0.02 x the raw (max - min),
    top-k counts exact."""
    got, want = by_key(got_rows), by_key(want_rows)
    assert set(got) == set(want)
    for key, value in want.items():
        name = key[0]
        base, _, suffix = name.rpartition(".")
        if suffix.endswith("percentile") or suffix == "median":
            span = max(RAW[base]) - min(RAW[base])
            assert abs(got[key] - value) <= 0.02 * span + 1e-6, key
        elif name.startswith("s."):
            assert abs(got[key] - value) <= np.spacing(np.float32(value)), \
                key
        else:
            assert got[key] == value, key


def port_local(lines=LINES):
    t = tstore.MetricStore(chunk=CHUNK, device="cpu", **TOPK)
    for line in lines:
        t.process_metric(tparser.parse_metric(line))
    return t


def jax_local(lines=LINES):
    j = jstore.MetricStore(chunk=CHUNK, **TOPK)
    for line in lines:
        j.process_metric(jparser.parse_metric(line))
    return j


def port_flush(store, digest_format="packed"):
    """A forwarding local's flush in the default columnar shape."""
    return store.flush(PCTS, HistogramAggregates.from_names(AGGS), 0,
                       is_local=True, columnar=True,
                       digest_format=digest_format)[1]


def jax_flush(store, digest_format="packed"):
    return store.flush(PCTS, JAggs.from_names(AGGS), is_local=True, now=0,
                       columnar=True, digest_format=digest_format)[1]


def port_global_rows(store):
    return store.flush(PCTS, HistogramAggregates.from_names(AGGS),
                       0)[0].to_intermetrics()


def jax_global_rows(store):
    return store.flush(PCTS, JAggs.from_names(AGGS), is_local=False,
                       now=0)[0]


# ---------------------------------------------------------------------------
# the pack
# ---------------------------------------------------------------------------


def drained_planes(rng, rows=300, k=104, heavy_row=None):
    """Planes laid out as a drain leaves them: each row's live centroids
    ascending with gap bins of weight 0 between them (cummax-filled
    means) and +inf past the last; an empty row's extrema +inf/-inf.
    Weights are integers below 256, so bfloat16 holds them exactly."""
    mean = np.full((rows, k), np.inf, np.float32)
    weight = np.zeros((rows, k), np.float32)
    dmin = np.full(rows, np.inf, np.float32)
    dmax = np.full(rows, -np.inf, np.float32)
    for r in range(rows):
        n = k if r == heavy_row else int(rng.integers(0, 12))
        if r % 17 == 0 and r != heavy_row:
            n = 0
        if n == 0:
            continue
        slots = np.sort(rng.choice(k, n, replace=False))
        vals = np.sort(rng.gamma(2.0, 10.0, n) * 10 ** (r % 4)).astype(
            np.float32)
        mean[r, :slots[-1] + 1] = np.maximum.accumulate(np.where(
            np.isin(np.arange(slots[-1] + 1), slots),
            np.repeat(vals, np.diff(np.r_[-1, slots])), -np.inf))
        weight[r, slots] = rng.integers(1, 256, n)
        dmin[r] = vals[0] - np.float32(rng.random())
        dmax[r] = vals[-1] + np.float32(rng.random())
    return mean, weight, dmin, dmax


@pytest.mark.parametrize("strategy", ["uniform", "skewed"])
def test_pack_parity(strategy, monkeypatch):
    """``_pack_slab`` + ``_fetch_packed`` of both packages on the same
    planes: counts, live quantized means and bfloat16 weight bits equal
    bit for bit; both pick the same fetch strategy (one full-width row
    forces the flat device compaction). No q differs by 1: both compute
    (m - dmin) * (65535 / span) in float32 with a true division and
    round half to even. (``65535.0 / span`` on a tensor multiplies by
    the reciprocal in torch: with it, seed 6 put row 259's product at
    51604.502 instead of 51604.5 and its q at 51605 against 51604.)"""
    rng = np.random.default_rng(5 if strategy == "uniform" else 6)
    planes = drained_planes(rng, heavy_row=7 if strategy == "skewed"
                            else None)
    rows, k = planes[0].shape
    gathers = {"port": 0, "jax": 0}
    for mod, label in ((tslab, "port"), (jslab, "jax")):
        real = mod._gather_pack

        def counted(*args, _real=real, _label=label):
            gathers[_label] += 1
            return _real(*args)

        monkeypatch.setattr(mod, "_gather_pack", counted)
    jout = jslab._fetch_packed(*jslab._pack_slab(
        *(np.array(a).reshape(-1) for a in planes[:2]), planes[2],
        planes[3], rows, k), rows - 3)
    tout = tslab._fetch_packed(*tslab._pack_slab(
        *(torch.from_numpy(a) for a in planes)), rows - 3)
    for got, want in zip(tout, jout):
        want = np.asarray(want)
        assert got.dtype == want.dtype == np.uint16
        np.testing.assert_array_equal(got, want)
    assert int(tout[0].sum()) == len(tout[1]) > 0
    want_gathers = 1 if strategy == "skewed" else 0
    assert gathers == {"port": want_gathers, "jax": want_gathers}


def test_pack_prefix_and_dead_slots():
    """Live slots move to each row's prefix in slot order; everything
    past a row's count is 0, including rows whose (m - dmin) * scale is
    NaN (an empty row: +inf extrema)."""
    rng = np.random.default_rng(8)
    mean, weight, dmin, dmax = drained_planes(rng, rows=40, k=16)
    counts, q, wb = tslab._pack_slab(*(torch.from_numpy(a) for a in
                                       (mean, weight, dmin, dmax)))
    q, wb = q.numpy().view(np.uint16), wb.numpy().view(np.uint16)
    for r in range(40):
        live = weight[r] > 0
        c = int(counts[r])
        assert c == live.sum()
        assert not q[r, c:].any() and not wb[r, c:].any()
        np.testing.assert_array_equal(
            (wb[r, :c].astype(np.uint32) << 16).view(np.float32),
            weight[r, live])
        if c:
            span = np.float32(dmax[r] - dmin[r])
            got = dmin[r] + q[r, :c].astype(np.float64) * span / 65535
            assert np.abs(got - mean[r, live]).max() <= span / 65535


def test_packed_planes_decode_like_jax():
    """PackedDigestPlanes' host decode (row slices, dequantized means,
    float32 weights) and ForwardableState.materialize_digests of a packed
    part agree with the JAX package's."""
    rng = np.random.default_rng(9)
    mean, weight, dmin, dmax = drained_planes(rng, rows=64, k=32)
    pc, pm, pw = tslab._fetch_packed(*tslab._pack_slab(
        *(torch.from_numpy(a) for a in (mean, weight, dmin, dmax))), 64)
    tp = tstore.PackedDigestPlanes(pc, pm, pw, dmin, dmax)
    jp = jstore.PackedDigestPlanes(pc, pm, pw, dmin, dmax)
    for got, want in zip(tp.row_slices(), jp.row_slices()):
        np.testing.assert_array_equal(got, want)
    assert tp.nbytes == jp.nbytes
    names = [f"h.{i}" for i in range(64)]
    joined = ["a:1,b:2" if i % 2 else "" for i in range(64)]
    arenas = (columnar.build_arenas(names), columnar.build_arenas(joined))
    ts, js = tstore.ForwardableState(), jstore.ForwardableState()
    ts.histograms_columnar = arenas + (tp,)
    js.histograms_columnar = arenas + (jp,)
    assert len(ts) == len(js) == 64
    ts.materialize_digests()
    js.materialize_digests()
    assert len(ts.histograms) == len(js.histograms) == 64
    for got, want in zip(ts.histograms, js.histograms):
        assert got[:2] == want[:2]
        for a, b in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


def _fill_state(st, rng_seed=4):
    """The same non-digest state in either package's ForwardableState:
    zero and negative counters, -0.0 and inf gauges, sets, per-row
    digests (a 0.0 mean and extremum), a top-k sketch with an unknown
    member."""
    rng = np.random.default_rng(rng_seed)
    st.counters += [("c.0", [], 0), ("c.1", ["a:b", "c:d"], -5),
                    ("c.2", [""], 1 << 40)]
    st.gauges += [("g.0", [], 0.0), ("g.1", ["x:y"], -0.0),
                  ("g.2", [], 3.5), ("g.3", [], float("inf"))]
    st.sets += [(f"s.{i}", ["t:1"], rng.integers(0, 30, 1 << 14).astype(
        np.uint8), 14) for i in range(3)]
    st.histograms += [("h.0", ["a:1"], np.array([0.0, 1.5, 2.0]),
                       np.array([1.0, 2.0, 0.5]), 0.0, 2.0)]
    st.timers += [("t.0", [], np.array([3.0]), np.array([4.0]), 3.0, 3.0)]
    st.topk = (rng.random((4, 16)).astype(np.float32),
               [("hh", ["k:v"], [(1, 2), (3, 1 << 31)], ["m1", None]),
                ("hh2", [], [], [])])


@pytest.mark.parametrize("compat", [False, True])
def test_metric_list_bytes_equal_protobuf(compat):
    """The hand MetricList of counters, gauges, sets, per-row digests and
    the top-k sketch is ``SerializeToString()`` of the JAX package's
    ``metric_list_from_state``, byte for byte, in both wire modes."""
    ts, js = tstore.ForwardableState(), jstore.ForwardableState()
    _fill_state(ts)
    _fill_state(js)
    want = jconvert.metric_list_from_state(
        js, reference_compat=compat).SerializeToString()
    assert tconvert.metric_list_from_state(
        ts, reference_compat=compat) == want
    assert tconvert.metric_list_from_state(tstore.ForwardableState()) == b""


def test_metric_lists_split_at_the_frame_bound():
    """The non-digest state cut into MetricLists of at most max_bytes (a
    16 KiB set alone gets its own): each a list protobuf parses, the top-k
    sketch in the first, and parsed together the one list."""
    ts, js = tstore.ForwardableState(), jstore.ForwardableState()
    _fill_state(ts)
    _fill_state(js)
    chunks = tconvert.metric_lists_from_state(ts, max_bytes=1000)
    assert len(chunks) == 4
    assert sum(n for _, n in chunks) == 3 + 4 + 2 + 3
    assert all(len(c) <= 1000 for c, n in chunks if n > 1)
    merged = forward_pb2.MetricList.FromString(b"".join(c for c, _ in
                                                        chunks))
    assert merged == jconvert.metric_list_from_state(js)
    assert forward_pb2.MetricList.FromString(chunks[0][0]).HasField("topk")
    assert tconvert.metric_lists_from_state(ts) == [
        (tconvert.metric_list_from_state(ts), 12)]


def test_default_oneof_values_are_present():
    """A counter of 0 is a present oneof member (an empty submessage):
    the C++ decoder reads a counter of 0, and a Metric without a value
    member reads as no value, as protobuf writes them."""
    zero = mlist.counter("z", [], 0)
    pb = forward_pb2.MetricList()
    m = pb.metrics.add(name="z")
    m.counter.value = 0
    pb.metrics.add(name="none")
    # a Metric of a name alone: field 1, length 4
    data = mlist.metric_list([zero, b"\x0a\x04none"])
    assert data == pb.SerializeToString()
    dec = tegress.decode_metric_list(data)
    assert list(dec.payload) == [tegress.PAYLOAD_COUNTER,
                                 tegress.PAYLOAD_NONE]
    assert list(dec.ivalue) == [0, 0]


def test_topk_sketch_reads_like_protobuf():
    ts = tstore.ForwardableState()
    _fill_state(ts)
    data = tconvert.metric_list_from_state(ts)
    pb = forward_pb2.MetricList.FromString(data)
    want_table, want_series = jconvert.decode_topk_sketch(pb.topk)
    got_table, got_series = tconvert.decode_topk_sketch(
        mlist.decode_topk(pb.topk.SerializeToString()))
    np.testing.assert_array_equal(got_table, want_table)
    assert got_series == want_series
    assert got_series[0][2] == [(1, 2), (3, 1 << 31)]
    with pytest.raises(mlist.DecodeError):
        mlist.decode_topk(b"\x0a\x05ab")


def _digest_inputs(rng, rows=120, k=104):
    mean, weight, dmin, dmax = drained_planes(rng, rows=rows, k=k,
                                              heavy_row=3)
    names = columnar.build_arenas([f"h.{i}" for i in range(rows)])
    tags = columnar.build_arenas(["env:a,zone:b" if i % 3 else ""
                                  for i in range(rows)])
    pc, pm, pw = tslab._fetch_packed(*tslab._pack_slab(
        *(torch.from_numpy(a) for a in (mean, weight, dmin, dmax))), rows)
    return names, tags, (mean, weight, dmin, dmax), (pc, pm, pw, dmin, dmax)


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_digest_frames_equal_jax(layout, compat):
    """The port's encode_digest_metrics(_packed) and the JAX package's on
    the same arenas and planes: the same chunks, byte for byte, and each
    package's decoder reads the same columns from them."""
    names, tags, dense, packed = _digest_inputs(np.random.default_rng(10))
    args = dict(compression=100.0, max_body_bytes=4096,
                reference_compat=compat)
    if layout == "dense":
        got = tegress.encode_digest_metrics(names, tags, *dense, 2, **args)
        want = jegress.encode_digest_metrics(names, tags, *dense, 2, **args)
    else:
        got = tegress.encode_digest_metrics_packed(
            names, tags, tstore.PackedDigestPlanes(*packed), 4, **args)
        want = jegress.encode_digest_metrics_packed(
            names, tags, jstore.PackedDigestPlanes(*packed), 4, **args)
    assert len(got) > 2 and got == want
    for frame in got:
        t, j = tegress.decode_metric_list(frame), \
            jegress.decode_metric_list(frame)
        assert t.count == j.count > 0 and t.arena == j.arena
        for name in tegress.DecodedMetricList.__slots__[1:19]:
            if name != "arena":
                np.testing.assert_array_equal(getattr(t, name),
                                              getattr(j, name), err_msg=name)
        assert (t.topk_off, t.topk_len) == (j.topk_off, j.topk_len)
        tds = [m.histogram.t_digest for m in
               forward_pb2.MetricList.FromString(frame).metrics]
        quantized = layout == "packed" and not compat
        assert any(td.quantized_means for td in tds) is quantized
        assert any(td.packed_means for td in tds) is not quantized
    with pytest.raises(ValueError, match="inconsistent"):
        bad = tstore.PackedDigestPlanes(packed[0], packed[1][:-1],
                                        packed[2], packed[3], packed[4])
        tegress.encode_digest_metrics_packed(names, tags, bad, 2)


def test_intern_table_matches_jax():
    """MListInternTable: misses, puts and assigns as the JAX package's;
    the payload kind is part of the key; reset forgets."""
    data = tconvert.metric_list_from_state(_state_with(
        counters=[("a", [], 1), ("b", ["t:1"], 2)],
        gauges=[("a", [], 1.0)]))
    for mod in (tegress, jegress):
        dec = mod.decode_metric_list(data)
        table = mod.MListInternTable()
        rows, miss = table.assign(dec)
        assert list(miss) == [0, 1, 2] and (rows == mod.MISS).all()
        for i in miss:
            no, nl = dec.name_off[i], dec.name_len[i]
            to, tl = dec.tags_off[i], dec.tags_len[i]
            table.put(int(dec.type[i]), int(dec.payload[i]),
                      dec.arena[no:no + nl], dec.arena[to:to + tl],
                      10 + int(i))
        rows, miss = table.assign(dec)
        assert list(rows) == [10, 11, 12] and not len(miss)
        table.reset()
        assert len(table.assign(dec)[1]) == 3
        table.close()
        dec.close()


def _state_with(**kw):
    st = tstore.ForwardableState()
    for k, v in kw.items():
        setattr(st, k, v)
    return st


# ---------------------------------------------------------------------------
# the import
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_frames():
    """The frames a port local sends for LINES: its packed digest groups
    from the C++ encoders, the rest from the hand codec."""
    fwd = port_flush(port_local())
    assert isinstance(fwd.histograms_columnar[2], tstore.PackedDigestPlanes)
    assert fwd.topk is not None and len(fwd.sets) == 30
    frames = tnt.encode_forwardable_frames(fwd, 100.0, False, 2048)
    assert len(frames) > 3
    return frames


def _import(store, egress_mod, frames):
    n_ok = n_err = 0
    for data, _rows in frames:
        dec = egress_mod.decode_metric_list(data, copy=False)
        try:
            ok, err = store.import_columnar(dec, data)
        finally:
            dec.close()
        n_ok, n_err = n_ok + ok, n_err + err
    return n_ok, n_err


def test_import_columnar_matches_jax(port_frames):
    """A port global's and a JAX global's import_columnar on the same
    frames. As globals: counters and gauges exact, set estimates within
    one float32 ulp, percentiles within 0.02 x span, the top-k exact.
    As forwarding middles: the merged digests' mass within rtol 1e-6 and
    the set registers equal."""
    n_metrics = 200 + 40 + 30 + 2 * 24 + 1
    rows = {}
    for label in ("global", "middle"):
        t = tstore.MetricStore(chunk=CHUNK, device="cpu", **TOPK)
        j = jstore.MetricStore(chunk=CHUNK, **TOPK)
        assert _import(t, tegress, port_frames) == (n_metrics, 0)
        assert _import(j, jegress, port_frames) == (n_metrics, 0)
        assert t.imported == j.imported == n_metrics
        if label == "global":
            rows["port"], rows["jax"] = port_global_rows(t), \
                jax_global_rows(j)
            continue
        tf = t.flush(PCTS, HistogramAggregates.from_names(AGGS), 0,
                     is_local=True)[1]
        jf = j.flush(PCTS, JAggs.from_names(AGGS), is_local=True, now=0)[1]
        tf.materialize_digests()
        jf.materialize_digests()
        for kind in ("histograms", "timers"):
            got = {e[0]: e for e in getattr(tf, kind)}
            want = {e[0]: e for e in getattr(jf, kind)}
            assert set(got) == set(want) and len(got) > 30
            for name, e in want.items():
                np.testing.assert_allclose(got[name][3].sum(), e[3].sum(),
                                           rtol=1e-6, err_msg=name)
                assert got[name][4:] == e[4:]
        assert sorted((n, bytes(r)) for n, _t, r, _p in tf.sets) == \
            sorted((n, bytes(r)) for n, _t, r, _p in jf.sets)
        assert sorted(tf.counters) == sorted(jf.counters)
    assert_global_rows_match(rows["port"], rows["jax"])
    names = {m.name for m in rows["port"]}
    assert {"c.0", "g.3", "s.2", "h.1.99percentile", "t.0.50percentile"} \
        <= names and any(n.endswith(".topk") for n in names)


def test_import_counts_bad_metrics():
    """An unknown type enum and a metric without a value stay unmatched
    and count as errors; a set whose HLL bytes are not a sketch is
    rejected alone (its row, interned first, flushes an empty estimate,
    as in the JAX package); the rest merges."""
    good = mlist.counter("ok", [], 7)
    bad_type = mlist.metric("x", [], 9, 5, b"")
    no_value = b"\x0a\x01y"  # a name alone
    bad_set = mlist.set_metric("s", [], b"not an hll")
    data = mlist.metric_list([good, bad_type, no_value, bad_set])
    t = tstore.MetricStore(chunk=CHUNK, device="cpu")
    j = jstore.MetricStore(chunk=CHUNK)
    assert _import(t, tegress, [(data, 4)]) == (1, 3)
    assert _import(j, jegress, [(data, 4)]) == (1, 3)
    assert by_key(port_global_rows(t)) == by_key(jax_global_rows(j)) == {
        ("ok", (), "counter"): 7.0, ("s", (), "gauge"): 0.0}


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------


def _wait(cond, timeout=SOCK_TIMEOUT):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, "timed out"
        time.sleep(0.01)


def test_port_local_into_jax_global_and_back():
    """Interop both ways over loopback: a port local's NativeForwarder
    into the JAX package's NativeImportServer, and a JAX local's
    NativeForwarder into the port's; each global emits what the same
    package's local into it emits."""
    def run(server_cls, gstore, forwarder_cls, state):
        srv = server_cls(gstore)
        srv.start("127.0.0.1:0")
        fwd = forwarder_cls(f"native://127.0.0.1:{srv.port}",
                            timeout=SOCK_TIMEOUT)
        try:
            ok = fwd.forward(state)
            assert ok in (True, None) and fwd.errors == 0
        finally:
            fwd.close()
            srv.stop()
        assert srv.import_errors == 0 and srv.received > 0
        return srv.received

    def glob(pkg):
        if pkg == "jax":
            return jstore.MetricStore(chunk=CHUNK, **TOPK)
        return tstore.MetricStore(chunk=CHUNK, device="cpu", **TOPK)

    # the JAX global's staging programs compile before any socket waits
    # on an ack (a first compile can take seconds under load)
    _import(glob("jax"), jegress, tnt.encode_forwardable_frames(
        port_flush(port_local()), 100.0, False, tnt.NativeForwarder
        .CHUNK_BYTES))
    rows = {}
    for src in ("port", "jax"):
        for dst in ("port", "jax"):
            state = (port_flush(port_local()) if src == "port"
                     else jax_flush(jax_local()))
            g = glob(dst)
            run(tnt.NativeImportServer if dst == "port"
                else jnt.NativeImportServer, g,
                tnt.NativeForwarder if src == "port"
                else jnt.NativeForwarder, state)
            rows[src, dst] = (port_global_rows(g) if dst == "port"
                              else jax_global_rows(g))
    assert_global_rows_match(rows["port", "jax"], rows["port", "port"])
    assert_global_rows_match(rows["jax", "port"], rows["jax", "jax"])
    assert_global_rows_match(rows["port", "port"], rows["jax", "jax"])


class _FakeGlobal:
    """A scripted framed-TCP global: ``script(conn_index, frame_index)``
    returns "ack" or "close". Records every frame it read."""

    def __init__(self, script):
        self.script = script
        self.frames = []  # (connection index, frame index)
        self.sock = socket.socket()
        self.sock.settimeout(0.5)  # the accept loop polls the stop flag
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.port = self.sock.getsockname()[1]
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        conn_i = 0
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with conn:
                conn.settimeout(SOCK_TIMEOUT)
                if tnt._read_exact(conn, 4) != tnt.MAGIC:
                    return
                frame_i = 0
                try:
                    while True:
                        head = tnt._read_exact(conn, 4)
                        if head is None:
                            break
                        (n,) = struct.unpack(">I", head)
                        tnt._read_exact(conn, n)
                        self.frames.append((conn_i, frame_i))
                        if self.script(conn_i, frame_i) == "close":
                            break
                        conn.sendall(struct.pack(">I", 1))
                        frame_i += 1
                except OSError:
                    pass
            conn_i += 1

    def close(self):
        self._stop.set()
        self.sock.close()
        self.thread.join(SOCK_TIMEOUT)


def test_at_most_once_after_progress():
    """A global that drops the connection after acking the first frame
    gets no resend: the forward fails with no retry. One that drops it
    before any ack gets a retry on a fresh connection."""
    for script, want in (
            (lambda c, f: "close" if f == 1 else "ack", "no_resend"),
            (lambda c, f: "close" if c == 0 else "ack", "retried")):
        state = port_flush(port_local())
        g = _FakeGlobal(script)
        fwd = tnt.NativeForwarder(f"native://127.0.0.1:{g.port}",
                                  timeout=SOCK_TIMEOUT)
        fwd.CHUNK_BYTES = 2048  # the digest groups go out as many frames
        try:
            ok = fwd.forward(state)
        finally:
            fwd.close()
            g.close()
        if want == "no_resend":
            assert ok is False and fwd.retries == 0 and fwd.errors == 1
            assert g.frames == [(0, 0), (0, 1)]
            assert 0 < fwd.forwarded < 300
        else:
            assert ok is True and fwd.retries == 1 and fwd.errors == 0
            assert g.frames[0] == (0, 0) and g.frames[1] == (1, 0)
            assert len(g.frames) > 4


def _frame_client(port):
    s = socket.create_connection(("127.0.0.1", port), SOCK_TIMEOUT)
    s.settimeout(SOCK_TIMEOUT)
    s.sendall(tnt.MAGIC)
    return s


def _send_frame(s, data):
    s.sendall(struct.pack(">I", len(data)) + data)
    return struct.unpack(">I", tnt._read_exact(s, 4))[0]


def test_failed_frames_are_counted_and_nacked():
    """A frame the store cannot merge is acked 0xFFFFFFFF and counted in
    import_errors; a frame with an unknown metric type counts its error
    and merges the rest; junk merges nothing; the stream stays framed;
    a bad magic or an oversized length closes the connection."""
    t = tstore.MetricStore(chunk=CHUNK, device="cpu")
    srv = tnt.NativeImportServer(t)
    srv.start("127.0.0.1:0")
    real = t.import_columnar
    try:
        s = _frame_client(srv.port)
        try:
            ok_metric = mlist.counter("ok", [], 2)
            good = mlist.metric_list([ok_metric])
            t.import_columnar = lambda dec, data: 1 / 0
            assert _send_frame(s, good) == tnt.ACK_ERROR
            assert srv.import_errors == 1 and srv.received == 0
            t.import_columnar = real
            assert _send_frame(s, mlist.metric_list(
                [mlist.metric("x", [], 9, 5, b""), ok_metric])) == 1
            assert srv.import_errors == 2 and srv.received == 1
            assert _send_frame(s, b"junk!") in (0, tnt.ACK_ERROR)
            assert _send_frame(s, good) == 1
        finally:
            s.close()
        for payload in (b"NOPE" + struct.pack(">I", 4) + b"xxxx",
                        tnt.MAGIC + struct.pack(">I", 1 << 31)):
            s = socket.create_connection(("127.0.0.1", srv.port),
                                         SOCK_TIMEOUT)
            s.settimeout(SOCK_TIMEOUT)
            try:
                s.sendall(payload)
                try:
                    assert s.recv(4) == b""
                except ConnectionResetError:
                    pass
            finally:
                s.close()
    finally:
        srv.stop()
    assert t.imported == 2
    assert by_key(port_global_rows(t)) == {("ok", (), "counter"): 4.0}


def test_no_fallback_without_the_library(monkeypatch):
    """Without the egress library the forward raises and an import frame
    fails (ACK_ERROR): there is no protobuf path behind either."""
    monkeypatch.setattr(tegress, "_lib", None)
    monkeypatch.setattr(tegress, "_build_error", "no compiler")
    monkeypatch.setattr(tegress, "_load", lambda: None)
    state = port_flush(port_local(LINES[:40]))
    fwd = tnt.NativeForwarder("native://127.0.0.1:9", timeout=1.0)
    with pytest.raises(RuntimeError, match="no compiler"):
        fwd.forward(state)
    srv = tnt.NativeImportServer(tstore.MetricStore(device="cpu"))
    assert srv._merge(mlist.metric_list([mlist.counter("a", [], 1)])) \
        == tnt.ACK_ERROR
    assert srv.import_errors == 1


def test_config_and_forwarder_choice():
    """native:// builds a NativeForwarder (packed unless
    forward_packed_digests is false); native_import_address is a key;
    gRPC stays refused."""
    class Srv:
        forward_fn = None

    for packed in (True, False):
        srv = Srv()
        srv.config = Config(hostname="h", forward_address="native://h:1",
                            forward_packed_digests=packed)
        fwd = configure_forwarding(srv)
        assert isinstance(fwd, tnt.NativeForwarder)
        assert fwd.wants_packed_digests is packed
        assert not getattr(fwd, "supports_chunked_forward", False)
        assert srv.forward_fn == fwd.forward
    compat = Srv()
    compat.config = Config(hostname="h", forward_address="native://h:1",
                           forward_reference_compatible=True)
    fwd = configure_forwarding(compat)
    assert not fwd.wants_packed_digests and not fwd.supports_topk
    assert Config(hostname="h", native_import_address="127.0.0.1:0") \
        .native_import_address == "127.0.0.1:0"
    # forward_use_grpc builds the gRPC forwarder (native:// still wins);
    # without grpcio it raises (tests/test_torch_grpc.py)
    grpc_srv = Srv()
    grpc_srv.config = Config(hostname="h", forward_address="127.0.0.1:1",
                             forward_use_grpc=True)
    fwd = configure_forwarding(grpc_srv)
    assert type(fwd).__name__ == "GRPCForwarder" and fwd.wants_packed_digests
    fwd.close()
    grpc_srv.config.forward_address = "native://h:1"
    assert isinstance(configure_forwarding(grpc_srv), tnt.NativeForwarder)


# ---------------------------------------------------------------------------
# port Servers end to end
# ---------------------------------------------------------------------------


def _send_lines(server):
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
        for i in range(0, len(LINES), 8):
            tx.sendto(b"\n".join(LINES[i:i + 8]),
                      ("127.0.0.1", server.statsd_addrs[0][1]))
    _wait(lambda: server.store.processed == len(LINES), 30)


@pytest.fixture(scope="module")
def servers():
    """One port global Server with both imports (http_address and
    native_import_address) and its channel sink; its locals are made by
    the tests. Returns (global, sink, captured frames)."""
    gsink = ChannelMetricSink()
    glob = Server(Config(http_address="127.0.0.1:0",
                         native_import_address="127.0.0.1:0",
                         interval="3600s", percentiles=PCTS,
                         aggregates=AGGS, hostname="g", **TOPK),
                  metric_sinks=[gsink], device="cpu")
    glob.start()
    frames = []
    srv = glob.native_import_server
    real = srv._merge

    def merge(data):
        frames.append(data)
        return real(data)

    srv._merge = merge
    try:
        yield glob, gsink, frames
    finally:
        glob.shutdown()


def _through(servers, address, **cfg):
    """LINES into a fresh port local Server forwarding to ``address``;
    the global then flushes. Returns the global's rows, but for the
    servers' own self-metrics (``veneur.*``: each flush's span re-enters
    its server, and a local forwards its ``veneur.*`` timers too)."""
    glob, gsink, _frames = servers
    local = Server(Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                          interval="3600s", percentiles=PCTS,
                          aggregates=AGGS, hostname="l",
                          forward_address=address, forward_timeout="60s",
                          **TOPK, **cfg),
                   metric_sinks=[ChannelMetricSink()], device="cpu")
    local.start()
    imported0 = glob.imported_metrics + glob.import_errors
    try:
        _send_lines(local)
        tflusher.flush_once(local)
        assert local.wait_forward(30) is True
        fwd = local.forwarder
        assert fwd.errors == 0
        # a native forward returns once every frame is merged and acked;
        # an HTTP POST's 202 comes before its merge
        if not address.startswith("native://"):
            _wait(lambda: glob.imported_metrics + glob.import_errors
                  - imported0 == fwd.forwarded)
        tflusher.flush_once(glob)
        return [m for m in gsink.get_flush(timeout=10)
                if not m.name.startswith("veneur.")]
    finally:
        local.shutdown()


@pytest.mark.parametrize("packed", [True, False])
def test_servers_native_matches_http(servers, packed):
    """Port Servers: a local with forward_address native://... into a
    global with native_import_address emits what the same traffic over
    HTTP/JSON emits; packed, its digest frames carry the quantized
    fields 16/17, with forward_packed_digests false the float64 arrays."""
    glob, _sink, frames = servers
    http = _through(servers, f"http://127.0.0.1:{glob.ops_server.port}")
    del frames[:]
    received0 = glob.native_import_server.received
    native = _through(servers,
                      f"native://127.0.0.1:{glob.native_import_server.port}",
                      forward_packed_digests=packed)
    assert glob.native_import_server.import_errors == 0
    metrics = [m for data in frames
               for m in forward_pb2.MetricList.FromString(data).metrics]
    # beside LINES' metrics, the local's own veneur.* timers of its first
    # flush, forwarded by its final (shutdown) flush
    own = sum(m.name.startswith("veneur.") for m in metrics)
    assert own > 0
    assert glob.native_import_server.received - received0 == \
        200 + 40 + 30 + 2 * 24 + 1 + own
    sent = [m for m in metrics if not m.name.startswith("veneur.")]
    assert_global_rows_match(native, http)
    digests = [m.histogram.t_digest for m in sent
               if m.WhichOneof("value") == "histogram"]
    assert len(digests) == 240
    assert all(bool(td.quantized_means) is packed
               and bool(td.packed_means) is not packed for td in digests)
