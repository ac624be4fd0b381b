"""The port's forward path (a local's flush, its /import body, the HTTP
wire) against the JAX package's, in both directions.

One seeded stream of DogStatsD lines (every type and scope, a
distribution step that trips the shift guard) goes into a JAX local and
a port local (chunk=64); both flush as forwarding locals. Then:

* the locals' own emissions match (tests/test_torch_store.py bounds);
* their forwarded bodies match, in our structured format and in the
  reference's (gob/axiomhq/LE): counters, gauges and set registers
  exactly; each digest by total weight (rtol 1e-6), min/max (exact) and
  quantiles within 0.02 x (max - min). The centroid lists themselves
  differ by design: the JAX CPU flush is its XLA rung, the port's the
  plain version of the K1 kernel;
* the JAX body into a port global and the port body into a JAX global
  emit what the JAX body into a JAX global emits: set estimates rtol
  1e-6, counters and gauges exact, percentiles within 0.02 x the raw
  samples' (max - min);
* the real wire: the port's HTTPForwarder POSTs to the JAX package's
  OpsServer and the JAX HTTPForwarder to the port's, on 127.0.0.1:0;
  each global then emits exactly what it emits for the same body merged
  directly;
* two port Servers, a local forwarding to a global, end to end.
"""

import json
import socket
import time

import numpy as np
import pytest

from veneur_tpu.core import store as jstore
from veneur_tpu.forward import convert as jconvert
from veneur_tpu.forward.http_forward import HTTPForwarder as JForwarder
from veneur_tpu.httpserv import OpsServer as JOpsServer
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.samplers.intermetric import HistogramAggregates as JAggs
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.core import store as tstore
from veneur_tpu_torch.forward import convert as tconvert
from veneur_tpu_torch.forward.http_forward import HTTPForwarder
from veneur_tpu_torch.httpserv import OpsServer
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

PCTS = [0.1, 0.5, 0.9, 0.99]
AGGS = ["min", "max", "count", "sum", "median"]
CHUNK = 64
SCOPES = ("", "|#veneurlocalonly", "|#veneurglobalonly", "|#env:a,zone:b")
FORMATS = ("structured", "reference")


def stream(seed=11):
    """(lines, raw): one interval of lines and each digest series' raw
    values by name. The second half of the digest samples steps the
    distribution by +500, which trips the shift guard."""
    rng = np.random.default_rng(seed)
    lines, raw = [], {}
    for i in range(40):
        sc = SCOPES[i % 4]
        for _ in range(int(rng.integers(1, 5))):
            lines.append(f"c.{i}:{int(rng.integers(1, 9))}|c{sc}")
        lines.append(f"g.{i}:{rng.normal(0, 50):.4f}|g{sc}")
        for _ in range(20):
            lines.append(f"s.{i}:m{int(rng.integers(0, 30 + 20 * i))}|s{sc}")
    for phase in (0.0, 500.0):
        for kind, t in (("h", "h"), ("t", "ms")):
            for i in range(40):
                for _ in range(int(rng.integers(6, 12))):
                    v = float(f"{phase + rng.gamma(2.0, 10.0):.4f}")
                    raw.setdefault(f"{kind}.{i}", []).append(v)
                    lines.append(f"{kind}.{i}:{v}|{t}{SCOPES[i % 4]}")
    return [ln.encode() for ln in lines], raw


LINES, RAW = stream()


def by_key(rows):
    out = {}
    for m in rows:
        key = (m.name, tuple(m.tags), m.type.value)
        assert key not in out, key
        out[key] = m.value
    return out


def assert_rows_match(got_rows, want_rows):
    """Emissions by (name, tags, type); percentiles and medians within
    0.02 x the series' raw (max - min)."""
    got, want = by_key(got_rows), by_key(want_rows)
    assert set(got) == set(want)
    for key, value in want.items():
        name = key[0]
        base, _, suffix = name.rpartition(".")
        if name.startswith("s."):
            np.testing.assert_allclose(got[key], value, rtol=1e-6,
                                       err_msg=key)
        elif suffix in ("sum", "avg"):
            np.testing.assert_allclose(got[key], value, rtol=1e-6,
                                       err_msg=key)
        elif suffix == "median" or suffix.endswith("percentile"):
            span = max(RAW[base]) - min(RAW[base])
            assert abs(got[key] - value) <= 0.02 * span + 1e-6, key
        else:
            assert got[key] == value, key


def digest_quantiles(means, weights, dmin, dmax, qs):
    """Inverse CDF of a merging t-digest (merging_digest.go:297-354) in
    float64 numpy: the yardstick both packages' centroids are held to."""
    means, weights = np.asarray(means), np.asarray(weights)
    ub = np.append((means[:-1] + means[1:]) / 2.0, dmax)
    incl = np.cumsum(weights)
    out = []
    for q in qs:
        target = q * incl[-1]
        i = min(int(np.searchsorted(incl, target)), len(means) - 1)
        lb = dmin if i == 0 else max(ub[i - 1], dmin)
        out.append(lb + (target - (incl[i] - weights[i])) / weights[i]
                   * (ub[i] - lb))
    return np.array(out)


@pytest.fixture(scope="module")
def locals_():
    """Both locals fed LINES and flushed as forwarding locals."""
    j = jstore.MetricStore(chunk=CHUNK)
    t = tstore.MetricStore(chunk=CHUNK, device="cpu")
    for line in LINES:
        j.process_metric(jparser.parse_metric(line))
        t.process_metric(tparser.parse_metric(line))
    jrows, jfwd, _ = j.flush(PCTS, JAggs.from_names(AGGS), is_local=True,
                             now=0)
    trows, tfwd = t.flush(PCTS, HistogramAggregates.from_names(AGGS), 0,
                          is_local=True)
    jfwd.materialize_digests()
    tfwd.materialize_digests()
    return {"jax": (jrows, jfwd), "port": (trows.to_intermetrics(), tfwd)}


def body(pkg, state, fmt):
    conv = jconvert if pkg == "jax" else tconvert
    entries = (conv.json_metrics_from_state(state) if fmt == "structured"
               else conv.reference_json_metrics_from_state(state))
    return json.loads(json.dumps(entries))  # as the wire carries it


def global_rows(pkg, metrics, chunk=CHUNK):
    """A fresh global of ``pkg`` merges one body and flushes."""
    if pkg == "jax":
        g = jstore.MetricStore(chunk=chunk)
        assert jconvert.apply_json_metric_list(g, metrics)[1] == 0
        rows, _, _ = g.flush(PCTS, JAggs.from_names(AGGS), is_local=False,
                             now=0)
        return rows
    g = tstore.MetricStore(chunk=chunk, device="cpu")
    assert tconvert.apply_json_metric_list(g, metrics)[1] == 0
    rows, _ = g.flush(PCTS, HistogramAggregates.from_names(AGGS), 0)
    return rows.to_intermetrics()


def test_local_flush_matches_jax(locals_):
    """What a local emits itself: local-only groups in full, mixed
    histograms/timers without percentiles, local sets, counters, gauges;
    no mixed sets and no global counters/gauges (those are forwarded)."""
    trows, jrows = locals_["port"][0], locals_["jax"][0]
    assert_rows_match(trows, jrows)
    names = {m.name for m in trows}
    assert "h.0.count" in names and "h.0.50percentile" not in names
    assert "h.1.50percentile" in names          # local-only
    assert "s.0" not in names and "s.1" in names
    assert "c.2" not in names and "c.1" in names


@pytest.mark.parametrize("fmt", FORMATS)
def test_forward_bodies_match_jax(locals_, fmt):
    tbody = body("port", locals_["port"][1], fmt)
    jbody = body("jax", locals_["jax"][1], fmt)
    assert len(tbody) == len(jbody)
    tops = {(d["name"], d["type"]): d for d in tbody}
    jops = {(d["name"], d["type"]): d for d in jbody}
    assert set(tops) == set(jops)
    n_digests = 0
    for key, jd in jops.items():
        if key[1] not in ("histogram", "timer"):
            assert tops[key] == jd, key   # scalars and sets: exact
            continue
        n_digests += 1
        (_, _, tm, tw, tmin, tmax), _ = tconvert._parse_json(tops[key])
        (_, _, jm, jw, jmin, jmax), _ = tconvert._parse_json(jd)
        np.testing.assert_allclose(tw.sum(), jw.sum(), rtol=1e-6)
        raw = np.float32(RAW[key[0]])  # the samples as the store holds them
        assert (tmin, tmax) == (jmin, jmax) == (raw.min(), raw.max())
        qs = np.linspace(0.0, 1.0, 21)
        dq = (digest_quantiles(tm, tw, tmin, tmax, qs)
              - digest_quantiles(jm, jw, jmin, jmax, qs))
        assert np.abs(dq).max() <= 0.02 * (tmax - tmin), key
    # every histogram and timer but the local-only ones is forwarded
    assert n_digests == 2 * 30


@pytest.mark.parametrize("fmt", FORMATS)
def test_bodies_cross_globals(locals_, fmt):
    """JAX body -> port global, port body -> JAX global, each against the
    JAX body -> JAX global."""
    jbody = body("jax", locals_["jax"][1], fmt)
    want = global_rows("jax", jbody)
    assert any(m.name.endswith("99percentile") for m in want)
    assert_rows_match(global_rows("port", jbody), want)
    assert_rows_match(global_rows("jax", body("port", locals_["port"][1],
                                              fmt)), want)


def _wait(cond, timeout=30.0):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, "timed out"
        time.sleep(0.02)


@pytest.mark.parametrize("fmt", FORMATS)
def test_http_wire_both_directions(locals_, fmt):
    compat = fmt == "reference"
    jglobal = jstore.MetricStore(chunk=CHUNK)
    tglobal = tstore.MetricStore(chunk=CHUNK, device="cpu")
    jops = JOpsServer("127.0.0.1:0", import_fn=lambda m:
                      jconvert.apply_json_metric_list(jglobal, m)[0])
    tops = OpsServer("127.0.0.1:0", import_fn=lambda m:
                     tconvert.apply_json_metric_list(tglobal, m)[0])
    jops.start()
    tops.start()
    try:
        tfwd = HTTPForwarder(f"127.0.0.1:{jops.port}",
                             reference_compat=compat)
        jfwd = JForwarder(f"127.0.0.1:{tops.port}", reference_compat=compat)
        assert tfwd.forward(locals_["port"][1])
        assert jfwd.forward(locals_["jax"][1])
        _wait(lambda: jops.import_pool.merged_batches == 1
              and tops.import_pool.merged_batches == 1)
    finally:
        jops.stop()
        tops.stop()
    assert tfwd.errors == 0 and tfwd.forwarded == len(
        body("port", locals_["port"][1], fmt))
    jrows, _, _ = jglobal.flush(PCTS, JAggs.from_names(AGGS),
                                is_local=False, now=0)
    trows = tglobal.flush(PCTS, HistogramAggregates.from_names(AGGS),
                          0)[0].to_intermetrics()
    # over the wire == merged directly, value for value
    assert by_key(jrows) == by_key(global_rows(
        "jax", body("port", locals_["port"][1], fmt)))
    assert by_key(trows) == by_key(global_rows(
        "port", body("jax", locals_["jax"][1], fmt)))


def test_port_servers_local_to_global():
    """A port Server local (UDP in, forward_address set) and a port Server
    global (http_address) end to end: one local flush forwards over
    HTTP (its digest groups streamed as parts of their own), the
    global's pool merges every body, one global flush emits what the
    JAX global emits for the JAX local's body of the same lines."""
    gsink, lsink = ChannelMetricSink(), ChannelMetricSink()
    glob = Server(Config(http_address="127.0.0.1:0", interval="3600s",
                         percentiles=PCTS, aggregates=AGGS, hostname="g"),
                  metric_sinks=[gsink], device="cpu")
    glob.start()
    try:
        local = Server(Config(
            statsd_listen_addresses=["udp://127.0.0.1:0"], interval="3600s",
            percentiles=PCTS, aggregates=AGGS, hostname="l",
            forward_address=f"http://127.0.0.1:{glob.ops_server.port}",
            # a loaded test run can hold a POST past the default 10 s
            # budget: the part would then re-merge (late) and arrive twice
            forward_timeout="60s"),
            metric_sinks=[lsink], device="cpu")
        local.start()
        try:
            assert local.is_local() and not glob.is_local()
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
                for i in range(0, len(LINES), 8):
                    tx.sendto(b"\n".join(LINES[i:i + 8]),
                              ("127.0.0.1", local.statsd_addrs[0][1]))
            _wait(lambda: local.store.processed == len(LINES))
            local.flush()
            assert local.wait_forward(30) is True
            # streaming egress (the default) POSTs each forwarded digest
            # group as its own part beside the rest of the state: wait
            # for every metric the local forwarded to merge (the flush's
            # self-metrics drain the forwarder's POST durations, so they
            # do not count the POSTs)
            forwarded = local.forwarder.forwarded
            _wait(lambda: glob.imported_metrics + glob.import_errors
                  == forwarded)
            assert glob.ops_server.import_pool.merged_batches >= 2
            glob.flush()
            # the global's own rows (its import spans' veneur.import.*
            # samples re-enter its pipeline) are not the local's data
            rows = [m for m in gsink.get_flush(timeout=10)
                    if not m.name.startswith("veneur.")]
        finally:
            local.shutdown()
    finally:
        glob.shutdown()
    assert glob.imported_metrics > 0 and glob.import_errors == 0
    # the reference pair at the Servers' staging chunk (the store default)
    j = jstore.MetricStore()
    for line in LINES:
        j.process_metric(jparser.parse_metric(line))
    _, jfwd, _ = j.flush(PCTS, JAggs.from_names(AGGS), is_local=True, now=0)
    jfwd.materialize_digests()
    assert_rows_match(rows, global_rows("jax", body("jax", jfwd,
                                                    "structured"),
                                        chunk=jstore.DEFAULT_CHUNK))
