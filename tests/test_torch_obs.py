"""The port's interval timeline and the flush's self-trace
(``veneur_tpu_torch/obs/``, the ``self_timers`` group, the flusher's
self-metrics) against the JAX package's (``veneur_tpu/obs/``).

* The ``StageRecorder`` on the same scripted clock and the same stage
  calls gives the same interval record in both packages (tree, coverage,
  ``record_abs``, ``amend``, ``record_late``, threads appending at once);
  the ``FlushTimeline`` ring stays bounded and its handler limits and
  refuses as the JAX one does; ``annotate_overlap`` buckets the same
  lanes. The kernel scopes are in ``test_torch_obs_kernels.py``.
* The ``self_timers`` group: the same rows from the same stage samples,
  exempt from the overload freeze, and carried by a checkpoint from
  either package into the other.
* A JAX Server and a port Server fed the same UDP lines for two
  intervals flush the same set of ``veneur.*`` row names (the fleet trace
  plane's ``veneur.fleet.e2e_age_ns`` and
  ``veneur.trace.fleet_pull_errors_total`` included), the same
  ``veneur.obs.stage_duration_ns`` stage tags, and the same counts that
  do not depend on time.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from veneur_tpu import obs as jobs
from veneur_tpu.config import Config as JConfig
from veneur_tpu.core import store as jstore
from veneur_tpu.obs import timeline as jtimeline
from veneur_tpu.persist import format as jpersist
from veneur_tpu.samplers.intermetric import HistogramAggregates as JAggs
from veneur_tpu.server import Server as JServer
from veneur_tpu.sinks import ChannelMetricSink as JChannel
from veneur_tpu_torch import obs as tobs
from veneur_tpu_torch.config import Config, read_config
from veneur_tpu_torch.core import store as tstore
from veneur_tpu_torch.obs import timeline as ttimeline
from veneur_tpu_torch.persist import format as tpersist
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

AGGS = ["min", "max", "count"]
PCTS = [0.5, 0.99]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, r.read().decode()


# -- the recorder ---------------------------------------------------------


def _nested(obs):
    clock = iter(range(0, 10000, 10))
    rec = obs.StageRecorder(clock_ns=lambda: next(clock) * 1000)
    with rec.stage("store"):
        with rec.stage("histograms", series=7):
            with rec.stage("fetch"):
                pass
    return rec.finish()


def _notes(obs):
    clock = iter(range(0, 10000, 10))
    rec = obs.StageRecorder(clock_ns=lambda: next(clock))
    with obs.activate(rec):
        with obs.maybe_stage("store"):
            with obs.maybe_stage("timers"):
                obs.note(rung="plain")
    return rec.finish()


def _abs_and_amend(obs):
    clock = iter(range(0, 10000, 10))
    rec = obs.StageRecorder(clock_ns=lambda: next(clock))
    t0 = rec.t0_ns
    rec.record_abs("post.datadog", t0 + 10, t0 + 510)
    rec.amend("post.datadog", bytes=42)
    return rec.finish()


def _coverage(obs):
    clock = iter([0, 0, 0, 900, 1000, 1000])
    rec = obs.StageRecorder(clock_ns=lambda: next(clock))
    with rec.stage("a"):
        with rec.stage("b"):
            pass
    return rec.finish(total_ns=1000)


def _late_before_finish(obs):
    clock = iter([0, 0, 1000, 1000])
    rec = obs.StageRecorder(clock_ns=lambda: next(clock))
    with rec.stage("post"):
        pass
    rec.record_late("forward", 0, 900)
    return rec.finish(total_ns=1000)


def _late_after_finish(obs):
    clock = iter(range(0, 10000, 10))
    rec = obs.StageRecorder(clock_ns=lambda: next(clock))
    entry = rec.finish()
    rec.record_late("forward", rec.t0_ns, rec.t0_ns + 5000, series=3)
    return entry


def _orphan_child(obs):
    """A child whose parent path was never recorded hangs at the root."""
    clock = iter(range(0, 10000, 10))
    rec = obs.StageRecorder(clock_ns=lambda: next(clock))
    rec.record_abs("post.channel", 20, 40)
    with rec.stage("store"):
        pass
    return rec.finish()


SCENARIOS = [_nested, _notes, _abs_and_amend, _coverage,
             _late_before_finish, _late_after_finish, _orphan_child]


def _comparable(entry):
    return {k: v for k, v in entry.items()
            if k not in ("wall_start", "wall_end")}


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_recorder_matches_jax(scenario):
    got, want = scenario(tobs), scenario(jobs)
    assert _comparable(got) == _comparable(want)


def test_recorder_coverage_and_tree():
    entry = _nested(tobs)
    assert [s["name"] for s in entry["stages"]] == [
        "store", "store.histograms", "store.histograms.fetch"]
    assert entry["tree"][0]["children"][0]["children"][0]["name"] == \
        "store.histograms.fetch"
    assert _coverage(tobs)["coverage_ratio"] == 1.0
    fwd = next(s for s in _late_before_finish(tobs)["stages"]
               if s["name"] == "forward")
    assert fwd["off_path"]


def test_module_hooks_are_noops_without_a_recorder():
    assert tobs.current() is None
    with tobs.maybe_stage("anything") as frame:
        assert frame is None
    tobs.note(rung="cuda")


def test_recorder_takes_every_writer_thread():
    for obs in (tobs, jobs):
        rec = obs.StageRecorder()

        def work(i, rec=rec):
            rec.record_abs(f"post.sink{i}", rec.t0_ns, rec.t0_ns + i)

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(rec.finish()["stages"]) == 8


# -- the timeline ring ----------------------------------------------------


def test_ring_is_bounded():
    for mod in (ttimeline, jtimeline):
        tl = mod.FlushTimeline(intervals=3)
        for i in range(7):
            tl.publish({"total_duration_ns": i, "coverage_ratio": 1.0,
                        "stages": [], "tree": []})
        assert [e["interval"] for e in tl.entries()] == [4, 5, 6]
        assert tl.published_total == 7
        assert tl.snapshot()["last_total_duration_ns"] == 6


@pytest.mark.parametrize("query,status", [({"n": "2"}, 200),
                                          ({}, 200), ({"n": "x"}, 400)])
def test_handler_limits_and_refuses(query, status):
    out = []
    for mod in (ttimeline, jtimeline):
        tl = mod.FlushTimeline(intervals=8)
        for i in range(5):
            tl.publish({"total_duration_ns": i, "coverage_ratio": 1.0,
                        "stages": [], "tree": []})
        code, body, _ = tl.handler(query)
        assert code == status
        if code == 200:
            data = json.loads(body)
            data.pop("instance_uid")
            out.append(data)
    if status == 200:
        assert out[0] == out[1]


def test_annotate_overlap_matches_jax():
    rng = np.random.default_rng(3)
    stages = []
    t = 0
    for name in ("store", "store.dispatch.histograms.compute",
                 "store.histograms.fetch", "serialize.histograms",
                 "post.datadog.serialize", "post.datadog.post",
                 "post.channel", "forward"):
        d = int(rng.integers(1000, 100000))
        stages.append({"name": name, "start_ns": t, "duration_ns": d,
                       **({"off_path": True} if name == "forward" else {})})
        t += int(rng.integers(0, d))
    stages.append({"name": "post.datadog", "start_ns": t,
                   "duration_ns": 5000, "post_ns": 3000,
                   "serialize_ns": 1000})
    got = ttimeline.annotate_overlap({"stages": [dict(s) for s in stages]})
    want = jtimeline.annotate_overlap({"stages": [dict(s) for s in stages]})
    assert got == want and got["overlap_ratio"] > 0


# -- the self-telemetry group ---------------------------------------------


DURATIONS = {"store.histograms": [1000.0, 2000.0, 3000.0, 4000.0, 5000.0],
             "post": [7000.0], "ingest.seal_to_merge": [12.0, 40.0, 9.0]}


def _rows(final):
    rows = (final.to_intermetrics() if hasattr(final, "to_intermetrics")
            else final)
    return {(m.name, tuple(m.tags)): m.value for m in rows}


def _self_timed(store):
    for stage, values in DURATIONS.items():
        for d in values:
            store.sample_self_timing(stage, d)
    return store


def test_self_timers_rows_match_jax():
    port = _self_timed(tstore.MetricStore(initial_capacity=32, chunk=128,
                                          device="cpu"))
    jax = _self_timed(jstore.MetricStore(initial_capacity=32, chunk=128))
    got = _rows(port.flush(PCTS, HistogramAggregates.from_names(AGGS), 1,
                           is_local=True, forward=False)[0])
    want = _rows(jax.flush(PCTS, JAggs.from_names(AGGS), is_local=True,
                           now=1, forward=False)[0])
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-6), key
    assert got[("veneur.obs.stage_duration_ns.count",
                ("stage:store.histograms",))] == 5


def test_self_timers_exempt_from_the_freeze():
    from veneur_tpu_torch.overload import OVERFLOW_NAME, OverloadController
    from veneur_tpu_torch.samplers.parser import MetricKey

    ctl = OverloadController(clock=lambda: 0.0)
    ctl._level = 1  # a forced freeze, no recompute (the clock is frozen)
    ctl._next_recompute = float("inf")
    store = tstore.MetricStore(initial_capacity=32, chunk=128,
                               overload=ctl, max_series=1000, device="cpu")
    store.sample_self_timing("store", 123.0)
    assert len(store.self_timers) == 1
    assert OVERFLOW_NAME not in store.self_timers.interner.names
    store.local_timers.sample(MetricKey(name="cust.t", type="timer"), [],
                              1.0, 1.0)
    assert OVERFLOW_NAME in store.local_timers.interner.names


@pytest.mark.parametrize("src", ["jax", "port"])
def test_self_timers_cross_the_checkpoint(src):
    """A checkpoint of one package's store carries the group into the
    other package's, which flushes the same rows."""
    make = {"jax": lambda: jstore.MetricStore(initial_capacity=32,
                                              chunk=128),
            "port": lambda: tstore.MetricStore(initial_capacity=32,
                                               chunk=128, device="cpu")}
    groups, _ = _self_timed(make[src]()).snapshot_state()
    assert groups["self_timers"]["names"]
    blob = (jpersist if src == "jax" else tpersist).serialize(
        groups, created_at=5.0, interval=10.0)
    port_dst, jax_dst = make["port"](), make["jax"]()
    port_dst.restore_state(tpersist.deserialize(blob)[0])
    jax_dst.restore_state(jpersist.deserialize(blob)[0])
    got = _rows(port_dst.flush(PCTS, HistogramAggregates.from_names(AGGS),
                               1, is_local=True, forward=False)[0])
    want = _rows(jax_dst.flush(PCTS, JAggs.from_names(AGGS), is_local=True,
                               now=1, forward=False)[0])
    assert set(got) == set(want) and got
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-6), key


# -- the configuration ----------------------------------------------------


def test_example_host_yaml_loads():
    cfg = read_config("example_host.yaml")
    assert cfg.obs_enabled is True
    assert cfg.obs_timeline_intervals == 64
    assert cfg.stats_address == "localhost:8125"


def test_obs_defaults_match_jax():
    got = Config()
    want = JConfig(interval="10s").apply_defaults()
    assert (got.obs_enabled, got.obs_timeline_intervals) == (
        want.obs_enabled, want.obs_timeline_intervals)
    with pytest.raises(ValueError, match="obs_timeline_intervals"):
        Config(obs_timeline_intervals=-1)


# -- a JAX Server and a port Server, two intervals ------------------------


def _lines(seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(24):
        scope = ("", "|#veneurlocalonly", "|#role:web")[i % 3]
        out.append(f"app.c.{i}:{int(rng.integers(1, 9))}|c{scope}")
        out.append(f"app.g.{i}:{rng.random():.4f}|g{scope}")
        out.append(f"app.h.{i}:{rng.gamma(2.0, 8.0):.4f}|h{scope}")
        out.append(f"app.t.{i}:{rng.gamma(2.0, 8.0):.4f}|ms{scope}")
        out.append(f"app.s.{i}:m{int(rng.integers(0, 20))}|s{scope}")
    return [ln.encode() for ln in out]


def _send(port, lines):
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
        for i in range(0, len(lines), 8):
            tx.sendto(b"\n".join(lines[i:i + 8]), ("127.0.0.1", port))


def _wait(cond, timeout=60.0):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, "timed out"
        time.sleep(0.02)


def _two_intervals(server, sink, port_of):
    """Two intervals of the same lines; the second flush's rows."""
    lines = _lines()
    server.start()
    try:
        port = port_of(server)
        for interval in range(2):
            _send(port, lines)
            _wait(lambda: server.store.processed >= len(lines))
            # the first flush's span reaches the store before the second
            # flush: it re-enters through the span workers
            if interval:
                _wait(lambda: "veneur.flush.total_duration_ns" in
                      server.store.histograms.interner.names)
            server.flush()
            rows = sink.get_flush(timeout=30)
        timeline = server.obs_timeline.entries()
    finally:
        server.shutdown()
    return rows, timeline


@pytest.fixture(scope="module")
def two_servers():
    cfg = dict(statsd_listen_addresses=["udp://127.0.0.1:0"],
               interval="3600s", percentiles=PCTS, aggregates=AGGS,
               hostname="obs", num_readers=1, flush_columnar=False)
    tsink, jsink = ChannelMetricSink(), JChannel()
    port = _two_intervals(Server(Config(**cfg), metric_sinks=[tsink],
                                 device="cpu"), tsink,
                          lambda s: s.statsd_addrs[0][1])
    jax = _two_intervals(JServer(JConfig(**cfg), metric_sinks=[jsink]),
                         jsink, lambda s: s.statsd_addrs[0][1])
    return port, jax


def _veneur(rows):
    return {m.name for m in rows if m.name.startswith("veneur.")}


# the JAX package's rows the port does not emit: none since the fleet
# trace plane (a global's ingest-to-sink age, its aggregator's pull
# errors) landed
PINNED_JAX_ONLY = set()


def test_servers_flush_the_same_self_metric_names(two_servers):
    (port_rows, _), (jax_rows, _) = two_servers
    got, want = _veneur(port_rows), _veneur(jax_rows)
    assert "veneur.obs.stage_duration_ns.50percentile" in got
    assert "veneur.flush.total_duration_ns.count" in got
    assert got - want == set(), sorted(got - want)
    assert want - got == PINNED_JAX_ONLY, sorted(want - got)


def _stage_tags(rows):
    return {t for m in rows if m.name == "veneur.obs.stage_duration_ns.count"
            for t in m.tags}


def test_servers_time_the_same_stages(two_servers):
    (port_rows, port_tl), (jax_rows, jax_tl) = two_servers
    got, want = _stage_tags(port_rows), _stage_tags(jax_rows)
    for stage in ("store", "store.swap", "store.dispatch",
                  "store.histograms", "store.self_timers", "post",
                  "span_join", "ingest.recv", "ingest.seal_to_merge"):
        assert f"stage:{stage}" in got, stage
    assert got == want, (sorted(got - want), sorted(want - got))
    assert [len(port_tl), len(jax_tl)] == [2, 2]
    for entry in port_tl:
        assert entry["coverage_ratio"] > 0.5
        assert entry["ingest_seal_to_merge"]["count"] >= 1


def _counts(rows):
    out = {}
    for m in rows:
        if m.name in ("veneur.flush.post_metrics_total",
                      "veneur.worker.metrics_processed_total",
                      "veneur.worker.metrics_flushed_total",
                      "veneur.worker.metrics_imported_total",
                      "veneur.packet.error_total",
                      "veneur.worker.spans_dropped_total"):
            out[(m.name, tuple(m.tags))] = m.value
    return out


def test_servers_count_the_same(two_servers):
    (port_rows, _), (jax_rows, _) = two_servers
    got, want = _counts(port_rows), _counts(jax_rows)
    assert got == want
    assert got[("veneur.worker.metrics_processed_total", ())] == \
        len(_lines())


def test_customer_rows_unchanged_by_the_self_trace(two_servers):
    (port_rows, _), (jax_rows, _) = two_servers
    got = {m.name for m in port_rows if not m.name.startswith("veneur.")}
    want = {m.name for m in jax_rows if not m.name.startswith("veneur.")}
    assert got == want and got


# -- the plane switched off -----------------------------------------------


def test_obs_disabled_means_no_recorder_and_404():
    cfg = Config(statsd_listen_addresses=[], interval="86400s",
                 http_address="127.0.0.1:0", obs_enabled=False,
                 store_initial_capacity=32, store_chunk=128)
    sink = ChannelMetricSink()
    srv = Server(cfg, metric_sinks=[sink], device="cpu")
    srv.start()
    try:
        assert srv.obs_timeline is None
        for _ in range(2):
            srv.handle_metric_packet(b"x:1|c")
            srv.flush()
            sink.get_flush(timeout=10)
        # no stage samples accrue with obs off
        assert len(srv.store.self_timers) == 0
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.ops_server.port, "/debug/flush-timeline")
        assert e.value.code == 404
        # the kernel counters stay on (they back /debug/xprof)
        _s, body = _get(srv.ops_server.port, "/debug/vars")
        obs = json.loads(body)["obs"]
        assert "dispatches" in obs["kernels"] and "timeline" not in obs
    finally:
        srv.shutdown()
