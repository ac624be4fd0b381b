"""One interval's flush: events, span sinks, the store, forward, sinks.

Port of ``veneur_tpu/flusher.py``'s ``flush_once`` (flusher.go:26-132):
the interval's events go to every metric sink's ``flush_other_samples``
(flusher.go:42-47); the span sinks flush on a thread of their own
(flusher.go:49), each sink once; the store drains into the sinks' rows
and, on a local, the ForwardableState it forwards; the forward runs on
its own thread off the flush path (flusher.go:66-75), its digest groups
packed on the device when the forwarder asks for them (the native
lane's ``wants_packed_digests``); each metric sink
flushes on a thread of its own (flusher.go:82-93), and the plugins run
after the sinks (flusher.go:95-109).

With ``flush_columnar`` (the default) the store's rows stay
``EmissionBlock`` columns: a sink with ``flush_columnar`` takes them as
they are, any other sink gets ``to_intermetrics()``. The native egress
library must load: a build or load failure fails the flush (there is no
quiet per-row fallback). With ``flush_streaming`` and a pipelined store
too, every sink with ``flush_chunk`` gets each completed group as it
exists (core/pipeline.py), and a forwarder that takes parts ships each
forwarded digest group upstream the same way. A store flush truncates
the checkpoint (``persist/``): the state it captured is now on its way
to the sinks. An active global with standby peers (``fleet/standby.py``)
snapshots the store just before its flush and, once the flush landed,
hands that snapshot to its replicator.

Self-telemetry (``obs/``, ``trace/``): the pass runs under a
``veneur.flush`` span whose samples are the server's self-metrics
(``veneur.flush.*``, ``veneur.worker.*``, ``veneur.packet.*``,
``veneur.overload.*``, ``veneur.forward.*``, ``veneur.import.*``,
``veneur.sink.*``, ``veneur.trace_client.*``, ``veneur.obs.*``,
``veneur.gc.*``, ``veneur.mem.*``, and the fleet's: ``veneur.fleet.*``,
``veneur.handoff.*``, ``veneur.ha.*``, ``veneur.checkpoint.*``,
``veneur.trace.*``), recorded into the server's own span channel so they
flush with the next interval; with ``obs_enabled`` its stages
(``events``, ``egress_detect``, ``ha_capture``, ``store`` with ``swap``,
``scalars``, ``dispatch`` and a stage a group, ``post``, ``plugins``,
``span_join``) land in ``/debug/flush-timeline``, as child spans and in
the ``self_timers`` group.

The fleet trace plane (``obs/tracectx.py``): at the generation swap the
flush takes the oldest ingest-era stamp its state holds (its lanes'
chunks and the hops it received); the forward carries the flush span's
ids and that stamp in ``X-Veneur-Trace`` (the batch forward and every
streamed part, over HTTP and gRPC; the ``native://`` lane carries none,
as in the JAX package), and the replication to a standby the span's ids.
At the interval's end the hops the server received since its last flush
(``server.obs_hops``) publish in its timeline entry with their trace ids
(``import_traces``), and a global samples the stamp's age after its
sinks joined as ``veneur.fleet.e2e_age_ns``.
"""

from __future__ import annotations

import collections
import inspect
import logging
import threading
import time
from typing import TYPE_CHECKING

from veneur_tpu_torch import obs
from veneur_tpu_torch.core.pipeline import ChunkStream
from veneur_tpu_torch.core.store import ForwardableState
from veneur_tpu_torch.native import egress
from veneur_tpu_torch.obs import kernels as obs_kernels
from veneur_tpu_torch.obs import tracectx
from veneur_tpu_torch.obs.timeline import annotate_overlap
from veneur_tpu_torch.resilience import Deadline
from veneur_tpu_torch.samplers.parser import MetricKey
from veneur_tpu_torch.sinks.base import filter_acceptable
from veneur_tpu_torch.trace import Trace
from veneur_tpu_torch.trace import samples as ssf_samples
from veneur_tpu_torch.trace.client import send_client_statistics

if TYPE_CHECKING:
    from veneur_tpu_torch.server import Server

log = logging.getLogger("veneur.flusher")

# how long a flush waits at its end for the span sinks' flush thread
# (the span_join stage; flusher.go:49 runs it beside the metric path)
SPAN_JOIN_TIMEOUT = 10.0


def flush_once(server: "Server") -> int:
    """Flush one interval; returns the number of rows emitted. A sink or
    plugin that raises is logged and the others still flush; a store
    (kernel) failure or an egress library that cannot load propagates.

    The pass runs under a ``veneur.flush`` root span (flusher.go:26-29)
    whose samples are the server's self-metrics; it is recorded through
    ``server.trace_client`` into the server's own span channel, so they
    re-enter the pipeline as ``veneur.*`` rows of the next flush. With
    ``obs_enabled`` the pass also runs under a :class:`StageRecorder`:
    its stage tree lands in ``server.obs_timeline``
    (``/debug/flush-timeline``), becomes child spans of the root, and
    each stage's duration a sample of the ``self_timers`` group."""
    span = Trace.start_trace("veneur.flush")
    span.name = "flush"
    timeline = server.obs_timeline
    rec = obs.StageRecorder() if timeline is not None else None
    if rec is not None:
        rec.adopt_trace(span.trace_id, span.span_id,
                        hop="local.flush" if server.is_local()
                        else "global.flush")
    try:
        with obs.activate(rec):
            n = _flush_once(server, span, rec)
        server.last_flush_time = time.time()
        server.last_flush_ok = True
        return n
    except Exception:
        server.last_flush_ok = False
        raise
    finally:
        if rec is not None:
            try:
                _publish_interval(server, span, rec, timeline)
            except Exception:  # telemetry must never fail a flush
                log.exception("flush-timeline publication failed")
        span.client_record(server.trace_client)


def _flush_once(server: "Server", span, rec) -> int:
    now = int(time.time())
    # events -> every metric sink's flush_other_samples (flusher.go:42-47)
    with obs.maybe_stage("events"):
        samples = server.event_worker.flush()
        for sink in server.metric_sinks:
            try:
                sink.flush_other_samples(samples)
            except Exception:
                log.exception("sink %s flush_other_samples failed",
                              sink.name)
    span_flusher = _start_span_flush(server)
    # the interval's egress budget: sink and streamed-part retries end
    # before the next flush; a seeded deadline_pressure fault shrinks it
    # (one schedule draw a flush)
    budget = _egress_budget(server)
    if server.soak_injector is not None:
        budget = server.soak_injector.scale_deadline("flush.deadline",
                                                     budget)
    deadline = Deadline.after(budget)
    is_local = server.is_local()
    forwarding = is_local and server.forward_fn is not None
    # the heavy-hitter sketch rides our JSON body, never the reference's
    # (forward_reference_compatible): then the local emits its own top-k
    topk_ok = getattr(server.forwarder, "supports_topk", True)
    use_columnar = server.config.flush_columnar
    if use_columnar:
        # the first call builds the library (seconds); raises if not
        with obs.maybe_stage("egress_detect"):
            egress.load()
    # device-packed digest planes whenever the forwarder takes them (the
    # native lane): only live centroids cross to the host, 4 bytes each
    digest_format = "packed" if (
        forwarding and getattr(server.forwarder, "wants_packed_digests",
                               False)) else "dense"
    # the freshness anchor, read and reset AT the swap: the oldest lane
    # chunk merged before it and the oldest received hop recorded before
    # it, the samples THIS flush drains (a stamp arriving after the swap
    # merges into the next generation and ages the next interval). The
    # forward's trace context and _publish_interval read it
    server._interval_oldest_ingest_ns = _take_oldest_ingest_ns(server)
    fwd_kwargs = _forward_kwargs(server, span, now) if forwarding else {}
    stream, stream_sinks = _build_stream(server, now, deadline,
                                         use_columnar, forwarding, rec,
                                         fwd_kwargs)
    ha_snapshot = _ha_capture(server)
    try:
        t0 = time.perf_counter()
        with obs.maybe_stage("store"):
            final, forwardable = server.store.flush(
                server.histogram_percentiles, server.histogram_aggregates,
                now, is_local=is_local, forward=forwarding,
                forward_topk=topk_ok, columnar=use_columnar,
                digest_format=digest_format, stream=stream)
        flush_elapsed = time.perf_counter() - t0
        log.debug("store flush of %d rows took %.1f ms", len(final),
                  flush_elapsed * 1e3)
        # the store just drained: a checkpoint holds state that is now
        # flushing, so a restart must never merge (and flush) it again.
        # Non-blocking: a write in flight holds the IO lock through its
        # fsync, and the writer's own epoch check then removes its file
        if server.checkpointer is not None:
            server.checkpointer.truncate(blocking=False)
        if ha_snapshot is not None:
            # the flush landed: the captured (now retired) epoch streams
            # to the standbys off the flush path, under the flush span
            # (no ingest stamp: a standby shadows it, it emits nothing)
            server.standby_manager.capture(
                *ha_snapshot,
                trace_ctx=tracectx.TraceContext(span.trace_id,
                                                span.span_id))
        # the self-metric set (README.md:248-277) rides the flush span
        # and re-enters the pipeline through the extraction sink
        _add_flush_samples(server, span, final, flush_elapsed)
        if forwarding and len(forwardable):
            # the batch forward's budget starts with it, as before
            # streaming: a slow store flush must not leave it no time
            # (this state has no requeue)
            thread = threading.Thread(
                target=_forward,
                args=(server, forwardable,
                      Deadline.after(_egress_budget(server)), rec,
                      fwd_kwargs),
                name="forward", daemon=True)
            server.forward_thread = thread
            thread.start()
        # the post stage covers the streamed chunks' tail as well as the
        # batch fan-out
        post_t0 = time.monotonic_ns()
    finally:
        # the interval barrier: every streamed chunk and forward part is
        # acked or requeued before the sink fan-out
        if stream is not None:
            stream.close()
    if final:
        t_post = time.perf_counter()
        sink_elapsed = _fan_out(server, final, stream_sinks, deadline, rec)
        if rec is not None:
            rec.record_abs("post", post_t0, time.monotonic_ns(),
                           sinks=len(server.metric_sinks))
        _check_flush_overrun(server, deadline, budget, sink_elapsed)
        span.add(ssf_samples.timing("veneur.flush.total_duration_ns",
                                    time.perf_counter() - t_post,
                                    {"part": "post"}),
                 *_sink_samples(server, sink_elapsed))
        # plugins run after the sinks (flusher.go:95-109)
        with obs.maybe_stage("plugins"):
            _flush_plugins(server, final)
    if span_flusher is not None:
        with obs.maybe_stage("span_join"):
            span_flusher.join(timeout=SPAN_JOIN_TIMEOUT)
    return len(final)


def _add_flush_samples(server: "Server", span, final,
                       flush_elapsed: float) -> None:
    ms = server.store.last_summary
    span.add(
        ssf_samples.timing("veneur.flush.total_duration_ns", flush_elapsed,
                           {"part": "store"}),
        ssf_samples.count("veneur.flush.post_metrics_total",
                          float(len(final)), None),
        ssf_samples.count(
            "veneur.flush.span_flush_skipped_total",
            float(_delta_since(server, "_last_span_flush_skipped",
                               server.span_flush_skipped)), None),
        ssf_samples.gauge("veneur.flush.age_seconds",
                          server.flush_age_seconds(), None),
        ssf_samples.count(
            "veneur.flush.overrun_total",
            float(_delta_since(server, "_last_flush_overruns",
                               server.flush_overruns)), None),
        *_worker_samples(server, ms),
        *_overload_samples(server, ms),
        *_fleet_samples(server),
        *_handoff_samples(server),
        *_ha_samples(server),
        *_forward_samples(server),
        *_import_samples(server),
        *_checkpoint_samples(server),
        *_trace_client_samples(server),
        *_runtime_samples())


def _ha_capture(server: "Server"):
    """Warm-standby replication: the (groups, flush_epoch) the flush is
    about to drain, taken without resetting anything BEFORE the
    generation swap, or None. Replicating only what a flush emitted is
    what makes the promoted standby's counter exclusion exact."""
    sby = getattr(server, "standby_manager", None)
    if sby is None or not sby.wants_capture():
        return None
    with obs.maybe_stage("ha_capture"):
        try:
            return server.store.snapshot_state()
        except Exception:
            log.exception("HA replication capture failed; this epoch "
                          "will not replicate")
            return None


def _egress_budget(server: "Server") -> float:
    return min(server.interval, server.config.forward_timeout_seconds)


def _fan_out(server: "Server", final, stream_sinks, deadline: Deadline,
             rec) -> dict:
    """One thread per metric sink (flusher.go:82-93). A streaming sink
    already has the blocks and gets only the extras; a columnar sink
    gets the whole flush as columns; any other sink gets InterMetrics.
    Without ``flush_columnar`` the flush holds no blocks, so a columnar
    sink takes every row through its per-row path. Returns each sink's
    seconds (a sink still running after the join has none); each sink
    thread records ``post.<sink>`` on the timeline."""
    threads = []
    sink_elapsed: dict = {}

    def timed(target, sink, arg):
        t0, t0_ns = time.perf_counter(), time.monotonic_ns()
        try:
            target(sink, arg)
        finally:
            sink_elapsed[sink.name] = time.perf_counter() - t0
            if rec is not None:
                rec.record_abs(f"post.{sink.name}", t0_ns,
                               time.monotonic_ns())

    for sink in server.metric_sinks:
        if hasattr(sink, "set_flush_deadline"):
            sink.set_flush_deadline(deadline)
        if sink in stream_sinks:
            target, arg = _flush_sink, list(final.extras)
        elif hasattr(sink, "flush_columnar"):
            target, arg = _flush_sink_columnar, final
        else:
            target, arg = _flush_sink, final.to_intermetrics()
        t = threading.Thread(target=timed, args=(target, sink, arg),
                             name=f"flush-{sink.name}", daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=30.0)
    return sink_elapsed


def _flush_plugins(server: "Server", final) -> None:
    for plugin in server.plugins:
        try:
            if hasattr(plugin, "flush_columnar"):
                plugin.flush_columnar(final)
            else:
                plugin.flush(final.to_intermetrics())
        except Exception:
            log.exception("plugin %s flush failed", plugin.name)


def _flush_sink(sink, metrics) -> None:
    try:
        sink.flush(filter_acceptable(metrics, sink.name))
    except Exception:
        log.exception("sink %s flush failed", sink.name)


def _flush_sink_columnar(sink, batch) -> None:
    # the blocks carry no routing (the store emits a veneursinkonly:
    # group per row); each columnar sink filters the extras itself
    try:
        sink.flush_columnar(batch)
    except Exception:
        log.exception("sink %s columnar flush failed", sink.name)


def _build_stream(server: "Server", now: int, deadline: Deadline,
                  use_columnar: bool, forwarding: bool, rec,
                  fwd_kwargs: dict):
    """The interval's :class:`ChunkStream` when streaming egress is on
    (``flush_streaming`` with a columnar, pipelined flush): every sink
    with ``flush_chunk`` POSTs each completed group the moment it
    exists, and when the forwarder takes parts, each forwarded digest
    group ships upstream the same way (with the batch forward's trace
    kwargs), a part that fails terminally re-merged into the live
    store. Returns (the stream or None, the streaming sinks)."""
    if not (use_columnar and server.config.flush_streaming
            and server.store.flush_pipeline_depth > 0):
        return None, []
    sinks = [s for s in server.metric_sinks if hasattr(s, "flush_chunk")]
    for sink in sinks:
        # the budget must be on the sink before its first chunk arrives
        if hasattr(sink, "set_flush_deadline"):
            sink.set_flush_deadline(deadline)
    fwd_fn = fwd_requeue = None
    if forwarding and getattr(server.forwarder, "supports_chunked_forward",
                              False):
        def fwd_fn(attr, part):
            mini = ForwardableState()
            setattr(mini, attr, part)
            return server.forward_fn(mini, deadline=deadline,
                                     **fwd_kwargs)

        def fwd_requeue(attr, part):
            _requeue_forward_part(server.store, attr, part)
    if not sinks and fwd_fn is None:
        return None, []
    return ChunkStream(sinks, now, depth=server.store.flush_pipeline_depth,
                       rec=rec, forward_fn=fwd_fn,
                       forward_requeue=fwd_requeue), sinks


def _requeue_forward_part(store, attr: str, part) -> None:
    """A streamed forward part that failed terminally re-merges into the
    LIVE store with import semantics, late but not lost: it forwards
    again with the next interval."""
    mini = ForwardableState()
    setattr(mini, attr, part)
    mini.materialize_digests()
    mtype = "histogram" if attr.startswith("histogram") else "timer"
    rows = mini.histograms if mtype == "histogram" else mini.timers
    entries = [
        (MetricKey(name=name, type=mtype, joined_tags=",".join(tags)),
         tags, means, weights, dmin, dmax)
        for name, tags, means, weights, dmin, dmax in rows]
    if entries:
        store.import_digests_bulk(entries)
        log.warning("re-merged %d forwarded %s series into the live store "
                    "after a streamed-forward failure; they ship with the "
                    "next flush", len(entries), mtype)


def _start_span_flush(server: "Server"):
    """Flush the span sinks on a thread of their own (flusher.go:49) and
    return it; the flush joins it at its end (the ``span_join`` stage,
    up to ``SPAN_JOIN_TIMEOUT``). A wedged lane can hold its barrier for 9 s, so with a
    short interval the previous span flush may still run: then this
    interval's is skipped, counted in ``server.span_flush_skipped``, and
    the previous thread is the one joined."""
    if not server._span_workers:
        return None  # not started: no span lanes
    previous = server.span_flush_thread
    if previous is not None and previous.is_alive():
        server._count("span_flush_skipped")
        log.warning("previous span flush still running; skipping this "
                    "interval's span flush")
        return previous
    # the lanes are shared between workers: flush each sink once
    thread = threading.Thread(target=server._span_workers[0].flush,
                              name="span-flush", daemon=True)
    server.span_flush_thread = thread
    thread.start()
    return thread


def _forward_kwargs(server: "Server", span, now: int) -> dict:
    """The trace kwargs the forward takes (flusher.go:66-75 hands it the
    flush span): ``parent_span``, whose parent-context headers the HTTP
    and gRPC forwarders send (http.go:184-188), and ``trace_ctx``, the
    fleet trace plane's hop context: the flush span's ids and the
    oldest ingest-era stamp aboard (the interval's start when no lane
    stamped one). A ``forward_fn`` without them (the native lane's, a
    caller's wrapper) gets none."""
    try:
        params = inspect.signature(server.forward_fn).parameters
    except (TypeError, ValueError):
        return {}  # not introspectable: the forward runs without them
    ingest_ns = server._interval_oldest_ingest_ns or int(now * 1e9)
    kwargs = {"parent_span": span,
              "trace_ctx": tracectx.TraceContext(span.trace_id,
                                                 span.span_id, ingest_ns)}
    return {k: v for k, v in kwargs.items() if k in params}


def _forward(server: "Server", state, deadline: Deadline, rec,
             fwd_kwargs: dict):
    """The forward thread: one POST of the interval's state (with the
    forwarder's own retries inside the deadline). Its outcome lands in
    ``server.last_forward_ok``; a failed forward is logged and counted
    and the thread ends: the state is not requeued. With a recorder, it
    lands in the interval's published timeline entry as the off-path
    ``forward`` stage."""
    t0 = time.monotonic_ns()
    try:
        ok = bool(server.forward_fn(state, deadline=deadline,
                                    **fwd_kwargs))
    except Exception:
        log.exception("forward failed")
        ok = False
    if not ok:
        server._count("forward_errors")
    server.last_forward_ok = ok
    if rec is not None:
        rec.record_late("forward", t0, time.monotonic_ns(),
                        series=len(state))


# -- the interval's self-trace ------------------------------------------------


def _publish_interval(server: "Server", span, rec, timeline) -> None:
    """Interval end: finish the stage record (with the hops this server
    received since its last flush as off-path stages, the ingest lanes'
    stage times as an off-path ``ingest`` subtree and their seal->merge
    latencies), stamp the entry with the received hops' trace ids
    (``import_traces``, what ``/debug/trace`` matches the aggregating
    flush on) and the age of the oldest ingest stamp it drained,
    annotate the egress overlap, publish it to the timeline ring, mirror
    the stage tree as child spans of the flush span, sample every stage
    duration into the self-telemetry group, and add the ``veneur.obs.*``
    and ``veneur.trace.*`` samples to the flush span. On a global the
    age, taken after the sinks joined, spans ingest to the sink's 2xx:
    ``veneur.fleet.e2e_age_ns``."""
    hops = server.obs_hops.drain() if server.obs_hops is not None else []
    for h in hops:
        # the true wall times ride as attrs: a hop that landed BEFORE
        # this interval began has its start clamped to 0 in the
        # recorder's frame, and the stitcher needs the real order
        attrs = {k: v for k, v in h.items()
                 if k not in ("hop", "duration_ns")}
        rec.record_abs(h["hop"],
                       tracectx.wall_to_mono_ns(rec, h["wall_start"]),
                       tracectx.wall_to_mono_ns(rec, h["wall_end"]),
                       off_path=True, **attrs)
    ingest = _drain_ingest_stages(server)
    if ingest:
        # lane-time since the last interval (recv includes socket wait),
        # anchored at the interval's start and off-path: ingest overlaps
        # the whole interval and must not count against coverage
        total = sum(ingest[s] for s in _INGEST_STAGES)
        rec.record_abs("ingest", rec.t0_ns, rec.t0_ns + total,
                       off_path=True, lanes=ingest["lanes"],
                       iters=ingest["iters"])
        for stage in _INGEST_STAGES:
            rec.record_abs(f"ingest.{stage}", rec.t0_ns,
                           rec.t0_ns + ingest[stage], off_path=True)
    entry = rec.finish()
    tids = sorted({h["trace_id"] for h in hops if h.get("trace_id")})
    if tids:
        entry["import_traces"] = tids
    latencies = _drain_ingest_latencies(server)
    if latencies:
        entry["ingest_seal_to_merge"] = {
            "count": len(latencies), "max_ns": int(max(latencies)),
            "avg_ns": int(sum(latencies) / len(latencies))}
    # freshness: the oldest ingest stamp this interval drained, taken at
    # the swap (_flush_once)
    oldest = server._interval_oldest_ingest_ns
    e2e_ns = None
    if oldest:
        age_ns = max(0, time.time_ns() - oldest)
        entry["oldest_sample_age_ns"] = age_ns
        if not server.is_local():
            e2e_ns = entry["e2e_age_ns"] = age_ns
    annotate_overlap(entry)
    timeline.publish(entry)
    _record_stage_spans(server, span, entry)
    store = server.store
    for stage in entry["stages"]:
        store.sample_self_timing(stage["name"], stage["duration_ns"])
    for ns in latencies:
        store.sample_self_timing("ingest.seal_to_merge", float(ns))
    if e2e_ns is not None:
        # its own metric name, through the same digest group
        store.sample_self_timing("e2e", float(e2e_ns),
                                 name="veneur.fleet.e2e_age_ns")
    for hop, n in sorted(collections.Counter(
            h["hop"] for h in hops).items()):
        span.add(ssf_samples.count("veneur.trace.hops_total", float(n),
                                   {"hop": hop}))
    agg = server.fleet_aggregator
    if agg is not None:
        span.add(ssf_samples.count(
            "veneur.trace.fleet_pull_errors_total",
            float(_delta_since(agg, "_last_pull_errors",
                               agg.pull_errors_total)), None))
    if entry.get("overlap_ratio") is not None:
        span.add(ssf_samples.gauge("veneur.obs.overlap_ratio",
                                   float(entry["overlap_ratio"]), None))
    span.add(
        ssf_samples.gauge("veneur.obs.stage_coverage_ratio",
                          float(entry["coverage_ratio"]), None),
        # nothing compiles at run time in the port: always 0
        ssf_samples.count("veneur.obs.kernel_compiles_total",
                          float(obs_kernels.compiles_total()), None))
    for scope_name, n in sorted(obs_kernels.dispatch_snapshot().items()):
        span.add(ssf_samples.count(
            "veneur.obs.kernel_dispatches_total",
            float(_delta_since(server, f"_last_dispatch_{scope_name}", n)),
            {"scope": scope_name}))


_INGEST_STAGES = ("recv", "decode", "stage", "seal")


def _drain_ingest_stages(server: "Server"):
    """The interval's ingest-lane stage times summed over every fleet
    (``IngestFleet.take_ingest_stages``); None without lanes or with
    stage tracing off."""
    total = None
    for fleet in server.ingest_fleets:
        stages = fleet.take_ingest_stages()
        if not stages:
            continue
        if total is None:
            total = stages
        else:
            for k in _INGEST_STAGES + ("iters", "lanes"):
                total[k] += stages[k]
    return total


def _take_oldest_ingest_ns(server: "Server"):
    """The oldest ingest-era stamp (wall ns) among the lane chunks
    merged and the hops received since the last flush (each read and
    reset), or None."""
    stamps = [fleet.take_oldest_ingest_ns() for fleet in server.ingest_fleets]
    if server.obs_hops is not None:
        stamps.append(server.obs_hops.take_oldest_ingest_ns())
    return min((v for v in stamps if v), default=None)


def _drain_ingest_latencies(server: "Server") -> list:
    """The interval's seal->merge latencies (ns) of every ingest fleet."""
    out: list = []
    for fleet in server.ingest_fleets:
        out.extend(fleet.take_merge_latencies())
    return out


def _record_stage_spans(server: "Server", root, entry) -> None:
    """Mirror the stage tree as child spans: one a stage, parented on
    its dotted-path parent's span (top-level stages on the flush root),
    its start and end on the root's wall clock, its attrs as tags.
    Recorded through the same nonblocking client as the root: a full
    span channel drops them."""
    cl = server.trace_client
    wall0 = entry["wall_start"]
    by_path = {}
    for stage in entry["stages"]:
        path = stage["name"]
        parent = by_path.get(path.rsplit(".", 1)[0]) if "." in path \
            else None
        child = (parent or root).start_child_span()
        child.name = f"veneur.flush.{path}"
        child.start = wall0 + stage["start_ns"] / 1e9
        child.end = child.start + stage["duration_ns"] / 1e9
        for key, value in stage.items():
            if key not in ("name", "start_ns", "duration_ns"):
                child.tags[key] = str(value)
        by_path[path] = child
        child.client_record(cl)


def _delta_since(obj, last_attr: str, cur):
    """An interval delta of a cumulative counter: ``cur`` is read once by
    the caller (re-reading it for the reset would lose what counted in
    between)."""
    delta = cur - getattr(obj, last_attr, 0)
    setattr(obj, last_attr, cur)
    return delta


def _check_flush_overrun(server: "Server", deadline: Deadline,
                         budget: float, sink_elapsed: dict) -> None:
    """The flush watchdog: retries clamp to the egress deadline, so one
    that actually expired means a sink ignored its budget. Counted in
    ``server.flush_overruns`` (``veneur.flush.overrun_total``), with a
    warning naming the culprit at most every 30 s."""
    if not deadline.expired():
        return
    server.flush_overruns += 1
    now = time.monotonic()
    if now - server._last_overrun_warn < 30.0:
        return
    server._last_overrun_warn = now
    # a sink whose thread outlived the join reported no time: it is the
    # culprit, not the slowest one that finished
    wedged = [s.name for s in server.metric_sinks
              if s.name not in sink_elapsed]
    if wedged:
        slowest = f"sink(s) still running: {', '.join(wedged)}"
    elif sink_elapsed:
        name, took = max(sink_elapsed.items(), key=lambda kv: kv[1])
        slowest = f"slowest sink: {name} ({took:.2f}s)"
    else:
        slowest = "no sink timings recorded"
    log.warning("flush overran its %.1fs egress deadline; %s (%d overruns "
                "since start)", budget, slowest, server.flush_overruns)


# -- the self-metrics on the flush span (README.md:248-277) -----------------


def _worker_samples(server: "Server", ms) -> list:
    """``veneur.worker.*`` and ``veneur.packet.*``: interval deltas of the
    ingest tallies, and each span lane's depth and high watermark."""
    errs = _delta_since(server, "_last_packet_errors",
                        server.packet_errors)
    drops = _delta_since(server, "_last_packet_drops", server.packet_drops)
    span_drops = _delta_since(server, "_last_spans_dropped",
                              server.spans_dropped)
    out = [
        ssf_samples.count("veneur.worker.spans_dropped_total",
                          float(span_drops), None),
        ssf_samples.count("veneur.worker.metrics_processed_total",
                          float(ms.processed), None),
        ssf_samples.count("veneur.worker.metrics_imported_total",
                          float(ms.imported), None),
        ssf_samples.count("veneur.packet.error_total", float(errs),
                          {"packet_type": "statsd"}),
        ssf_samples.count("veneur.packet.drop_total", float(drops),
                          {"packet_type": "statsd"}),
    ]
    for mtype in ("counters", "gauges", "histograms", "sets", "timers"):
        out.append(ssf_samples.count(
            "veneur.worker.metrics_flushed_total",
            float(getattr(ms, mtype)), {"metric_type": mtype.rstrip("s")}))
    for lane in server._span_lanes:
        hwm, lane.depth_hwm = lane.depth_hwm, 0
        out.append(ssf_samples.gauge("veneur.server.span_lane.depth",
                                     float(lane.queue.qsize()),
                                     {"sink": lane.sink.name}))
        out.append(ssf_samples.gauge("veneur.server.span_lane.depth_hwm",
                                     float(hwm), {"sink": lane.sink.name}))
    return out


def _overload_samples(server: "Server", ms) -> list:
    """``veneur.overload.*``: the admission level and sheds by lane,
    quarantines by reason, spills by group, and the compute ladder's
    tallies and breaker state. The port has no rung 2, so
    ``compute_fallback_total`` is always 0."""
    ov = server.overload
    out = [ssf_samples.gauge("veneur.overload.level", float(ov.level()),
                             None)]
    for lane, shed in sorted(ov.shed.items()):
        out.append(ssf_samples.count(
            "veneur.overload.shed_total",
            float(_delta_since(ov, f"_last_shed_{lane}", shed)),
            {"lane": lane}))
    quarantine = server.store.quarantine
    for reason, total in sorted(quarantine.snapshot().items()):
        out.append(ssf_samples.count(
            "veneur.overload.quarantined_total",
            float(_delta_since(quarantine, f"_last_{reason}", total)),
            {"reason": reason}))
    for group, spilled in sorted(ms.spilled.items()):
        out.append(ssf_samples.count(
            "veneur.overload.samples_spilled_total", float(spilled),
            {"group": group}))
    compute = server.store.compute
    out.append(ssf_samples.count("veneur.overload.compute_fallback_total",
                                 0.0, None))
    out.append(ssf_samples.count(
        "veneur.overload.compute_requeued_total",
        float(_delta_since(compute, "_last_reported_requeues",
                           compute.requeued_total)), None))
    for kernel, gauge in compute.states():
        out.append(ssf_samples.gauge("veneur.breaker.state", gauge,
                                     {"destination": kernel}))
    return out


def _counts(obj, pairs) -> list:
    """``veneur.<metric>`` interval-delta counts of ``obj``'s cumulative
    counters: (metric, attribute) pairs, the last reported values kept
    on ``obj`` as ``_last_<attribute>``."""
    return [ssf_samples.count(
        metric, float(_delta_since(obj, f"_last_{attr}",
                                   getattr(obj, attr))), None)
        for metric, attr in pairs]


def _fleet_samples(server: "Server") -> list:
    """``veneur.fleet.*``: each shard's resident rows, summed over the
    mesh groups as the generation swap stamped them (the RETIRED
    interval's fill), and their balance ratio. Empty off the mesh."""
    occ = server.store.last_fleet_occupancy
    if server.store.mesh is None or not occ:
        return []
    from veneur_tpu_torch.fleet import balance_ratio

    out = [ssf_samples.gauge("veneur.fleet.shard_occupancy", float(rows),
                             {"shard": str(i)})
           for i, rows in enumerate(occ)]
    out.append(ssf_samples.gauge("veneur.fleet.balance_ratio",
                                 balance_ratio(occ), None))
    return out


def _handoff_samples(server: "Server") -> list:
    """``veneur.handoff.*``: the elastic resharding's transitions, moved,
    requeued and received series, guard hits, retries and spool errors
    as interval deltas, its epoch, the last transition's wall time and
    each destination's breaker. Empty without ``handoff_enabled``."""
    mgr = server.handoff_manager
    if mgr is None:
        return []
    out = _counts(mgr, (
        ("veneur.handoff.resizes_total", "resizes_total"),
        ("veneur.handoff.moved_series_total", "moved_series_total"),
        ("veneur.handoff.sent_total", "sent_total"),
        ("veneur.handoff.failed_total", "send_failures_total"),
        ("veneur.handoff.requeued_series_total", "requeued_series_total"),
        ("veneur.handoff.received_series_total", "received_series_total"),
        ("veneur.handoff.duplicate_total", "duplicates_total"),
        ("veneur.handoff.retries_total", "retries_total"),
        ("veneur.handoff.requeue_retries_total", "requeue_retries_total"),
        ("veneur.handoff.spool_errors_total", "spool_errors_total")))
    out.append(ssf_samples.gauge("veneur.handoff.epoch", float(mgr.epoch),
                                 None))
    if mgr.last_duration_ns:
        out.append(ssf_samples.timing("veneur.handoff.duration_ns",
                                      mgr.last_duration_ns / 1e9, None))
    out.extend(ssf_samples.gauge("veneur.breaker.state", gauge,
                                 {"destination": dest})
               for dest, gauge in mgr.breakers.states())
    return out


def _ha_samples(server: "Server") -> list:
    """``veneur.ha.*``: the active's replication tallies, the standby's
    guard hits and replication age, promotions, and the lease's
    leadership gauges and counts, counters as interval deltas, and each
    standby's breaker. Empty without a standby manager."""
    sby = server.standby_manager
    if sby is None:
        return []
    out = _counts(sby, (
        ("veneur.ha.replicated_total", "replicated_total"),
        ("veneur.ha.replicated_series_total", "replicated_series_total"),
        ("veneur.ha.replicate_failures_total", "replicate_failures_total"),
        ("veneur.ha.dropped_epochs_total", "dropped_epochs_total"),
        ("veneur.ha.received_series_total", "received_series_total"),
        ("veneur.ha.duplicate_total", "duplicates_total"),
        ("veneur.ha.stale_total", "stale_total"),
        ("veneur.ha.fenced_total", "fenced_total"),
        ("veneur.ha.promotions_total", "promotions_total"),
        ("veneur.ha.promoted_series_total", "promoted_series_total"),
        ("veneur.ha.retries_total", "retries_total")))
    out.append(ssf_samples.gauge("veneur.ha.is_leader",
                                 1.0 if sby.is_leader else 0.0, None))
    out.append(ssf_samples.gauge("veneur.ha.lease_epoch",
                                 float(sby.lease_epoch), None))
    age = sby.replication_age_seconds()
    if age >= 0:
        out.append(ssf_samples.gauge("veneur.ha.replication_age_seconds",
                                     float(age), None))
    if server.lease_elector is not None:
        out.extend(_counts(server.lease_elector, (
            ("veneur.ha.lease_acquires_total", "acquires_total"),
            ("veneur.ha.lease_demotions_total", "demotions_total"),
            ("veneur.ha.lease_renew_failures_total",
             "renew_failures_total"))))
    out.extend(ssf_samples.gauge("veneur.breaker.state", gauge,
                                 {"destination": dest})
               for dest, gauge in sby.breakers.states())
    return out


def _checkpoint_samples(server: "Server") -> list:
    """``veneur.checkpoint.*``: the last write's duration and bytes, the
    checkpoint's age, and the restore, discard and write-error counts as
    interval deltas (a checkpointer that can never write shows before
    the next crash proves it). Empty without ``checkpoint_path``."""
    ckpt = server.checkpointer
    if ckpt is None:
        return []
    return [
        ssf_samples.timing("veneur.checkpoint.write_duration_ns",
                           ckpt.last_write_duration_s, None),
        ssf_samples.gauge("veneur.checkpoint.bytes",
                          float(ckpt.last_write_bytes), None),
        ssf_samples.gauge("veneur.checkpoint.age_seconds",
                          ckpt.age_seconds(), None),
        *_counts(ckpt, (
            ("veneur.checkpoint.restore_total", "restore_total"),
            ("veneur.checkpoint.discard_total", "discard_total"),
            ("veneur.checkpoint.write_errors_total", "write_errors")))]


def _forward_samples(server: "Server") -> list:
    """``veneur.forward.*``: the forwarder's forwarded, error and retry
    deltas, its breaker, and each POST's duration and body size since
    the last flush (the forward runs off the flush path)."""
    f = server.forwarder
    if f is None or not hasattr(f, "forwarded"):
        return []
    with f._lock:
        fwd, errs = f.forwarded, f.errors
        retries = getattr(f, "retries", 0)
        durs = list(f.post_durations)
        lens = list(f.post_content_lengths)
        f.post_durations.clear()
        f.post_content_lengths.clear()
    out = [
        ssf_samples.count(
            "veneur.forward.post_metrics_total",
            float(_delta_since(f, "_last_reported_forwarded", fwd)), None),
        ssf_samples.count(
            "veneur.forward.error_total",
            float(_delta_since(f, "_last_reported_errors", errs)), None),
        ssf_samples.count(
            "veneur.forward.retries_total",
            float(_delta_since(f, "_last_reported_retries", retries)),
            None),
    ]
    breaker = getattr(f, "breaker", None)
    if breaker is not None:
        out.append(ssf_samples.gauge(
            "veneur.breaker.state", breaker.state_gauge(),
            {"destination": breaker.name or "forward"}))
    out.extend(ssf_samples.timing("veneur.forward.duration_ns", d,
                                  {"part": "post"}) for d in durs)
    out.extend(ssf_samples.histogram("veneur.forward.content_length_bytes",
                                     float(n), None) for n in lens)
    return out


def _import_samples(server: "Server") -> list:
    """``veneur.import.request_error_total`` by protocol, over the import
    servers this (global) instance runs."""
    out = []
    for srv, proto in ((server.import_server, "grpc"),
                       (server.native_import_server, "native")):
        if srv is None:
            continue
        out.append(ssf_samples.count(
            "veneur.import.request_error_total",
            float(_delta_since(srv, "_last_reported_import_errors",
                               srv.import_errors)), {"protocol": proto}))
    return out


def _sink_samples(server: "Server", sink_elapsed: dict) -> list:
    """Each metric sink's flush telemetry: ``veneur.flush.duration_ns``
    (with marshal and post parts where the sink records them), error
    and retry deltas, the streamed chunks' requeue and drop tallies, its
    breaker, and POST body sizes. A sink's batch marshal and POST
    seconds amend its ``post.<sink>`` stage for the overlap lanes."""
    rec = obs.current()
    out = []
    for sink in server.metric_sinks:
        name = sink.name
        if name in sink_elapsed:
            out.append(ssf_samples.timing("veneur.flush.duration_ns",
                                          sink_elapsed[name],
                                          {"sink": name}))
        for attr, last, metric in (
                ("flush_errors", "_last_reported_flush_errors",
                 "veneur.flush.error_total"),
                ("retries", "_last_reported_retries",
                 f"veneur.sink.{name}.retries_total"),
                ("chunks_requeued_total", "_last_reported_chunk_requeues",
                 f"veneur.sink.{name}.chunks_requeued_total"),
                ("chunk_rows_dropped", "_last_reported_chunk_drops",
                 f"veneur.sink.{name}.chunk_rows_dropped_total")):
            if hasattr(sink, attr):
                tags = {"sink": name} if attr == "flush_errors" else None
                out.append(ssf_samples.count(
                    metric,
                    float(_delta_since(sink, last, getattr(sink, attr))),
                    tags))
        if hasattr(sink, "chunk_requeue_bytes"):
            out.append(ssf_samples.gauge(
                f"veneur.sink.{name}.chunk_requeue_bytes",
                float(sink.chunk_requeue_bytes()), None))
        breaker = getattr(sink, "breaker", None)
        if breaker is not None:
            out.append(ssf_samples.gauge(
                "veneur.breaker.state", breaker.state_gauge(),
                {"destination": breaker.name or name, "sink": name}))
        if not hasattr(sink, "drain_flush_telemetry"):
            continue
        for kind, value in sink.drain_flush_telemetry():
            if kind in ("marshal_s", "chunk_marshal_s"):
                part = "marshal"
            elif kind in ("post_s", "chunk_post_s"):
                part = "post"
            else:  # content_length_bytes
                out.append(ssf_samples.histogram(
                    "veneur.flush.content_length_bytes", float(value),
                    {"sink": name}))
                if rec is not None:
                    rec.amend(f"post.{name}", bytes=int(value))
                continue
            out.append(ssf_samples.timing("veneur.flush.duration_ns",
                                          value,
                                          {"sink": name, "part": part}))
            if rec is not None and not kind.startswith("chunk_"):
                # a streamed chunk's own post.<sink>.serialize/.post
                # stages carry its lanes; amending would bill them twice
                lane = "serialize_ns" if part == "marshal" else "post_ns"
                rec.amend(f"post.{name}", **{lane: int(value * 1e9)})
    return out


def _trace_client_samples(server: "Server") -> list:
    """``veneur.trace_client.*``: the trace client's own backpressure
    counters, drained and reset an interval (client.go:446-452), so drops
    on the self-telemetry path are visible too."""
    stats: dict = {}
    send_client_statistics(server.trace_client, stats.__setitem__)
    return [ssf_samples.count(f"veneur.{name}", value, None)
            for name, value in stats.items()]


def _runtime_samples() -> list:
    """The Go runtime gauges' Python counterparts (``veneur.gc.number``,
    ``veneur.mem.heap_alloc_bytes``: the peak RSS; README.md:267-269)."""
    import gc
    import resource

    return [
        ssf_samples.gauge("veneur.gc.number",
                          float(sum(s["collections"]
                                    for s in gc.get_stats())), None),
        ssf_samples.gauge(
            "veneur.mem.heap_alloc_bytes",
            float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                  * 1024), None),
    ]
