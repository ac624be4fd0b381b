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
hands that snapshot to its replicator. Self-telemetry is not ported
yet.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import TYPE_CHECKING

from veneur_tpu_torch.core.pipeline import ChunkStream
from veneur_tpu_torch.core.store import ForwardableState
from veneur_tpu_torch.native import egress
from veneur_tpu_torch.resilience import Deadline
from veneur_tpu_torch.samplers.parser import MetricKey
from veneur_tpu_torch.sinks.base import filter_acceptable

if TYPE_CHECKING:
    from veneur_tpu_torch.server import Server

log = logging.getLogger("veneur.flusher")


def flush_once(server: "Server") -> int:
    """Flush one interval; returns the number of rows emitted. A sink or
    plugin that raises is logged and the others still flush; a store
    (kernel) failure or an egress library that cannot load propagates."""
    now = int(time.time())
    samples = server.event_worker.flush()
    for sink in server.metric_sinks:
        try:
            sink.flush_other_samples(samples)
        except Exception:
            log.exception("sink %s flush_other_samples failed", sink.name)
    _start_span_flush(server)
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
        egress.load()  # the first call builds the library; raises if not
    # device-packed digest planes whenever the forwarder takes them (the
    # native lane): only live centroids cross to the host, 4 bytes each
    digest_format = "packed" if (
        forwarding and getattr(server.forwarder, "wants_packed_digests",
                               False)) else "dense"
    stream, stream_sinks = _build_stream(server, now, deadline,
                                         use_columnar, forwarding)
    ha_snapshot = _ha_capture(server)
    try:
        t0 = time.perf_counter()
        final, forwardable = server.store.flush(
            server.histogram_percentiles, server.histogram_aggregates, now,
            is_local=is_local, forward=forwarding, forward_topk=topk_ok,
            columnar=use_columnar, digest_format=digest_format,
            stream=stream)
        log.debug("store flush of %d rows took %.1f ms", len(final),
                  (time.perf_counter() - t0) * 1e3)
        # the store just drained: a checkpoint holds state that is now
        # flushing, so a restart must never merge (and flush) it again.
        # Non-blocking: a write in flight holds the IO lock through its
        # fsync, and the writer's own epoch check then removes its file
        if server.checkpointer is not None:
            server.checkpointer.truncate(blocking=False)
        if ha_snapshot is not None:
            # the flush landed: the captured (now retired) epoch streams
            # to the standbys off the flush path
            server.standby_manager.capture(*ha_snapshot)
        if forwarding and len(forwardable):
            # the batch forward's budget starts with it, as before
            # streaming: a slow store flush must not leave it no time
            # (this state has no requeue)
            thread = threading.Thread(
                target=_forward,
                args=(server, forwardable,
                      Deadline.after(_egress_budget(server))),
                name="forward", daemon=True)
            server.forward_thread = thread
            thread.start()
    finally:
        # the interval barrier: every streamed chunk and forward part is
        # acked or requeued before the sink fan-out
        if stream is not None:
            stream.close()
    if final:
        _fan_out(server, final, stream_sinks, deadline)
    server.last_flush_time = time.time()
    server.last_flush_ok = True
    return len(final)


def _ha_capture(server: "Server"):
    """Warm-standby replication: the (groups, flush_epoch) the flush is
    about to drain, taken without resetting anything BEFORE the
    generation swap, or None. Replicating only what a flush emitted is
    what makes the promoted standby's counter exclusion exact."""
    sby = getattr(server, "standby_manager", None)
    if sby is None or not sby.wants_capture():
        return None
    try:
        return server.store.snapshot_state()
    except Exception:
        log.exception("HA replication capture failed; this epoch will "
                      "not replicate")
        return None


def _egress_budget(server: "Server") -> float:
    return min(server.interval, server.config.forward_timeout_seconds)


def _fan_out(server: "Server", final, stream_sinks,
             deadline: Deadline) -> None:
    """One thread per metric sink (flusher.go:82-93), then the plugins
    (flusher.go:95-109). A streaming sink already has the blocks and
    gets only the extras; a columnar sink gets the whole flush as
    columns; any other sink gets InterMetrics. Without
    ``flush_columnar`` the flush holds no blocks, so a columnar sink
    takes every row through its per-row path."""
    threads = []
    for sink in server.metric_sinks:
        if hasattr(sink, "set_flush_deadline"):
            sink.set_flush_deadline(deadline)
        if sink in stream_sinks:
            target, arg = _flush_sink, list(final.extras)
        elif hasattr(sink, "flush_columnar"):
            target, arg = _flush_sink_columnar, final
        else:
            target, arg = _flush_sink, final.to_intermetrics()
        t = threading.Thread(target=target, args=(sink, arg),
                             name=f"flush-{sink.name}", daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=30.0)
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
                  use_columnar: bool, forwarding: bool):
    """The interval's :class:`ChunkStream` when streaming egress is on
    (``flush_streaming`` with a columnar, pipelined flush): every sink
    with ``flush_chunk`` POSTs each completed group the moment it
    exists, and when the forwarder takes parts, each forwarded digest
    group ships upstream the same way, a part that fails terminally
    re-merged into the live store. Returns (the stream or None, the
    streaming sinks)."""
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
            return server.forward_fn(mini, deadline=deadline)

        def fwd_requeue(attr, part):
            _requeue_forward_part(server.store, attr, part)
    if not sinks and fwd_fn is None:
        return None, []
    return ChunkStream(sinks, now, depth=server.store.flush_pipeline_depth,
                       forward_fn=fwd_fn, forward_requeue=fwd_requeue), sinks


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


def _start_span_flush(server: "Server") -> None:
    """Flush the span sinks on a thread of their own. A wedged lane can
    hold its barrier for 9 s, so with a short interval the previous span
    flush may still run: then this interval's is skipped and counted in
    ``server.span_flush_skipped``, never stacked onto the same sinks."""
    if not server._span_workers:
        return  # not started: no span lanes
    previous = server.span_flush_thread
    if previous is not None and previous.is_alive():
        server._count("span_flush_skipped")
        log.warning("previous span flush still running; skipping this "
                    "interval's span flush")
        return
    # the lanes are shared between workers: flush each sink once
    thread = threading.Thread(target=server._span_workers[0].flush,
                              name="span-flush", daemon=True)
    server.span_flush_thread = thread
    thread.start()


def _forward(server: "Server", state, deadline: Deadline):
    """The forward thread: one POST of the interval's state (with the
    forwarder's own retries inside the deadline). Its outcome lands in
    ``server.last_forward_ok``; a failed forward is logged and counted
    and the thread ends: the state is not requeued."""
    try:
        ok = bool(server.forward_fn(state, deadline=deadline))
    except Exception:
        log.exception("forward failed")
        ok = False
    if not ok:
        server._count("forward_errors")
    server.last_forward_ok = ok
