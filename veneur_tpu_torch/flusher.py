"""One interval's flush: events, span sinks, the store, forward, sinks.

Port of ``veneur_tpu/flusher.py``'s ``flush_once`` for the non-columnar
path (flusher.go:26-132): the interval's events go to every metric
sink's ``flush_other_samples`` (flusher.go:42-47); the span sinks flush
on a thread of their own (flusher.go:49), each sink once; the store
drains into InterMetrics and, on a local, the ForwardableState it
forwards; the forward runs on its own thread off the flush path
(flusher.go:66-75) while each metric sink gets the batch it accepts, one
sink after another. Streaming egress and self-telemetry are not ported
yet.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import TYPE_CHECKING

from veneur_tpu_torch.resilience import Deadline
from veneur_tpu_torch.sinks.base import filter_acceptable

if TYPE_CHECKING:
    from veneur_tpu_torch.server import Server

log = logging.getLogger("veneur.flusher")


def flush_once(server: "Server") -> int:
    """Flush one interval; returns the number of metrics emitted. A sink
    that raises is logged and the remaining sinks still flush; a store
    (kernel) failure propagates."""
    now = int(time.time())
    samples = server.event_worker.flush()
    for sink in server.metric_sinks:
        try:
            sink.flush_other_samples(samples)
        except Exception:
            log.exception("sink %s flush_other_samples failed", sink.name)
    _start_span_flush(server)
    is_local = server.is_local()
    forwarding = is_local and server.forward_fn is not None
    # the heavy-hitter sketch rides our JSON body, never the reference's
    # (forward_reference_compatible): then the local emits its own top-k
    topk_ok = getattr(server.forwarder, "supports_topk", True)
    t0 = time.perf_counter()
    final, forwardable = server.store.flush(
        server.histogram_percentiles, server.histogram_aggregates, now,
        is_local=is_local, forward=forwarding, forward_topk=topk_ok)
    log.debug("store flush of %d metrics took %.1f ms", len(final),
              (time.perf_counter() - t0) * 1e3)
    if forwarding and len(forwardable):
        # the forward shares the interval's budget: its retries end
        # before the next flush
        deadline = Deadline.after(min(server.interval,
                                      server.config.forward_timeout_seconds))
        thread = threading.Thread(
            target=_forward, args=(server, forwardable, deadline),
            name="forward", daemon=True)
        server.forward_thread = thread
        thread.start()
    if final:
        for sink in server.metric_sinks:
            try:
                sink.flush(filter_acceptable(final, sink.name))
            except Exception:
                log.exception("sink %s flush failed", sink.name)
    server.last_flush_time = time.time()
    server.last_flush_ok = True
    return len(final)


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
