"""One interval's flush: drain the store and hand the rows to every sink.

Port of ``veneur_tpu/flusher.py``'s ``flush_once`` for the non-columnar,
non-forwarding path (flusher.go:26-132): the store drains into
InterMetrics, then each metric sink gets the batch it accepts, one sink
after another. Forwarding, span sinks and self-telemetry are not ported
yet.
"""

from __future__ import annotations

import logging
import time
from typing import TYPE_CHECKING

from veneur_tpu_torch.sinks.base import filter_acceptable

if TYPE_CHECKING:
    from veneur_tpu_torch.server import Server

log = logging.getLogger("veneur.flusher")


def flush_once(server: "Server") -> int:
    """Flush one interval; returns the number of metrics emitted. A sink
    that raises is logged and the remaining sinks still flush; a store
    (kernel) failure propagates."""
    now = int(time.time())
    t0 = time.perf_counter()
    final = server.store.flush(server.histogram_percentiles,
                               server.histogram_aggregates, now)
    log.debug("store flush of %d metrics took %.1f ms", len(final),
              (time.perf_counter() - t0) * 1e3)
    if final:
        for sink in server.metric_sinks:
            try:
                sink.flush(filter_acceptable(final, sink.name))
            except Exception:
                log.exception("sink %s flush failed", sink.name)
    server.last_flush_time = time.time()
    server.last_flush_ok = True
    return len(final)
