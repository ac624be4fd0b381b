"""Logging sink (cf. veneur/sinks/debug/debug.go): print every
flushed metric for debugging."""

from __future__ import annotations

import logging

from .base import MetricSink

log = logging.getLogger("veneur.sinks.debug")


class DebugMetricSink(MetricSink):
    @property
    def name(self) -> str:
        return "debug"

    def flush(self, metrics) -> None:
        for m in metrics:
            log.info("Flushed metric name=%r time=%d value=%f tags=%r type=%s",
                     m.name, m.timestamp, m.value, m.tags, m.type.value)

    def flush_other_samples(self, samples) -> None:
        for s in samples:
            log.info("Flushed sample %r", s)
