"""Logging sinks (cf. veneur/sinks/debug/debug.go): print every
flushed metric and ingested span for debugging."""

from __future__ import annotations

import logging

from .base import MetricSink, SpanSink

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


class DebugSpanSink(SpanSink):
    @property
    def name(self) -> str:
        return "debug"

    def ingest(self, span) -> None:
        log.info("Ingested span %r", span)
