"""No-op sinks, used as the defaults (cf. veneur/sinks/blackhole)."""

from __future__ import annotations

from .base import MetricSink, SpanSink


class BlackholeMetricSink(MetricSink):
    @property
    def name(self) -> str:
        return "blackhole"

    def flush(self, metrics) -> None:
        pass

    def flush_other_samples(self, samples) -> None:
        pass


class BlackholeSpanSink(SpanSink):
    @property
    def name(self) -> str:
        return "blackhole"

    def ingest(self, span) -> None:
        pass
