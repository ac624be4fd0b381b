"""No-op sink, used as the default (cf. veneur/sinks/blackhole)."""

from __future__ import annotations

from .base import MetricSink


class BlackholeMetricSink(MetricSink):
    @property
    def name(self) -> str:
        return "blackhole"

    def flush(self, metrics) -> None:
        pass

    def flush_other_samples(self, samples) -> None:
        pass
