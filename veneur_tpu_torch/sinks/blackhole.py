"""No-op sinks, used as the defaults (cf. veneur/sinks/blackhole)."""

from __future__ import annotations

from .base import MetricSink, SpanSink


class BlackholeMetricSink(MetricSink):
    def __init__(self):
        self.chunk_rows_acked = 0
        self.chunks_flushed = 0

    @property
    def name(self) -> str:
        return "blackhole"

    def flush(self, metrics) -> None:
        pass

    def flush_columnar(self, batch) -> None:
        pass

    def flush_chunk(self, chunk) -> None:
        """Streaming egress no-op: every chunk row acks at once (the
        counters keep conservation checks honest)."""
        self.chunks_flushed += 1
        self.chunk_rows_acked += chunk.rows

    def flush_other_samples(self, samples) -> None:
        pass


class BlackholeSpanSink(SpanSink):
    @property
    def name(self) -> str:
        return "blackhole"

    def ingest(self, span) -> None:
        pass
