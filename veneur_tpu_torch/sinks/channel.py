"""Queue-backed sinks for test assertions (cf. channelMetricSink,
veneur/server_test.go:170-200)."""

from __future__ import annotations

import queue
from typing import List

from .base import MetricSink, SpanSink


class ChannelMetricSink(MetricSink):
    """Delivers each flush batch to a queue the test can drain, and each
    flush's events (``flush_other_samples``) to a second queue."""

    def __init__(self, maxsize: int = 0):
        self.queue: "queue.Queue[List]" = queue.Queue(maxsize)
        self.other_queue: "queue.Queue[List]" = queue.Queue(maxsize)

    @property
    def name(self) -> str:
        return "channel"

    def flush(self, metrics) -> None:
        self.queue.put(list(metrics))

    def flush_other_samples(self, samples) -> None:
        self.other_queue.put(list(samples))

    def get_flush(self, timeout: float = 30.0):
        return self.queue.get(timeout=timeout)

    def get_other_samples(self, timeout: float = 30.0):
        return self.other_queue.get(timeout=timeout)


class ChannelSpanSink(SpanSink):
    """Delivers each ingested span to a queue; counts its flushes."""

    def __init__(self, maxsize: int = 0):
        self.queue: "queue.Queue" = queue.Queue(maxsize)
        self.flushes = 0

    @property
    def name(self) -> str:
        return "channel"

    def ingest(self, span) -> None:
        self.queue.put(span)

    def flush(self) -> None:
        self.flushes += 1
