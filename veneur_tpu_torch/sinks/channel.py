"""Queue-backed sink for test assertions (cf. channelMetricSink,
veneur/server_test.go:170-200)."""

from __future__ import annotations

import queue
from typing import List

from .base import MetricSink


class ChannelMetricSink(MetricSink):
    """Delivers each flush batch to a queue the test can drain."""

    def __init__(self, maxsize: int = 0):
        self.queue: "queue.Queue[List]" = queue.Queue(maxsize)

    @property
    def name(self) -> str:
        return "channel"

    def flush(self, metrics) -> None:
        self.queue.put(list(metrics))

    def get_flush(self, timeout: float = 30.0):
        return self.queue.get(timeout=timeout)
