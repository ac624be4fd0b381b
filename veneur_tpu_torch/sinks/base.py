"""Sink interfaces (cf. veneur/sinks/sinks.go:31-97): metric sinks take
each flush's rows, span sinks take SSF spans as they arrive."""

from __future__ import annotations

import abc
from typing import Iterable, List

from veneur_tpu_torch.samplers.intermetric import InterMetric


class MetricSink(abc.ABC):
    """A backend receiving the full flushed-metric batch every interval.

    A sink may also take a flush as columns (``flush_columnar(batch)``,
    a :class:`~veneur_tpu_torch.core.columnar.ColumnarFlush`) and, for
    streaming egress, each completed group as it exists
    (``flush_chunk(chunk)``, a :class:`~veneur_tpu_torch.core.pipeline.
    FlushChunk`); the flusher checks for those methods."""

    # the interval's egress budget, set by the flusher before the sink's
    # flush starts; retry loops clamp their backoff to it so no sink
    # pushes a flush past the interval boundary
    flush_deadline = None

    @property
    @abc.abstractmethod
    def name(self) -> str: ...

    def start(self) -> None:
        """Called once at server start."""

    def set_flush_deadline(self, deadline) -> None:
        self.flush_deadline = deadline

    @abc.abstractmethod
    def flush(self, metrics: List[InterMetric]) -> None: ...

    def flush_other_samples(self, samples: Iterable) -> None:
        """Receive non-metric samples (events, ...); default: drop."""


class SpanSink(abc.ABC):
    """A backend receiving SSF spans as they arrive (sinks.go:85-97)."""

    @property
    @abc.abstractmethod
    def name(self) -> str: ...

    def start(self) -> None:
        """Called once at server start."""

    @abc.abstractmethod
    def ingest(self, span) -> None: ...

    def flush(self) -> None:
        """Called once a flush interval, off the metric flush's thread."""


def filter_acceptable(metrics: List[InterMetric],
                      sink_name: str) -> List[InterMetric]:
    """The metrics a sink accepts: veneursinkonly: routing
    (sinks.go:50-56)."""
    return [m for m in metrics if m.is_acceptable_to(sink_name)]
