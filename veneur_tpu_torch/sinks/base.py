"""Sink interfaces (cf. veneur/sinks/sinks.go:31-97)."""

from __future__ import annotations

import abc
from typing import Iterable, List

from veneur_tpu_torch.samplers.intermetric import InterMetric


class MetricSink(abc.ABC):
    """A backend receiving the full flushed-metric batch every interval."""

    @property
    @abc.abstractmethod
    def name(self) -> str: ...

    def start(self) -> None:
        """Called once at server start."""

    @abc.abstractmethod
    def flush(self, metrics: List[InterMetric]) -> None: ...

    def flush_other_samples(self, samples: Iterable) -> None:
        """Receive non-metric samples (events, ...); default: drop."""


def filter_acceptable(metrics: List[InterMetric],
                      sink_name: str) -> List[InterMetric]:
    """The metrics a sink accepts: veneursinkonly: routing
    (sinks.go:50-56)."""
    return [m for m in metrics if m.is_acceptable_to(sink_name)]
