"""Flushed-metric types: InterMetric, aggregate selection, sink routing.

Mirrors the flush-side types of ``veneur/samplers/samplers.go``:
``InterMetric`` (samplers.go:48-61), the histogram-aggregate bitmask
(samplers.go:63-98) and the ``veneursinkonly:`` routing tag
(samplers.go:110-127).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import FrozenSet, List, Optional


class MetricType(enum.Enum):
    COUNTER = "counter"
    GAUGE = "gauge"
    STATUS = "status"


class Aggregate(enum.IntFlag):
    """Bitmask of histogram aggregates (samplers.go:63-77)."""

    MIN = 1 << 0
    MAX = 1 << 1
    MEDIAN = 1 << 2
    AVERAGE = 1 << 3
    COUNT = 1 << 4
    SUM = 1 << 5
    HARMONIC_MEAN = 1 << 6


AGGREGATES_LOOKUP = {
    "min": Aggregate.MIN,
    "max": Aggregate.MAX,
    "median": Aggregate.MEDIAN,
    "avg": Aggregate.AVERAGE,
    "count": Aggregate.COUNT,
    "sum": Aggregate.SUM,
    "hmean": Aggregate.HARMONIC_MEAN,
}

AGGREGATE_SUFFIX = {
    Aggregate.MIN: "min",
    Aggregate.MAX: "max",
    Aggregate.MEDIAN: "median",
    Aggregate.AVERAGE: "avg",
    Aggregate.COUNT: "count",
    Aggregate.SUM: "sum",
    Aggregate.HARMONIC_MEAN: "hmean",
}


@dataclass(frozen=True)
class HistogramAggregates:
    """The selected aggregates plus their count (samplers.go:85-88)."""

    value: Aggregate = (Aggregate.MIN | Aggregate.MAX | Aggregate.COUNT)

    @property
    def count(self) -> int:
        return bin(int(self.value)).count("1")

    @classmethod
    def from_names(cls, names: List[str]) -> "HistogramAggregates":
        agg = Aggregate(0)
        for name in names:
            flag = AGGREGATES_LOOKUP.get(name)
            if flag is not None:
                agg |= flag
        return cls(value=agg)


SINK_PREFIX = "veneursinkonly:"


def route_info(tags: List[str]) -> Optional[FrozenSet[str]]:
    """Extract the set of sink names a metric is restricted to, or None when
    it goes to every sink (samplers.go:110-127)."""
    info = None
    for tag in tags:
        if tag.startswith(SINK_PREFIX):
            if info is None:
                info = set()
            info.add(tag[len(SINK_PREFIX):])
    return frozenset(info) if info is not None else None


@dataclass
class InterMetric:
    """A completed metric ready for sink flushing (samplers.go:48-61)."""

    name: str
    timestamp: int
    value: float
    tags: List[str] = field(default_factory=list)
    type: MetricType = MetricType.GAUGE
    message: str = ""
    hostname: str = ""
    sinks: Optional[FrozenSet[str]] = None  # None = all sinks

    def is_acceptable_to(self, sink_name: str) -> bool:
        """Routing check (sinks/sinks.go:50-56)."""
        return self.sinks is None or sink_name in self.sinks
