"""Egress: metric sinks (cf. veneur/sinks/sinks.go). Each metric
sink receives the full ``[]InterMetric`` batch once per flush."""

from .base import MetricSink, filter_acceptable
from .blackhole import BlackholeMetricSink
from .channel import ChannelMetricSink
from .debug import DebugMetricSink

__all__ = [
    "MetricSink",
    "filter_acceptable",
    "BlackholeMetricSink",
    "ChannelMetricSink",
    "DebugMetricSink",
]
