"""Egress: metric sinks and span sinks (cf. veneur/sinks/sinks.go). Each
metric sink receives the full ``[]InterMetric`` batch once per flush;
each span sink receives SSF spans as they arrive. The metric-extraction
span sink (``ssfmetrics.py``) is how SSF samples reach the store."""

from .base import MetricSink, SpanSink, filter_acceptable
from .blackhole import BlackholeMetricSink, BlackholeSpanSink
from .channel import ChannelMetricSink, ChannelSpanSink
from .debug import DebugMetricSink, DebugSpanSink
from .ssfmetrics import MetricExtractionSink

__all__ = [
    "MetricSink",
    "SpanSink",
    "filter_acceptable",
    "BlackholeMetricSink",
    "BlackholeSpanSink",
    "ChannelMetricSink",
    "ChannelSpanSink",
    "DebugMetricSink",
    "DebugSpanSink",
    "MetricExtractionSink",
]
