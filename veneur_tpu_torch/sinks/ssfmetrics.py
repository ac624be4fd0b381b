"""Metric-extraction span sink: how SSF samples reach the store.

Port of ``veneur_tpu/sinks/ssfmetrics.py`` (after
veneur/sinks/ssfmetrics/metrics.go:63-141): a span sink on the main path
(server.go:282-290) that unpacks each span's embedded SSFSamples into
UDPMetrics, derives an indicator span's duration timer when configured,
and feeds everything to the store. It runs on the span-worker lane's
thread, so a histogram sample's staging there may launch K2 (the shift
guard) on the store's device.
"""

from __future__ import annotations

import logging
from typing import Callable

from veneur_tpu_torch.samplers import parser as p

from .base import SpanSink

log = logging.getLogger("veneur.sinks.ssfmetrics")


class MetricExtractionSink(SpanSink):
    """process_metric: a callable taking a UDPMetric (the store's
    ingest). ``invalid_samples`` counts the samples that did not convert
    (bad type, poisoned value, no name or value)."""

    def __init__(self, process_metric: Callable[[p.UDPMetric], None],
                 indicator_span_timer_name: str = ""):
        self._process = process_metric
        self._timer_name = indicator_span_timer_name
        self.invalid_samples = 0  # written by the sink's one lane thread

    @property
    def name(self) -> str:
        return "metric_extraction"

    def ingest(self, span) -> None:
        if getattr(span, "metrics_extracted", False):
            # the native SSF lane converted the embedded samples (and any
            # indicator timer) on its C++ reader threads already
            return
        metrics, invalid = p.convert_metrics(span)
        if invalid:
            self.invalid_samples += len(invalid)
            log.error("parse errors on %d metrics", len(invalid))
        if span.indicator and self._timer_name:
            try:
                metrics.extend(
                    p.convert_indicator_metrics(span, self._timer_name))
            except p.ParseError as e:
                self.invalid_samples += 1
                log.error("couldn't extract indicator metrics: %s", e)
        for m in metrics:
            self._process(m)
