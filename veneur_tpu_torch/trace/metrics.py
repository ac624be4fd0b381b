"""One-off metric reporting through a trace client.

Port of ``veneur_tpu/trace/metrics.py``
(the reference's ``trace/metrics/client.go:21-58``): a batch of SSF
samples rides in a metrics-only span.
"""

from __future__ import annotations

from typing import List, Optional

from veneur_tpu_torch.protocol.ssf import SSFSample, SSFSpan
from veneur_tpu_torch.trace.client import Client, record
from veneur_tpu_torch.trace.samples import Samples


class NoMetricsError(Exception):
    """No metrics were included in the batch (metrics/client.go:12-16)."""


def report(cl: Optional[Client], samples: Samples) -> None:
    report_batch(cl, samples.batch)


def report_batch(cl: Optional[Client], samples: List[SSFSample]) -> None:
    if not samples:
        raise NoMetricsError("No metrics to send.")
    record(cl, SSFSpan(metrics=samples))


def report_one(cl: Optional[Client], metric: SSFSample) -> None:
    report_batch(cl, [metric])
