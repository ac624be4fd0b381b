"""Interval-timeline observability of the port: per-stage self-tracing
of the flush, kernel profiler scopes, and the self-telemetry plumbing.

Port of ``veneur_tpu/obs/`` (the single-server plane):

- :mod:`~veneur_tpu_torch.obs.recorder`: ``StageRecorder``, the
  begin/end tracer the flusher threads through the hot path
  (monotonic-ns stamps, deque appends, merged at interval end).
- :mod:`~veneur_tpu_torch.obs.timeline`: the bounded per-interval ring
  behind ``GET /debug/flush-timeline``.
- :mod:`~veneur_tpu_torch.obs.kernels`: ``torch.profiler`` and NVTX
  ranges over every device dispatch, dispatch and launch counters, and
  the on-demand ``/debug/xprof`` capture.

The fleet trace plane (``TraceContext``, ``HopLog``, the fleet
aggregator) is not ported.
"""

from __future__ import annotations

from veneur_tpu_torch.obs.recorder import (StageRecorder, activate, current,
                                           maybe_stage, note)
from veneur_tpu_torch.obs.timeline import FlushTimeline

__all__ = ["StageRecorder", "FlushTimeline", "activate", "current",
           "maybe_stage", "note"]
