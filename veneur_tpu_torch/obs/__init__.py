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
- :mod:`~veneur_tpu_torch.obs.tracectx`: the fleet trace plane's
  cross-hop contract: ``TraceContext`` and the ``X-Veneur-Trace``
  header stamped into every forward, proxy, import, handoff and
  replication body, and the receiving side's ``HopLog``.
- :mod:`~veneur_tpu_torch.obs.fleet`: the fleet aggregation view:
  ``GET /debug/fleet`` (peer timelines, keep-last-good) and ``GET
  /debug/trace?id=...`` (the stitched per-trace hop view).
"""

from __future__ import annotations

from veneur_tpu_torch.obs.recorder import (StageRecorder, activate, current,
                                           maybe_stage, note)
from veneur_tpu_torch.obs.timeline import FlushTimeline
from veneur_tpu_torch.obs.tracectx import HopLog, TraceContext

__all__ = ["StageRecorder", "FlushTimeline", "HopLog", "TraceContext",
           "activate", "current", "maybe_stage", "note"]
