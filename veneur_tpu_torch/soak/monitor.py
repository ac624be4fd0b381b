"""Steady-state sampling for soak runs.

One :class:`IntervalSample` is captured per driven flush interval —
always on the GLOBAL role, after its flush — and the
:class:`SteadyStateMonitor` turns the series into the derived
statistics the gate library checks: the post-warmup RSS slope
(least-squares, as a percentage of the mean per 100 intervals),
per-process-generation compile-counter drift, the end-to-end freshness
p99, and the coverage/recovery views. RSS is the CURRENT resident set
from ``/proc/self/statm`` (``ru_maxrss`` is a high-water mark and can
never show a slope)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

_PAGE_KB = os.sysconf("SC_PAGE_SIZE") // 1024 if hasattr(os, "sysconf") \
    else 4


def read_rss_kb(pid: int = 0) -> int:
    """Current resident set in KiB for ``pid`` (0 = this process).
    Returns 0 where /proc is unavailable — the RSS gate then reports
    an unmeasurable slope of 0.0 rather than crashing the soak."""
    path = f"/proc/{pid}/statm" if pid else "/proc/self/statm"
    try:
        with open(path) as f:
            return int(f.read().split()[1]) * _PAGE_KB
    except (OSError, IndexError, ValueError):
        return 0


@dataclass
class IntervalSample:
    """One interval's steady-state reading of the global role."""

    idx: int
    generation: int           # restarts of the sampled process so far
    rss_kb: int = 0
    compiles: int = 0
    coverage_ratio: Optional[float] = None
    e2e_age_ns: Optional[int] = None
    overload_level: int = 0
    breaker_gauge: float = 0.0
    requeue_bytes: int = 0
    rows_pending: int = 0
    ckpt_write_errors: int = 0
    spool_errors: int = 0
    degradations: Tuple[str, ...] = ()


class SteadyStateMonitor:
    """Accumulates interval samples and derives the gate statistics."""

    def __init__(self, warmup_intervals: int = 2):
        self.warmup = max(0, warmup_intervals)
        self.samples: List[IntervalSample] = []

    def add(self, sample: IntervalSample) -> None:
        self.samples.append(sample)

    def post_warmup(self) -> List[IntervalSample]:
        return self.samples[self.warmup:]

    # -- derived statistics ------------------------------------------------

    def rss_slope_pct_per_100(self) -> float:
        """Least-squares RSS slope over the post-warmup samples,
        normalized to percent-of-mean per 100 intervals (the
        acceptance bound is ≤ 1%/100)."""
        pts = [(float(s.idx), float(s.rss_kb))
               for s in self.post_warmup() if s.rss_kb > 0]
        if len(pts) < 2:
            return 0.0
        n = len(pts)
        mx = sum(x for x, _ in pts) / n
        my = sum(y for _, y in pts) / n
        denom = sum((x - mx) ** 2 for x, _ in pts)
        if denom <= 0 or my <= 0:
            return 0.0
        slope = sum((x - mx) * (y - my) for x, y in pts) / denom
        return slope * 100.0 / my * 100.0

    def compile_drift(self, after_idx: int = 0) -> int:
        """Total growth of the jit compile counter past each process
        generation's first sample at or after ``after_idx`` (the
        generation's own warmup: a restarted process legitimately
        recompiles once, and chaos can first-exercise a novel kernel
        shape late — e.g. a re-merged forward part after a proxy
        kill). Any residual growth is per-interval recompilation — the
        drift the gate pins to zero; the gate passes the end of the
        scenario's chaos span as ``after_idx`` so the zero bound reads
        the steady state, where sustained recompilation still shows."""
        drift = 0
        by_gen = {}
        for s in self.post_warmup():
            if s.idx < after_idx:
                continue
            by_gen.setdefault(s.generation, []).append(s.compiles)
        for counts in by_gen.values():
            if len(counts) >= 2:
                drift += max(0, counts[-1] - counts[0])
        return drift

    def coverage_median(self) -> Optional[float]:
        vals = sorted(s.coverage_ratio for s in self.post_warmup()
                      if s.coverage_ratio is not None)
        if not vals:
            return None
        return vals[len(vals) // 2]

    def e2e_age_p99_s(self) -> Optional[float]:
        vals = sorted(s.e2e_age_ns for s in self.post_warmup()
                      if s.e2e_age_ns is not None)
        if not vals:
            return None
        return vals[min(len(vals) - 1, int(0.99 * (len(vals) - 1)))] / 1e9

    def max_requeue_bytes(self) -> int:
        return max((s.requeue_bytes for s in self.samples), default=0)

    def tail(self, n: int) -> List[IntervalSample]:
        return self.samples[-n:] if n > 0 else []
