"""BufferCensus: live tensor storage held to a settled zero-growth bound.

The JAX package pairs its census (over ``jax.live_arrays()``) with a
static donation-safety pass. What a static pass cannot see (a retained
reference threaded through a container at run time, a retired plane a
bug keeps alive), this recorder catches with live tensors.

A census samples the aggregate of live torch tensor storage on its
device (total bytes and buffer count, every storage counted once by its
data pointer, however many tensors view it) per flush interval,
attributes each interval's delta to the programs dispatched in it, and
asserts a **settled zero-growth identity** at teardown: once the
pipeline has drained and Python's collector has run, live bytes must be
back within ``tolerance_bytes`` of the armed baseline. This is the leak
class the soak's ``rss_slope`` gate cannot isolate: host RSS noise
(arena reuse, interned strings, test bookkeeping) swamps a slow
per-interval plane leak, while the census counts nothing but tensors a
Python object still reaches.

On a CUDA device each sample also reads ``torch.cuda.memory_allocated``
(the caching allocator's live bytes: tensors no Python object reaches,
such as one a C++ thread holds, count there and not in the scan), so a
report can set the two side by side.

Armed in :func:`veneur_tpu_torch.soak.orchestrator.run_soak` as the
``device_buffers_bounded`` gate. With a ``ProcessFleet`` the orchestrator owns
no tensors of the fleet, so the census reads its own process and the
gate passes vacuously; the in-process soak carries the real coverage.
"""

from __future__ import annotations

import gc
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

from veneur_tpu_torch.device import resolve_device


def _on(t: torch.Tensor, device: torch.device) -> bool:
    return (t.device.type == device.type
            and (device.index is None or t.device.index == device.index))


def live_storage(device) -> Tuple[int, int]:
    """(total bytes, storage count) of every live tensor's storage on
    ``device``, each storage once, found through the collector's view of
    live objects. Synchronizes a CUDA device first."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.is_initialized():
        torch.cuda.synchronize(device)
    seen = {}
    tensor = torch.Tensor
    for obj in gc.get_objects():
        # type(), not isinstance(): a deprecated module proxy among the
        # live objects warns on any attribute read
        if not issubclass(type(obj), tensor):
            continue
        try:
            if not _on(obj, device) or obj.is_sparse or obj.is_meta:
                continue
            st = obj.untyped_storage()
            ptr = st.data_ptr()
            if ptr:
                seen[ptr] = max(seen.get(ptr, 0), st.nbytes())
        except Exception:  # pragma: no cover - a tensor without storage
            continue
    return sum(seen.values()), len(seen)


def allocated_bytes(device) -> Optional[int]:
    """``torch.cuda.memory_allocated`` of a CUDA device already in use,
    else None (a CPU device, or a process that never touched the card)."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_initialized():
        return None
    return int(torch.cuda.memory_allocated(device))


@dataclass
class CensusSample:
    idx: int
    label: str
    bytes_live: int
    count_live: int
    delta_bytes: int
    delta_count: int
    programs: Tuple[str, ...]  # dispatches this delta attributes to
    settled: bool
    ok: Optional[bool]         # None on un-settled samples
    allocated: Optional[int] = None  # memory_allocated on a CUDA device


@dataclass
class CensusViolation:
    """Settled growth above tolerance: a plane leak."""

    census: str
    label: str
    baseline_bytes: int
    settled_bytes: int
    growth_bytes: int
    tolerance_bytes: int
    suspects: List[str] = field(default_factory=list)

    def __str__(self):
        who = (f"; suspect programs (largest attributed growth first): "
               f"{', '.join(self.suspects)}" if self.suspects else "")
        return (f"buffer census '{self.census}' [{self.label}]: live "
                f"tensor bytes grew {self.growth_bytes:+d} past the "
                f"armed baseline ({self.baseline_bytes} -> "
                f"{self.settled_bytes}, tolerance "
                f"{self.tolerance_bytes}) after settling — a retired "
                f"plane is being retained{who}")


class BufferCensus:
    """Live-tensor-storage recorder with a settled zero-growth gate."""

    def __init__(self, name: str = "device-buffers",
                 tolerance_bytes: int = 1 << 20, device=None):
        self.name = name
        self.tolerance_bytes = int(tolerance_bytes)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._baseline: Optional[Tuple[int, int]] = None
        self.samples: List[CensusSample] = []
        self.violations: List[CensusViolation] = []

    # -- lifecycle ---------------------------------------------------------

    def arm(self, label: str = "baseline") -> CensusSample:
        """Record the steady-state baseline every later settled sample
        is measured against. Call once traffic-independent allocation
        (store construction, the first flush's planes) is done."""
        with self._lock:
            b, c = live_storage(self.device)
            self._baseline = (b, c)
            snap = CensusSample(
                idx=len(self.samples), label=label, bytes_live=b,
                count_live=c, delta_bytes=0, delta_count=0,
                programs=(), settled=False, ok=None,
                allocated=allocated_bytes(self.device))
            self.samples.append(snap)
            return snap

    @property
    def armed(self) -> bool:
        return self._baseline is not None

    def sample(self, label: str = "",
               programs: Tuple[str, ...] = (),
               settled: bool = False) -> CensusSample:
        """Read the live-storage aggregate once. ``programs`` names the
        dispatches since the previous sample, so a growing interval is
        attributable by inspection. ``settled=True`` additionally runs
        the collector and asserts the zero-growth identity against the
        armed baseline."""
        if settled:
            gc.collect()  # drop dead handles before judging growth
        with self._lock:
            b, c = live_storage(self.device)
            prev = self.samples[-1] if self.samples else None
            snap = CensusSample(
                idx=len(self.samples), label=label, bytes_live=b,
                count_live=c,
                delta_bytes=b - (prev.bytes_live if prev else 0),
                delta_count=c - (prev.count_live if prev else 0),
                programs=tuple(programs), settled=settled, ok=None,
                allocated=allocated_bytes(self.device))
            if settled and self._baseline is not None:
                growth = b - self._baseline[0]
                snap.ok = growth <= self.tolerance_bytes
                if not snap.ok:
                    self.violations.append(CensusViolation(
                        census=self.name, label=label,
                        baseline_bytes=self._baseline[0],
                        settled_bytes=b, growth_bytes=growth,
                        tolerance_bytes=self.tolerance_bytes,
                        suspects=self._suspects()))
            self.samples.append(snap)
            return snap

    def settle(self, label: str = "settled") -> CensusSample:
        return self.sample(label=label, settled=True)

    def _suspects(self) -> List[str]:
        """Programs ranked by total attributed growth, for the
        violation message (lock already held)."""
        growth: dict = {}
        for s in self.samples:
            if s.delta_bytes <= 0 or not s.programs:
                continue
            per = s.delta_bytes / len(s.programs)
            for p in s.programs:
                growth[p] = growth.get(p, 0.0) + per
        ranked = sorted(growth.items(), key=lambda kv: -kv[1])
        return [f"{p} (+{int(g)}B)" for p, g in ranked[:4]]

    # -- verdicts ----------------------------------------------------------

    def growth_bytes(self) -> int:
        """Settled growth vs the baseline: max over settled samples (0
        when un-armed or never settled — vacuously bounded)."""
        with self._lock:
            if self._baseline is None:
                return 0
            settled = [s.bytes_live - self._baseline[0]
                       for s in self.samples if s.settled]
            return max(settled) if settled else 0

    def settled_ok(self) -> bool:
        return not self.violations

    def assert_clean(self):
        if self.violations:
            raise AssertionError(
                f"{len(self.violations)} buffer census "
                f"violation(s):"
                + "".join(f"\n  {v}" for v in self.violations))

    def timeline(self) -> List[dict]:
        """JSON-shaped sample history (soak reports)."""
        return [{"idx": s.idx, "label": s.label,
                 "bytes_live": s.bytes_live, "count_live": s.count_live,
                 "delta_bytes": s.delta_bytes,
                 "delta_count": s.delta_count,
                 "programs": list(s.programs), "settled": s.settled,
                 "ok": s.ok, "allocated": s.allocated}
                for s in self.samples]
