"""StageRecorder: lock-cheap per-interval stage tracing.

Port of ``veneur_tpu/obs/recorder.py`` (host Python, copied).

One recorder lives for exactly one flush interval. Every instrumented
region records ``(path, t0_ns, t1_ns, attrs)`` with monotonic-ns
stamps; the write side is a ``collections.deque`` append (GIL-atomic,
no lock — the same single-writer-then-merge shape as the ingest
lanes), and the merge into a stage tree happens once, at interval end
(:meth:`StageRecorder.finish`).

Stage nesting is carried by the recording thread's own open-stage
stack (``threading.local``): ``stage("fetch")`` entered while
``stage("histograms")`` is open under ``stage("store")`` records as
``store.histograms.fetch``. Threads that aren't part of the flusher's
call tree (sink POST threads, the off-path forward) record absolute
paths with :meth:`StageRecorder.record_abs`.

The flusher parks the interval's recorder in a thread-local slot
(:func:`activate`) so deep call sites — the store's generation swap,
each digest group's compute/fetch, the breaker ladder's rung choice —
can attach stages and notes without threading a parameter through
every signature. When observability is off (``obs_enabled: false``)
the slot is empty and every hook costs one thread-local read.
"""

from __future__ import annotations

import collections
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

_NS = 1_000_000_000

_tls = threading.local()


def current() -> Optional["StageRecorder"]:
    """The interval recorder active on this thread tree, or None."""
    return getattr(_tls, "recorder", None)


@contextmanager
def activate(rec: Optional["StageRecorder"]):
    """Park ``rec`` as the current recorder for this thread (the
    flusher wraps the whole interval in this). None deactivates."""
    prev = getattr(_tls, "recorder", None)
    _tls.recorder = rec
    try:
        yield rec
    finally:
        _tls.recorder = prev


@contextmanager
def maybe_stage(name: str, **attrs):
    """``rec.stage(name)`` against the current recorder, or a no-op
    when observability is off — the one-line hook for deep call
    sites."""
    rec = current()
    if rec is None:
        yield None
        return
    with rec.stage(name, **attrs) as frame:
        yield frame


def note(**attrs) -> None:
    """Attach attrs to the innermost open stage of the current
    recorder (e.g. which breaker rung a flush ran); no-op without
    one."""
    rec = current()
    if rec is not None:
        rec.note(**attrs)


class _Frame:
    __slots__ = ("name", "path", "attrs")

    def __init__(self, name: str, path: str, attrs: dict):
        self.name = name
        self.path = path
        self.attrs = attrs


class StageRecorder:
    """Begin/end stage tracer for ONE flush interval."""

    def __init__(self, clock_ns=time.monotonic_ns):
        self._clock = clock_ns
        # (path, t0_ns, t1_ns, attrs) — append is GIL-atomic
        self._events: "collections.deque" = collections.deque()
        self._amends: "collections.deque" = collections.deque()
        self._stacks = threading.local()
        self.t0_ns = clock_ns()
        self.wall_start = time.time()
        self.entry: Optional[dict] = None  # set by finish()
        # the trace identity this interval's stage tree publishes
        # under (adopt_trace); zero = none
        self.trace_id = 0
        self.span_id = 0
        self.parent_span_id = 0
        self.hop = ""

    def adopt_trace(self, trace_id: int, span_id: int = 0,
                    parent_id: int = 0, hop: str = "") -> None:
        """Join this recorder's stage tree into a distributed trace: the
        published entry gains ``trace_id``/``span_id``/
        ``parent_span_id``/``hop``, which ``GET /debug/trace`` stitches
        on. The flusher adopts its flush span's ids; the proxy's fan-out
        adopts the ids off the ``X-Veneur-Trace`` header; a span id of 0
        draws a fresh one."""
        from veneur_tpu_torch.obs import tracectx

        self.trace_id = int(trace_id)
        self.span_id = int(span_id) or tracectx.new_span_id()
        self.parent_span_id = int(parent_id)
        self.hop = hop

    # -- recording ---------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._stacks, "stack", None)
        if st is None:
            st = self._stacks.stack = []
        return st

    @contextmanager
    def stage(self, name: str, **attrs):
        """Record one nested stage around the with-body."""
        stack = self._stack()
        path = stack[-1].path + "." + name if stack else name
        frame = _Frame(name, path, attrs)
        stack.append(frame)
        t0 = self._clock()
        try:
            yield frame
        finally:
            t1 = self._clock()
            stack.pop()
            self._events.append((path, t0, t1, frame.attrs))

    def note(self, **attrs) -> None:
        stack = self._stack()
        if stack:
            stack[-1].attrs.update(attrs)

    def record_abs(self, path: str, t0_ns: int, t1_ns: int,
                   **attrs) -> None:
        """Record a stage at an absolute dotted path — for threads
        outside the flusher's stage stack (per-sink POSTs)."""
        self._events.append((path, t0_ns, t1_ns, attrs))

    def amend(self, path: str, **attrs) -> None:
        """Merge attrs into an already-recorded stage at finish time
        (sink telemetry drains after the POST threads joined)."""
        self._amends.append((path, attrs))

    def record_late(self, path: str, t0_ns: int, t1_ns: int,
                    **attrs) -> None:
        """Record a stage AFTER the interval published (the off-path
        forward): the entry already in the ring gains the stage in
        place, so ``/debug/flush-timeline`` shows it once it lands."""
        entry = self.entry
        if entry is None:
            # finish() has not run yet (a fast forward): land in the
            # normal event stream, keeping the off-path marker so
            # coverage accounting excludes it either way
            attrs = dict(attrs, off_path=True)
            self._events.append((path, t0_ns, t1_ns, attrs))
            return
        stage = dict(attrs)
        stage["name"] = path
        stage["start_ns"] = max(0, t0_ns - self.t0_ns)
        stage["duration_ns"] = max(0, t1_ns - t0_ns)
        stage["off_path"] = True
        entry["stages"].append(stage)
        entry["tree"].append(dict(stage, children=[]))

    # -- merge -------------------------------------------------------------

    def finish(self, total_ns: Optional[int] = None) -> dict:
        """Merge the recorded events into the interval record: a flat
        ``stages`` list plus a nested ``tree``, both ordered by start.
        ``coverage_ratio`` is the fraction of ``total_duration_ns``
        accounted for by top-level stages (off-path stages like the
        forward are excluded from both sides)."""
        end_ns = self._clock()
        if total_ns is None:
            total_ns = end_ns - self.t0_ns
        amends: Dict[str, dict] = {}
        # drain both deques destructively: a late sink/forward thread
        # may still be appending while this merge runs (deque ops are
        # GIL-atomic; iterating a mutating deque raises) — anything
        # appended after this drain is swept up by the straggler pass
        # below once ``self.entry`` is published
        events = _drain(self._events)
        for path, attrs in _drain(self._amends):
            amends.setdefault(path, {}).update(attrs)
        stages: List[dict] = []
        for path, t0, t1, attrs in events:
            stage = dict(attrs)
            stage["name"] = path
            stage["start_ns"] = max(0, t0 - self.t0_ns)
            stage["duration_ns"] = max(0, t1 - t0)
            extra = amends.pop(path, None)
            if extra:
                stage.update(extra)
            stages.append(stage)
        stages.sort(key=lambda s: (s["start_ns"], s["name"]))
        top_ns = sum(s["duration_ns"] for s in stages
                     if "." not in s["name"] and not s.get("off_path"))
        entry = {
            "wall_start": self.wall_start,
            "wall_end": self.wall_start + (end_ns - self.t0_ns) / _NS,
            "total_duration_ns": int(total_ns),
            "coverage_ratio": round(top_ns / total_ns, 4)
            if total_ns else 0.0,
            "stages": stages,
            "tree": _build_tree(stages),
        }
        if self.trace_id:
            entry["trace_id"] = self.trace_id
            entry["span_id"] = self.span_id
            entry["parent_span_id"] = self.parent_span_id
            entry["hop"] = self.hop
        self.entry = entry
        # straggler pass: events recorded between the drain above and
        # the entry publication (record_late saw entry None and fell
        # back to the stream) land in the published entry after all —
        # nothing recorded is ever silently lost
        for path, t0, t1, attrs in _drain(self._events):
            self.record_late(path, t0, t1, **attrs)
        return entry


def _drain(dq: "collections.deque") -> list:
    out = []
    while True:
        try:
            out.append(dq.popleft())
        except IndexError:
            return out


def _build_tree(stages: List[dict]) -> List[dict]:
    """Nest the flat dotted-path stage list: ``store.histograms.fetch``
    hangs under ``store.histograms`` under ``store``. A child whose
    parent path was never recorded attaches at the root (keeps the
    tree total — nothing is dropped)."""
    roots: List[dict] = []
    by_path: Dict[str, dict] = {}
    for stage in stages:
        node = dict(stage, children=[])
        path = stage["name"]
        # the LAST recorded node wins the path slot for parenting;
        # repeated stages (several sinks, retried groups) all stay in
        # the tree, later ones just can't adopt children
        by_path[path] = node
        parent = None
        if "." in path:
            parent = by_path.get(path.rsplit(".", 1)[0])
        if parent is not None:
            parent["children"].append(node)
        else:
            roots.append(node)
    return roots
