"""Lock-free ingest counters (port of ``veneur_tpu/ingest/counters.py``).

Two shapes, one rule: the hot path writes a cell only its own thread
ever writes, and readers sum the cells. Under CPython's GIL a
single-writer integer ``+=`` cannot lose increments, so the packet-rate
paths pay an attribute add instead of a lock acquisition that would
serialize every reader on every bad packet.
"""

from __future__ import annotations

import threading
from typing import Dict

# past this many registered writer cells (thread churn: per-connection
# TCP readers, short-lived pumps) new threads share one locked overflow
# cell instead of growing the cell list forever
_MAX_CELLS = 256


class ShardedCounter:
    """A counter whose ``add`` is lock-free on the hot path: every
    writer thread owns a one-element list cell (single-writer ``+=`` is
    GIL-atomic); ``total()`` sums read-side. Registration of a NEW
    thread's cell takes a small lock once per thread; bounded thread
    churn falls back to a shared locked overflow cell."""

    __slots__ = ("_cells", "_local", "_register_lock", "_overflow")

    def __init__(self):
        self._cells = []
        self._local = threading.local()
        self._register_lock = threading.Lock()
        self._overflow = 0

    def add(self, n: int = 1) -> None:
        try:
            cell = self._local.cell
        except AttributeError:
            if len(self._cells) >= _MAX_CELLS:
                with self._register_lock:
                    self._overflow += n
                return
            cell = [0]
            with self._register_lock:
                self._cells.append(cell)
            self._local.cell = cell
        cell[0] += n

    def total(self) -> int:
        # list() snapshots against concurrent registration; cells are
        # never removed, so the sum is monotone and never undercounts a
        # completed add
        return sum(c[0] for c in list(self._cells)) + self._overflow


class LaneLedger:
    """Single-writer per-reason quarantine tally for one ingest lane.

    Duck-types ``overload.Quarantine.count`` so the store's
    ``_scrub_*_batch`` helpers can account poison into it WITHOUT the
    shared ledger's lock — the lane thread is the only writer; the
    merger folds deltas into the shared ``Quarantine`` at the group
    boundary (one locked add per chunk, not per sample)."""

    __slots__ = ("counts", "_reported")

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self._reported: Dict[str, int] = {}

    def count(self, reason: str, n: int = 1) -> None:
        self.counts[reason] = self.counts.get(reason, 0) + n

    def total(self) -> int:
        return sum(self.counts.values())

    def take_deltas(self) -> Dict[str, int]:
        """Per-reason counts since the last call (merger-side only)."""
        out = {}
        for reason, v in self.counts.items():
            d = v - self._reported.get(reason, 0)
            if d:
                out[reason] = d
                self._reported[reason] = v
        return out
