"""LedgerAudit: a conservation identity checked over live counters.

The JAX package pairs it with a static drop-flow pass, which proves every
lexical discard edge credits a ledger counter. What a static pass cannot
see (dynamic dispatch, a credit of the wrong amount, a native-path drop
below the AST), this recorder catches with live traffic.

An audit is a two-sided sum over registered **terms**::

    audit = LedgerAudit("ingest")
    audit.register("parsed",      "in",  lambda: fleet_totals()["parsed"])
    audit.register("merged",      "out", lambda: fleet_totals()["merged"])
    audit.register("quarantined", "out", ...)
    ...
    audit.snapshot(settled=False)   # record the timeline, don't assert
    audit.snapshot(settled=True)    # boundary: sum(in) must == sum(out)
    audit.assert_clean()

Each snapshot records every term's value and its delta since the
previous snapshot; a **settled** snapshot (an interval boundary where
the pipeline is drained) additionally checks the conservation identity
``sum(in) == sum(out)`` cumulatively and, on mismatch, records a
:class:`LedgerViolation` naming the per-term deltas, so the diverging
counter is visible by inspection. Un-settled snapshots exist because the
strict identity is false mid-chaos (requeued state in flight, a sink
outage holding emissions back); the exact invariant is
cumulative-at-settled-points, which is also what the soak gates assert.

Wired into :func:`veneur_tpu_torch.soak.orchestrator.run_soak`
(per-interval timeline snapshots, settled at terminal settlement).
:func:`for_fleet` and :func:`for_soak_ledger` build the two standard
term sets.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional


@dataclass
class LedgerViolation:
    """One failed conservation check at a settled snapshot."""

    audit: str
    snapshot_idx: int
    label: str
    total_in: int
    total_out: int
    values: Dict[str, int]
    deltas: Dict[str, int]

    def __str__(self):
        terms = ", ".join(
            f"{name}={self.values[name]:+d} (Δ{self.deltas.get(name, 0):+d})"
            for name in sorted(self.values))
        return (f"ledger audit '{self.audit}' snapshot #{self.snapshot_idx}"
                f"{f' [{self.label}]' if self.label else ''}: "
                f"sum(in)={self.total_in} != sum(out)={self.total_out} "
                f"(unaccounted {self.total_in - self.total_out:+d}); "
                f"terms: {terms}")


@dataclass
class LedgerSnapshot:
    idx: int
    label: str
    settled: bool
    values: Dict[str, int]
    deltas: Dict[str, int]
    ok: Optional[bool]  # None on un-settled snapshots


@dataclass
class _Term:
    name: str
    side: str  # "in" | "out"
    fn: Callable[[], int]


class LedgerAudit:
    """Conservation recorder over a set of (side, counter-fn) terms."""

    def __init__(self, name: str = "ledger"):
        self.name = name
        self._terms: List[_Term] = []
        self._lock = threading.Lock()
        self.snapshots: List[LedgerSnapshot] = []
        self.violations: List[LedgerViolation] = []

    def register(self, name: str, side: str,
                 fn: Callable[[], int]) -> "LedgerAudit":
        if side not in ("in", "out"):
            raise ValueError(f"side must be 'in' or 'out', got {side!r}")
        with self._lock:
            if any(t.name == name for t in self._terms):
                raise ValueError(f"duplicate audit term {name!r}")
            self._terms.append(_Term(name, side, fn))
        return self

    # -- snapshots ---------------------------------------------------------

    def snapshot(self, label: str = "",
                 settled: bool = True) -> LedgerSnapshot:
        """Read every term once. ``settled=True`` asserts the cumulative
        identity ``sum(in) == sum(out)`` and records a violation on
        mismatch; ``settled=False`` only extends the timeline (the
        identity is legitimately false mid-interval)."""
        with self._lock:
            values = {t.name: int(t.fn()) for t in self._terms}
            prev = self.snapshots[-1].values if self.snapshots else {}
            deltas = {n: v - prev.get(n, 0) for n, v in values.items()}
            total_in = sum(values[t.name] for t in self._terms
                           if t.side == "in")
            total_out = sum(values[t.name] for t in self._terms
                            if t.side == "out")
            ok: Optional[bool] = None
            if settled:
                ok = total_in == total_out
                if not ok:
                    self.violations.append(LedgerViolation(
                        audit=self.name, snapshot_idx=len(self.snapshots),
                        label=label, total_in=total_in, total_out=total_out,
                        values=values, deltas=deltas))
            snap = LedgerSnapshot(idx=len(self.snapshots), label=label,
                                  settled=settled, values=values,
                                  deltas=deltas, ok=ok)
            self.snapshots.append(snap)
            return snap

    def assert_clean(self):
        if self.violations:
            raise AssertionError(
                f"{len(self.violations)} ledger conservation violation(s):"
                + "".join(f"\n  {v}" for v in self.violations))

    def timeline(self) -> List[dict]:
        """JSON-shaped snapshot history (soak reports, bench lanes)."""
        return [{"idx": s.idx, "label": s.label, "settled": s.settled,
                 "ok": s.ok, "values": dict(s.values),
                 "deltas": dict(s.deltas)} for s in self.snapshots]


# -- standard term sets ----------------------------------------------------

def for_fleet(fleet, name: str = "ingest-fleet") -> LedgerAudit:
    """The ingest-lane conservation identity of the port's
    :class:`~veneur_tpu_torch.ingest.lanes.IngestFleet`, fleet-aggregated
    (``IngestFleet.balance()``'s invariant as an audit): everything the
    lanes parsed is merged, quarantined, shed, or still pending at the
    group boundary. Settled snapshots belong after ``merge_sealed``
    with traffic paused."""
    audit = LedgerAudit(name)

    def total(key: str) -> Callable[[], int]:
        return lambda: int(fleet.totals().get(key, 0))

    def pending() -> int:
        n = 0
        for lane in fleet.lanes:
            n += sum(c.records for c in list(lane.sealed))
            n += lane._staged_total
        return n

    audit.register("parsed", "in", total("parsed"))
    audit.register("merged", "out", total("merged"))
    audit.register("quarantined", "out", total("quarantined"))
    audit.register("shed", "out", total("shed_records"))
    audit.register("pending", "out", pending)
    return audit


def for_soak_ledger(ledger, name: str = "soak-global") -> LedgerAudit:
    """The soak plane's global conservation identity
    (``soak/gates.py`` ``conservation_global``) as a live audit:
    ``sent == emitted + shed + quarantined + accounted_lost``. Settled
    only after terminal settlement (the per-interval timeline rides
    along un-asserted)."""
    audit = LedgerAudit(name)
    audit.register("sent_global", "in", lambda: ledger.sent_global)
    audit.register("emitted_global", "out", lambda: ledger.emitted_global)
    audit.register("shed", "out", lambda: ledger.shed)
    audit.register("quarantined", "out", lambda: ledger.quarantined)
    audit.register("accounted_lost", "out",
                   lambda: ledger.accounted_lost)
    return audit
