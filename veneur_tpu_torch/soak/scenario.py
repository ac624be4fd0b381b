"""Deterministic soak scenarios: one seed fully determines the chaos.

A :class:`SoakScenario` is the complete, replayable description of a
soak run — how many driven flush intervals, which intervals SIGKILL
which fleet role, which intervals the sink egress is black-holed /
5xx-ing / slow, and which seeded fault kinds ride the servers'
:class:`~veneur_tpu_torch.resilience.faults.FaultInjector` (checkpoint/spool
disk-full, flush-deadline pressure, membership churn). Everything is
derived from ``random.Random(seed)`` in :meth:`SoakScenario.generate`,
so a failed soak reproduces exactly from the seed its gate violation
names (``docs/resilience.md`` "Soak & chaos").

The schedule layout keeps the invariant gates decidable:

* chaos (kills + sink outage windows) lands only in
  ``[warmup, intervals - recovery_tail)`` — the head gives the compile
  ladder and RSS a settling window, the tail gives every breaker /
  overload / requeue excursion room to recover before the recovery
  gate reads the final samples;
* kills cycle global → local → proxy, so three scheduled kills cover
  every fleet role;
* sink windows never extend into the recovery tail, so the one
  repost-per-interval drain always empties the requeue before the end.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Tuple

# sink egress modes a scenario window can impose on the global's
# Datadog POST path (orchestrator.ChaosPost)
MODE_OK = "ok"
MODE_BLACKHOLE = "blackhole"   # connect/refused twin: raises OSError
MODE_HTTP_5XX = "http_5xx"     # API-side failure: returns 503
MODE_SLOW = "slow"             # latency injection: sleeps, then 202
SINK_MODES = (MODE_BLACKHOLE, MODE_HTTP_5XX, MODE_SLOW)

# fleet roles a kill can target, in kill-cycle order (the single-kill
# smoke scenario kills the global: checkpoint restore + sink-generation
# folding is the most load-bearing path)
ROLE_GLOBAL = "global"
ROLE_LOCAL = "local"
ROLE_PROXY = "proxy"
KILL_CYCLE = (ROLE_GLOBAL, ROLE_LOCAL, ROLE_PROXY)
# the warm-standby global (fleet/standby.py): only present in
# kill_forever scenarios, promoted when the active dies
ROLE_STANDBY = "standby"

# scenario kinds: kill_restart is the classic soak (SIGKILL →
# same-port respawn → checkpoint restore); kill_forever is the HA
# acceptance (SIGKILL the active global with NO restart — the
# warm standby must take the lease, merge its replicated shadow, and
# serve, with loss bounded to the active's un-flushed tail)
KIND_KILL_RESTART = "kill_restart"
KIND_KILL_FOREVER = "kill_forever"

# seeded fault kinds the servers arm (resilience/faults.py SOAK_KINDS)
DEFAULT_FAULT_KINDS = "disk_full,deadline_pressure"


@dataclass(frozen=True)
class GateThresholds:
    """The steady-state invariant bounds ``soak.gates`` machine-checks.

    Defaults encode the acceptance bar from docs/resilience.md: exact
    conservation, RSS slope ≤ 1% of the mean per 100 intervals after
    warmup, zero compile-counter drift per process generation,
    timeline coverage ≥ 0.9, bounded end-to-end freshness, and full
    recovery (overload 0, breaker closed, requeue drained, no
    degradations) over the final ``recovery_intervals`` samples."""

    warmup_intervals: int = 2
    rss_slope_pct_per_100: float = 1.0
    coverage_min: float = 0.9
    e2e_age_p99_max_s: float = 60.0
    recovery_intervals: int = 3
    max_compile_drift: int = 0
    requeue_max_bytes: int = 32 * 1048576
    # kill_forever only: wall-clock bound on active-death →
    # standby-holds-the-lease (the lease ttl plus election slack)
    takeover_detect_max_s: float = 15.0
    # settled growth bound for the orchestrator-process BufferCensus
    # (lint/buffer_census.py): max bytes of net live tensor storage
    # growth between arming and the terminal settlement
    device_buffer_growth_max_bytes: int = 1 << 20


@dataclass(frozen=True)
class FaultWindow:
    """One sink-egress outage: ``mode`` holds for intervals
    ``[start, end)``."""

    mode: str
    start: int
    end: int

    def covers(self, idx: int) -> bool:
        return self.start <= idx < self.end


@dataclass(frozen=True)
class SoakScenario:
    """One fully-determined soak run. ``kills`` is a tuple of
    ``(interval_index, role)``; a kill executes BEFORE that interval's
    traffic (checkpoint-commit → SIGKILL → restart on the same ports
    and checkpoint path). ``repro()`` renders the exact call that
    regenerates this scenario — every gate violation carries it."""

    seed: int
    intervals: int
    kills: Tuple[Tuple[int, str], ...] = ()
    sink_windows: Tuple[FaultWindow, ...] = ()
    fault_rate: float = 0.05
    fault_kinds: str = DEFAULT_FAULT_KINDS
    counters_per_interval: int = 24
    timers_per_interval: int = 8
    thresholds: GateThresholds = field(default_factory=GateThresholds)
    kind: str = KIND_KILL_RESTART

    def sink_mode(self, idx: int) -> str:
        for w in self.sink_windows:
            if w.covers(idx):
                return w.mode
        return MODE_OK

    def kills_at(self, idx: int) -> Tuple[str, ...]:
        return tuple(role for at, role in self.kills if at == idx)

    def repro(self) -> str:
        kind = ("" if self.kind == KIND_KILL_RESTART
                else f", kind={self.kind!r}")
        return (f"SoakScenario.generate(seed={self.seed}, "
                f"intervals={self.intervals}, kills={len(self.kills)}"
                f"{kind})")

    @classmethod
    def generate(cls, seed: int, intervals: int = 8, kills: int = 1,
                 thresholds: GateThresholds = None,
                 fault_rate: float = 0.05,
                 fault_kinds: str = DEFAULT_FAULT_KINDS,
                 kind: str = KIND_KILL_RESTART) -> "SoakScenario":
        """Derive the full chaos schedule from ``seed``. Same
        arguments → identical scenario, byte for byte."""
        thr = thresholds or GateThresholds()
        rng = random.Random(seed)
        # chaos may not touch the warmup head or the recovery tail
        lo = thr.warmup_intervals
        hi = max(lo + 1, intervals - (thr.recovery_intervals + 1))
        span = range(lo, hi)
        if kind == KIND_KILL_FOREVER:
            # the HA takeover scenario: exactly ONE kill — the active
            # global, dead forever — and no sink-outage windows (the
            # outage transport is per-process; a window spanning the
            # takeover would impose chaos on a sink generation that no
            # longer exists — orthogonal coverage already owned by the
            # kill_restart scenarios)
            kill_at = rng.choice(list(span))
            return cls(seed=seed, intervals=intervals,
                       kills=((kill_at, ROLE_GLOBAL),), sink_windows=(),
                       fault_rate=fault_rate, fault_kinds=fault_kinds,
                       thresholds=thr, kind=kind)
        n_kills = min(kills, len(span))
        kill_at = sorted(rng.sample(span, n_kills)) if n_kills else []
        kill_plan = tuple((at, KILL_CYCLE[i % len(KILL_CYCLE)])
                         for i, at in enumerate(kill_at))
        # one window per sink mode, longest first, clipped to the
        # chaos span; windows may overlap kills (a global kill during
        # a black hole is exactly the crash-loss fold the dd-rows gate
        # accounts) but never each other
        windows = []
        taken = set()
        for mode, length in ((MODE_BLACKHOLE, 3), (MODE_HTTP_5XX, 2),
                             (MODE_SLOW, 1)):
            length = min(length, len(span))
            if length <= 0:
                continue
            starts = [s for s in range(lo, hi - length + 1)
                      if not any(t in taken for t in range(s, s + length))]
            if not starts:
                continue
            start = rng.choice(starts)
            taken.update(range(start, start + length))
            windows.append(FaultWindow(mode, start, start + length))
        return cls(seed=seed, intervals=intervals, kills=kill_plan,
                   sink_windows=tuple(sorted(windows,
                                             key=lambda w: w.start)),
                   fault_rate=fault_rate, fault_kinds=fault_kinds,
                   thresholds=thr)
