"""The soak gate library: machine-checked steady-state invariants.

Every gate is a pure function of the run's :class:`SoakLedger` (exact
end-to-end counts, folded across process kills) and the
:class:`~veneur_tpu_torch.soak.monitor.SteadyStateMonitor` samples. A
violated gate names itself, its measured value, its threshold, AND the
scenario's reproduction call — a failed soak is a seed, not a shrug
(``docs/resilience.md`` "Soak & chaos" gate table):

==================  ====================================================
gate                invariant
==================  ====================================================
conservation_global sent global-only counter value == value emitted by
                    the global's accounting sink + shed + quarantined
                    + accounted_lost (exact, across every kill/restart
                    via checkpoint epochs; ``accounted_lost`` is only
                    ever non-zero in a kill_forever scenario — the
                    active's un-flushed tail, measured at the kill)
conservation_local  same for local-only counters at the local instance
dd_rows_conserved   every Datadog emission row is acked, parked
                    (pending), dropped counted, or crash-lost counted —
                    folded across sink generations
rss_slope           post-warmup RSS slope ≤ threshold %/100 intervals
compile_drift       zero jit-compile growth per process generation
                    across the post-chaos steady state
coverage            median timeline coverage_ratio ≥ threshold
e2e_age_p99         p99 of veneur.fleet.e2e_age_ns ≤ threshold
recovery            final samples: overload level 0, breaker closed,
                    requeue drained, nothing pending, no degradations
requeue_bounded     max parked sink bytes ≤ the configured budget
device_buffers_bounded settled growth of live tensor storage on the
                    fleet's device in the orchestrator's process ≤
                    the configured byte bound
                    (``lint/buffer_census.py``; vacuously green when
                    the orchestrator owns no tensors of the fleet)
takeover            kill_forever only: the standby promoted, held the
                    lease within ``takeover_detect_max_s`` of the
                    active's SIGKILL, and the accounted loss is
                    bounded by the un-replicated tail (≤ 1 flush
                    interval's sent value)
==================  ====================================================
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from veneur_tpu_torch.soak.monitor import SteadyStateMonitor
from veneur_tpu_torch.soak.scenario import KIND_KILL_FOREVER, SoakScenario


@dataclass
class SoakLedger:
    """Exact end-to-end counts, folded across restarts. The orchestrator
    accumulates the monotone per-generation counters (sink rows,
    shed/quarantine tallies, checkpoint/spool errors) into this ledger
    at every kill and once at the end, so a counter reset by a process
    death can never hide loss."""

    sent_global: int = 0       # counter VALUE sent tagged veneurglobalonly
    emitted_global: int = 0    # counter VALUE the global's channel sink saw
    sent_local: int = 0        # counter VALUE sent local-only
    emitted_local: int = 0     # counter VALUE the local's channel sink saw
    shed: int = 0              # overload sheds, folded across generations
    quarantined: int = 0       # quarantine ledger, folded
    dd_offered: int = 0        # rows offered to the Datadog chunk path
    dd_acked: int = 0          # rows 2xx-acked, folded
    dd_dropped: int = 0        # rows dropped counted (budget eviction)
    dd_crash_lost: int = 0     # rows parked at a kill — died with the sink
    dd_pending: int = 0        # rows still parked at the end
    ckpt_write_errors: int = 0  # injected/real ENOSPC commits survived
    spool_errors: int = 0       # handoff spool writes the disk refused
    ckpt_retries: int = 0       # kill-time checkpoint attempts past one
    restarts: Dict[str, int] = field(default_factory=dict)
    # kill_forever (HA takeover) accounting — all stay zero/-1 in a
    # kill_restart run. accounted_lost is the active's un-flushed tail
    # at the SIGKILL, measured exactly from the settled ledger;
    # takeover_loss_bound is the ≤-1-interval bound it must respect.
    accounted_lost: int = 0
    takeover_loss_bound: int = 0
    promotions: int = 0              # standby promotions observed
    takeover_detect_s: float = -1.0  # SIGKILL → standby holds the lease
    takeover_first_flush_s: float = -1.0  # SIGKILL → first good flush
    # orchestrator-process BufferCensus fold (lint/buffer_census.py): max
    # settled live tensor storage growth over the baseline, and the
    # census's own verdict/detail (suspect programs on a violation)
    device_buffer_growth_bytes: int = 0
    buffer_census_ok: bool = True
    buffer_census_detail: str = ""

    def restart_total(self) -> int:
        return sum(self.restarts.values())


@dataclass
class GateResult:
    name: str
    ok: bool
    value: object
    threshold: object
    detail: str = ""


class SoakGateError(AssertionError):
    """A steady-state gate failed. The message names every violated
    gate and the scenario's exact reproduction call."""


def run_gates(scenario: SoakScenario, monitor: SteadyStateMonitor,
              ledger: SoakLedger) -> List[GateResult]:
    thr = scenario.thresholds
    out: List[GateResult] = []

    # accounted_lost folds EXPLICITLY: a kill_forever run loses the
    # active's un-flushed tail by design, and conservation stays exact
    # only because that loss is measured and named, never shrugged
    want = (ledger.emitted_global + ledger.shed + ledger.quarantined
            + ledger.accounted_lost)
    out.append(GateResult(
        "conservation_global", ledger.sent_global == want,
        ledger.sent_global, want,
        f"sent={ledger.sent_global} emitted={ledger.emitted_global} "
        f"shed={ledger.shed} quarantined={ledger.quarantined} "
        f"accounted_lost={ledger.accounted_lost} "
        f"restarts={ledger.restart_total()}"))

    out.append(GateResult(
        "conservation_local", ledger.sent_local == ledger.emitted_local,
        ledger.sent_local, ledger.emitted_local,
        f"sent={ledger.sent_local} emitted={ledger.emitted_local}"))

    dd_accounted = (ledger.dd_acked + ledger.dd_pending
                    + ledger.dd_dropped + ledger.dd_crash_lost)
    out.append(GateResult(
        "dd_rows_conserved", ledger.dd_offered == dd_accounted,
        ledger.dd_offered, dd_accounted,
        f"offered={ledger.dd_offered} acked={ledger.dd_acked} "
        f"pending={ledger.dd_pending} dropped={ledger.dd_dropped} "
        f"crash_lost={ledger.dd_crash_lost}"))

    slope = monitor.rss_slope_pct_per_100()
    out.append(GateResult(
        "rss_slope", slope <= thr.rss_slope_pct_per_100,
        round(slope, 4), thr.rss_slope_pct_per_100,
        f"{len(monitor.post_warmup())} post-warmup samples"))

    # the zero bound reads the post-chaos steady state: kills and sink
    # windows first-exercise novel kernel shapes (a re-merged forward
    # part, a restarted generation's import path) and those one-off
    # compiles are legitimate; per-interval recompilation would keep
    # growing the counter into the steady tail and still fail here
    chaos_end = max(
        [at + 1 for at, _role in scenario.kills]
        + [w.end for w in scenario.sink_windows] + [0])
    drift = monitor.compile_drift(after_idx=chaos_end)
    out.append(GateResult(
        "compile_drift", drift <= thr.max_compile_drift,
        drift, thr.max_compile_drift,
        f"jit compiles past each generation's first steady-state "
        f"sample (idx >= {chaos_end})"))

    cov = monitor.coverage_median()
    out.append(GateResult(
        "coverage", cov is not None and cov >= thr.coverage_min,
        cov, thr.coverage_min, "median post-warmup coverage_ratio"))

    p99 = monitor.e2e_age_p99_s()
    out.append(GateResult(
        "e2e_age_p99", p99 is not None and p99 <= thr.e2e_age_p99_max_s,
        None if p99 is None else round(p99, 3), thr.e2e_age_p99_max_s,
        "p99 ingest→emission freshness, seconds"))

    tail = monitor.tail(thr.recovery_intervals)
    bad = [f"i{s.idx}:" + ",".join(
        (["overload"] if s.overload_level else [])
        + (["breaker"] if s.breaker_gauge else [])
        + (["requeue"] if s.requeue_bytes or s.rows_pending else [])
        + ([f"degraded({';'.join(s.degradations)})"]
           if s.degradations else []))
        for s in tail
        if (s.overload_level or s.breaker_gauge or s.requeue_bytes
            or s.rows_pending or s.degradations)]
    out.append(GateResult(
        "recovery", len(tail) >= min(thr.recovery_intervals,
                                     len(monitor.samples)) and not bad,
        "; ".join(bad) or "recovered", "clean final "
        f"{thr.recovery_intervals} intervals",
        "overload/breaker/requeue/degradation state in the tail"))

    mx = monitor.max_requeue_bytes()
    out.append(GateResult(
        "requeue_bounded", mx <= thr.requeue_max_bytes,
        mx, thr.requeue_max_bytes, "max parked sink bytes ever sampled"))

    out.append(GateResult(
        "device_buffers_bounded",
        (ledger.buffer_census_ok
         and ledger.device_buffer_growth_bytes
         <= thr.device_buffer_growth_max_bytes),
        ledger.device_buffer_growth_bytes,
        thr.device_buffer_growth_max_bytes,
        ledger.buffer_census_detail
        or "settled live tensor storage growth in the orchestrator's process "
           "(vacuously green when the orchestrator owns no tensors)"))

    if scenario.kind == KIND_KILL_FOREVER:
        promoted = ledger.promotions >= 1
        detected = (0.0 <= ledger.takeover_detect_s
                    <= thr.takeover_detect_max_s)
        bounded = ledger.accounted_lost <= ledger.takeover_loss_bound
        out.append(GateResult(
            "takeover", promoted and detected and bounded,
            {"detect_s": round(ledger.takeover_detect_s, 3),
             "first_flush_s": round(ledger.takeover_first_flush_s, 3),
             "accounted_lost": ledger.accounted_lost,
             "promotions": ledger.promotions},
            {"detect_max_s": thr.takeover_detect_max_s,
             "loss_bound": ledger.takeover_loss_bound},
            "standby promoted, lease held within the detect bound, "
            "loss ≤ the un-replicated tail (1 flush interval)"))
    return out


def gate_vector(results: List[GateResult]) -> dict:
    """The machine-checked gate vector (a soak report's verdict)."""
    return {
        "all_ok": all(r.ok for r in results),
        "gates": {r.name: {"ok": r.ok, "value": r.value,
                           "threshold": r.threshold, "detail": r.detail}
                  for r in results}}


def enforce(results: List[GateResult], scenario: SoakScenario) -> None:
    """Raise :class:`SoakGateError` naming every violated gate and the
    scenario seed; silent on a clean vector."""
    bad = [r for r in results if not r.ok]
    if not bad:
        return
    lines = [f"  gate '{r.name}' violated: value={r.value!r} "
             f"threshold={r.threshold!r} ({r.detail})" for r in bad]
    raise SoakGateError(
        "soak steady-state gates failed:\n" + "\n".join(lines)
        + f"\nreproduce with {scenario.repro()}")
