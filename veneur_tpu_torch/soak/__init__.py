"""The soak plane: a deterministic chaos soak with steady-state
invariant gates, on the port.

One seed fully determines the chaos schedule
(:class:`~veneur_tpu_torch.soak.scenario.SoakScenario`); the orchestrator
drives a real fleet (local → proxy → global, and a warm standby in the
takeover scenario) through it while the
:class:`~veneur_tpu_torch.soak.monitor.SteadyStateMonitor` samples every
interval, and :mod:`veneur_tpu_torch.soak.gates` machine-checks the
invariants at the end: exact conservation across kills, bounded RSS
slope, zero compile drift, timeline coverage, e2e freshness, full
recovery, bounded requeue memory, settled tensor storage and, in the
takeover scenario, the takeover."""

from veneur_tpu_torch.soak.gates import (GateResult, SoakGateError,
                                         SoakLedger, enforce, gate_vector,
                                         run_gates)
from veneur_tpu_torch.soak.monitor import IntervalSample, SteadyStateMonitor
from veneur_tpu_torch.soak.orchestrator import (ChaosPost, FleetSpec,
                                                InProcessFleet,
                                                ProcessFleet, SoakReport,
                                                run_soak)
from veneur_tpu_torch.soak.scenario import (KIND_KILL_FOREVER,
                                            KIND_KILL_RESTART, FaultWindow,
                                            GateThresholds, SoakScenario)

__all__ = [
    "ChaosPost", "FaultWindow", "FleetSpec", "GateResult",
    "GateThresholds", "InProcessFleet", "IntervalSample",
    "KIND_KILL_FOREVER", "KIND_KILL_RESTART", "ProcessFleet",
    "SoakGateError", "SoakLedger", "SoakReport", "SoakScenario",
    "SteadyStateMonitor", "enforce", "gate_vector", "run_gates",
    "run_soak",
]
