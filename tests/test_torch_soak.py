"""The port's soak plane (``veneur_tpu_torch/soak/``) against the JAX
package's (``veneur_tpu/soak/``).

* ``SoakScenario.generate`` gives the JAX package's scenario, field for
  field, over a range of seeds, lengths and kill counts and both kinds,
  and ``interval_traffic`` the same datagrams, byte for byte, for every
  interval of the smoke and slow scenarios.
* The monitor's statistics and the gate vector equal the JAX package's
  on the same ``IntervalSample``s and ``SoakLedger`` (floats exactly:
  both run the same Python arithmetic), but the text of the
  ``device_buffers_bounded`` gate's default detail, which names what the
  census reads (live tensor storage here, ``jax.live_arrays()`` there).
* A checkpoint refused by the disk degrades a port Server and names
  itself on ``/healthcheck/ready`` at HTTP 200, as in the JAX package.
* The in-process kill_restart and kill_forever soaks run on the CPU with
  the JAX tests' seeds, thresholds and assertions (the full gate vector,
  exact conservation, the settled ledger audit and buffer census, 60 s
  and 90 s bounds).
* One ``_Child`` of each role boots with ``device: cpu`` and answers the
  line protocol; the three ``ProcessFleet`` soaks are marked ``slow``,
  as the JAX package's are.
"""

import dataclasses
import threading
import time
import urllib.request

import numpy as np
import pytest

from veneur_tpu import soak as jsoak
from veneur_tpu.soak import gates as jgates
from veneur_tpu.soak import monitor as jmonitor
from veneur_tpu.soak import orchestrator as jorch
from veneur_tpu.soak import scenario as jscenario
from veneur_tpu_torch import soak as tsoak
from veneur_tpu_torch.soak import gates as tgates
from veneur_tpu_torch.soak import monitor as tmonitor
from veneur_tpu_torch.soak import orchestrator as torch_orch
from veneur_tpu_torch.soak import scenario as tscenario

# (seed, intervals, kills, kind) of the smoke and slow scenarios
SMOKES = [(7, 10, 1, "kill_restart"), (21, 8, 1, "kill_forever"),
          (13, 40, 3, "kill_restart"), (17, 12, 0, "kill_restart"),
          (22, 8, 1, "kill_forever")]


def _fields(sc) -> tuple:
    return (sc.seed, sc.intervals, sc.kills,
            tuple((w.mode, w.start, w.end) for w in sc.sink_windows),
            sc.fault_rate, sc.fault_kinds, sc.counters_per_interval,
            sc.timers_per_interval, dataclasses.astuple(sc.thresholds),
            sc.kind, sc.repro())


def _thresholds(pkg, **kw):
    return pkg.GateThresholds(**kw) if kw else None


# -- scenario and traffic ---------------------------------------------------


@pytest.mark.parametrize("kind", ["kill_restart", "kill_forever"])
def test_scenarios_equal_the_jax_package(kind):
    for seed in range(60):
        for intervals, kills in ((8, 1), (10, 1), (12, 2), (30, 3),
                                 (40, 3), (5, 0), (3, 1)):
            thr = {} if seed % 3 else {"warmup_intervals": 3,
                                        "recovery_intervals": 4}
            a = jscenario.SoakScenario.generate(
                seed=seed, intervals=intervals, kills=kills,
                thresholds=_thresholds(jscenario, **thr), kind=kind)
            b = tscenario.SoakScenario.generate(
                seed=seed, intervals=intervals, kills=kills,
                thresholds=_thresholds(tscenario, **thr), kind=kind)
            assert _fields(a) == _fields(b), (seed, intervals, kills)
            for idx in range(intervals):
                assert a.sink_mode(idx) == b.sink_mode(idx)
                assert a.kills_at(idx) == b.kills_at(idx)


def test_interval_traffic_is_byte_equal():
    for seed, intervals, kills, kind in SMOKES:
        a = jscenario.SoakScenario.generate(seed=seed, intervals=intervals,
                                            kills=kills, kind=kind)
        b = tscenario.SoakScenario.generate(seed=seed, intervals=intervals,
                                            kills=kills, kind=kind)
        for idx in range(intervals):
            assert (jorch.interval_traffic(a, idx)
                    == torch_orch.interval_traffic(b, idx)), (seed, idx)


def test_defaults_and_constants_equal():
    assert dataclasses.astuple(jscenario.GateThresholds()) == \
        dataclasses.astuple(tscenario.GateThresholds())
    for name in ("MODE_OK", "MODE_BLACKHOLE", "MODE_HTTP_5XX", "MODE_SLOW",
                 "SINK_MODES", "KILL_CYCLE", "ROLE_STANDBY",
                 "KIND_KILL_RESTART", "KIND_KILL_FOREVER",
                 "DEFAULT_FAULT_KINDS"):
        assert getattr(jscenario, name) == getattr(tscenario, name), name
    assert (jorch.GLOBAL_PREFIX, jorch.LOCAL_PREFIX) == \
        (torch_orch.GLOBAL_PREFIX, torch_orch.LOCAL_PREFIX)
    assert dataclasses.astuple(jgates.SoakLedger()) == \
        dataclasses.astuple(tgates.SoakLedger())


def test_fleet_spec_carries_the_device():
    sc = tscenario.SoakScenario.generate(seed=21, intervals=8,
                                         kind="kill_forever")
    spec = torch_orch.FleetSpec.for_scenario(sc, "/tmp/x")
    assert spec.device == "cuda" and spec.lease_ttl_s == 1.5
    spec = torch_orch.FleetSpec.for_scenario(sc, "/tmp/x", device="cpu")
    assert torch_orch.FleetSpec.from_json(spec.to_json()) == spec
    jspec = jorch.FleetSpec.for_scenario(
        jscenario.SoakScenario.generate(seed=21, intervals=8,
                                        kind="kill_forever"), "/tmp/x")
    # the JAX spec's fields and one more, the device
    assert set(spec.to_json()) - set(jspec.to_json()) == {"device"}


# -- monitor and gates ------------------------------------------------------


def _samples(pkg, rng, n, gens=1):
    out = []
    for i in range(n):
        out.append(pkg.IntervalSample(
            idx=i, generation=min(gens - 1, i * gens // n),
            rss_kb=int(400_000 + rng.integers(-5000, 9000) + 700 * i),
            compiles=int(30 + (i > n // 2) * rng.integers(0, 2)),
            coverage_ratio=(None if i == 3 else
                            float(np.round(rng.uniform(0.85, 1.0), 4))),
            e2e_age_ns=(None if i == 1 else int(rng.integers(1, 9) * 1e8)),
            overload_level=int(i == n - 1 and rng.random() < 0.3),
            breaker_gauge=float(i == n - 2 and rng.random() < 0.3),
            requeue_bytes=int(rng.integers(0, 4096)) if i < n - 4 else 0,
            rows_pending=0, ckpt_write_errors=int(rng.integers(0, 3)),
            degradations=(("checkpoint writes failing",)
                          if i == n - 1 and rng.random() < 0.2 else ())))
    return out


def _ledger(pkg, rng, forever: bool):
    sent = int(rng.integers(500, 2000))
    lost = int(rng.integers(0, 40)) if forever else 0
    shed, quar = int(rng.integers(0, 5)), int(rng.integers(0, 5))
    emitted = sent - shed - quar - lost - int(rng.random() < 0.3)
    off = int(rng.integers(1000, 5000))
    acked = off - int(rng.integers(0, 50))
    led = pkg.SoakLedger(
        sent_global=sent, emitted_global=float(emitted), shed=shed,
        quarantined=quar, sent_local=200, emitted_local=200.0,
        dd_offered=off, dd_acked=acked, dd_dropped=off - acked,
        restarts={"global": 1},
        device_buffer_growth_bytes=int(rng.integers(-4096, 1 << 21)))
    if forever:
        led.accounted_lost = lost
        led.takeover_loss_bound = lost + int(rng.integers(-2, 30))
        led.promotions = int(rng.random() < 0.9)
        led.takeover_detect_s = float(rng.uniform(-1.0, 18.0))
        led.takeover_first_flush_s = led.takeover_detect_s + 0.4
    return led


def _vector(pkg_gates, results):
    vec = pkg_gates.gate_vector(results)
    gate = vec["gates"].get("device_buffers_bounded")
    if gate is not None and gate["detail"].startswith("settled "):
        gate["detail"] = "<default census detail>"
    return vec


@pytest.mark.parametrize("kind", ["kill_restart", "kill_forever"])
def test_monitor_and_gate_vector_equal_the_jax_package(kind):
    for trial in range(40):
        rng = np.random.default_rng(trial)
        n = int(rng.integers(4, 20))
        gens = int(rng.integers(1, 3))
        js = jscenario.SoakScenario.generate(seed=trial, intervals=n,
                                             kills=1, kind=kind)
        ts = tscenario.SoakScenario.generate(seed=trial, intervals=n,
                                             kills=1, kind=kind)
        jm = jmonitor.SteadyStateMonitor(js.thresholds.warmup_intervals)
        tm = tmonitor.SteadyStateMonitor(ts.thresholds.warmup_intervals)
        for s in _samples(jmonitor, np.random.default_rng(trial), n, gens):
            jm.add(s)
        for s in _samples(tmonitor, np.random.default_rng(trial), n, gens):
            tm.add(s)
        for stat in ("rss_slope_pct_per_100", "coverage_median",
                     "e2e_age_p99_s", "max_requeue_bytes"):
            assert getattr(jm, stat)() == getattr(tm, stat)(), stat
        for after in (0, 3, n // 2):
            assert jm.compile_drift(after) == tm.compile_drift(after)
        forever = kind == "kill_forever"
        jl = _ledger(jgates, np.random.default_rng(100 + trial), forever)
        tl = _ledger(tgates, np.random.default_rng(100 + trial), forever)
        jl.buffer_census_ok = tl.buffer_census_ok = trial % 7 != 0
        jr = jgates.run_gates(js, jm, jl)
        tr = tgates.run_gates(ts, tm, tl)
        assert _vector(jgates, jr) == _vector(tgates, tr), trial
        jerr = terr = None
        try:
            jgates.enforce(jr, js)
        except jgates.SoakGateError as e:
            jerr = str(e)
        try:
            tgates.enforce(tr, ts)
        except tgates.SoakGateError as e:
            terr = str(e)
        if jerr is not None and "device_buffers_bounded" in jerr:
            continue  # the census gate's default detail differs in text
        assert jerr == terr


def test_clean_vector_names_the_gates_of_the_jax_package():
    sc = tscenario.SoakScenario.generate(seed=4, intervals=10,
                                         kind="kill_forever")
    mon = tmonitor.SteadyStateMonitor(sc.thresholds.warmup_intervals)
    for i in range(10):
        mon.add(tmonitor.IntervalSample(idx=i, generation=0,
                                        rss_kb=400_000, compiles=30,
                                        coverage_ratio=0.97,
                                        e2e_age_ns=5 * 10**8))
    led = tgates.SoakLedger(sent_global=1000, emitted_global=967, shed=6,
                            quarantined=4, sent_local=200,
                            emitted_local=200, dd_offered=5000,
                            dd_acked=4900, dd_dropped=50,
                            dd_crash_lost=50, accounted_lost=23,
                            takeover_loss_bound=30, promotions=1,
                            takeover_detect_s=2.1,
                            takeover_first_flush_s=3.4)
    vec = tgates.gate_vector(tgates.run_gates(sc, mon, led))
    assert vec["all_ok"], vec
    assert set(vec["gates"]) == {
        "conservation_global", "conservation_local", "dd_rows_conserved",
        "rss_slope", "compile_drift", "coverage", "e2e_age_p99",
        "recovery", "requeue_bounded", "device_buffers_bounded",
        "takeover"}
    led.accounted_lost = 0
    with pytest.raises(tgates.SoakGateError, match="seed=4"):
        tgates.enforce(tgates.run_gates(sc, mon, led), sc)


# -- disk-full degradation --------------------------------------------------


def test_injected_enospc_rides_the_ready_body(tmp_path):
    """A checkpoint commit refused by the disk (injected ``disk_full``,
    rate 1.0) degrades the instance: counted, named on
    /healthcheck/ready at HTTP 200, never raised."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.samplers.parser import parse_metric
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks import ChannelMetricSink

    cfg = Config(statsd_listen_addresses=[],
                 http_address="127.0.0.1:0", interval="86400s",
                 store_initial_capacity=32, store_chunk=128,
                 aggregates=["count"], percentiles=[0.5],
                 checkpoint_path=str(tmp_path / "v.ckpt"),
                 checkpoint_interval="3600s",
                 fault_injection_rate=1.0,
                 fault_injection_seed=9,
                 fault_injection_kinds="disk_full")
    server = Server(cfg, metric_sinks=[ChannelMetricSink()], device="cpu")
    server.start()
    try:
        server.store.process_metric(parse_metric(b"c1:1|c"))
        assert server.checkpointer.write_once() is False  # no raise
        assert server.checkpointer.write_errors == 1
        assert "disk full" in server.checkpointer.last_error
        url = (f"http://127.0.0.1:{server.ops_server.port}"
               f"/healthcheck/ready")
        with urllib.request.urlopen(url) as r:
            assert r.status == 200  # degraded is NOT unready
            body = r.read().decode()
        assert "degraded" in body
        assert "checkpoint writes failing" in body
        assert "disk full" in body
    finally:
        server.shutdown()


# -- the in-process smokes --------------------------------------------------


def test_soak_smoke(tmp_path):
    """A real in-process fleet (local UDP → proxy → global) on the CPU,
    10 driven intervals, one global kill (crash_stop) inside the chaos
    span plus the seeded sink windows and disk-full/deadline-pressure
    faults: the full gate vector clean, exact conservation across the
    restart, the ledger audit settled, the census back at its baseline
    with the killed generation's planes freed."""
    thr = tscenario.GateThresholds(warmup_intervals=2,
                                   rss_slope_pct_per_100=500.0)
    sc = tscenario.SoakScenario.generate(seed=7, intervals=10, kills=1,
                                         thresholds=thr)
    assert sc.kills and sc.sink_windows  # chaos actually scheduled
    t0 = time.monotonic()
    report = tsoak.run_soak(sc, tsoak.InProcessFleet(sc, str(tmp_path),
                                                     device="cpu"))
    elapsed = time.monotonic() - t0
    vec = report.vector()
    assert vec["all_ok"], vec
    led = report.ledger
    assert led.restarts == {"global": 1}
    assert led.sent_global > 0
    assert led.sent_global == (led.emitted_global + led.shed
                               + led.quarantined)
    assert led.sent_local == led.emitted_local
    assert led.dd_offered > 0
    assert led.dd_offered == (led.dd_acked + led.dd_pending
                              + led.dd_dropped + led.dd_crash_lost)
    assert led.dd_pending == 0
    tl = report.ledger_timeline
    assert len(tl) >= 10
    assert all(s["ok"] is None for s in tl if not s["settled"])
    terminal = tl[-1]
    assert terminal["settled"] and terminal["ok"] is True
    assert terminal["values"]["sent_global"] == led.sent_global
    btl = report.buffer_timeline
    assert len(btl) >= 2
    assert btl[-1]["settled"] and btl[-1]["ok"] is True
    # the restarted global's new planes came, the killed one's went
    assert max(s["bytes_live"] for s in btl) > btl[-1]["bytes_live"]
    assert led.buffer_census_ok
    assert led.device_buffer_growth_bytes <= \
        sc.thresholds.device_buffer_growth_max_bytes
    assert elapsed < 60.0, f"soak smoke took {elapsed:.1f}s"


def test_kill_forever_promotes_standby(tmp_path):
    """The HA smoke: an active and a warm standby global behind a file
    lease, replication after every flush, the proxy routed by
    ``LeaderDiscoverer``; mid-run the active is crash-stopped with no
    restart. The standby takes the lease, merges its shadow, the proxy
    re-routes, and the loss is the active's one un-flushed interval,
    folded exactly into conservation as ``accounted_lost``."""
    thr = tscenario.GateThresholds(warmup_intervals=2,
                                   rss_slope_pct_per_100=500.0)
    sc = tscenario.SoakScenario.generate(seed=21, intervals=8,
                                         kind="kill_forever",
                                         thresholds=thr)
    t0 = time.monotonic()
    fleet = tsoak.InProcessFleet(sc, str(tmp_path), device="cpu")
    report = tsoak.run_soak(sc, fleet)
    elapsed = time.monotonic() - t0
    vec = report.vector()
    assert vec["all_ok"], vec
    led = report.ledger
    assert led.promotions == 1
    assert led.restarts == {}
    assert 0.0 <= led.takeover_detect_s <= thr.takeover_detect_max_s
    assert led.takeover_first_flush_s >= led.takeover_detect_s
    assert 0 <= led.accounted_lost <= led.takeover_loss_bound
    assert led.sent_global == (led.emitted_global + led.shed
                               + led.quarantined + led.accounted_lost)
    assert led.sent_local == led.emitted_local
    # the proxy followed the lease onto the standby
    from veneur_tpu_torch.discovery import LeaderDiscoverer
    assert isinstance(fleet.proxy.discoverer, LeaderDiscoverer)
    assert list(fleet.proxy.ring.members()) == [
        f"http://127.0.0.1:{fleet.spec.standby_port}"]
    assert elapsed < 90.0, f"HA takeover smoke took {elapsed:.1f}s"


# -- the line protocol and the process fleet --------------------------------


def test_child_line_protocol(tmp_path):
    """A ``_Child`` of each role on the CPU: the HA fleet's boot order
    (the active holds the lease before the standby, the proxy and the
    local boot), then flush, counters, ring, hastatus, the settle reads,
    a sink mode, a bad command, and quit."""
    sc = tscenario.SoakScenario.generate(seed=21, intervals=8,
                                         kind="kill_forever")
    spec = torch_orch.FleetSpec.for_scenario(sc, str(tmp_path),
                                             device="cpu")
    kids = {}
    try:
        kids["global"] = torch_orch._Child("global", spec)
        kids["global"].spawn()
        torch_orch.ProcessFleet._wait_leader(kids["global"])
        rest = [torch_orch._Child(r, spec)
                for r in ("standby", "proxy", "local")]
        boots = [threading.Thread(target=c.spawn) for c in rest]
        for th in boots:
            th.start()
        for th in boots:
            th.join()
        kids.update({c.role: c for c in rest})
        for role, c in kids.items():
            assert c.ready["ready"] and c.ready["role"] == role
        lines, sent_c, sent_l, n_series = torch_orch.interval_traffic(sc, 0)
        p0 = kids["local"].command("processed")["v"]
        import socket
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for ln in lines:
                s.sendto(ln, ("127.0.0.1", spec.udp_port))
        torch_orch._settle(lambda: kids["local"].command("processed")["v"],
                           p0 + len(lines))
        i0 = kids["global"].command("imported")["v"]
        assert kids["local"].command("flush")["emitted"] == sent_l
        torch_orch._settle(lambda: kids["global"].command("imported")["v"],
                           i0 + n_series)
        ack = kids["global"].command("flush")
        assert ack["ok"] and ack["emitted"] == sent_c
        assert {"rss_kb", "compiles", "coverage_ratio", "e2e_age_ns",
                "overload_level", "requeue_bytes",
                "degradations"} <= set(ack["sample"])
        assert set(kids["global"].command("counters")["counters"]) >= {
            "dd_offered", "dd_acked", "shed", "quarantined"}
        assert set(kids["local"].command("counters")["counters"]) == {
            "shed", "quarantined", "ckpt_write_errors"}
        assert kids["proxy"].command("counters") == {"counters": {}}
        assert kids["proxy"].command("ring") == {
            "members": [f"http://127.0.0.1:{spec.global_port}"]}
        assert kids["global"].command("hastatus")["ha"]["is_leader"]
        # the flush's epoch reaches the standby off the flush thread
        deadline = time.monotonic() + 20.0
        sby = kids["standby"].command("hastatus")["ha"]
        while not sby["receives_total"] and time.monotonic() < deadline:
            time.sleep(0.05)
            sby = kids["standby"].command("hastatus")["ha"]
        assert not sby["is_leader"] and sby["receives_total"] >= 1
        assert kids["global"].command("mode blackhole") == {
            "ok": True, "mode": "blackhole"}
        assert kids["global"].command("ckpt")["ok"]
        assert kids["local"].command("nonsense")["ok"] is False
    finally:
        for c in kids.values():
            c.quit()
    for c in kids.values():
        assert c.proc.returncode == 0


@pytest.mark.slow
class TestProcessSoak:
    def test_multi_process_soak_survives_real_sigkills(self, tmp_path):
        thr = tscenario.GateThresholds(warmup_intervals=6,
                                       rss_slope_pct_per_100=60.0,
                                       recovery_intervals=4)
        sc = tscenario.SoakScenario.generate(seed=13, intervals=40, kills=3,
                                             thresholds=thr)
        assert tuple(r for _a, r in sc.kills) == tscenario.KILL_CYCLE
        report = tsoak.run_soak(sc, tsoak.ProcessFleet(sc, str(tmp_path),
                                                       device="cpu"))
        vec = report.vector()
        assert vec["all_ok"], vec
        led = report.ledger
        assert led.restarts == {"global": 1, "local": 1, "proxy": 1}
        assert led.sent_global == (led.emitted_global + led.shed
                                   + led.quarantined)
        assert led.sent_local == led.emitted_local
        assert led.dd_offered == (led.dd_acked + led.dd_pending
                                  + led.dd_dropped + led.dd_crash_lost)

    def test_restart_storm_rebinds_same_port(self, tmp_path):
        thr = tscenario.GateThresholds(warmup_intervals=3,
                                       rss_slope_pct_per_100=500.0)
        base = tscenario.SoakScenario.generate(seed=17, intervals=12,
                                               kills=0, thresholds=thr)
        sc = tscenario.SoakScenario(
            seed=17, intervals=12,
            kills=((3, "global"), (4, "global"), (5, "global")),
            sink_windows=base.sink_windows, fault_rate=base.fault_rate,
            fault_kinds=base.fault_kinds, thresholds=thr)
        report = tsoak.run_soak(sc, tsoak.ProcessFleet(sc, str(tmp_path),
                                                       device="cpu"))
        vec = report.vector()
        assert vec["all_ok"], vec
        led = report.ledger
        assert led.restarts == {"global": 3}
        assert led.sent_global == (led.emitted_global + led.shed
                                   + led.quarantined)

    def test_multi_process_kill_forever_takeover(self, tmp_path):
        thr = tscenario.GateThresholds(warmup_intervals=2,
                                       rss_slope_pct_per_100=500.0)
        sc = tscenario.SoakScenario.generate(seed=22, intervals=8,
                                             kind="kill_forever",
                                             thresholds=thr)
        report = tsoak.run_soak(sc, tsoak.ProcessFleet(sc, str(tmp_path),
                                                       device="cpu"))
        vec = report.vector()
        assert vec["all_ok"], vec
        led = report.ledger
        assert led.promotions == 1 and led.restarts == {}
        assert led.sent_global == (led.emitted_global + led.shed
                                   + led.quarantined + led.accounted_lost)


def test_jax_soak_package_is_the_reference():
    """The names the port's soak package exports are the JAX package's."""
    assert set(tsoak.__all__) == set(jsoak.__all__)
