"""The soak orchestrator: a chaos-driven fleet behind one soak loop.

Boots a production-shaped fleet — a LOCAL instance (UDP statsd ingest,
checkpointed, forwarding) → an HTTP PROXY (consistent-hash fan-out,
peers-file discovery) → a GLOBAL aggregator (checkpointed, handoff
plane armed, Datadog streamed egress + an exact-accounting channel
sink) — then drives the scenario's intervals: mixed traffic in, driven
flushes through, the seeded chaos schedule on top (role kills, sink
black-hole/5xx/latency windows, injected disk-full and
flush-deadline-pressure faults), a steady-state sample per interval,
and the full gate vector at the end (``soak.gates``).

Two interchangeable fleet backends share the orchestrator's loop:

* :class:`InProcessFleet` — all three roles in this process; kills are
  ``Server.crash_stop()`` (the SIGKILL twin: no final flush, no
  checkpoint truncation, no handoff quiesce). Fast enough for the
  tier-1 smoke test.
* :class:`ProcessFleet` — each role is a real child process
  (``python -m veneur_tpu_torch.soak.child``) on fixed ports; kills are
  real ``SIGKILL``. Each child imports torch and builds its role on
  ``FleetSpec.device``.

Conservation across a kill is exact because a kill is scheduled
BETWEEN intervals: the orchestrator settles ingest, commits a checkpoint
(retried through injected ENOSPC until the disk admits it), folds the
dying generation's monotone counters into the run ledger (parked sink
rows become counted ``dd_crash_lost``), and only then kills. The
restarted process restores from the checkpoint epoch and the ledger
closes end to end.

Every role runs on ``FleetSpec.device`` (``cuda`` unless the caller
names another): a global's flush drains through K1, its import guard
drains, each restart's checkpoint restore and the standby's promotion
through K2. The orchestrator's :class:`BufferCensus` reads live tensor storage
on that device.
"""

from __future__ import annotations

import logging
import random
import socket
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from veneur_tpu_torch.soak.gates import (GateResult, SoakLedger, enforce,
                                   gate_vector, run_gates)
from veneur_tpu_torch.soak.monitor import (IntervalSample, SteadyStateMonitor,
                                     read_rss_kb)
from veneur_tpu_torch.soak.scenario import (KIND_KILL_FOREVER, MODE_BLACKHOLE,
                                      MODE_HTTP_5XX, MODE_OK, MODE_SLOW,
                                      ROLE_GLOBAL, ROLE_LOCAL, ROLE_PROXY,
                                      ROLE_STANDBY, SoakScenario)

log = logging.getLogger("veneur.soak")

GLOBAL_PREFIX = "soak.c"   # counters tagged veneurglobalonly (the ledger)
LOCAL_PREFIX = "soak.l"    # counters aggregated at the local instance


class ChaosPost:
    """The global's Datadog POST transport under scenario control:
    ``ok`` → 202, ``http_5xx`` → 503, ``blackhole`` → raises (the
    refused-connection twin), ``slow`` → latency then 202. One
    instance survives sink generations so an outage window spans a
    global restart."""

    def __init__(self, slow_s: float = 0.05):
        self.mode = MODE_OK
        self.slow_s = slow_s
        self.posts = 0
        self.failures = 0

    def __call__(self, url, body, **kwargs) -> int:
        self.posts += 1
        if self.mode == MODE_BLACKHOLE:
            self.failures += 1
            raise OSError("soak: injected sink black hole")
        if self.mode == MODE_HTTP_5XX:
            self.failures += 1
            return 503
        if self.mode == MODE_SLOW:
            time.sleep(self.slow_s)
        return 202


def pick_port(kind: int = socket.SOCK_DGRAM) -> int:
    """A fixed port the fleet keeps across restarts (bind-0, read,
    close). TCP listeners here use SO_REUSEPORT (OpsServer does too)
    so the address survives kill/rebind cycles."""
    s = socket.socket(socket.AF_INET, kind)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@dataclass
class FleetSpec:
    """Everything needed to (re)build any role — JSON-serializable so
    the subprocess children build byte-identical servers."""

    root: str                  # scratch dir: checkpoints, spool, peers
    udp_port: int
    proxy_port: int
    global_port: int
    fault_rate: float
    fault_kinds: str
    seed: int
    requeue_max_bytes: int
    breaker_reset_s: float = 0.75
    # HA (kill_forever scenarios): a warm-standby global on its own
    # port plus a file:// lease; lease_ttl_s == 0 means HA off
    standby_port: int = 0
    lease_ttl_s: float = 0.0
    # the torch device every role builds its store on
    device: str = "cuda"

    def to_json(self) -> dict:
        return dict(self.__dict__)

    @classmethod
    def from_json(cls, d: dict) -> "FleetSpec":
        return cls(**d)

    @classmethod
    def for_scenario(cls, scenario: SoakScenario, root: str,
                     device: str = "cuda") -> "FleetSpec":
        ha = scenario.kind == KIND_KILL_FOREVER
        return cls(root=root, udp_port=pick_port(),
                   proxy_port=pick_port(socket.SOCK_STREAM),
                   global_port=pick_port(socket.SOCK_STREAM),
                   fault_rate=scenario.fault_rate,
                   fault_kinds=scenario.fault_kinds,
                   seed=scenario.seed,
                   requeue_max_bytes=scenario.thresholds.requeue_max_bytes,
                   standby_port=pick_port(socket.SOCK_STREAM) if ha else 0,
                   lease_ttl_s=1.5 if ha else 0.0, device=device)


# -- role construction (shared by InProcessFleet and soak.child) -----------

def build_local_server(spec: FleetSpec):
    """The local role: UDP statsd ingest on the fixed port, driven
    cadence, checkpointed, forwarding to the proxy."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks import ChannelMetricSink

    cfg = Config(
        statsd_listen_addresses=[f"udp://127.0.0.1:{spec.udp_port}"],
        interval="86400s",  # driven cadence: the loop never self-fires
        forward_address=f"http://127.0.0.1:{spec.proxy_port}",
        aggregates=["count"], percentiles=[0.5], num_readers=2,
        store_initial_capacity=64, store_chunk=128,
        checkpoint_path=f"{spec.root}/local.ckpt",
        checkpoint_interval="3600s",
        fault_injection_rate=spec.fault_rate,
        fault_injection_seed=spec.seed + 1,
        fault_injection_kinds="disk_full,deadline_pressure")
    sink = ChannelMetricSink()
    server = Server(cfg, metric_sinks=[sink], device=spec.device)
    server.start()
    return server, sink


def build_global_server(spec: FleetSpec, chaos_post: ChaosPost,
                        role: str = ROLE_GLOBAL):
    """The global role: /import ingest on the fixed ops port, handoff
    plane armed over the peers file, checkpointed, channel sink for
    exact value accounting + Datadog streamed egress through the
    scenario's :class:`ChaosPost`. ``role`` may be ``standby`` (HA
    scenarios): same shape on ``spec.standby_port``, contending for
    the shared file lease but replicating to nobody. Returns
    ``(server, channel_sink, dd_sink, offered_counter)`` where
    ``offered_counter`` is a one-slot list counting rows offered to
    the chunk path this generation."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.resilience import CircuitBreaker, RetryPolicy
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks import ChannelMetricSink
    from veneur_tpu_torch.sinks.datadog import DatadogMetricSink

    port = spec.standby_port if role == ROLE_STANDBY else spec.global_port
    self_addr = f"http://127.0.0.1:{port}"
    # each global life gets its OWN handoff ring (itself); the proxy's
    # routing is lease-driven in HA mode, peers.txt-driven otherwise
    peers = (f"{spec.root}/standby_peers.txt" if role == ROLE_STANDBY
             else f"{spec.root}/peers.txt")
    with open(peers, "w") as f:
        f.write(self_addr + "\n")
    ha_keys = {}
    if spec.lease_ttl_s > 0:
        ha_keys = dict(
            lease_path=f"file://{spec.root}/lease",
            lease_ttl=f"{spec.lease_ttl_s}s",
            lease_renew_interval=f"{spec.lease_ttl_s / 3.0:.3f}s")
        if role == ROLE_GLOBAL:
            # the active streams its retired flush epochs to the
            # standby; the standby replicates to nobody (its shadow is
            # the receiving end)
            ha_keys["standby_peers"] = \
                f"http://127.0.0.1:{spec.standby_port}"
    cfg = Config(
        statsd_listen_addresses=[], interval="86400s",
        http_address=f"127.0.0.1:{port}",
        aggregates=["count"], percentiles=[0.5],
        store_initial_capacity=64, store_chunk=128,
        checkpoint_path=f"{spec.root}/{role}.ckpt",
        checkpoint_interval="3600s",
        handoff_enabled=True,
        handoff_self=self_addr,
        handoff_peers=f"file://{peers}",
        fault_injection_rate=spec.fault_rate,
        fault_injection_seed=spec.seed + (2 if role == ROLE_GLOBAL
                                          else 4),
        fault_injection_kinds=spec.fault_kinds,
        sink_requeue_max_bytes=spec.requeue_max_bytes,
        **ha_keys)
    channel = ChannelMetricSink()
    dd = DatadogMetricSink(
        interval=10.0, flush_max_per_body=100, hostname="soak-global",
        tags=["soak:1"], dd_hostname="http://dd.soak.invalid",
        api_key="soak", post=chaos_post,
        retry_policy=RetryPolicy(max_attempts=1),
        breaker=CircuitBreaker(failure_threshold=3,
                               reset_timeout=spec.breaker_reset_s,
                               name="datadog"),
        requeue_max_bytes=spec.requeue_max_bytes)
    offered = [0]
    orig_chunk = dd.flush_chunk

    def counting_flush_chunk(chunk):
        offered[0] += chunk.rows
        orig_chunk(chunk)

    dd.flush_chunk = counting_flush_chunk
    server = Server(cfg, metric_sinks=[channel, dd], device=spec.device)
    server.start()
    return server, channel, dd, offered


def build_proxy(spec: FleetSpec):
    """The proxy role: HTTP /import fan-out over the peers-file ring —
    or, in HA mode, over the lease (:class:`LeaderDiscoverer`: the
    holder IS the membership, so a takeover re-routes the fan-out
    within one ordinary refresh, no new routing machinery)."""
    from veneur_tpu_torch.config import ProxyConfig
    from veneur_tpu_torch.proxy.proxy import Proxy

    if spec.lease_ttl_s > 0:
        from veneur_tpu_torch.discovery import (LeaderDiscoverer,
                                          lease_backend_from_url)

        disc = LeaderDiscoverer(
            lease_backend_from_url(f"file://{spec.root}/lease"))
        # chase a lease transition quickly: the refresh cadence bounds
        # detect→re-route, and the active already holds at proxy boot
        cfg = ProxyConfig(http_address=f"127.0.0.1:{spec.proxy_port}",
                          forward_timeout="5s",
                          consul_refresh_interval="250ms")
    else:
        from veneur_tpu_torch.discovery import FilePeersDiscoverer

        peers = f"{spec.root}/peers.txt"
        with open(peers, "w") as f:
            f.write(f"http://127.0.0.1:{spec.global_port}\n")
        disc = FilePeersDiscoverer(peers)
        cfg = ProxyConfig(http_address=f"127.0.0.1:{spec.proxy_port}",
                          forward_timeout="5s")
    proxy = Proxy(cfg, discoverer=disc)
    proxy.start()
    return proxy


def drain_channel(sink, prefix: str) -> float:
    """Drain every queued flush batch; return the summed value of
    metrics whose name starts with ``prefix`` (counters flush raw
    counts, so the sum is the exact ingested value)."""
    import queue

    total = 0.0
    while True:
        try:
            batch = sink.queue.get_nowait()
        except queue.Empty:
            return total
        for m in batch:
            if m.name.startswith(prefix):
                total += m.value


def global_sample_fields(server, dd, pid: int = 0) -> dict:
    """One interval's steady-state reading of a global server (shared
    by the in-process fleet and the subprocess child)."""
    from veneur_tpu_torch.obs import kernels

    entry = {}
    if server.obs_timeline is not None:
        entries = server.obs_timeline.entries(1)
        entry = entries[-1] if entries else {}
    ckpt = server.checkpointer
    mgr = server.handoff_manager
    return {
        "rss_kb": read_rss_kb(pid),
        "compiles": kernels.compiles_total(),
        "coverage_ratio": entry.get("coverage_ratio"),
        "e2e_age_ns": entry.get("e2e_age_ns"),
        "overload_level": server.overload.level_nowait(),
        "breaker_gauge": (dd.breaker.state_gauge()
                          if dd.breaker is not None else 0.0),
        "requeue_bytes": dd.chunk_requeue_bytes(),
        "rows_pending": dd.chunk_rows_pending(),
        "ckpt_write_errors": ckpt.write_errors if ckpt else 0,
        "spool_errors": mgr.spool_errors_total if mgr else 0,
        "degradations": tuple(server.degradation()),
    }


def global_counters(server, dd, offered) -> Dict[str, int]:
    """The global generation's monotone counters, read just before a
    kill (folded with parked rows → crash_lost) and once at the end."""
    mgr = server.handoff_manager
    return {
        "dd_offered": offered[0],
        "dd_acked": dd.chunk_rows_acked,
        "dd_dropped": dd.chunk_rows_dropped,
        "dd_pending": dd.chunk_rows_pending(),
        "shed": server.overload.shed_total(),
        "quarantined": server.quarantined,
        "ckpt_write_errors": (server.checkpointer.write_errors
                              if server.checkpointer else 0),
        "spool_errors": mgr.spool_errors_total if mgr else 0,
    }


def local_counters(server) -> Dict[str, int]:
    return {
        "shed": server.overload.shed_total(),
        "quarantined": server.quarantined,
        "ckpt_write_errors": (server.checkpointer.write_errors
                              if server.checkpointer else 0),
    }


def checkpoint_with_retry(server, attempts: int = 400,
                          pause_s: float = 0.005) -> int:
    """Commit a checkpoint, riding through injected/real ENOSPC (the
    write path never raises; it counts and returns False). Returns the
    attempt count; raises only if the disk never admits the write."""
    ckpt = server.checkpointer
    if ckpt is None:
        return 0
    for i in range(attempts):
        if ckpt.write_once():
            return i + 1
        time.sleep(pause_s)
    raise RuntimeError(
        f"checkpoint to {ckpt.path} failed {attempts} times "
        f"(last error: {ckpt.last_error})")


# -- the in-process fleet ---------------------------------------------------

class InProcessFleet:
    """All three roles in this process (plus the warm standby in HA
    scenarios). Kills use ``Server.crash_stop()`` — the in-process
    SIGKILL twin (no final flush, no checkpoint, no lease release)."""

    def __init__(self, scenario: SoakScenario, root: str,
                 device: str = "cuda"):
        self.spec = FleetSpec.for_scenario(scenario, root, device)
        self.chaos = ChaosPost()
        self._sender: Optional[socket.socket] = None
        self.local = self.local_sink = None
        self.glob = self.g_channel = self.g_dd = None
        self._g_offered = [0]
        self.proxy = None
        self.sby = self.s_channel = self.s_dd = None
        self._s_offered = [0]

    def start(self) -> None:
        self.glob, self.g_channel, self.g_dd, self._g_offered = \
            build_global_server(self.spec, self.chaos)
        if self.spec.lease_ttl_s > 0:
            # the active must hold the lease before the standby's
            # elector (or the proxy's first refresh) can observe it —
            # boot order is the determinism of who is active
            self._wait_leader()
            self.s_chaos = ChaosPost()
            self.sby, self.s_channel, self.s_dd, self._s_offered = \
                build_global_server(self.spec, self.s_chaos,
                                    role=ROLE_STANDBY)
        self.proxy = build_proxy(self.spec)
        self.local, self.local_sink = build_local_server(self.spec)
        self._sender = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sender.connect(("127.0.0.1", self.spec.udp_port))

    def _wait_leader(self, timeout_s: float = 30.0) -> None:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            sm = getattr(self.glob, "standby_manager", None)
            if sm is not None and sm.is_leader:
                return
            time.sleep(0.02)
        raise RuntimeError("active global never acquired the boot lease")

    def stop(self) -> None:
        for closer in (
                lambda: self._sender and self._sender.close(),
                lambda: self.local and self.local.shutdown(),
                lambda: self.proxy and self.proxy.shutdown(),
                lambda: self.sby and self.sby.shutdown(),
                lambda: self.glob and self.glob.shutdown()):
            try:
                closer()
            except Exception:
                log.exception("soak fleet stop")

    def send(self, lines: List[bytes]) -> None:
        for line in lines:
            self._sender.send(line)

    def local_processed(self) -> int:
        return self.local.store.processed

    def global_imported(self) -> int:
        return self.glob.store.imported

    def set_sink_mode(self, mode: str) -> None:
        self.chaos.mode = mode

    def flush_local(self) -> float:
        self.local.flush()
        return drain_channel(self.local_sink, LOCAL_PREFIX)

    def flush_global(self) -> Tuple[float, dict]:
        self.glob.flush()
        emitted = drain_channel(self.g_channel, GLOBAL_PREFIX)
        return emitted, global_sample_fields(self.glob, self.g_dd)

    def checkpoint(self, role: str) -> int:
        if role == ROLE_LOCAL:
            return checkpoint_with_retry(self.local)
        if role == ROLE_GLOBAL:
            return checkpoint_with_retry(self.glob)
        return 0

    def counters(self, role: str) -> Dict[str, int]:
        if role == ROLE_GLOBAL:
            return global_counters(self.glob, self.g_dd, self._g_offered)
        if role == ROLE_LOCAL:
            return local_counters(self.local)
        return {}

    def kill_restart(self, role: str) -> None:
        if role == ROLE_LOCAL:
            self.local.crash_stop()
            self.local, self.local_sink = build_local_server(self.spec)
        elif role == ROLE_GLOBAL:
            self.glob.crash_stop()
            self.glob, self.g_channel, self.g_dd, self._g_offered = \
                build_global_server(self.spec, self.chaos)
        elif role == ROLE_PROXY:
            # the proxy is stateless; its crash twin is an immediate
            # teardown + rebind on the same fixed port
            try:
                self.proxy.shutdown()
            except Exception:
                pass
            self.proxy = build_proxy(self.spec)

    # -- HA takeover (kill_forever scenarios) --------------------------------

    def ha_status(self) -> dict:
        server = self.sby if self.sby is not None else self.glob
        sm = getattr(server, "standby_manager", None)
        return sm.snapshot() if sm is not None else {}

    def kill_forever(self) -> None:
        """SIGKILL-twin the active with NO restart: the standby becomes
        the fleet's global (its lease poll promotes it; the orchestrator's
        view swaps immediately so flush/counters target the survivor)."""
        self.glob.crash_stop()
        self.glob, self.g_channel, self.g_dd, self._g_offered = \
            (self.sby, self.s_channel, self.s_dd, self._s_offered)
        self.chaos = self.s_chaos
        self.sby = self.s_channel = self.s_dd = None

    def await_reroute(self, timeout_s: float = 15.0) -> bool:
        """Wait for the proxy ring to chase the lease onto the promoted
        standby (one ordinary membership refresh)."""
        want = [f"http://127.0.0.1:{self.spec.standby_port}"]
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if list(self.proxy.ring.members()) == want:
                return True
            time.sleep(0.05)
        return False


# -- the multi-process fleet ------------------------------------------------

class _Child:
    """One role as a real child process speaking the line protocol of
    ``veneur_tpu_torch.soak.child`` (commands on stdin, one JSON ack per
    command on stdout, logs on stderr)."""

    def __init__(self, role: str, spec: FleetSpec):
        self.role = role
        self.spec = spec
        self.proc = None
        self.ready: dict = {}

    def spawn(self) -> None:
        import json
        import subprocess
        import sys

        spec_path = f"{self.spec.root}/{self.role}.spec.json"
        with open(spec_path, "w") as f:
            json.dump(self.spec.to_json(), f)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "veneur_tpu_torch.soak.child",
             self.role, spec_path],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, bufsize=1)
        self.ready = self._read_line(timeout_s=120.0)
        if not self.ready.get("ready"):
            raise RuntimeError(f"soak {self.role} child failed to boot: "
                               f"{self.ready}")

    def _read_line(self, timeout_s: float = 60.0) -> dict:
        import json
        import select

        deadline = time.monotonic() + timeout_s
        buf = ""
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(
                    f"soak {self.role} child unresponsive "
                    f"(rc={self.proc.poll()})")
            r, _, _ = select.select([self.proc.stdout], [], [], left)
            if not r:
                continue
            buf = self.proc.stdout.readline()
            if buf == "":
                raise RuntimeError(
                    f"soak {self.role} child died "
                    f"(rc={self.proc.poll()})")
            buf = buf.strip()
            if buf:
                return json.loads(buf)

    def command(self, cmd: str, timeout_s: float = 60.0) -> dict:
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()
        return self._read_line(timeout_s)

    def kill(self) -> None:
        self.proc.kill()
        self.proc.wait(timeout=30)

    def quit(self) -> None:
        try:
            self.command("quit", timeout_s=30.0)
        except Exception:
            pass
        try:
            self.proc.wait(timeout=30)
        except Exception:
            self.proc.kill()


class ProcessFleet:
    """Each role a real OS process on fixed ports; kills are real
    SIGKILL. The orchestrator's view is identical to the in-process fleet —
    the children self-report their samples and counters."""

    def __init__(self, scenario: SoakScenario, root: str,
                 device: str = "cuda"):
        self.spec = FleetSpec.for_scenario(scenario, root, device)
        self.children: Dict[str, _Child] = {}
        self._sender: Optional[socket.socket] = None
        self._mode = MODE_OK

    def start(self) -> None:
        ha = self.spec.lease_ttl_s > 0
        roles = ((ROLE_GLOBAL, ROLE_STANDBY, ROLE_PROXY, ROLE_LOCAL)
                 if ha else (ROLE_GLOBAL, ROLE_PROXY, ROLE_LOCAL))
        for role in roles:
            child = _Child(role, self.spec)
            child.spawn()
            self.children[role] = child
            if ha and role == ROLE_GLOBAL:
                # boot order is the determinism of who is active: the
                # first global must hold the lease before the standby
                # (or the proxy's fatal-on-empty first refresh) looks
                self._wait_leader(child)
        self._sender = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sender.connect(("127.0.0.1", self.spec.udp_port))

    @staticmethod
    def _wait_leader(child: "_Child", timeout_s: float = 30.0) -> None:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if child.command("hastatus").get("ha", {}).get("is_leader"):
                return
            time.sleep(0.05)
        raise RuntimeError("active global never acquired the boot lease")

    def stop(self) -> None:
        if self._sender is not None:
            self._sender.close()
        for child in self.children.values():
            child.quit()

    def send(self, lines: List[bytes]) -> None:
        for line in lines:
            self._sender.send(line)

    def local_processed(self) -> int:
        return self.children[ROLE_LOCAL].command("processed")["v"]

    def global_imported(self) -> int:
        return self.children[ROLE_GLOBAL].command("imported")["v"]

    def set_sink_mode(self, mode: str) -> None:
        self._mode = mode
        self.children[ROLE_GLOBAL].command(f"mode {mode}")

    def flush_local(self) -> float:
        return self.children[ROLE_LOCAL].command(
            "flush", timeout_s=120.0)["emitted"]

    def flush_global(self) -> Tuple[float, dict]:
        ack = self.children[ROLE_GLOBAL].command("flush", timeout_s=120.0)
        sample = ack["sample"]
        sample["degradations"] = tuple(sample.get("degradations", ()))
        return ack["emitted"], sample

    def checkpoint(self, role: str) -> int:
        if role == ROLE_PROXY:
            return 0
        ack = self.children[role].command("ckpt", timeout_s=120.0)
        if not ack.get("ok"):
            raise RuntimeError(f"soak {role} child checkpoint failed: {ack}")
        return ack.get("attempts", 1)

    def counters(self, role: str) -> Dict[str, int]:
        if role == ROLE_PROXY:
            return {}
        return self.children[role].command("counters")["counters"]

    def kill_restart(self, role: str) -> None:
        self.children[role].kill()
        child = _Child(role, self.spec)
        child.spawn()
        self.children[role] = child
        if role == ROLE_GLOBAL and self._mode != MODE_OK:
            # the outage window outlives the process it was imposed on
            child.command(f"mode {self._mode}")

    # -- HA takeover (kill_forever scenarios) --------------------------------

    def ha_status(self) -> dict:
        child = self.children.get(ROLE_STANDBY) \
            or self.children[ROLE_GLOBAL]
        return child.command("hastatus").get("ha", {})

    def kill_forever(self) -> None:
        """Real SIGKILL of the active global, NO respawn: the standby
        child becomes the fleet's global for every later command."""
        self.children[ROLE_GLOBAL].kill()
        self.children[ROLE_GLOBAL] = self.children.pop(ROLE_STANDBY)

    def await_reroute(self, timeout_s: float = 15.0) -> bool:
        want = [f"http://127.0.0.1:{self.spec.standby_port}"]
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                members = self.children[ROLE_PROXY].command(
                    "ring").get("members")
            except Exception:
                members = None
            if members == want:
                return True
            time.sleep(0.1)
        return False


# -- the soak loop -----------------------------------------------------------

@dataclass
class SoakReport:
    scenario: SoakScenario
    ledger: SoakLedger
    monitor: SteadyStateMonitor
    results: List[GateResult] = field(default_factory=list)
    # per-interval conservation timeline from the armed LedgerAudit
    # (lint/ledger_audit.py) — settled only at terminal settlement
    ledger_timeline: List[dict] = field(default_factory=list)
    # per-interval live tensor storage timeline from the armed
    # BufferCensus (lint/buffer_census.py), judged at terminal
    # settlement
    buffer_timeline: List[dict] = field(default_factory=list)

    def vector(self) -> dict:
        return gate_vector(self.results)


def interval_traffic(scenario: SoakScenario,
                     idx: int) -> Tuple[List[bytes], int, int, int]:
    """The interval's deterministic production-shaped mix: global-only
    counters (the exact ledger), global-only timers (digest
    forwarding), local counters and a gauge. Returns
    ``(datagrams, global_counter_value, local_counter_value,
    distinct_global_series)``."""
    rng = random.Random(scenario.seed * 1000003 + idx)
    lines: List[bytes] = []
    names = set()
    sent_c = 0
    for i in range(scenario.counters_per_interval):
        name = f"soak.c{i % 8}"
        v = rng.randint(1, 5)
        lines.append(f"{name}:{v}|c|#veneurglobalonly".encode())
        names.add(name)
        sent_c += v
    for i in range(scenario.timers_per_interval):
        name = f"soak.t{i % 4}"
        lines.append(f"{name}:{rng.uniform(0.5, 20.0):.3f}|ms"
                     f"|#veneurglobalonly".encode())
        names.add(name)
    sent_l = 0
    for i in range(8):
        lines.append(f"soak.l{i % 4}:1|c".encode())
        sent_l += 1
    lines.append(b"soak.g:42|g")
    rng.shuffle(lines)
    return lines, sent_c, sent_l, len(names)


def _settle(read: Callable[[], int], target: int, timeout_s: float = 15.0,
            stable_s: float = 0.15) -> int:
    """Poll until ``read()`` reaches ``target`` AND holds still for
    ``stable_s`` (self-telemetry re-enters the stores asynchronously,
    so >= alone can fire early)."""
    deadline = time.monotonic() + timeout_s
    last, last_change = read(), time.monotonic()
    while time.monotonic() < deadline:
        cur = read()
        if cur != last:
            last, last_change = cur, time.monotonic()
        elif cur >= target and time.monotonic() - last_change >= stable_s:
            return cur
        time.sleep(0.01)
    return last


def _fold(ledger: SoakLedger, counters: Dict[str, int],
          crash: bool) -> None:
    ledger.shed += counters.get("shed", 0)
    ledger.quarantined += counters.get("quarantined", 0)
    ledger.ckpt_write_errors += counters.get("ckpt_write_errors", 0)
    ledger.spool_errors += counters.get("spool_errors", 0)
    ledger.dd_offered += counters.get("dd_offered", 0)
    ledger.dd_acked += counters.get("dd_acked", 0)
    ledger.dd_dropped += counters.get("dd_dropped", 0)
    pending = counters.get("dd_pending", 0)
    if crash:
        ledger.dd_crash_lost += pending
    else:
        ledger.dd_pending += pending


def _takeover(scenario: SoakScenario, fleet, ledger: SoakLedger,
              idx: int, sent_c: int,
              say: Callable[[str], None]) -> Tuple[float, dict]:
    """The kill_forever pivot. The interval's traffic is settled into
    the active but deliberately NOT flushed — that un-flushed tail is
    the bounded, accounted loss. Wait until replication is current
    (every PRIOR interval's flush reached the standby), measure the
    exact loss from the settled ledger, SIGKILL the active with no
    restart, time the standby's lease takeover, wait for the proxy to
    re-route, and take the first good flush from the survivor."""
    thr = scenario.thresholds
    # replication currency: the active flushed (and so replicated)
    # once per prior interval; insist the standby has received them
    # all, so the loss stays bounded by THIS interval's tail
    deadline = time.monotonic() + 10.0
    while (fleet.ha_status().get("receives_total", 0) < idx
           and time.monotonic() < deadline):
        time.sleep(0.05)
    # fold the active's monotone counters now — it dies next, and its
    # parked sink rows die with it (crash fold)
    _fold(ledger, fleet.counters(ROLE_GLOBAL), crash=True)
    # PEEK the local's shed/quarantine tallies without folding (the
    # end-of-run fold still owns them): accounted_lost must exclude
    # value the pipeline already accounted upstream of the active
    lc = fleet.counters(ROLE_LOCAL)
    ledger.accounted_lost = int(round(
        ledger.sent_global - ledger.emitted_global - ledger.shed
        - ledger.quarantined - lc.get("shed", 0)
        - lc.get("quarantined", 0)))
    ledger.takeover_loss_bound = sent_c
    t_kill = time.monotonic()
    fleet.kill_forever()
    say(f"interval {idx}: SIGKILL active global, no restart "
        f"(un-flushed tail value {ledger.accounted_lost})")
    deadline = time.monotonic() + thr.takeover_detect_max_s + 5.0
    st = fleet.ha_status()
    while not st.get("is_leader") and time.monotonic() < deadline:
        time.sleep(0.05)
        st = fleet.ha_status()
    if st.get("is_leader"):
        ledger.takeover_detect_s = time.monotonic() - t_kill
    ledger.promotions = 1 if st.get("promoted") else 0
    fleet.await_reroute()
    emitted, sample = fleet.flush_global()
    ledger.takeover_first_flush_s = time.monotonic() - t_kill
    say(f"interval {idx}: standby promoted in "
        f"{ledger.takeover_detect_s:.2f}s, first flush at "
        f"+{ledger.takeover_first_flush_s:.2f}s")
    return emitted, sample


def run_soak(scenario: SoakScenario, fleet,
             enforce_gates: bool = True,
             progress: Optional[Callable[[str], None]] = None
             ) -> SoakReport:
    """Drive the scenario over ``fleet`` (InProcessFleet or
    ProcessFleet): per interval — scheduled kills (checkpoint → fold →
    kill → restart), the sink outage mode, deterministic traffic,
    settled driven flushes local→global, one steady-state sample. Then
    terminal settlement (flush rounds until the pipeline drains), the
    end-of-run counter fold, and the gate vector. Raises
    :class:`~veneur_tpu_torch.soak.gates.SoakGateError` on any violated gate
    unless ``enforce_gates=False``."""
    say = progress or (lambda s: log.info("%s", s))
    monitor = SteadyStateMonitor(scenario.thresholds.warmup_intervals)
    ledger = SoakLedger()
    # the ledger audit rides every soak run: per-interval timeline
    # snapshots (un-asserted — requeued state is legitimately in flight
    # mid-chaos), one SETTLED check after terminal settlement where the
    # cumulative identity is exact
    from veneur_tpu_torch.lint.buffer_census import BufferCensus
    from veneur_tpu_torch.lint.ledger_audit import for_soak_ledger

    audit = for_soak_ledger(ledger)
    # the buffer census rides next to it: live tensor storage on the
    # fleet's device, armed once warmup allocation (store planes, the
    # first flushes' planes) is done, sampled every interval, and judged
    # at terminal settlement as the device_buffers_bounded gate. With a
    # ProcessFleet the orchestrator owns no tensors of the fleet, so the gate
    # passes vacuously; the in-process soak carries the teeth
    census = BufferCensus(
        name="soak-device-buffers",
        tolerance_bytes=scenario.thresholds.device_buffer_growth_max_bytes,
        device=fleet.spec.device)
    generation = 0  # restarts of the GLOBAL role (compile-drift folds)
    fleet.start()
    try:
        for idx in range(scenario.intervals):
            takeover = (scenario.kind == KIND_KILL_FOREVER
                        and ROLE_GLOBAL in scenario.kills_at(idx))
            if not takeover:
                for role in scenario.kills_at(idx):
                    attempts = fleet.checkpoint(role)
                    ledger.ckpt_retries += max(0, attempts - 1)
                    _fold(ledger, fleet.counters(role), crash=True)
                    fleet.kill_restart(role)
                    ledger.restarts[role] = \
                        ledger.restarts.get(role, 0) + 1
                    if role == ROLE_GLOBAL:
                        generation += 1
                    say(f"interval {idx}: killed+restarted {role} "
                        f"(checkpoint attempts={attempts})")
            mode = scenario.sink_mode(idx)
            fleet.set_sink_mode(mode)
            lines, sent_c, sent_l, n_series = interval_traffic(
                scenario, idx)
            p0 = fleet.local_processed()
            fleet.send(lines)
            ledger.sent_global += sent_c
            ledger.sent_local += sent_l
            _settle(fleet.local_processed, p0 + len(lines))
            i0 = fleet.global_imported()
            ledger.emitted_local += fleet.flush_local()
            _settle(fleet.global_imported, i0 + n_series)
            if takeover:
                emitted, sample = _takeover(scenario, fleet, ledger,
                                            idx, sent_c, say)
                generation += 1  # the standby is a different process
            else:
                emitted, sample = fleet.flush_global()
            ledger.emitted_global += emitted
            audit.snapshot(label=f"interval-{idx}", settled=False)
            if not census.armed and \
                    idx + 1 >= scenario.thresholds.warmup_intervals:
                census.arm(label=f"post-warmup-{idx}")
            else:
                census.sample(label=f"interval-{idx}",
                              programs=("flush_local", "flush_global"))
            monitor.add(IntervalSample(idx=idx, generation=generation,
                                       **sample))
            if mode != MODE_OK or scenario.kills_at(idx):
                say(f"interval {idx}: mode={mode} "
                    f"emitted={emitted:.0f}/{ledger.sent_global}")
        # terminal settlement: clean egress, then flush rounds until
        # nothing new emits and the requeue is drained — late, never
        # lost, and the ledger closes exactly
        fleet.set_sink_mode(MODE_OK)
        for _ in range(12):
            moved = fleet.flush_local()
            time.sleep(0.2)
            emitted, _sample = fleet.flush_global()
            ledger.emitted_local += moved
            ledger.emitted_global += emitted
            if (not moved and not emitted
                    and fleet.counters(ROLE_GLOBAL).get("dd_pending", 0)
                    == 0):
                break
        for role in (ROLE_GLOBAL, ROLE_LOCAL):
            _fold(ledger, fleet.counters(role), crash=False)
        audit.snapshot(label="terminal-settlement", settled=True)
        census.settle(label="terminal-settlement")
    finally:
        fleet.stop()
    ledger.device_buffer_growth_bytes = census.growth_bytes()
    ledger.buffer_census_ok = census.settled_ok()
    if census.violations:
        ledger.buffer_census_detail = str(census.violations[0])
    report = SoakReport(scenario=scenario, ledger=ledger, monitor=monitor)
    report.results = run_gates(scenario, monitor, ledger)
    report.ledger_timeline = audit.timeline()
    report.buffer_timeline = census.timeline()
    if enforce_gates:
        # gates first (their failure message carries the scenario's
        # exact repro call); the audit/census twins are the
        # independent backstops
        enforce(report.results, scenario)
        audit.assert_clean()
        census.assert_clean()
    return report
