"""Live debug endpoints: inspect a RUNNING server, not a shutdown dump.

Port of ``veneur_tpu/debug.py`` (the reference mounts net/http/pprof on
every mux, http.go:43-48, proxy.go:383-388):

    GET /debug/threads              every thread's stack (goroutine dump)
    GET /debug/profile?seconds=N    a statistical profile over ALL threads
                                    (samples sys._current_frames), as
                                    collapsed-stack lines, hottest first
    GET /debug/vars                 JSON of the store's, the lanes' and
                                    the queues' depths and counters
                                    (expvar's role), the overload ladder,
                                    the mesh, the handoff and the obs
                                    plane's timeline, kernel counters,
                                    hop log and fleet pulls
    GET /debug/flush-timeline       the last N flush intervals as stage
                                    trees (obs/; a server with
                                    obs_enabled; 404 without)
    GET /debug/xprof?seconds=N      an on-demand torch.profiler capture
                                    (CPU and CUDA, a Chrome trace on
                                    local disk), the device kernels
                                    under the scopes of obs/kernels.py;
                                    one at a time, clamped to 30 s
    GET /debug/fleet?n=K            the fleet view: each peer's last
                                    pulled timeline summary, kept and
                                    served stale when a pull fails
                                    (obs/fleet.py)
    GET /debug/trace?id=T           trace T's hops across this server
                                    and its peers, in wall order, with
                                    hop_coverage_ratio; 404 unknown

The server's ops server mounts the first five, and the last two with
its fleet aggregator (``obs_enabled``); the proxy mounts the first three
(and its own ``/debug/flush-timeline``), its ``/debug/vars`` body its
own ``vars()`` beside the time and the thread count.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import traceback
from collections import Counter
from typing import Dict

from veneur_tpu_torch.obs import kernels as obs_kernels

MAX_PROFILE_SECONDS = 60.0
PROFILE_HZ = 200.0

# one profile at a time: overlapping samplers would double the overhead
# and interleave their results
_profile_lock = threading.Lock()


def dump_threads() -> str:
    """Every live thread's stack, newest frame last."""
    names = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        t = names.get(ident)
        name = t.name if t else "?"
        daemon = " daemon" if t is not None and t.daemon else ""
        out.append(f"--- thread {ident} [{name}]{daemon} ---")
        out.append("".join(traceback.format_stack(frame)).rstrip())
        out.append("")
    return "\n".join(out)


def sample_profile(seconds: float, hz: float = PROFILE_HZ) -> str:
    """A statistical whole-process profile: every thread's stack polled
    at ``hz`` for ``seconds``, identical stacks counted, as
    ``frame;frame;frame <count>`` lines (collapsed-stack format). The
    sampler leaves itself out: its own thread, and any thread inside
    ``sample_profile`` (a second request waiting on the lock)."""
    seconds = max(0.1, min(float(seconds), MAX_PROFILE_SECONDS))
    interval = 1.0 / hz
    stacks: Counter = Counter()
    me = threading.get_ident()
    my_code = sample_profile.__code__
    samples = 0
    if not _profile_lock.acquire(timeout=1.0):
        return "another profile is already running\n"
    try:
        deadline = time.perf_counter() + seconds
        while time.perf_counter() < deadline:
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                parts = []
                f = frame
                sampler = False
                while f is not None:
                    code = f.f_code
                    if code is my_code:
                        sampler = True
                        break
                    parts.append(f"{code.co_filename.rsplit('/', 1)[-1]}"
                                 f":{code.co_name}:{f.f_lineno}")
                    f = f.f_back
                if not sampler:
                    stacks[";".join(reversed(parts))] += 1
            samples += 1
            time.sleep(interval)
    finally:
        _profile_lock.release()
    head = (f"# {samples} sampling rounds over {seconds:.1f}s "
            f"at {hz:.0f} Hz; one line per distinct stack\n")
    body = "\n".join(f"{stack} {n}" for stack, n in stacks.most_common())
    return head + body + "\n"


def _group_depths(store) -> Dict[str, Dict[str, int]]:
    out = {}
    for attr in store._GEN_GROUPS:
        g = getattr(store, attr)
        d = {"series": len(g)}
        for staged, key in (("_fill", "staged_samples"),
                            ("_imp_fill", "staged_imports"),
                            ("_imp_stat_fill", "staged_import_stats")):
            v = getattr(g, staged, None)
            if isinstance(v, int):
                d[key] = v
        cap = getattr(g, "capacity", None)
        if isinstance(cap, int):
            d["capacity"] = cap
        out[attr] = d
    return out


def collect_vars(server) -> dict:
    """The /debug/vars body of a port Server (expvar's role)."""
    store = server.store
    out: dict = {"time": time.time(),
                 "threads": len(threading.enumerate()),
                 "store": {"processed_this_interval": store.processed,
                           "imported_this_interval": store.imported,
                           "groups": _group_depths(store)},
                 "packet_errors": server.packet_errors,
                 "packet_drops": server.packet_drops,
                 "spans_dropped": server.spans_dropped}
    if server.ingest_fleets:
        out["ingest_fleet"] = [f.snapshot() for f in server.ingest_fleets]
        lanes = [lane for f in server.ingest_fleets for lane in f.lanes]
        pkts = sum(lane.packets for lane in lanes)
        calls = sum(lane._receiver.syscalls for lane in lanes)
        out["udp_readers"] = {
            "packets": pkts, "syscalls": calls,
            "recvmmsg": all(lane.using_recvmmsg for lane in lanes),
            "syscalls_per_packet": (round(calls / pkts, 4) if pkts
                                    else None)}
    if server._span_lanes:
        out["span_lanes"] = [{"sink": lane.sink.name,
                              "depth": lane.queue.qsize()}
                             for lane in server._span_lanes]
    if server.import_server is not None:
        out["grpc_import"] = {"received": server.import_server.received,
                              "errors": server.import_server.import_errors}
    if server.native_import_server is not None:
        nimp = server.native_import_server
        out["native_import"] = {"received": nimp.received,
                                "errors": nimp.import_errors}
    pool = getattr(server.ops_server, "import_pool", None)
    if pool is not None:
        out["http_import"] = {"queue_depth": pool.qsize(),
                              "merged_batches": pool.merged_batches,
                              "shed_batches": pool.shed}
    # the overload ladder: admission level and sheds, quarantines by
    # reason, spills by group, the compute breaker
    section = dict(server.overload.snapshot())
    section["quarantined"] = store.quarantine.snapshot()
    section["compute"] = store.compute.snapshot()
    spilled = {attr: getattr(store, attr).spilled
               for attr in store._GEN_GROUPS
               if getattr(store, attr).spilled}
    if spilled:
        section["spilled_this_interval"] = spilled
    section["max_series"] = store.max_series
    out["overload"] = section
    out["degraded"] = server.degradation()
    if store.mesh is not None:
        from veneur_tpu_torch.fleet import fleet_snapshot

        out["mesh"] = fleet_snapshot(store)
    if server.handoff_manager is not None:
        out["handoff"] = server.handoff_manager.snapshot()
    if server.standby_manager is not None:
        out["standby"] = server.standby_manager.snapshot()
    # the obs plane: the kernel scopes' dispatches and the CUDA launch
    # counters run whether or not obs_enabled; the timeline with it
    obs = {"kernels": obs_kernels.snapshot()}
    if server.obs_timeline is not None:
        obs["timeline"] = server.obs_timeline.snapshot()
    if server.obs_hops is not None:
        obs["hops"] = server.obs_hops.snapshot()
    if server.fleet_aggregator is not None:
        obs["fleet"] = server.fleet_aggregator.snapshot()
    out["obs"] = obs
    return out


def mount(add_route, server=None, extra_vars=None) -> None:
    """Register the /debug/* routes through ``add_route(path, fn)``.

    Handlers take the parsed query dict and return ``(status, body,
    content_type[, headers])``; the profile's fourth element sets
    ``Content-Disposition`` so its output drops into flamegraph tools.
    ``server`` (a port Server) adds ``/debug/vars``,
    ``/debug/flush-timeline`` and ``/debug/xprof``, and with its fleet
    aggregator ``/debug/fleet`` and ``/debug/trace``; without one
    ``/debug/vars`` answers the time, the thread count and
    ``extra_vars()``."""

    def threads(query):
        return 200, dump_threads(), "text/plain"

    def profile(query):
        try:
            seconds = float(query.get("seconds", "5"))
        except ValueError:
            return 400, "seconds must be a number", "text/plain"
        return (200, sample_profile(seconds), "text/plain",
                {"Content-Disposition":
                 'attachment; filename="veneur-profile.collapsed"'})

    def dvars(query):
        data = (collect_vars(server) if server is not None
                else {"time": time.time(),
                      "threads": len(threading.enumerate())})
        if extra_vars is not None:
            data.update(extra_vars())
        return 200, json.dumps(data, default=str), "application/json"

    def flush_timeline(query):
        if server.obs_timeline is None:
            return (404, "flush timeline disabled (obs_enabled: false)",
                    "text/plain")
        return server.obs_timeline.handler(query)

    def xprof(query):
        try:
            seconds = float(query.get("seconds", "2"))
        except ValueError:
            return 400, "seconds must be a number", "text/plain"
        return obs_kernels.capture_xprof(seconds)

    add_route("/debug/threads", threads)
    add_route("/debug/profile", profile)
    add_route("/debug/vars", dvars)
    if server is not None:
        add_route("/debug/flush-timeline", flush_timeline)
        add_route("/debug/xprof", xprof)
        agg = server.fleet_aggregator
        if agg is not None:
            # the fleet trace plane: the peer view and the stitched trace
            add_route("/debug/fleet", agg.fleet_route)
            add_route("/debug/trace", agg.trace_route)
