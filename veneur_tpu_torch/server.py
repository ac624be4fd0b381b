"""Server lifecycle: config -> listeners -> store -> flush loop.

A slim port of ``veneur_tpu/server.py`` (after
``veneur/server.go``): DogStatsD datagrams and SSF spans reach the dense
:class:`MetricStore`, and a ticker flushes the store to the metric sinks
every interval. The store runs on ``cuda`` unless ``device="cpu"`` is
passed.

Each statsd ``udp://`` listener takes the first rung of the reference's
ladder that comes up: the ingest-lane fleet (``ingest/``, the default),
then, with ``ingest_lanes: -1``, the C++ reader pool feeding
``MetricStore.process_batch``, then, with ``native_ingest: false`` too
(or without a compiler), the Python readers and the per-line parser. A
``tcp://`` listener (TLS with ``tls_certificate`` and ``tls_key``,
client certificates required with ``tls_authority_certificate``) takes
the C++ listener (``native.NativeTLSReader``, pumped into
``process_batch``) with ``native_ingest`` on an IPv4 address when the
library and, for TLS, the runtime's libssl load; else the Python one
(``networking.start_statsd``). ``listeners`` names each rung.
Event and service-check lines (the native rungs hand them back raw) go
through :meth:`Server.handle_metric_packet`: events collect in the
:class:`EventWorker` until the flush hands them to every metric sink's
``flush_other_samples``; service checks become status rows.

SSF (server.go:722-899): an ``ssf_listen_addresses`` ``udp://`` address
runs the C++ SSF reader pool (with ``native_ingest``), whose pump feeds
the embedded samples to ``process_batch`` and the spans, in batches, to
the span channel; otherwise Python readers decode each datagram. A
``unix://`` or ``tcp://`` address takes framed spans. Span workers drain
the channel into one bounded lane a span sink; the metric-extraction
sink, always last, turns the spans' samples and indicator timers into
store samples. A full channel sheds spans and counts them
(``spans_dropped``).

Overload (``overload.py``): the server builds an
:class:`~veneur_tpu_torch.overload.OverloadController` from its config
and attaches it, as the JAX server does. Its pressure (span channel,
span lanes, ingest-fleet backlogs, group occupancy) freezes first-sight
series at the low watermark, sheds spans at the high one (``admit_span``
before the channel; ``admit_packet("ssf")`` on the Python SSF readers)
and statsd datagrams at the hard one (the lanes at the socket,
``admit_packet("statsd")`` on the Python readers); every shed lands in
``overload.shed``. The store caps each group at ``max_series`` and the
joined tags at ``max_tag_length`` on every path.

Each flush (``flusher.py``) is columnar, pipelined and streaming by
default (``flush_columnar``, ``flush_pipeline_depth``,
``flush_streaming``): the metric sinks, then the ``plugins``, get the
store's rows; ``sinks/factory.py`` ``create_sinks`` builds the
configured sinks, span sinks and plugins, which ``cli/server.py`` hands
over as ``config_sinks``: :meth:`Server.reload` (the CLI's SIGHUP)
rebuilds those from the new file, while the sinks and plugins passed as
``metric_sinks``, ``span_sinks`` and ``plugins`` survive it. A reload
takes the interval, percentiles, aggregates, tags and the forwarder,
and keeps every socket and the store. The span sinks given run beside
the metric-extraction sink.

Fault injection (``resilience/faults.py``): with ``fault_injection_rate``
above 0, each consumer builds an injector of its own from the same
keys, where the JAX package builds one: the forwarder, the factory's
Datadog and SignalFx sinks, the handoff's watcher (churn kinds), and
here ``ingest_injector`` (``truncate``, ``burst``: each datagram of the
per-datagram Python path, :meth:`Server.handle_packet`; the ingest
lanes and the C++ pools take no ingest kind) and ``soak_injector``
(``disk_full``, ``deadline_pressure``).

Crash-safe state: with ``checkpoint_path`` set a background thread
checkpoints the store every ``checkpoint_interval`` (``persist/``);
:meth:`Server.start` first merges a valid checkpoint left by a killed
process (before any listener ingests), and a flush truncates it. A
digest flush whose kernel fails runs the compute ladder
(``resilience/compute.py``); ``degradation()`` names an open compute
breaker and a failing checkpoint write, and ``GET /healthcheck/ready``
carries both. :meth:`Server.crash_stop` is the in-process SIGKILL.

Global aggregation: with ``forward_address`` set the server is a local
and forwards its sketch state there after each flush, over HTTP or, for
``native://host:port``, as MetricList frames over framed TCP, or with
``forward_use_grpc`` as the same frames over gRPC (digests packed on the
device); with ``http_address`` set it serves ``POST /import`` (a global
merges what its locals forward) beside ``/healthcheck`` and
``/version``, with ``native_import_address`` the framed-TCP import
(``forward/native_transport.py``) and with ``grpc_address`` the gRPC
import (``forward/grpc_forward.py``: ``server.import_server``), on a
dense, slab, tiered or mesh store alike; the two imports count on
their objects (``received``, ``import_errors``), and ``GET /debug/vars``
shows them.

Self-telemetry (``obs/``, ``trace/``, ``debug.py``): ``trace_client``
records each flush's span into the server's own span channel, so its
``veneur.*`` self-metrics flush with the next interval; with
``obs_enabled`` (the default) ``obs_timeline`` keeps the last
``obs_timeline_intervals`` flush stage trees (``GET
/debug/flush-timeline``) and the ingest lanes time their stages. The
ops server mounts the debug endpoints (``/debug/threads``,
``/debug/profile``, ``/debug/vars``, ``/debug/flush-timeline``,
``/debug/xprof``).

The fleet trace plane (``obs/tracectx.py``, ``obs/fleet.py``): with
``obs_enabled`` the server keeps ``obs_hops``, the hop log its HTTP and
gRPC imports, its handoff receiver and its standby record the
``X-Veneur-Trace`` hops they merge into, and ``fleet_aggregator``, which
serves ``GET /debug/fleet`` and ``GET /debug/trace?id=...`` on the ops
server, pulling the peers of ``fleet_peers`` (a CSV or ``file://``;
``handoff_peers`` without it).

Crash reports (``crash.py``): every thread the server starts reports an
uncaught exception to ``sentry_dsn`` (when set) before it rethrows, and
a process-wide ``threading.excepthook`` covers the others; with
``enable_profiling`` cProfile runs from start to shutdown and writes
``veneur-profile.pstats``.

The global tier as a fleet (``fleet/``): with ``handoff_enabled`` a
global watches its fleet's membership and hands the key ranges a resize
moves to their new owner's ``POST /handoff`` (``handoff_manager``;
``/handoff-status`` answers the sender's completion probe); a spool of a
crashed life re-sends or re-merges at :meth:`Server.start`. With
``standby_peers`` the active replicates each flush to its standbys'
``POST /replicate``, and with ``lease_path`` the instances elect the
active through a lease (``standby_manager``, ``lease_elector``; ``GET
/ha-status``): a standby that wins the lease promotes its shadow into
the live store. :meth:`Server.shutdown` quiesces a handoff in flight and
releases the lease before its final flush; :meth:`Server.crash_stop`
releases nothing, so a standby waits out the lease's ttl.
"""

from __future__ import annotations

import logging
import math
import queue
import threading
import time
from typing import List, Optional, Tuple

from veneur_tpu_torch import crash, flusher, native, networking, overload
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.core.store import MetricStore
from veneur_tpu_torch.forward import configure_forwarding
from veneur_tpu_torch.forward.native_transport import NativeImportServer
from veneur_tpu_torch.httpserv import OpsServer
from veneur_tpu_torch.ingest import IngestFleet, ShardedCounter
from veneur_tpu_torch.obs import FlushTimeline, HopLog
from veneur_tpu_torch.obs.fleet import FleetAggregator
from veneur_tpu_torch.ops import tdigest_cuda
from veneur_tpu_torch.persist import Checkpointer
from veneur_tpu_torch.persist import format as ckpt_format
from veneur_tpu_torch.protocol import ssf, wire
from veneur_tpu_torch.protocol.addr import resolve_addr
from veneur_tpu_torch.resilience import compute as rcompute
from veneur_tpu_torch.resilience import faults as rfaults
from veneur_tpu_torch.samplers import parser as p
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates
from veneur_tpu_torch.sinks.base import MetricSink, SpanSink
from veneur_tpu_torch.sinks.blackhole import BlackholeMetricSink
from veneur_tpu_torch.sinks.ssfmetrics import MetricExtractionSink
from veneur_tpu_torch.trace import new_channel_client

log = logging.getLogger("veneur.server")


class EventWorker:
    """Collects events (as SSFSamples) until the flush (worker.go:439-485)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._samples: List[ssf.SSFSample] = []

    def __len__(self) -> int:
        """Events waiting for the next flush."""
        with self._lock:
            return len(self._samples)

    def add(self, sample: ssf.SSFSample):
        with self._lock:
            self._samples.append(sample)

    def flush(self) -> List[ssf.SSFSample]:
        with self._lock:
            out, self._samples = self._samples, []
        return out


class _SinkIngestor:
    """One span sink's bounded ingest lane: a thread drains a bounded
    queue into ``sink.ingest``, so a hung sink wedges only its own lane
    (the reference's goroutine-a-span with a 9 s timeout,
    worker.go:541-590): its queue fills and further spans drop, counted
    in ``ingest_timeouts``, while every other sink keeps draining. The
    thread exits once ``stop`` is set and its queue is empty."""

    TIMEOUT = 9.0  # worker.go:523

    def __init__(self, sink: SpanSink, stop: threading.Event,
                 capacity: int = 4096):
        self.sink = sink
        self.stop = stop
        self.queue: "queue.Queue" = queue.Queue(capacity)
        self.ingest_errors = 0
        self.ingest_timeouts = 0
        # the interval's deepest queue (veneur.server.span_lane.depth_hwm,
        # read and reset by the flush)
        self.depth_hwm = 0
        self._drop_lock = threading.Lock()  # offer() runs on every worker
        self._flush_thread: Optional[threading.Thread] = None
        self.thread = threading.Thread(
            target=self._work, name=f"span-ingest-{sink.name}", daemon=True)
        self.thread.start()

    def offer(self, item, n: int = 1) -> None:
        """Queue a span, or a native batch of ``n`` spans as one item."""
        try:
            self.queue.put_nowait(item)
        except queue.Full:
            with self._drop_lock:
                self.ingest_timeouts += n
            return
        d = self.queue.qsize()
        if d > self.depth_hwm:
            self.depth_hwm = d

    def _ingest(self, span) -> None:
        try:
            self.sink.ingest(span)
        except Exception:
            self.ingest_errors += 1
            log.exception("span sink %s ingest failed", self.sink.name)

    def _work(self):
        while True:
            try:
                item = self.queue.get(timeout=0.5)
            except queue.Empty:
                if self.stop.is_set():
                    return
                continue
            try:
                for span in (item if type(item) is list else (item,)):
                    self._ingest(span)
            finally:
                self.queue.task_done()

    def drain(self, timeout: float = TIMEOUT) -> bool:
        """Wait (bounded) until every offered span has been ingested;
        False if the lane is still wedged."""
        deadline = time.monotonic() + timeout
        while self.queue.unfinished_tasks:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)
        return True

    def flush_sink(self, timeout: float = TIMEOUT) -> None:
        """Run ``sink.flush()`` on a thread of its own, joined up to
        ``timeout``: a sink whose flush blocks pins only itself, and the
        next interval skips it while its last flush still runs."""
        if self._flush_thread is not None and self._flush_thread.is_alive():
            log.warning("span sink %s previous flush still running; "
                        "skipping", self.sink.name)
            return

        def run():
            try:
                self.sink.flush()
            except Exception:
                log.exception("span sink %s flush failed", self.sink.name)

        t = threading.Thread(target=run, name=f"span-flush-{self.sink.name}",
                             daemon=True)
        self._flush_thread = t
        t.start()
        t.join(timeout)
        if t.is_alive():
            log.warning("span sink %s flush exceeded %.0fs; continuing "
                        "without it", self.sink.name, timeout)


def make_span_lanes(sinks: List[SpanSink],
                    stop: threading.Event) -> List[_SinkIngestor]:
    """One lane a sink, shared by every SpanWorker: a sink has one ingest
    thread, and the flush barrier covers every worker's spans."""
    return [_SinkIngestor(s, stop) for s in sinks]


class SpanWorker:
    """Drains the span channel into every span sink's lane
    (worker.go:487-592). It exits once ``stop`` is set and the channel
    is empty, so spans accepted before a shutdown still reach the
    sinks."""

    def __init__(self, span_chan: "queue.Queue", stop: threading.Event,
                 lanes: List[_SinkIngestor]):
        self.chan = span_chan
        self.stop = stop
        self.lanes = lanes
        self.ingested = 0

    def work(self):
        while True:
            try:
                item = self.chan.get(timeout=0.5)
            except queue.Empty:
                if self.stop.is_set():
                    return
                continue
            # a native batch rides every hop as one item
            n = len(item) if type(item) is list else 1
            self.ingested += n
            for lane in self.lanes:
                lane.offer(item, n)

    def flush(self):
        for lane in self.lanes:
            # the flush barrier: in-flight spans get a bounded chance to
            # land before the sink flushes; a wedged lane is skipped
            if not lane.drain():
                log.warning("span sink %s still wedged at flush; %d drops "
                            "so far", lane.sink.name, lane.ingest_timeouts)
            lane.flush_sink()


def calculate_tick_delay(interval: float, now: float) -> float:
    """Seconds until the next interval boundary (server.go:1163-1177)."""
    return interval - math.fmod(now, interval)


class Server:
    def __init__(self, config: Config,
                 metric_sinks: Optional[List[MetricSink]] = None,
                 span_sinks: Optional[List[SpanSink]] = None,
                 device=None, plugins: Optional[list] = None, mesh=None,
                 config_sinks: Optional[tuple] = None):
        self.config = config
        self.interval = config.interval_seconds
        self.hostname = config.hostname
        self.tags = list(config.tags)
        self.tags_exclude = set(config.tags_exclude)
        self.histogram_percentiles = list(config.percentiles)
        self.histogram_aggregates = HistogramAggregates.from_names(
            config.aggregates)
        self.overload = overload.from_config(config)
        # a global with mesh_enabled (Config refuses it on a local)
        # shards its store over the fleet mesh (core/mesh_store.py): the
        # visible cards' by default, or the caller's ``mesh`` (a
        # ShardMesh; one card repeated shapes a wider mesh on it)
        if mesh is not None and not config.mesh_enabled:
            raise ValueError("a mesh was given, but mesh_enabled is off")
        if config.mesh_enabled and mesh is None:
            from veneur_tpu_torch.fleet import build_mesh

            mesh = build_mesh(config, None if device is None
                              else [device])
        self.store = MetricStore(
            initial_capacity=config.store_initial_capacity,
            chunk=config.store_chunk,
            compression=config.tdigest_compression,
            hll_precision=config.hll_precision,
            topk_depth=config.topk_depth, topk_width=config.topk_width,
            topk_k=config.topk_k, max_series=config.max_series,
            max_tag_length=config.max_tag_length, overload=self.overload,
            flush_pipeline_depth=config.flush_pipeline_depth,
            compute=rcompute.from_config(config),
            digest_storage=config.digest_storage,
            digest_dtype=config.digest_dtype, slab_rows=config.slab_rows,
            tier_pool_centroids=config.tier_pool_centroids,
            tier_promote_samples=config.tier_promote_samples,
            tier_promote_intervals=config.tier_promote_intervals,
            tier_demote_intervals=config.tier_demote_intervals,
            device=device, mesh=mesh)
        # the seeded ingest faults (truncate, burst) on the per-datagram
        # path and the host-resource ones (disk_full on the checkpoint
        # commit, deadline_pressure on the flush budget), each injector
        # armed only when a kind of its own is configured
        self.ingest_injector = rfaults.armed_for(config, rfaults.INGEST_KINDS)
        self.soak_injector = rfaults.armed_for(config, rfaults.SOAK_KINDS)
        # config-driven sinks and plugins (``config_sinks``, what
        # sinks/factory.py create_sinks built from ``config``) rebuild at
        # a reload; the injected ones survive it. Neither given: a
        # blackhole
        cfg_metric_sinks, cfg_span_sinks, cfg_plugins = (
            config_sinks or ([], [], []))
        if metric_sinks is None and config_sinks is None:
            metric_sinks = [BlackholeMetricSink()]
        self._injected_metric_sinks = list(metric_sinks or [])
        self._injected_plugins = list(plugins or [])
        self.metric_sinks = self._injected_metric_sinks + list(
            cfg_metric_sinks)
        # archival plugins, flushed after the metric sinks
        self.plugins = self._injected_plugins + list(cfg_plugins)
        # the config-driven sinks a reload replaced: closed at the next
        # reload or at shutdown, once their in-flight flushes finished
        self._retired_sinks: List[MetricSink] = []
        self._reload_lock = threading.Lock()
        self.event_worker = EventWorker()
        self.span_chan: "queue.Queue" = queue.Queue(
            config.span_channel_capacity)
        # the pressure sources (span channel, lanes, groups) are read
        # through the server
        self.overload.attach(self)
        # the extraction sink is how SSF samples reach the store
        # (server.go:282-290)
        self.extraction_sink = MetricExtractionSink(
            self.store.process_metric, config.indicator_span_timer_name)
        self.span_sinks: List[SpanSink] = (list(span_sinks or [])
                                           + list(cfg_span_sinks)
                                           + [self.extraction_sink])
        # per-line tallies, added to from reader threads without a lock;
        # the properties below add what the native rungs count
        self._packet_errors = ShardedCounter()
        self._quarantined = ShardedCounter()
        self._spans_dropped = ShardedCounter()
        self._last_span_drop_log = 0.0
        # interval span flushes skipped: the previous one still ran
        self.span_flush_skipped = 0
        # flushes whose egress deadline expired (a sink ignored its
        # budget) and when the last warning about one was logged
        self.flush_overruns = 0
        self._last_overrun_warn = 0.0
        # datagrams the C++ reader pools dropped (their pump fell behind)
        self.packet_drops = 0
        # self-telemetry: a channel trace client into our own span
        # channel, so the flush span's self-metrics re-enter the pipeline
        # (server.go:196-202); with obs_enabled the timeline ring behind
        # /debug/flush-timeline (None: the flusher allocates no recorder)
        self.trace_client = new_channel_client(self.span_chan)
        self.obs_timeline = None
        # the fleet trace plane: the hops this server receives (the
        # imports, the handoff and the replication) and the /debug/fleet
        # and /debug/trace view; with no peer source the aggregator still
        # serves this server's own entries
        self.obs_hops: Optional[HopLog] = None
        self.fleet_aggregator: Optional[FleetAggregator] = None
        if config.obs_enabled:
            self.obs_timeline = FlushTimeline(config.obs_timeline_intervals)
            self.obs_hops = HopLog()
            self.fleet_aggregator = FleetAggregator(
                self_addr=config.handoff_self,
                watcher=self._build_fleet_watcher(config),
                timeline=self.obs_timeline, hop_log=self.obs_hops,
                pull_timeout=config.fleet_pull_timeout_seconds,
                pull_interval=config.fleet_pull_interval_seconds)
        # the oldest ingest stamp the current flush drains (taken at its
        # swap; flusher.py)
        self._interval_oldest_ingest_ns: Optional[int] = None
        # the span-flush worker (flusher.SpanFlushWorker), built at the
        # first flush of a started server, stopped with the servers
        self.span_flush_worker = None
        self._span_flush_closed = False
        self.last_flush_time = 0.0
        self.last_flush_ok = True
        # readiness measures flush staleness from here until a flush lands
        self._started_wall = time.time()
        # crash-safe state (persist/): the interval checkpoint
        self.checkpointer: Optional[Checkpointer] = None
        if config.checkpoint_path:
            write_fn = None
            if self.soak_injector is not None:
                write_fn = self.soak_injector.wrap_write(
                    ckpt_format.write_atomic, "checkpoint.write")
            self.checkpointer = Checkpointer(
                self.store, config.checkpoint_path,
                interval_s=(config.checkpoint_interval_seconds
                            or self.interval / 4.0),
                max_age_s=config.checkpoint_max_age_intervals * self.interval,
                hostname=self.hostname, write_fn=write_fn)
        # the global tier as a fleet: elastic resharding (both roles),
        # warm-standby replication and the leadership lease; each needs a
        # global, as Config checks
        self.handoff_manager = None
        self.standby_manager = None
        self.lease_elector = None
        if config.handoff_enabled:
            from veneur_tpu_torch.fleet.handoff import HandoffManager

            self.handoff_manager = HandoffManager.for_server(self)
        if config.standby_peers or config.lease_path:
            from veneur_tpu_torch.fleet.standby import StandbyManager

            self.standby_manager = StandbyManager.for_server(self)
            if config.lease_path:
                from veneur_tpu_torch.discovery import (
                    LeaseElector, lease_backend_from_url)

                self.lease_elector = LeaseElector(
                    lease_backend_from_url(config.lease_path),
                    holder=config.handoff_self or config.http_address,
                    ttl=config.lease_ttl_seconds,
                    renew_interval=config.lease_renew_interval_seconds,
                    on_promote=self.standby_manager.on_promote,
                    on_demote=self.standby_manager.on_demote)
            else:
                # no election: replicate unconditionally
                self.standby_manager.is_leader = True
        # global aggregation (start() wires them from the config)
        self.forward_fn = None
        self.forwarder = None
        self.forward_thread: Optional[threading.Thread] = None
        self.last_forward_ok: Optional[bool] = None
        self.forward_errors = 0
        self.ops_server: Optional[OpsServer] = None
        # the framed-TCP import (native_import_address) and the gRPC one
        # (grpc_address)
        self.native_import_server: Optional[NativeImportServer] = None
        self.import_server = None
        self.imported_metrics = 0
        self.import_errors = 0
        self.statsd_addrs: List[tuple] = []
        # (listen address, rung: "lanes", "native" or "python", bound
        # address), one per statsd listener
        self.listeners: List[Tuple[str, str, tuple]] = []
        # bound SSF addresses ((host, port), or a unix socket's path) and
        # (listen address, rung: "native", "python" or "stream", bound)
        self.ssf_addrs: list = []
        self.ssf_listeners: List[Tuple[str, str, object]] = []
        self.ingest_fleets: List[IngestFleet] = []
        self.native_readers: list = []
        self.native_ssf_readers: List[native.NativeSSFReader] = []
        # SSF datagrams the C++ pool shed because its batch was full
        self.native_ssf_drops = 0
        self._native_pumps: List[threading.Thread] = []
        self._span_workers: List[SpanWorker] = []
        self._span_threads: List[threading.Thread] = []
        self._span_lanes: List[_SinkIngestor] = []
        self._stop = threading.Event()
        # the span lanes outlive the span workers at shutdown
        self._span_stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._counts_lock = threading.Lock()
        # crash reports and profiling (start() wires them)
        self._sentry: Optional[crash.SentryReporter] = None
        self._guard = lambda fn: fn
        self._profiler = None
        # the Python TCP rung's TLS context; a bad certificate raises here
        self._tls_context = None
        if config.tls_certificate and config.tls_key:
            self._tls_context = networking.make_server_tls_context(
                config.tls_certificate, config.tls_key,
                config.tls_authority_certificate)

    @staticmethod
    def _build_fleet_watcher(config: Config):
        """The /debug/fleet membership: ``fleet_peers`` (a CSV or
        ``file://``), else ``handoff_peers``; None = own entries only."""
        from veneur_tpu_torch.discovery import (FilePeersDiscoverer,
                                                RingWatcher,
                                                StaticDiscoverer)

        peers = config.fleet_peers.strip() or config.handoff_peers.strip()
        if not peers:
            return None
        if peers.startswith("file://"):
            discoverer = FilePeersDiscoverer(peers[len("file://"):])
        else:
            discoverer = StaticDiscoverer(
                [p.strip() for p in peers.split(",") if p.strip()])
        return RingWatcher(discoverer, "veneur-fleet-debug")

    def _wire_crash_surface(self) -> None:
        """Report-then-rethrow on every thread the server starts
        (ConsumePanic, sentry.go:17-52) and a process-wide excepthook;
        with ``enable_profiling``, one cProfile from here to shutdown.
        On Python 3.12 and later cProfile monitors every thread of the
        process (``sys.monitoring``), and a second profiler, on a thread
        of its own, would raise: the JAX package's per-thread profilers
        do, killing each thread they wrap."""
        if self.config.sentry_dsn:
            self._sentry = crash.SentryReporter(self.config.sentry_dsn)
        crash.install_excepthook(self._sentry)
        self._guard = lambda fn: crash.guarded(fn, self._sentry)
        if self.config.enable_profiling:
            import cProfile

            self._profiler = cProfile.Profile()
            self._profiler.enable()
            log.info("profiling enabled; stats written on shutdown")

    def _write_profile(self) -> None:
        """Write the profile to ``veneur-profile.pstats``
        (server.go:1039-1047)."""
        if self._profiler is None:
            return
        import pstats

        self._profiler.disable()
        path = "veneur-profile.pstats"
        pstats.Stats(self._profiler).dump_stats(path)
        log.info("profile written to %s", path)
        self._profiler = None

    def _count(self, attr: str, n: int = 1):
        with self._counts_lock:
            setattr(self, attr, getattr(self, attr) + n)

    @property
    def packet_errors(self) -> int:
        """Rejected lines: per-line parse errors, the native pool's and
        the lanes' parse errors."""
        return (self._packet_errors.total()
                + sum(f.parse_errors() for f in self.ingest_fleets))

    @property
    def quarantined(self) -> int:
        """Poisoned samples: per-line rejections plus the store's ledger
        of the batch and lane paths (cut tag sets included)."""
        return self._quarantined.total() + self.store.quarantine.total()

    @property
    def spans_dropped(self) -> int:
        """Spans shed because the span channel was full."""
        return self._spans_dropped.total()

    @property
    def using_native(self) -> bool:
        """Every statsd listener decodes with the C++ parser."""
        return self._all_listeners(lambda lane: lane.using_native)

    @property
    def using_recvmmsg(self) -> bool:
        """Every statsd listener drains its sockets with recvmmsg (the
        C++ pool always does; the Python readers never do)."""
        return self._all_listeners(lambda lane: lane.using_recvmmsg)

    def _all_listeners(self, lane_test) -> bool:
        return (bool(self.listeners)
                and all(rung != "python" for _, rung, _ in self.listeners)
                and all(lane_test(lane) for f in self.ingest_fleets
                        for lane in f.lanes))

    def is_local(self) -> bool:
        """forward_address set means the local role (server.go:1132-1137)."""
        return bool(self.config.forward_address)

    def count_imported(self, n_ok: int, n_errors: int):
        """Tally one merged /import batch."""
        self._count("imported_metrics", n_ok)
        self._count("import_errors", n_errors)

    def handle_metric_packet(self, packet: bytes) -> bool:
        """Parse one line and route it (server.go:670-720): events to the
        event worker, service checks and metrics to the store. Returns
        False on a rejected line: counted in ``packet_errors`` or
        ``quarantined`` (poisoned values), and logged at debug level. A
        tag set past ``max_tag_length`` is cut and counted."""
        try:
            if packet.startswith(b"_e{"):
                self.event_worker.add(p.parse_event(packet))
            elif packet.startswith(b"_sc"):
                self.store.process_metric(p.parse_service_check(packet))
            else:
                self.store.process_metric(p.parse_metric(
                    packet, max_tag_length=self.store.max_tag_length,
                    quarantine=self.store.quarantine))
        except p.QuarantineError as e:
            self._quarantined.add()
            log.debug("quarantined packet %r: %s", packet[:100], e)
            return False
        except p.ParseError as e:
            self._packet_errors.add()
            log.debug("rejected packet %r: %s", packet[:100], e)
            return False
        return True

    def handle_packet(self, datagram: bytes):
        """Split a datagram into metric lines (server.go:806-819). With
        an ingest kind configured, the seeded schedule first mangles the
        datagram (``ingest.statsd``): cut mid-line, or a burst of
        copies."""
        inj = self.ingest_injector
        if inj is not None:
            for mangled in inj.mangle_packet("ingest.statsd", datagram):
                for line in p.split_lines(mangled):
                    self.handle_metric_packet(line)
            return
        for line in p.split_lines(datagram):
            self.handle_metric_packet(line)

    def handle_ssf_packet(self, datagram: bytes):
        """One UDP datagram = one bare SSFSpan (server.go:827-860); an
        undecodable one is counted in ``packet_errors``."""
        try:
            span = wire.parse_ssf(datagram)
        except ssf.DecodeError as e:
            self._packet_errors.add()
            log.debug("rejected SSF packet: %s", e)
            return
        self.handle_ssf(span)

    def _shed_spans(self, count: int):
        """Count shed spans; warn at most once a second."""
        self._spans_dropped.add(count)
        now = time.monotonic()
        if now - self._last_span_drop_log >= 1.0:
            self._last_span_drop_log = now
            log.warning("dropping spans; span channel is full (%d dropped "
                        "since start)", self.spans_dropped)

    def handle_ssf(self, span):
        """Hand a span to the span workers (server.go:753-792). Under
        overload the controller sheds raw spans before the channel
        (counted in ``overload.shed``); a full channel sheds too."""
        if not self.overload.admit_span():
            return
        try:
            self.span_chan.put_nowait(span)
        except queue.Full:
            self._shed_spans(1)

    def handle_ssf_batch(self, spans: list):
        """handle_ssf for a native batch: one channel hop for the batch,
        shedding counted per span."""
        if not spans:
            return
        if not self.overload.admit_span(len(spans)):
            return
        try:
            self.span_chan.put_nowait(spans)
        except queue.Full:
            self._shed_spans(len(spans))

    def handle_ssf_stream(self, conn):
        """Framed-SSF stream pump (server.go:862-899): a framing error
        poisons the stream and closes the connection; a frame whose body
        does not decode is counted and skipped (the stream is still at a
        frame boundary)."""
        stream = conn.makefile("rb")
        try:
            while not self._stop.is_set():
                try:
                    span = wire.read_ssf(stream)
                except wire.FramingError as e:
                    self._packet_errors.add()
                    log.warning("SSF framing error, closing stream: %s", e)
                    return
                except ssf.DecodeError as e:
                    self._packet_errors.add()
                    log.debug("bad SSF message: %s", e)
                    continue
                if span is None:
                    return  # clean EOF at a frame boundary
                self.handle_ssf(span)
        finally:
            stream.close()
            conn.close()

    def start(self):
        """Bring up the span workers, the listeners and the flush ticker
        (server.go:555-666). On the card the kernel library loads first:
        a build or load failure raises here, not inside a flush. A
        checkpoint left by a killed process merges into the store before
        any listener ingests."""
        cfg = self.config
        if self.store.device.type == "cuda":
            tdigest_cuda._kernel_lib()
        self._wire_crash_surface()
        self._started_wall = time.time()
        if self.checkpointer is not None:
            self.checkpointer.restore()
        if self.handoff_manager is not None:
            # handoffs a crashed life spooled but never saw acked re-send
            # (the receiver's id guard makes that exactly-once) or
            # re-enter the live store: late, never lost
            self.handoff_manager.recover_spool()
        self._span_lanes = make_span_lanes(self.span_sinks, self._span_stop)
        for i in range(cfg.num_span_workers):
            w = SpanWorker(self.span_chan, self._stop, self._span_lanes)
            t = threading.Thread(target=self._guard(w.work),
                                 name=f"span-worker-{i}", daemon=True)
            t.start()
            self._span_workers.append(w)
            self._span_threads.append(t)
        for sink in self.metric_sinks + self.span_sinks:
            sink.start()
        if cfg.http_address:
            self.ops_server = OpsServer.for_server(self, cfg.http_address)
            self._mount_fleet_routes(self.ops_server)
            self.ops_server.start()
        if cfg.grpc_address:
            from veneur_tpu_torch.forward.grpc_forward import ImportServer

            self.import_server = ImportServer(
                self.store, trace_client=self.trace_client,
                hop_log=self.obs_hops)
            self.import_server.start(cfg.grpc_address)
        if cfg.native_import_address:
            self.native_import_server = NativeImportServer(self.store)
            self.native_import_server.start(cfg.native_import_address)
        if self.forward_fn is None:
            self.forwarder = configure_forwarding(self)
        for spec in cfg.statsd_listen_addresses:
            if (self._try_ingest_lanes(spec) or self._try_native_statsd(spec)
                    or self._try_native_tcp(spec)):
                continue
            threads, bound = networking.start_statsd(
                spec, cfg.num_readers, cfg.read_buffer_size_bytes,
                cfg.metric_max_length, self.handle_packet, self._stop,
                admit=lambda: self.overload.admit_packet("statsd"),
                handle_tcp_line=self.handle_metric_packet,
                tls_config=self._tls_context,
                error_log_interval=self.interval)
            self._threads.extend(threads)
            self.statsd_addrs.extend(bound)
            self.listeners.append((spec, "python", bound[0]))
        for spec in cfg.ssf_listen_addresses:
            if self._try_native_ssf(spec):
                continue
            threads, bound = networking.start_ssf(
                spec, cfg.num_readers, cfg.read_buffer_size_bytes,
                cfg.trace_max_length_bytes, self.handle_ssf_packet,
                self.handle_ssf_stream, self._stop,
                admit=lambda: self.overload.admit_packet("ssf"))
            self._threads.extend(threads)
            self.ssf_addrs.extend(bound)
            rung = ("python" if resolve_addr(spec).family == "udp"
                    else "stream")
            self.ssf_listeners.append((spec, rung, bound[0]))
        for name, worker in (("handoff-refresh", self.handoff_manager),
                             ("ha-replicator", self.standby_manager),
                             ("lease-elector", self.lease_elector)):
            if worker is not None:
                t = threading.Thread(target=self._guard(worker.run),
                                     args=(self._stop,), name=name,
                                     daemon=True)
                t.start()
                self._threads.append(t)
        ticker = threading.Thread(target=self._guard(self._flush_loop),
                                  name="flush-ticker", daemon=True)
        ticker.start()
        self._threads.append(ticker)
        if self.checkpointer is not None:
            ckpt = threading.Thread(
                target=self._guard(self.checkpointer.run),
                args=(self._stop,), name="checkpoint", daemon=True)
            ckpt.start()
            self._threads.append(ckpt)
            log.info("checkpointing to %s every %.1fs",
                     self.checkpointer.path, self.checkpointer.interval_s)

    def _mount_fleet_routes(self, ops: OpsServer) -> None:
        """The receivers of the fleet plane: a peer's moved ranges merge
        on ``POST /handoff`` synchronously (the 2xx is the ack; the id
        and epoch guards make retries at-most-once), the active's
        retired flushes shadow on ``POST /replicate`` until a
        promotion."""
        mgr = self.handoff_manager
        if mgr is not None:
            ops.add_post_route("/handoff", lambda headers, body:
                               mgr.handle_handoff(body, headers=headers))
            ops.add_route("/handoff-status", mgr.status_route)
        sby = self.standby_manager
        if sby is not None:
            ops.add_post_route("/replicate", lambda headers, body:
                               sby.handle_replicate(body, headers=headers))
            ops.add_route("/ha-status", sby.status_route)

    def _try_ingest_lanes(self, spec: str) -> bool:
        """The default rung: one lane per reader (``ingest_lanes: 0``) or
        ``ingest_lanes`` lanes, merged into the store by the fleet's
        merger thread; ``-1`` falls through to the legacy readers."""
        cfg = self.config
        if cfg.ingest_lanes < 0 or resolve_addr(spec).family != "udp":
            return False
        num_lanes = cfg.ingest_lanes or max(1, cfg.num_readers)
        try:
            fleet = IngestFleet(
                self.store, resolve_addr(spec), num_lanes,
                cfg.read_buffer_size_bytes, cfg.metric_max_length,
                stop=self._stop, raw_handler=self.handle_metric_packet,
                overload=self.overload,
                trace_stages=bool(cfg.obs_enabled))
        except OSError as e:
            log.warning("ingest lanes failed to bind (%s); falling back "
                        "to the legacy readers", e)
            return False
        fleet.start()
        self.ingest_fleets.append(fleet)
        # sealed but unmerged chunks belong in a checkpoint: every fleet
        # drains before a snapshot
        fleets = list(self.ingest_fleets)
        self.store.set_ingest_drain(
            lambda: [f.merge_sealed() for f in fleets])
        # one entry per LISTENER: every lane REUSEPORTs the same address
        self.statsd_addrs.append(fleet.bound[0])
        self.listeners.append((spec, "lanes", fleet.bound[0]))
        log.info("ingest fleet on udp port %s: %d lanes (native decode=%s, "
                 "recvmmsg=%s)", fleet.bound[0][1], num_lanes,
                 fleet.lanes[0].using_native,
                 fleet.lanes[0].using_recvmmsg)
        return True

    def _try_native_statsd(self, spec: str) -> bool:
        """The C++ SO_REUSEPORT reader pool for a plain IPv4 listener
        (socket_linux.go:12-76 + networking.go:37-87 rebuilt native),
        pumped into ``MetricStore.process_batch``; False falls back to
        the Python readers."""
        cfg = self.config
        if not cfg.native_ingest:
            return False
        addr = resolve_addr(spec)
        if (addr.family != "udp" or addr.scheme.endswith("6")
                or ":" in addr.host):
            return False  # the native pool is AF_INET only
        if not native.available():
            return False  # logged by the loader
        host = addr.host or "0.0.0.0"
        try:
            reader = native.NativeUDPReader(
                host=host, port=addr.port,
                num_readers=max(1, cfg.num_readers),
                rcvbuf=cfg.read_buffer_size_bytes,
                dgram_max=cfg.metric_max_length)
        except OSError as e:
            log.warning("native UDP readers failed (%s); using Python "
                        "readers", e)
            return False
        self.native_readers.append(reader)
        self.statsd_addrs.append((host, reader.port))
        self.listeners.append((spec, "native", (host, reader.port)))
        t = threading.Thread(target=self._guard(self._native_pump),
                             args=(reader,),
                             name="native-udp-pump", daemon=True)
        t.start()
        self._native_pumps.append(t)
        log.info("native ingest on udp port %d (%d readers)", reader.port,
                 reader.num_readers)
        return True

    def _try_native_tcp(self, spec: str) -> bool:
        """The C++ TCP/TLS statsd listener for an IPv4 ``tcp://`` address
        (accept, handshake, framing and parse off the GIL), pumped as the
        UDP pool is; False falls back to the Python listener: without
        ``native_ingest`` or the library, on IPv6, or for TLS without the
        runtime's libssl."""
        cfg = self.config
        if not cfg.native_ingest:
            return False
        addr = resolve_addr(spec)
        if (addr.family != "tcp" or addr.scheme.endswith("6")
                or ":" in addr.host):
            return False
        if not native.available():
            return False  # logged by the loader
        use_tls = bool(cfg.tls_certificate and cfg.tls_key)
        if use_tls and not native.tls_available():
            log.warning("the runtime's libssl did not load; the Python "
                        "listener serves TLS on %s", spec)
            return False
        host = addr.host or "0.0.0.0"
        try:
            reader = native.NativeTLSReader(
                host=host, port=addr.port,
                cert_path=cfg.tls_certificate if use_tls else "",
                key_path=cfg.tls_key if use_tls else "",
                ca_path=cfg.tls_authority_certificate if use_tls else "",
                max_line=cfg.metric_max_length)
        except (OSError, RuntimeError) as e:
            log.warning("native TCP/TLS listener failed (%s); using the "
                        "Python listener", e)
            return False
        self.native_readers.append(reader)
        self.statsd_addrs.append((host, reader.port))
        self.listeners.append((spec, "native", (host, reader.port)))
        t = threading.Thread(target=self._guard(self._native_pump),
                             args=(reader,), name="native-tcp-pump",
                             daemon=True)
        t.start()
        self._native_pumps.append(t)
        log.info("native %s statsd listener on tcp port %d",
                 "TLS" if use_tls else "plaintext", reader.port)
        return True

    def _native_pump(self, reader):
        """Drain the reader pool's parsed batches into the store; raw
        event/service-check lines re-enter the per-line path."""
        last_drops = 0
        while not self._stop.is_set():
            try:
                batches = reader.drain()
                drops = reader.drops()
                if drops != last_drops:
                    self._count("packet_drops", drops - last_drops)
                    log.warning("native ingest dropped %d datagrams (pump "
                                "falling behind)", drops - last_drops)
                    last_drops = drops
                if not batches:
                    self._stop.wait(0.005)
                    continue
                for b in batches:
                    self._packet_errors.add(int(b.parse_errors))
                    for line in self.store.process_batch(b):
                        self.handle_metric_packet(line)
            except Exception:
                # one bad batch must not kill the listener's only pump
                log.exception("native pump iteration failed")
                self._stop.wait(0.05)

    def _try_native_ssf(self, spec: str) -> bool:
        """The C++ SSF reader pool for a plain IPv4 UDP SSF listener:
        datagrams decode on the C++ reader threads (off the GIL) and
        their embedded samples arrive as parsed records for
        ``process_batch`` (server.go:827-860 rebuilt native). False
        falls back to the Python readers."""
        cfg = self.config
        if not cfg.native_ingest:
            return False
        addr = resolve_addr(spec)
        if (addr.family != "udp" or addr.scheme.endswith("6")
                or ":" in addr.host):
            return False  # the native pool is AF_INET only
        if not native.available():
            return False  # logged by the loader
        host = addr.host or "0.0.0.0"
        try:
            reader = native.NativeSSFReader(
                host=host, port=addr.port,
                num_readers=max(1, cfg.num_readers),
                rcvbuf=cfg.read_buffer_size_bytes,
                dgram_max=cfg.trace_max_length_bytes,
                indicator_timer_name=cfg.indicator_span_timer_name)
        except OSError as e:
            log.warning("native SSF readers failed (%s); using Python "
                        "readers", e)
            return False
        self.native_readers.append(reader)
        self.native_ssf_readers.append(reader)
        self.ssf_addrs.append((host, reader.port))
        self.ssf_listeners.append((spec, "native", (host, reader.port)))
        t = threading.Thread(target=self._guard(self._native_ssf_pump),
                             args=(reader,),
                             name="native-ssf-pump", daemon=True)
        t.start()
        self._native_pumps.append(t)
        log.info("native SSF ingest on udp port %d (%d readers)",
                 reader.port, reader.num_readers)
        return True

    def _native_ssf_pump(self, reader: native.NativeSSFReader):
        """Drain decoded span batches: the embedded samples go through
        ``process_batch`` (which may launch K2 from this thread), slow-lane
        samples (STATUS, undecodable) through the port's SSF codec and
        parser, and the spans, as LazySpan batches, to the span workers.
        Undecodable datagrams and invalid samples count in
        ``packet_errors``."""
        last_drops = 0
        while not self._stop.is_set():
            try:
                batches = reader.drain()
                drops = reader.drops()
                if drops != last_drops:
                    self._count("native_ssf_drops", drops - last_drops)
                    self._count("packet_drops", drops - last_drops)
                    log.warning("native SSF ingest dropped %d datagrams "
                                "(pump falling behind)", drops - last_drops)
                    last_drops = drops
                if not batches:
                    self._stop.wait(0.005)
                    continue
                for b in batches:
                    self._packet_errors.add(int(b.decode_errors)
                                            + int(b.invalid_samples))
                    if b.metrics.count:
                        for line in self.store.process_batch(b.metrics):
                            self.handle_metric_packet(line)
                    for raw in b.slow_samples:
                        self._slow_ssf_sample(raw)
                    self.handle_ssf_batch(b.spans())
            except Exception:
                # one bad batch must not kill the listener's only pump
                log.exception("native SSF pump iteration failed")
                self._stop.wait(0.05)

    def _slow_ssf_sample(self, raw: bytes):
        """One slow-lane sample of the native SSF pump, as the Python lane
        converts it; rejected samples are counted."""
        try:
            m = p.parse_metric_ssf(ssf.decode_sample(raw))
            if p.valid_metric(m):
                self.store.process_metric(m)
        except p.QuarantineError:
            self._quarantined.add()
        except (ssf.DecodeError, p.ParseError):
            self._packet_errors.add()

    def _flush_loop(self):
        """Interval ticker, optionally aligned to wall-clock interval
        boundaries (server.go:638-665)."""
        if self.config.synchronize_with_interval:
            if self._stop.wait(calculate_tick_delay(self.interval,
                                                    time.time())):
                return
        while not self._stop.wait(self.interval):
            try:
                self.flush()
            except Exception:
                # the ticker must keep running; the failed interval is
                # reported here with its traceback and in last_flush_ok
                self.last_flush_ok = False
                log.exception("flush failed")

    def flush(self) -> int:
        """One flush pass; see veneur_tpu_torch.flusher."""
        return flusher.flush_once(self)

    def flush_age_seconds(self) -> float:
        """Seconds since the last successful flush (since start before
        the first one)."""
        base = self.last_flush_time or self._started_wall
        return max(0.0, time.time() - base)

    def readiness(self) -> tuple:
        """(ready, age_seconds, limit_seconds): ready while the last
        successful flush is no older than twice the interval. A wedged
        flush goes unready here while /healthcheck (liveness) stays ok."""
        age = self.flush_age_seconds()
        limit = 2.0 * self.interval
        return age <= limit, age, limit

    def is_ready(self) -> bool:
        return self.readiness()[0]

    def degradation(self) -> list:
        """Human-readable active degradations, [] when fully healthy.
        Degraded is not unready: a shedding but flushing instance keeps
        taking traffic, so this rides the readiness body, not its
        status."""
        out = []
        level = self.overload.level()
        if level > 0:
            out.append(f"overload level {level} "
                       f"(pressure {self.overload.pressure():.2f})")
        for kernel, gauge in self.store.compute.states():
            if gauge:
                state = "half-open" if gauge == 1.0 else "open"
                out.append(f"compute breaker {kernel} {state} (digest "
                           f"intervals re-merge until it closes)")
        ckpt = self.checkpointer
        if ckpt is not None and ckpt.last_error:
            out.append(f"checkpoint writes failing ({ckpt.last_error})")
        mgr = self.handoff_manager
        if mgr is not None and mgr.last_spool_error:
            out.append(f"handoff spool writes failing "
                       f"({mgr.last_spool_error})")
        # failing replication widens the standby's takeover window past
        # one interval: degraded, not unready
        sby = self.standby_manager
        if sby is not None and sby.is_leader and sby.last_error:
            out.append(f"standby replication failing ({sby.last_error})")
        elector = self.lease_elector
        if elector is not None and elector.last_error:
            out.append(f"lease renewal failing ({elector.last_error})")
        return out

    # keys a live reload cannot change: the sockets stay bound (a
    # SIGUSR2 upgrade is the path for these), the store's geometry and
    # plumbing are allocated once, and the checkpointer, standby and
    # lease threads bind theirs at construction
    _RELOAD_FROZEN = ("statsd_listen_addresses", "ssf_listen_addresses",
                      "ingest_lanes", "http_address", "grpc_address",
                      "native_import_address", "tls_certificate",
                      "tls_key", "tls_authority_certificate",
                      "digest_storage", "digest_dtype", "slab_rows",
                      "flush_pipeline_depth", "flush_streaming",
                      "tier_pool_centroids", "tier_promote_samples",
                      "tier_promote_intervals", "tier_demote_intervals",
                      "tdigest_compression", "hll_precision",
                      "mesh_enabled", "mesh_hosts",
                      "store_initial_capacity", "store_chunk",
                      "span_channel_capacity", "num_span_workers",
                      "enable_profiling", "sentry_dsn",
                      "checkpoint_path", "checkpoint_interval",
                      "checkpoint_max_age_intervals",
                      "standby_peers", "standby_shadow_epochs",
                      "lease_path", "lease_ttl", "lease_renew_interval",
                      "max_series", "max_tag_length",
                      "overload_low_watermark", "overload_high_watermark",
                      "overload_hard_watermark",
                      "compute_breaker_failure_threshold",
                      "compute_breaker_reset_timeout")

    def reload(self, config: Config) -> None:
        """The SIGHUP reload (server.go:1048-1076): take ``config``'s
        interval, percentiles, aggregates, hostname, tags and
        ``tags_exclude``, rebuild the config-driven metric sinks and
        plugins (sinks/factory.py) and, on a local, the forwarder,
        without dropping a socket or the store's state. A frozen key
        (``_RELOAD_FROZEN``) logs a warning and keeps its old value; the
        role (local or global) stays; the span sinks stay (their lanes
        rebuild only on a restart). Injected sinks survive. The sinks a
        reload replaces close at the next reload or at shutdown, after
        their in-flight flushes. Overlapping reloads apply one at a
        time."""
        with self._reload_lock:
            self._reload_locked(config)

    def _reload_locked(self, config: Config) -> None:
        from veneur_tpu_torch.sinks import factory

        for key in self._RELOAD_FROZEN:
            old, new = getattr(self.config, key), getattr(config, key)
            if old != new:
                log.warning("reload cannot change %r (%r -> %r); keeping "
                            "the old value; restart to apply", key, old,
                            new)
                setattr(config, key, old)
        if bool(config.forward_address) != bool(self.config.forward_address):
            log.warning("reload cannot change the instance's role (local "
                        "or global); keeping forward_address=%r",
                        self.config.forward_address)
            config.forward_address = self.config.forward_address
        if (factory.span_sinks_configured(config)
                or factory.span_sinks_configured(self.config)):
            log.warning("reload keeps the existing span sinks (the span "
                        "lanes rebuild only on a restart)")
        # the previous reload's retired sinks have had at least an
        # interval to finish their flushes
        self._close_retired_sinks()
        old_cfg_sinks = [s for s in self.metric_sinks
                         if s not in self._injected_metric_sinks]
        old_forwarder = self.forwarder
        cfg_metric_sinks, _, cfg_plugins = factory.create_sinks(config)
        for sink in cfg_metric_sinks:
            try:
                sink.start()
            except Exception:
                log.exception("sink %s failed to start after reload",
                              sink.name)
        self.config = config
        self.interval = config.interval_seconds
        self.hostname = config.hostname
        self.tags = list(config.tags)
        self.tags_exclude = set(config.tags_exclude)
        self.histogram_percentiles = list(config.percentiles)
        self.histogram_aggregates = HistogramAggregates.from_names(
            config.aggregates)
        # the new set takes effect at the next flush; a flush in flight
        # holds the old list, which stays valid until its sinks close
        self.metric_sinks = self._injected_metric_sinks + cfg_metric_sinks
        self._retired_sinks = old_cfg_sinks
        self.plugins = self._injected_plugins + cfg_plugins
        if self.is_local():
            self.forward_fn = None
            self.forwarder = configure_forwarding(self)
        if (old_forwarder is not None and old_forwarder is not self.forwarder
                and hasattr(old_forwarder, "close")):
            old_forwarder.close()
        log.info("config reloaded: %d metric sinks, %d plugins, interval "
                 "%.1fs", len(self.metric_sinks), len(self.plugins),
                 self.interval)

    def _close_retired_sinks(self) -> None:
        for sink in self._retired_sinks:
            close = getattr(sink, "close", None)
            if close is None:
                continue
            try:
                close()
            except Exception:
                log.exception("retired sink %s close failed",
                              getattr(sink, "name", sink))
        self._retired_sinks = []

    def wait_forward(self, timeout: float = 60.0) -> Optional[bool]:
        """Join the last flush's forward thread; returns its outcome
        (None when no forward ran). A forward still running after
        ``timeout`` raises TimeoutError."""
        thread = self.forward_thread
        if thread is None:
            return None
        thread.join(timeout)
        if thread.is_alive():
            raise TimeoutError(f"forward still running after {timeout} s")
        return self.last_forward_ok

    def crash_stop(self, timeout: float = 10.0):
        """Abandon the process state WITHOUT the final flush or the
        checkpoint's truncation: the in-process twin of SIGKILL. Threads
        are joined and sockets closed, so a test can restart on the same
        ``checkpoint_path`` in one process, but whatever lived only in
        this store dies here, as in a real kill: a restart recovers what
        the last checkpoint committed. The lease is NOT released: a
        standby waits out its ttl, as after a real kill."""
        self._stop_threads(timeout)
        self._close_servers()

    def shutdown(self, timeout: float = 10.0):
        """Stop the readers, the ticker and the checkpoint thread, let the
        span workers and span lanes finish what they accepted, then flush
        the current interval once more so its data reaches the sinks
        (and, on a local, its forward lands) and the checkpoint is
        truncated, and stop the ops server. A handoff in flight finishes
        (streamed or re-queued) and the lease goes back first, so the
        moved ranges make this final flush and a standby promotes on its
        next poll instead of waiting out the ttl."""
        self._stop_threads(timeout)
        if (self.handoff_manager is not None
                and not self.handoff_manager.quiesce(timeout=30.0)):
            log.warning("handoff still in flight at shutdown; its spool "
                        "recovers at the next start")
        if self.lease_elector is not None:
            self.lease_elector.release()
        try:
            self.flush()
            self.wait_forward(timeout)
        finally:
            self._close_servers()

    def _stop_threads(self, timeout: float):
        self._stop.set()
        for t in self._threads + self._native_pumps:
            t.join(timeout=timeout)
        stuck = [t.name for t in self._threads + self._native_pumps
                 if t.is_alive()]
        if stuck:
            log.warning("threads still running after shutdown: %s", stuck)
        for reader in self.native_readers:
            if any(t.is_alive() for t in self._native_pumps):
                # a stuck pump may still read the pool's batches: leak
                # the pool rather than free memory a live thread uses
                reader.leak()
            else:
                reader.stop()
        # the lanes seal their staged residue on exit and the fleet's
        # final merge folds it into the store, so accepted samples ride
        # the last flush out instead of dying in staging
        for fleet in self.ingest_fleets:
            try:
                fleet.shutdown(timeout)
            except Exception:
                log.exception("ingest fleet shutdown failed")
        self._threads.clear()
        self._native_pumps.clear()
        # the workers empty the channel, then the lanes their queues
        for t in self._span_threads:
            t.join(timeout=timeout)
        self._span_stop.set()
        for lane in self._span_lanes:
            lane.thread.join(timeout=timeout)
        self._span_threads.clear()

    def _close_servers(self):
        self._span_flush_closed = True
        if self.span_flush_worker is not None:
            self.span_flush_worker.stop()
        self._write_profile()
        self.trace_client.close()
        if self.ops_server is not None:
            self.ops_server.stop()
        if self.native_import_server is not None:
            self.native_import_server.stop()
        if self.import_server is not None:
            self.import_server.stop()
        if hasattr(self.forwarder, "close"):
            self.forwarder.close()
        # sinks holding a thread or a channel (LightStep's reporters, the
        # gRPC span sinks) release it, the ones a reload retired too
        for sink in self.metric_sinks + self.span_sinks:
            if hasattr(sink, "close"):
                sink.close()
        self._close_retired_sinks()
