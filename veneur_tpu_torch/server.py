"""Server lifecycle: config -> UDP listeners -> store -> flush loop.

A slim port of ``veneur_tpu/server.py`` (after
``veneur/server.go``): DogStatsD datagrams from the UDP listeners reach
the dense :class:`MetricStore`, and a ticker flushes the store to the
metric sinks every interval. The store runs on ``cuda`` unless
``device="cpu"`` is passed.

Each ``udp://`` listener takes the first rung of the reference's ladder
that comes up: the ingest-lane fleet (``ingest/``, the default), then,
with ``ingest_lanes: -1``, the C++ reader pool feeding
``MetricStore.process_batch``, then, with ``native_ingest: false`` too
(or without a compiler), the Python readers and the per-line parser.
Event and service-check lines the native rungs hand back go through
:meth:`Server.handle_metric_packet`, which counts them ``not_ported``.

Global aggregation: with ``forward_address`` set the server is a local
and forwards its sketch state there over HTTP after each flush; with
``http_address`` set it serves ``POST /import`` (a global merges what
its locals forward) beside ``/healthcheck`` and ``/version``.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional, Tuple

from veneur_tpu_torch import flusher, native, networking
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.core.store import MetricStore
from veneur_tpu_torch.forward import configure_forwarding
from veneur_tpu_torch.httpserv import OpsServer
from veneur_tpu_torch.ingest import IngestFleet, ShardedCounter
from veneur_tpu_torch.protocol.addr import resolve_addr
from veneur_tpu_torch.samplers import parser as p
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates
from veneur_tpu_torch.sinks.base import MetricSink
from veneur_tpu_torch.sinks.blackhole import BlackholeMetricSink

log = logging.getLogger("veneur.server")


class Server:
    def __init__(self, config: Config,
                 metric_sinks: Optional[List[MetricSink]] = None,
                 device=None):
        self.config = config
        self.interval = config.interval_seconds
        self.hostname = config.hostname
        self.tags = list(config.tags)
        self.histogram_percentiles = list(config.percentiles)
        self.histogram_aggregates = HistogramAggregates.from_names(
            config.aggregates)
        self.store = MetricStore(compression=config.tdigest_compression,
                                 hll_precision=config.hll_precision,
                                 device=device)
        self.metric_sinks = (list(metric_sinks) if metric_sinks is not None
                             else [BlackholeMetricSink()])
        # per-line tallies, added to from reader threads without a lock;
        # the properties below add what the native rungs count
        self._packet_errors = ShardedCounter()
        self._quarantined = ShardedCounter()
        self._not_ported = ShardedCounter()
        self.last_flush_time = 0.0
        self.last_flush_ok = True
        # global aggregation (start() wires them from the config)
        self.forward_fn = None
        self.forwarder = None
        self.forward_thread: Optional[threading.Thread] = None
        self.last_forward_ok: Optional[bool] = None
        self.forward_errors = 0
        self.ops_server: Optional[OpsServer] = None
        self.imported_metrics = 0
        self.import_errors = 0
        self.statsd_addrs: List[tuple] = []
        # (listen address, rung: "lanes", "native" or "python", bound
        # address), one per statsd listener
        self.listeners: List[Tuple[str, str, tuple]] = []
        self.ingest_fleets: List[IngestFleet] = []
        self.native_readers: List[native.NativeUDPReader] = []
        self._native_pumps: List[threading.Thread] = []
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._counts_lock = threading.Lock()

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
        of the batch and lane paths."""
        return self._quarantined.total() + self.store.quarantine.total()

    @property
    def not_ported(self) -> int:
        """Lines of kinds the port does not handle: events and service
        checks on every path, heavy-hitter sets (per line here, per record
        in the store on the native paths)."""
        return self._not_ported.total() + self.store.not_ported

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
        """Parse one line and route it (server.go:670-720). Returns False
        on a rejected line: counted in ``packet_errors``, ``quarantined``
        (poisoned values) or ``not_ported`` (events, service checks,
        heavy-hitter sets), and logged at debug level."""
        try:
            if packet.startswith(b"_e{"):
                p.parse_event(packet)
            elif packet.startswith(b"_sc"):
                p.parse_service_check(packet)
            else:
                self.store.process_metric(p.parse_metric(packet))
        except p.NotPortedError as e:
            self._not_ported.add()
            log.debug("unported packet %r: %s", packet[:100], e)
            return False
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
        """Split a datagram into metric lines (server.go:806-819)."""
        for line in p.split_lines(datagram):
            self.handle_metric_packet(line)

    def start(self):
        """Bring up the UDP readers and the flush ticker."""
        for sink in self.metric_sinks:
            sink.start()
        cfg = self.config
        if cfg.http_address:
            self.ops_server = OpsServer.for_server(self, cfg.http_address)
            self.ops_server.start()
        if self.forward_fn is None:
            self.forwarder = configure_forwarding(self)
        for spec in cfg.statsd_listen_addresses:
            if self._try_ingest_lanes(spec) or self._try_native_statsd(spec):
                continue
            threads, bound = networking.start_statsd(
                spec, cfg.num_readers, cfg.read_buffer_size_bytes,
                cfg.metric_max_length, self.handle_packet, self._stop)
            self._threads.extend(threads)
            self.statsd_addrs.extend(bound)
            self.listeners.append((spec, "python", bound[0]))
        ticker = threading.Thread(target=self._flush_loop,
                                  name="flush-ticker", daemon=True)
        ticker.start()
        self._threads.append(ticker)

    def _try_ingest_lanes(self, spec: str) -> bool:
        """The default rung: one lane per reader (``ingest_lanes: 0``) or
        ``ingest_lanes`` lanes, merged into the store by the fleet's
        merger thread; ``-1`` falls through to the legacy readers."""
        cfg = self.config
        if cfg.ingest_lanes < 0:
            return False
        num_lanes = cfg.ingest_lanes or max(1, cfg.num_readers)
        try:
            fleet = IngestFleet(
                self.store, resolve_addr(spec), num_lanes,
                cfg.read_buffer_size_bytes, cfg.metric_max_length,
                stop=self._stop, raw_handler=self.handle_metric_packet)
        except OSError as e:
            log.warning("ingest lanes failed to bind (%s); falling back "
                        "to the legacy readers", e)
            return False
        fleet.start()
        self.ingest_fleets.append(fleet)
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
        if addr.scheme.endswith("6") or ":" in addr.host:
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
        t = threading.Thread(target=self._native_pump, args=(reader,),
                             name="native-udp-pump", daemon=True)
        t.start()
        self._native_pumps.append(t)
        log.info("native ingest on udp port %d (%d readers)", reader.port,
                 reader.num_readers)
        return True

    def _native_pump(self, reader: native.NativeUDPReader):
        """Drain the reader pool's parsed batches into the store; raw
        event/service-check lines re-enter the per-line path."""
        last_drops = 0
        while not self._stop.is_set():
            try:
                batches = reader.drain()
                drops = reader.drops()
                if drops != last_drops:
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

    def _flush_loop(self):
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

    def shutdown(self, timeout: float = 10.0):
        """Stop the readers and the ticker, then flush the current
        interval once more so its data reaches the sinks (and, on a
        local, its forward lands), and stop the ops server."""
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
        try:
            self.flush()
            self.wait_forward(timeout)
        finally:
            if self.ops_server is not None:
                self.ops_server.stop()
