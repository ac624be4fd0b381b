"""Server lifecycle: config -> UDP listeners -> store -> flush loop.

A slim port of ``veneur_tpu/server.py`` (after
``veneur/server.go``): DogStatsD lines from the UDP readers go
through the parser into the dense :class:`MetricStore`, and a ticker
flushes the store to the metric sinks every interval. The store runs on
``cuda`` unless ``device="cpu"`` is passed.

Global aggregation: with ``forward_address`` set the server is a local
and forwards its sketch state there over HTTP after each flush; with
``http_address`` set it serves ``POST /import`` (a global merges what
its locals forward) beside ``/healthcheck`` and ``/version``.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional

from veneur_tpu_torch import flusher, networking
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.core.store import MetricStore
from veneur_tpu_torch.forward import configure_forwarding
from veneur_tpu_torch.httpserv import OpsServer
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
        self.packet_errors = 0
        self.quarantined = 0
        self.not_ported = 0
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
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._counts_lock = threading.Lock()

    def _count(self, attr: str, n: int = 1):
        with self._counts_lock:
            setattr(self, attr, getattr(self, attr) + n)

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
            self._count("not_ported")
            log.debug("unported packet %r: %s", packet[:100], e)
            return False
        except p.QuarantineError as e:
            self._count("quarantined")
            log.debug("quarantined packet %r: %s", packet[:100], e)
            return False
        except p.ParseError as e:
            self._count("packet_errors")
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
            threads, bound = networking.start_statsd(
                spec, cfg.num_readers, cfg.read_buffer_size_bytes,
                cfg.metric_max_length, self.handle_packet, self._stop)
            self._threads.extend(threads)
            self.statsd_addrs.extend(bound)
        ticker = threading.Thread(target=self._flush_loop,
                                  name="flush-ticker", daemon=True)
        ticker.start()
        self._threads.append(ticker)

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
        for t in self._threads:
            t.join(timeout=timeout)
        stuck = [t.name for t in self._threads if t.is_alive()]
        if stuck:
            log.warning("threads still running after shutdown: %s", stuck)
        self._threads.clear()
        try:
            self.flush()
            self.wait_forward(timeout)
        finally:
            if self.ops_server is not None:
                self.ops_server.stop()
