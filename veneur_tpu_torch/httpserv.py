"""The operational HTTP server of the port: health, version, import.

Port of the part of ``veneur_tpu/httpserv.py`` that global aggregation
and readiness need (after the reference's goji mux, http.go:21-51, and
its import handler, handlers_global.go:60-213):

    GET  /healthcheck        -> "ok" (liveness)
    GET  /healthcheck/ready  -> "ready", "ready (degraded: ...)" naming
                                an overload level, an open compute
                                breaker or failing checkpoint writes; 503
                                once the last successful flush is older
                                than twice the interval
    GET  /version            -> version string
    POST /import             -> JSON (optionally deflate) list of
                                forwarded metrics, queued for a merge
                                worker; 202, or 429 when the bounded
                                queue is full. The merge runs under a
                                ``veneur.import`` span joined to the
                                sender's trace (handlers_global.go:125),
                                and with a hop log records its
                                ``global.import`` hop (obs/tracectx.py)

Error behavior follows ``unmarshalMetricsFromHTTP``: an empty body, an
unknown encoding and invalid JSON are 400s.

A Server's ops server also serves the live debug endpoints of
``debug.py`` (``/debug/threads``, ``/debug/profile``, ``/debug/vars``,
``/debug/flush-timeline``, ``/debug/xprof``, and with a fleet
aggregator ``/debug/fleet`` and ``/debug/trace``), as JAX
``httpserv.py:405-407`` mounts them.

A Server mounts more routes with :meth:`OpsServer.add_route` (GET,
``fn(query) -> (status, body, content_type[, headers])``) and
:meth:`OpsServer.add_post_route` (POST, ``fn(headers, body) -> (status,
body, content_type)``): the elastic resharding's ``POST /handoff`` and
``GET /handoff-status``, the standby's ``POST /replicate`` and ``GET
/ha-status``. A POST route answers on the request thread, before
``/import``: its 2xx is the ack of a merge that landed, so it never
rides the import pool.
"""

from __future__ import annotations

import errno
import json
import logging
import queue
import socket
import threading
import time
import urllib.parse
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

from veneur_tpu_torch import __version__, debug
from veneur_tpu_torch.networking import warn_if_port_already_served
from veneur_tpu_torch import trace as vtrace
from veneur_tpu_torch.obs import tracectx
from veneur_tpu_torch.trace import samples as ssf_samples

log = logging.getLogger("veneur.http")

# Inflate bound for deflate-encoded bodies: a small crafted body must not
# expand to gigabytes (the /import endpoint is unauthenticated).
MAX_INFLATED_BYTES = 256 * 1024 * 1024


class ImportError400(ValueError):
    pass


def bounded_inflate(body: bytes, limit: Optional[int] = None) -> bytes:
    """zlib-decompress with an output-size cap; raises ImportError400 on
    malformed input or when the inflated size exceeds ``limit``."""
    if limit is None:
        limit = MAX_INFLATED_BYTES
    d = zlib.decompressobj()
    try:
        out = d.decompress(body, limit)
    except zlib.error as e:
        raise ImportError400(f"invalid deflate body: {e}")
    if d.unconsumed_tail:
        raise ImportError400(
            f"deflate body inflates past the {limit}-byte limit")
    if not d.eof:
        raise ImportError400("invalid deflate body: truncated stream")
    return out


def unmarshal_metrics_from_http(headers, body: bytes) -> List[dict]:
    """Decode an /import body (handlers_global.go:147-213)."""
    if not body:
        raise ImportError400("empty request body")
    encoding = (headers.get("Content-Encoding") or "").lower()
    if encoding == "deflate":
        body = bounded_inflate(body)
    elif encoding not in ("", "identity"):
        raise ImportError400(f"unknown Content-Encoding {encoding!r}")
    try:
        metrics = json.loads(body)
    except json.JSONDecodeError as e:
        raise ImportError400(f"invalid JSON: {e}")
    if not isinstance(metrics, list):
        raise ImportError400("body must be a JSON array of metrics")
    if not metrics:
        raise ImportError400("empty import batch")
    return metrics


class _Handler(BaseHTTPRequestHandler):
    server_version = f"veneur-tpu-torch/{__version__}"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route to logging, not stderr
        log.debug("http: " + fmt, *args)

    def _reply(self, status: int, body: str = "",
               ctype: str = "text/plain", headers=None):
        data = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(data)

    def _drain_body(self) -> bytes:
        """Always consume the request body: on keep-alive connections an
        unread body desyncs the next request on the stream."""
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    def _call_route(self, fn, *args):
        try:
            self._reply(*fn(*args))
        except Exception as e:
            log.exception("handler for %s failed", self.path)
            self._reply(500, str(e))

    def do_GET(self):
        self._drain_body()
        path, _, qs = self.path.partition("?")
        ready = self.server.veneur_ready
        extra = self.server.veneur_get_routes.get(path)
        if path == "/healthcheck":
            self._reply(200, "ok")
        elif path == "/healthcheck/ready" and ready is not None:
            self._reply(*ready())
        elif path == "/version":
            self._reply(200, __version__)
        elif extra is not None:
            self._call_route(extra, dict(urllib.parse.parse_qsl(qs)))
        else:
            self._reply(404, "not found")

    def do_POST(self):
        body = self._drain_body()
        path = self.path.partition("?")[0]
        extra = self.server.veneur_post_routes.get(path)
        if extra is not None:
            # a synchronous merge (POST /handoff, /replicate): its 2xx is
            # the ack, so it never rides the async import pool
            self._call_route(extra, self.headers, body)
            return
        if path != "/import":
            self._reply(404, "not found")
            return
        pool = self.server.veneur_import_pool
        if pool is None:
            self._reply(404, "import not enabled on this instance")
            return
        try:
            metrics = unmarshal_metrics_from_http(self.headers, body)
        except ImportError400 as e:
            self._reply(400, str(e))
            return
        # the forwarder's trace context, so the import span stitches into
        # the local's flush trace (handlers_global.go:125)
        carrier = {k.lower(): v for k, v in self.headers.items()}
        # merge off the request thread (the reference's ``go
        # s.ImportMetrics``, http.go:54-60) through a BOUNDED worker
        # pool: a fleet hitting a slow interval sheds (429) instead of
        # piling up threads and bodies
        if pool.submit(metrics, carrier):
            self._reply(202, "accepted")
        else:
            self._reply(429, "import queue full; retry next interval")


def _merge_one(handle, metrics: List[dict], carrier, trace_client,
               hop_log) -> bool:
    """One import batch's merge under a ``veneur.import`` span parented
    on the carrier's trace headers, with ``veneur.import.metrics_total``,
    recorded through ``trace_client``; with a ``hop_log`` the merge parks
    its ``global.import`` hop there (an untraced sender's too, counted
    but unstitchable) for the next flush to publish, and the header's
    ingest stamp folds into the freshness min behind
    ``veneur.fleet.e2e_age_ns``. Returns whether the merge succeeded."""
    span = vtrace.from_headers(carrier or {}, resource="veneur.import")
    span.name = "import"
    ok = True
    try:
        n_ok = handle(metrics)
        if not isinstance(n_ok, int):  # a handle that counts nothing
            n_ok = len(metrics)
        span.add(ssf_samples.count("veneur.import.metrics_total",
                                   float(n_ok), None))
    except Exception as e:
        # the worker must survive a failed merge; the batch is reported
        # here and counted
        span.error(e)
        log.exception("import of %d metrics failed", len(metrics))
        ok = False
    finally:
        span.finish()
        span.client_record(trace_client)
    if hop_log is not None:
        hop_log.record("global.import",
                       tracectx.TraceContext.from_headers(carrier),
                       span.start, span.end or time.time(),
                       metrics=len(metrics), protocol="http")
    return ok


class ImportQueuePool:
    """Bounded merge queue + worker pool behind ``POST /import`` (the
    reference's bounded worker channels, http.go:54-142). A full queue
    sheds the POST with 429; ``shed`` counts rejected batches,
    ``merged_batches`` the merged ones and ``failed_batches`` those whose
    merge raised. Each merge runs through :func:`_merge_one`."""

    def __init__(self, handle: Callable[[List[dict]], object],
                 workers: int = 2, max_queue: int = 64,
                 trace_client=None, hop_log=None):
        self._handle = handle
        self._trace_client = trace_client
        self._hop_log = hop_log
        # queue.Queue(maxsize <= 0) is UNBOUNDED, the opposite of this
        # pool's purpose: clamp to the smallest real bound
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, max_queue))
        self.shed = 0
        self.merged_batches = 0
        self.failed_batches = 0
        self._stopping = threading.Event()
        self._lock = threading.Lock()
        self._workers = [
            threading.Thread(target=self._worker,
                             name=f"import-merge-{i}", daemon=True)
            for i in range(max(1, workers))]
        for t in self._workers:
            t.start()

    def submit(self, metrics, carrier=None) -> bool:
        """Enqueue one decoded batch with its request's headers
        (lowercased); False = queue full (or the pool is stopping), shed
        it."""
        if self._stopping.is_set():
            return False
        try:
            self._q.put_nowait((metrics, carrier))
            return True
        except queue.Full:
            with self._lock:
                self.shed += 1
            return False

    def qsize(self) -> int:
        return self._q.qsize()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._stopping.is_set():
                continue  # drain without merging; exit on the sentinel
            metrics, carrier = item
            ok = _merge_one(self._handle, metrics, carrier,
                            self._trace_client, self._hop_log)
            with self._lock:
                if ok:
                    self.merged_batches += 1
                else:
                    self.failed_batches += 1

    def stop(self):
        # never block on a full queue: flag first (workers then drain
        # without merging) and let the bounded join absorb the rest
        self._stopping.set()
        for _ in self._workers:
            try:
                self._q.put_nowait(None)
            except queue.Full:
                break
        for t in self._workers:
            t.join(timeout=5.0)


class ReuseportHTTPServer(ThreadingHTTPServer):
    """A ThreadingHTTPServer bound with SO_REUSEADDR and SO_REUSEPORT, so
    a SIGUSR2 upgrade (``cli/upgrade.py``), a rolling restart or a
    respawn after SIGKILL on the same port runs two generations side by
    side (the role einhorn's inherited socket plays for the reference,
    server.go:1048-1076). The bind retries a transient EADDRINUSE for a
    bounded window: a killed predecessor's listener can linger for a few
    milliseconds in its closing states."""

    BIND_ATTEMPTS = 20
    BIND_RETRY_PAUSE_S = 0.05

    def server_bind(self):
        self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if hasattr(socket, "SO_REUSEPORT"):
            self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT,
                                   1)
            host, port = self.server_address[:2]
            warn_if_port_already_served(self.address_family,
                                        socket.SOCK_STREAM, host, port)
        for attempt in range(self.BIND_ATTEMPTS):
            try:
                return super().server_bind()
            except OSError as e:
                if (e.errno != errno.EADDRINUSE
                        or attempt == self.BIND_ATTEMPTS - 1):
                    raise
                log.warning("bind to %s transiently refused (%s); retry "
                            "%d/%d", self.server_address, e, attempt + 1,
                            self.BIND_ATTEMPTS)
                time.sleep(self.BIND_RETRY_PAUSE_S)


class OpsServer:
    """The /healthcheck, /version and /import endpoints (http.go:21-51).

    ``import_fn`` receives each decoded JSON metric list on a merge
    worker; without one, /import answers 404. ``ready_fn`` answers
    /healthcheck/ready with (status, body); without one, 404."""

    def __init__(self, addr: str = "127.0.0.1:0",
                 import_fn: Optional[Callable[[List[dict]], object]] = None,
                 import_workers: int = 2, import_queue: int = 64,
                 ready_fn: Optional[Callable[[], tuple]] = None,
                 trace_client=None, hop_log=None):
        host, _, port = addr.rpartition(":")
        self._httpd = ReuseportHTTPServer((host or "127.0.0.1", int(port)),
                                          _Handler)
        self._httpd.daemon_threads = True
        self.import_pool = (
            ImportQueuePool(import_fn, workers=import_workers,
                            max_queue=import_queue,
                            trace_client=trace_client, hop_log=hop_log)
            if import_fn is not None else None)
        self._httpd.veneur_import_pool = self.import_pool
        self._httpd.veneur_ready = ready_fn
        self._httpd.veneur_get_routes = {}
        self._httpd.veneur_post_routes = {}
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def for_server(cls, server, addr: str) -> "OpsServer":
        """The ops server of a port :class:`~veneur_tpu_torch.server.Server`:
        /import merges into its store. The merge runs on the pool's
        threads; the store's import methods take its lock and use its
        device."""
        from veneur_tpu_torch.forward.convert import apply_json_metric_list

        def import_metrics(metrics: List[dict]) -> int:
            n_ok, errs = apply_json_metric_list(server.store, metrics)
            server.count_imported(n_ok, errs)
            if errs:
                log.warning("failed to import %d/%d metrics", errs,
                            len(metrics))
            return n_ok

        def ready():
            ok, age, limit = server.readiness()
            degraded = server.degradation()
            if ok:
                return 200, ("ready" if not degraded else
                             "ready (degraded: " + "; ".join(degraded) + ")")
            detail = ("; last flush attempt FAILED"
                      if not server.last_flush_ok else "")
            if degraded:
                detail += "; degraded: " + "; ".join(degraded)
            return 503, (f"last successful flush {age:.1f}s ago (limit "
                         f"{limit:.1f}s){detail}")

        cfg = server.config
        ops = cls(addr, import_fn=import_metrics,
                  import_workers=cfg.http_import_workers,
                  import_queue=cfg.http_import_queue, ready_fn=ready,
                  trace_client=server.trace_client,
                  hop_log=server.obs_hops)
        debug.mount(ops.add_route, server=server)
        return ops

    def add_route(self, path: str, fn: Callable):
        """GET ``path``: fn(query: dict) -> (status, body, content_type)."""
        self._httpd.veneur_get_routes[path] = fn

    def add_post_route(self, path: str, fn: Callable):
        """POST ``path``: fn(headers, body: bytes) -> (status, body,
        content_type), answered on the request thread."""
        self._httpd.veneur_post_routes[path] = fn

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="http-serve", daemon=True)
        self._thread.start()
        log.info("http server listening on port %d", self.port)

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self.import_pool is not None:
            self.import_pool.stop()
