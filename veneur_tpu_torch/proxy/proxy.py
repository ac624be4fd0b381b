"""The HTTP proxy: ``POST /import`` fan-out over the consistent ring.

Port of ``veneur_tpu/proxy/proxy.py`` (after the reference's
``proxy.go``): discovery-driven ring refresh (``Start`` /
``RefreshDestinations``, proxy.go:206-371), per-metric consistent hashing
on ``MetricKey.String()`` and parallel per-destination POSTs
(``ProxyMetrics``, proxy.go:437-505), trace spans over a ring of their
own (``ProxyTraces``, :393-434), and the gRPC flavour on
``grpc_forward_address``, whose ring follows the same refresh. The proxy
is stateless: a failed or empty refresh keeps the last good ring
(:351-361), and starting with zero destinations is fatal (:232-243).

Routes: ``POST /import`` and ``POST /spans`` (202, then the fan-out off
the request thread), ``GET /healthcheck``, ``GET /debug/flush-timeline``
(the proxy's hops, below) and through ``debug.mount`` ``GET
/debug/threads``, ``/debug/profile`` and ``/debug/vars`` (the time, the
thread count and the proxy's own ``vars()``: the ring's counters and
breakers).

The fleet trace plane (``obs/tracectx.py``): an ``/import`` body that
carries ``X-Veneur-Trace`` fans out under a ``proxy.fan_out`` hop of its
own: each destination POST carries the context re-parented under the
hop's span (``TraceContext.child``), so the global's import parents
under the fan-out rather than the local's flush, and the hop (a
``post.<destination>`` stage a destination) publishes into a 64-entry
timeline, where a global's ``/debug/trace`` pulls it. The gRPC proxy
carries no trace, as in the JAX package.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.parse
import zlib
from collections import defaultdict
from http.server import BaseHTTPRequestHandler
from typing import Callable, Dict, List, Optional

from veneur_tpu_torch import debug, obs
from veneur_tpu_torch.config import ProxyConfig
from veneur_tpu_torch.discovery import (ConsulDiscoverer, Discoverer,
                                        RetryingDiscoverer,
                                        StaticDiscoverer)
from veneur_tpu_torch.forward.http_forward import post_helper
from veneur_tpu_torch.httpserv import (ImportError400, ReuseportHTTPServer,
                                       bounded_inflate,
                                       unmarshal_metrics_from_http)
from veneur_tpu_torch.obs import tracectx
from veneur_tpu_torch.proxy.consistent import (ConsistentRing,
                                               EmptyRingError, ring_key)
from veneur_tpu_torch.resilience import (BreakerRegistry, Deadline,
                                         RetryPolicy, is_transient_status,
                                         post_with_retry)
from veneur_tpu_torch.resilience import faults

log = logging.getLogger("veneur.proxy")


def metric_ring_key(d: dict) -> str:
    """The hash key of one JSON metric, ``MetricKey.String()``
    (samplers/parser.go:50-56): the shared ``ring_key`` rule, so proxy
    routing and device placement hash one string."""
    return ring_key(d["name"], d["type"], ",".join(d.get("tags") or []))


class _ProxyHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        log.debug("proxy http: " + fmt, *args)

    def _reply(self, status: int, body: str = "",
               ctype: str = "text/plain", headers=None):
        data = body.encode()
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(data)

    def _drain_body(self) -> bytes:
        # always consume the body: leftovers desync keep-alive connections
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    def do_GET(self):
        self._drain_body()
        path, _, qs = self.path.partition("?")
        route = self.server.veneur_get_routes.get(path)
        if path == "/healthcheck":
            self._reply(200, "ok")
        elif route is not None:
            self._reply(*route(dict(urllib.parse.parse_qsl(qs))))
        else:
            self._reply(404, "not found")

    def do_POST(self):
        body = self._drain_body()
        proxy = self.server.veneur_proxy
        path = self.path.partition("?")[0]
        if path == "/import":
            try:
                metrics = unmarshal_metrics_from_http(self.headers, body)
            except ImportError400 as e:
                self._reply(400, str(e))
                return
            # the fleet trace plane rides through: re-parented under the
            # fan-out's span on every destination POST
            trace_header = self.headers.get(tracectx.HEADER)
            # accept, then fan out off the request thread
            # (handlers_global.go:28-43: "go p.ProxyMetrics")
            self._reply(202, "accepted")
            threading.Thread(target=proxy.proxy_metrics,
                             args=(metrics, trace_header),
                             name="proxy-fanout", daemon=True).start()
        elif path == "/spans":
            # Datadog trace spans fan out over their own ring
            # (handlers_global.go:45-56 -> ProxyTraces, proxy.go:393-434)
            if not proxy.accepting_traces:
                self._reply(404, "not accepting traces")
                return
            try:
                if (self.headers.get("Content-Encoding") or "") == "deflate":
                    body = bounded_inflate(body)
                traces = json.loads(body)
                if not isinstance(traces, list):
                    raise ValueError("expected a JSON array of spans")
            except (ValueError, zlib.error) as e:
                self._reply(400, f"bad trace body: {e}")
                return
            self._reply(202, "accepted")
            threading.Thread(target=proxy.proxy_traces, args=(traces,),
                             name="proxy-spans", daemon=True).start()
        else:
            self._reply(404, "not found")


class Proxy:
    """veneur-proxy: the consistent-hash availability layer in front of
    the global tier. ``discoverer`` overrides the config's (it then
    serves both rings); ``grpc_dial`` maps a ring member to its gRPC
    import address for the gRPC flavour (default: the member without
    its scheme, as the JAX package dials it), so one member can stand
    for a global's HTTP and gRPC listeners and both transports route a
    series to the same global."""

    def __init__(self, config: ProxyConfig,
                 discoverer: Optional[Discoverer] = None,
                 grpc_dial: Optional[Callable[[str], str]] = None):
        self.config = config.finalize()
        self.forward_timeout = config.forward_timeout_seconds
        self.refresh_interval = config.refresh_interval_seconds
        # retries inside the forward_timeout deadline, and one breaker a
        # ring destination
        self.retry_policy = RetryPolicy.from_config(config)
        self.breakers = BreakerRegistry(
            failure_threshold=config.breaker_failure_threshold,
            reset_timeout=config.breaker_reset_timeout_seconds)
        # the seeded transport faults around the fan-out's post, as the
        # JAX proxy wraps it; membership churn has an injector of its own
        # (armed by a churn kind): it mangles each refresh and
        # black-holes a partitioned member's sends
        self.fault_injector = faults.from_config(config)
        self._post = (self.fault_injector.wrap_post(post_helper,
                                                    "proxy.post")
                      if self.fault_injector is not None else post_helper)
        self.churn_injector = faults.armed_for(config, faults.CHURN_KINDS)
        self.service_name = config.consul_forward_service_name
        if discoverer is not None:
            self.discoverer = discoverer
        elif self.service_name:
            self.discoverer = ConsulDiscoverer()
        elif config.forward_address:
            self.discoverer = StaticDiscoverer([config.forward_address])
            self.service_name = "static"
        else:
            raise ValueError(
                "proxy needs consul_forward_service_name or forward_address")
        self.ring = ConsistentRing()
        # trace spans ride their own ring (proxy.go:41,119-136): a Consul
        # service, else the static trace_address; an injected discoverer
        # serves both rings
        self.trace_service_name = config.consul_trace_service_name
        self.trace_ring = ConsistentRing()
        self.accepting_traces = bool(self.trace_service_name
                                     or config.trace_address)
        if discoverer is not None:
            self.trace_discoverer: Optional[Discoverer] = discoverer
        elif self.trace_service_name:
            self.trace_discoverer = ConsulDiscoverer()
        else:
            self.trace_discoverer = None
            if config.trace_address:
                self.trace_ring.set_members([config.trace_address])
        self.grpc_dial = grpc_dial
        # the trace-bearing fan-outs' hops, one entry a batch, served at
        # GET /debug/flush-timeline
        self.obs_timeline = obs.FlushTimeline(64)
        # the gRPC flavour (grpc_forward_address), seeded and refreshed
        # with the metrics ring's membership (proxysrv/server.go:147-177)
        self.grpc_server = None
        self._last_destinations: List[str] = []
        self._stop = threading.Event()
        self._httpd: Optional[ReuseportHTTPServer] = None
        self._threads: List[threading.Thread] = []
        self.proxied = 0
        self.traces_proxied = 0
        self.forward_errors = 0
        self.forward_retries = 0
        self.breaker_rejections = 0
        self.dropped = 0
        self.refresh_failures = 0
        self.refresh_retries = 0
        self._lock = threading.Lock()

    # -- discovery ------------------------------------------------------

    def refresh_destinations(self):
        """Re-resolve every configured ring (proxy.go:239-267)."""
        self._refresh_ring(self.discoverer, self.service_name, self.ring)
        if (self.accepting_traces and self.trace_service_name
                and self.trace_discoverer is not None):
            self._refresh_ring(self.trace_discoverer,
                               self.trace_service_name, self.trace_ring)

    def _refresh_ring(self, discoverer: Discoverer, service_name: str,
                      ring: ConsistentRing):
        """Re-resolve one ring; a failure or an empty result keeps the
        previous ring (proxy.go:337-371), after the shared retries
        inside the refresh interval."""

        def on_retry(retry_index, exc, pause):
            with self._lock:
                self.refresh_retries += 1

        retrying = RetryingDiscoverer(discoverer, self.retry_policy,
                                      budget=self.refresh_interval,
                                      on_retry=on_retry)
        try:
            destinations = retrying.get_destinations_for_service(
                service_name)
        except Exception as e:
            with self._lock:
                self.refresh_failures += 1
            log.warning("destination refresh failed, keeping %d known: %s",
                        len(ring), e)
            return
        if not destinations:
            with self._lock:
                self.refresh_failures += 1
            log.warning("discovery returned zero destinations, keeping %d",
                        len(ring))
            return
        if self.churn_injector is not None:
            # churn degrades the fleet, never erases it
            destinations = self.churn_injector.mangle_members(
                f"discovery.refresh.{service_name}",
                destinations) or destinations
        ring.set_members(destinations)
        # breakers of departed members die with the membership
        self.breakers.retain(set(self.ring.members())
                             | set(self.trace_ring.members()))
        if ring is self.ring:
            self._last_destinations = list(destinations)
            if self.grpc_server is not None:
                self.grpc_server.set_destinations(destinations)

    def _refresh_loop(self):
        while not self._stop.wait(self.refresh_interval):
            self.refresh_destinations()

    # -- proxying -------------------------------------------------------

    def proxy_metrics(self, metrics: List[dict], trace_header=None):
        """Hash each metric to its destination, batch, and POST the
        batches in parallel (proxy.go:437-505); ``trace_header`` is the
        inbound ``X-Veneur-Trace`` value, if any."""
        self._fan_out(metrics, self.ring, metric_ring_key, "/import",
                      compress=True, counter="proxied", what="metrics",
                      trace_header=trace_header)

    def proxy_traces(self, traces: List[dict]):
        """Partition Datadog trace spans by trace id over the trace ring
        and POST each batch to ``{dest}/spans``, uncompressed
        (proxy.go:393-434)."""
        self._fan_out(traces, self.trace_ring,
                      lambda t: str(int(t["trace_id"])), "/spans",
                      compress=False, counter="traces_proxied",
                      what="trace spans")

    def _fan_out(self, items: List[dict], ring: ConsistentRing, key_fn,
                 path: str, compress: bool, counter: str, what: str,
                 trace_header=None):
        """Partition, then POST each destination's batch on its own
        thread. A batch resolves through one ``get_many``, one ring
        version, so a refresh mid-batch cannot split it across two
        memberships. A trace-bearing batch runs under a recorder: its
        ``proxy.fan_out`` hop publishes into :attr:`obs_timeline`, and
        every destination POST carries the context re-parented under the
        hop's span."""
        ctx = tracectx.TraceContext.decode(trace_header) \
            if trace_header else None
        rec = fwd_headers = None
        if ctx is not None:
            rec = obs.StageRecorder()
            rec.adopt_trace(ctx.trace_id, parent_id=ctx.parent_id,
                            hop="proxy.fan_out")
            fwd_headers = {tracectx.HEADER:
                           ctx.child(rec.span_id).encode()}
        by_dest: Dict[str, List[dict]] = defaultdict(list)
        dropped = 0
        keyed: List[tuple] = []
        for d in items:
            try:
                keyed.append((key_fn(d), d))
            except (KeyError, TypeError, ValueError):
                dropped += 1
        try:
            owners = ring.get_many([k for k, _ in keyed])
        except EmptyRingError:
            dropped += len(keyed)
            owners = []
        for owner, (_, d) in zip(owners, keyed):
            by_dest[owner].append(d)
        if dropped:
            with self._lock:
                self.dropped += dropped
            log.warning("dropped %d unroutable %s", dropped, what)
        threads = []
        for dest, batch in by_dest.items():
            t = threading.Thread(
                target=self._post_batch,
                args=(dest, batch, path, compress, counter, what),
                kwargs={"headers": fwd_headers, "rec": rec},
                name="proxy-post", daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=self.forward_timeout + 1.0)
        if rec is not None:
            try:
                entry = rec.finish()
                entry.update(what=what, items=len(items),
                             destinations=len(by_dest))
                self.obs_timeline.publish(entry)
            except Exception:  # telemetry must never fail a fan-out
                log.exception("proxy hop publication failed")

    def _post_batch(self, dest: str, batch: List[dict], path: str,
                    compress: bool, counter: str, what: str,
                    headers=None, rec=None):
        t0_ns = time.monotonic_ns()
        try:
            self._post_batch_inner(dest, batch, path, compress, counter,
                                   what, headers)
        finally:
            if rec is not None:
                # each destination's POST is a child stage of the
                # fan-out hop, recorded from its own thread
                rec.record_abs(f"post.{dest}", t0_ns, time.monotonic_ns(),
                               items=len(batch))

    def _post_batch_inner(self, dest: str, batch: List[dict], path: str,
                          compress: bool, counter: str, what: str,
                          headers):
        url = dest.rstrip("/")
        if not url.startswith(("http://", "https://")):
            url = "http://" + url
        # a black-holed global is rejected at once by its breaker and
        # probed again after the reset timeout; the ring is untouched
        breaker = self.breakers.get(dest)
        if not breaker.allow():
            with self._lock:
                self.forward_errors += 1
                self.breaker_rejections += 1
            log.debug("skipping %d %s to %s: circuit breaker open",
                      len(batch), what, dest)
            return

        def on_retry(retry_index, exc, pause):
            with self._lock:
                self.forward_retries += 1

        def post():
            if self.churn_injector is not None and \
                    self.churn_injector.is_partitioned(dest):
                raise faults.InjectedConnectError(
                    f"{dest} is partitioned (injected)")
            return self._post(url + path, batch, compress=compress,
                              timeout=deadline.clamp(self.forward_timeout),
                              headers=headers)

        deadline = Deadline.after(self.forward_timeout)
        try:
            status = post_with_retry(post, self.retry_policy,
                                     deadline=deadline, on_retry=on_retry)
        except Exception as e:
            breaker.record_failure()
            with self._lock:
                self.forward_errors += 1
            log.warning("failed to proxy %d %s to %s: %s",
                        len(batch), what, dest, e)
            return
        if 200 <= status < 300:
            breaker.record_success()
            with self._lock:
                setattr(self, counter, getattr(self, counter) + len(batch))
            return
        # a 4xx proves the destination alive; only transient statuses
        # (5xx/429) count toward its breaker
        if is_transient_status(status):
            breaker.record_failure()
        else:
            breaker.record_success()
        with self._lock:
            self.forward_errors += 1
        log.warning("failed to proxy %d %s to %s: destination returned "
                    "HTTP %d", len(batch), what, dest, status)

    # -- lifecycle ------------------------------------------------------

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else 0

    def vars(self) -> dict:
        """``GET /debug/vars``: the rings and the fan-out counters."""
        ring = {"destinations": len(self.ring), "version": self.ring.version,
                "trace_destinations": len(self.trace_ring),
                "proxied": self.proxied,
                "traces_proxied": self.traces_proxied,
                "forward_errors": self.forward_errors,
                "forward_retries": self.forward_retries,
                "breaker_rejections": self.breaker_rejections,
                "dropped": self.dropped,
                "refresh_failures": self.refresh_failures,
                "refresh_retries": self.refresh_retries}
        out = {"ring": ring, "breakers": dict(self.breakers.states())}
        g = self.grpc_server
        if g is not None:
            out["grpc"] = {"port": g.port, "destinations": len(g.ring),
                           "proxied": g.proxied,
                           "forward_errors": g.forward_errors,
                           "dropped": g.dropped}
        return out

    def start(self):
        """The first refresh (fatal when empty), the refresh loop, the
        HTTP listener and, with ``grpc_forward_address``, the gRPC one
        (proxy.go:206-287)."""
        self.refresh_destinations()
        if len(self.ring) == 0:
            raise RuntimeError(
                "refusing to start with zero destinations (proxy.go:232-243)")
        if (self.accepting_traces and self.trace_service_name
                and len(self.trace_ring) == 0):
            raise RuntimeError("refusing to start with zero trace "
                               "destinations (proxy.go:239-243)")
        needs_refresh = (
            not isinstance(self.discoverer, StaticDiscoverer)
            or (self.trace_discoverer is not None
                and not isinstance(self.trace_discoverer, StaticDiscoverer)))
        if needs_refresh:
            t = threading.Thread(target=self._refresh_loop,
                                 name="proxy-refresh", daemon=True)
            t.start()
            self._threads.append(t)
        host, _, port = (self.config.http_address or "0.0.0.0:8127"
                         ).rpartition(":")
        self._httpd = ReuseportHTTPServer((host or "0.0.0.0", int(port)),
                                          _ProxyHandler)
        self._httpd.daemon_threads = True
        self._httpd.veneur_proxy = self
        # the live debug endpoints (the reference mounts pprof on the
        # proxy's mux too, proxy.go:383-388)
        self._httpd.veneur_get_routes = {
            "/debug/flush-timeline": self.obs_timeline.handler}
        debug.mount(self._httpd.veneur_get_routes.__setitem__,
                    extra_vars=self.vars)
        t = threading.Thread(target=self._httpd.serve_forever,
                             name="proxy-http", daemon=True)
        t.start()
        self._threads.append(t)
        if self.config.grpc_forward_address:
            from veneur_tpu_torch.proxy.grpc_proxy import GRPCProxyServer

            self.grpc_server = GRPCProxyServer(
                destinations=self._last_destinations,
                forward_timeout=self.forward_timeout, dial=self.grpc_dial,
                injector=self.churn_injector)
            self.grpc_server.start(self.config.grpc_forward_address)
        log.info("veneur-proxy listening on port %d with %d destinations",
                 self.port, len(self.ring))

    def shutdown(self):
        self._stop.set()
        if self.grpc_server is not None:
            self.grpc_server.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        for t in self._threads:
            t.join(timeout=5.0)
