"""The LightStep span sink: a tracer pool round-robined by trace id.

Port of ``veneur_tpu/sinks/lightstep.py`` (after
``sinks/lightstep/lightstep.go``): ``num_clients`` tracers report to the
collector (an http scheme means plaintext; default port 8080;
lightstep.go:41-110), each span goes to ``tracers[trace_id %
len(tracers)]`` (lightstep.go:146-148) as an OpenTracing-style span:
parent id clamped to 0, the ``error-code``, ``indicator``, ``component``
and ``type`` tags and the error flag, finished at the SSF end timestamp
(lightstep.go:124-175). ``flush`` logs and resets the per-service counts
(lightstep.go:203+).

With an access token each tracer is an :class:`HTTPReportingTracer`: a
bounded buffer (the oldest drop first) and a thread that POSTs the
buffered spans as one JSON report to ``{collector}/api/v2/reports``
with the ``Lightstep-Access-Token`` header, backing off after a failed
POST (whose batch drops: spans are telemetry). Without one, each is a
:class:`BufferingTracer` that keeps them for a caller to drain. A
``tracer_factory`` returning objects with ``report(span_dict)`` (and
optionally ``close()``) can be injected.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional
from urllib.parse import urlparse

from veneur_tpu_torch.forward.http_forward import post_helper
from veneur_tpu_torch.protocol import wire
from veneur_tpu_torch.resilience import RetryPolicy
from veneur_tpu_torch.sinks.base import SpanSink

log = logging.getLogger("veneur.sinks.lightstep")

LIGHTSTEP_DEFAULT_PORT = 8080
LIGHTSTEP_DEFAULT_INTERVAL = 300.0  # 5 minutes (lightstep.go:29)
INDICATOR_SPAN_TAG_NAME = "indicator"
RESOURCE_KEY = "resource"
REPORT_PATH = "/api/v2/reports"


class BufferingTracer:
    """Default tracer: buffers up to ``max_spans`` converted spans for an
    external shipper (the role the LightStep client's in-memory span
    buffer plays, lightstep.go:96-101)."""

    def __init__(self, max_spans: int = 1024):
        self.max_spans = max_spans
        self.spans: List[dict] = []
        self._lock = threading.Lock()
        self.dropped = 0

    def report(self, span: dict) -> None:
        with self._lock:
            if len(self.spans) >= self.max_spans:
                self.dropped += 1
                self.spans.pop(0)
            self.spans.append(span)

    def drain(self) -> List[dict]:
        with self._lock:
            out, self.spans = self.spans, []
            return out

    def close(self) -> None:
        pass


class HTTPReportingTracer(BufferingTracer):
    """Bundled reporting transport: the BufferingTracer's bounded buffer
    plus a daemon thread that drains it every ``report_interval``
    seconds (or when ``max_batch`` spans accumulate) and POSTs one JSON
    report to the collector via the shared ``post_helper``.

    Failure semantics mirror the reference's client behavior: the batch
    in flight is dropped on a failed POST (spans are telemetry, not
    durable data), the buffer keeps absorbing new spans with
    oldest-first drop, and retry waits back off exponentially with full
    jitter (the shared ``resilience.RetryPolicy`` shape, floored at one
    report interval) — the batch-full wake is ignored while failing, so
    an outage under load cannot turn into a tight connect loop
    (cf. trace/backend.go:135-180).
    """

    def __init__(self, host: str, port: int, plaintext: bool,
                 access_token: str, max_spans: int = 1024,
                 report_interval: float = 1.0, max_batch: int = 512,
                 reconnect_period: float = 0.0,
                 retry_policy: Optional[RetryPolicy] = None,
                 **_unused):
        super().__init__(max_spans=max_spans)
        scheme = "http" if plaintext else "https"
        self.url = f"{scheme}://{host}:{port}{REPORT_PATH}"
        self.access_token = access_token
        self.max_batch = max_batch
        self.report_interval = report_interval
        # backoff shape only (the reporter loop never gives up; the
        # buffer's oldest-first drop is the budget): base doubles from
        # one report interval, capped at 32 intervals
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=1, base_interval=report_interval,
            max_interval=report_interval * 32)
        self.reported = 0
        self.retries = 0
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._failures = 0
        self._thread = threading.Thread(target=self._run,
                                        name="lightstep-reporter",
                                        daemon=True)
        self._thread.start()

    def report(self, span: dict) -> None:
        super().report(span)
        with self._lock:
            full = len(self.spans) >= self.max_batch
        if full:
            self._wake.set()

    def _post(self, batch: List[dict]) -> bool:
        try:
            status = post_helper(
                self.url, {"access_token": self.access_token,
                           "spans": batch},
                compress=False,
                headers={"Lightstep-Access-Token": self.access_token})
            if 200 <= status < 300:
                return True
            log.warning("lightstep report to %s got HTTP %d", self.url,
                        status)
        except Exception as e:
            # any transport/protocol error (URLError, OSError, bad
            # status line, ...) must never kill the reporter thread
            log.warning("lightstep report to %s failed: %s", self.url, e)
        return False

    def _run(self) -> None:
        while not self._stop.is_set():
            if self._failures:
                # honor the backoff even if report() keeps setting the
                # batch-full wake during an outage; exponential full
                # jitter, floored at one report interval so a run of
                # small jitter draws cannot tighten into a connect loop
                pause = max(self.report_interval,
                            self.retry_policy.backoff(self._failures - 1))
                self.retries += 1
                self._stop.wait(pause)
                self._wake.clear()
            else:
                self._wake.wait(timeout=self.report_interval)
                self._wake.clear()
            batch = self.drain()
            if not batch:
                continue
            if self._post(batch):
                with self._lock:
                    self.reported += len(batch)
                self._failures = 0
            else:
                # drop the failed batch; back off the next attempt
                with self._lock:
                    self.dropped += len(batch)
                self._failures += 1

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5)
        batch = self.drain()
        if batch:
            self._post(batch)


class LightStepSpanSink(SpanSink):
    """Round-robin tracer-pool span sink (lightstep.go:30-210)."""

    def __init__(self, collector: str, reconnect_period: float = 0.0,
                 maximum_spans: int = 1024, num_clients: int = 1,
                 access_token: str = "",
                 tracer_factory: Optional[Callable[..., object]] = None,
                 retry_policy: Optional[RetryPolicy] = None):
        host = urlparse(collector if "//" in collector
                        else "//" + collector)
        try:
            self.port = host.port or LIGHTSTEP_DEFAULT_PORT
        except ValueError:
            log.warning("Error parsing LightStep port, using default %d",
                        LIGHTSTEP_DEFAULT_PORT)
            self.port = LIGHTSTEP_DEFAULT_PORT
        self.host = host.hostname or "localhost"
        self.plaintext = host.scheme == "http"
        self.access_token = access_token
        if reconnect_period and tracer_factory is None:
            # not silently dead (the repo's config policy): the bundled
            # transports open a fresh connection per report, so the
            # vendored client's periodic-reconnect knob has no effect.
            # Logged once per sink, whatever the client count/transport.
            log.info("lightstep_reconnect_period has no effect on the "
                     "bundled transports (they reconnect per report)")
        self.reconnect_period = reconnect_period or LIGHTSTEP_DEFAULT_INTERVAL
        n = num_clients if num_clients > 0 else 1  # lightstep.go:77-81
        if tracer_factory is not None:
            factory = tracer_factory
        elif access_token:
            # a configured token means "actually ship": use the bundled
            # HTTP reporting transport
            factory = HTTPReportingTracer
        else:
            factory = lambda **kw: BufferingTracer(max_spans=maximum_spans)
        tracer_kwargs = dict(host=self.host, port=self.port,
                             plaintext=self.plaintext,
                             access_token=access_token,
                             max_spans=maximum_spans,
                             reconnect_period=self.reconnect_period)
        if retry_policy is not None:
            # the config-driven backoff shape reaches the reporter;
            # omitted (None) keeps the kwarg out so custom injected
            # factories need not accept it
            tracer_kwargs["retry_policy"] = retry_policy
        self.tracers = [factory(**tracer_kwargs) for _ in range(n)]
        self._lock = threading.Lock()
        self._service_count: Dict[str, int] = {}

    @property
    def name(self) -> str:
        return "lightstep"

    def ingest(self, span) -> None:
        if not wire.valid_trace(span):
            raise ValueError("invalid span for lightstep sink")
        if not self.tracers:
            raise RuntimeError("No lightstep tracer clients initialized")
        parent_id = max(span.parent_id, 0)
        error_code = 1 if span.error else 0
        tags = dict(span.tags)
        tags[RESOURCE_KEY] = tags.get(RESOURCE_KEY, "")
        tags["component"] = span.service
        tags[INDICATOR_SPAN_TAG_NAME] = str(span.indicator).lower()
        tags["type"] = "http"
        tags["error-code"] = error_code
        if error_code:
            tags["error"] = True  # OT-standard error flag
        tracer = self.tracers[span.trace_id % len(self.tracers)]
        tracer.report({
            "operation_name": span.name,
            "trace_id": span.trace_id,
            "span_id": span.id,
            "parent_span_id": parent_id,
            "start_timestamp": span.start_timestamp,
            "end_timestamp": span.end_timestamp,
            "tags": tags,
        })
        service = span.service or "unknown"
        with self._lock:
            self._service_count[service] = (
                self._service_count.get(service, 0) + 1)

    def flush(self) -> None:
        """Report + reset per-service counts (lightstep.go:203+)."""
        with self._lock:
            counts, self._service_count = self._service_count, {}
        for service, count in counts.items():
            log.info("lightstep sink: %d spans flushed for service %s",
                     count, service)

    def close(self) -> None:
        for t in self.tracers:
            close = getattr(t, "close", None)
            if close:
                close()
