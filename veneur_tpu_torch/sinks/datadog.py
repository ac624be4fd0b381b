"""The Datadog sinks: series, service checks and events; and spans.

Port of ``DatadogMetricSink`` in ``veneur_tpu/sinks/datadog.py`` (after
``sinks/datadog/datadog.go``):

- ``flush`` finalizes InterMetrics (the magic ``host:`` / ``device:``
  tags, counters as rates, status rows as service checks;
  datadog.go:245-322) and POSTs them to ``/api/v1/series`` in about
  equal chunks of at most ``flush_max_per_body``, in parallel
  (datadog.go:324-330). Service checks go to ``/api/v1/check_run``
  uncompressed; DogStatsD events arrive through ``flush_other_samples``
  and go to ``/intake`` (datadog.go:155-243).
- ``flush_columnar`` and ``flush_chunk`` take emission blocks: the C++
  serializer (``native/egress.py``) writes the deflated series bodies
  without a Python object a row. A streamed chunk body that fails
  terminally parks for a retry next interval, inside a bytes budget.

Every POST runs the port's retry loop inside the flush deadline and,
when given, a circuit breaker for the API endpoint. The transport is
injectable (``post``), so tests run without a network. Each flush
leaves its marshal and POST seconds and body sizes for the flusher's
``veneur.flush.*`` self-metrics (``drain_flush_telemetry``), and a
streamed chunk records ``post.datadog.serialize`` and
``post.datadog.post`` on the interval's timeline.

``DatadogSpanSink`` keeps the newest ``buffer_size`` spans in a ring
(datadog.go:387-397); each flush groups them by trace id and PUTs
``[[span, ...], ...]`` to the trace agent's ``/v0.3/traces``, without
deflate (datadog.go:460-530).
"""

from __future__ import annotations

import http.client
import json
import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from veneur_tpu_torch.core.columnar import TYPE_COUNTER
from veneur_tpu_torch.forward.http_forward import post_helper
from veneur_tpu_torch.native import egress
from veneur_tpu_torch.obs import recorder as obs_rec
from veneur_tpu_torch.protocol import constants as dogstatsd
from veneur_tpu_torch.protocol import wire
from veneur_tpu_torch.resilience import (RetryPolicy, is_transient_status,
                                         post_with_retry)
from veneur_tpu_torch.samplers.intermetric import InterMetric, MetricType
from veneur_tpu_torch.sinks.base import MetricSink, SpanSink

log = logging.getLogger("veneur.sinks.datadog")

# post(url, payload, compress=, precompressed=, method=) -> HTTP status
PostFn = Callable[..., int]

DATADOG_RESOURCE_KEY = "resource"
DATADOG_SPAN_TYPE = "web"

# deflate level of the native serializer: level 1 runs about twice
# zlib's default 6 at a ~12% ratio cost
COMPRESS_LEVEL = 1


def _default_post(url: str, payload, compress: bool = True,
                  precompressed: bool = False, method: str = "POST") -> int:
    return post_helper(url, payload, compress=compress,
                       precompressed=precompressed, method=method)


def _ok(status: int) -> bool:
    """Success statuses per the reference's PostHelper
    (http/http.go:230-236): 200 or 202."""
    return status in (200, 202)


def _body_rows(n: int, max_per_body: int, n_bodies: int) -> list:
    """Emissions in each of one block's serialized bodies: the native
    serializer closes a body at exactly ``max_per_body`` emissions, so
    every body but the last holds max_per_body rows (the split the
    per-chunk conservation accounting relies on)."""
    if n_bodies <= 1:
        return [n]
    return [max_per_body] * (n_bodies - 1) + \
        [n - max_per_body * (n_bodies - 1)]


class DatadogMetricSink(MetricSink):
    """Flushes to the Datadog v1 series API (datadog.go:34-357)."""

    def __init__(self, interval: float, flush_max_per_body: int,
                 hostname: str, tags: Sequence[str], dd_hostname: str,
                 api_key: str, post: Optional[PostFn] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 breaker=None, fault_injector=None,
                 requeue_max_bytes: int = 32 * 1048576):
        self.interval = interval
        self.flush_max_per_body = max(1, flush_max_per_body)
        self.hostname = hostname
        self.tags = list(tags)
        self.dd_hostname = dd_hostname.rstrip("/")
        self.api_key = api_key
        self.post = post or _default_post
        # the seeded transport faults, around every POST as "sink.datadog"
        if fault_injector is not None:
            self.post = fault_injector.wrap_post(self.post, "sink.datadog")
        self.retry_policy = retry_policy or RetryPolicy()
        self.breaker = breaker
        self.retries = 0
        self.metrics_flushed = 0
        self.flush_errors = 0
        self._common_json = ",".join(
            json.dumps(t) for t in self.tags).encode("utf-8")
        # POSTs run on several threads; guards the counters and the
        # requeue buffer
        self._err_lock = threading.Lock()
        # streamed chunk bodies that got no 2xx park here for a retry
        # each interval, bounded by bytes: every emission row is acked,
        # parked (chunk_rows_requeued) or, evicted oldest first past the
        # budget, counted dropped
        self._requeued: deque = deque()
        self.requeue_max_bytes = max(0, requeue_max_bytes)
        self.requeue_max_bodies = 256  # a count bound besides the bytes
        self._requeued_bytes = 0
        self._last_repost_ts = None
        self.chunks_flushed = 0
        self.chunks_requeued_total = 0
        self.chunk_rows_acked = 0
        self.chunk_rows_requeued = 0
        self.chunk_rows_dropped = 0
        # (kind, value) pairs for the flusher's self-metrics: marshal_s,
        # post_s, chunk_marshal_s, chunk_post_s, content_length_bytes
        self._telemetry: List[tuple] = []

    @property
    def name(self) -> str:
        return "datadog"

    def drain_flush_telemetry(self) -> List[tuple]:
        with self._err_lock:
            out, self._telemetry = self._telemetry, []
        return out

    def _url(self, path: str) -> str:
        return f"{self.dd_hostname}{path}?api_key={self.api_key}"

    def _count_error(self) -> None:
        with self._err_lock:
            self.flush_errors += 1

    def _count_retry(self, retry_index, exc, pause) -> None:
        with self._err_lock:
            self.retries += 1

    def _resilient_post(self, call) -> int:
        """Run a POST closure under the retry loop (transport errors and
        5xx/429, backoff clamped to the flush deadline) and the breaker.
        An open breaker raises OSError, counted by the caller's error
        path."""
        if self.breaker is not None and not self.breaker.allow():
            raise OSError("datadog circuit breaker open")
        try:
            status = post_with_retry(call, self.retry_policy,
                                     deadline=self.flush_deadline,
                                     on_retry=self._count_retry)
        except OSError:
            if self.breaker is not None:
                self.breaker.record_failure()
            raise
        if self.breaker is not None:
            # a 4xx still proves the destination is alive; only
            # transient statuses count toward tripping the breaker
            if is_transient_status(status):
                self.breaker.record_failure()
            else:
                self.breaker.record_success()
        return status

    # -- columnar and streamed egress ---------------------------------------

    def flush_columnar(self, batch) -> None:
        """Serialize the flush's emission blocks to deflated series bodies
        in C++ and POST them in parallel; the extras (status checks,
        routed rows) take the per-row path."""
        bodies: List[bytes] = []
        t_marshal = time.perf_counter()
        for blk in batch.blocks:
            bodies.extend(self._serialize_block(blk, batch.timestamp))
        t_marshal = time.perf_counter() - t_marshal
        threads = [threading.Thread(target=self._flush_body, args=(body,),
                                    daemon=True) for body in bodies]
        t_post = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        t_post = time.perf_counter() - t_post
        with self._err_lock:
            self._telemetry += [("marshal_s", t_marshal), ("post_s", t_post)]
            self._telemetry += [("content_length_bytes", len(b))
                                for b in bodies]
        self.metrics_flushed += sum(len(b) for b in batch.blocks)
        if batch.extras:
            self.flush(batch.extras)

    def flush_chunk(self, chunk) -> None:
        """Streaming egress: serialize, deflate and POST one completed
        group's chunk while later groups still fetch. Every emission row
        either reaches a 2xx body (``chunk_rows_acked``) or its body
        parks for a retry next interval (``chunk_rows_requeued``); past
        the ``requeue_max_bytes`` budget the oldest parked bodies drop,
        counted (``chunk_rows_dropped``)."""
        # normally a no-op: the stream worker reposted already for this
        # interval; hand-built chunks (cycle 0) key on the timestamp
        self.repost_requeued(chunk.cycle or chunk.timestamp)
        rec = obs_rec.current()
        t0_ns = time.monotonic_ns()
        bodies = []
        for blk in chunk.blocks:
            blk_bodies = self._serialize_block(blk, chunk.timestamp)
            bodies.extend(zip(blk_bodies,
                              _body_rows(len(blk), self.flush_max_per_body,
                                         len(blk_bodies))))
        t1_ns = time.monotonic_ns()
        for body, nrows in bodies:
            self._post_chunk_body(body, nrows)
        t2_ns = time.monotonic_ns()
        if rec is not None:
            rec.record_abs(f"post.{self.name}.serialize", t0_ns, t1_ns,
                           chunk=chunk.seq)
            rec.record_abs(f"post.{self.name}.post", t1_ns, t2_ns,
                           chunk=chunk.seq, rows=chunk.rows,
                           bytes=sum(len(b) for b, _ in bodies))
        with self._err_lock:
            # chunk kinds: the chunk's own timeline stages carry its lanes
            self._telemetry += [("chunk_marshal_s", (t1_ns - t0_ns) / 1e9),
                                ("chunk_post_s", (t2_ns - t1_ns) / 1e9)]
            self._telemetry += [("content_length_bytes", len(b))
                                for b, _ in bodies]
            self.chunks_flushed += 1
            self.metrics_flushed += chunk.rows

    def _serialize_block(self, blk, timestamp: int) -> List[bytes]:
        """One emission block -> deflated series bodies: counters become
        rates (datadog.go:295-297), then the native serializer. The
        batch and streamed paths share it, so their wire format cannot
        diverge."""
        values = blk.values
        if (blk.type_codes == TYPE_COUNTER).any():
            values = np.where(blk.type_codes == TYPE_COUNTER,
                              values / self.interval, values)
        return egress.dd_series_bodies(
            blk.names, blk.tags, blk.suffixes, blk.rows, blk.suffix_idx,
            values, blk.type_codes, timestamp=timestamp,
            interval=int(self.interval), default_host=self.hostname,
            common_tags_json=self._common_json,
            max_per_body=self.flush_max_per_body,
            compress_level=COMPRESS_LEVEL)

    def _post_chunk_body(self, body: bytes, nrows: int) -> bool:
        """POST one serialized chunk body; a terminal failure parks it.
        The catch is broad on purpose (transport OSErrors and protocol
        HTTPExceptions alike): any escape would leave the body's rows
        neither acked, parked nor dropped."""
        try:
            status = self._resilient_post(lambda: self.post(
                self._url("/api/v1/series"), body, precompressed=True))
            if _ok(status):
                with self._err_lock:
                    self.chunk_rows_acked += nrows
                return True
            log.warning("Datadog chunk POST returned HTTP %d", status)
            self._count_error()
        except (OSError, http.client.HTTPException):
            log.warning("error POSTing chunk body to Datadog",
                        exc_info=True)
            self._count_error()
        with self._err_lock:
            self._park_locked(body, nrows)
        return False

    def _park_locked(self, body: bytes, nrows: int) -> None:
        """Park one unacked body for the next interval's repost, evicting
        the oldest parked bodies (counted ``chunk_rows_dropped``) until
        the bytes budget and the body-count bound admit it; a body alone
        past the whole budget drops outright. Caller holds
        ``_err_lock``."""
        if len(body) > self.requeue_max_bytes:
            self.chunk_rows_dropped += nrows
            return
        while self._requeued and (
                self._requeued_bytes + len(body) > self.requeue_max_bytes
                or len(self._requeued) >= self.requeue_max_bodies):
            old_body, old_rows = self._requeued.popleft()
            self._requeued_bytes -= len(old_body)
            self.chunk_rows_dropped += old_rows
        self._requeued.append((body, nrows))
        self._requeued_bytes += len(body)
        self.chunk_rows_requeued += nrows

    def repost_requeued(self, cycle: int) -> None:
        """Parked bodies get one more POST an interval; ``cycle`` is the
        interval's dedup key (the stream's flush-cycle id, or a
        hand-built chunk's timestamp). A body that fails again re-parks
        through the same budget, so an outage of many intervals keeps
        the freshest budget's worth and drops, counted, only past it."""
        with self._err_lock:
            if cycle == self._last_repost_ts:
                return
            self._last_repost_ts = cycle
            if not self._requeued:
                return
            pending, self._requeued = list(self._requeued), deque()
            self._requeued_bytes = 0
            self.chunks_requeued_total += len(pending)
        for body, nrows in pending:
            self._post_chunk_body(body, nrows)

    def chunk_rows_pending(self) -> int:
        """Rows parked for the next interval's retry."""
        with self._err_lock:
            return sum(n for _b, n in self._requeued)

    def chunk_requeue_bytes(self) -> int:
        """Serialized bytes parked, bounded by ``requeue_max_bytes``."""
        with self._err_lock:
            return self._requeued_bytes

    def _flush_body(self, body: bytes) -> None:
        try:
            status = self._resilient_post(lambda: self.post(
                self._url("/api/v1/series"), body, precompressed=True))
            if not _ok(status):
                log.warning("Datadog series flush returned HTTP %d", status)
                self._count_error()
        except OSError:
            log.warning("error flushing metrics to Datadog", exc_info=True)
            self._count_error()

    # -- per-row egress -----------------------------------------------------

    def flush(self, metrics: List[InterMetric]) -> None:
        t_marshal = time.perf_counter()
        dd_metrics, checks = self.finalize_metrics(metrics)
        t_marshal = time.perf_counter() - t_marshal
        if checks:
            # check_run takes an array but not deflate (datadog.go:113-116)
            try:
                status = self._resilient_post(lambda: self.post(
                    self._url("/api/v1/check_run"), checks,
                    compress=False))
                if not _ok(status):
                    log.warning("Datadog check_run returned HTTP %d", status)
                    self._count_error()
            except OSError:
                log.warning("error flushing checks to Datadog",
                            exc_info=True)
                self._count_error()
        if not dd_metrics:
            return
        # equal-size chunks under flush_max_per_body, rounding-up division
        # (datadog.go:127-146)
        workers = ((len(dd_metrics) - 1) // self.flush_max_per_body) + 1
        chunk_size = ((len(dd_metrics) - 1) // workers) + 1
        threads = [threading.Thread(
            target=self._flush_part,
            args=(dd_metrics[i * chunk_size:(i + 1) * chunk_size],),
            daemon=True) for i in range(workers)]
        t_post = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        with self._err_lock:
            self._telemetry += [("marshal_s", t_marshal),
                                ("post_s", time.perf_counter() - t_post)]
        self.metrics_flushed += len(dd_metrics)

    def _flush_part(self, chunk: List[dict]) -> None:
        try:
            status = self._resilient_post(lambda: self.post(
                self._url("/api/v1/series"), {"series": chunk}))
            if not _ok(status):
                log.warning("Datadog series flush returned HTTP %d", status)
                self._count_error()
        except OSError:
            log.warning("error flushing metrics to Datadog", exc_info=True)
            self._count_error()

    def finalize_metrics(self, metrics: List[InterMetric]):
        """InterMetric -> DDMetric and DDServiceCheck dicts
        (datadog.go:245-322)."""
        dd_metrics: List[dict] = []
        checks: List[dict] = []
        for m in metrics:
            if not m.is_acceptable_to(self.name):
                continue
            tags = list(self.tags)
            hostname = ""
            devicename = ""
            for tag in m.tags:
                if tag.startswith("host:"):
                    hostname = tag[5:]
                elif tag.startswith("device:"):
                    devicename = tag[7:]
                else:
                    tags.append(tag)
            if not hostname:
                hostname = m.hostname or self.hostname
            if m.type == MetricType.STATUS:
                checks.append({
                    "check": m.name,
                    "status": int(m.value),
                    "timestamp": m.timestamp,
                    "message": m.message,
                    "host_name": hostname,
                    "tags": tags,
                })
                continue
            if m.type == MetricType.COUNTER:
                # counters become rates for Datadog (datadog.go:295-297)
                metric_type = "rate"
                value = m.value / self.interval
            elif m.type == MetricType.GAUGE:
                metric_type = "gauge"
                value = m.value
            else:
                log.warning("unknown metric type %s", m.type)
                continue
            dd_metrics.append({
                "metric": m.name,
                "points": [[float(m.timestamp), value]],
                "tags": tags,
                "type": metric_type,
                "interval": int(self.interval),
                "host": hostname,
                "device_name": devicename,
            })
        return dd_metrics, checks

    def flush_other_samples(self, samples) -> None:
        """DogStatsD events -> ``/intake`` (datadog.go:155-243)."""
        events = []
        for sample in samples:
            tags = dict(sample.tags)
            if dogstatsd.EVENT_IDENTIFIER_KEY not in tags:
                log.warning("received a non-event SSF sample in "
                            "flush_other_samples")
                continue
            del tags[dogstatsd.EVENT_IDENTIFIER_KEY]
            event = {
                "msg_title": sample.name,
                "msg_text": sample.message,
                "timestamp": sample.timestamp,
                "priority": "normal",
                "alert_type": "info",
            }
            for tag, key in (
                    (dogstatsd.EVENT_AGGREGATION_KEY_TAG, "aggregation_key"),
                    (dogstatsd.EVENT_PRIORITY_TAG, "priority"),
                    (dogstatsd.EVENT_SOURCE_TYPE_TAG, "source_type_name"),
                    (dogstatsd.EVENT_ALERT_TYPE_TAG, "alert_type")):
                if tag in tags:
                    event[key] = tags.pop(tag)
            event["host"] = tags.pop(dogstatsd.EVENT_HOSTNAME_TAG,
                                     self.hostname)
            event["tags"] = [f"{k}:{v}" for k, v in tags.items()] + self.tags
            events.append(event)
        if not events:
            return
        try:
            status = self._resilient_post(lambda: self.post(
                self._url("/intake"), {"events": {"api": events}}))
            if not _ok(status):
                log.warning("Datadog event intake returned HTTP %d", status)
                self._count_error()
        except OSError:
            log.warning("error flushing events to Datadog", exc_info=True)
            self._count_error()


class DatadogSpanSink(SpanSink):
    """Ring-buffered span sink for the Datadog trace agent
    (datadog.go:359-530)."""

    def __init__(self, trace_address: str, buffer_size: int = 16384,
                 post: Optional[PostFn] = None,
                 retry_policy: Optional[RetryPolicy] = None):
        self.trace_address = trace_address.rstrip("/")
        self.buffer_size = buffer_size
        # the reference's container/ring: the newest buffer_size spans
        # win (datadog.go:395-397)
        self._buffer: deque = deque(maxlen=buffer_size)
        self._lock = threading.Lock()
        self.post = post or _default_post
        self.retry_policy = retry_policy or RetryPolicy()
        self.retries = 0
        self.spans_flushed = 0

    def _count_retry(self, retry_index, exc, pause) -> None:
        with self._lock:
            self.retries += 1

    @property
    def name(self) -> str:
        return "datadog"

    def ingest(self, span) -> None:
        if not wire.valid_trace(span):
            raise ValueError("invalid span for datadog sink")
        with self._lock:
            self._buffer.append(span)

    def flush(self) -> None:
        with self._lock:
            spans = list(self._buffer)
            self._buffer.clear()
        if not spans:
            return
        trace_map: Dict[int, List[dict]] = {}
        for span in spans:
            tags = dict(span.tags)
            resource = tags.pop(DATADOG_RESOURCE_KEY, "") or "unknown"
            trace_map.setdefault(span.trace_id, []).append({
                "trace_id": span.trace_id,
                "span_id": span.id,
                "parent_id": max(span.parent_id, 0),
                "service": span.service,
                "name": span.name or "unknown",
                "resource": resource,
                "start": span.start_timestamp,
                "duration": span.end_timestamp - span.start_timestamp,
                "type": DATADOG_SPAN_TYPE,
                "error": 2 if span.error else 0,
                "meta": tags,
            })
        # spans grouped by trace (datadog.go:503-508)
        final_traces = list(trace_map.values())
        try:
            status = post_with_retry(
                lambda: self.post(f"{self.trace_address}/v0.3/traces",
                                  final_traces, compress=False,
                                  method="PUT"),
                self.retry_policy, on_retry=self._count_retry)
        except OSError:
            log.warning("error flushing traces to Datadog", exc_info=True)
            return
        if _ok(status):
            with self._lock:
                self.spans_flushed += len(spans)
        else:
            log.warning("Datadog trace flush returned HTTP %d", status)
