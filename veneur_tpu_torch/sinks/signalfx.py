"""The SignalFx metric sink: dimension-based datapoints, per-tag API keys.

Port of ``veneur_tpu/sinks/signalfx.py`` (after
``sinks/signalfx/signalfx.go``):

- rows become SignalFx datapoints: counters stay counters, gauges and
  status checks flush as gauges (signalfx.go:195-210); every tag is a
  dimension and so is the host, under ``hostname_tag``, since SignalFx
  has no host field (signalfx.go:169-184); the common dimensions (the
  config's tags) override, and the excluded tag keys drop
  (signalfx.go:185-192, ``set_excluded_tags`` :255);
- ``flush_columnar`` serializes each emission block to one uncompressed
  ``/v2/datapoint`` body in C++ (``native/egress.py``
  ``sfx_datapoint_bodies``) and POSTs the bodies in parallel; a build or
  load failure of the library raises, with no per-row fallback. With
  ``vary_by`` the value of that tag picks a per-tag client (its own API
  key, signalfx.go:31-66, 135-143), which the columnar serializer does
  not model: that configuration takes the per-row ``flush`` on the
  materialized rows, one parallel submission a client, as in the JAX
  package;
- DogStatsD events (``flush_other_samples``) go to ``/v2/event``
  (signalfx.go:227-253).

Every submit runs the port's retry loop inside the flush deadline and,
when given, a circuit breaker for the ingest endpoint. The client is
injectable for tests.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence

from veneur_tpu_torch.forward.http_forward import post_helper
from veneur_tpu_torch.native import egress
from veneur_tpu_torch.protocol import constants as dogstatsd
from veneur_tpu_torch.resilience import (RetryPolicy, is_transient_status,
                                         post_with_retry)
from veneur_tpu_torch.samplers.intermetric import InterMetric, MetricType
from veneur_tpu_torch.sinks.base import MetricSink

log = logging.getLogger("veneur.sinks.signalfx")

EVENT_CATEGORY_USER_DEFINED = "USER_DEFINED"


class SignalFxClient:
    """One SignalFx ingest endpoint and its token (signalfx.go:97-106):
    ``submit`` POSTs ``{"gauge": [...], "counter": [...]}`` to
    ``/v2/datapoint``, ``submit_raw`` a serialized body there,
    ``submit_event`` an event to ``/v2/event``."""

    def __init__(self, endpoint: str, api_key: str, timeout: float = 10.0):
        self.endpoint = endpoint.rstrip("/")
        self.api_key = api_key
        self.timeout = timeout

    def _headers(self) -> dict:
        return {"X-Sf-Token": self.api_key}

    def submit(self, datapoints: List[dict]) -> int:
        # leaves the points as they are: the retry loop may submit again
        body: Dict[str, List[dict]] = {}
        for dp in datapoints:
            body.setdefault(dp.get("_sfx_type", "gauge"), []).append(
                {k: v for k, v in dp.items() if k != "_sfx_type"})
        return post_helper(self.endpoint + "/v2/datapoint", body,
                           timeout=self.timeout, compress=False,
                           headers=self._headers())

    def submit_raw(self, body: bytes) -> int:
        return post_helper(self.endpoint + "/v2/datapoint", None,
                           timeout=self.timeout, compress=False,
                           headers=self._headers(), raw_body=body)

    def submit_event(self, event: dict) -> int:
        return post_helper(self.endpoint + "/v2/event", [event],
                           timeout=self.timeout, compress=False,
                           headers=self._headers())


class SignalFxSink(MetricSink):
    """Dimension-based metric sink with the vary-by-tag client fan-out
    (signalfx.go:79-225). ``drain_flush_telemetry`` gives the flusher
    each columnar flush's serialize and POST seconds and body sizes."""

    def __init__(self, hostname_tag: str, hostname: str,
                 common_dimensions: Optional[Dict[str, str]] = None,
                 client: Optional[SignalFxClient] = None,
                 vary_by: str = "",
                 per_tag_clients: Optional[Dict[str, SignalFxClient]] = None,
                 excluded_tags: Optional[Sequence[str]] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 breaker=None, fault_injector=None):
        self.hostname_tag = hostname_tag
        self.hostname = hostname
        self.common_dimensions = dict(common_dimensions or {})
        self.default_client = client
        self.vary_by = vary_by
        self.clients_by_tag_value = dict(per_tag_clients or {})
        self.excluded_tags = set(excluded_tags or ())
        self.retry_policy = retry_policy or RetryPolicy()
        self.breaker = breaker
        # the seeded transport faults, around every submit as
        # "sink.signalfx"
        self._faults = fault_injector
        # submits run on several threads; guards the counters
        self._lock = threading.Lock()
        self._telemetry: List[tuple] = []
        self.retries = 0
        self.flush_errors = 0
        self.metrics_flushed = 0
        self.metrics_skipped = 0
        self.events_reported = 0

    @property
    def name(self) -> str:
        return "signalfx"

    def set_excluded_tags(self, excludes: Sequence[str]) -> None:
        """SetExcludedTags (signalfx.go:255-262)."""
        self.excluded_tags = set(excludes)

    def drain_flush_telemetry(self) -> List[tuple]:
        with self._lock:
            out, self._telemetry = self._telemetry, []
        return out

    def _count_retry(self, retry_index, exc, pause) -> None:
        with self._lock:
            self.retries += 1

    def _count_error(self) -> None:
        with self._lock:
            self.flush_errors += 1

    def _resilient_submit(self, call) -> int:
        """``call`` under the retry loop and the endpoint's breaker; an
        open breaker raises OSError, which the callers log."""
        if self.breaker is not None and not self.breaker.allow():
            raise OSError("signalfx circuit breaker open")
        if self._faults is not None:
            call = self._faults.wrap_post(call, "sink.signalfx")
        try:
            status = post_with_retry(call, self.retry_policy,
                                     deadline=self.flush_deadline,
                                     on_retry=self._count_retry)
        except OSError:
            if self.breaker is not None:
                self.breaker.record_failure()
            raise
        if self.breaker is not None:
            if is_transient_status(status):
                self.breaker.record_failure()
            else:
                self.breaker.record_success()
        return status

    def _submit(self, what: str, call) -> bool:
        """One submission; a non-2xx reply or a transport error is
        logged and counted in ``flush_errors``."""
        try:
            status = self._resilient_submit(call)
        except OSError:
            log.warning("could not submit %s to signalfx", what,
                        exc_info=True)
            self._count_error()
            return False
        if status >= 300:
            log.warning("signalfx %s submit returned HTTP %d", what, status)
            self._count_error()
            return False
        return True

    def _client(self, key: str) -> SignalFxClient:
        return self.clients_by_tag_value.get(key, self.default_client)

    def _dimensions(self, metric: InterMetric):
        dims = {self.hostname_tag: metric.hostname or self.hostname}
        for tag in metric.tags:
            k, sep, v = tag.partition(":")
            dims[k] = v if sep else ""
        dims.update(self.common_dimensions)
        metric_key = dims.get(self.vary_by, "") if self.vary_by else ""
        for k in self.excluded_tags:
            dims.pop(k, None)
        dims.pop("veneursinkonly", None)
        return dims, metric_key

    def flush_columnar(self, batch) -> None:
        """One uncompressed body a block from the C++ serializer, POSTed
        in parallel; the extras take the per-row path. With ``vary_by``
        the whole flush does."""
        if self.vary_by or self.default_client is None:
            self.flush(batch.to_intermetrics())
            return
        excluded = set(self.excluded_tags)
        common = {k: v for k, v in self.common_dimensions.items()
                  if k not in excluded}
        common_json = ",".join(
            f"{json.dumps(k)}:{json.dumps(v)}"
            for k, v in common.items()).encode("utf-8")
        t_marshal = time.perf_counter()
        bodies: List[bytes] = []
        for blk in batch.blocks:
            bodies.extend(egress.sfx_datapoint_bodies(
                blk.names, blk.tags, blk.suffixes, blk.rows,
                blk.suffix_idx, blk.values, blk.type_codes,
                timestamp_ms=batch.timestamp * 1000,
                hostname_tag=(self.hostname_tag
                              if self.hostname_tag not in excluded
                              else ""),
                hostname=self.hostname, common_dims_json=common_json,
                common_keys=[k.encode() for k in common],
                excluded_keys=[k.encode() for k in excluded]))
            # counted whatever the POST's outcome, as the per-row flush
            # counts (failures are logged and counted as errors)
            self.metrics_flushed += len(blk)
        t_marshal = time.perf_counter() - t_marshal
        client = self.default_client
        threads = [threading.Thread(
            target=self._submit, args=("datapoint", lambda b=body:
                                       client.submit_raw(b)),
            name="signalfx-post", daemon=True) for body in bodies]
        t_post = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        t_post = time.perf_counter() - t_post
        with self._lock:
            self._telemetry += [("marshal_s", t_marshal), ("post_s", t_post)]
            self._telemetry += [("content_length_bytes", len(b))
                                for b in bodies]
        if batch.extras:
            self.flush(batch.extras)

    def flush(self, metrics: List[InterMetric]) -> None:
        points_by_key: Dict[str, List[dict]] = {"": []}
        for m in metrics:
            if not m.is_acceptable_to(self.name):
                self.metrics_skipped += 1
                continue
            dims, metric_key = self._dimensions(m)
            if m.type == MetricType.COUNTER:
                point = {"_sfx_type": "counter", "metric": m.name,
                         "dimensions": dims, "value": int(m.value),
                         "timestamp": m.timestamp * 1000}
            else:
                # gauges and status checks both flush as gauges
                # (signalfx.go:195-207)
                point = {"_sfx_type": "gauge", "metric": m.name,
                         "dimensions": dims, "value": m.value,
                         "timestamp": m.timestamp * 1000}
            points_by_key.setdefault(metric_key, []).append(point)
            self.metrics_flushed += 1
        if self.default_client is None:
            return
        # one parallel submission a client (signalfx.go:44-66)
        threads = []
        for key, points in points_by_key.items():
            if not points:
                continue
            client = self._client(key)
            t = threading.Thread(
                target=self._submit,
                args=("datapoint", lambda c=client, p=points: c.submit(p)),
                name="signalfx-post", daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join()

    def flush_other_samples(self, samples) -> None:
        """Events to ``/v2/event``; other samples are ignored
        (signalfx.go:227-253)."""
        if self.default_client is None:
            return
        for sample in samples:
            if dogstatsd.EVENT_IDENTIFIER_KEY not in sample.tags:
                continue
            dims = dict(sample.tags)
            del dims[dogstatsd.EVENT_IDENTIFIER_KEY]
            for magic in (dogstatsd.EVENT_AGGREGATION_KEY_TAG,
                          dogstatsd.EVENT_ALERT_TYPE_TAG,
                          dogstatsd.EVENT_PRIORITY_TAG,
                          dogstatsd.EVENT_SOURCE_TYPE_TAG):
                dims.pop(magic, None)
            if dogstatsd.EVENT_HOSTNAME_TAG in dims:
                dims[self.hostname_tag] = dims.pop(
                    dogstatsd.EVENT_HOSTNAME_TAG)
            else:
                dims[self.hostname_tag] = self.hostname
            dims.update(self.common_dimensions)
            for k in self.excluded_tags:
                dims.pop(k, None)
            event = {
                "eventType": sample.name,
                "category": EVENT_CATEGORY_USER_DEFINED,
                "dimensions": dims,
                "properties": {"description": sample.message},
                "timestamp": sample.timestamp * 1000,
            }
            if self._submit("event", lambda e=event:
                            self.default_client.submit_event(e)):
                with self._lock:
                    self.events_reported += 1
