"""HTTP forwarding client: deflate-compressed JSON ``POST /import``.

Port of ``veneur_tpu/forward/http_forward.py`` (after ``flushForward`` +
``PostHelper``, flusher.go:292-385 and http/http.go:123-247): JSON
body, zlib deflate ``Content-Encoding``, success = any 2xx (the
reference answers 202). Retries with backoff inside the flush deadline
and a circuit breaker for the destination. The POST carries the flush
span's parent-context headers (http.go:184-188) and the fleet trace
plane's ``X-Veneur-Trace`` (``obs/tracectx.py``).
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request
import zlib
from typing import List

from veneur_tpu_torch.forward.convert import (
    json_metrics_from_state, reference_json_metrics_from_state)
from veneur_tpu_torch.obs import tracectx
from veneur_tpu_torch.resilience import (Deadline, RetryPolicy,
                                         is_transient_status,
                                         post_with_retry)

log = logging.getLogger("veneur.forward.http")


def post_helper(url: str, payload, timeout: float = 10.0,
                compress: bool = True, headers: dict = None,
                method: str = "POST", precompressed: bool = False,
                out_info: dict = None, raw_body: bytes = None) -> int:
    """Send a JSON payload, deflated unless ``compress`` is False
    (http/http.go:123-247), with ``headers`` beside the content ones;
    ``precompressed`` sends ``payload`` bytes as an already-deflated JSON
    body, ``raw_body`` bytes as an uncompressed one (the native
    serializers' outputs). Returns the HTTP status (including non-2xx);
    raises only on transport errors. ``out_info`` (if given) receives
    ``content_length``, the size of the body as sent."""
    hdrs = {"Content-Type": "application/json"}
    if raw_body is not None:
        body = raw_body
    elif precompressed:
        body = payload
        hdrs["Content-Encoding"] = "deflate"
    else:
        body = json.dumps(payload).encode("utf-8")
        if compress:
            body = zlib.compress(body)
            hdrs["Content-Encoding"] = "deflate"
    if headers:
        hdrs.update(headers)
    if out_info is not None:
        out_info["content_length"] = len(body)
    req = urllib.request.Request(url, data=body, headers=hdrs, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        e.close()
        return e.code


class HTTPForwarder:
    """Per-flush HTTP forward of a ForwardableState (flusher.go:292-385).

    ``reference_compat`` emits the reference's own JSONMetric format
    (gob digests, axiomhq sets, LE scalars), for forwarding into a Go
    global; that format cannot carry the heavy-hitter sketch
    (``supports_topk`` False), so such a local emits its own top-k."""

    def __init__(self, addr: str, timeout: float = 10.0,
                 compression: float = 100.0,
                 reference_compat: bool = False,
                 retry_policy: RetryPolicy = None, breaker=None,
                 fault_injector=None):
        self.base = addr.rstrip("/")
        if not self.base.startswith(("http://", "https://")):
            self.base = "http://" + self.base
        self.timeout = timeout
        self.compression = compression
        self.reference_compat = reference_compat
        self.supports_topk = not reference_compat
        # streaming egress (core/pipeline.py ChunkStream): /import merges
        # partial bodies, so a ForwardableState carrying one digest
        # group's planes is a valid POST on its own
        self.supports_chunked_forward = True
        self.retry_policy = retry_policy or RetryPolicy()
        self.breaker = breaker
        # the seeded transport faults (resilience/faults.py), wrapped
        # around each POST attempt as "forward.http"
        self._faults = fault_injector
        # forward() runs on a fresh thread each flush; guard the counters
        self._lock = threading.Lock()
        self.forwarded = 0
        self.errors = 0
        self.retries = 0
        # per-POST telemetry: wall seconds and body bytes as sent
        self.post_durations: List[float] = []
        self.post_content_lengths: List[int] = []

    def _count_retry(self, retry_index, exc, pause):
        with self._lock:
            self.retries += 1

    def _post(self, *args, **kwargs) -> int:
        # post_helper resolved at call time (tests patch the module's
        # name); the fault wrap applies per attempt
        fn = post_helper
        if self._faults is not None:
            fn = self._faults.wrap_post(fn, "forward.http")
        return fn(*args, **kwargs)

    def _rejected_by_breaker(self, consume_probe: bool) -> bool:
        """The breaker gate: blocked() before serialization is paid
        (never consumes a half-open probe), allow() at the send site
        (counts the probe). Rejections count as errors."""
        if self.breaker is None:
            return False
        rejected = (not self.breaker.allow()) if consume_probe \
            else self.breaker.blocked()
        if rejected:
            with self._lock:
                self.errors += 1
            log.warning("forward to %s skipped: circuit breaker open",
                        self.base)
        return rejected

    def body(self, state) -> List[dict]:
        """The JSON entries of one ForwardableState (its digest planes
        are materialized into per-row centroid lists first)."""
        state.materialize_digests()
        if self.reference_compat:
            return reference_json_metrics_from_state(state, self.compression)
        return json_metrics_from_state(state, self.compression)

    def forward(self, state, deadline: Deadline = None, parent_span=None,
                trace_ctx=None) -> bool:
        """POST one ForwardableState. Returns True once the body got a
        2xx (or there was nothing to send). ``parent_span`` (the flush
        span) sends its parent-context headers, so the global's import
        span joins its trace (http/http.go:184-188); ``trace_ctx`` sends
        the one-header hop contract, which the global's hop log adopts."""
        if self._rejected_by_breaker(consume_probe=False):
            return False
        metrics = self.body(state)
        if not metrics:
            return True
        url = self.base + "/import"
        headers = (dict(parent_span.context_as_parent())
                   if parent_span is not None else {})
        if trace_ctx is not None:
            headers[tracectx.HEADER] = trace_ctx.encode()
        info = {}
        t0 = time.perf_counter()
        # the flush deadline bounds every attempt and backoff sleep; a
        # standalone forward budgets its own timeout
        if deadline is None:
            deadline = Deadline.after(self.timeout)
        if self._rejected_by_breaker(consume_probe=True):
            return False
        ok = False
        try:
            status = post_with_retry(
                lambda: self._post(url, metrics,
                                   timeout=deadline.clamp(self.timeout),
                                   headers=headers, out_info=info),
                self.retry_policy, deadline=deadline,
                on_retry=self._count_retry)
            if 200 <= status < 300:
                ok = True
                if self.breaker is not None:
                    self.breaker.record_success()
                with self._lock:
                    self.forwarded += len(metrics)
            else:
                # a 4xx still proves the destination is alive; only
                # transient statuses (5xx/429) count toward tripping
                if self.breaker is not None:
                    if is_transient_status(status):
                        self.breaker.record_failure()
                    else:
                        self.breaker.record_success()
                with self._lock:
                    self.errors += 1
                log.warning("forward to %s returned HTTP %d", url, status)
        except OSError as e:  # urllib.error.URLError is an OSError
            if self.breaker is not None:
                self.breaker.record_failure()
            with self._lock:
                self.errors += 1
            log.warning("failed to forward %d metrics to %s: %s",
                        len(metrics), url, e)
        finally:
            with self._lock:
                self.post_durations.append(time.perf_counter() - t0)
                if "content_length" in info:
                    self.post_content_lengths.append(info["content_length"])
        return ok
