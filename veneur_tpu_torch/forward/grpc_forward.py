"""gRPC forwarding: the ``Forward.SendMetrics`` client and import server.

Port of ``veneur_tpu/forward/grpc_forward.py`` (after ``forwardGRPC``,
flusher.go:424-473, and ``importsrv.Server``, importsrv/server.go:37-147),
without protobuf: grpcio carries raw bytes through generic handlers. A
request is a serialized ``forwardrpc.MetricList``, written by the C++
encoders and ``protocol/mlist.py`` (``encode_forwardable_frames``, the
frames the ``native://`` lane sends), and the reply
``google.protobuf.Empty`` is the empty byte string.

The import server decodes each request in C++ and merges it through
``MetricStore.import_columnar``, the body the ``native://`` lane runs
(``native_transport.import_metric_list``). Unlike the JAX package there
is no protobuf fallback: :meth:`ImportServer.start` raises when the
egress library cannot load. The forwarder sends the flush span's
parent-context headers and the fleet trace plane's ``X-Veneur-Trace`` as
call metadata, lowercased as gRPC requires; the import server reads them
into a ``veneur.import`` span and its ``global.import`` hop
(``obs/tracectx.py``). ``grpc`` is imported where a channel or a
server is made, so the module imports without grpcio; the config
refuses a gRPC key when grpcio is missing.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent import futures
from typing import List, Optional, Sequence, Tuple

from veneur_tpu_torch.forward.native_transport import (
    encode_forwardable_frames, import_metric_list)
from veneur_tpu_torch import trace as vtrace
from veneur_tpu_torch.native import egress
from veneur_tpu_torch.networking import warn_for_stream_addr
from veneur_tpu_torch.obs import tracectx
from veneur_tpu_torch.resilience import (Deadline, RetryPolicy,
                                         call_with_retry)
from veneur_tpu_torch.trace import samples as ssf_samples

log = logging.getLogger("veneur.forward.grpc")

SERVICE = "forwardrpc.Forward"
# forward messages scale with active-series cardinality: 256 MiB covers
# ~2.5M digests an interval a local before chunking is needed
MAX_MESSAGE = 256 * 1024 * 1024
CHANNEL_OPTIONS = (("grpc.max_receive_message_length", MAX_MESSAGE),
                   ("grpc.max_send_message_length", MAX_MESSAGE))
# status codes worth a retry: transient server or transport conditions,
# the gRPC analogue of 5xx/429 (an invalid-argument reply would fail
# the same way on every attempt)
RETRYABLE_CODES = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "RESOURCE_EXHAUSTED",
                   "ABORTED", "UNKNOWN")


def _raw(data: bytes) -> bytes:
    return data


def dial(addr: str, service: str = SERVICE, method: str = "SendMetrics"):
    """A channel to ``addr`` (``host:port``; a ``scheme://`` prefix is
    dropped) and its raw-bytes callable of ``/service/method``
    (``Forward.SendMetrics`` by default)."""
    import grpc

    channel = grpc.insecure_channel(addr.split("://", 1)[-1],
                                    options=list(CHANNEL_OPTIONS))
    send = channel.unary_unary(f"/{service}/{method}",
                               request_serializer=_raw,
                               response_deserializer=_raw)
    return channel, send


def serve(handler, workers: int, service: str = SERVICE,
          method: str = "SendMetrics"):
    """A grpc server whose ``/service/method`` (``Forward.SendMetrics``
    by default) calls ``handler(request bytes, context)`` and answers the
    bytes it returns."""
    import grpc

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=workers),
                         options=list(CHANNEL_OPTIONS))
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        service, {method: grpc.unary_unary_rpc_method_handler(
            handler, request_deserializer=_raw,
            response_serializer=_raw)}),))
    return server


def retryable_rpc(e: BaseException) -> bool:
    """A transient gRPC status, or a socket error."""
    code = e.code() if callable(getattr(e, "code", None)) else None
    return getattr(code, "name", None) in RETRYABLE_CODES \
        or isinstance(e, OSError)


class GRPCForwarder:
    """A local's per-flush gRPC forward of its ForwardableState, with the
    other forwarders' surface (``forward(state, deadline) -> bool``, the
    counters, the retry policy and the breaker). Each frame retries on
    its own inside the flush deadline: a frame the global answered is
    merged there and never sent again."""

    # native MetricList frames cap well under the channel's bound
    CHUNK_BYTES = 64 * 1024 * 1024

    def __init__(self, addr: str, timeout: float = 10.0,
                 compression: float = 100.0,
                 reference_compat: bool = False,
                 retry_policy: RetryPolicy = None, breaker=None,
                 fault_injector=None):
        self.addr = addr.split("://", 1)[-1]
        self.timeout = timeout
        self.compression = compression
        self.reference_compat = reference_compat
        self.retry_policy = retry_policy or RetryPolicy()
        self.breaker = breaker
        # the seeded transport faults, raised before each frame's send
        # attempt as "forward.grpc"
        self._faults = fault_injector
        # the heavy-hitter sketch rides MetricList.topk, which a
        # reference global would skip: off the wire into a reference
        # fleet (the local then emits its own top-k)
        self.supports_topk = not reference_compat
        # device-packed digest planes (tdigest fields 16/17) unless the
        # wire goes to a reference global, which reads full-precision
        # centroids
        self.wants_packed_digests = not reference_compat
        self._channel, self._send = dial(self.addr)
        self._lock = threading.Lock()
        self.forwarded = 0
        self.errors = 0
        self.retries = 0
        # per-forward telemetry: wall seconds of the sends, frame bytes
        # put on the wire, seconds in encode_forwardable_frames
        self.post_durations: List[float] = []
        self.post_content_lengths: List[int] = []
        self.encode_durations: List[float] = []

    def retarget(self, addr: str) -> None:
        """Dial a new destination (a promoted standby): the swap is atomic
        under the counter lock, and the old channel closes after it (an
        RPC it cancels fails into the ordinary retry and error
        accounting)."""
        addr = addr.split("://", 1)[-1]
        if addr == self.addr:
            return
        channel, send = dial(addr)
        with self._lock:
            old, self._channel, self._send = self._channel, channel, send
            self.addr = addr
        old.close()

    def _count_retry(self, retry_index, exc, pause):
        with self._lock:
            self.retries += 1

    def _rejected_by_breaker(self, consume_probe: bool) -> bool:
        """The breaker gate: blocked() before the encode is paid (never
        consumes a half-open probe), allow() at the send (counts the
        probe). Rejections count as errors."""
        if self.breaker is None:
            return False
        rejected = (not self.breaker.allow()) if consume_probe \
            else self.breaker.blocked()
        if rejected:
            with self._lock:
                self.errors += 1
            log.warning("gRPC forward to %s skipped: circuit breaker open",
                        self.addr)
        return rejected

    def forward(self, state, deadline: Deadline = None, parent_span=None,
                trace_ctx=None) -> bool:
        """Encode one ForwardableState and send its frames. Returns True
        once every frame was answered (or there was nothing to send).
        ``parent_span`` and ``trace_ctx`` ride every call's metadata, as
        the HTTP forward's headers."""
        if self._rejected_by_breaker(consume_probe=False):
            return False
        t0 = time.perf_counter()
        frames = encode_forwardable_frames(
            state, self.compression, self.reference_compat, self.CHUNK_BYTES)
        with self._lock:
            self.encode_durations.append(time.perf_counter() - t0)
        if not frames:
            return True
        metadata = [(k.lower(), v) for k, v in (
            parent_span.context_as_parent().items()
            if parent_span is not None else ())]
        if trace_ctx is not None:
            metadata.append((tracectx.HEADER.lower(), trace_ctx.encode()))
        return self.send_frames(frames, deadline,
                                metadata=tuple(metadata) or None)

    def send_frames(self, frames: Sequence[Tuple[bytes, int]],
                    deadline: Deadline = None, metadata=None) -> bool:
        """Send encoded ``(MetricList bytes, rows)`` frames in order, one
        RPC each, each with its own retries inside ``deadline`` and with
        ``metadata`` (lowercase keys)."""
        import grpc

        if deadline is None:
            deadline = Deadline.after(self.timeout)
        if self._rejected_by_breaker(consume_probe=True):
            return False
        sent_rows = 0
        attempted: List[int] = []  # frames actually put on the wire
        t0 = time.perf_counter()
        try:
            for payload, rows in frames:
                def send_frame(payload=payload):
                    if self._faults is not None:
                        self._faults.maybe_fail("forward.grpc")
                    attempted.append(len(payload))
                    self._send(payload, timeout=deadline.clamp(self.timeout),
                               metadata=metadata)

                call_with_retry(send_frame, self.retry_policy,
                                deadline=deadline,
                                retryable=(grpc.RpcError, OSError),
                                retry_if=retryable_rpc,
                                on_retry=self._count_retry)
                sent_rows += rows
        except (grpc.RpcError, OSError) as e:
            # a permanent status proves the destination alive: only
            # transient ones count toward its breaker
            if self.breaker is not None:
                if retryable_rpc(e):
                    self.breaker.record_failure()
                else:
                    self.breaker.record_success()
            with self._lock:
                self.errors += 1
                self.forwarded += sent_rows
            log.warning("failed to forward %d metrics to %s (~%d sent "
                        "before the failure): %s",
                        sum(rows for _, rows in frames), self.addr,
                        sent_rows, e)
            return False
        finally:
            with self._lock:
                self.post_durations.append(time.perf_counter() - t0)
                self.post_content_lengths.extend(attempted)
        if self.breaker is not None:
            self.breaker.record_success()
        with self._lock:
            self.forwarded += sent_rows
        return True

    def close(self):
        self._channel.close()


class ImportServer:
    """The global's gRPC import (importsrv/server.go:37-147): each request
    merges into ``store`` through ``import_columnar``. ``received`` and
    ``import_errors`` count merged and rejected metrics (a request that
    fails whole counts one error and is answered with an error status).
    Each request runs under a ``veneur.import`` span parented on its
    metadata, recorded through ``trace_client``, and with a ``hop_log``
    records its ``global.import`` hop, as the HTTP import does."""

    def __init__(self, store, workers: int = 4, trace_client=None,
                 hop_log=None):
        if store is None:
            raise ValueError("ImportServer needs a store")
        self._store = store
        self._workers = workers
        self._trace_client = trace_client
        self._hop_log = hop_log
        self.received = 0
        self.import_errors = 0
        self._lock = threading.Lock()
        self._grpc = None
        self.port: Optional[int] = None

    def _send_metrics(self, request: bytes, context) -> bytes:
        import grpc

        carrier = dict(context.invocation_metadata() or ())
        span = vtrace.from_headers(carrier, resource="veneur.import")
        span.name = "import"
        t0 = time.perf_counter()
        try:
            n_ok, n_err = import_metric_list(self._store, request)
        except Exception as e:
            log.exception("gRPC import request failed")
            with self._lock:
                self.import_errors += 1
            span.error(e)
            span.finish()
            span.client_record(self._trace_client)
            # not retryable: a request that failed mid-merge must not
            # merge twice
            context.abort(grpc.StatusCode.INTERNAL, f"import failed: {e}")
        with self._lock:
            self.received += n_ok
            self.import_errors += n_err
        span.add(ssf_samples.timing("veneur.import.response_duration_ns",
                                    time.perf_counter() - t0,
                                    {"part": "merge"}),
                 ssf_samples.count("veneur.import.metrics_total",
                                   float(n_ok), None))
        span.finish()
        span.client_record(self._trace_client)
        if self._hop_log is not None:
            # an untraced import still records: counted, unstitchable
            self._hop_log.record("global.import",
                                 tracectx.TraceContext.from_headers(carrier),
                                 span.start, span.end, metrics=n_ok,
                                 protocol="grpc")
        return b""  # google.protobuf.Empty

    def start(self, addr: str = "[::]:0") -> int:
        """Bind and serve; returns the bound port (server.go:1079-1093).
        Raises when the egress library (the C++ decoder) cannot load."""
        egress.load()
        # grpc binds with SO_REUSEPORT: say so when another process
        # already serves the port
        warn_for_stream_addr(addr)
        self._grpc = serve(self._send_metrics, self._workers)
        self.port = self._grpc.add_insecure_port(addr)
        if self.port == 0:
            raise RuntimeError(f"could not bind the gRPC import server to "
                               f"{addr}")
        self._grpc.start()
        log.info("gRPC import server listening on %s (port %d)", addr,
                 self.port)
        return self.port

    def stop(self, grace: float = 1.0):
        if self._grpc is not None:
            self._grpc.stop(grace).wait(timeout=grace + 1.0)
