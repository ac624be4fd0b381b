"""The generic gRPC span sink: a unary ``SpanSink.SendSpan`` call a span.

Port of ``veneur_tpu/sinks/grpsink.py`` (after
``sinks/grpsink/grpsink.go``) without protobuf: the request is the
span's SSF bytes from the port's codec (``protocol/ssf.py``; a native
reader's ``LazySpan`` hands over the bytes it received) and the reply
``grpsink.Empty`` is the empty byte string, both through the raw-bytes
helpers of ``forward/grpc_forward.py``. A failed call counts a drop and
logs once a connection-state change, so a sink under duress does not
log a line a span (grpsink.go:98-137); ``flush`` logs and resets the
sent and dropped counts (grpsink.go:139-160).

``SpanSinkServer`` is the receiving end (the reference's test server;
in production, Falconer). ``grpc`` is imported where a channel or a
server is made; the config refuses ``falconer_address`` without it.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, List, Optional

from veneur_tpu_torch.forward.grpc_forward import dial, serve
from veneur_tpu_torch.protocol import ssf, wire
from veneur_tpu_torch.sinks.base import SpanSink

log = logging.getLogger("veneur.sinks.grpc")

SERVICE = "grpsink.SpanSink"
METHOD = "SendSpan"


class GRPCSpanSink(SpanSink):
    """Sends each span to a remote gRPC SpanSink service
    (grpsink.go:30-160)."""

    def __init__(self, target: str, name: str = "grpc",
                 timeout: float = 10.0):
        import grpc

        self.target = target
        self._name = name
        self.timeout = timeout
        self._rpc_error = grpc.RpcError
        self._channel, self._send = dial(target, SERVICE, METHOD)
        self._lock = threading.Lock()
        self.sent_count = 0
        self.drop_count = 0
        # one error logged a connection-state change (grpsink.go:115-127)
        self._logged_since_transition = False
        self._channel.subscribe(self._on_state_change)

    @property
    def name(self) -> str:
        return self._name

    def _on_state_change(self, connectivity) -> None:
        with self._lock:
            self._logged_since_transition = False

    def ingest(self, span) -> None:
        if not wire.valid_trace(span):
            raise ValueError("invalid span for gRPC sink")
        try:
            self._send(span.SerializeToString(), timeout=self.timeout)
            with self._lock:
                self.sent_count += 1
        except self._rpc_error as e:
            # counted, not raised: the span worker would log a traceback
            # a span, the spew grpsink.go:115-127 avoids
            with self._lock:
                self.drop_count += 1
                should_log = not self._logged_since_transition
                self._logged_since_transition = True
            if should_log:
                log.error("Error sending span to gRPC sink target %s "
                          "(name=%s): %s", self.target, self._name, e)

    def flush(self) -> None:
        """Log and reset the sent and dropped counts (grpsink.go:139-160)."""
        with self._lock:
            sent, dropped = self.sent_count, self.drop_count
            self.sent_count = 0
            self.drop_count = 0
        if sent or dropped:
            log.info("gRPC span sink %s: %d sent, %d dropped since last "
                     "flush", self._name, sent, dropped)

    def close(self) -> None:
        self._channel.close()


class SpanSinkServer:
    """An in-process gRPC SpanSink service: each received span decoded
    with the port's codec, kept in ``spans`` or handed to ``handler``."""

    def __init__(self, handler: Optional[Callable] = None, workers: int = 4):
        self.spans: List[ssf.SSFSpan] = []
        self._handler = handler
        self._lock = threading.Lock()
        self._grpc = serve(self._send_span, workers, SERVICE, METHOD)
        self.port: Optional[int] = None

    def _send_span(self, request: bytes, context) -> bytes:
        span = ssf.decode_span(request)
        if self._handler is not None:
            self._handler(span)
        else:
            with self._lock:
                self.spans.append(span)
        return b""

    def start(self, addr: str = "[::]:0") -> int:
        self.port = self._grpc.add_insecure_port(addr)
        if self.port == 0:
            raise RuntimeError(f"could not bind span sink server to {addr}")
        self._grpc.start()
        return self.port

    def stop(self, grace: float = 1.0):
        self._grpc.stop(grace).wait(timeout=grace + 1.0)
