"""Trace-client backends: UDP packets, and framed SSF on a stream.

Port of ``veneur_tpu/trace/backend.py`` (the reference's
``trace/backend.go``):

- ``PacketBackend`` sends each span as one bare SSF datagram
  (backend.go:94-125); no buffering, no flush.
- ``StreamBackend`` writes framed SSF onto a UNIX or TCP stream through
  an optional buffer. A write error poisons the connection: it is closed
  and re-dialed on the next send, and the span is dropped
  (backend.go:72-84, 183-240).
- ``_dial`` retries with a linearly growing backoff up to a cap, inside
  an overall connect timeout (backend.go:135-180).

Defaults (backend.go:20-37): backoff 10 ms, max backoff 1 s, connect
timeout 10 s.
"""

from __future__ import annotations

import io
import socket
import time
from typing import Optional

from veneur_tpu_torch.protocol import addr as vaddr
from veneur_tpu_torch.protocol import wire

DEFAULT_BACKOFF = 0.010
DEFAULT_MAX_BACKOFF = 1.0
DEFAULT_CONNECT_TIMEOUT = 10.0


class BackendParams:
    def __init__(self, address: str, backoff: float = 0.0,
                 max_backoff: float = 0.0, connect_timeout: float = 0.0,
                 buffer_size: int = 0):
        self.address = address
        self.backoff = backoff or DEFAULT_BACKOFF
        self.max_backoff = max_backoff or DEFAULT_MAX_BACKOFF
        self.connect_timeout = connect_timeout or DEFAULT_CONNECT_TIMEOUT
        self.buffer_size = buffer_size


def _connect_target(resolved: vaddr.ResolvedAddr):
    if resolved.family == "unix":
        return resolved.path
    return (resolved.host or "127.0.0.1", resolved.port)


def _dial_once(resolved: vaddr.ResolvedAddr) -> socket.socket:
    kind = socket.SOCK_DGRAM if resolved.family == "udp" \
        else socket.SOCK_STREAM
    s = socket.socket(resolved.socket_family, kind)
    try:
        s.connect(_connect_target(resolved))
    except OSError:
        s.close()
        raise
    return s


def _dial(params: BackendParams) -> socket.socket:
    """Dial with linear backoff until the connect timeout elapses
    (backend.go:135-180)."""
    resolved = vaddr.resolve_addr(params.address)
    deadline = time.monotonic() + params.connect_timeout
    wait = 0.0
    while True:
        try:
            return _dial_once(resolved)
        except OSError:
            now = time.monotonic()
            if now >= deadline:
                raise
            time.sleep(min(wait, max(deadline - now, 0.0)))
            wait = min(wait + params.backoff, params.max_backoff)


class PacketBackend:
    """UDP: one encoded span a datagram (backend.go:94-125)."""

    def __init__(self, params: BackendParams):
        self.params = params
        self._conn: Optional[socket.socket] = None

    def send_sync(self, span) -> None:
        if self._conn is None:
            self._conn = _dial(self.params)
        self._conn.send(span.SerializeToString())

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None


class StreamBackend:
    """Framed SSF on a stream, optionally buffered (backend.go:128-240)."""

    def __init__(self, params: BackendParams):
        self.params = params
        self._conn: Optional[socket.socket] = None
        self._buffer: Optional[io.BytesIO] = None

    def _connect(self) -> None:
        self._conn = _dial(self.params)
        if self.params.buffer_size > 0:
            self._buffer = io.BytesIO()

    def send_sync(self, span) -> None:
        if self._conn is None:
            self._connect()
        frame = wire.frame_bytes(span)
        if self._buffer is not None:
            self._buffer.write(frame)
            if self._buffer.tell() >= self.params.buffer_size:
                self.flush_sync()
            return
        try:
            self._conn.sendall(frame)
        except OSError:
            # poison pill: drop the span, reconnect at the next send
            self._teardown()
            raise

    def flush_sync(self) -> None:
        """Flush the buffer; a failed flush discards it and forces a
        reconnect (backend.go:226-240)."""
        if self._buffer is None:
            return
        if self._conn is None:
            self._connect()
        data = self._buffer.getvalue()
        self._buffer = io.BytesIO()
        if not data:
            return
        try:
            self._conn.sendall(data)
        except OSError:
            self._teardown()
            raise

    def _teardown(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
        self._conn = None
        if self.params.buffer_size > 0:
            self._buffer = io.BytesIO()

    def close(self) -> None:
        self._teardown()
