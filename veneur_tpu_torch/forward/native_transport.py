"""Framed-TCP MetricList transport: the global tier's binary import lane.

Port of ``veneur_tpu/forward/native_transport.py``. An extension of the
framework (the reference speaks HTTP and gRPC): a 4-byte length frame
around a serialized ``MetricList``, received with ``recv_into``,
decoded in C++ and merged through ``MetricStore.import_columnar``
(``importsrv/server.go:37-147`` is the behavioural spec).

Wire: connect, the client sends the magic ``VNI1``, then per message
``u32 BE length + MetricList bytes``; the server answers each frame with
a ``u32 BE`` merged-row count (``0xFFFFFFFF``: the frame failed to
decode or merge; the stream stays framed and usable). One connection
serves many intervals; the client reconnects after an error.

Enable: a global sets ``native_import_address``; a local sets
``forward_address: "native://host:port"``. Unlike the JAX package there
is no protobuf fallback: the C++ egress library must load
(``native/egress.py``), or the import frame fails and the forward
raises.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time
from typing import List, Optional, Tuple

from veneur_tpu_torch.core.store import PackedDigestPlanes
from veneur_tpu_torch.forward.convert import metric_lists_from_state
from veneur_tpu_torch.native import egress
from veneur_tpu_torch.networking import new_tcp_listener
from veneur_tpu_torch.protocol import mlist
from veneur_tpu_torch.resilience import (Deadline, RetryPolicy,
                                         call_with_retry)

log = logging.getLogger("veneur.forward.native")

MAGIC = b"VNI1"
ACK_ERROR = 0xFFFFFFFF
# forward messages scale with active-series cardinality (the JAX
# package's gRPC channel bound)
MAX_FRAME = 256 * 1024 * 1024


def _read_exact(sock: socket.socket, n: int,
                stop: Optional[threading.Event] = None
                ) -> Optional[memoryview]:
    """Read exactly n bytes; None on a clean EOF at the read's start, a
    SHORT view on an EOF mid-read. With ``stop``, a socket timeout only
    polls the flag and keeps waiting (a connection idles between flush
    intervals); without it, the timeout propagates."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            r = sock.recv_into(view[got:], n - got)
        except socket.timeout:
            if stop is None:
                raise
            if stop.is_set():
                return None if got == 0 else view[:got]
            continue
        if r == 0:
            return None if got == 0 else view[:got]
        got += r
    return view


def encode_forwardable_frames(state, compression: float,
                              reference_compat: bool,
                              chunk_bytes: int) -> List[Tuple[bytes, int]]:
    """ForwardableState -> ``[(serialized MetricList, rows)]``: the
    columnar digest groups (dense or packed planes) through the C++
    encoders, the rest through ``metric_lists_from_state``, every frame
    at most ``chunk_bytes`` but for a single metric larger alone. Each
    frame is a complete MetricList (protobuf messages concatenate). The
    counterpart of the JAX package's ``encode_forwardable_frames``
    (``forward/grpc_forward.py:35``); as there, the native and the gRPC
    forwarders (``grpc_forward.py``) share it. Unlike it, the rest of
    the state is cut to ``chunk_bytes`` too: one frame holds at most
    ``MAX_FRAME``, under the gRPC channel's bound."""
    frames = []
    for attr, pb_type in (("histograms_columnar", mlist.HISTOGRAM),
                          ("timers_columnar", mlist.TIMER)):
        col = getattr(state, attr)
        if col is None:
            continue
        if isinstance(col[2], PackedDigestPlanes):
            names, tags, planes = col
            chunks = egress.encode_digest_metrics_packed(
                names, tags, planes, pb_type, compression,
                max_body_bytes=chunk_bytes,
                reference_compat=reference_compat)
            n_raw = planes.nrows
        else:
            names, tags, means, weights, dmins, dmaxs = col
            chunks = egress.encode_digest_metrics(
                names, tags, means, weights, dmins, dmaxs, pb_type,
                compression, max_body_bytes=chunk_bytes,
                reference_compat=reference_compat)
            n_raw = len(means)
        setattr(state, attr, None)  # consumed
        # rows credit a chunk: a transport failure mid-list must not
        # report rows the global never merged
        per = n_raw // len(chunks) if chunks else 0
        for i, c in enumerate(chunks):
            last = i == len(chunks) - 1
            frames.append((c, n_raw - per * (len(chunks) - 1) if last
                           else per))
    frames += metric_lists_from_state(state, compression,
                                      reference_compat=reference_compat,
                                      max_bytes=chunk_bytes)
    return frames


def import_metric_list(store, data: bytes) -> Tuple[int, int]:
    """Merge one serialized MetricList into ``store``: the C++ decode,
    then ``MetricStore.import_columnar``, the one import body of the
    native and the gRPC lanes. Returns (merged, rejected) metrics;
    raises when the frame cannot be decoded or merged."""
    dec = egress.decode_metric_list(data, copy=False)
    try:
        return store.import_columnar(dec, data)
    finally:
        dec.close()


class NativeImportServer:
    """The global's framed-TCP import; ``received`` and ``import_errors``
    count merged and rejected metrics (a frame that fails whole counts
    one error)."""

    def __init__(self, store, max_frame: int = MAX_FRAME):
        self._store = store
        self._max_frame = max_frame
        self.received = 0
        self.import_errors = 0
        self._lock = threading.Lock()
        self._listener: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._conns: set = set()
        self.port: Optional[int] = None

    def start(self, addr: str = "127.0.0.1:0") -> int:
        host, _, port = addr.rpartition(":")
        # SO_REUSEPORT: two generations can overlap on the import port
        s = new_tcp_listener(socket.AF_INET, host or "127.0.0.1", int(port))
        s.settimeout(0.5)  # the accept loop polls the stop flag
        self._listener = s
        self.port = s.getsockname()[1]
        t = threading.Thread(target=self._accept_loop,
                             name="native-import-accept", daemon=True)
        t.start()
        self._threads.append(t)
        log.info("native import server listening on port %d", self.port)
        return self.port

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, peer = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            # prune finished connection threads (a long-lived global
            # sees many reconnects)
            self._threads = [t for t in self._threads if t.is_alive()]
            with self._lock:
                self._conns.add(conn)
            t = threading.Thread(target=self._serve, args=(conn, peer),
                                 name="native-import-conn", daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn: socket.socket, peer):
        try:
            # the socket timeout is the stop-flag poll period; frame reads
            # pass the stop event, so idle connections outlive any interval
            conn.settimeout(1.0)
            magic = _read_exact(conn, 4, self._stop)
            if magic is None or bytes(magic) != MAGIC:
                log.warning("native import: bad magic from %s", peer)
                return
            while not self._stop.is_set():
                header = _read_exact(conn, 4, self._stop)
                if header is None or len(header) < 4:
                    return  # a clean close, or the peer died mid-header
                (length,) = struct.unpack(">I", header)
                if length == 0 or length > self._max_frame:
                    log.warning("native import: invalid frame length %d "
                                "from %s; closing", length, peer)
                    return
                payload = _read_exact(conn, length, self._stop)
                if payload is None or len(payload) < length:
                    return  # truncated mid-frame: the stream is poisoned
                if self._stop.is_set():
                    return  # a stopped server neither merges nor acks
                conn.sendall(struct.pack(">I", self._merge(bytes(payload))))
        except OSError as e:
            log.debug("native import connection from %s ended: %s", peer, e)
        finally:
            with self._lock:
                self._conns.discard(conn)
            conn.close()

    def _merge(self, data: bytes) -> int:
        try:
            n_ok, n_err = import_metric_list(self._store, data)
        except Exception:
            log.exception("native import frame failed")
            with self._lock:
                self.import_errors += 1
            return ACK_ERROR
        with self._lock:
            self.received += n_ok
            self.import_errors += n_err
        return min(n_ok, ACK_ERROR - 1)

    def stop(self, grace: float = 2.0):
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:  # unblock serve threads waiting on reads
            try:
                c.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=grace)


class NativeForwarder:
    """A local's framed-TCP forward of its ForwardableState, with the
    HTTP forwarder's surface (``forward(state, deadline) -> bool``, the
    counters, the retry policy and the breaker). It does not take
    streamed parts (no ``supports_chunked_forward``): the state goes
    through the batch forward thread."""

    CHUNK_BYTES = 64 * 1024 * 1024

    def __init__(self, addr: str, timeout: float = 10.0,
                 compression: float = 100.0,
                 reference_compat: bool = False,
                 retry_policy: RetryPolicy = None, breaker=None,
                 fault_injector=None):
        if addr.startswith("native://"):
            addr = addr[len("native://"):]
        host, _, port = addr.rpartition(":")
        self._host, self._port = host or "127.0.0.1", int(port)
        self.timeout = timeout
        self.compression = compression
        self.reference_compat = reference_compat
        self.supports_topk = not reference_compat
        # device-packed digest planes (tdigest fields 16/17) unless the
        # wire goes to a reference global, which reads full-precision
        # centroids
        self.wants_packed_digests = not reference_compat
        self.retry_policy = retry_policy or RetryPolicy()
        self.breaker = breaker
        # the seeded transport faults, raised before each send attempt
        # as "forward.native"
        self._faults = fault_injector
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self.forwarded = 0
        self.errors = 0
        self.retries = 0
        # per-forward telemetry: wall seconds, frame bytes put on the wire
        self.post_durations: List[float] = []
        self.post_content_lengths: List[int] = []
        # seconds in encode_forwardable_frames, a forward each
        self.encode_durations: List[float] = []

    def _connect(self, deadline: Deadline) -> socket.socket:
        timeout = deadline.clamp(self.timeout)
        s = socket.create_connection((self._host, self._port),
                                     timeout=timeout)
        s.settimeout(timeout)
        s.sendall(MAGIC)
        return s

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
            log.warning("native forward to %s:%d skipped: circuit breaker "
                        "open", self._host, self._port)
        return rejected

    def forward(self, state, deadline: Deadline = None) -> bool:
        """Send one ForwardableState as frames. Returns True once every
        frame was acked (or there was nothing to send)."""
        if self._rejected_by_breaker(consume_probe=False):
            return False
        t0 = time.perf_counter()
        frames = encode_forwardable_frames(
            state, self.compression, self.reference_compat, self.CHUNK_BYTES)
        with self._lock:
            self.encode_durations.append(time.perf_counter() - t0)
        if not frames:
            return True
        if deadline is None:
            deadline = Deadline.after(self.timeout)
        attempted: List[int] = []  # frames actually put on the wire
        t_start = time.perf_counter()
        try:
            return self._forward_frames(frames, attempted, deadline)
        finally:
            with self._lock:
                self.post_durations.append(time.perf_counter() - t_start)
                self.post_content_lengths.extend(attempted)

    def _drop_socket(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _forward_frames(self, frames, attempted: List[int],
                        deadline: Deadline) -> bool:
        if self._rejected_by_breaker(consume_probe=True):
            return False
        # at most once after progress: retry only while nothing has been
        # acked. Once a frame is acked, resending the one in flight could
        # merge it twice upstream if its ack, not the frame, was lost
        # (the framing has no dedupe), so a mid-list failure gives up.
        sent_rows = 0
        next_frame = 0

        def attempt():
            nonlocal sent_rows, next_frame
            if self._faults is not None:
                self._faults.maybe_fail("forward.native")
            if self._sock is None:
                self._sock = self._connect(deadline)
            while next_frame < len(frames):
                payload, rows = frames[next_frame]
                attempted.append(len(payload))
                self._sock.sendall(struct.pack(">I", len(payload)))
                self._sock.sendall(payload)
                ack = _read_exact(self._sock, 4)
                if ack is None or len(ack) < 4:
                    raise OSError("connection closed mid-ack")
                (merged,) = struct.unpack(">I", ack)
                if merged == ACK_ERROR:
                    raise OSError("the global rejected the frame")
                sent_rows += rows
                next_frame += 1

        def on_retry(retry_index, exc, pause):
            self._drop_socket()  # retries run on a fresh connection
            with self._lock:
                self.retries += 1
            log.debug("native forward to %s:%d retrying (frame %d/%d): %s",
                      self._host, self._port, next_frame, len(frames), exc)

        try:
            call_with_retry(attempt, self.retry_policy, deadline=deadline,
                            retryable=(OSError,),
                            retry_if=lambda e: sent_rows == 0,
                            on_retry=on_retry)
        except OSError as e:
            self._drop_socket()
            if self.breaker is not None:
                self.breaker.record_failure()
            with self._lock:
                self.errors += 1
                self.forwarded += sent_rows
            log.warning("failed to forward %d metrics to native://%s:%d "
                        "(~%d sent before the failure): %s",
                        sum(rows for _, rows in frames), self._host,
                        self._port, sent_rows, e)
            return False
        if self.breaker is not None:
            self.breaker.record_success()
        with self._lock:
            self.forwarded += sent_rows
        return True

    def close(self):
        self._drop_socket()
