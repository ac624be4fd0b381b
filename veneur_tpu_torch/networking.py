"""DogStatsD and SSF listeners (SO_REUSEPORT multi-reader).

Port of ``veneur_tpu/networking.py`` (after ``veneur/networking.go`` +
``socket_linux.go``): ``num_readers`` UDP sockets bound to one port with
SO_REUSEPORT, so the kernel balances datagrams across reader threads,
for statsd lines and for SSF spans (one bare SSFSpan a datagram); a TCP
statsd listener, newline-framed, optionally TLS with client-certificate
authentication (networking.go:93-134), one thread a connection, where
the handshake runs too; and UNIX and TCP stream listeners for framed
SSF, one thread a connection. This is the Python rung of the TCP/TLS
listener; the server takes the C++ one (``native.NativeTLSReader``)
first.
"""

from __future__ import annotations

import dataclasses
import errno
import logging
import os
import select
import socket
import ssl
import threading
import time
from typing import Callable, List, Optional

from veneur_tpu_torch.protocol.addr import ResolvedAddr, resolve_addr

log = logging.getLogger("veneur.networking")

# a TCP listener's errors log at most once an interval: a persistent
# error (a dead NIC, a client retrying a bad certificate) would otherwise
# log at connection rate
DEFAULT_ERROR_LOG_INTERVAL = 10.0
# a handshake a silent client never finishes ends here
HANDSHAKE_TIMEOUT_S = 10.0


class _LogLimiter:
    """At most one warning every ``interval`` seconds; the ones in
    between are counted and named on the next line that logs. Shared by
    a listener's connection threads."""

    def __init__(self, interval: float = DEFAULT_ERROR_LOG_INTERVAL,
                 clock: Callable[[], float] = time.monotonic):
        self.interval = interval
        self._clock = clock
        self._lock = threading.Lock()
        self._last = -interval
        self.suppressed = 0
        self.emitted = 0

    def warn(self, fmt: str, *args) -> None:
        with self._lock:
            now = self._clock()
            if now - self._last < self.interval:
                self.suppressed += 1
                return
            self._last = now
            suppressed, self.suppressed = self.suppressed, 0
            self.emitted += 1
        if suppressed:
            log.warning(fmt + " (%d similar suppressed in the last "
                        "%.0fs)", *(args + (suppressed, self.interval)))
        else:
            log.warning(fmt, *args)


def new_udp_socket(addr: ResolvedAddr, recv_buf: int,
                   reuse_port: bool) -> socket.socket:
    """A bound UDP socket with SO_REUSEPORT + SO_RCVBUF
    (socket_linux.go:12-76)."""
    sock = socket.socket(addr.socket_family, socket.SOCK_DGRAM)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if reuse_port and hasattr(socket, "SO_REUSEPORT"):
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        if recv_buf:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, recv_buf)
        sock.bind((addr.host, addr.port))
    except OSError:
        sock.close()
        raise
    return sock


def start_statsd(addr_spec: str, num_readers: int, recv_buf: int,
                 metric_max_length: int,
                 handle_packet: Callable[[bytes], None],
                 stop: threading.Event,
                 admit: Optional[Callable[[], bool]] = None,
                 handle_tcp_line: Optional[Callable[[bytes], None]] = None,
                 tls_config: Optional[ssl.SSLContext] = None,
                 error_log_interval: float = DEFAULT_ERROR_LOG_INTERVAL):
    """Start the statsd listener of one address (networking.go:18-35).
    ``udp://``: ``num_readers`` reader threads; with port 0 every reader
    shares the port the first one was given. ``tcp://``: an accept loop
    and a thread a connection, each complete line to
    ``handle_tcp_line`` (``handle_packet`` without it), over TLS with
    ``tls_config``. Returns (threads, already started; bound addresses).
    ``admit`` is the overload controller's gate: when it returns False
    the datagram or line is dropped at the socket (the controller counts
    the shed). A TCP listener's errors log at most once every
    ``error_log_interval`` seconds."""
    addr = resolve_addr(addr_spec)
    threads: List[threading.Thread] = []
    bound: List[tuple] = []
    if addr.family == "tcp":
        listener = new_tcp_listener(addr.socket_family, addr.host,
                                    addr.port)
        bound.append(listener.getsockname())
        t = threading.Thread(
            target=_tcp_accept_loop,
            args=(listener, metric_max_length,
                  handle_tcp_line or handle_packet, stop, tls_config,
                  _LogLimiter(error_log_interval), admit),
            name="statsd-tcp-listener", daemon=True)
        t.start()
        return [t], bound
    if addr.family != "udp":
        raise ValueError(f"statsd listen address must be udp or tcp: "
                         f"{addr_spec}")
    for i in range(max(1, num_readers)):
        sock = new_udp_socket(addr, recv_buf, reuse_port=True)
        bound.append(sock.getsockname())
        if addr.port == 0:
            addr = dataclasses.replace(addr, port=sock.getsockname()[1])
        t = threading.Thread(
            target=_udp_read_loop,
            args=(sock, metric_max_length, handle_packet, stop, admit),
            name=f"statsd-udp-reader-{i}", daemon=True)
        t.start()
        threads.append(t)
    return threads, bound


def _udp_read_loop(sock: socket.socket, max_len: int,
                   handle_packet: Callable[[bytes], None],
                   stop: threading.Event,
                   admit: Optional[Callable[[], bool]] = None):
    """Per-reader receive loop (server.go:795-825): one datagram may hold
    several newline-separated metrics; the socket is polled so the loop
    notices ``stop`` within half a second."""
    try:
        while not stop.is_set():
            ready, _, _ = select.select([sock], [], [], 0.5)
            if not ready:
                continue
            try:
                data = sock.recv(max_len)
            except OSError as e:
                if stop.is_set() or e.errno == errno.EBADF:
                    break
                log.warning("UDP recv error: %s", e)
                continue
            if not data:  # zero-length datagrams are valid UDP; ignore
                continue
            if admit is not None and not admit():
                continue  # shed at the socket; the controller counts it
            handle_packet(data)
    finally:
        sock.close()


def _tcp_accept_loop(listener: socket.socket, max_len: int,
                     handle_line: Callable[[bytes], None],
                     stop: threading.Event,
                     tls_config: Optional[ssl.SSLContext],
                     limiter: _LogLimiter,
                     admit: Optional[Callable[[], bool]] = None):
    """Accept until ``stop`` (server.go:901-1001); each connection, its
    handshake included, runs on a thread of its own."""
    listener.settimeout(0.5)
    try:
        while not stop.is_set():
            try:
                conn, peer = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=_tcp_conn_loop,
                             args=(conn, max_len, handle_line, stop,
                                   tls_config, peer, limiter, admit),
                             name="statsd-tcp-conn", daemon=True).start()
    finally:
        listener.close()


def _tcp_conn_loop(conn: socket.socket, max_len: int,
                   handle_line: Callable[[bytes], None],
                   stop: threading.Event,
                   tls_config: Optional[ssl.SSLContext], peer,
                   limiter: _LogLimiter,
                   admit: Optional[Callable[[], bool]] = None):
    """Split a TCP connection into lines; a line longer than ``max_len``
    closes the connection (server.go:920-983). The TLS handshake runs
    here, not in the accept loop: a client that connects and sends
    nothing wedges only its own thread, and only until the handshake's
    timeout."""
    try:
        if tls_config is not None:
            try:
                conn.settimeout(HANDSHAKE_TIMEOUT_S)
                conn = tls_config.wrap_socket(conn, server_side=True)
            except (ssl.SSLError, OSError) as e:
                limiter.warn("TLS handshake failed from %s: %s", peer, e)
                return
        conn.settimeout(0.5)
        buf = bytearray()
        while not stop.is_set():
            try:
                data = conn.recv(65536)
            except socket.timeout:
                continue
            except OSError as e:
                if not stop.is_set() and e.errno != errno.EBADF:
                    limiter.warn("TCP recv error from %s: %s", peer, e)
                break
            if not data:
                break
            buf.extend(data)
            start = 0
            while True:
                nl = buf.find(b"\n", start)
                if nl == -1:
                    break
                line = bytes(buf[start:nl])
                start = nl + 1
                # the gate the UDP readers apply: TCP statsd sheds at the
                # hard watermark too
                if line and (admit is None or admit()):
                    handle_line(line)
            del buf[:start]
            if len(buf) > max_len:
                limiter.warn("line longer than %d bytes from %s, closing "
                             "the connection", max_len, peer)
                break
    finally:
        conn.close()


def make_server_tls_context(cert_path: str, key_path: str,
                            ca_path: str = "") -> ssl.SSLContext:
    """The TLS listener's context; a CA certificate makes a client
    certificate signed by it required (server.go:314-348)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_path, key_path)
    if ca_path:
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(ca_path)
    return ctx


def warn_if_port_already_served(family: int, kind: int, host: str,
                                port: int) -> None:
    """Probe ``host:port`` with a plain bind before the real, SO_REUSEPORT
    one: when another process already serves the port, say so, since the
    two would split its traffic. An upgrade replacement
    (``VENEUR_READY_FD`` in the environment, ``cli/upgrade.py``) overlaps
    by design and stays quiet. Best effort: a probe that cannot be made
    stays quiet and the real bind reports the error. The TCP probe sets
    SO_REUSEADDR (a TIME_WAIT left by a restart is no second instance);
    a UDP one does not, or it would bind beside a live listener."""
    if port == 0:
        return
    probe = None
    try:
        probe = socket.socket(family, kind)
        if kind == socket.SOCK_STREAM:
            probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        probe.bind((host, port))
    except OSError as e:
        if e.errno == errno.EADDRINUSE:
            from veneur_tpu_torch.cli.upgrade import READY_ENV

            if os.environ.get(READY_ENV):
                return
            log.warning(
                "port %s:%d is already being served by another process; "
                "binding alongside it (SO_REUSEPORT), so its traffic will "
                "be split between the two", host, port)
    finally:
        if probe is not None:
            probe.close()


def warn_for_stream_addr(addr_str: str) -> None:
    """:func:`warn_if_port_already_served` for a ``host:port`` /
    ``[v6]:port`` stream address (the gRPC listeners' format)."""
    host, _, port_s = addr_str.rpartition(":")
    host = host.strip("[]")
    try:
        port = int(port_s)
    except ValueError:
        return
    if ":" in host or host in ("", "::"):
        family, wildcard = socket.AF_INET6, "::"
    else:
        family, wildcard = socket.AF_INET, "0.0.0.0"
    warn_if_port_already_served(family, socket.SOCK_STREAM,
                                host or wildcard, port)


def new_tcp_listener(family: int, host: str, port: int,
                     backlog: int = 128) -> socket.socket:
    """A bound, listening TCP socket with SO_REUSEPORT where available."""
    listener = socket.socket(family, socket.SOCK_STREAM)
    try:
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if hasattr(socket, "SO_REUSEPORT"):
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            warn_if_port_already_served(family, socket.SOCK_STREAM, host,
                                        port)
        listener.bind((host, port))
        listener.listen(backlog)
    except OSError:
        listener.close()
        raise
    return listener


def start_ssf(addr_spec: str, num_readers: int, recv_buf: int,
              trace_max_length: int,
              handle_ssf_packet: Callable[[bytes], None],
              handle_ssf_stream: Callable[[socket.socket], None],
              stop: threading.Event,
              admit: Optional[Callable[[], bool]] = None):
    """Start the SSF listeners of one address (networking.go:138-223):
    ``udp://`` runs ``num_readers`` datagram readers, each datagram one
    bare SSFSpan; ``unix://`` and ``tcp://`` accept streams of framed
    spans, each connection on its own thread. Returns (threads, already
    started; bound addresses: (host, port), or the socket path).
    ``admit`` gates the UDP datagrams as in :func:`start_statsd` (spans
    shed before statsd does)."""
    addr = resolve_addr(addr_spec)
    threads: List[threading.Thread] = []
    bound: list = []
    if addr.family == "udp":
        for i in range(max(1, num_readers)):
            sock = new_udp_socket(addr, recv_buf, reuse_port=True)
            bound.append(sock.getsockname())
            if addr.port == 0:
                addr = dataclasses.replace(addr,
                                           port=sock.getsockname()[1])
            t = threading.Thread(
                target=_udp_read_loop,
                args=(sock, trace_max_length, handle_ssf_packet, stop,
                      admit),
                name=f"ssf-udp-reader-{i}", daemon=True)
            t.start()
            threads.append(t)
        return threads, bound
    if addr.family == "unix":
        if os.path.exists(addr.path):
            os.unlink(addr.path)
        listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            listener.bind(addr.path)
            listener.listen(128)
        except OSError:
            listener.close()
            raise
        bound.append(addr.path)
    else:
        listener = new_tcp_listener(addr.socket_family, addr.host,
                                    addr.port)
        bound.append(listener.getsockname())
    t = threading.Thread(target=_stream_accept_loop,
                         args=(listener, handle_ssf_stream, stop),
                         name=f"ssf-{addr.family}-listener", daemon=True)
    t.start()
    threads.append(t)
    return threads, bound


def _stream_accept_loop(listener: socket.socket,
                        handle_stream: Callable[[socket.socket], None],
                        stop: threading.Event):
    """Accept connections until ``stop``; each connection's stream pump
    runs on a thread of its own and closes the connection."""
    listener.settimeout(0.5)
    try:
        while not stop.is_set():
            try:
                conn, _ = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.settimeout(None)
            threading.Thread(target=handle_stream, args=(conn,),
                             name="ssf-stream", daemon=True).start()
    finally:
        listener.close()
