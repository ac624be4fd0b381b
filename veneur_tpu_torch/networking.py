"""DogStatsD and SSF listeners (SO_REUSEPORT multi-reader).

Port of ``veneur_tpu/networking.py`` without TLS (after
``veneur/networking.go`` + ``socket_linux.go``): ``num_readers`` UDP
sockets bound to one port with SO_REUSEPORT, so the kernel balances
datagrams across reader threads, for statsd lines and for SSF spans
(one bare SSFSpan a datagram); and UNIX and TCP stream listeners for
framed SSF, one thread a connection. TCP and TLS statsd listeners are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import errno
import logging
import os
import select
import socket
import threading
from typing import Callable, List, Optional

from veneur_tpu_torch.protocol.addr import ResolvedAddr, resolve_addr

log = logging.getLogger("veneur.networking")


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
                 admit: Optional[Callable[[], bool]] = None):
    """Start ``num_readers`` UDP reader threads for one ``udp://`` address
    (networking.go:18-35). Returns (reader threads, already started;
    bound addresses). With port 0 every reader shares the port the first
    one was given. ``admit`` is the overload controller's gate: when it
    returns False the datagram is dropped at the socket (the controller
    counts the shed)."""
    addr = resolve_addr(addr_spec)
    threads: List[threading.Thread] = []
    bound: List[tuple] = []
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


def warn_for_stream_addr(addr_str: str) -> None:
    """Probe a ``host:port`` / ``[v6]:port`` stream address (the gRPC
    listeners' format) with a plain bind before the real, SO_REUSEPORT
    one: when another process already serves the port, say so, since
    the two would split its traffic. Best effort: a probe that cannot
    be made stays quiet and the real bind reports the error."""
    host, _, port_s = addr_str.rpartition(":")
    host = host.strip("[]")
    try:
        port = int(port_s)
    except ValueError:
        return
    if not port:
        return
    if ":" in host or host in ("", "::"):
        family, wildcard = socket.AF_INET6, "::"
    else:
        family, wildcard = socket.AF_INET, "0.0.0.0"
    probe = None
    try:
        probe = socket.socket(family, socket.SOCK_STREAM)
        # REUSEADDR: a TIME_WAIT left by a restart is no second instance
        probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        probe.bind((host or wildcard, port))
    except OSError as e:
        if e.errno == errno.EADDRINUSE:
            log.warning(
                "port %s:%d is already being served by another process; "
                "binding alongside it (SO_REUSEPORT), so its traffic will "
                "be split between the two", host or wildcard, port)
    finally:
        if probe is not None:
            probe.close()


def new_tcp_listener(family: int, host: str, port: int,
                     backlog: int = 128) -> socket.socket:
    """A bound, listening TCP socket with SO_REUSEPORT where available."""
    listener = socket.socket(family, socket.SOCK_STREAM)
    try:
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if hasattr(socket, "SO_REUSEPORT"):
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
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
