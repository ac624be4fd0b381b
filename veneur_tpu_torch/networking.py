"""UDP DogStatsD listeners (SO_REUSEPORT multi-reader).

Port of the UDP half of ``veneur_tpu/networking.py`` (after
``veneur/networking.go`` + ``socket_linux.go``): ``num_readers``
UDP sockets bound to one port with SO_REUSEPORT, so the kernel balances
datagrams across reader threads. TCP, TLS and SSF listeners are not
ported yet.
"""

from __future__ import annotations

import errno
import logging
import select
import socket
import threading
from typing import Callable, List

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
                 stop: threading.Event):
    """Start ``num_readers`` UDP reader threads for one ``udp://`` address
    (networking.go:18-35). Returns (reader threads, already started;
    bound addresses). With port 0 every reader shares the port the first
    one was given."""
    addr = resolve_addr(addr_spec)
    threads: List[threading.Thread] = []
    bound: List[tuple] = []
    for i in range(max(1, num_readers)):
        sock = new_udp_socket(addr, recv_buf, reuse_port=True)
        bound.append(sock.getsockname())
        if addr.port == 0:
            addr = ResolvedAddr(scheme=addr.scheme, host=addr.host,
                                port=sock.getsockname()[1])
        t = threading.Thread(
            target=_udp_read_loop,
            args=(sock, metric_max_length, handle_packet, stop),
            name=f"statsd-udp-reader-{i}", daemon=True)
        t.start()
        threads.append(t)
    return threads, bound


def _udp_read_loop(sock: socket.socket, max_len: int,
                   handle_packet: Callable[[bytes], None],
                   stop: threading.Event):
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
            if data:  # zero-length datagrams are valid UDP; ignore
                handle_packet(data)
    finally:
        sock.close()
