"""URL-style listen-address resolution for UDP (cf.
veneur/protocol/addr.go), e.g. ``udp://127.0.0.1:8126``."""

from __future__ import annotations

import socket
from dataclasses import dataclass
from urllib.parse import urlparse


@dataclass(frozen=True)
class ResolvedAddr:
    """A resolved UDP listen address."""

    scheme: str
    host: str
    port: int

    @property
    def socket_family(self) -> int:
        return socket.AF_INET6 if self.scheme.endswith("6") else socket.AF_INET


def resolve_addr(spec: str) -> ResolvedAddr:
    """Parse ``udp://host:port`` (udp, udp4 or udp6) and resolve the host
    eagerly, as net.ResolveUDPAddr does (addr.go:18-43). Other schemes
    raise ValueError: TCP and UNIX listeners are not ported yet."""
    u = urlparse(spec)
    if u.scheme not in ("udp", "udp4", "udp6"):
        raise ValueError(f"unsupported address {spec!r}: veneur_tpu_torch "
                         f"listens on udp:// addresses only")
    if u.port is None:
        raise ValueError(f"no port in address {spec!r}")
    host = u.hostname or ""
    if host:
        af = socket.AF_INET6 if u.scheme == "udp6" else socket.AF_UNSPEC
        host = socket.getaddrinfo(host, u.port, af, socket.SOCK_DGRAM)[0][4][0]
    return ResolvedAddr(scheme=u.scheme, host=host, port=u.port)
