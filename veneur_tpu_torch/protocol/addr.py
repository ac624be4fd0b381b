"""URL-style listen-address resolution (cf. veneur/protocol/addr.go).

Valid examples::

    udp://127.0.0.1:8126
    tcp6://[::1]:9002
    unix:///tmp/veneur.sock

The statsd listeners take ``udp://`` addresses only (``config.py``); the
SSF listeners take all three families.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from urllib.parse import urlparse


@dataclass(frozen=True)
class ResolvedAddr:
    """A resolved listen address.

    family: "udp" | "tcp" | "unix" (udp4/udp6 collapse into udp, etc.);
    host/port for the inet families, path for unix sockets."""

    scheme: str
    family: str
    host: str = ""
    port: int = 0
    path: str = ""

    @property
    def socket_family(self) -> int:
        if self.family == "unix":
            return socket.AF_UNIX
        if self.scheme.endswith("6"):
            return socket.AF_INET6
        return socket.AF_INET

    @property
    def socket_type(self) -> int:
        return (socket.SOCK_DGRAM if self.family == "udp"
                else socket.SOCK_STREAM)

    def connect_target(self):
        """What ``socket.connect`` takes: the path, or (host, port)."""
        return self.path if self.family == "unix" else (self.host, self.port)


def resolve_addr(spec: str) -> ResolvedAddr:
    """Parse a URL-style address and resolve its host eagerly, as
    net.Resolve*Addr does (addr.go:18-43); unknown schemes raise
    ValueError."""
    u = urlparse(spec)
    scheme = u.scheme
    if scheme in ("unix", "unixgram", "unixpacket"):
        if not u.path:
            raise ValueError(f"no path in unix address {spec!r}")
        return ResolvedAddr(scheme=scheme, family="unix", path=u.path)
    if scheme in ("tcp", "tcp4", "tcp6", "udp", "udp4", "udp6"):
        family = "tcp" if scheme.startswith("tcp") else "udp"
        if u.port is None:
            raise ValueError(f"no port in address {spec!r}")
        host = u.hostname or ""
        if host:
            af = socket.AF_INET6 if scheme.endswith("6") else socket.AF_UNSPEC
            kind = (socket.SOCK_DGRAM if family == "udp"
                    else socket.SOCK_STREAM)
            host = socket.getaddrinfo(host, u.port, af, kind)[0][4][0]
        return ResolvedAddr(scheme=scheme, family=family, host=host,
                            port=u.port)
    raise ValueError(f"unknown address family {scheme!r} on address "
                     f"{spec!r}")
