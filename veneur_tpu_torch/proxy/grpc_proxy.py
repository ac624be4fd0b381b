"""The gRPC proxy: ``Forward.SendMetrics`` fan-out over the consistent ring.

Port of ``veneur_tpu/proxy/grpc_proxy.py`` (after the reference's
``proxysrv/server.go``): receive a MetricList, hash each metric to a
destination (``destForMetric``, :272-286), forward each destination's
share in parallel (``sendMetrics``, :189-269), and drop the connections
of departed members on a membership change (``SetDestinations``,
:147-177). The RPC is answered before the fan-out ends (:179-187).

Without protobuf: a request arrives as raw bytes,
``protocol/mlist.py`` ``split_metric_list`` reads each metric's key
from its own fields, and a destination's request is the concatenation
of its metrics' field records (repeated fields concatenate), so no
metric is re-encoded. As in the JAX package only ``metrics`` is
forwarded: a ``topk`` sketch stays at the proxy. A request that does
not parse is answered with INVALID_ARGUMENT.
"""

from __future__ import annotations

import logging
import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence

from veneur_tpu_torch.forward import grpc_forward
from veneur_tpu_torch.forward.convert import type_name
from veneur_tpu_torch.protocol import mlist
from veneur_tpu_torch.proxy.consistent import (ConsistentRing,
                                               EmptyRingError, ring_key)

log = logging.getLogger("veneur.proxy.grpc")


def grpc_target(member: str) -> str:
    """A ring member's gRPC address: the member without its scheme (the
    JAX package dials the member itself)."""
    return member.split("://", 1)[-1]


class _ConnMap:
    """Member -> channel and its SendMetrics callable, made on first use
    and pruned on a membership change (proxysrv/client_conn_map.go)."""

    def __init__(self, dial: Callable[[str], str]):
        self._dial = dial
        self._lock = threading.Lock()
        self._conns: Dict[str, tuple] = {}

    def get(self, dest: str):
        with self._lock:
            entry = self._conns.get(dest)
            if entry is None:
                entry = grpc_forward.dial(self._dial(dest))
                self._conns[dest] = entry
            return entry[1]

    def prune(self, keep: Sequence[str]):
        keep = set(keep)
        with self._lock:
            gone = [self._conns.pop(d) for d in list(self._conns)
                    if d not in keep]
        for channel, _ in gone:
            channel.close()

    def close(self):
        self.prune(())


class GRPCProxyServer:
    """The gRPC flavour of veneur-proxy (proxysrv.Server). ``dial`` maps a
    ring member to the gRPC address to call (default
    :func:`grpc_target`): a member may name a global's HTTP address while
    its gRPC import listens elsewhere, and both transports still hash
    the same member. ``injector`` (a churn FaultInjector) black-holes a
    partitioned member. Counters: ``proxied`` (metrics a destination
    answered), ``forward_errors`` (failed destination requests),
    ``dropped`` (metrics no member could take)."""

    def __init__(self, destinations: Optional[Sequence[str]] = None,
                 forward_timeout: float = 10.0, workers: int = 8,
                 dial: Optional[Callable[[str], str]] = None,
                 injector=None):
        self.ring = ConsistentRing()
        self.conns = _ConnMap(dial or grpc_target)
        self.forward_timeout = forward_timeout
        self.injector = injector
        self.proxied = 0
        self.forward_errors = 0
        self.dropped = 0
        self._lock = threading.Lock()
        self._workers = workers
        self._grpc = None
        self.port: Optional[int] = None
        if destinations:
            self.set_destinations(destinations)

    def set_destinations(self, destinations: Sequence[str]):
        """Replace the membership and close the connections of departed
        members (proxysrv/server.go:147-177)."""
        self.ring.set_members(destinations)
        self.conns.prune(list(destinations))

    def _recv(self, request: bytes, context) -> bytes:
        import grpc

        try:
            spans = mlist.split_metric_list(request)
        except mlist.DecodeError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          f"malformed MetricList: {e}")
        # answer now; forward on a worker thread (server.go:179-187)
        threading.Thread(target=self.send_metrics, args=(request, spans),
                         name="grpc-proxy-fanout", daemon=True).start()
        return b""  # google.protobuf.Empty

    def send_metrics(self, data: bytes,
                     spans: Optional[List[mlist.MetricSpan]] = None):
        """Route each metric of a serialized MetricList by the same key as
        the HTTP proxy's ``metric_ring_key`` (``ring_key(name, type,
        ",".join(tags))``, one ring version for the whole request) and
        send each destination its share; returns once every share was
        answered or timed out."""
        if spans is None:
            spans = mlist.split_metric_list(data)
        keys, routable, dropped = [], [], 0
        for s in spans:
            try:
                keys.append(ring_key(s.name, type_name(s.type),
                                     ",".join(s.tags)))
                routable.append(s)
            except ValueError:  # an unknown metric type
                dropped += 1
        try:
            owners = self.ring.get_many(keys)
        except EmptyRingError:
            dropped += len(keys)
            owners = []
        by_dest = defaultdict(list)
        for owner, s in zip(owners, routable):
            by_dest[owner].append(s)
        if dropped:
            with self._lock:
                self.dropped += dropped
            log.warning("dropped %d unroutable metrics", dropped)
        view = memoryview(data)
        threads = []
        for dest, batch in by_dest.items():
            body = b"".join(view[s.start:s.end] for s in batch)
            t = threading.Thread(target=self._forward,
                                 args=(dest, body, len(batch)),
                                 name="grpc-proxy-send", daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=self.forward_timeout + 1.0)

    def _forward(self, dest: str, body: bytes, n: int):
        import grpc

        try:
            if self.injector is not None and \
                    self.injector.is_partitioned(dest):
                raise ConnectionRefusedError(f"{dest} is partitioned "
                                             "(injected)")
            self.conns.get(dest)(body, timeout=self.forward_timeout)
        except (grpc.RpcError, OSError) as e:
            with self._lock:
                self.forward_errors += 1
            log.warning("failed to forward %d metrics to %s: %s", n, dest, e)
            return
        with self._lock:
            self.proxied += n

    def start(self, addr: str = "[::]:0") -> int:
        self._grpc = grpc_forward.serve(self._recv, self._workers)
        self.port = self._grpc.add_insecure_port(addr)
        if self.port == 0:
            raise RuntimeError(f"could not bind the gRPC proxy to {addr}")
        self._grpc.start()
        log.info("gRPC proxy listening on port %d with %d destinations",
                 self.port, len(self.ring))
        return self.port

    def stop(self, grace: float = 1.0):
        if self._grpc is not None:
            self._grpc.stop(grace).wait(timeout=grace + 1.0)
        self.conns.close()
