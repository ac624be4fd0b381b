"""The availability tier: consistent-hash proxying of forwarded metrics.

Port of ``veneur_tpu/proxy/`` (after the reference's ``proxy.go`` and
``proxysrv/``): a stateless proxy that hashes every forwarded metric
onto a ring of discovered globals, so one series always merges on one
global, over HTTP (``proxy.py``) and gRPC (``grpc_proxy.py``). The ring
(``consistent.py``) is also the fleet router's placement rule
(``fleet/router.py``).
"""

from veneur_tpu_torch.proxy.consistent import (ConsistentRing,
                                               EmptyRingError, ring_key)
from veneur_tpu_torch.proxy.grpc_proxy import GRPCProxyServer
from veneur_tpu_torch.proxy.proxy import Proxy

__all__ = ["ConsistentRing", "EmptyRingError", "GRPCProxyServer", "Proxy",
           "ring_key"]
