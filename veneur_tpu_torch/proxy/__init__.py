"""The proxy tier's ownership rule (port of ``veneur_tpu/proxy/``).

Only the consistent-hash ring is ported so far: the fleet router
(``fleet/router.py``) places a series on its device shard by the same
ring rule the proxy routes with. The proxy itself, discovery and the
gRPC proxy are not ported yet.
"""

from veneur_tpu_torch.proxy.consistent import (ConsistentRing,
                                               EmptyRingError, ring_key)

__all__ = ["ConsistentRing", "EmptyRingError", "ring_key"]
