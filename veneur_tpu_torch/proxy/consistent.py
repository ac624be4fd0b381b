"""Consistent hashing ring (a copy of ``veneur_tpu/proxy/consistent.py``).

Same contract as the vendored ``stathat.com/c/consistent`` the reference
proxies with (``proxy.go:437-478``): members are replicated onto a ring of
CRC32 points; ``get(key)`` walks clockwise to the first point. Adding or
removing one member only remaps ~1/N of the keyspace.
"""

from __future__ import annotations

import bisect
import threading
import zlib
from typing import Dict, List, Optional, Sequence


class EmptyRingError(Exception):
    pass


def ring_key(name: str, mtype: str, joined_tags: str) -> str:
    """THE ownership hash rule, written once: ``MetricKey.String()``
    (``name + type + joined sorted tags``, samplers/parser.go:50-56).
    Proxy routing (``metric_ring_key``), device placement
    (``fleet.router.ShardRouter``) and the elastic-resharding
    moved-range computation (``fleet.router.RingTransition``) all hash
    this same string, so ownership agrees across every tier by
    construction. Lives here — the one module all three import —
    so none of them needs a cyclic or per-call import."""
    return name + mtype + joined_tags


class ConsistentRing:
    """Thread-safe consistent hash ring with virtual replicas."""

    def __init__(self, members: Optional[Sequence[str]] = None,
                 replicas: int = 20):
        self.replicas = replicas
        self._lock = threading.RLock()
        self._points: List[int] = []
        self._owner: Dict[int, str] = {}
        self._members: set = set()
        # bumped on every membership mutation; a routing consumer that
        # resolves a whole batch under one lock hold (get_many) routes
        # it by exactly one version of the ring
        self.version = 0
        if members:
            self.set_members(members)

    @staticmethod
    def _hash(key: str) -> int:
        return zlib.crc32(key.encode("utf-8")) & 0xFFFFFFFF

    def members(self) -> List[str]:
        with self._lock:
            return sorted(self._members)

    def __len__(self) -> int:
        return len(self._members)

    @staticmethod
    def _add_into(points: List[int], owner: Dict[int, str], members: set,
                  member: str, replicas: int):
        if member in members:
            return
        members.add(member)
        for i in range(replicas):
            h = ConsistentRing._hash(f"{member}{i}")
            # last-write-wins on the (rare) collision, like the original
            if h not in owner:
                bisect.insort(points, h)
            owner[h] = member

    @staticmethod
    def _remove_from(points: List[int], owner: Dict[int, str],
                     members: set, member: str, replicas: int):
        if member not in members:
            return
        members.discard(member)
        for i in range(replicas):
            h = ConsistentRing._hash(f"{member}{i}")
            if owner.get(h) == member:
                del owner[h]
                idx = bisect.bisect_left(points, h)
                if idx < len(points) and points[idx] == h:
                    points.pop(idx)

    def add(self, member: str):
        with self._lock:
            if member in self._members:
                return
            self._add_into(self._points, self._owner, self._members,
                           member, self.replicas)
            self.version += 1

    def remove(self, member: str):
        with self._lock:
            if member not in self._members:
                return
            self._remove_from(self._points, self._owner, self._members,
                              member, self.replicas)
            self.version += 1

    def set_members(self, members: Sequence[str]):
        """Replace the membership ATOMICALLY (RefreshDestinations,
        proxy.go:337-371): the removes and adds apply to private copies
        that swap in under one lock hold, so a concurrent ``get`` /
        ``get_many`` can never observe a half-transitioned ring — the
        window where a key routed to neither its old nor its new owner
        (the ring-transition double-count hazard; docs/resilience.md
        "Elastic resharding")."""
        with self._lock:
            want = set(members)
            if want == self._members:
                return
            points = list(self._points)
            owner = dict(self._owner)
            current = set(self._members)
            for m in sorted(current - want):
                self._remove_from(points, owner, current, m, self.replicas)
            for m in sorted(want - current):
                self._add_into(points, owner, current, m, self.replicas)
            self._points, self._owner, self._members = points, owner, current
            self.version += 1

    def _get_locked(self, key: str) -> str:
        h = self._hash(key)
        idx = bisect.bisect_right(self._points, h)
        if idx == len(self._points):
            idx = 0
        return self._owner[self._points[idx]]

    def get(self, key: str) -> str:
        """The member owning ``key`` (clockwise walk)."""
        with self._lock:
            if not self._points:
                raise EmptyRingError("ring has no members")
            return self._get_locked(key)

    def get_many(self, keys: Sequence[str]) -> List[str]:
        """Owners for a whole batch under ONE lock hold: every key
        routes by the same ring version, so a membership swap landing
        mid-batch cannot split the batch across two rings (the proxy's
        fan-out and the handoff router both route per-batch)."""
        with self._lock:
            if not self._points:
                raise EmptyRingError("ring has no members")
            return [self._get_locked(k) for k in keys]
