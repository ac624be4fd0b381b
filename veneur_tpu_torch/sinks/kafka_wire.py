"""A Kafka producer on stdlib sockets, speaking the v0 wire protocol.

Port of ``veneur_tpu/sinks/kafka_wire.py``. The reference builds a
sarama AsyncProducer (``sinks/kafka/kafka.go:155-172``); neither
package ships a Kafka client, so the default producer is this one:

- Metadata v0 (api_key 3) on first use of a topic, for its partition
  count and each partition's leader;
- Produce v0 (api_key 0) with a CRC-framed message set a message, at
  the configured ack level (none/local/all), retry budget and
  partitioner (sarama's hash partitioner bit for bit, or random);
- one connection a broker, (re)connected lazily inside the retries.

Only what the Kafka sinks need: a producer, not a client library. The
layout follows the public Kafka protocol specification (the v0 APIs,
which every broker since 0.8 accepts).
"""

from __future__ import annotations

import logging
import random
import socket
import struct
import threading
import zlib
from typing import Dict, List, Optional, Tuple

log = logging.getLogger("veneur.kafka.wire")

_API_PRODUCE = 0
_API_METADATA = 3


def _str(s: Optional[str]) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    b = s.encode("utf-8")
    return struct.pack(">h", len(b)) + b


def _bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


class _NoLeader(RuntimeError):
    """A keyed message's partition currently has no leader (election in
    flight) — retryable after a metadata refresh, without tearing down
    connections to healthy brokers."""


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def i16(self) -> int:
        return struct.unpack(">h", self.take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self.take(8))[0]

    def string(self) -> str:
        n = self.i16()
        return "" if n < 0 else self.take(n).decode("utf-8", "replace")


def _message_set(value: bytes) -> bytes:
    """One v0 message: CRC over magic..value (offset 0, no key)."""
    body = struct.pack(">bb", 0, 0) + _bytes(None) + _bytes(value)
    msg = struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF) + body
    return struct.pack(">q", 0) + struct.pack(">i", len(msg)) + msg


class WireProducer:
    """produce(topic, value) over raw sockets; thread-safe."""

    def __init__(self, brokers: str, acks: int = 1, timeout_ms: int = 10000,
                 retry_max: int = 3, partitioner: str = "hash",
                 client_id: str = "veneur-tpu"):
        self.bootstrap: List[Tuple[str, int]] = []
        for b in brokers.split(","):
            host, sep, port = b.strip().rpartition(":")
            if sep and port.isdigit():
                self.bootstrap.append((host or "127.0.0.1", int(port)))
            else:
                # bare hostname (or trailing colon): default port 9092,
                # like the kafka clients do
                bare = host if sep else b.strip()
                self.bootstrap.append((bare or "127.0.0.1", 9092))
        self.acks = acks
        self.timeout_ms = timeout_ms
        self.retry_max = max(0, retry_max)
        self.partitioner = partitioner
        self.client_id = client_id
        self._lock = threading.Lock()
        self._correlation = 0
        self._conns: Dict[Tuple[str, int], socket.socket] = {}
        # topic -> (partition -> broker addr)
        self._leaders: Dict[str, Dict[int, Tuple[str, int]]] = {}
        # topic -> total partition count (incl. leaderless; hash modulus)
        self._npartitions: Dict[str, int] = {}
        self._rr = 0
        self.errors = 0

    # -- wire plumbing -----------------------------------------------------

    def _conn(self, addr: Tuple[str, int]) -> socket.socket:
        sock = self._conns.get(addr)
        if sock is not None:
            return sock
        sock = socket.create_connection(addr, timeout=self.timeout_ms / 1e3)
        self._conns[addr] = sock
        return sock

    def _drop(self, addr: Tuple[str, int]):
        sock = self._conns.pop(addr, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _roundtrip(self, addr: Tuple[str, int], api_key: int,
                   body: bytes, want_reply: bool) -> Optional[_Reader]:
        self._correlation += 1
        header = (struct.pack(">hhi", api_key, 0, self._correlation)
                  + _str(self.client_id))
        payload = header + body
        sock = self._conn(addr)
        sock.sendall(struct.pack(">i", len(payload)) + payload)
        if not want_reply:
            return None
        raw = b""
        while len(raw) < 4:
            chunk = sock.recv(4 - len(raw))
            if not chunk:
                raise ConnectionError("broker closed connection")
            raw += chunk
        (size,) = struct.unpack(">i", raw)
        data = b""
        while len(data) < size:
            chunk = sock.recv(size - len(data))
            if not chunk:
                raise ConnectionError("broker closed mid-response")
            data += chunk
        r = _Reader(data)
        r.i32()  # correlation id
        return r

    # -- metadata ----------------------------------------------------------

    def _refresh_metadata(self, topic: str):
        body = struct.pack(">i", 1) + _str(topic)
        last_err: Optional[Exception] = None
        for addr in self.bootstrap:
            try:
                r = self._roundtrip(addr, _API_METADATA, body, True)
            except OSError as e:
                last_err = e
                self._drop(addr)
                continue
            brokers: Dict[int, Tuple[str, int]] = {}
            for _ in range(r.i32()):
                node = r.i32()
                host = r.string()
                port = r.i32()
                brokers[node] = (host, port)
            leaders: Dict[int, Tuple[str, int]] = {}
            total = 0
            for _ in range(r.i32()):
                r.i16()  # topic error code
                r.string()  # topic name
                for _ in range(r.i32()):
                    r.i16()  # partition error code
                    pid = r.i32()
                    leader = r.i32()
                    for _ in range(r.i32()):
                        r.i32()  # replicas
                    for _ in range(r.i32()):
                        r.i32()  # isr
                    total += 1  # leaderless partitions still count for
                    # the hash modulus (sarama mods by the topic's full
                    # partition count, not the currently-leadered subset)
                    if leader in brokers:
                        leaders[pid] = brokers[leader]
            if leaders:
                self._leaders[topic] = leaders
                self._npartitions[topic] = total
                return
            last_err = RuntimeError(f"no leaders for topic {topic!r}")
        raise last_err or RuntimeError("no bootstrap broker reachable")

    def _pick(self, topic: str, key: Optional[str]) -> Tuple[int,
                                                             Tuple[str, int]]:
        parts = self._leaders[topic]
        if key is not None and self.partitioner == "hash":
            # sarama's HashPartitioner, bit-for-bit: FNV-1a 32, the hash
            # reinterpreted as int32 with a negative result negated —
            # which collapses to abs(int32(h)) — taken modulo the
            # topic's TOTAL partition count (leaderless partitions
            # included) — co-partitioning with Go producers/consumers
            # depends on both details. (Python's builtin hash() is
            # salted per process and would scatter one key across
            # partitions between restarts.)
            h = 2166136261
            for byte in key.encode("utf-8"):
                h = ((h ^ byte) * 16777619) & 0xFFFFFFFF
            if h >= 1 << 31:
                h -= 1 << 32  # int32 reinterpretation
            pid = abs(h) % self._npartitions[topic]
            if pid not in parts:
                # the key's partition is mid-election: fail this attempt
                # rather than silently re-route the key (produce() will
                # re-learn metadata and retry, keeping its connections)
                raise _NoLeader(
                    f"partition {pid} of {topic!r} has no leader")
        elif self.partitioner == "random" or self.partitioner == "hash":
            # nil-key messages under sarama's HashPartitioner dispatch
            # via the random partitioner (sarama partitioner.go), so a
            # hash-partitioned producer with no key lands here too
            pids = sorted(parts)
            pid = pids[random.randrange(len(pids))]
        else:
            pids = sorted(parts)
            self._rr += 1
            pid = pids[self._rr % len(pids)]
        return pid, parts[pid]

    # -- produce -----------------------------------------------------------

    def produce(self, topic: str, value: bytes,
                key: Optional[str] = None) -> None:
        # one socket, one in-flight produce: the lock IS the wire
        # serializer. Only the kafka sink's flush thread contends, and
        # the egress deadline bounds the hold
        with self._lock:
            err: Optional[Exception] = None
            for attempt in range(self.retry_max + 1):
                try:
                    if topic not in self._leaders:
                        self._refresh_metadata(topic)
                    pid, addr = self._pick(topic, key)
                    mset = _message_set(value)
                    body = (struct.pack(">hi", self.acks, self.timeout_ms)
                            + struct.pack(">i", 1) + _str(topic)
                            + struct.pack(">i", 1)
                            + struct.pack(">i", pid)
                            + struct.pack(">i", len(mset)) + mset)
                    r = self._roundtrip(addr, _API_PRODUCE, body,
                                        want_reply=self.acks != 0)
                    if r is not None:
                        r.i32()  # topic count (1)
                        r.string()
                        r.i32()  # partition count (1)
                        r.i32()  # partition id
                        code = r.i16()
                        r.i64()  # offset
                        if code != 0:
                            raise RuntimeError(
                                f"produce failed with error code {code}")
                    return
                except _NoLeader as e:
                    # expected during elections: re-learn metadata for
                    # this topic only; healthy-broker connections and
                    # other topics' leaders are untouched (no churn
                    # storm while the cluster is already degraded)
                    err = e
                    self._leaders.pop(topic, None)
                except Exception as e:
                    err = e
                    # leadership may have moved; reconnect + re-learn
                    self._leaders.pop(topic, None)
                    for a in list(self._conns):
                        self._drop(a)
            self.errors += 1
            raise err  # type: ignore[misc]

    def close(self) -> None:
        with self._lock:
            for a in list(self._conns):
                self._drop(a)
