"""The port's stdlib Kafka producer (``sinks/kafka_wire.py``) against a
fake broker, and its partitioner against the JAX package's.

The fake broker (a copy of ``tests/test_kafka_faults.py``'s) speaks
Metadata v0 and Produce v0 and records every message. Held: the
roundtrip, acks none, a broker error raising after its retries, an
unreachable broker raising within its timeout, the sarama-parity hash
partitioner equal to the JAX package's ``WireProducer`` on seeded keys,
a key whose partition has no leader failing instead of moving, and the
metric sink producing through it.
"""

import json
import socket
import struct
import threading
import time
import zlib

import numpy as np
import pytest

from veneur_tpu.sinks.kafka_wire import WireProducer as JWireProducer
from veneur_tpu_torch.samplers.intermetric import InterMetric, MetricType
from veneur_tpu_torch.sinks.kafka import KafkaMetricSink
from veneur_tpu_torch.sinks.kafka_wire import WireProducer, _Reader


class FakeBroker:
    """Just enough Kafka: Metadata v0 + Produce v0, with injectable
    produce error codes. Records every produced message value."""

    def __init__(self, partitions: int = 2, produce_error: int = 0):
        self.partitions = partitions
        self.produce_error = produce_error
        self.messages = []   # (topic, partition, value bytes)
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(8)
        self.port = self._srv.getsockname()[1]
        self._stop = False
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _recv_exact(self, conn, n):
        data = b""
        while len(data) < n:
            chunk = conn.recv(n - len(data))
            if not chunk:
                raise ConnectionError
            data += chunk
        return data

    def _serve(self, conn):
        try:
            while True:
                (size,) = struct.unpack(">i", self._recv_exact(conn, 4))
                r = _Reader(self._recv_exact(conn, size))
                api = r.i16()
                r.i16()  # api version
                corr = r.i32()
                r.string()  # client id
                if api == 3:
                    resp = self._metadata(r)
                elif api == 0:
                    resp = self._produce(r)
                    if resp is None:
                        continue  # acks=0: no response
                else:
                    break
                payload = struct.pack(">i", corr) + resp
                conn.sendall(struct.pack(">i", len(payload)) + payload)
        except (ConnectionError, OSError, struct.error):
            pass
        finally:
            conn.close()

    def _metadata(self, r):
        r.i32()  # topic count
        topic = r.string()
        out = struct.pack(">i", 1)  # one broker: us
        out += struct.pack(">i", 1)  # node id
        host = b"127.0.0.1"
        out += struct.pack(">h", len(host)) + host
        out += struct.pack(">i", self.port)
        out += struct.pack(">i", 1)  # one topic
        out += struct.pack(">h", 0)  # topic error
        tb = topic.encode()
        out += struct.pack(">h", len(tb)) + tb
        out += struct.pack(">i", self.partitions)
        for pid in range(self.partitions):
            out += struct.pack(">h", 0)       # partition error
            out += struct.pack(">i", pid)
            out += struct.pack(">i", 1)       # leader: us
            out += struct.pack(">i", 0)       # replicas: empty
            out += struct.pack(">i", 0)       # isr: empty
        return out

    def _produce(self, r):
        acks = r.i16()
        r.i32()  # timeout
        r.i32()  # topic count
        topic = r.string()
        r.i32()  # partition count
        pid = r.i32()
        mset = r.take(r.i32())
        mr = _Reader(mset)
        mr.i64()  # offset
        mr.i32()  # message size
        crc = mr.i32() & 0xFFFFFFFF
        body_start = mr.pos
        mr.i16()  # magic + attributes
        klen = mr.i32()
        if klen > 0:
            mr.take(klen)
        value = mr.take(mr.i32())
        assert crc == (zlib.crc32(mset[body_start:]) & 0xFFFFFFFF)
        if self.produce_error == 0:
            self.messages.append((topic, pid, value))
        if acks == 0:
            return None
        tb = topic.encode()
        return (struct.pack(">i", 1)
                + struct.pack(">h", len(tb)) + tb
                + struct.pack(">i", 1)
                + struct.pack(">i", pid)
                + struct.pack(">h", self.produce_error)
                + struct.pack(">q", len(self.messages)))

    def close(self):
        self._stop = True
        self._srv.close()


@pytest.fixture
def broker():
    b = FakeBroker()
    yield b
    b.close()


def _wait(cond, timeout: float = 5.0) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.01)


def test_produce_roundtrip(broker):
    p = WireProducer(f"127.0.0.1:{broker.port}", acks=1)
    for i in range(20):
        p.produce("metrics", f"payload{i}".encode(), key=f"k{i}")
    p.close()
    assert sorted(v for _, _, v in broker.messages) == sorted(
        f"payload{i}".encode() for i in range(20))
    # the hash partitioner spreads the keys over both partitions
    assert {pid for _, pid, _ in broker.messages} == {0, 1}


def test_acks_none_fire_and_forget(broker):
    p = WireProducer(f"127.0.0.1:{broker.port}", acks=0)
    p.produce("m", b"x")
    _wait(lambda: broker.messages)
    assert broker.messages == [("m", broker.messages[0][1], b"x")]
    p.close()


def test_broker_error_raises_after_retries(broker):
    broker.produce_error = 6  # NOT_LEADER_FOR_PARTITION
    p = WireProducer(f"127.0.0.1:{broker.port}", acks=1, retry_max=1)
    with pytest.raises(RuntimeError, match="error code 6"):
        p.produce("m", b"x")
    assert p.errors == 1 and not broker.messages
    p.close()


def test_unreachable_broker_raises_not_hangs():
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()  # nothing listens here
    p = WireProducer(f"127.0.0.1:{port}", acks=1, retry_max=0,
                     timeout_ms=500)
    t0 = time.time()
    with pytest.raises(OSError):
        p.produce("m", b"x")
    assert time.time() - t0 < 5


@pytest.mark.parametrize("partitions", [1, 3, 7])
def test_hash_partitions_equal_jax(partitions):
    """Seeded keys land on the partition the JAX package's producer (and
    sarama's HashPartitioner) picks."""
    rng = np.random.default_rng(partitions)
    keys = [f"series-{int(k)}" for k in rng.integers(0, 1 << 30, 300)]
    keys += ["", "a", "host:x", "ünïcode"]
    ours, theirs = WireProducer("127.0.0.1:9092"), JWireProducer(
        "127.0.0.1:9092")
    for p in (ours, theirs):
        p._leaders["t"] = {i: ("h", 1) for i in range(partitions)}
        p._npartitions["t"] = partitions
    got = [ours._pick("t", k)[0] for k in keys]
    assert got == [theirs._pick("t", k)[0] for k in keys]
    assert len(set(got)) == partitions
    assert ours.bootstrap == theirs.bootstrap == [("127.0.0.1", 9092)]


def test_leaderless_partition_fails_not_reroutes():
    """A key whose partition is mid-election raises (produce retries after
    re-learning the metadata) instead of landing elsewhere."""
    prod, ref = WireProducer("127.0.0.1:9092"), JWireProducer(
        "127.0.0.1:9092")
    for p in (prod, ref):
        p._npartitions["t"] = 3
        p._leaders["t"] = {0: ("h", 1), 2: ("h", 1)}  # 1 has no leader
        p._npartitions["u"] = 3
        p._leaders["u"] = {i: ("h", 1) for i in range(3)}
    keys = [f"k{i}" for i in range(100)]
    lost = [k for k in keys if ref._pick("u", k)[0] == 1]
    kept = [k for k in keys if ref._pick("u", k)[0] == 2]
    with pytest.raises(RuntimeError, match="no leader"):
        prod._pick("t", lost[0])
    assert prod._pick("t", kept[0])[0] == 2


def test_metric_sink_produces_through_the_wire_producer(broker):
    sink = KafkaMetricSink(f"127.0.0.1:{broker.port}", "veneur.metrics")
    sink.start()
    sink.flush([InterMetric(name="kafka.e2e", timestamp=7, value=4.5,
                            tags=["a:b"], type=MetricType.GAUGE)])
    _wait(lambda: broker.messages)
    doc = json.loads(broker.messages[0][2])
    assert (doc["name"], doc["value"], doc["tags"]) == ("kafka.e2e", 4.5,
                                                       ["a:b"])
    assert sink.metrics_flushed == 1
    sink.producer.close()
