"""The Kafka sinks: a JSON message a metric, and a sampled span stream.

Port of ``veneur_tpu/sinks/kafka.py`` (after ``sinks/kafka/kafka.go``):

- ``KafkaMetricSink.flush`` produces one JSON InterMetric a message on
  the metric topic (kafka.go:189-221), status rows included; the check
  and event topics are carried, and, as in the JAX package and the
  reference, nothing is produced on them;
- ``KafkaSpanSink.ingest`` serializes each span as JSON or SSF protobuf
  (the port's own codec, ``protocol/ssf.py``: the bytes
  ``sample_pb2.SSFSpan.SerializeToString`` gives; a native reader's
  ``LazySpan`` hands over the bytes it received) onto the span topic
  (kafka.go:352-386), after sampling: the crc32 of the trace id, or of
  the ``sample_tag``'s value (untagged spans drop), against the
  threshold of ``sample_rate_percentage`` (kafka.go:306-349);
- ``ProducerConfig`` carries the producer's tuning (kafka.go:109-152).

The producer is injectable: any object with ``produce(topic, value)``.
``new_producer`` takes the ``kafka`` client package where it imports,
else the stdlib wire producer (``sinks/kafka_wire.py``).
"""

from __future__ import annotations

import json
import logging
import zlib
from dataclasses import dataclass
from typing import List, Optional, Protocol

from veneur_tpu_torch.resilience import RetryPolicy, call_with_retry
from veneur_tpu_torch.samplers.intermetric import InterMetric
from veneur_tpu_torch.sinks.base import MetricSink, SpanSink

log = logging.getLogger("veneur.sinks.kafka")

MAX_UINT32 = 0xFFFFFFFF


class Producer(Protocol):
    def produce(self, topic: str, value: bytes) -> None: ...

    def close(self) -> None: ...


@dataclass
class ProducerConfig:
    """Producer tuning, mirroring newProducerConfig (kafka.go:109-152)."""

    ack_requirement: str = "all"  # all | none | local
    partitioner: str = "hash"     # hash | random
    retries: int = 0
    buffer_bytes: int = 0
    buffer_messages: int = 0
    buffer_frequency: float = 0.0  # seconds

    def normalized_acks(self) -> str:
        if self.ack_requirement not in ("all", "none", "local"):
            log.warning("Unknown ack requirement %r, defaulting to all",
                        self.ack_requirement)
            return "all"
        return self.ack_requirement


def new_producer(brokers: str, config: ProducerConfig) -> Producer:
    """Build a real Kafka producer (kafka.go:155-172): the optional
    ``kafka`` client package when installed, else the bundled stdlib
    wire-protocol producer (sinks/kafka_wire.py)."""
    broker_list = [b for b in brokers.split(",") if b]
    if not broker_list:
        raise ValueError("No brokers in broker list")
    try:
        from kafka import KafkaProducer  # optional, not bundled
    except ImportError:
        from veneur_tpu_torch.sinks.kafka_wire import WireProducer

        if config.buffer_bytes or config.buffer_messages or \
                config.buffer_frequency:
            log.warning("the bundled wire producer sends synchronously; "
                        "buffer_bytes/buffer_messages/buffer_frequency "
                        "are ignored (install the kafka package for "
                        "batched sends)")
        acks = {"all": -1, "none": 0, "local": 1}[config.normalized_acks()]
        # default the port like the kafka client does
        normalized = ",".join(b if ":" in b else f"{b}:9092"
                              for b in broker_list)
        return WireProducer(
            normalized, acks=acks, retry_max=config.retries,
            partitioner=config.partitioner or "hash")
    acks = {"all": "all", "none": 0, "local": 1}[config.normalized_acks()]
    kwargs = dict(
        bootstrap_servers=broker_list, acks=acks,
        retries=config.retries,
        batch_size=config.buffer_bytes or 16384,
        linger_ms=int(config.buffer_frequency * 1000))
    if config.partitioner == "random":
        import random

        def _random_partitioner(key, all_parts, available):
            return random.choice(available or all_parts)

        kwargs["partitioner"] = _random_partitioner
    if config.buffer_messages:
        # kafka-python batches by bytes/linger only (kafka.go:137-139's
        # Flush.Messages has no equivalent knob)
        log.warning("buffer_messages=%d is not supported by the kafka "
                    "client; batching is governed by buffer_bytes and "
                    "buffer_frequency", config.buffer_messages)
    kp = KafkaProducer(**kwargs)

    class _KP:
        def produce(self, topic: str, value: bytes) -> None:
            kp.send(topic, value)

        def close(self) -> None:
            kp.close()

    return _KP()


def _sample_threshold(sample_rate_percentage: float) -> int:
    """sampleRatePercentage → crc32 admission threshold
    (kafka.go:259-269)."""
    pct = min(max(sample_rate_percentage, 0.0), 100.0)
    return int(MAX_UINT32 * (pct / 100.0))


def _hash_key(value: str) -> int:
    """crc32 of the tag value (kafka.go:333-341 — the 64-byte scratch
    there is sliced back to the original length, so it is a plain
    ChecksumIEEE of the value bytes)."""
    return zlib.crc32(value.encode("utf-8"))


class KafkaMetricSink(MetricSink):
    """One JSON InterMetric per message (kafka.go:60-221).

    Not columnar: the wire contract is a message a metric, so each row
    pays a produce round trip anyway (the reference's sarama message
    each); the produce, not the JSON, bounds this sink."""

    def __init__(self, brokers: str, metric_topic: str,
                 check_topic: str = "", event_topic: str = "",
                 config: Optional[ProducerConfig] = None,
                 producer: Optional[Producer] = None,
                 retry_policy=None):
        if not metric_topic:
            raise ValueError("Cannot start Kafka metric sink with no topic")
        self.brokers = brokers
        self.metric_topic = metric_topic
        self.check_topic = check_topic
        self.event_topic = event_topic
        self.config = config or ProducerConfig()
        self.producer = producer
        # kafka_retry_max rides ProducerConfig.retries (kafka.go:131)
        # and sets the attempt budget; the backoff SHAPE comes from the
        # shared config knobs (retry_base_interval) when the factory
        # passes them
        shape = retry_policy or RetryPolicy(base_interval=0.05,
                                            max_interval=1.0)
        self.retry_policy = RetryPolicy(
            max_attempts=self.config.retries + 1,
            base_interval=shape.base_interval,
            max_interval=shape.max_interval)
        self.metrics_flushed = 0
        self.flush_errors = 0
        self.retries = 0

    @property
    def name(self) -> str:
        return "kafka"

    def start(self) -> None:
        if self.producer is None:
            self.producer = new_producer(self.brokers, self.config)

    def _count_retry(self, retry_index, exc, pause) -> None:
        self.retries += 1

    def flush(self, metrics: List[InterMetric]) -> None:
        if not metrics or self.producer is None:
            return
        # kafka_retry_max applies here for every producer, an injected
        # one included (the wire producer retries its round trips too)
        policy = self.retry_policy
        for m in metrics:
            if not m.is_acceptable_to(self.name):
                continue
            body = json.dumps({
                "name": m.name, "timestamp": m.timestamp, "value": m.value,
                "tags": m.tags, "type": m.type.value, "message": m.message,
                "hostname": m.hostname,
            }).encode("utf-8")
            try:
                # producer flavors raise different exception types
                # (socket errors, client library errors); all retryable
                call_with_retry(
                    lambda body=body: self.producer.produce(
                        self.metric_topic, body),
                    policy, deadline=self.flush_deadline,
                    retryable=(Exception,), on_retry=self._count_retry)
            except Exception:
                # one undeliverable metric must not drop the rest of
                # the batch
                self.flush_errors += 1
                log.warning("kafka produce to %s failed after %d "
                            "attempt(s)", self.metric_topic,
                            policy.max_attempts, exc_info=True)
                continue
            self.metrics_flushed += 1


class KafkaSpanSink(SpanSink):
    """Sampled JSON/protobuf span stream (kafka.go:230-396)."""

    def __init__(self, brokers: str, topic: str,
                 serialization_format: str = "protobuf",
                 sample_tag: str = "",
                 sample_rate_percentage: float = 100.0,
                 config: Optional[ProducerConfig] = None,
                 producer: Optional[Producer] = None):
        if not topic:
            raise ValueError("Cannot start Kafka span sink with no topic")
        serializer = serialization_format
        if serializer not in ("json", "protobuf"):
            log.warning("Unknown serialization format %r, defaulting to "
                        "protobuf", serializer)
            serializer = "protobuf"
        self.brokers = brokers
        self.topic = topic
        self.serializer = serializer
        self.sample_tag = sample_tag
        self.sample_threshold = _sample_threshold(sample_rate_percentage)
        self.config = config or ProducerConfig()
        self.producer = producer
        self.spans_flushed = 0
        self.spans_dropped = 0

    @property
    def name(self) -> str:
        return "kafka"

    def start(self) -> None:
        if self.producer is None:
            self.producer = new_producer(self.brokers, self.config)

    def _should_sample(self, span) -> bool:
        if not self.sample_tag and self.sample_threshold >= MAX_UINT32:
            return True
        if not self.sample_tag:
            value = str(span.trace_id)
        else:
            value = span.tags.get(self.sample_tag)
            if value is None:
                # untagged spans drop regardless of rate (kafka.go:320-327)
                return False
        return _hash_key(value) <= self.sample_threshold

    def ingest(self, span) -> None:
        if self.producer is None:
            return
        if not self._should_sample(span):
            self.spans_dropped += 1
            return
        if self.serializer == "json":
            body = json.dumps({
                "version": span.version, "trace_id": span.trace_id,
                "id": span.id, "parent_id": span.parent_id,
                "start_timestamp": span.start_timestamp,
                "end_timestamp": span.end_timestamp,
                "error": span.error, "service": span.service,
                "tags": dict(span.tags), "indicator": span.indicator,
                "name": span.name,
            }).encode("utf-8")
        else:
            body = span.SerializeToString()
        self.producer.produce(self.topic, body)
        self.spans_flushed += 1

    def flush(self) -> None:
        """Spans ship asynchronously at ingest (kafka.go:388-396)."""
