"""The sinks, span sinks and plugins a config asks for.

Port of ``veneur_tpu/sinks/factory.py`` (after the sink section of
``NewFromConfig``, ``server.go:350-519``): each backend comes up when
its keys are set, in the JAX package's order. Metric sinks: SignalFx
(server.go:350-390), Datadog (:392-419), Kafka (:451-472), debug with
``debug_flushed_metrics``. Span sinks: Datadog (``datadog_trace_api_
address``), LightStep (:421-437), Falconer (:439-449), Kafka with
``kafka_span_topic``, debug with ``debug_ingested_spans``. Plugins: S3
(:477-519), then the local file. Every HTTP sink shares one retry
policy from the config and gets a breaker for its endpoint; the
SignalFx and Datadog metric sinks share one fault injector
(``fault_injection_*``), the JAX package's two hooked sinks.
"""

from __future__ import annotations

import logging
from typing import List, Tuple

from veneur_tpu_torch.config import Config, parse_duration
from veneur_tpu_torch.plugins import Plugin
from veneur_tpu_torch.plugins.localfile import LocalFilePlugin
from veneur_tpu_torch.plugins.s3 import S3Plugin
from veneur_tpu_torch.resilience import CircuitBreaker, RetryPolicy, faults
from veneur_tpu_torch.sinks.base import MetricSink, SpanSink
from veneur_tpu_torch.sinks.datadog import DatadogMetricSink, DatadogSpanSink
from veneur_tpu_torch.sinks.debug import DebugMetricSink, DebugSpanSink
from veneur_tpu_torch.sinks.kafka import (KafkaMetricSink, KafkaSpanSink,
                                          ProducerConfig)
from veneur_tpu_torch.sinks.lightstep import LightStepSpanSink
from veneur_tpu_torch.sinks.signalfx import SignalFxClient, SignalFxSink

log = logging.getLogger("veneur.sinks.factory")


def span_sinks_configured(config: Config) -> bool:
    """Whether :func:`create_sinks` builds a span sink for ``config``,
    without building one (no producer or channel is made)."""
    return bool(
        config.datadog_trace_api_address
        or config.lightstep_collector_host
        or config.falconer_address
        or (config.kafka_broker and config.kafka_span_topic)
        or config.debug_ingested_spans)


def _seconds(duration: str) -> float:
    return parse_duration(duration) if duration else 0.0


def _producer_config(config: Config, acks: str, buffer_bytes: int,
                     buffer_messages: int, frequency: str) -> ProducerConfig:
    return ProducerConfig(
        ack_requirement=acks or "all",
        partitioner=config.kafka_partitioner or "hash",
        retries=config.kafka_retry_max, buffer_bytes=buffer_bytes,
        buffer_messages=buffer_messages,
        buffer_frequency=_seconds(frequency))


def create_sinks(config: Config) -> Tuple[List[MetricSink], List[SpanSink],
                                          List[Plugin]]:
    """(metric sinks, span sinks, plugins) for ``config``."""
    metric_sinks: List[MetricSink] = []
    span_sinks: List[SpanSink] = []
    plugins: List[Plugin] = []
    interval = config.interval_seconds
    retry_policy = RetryPolicy.from_config(config)
    fault_injector = faults.from_config(config)

    def breaker(name: str) -> CircuitBreaker:
        return CircuitBreaker(
            failure_threshold=config.breaker_failure_threshold,
            reset_timeout=config.breaker_reset_timeout_seconds, name=name)

    if config.signalfx_api_key and config.signalfx_endpoint_base:
        # {name:, api_key:} maps (config.go's signalfx keys)
        per_tag = {entry.get("name", ""): SignalFxClient(
            config.signalfx_endpoint_base, entry.get("api_key", ""))
            for entry in config.signalfx_per_tag_api_keys}
        metric_sinks.append(SignalFxSink(
            hostname_tag=config.signalfx_hostname_tag or "host",
            hostname=config.hostname,
            # the config's tags become common dimensions (server.go:356)
            common_dimensions=dict(t.partition(":")[::2]
                                   for t in config.tags),
            client=SignalFxClient(config.signalfx_endpoint_base,
                                  config.signalfx_api_key),
            vary_by=config.signalfx_vary_key_by, per_tag_clients=per_tag,
            excluded_tags=config.tags_exclude, retry_policy=retry_policy,
            breaker=breaker(config.signalfx_endpoint_base),
            fault_injector=fault_injector))
    if config.datadog_api_key and config.datadog_api_hostname:
        metric_sinks.append(DatadogMetricSink(
            interval=interval,
            flush_max_per_body=config.datadog_flush_max_per_body,
            hostname=config.hostname, tags=config.tags,
            dd_hostname=config.datadog_api_hostname,
            api_key=config.datadog_api_key, retry_policy=retry_policy,
            breaker=breaker(config.datadog_api_hostname),
            fault_injector=fault_injector,
            requeue_max_bytes=config.sink_requeue_max_bytes))
    if config.datadog_trace_api_address:
        span_sinks.append(DatadogSpanSink(
            trace_address=config.datadog_trace_api_address,
            buffer_size=config.datadog_span_buffer_size,
            retry_policy=retry_policy))
    if config.lightstep_collector_host:
        span_sinks.append(LightStepSpanSink(
            collector=config.lightstep_collector_host,
            reconnect_period=_seconds(config.lightstep_reconnect_period),
            maximum_spans=config.lightstep_maximum_spans or 1024,
            num_clients=config.lightstep_num_clients,
            access_token=config.lightstep_access_token,
            retry_policy=retry_policy))
    if config.falconer_address:
        from veneur_tpu_torch.sinks.falconer import new_falconer_span_sink

        span_sinks.append(new_falconer_span_sink(config.falconer_address))
    if config.kafka_broker:
        if config.kafka_metric_topic:
            metric_sinks.append(KafkaMetricSink(
                brokers=config.kafka_broker,
                metric_topic=config.kafka_metric_topic,
                check_topic=config.kafka_check_topic,
                event_topic=config.kafka_event_topic,
                config=_producer_config(
                    config, config.kafka_metric_require_acks,
                    config.kafka_metric_buffer_bytes,
                    config.kafka_metric_buffer_messages,
                    config.kafka_metric_buffer_frequency),
                retry_policy=retry_policy))
        if config.kafka_span_topic:
            span_sinks.append(KafkaSpanSink(
                brokers=config.kafka_broker, topic=config.kafka_span_topic,
                serialization_format=(config.kafka_span_serialization_format
                                      or "protobuf"),
                sample_tag=config.kafka_span_sample_tag,
                sample_rate_percentage=(
                    config.kafka_span_sample_rate_percent or 100),
                config=_producer_config(
                    config, config.kafka_span_require_acks,
                    config.kafka_span_buffer_bytes,
                    config.kafka_span_buffer_mesages,
                    config.kafka_span_buffer_frequency)))
    if config.debug_flushed_metrics:
        metric_sinks.append(DebugMetricSink())
    if config.debug_ingested_spans:
        span_sinks.append(DebugSpanSink())
    if config.aws_s3_bucket:
        svc = None
        try:
            import boto3  # not bundled: without it the plugin stays off

            svc = boto3.client("s3", region_name=config.aws_region or None)
        except ImportError:
            log.warning("aws_s3_bucket is set but boto3 does not import; "
                        "the S3 plugin errors on each flush until a "
                        "client is injected")
        plugins.append(S3Plugin(hostname=config.hostname,
                                bucket=config.aws_s3_bucket,
                                interval=int(interval), svc=svc))
    if config.flush_file:
        plugins.append(LocalFilePlugin(file_path=config.flush_file,
                                       hostname=config.hostname,
                                       interval=int(interval)))
    return metric_sinks, span_sinks, plugins
