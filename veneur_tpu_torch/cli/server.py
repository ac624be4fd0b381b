"""The server binary: ``python -m veneur_tpu_torch.cli.server -f config.yaml``
(cf. veneur/cmd/veneur/main.go:22-88). Runs on the GPU; it
exits with an error when no CUDA device is present."""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from veneur_tpu_torch.config import Config, read_config
from veneur_tpu_torch.plugins.localfile import LocalFilePlugin
from veneur_tpu_torch.resilience import CircuitBreaker, RetryPolicy
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.datadog import DatadogMetricSink
from veneur_tpu_torch.sinks.debug import DebugMetricSink

log = logging.getLogger("veneur")


def config_sinks(config: Config):
    """(metric sinks, plugins) the config asks for, as the JAX package's
    ``sinks/factory.py`` builds them: the Datadog metric sink when
    ``datadog_api_key`` and ``datadog_api_hostname`` are both set (with
    the retry policy and a breaker for its endpoint), the debug sink
    with ``debug_flushed_metrics``, and the local-file plugin with
    ``flush_file``."""
    sinks, plugins = [], []
    interval = config.interval_seconds
    if config.datadog_api_key and config.datadog_api_hostname:
        sinks.append(DatadogMetricSink(
            interval=interval,
            flush_max_per_body=config.datadog_flush_max_per_body,
            hostname=config.hostname, tags=config.tags,
            dd_hostname=config.datadog_api_hostname,
            api_key=config.datadog_api_key,
            retry_policy=RetryPolicy.from_config(config),
            breaker=CircuitBreaker(
                failure_threshold=config.breaker_failure_threshold,
                reset_timeout=config.breaker_reset_timeout_seconds,
                name=config.datadog_api_hostname),
            requeue_max_bytes=config.sink_requeue_max_bytes))
    if config.debug_flushed_metrics:
        sinks.append(DebugMetricSink())
    if config.flush_file:
        plugins.append(LocalFilePlugin(file_path=config.flush_file,
                                       hostname=config.hostname,
                                       interval=int(interval)))
    return sinks, plugins


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="veneur-torch")
    ap.add_argument("-f", dest="config", required=True,
                    help="The config file to read for settings.")
    args = ap.parse_args(argv)
    try:
        config = read_config(args.config)
    except (OSError, ValueError) as e:
        log.error("Error reading config file: %s", e)
        return 1
    logging.basicConfig(
        level=logging.DEBUG if config.debug else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    # with no sink configured, a blackhole
    sinks, plugins = config_sinks(config)
    server = Server(config, metric_sinks=sinks or None, plugins=plugins)
    done = threading.Event()

    def handle_signal(signum, frame):
        log.info("Received signal %d, shutting down", signum)
        done.set()

    signal.signal(signal.SIGTERM, handle_signal)
    signal.signal(signal.SIGINT, handle_signal)
    server.start()
    log.info("Starting server: statsd listeners %s, SSF listeners %s",
             [(spec, rung) for spec, rung, _ in server.listeners],
             [(spec, rung) for spec, rung, _ in server.ssf_listeners])
    done.wait()
    server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
