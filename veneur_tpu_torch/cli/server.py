"""The server binary: ``python -m veneur_tpu_torch.cli.server -f config.yaml``
(cf. veneur/cmd/veneur/main.go:22-88). Runs on the GPU; it
exits with an error when no CUDA device is present."""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from veneur_tpu_torch.config import read_config
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.debug import DebugMetricSink

log = logging.getLogger("veneur")


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
    # the only ported sink that reports anywhere is the debug sink
    # (debug_flushed_metrics, as in the reference); otherwise a blackhole
    sinks = [DebugMetricSink()] if config.debug_flushed_metrics else None
    server = Server(config, metric_sinks=sinks)
    done = threading.Event()

    def handle_signal(signum, frame):
        log.info("Received signal %d, shutting down", signum)
        done.set()

    signal.signal(signal.SIGTERM, handle_signal)
    signal.signal(signal.SIGINT, handle_signal)
    server.start()
    log.info("Starting server on %s (statsd)", server.statsd_addrs)
    done.wait()
    server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
