"""The server binary: ``python -m veneur_tpu_torch.cli.server -f config.yaml``
(cf. veneur/cmd/veneur/main.go:22-88).

``--device`` names the torch device the store runs on: the card by
default, or ``cpu``, which is how a caller asks for the CPU, as the
tests do. Without a GPU and without ``--device cpu`` it exits with an
error, as ``device.py`` makes it. The sinks, span sinks and plugins the
file configures are handed to the Server as config-driven ones.

Signals: SIGTERM and SIGINT drain (one final flush) and exit. SIGHUP
re-reads the file and reloads the Server on a thread
(``Server.reload``: interval, percentiles, aggregates, tags, the
config-driven sinks and plugins and the forwarder change; listeners and
the store stay). SIGUSR2 is the zero-downtime upgrade
(``cli/upgrade.py``): a replacement re-execs the recorded command line,
``--device`` included, binds the same ports beside this process, and
this generation drains once the replacement is ready.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from veneur_tpu_torch.cli import upgrade
from veneur_tpu_torch.config import Config, read_config
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.factory import create_sinks

log = logging.getLogger("veneur")

MODULE = "veneur_tpu_torch.cli.server"


def config_sinks(config: Config):
    """(metric sinks, span sinks, plugins) the config asks for:
    ``sinks/factory.py`` ``create_sinks``, the ones and the order the
    JAX Server builds from the same file."""
    return create_sinks(config)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="veneur-torch")
    ap.add_argument("-f", dest="config", required=True,
                    help="The config file to read for settings.")
    ap.add_argument("--device", default=None,
                    help="The torch device of the store: the card by "
                    "default (an error without one), or cpu.")
    args = ap.parse_args(argv)
    # the exact command line, so a SIGUSR2 upgrade re-execs what the
    # operator ran, --device included
    upgrade.record_startup_argv(MODULE, argv)
    try:
        config = read_config(args.config)
    except (OSError, ValueError) as e:
        log.error("Error reading config file: %s", e)
        return 1
    logging.basicConfig(
        level=logging.DEBUG if config.debug else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    server = Server(config, device=args.device,
                    config_sinks=config_sinks(config))
    done = threading.Event()

    def handle_signal(signum, frame):
        log.info("Received signal %d, shutting down", signum)
        # marks the stop as asked for before done is set, so a racing
        # SIGUSR2 handoff cannot leave a replacement serving
        upgrade.request_shutdown(done)

    def handle_hup(signum, frame):
        # a thread, so the handler never blocks in sink construction
        def do_reload():
            try:
                new_cfg = read_config(args.config)
            except Exception as e:
                log.error("SIGHUP reload: re-reading the config failed, "
                          "keeping the running one: %s", e)
                return
            try:
                server.reload(new_cfg)
            except Exception:
                log.exception("SIGHUP reload failed; continuing with the "
                              "previous configuration")

        log.info("Received SIGHUP, reloading configuration from %s",
                 args.config)
        threading.Thread(target=do_reload, name="config-reload",
                         daemon=True).start()

    handle_usr2 = upgrade.make_sigusr2_handler(args.config, MODULE, done, log)
    # before the (slow: CUDA context, library loads) start, so a signal
    # during startup reaches a handler, not the default action
    signal.signal(signal.SIGTERM, handle_signal)
    signal.signal(signal.SIGINT, handle_signal)
    signal.signal(signal.SIGHUP, handle_hup)
    signal.signal(signal.SIGUSR2, handle_usr2)
    server.start()
    log.info("Starting server: statsd listeners %s, SSF listeners %s",
             [(spec, rung) for spec, rung, _ in server.listeners],
             [(spec, rung) for spec, rung, _ in server.ssf_listeners])
    # a replacement generation releases the old one to drain only now,
    # with every listener bound and the kernel library loaded
    upgrade.notify_ready()
    done.wait()
    try:
        server.shutdown()
    finally:
        # a shutdown that raced an upgrade: the replacement whose
        # handoff never completed must not outlive this generation
        upgrade.reap_unfinished_replacement(log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
