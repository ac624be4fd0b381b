"""The proxy binary: ``python -m veneur_tpu_torch.cli.proxy -f proxy.yaml``
(cf. veneur/cmd/veneur-proxy/main.go:20-58). Brings up the consistent-
hashing proxy (the HTTP listener and, with ``grpc_forward_address``, the
gRPC one) until SIGINT or SIGTERM. It needs no GPU. SIGUSR2 is the
zero-downtime upgrade on the server binary's protocol
(``cli/upgrade.py``): a replacement binds the same ports beside this
process (SO_REUSEPORT), and this one, stateless, shuts down once the
replacement is ready."""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from veneur_tpu_torch.cli import upgrade
from veneur_tpu_torch.config import read_proxy_config
from veneur_tpu_torch.proxy.proxy import Proxy

log = logging.getLogger("veneur-proxy")

MODULE = "veneur_tpu_torch.cli.proxy"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="veneur-proxy-torch")
    ap.add_argument("-f", dest="config", required=True,
                    help="The config file to read for settings.")
    args = ap.parse_args(argv)
    upgrade.record_startup_argv(MODULE, argv)
    try:
        config = read_proxy_config(args.config)
    except (OSError, ValueError) as e:
        log.error("Error reading config file: %s", e)
        return 1
    logging.basicConfig(
        level=logging.DEBUG if config.debug else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    proxy = Proxy(config)
    done = threading.Event()

    def handle_signal(signum, frame):
        log.info("Received signal %d, shutting down", signum)
        upgrade.request_shutdown(done)

    handle_usr2 = upgrade.make_sigusr2_handler(args.config, MODULE, done, log)
    signal.signal(signal.SIGTERM, handle_signal)
    signal.signal(signal.SIGINT, handle_signal)
    signal.signal(signal.SIGUSR2, handle_usr2)
    proxy.start()
    log.info("Starting proxy on %s (HTTP port %d%s)", config.http_address,
             proxy.port, f", gRPC port {proxy.grpc_server.port}"
             if proxy.grpc_server is not None else "")
    upgrade.notify_ready()
    done.wait()
    try:
        proxy.shutdown()
    finally:
        upgrade.reap_unfinished_replacement(log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
