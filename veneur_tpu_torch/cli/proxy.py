"""The proxy binary: ``python -m veneur_tpu_torch.cli.proxy -f proxy.yaml``
(cf. veneur/cmd/veneur-proxy/main.go:20-58). Brings up the consistent-
hashing proxy (the HTTP listener and, with ``grpc_forward_address``, the
gRPC one) until SIGINT or SIGTERM. It needs no GPU. The JAX package's
SIGUSR2 upgrade is not ported."""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from veneur_tpu_torch.config import read_proxy_config
from veneur_tpu_torch.proxy.proxy import Proxy

log = logging.getLogger("veneur-proxy")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="veneur-proxy-torch")
    ap.add_argument("-f", dest="config", required=True,
                    help="The config file to read for settings.")
    args = ap.parse_args(argv)
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
        done.set()

    signal.signal(signal.SIGTERM, handle_signal)
    signal.signal(signal.SIGINT, handle_signal)
    proxy.start()
    log.info("Starting proxy on %s (HTTP port %d%s)", config.http_address,
             proxy.port, f", gRPC port {proxy.grpc_server.port}"
             if proxy.grpc_server is not None else "")
    done.wait()
    proxy.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
