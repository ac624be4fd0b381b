"""veneur-emit: the shell-script metric emitter (the reference's
``cmd/veneur-emit/main.go``), port of ``veneur_tpu/cli/emit.py``.

    python -m veneur_tpu_torch.cli.emit -hostport 127.0.0.1:8126 \
        -name deploys -count 1 -tag env:prod

A client: it sends datagrams or one SSF span and does no device work
(it imports no torch). Three modes (main.go:31, flag validation
:100-157):

- ``metric`` (the default): ``-count``, ``-gauge``, ``-timing``, ``-set``
  with ``-name`` and ``-tag``, sent as DogStatsD datagrams, or under
  ``-ssf`` as one SSF span carrying the samples (senders :484-529),
  encoded with the port's codec (``protocol/ssf.py`` ``encode_span``).
  ``-command`` times the rest of the command line, reports it as a
  timing, and exits with the command's status (:354-391); the command
  sees the span's ids in ``VENEUR_EMIT_TRACE_ID`` and
  ``VENEUR_EMIT_PARENT_SPAN_ID``, so a nested emit parents under it.
- ``event``: ``-e_title``, ``-e_text``, ... as a DogStatsD ``_e{}``
  packet (:555-601).
- ``sc``: ``-sc_name``, ``-sc_status``, ... as a ``_sc`` packet
  (:603-642).
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import socket
import subprocess
import sys
import time
from typing import List, Optional

from veneur_tpu_torch.protocol import addr as vaddr
from veneur_tpu_torch.protocol import ssf, wire
from veneur_tpu_torch.trace import samples as ssf_samples

log = logging.getLogger("veneur-emit")

# env passthrough for nested span propagation (main.go:155-157)
ENV_TRACE_ID = "VENEUR_EMIT_TRACE_ID"
ENV_SPAN_ID = "VENEUR_EMIT_PARENT_SPAN_ID"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="veneur-emit")
    ap.add_argument("-hostport", default="",
                    help="Address of destination (hostport or listening "
                    "address URL).")
    ap.add_argument("-mode", default="metric",
                    choices=["metric", "event", "sc"])
    ap.add_argument("-debug", action="store_true")
    ap.add_argument("-command", action="store_true",
                    help="Time the trailing command and report it as a "
                    "timing metric.")
    # metric flags
    ap.add_argument("-name", default="")
    ap.add_argument("-gauge", type=float, default=None)
    ap.add_argument("-timing", default="")
    ap.add_argument("-count", type=int, default=None)
    ap.add_argument("-set", default="")
    ap.add_argument("-tag", default="")
    ap.add_argument("-ssf", action="store_true")
    # event flags
    ap.add_argument("-e_title", default="")
    ap.add_argument("-e_text", default="")
    ap.add_argument("-e_time", default="")
    ap.add_argument("-e_hostname", default="")
    ap.add_argument("-e_aggr_key", default="")
    ap.add_argument("-e_priority", default="normal")
    ap.add_argument("-e_source_type", default="")
    ap.add_argument("-e_alert_type", default="info")
    ap.add_argument("-e_event_tags", default="")
    # service check flags
    ap.add_argument("-sc_name", default="")
    ap.add_argument("-sc_status", default="")
    ap.add_argument("-sc_time", default="")
    ap.add_argument("-sc_hostname", default="")
    ap.add_argument("-sc_tags", default="")
    ap.add_argument("-sc_msg", default="")
    # tracing flags
    ap.add_argument("-trace_id", type=int, default=0)
    ap.add_argument("-parent_span_id", type=int, default=0)
    ap.add_argument("-span_service", default="veneur-emit")
    ap.add_argument("-indicator", action="store_true")
    return ap


def parse_tags(spec: str) -> List[str]:
    return [t for t in spec.split(",") if t]


def build_metric_packets(args) -> List[bytes]:
    """DogStatsD metric lines (the statsd sender, main.go:484-507)."""
    tags = parse_tags(args.tag)
    suffix = ("|#" + ",".join(tags)).encode() if tags else b""
    name = args.name.encode()
    out = []
    if args.count is not None:
        out.append(name + f":{args.count}|c".encode() + suffix)
    if args.gauge is not None:
        out.append(name + f":{args.gauge:g}|g".encode() + suffix)
    if args.timing:
        ms = parse_go_duration_ms(args.timing)
        out.append(name + f":{ms:g}|ms".encode() + suffix)
    if args.set:
        out.append(name + f":{args.set}|s".encode() + suffix)
    return out


def parse_go_duration_ms(s: str) -> float:
    from veneur_tpu_torch.config import parse_duration

    return parse_duration(s) * 1000.0


def build_event_packet(args, now: Optional[int] = None) -> bytes:
    """_e{title_len,text_len}: packet (main.go:555-601)."""
    if not args.e_title or not args.e_text:
        raise ValueError("Event mode requires e_title and e_text")
    title = args.e_title.encode()
    text = args.e_text.encode()
    pkt = b"_e{%d,%d}:%s|%s" % (len(title), len(text), title, text)
    if args.e_time:
        pkt += b"|d:%d" % int(args.e_time)
    elif now is not None:
        pkt += b"|d:%d" % now
    if args.e_hostname:
        pkt += b"|h:" + args.e_hostname.encode()
    if args.e_aggr_key:
        pkt += b"|k:" + args.e_aggr_key.encode()
    if args.e_priority and args.e_priority != "normal":
        pkt += b"|p:" + args.e_priority.encode()
    if args.e_source_type:
        pkt += b"|s:" + args.e_source_type.encode()
    if args.e_alert_type and args.e_alert_type != "info":
        pkt += b"|t:" + args.e_alert_type.encode()
    tags = parse_tags(args.e_event_tags)
    if tags:
        pkt += b"|#" + ",".join(tags).encode()
    return pkt


def build_service_check_packet(args, now: Optional[int] = None) -> bytes:
    """_sc|name|status packet (main.go:603-642)."""
    if not args.sc_name or args.sc_status == "":
        raise ValueError("Service check mode requires sc_name and sc_status")
    pkt = b"_sc|%s|%s" % (args.sc_name.encode(), args.sc_status.encode())
    if args.sc_time:
        pkt += b"|d:%d" % int(args.sc_time)
    elif now is not None:
        pkt += b"|d:%d" % now
    if args.sc_hostname:
        pkt += b"|h:" + args.sc_hostname.encode()
    tags = parse_tags(args.sc_tags)
    if tags:
        pkt += b"|#" + ",".join(tags).encode()
    if args.sc_msg:
        pkt += b"|m:" + args.sc_msg.encode()
    return pkt


def build_ssf_span(args, start: float, end: float,
                   exit_status: int = 0) -> ssf.SSFSpan:
    """One SSF span carrying the requested samples (createMetrics +
    setupSpan, main.go:393-482)."""
    tags = {}
    for t in parse_tags(args.tag):
        k, _, v = t.partition(":")
        tags[k] = v
    span = ssf.SSFSpan(
        name=args.name, service=args.span_service,
        start_timestamp=int(start * 1e9), end_timestamp=int(end * 1e9),
        indicator=args.indicator, error=exit_status != 0)
    trace_id = args.trace_id or int(os.environ.get(ENV_TRACE_ID, "0") or 0)
    parent_id = (args.parent_span_id
                 or int(os.environ.get(ENV_SPAN_ID, "0") or 0))
    if trace_id:
        span.trace_id = trace_id
        span.id = random.getrandbits(63)
        span.parent_id = parent_id
    if args.count is not None:
        span.metrics.append(ssf_samples.count(args.name, args.count, tags))
    if args.gauge is not None:
        span.metrics.append(ssf_samples.gauge(args.name, args.gauge, tags))
    if args.timing:
        span.metrics.append(ssf_samples.timing(
            args.name, parse_go_duration_ms(args.timing) / 1e3,
            tags, resolution=1e-3))
    if args.set:
        span.metrics.append(ssf_samples.set_sample(args.name, args.set, tags))
    return span


def send_packets(hostport: str, packets: List[bytes]) -> None:
    """Send datagrams/frames to a hostport or URL address
    (main.go:509-553)."""
    spec = hostport if "//" in hostport else f"udp://{hostport}"
    resolved = vaddr.resolve_addr(spec)
    s = socket.socket(resolved.socket_family, resolved.socket_type)
    try:
        s.connect(resolved.connect_target())
        for pkt in packets:
            s.send(pkt)
    finally:
        s.close()


def send_ssf(hostport: str, span: ssf.SSFSpan) -> None:
    spec = hostport if "//" in hostport else f"udp://{hostport}"
    resolved = vaddr.resolve_addr(spec)
    s = socket.socket(resolved.socket_family, resolved.socket_type)
    try:
        s.connect(resolved.connect_target())
        if resolved.family == "udp":
            s.send(ssf.encode_span(span))
        else:
            s.sendall(wire.frame_bytes(span))
    finally:
        s.close()


def time_command(argv: List[str], trace_id: int, span_id: int):
    """Run + time the trailing command (main.go:354-391); the child sees
    our span ids via the environment for nesting."""
    env = dict(os.environ)
    if trace_id:
        env[ENV_TRACE_ID] = str(trace_id)
        env[ENV_SPAN_ID] = str(span_id)
    start = time.time()
    proc = subprocess.run(argv, env=env)
    end = time.time()
    return start, end, proc.returncode


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    # everything after the first non-flag token is the timed command
    command_args: List[str] = []
    for i, tok in enumerate(argv):
        if not tok.startswith("-"):
            prev = argv[i - 1] if i else ""
            if prev.startswith("-") and "=" not in prev and \
                    prev.lstrip("-") not in ("debug", "command", "ssf",
                                             "indicator"):
                continue  # this token is a flag value
            command_args = argv[i:]
            argv = argv[:i]
            break
    args = build_parser().parse_args(argv)
    if args.debug:
        logging.basicConfig(level=logging.DEBUG)

    exit_status = 0
    now = int(time.time())
    if args.command:
        if not command_args:
            log.error("-command requires a command to time")
            return 1
        trace_id = args.trace_id or random.getrandbits(63)
        span_id = random.getrandbits(63)
        start, end, exit_status = time_command(command_args, trace_id,
                                               span_id)
        args.timing = f"{(end - start) * 1000.0}ms"
        if args.ssf:
            span = build_ssf_span(args, start, end, exit_status)
            span.trace_id = trace_id
            span.id = span_id
            send_ssf(args.hostport, span)
            return exit_status
    if args.mode == "event":
        send_packets(args.hostport, [build_event_packet(args, now)])
    elif args.mode == "sc":
        send_packets(args.hostport, [build_service_check_packet(args, now)])
    elif args.ssf:
        t = time.time()
        send_ssf(args.hostport, build_ssf_span(args, t, t, exit_status))
    else:
        send_packets(args.hostport, build_metric_packets(args))
    return exit_status


if __name__ == "__main__":
    sys.exit(main())
