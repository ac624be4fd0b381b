"""The port's client CLIs against the JAX package's.

* ``emit``: for a table of command lines with a fixed clock and seeded
  ids, the DogStatsD datagrams and the ``-ssf`` span bytes (the port's
  codec against JAX ``sample_pb2``) are byte-equal, built and as sent
  over a real UDP socket; ``-command`` times the command, exits with its
  status and hands the span ids to it in the environment;
* ``prometheus``: seeded expositions parse and translate to the same
  packets, with and without ignore lists and a prefix; ``collect_once``
  scrapes an in-process endpoint and sends them.
"""

import random
import re
import socket
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from veneur_tpu.cli import emit as jemit
from veneur_tpu.cli import prometheus as jprom
from veneur_tpu_torch.cli import emit as temit
from veneur_tpu_torch.cli import prometheus as tprom
from veneur_tpu_torch.protocol import ssf

NOW = 1_700_000_000

EMIT_CASES = {
    "count": ["-name", "a.b", "-count", "3"],
    "gauge_tags": ["-name", "g", "-gauge", "2.5", "-tag", "env:prod,az:1"],
    "timing": ["-name", "t", "-timing", "250ms", "-tag", "k:v"],
    "set": ["-name", "s", "-set", "member-7"],
    "all": ["-name", "m", "-count", "-2", "-gauge", "1e-3", "-timing",
            "1.5s", "-set", "x"],
    "event": ["-mode", "event", "-e_title", "deploy", "-e_text",
              "v2 out", "-e_hostname", "h1", "-e_aggr_key", "k",
              "-e_priority", "low", "-e_source_type", "jenkins",
              "-e_alert_type", "error", "-e_event_tags", "a:b,c"],
    "event_time": ["-mode", "event", "-e_title", "t", "-e_text", "x",
                   "-e_time", "12345"],
    "sc": ["-mode", "sc", "-sc_name", "db.up", "-sc_status", "2",
           "-sc_hostname", "h", "-sc_tags", "role:db", "-sc_msg", "down"],
    "sc_time": ["-mode", "sc", "-sc_name", "x", "-sc_status", "0",
                "-sc_time", "99"],
}

SSF_CASES = {
    "count": ["-name", "c", "-count", "4", "-ssf"],
    "gauge_tag": ["-name", "g", "-gauge", "0.25", "-tag", "env:a", "-ssf"],
    "timing_trace": ["-name", "t", "-timing", "42ms", "-ssf", "-trace_id",
                     "77", "-parent_span_id", "5", "-span_service", "svc"],
    "set_indicator": ["-name", "s", "-set", "m1", "-ssf", "-indicator",
                      "-tag", "k:v"],
    "all_trace": ["-name", "a", "-count", "1", "-gauge", "3", "-timing",
                  "1s", "-set", "z", "-ssf", "-trace_id", "9"],
}


def _packets(mod, argv):
    args = mod.build_parser().parse_args(argv)
    if args.mode == "event":
        return [mod.build_event_packet(args, NOW)]
    if args.mode == "sc":
        return [mod.build_service_check_packet(args, NOW)]
    return mod.build_metric_packets(args)


@pytest.mark.parametrize("case", sorted(EMIT_CASES))
def test_emit_packets_equal_the_jax_cli(case):
    argv = EMIT_CASES[case]
    got = _packets(temit, argv)
    assert got == _packets(jemit, argv) and got


@pytest.mark.parametrize("case", sorted(SSF_CASES))
def test_emit_ssf_span_bytes_equal_the_jax_cli(case, monkeypatch):
    """The span the port builds encodes to the JAX CLI's bytes for the
    same arguments, clock and seeded span id; the JAX decoder reads it
    back to the same span."""
    from veneur_tpu.protocol.gen.ssf import sample_pb2

    monkeypatch.delenv(temit.ENV_TRACE_ID, raising=False)
    monkeypatch.delenv(temit.ENV_SPAN_ID, raising=False)
    argv = SSF_CASES[case]
    spans = {}
    for name, mod in (("jax", jemit), ("port", temit)):
        random.seed(31)
        args = mod.build_parser().parse_args(argv)
        spans[name] = mod.build_ssf_span(args, 100.25, 101.5, exit_status=1)
    ours = ssf.encode_span(spans["port"])
    assert ours == spans["jax"].SerializeToString()
    back = sample_pb2.SSFSpan()
    back.ParseFromString(ours)
    assert back == spans["jax"]


class _UDPSink:
    def __init__(self):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(10)
        self.hostport = f"127.0.0.1:{self.sock.getsockname()[1]}"

    def recv(self, n):
        return [self.sock.recv(65536) for _ in range(n)]

    def close(self):
        self.sock.close()


@pytest.mark.parametrize("case", ["all", "event", "sc", "ssf"])
def test_emit_main_sends_the_jax_datagrams(case, monkeypatch):
    """main() of each CLI over a real UDP socket, the clock fixed and
    the ids seeded: the same datagrams arrive."""
    argv = (SSF_CASES["all_trace"] if case == "ssf" else EMIT_CASES[case])
    sink = _UDPSink()
    try:
        got = {}
        for name, mod in (("jax", jemit), ("port", temit)):
            monkeypatch.setattr(mod.time, "time", lambda: NOW + 0.5)
            random.seed(3)
            assert mod.main(["-hostport", sink.hostport] + argv) == 0
            n = 1 if case != "all" else 4
            got[name] = sink.recv(n)
        assert got["port"] == got["jax"]
    finally:
        sink.close()


def test_emit_command_times_and_passes_the_exit_status(tmp_path,
                                                       monkeypatch):
    """-command runs the rest of the line, reports its wall time as a
    timing, exits with its status, and hands the span ids to it; -ssf
    sends the span, marked errored on a failing command."""
    monkeypatch.delenv(temit.ENV_TRACE_ID, raising=False)
    sink = _UDPSink()
    try:
        assert temit.main(["-hostport", sink.hostport, "-name", "cmd.ok",
                           "-command", "true"]) == 0
        (pkt,) = sink.recv(1)
        m = re.fullmatch(rb"cmd\.ok:([0-9.e+-]+)\|ms", pkt)
        assert m and 0.0 < float(m.group(1)) < 60_000.0
        assert temit.main(["-hostport", sink.hostport, "-name", "cmd.bad",
                           "-command", sys.executable, "-c",
                           "import sys; sys.exit(3)"]) == 3
        assert sink.recv(1)[0].startswith(b"cmd.bad:")
        env_file = tmp_path / "env"
        status = temit.main([
            "-hostport", sink.hostport, "-name", "cmd.ssf", "-ssf",
            "-trace_id", "1234", "-command", sys.executable, "-c",
            "import os, sys; open(sys.argv[1], 'w').write("
            "os.environ['VENEUR_EMIT_TRACE_ID'] + ' ' + "
            "os.environ['VENEUR_EMIT_PARENT_SPAN_ID']); sys.exit(2)",
            str(env_file)])
        assert status == 2
        span = ssf.decode_span(sink.recv(1)[0])
        trace_id, span_id = map(int, env_file.read_text().split())
        assert (span.trace_id, span.id) == (1234, span_id) == (
            trace_id, span.id)
        assert span.error and span.name == "cmd.ssf"
        assert [s.name for s in span.metrics] == ["cmd.ssf"]
        assert span.metrics[0].unit == "ms"
        assert temit.main(["-hostport", sink.hostport, "-command"]) == 1
    finally:
        sink.close()


# -- prometheus -----------------------------------------------------------------


def exposition(seed: int, families: int = 40) -> str:
    """A seeded text exposition: counters, gauges, untyped, summaries and
    histograms, with labels (escaped quotes among them), NaN quantiles,
    timestamps and +Inf buckets."""
    rng = np.random.default_rng(seed)
    out = []
    for f in range(families):
        kind = ["counter", "gauge", "untyped", "summary",
                "histogram"][f % 5]
        name = f"fam_{f}_{kind}"
        if kind != "untyped" or f % 2:
            out.append(f"# HELP {name} help text {f}")
            out.append(f"# TYPE {name} {kind}")
        for s in range(int(rng.integers(1, 4))):
            labels = {"inst": f"i{s}", "job": "j\\\"q\\\"" if s else "j"}
            lab = ",".join(f'{k}="{v}"' for k, v in labels.items())
            if kind in ("counter", "gauge", "untyped"):
                v = float(rng.integers(0, 1000)) if kind == "counter" \
                    else float(rng.normal(0, 100))
                ts = f" {1700000000000 + s}" if s == 1 else ""
                out.append(f"{name}{{{lab}}} {v}{ts}")
            elif kind == "summary":
                for q in ("0.5", "0.9", "0.99"):
                    v = "NaN" if s == 2 else f"{rng.gamma(2.0, 1.0):.6f}"
                    out.append(f'{name}{{{lab},quantile="{q}"}} {v}')
                out.append(f"{name}_sum{{{lab}}} {rng.gamma(2.0, 50.0)}")
                out.append(f"{name}_count{{{lab}}} {int(rng.integers(1, 99))}")
            else:
                acc = 0
                for le in ("0.1", "1", "10", "+Inf"):
                    acc += int(rng.integers(0, 20))
                    out.append(f'{name}_bucket{{{lab},le="{le}"}} {acc}')
                out.append(f"{name}_sum{{{lab}}} {rng.gamma(2.0, 5.0)}")
                out.append(f"{name}_count{{{lab}}} {acc}")
    return "\n".join(out) + "\n"


@pytest.mark.parametrize("seed,labels,metrics,prefix", [
    (1, "", "", ""),
    (2, "inst", "", "pre"),
    (3, "^job$", "fam_1_|summary", ""),
    (4, "", "histogram", "a.b"),
])
def test_prometheus_translation_equals_the_jax_cli(seed, labels, metrics,
                                                  prefix):
    text = exposition(seed)
    out = {}
    for name, mod in (("jax", jprom), ("port", tprom)):
        fams = mod.parse_exposition(text)
        out[name] = (
            # repr: a NaN quantile equals itself
            [(f.name, f.type, repr(f.samples)) for f in fams],
            mod.translate(fams, [re.compile(p) for p in labels.split(",")
                                 if p],
                          [re.compile(p) for p in metrics.split(",") if p],
                          prefix))
    assert out["port"] == out["jax"]
    assert len(out["port"][1]) > 20


def test_prometheus_collect_once_scrapes_and_sends():
    """collect_once scrapes an in-process /metrics over HTTP and sends
    each translated packet to the statsd address."""
    text = exposition(5, families=10).encode()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(text)))
            self.end_headers()
            self.wfile.write(text)

        def log_message(self, *args):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    sink = _UDPSink()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/metrics"
        n = tprom.collect_once(url, sink.hostport, [], [], "p")
        want = jprom.translate(jprom.parse_exposition(text.decode()), [],
                               [], "p")
        assert n == len(want)
        assert sorted(sink.recv(n)) == sorted(want)
    finally:
        sink.close()
        httpd.shutdown()
        httpd.server_close()
