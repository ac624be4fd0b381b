"""veneur-prometheus: poll a Prometheus ``/metrics`` endpoint and
translate it to DogStatsD (the reference's
``cmd/veneur-prometheus/main.go``), port of
``veneur_tpu/cli/prometheus.py``.

    python -m veneur_tpu_torch.cli.prometheus -H http://host:9090/metrics \
        -s 127.0.0.1:8126 -i 10s

A client, stdlib only: it does no device work (it imports no torch).
Counters and gauges map one to one; a summary emits ``.sum``,
``.count`` and one ``.{q}percentile`` gauge a quantile; a histogram
emits ``.sum``, ``.count`` and one cumulative ``.le{bound}`` count a
bucket (main.go:95-141). The label and metric ignore lists are regexes
(main.go:43-56, 160-181); ``-p`` prefixes every emitted name. The
exposition parser is self-contained: ``# TYPE`` comments carry a
family's type; sample lines are ``name{label="v",...} value``.
"""

from __future__ import annotations

import argparse
import logging
import math
import re
import socket
import sys
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

log = logging.getLogger("veneur-prometheus")

_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>.*)\})?\s+(?P<value>[^ ]+)(?:\s+\d+)?$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


@dataclass
class Family:
    name: str
    type: str = "untyped"
    samples: List[Tuple[str, Dict[str, str], float]] = field(
        default_factory=list)


def parse_exposition(text: str) -> List[Family]:
    """Parse Prometheus text exposition format into metric families."""
    families: Dict[str, Family] = {}
    types: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name = m.group("name")
        labels = {k: v.replace('\\"', '"').replace("\\\\", "\\")
                  for k, v in _LABEL_RE.findall(m.group("labels") or "")}
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        # histogram/summary series share the family name minus suffix
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in types:
                base = name[:-len(suffix)]
                break
        fam = families.setdefault(base, Family(base))
        fam.type = types.get(base, "untyped")
        fam.samples.append((name, labels, value))
    return list(families.values())


def _tags(labels: Dict[str, str],
          ignored: List[re.Pattern]) -> List[str]:
    out = []
    for k, v in labels.items():
        if any(p.search(k) for p in ignored):
            continue
        out.append(f"{k}:{v}")
    return out


def translate(families: List[Family], ignored_labels: List[re.Pattern],
              ignored_metrics: List[re.Pattern],
              prefix: str = "") -> List[bytes]:
    """Families → DogStatsD packets (collect, main.go:68-146)."""
    packets: List[bytes] = []
    pre = (prefix + ".") if prefix else ""

    def emit(name: str, value: float, kind: str, tags: List[str]):
        suffix = ("|#" + ",".join(tags)).encode() if tags else b""
        packets.append(f"{pre}{name}:{value:g}|{kind}".encode() + suffix)

    for fam in families:
        if any(p.search(fam.name) for p in ignored_metrics):
            continue
        if fam.type == "counter":
            for name, labels, value in fam.samples:
                emit(name, int(value), "c", _tags(labels, ignored_labels))
        elif fam.type == "gauge" or fam.type == "untyped":
            for name, labels, value in fam.samples:
                emit(name, value, "g", _tags(labels, ignored_labels))
        elif fam.type == "summary":
            for name, labels, value in fam.samples:
                tags = _tags({k: v for k, v in labels.items()
                              if k != "quantile"}, ignored_labels)
                if name.endswith("_sum"):
                    emit(f"{fam.name}.sum", value, "g", tags)
                elif name.endswith("_count"):
                    emit(f"{fam.name}.count", int(value), "c", tags)
                elif "quantile" in labels and not math.isnan(value):
                    q = int(float(labels["quantile"]) * 100)
                    emit(f"{fam.name}.{q}percentile", value, "g", tags)
        elif fam.type == "histogram":
            for name, labels, value in fam.samples:
                tags = _tags({k: v for k, v in labels.items() if k != "le"},
                             ignored_labels)
                if name.endswith("_sum"):
                    emit(f"{fam.name}.sum", value, "g", tags)
                elif name.endswith("_count"):
                    emit(f"{fam.name}.count", int(value), "c", tags)
                elif "le" in labels:
                    try:
                        bound = float(labels["le"])
                    except ValueError:
                        continue
                    if not math.isnan(bound):
                        # %f spelling matches the reference (main.go:133)
                        emit(f"{fam.name}.le{bound:f}", int(value), "c",
                             tags)
    return packets


def collect_once(metrics_url: str, stats_host: str,
                 ignored_labels: List[re.Pattern],
                 ignored_metrics: List[re.Pattern],
                 prefix: str = "") -> int:
    with urllib.request.urlopen(metrics_url, timeout=10.0) as resp:
        text = resp.read().decode("utf-8", "replace")
    packets = translate(parse_exposition(text), ignored_labels,
                        ignored_metrics, prefix)
    host, _, port = stats_host.rpartition(":")
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for pkt in packets:
            s.sendto(pkt, (host or "127.0.0.1", int(port)))
    finally:
        s.close()
    return len(packets)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="veneur-prometheus")
    ap.add_argument("-d", dest="debug", action="store_true")
    ap.add_argument("-H", "--host", dest="metrics_host",
                    default="http://localhost:9090/metrics")
    ap.add_argument("-i", dest="interval", default="10s")
    ap.add_argument("--ignored-labels", default="")
    ap.add_argument("--ignored-metrics", default="")
    ap.add_argument("-p", dest="prefix", default="")
    ap.add_argument("-s", dest="stats_host", default="127.0.0.1:8126")
    args = ap.parse_args(argv)
    if args.debug:
        logging.basicConfig(level=logging.DEBUG)

    from veneur_tpu_torch.config import parse_duration

    interval = parse_duration(args.interval)
    ignored_labels = [re.compile(p)
                      for p in args.ignored_labels.split(",") if p]
    ignored_metrics = [re.compile(p)
                       for p in args.ignored_metrics.split(",") if p]
    while True:
        try:
            n = collect_once(args.metrics_host, args.stats_host,
                             ignored_labels, ignored_metrics, args.prefix)
            log.debug("flushed %d packets", n)
        except Exception:
            log.exception("collection failed")
        time.sleep(interval)


if __name__ == "__main__":
    sys.exit(main())
