"""Configuration of the port's server: the keys this slice implements.

A YAML file (the veneur key names) maps onto :class:`Config`. A key this
port does not implement yet raises :class:`UnsupportedConfig` instead of
being ignored, unless its value is empty or off (``""``, ``[]``,
``false``, ``null``) or ``digest_storage: dense``. PyYAML is imported
only inside :func:`read_config`: code that builds its ``Config`` directly
never needs it.
"""

from __future__ import annotations

import dataclasses
import re
import socket
from dataclasses import dataclass, field
from typing import List


class UnsupportedConfig(ValueError):
    """A configuration key or value this port does not implement yet."""


@dataclass
class Config:
    """Server configuration (config.go:3-89); field names are YAML keys."""

    statsd_listen_addresses: List[str] = field(default_factory=list)
    interval: str = "10s"
    percentiles: List[float] = field(default_factory=list)
    aggregates: List[str] = field(default_factory=list)
    tdigest_compression: float = 100.0
    hll_precision: int = 14
    hostname: str = ""
    tags: List[str] = field(default_factory=list)
    debug: bool = False
    debug_flushed_metrics: bool = False
    num_readers: int = 1
    metric_max_length: int = 4096
    read_buffer_size_bytes: int = 2 * 1048576

    def __post_init__(self):
        if not self.aggregates:
            self.aggregates = ["min", "max", "count"]
        if not self.hostname:
            self.hostname = socket.gethostname()
        for spec in self.statsd_listen_addresses:
            if not spec.startswith(("udp://", "udp4://", "udp6://")):
                raise UnsupportedConfig(
                    f"statsd_listen_addresses: {spec!r} is not a udp:// "
                    "address; TCP and UNIX listeners are not ported yet")

    @property
    def interval_seconds(self) -> float:
        return parse_duration(self.interval)


# values that leave an unimplemented key switched off
_OFF_VALUES = (None, "", [], {}, False)
_OFF_SETTINGS = {"digest_storage": "dense"}

_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
_DURATION_UNITS = {"ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3,
                   "s": 1.0, "m": 60.0, "h": 3600.0}


def parse_duration(s: str) -> float:
    """Go-style duration string -> seconds ("10s", "1m30s", "50ms")."""
    if not s:
        raise ValueError("empty duration")
    pos = 0
    total = 0.0
    for m in _DURATION_RE.finditer(s):
        if m.start() != pos:
            raise ValueError(f"invalid duration {s!r}")
        total += float(m.group(1)) * _DURATION_UNITS[m.group(2)]
        pos = m.end()
    if pos != len(s):
        raise ValueError(f"invalid duration {s!r}")
    return total


def config_from_dict(data: dict) -> Config:
    """Config from a parsed mapping; raises UnsupportedConfig on any key
    this port does not implement (switched-off values excepted)."""
    known = {f.name for f in dataclasses.fields(Config)}
    unsupported = sorted(
        k for k, v in data.items()
        if k not in known and v not in _OFF_VALUES
        and _OFF_SETTINGS.get(k, object()) != v)
    if unsupported:
        raise UnsupportedConfig(
            f"configuration keys not implemented by veneur_tpu_torch yet: "
            f"{unsupported} (run veneur_tpu for these)")
    return Config(**{k: v for k, v in data.items()
                     if k in known and v is not None})


def read_config(path: str) -> Config:
    """Load a YAML config file."""
    import yaml  # the card's machine may lack PyYAML; only files need it

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ValueError("config must be a YAML mapping")
    return config_from_dict(data)
