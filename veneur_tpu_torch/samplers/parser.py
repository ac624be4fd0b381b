"""DogStatsD datagram parsing.

Port of the DogStatsD half of ``veneur_tpu/samplers/parser.py`` (itself a
behavioral port of ``veneur/samplers/parser.go``): the same
packet grammar, validation rules, magic-tag scoping and fnv1a-32 digest
over name, type and the comma-joined sorted tag list. SSF samples, events
and service checks are not ported yet: :func:`parse_event` and
:func:`parse_service_check` raise :class:`NotPortedError`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Union

# Metric scopes (parser.go:34-40)
MIXED_SCOPE = 0
LOCAL_ONLY = 1
GLOBAL_ONLY = 2

# numeric bounds of the store lanes (veneur_tpu/overload.py): past these a
# value would launder into inf (f32 digest staging), and a rate below
# MIN_SAMPLE_RATE overflows its float32 reciprocal weight
F32_ABS_MAX = 3.4028235e38
MIN_SAMPLE_RATE = 1e-38
# int64 counter lanes overflow past 2^63
_COUNTER_ABS_MAX = float(1 << 63)

_FNV1A_INIT32 = 0x811C9DC5
_FNV1A_PRIME32 = 0x01000193
_MASK32 = 0xFFFFFFFF


def fnv1a_32(data: Union[str, bytes], h: int = _FNV1A_INIT32) -> int:
    """32-bit FNV-1a (segmentio/fasthash-compatible), resumable."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    for b in data:
        h = ((h ^ b) * _FNV1A_PRIME32) & _MASK32
    return h


@dataclass(frozen=True)
class MetricKey:
    """The identity of a series (parser.go:42-48)."""

    name: str
    type: str
    joined_tags: str = ""


@dataclass
class UDPMetric:
    """One parsed sample (parser.go:21-32)."""

    key: MetricKey
    digest: int
    value: object  # float, or str for sets
    sample_rate: float = 1.0
    tags: List[str] = field(default_factory=list)
    scope: int = MIXED_SCOPE


class ParseError(ValueError):
    pass


class QuarantineError(ParseError):
    """A line that parsed but carries a poisoned payload (NaN/Inf,
    out-of-range values, an absurd sample rate), with a machine
    ``reason``."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


class NotPortedError(ParseError):
    """A well-formed line of a kind this port does not handle yet."""


_TYPE_BY_LEAD = {
    ord("c"): "counter",
    ord("g"): "gauge",
    ord("h"): "histogram",
    ord("m"): "timer",  # "ms"; only the first byte is inspected (parser.go:281)
    ord("s"): "set",
}


def _extract_scope_tags(tags: List[str]) -> tuple[List[str], int]:
    """Drop the first magic scope tag (prefix match) from a sorted tag
    list and return the scope it selects (parser.go:326-342)."""
    for i, tag in enumerate(tags):
        if tag.startswith("veneurlocalonly"):
            return tags[:i] + tags[i + 1:], LOCAL_ONLY
        if tag.startswith("veneurglobalonly"):
            return tags[:i] + tags[i + 1:], GLOBAL_ONLY
    return tags, MIXED_SCOPE


def _check_numeric(value: float, mtype: str, raw) -> None:
    """Non-finite values and values the typed store lanes cannot hold
    (int64 counters, f32 digest staging) raise QuarantineError."""
    if value != value or value in (float("inf"), float("-inf")):
        raise QuarantineError(
            "not_finite", f"Non-finite metric value: {raw!r}")
    if mtype == "counter" and abs(value) >= _COUNTER_ABS_MAX:
        raise QuarantineError(
            "out_of_range", f"Counter value overflows int64: {raw!r}")
    if mtype in ("histogram", "timer") and abs(value) > F32_ABS_MAX:
        raise QuarantineError(
            "out_of_range", f"Value exceeds float32 range: {raw!r}")


def parse_metric(packet: bytes) -> UDPMetric:
    """Parse one DogStatsD metric line (parser.go:232-363).

    Grammar: ``name:value|type[|@rate][|#tag1,tag2]``; sections after the
    type may appear in any order but at most once each."""
    chunks = bytes(packet).split(b"|")
    head = chunks[0]
    colon = head.find(b":")
    if colon == -1:
        raise ParseError("Invalid metric packet, need at least 1 colon")
    name_b, value_b = head[:colon], head[colon + 1:]
    if not name_b:
        raise ParseError("Invalid metric packet, name cannot be empty")
    if len(chunks) < 2:
        raise ParseError("Invalid metric packet, need at least 1 pipe for type")
    type_b = chunks[1]
    if not type_b:
        raise ParseError("Invalid metric packet, metric type not specified")

    mtype = _TYPE_BY_LEAD.get(type_b[0])
    if mtype is None:
        raise ParseError("Invalid type for metric")

    name = name_b.decode("utf-8", "replace")
    h = fnv1a_32(name)
    h = fnv1a_32(mtype, h)

    value: object
    if mtype == "set":
        value = value_b.decode("utf-8", "replace")
    else:
        try:
            value = float(value_b)
        except ValueError:
            raise ParseError(f"Invalid number for metric value: {value_b!r}")
        _check_numeric(value, mtype, value_b)

    sample_rate = 1.0
    found_rate = False
    tags: Optional[List[str]] = None
    joined = ""
    scope = MIXED_SCOPE
    for chunk in chunks[2:]:
        if not chunk:
            raise ParseError("Invalid metric packet, empty string after/between pipes")
        lead = chunk[0]
        if lead == ord("@"):
            if found_rate:
                raise ParseError("Invalid metric packet, multiple sample rates specified")
            try:
                sample_rate = float(chunk[1:])
            except ValueError:
                raise ParseError(f"Invalid float for sample rate: {chunk[1:]!r}")
            if not MIN_SAMPLE_RATE <= sample_rate <= 1:
                raise QuarantineError(
                    "bad_rate",
                    f"Sample rate {sample_rate} must be >0 and <=1")
            found_rate = True
        elif lead == ord("#"):
            if tags is not None:
                raise ParseError("Invalid metric packet, multiple tag sections specified")
            tags = sorted(chunk[1:].decode("utf-8", "replace").split(","))
            tags, scope = _extract_scope_tags(tags)
            joined = ",".join(tags)
            h = fnv1a_32(joined, h)
        else:
            raise ParseError(
                f"Invalid metric packet, contains unknown section {chunk!r}")

    return UDPMetric(
        key=MetricKey(name=name, type=mtype, joined_tags=joined),
        digest=h,
        value=value,
        sample_rate=sample_rate,
        tags=tags or [],
        scope=scope,
    )


def parse_event(packet: bytes):
    """DogStatsD events (``_e{...}``) are not ported yet."""
    raise NotPortedError("DogStatsD events are not ported yet "
                         "(veneur_tpu_torch handles metric lines only)")


def parse_service_check(packet: bytes):
    """DogStatsD service checks (``_sc|...``) are not ported yet."""
    raise NotPortedError("DogStatsD service checks are not ported yet "
                         "(veneur_tpu_torch handles metric lines only)")


def split_lines(packet: bytes):
    """Split a multi-metric datagram on newlines, skipping empty lines
    (cf. SplitBytes, samplers/split_bytes.go:17-56)."""
    for line in packet.split(b"\n"):
        if line:
            yield line
