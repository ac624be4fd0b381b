"""DogStatsD datagram and SSF-sample parsing.

Port of ``veneur_tpu/samplers/parser.py`` (itself a behavioral port of
``veneur/samplers/parser.go``): the same packet grammar, validation
rules, magic-tag scoping and fnv1a-32 digest over name, type and the
comma-joined sorted tag list, for metric lines, DogStatsD events and
service checks, and the metric samples SSF spans carry. SSF messages
come from the port's own codec (``protocol/ssf.py``), not protobuf.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Union

from veneur_tpu_torch.overload import F32_ABS_MAX, MIN_SAMPLE_RATE
from veneur_tpu_torch.protocol import constants as dogstatsd
from veneur_tpu_torch.protocol import ssf

# Metric scopes (parser.go:34-40)
MIXED_SCOPE = 0
LOCAL_ONLY = 1
GLOBAL_ONLY = 2
TOPK_SCOPE = 3  # veneur_ingest.cpp Scope::kTopK: heavy-hitter SSF sets

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
    value: object  # float, str (sets), or the SSF status enum's int
    sample_rate: float = 1.0
    tags: List[str] = field(default_factory=list)
    scope: int = MIXED_SCOPE
    timestamp: int = 0
    message: str = ""
    hostname: str = ""


class ParseError(ValueError):
    pass


class QuarantineError(ParseError):
    """A line that parsed but carries a poisoned payload (NaN/Inf,
    out-of-range values, an absurd sample rate), with a machine
    ``reason``."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


_TYPE_BY_LEAD = {
    ord("c"): "counter",
    ord("g"): "gauge",
    ord("h"): "histogram",
    ord("m"): "timer",  # "ms"; only the first byte is inspected (parser.go:281)
    ord("s"): "set",
}


def _extract_scope_tags(tags: List[str],
                        prefix_match: bool = True) -> tuple[List[str], int]:
    """Drop the first magic scope tag from a sorted tag list and return
    the scope it selects (parser.go:326-342). Metric lines match by
    prefix; service checks compare exactly (``prefix_match=False``)."""
    for i, tag in enumerate(tags):
        if prefix_match:
            local = tag.startswith("veneurlocalonly")
            glob = tag.startswith("veneurglobalonly")
        else:
            local = tag == "veneurlocalonly"
            glob = tag == "veneurglobalonly"
        if local:
            return tags[:i] + tags[i + 1:], LOCAL_ONLY
        if glob:
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


def truncate_joined_tags(joined: str, limit: int) -> str:
    """Cut a joined tag string at the last whole tag within ``limit``
    (the per-series tag-length cap; identities merge past it)."""
    if not limit or len(joined) <= limit:
        return joined
    cut = joined.rfind(",", 0, limit + 1)
    return joined[:cut] if cut > 0 else joined[:limit]


def parse_metric(packet: bytes, max_tag_length: int = 0,
                 quarantine=None) -> UDPMetric:
    """Parse one DogStatsD metric line (parser.go:232-363).

    Grammar: ``name:value|type[|@rate][|#tag1,tag2]``; sections after the
    type may appear in any order but at most once each.
    ``max_tag_length`` caps the joined tag string: an oversized tag set
    is cut at a tag boundary and counted in ``quarantine`` under
    ``oversized_tags``."""
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
            if max_tag_length and len(joined) > max_tag_length:
                if quarantine is not None:
                    quarantine.count("oversized_tags")
                joined = truncate_joined_tags(joined, max_tag_length)
                tags = joined.split(",") if joined else []
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


_SSF_TYPE_NAMES = {
    ssf.SSFSample.COUNTER: "counter",
    ssf.SSFSample.GAUGE: "gauge",
    ssf.SSFSample.HISTOGRAM: "histogram",
    ssf.SSFSample.SET: "set",
    ssf.SSFSample.STATUS: "status",
}


def parse_metric_ssf(sample) -> UDPMetric:
    """Convert one embedded SSFSample to a UDPMetric (parser.go:179-230).
    Non-finite and out-of-range values raise QuarantineError, as on the
    statsd lane."""
    mtype = _SSF_TYPE_NAMES.get(sample.metric)
    if mtype is None:
        raise ParseError("Invalid type for metric")
    h = fnv1a_32(sample.name)
    h = fnv1a_32(mtype, h)

    if sample.metric == ssf.SSFSample.SET:
        value: object = sample.message
    elif sample.metric == ssf.SSFSample.STATUS:
        value = int(sample.status)
    else:
        value = float(sample.value)
        _check_numeric(value, mtype, sample.value)

    scope = MIXED_SCOPE
    tags = []
    topk = False
    for k, v in sample.tags.items():
        if k == "veneurlocalonly":
            scope = LOCAL_ONLY
            continue
        if k == "veneurglobalonly":
            scope = GLOBAL_ONLY
            continue
        if k == "veneurtopk":
            topk = True
        tags.append(f"{k}:{v}")
    tags.sort()
    # heavy-hitter routing, as the statsd lane's veneurtopk tag: only
    # sets re-route, and the tag stays in the list
    if topk and sample.metric == ssf.SSFSample.SET:
        scope = TOPK_SCOPE
    joined = ",".join(tags)
    h = fnv1a_32(joined, h)
    return UDPMetric(
        key=MetricKey(name=sample.name, type=mtype, joined_tags=joined),
        digest=h,
        value=value,
        # proto3's absent-field default is 0; absent means unsampled
        sample_rate=sample.sample_rate if sample.sample_rate > 0 else 1.0,
        tags=tags,
        scope=scope,
    )


def valid_metric(metric: UDPMetric) -> bool:
    """Name and value must both be present (parser.go:152-157)."""
    return (bool(metric.key.name) and metric.value is not None
            and metric.value != "")


def convert_metrics(span) -> tuple[List[UDPMetric], List]:
    """Extract all valid metrics from a span; returns (metrics, invalid
    samples) (parser.go:70-92)."""
    out: List[UDPMetric] = []
    invalid = []
    for sample in span.metrics:
        try:
            m = parse_metric_ssf(sample)
        except ParseError:
            invalid.append(sample)
            continue
        if not valid_metric(m):
            invalid.append(sample)
            continue
        out.append(m)
    return out, invalid


def convert_indicator_metrics(span, timer_name: str) -> List[UDPMetric]:
    """The duration timer of an indicator span (parser.go:94-121): a
    nanosecond histogram tagged with the service and the error status.
    The duration passes through the sample's float field, so it rounds
    to float32 here (the C++ lane keeps it a double)."""
    if not span.indicator or not timer_name:
        return []
    duration_ns = span.end_timestamp - span.start_timestamp
    sample = ssf.SSFSample(
        metric=ssf.SSFSample.HISTOGRAM,
        name=timer_name,
        value=float(duration_ns),
        unit="ns",
        sample_rate=1.0,
    )
    sample.tags["service"] = span.service
    sample.tags["error"] = "true" if span.error else "false"
    return [parse_metric_ssf(sample)]


def parse_tags_to_map(tags: List[str]) -> dict:
    """Split "k:v" tags into a map; tags without ':' map to ""
    (parser.go:628-640)."""
    out = {}
    for tag in tags:
        k, _, v = tag.partition(":")
        out[k] = v
    return out


def parse_event(packet: bytes, now: Optional[int] = None) -> ssf.SSFSample:
    """Parse a DogStatsD event (``_e{title_len,text_len}:title|text|...``)
    into an SSFSample whose ``vdogstatsd_*`` tags carry the
    Datadog-specific fields (parser.go:365-511)."""
    ret = ssf.SSFSample(timestamp=now if now is not None
                        else int(time.time()))
    ret.tags[dogstatsd.EVENT_IDENTIFIER_KEY] = ""

    chunks = bytes(packet).split(b"|")
    head = chunks[0]
    colon = head.find(b":")
    if colon == -1:
        raise ParseError("Invalid event packet, need at least 1 colon")
    lengths = head[:colon]
    if not lengths.startswith(b"_e{") or not lengths.endswith(b"}"):
        raise ParseError("Invalid event packet, must have _e{} wrapper "
                         "around length section")
    lengths = lengths[3:-1]
    comma = lengths.find(b",")
    if comma == -1:
        raise ParseError("Invalid event packet, length section requires "
                         "comma divider")
    try:
        title_len = int(lengths[:comma])
    except ValueError as e:
        raise ParseError(f"Invalid event packet, title length is not an "
                         f"integer: {e}")
    if title_len <= 0:
        raise ParseError("Invalid event packet, title length must be "
                         "positive")
    try:
        text_len = int(lengths[comma + 1:])
    except ValueError as e:
        raise ParseError(f"Invalid event packet, text length is not an "
                         f"integer: {e}")
    if text_len <= 0:
        raise ParseError("Invalid event packet, text length must be "
                         "positive")

    title = head[colon + 1:]
    if len(title) != title_len:
        raise ParseError("Invalid event packet, actual title length did "
                         "not match encoded length")
    ret.name = title.decode("utf-8", "replace")

    if len(chunks) < 2:
        raise ParseError("Invalid event packet, must have at least 1 pipe "
                         "for text")
    text = chunks[1]
    if len(text) != text_len:
        raise ParseError("Invalid event packet, actual text length did not "
                         "match encoded length")
    ret.message = text.decode("utf-8", "replace").replace("\\n", "\n")

    seen = set()

    def once(kind: str):
        if kind in seen:
            raise ParseError(f"Invalid event packet, multiple {kind} "
                             "sections")
        seen.add(kind)

    for chunk in chunks[2:]:
        if not chunk:
            raise ParseError("Invalid event packet, empty string "
                             "after/between pipes")
        if chunk.startswith(b"d:"):
            once("date")
            try:
                ret.timestamp = int(chunk[2:])
            except ValueError as e:
                raise ParseError(f"Invalid event packet, could not parse "
                                 f"date as unix timestamp: {e}")
        elif chunk.startswith(b"h:"):
            once("hostname")
            ret.tags[dogstatsd.EVENT_HOSTNAME_TAG] = chunk[2:].decode(
                "utf-8", "replace")
        elif chunk.startswith(b"k:"):
            once("aggregation key")
            ret.tags[dogstatsd.EVENT_AGGREGATION_KEY_TAG] = chunk[2:].decode(
                "utf-8", "replace")
        elif chunk.startswith(b"p:"):
            once("priority")
            pri = chunk[2:].decode("utf-8", "replace")
            if pri not in ("normal", "low"):
                raise ParseError("Invalid event packet, priority must be "
                                 "normal or low")
            ret.tags[dogstatsd.EVENT_PRIORITY_TAG] = pri
        elif chunk.startswith(b"s:"):
            once("source")
            ret.tags[dogstatsd.EVENT_SOURCE_TYPE_TAG] = chunk[2:].decode(
                "utf-8", "replace")
        elif chunk.startswith(b"t:"):
            once("alert")
            alert = chunk[2:].decode("utf-8", "replace")
            if alert not in ("error", "warning", "info", "success"):
                raise ParseError("Invalid event packet, alert level must be "
                                 "error, warning, info or success")
            ret.tags[dogstatsd.EVENT_ALERT_TYPE_TAG] = alert
        elif chunk[0] == ord("#"):
            once("tags")
            for k, v in parse_tags_to_map(
                    chunk[1:].decode("utf-8", "replace").split(",")).items():
                ret.tags[k] = v
        else:
            raise ParseError("Invalid event packet, unrecognized metadata "
                             "section")
    return ret


_STATUS_BY_BYTE = {
    b"0": ssf.SSFSample.OK,
    b"1": ssf.SSFSample.WARNING,
    b"2": ssf.SSFSample.CRITICAL,
    b"3": ssf.SSFSample.UNKNOWN,
}


def parse_service_check(packet: bytes,
                        now: Optional[int] = None) -> UDPMetric:
    """Parse a DogStatsD service check (``_sc|name|status|...``) into a
    "status" UDPMetric (parser.go:513-626)."""
    chunks = bytes(packet).split(b"|")
    if chunks[0] != b"_sc":
        raise ParseError("Invalid service check packet, no _sc prefix")
    if len(chunks) < 2:
        raise ParseError("Invalid service check packet, need name section")
    if not chunks[1]:
        raise ParseError("Invalid service check packet, empty name")
    name = chunks[1].decode("utf-8", "replace")
    if len(chunks) < 3:
        raise ParseError("Invalid service check packet, need status "
                         "section")
    status = _STATUS_BY_BYTE.get(chunks[2])
    if status is None:
        raise ParseError("Invalid service check packet, must have status "
                         "of 0, 1, 2, or 3")

    timestamp = now if now is not None else int(time.time())
    hostname = ""
    message = ""
    tags: List[str] = []
    scope = MIXED_SCOPE
    seen = set()

    def once(kind: str):
        if kind in seen:
            raise ParseError(f"Invalid service check packet, multiple "
                             f"{kind} sections")
        seen.add(kind)

    for chunk in chunks[3:]:
        if not chunk:
            raise ParseError("Invalid service packet packet, empty string "
                             "after/between pipes")
        if "message" in seen:
            raise ParseError("Invalid service check packet, message must "
                             "be the last metadata section")
        if chunk.startswith(b"d:"):
            once("date")
            try:
                timestamp = int(chunk[2:])
            except ValueError as e:
                raise ParseError(f"Invalid service check packet, could not "
                                 f"parse date as unix timestamp: {e}")
        elif chunk.startswith(b"h:"):
            once("hostname")
            hostname = chunk[2:].decode("utf-8", "replace")
        elif chunk.startswith(b"m:"):
            once("message")
            message = chunk[2:].decode("utf-8", "replace").replace("\\n",
                                                                   "\n")
        elif chunk[0] == ord("#"):
            once("tags")
            tags = sorted(chunk[1:].decode("utf-8", "replace").split(","))
            tags, scope = _extract_scope_tags(tags, prefix_match=False)
        else:
            raise ParseError("Invalid service check packet, unrecognized "
                             "metadata section")

    joined = ",".join(tags)
    h = fnv1a_32(name)
    h = fnv1a_32("status", h)
    h = fnv1a_32(joined, h)
    return UDPMetric(
        key=MetricKey(name=name, type="status", joined_tags=joined),
        digest=h,
        value=int(status),
        sample_rate=1.0,
        tags=tags,
        scope=scope,
        timestamp=timestamp,
        message=message,
        hostname=hostname,
    )


def split_lines(packet: bytes):
    """Split a multi-metric datagram on newlines, skipping empty lines
    (cf. SplitBytes, samplers/split_bytes.go:17-56)."""
    for line in packet.split(b"\n"):
        if line:
            yield line
