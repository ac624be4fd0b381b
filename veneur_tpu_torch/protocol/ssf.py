"""The SSF schema and its protobuf wire codec, without protobuf.

Stands in for the JAX package's generated ``sample_pb2`` (schema:
``protocol/proto/ssf/sample.proto``, wire-compatible with the reference's
``ssf/sample.proto``): the card's machine has no ``protobuf``. Two plain
message classes carry the proto3 field numbers and defaults:

    SSFSample  1 metric (enum)  2 name  3 value (float)  4 timestamp
               5 message  6 status (enum)  7 sample_rate (float)
               8 tags map<string,string>  9 unit
    SSFSpan    1 version (int32)  2 trace_id  3 id  4 parent_id
               5 start_timestamp  6 end_timestamp (int64)  7 error
               8 service  10 metrics (repeated SSFSample)
               11 tags map<string,string>  12 indicator  13 name

The decoder follows what protobuf's own (upb) decoder does with the same
bytes: the last occurrence of a scalar wins; float fields round to
float32 on assignment, as protobuf stores them; int32 and enum fields
keep the low 32 bits of their varint, int64 fields the low 64; strings
must be valid UTF-8; unknown fields of every wire type (groups included)
are skipped; a known field on an unexpected wire type is an unknown
field; a map entry holding an unknown field is dropped whole, as upb
moves it to the parent's unknown fields; a missing map key or value is
"" and the last duplicate key wins. Truncated input, over-long varints
and lengths, bad tags and stray end-groups raise :class:`DecodeError`.

The encoder writes fields in field-number order and skips proto3
defaults (a float counts as default only when its bits are zero, so
-0.0 is written), and writes map entries in insertion order. protobuf
writes them in its hash table's order, so encoded bytes equal
protobuf's only where each map has at most one entry.
"""

from __future__ import annotations

import ctypes
import enum
import struct
from typing import Dict, List, Optional

_U64 = (1 << 64) - 1
_F32 = struct.Struct("<f")


class DecodeError(ValueError):
    """Bytes that are not a well-formed SSF message."""


class Metric(enum.IntEnum):
    COUNTER = 0
    GAUGE = 1
    HISTOGRAM = 2
    SET = 3
    STATUS = 4


class Status(enum.IntEnum):
    OK = 0
    WARNING = 1
    CRITICAL = 2
    UNKNOWN = 3


def _f32(v) -> float:
    """A float as a protobuf ``float`` field holds it: rounded to float32
    (a C cast: out-of-range values become +-inf)."""
    return ctypes.c_float(v).value


class SSFSample:
    """A StatsD-style point-in-time metric (``ssf.SSFSample``)."""

    COUNTER, GAUGE, HISTOGRAM, SET, STATUS = (int(m) for m in Metric)
    OK, WARNING, CRITICAL, UNKNOWN = (int(s) for s in Status)

    __slots__ = ("metric", "name", "_value", "timestamp", "message",
                 "status", "_sample_rate", "tags", "unit")

    def __init__(self, metric: int = 0, name: str = "", value: float = 0.0,
                 timestamp: int = 0, message: str = "", status: int = 0,
                 sample_rate: float = 0.0,
                 tags: Optional[Dict[str, str]] = None, unit: str = ""):
        self.metric = int(metric)
        self.name = name
        self.value = value
        self.timestamp = int(timestamp)
        self.message = message
        self.status = int(status)
        self.sample_rate = sample_rate
        self.tags: Dict[str, str] = dict(tags) if tags else {}
        self.unit = unit

    @property
    def value(self) -> float:
        return self._value

    @value.setter
    def value(self, v) -> None:
        self._value = _f32(v)

    @property
    def sample_rate(self) -> float:
        return self._sample_rate

    @sample_rate.setter
    def sample_rate(self, v) -> None:
        self._sample_rate = _f32(v)

    def _fields(self):
        return (self.metric, self.name, _F32.pack(self._value),
                self.timestamp, self.message, self.status,
                _F32.pack(self._sample_rate), self.tags, self.unit)

    def __eq__(self, other) -> bool:
        return (isinstance(other, SSFSample)
                and self._fields() == other._fields())

    def __repr__(self) -> str:
        return (f"SSFSample(metric={self.metric}, name={self.name!r}, "
                f"value={self.value!r}, timestamp={self.timestamp}, "
                f"message={self.message!r}, status={self.status}, "
                f"sample_rate={self.sample_rate!r}, tags={self.tags!r}, "
                f"unit={self.unit!r})")

    def SerializeToString(self) -> bytes:  # noqa: N802 - protobuf's name
        return encode_sample(self)


class SSFSpan:
    """A trace span that may embed metric samples (``ssf.SSFSpan``)."""

    __slots__ = ("version", "trace_id", "id", "parent_id",
                 "start_timestamp", "end_timestamp", "error", "service",
                 "metrics", "tags", "indicator", "name")

    def __init__(self, version: int = 0, trace_id: int = 0, id: int = 0,
                 parent_id: int = 0, start_timestamp: int = 0,
                 end_timestamp: int = 0, error: bool = False,
                 service: str = "",
                 metrics: Optional[List[SSFSample]] = None,
                 tags: Optional[Dict[str, str]] = None,
                 indicator: bool = False, name: str = ""):
        self.version = int(version)
        self.trace_id = int(trace_id)
        self.id = int(id)
        self.parent_id = int(parent_id)
        self.start_timestamp = int(start_timestamp)
        self.end_timestamp = int(end_timestamp)
        self.error = bool(error)
        self.service = service
        self.metrics: List[SSFSample] = list(metrics) if metrics else []
        self.tags: Dict[str, str] = dict(tags) if tags else {}
        self.indicator = bool(indicator)
        self.name = name

    def _fields(self):
        return tuple(getattr(self, f) for f in self.__slots__)

    def __eq__(self, other) -> bool:
        return (isinstance(other, SSFSpan)
                and self._fields() == other._fields())

    def __repr__(self) -> str:
        return "SSFSpan(" + ", ".join(
            f"{f}={getattr(self, f)!r}" for f in self.__slots__) + ")"

    def SerializeToString(self) -> bytes:  # noqa: N802 - protobuf's name
        return encode_span(self)


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    n &= _U64  # negatives as their 64-bit two's complement (10 bytes)
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _put_varint(out: bytearray, field: int, v: int) -> None:
    if v:
        out += _varint(field << 3)
        out += _varint(v)


def _put_bytes(out: bytearray, field: int, data: bytes) -> None:
    out += _varint((field << 3) | 2)
    out += _varint(len(data))
    out += data


def _put_str(out: bytearray, field: int, s: str) -> None:
    if s:
        _put_bytes(out, field, s.encode("utf-8"))


def _put_f32(out: bytearray, field: int, v: float) -> None:
    bits = _F32.pack(v)
    if bits != b"\0\0\0\0":
        out += _varint((field << 3) | 5)
        out += bits


def _put_map(out: bytearray, field: int, tags: Dict[str, str]) -> None:
    for k, v in tags.items():
        kb, vb = k.encode("utf-8"), v.encode("utf-8")
        entry = (b"\x0a" + _varint(len(kb)) + kb
                 + b"\x12" + _varint(len(vb)) + vb)
        _put_bytes(out, field, entry)


def encode_sample(s: SSFSample) -> bytes:
    """The protobuf bytes of one SSFSample."""
    out = bytearray()
    _put_varint(out, 1, s.metric)
    _put_str(out, 2, s.name)
    _put_f32(out, 3, s.value)
    _put_varint(out, 4, s.timestamp)
    _put_str(out, 5, s.message)
    _put_varint(out, 6, s.status)
    _put_f32(out, 7, s.sample_rate)
    _put_map(out, 8, s.tags)
    _put_str(out, 9, s.unit)
    return bytes(out)


def encode_span(span: SSFSpan) -> bytes:
    """The protobuf bytes of one SSFSpan."""
    out = bytearray()
    _put_varint(out, 1, span.version)
    _put_varint(out, 2, span.trace_id)
    _put_varint(out, 3, span.id)
    _put_varint(out, 4, span.parent_id)
    _put_varint(out, 5, span.start_timestamp)
    _put_varint(out, 6, span.end_timestamp)
    _put_varint(out, 7, int(span.error))
    _put_str(out, 8, span.service)
    for sample in span.metrics:
        _put_bytes(out, 10, encode_sample(sample))
    _put_map(out, 11, span.tags)
    _put_varint(out, 12, int(span.indicator))
    _put_str(out, 13, span.name)
    return bytes(out)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

# upb's default recursion limit: a submessage and a group each take a
# level, so a sample's groups nest one level less deep than a span's
_MAX_DEPTH = 100


def _read_varint(buf, pos: int, end: int):
    result = shift = 0
    for i in range(10):
        if pos >= end:
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result & _U64, pos
        shift += 7
    raise DecodeError("varint longer than 10 bytes")


def _read_tag(buf, pos: int, end: int):
    tag, pos = _read_varint(buf, pos, end)
    if tag > 0xFFFFFFFF or tag >> 3 == 0:
        raise DecodeError(f"invalid tag {tag}")
    return tag >> 3, tag & 7, pos


def _read_len(buf, pos: int, end: int):
    n, pos = _read_varint(buf, pos, end)
    if n > end - pos:
        raise DecodeError(f"length {n} runs past the message")
    return pos, pos + n


def _skip(buf, pos: int, end: int, field: int, wt: int, depth: int = 0):
    """Skip one unknown field's payload; returns the position after it."""
    if wt == 0:
        return _read_varint(buf, pos, end)[1]
    if wt == 1 or wt == 5:
        pos += 8 if wt == 1 else 4
        if pos > end:
            raise DecodeError("truncated fixed-width field")
        return pos
    if wt == 2:
        return _read_len(buf, pos, end)[1]
    if wt == 3:
        if depth >= _MAX_DEPTH:
            raise DecodeError("groups nested too deeply")
        while True:
            f, w, pos = _read_tag(buf, pos, end)
            if w == 4:
                if f != field:
                    raise DecodeError("mismatched end-group")
                return pos
            pos = _skip(buf, pos, end, f, w, depth + 1)
    raise DecodeError(f"unexpected wire type {wt}")


def _str(buf, a: int, b: int) -> str:
    try:
        return bytes(buf[a:b]).decode("utf-8")
    except UnicodeDecodeError as e:
        raise DecodeError(f"invalid UTF-8 in a string field: {e}") from None


def _int64(v: int) -> int:
    return v - (1 << 64) if v >> 63 else v


def _int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >> 31 else v


def _map_entry(buf, pos: int, end: int, depth: int):
    """(key, value) of one map entry, or None when it holds an unknown
    field (protobuf then keeps it as an unknown field of the parent)."""
    key = value = ""
    known = True
    while pos < end:
        field, wt, pos = _read_tag(buf, pos, end)
        if wt == 2 and field in (1, 2):
            a, pos = _read_len(buf, pos, end)
            if field == 1:
                key = _str(buf, a, pos)
            else:
                value = _str(buf, a, pos)
        else:
            pos = _skip(buf, pos, end, field, wt, depth)
            known = False
    return (key, value) if known else None


def _decode_sample(buf, pos: int, end: int, depth: int = 0) -> SSFSample:
    s = SSFSample()
    while pos < end:
        field, wt, pos = _read_tag(buf, pos, end)
        if wt == 0 and field in (1, 4, 6):
            v, pos = _read_varint(buf, pos, end)
            if field == 1:
                s.metric = _int32(v)
            elif field == 4:
                s.timestamp = _int64(v)
            else:
                s.status = _int32(v)
        elif wt == 5 and field in (3, 7):
            if pos + 4 > end:
                raise DecodeError("truncated float")
            v = _F32.unpack_from(buf, pos)[0]
            pos += 4
            if field == 3:
                s._value = v
            else:
                s._sample_rate = v
        elif wt == 2 and field in (2, 5, 8, 9):
            a, pos = _read_len(buf, pos, end)
            if field == 8:
                kv = _map_entry(buf, a, pos, depth + 1)
                if kv is not None:
                    s.tags[kv[0]] = kv[1]
            elif field == 2:
                s.name = _str(buf, a, pos)
            elif field == 5:
                s.message = _str(buf, a, pos)
            else:
                s.unit = _str(buf, a, pos)
        else:
            pos = _skip(buf, pos, end, field, wt, depth)
    return s


_SPAN_INT64 = {2: "trace_id", 3: "id", 4: "parent_id",
               5: "start_timestamp", 6: "end_timestamp"}


def _decode_span(buf, pos: int, end: int) -> SSFSpan:
    span = SSFSpan()
    while pos < end:
        field, wt, pos = _read_tag(buf, pos, end)
        if wt == 0 and (field in _SPAN_INT64 or field in (1, 7, 12)):
            v, pos = _read_varint(buf, pos, end)
            if field == 1:
                span.version = _int32(v)
            elif field == 7:
                span.error = v != 0
            elif field == 12:
                span.indicator = v != 0
            else:
                setattr(span, _SPAN_INT64[field], _int64(v))
        elif wt == 2 and field in (8, 10, 11, 13):
            a, pos = _read_len(buf, pos, end)
            if field == 10:
                span.metrics.append(_decode_sample(buf, a, pos, 1))
            elif field == 11:
                kv = _map_entry(buf, a, pos, 1)
                if kv is not None:
                    span.tags[kv[0]] = kv[1]
            elif field == 8:
                span.service = _str(buf, a, pos)
            else:
                span.name = _str(buf, a, pos)
        else:
            pos = _skip(buf, pos, end, field, wt)
    return span


def decode_span(data: bytes) -> SSFSpan:
    """Decode one SSFSpan; raises DecodeError on malformed bytes."""
    buf = memoryview(data).cast("B") if not isinstance(data, bytes) \
        else data
    return _decode_span(buf, 0, len(buf))


def decode_sample(data: bytes) -> SSFSample:
    """Decode one SSFSample; raises DecodeError on malformed bytes."""
    buf = memoryview(data).cast("B") if not isinstance(data, bytes) \
        else data
    return _decode_sample(buf, 0, len(buf))
