"""The forwardrpc.MetricList wire, without protobuf.

Stands in for the JAX package's generated ``forward_pb2`` and
``metricpb_pb2`` where a local forwards over the framed-TCP lane (the
card's machine has no protobuf). Schema
(``protocol/proto/forwardrpc/forward.proto``, ``metricpb/metric.proto``,
``tdigestpb/tdigest.proto``):

    MetricList         1 metrics (repeated Metric)  14 topk (TopKSketch)
    Metric             1 name  2 tags (repeated)  3 type (enum)
                       oneof value: 5 counter  6 gauge  7 histogram  8 set
    CounterValue       1 value (int64)
    GaugeValue         1 value (double)
    HistogramValue     1 t_digest (MergingDigestData)
    SetValue           1 hyper_log_log (bytes)
    MergingDigestData  1 main_centroids (repeated Centroid)  2 compression
                       3 min  4 max (double)  14 packed_means
                       15 packed_weights (packed double)
                       16 quantized_means  17 quantized_weights (bytes)
    Centroid           1 mean  2 weight (double)
    TopKSketch         1 depth  2 width (uint32)  3 table (bytes)
                       4 series (repeated TopKSeries)
    TopKSeries         1 name  2 tags (repeated)  3 keys (packed uint64)
                       4 members (repeated)

The encoder writes what protobuf's own serializer writes for the same
message: fields in field-number order, proto3 defaults skipped (a double
counts as default only when its bits are zero), repeated strings written
even when empty. A oneof member set to its default is still present: a
counter of 0 is the ``counter`` field holding an empty submessage, which
the C++ decoder reads as a counter of 0, while a Metric with no value
member is a metric with no value. Digest groups forwarded as planes are
not written here: the C++ encoders (``native/egress.py``) write them.

The reader parses a ``TopKSketch`` (the global's import needs it), and
:func:`split_metric_list` walks a MetricList's ``metrics`` for the gRPC
proxy; malformed bytes raise
:class:`~veneur_tpu_torch.protocol.ssf.DecodeError`.
"""

from __future__ import annotations

import struct
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from veneur_tpu_torch.protocol.ssf import (DecodeError, _int32,
                                           _read_len, _read_tag,
                                           _read_varint, _skip, _str,
                                           _varint)

# metricpb.Type
COUNTER, GAUGE, HISTOGRAM, SET, TIMER = range(5)

_F64 = struct.Struct("<d")
_ZERO64 = b"\0" * 8


def _field(field: int, data: bytes) -> bytes:
    """A length-delimited field, written even when ``data`` is empty."""
    return _varint((field << 3) | 2) + _varint(len(data)) + data


def _double(field: int, v: float) -> bytes:
    bits = _F64.pack(v)
    return b"" if bits == _ZERO64 else _varint((field << 3) | 1) + bits


def _uint(field: int, v: int) -> bytes:
    return _varint(field << 3) + _varint(v) if v else b""


def _str_field(field: int, s: str) -> bytes:
    return _field(field, s.encode("utf-8")) if s else b""


def metric(name: str, tags: Sequence[str], pb_type: int, value_field: int,
           value: bytes) -> bytes:
    """One Metric: name, tags, type, and the value-oneof member
    ``value_field`` holding the submessage ``value``."""
    return (_str_field(1, name)
            + b"".join(_field(2, t.encode("utf-8")) for t in tags)
            + _uint(3, pb_type) + _field(value_field, value))


def counter(name: str, tags: Sequence[str], value: int) -> bytes:
    return metric(name, tags, COUNTER, 5, _uint(1, int(value)))


def gauge(name: str, tags: Sequence[str], value: float) -> bytes:
    return metric(name, tags, GAUGE, 6, _double(1, float(value)))


def set_metric(name: str, tags: Sequence[str], hll: bytes) -> bytes:
    return metric(name, tags, SET, 8, _field(1, hll) if hll else b"")


def digest(name: str, tags: Sequence[str], pb_type: int, means, weights,
           dmin: float, dmax: float, compression: float = 100.0,
           reference_compat: bool = False) -> bytes:
    """A histogram or timer Metric whose t-digest carries its centroids as
    the packed parallel arrays (fields 14/15) and, with
    ``reference_compat``, also as the reference's repeated Centroid
    messages (field 1), which a Go global reads."""
    means = np.ascontiguousarray(means, "<f8")
    weights = np.ascontiguousarray(weights, "<f8")
    td = bytearray()
    if reference_compat:
        for m, w in zip(means.tolist(), weights.tolist()):
            td += _field(1, _double(1, m) + _double(2, w))
    td += _double(2, compression) + _double(3, float(dmin)) \
        + _double(4, float(dmax))
    if len(means):
        td += _field(14, means.tobytes()) + _field(15, weights.tobytes())
    return metric(name, tags, pb_type, 7, _field(1, bytes(td)))


def topk_sketch(table: np.ndarray, series) -> bytes:
    """A TopKSketch: the [depth, width] float32 count-min table and each
    series' candidate keys ((hi, lo) u32 halves -> one u64) and members
    (None -> "")."""
    table = np.ascontiguousarray(table, "<f4")
    depth, width = table.shape
    out = bytearray(_uint(1, depth) + _uint(2, width))
    if table.size:
        out += _field(3, table.tobytes())
    for name, tags, keys, members in series:
        s = bytearray(_str_field(1, name))
        for t in tags:
            s += _field(2, t.encode("utf-8"))
        if keys:
            s += _field(3, b"".join(_varint((int(hi) << 32) | int(lo))
                                    for hi, lo in keys))
        for m in members:
            s += _field(4, (m or "").encode("utf-8"))
        out += _field(4, bytes(s))
    return bytes(out)


def framed_size(metric_bytes: bytes) -> int:
    """Bytes one serialized Metric takes inside a MetricList."""
    return 1 + len(_varint(len(metric_bytes))) + len(metric_bytes)


def metric_list(metrics: Sequence[bytes],
                topk: Optional[bytes] = None) -> bytes:
    """A MetricList of serialized Metrics and an optional TopKSketch."""
    body = b"".join(_field(1, m) for m in metrics)
    return body + _field(14, topk) if topk is not None else body


class TopKSeries(NamedTuple):
    name: str
    tags: List[str]
    keys: List[int]
    members: List[str]


class TopKSketch(NamedTuple):
    depth: int
    width: int
    table: bytes
    series: List[TopKSeries]


def _decode_series(buf, pos: int, end: int) -> TopKSeries:
    name, tags, keys, members = "", [], [], []
    while pos < end:
        field, wt, pos = _read_tag(buf, pos, end)
        if field in (1, 2, 4) and wt == 2:
            a, pos = _read_len(buf, pos, end)
            s = _str(buf, a, pos)
            if field == 1:
                name = s
            else:
                (tags if field == 2 else members).append(s)
        elif field == 3 and wt == 2:  # packed keys
            a, b = _read_len(buf, pos, end)
            while a < b:
                k, a = _read_varint(buf, a, b)
                keys.append(k)
            pos = b
        elif field == 3 and wt == 0:  # an unpacked key
            k, pos = _read_varint(buf, pos, end)
            keys.append(k)
        else:
            pos = _skip(buf, pos, end, field, wt)
    return TopKSeries(name, tags, keys, members)


def decode_topk(data: bytes) -> TopKSketch:
    """The TopKSketch of the serialized bytes (last scalar wins, unknown
    fields skipped, as protobuf's decoder does)."""
    buf = memoryview(data)
    pos, end = 0, len(buf)
    depth = width = 0
    table = b""
    series: List[TopKSeries] = []
    while pos < end:
        field, wt, pos = _read_tag(buf, pos, end)
        if field in (1, 2) and wt == 0:
            v, pos = _read_varint(buf, pos, end)
            if field == 1:
                depth = v & 0xFFFFFFFF
            else:
                width = v & 0xFFFFFFFF
        elif field == 3 and wt == 2:
            a, pos = _read_len(buf, pos, end)
            table = bytes(buf[a:pos])
        elif field == 4 and wt == 2:
            a, pos = _read_len(buf, pos, end)
            series.append(_decode_series(buf, a, pos))
        else:
            pos = _skip(buf, pos, end, field, wt)
    return TopKSketch(depth, width, table, series)


class MetricSpan(NamedTuple):
    """One ``metrics`` entry of a serialized MetricList: ``data[start:
    end]`` is its whole field record (tag, length, Metric), and the key
    fields read from the Metric's own fields."""
    start: int
    end: int
    name: str
    type: int
    tags: List[str]


def _metric_key(buf, pos: int, end: int) -> Tuple[str, int, List[str]]:
    name, pb_type, tags = "", 0, []
    while pos < end:
        field, wt, pos = _read_tag(buf, pos, end)
        if field in (1, 2) and wt == 2:
            a, pos = _read_len(buf, pos, end)
            if field == 1:
                name = _str(buf, a, pos)
            else:
                tags.append(_str(buf, a, pos))
        elif field == 3 and wt == 0:
            v, pos = _read_varint(buf, pos, end)
            pb_type = _int32(v)
        else:
            pos = _skip(buf, pos, end, field, wt)
    return name, pb_type, tags


def split_metric_list(data: bytes) -> List[MetricSpan]:
    """The ``metrics`` entries of a serialized MetricList, in order, each
    with its byte span and key. Other top-level fields (``topk``) are
    skipped. Repeated fields concatenate, so the records of any subset,
    joined, are a MetricList of those metrics: the gRPC proxy routes
    spans without re-encoding a metric."""
    buf = memoryview(data)
    pos, end = 0, len(buf)
    out: List[MetricSpan] = []
    while pos < end:
        start = pos
        field, wt, pos = _read_tag(buf, pos, end)
        if field == 1 and wt == 2:
            a, pos = _read_len(buf, pos, end)
            out.append(MetricSpan(start, pos, *_metric_key(buf, a, pos)))
        else:
            pos = _skip(buf, pos, end, field, wt)
    return out


__all__ = ["COUNTER", "GAUGE", "HISTOGRAM", "SET", "TIMER", "DecodeError",
           "MetricSpan", "TopKSeries", "TopKSketch", "counter",
           "decode_topk", "digest", "framed_size", "gauge", "metric",
           "metric_list", "set_metric", "split_metric_list", "topk_sketch"]
