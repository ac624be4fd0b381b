"""The port's SSF codec and its SSF, event and service-check parsers
against the JAX package's.

* ``protocol/ssf.py`` against the generated ``sample_pb2`` (protobuf's
  own decoder): the golden fixture, ~200 seeded spans (negative and
  2^63 - 1 ids, unicode, empty fields, NaN and -0.0 floats, duplicate map
  keys, unknown fields of every wire type), every truncation of a few
  spans and ~400 seeded byte mutations decode to the same fields, or
  raise in both; the port's bytes decode under protobuf as they were
  meant, and equal protobuf's where every map has at most one entry
  (protobuf writes map entries in its hash table's order).
* ``parse_metric_ssf`` / ``convert_metrics`` / ``convert_indicator_metrics``
  on the same seeded spans: key, digest, value, rate, tags and scope
  equal, and the same samples rejected; ``parse_event`` and
  ``parse_service_check`` on a seeded corpus of valid and malformed
  packets: the same accept or reject, the same fields.
* Framing (``protocol/wire.py``): round trips both ways with the JAX
  package's framer, and the same error class for each fault.
"""

import io
import math
import pathlib
import struct

import numpy as np
import pytest
from google.protobuf.message import DecodeError as PbDecodeError

from veneur_tpu.protocol import wire as jwire
from veneur_tpu.protocol.gen.ssf import sample_pb2 as pb
from veneur_tpu.samplers import parser as jparser
from veneur_tpu_torch.protocol import ssf, wire
from veneur_tpu_torch.samplers import parser as tparser

FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / \
    "ssf_span.pb"
SAMPLE_FIELDS = ("metric", "name", "value", "timestamp", "message",
                 "status", "sample_rate", "unit")
SPAN_FIELDS = ("version", "trace_id", "id", "parent_id", "start_timestamp",
               "end_timestamp", "error", "service", "indicator", "name")


def _bits(v: float) -> bytes:
    return struct.pack("<f", v)


def _sample_tuple(s):
    return tuple(_bits(getattr(s, f)) if f in ("value", "sample_rate")
                 else getattr(s, f) for f in SAMPLE_FIELDS) + (
        dict(s.tags),)


def _span_tuple(span):
    return (tuple(getattr(span, f) for f in SPAN_FIELDS), dict(span.tags),
            [_sample_tuple(s) for s in span.metrics])


def _decode_both(raw: bytes):
    """(port span or its error class, protobuf span or its error)."""
    want = pb.SSFSpan()
    try:
        want.ParseFromString(raw)
    except PbDecodeError:
        want = None
    try:
        got = ssf.decode_span(raw)
    except ssf.DecodeError:
        got = None
    return got, want


def _assert_same_decode(raw: bytes):
    got, want = _decode_both(raw)
    assert (got is None) == (want is None), (raw.hex(), got, want)
    if got is not None:
        assert _span_tuple(got) == _span_tuple(want), raw.hex()


# ---------------------------------------------------------------------------
# a small wire writer of its own, for what protobuf's encoder never writes
# (duplicate map keys, unknown fields, fields out of order)
# ---------------------------------------------------------------------------


def _vi(n: int) -> bytes:
    n &= (1 << 64) - 1
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _fld(field: int, wt: int, payload) -> bytes:
    tag = _vi((field << 3) | wt)
    if wt == 0:
        return tag + _vi(payload)
    if wt == 2:
        return tag + _vi(len(payload)) + payload
    return tag + payload  # fixed-width payload bytes


def _unknown(rng, field: int) -> bytes:
    wt = int(rng.choice([0, 1, 2, 3, 5]))
    if wt == 0:
        return _fld(field, 0, int(rng.integers(0, 1 << 62)))
    if wt == 1:
        return _fld(field, 1, rng.bytes(8))
    if wt == 5:
        return _fld(field, 5, rng.bytes(4))
    if wt == 2:
        return _fld(field, 2, rng.bytes(int(rng.integers(0, 6))))
    return (_vi((field << 3) | 3) + _fld(1, 0, 5) + _fld(2, 2, b"xy")
            + _vi((field << 3) | 4))


_WORDS = ["", "a", "svc", "ü.name", "日本", "x" * 40, "name", "k:v", "é,ß"]


def _word(rng) -> str:
    return _WORDS[int(rng.integers(0, len(_WORDS)))]


def _map_entry(rng, key: str, value: str) -> bytes:
    parts = []
    if rng.random() > 0.1:
        parts.append(_fld(1, 2, key.encode()))
    if rng.random() > 0.1:
        parts.append(_fld(2, 2, value.encode()))
    if rng.random() < 0.1:
        parts.append(_unknown(rng, 3))  # drops the whole entry
    if rng.random() < 0.3:
        parts.reverse()
    return b"".join(parts)


def _tags(rng, field: int) -> bytes:
    out = b""
    keys = [_word(rng) for _ in range(int(rng.integers(0, 4)))]
    if keys and rng.random() < 0.3:
        keys.append(keys[0])  # a duplicate key: the last one wins
    for k in keys:
        out += _fld(field, 2, _map_entry(rng, k, _word(rng)))
    return out


_INTS = [0, 1, -1, 7, 1 << 31, -(1 << 31), (1 << 63) - 1, -(1 << 63),
         1 << 40, 123456789]
_FLOATS = [0.0, -0.0, 1.0, 0.5, 123456789.0, 3.4e38, 1e-40, float("nan"),
           float("inf"), -2.5, 1e39]


def _int(rng) -> int:
    return _INTS[int(rng.integers(0, len(_INTS)))]


def _f32_bytes(rng) -> bytes:
    v = _FLOATS[int(rng.integers(0, len(_FLOATS)))]
    with np.errstate(over="ignore"):
        return np.float32(v).tobytes()


def _sample_bytes(rng) -> bytes:
    parts = [
        _fld(1, 0, int(rng.integers(0, 6)) if rng.random() > 0.05 else -1),
        _fld(2, 2, _word(rng).encode()),
        _fld(3, 5, _f32_bytes(rng)),
        _fld(4, 0, _int(rng)),
        _fld(5, 2, _word(rng).encode()),
        _fld(6, 0, int(rng.integers(0, 5))),
        _fld(7, 5, _f32_bytes(rng)),
        _tags(rng, 8),
        _fld(9, 2, _word(rng).encode()),
    ]
    if rng.random() < 0.3:
        parts.append(_unknown(rng, int(rng.integers(10, 40))))
    if rng.random() < 0.2:
        parts.append(_fld(2, 0, 1))  # a known field on the wrong wire type
    order = rng.permutation(len(parts))
    return b"".join(parts[i] for i in order if rng.random() > 0.2)


def _span_bytes(rng) -> bytes:
    parts = [_fld(1, 0, _int(rng))]
    parts += [_fld(f, 0, _int(rng)) for f in range(2, 7)]
    parts += [_fld(7, 0, int(rng.integers(0, 3))),
              _fld(8, 2, _word(rng).encode()),
              _tags(rng, 11),
              _fld(12, 0, int(rng.integers(0, 2))),
              _fld(13, 2, _word(rng).encode())]
    parts += [_fld(10, 2, _sample_bytes(rng))
              for _ in range(int(rng.integers(0, 5)))]
    if rng.random() < 0.3:
        parts.append(_unknown(rng, int(rng.integers(14, 100))))
    if rng.random() < 0.2:
        parts.append(_fld(3, 5, b"\0\0\0\1"))  # id on the wrong wire type
    order = rng.permutation(len(parts))
    return b"".join(parts[i] for i in order if rng.random() > 0.1)


def _seeded_spans(seed: int = 101, n: int = 200):
    rng = np.random.default_rng(seed)
    return [_span_bytes(rng) for _ in range(n)]


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


def test_fixture_decodes_as_protobuf_does():
    raw = FIXTURE.read_bytes()
    _assert_same_decode(raw)
    span = ssf.decode_span(raw)
    assert (span.trace_id, span.service, span.indicator) == (
        7777777777, "payments-srv", True)
    # two tags: compare the decoded span, not the bytes
    want = pb.SSFSpan()
    want.ParseFromString(ssf.encode_span(span))
    assert _span_tuple(want) == _span_tuple(span)


@pytest.mark.parametrize("part", range(4))
def test_seeded_spans_decode_as_protobuf_does(part):
    spans = _seeded_spans()
    for raw in spans[part * 50:(part + 1) * 50]:
        _assert_same_decode(raw)


def test_seeded_spans_mostly_decode():
    """The corpus exercises decoding, not just rejection."""
    ok = sum(_decode_both(raw)[0] is not None for raw in _seeded_spans())
    assert ok > 150


def test_truncations_raise_or_decode_alike():
    raws = [FIXTURE.read_bytes()] + _seeded_spans(7, 6)
    rejected = 0
    for raw in raws:
        for cut in range(len(raw)):
            _assert_same_decode(raw[:cut])
            rejected += _decode_both(raw[:cut])[1] is None
    assert rejected > 50
    # lengths that run past the end, and over-long varints
    for bad in (b"\x42\x05ab", b"\x52\x0a\x08\x01", b"\x10" + b"\x80" * 10
                + b"\x01", b"\xf8\xff\xff\xff\xff\x0f\x01", b"\x0c",
                b"\x0e", b"\x00\x01", b"\x7b\x08\x01\x84\x01",
                b"\x42\x02\xc0\xaf", b"\x5a\x04\x0a\x02\xff\xfe"):
        with pytest.raises(PbDecodeError):
            pb.SSFSpan().ParseFromString(bad)
        with pytest.raises(ssf.DecodeError):
            ssf.decode_span(bad)


@pytest.mark.parametrize("where", ["span", "sample", "entry",
                                   "sample_entry"])
def test_group_nesting_limit_matches_protobuf(where):
    """Unknown groups nest up to protobuf's recursion limit (100 levels,
    a submessage taking one) and no deeper, in both decoders."""
    for d in (98, 99, 100, 101):
        raw = b"\x7b" * d + b"\x7c" * d
        if where in ("sample_entry", "entry"):
            raw = _fld(8 if where == "sample_entry" else 11, 2, raw)
        if where in ("sample", "sample_entry"):
            raw = _fld(10, 2, raw)
        _assert_same_decode(raw)


@pytest.mark.parametrize("seed", [11, 12])
def test_mutations_decode_as_protobuf_does(seed):
    rng = np.random.default_rng(seed)
    base = _seeded_spans(seed, 20)
    for i in range(200):
        raw = bytearray(base[i % len(base)])
        if not raw:
            continue
        for _ in range(int(rng.integers(1, 4))):
            raw[int(rng.integers(0, len(raw)))] = int(rng.integers(0, 256))
        _assert_same_decode(bytes(raw))


def _pb_span(rng, i: int):
    """A protobuf span with at most one tag a map."""
    span = pb.SSFSpan(
        version=_int(rng) & 0x7FFFFFFF, trace_id=_int(rng), id=_int(rng),
        parent_id=_int(rng), start_timestamp=_int(rng),
        end_timestamp=_int(rng), error=bool(i % 2), service=_word(rng),
        indicator=bool(i % 3 == 0), name=_word(rng))
    if i % 2:
        span.tags[_word(rng)] = _word(rng)
    for j in range(i % 4):
        s = span.metrics.add(metric=j % 5, name=_word(rng),
                             value=_FLOATS[(i + j) % 7],
                             timestamp=_int(rng), message=_word(rng),
                             status=j % 4, sample_rate=_FLOATS[j % 5],
                             unit=_word(rng))
        if j % 2:
            s.tags[_word(rng)] = _word(rng)
    return span


def test_encoding_matches_protobuf_bytes():
    rng = np.random.default_rng(21)
    for i in range(60):
        want = _pb_span(rng, i)
        raw = want.SerializeToString()
        got = ssf.decode_span(raw)
        assert ssf.encode_span(got) == raw, i
        assert _span_tuple(got) == _span_tuple(want)
    # negative int32 / enum values take ten bytes, as in protobuf
    assert ssf.SSFSpan(version=-1).SerializeToString() == \
        pb.SSFSpan(version=-1).SerializeToString()
    assert ssf.SSFSample(metric=-2).SerializeToString() == \
        pb.SSFSample(metric=-2).SerializeToString()


def test_port_encoding_decodes_under_protobuf():
    rng = np.random.default_rng(23)
    for raw in _seeded_spans(23, 60):
        span = ssf.decode_span(raw) if _decode_both(raw)[0] else None
        if span is None:
            continue
        span.tags.update({_word(rng): "1", "zz": "2"})
        want = pb.SSFSpan()
        want.ParseFromString(span.SerializeToString())
        assert _span_tuple(want) == _span_tuple(span)


def test_float_fields_round_to_float32():
    """A float field holds float32, as protobuf's: 123456789 ns reads
    back 123456792, and values past float32 become inf."""
    for v in (123456789.0, 0.1, 1e39, -1e39, 1e-46, float("nan")):
        got, want = ssf.SSFSample(value=v), pb.SSFSample(value=v)
        assert _bits(got.value) == _bits(want.value), v
        got.sample_rate = v
        want.sample_rate = v
        assert _bits(got.sample_rate) == _bits(want.sample_rate), v
    assert ssf.SSFSample(value=123456789).value == 123456792.0


# ---------------------------------------------------------------------------
# SSF sample parsing
# ---------------------------------------------------------------------------


def _metric_tuple(m):
    return (m.key.name, m.key.type, m.key.joined_tags, m.digest,
            m.value if not isinstance(m.value, float)
            or not math.isnan(m.value) else "nan",
            m.sample_rate, m.tags, m.scope, m.timestamp, m.message,
            m.hostname)


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except Exception as e:  # the class name and reason are compared
        return type(e).__name__, getattr(e, "reason", None)


def _sample_corpus(seed: int = 31):
    """(port span, JAX span) pairs decoded from the same seeded bytes,
    with named samples of every type and value so conversion succeeds
    as often as it rejects."""
    out = []
    for i, raw in enumerate(_seeded_spans(seed, 120)):
        got, want = _decode_both(raw)
        if got is None:
            continue
        extra = pb.SSFSpan()
        for j in range(3):
            s = extra.metrics.add(
                metric=(i + j) % 6, name=f"m{j}", value=float(i * j) / 3,
                message=f"u{j}", status=j, sample_rate=[0, 0.5, 1][j])
            s.tags["env"] = "prod"
            if i % 5 == 0:
                s.tags[["veneurlocalonly", "veneurglobalonly",
                        "veneurtopk"][j]] = ""
        blob = raw + extra.SerializeToString()
        out.append((ssf.decode_span(blob), _decode_both(blob)[1]))
    return out


def test_parse_metric_ssf_matches_jax():
    n_ok = 0
    for got_span, want_span in _sample_corpus():
        for gs, ws in zip(got_span.metrics, want_span.metrics):
            got = _outcome(tparser.parse_metric_ssf, gs)
            want = _outcome(jparser.parse_metric_ssf, ws)
            if want[0] == "ok":
                n_ok += 1
                assert got[0] == "ok", (gs, got)
                assert _metric_tuple(got[1]) == _metric_tuple(want[1])
                assert tparser.valid_metric(got[1]) == \
                    jparser.valid_metric(want[1])
            else:
                assert got == want, (gs, got, want)
    assert n_ok > 200


def test_convert_metrics_matches_jax():
    for got_span, want_span in _sample_corpus(33):
        got, got_bad = tparser.convert_metrics(got_span)
        want, want_bad = jparser.convert_metrics(want_span)
        assert [_metric_tuple(m) for m in got] == \
            [_metric_tuple(m) for m in want]
        assert [_sample_tuple(s) for s in got_bad] == \
            [_sample_tuple(s) for s in want_bad]


def test_convert_indicator_metrics_matches_jax():
    rng = np.random.default_rng(41)
    for i in range(50):
        start = int(rng.integers(0, 1 << 62))
        dur = int(rng.integers(1000, 10 ** 10))
        kw = dict(start_timestamp=start, end_timestamp=start + dur,
                  service=_word(rng), error=bool(i % 2),
                  indicator=bool(i % 5))
        got = tparser.convert_indicator_metrics(ssf.SSFSpan(**kw), "ind.t")
        want = jparser.convert_indicator_metrics(pb.SSFSpan(**kw), "ind.t")
        assert [_metric_tuple(m) for m in got] == \
            [_metric_tuple(m) for m in want]
        assert tparser.convert_indicator_metrics(ssf.SSFSpan(**kw), "") == []
    # the duration passes through the float field: float32
    span = ssf.SSFSpan(start_timestamp=1, end_timestamp=123456790,
                       indicator=True, service="s")
    (m,) = tparser.convert_indicator_metrics(span, "t")
    assert m.value == 123456792.0 and m.tags == ["error:false", "service:s"]


def test_parse_tags_to_map_matches_jax():
    for tags in (["a:b", "c", "d:e:f", ""], [], ["x:1", "x:2"]):
        assert tparser.parse_tags_to_map(tags) == \
            jparser.parse_tags_to_map(tags)


# ---------------------------------------------------------------------------
# events and service checks
# ---------------------------------------------------------------------------

EVENT_CASES = [
    b"_e{5,4}:title|text", b"_e{5,4}:title|text|#a:b,c",
    b"_e{2,5}:ti|te\\\\nx|d:1700000000|h:host|k:agg|p:low|s:src|t:error",
    b"_e{1,1}:a|b|p:normal|t:success|#x:y", b"_e{1,1}:a|b|t:bad",
    b"_e{1,1}:a|b|p:high", b"_e{1,1}:a|b|d:x", b"_e{1,1}:a|b|d:1|d:2",
    b"_e{1,1}:a|b|zz", b"_e{1,1}:a|b||", b"_e{0,1}:|b", b"_e{1,0}:a|",
    b"_e{x,1}:a|b", b"_e{1,x}:a|b", b"_e{1}:a|b", b"_e1,1:a|b",
    b"_e{1,1}a|b", b"_e{2,1}:a|b", b"_e{1,2}:a|b", b"_e{1,1}:a",
    "_e{2,2}:ü|ß".encode(), b"_e{1,1}:a|b|#k:v|#k:w",
    b"_e{1,1}:a|b|h:x|h:y",
]
SERVICE_CHECK_CASES = [
    b"_sc|svc|0", b"_sc|svc|1|d:1700000000|h:host|#a:b,c|m:msg\\\\nx",
    b"_sc|svc|2|#veneurlocalonly,x:y", b"_sc|svc|3|#veneurglobalonly",
    b"_sc|svc|3|#veneurlocalonlyz", b"_sc|svc|4", b"_sc|svc",
    b"_sc||0", b"_sc", b"_sx|svc|0", b"_sc|svc|0|m:a|h:b",
    b"_sc|svc|0|d:x", b"_sc|svc|0|zz", b"_sc|svc|0||",
    b"_sc|svc|0|h:a|h:b", "_sc|ü|1|m:é".encode(), b"_sc|svc|01",
]


def _event_tuple(e):
    return (e.name, e.message, e.timestamp, dict(e.tags), e.metric,
            _bits(e.value), _bits(e.sample_rate))


def _seeded_packets(cases, seed):
    """The cases plus seeded mutations: sections dropped, duplicated or
    swapped, and single bytes changed."""
    rng = np.random.default_rng(seed)
    out = list(cases)
    for i in range(200):
        parts = cases[i % len(cases)].split(b"|")
        op = int(rng.integers(0, 4))
        j = int(rng.integers(0, len(parts)))
        if op == 0 and len(parts) > 1:
            del parts[j]
        elif op == 1:
            parts.insert(j, parts[j])
        elif op == 2:
            k = int(rng.integers(0, len(parts)))
            parts[j], parts[k] = parts[k], parts[j]
        else:
            b = bytearray(parts[j] or b"x")
            b[int(rng.integers(0, len(b)))] = int(rng.choice(
                list(b"|:#,{}01239axhdmpkst_e")))
            parts[j] = bytes(b)
        out.append(b"|".join(parts))
    return out


def test_parse_event_matches_jax():
    ok = 0
    for line in _seeded_packets(EVENT_CASES, 51):
        got = _outcome(tparser.parse_event, line, 1234)
        want = _outcome(jparser.parse_event, line, 1234)
        assert got[0] == want[0], (line, got, want)
        if want[0] == "ok":
            ok += 1
            assert _event_tuple(got[1]) == _event_tuple(want[1]), line
    assert ok > 15
    e = tparser.parse_event(b"_e{1,1}:a|b|h:host|#x:y", 5)
    assert e.tags == {"vdogstatsd_ev": "", "vdogstatsd_hostname": "host",
                      "x": "y"}


def test_parse_service_check_matches_jax():
    ok = 0
    for line in _seeded_packets(SERVICE_CHECK_CASES, 53):
        got = _outcome(tparser.parse_service_check, line, 1234)
        want = _outcome(jparser.parse_service_check, line, 1234)
        assert got[0] == want[0], (line, got, want)
        if want[0] == "ok":
            ok += 1
            assert _metric_tuple(got[1]) == _metric_tuple(want[1]), line
    assert ok > 15


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


def test_parse_ssf_normalizes_as_jax():
    rng = np.random.default_rng(61)
    for raw in _seeded_spans(61, 80):
        got, want = _decode_both(raw)
        if got is None:
            continue
        extra = _fld(11, 2, _fld(1, 2, b"name") + _fld(2, 2, b"from-tag"))
        if rng.random() < 0.5:
            raw += extra
        assert _span_tuple(wire.parse_ssf(raw)) == \
            _span_tuple(jwire.parse_ssf(raw))


def test_valid_trace_matches_jax():
    for raw in _seeded_spans(63, 80):
        got, want = _decode_both(raw)
        if got is not None:
            assert wire.valid_trace(got) == jwire.valid_trace(want)


def test_framing_round_trips_both_ways():
    rng = np.random.default_rng(71)
    spans = [_pb_span(rng, i) for i in range(20)]
    ours = io.BytesIO()
    theirs = io.BytesIO()
    for s in spans:
        port_span = ssf.decode_span(s.SerializeToString())
        n = wire.write_ssf(ours, port_span)
        assert n == len(s.SerializeToString())
        jwire.write_ssf(theirs, s)
        assert wire.frame_bytes(port_span) == jwire.frame_bytes(s)
    assert ours.getvalue() == theirs.getvalue()
    for stream, read in ((io.BytesIO(theirs.getvalue()), wire.read_ssf),
                         (io.BytesIO(ours.getvalue()), jwire.read_ssf)):
        for s in spans:
            assert _span_tuple(read(stream)) == _span_tuple(jwire.parse_ssf(
                s.SerializeToString()))
        assert read(stream) is None  # clean EOF at a frame boundary


@pytest.mark.parametrize("frame,error", [
    (b"\x01\x00\x00\x00\x00", "FrameVersionError"),
    (struct.pack(">BI", 0, wire.MAX_FRAME_LENGTH + 1), "FrameLengthError"),
    (b"\x00\x00\x00", "FramingIOError"),
    (b"\x00\x00\x00\x00\x05ab", "FramingIOError"),
])
def test_framing_errors_match_jax(frame, error):
    for mod in (wire, jwire):
        with pytest.raises(mod.FramingError) as e:
            mod.read_ssf(io.BytesIO(frame))
        assert type(e.value).__name__ == error
        assert e.value.poisons_stream


def test_bad_body_leaves_the_stream_at_a_boundary():
    good = ssf.SSFSpan(id=1, service="s")
    stream = io.BytesIO(struct.pack(">BI", 0, 2) + b"\x0c\x00"
                        + wire.frame_bytes(good))
    with pytest.raises(ssf.DecodeError):
        wire.read_ssf(stream)
    assert wire.read_ssf(stream) == good
    with pytest.raises(wire.FrameLengthError):
        wire.frame_bytes(type("Big", (), {"SerializeToString": lambda self:
                                          b"\0" * (wire.MAX_FRAME_LENGTH
                                                   + 1)})())
