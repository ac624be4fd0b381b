"""Minimal Go ``encoding/gob`` stream codec — reference HTTP interop.

A reference (Go) local's ``POST /import`` body wraps each sketch in a
``JSONMetric`` whose ``value`` is the sampler's internal serialization
(the reference's ``samplers/samplers.go``): counters are a little-endian
int64, gauges a little-endian float64, sets the axiomhq binary sketch
(handled by ``ops/axiomhq.py``), and histograms/timers a **gob stream**
of ``[]tdigest.Centroid`` + compression + min + max
(``tdigest/merging_digest.go:375-394``).

This module implements exactly the subset of the gob wire format those
streams use — unsigned/signed ints, byte-reversed floats, strings,
struct/slice type definitions and values — validated against the
reference's checked-in fixture (``fixtures/import.uncompressed``).

Format summary (the encoding/gob specification):

- unsigned int: one byte if < 128, else a byte holding the NEGATED count
  of the minimal big-endian bytes that follow.
- signed int i: unsigned (i<<1), low bit set and bits complemented when
  negative.
- float64: IEEE-754 bytes reversed, then sent as an unsigned int.
- string/[]byte: unsigned length + raw bytes.
- stream: messages of (unsigned byte count, body). A body starts with a
  signed type id — negative defines that type (a wireType value
  follows), positive sends a value of the type. Non-struct top-level
  values are preceded by one delta byte (as if field 0 of a struct);
  struct values are (field delta, value) pairs ending with delta 0.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

# builtin gob type ids (gob/type.go)
BOOL, INT, UINT, FLOAT, BYTES, STRING = 1, 2, 3, 4, 5, 6


class GobError(ValueError):
    pass


class _Reader:
    __slots__ = ("data", "pos", "end")

    def __init__(self, data: bytes, pos: int = 0, end: int = -1):
        self.data = data
        self.pos = pos
        self.end = len(data) if end < 0 else end

    def byte(self) -> int:
        if self.pos >= self.end:
            raise GobError("truncated gob stream")
        b = self.data[self.pos]
        self.pos += 1
        return b

    def read_uint(self) -> int:
        b = self.byte()
        if b < 0x80:
            return b
        n = 256 - b
        if n > 8 or self.pos + n > self.end:
            raise GobError(f"bad uint byte count {n}")
        v = int.from_bytes(self.data[self.pos:self.pos + n], "big")
        self.pos += n
        return v

    def read_int(self) -> int:
        u = self.read_uint()
        return ~(u >> 1) if u & 1 else u >> 1

    def read_float(self) -> float:
        # the float64's bytes are REVERSED then sent as an unsigned int:
        # the wire number's big-endian bytes, read back least-significant
        # -first, are the original IEEE-754 bits
        u = self.read_uint()
        return struct.unpack("<d", u.to_bytes(8, "big"))[0]

    def read_bytes(self) -> bytes:
        n = self.read_uint()
        if self.pos + n > self.end:
            raise GobError("truncated gob bytes")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out


# wireType field indices (gob/type.go wireType struct)
_W_ARRAY, _W_SLICE, _W_STRUCT, _W_MAP = 0, 1, 2, 3


class _SliceType:
    __slots__ = ("elem",)

    def __init__(self, elem: int):
        self.elem = elem


class _StructType:
    __slots__ = ("name", "fields")  # fields: [(name, typeid)]

    def __init__(self, name: str, fields: List[Tuple[str, int]]):
        self.name = name
        self.fields = fields


class GobStream:
    """Decode one gob stream's values in order."""

    def __init__(self, data: bytes):
        self.r = _Reader(data)
        self.types: Dict[int, object] = {}

    def _read_common(self, r: _Reader) -> str:
        """CommonType{Name string, Id int} (as a struct value)."""
        name = ""
        field = -1
        while True:
            delta = r.read_uint()
            if delta == 0:
                return name
            field += delta
            if field == 0:
                name = r.read_bytes().decode("utf-8", "replace")
            elif field == 1:
                r.read_int()  # Id (redundant with the message's type id)
            else:
                raise GobError(f"unexpected CommonType field {field}")

    def _read_typedef(self, type_id: int, r: _Reader):
        field = -1
        wt = None
        while True:
            delta = r.read_uint()
            if delta == 0:
                break
            field += delta
            if field == _W_SLICE:
                # SliceType{CommonType, Elem typeId}
                elem = 0
                f2 = -1
                while True:
                    d2 = r.read_uint()
                    if d2 == 0:
                        break
                    f2 += d2
                    if f2 == 0:
                        self._read_common(r)
                    elif f2 == 1:
                        elem = r.read_int()
                    else:
                        raise GobError("unexpected SliceType field")
                wt = _SliceType(elem)
            elif field == _W_STRUCT:
                # StructType{CommonType, Field []fieldType}
                name = ""
                fields: List[Tuple[str, int]] = []
                f2 = -1
                while True:
                    d2 = r.read_uint()
                    if d2 == 0:
                        break
                    f2 += d2
                    if f2 == 0:
                        name = self._read_common(r)
                    elif f2 == 1:
                        for _ in range(r.read_uint()):
                            fname, fid, f3 = "", 0, -1
                            while True:
                                d3 = r.read_uint()
                                if d3 == 0:
                                    break
                                f3 += d3
                                if f3 == 0:
                                    fname = r.read_bytes().decode(
                                        "utf-8", "replace")
                                elif f3 == 1:
                                    fid = r.read_int()
                                else:
                                    raise GobError(
                                        "unexpected fieldType field")
                            fields.append((fname, fid))
                    else:
                        raise GobError("unexpected StructType field")
                wt = _StructType(name, fields)
            else:
                raise GobError(
                    f"unsupported wireType kind (field {field})")
        if wt is None:
            raise GobError("empty type definition")
        self.types[type_id] = wt

    # real streams nest ~3 deep ([]struct{...[]float64}); a crafted
    # self-referential typedef must hit GobError, not RecursionError
    MAX_DEPTH = 32

    def _read_value(self, type_id: int, r: _Reader, depth: int = 0):
        if depth > self.MAX_DEPTH:
            raise GobError("gob value nesting too deep")
        if type_id == BOOL:
            return bool(r.read_uint())
        if type_id == INT:
            return r.read_int()
        if type_id == UINT:
            return r.read_uint()
        if type_id == FLOAT:
            return r.read_float()
        if type_id in (BYTES, STRING):
            return r.read_bytes()
        wt = self.types.get(type_id)
        if wt is None:
            raise GobError(f"value of undefined type {type_id}")
        if isinstance(wt, _SliceType):
            return [self._read_value(wt.elem, r, depth + 1)
                    for _ in range(r.read_uint())]
        # struct: (delta, value) pairs, 0-terminated; omitted fields keep
        # their zero value
        out = {name: _zero(self, fid, depth + 1)
               for name, fid in wt.fields}
        field = -1
        while True:
            delta = r.read_uint()
            if delta == 0:
                return out
            field += delta
            if not 0 <= field < len(wt.fields):
                raise GobError(f"field {field} out of range for "
                               f"{wt.name}")
            name, fid = wt.fields[field]
            out[name] = self._read_value(fid, r, depth + 1)

    def next_value(self):
        """Read messages until the next VALUE (consuming type
        definitions); returns the decoded Python value."""
        while True:
            n = self.r.read_uint()
            end = self.r.pos + n
            if end > self.r.end:
                raise GobError("message length past end of stream")
            msg = _Reader(self.r.data, self.r.pos, end)
            self.r.pos = end
            type_id = msg.read_int()
            if type_id < 0:
                self._read_typedef(-type_id, msg)
                continue
            wt = self.types.get(type_id)
            if not isinstance(wt, _StructType):
                # non-struct top-level values carry one leading ZERO
                # delta byte (observed in the reference's golden fixture)
                if msg.read_uint() != 0:
                    raise GobError("expected singleton zero-delta byte")
            return self._read_value(type_id, msg)


def _zero(stream: GobStream, type_id: int, depth: int = 0):
    if depth > GobStream.MAX_DEPTH:
        raise GobError("gob type nesting too deep")
    if type_id == FLOAT:
        return 0.0
    if type_id in (INT, UINT):
        return 0
    if type_id == BOOL:
        return False
    if type_id in (BYTES, STRING):
        return b""
    wt = stream.types.get(type_id)
    if isinstance(wt, _SliceType):
        return []
    if isinstance(wt, _StructType):
        return {name: _zero(stream, fid, depth + 1)
                for name, fid in wt.fields}
    return None


def _enc_uint(v: int) -> bytes:
    if v < 128:
        return bytes([v])
    body = v.to_bytes((v.bit_length() + 7) // 8, "big")
    return bytes([256 - len(body)]) + body


def _enc_int(i: int) -> bytes:
    return _enc_uint((~i << 1) | 1 if i < 0 else i << 1)


def _enc_float(v: float) -> bytes:
    bits = struct.unpack("<Q", struct.pack("<d", v))[0]
    return _enc_uint(int.from_bytes(bits.to_bytes(8, "little"), "big"))


def _enc_msg(body: bytes) -> bytes:
    return _enc_uint(len(body)) + body


# The type-definition prologue MergingDigest.GobEncode's stream carries,
# byte-identical to the Go encoder's output (ids 68 = []Centroid,
# 66 = Centroid{Mean, Weight, Samples}, 67 = []float64, defined in that
# order; verified against the reference's fixtures/import.uncompressed).
_DIGEST_PROLOGUE = (
    _enc_msg(_enc_int(-68) + _enc_uint(2)
             + _enc_uint(1) + _enc_uint(2) + _enc_int(68) + _enc_uint(0)
             + _enc_uint(1) + _enc_int(66) + _enc_uint(0) + _enc_uint(0))
    + _enc_msg(_enc_int(-66) + _enc_uint(3)
               + _enc_uint(1) + _enc_uint(1) + _enc_uint(8) + b"Centroid"
               + _enc_uint(1) + _enc_int(66) + _enc_uint(0)
               + _enc_uint(1) + _enc_uint(3)
               + _enc_uint(1) + _enc_uint(4) + b"Mean"
               + _enc_uint(1) + _enc_int(FLOAT) + _enc_uint(0)
               + _enc_uint(1) + _enc_uint(6) + b"Weight"
               + _enc_uint(1) + _enc_int(FLOAT) + _enc_uint(0)
               + _enc_uint(1) + _enc_uint(7) + b"Samples"
               + _enc_uint(1) + _enc_int(67) + _enc_uint(0)
               + _enc_uint(0) + _enc_uint(0))
    + _enc_msg(_enc_int(-67) + _enc_uint(2)
               + _enc_uint(1) + _enc_uint(1) + _enc_uint(9) + b"[]float64"
               + _enc_uint(1) + _enc_int(67) + _enc_uint(0)
               + _enc_uint(1) + _enc_int(FLOAT) + _enc_uint(0)
               + _enc_uint(0)))


def encode_reference_digest(means, weights, compression: float,
                            dmin: float, dmax: float) -> bytes:
    """The inverse of ``decode_reference_digest``: produce the exact gob
    stream ``MergingDigest.GobDecode`` reads (merging_digest.go:396-426)
    — Encode([]Centroid), Encode(compression), Encode(min), Encode(max).
    Output is byte-identical to the Go encoder's for the same centroids
    (asserted against the reference's golden fixture in tests)."""
    cents = bytearray(_enc_uint(len(means)))
    for mean, weight in zip(means, weights):
        # gob omits zero-valued struct fields (field deltas skip them);
        # Samples stays empty (the reference's streams never populate it)
        mean, weight = float(mean), float(weight)
        delta = 1
        if mean != 0.0:
            cents += _enc_uint(1) + _enc_float(mean)
        else:
            delta = 2
        if weight != 0.0:
            cents += _enc_uint(delta) + _enc_float(weight)
        cents += _enc_uint(0)
    out = bytearray(_DIGEST_PROLOGUE)
    out += _enc_msg(_enc_int(68) + _enc_uint(0) + bytes(cents))
    for x in (compression, dmin, dmax):
        out += _enc_msg(_enc_int(FLOAT) + _enc_uint(0) + _enc_float(x))
    return bytes(out)


def decode_reference_digest(blob: bytes):
    """The reference's ``MergingDigest.GobEncode`` stream → (means,
    weights, compression, dmin, dmax) (merging_digest.go:375-394:
    Encode(mainCentroids), Encode(compression), Encode(min),
    Encode(max))."""
    s = GobStream(blob)
    centroids = s.next_value()
    compression = s.next_value()
    dmin = s.next_value()
    dmax = s.next_value()
    if not isinstance(centroids, list):
        raise GobError("first gob value is not a centroid slice")
    means = [c["Mean"] for c in centroids]
    weights = [c["Weight"] for c in centroids]
    return means, weights, float(compression), float(dmin), float(dmax)
