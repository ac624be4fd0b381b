"""Framed-SSF stream codec (port of ``veneur_tpu/protocol/wire.py``).

The SSF wire protocol (cf. veneur/protocol/wire.go:1-53) frames a
protobuf-encoded ``ssf.SSFSpan`` as::

    [ 8 bits  version/type, currently always 0 ]
    [ 32 bits big-endian content length        ]
    [ <length> octets of SSFSpan protobuf      ]

The protocol carries no resync hints, so any framing error poisons the
stream: callers must stop reading and close the connection
(``FramingError.poisons_stream``). Spans decode with the port's own
codec (``protocol/ssf.py``), never protobuf.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Optional

from veneur_tpu_torch.protocol import ssf

MAX_FRAME_LENGTH = 16 * 1024 * 1024  # MaxSSFPacketLength (wire.go:43)
# 1 byte version + 4 bytes big-endian length (wire.go:46-48)
FRAME_HEADER = struct.Struct(">BI")
VERSION_0 = 0


class FramingError(Exception):
    """A wire-protocol framing error: the stream is poisoned and must be
    closed (wire.go:26-28, errors.go:31-41)."""

    poisons_stream = True


class FrameVersionError(FramingError):
    def __init__(self, version: int):
        super().__init__(f"SSF framing error: unexpected version number "
                         f"{version}")
        self.version = version


class FrameLengthError(FramingError):
    def __init__(self, length: int):
        super().__init__(f"SSF framing error: length {length} is too large")
        self.length = length


class FramingIOError(FramingError):
    pass


def parse_ssf(packet: bytes) -> ssf.SSFSpan:
    """Decode and normalize one SSFSpan (wire.go:138-174): a span with an
    empty name adopts (and removes) its "name" tag; embedded metrics with
    sample_rate 0 get sample_rate 1. Raises ``ssf.DecodeError`` on a bad
    payload."""
    span = ssf.decode_span(packet)
    if not span.name and "name" in span.tags:
        span.name = span.tags.pop("name")
    for sample in span.metrics:
        if sample.sample_rate == 0:
            sample.sample_rate = 1.0
    return span


def valid_trace(span) -> bool:
    """A span is a valid trace span iff id, trace id and both timestamps
    are set (wire.go:80-87)."""
    return bool(span.id and span.trace_id and span.start_timestamp
                and span.end_timestamp)


def _read_exact(stream: BinaryIO, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = stream.read(n - len(buf))
        if not chunk:
            raise FramingIOError(f"EOF after {len(buf)}/{n} frame octets")
        buf.extend(chunk)
    return bytes(buf)


def read_ssf(stream: BinaryIO) -> Optional[ssf.SSFSpan]:
    """Read one framed span from a blocking stream (wire.go:109-135).

    Returns None on clean EOF at a frame boundary; raises FramingError
    subclasses when the stream is poisoned, and ``ssf.DecodeError`` when
    a whole frame was read but its body does not decode (the stream is
    then still at a frame boundary)."""
    first = stream.read(1)
    if first == b"":
        return None  # clean hang-up between messages
    version = first[0]
    if version != VERSION_0:
        raise FrameVersionError(version)
    length = struct.unpack(">I", _read_exact(stream, 4))[0]
    if length > MAX_FRAME_LENGTH:
        raise FrameLengthError(length)
    return parse_ssf(_read_exact(stream, length))


def frame_bytes(span) -> bytes:
    """The complete frame of a span (for datagram and stream sends)."""
    body = span.SerializeToString()
    if len(body) > MAX_FRAME_LENGTH:
        raise FrameLengthError(len(body))
    return FRAME_HEADER.pack(VERSION_0, len(body)) + body


def write_ssf(stream: BinaryIO, span) -> int:
    """Frame and write one span; returns the number of body bytes written
    (wire.go:187-219)."""
    frame = frame_bytes(span)
    try:
        stream.write(frame)
    except OSError as e:
        raise FramingIOError(str(e)) from e
    return len(frame) - FRAME_HEADER.size
