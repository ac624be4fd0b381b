"""ctypes bindings for the native (C++) DogStatsD and SSF ingest library.

Port of ``veneur_tpu/native/__init__.py``. ``veneur_ingest.cpp`` beside
this file is a byte-for-byte copy of the JAX package's source. At first
use the source builds with g++ into ``build/native/libveneur_ingest-<hash>.so``
at the repository root, the hash covering the source and the flags, so
an edited source never loads a stale build; nothing is written beside
the source. Exposes:

- ``parse_lines(data)``: parse a byte buffer of DogStatsD lines into a
  :class:`ParsedBatch` of numpy columns and an arena (one FFI call a
  buffer; the parse releases the GIL);
- :class:`InternTable`: the C++ (kind, name, tags) -> row memo table;
- :class:`NativeUDPReader`: the SO_REUSEPORT reader pool, N sockets
  drained with recvmmsg on C++ threads, handing Python parsed batches
  through double-buffer swaps;
- ``tls_available()`` and :class:`NativeTLSReader`: the TCP/TLS statsd
  listener, whose accept, handshake (the runtime's libssl, loaded with
  ``dlopen``), newline framing and parse run on C++ threads, handing
  parsed batches over through the same swap as the UDP pool;
- ``decode_spans(datagrams)`` and :class:`NativeSSFReader`: SSFSpan
  datagrams decoded in C++ (the reader pool's threads, off the GIL) into
  a :class:`SpanBatch`: span headers, the embedded samples as an
  ordinary :class:`ParsedBatch` for ``MetricStore.process_batch``, and
  the raw bytes of slow-lane samples (STATUS, undecodable). Spans reach
  the span sinks as :class:`LazySpan` facades, which decode the rest of
  a span with the port's own codec (``protocol/ssf.py``) on first touch.

``available()`` gates all of it: without a compiler the caller falls
back to the pure-Python parser, and says so.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

log = logging.getLogger("veneur.native")

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "veneur_ingest.cpp"
BUILD_DIR = _HERE.parents[1] / "build" / "native"
# the JAX package's build flags (veneur_tpu/native/__init__.py _build)
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

MISS = 0xFFFFFFFF  # vt_intern_assign's "unknown series" row sentinel

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None


class _VtBatch(ctypes.Structure):
    """Mirror of ``struct VtBatch`` (veneur_ingest.cpp), field for field."""

    _fields_ = [
        ("capacity", ctypes.c_uint32),
        ("arena_cap", ctypes.c_uint32),
        ("count", ctypes.c_uint32),
        ("arena_len", ctypes.c_uint32),
        ("parse_errors", ctypes.c_uint64),
        ("type", ctypes.POINTER(ctypes.c_uint8)),
        ("scope", ctypes.POINTER(ctypes.c_uint8)),
        ("value", ctypes.POINTER(ctypes.c_double)),
        ("sample_rate", ctypes.POINTER(ctypes.c_float)),
        ("digest", ctypes.POINTER(ctypes.c_uint32)),
        ("name_off", ctypes.POINTER(ctypes.c_uint32)),
        ("name_len", ctypes.POINTER(ctypes.c_uint32)),
        ("tags_off", ctypes.POINTER(ctypes.c_uint32)),
        ("tags_len", ctypes.POINTER(ctypes.c_uint32)),
        ("aux_off", ctypes.POINTER(ctypes.c_uint32)),
        ("aux_len", ctypes.POINTER(ctypes.c_uint32)),
        ("arena", ctypes.POINTER(ctypes.c_char)),
    ]


class _VsBatch(ctypes.Structure):
    """Mirror of ``struct VsBatch`` (veneur_ingest.cpp), field for field."""

    _fields_ = [
        ("capacity", ctypes.c_uint32),
        ("count", ctypes.c_uint32),
        ("arena_cap", ctypes.c_uint32),
        ("arena_len", ctypes.c_uint32),
        ("decode_errors", ctypes.c_uint64),
        ("invalid_samples", ctypes.c_uint64),
        ("version", ctypes.POINTER(ctypes.c_int32)),
        ("trace_id", ctypes.POINTER(ctypes.c_int64)),
        ("span_id", ctypes.POINTER(ctypes.c_int64)),
        ("parent_id", ctypes.POINTER(ctypes.c_int64)),
        ("start_ns", ctypes.POINTER(ctypes.c_int64)),
        ("end_ns", ctypes.POINTER(ctypes.c_int64)),
        ("error", ctypes.POINTER(ctypes.c_uint8)),
        ("indicator", ctypes.POINTER(ctypes.c_uint8)),
        ("service_off", ctypes.POINTER(ctypes.c_uint32)),
        ("service_len", ctypes.POINTER(ctypes.c_uint32)),
        ("name_off", ctypes.POINTER(ctypes.c_uint32)),
        ("name_len", ctypes.POINTER(ctypes.c_uint32)),
        ("raw_off", ctypes.POINTER(ctypes.c_uint32)),
        ("raw_len", ctypes.POINTER(ctypes.c_uint32)),
        ("arena", ctypes.POINTER(ctypes.c_char)),
        ("metrics", ctypes.POINTER(_VtBatch)),
        ("slow_cap", ctypes.c_uint32),
        ("slow_count", ctypes.c_uint32),
        ("slow_off", ctypes.POINTER(ctypes.c_uint32)),
        ("slow_len", ctypes.POINTER(ctypes.c_uint32)),
    ]


def _library_path(source: Path, flags, stem: str) -> Path:
    """``build/native/<stem>-<hash>.so``, the hash covering the source and
    the compile flags."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{stem}-{digest[:16]}.so"


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    return _library_path(SOURCE, GXX_FLAGS, "libveneur_ingest")


def compile_library(source: Path, flags, libs, out: Path) -> Path:
    """Compile ``source`` with g++ into ``out`` unless it is built
    already; returns ``out``. Raises RuntimeError with the compiler's
    output on failure. Concurrent builds each compile into a temporary
    file and rename it into place, so a reader never sees half a
    library."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *flags, "-o", tmp, str(source), *libs],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    except FileNotFoundError:
        raise RuntimeError("g++ not found") from None
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"native build of {source.name} timed out") \
            from None
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"native build of {source.name} failed: "
                           + e.stderr.decode(errors="replace")) from None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build() -> Path:
    """Compile the ingest library unless this source is built already;
    returns its path (see :func:`compile_library`)."""
    return compile_library(SOURCE, GXX_FLAGS, ("-ldl",), library_path())


def _load():
    """The bound library, built first if needed; None (and a logged
    warning, once) when it cannot be built or loaded."""
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            _lib = _bind(ctypes.CDLL(str(build())))
        except (RuntimeError, OSError) as e:
            _build_error = str(e)
            log.warning("native ingest unavailable, the Python parser "
                        "takes its place: %s", e)
        return _lib


def _bind(lib):
    lib.vt_batch_new.restype = ctypes.POINTER(_VtBatch)
    lib.vt_batch_new.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
    lib.vt_batch_free.argtypes = [ctypes.POINTER(_VtBatch)]
    lib.vt_batch_reset.argtypes = [ctypes.POINTER(_VtBatch)]
    lib.vt_parse_lines.restype = ctypes.c_uint32
    lib.vt_parse_lines.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.POINTER(_VtBatch)]
    lib.vt_reader_start.restype = ctypes.c_void_p
    lib.vt_reader_start.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int]
    lib.vt_reader_port.restype = ctypes.c_int
    lib.vt_reader_port.argtypes = [ctypes.c_void_p]
    lib.vt_reader_count.restype = ctypes.c_int
    lib.vt_reader_count.argtypes = [ctypes.c_void_p]
    lib.vt_reader_swap.restype = ctypes.POINTER(_VtBatch)
    lib.vt_reader_swap.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.vt_reader_drops.restype = ctypes.c_uint64
    lib.vt_reader_drops.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.vt_reader_stop.argtypes = [ctypes.c_void_p]
    lib.vt_intern_new.restype = ctypes.c_void_p
    lib.vt_intern_free.argtypes = [ctypes.c_void_p]
    lib.vt_intern_reset.argtypes = [ctypes.c_void_p]
    lib.vt_intern_put.argtypes = [
        ctypes.c_void_p, ctypes.c_uint8, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32]
    lib.vt_intern_assign.restype = ctypes.c_uint32
    lib.vt_intern_assign.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_VtBatch),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint32)]
    lib.vs_batch_new.restype = ctypes.POINTER(_VsBatch)
    lib.vs_batch_new.argtypes = [ctypes.c_uint32, ctypes.c_uint32,
                                 ctypes.c_uint32, ctypes.c_uint32]
    lib.vs_batch_free.argtypes = [ctypes.POINTER(_VsBatch)]
    lib.vs_decode_span.restype = ctypes.c_int
    lib.vs_decode_span.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_VsBatch),
        ctypes.c_char_p, ctypes.c_uint32]
    lib.vs_reader_start.restype = ctypes.c_void_p
    lib.vs_reader_start.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_int, ctypes.c_char_p]
    lib.vs_reader_port.restype = ctypes.c_int
    lib.vs_reader_port.argtypes = [ctypes.c_void_p]
    lib.vs_reader_count.restype = ctypes.c_int
    lib.vs_reader_count.argtypes = [ctypes.c_void_p]
    lib.vs_reader_swap.restype = ctypes.POINTER(_VsBatch)
    lib.vs_reader_swap.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.vs_reader_packets.restype = ctypes.c_uint64
    lib.vs_reader_packets.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.vs_reader_drops.restype = ctypes.c_uint64
    lib.vs_reader_drops.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.vs_reader_stop.argtypes = [ctypes.c_void_p]
    lib.vt_tls_available.restype = ctypes.c_int
    lib.vt_tls_available.argtypes = []
    lib.vt_tls_server_start.restype = ctypes.c_void_p
    lib.vt_tls_server_start.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int]
    lib.vt_tls_server_port.restype = ctypes.c_int
    lib.vt_tls_server_port.argtypes = [ctypes.c_void_p]
    lib.vt_tls_server_swap.restype = ctypes.POINTER(_VtBatch)
    lib.vt_tls_server_swap.argtypes = [ctypes.c_void_p]
    for fn in ("conns", "handshake_failures", "drops"):
        getattr(lib, f"vt_tls_server_{fn}").restype = ctypes.c_uint64
        getattr(lib, f"vt_tls_server_{fn}").argtypes = [ctypes.c_void_p]
    lib.vt_tls_server_stop.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native ingest unavailable: {_build_error}")
    return lib


class ParsedBatch:
    """numpy columns over a VtBatch. The arrays are COPIES (safe after
    the batch is reused); the arena is one bytes object."""

    __slots__ = ("count", "parse_errors", "type", "scope", "value",
                 "sample_rate", "digest", "name_off", "name_len",
                 "tags_off", "tags_len", "aux_off", "aux_len", "arena")

    def __init__(self, b: _VtBatch):
        n = b.count
        self.count = n
        self.parse_errors = b.parse_errors

        def arr(ptr, dtype):
            if n == 0:
                return np.empty(0, dtype)
            return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype,
                                                                 copy=True)

        self.type = arr(b.type, np.uint8)
        self.scope = arr(b.scope, np.uint8)
        self.value = arr(b.value, np.float64)
        self.sample_rate = arr(b.sample_rate, np.float32)
        self.digest = arr(b.digest, np.uint32)
        self.name_off = arr(b.name_off, np.uint32)
        self.name_len = arr(b.name_len, np.uint32)
        self.tags_off = arr(b.tags_off, np.uint32)
        self.tags_len = arr(b.tags_len, np.uint32)
        self.aux_off = arr(b.aux_off, np.uint32)
        self.aux_len = arr(b.aux_len, np.uint32)
        self.arena = ctypes.string_at(b.arena, b.arena_len)

    def member_hashes(self) -> np.ndarray:
        """uint64 set-member hashes carried in the value slot's bit
        pattern (meaningful for set records only)."""
        return self.value.view(np.uint64)

    def raw_view(self) -> _VtBatch:
        """A VtBatch borrowing this batch's arrays and arena, for C calls
        that re-read the batch (vt_intern_assign); keep the ParsedBatch
        alive across the call."""
        b = _VtBatch()
        b.count = self.count
        b.arena_len = len(self.arena)
        u8, u32 = ctypes.c_uint8, ctypes.c_uint32
        b.type = self.type.ctypes.data_as(ctypes.POINTER(u8))
        b.scope = self.scope.ctypes.data_as(ctypes.POINTER(u8))
        b.name_off = self.name_off.ctypes.data_as(ctypes.POINTER(u32))
        b.name_len = self.name_len.ctypes.data_as(ctypes.POINTER(u32))
        b.tags_off = self.tags_off.ctypes.data_as(ctypes.POINTER(u32))
        b.tags_len = self.tags_len.ctypes.data_as(ctypes.POINTER(u32))
        b.arena = ctypes.cast(ctypes.c_char_p(self.arena),
                              ctypes.POINTER(ctypes.c_char))
        return b


def parse_lines(data: bytes, max_records: int = 0,
                arena_cap: int = 0) -> ParsedBatch:
    """Parse a buffer of newline-separated DogStatsD lines natively."""
    lib = _require()
    max_records = max_records or max(16, data.count(b"\n") + 1)
    arena_cap = arena_cap or (len(data) + 64)
    b = lib.vt_batch_new(max_records, arena_cap)
    try:
        lib.vt_parse_lines(data, len(data), b)
        return ParsedBatch(b.contents)
    finally:
        lib.vt_batch_free(b)


class InternTable:
    """The C++ series table: (kind, name, tags) -> row. It only memoizes
    rows the caller assigned; unknown keys come back as MISS for the
    caller to resolve and teach back with put()."""

    def __init__(self):
        self._lib = _require()
        self._handle = self._lib.vt_intern_new()

    def assign(self, batch: ParsedBatch):
        """Returns (rows uint32[count], kinds uint8[count],
        miss_indices uint32[nmiss]); misses hold MISS in rows."""
        count = batch.count
        rows = np.empty(count, np.uint32)
        kinds = np.empty(count, np.uint8)
        miss = np.empty(count, np.uint32)
        view = batch.raw_view()
        nmiss = self._lib.vt_intern_assign(
            self._handle, ctypes.byref(view),
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            kinds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            miss.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        return rows, kinds, miss[:nmiss]

    def put(self, kind: int, name: bytes, tags: bytes, row: int):
        self._lib.vt_intern_put(self._handle, kind, name, len(name),
                                tags, len(tags), row)

    def reset(self):
        self._lib.vt_intern_reset(self._handle)

    def close(self):
        if self._handle:
            self._lib.vt_intern_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeUDPReader:
    """The C++ SO_REUSEPORT reader pool (networking.go:37-87 rebuilt
    native). ``drain()`` swaps every reader's batch and returns the
    non-empty ones."""

    # each reader's double-buffered batch: records and arena bytes
    BATCH_RECORDS = 262144
    BATCH_ARENA = 32 * 1024 * 1024

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 num_readers: int = 1, rcvbuf: int = 2 * 1024 * 1024,
                 dgram_max: int = 8192):
        lib = _require()
        self._lib = lib
        self._handle = lib.vt_reader_start(
            host.encode(), port, num_readers, rcvbuf, self.BATCH_RECORDS,
            self.BATCH_ARENA, dgram_max)
        if not self._handle:
            raise OSError(f"could not bind native UDP readers on "
                          f"{host}:{port}")
        self.port = lib.vt_reader_port(self._handle)
        self.num_readers = lib.vt_reader_count(self._handle)

    def drain(self) -> List[ParsedBatch]:
        out = []
        for i in range(self.num_readers):
            b = self._lib.vt_reader_swap(self._handle, i)
            if b.contents.count or b.contents.parse_errors:
                out.append(ParsedBatch(b.contents))
        return out

    def drops(self) -> int:
        return sum(self._lib.vt_reader_drops(self._handle, i)
                   for i in range(self.num_readers))

    def stop(self) -> None:
        if self._handle:
            self._lib.vt_reader_stop(self._handle)
            self._handle = None

    def leak(self) -> None:
        """Abandon the pool WITHOUT freeing it (disarms stop() and the
        finalizer): for a shutdown where a pump thread may still read its
        batches, a bounded leak at exit beats a use-after-free."""
        self._handle = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


def tls_available() -> bool:
    """True when the library loaded and found the runtime's libssl
    (``libssl.so.3`` or ``.so.1.1``, loaded with ``dlopen``: no OpenSSL
    headers at build time)."""
    lib = _load()
    return bool(lib is not None and lib.vt_tls_available())


class NativeTLSReader:
    """The C++ TCP/TLS statsd listener (one IPv4 address): accept, the
    handshake, newline framing and the DogStatsD parse run off the GIL,
    on a thread a connection; ``drain()`` swaps its parsed batch as
    :class:`NativeUDPReader` does. An empty ``cert_path`` serves plain
    TCP; ``ca_path`` requires a client certificate signed by it (as
    ``networking.make_server_tls_context`` does). A line longer than
    ``max_line`` closes its connection; a handshake that fails or takes
    over 10 s counts in :meth:`handshake_failures`."""

    BATCH_RECORDS = NativeUDPReader.BATCH_RECORDS
    BATCH_ARENA = NativeUDPReader.BATCH_ARENA

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 cert_path: str = "", key_path: str = "",
                 ca_path: str = "", max_line: int = 4096):
        lib = _require()
        if cert_path and not lib.vt_tls_available():
            raise RuntimeError("the runtime's libssl did not load")
        self._lib = lib
        self._handle = lib.vt_tls_server_start(
            host.encode(), port, cert_path.encode(), key_path.encode(),
            ca_path.encode(), self.BATCH_RECORDS, self.BATCH_ARENA,
            max_line)
        if not self._handle:
            raise OSError(f"could not start the native TCP/TLS listener "
                          f"on {host}:{port}")
        self.port = lib.vt_tls_server_port(self._handle)
        self.num_readers = 1

    def drain(self) -> List[ParsedBatch]:
        b = self._lib.vt_tls_server_swap(self._handle)
        if b.contents.count or b.contents.parse_errors:
            return [ParsedBatch(b.contents)]
        return []

    def conns(self) -> int:
        """Connections accepted, ever."""
        return self._lib.vt_tls_server_conns(self._handle)

    def handshake_failures(self) -> int:
        return self._lib.vt_tls_server_handshake_failures(self._handle)

    def drops(self) -> int:
        """Reads whose lines found the batch full and were dropped."""
        return self._lib.vt_tls_server_drops(self._handle)

    def stop(self) -> None:
        if self._handle:
            self._lib.vt_tls_server_stop(self._handle)
            self._handle = None

    def leak(self) -> None:
        """See :meth:`NativeUDPReader.leak`."""
        self._handle = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class LazySpan:
    """A decoded SSF span: the hot header fields preloaded from the C++
    span batch; the rest (tags, embedded metrics, version) decoded from
    the raw bytes on first touch with the port's codec, so span sinks
    that never read them never pay a Python decode.
    ``metrics_extracted`` tells the metric-extraction sink that the C++
    lane converted the embedded samples already."""

    __slots__ = ("trace_id", "id", "parent_id", "start_timestamp",
                 "end_timestamp", "error", "indicator", "service",
                 "name", "metrics_extracted", "_raw", "_pb")

    def __init__(self, trace_id, id, parent_id, start_timestamp,
                 end_timestamp, error, indicator, service, name, raw):
        self.trace_id = trace_id
        self.id = id
        self.parent_id = parent_id
        self.start_timestamp = start_timestamp
        self.end_timestamp = end_timestamp
        self.error = error
        self.indicator = indicator
        self.service = service
        self.name = name
        self.metrics_extracted = True
        self._raw = raw
        self._pb = None

    @property
    def pb(self):
        """The whole span, decoded (``protocol.ssf.SSFSpan``)."""
        if self._pb is None:
            from veneur_tpu_torch.protocol import ssf

            self._pb = ssf.decode_span(self._raw)
        return self._pb

    def SerializeToString(self):  # noqa: N802 - protobuf's name
        return self._raw

    def __getattr__(self, item):
        # only names outside __slots__ get here: the cold fields
        if item.startswith("_"):
            raise AttributeError(item)
        return getattr(self.pb, item)


class SpanBatch:
    """numpy/bytes copies of a VsBatch (safe after the C++ batch is
    reused): span headers, the embedded samples as a ParsedBatch (ready
    for MetricStore.process_batch), and the raw bytes of slow-lane
    samples (STATUS, undecodable) for the Python parser."""

    __slots__ = ("count", "decode_errors", "invalid_samples",
                 "metrics", "slow_samples", "trace_id", "span_id",
                 "parent_id", "start_ns", "end_ns", "error", "indicator",
                 "service_off", "service_len", "name_off", "name_len",
                 "raw_off", "raw_len", "arena")

    def __init__(self, b: _VsBatch):
        n = b.count
        self.count = n
        self.decode_errors = b.decode_errors
        self.invalid_samples = b.invalid_samples

        def arr(ptr, dtype):
            if n == 0:
                return np.empty(0, dtype)
            return np.ctypeslib.as_array(ptr, shape=(n,)).astype(
                dtype, copy=True)

        self.trace_id = arr(b.trace_id, np.int64)
        self.span_id = arr(b.span_id, np.int64)
        self.parent_id = arr(b.parent_id, np.int64)
        self.start_ns = arr(b.start_ns, np.int64)
        self.end_ns = arr(b.end_ns, np.int64)
        self.error = arr(b.error, np.uint8)
        self.indicator = arr(b.indicator, np.uint8)
        self.service_off = arr(b.service_off, np.uint32)
        self.service_len = arr(b.service_len, np.uint32)
        self.name_off = arr(b.name_off, np.uint32)
        self.name_len = arr(b.name_len, np.uint32)
        self.raw_off = arr(b.raw_off, np.uint32)
        self.raw_len = arr(b.raw_len, np.uint32)
        self.arena = ctypes.string_at(b.arena, b.arena_len)
        self.metrics = ParsedBatch(b.metrics.contents)
        self.slow_samples = [
            self.arena[b.slow_off[i]:b.slow_off[i] + b.slow_len[i]]
            for i in range(b.slow_count)]

    def span(self, i: int) -> LazySpan:
        ro, rl = self.raw_off[i], self.raw_len[i]
        so, sl = self.service_off[i], self.service_len[i]
        no, nl = self.name_off[i], self.name_len[i]
        return LazySpan(
            int(self.trace_id[i]), int(self.span_id[i]),
            int(self.parent_id[i]), int(self.start_ns[i]),
            int(self.end_ns[i]), bool(self.error[i]),
            bool(self.indicator[i]),
            self.arena[so:so + sl].decode("utf-8", "replace"),
            self.arena[no:no + nl].decode("utf-8", "replace"),
            self.arena[ro:ro + rl])

    def spans(self) -> List[LazySpan]:
        return [self.span(i) for i in range(self.count)]


def decode_spans(datagrams: List[bytes],
                 indicator_timer_name: str = "") -> SpanBatch:
    """Batch-decode bare SSFSpan datagrams natively (tests and direct
    calls; the server uses NativeSSFReader)."""
    lib = _require()
    total = sum(len(d) for d in datagrams)
    ind = indicator_timer_name.encode()
    b = lib.vs_batch_new(max(len(datagrams), 16), total + 64,
                         max(32, len(datagrams) * 9), total * 2 + 1024)
    try:
        for d in datagrams:
            lib.vs_decode_span(d, len(d), b, ind, len(ind))
        return SpanBatch(b.contents)
    finally:
        lib.vs_batch_free(b)


class NativeSSFReader:
    """The C++ SSF reader pool: SO_REUSEPORT sockets drained with
    recvmmsg, one SSFSpan decoded a datagram on the C++ threads (off the
    GIL), its embedded samples converted to parsed records in line.
    ``drain()`` swaps every reader's batch.

    Sizing: a reader takes a datagram only while its batch has room for
    the span, its bytes and 8 more records (the C++ precheck). A span
    with more than 8 samples can still fill the record column mid-span:
    the samples past it go to the slow lane, but an indicator timer past
    it is skipped uncounted (inherited from the C++). ``metric_cap``
    therefore defaults to RECORDS_PER_SPAN records a span of
    ``span_cap``, so a batch never fills its record column before its
    span column while spans carry at most RECORDS_PER_SPAN - 1 samples."""

    RECORDS_PER_SPAN = 32

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 num_readers: int = 1, rcvbuf: int = 2 * 1024 * 1024,
                 span_cap: int = 16384, arena_cap: int = 32 * 1024 * 1024,
                 metric_cap: int = 0, metric_arena: int = 64 * 1024 * 1024,
                 dgram_max: int = 8192, indicator_timer_name: str = ""):
        lib = _require()
        self._lib = lib
        metric_cap = metric_cap or span_cap * self.RECORDS_PER_SPAN
        self._handle = lib.vs_reader_start(
            host.encode(), port, num_readers, rcvbuf, span_cap,
            arena_cap, metric_cap, metric_arena, dgram_max,
            indicator_timer_name.encode())
        if not self._handle:
            raise OSError(f"could not bind native SSF readers on "
                          f"{host}:{port}")
        self.port = lib.vs_reader_port(self._handle)
        self.num_readers = lib.vs_reader_count(self._handle)

    def drain(self) -> List[SpanBatch]:
        out = []
        for i in range(self.num_readers):
            b = self._lib.vs_reader_swap(self._handle, i)
            if b.contents.count or b.contents.decode_errors:
                out.append(SpanBatch(b.contents))
        return out

    def packets(self) -> int:
        return sum(self._lib.vs_reader_packets(self._handle, i)
                   for i in range(self.num_readers))

    def drops(self) -> int:
        """Datagrams shed because a batch was full (the pump fell
        behind)."""
        return sum(self._lib.vs_reader_drops(self._handle, i)
                   for i in range(self.num_readers))

    def stop(self) -> None:
        if self._handle:
            self._lib.vs_reader_stop(self._handle)
            self._handle = None

    def leak(self) -> None:
        """See NativeUDPReader.leak."""
        self._handle = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass
