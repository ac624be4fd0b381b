"""ctypes bindings for the native (C++) DogStatsD ingest library.

Port of the statsd half of ``veneur_tpu/native/__init__.py``.
``veneur_ingest.cpp`` beside this file is a byte-for-byte copy of the
JAX package's source; its SSF (``vs_*``) and TLS (``vt_tls_*``) halves
compile into the library but are not bound here yet. At first use the
source builds with g++ into ``build/native/libveneur_ingest-<hash>.so``
at the repository root, the hash covering the source and the flags, so
an edited source never loads a stale build; nothing is written beside
the source. Exposes:

- ``parse_lines(data)``: parse a byte buffer of DogStatsD lines into a
  :class:`ParsedBatch` of numpy columns and an arena (one FFI call a
  buffer; the parse releases the GIL);
- :class:`InternTable`: the C++ (kind, name, tags) -> row memo table;
- :class:`NativeUDPReader`: the SO_REUSEPORT reader pool, N sockets
  drained with recvmmsg on C++ threads, handing Python parsed batches
  through double-buffer swaps.

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


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libveneur_ingest-{digest[:16]}.so"


def build() -> Path:
    """Compile the library unless this source is built already; returns
    its path. Raises RuntimeError with the compiler's output on failure.
    Concurrent builds each compile into a temporary file and rename it
    into place, so a reader never sees half a library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE), "-ldl"],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    except FileNotFoundError:
        raise RuntimeError("g++ not found") from None
    except subprocess.TimeoutExpired:
        raise RuntimeError("native build timed out") from None
    except subprocess.CalledProcessError as e:
        raise RuntimeError("native build failed: "
                           + e.stderr.decode(errors="replace")) from None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


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
