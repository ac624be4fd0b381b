"""ctypes bindings for the C++ egress library (``veneur_egress.cpp``).

Port of the sink half of ``veneur_tpu/native/egress.py``.
``veneur_egress.cpp`` beside this file is a byte-for-byte copy of the
JAX package's source; at first use it builds with g++ into
``build/native/libveneur_egress-<hash>.so`` at the repository root (the
hash covering the source and the flags, as for the ingest library). Its
MetricList codec (``vt_mlist_*``, ``vt_mintern_*``) compiles into the
library but is not bound here yet. Exposes:

- ``dd_series_bodies``: one columnar emission block -> Datadog
  ``/api/v1/series`` JSON bodies, deflated in C++ (the vectorized
  finalize and serialize of ``sinks/datadog/datadog.go:245-330``);
- ``tsv_rows``: one block -> the archival TSV rows of the local-file
  plugin (``plugins/csv_encode.py`` column order).

Unlike the JAX package, nothing falls back quietly: when the library
cannot be built or loaded, :func:`load` and every serializer raise
``RuntimeError`` (``available()`` says False). A flush with
``flush_columnar: true`` therefore fails loudly; per-row emission is
``flush_columnar: false``.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from veneur_tpu_torch import native

log = logging.getLogger("veneur.native.egress")

SOURCE = Path(__file__).resolve().parent / "veneur_egress.cpp"
# the JAX package's build flags (veneur_tpu/native/egress.py _build),
# linked with -lz
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

Arenas = Tuple[bytes, np.ndarray, np.ndarray]

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None


class _VtBodies(ctypes.Structure):
    # ptr as void*: c_char_p would convert to bytes truncated at the
    # first NUL, and deflated bodies contain NULs
    _fields_ = [
        ("count", ctypes.c_uint32),
        ("ptr", ctypes.POINTER(ctypes.c_void_p)),
        ("len", ctypes.POINTER(ctypes.c_uint64)),
        ("impl", ctypes.c_void_p),
    ]


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    return native._library_path(SOURCE, GXX_FLAGS, "libveneur_egress")


def build() -> Path:
    """Compile the egress library unless this source is built already;
    returns its path. Raises RuntimeError with the compiler's output."""
    return native.compile_library(SOURCE, GXX_FLAGS, ("-lz",),
                                  library_path())


def _bind(lib):
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.vt_dd_series_json.restype = ctypes.POINTER(_VtBodies)
    lib.vt_dd_series_json.argtypes = [
        ctypes.c_char_p, u32p, u32p,            # names
        ctypes.c_char_p, u32p, u32p,            # tags
        ctypes.c_uint32,                        # nrows
        ctypes.c_char_p, u32p, u32p, ctypes.c_uint32,  # suffixes
        u32p, u8p, f64p, u8p, ctypes.c_uint64,  # emissions
        ctypes.c_int64, ctypes.c_int32,         # timestamp, interval
        ctypes.c_char_p, ctypes.c_char_p,       # host, common tags json
        ctypes.c_uint32, ctypes.c_int,          # max_per_body, level
    ]
    lib.vt_bodies_free.argtypes = [ctypes.POINTER(_VtBodies)]
    lib.vt_tsv_rows.restype = ctypes.POINTER(_VtBodies)
    lib.vt_tsv_rows.argtypes = [
        ctypes.c_char_p, u32p, u32p,            # names
        ctypes.c_char_p, u32p, u32p,            # tags
        ctypes.c_uint32,                        # nrows
        ctypes.c_char_p, u32p, u32p, ctypes.c_uint32,  # suffixes
        u32p, u8p, f64p, u8p, ctypes.c_uint64,  # emissions
        ctypes.c_char_p, ctypes.c_char_p,       # hostname, interval str
        ctypes.c_char_p, ctypes.c_char_p,       # timestamp, partition
    ]
    return lib


def _load():
    """The bound library, built first if needed; None (and a logged
    error, once) when it cannot be built or loaded."""
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            _lib = _bind(ctypes.CDLL(str(build())))
        except (RuntimeError, OSError) as e:
            _build_error = str(e)
            log.error("native egress unavailable: %s", e)
        return _lib


def load():
    """The bound library; raises RuntimeError when it cannot be built or
    loaded (there is no per-row fallback behind a columnar flush)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native egress unavailable: {_build_error}")
    return lib


def available() -> bool:
    return _load() is not None


def _take_bodies(lib, bp) -> List[bytes]:
    try:
        b = bp.contents
        return [ctypes.string_at(b.ptr[i], b.len[i])
                for i in range(b.count)]
    finally:
        lib.vt_bodies_free(bp)


def _u32a(a: np.ndarray) -> np.ndarray:
    """Contiguous u32 copy the CALLER must keep referenced across the C
    call (data_as on a temporary would dangle)."""
    return np.ascontiguousarray(a, np.uint32)


def _p(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _key_list(keys: List[bytes]):
    """(blob, off-array, len-array) of a small key set."""
    blob = b"".join(keys)
    n = max(len(keys), 1)
    offs = np.zeros(n, np.uint32)
    lens = np.zeros(n, np.uint32)
    pos = 0
    for i, k in enumerate(keys):
        offs[i] = pos
        lens[i] = len(k)
        pos += len(k)
    return blob, offs, lens


def _block_args(names: Arenas, tags: Arenas, suffixes: List[bytes],
                em_rows, em_suffix, em_values, em_type) -> tuple:
    """(args, keep): the leading arguments both serializers share, and
    the contiguous arrays they point into, which the caller keeps
    referenced across the call."""
    if len(suffixes) > 255:
        raise ValueError("more than 255 emission suffixes")
    suffix_blob, s_off, s_len = _key_list(suffixes)
    em_rows = _u32a(em_rows)
    em_suffix = np.ascontiguousarray(em_suffix, np.uint8)
    em_values = np.ascontiguousarray(em_values, np.float64)
    em_type = np.ascontiguousarray(em_type, np.uint8)
    n = len(em_rows)
    assert len(em_suffix) == n and len(em_values) == n and len(em_type) == n
    name_arena, name_off, name_len = names
    tags_arena, tags_off, tags_len = tags
    name_off, name_len = _u32a(name_off), _u32a(name_len)
    tags_off, tags_len = _u32a(tags_off), _u32a(tags_len)
    u32, u8, f64 = ctypes.c_uint32, ctypes.c_uint8, ctypes.c_double
    keep = [name_off, name_len, tags_off, tags_len, s_off, s_len, em_rows,
            em_suffix, em_values, em_type]
    args = [name_arena, _p(name_off, u32), _p(name_len, u32),
            tags_arena, _p(tags_off, u32), _p(tags_len, u32),
            len(name_off),
            suffix_blob, _p(s_off, u32), _p(s_len, u32), len(suffixes),
            _p(em_rows, u32), _p(em_suffix, u8), _p(em_values, f64),
            _p(em_type, u8), n]
    return args, keep


def dd_series_bodies(names: Arenas, tags: Arenas, suffixes: List[bytes],
                     em_rows: np.ndarray, em_suffix: np.ndarray,
                     em_values: np.ndarray, em_type: np.ndarray,
                     timestamp: int, interval: int, default_host: str,
                     common_tags_json: bytes = b"",
                     max_per_body: int = 0,
                     compress_level: int = 1) -> List[bytes]:
    """Serialize one columnar emission block into chunked
    ``{"series": [...]}`` bodies, deflated unless ``compress_level`` is 0.

    names/tags: (arena bytes, offsets u32[S], lengths u32[S]).
    emissions: parallel arrays: row index u32, suffix index u8 (into
    ``suffixes``), finalized value f64 (counters already divided by the
    interval), type code u8 (0 gauge, 1 rate)."""
    lib = load()
    args, keep = _block_args(names, tags, suffixes, em_rows, em_suffix,
                             em_values, em_type)
    bp = lib.vt_dd_series_json(
        *args, timestamp, interval, default_host.encode("utf-8"),
        common_tags_json, max_per_body, compress_level)
    del keep
    return _take_bodies(lib, bp)


def tsv_rows(names: Arenas, tags: Arenas, suffixes: List[bytes],
             em_rows: np.ndarray, em_suffix: np.ndarray,
             em_values: np.ndarray, em_type: np.ndarray,
             hostname: str, interval: int, timestamp_str: str,
             partition_str: str) -> bytes:
    """Serialize one columnar emission block into the archival TSV rows
    of the local-file plugin (plugins/csv_encode.py column order;
    reference csv.go:17-92). Counter values must arrive already divided
    by the interval (em_type picks the rate/gauge column only)."""
    lib = load()
    args, keep = _block_args(names, tags, suffixes, em_rows, em_suffix,
                             em_values, em_type)
    bp = lib.vt_tsv_rows(
        *args, hostname.encode("utf-8"), str(int(interval)).encode(),
        timestamp_str.encode(), partition_str.encode())
    del keep
    (body,) = _take_bodies(lib, bp)
    return body
