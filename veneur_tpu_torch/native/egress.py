"""ctypes bindings for the C++ egress library (``veneur_egress.cpp``).

Port of the sink half of ``veneur_tpu/native/egress.py``.
``veneur_egress.cpp`` beside this file is a byte-for-byte copy of the
JAX package's source; at first use it builds with g++ into
``build/native/libveneur_egress-<hash>.so`` at the repository root (the
hash covering the source and the flags, as for the ingest library).
Exposes:

- ``dd_series_bodies``: one columnar emission block -> Datadog
  ``/api/v1/series`` JSON bodies, deflated in C++ (the vectorized
  finalize and serialize of ``sinks/datadog/datadog.go:245-330``);
- ``sfx_datapoint_bodies``: one block -> a SignalFx ``/v2/datapoint``
  JSON body, uncompressed (the vectorized ``SignalFxSink._dimensions``
  and serialize of ``sinks/signalfx/signalfx.go:150-225``);
- ``tsv_rows``: one block -> the archival TSV rows of the local-file
  plugin (``plugins/csv_encode.py`` column order);
- ``decode_metric_list`` / ``MListInternTable``: forwardrpc.MetricList
  bytes -> a struct-of-arrays batch and the (type, payload, name, tags)
  -> store row memo of the global's import (``importsrv/server.go:101-132``);
- ``encode_digest_metrics`` / ``encode_digest_metrics_packed``: a
  forwarded digest group's dense or device-packed planes -> serialized
  MetricList chunks (``flusher.go:424-473``).

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

# vt_mintern_assign's miss marker
MISS = 0xFFFFFFFF

# VtMetricBatch payload kinds (which value-oneof a Metric carried)
PAYLOAD_NONE = 0
PAYLOAD_COUNTER = 1
PAYLOAD_GAUGE = 2
PAYLOAD_HISTOGRAM = 3
PAYLOAD_SET = 4


class _VtBodies(ctypes.Structure):
    # ptr as void*: c_char_p would convert to bytes truncated at the
    # first NUL, and deflated bodies contain NULs
    _fields_ = [
        ("count", ctypes.c_uint32),
        ("ptr", ctypes.POINTER(ctypes.c_void_p)),
        ("len", ctypes.POINTER(ctypes.c_uint64)),
        ("impl", ctypes.c_void_p),
    ]


class _VtMetricBatch(ctypes.Structure):
    _fields_ = [
        ("count", ctypes.c_uint32),
        ("arena_len", ctypes.c_uint64),
        ("ncent", ctypes.c_uint64),
        ("topk_off", ctypes.c_uint64),
        ("topk_len", ctypes.c_uint64),
        ("type", ctypes.POINTER(ctypes.c_uint8)),
        ("payload", ctypes.POINTER(ctypes.c_uint8)),
        ("name_off", ctypes.POINTER(ctypes.c_uint32)),
        ("name_len", ctypes.POINTER(ctypes.c_uint32)),
        ("tags_off", ctypes.POINTER(ctypes.c_uint32)),
        ("tags_len", ctypes.POINTER(ctypes.c_uint32)),
        ("ivalue", ctypes.POINTER(ctypes.c_int64)),
        ("dvalue", ctypes.POINTER(ctypes.c_double)),
        ("compression", ctypes.POINTER(ctypes.c_double)),
        ("dmin", ctypes.POINTER(ctypes.c_double)),
        ("dmax", ctypes.POINTER(ctypes.c_double)),
        ("cent_off", ctypes.POINTER(ctypes.c_uint64)),
        ("cent_len", ctypes.POINTER(ctypes.c_uint32)),
        ("hll_off", ctypes.POINTER(ctypes.c_uint64)),
        ("hll_len", ctypes.POINTER(ctypes.c_uint64)),
        ("arena", ctypes.POINTER(ctypes.c_char)),
        ("means", ctypes.POINTER(ctypes.c_double)),
        ("weights", ctypes.POINTER(ctypes.c_double)),
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
    u16p = ctypes.POINTER(ctypes.c_uint16)
    f32p = ctypes.POINTER(ctypes.c_float)
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
    lib.vt_sfx_datapoints_json.restype = ctypes.POINTER(_VtBodies)
    lib.vt_sfx_datapoints_json.argtypes = [
        ctypes.c_char_p, u32p, u32p,            # names
        ctypes.c_char_p, u32p, u32p,            # tags
        ctypes.c_uint32,                        # nrows
        ctypes.c_char_p, u32p, u32p, ctypes.c_uint32,  # suffixes
        u32p, u8p, f64p, u8p, ctypes.c_uint64,  # emissions
        ctypes.c_int64,                         # timestamp ms
        ctypes.c_char_p, ctypes.c_char_p,       # hostname tag, hostname
        ctypes.c_char_p,                        # common dims json
        ctypes.c_char_p, u32p, u32p, ctypes.c_uint32,  # common keys
        ctypes.c_char_p, u32p, u32p, ctypes.c_uint32,  # excluded keys
    ]
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
    lib.vt_mlist_decode.restype = ctypes.POINTER(_VtMetricBatch)
    lib.vt_mlist_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.vt_mbatch_free.argtypes = [ctypes.POINTER(_VtMetricBatch)]
    lib.vt_mintern_new.restype = ctypes.c_void_p
    lib.vt_mintern_free.argtypes = [ctypes.c_void_p]
    lib.vt_mintern_reset.argtypes = [ctypes.c_void_p]
    lib.vt_mintern_put.argtypes = [
        ctypes.c_void_p, ctypes.c_uint8, ctypes.c_uint8, ctypes.c_char_p,
        ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32]
    lib.vt_mintern_assign.restype = ctypes.c_uint32
    lib.vt_mintern_assign.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_VtMetricBatch), u32p, u32p]
    digest_tail = [
        ctypes.c_uint32, ctypes.c_uint8,        # nrows, pb type
        ctypes.c_double, ctypes.c_uint64,       # compression, max bytes
        ctypes.c_int,                           # reference_compat
    ]
    lib.vt_mlist_encode_digests.restype = ctypes.POINTER(_VtBodies)
    lib.vt_mlist_encode_digests.argtypes = [
        ctypes.c_char_p, u32p, u32p,            # names
        ctypes.c_char_p, u32p, u32p,            # tags
        f32p, f32p, ctypes.c_uint32,            # means, weights, K
        f32p, f32p,                             # dmins, dmaxs
    ] + digest_tail
    lib.vt_mlist_encode_digests_packed.restype = ctypes.POINTER(_VtBodies)
    lib.vt_mlist_encode_digests_packed.argtypes = [
        ctypes.c_char_p, u32p, u32p,            # names
        ctypes.c_char_p, u32p, u32p,            # tags
        u16p, u16p, u16p,                       # counts, means_q, weights_bf
        f32p, f32p,                             # dmins, dmaxs
    ] + digest_tail
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


def sfx_datapoint_bodies(names: Arenas, tags: Arenas,
                         suffixes: List[bytes], em_rows: np.ndarray,
                         em_suffix: np.ndarray, em_values: np.ndarray,
                         em_type: np.ndarray, timestamp_ms: int,
                         hostname_tag: str, hostname: str,
                         common_dims_json: bytes = b"",
                         common_keys: Optional[List[bytes]] = None,
                         excluded_keys: Optional[List[bytes]] = None
                         ) -> List[bytes]:
    """Serialize one columnar emission block into a SignalFx
    ``/v2/datapoint`` body (``{"gauge": [...], "counter": [...]}``,
    uncompressed). Each tag becomes a dimension, the host one too (under
    ``hostname_tag``; "" leaves it out); ``common_dims_json`` is the
    escaped ``"k":"v",...`` fragment of the common dimensions, whose
    keys (``common_keys``) override a tag's; ``excluded_keys`` drop."""
    lib = load()
    args, keep = _block_args(names, tags, suffixes, em_rows, em_suffix,
                             em_values, em_type)
    ck_blob, ck_off, ck_len = _key_list(common_keys or [])
    ex_blob, ex_off, ex_len = _key_list(excluded_keys or [])
    u32 = ctypes.c_uint32
    bp = lib.vt_sfx_datapoints_json(
        *args, timestamp_ms, hostname_tag.encode("utf-8"),
        hostname.encode("utf-8"), common_dims_json,
        ck_blob, _p(ck_off, u32), _p(ck_len, u32), len(common_keys or ()),
        ex_blob, _p(ex_off, u32), _p(ex_len, u32),
        len(excluded_keys or ()))
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


# ---------------------------------------------------------------------------
# MetricList decode and interning (the global's columnar import)
# ---------------------------------------------------------------------------


class DecodedMetricList:
    """numpy views over a decoded MetricList. Arrays are copies by
    default; ``copy=False`` gives zero-copy views into the C++ batch (the
    import path uses it), which die with :meth:`close`. The hll spans
    index into the original frame bytes, which the caller keeps."""

    __slots__ = ("count", "type", "payload", "name_off", "name_len",
                 "tags_off", "tags_len", "ivalue", "dvalue", "compression",
                 "dmin", "dmax", "cent_off", "cent_len", "hll_off",
                 "hll_len", "arena", "means", "weights", "topk_off",
                 "topk_len", "_ptr", "_lib")

    def __init__(self, lib, ptr, copy: bool = True):
        self._lib = lib
        self._ptr = ptr
        b = ptr.contents
        n = b.count
        self.topk_off = b.topk_off
        self.topk_len = b.topk_len

        def arr(p, dtype, count=n):
            if count == 0:
                return np.empty(0, dtype)
            return np.ctypeslib.as_array(p, shape=(count,)).astype(
                dtype, copy=copy)

        self.count = n
        self.type = arr(b.type, np.uint8)
        self.payload = arr(b.payload, np.uint8)
        self.name_off = arr(b.name_off, np.uint32)
        self.name_len = arr(b.name_len, np.uint32)
        self.tags_off = arr(b.tags_off, np.uint32)
        self.tags_len = arr(b.tags_len, np.uint32)
        self.ivalue = arr(b.ivalue, np.int64)
        self.dvalue = arr(b.dvalue, np.float64)
        self.compression = arr(b.compression, np.float64)
        self.dmin = arr(b.dmin, np.float64)
        self.dmax = arr(b.dmax, np.float64)
        self.cent_off = arr(b.cent_off, np.uint64)
        self.cent_len = arr(b.cent_len, np.uint32)
        self.hll_off = arr(b.hll_off, np.uint64)
        self.hll_len = arr(b.hll_len, np.uint64)
        self.arena = (ctypes.string_at(b.arena, b.arena_len)
                      if b.arena_len else b"")
        self.means = arr(b.means, np.float64, b.ncent)
        self.weights = arr(b.weights, np.float64, b.ncent)

    def raw_view(self) -> _VtMetricBatch:
        """A struct borrowing this batch's arrays for a C call
        (vt_mintern_assign); keep ``self`` alive across the call."""
        b = _VtMetricBatch()
        b.count = self.count
        b.arena_len = len(self.arena)
        b.type = _p(self.type, ctypes.c_uint8)
        b.payload = _p(self.payload, ctypes.c_uint8)
        b.name_off = _p(self.name_off, ctypes.c_uint32)
        b.name_len = _p(self.name_len, ctypes.c_uint32)
        b.tags_off = _p(self.tags_off, ctypes.c_uint32)
        b.tags_len = _p(self.tags_len, ctypes.c_uint32)
        b.arena = ctypes.cast(ctypes.c_char_p(self.arena),
                              ctypes.POINTER(ctypes.c_char))
        return b

    def close(self):
        if self._ptr:
            self._lib.vt_mbatch_free(self._ptr)
            self._ptr = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def decode_metric_list(data: bytes, copy: bool = True) -> DecodedMetricList:
    """One serialized MetricList -> its columns (C++ ``vt_mlist_decode``:
    quantized digests, fields 16/17, before the packed doubles, 14/15,
    before the reference's repeated centroids)."""
    lib = load()
    return DecodedMetricList(lib, lib.vt_mlist_decode(data, len(data)),
                             copy=copy)


class MListInternTable:
    """(metricpb type, payload kind, name, joined tags) -> store row,
    memoized in C++. Misses come back for Python to resolve and teach
    with :meth:`put`. The payload kind is part of the key: rows mean
    something only inside the group the value-oneof picks, so a repeated
    (type, name, tags) with another oneof must miss."""

    def __init__(self):
        self._lib = load()
        self._handle = self._lib.vt_mintern_new()

    def assign(self, batch: DecodedMetricList):
        """(rows u32 [count], MISS where unknown; the miss indices)."""
        n = batch.count
        rows = np.empty(n, np.uint32)
        miss = np.empty(n, np.uint32)
        view = batch.raw_view()
        nmiss = self._lib.vt_mintern_assign(
            self._handle, ctypes.byref(view), _p(rows, ctypes.c_uint32),
            _p(miss, ctypes.c_uint32))
        return rows, miss[:nmiss]

    def put(self, pb_type: int, payload: int, name: bytes, tags: bytes,
            row: int):
        self._lib.vt_mintern_put(self._handle, pb_type, payload, name,
                                 len(name), tags, len(tags), row)

    def reset(self):
        self._lib.vt_mintern_reset(self._handle)

    def close(self):
        if self._handle:
            self._lib.vt_mintern_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# MetricList encode (a local's forwarded digest groups)
# ---------------------------------------------------------------------------


def _arena_args(names: Arenas, tags: Arenas) -> tuple:
    """(the six arena arguments, the contiguous arrays to keep)."""
    name_arena, name_off, name_len = names
    tags_arena, tags_off, tags_len = tags
    keep = [_u32a(a) for a in (name_off, name_len, tags_off, tags_len)]
    u32 = ctypes.c_uint32
    return ([name_arena, _p(keep[0], u32), _p(keep[1], u32),
             tags_arena, _p(keep[2], u32), _p(keep[3], u32)], keep)


def encode_digest_metrics(names: Arenas, tags: Arenas, means: np.ndarray,
                          weights: np.ndarray, dmins: np.ndarray,
                          dmaxs: np.ndarray, pb_type: int,
                          compression: float = 100.0,
                          max_body_bytes: int = 0,
                          reference_compat: bool = False) -> List[bytes]:
    """Dense digest planes -> serialized MetricList chunks.

    means/weights: [S, K] float32 (weight <= 0 marks padding); each
    chunk is a complete MetricList of at most ``max_body_bytes`` (0 =
    one chunk) unless one metric alone is larger."""
    lib = load()
    means = np.ascontiguousarray(means, np.float32)
    weights = np.ascontiguousarray(weights, np.float32)
    dmins = np.ascontiguousarray(dmins, np.float32)
    dmaxs = np.ascontiguousarray(dmaxs, np.float32)
    nrows, k = means.shape
    if weights.shape != (nrows, k) or dmins.shape != (nrows,) \
            or dmaxs.shape != (nrows,):
        raise ValueError("digest planes disagree in shape")
    args, keep = _arena_args(names, tags)
    f32 = ctypes.c_float
    bp = lib.vt_mlist_encode_digests(
        *args, _p(means, f32), _p(weights, f32), k, _p(dmins, f32),
        _p(dmaxs, f32), nrows, pb_type, compression, max_body_bytes,
        1 if reference_compat else 0)
    del keep
    return _take_bodies(lib, bp)


def encode_digest_metrics_packed(names: Arenas, tags: Arenas, planes,
                                 pb_type: int, compression: float = 100.0,
                                 max_body_bytes: int = 0,
                                 reference_compat: bool = False
                                 ) -> List[bytes]:
    """Device-packed digest planes (``core.store.PackedDigestPlanes``) ->
    serialized MetricList chunks. Without ``reference_compat`` the
    quantized u16 arrays go on the wire verbatim (tdigest fields 16/17,
    4 bytes a centroid); with it the C++ dequantizes into the reference's
    repeated centroids plus the packed doubles."""
    lib = load()
    counts = np.ascontiguousarray(planes.counts, np.uint16)
    means_q = np.ascontiguousarray(planes.means_q, np.uint16)
    weights_bf = np.ascontiguousarray(planes.weights_bf, np.uint16)
    dmins = np.ascontiguousarray(planes.dmin, np.float32)
    dmaxs = np.ascontiguousarray(planes.dmax, np.float32)
    nrows = len(counts)
    total = int(counts.astype(np.int64).sum())
    if not (total == len(means_q) == len(weights_bf)):
        # the C++ walker advances by counts: a mismatch would read past
        # the arrays (an exception, not an assert: it must survive -O)
        raise ValueError(
            f"packed planes inconsistent: sum(counts)={total}, "
            f"means={len(means_q)}, weights={len(weights_bf)}")
    args, keep = _arena_args(names, tags)
    u16, f32 = ctypes.c_uint16, ctypes.c_float
    bp = lib.vt_mlist_encode_digests_packed(
        *args, _p(counts, u16), _p(means_q, u16), _p(weights_bf, u16),
        _p(dmins, f32), _p(dmaxs, f32), nrows, pb_type, compression,
        max_body_bytes, 1 if reference_compat else 0)
    del keep
    return _take_bodies(lib, bp)
