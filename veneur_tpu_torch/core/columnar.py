"""Columnar flush egress: the store's flush results as flat arrays.

Port of ``veneur_tpu/core/columnar.py``. Per-row emission builds ~15
Python objects a series an interval (the loop the reference runs in
``flusher.go:189-254`` + ``sinks/datadog/datadog.go:245-330``). A
columnar flush produces ``EmissionBlock``s instead: interner string
arenas plus parallel (row, suffix, value, type) arrays built by
vectorized numpy masking, which native sinks serialize without
materializing objects (``native/veneur_egress.cpp``).
``to_intermetrics`` lazily materializes the legacy list for sinks and
plugins that still consume ``InterMetric``. Everything here is numpy on
the host: the arrays come from fetches the flush thread already made.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from veneur_tpu_torch.samplers.intermetric import (
    Aggregate,
    InterMetric,
    MetricType,
)

Arenas = Tuple[bytes, np.ndarray, np.ndarray]  # blob, offsets u32, lengths u32

# emission type codes (the C++ serializer's em_type)
TYPE_GAUGE = 0
TYPE_COUNTER = 1  # serialized as a Datadog "rate" (value / interval)


def build_arenas(strs: List[str]) -> Arenas:
    """Concatenate strings into one encoded blob + offset/length columns.

    Fast path: one NUL-separated join + one encode, spans recovered by a
    vectorized separator scan (no per-string Python). The NUL separators
    stay in the blob — consumers only read [off, off+len) spans. A string
    containing NUL itself (never produced by the parsers, but imports are
    untrusted) breaks the span count and falls back to per-string
    encoding with a NUL-free layout."""
    n = len(strs)
    if n == 0:
        return b"", np.empty(0, np.uint32), np.empty(0, np.uint32)
    blob = "\x00".join(strs).encode("utf-8")
    seps = np.flatnonzero(np.frombuffer(blob, np.uint8) == 0)
    if len(seps) != n - 1:  # embedded NUL somewhere: slow path
        enc = [s.encode("utf-8") for s in strs]
        blob = b"".join(enc)
        lens = np.fromiter((len(e) for e in enc), np.int64, n)
        offs = np.zeros(n, np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        return blob, offs.astype(np.uint32), lens.astype(np.uint32)
    offs = np.empty(n, np.int64)
    offs[0] = 0
    offs[1:] = seps + 1
    ends = np.empty(n, np.int64)
    ends[:-1] = seps
    ends[-1] = len(blob)
    return blob, offs.astype(np.uint32), (ends - offs).astype(np.uint32)


def arena_strings(arenas: Arenas) -> List[str]:
    """The strings of (blob, offsets, lengths), the inverse of
    :func:`build_arenas`: one decode and split when the spans are its
    NUL-separated layout, else a decode a span."""
    blob, offs, lens = arenas
    n = len(offs)
    lens64 = np.asarray(lens, np.int64)
    starts = np.cumsum(lens64 + 1) - lens64 - 1
    if n and np.array_equal(np.asarray(offs, np.int64), starts) \
            and int(starts[-1] + lens64[-1]) == len(blob):
        parts = blob.decode("utf-8", "replace").split("\x00")
        if len(parts) == n and np.array_equal(
                np.fromiter(map(len, parts), np.int64, n), lens64):
            return parts
    return [blob[o:o + ln].decode("utf-8", "replace")
            for o, ln in zip(offs.tolist(), lens.tolist())]


@dataclass
class EmissionBlock:
    """One group's flush output as columns: S rows (names/tags arenas)
    emitting N metrics (parallel rows/suffix/values/types arrays)."""

    names: Arenas
    tags: Arenas
    suffixes: List[bytes]
    rows: np.ndarray        # u32 [N] — row index into the arenas
    suffix_idx: np.ndarray  # u8  [N] — index into suffixes
    values: np.ndarray      # f64 [N] — raw values (sinks finalize rates)
    type_codes: np.ndarray  # u8  [N] — TYPE_GAUGE / TYPE_COUNTER

    def __len__(self):
        return len(self.rows)


@dataclass
class ColumnarFlush:
    """A full flush: columnar blocks plus legacy extras (status checks,
    top-k, routed metrics — low-cardinality paths)."""

    timestamp: int
    blocks: List[EmissionBlock] = field(default_factory=list)
    extras: List[InterMetric] = field(default_factory=list)
    _materialized: Optional[List[InterMetric]] = None

    def __len__(self):
        return sum(len(b) for b in self.blocks) + len(self.extras)

    def add_block(self, block: Optional[EmissionBlock]):
        if block is not None and len(block):
            self.blocks.append(block)

    def to_intermetrics(self) -> List[InterMetric]:
        """Materialize the legacy InterMetric list (memoized) for sinks
        and plugins that do not consume columns."""
        if self._materialized is not None:
            return self._materialized
        out: List[InterMetric] = []
        for blk in self.blocks:
            nb, no, nl = blk.names
            tb, to, tl = blk.tags
            # per-row decodes memoized: emissions repeat rows ~5-15x
            names: dict = {}
            tags: dict = {}
            for i in range(len(blk.rows)):
                r = int(blk.rows[i])
                name = names.get(r)
                if name is None:
                    name = nb[no[r]:no[r] + nl[r]].decode("utf-8", "replace")
                    names[r] = name
                tg = tags.get(r)
                if tg is None:
                    joined = tb[to[r]:to[r] + tl[r]].decode("utf-8",
                                                            "replace")
                    tg = joined.split(",") if joined else []
                    tags[r] = tg
                suffix = blk.suffixes[blk.suffix_idx[i]].decode()
                out.append(InterMetric(
                    name=name + suffix, timestamp=self.timestamp,
                    value=float(blk.values[i]), tags=list(tg),
                    type=(MetricType.COUNTER
                          if blk.type_codes[i] == TYPE_COUNTER
                          else MetricType.GAUGE),
                    sinks=None))
            del names, tags
        out.extend(self.extras)
        self._materialized = out
        return out


def has_sink_routing(tags_blob: bytes) -> bool:
    """True if any row in the joined-tags arena carries a
    ``veneursinkonly:`` routing tag — such groups fall back to per-row
    emission so routing semantics hold (sinks.go:50-56)."""
    return b"veneursinkonly:" in tags_blob


def scalar_block(interner, values: np.ndarray,
                 type_code: int) -> Optional[EmissionBlock]:
    """Counters/gauges/set-estimates: one emission per interned row."""
    n = len(interner)
    if n == 0:
        return None
    names = build_arenas(interner.names)
    tags = build_arenas(interner.joined)
    rows = np.arange(n, dtype=np.uint32)
    return EmissionBlock(
        names=names, tags=tags, suffixes=[b""],
        rows=rows, suffix_idx=np.zeros(n, np.uint8),
        values=np.asarray(values[:n], np.float64),
        type_codes=np.full(n, type_code, np.uint8))


def digest_block(names: Arenas, tags: Arenas, r: dict, agg: Aggregate,
                 percentiles: List[float]) -> Optional[EmissionBlock]:
    """Histogram/timer flush results → emissions, masks computed
    vectorized (the emission rules of Histo.Flush,
    samplers.go:511-636, identical to MetricStore._emit_digest_result)."""
    n = len(names[1])
    if n == 0:
        return None
    vmax = np.asarray(r["max"][:n], np.float64)
    vmin = np.asarray(r["min"][:n], np.float64)
    vsum = np.asarray(r["sum"][:n], np.float64)
    cnt = np.asarray(r["count"][:n], np.float64)
    recip = np.asarray(r["recip"][:n], np.float64)
    median = np.asarray(r["median"][:n], np.float64)

    suffixes: List[bytes] = []
    rows_parts: List[np.ndarray] = []
    sfx_parts: List[np.ndarray] = []
    val_parts: List[np.ndarray] = []
    type_parts: List[np.ndarray] = []

    def emit(suffix: bytes, values: np.ndarray, mask: Optional[np.ndarray],
             type_code: int = TYPE_GAUGE):
        idx = (np.flatnonzero(mask) if mask is not None
               else np.arange(n, dtype=np.int64))
        if len(idx) == 0:
            return
        j = len(suffixes)
        suffixes.append(suffix)
        rows_parts.append(idx.astype(np.uint32))
        sfx_parts.append(np.full(len(idx), j, np.uint8))
        val_parts.append(values[idx] if mask is not None else values)
        type_parts.append(np.full(len(idx), type_code, np.uint8))

    if agg & Aggregate.MAX:
        emit(b".max", vmax, np.isfinite(vmax))
    if agg & Aggregate.MIN:
        emit(b".min", vmin, np.isfinite(vmin))
    if agg & Aggregate.SUM:
        emit(b".sum", vsum, vsum != 0)
    if agg & Aggregate.AVERAGE:
        mask = (vsum != 0) & (cnt != 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            emit(b".avg", vsum / np.where(cnt == 0, 1, cnt), mask)
    if agg & Aggregate.COUNT:
        emit(b".count", cnt, cnt != 0, TYPE_COUNTER)
    if agg & Aggregate.MEDIAN:
        emit(b".median", median, None)
    if agg & Aggregate.HARMONIC_MEAN:
        mask = (recip != 0) & (cnt != 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            emit(b".hmean", cnt / np.where(recip == 0, 1, recip), mask)
    if percentiles:
        pcts = np.asarray(r["percentiles"][:n], np.float64)
        for i, p in enumerate(percentiles):
            emit(f".{int(p * 100)}percentile".encode(), pcts[:, i], None)

    if not suffixes:
        return None
    return EmissionBlock(
        names=names, tags=tags, suffixes=suffixes,
        rows=np.concatenate(rows_parts),
        suffix_idx=np.concatenate(sfx_parts),
        values=np.concatenate(val_parts),
        type_codes=np.concatenate(type_parts))
