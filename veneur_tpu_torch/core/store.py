"""The dense metric store: every series is a row in device-resident tensors.

Port of the dense single-device subset of ``veneur_tpu/core/store.py``.
Every scope-class is one dense group:

    =====================  =============================================
    scope-class            state
    =====================  =============================================
    counters               host   int64  [S]   (exact, like Go int64)
    global_counters        host   int64  [S]
    gauges                 host   float64[S]   (last-write-wins)
    global_gauges          host   float64[S]
    histograms             device t-digest [S, K] + temp bins [S, K]
    timers                 device t-digest [S, K] + temp bins [S, K]
    local_histograms       device t-digest [S, K] + temp bins [S, K]
    local_timers           device t-digest [S, K] + temp bins [S, K]
    sets                   device HLL registers [S, 2^p] (int8)
    local_sets             device HLL registers [S, 2^p] (int8)
    =====================  =============================================

The per-interval flush drains every digest group through the K1 kernel
(``ops/tdigest_cuda.drain_quantile``) and every set group through one
batched estimate. This store plays the non-forwarding (global) role:
forwarding, imports, status checks, heavy hitters, snapshots, overload
control and columnar egress are not ported yet, and a kernel error
propagates (there is no fallback rung).

Device state is updated in place where the JAX package donates buffers;
a flush swaps every group for a fresh twin with freshly allocated
planes, so a retired generation never aliases the live one.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List

import numpy as np
import torch

from veneur_tpu_torch.core.bucketing import pow2_cap
from veneur_tpu_torch.device import resolve_device
from veneur_tpu_torch.ops import hll as hll_ops
from veneur_tpu_torch.ops import tdigest as td_ops
from veneur_tpu_torch.samplers.intermetric import (
    Aggregate,
    HistogramAggregates,
    InterMetric,
    MetricType,
    route_info,
)
from veneur_tpu_torch.samplers.parser import (
    F32_ABS_MAX,
    GLOBAL_ONLY,
    LOCAL_ONLY,
    MIN_SAMPLE_RATE,
    MetricKey,
    NotPortedError,
    UDPMetric,
)

DEFAULT_CHUNK = 1 << 14
DEFAULT_INITIAL_CAPACITY = 1 << 10
_GROW_FACTOR = 2
COUNTER_CONTRIB_MAX = float(1 << 63)
_STAT_NAMES = ("pcts", "count", "sum", "min", "max", "recip")


class Interner:
    """MetricKey -> dense row index, plus per-row name/tags for flush-time
    emission (the keys of the reference's map[MetricKey]*sampler,
    worker.go:54-91)."""

    __slots__ = ("rows", "names", "tags")

    def __init__(self):
        self.rows: Dict[MetricKey, int] = {}
        self.names: List[str] = []
        self.tags: List[List[str]] = []

    def __len__(self) -> int:
        return len(self.rows)

    def intern(self, key: MetricKey, tags: List[str]) -> int:
        row = self.rows.get(key)
        if row is None:
            row = len(self.rows)
            self.rows[key] = row
            self.names.append(key.name)
            self.tags.append(tags)
        return row


# ---------------------------------------------------------------------------
# Host-side scalar groups
# ---------------------------------------------------------------------------


class ScalarGroup:
    """Counters / gauges: host numpy state.

    kind: "counter" (int64 accumulate, samplers.go:141-143) or "gauge"
    (float64 last-write, samplers.go:225-227). Samples the typed lane
    cannot hold are counted in ``scrubbed`` and dropped."""

    def __init__(self, kind: str, capacity: int = DEFAULT_INITIAL_CAPACITY):
        if kind not in ("counter", "gauge"):
            raise ValueError(f"unknown scalar kind {kind!r}")
        self.kind = kind
        self.interner = Interner()
        self.capacity = capacity
        self.scrubbed = 0
        self.values = np.zeros(capacity, np.int64 if kind == "counter"
                               else np.float64)

    def __len__(self):
        return len(self.interner)

    def _row(self, key: MetricKey, tags: List[str]) -> int:
        row = self.interner.intern(key, tags)
        if row >= self.capacity:
            self.capacity *= _GROW_FACTOR
            self.values = np.concatenate(
                [self.values, np.zeros(self.capacity - len(self.values),
                                       self.values.dtype)])
        return row

    def sample(self, key: MetricKey, tags: List[str], value: float,
               sample_rate: float):
        if not math.isfinite(value):
            self.scrubbed += 1
            return
        if self.kind == "counter":
            # Go semantics: value += int64(sample) * int64(1/rate), the
            # reciprocal a float32 division (samplers.go:141-143)
            if not MIN_SAMPLE_RATE <= sample_rate <= 1:
                self.scrubbed += 1
                return
            contrib = (int(value)
                       * int(np.float32(1.0) / np.float32(sample_rate)))
            if abs(contrib) >= COUNTER_CONTRIB_MAX:
                self.scrubbed += 1
                return
            row = self._row(key, tags)  # may grow (replace) values
            self.values[row] += contrib
        else:
            row = self._row(key, tags)
            self.values[row] = value

    def snapshot_and_reset(self):
        n = len(self.interner)
        interner, self.interner = self.interner, Interner()
        values = self.values[:n].copy()
        self.values[:] = 0
        return interner, values

    def fresh(self) -> "ScalarGroup":
        """Empty same-config twin (swap-on-flush generation swap)."""
        return ScalarGroup(self.kind, self.capacity)


# ---------------------------------------------------------------------------
# Device-side digest groups (histograms and timers)
# ---------------------------------------------------------------------------


def _ingest_samples(digest: td_ops.TDigest, temp: td_ops.TempCentroids,
                    rows, values, weights, compression):
    """Shift-guarded ingest (ops/tdigest.py ingest_chunk_guarded): a
    distribution step drains the bins into the digest through K2 before
    re-binning. Updates ``temp`` in place; returns (digest, temp)."""
    return td_ops.ingest_chunk_guarded(digest, temp, rows, values, weights,
                                       compression)


def _flush_digests(digest: td_ops.TDigest, temp: td_ops.TempCentroids,
                   dmin, dmax, qs, compression):
    """The per-interval flush program: one K1 launch drains and computes
    every percentile for the whole group (the Histo.Flush hot loop of
    samplers.go:511-636 over all series at once)."""
    drained, pcts = td_ops.drain_and_quantile(digest, temp, dmin, dmax, qs,
                                              compression)
    return (drained, pcts, temp.count, temp.vsum, temp.vmin, temp.vmax,
            temp.recip)


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class DigestGroup:
    """One scope-class of histograms/timers as a dense t-digest batch."""

    # set by MetricStore._swap_generation: a retired group's flush drops
    # its device state instead of reallocating it
    _retired = False

    def __init__(self, capacity: int = DEFAULT_INITIAL_CAPACITY,
                 chunk: int = DEFAULT_CHUNK,
                 compression: float = td_ops.DEFAULT_COMPRESSION,
                 device=None):
        self.device = resolve_device(device)
        self.interner = Interner()
        self.capacity = capacity
        self.chunk = chunk
        self.compression = compression
        self.k = td_ops.size_bound(compression)
        self.scrubbed = 0
        self._init_device()
        self._new_sample_buffers()

    def _init_device(self):
        dev = self.device
        self.temp = td_ops.init_temp(self.capacity, self.k, self.compression,
                                     device=dev)
        self.digest = td_ops.init((self.capacity,), self.compression,
                                  self.k, device=dev)
        self.dmin = torch.full((self.capacity,), math.inf,
                               dtype=torch.float32, device=dev)
        self.dmax = torch.full((self.capacity,), -math.inf,
                               dtype=torch.float32, device=dev)
        self._device_dirty = False

    def _new_sample_buffers(self):
        # fresh host buffers per drain: a host->device copy may still be
        # reading the previous ones
        self._rows = np.full(self.chunk, self.capacity, np.int32)
        self._vals = np.zeros(self.chunk, np.float32)
        self._wts = np.zeros(self.chunk, np.float32)
        self._fill = 0

    def __len__(self):
        return len(self.interner)

    def _row(self, key: MetricKey, tags: List[str]) -> int:
        row = self.interner.intern(key, tags)
        if row >= self.capacity:
            self._grow()
        return row

    def _grow(self):
        self._drain_samples()
        old = self.capacity
        self.capacity *= _GROW_FACTOR
        pad = self.capacity - old

        def grow(t, fill):
            return torch.cat([t, t.new_full((pad,) + tuple(t.shape[1:]),
                                            fill)])

        t = self.temp
        self.temp = td_ops.TempCentroids(
            sum_w=grow(t.sum_w, 0.0), sum_wm=grow(t.sum_wm, 0.0),
            seg_w=grow(t.seg_w, 0.0), seg_wm=grow(t.seg_wm, 0.0),
            count=grow(t.count, 0.0), vsum=grow(t.vsum, 0.0),
            vmin=grow(t.vmin, math.inf), vmax=grow(t.vmax, -math.inf),
            recip=grow(t.recip, 0.0))
        d = self.digest
        self.digest = td_ops.TDigest(
            mean=grow(d.mean, math.inf), weight=grow(d.weight, 0.0),
            min=grow(d.min, math.inf), max=grow(d.max, -math.inf))
        self.dmin = grow(self.dmin, math.inf)
        self.dmax = grow(self.dmax, -math.inf)
        # re-point staging padding at the new out-of-range row id
        self._rows[self._fill:] = self.capacity

    def ensure_capacity(self, max_row: int):
        """Grow so max_row is addressable (bulk paths bypass _row)."""
        while max_row >= self.capacity:
            self._grow()

    def fresh(self) -> "DigestGroup":
        """Empty same-config twin with newly allocated planes. Carries the
        grown capacity so a steady cardinality never re-grows."""
        return DigestGroup(self.capacity, self.chunk, self.compression,
                           self.device)

    def sample_many(self, rows: np.ndarray, vals: np.ndarray,
                    wts: np.ndarray):
        """Bulk staging append of pre-interned rows: one numpy copy per
        span instead of a Python call per sample. Non-finite values and
        non-positive or non-finite weights are counted in ``scrubbed``
        and dropped."""
        vals = np.asarray(vals, np.float32)
        wts = np.asarray(wts, np.float32)
        ok = np.isfinite(vals) & np.isfinite(wts) & (wts > 0)
        if not ok.all():
            self.scrubbed += int((~ok).sum())
            rows, vals, wts = rows[ok], vals[ok], wts[ok]
        n = len(rows)
        start = 0
        while start < n:
            take = min(self.chunk - self._fill, n - start)
            i = self._fill
            self._rows[i:i + take] = rows[start:start + take]
            self._vals[i:i + take] = vals[start:start + take]
            self._wts[i:i + take] = wts[start:start + take]
            self._fill = i + take
            start += take
            if self._fill == self.chunk:
                self._drain_samples()

    def sample(self, key: MetricKey, tags: List[str], value: float,
               sample_rate: float):
        if not math.isfinite(value) or abs(value) > F32_ABS_MAX \
                or not MIN_SAMPLE_RATE <= sample_rate <= 1:
            self.scrubbed += 1
            return
        row = self._row(key, tags)
        i = self._fill
        self._rows[i] = row
        self._vals[i] = value
        # float32 reciprocal, bit-identical to the JAX package's staging
        self._wts[i] = np.float32(1.0) / np.float32(sample_rate)
        self._fill = i + 1
        if self._fill == self.chunk:
            self._drain_samples()

    def _drain_samples(self):
        if self._fill == 0:
            return
        self._device_dirty = True
        # a pow2 prefix of the sentinel-padded buffers: a partial chunk
        # pays for its own size, and the device sees few distinct shapes
        n = pow2_cap(self._fill)
        rows, vals, wts = self._rows[:n], self._vals[:n], self._wts[:n]
        self._new_sample_buffers()
        dev = self.device
        self.digest, self.temp = _ingest_samples(
            self.digest, self.temp,
            torch.from_numpy(rows).to(dev).long(),
            torch.from_numpy(vals).to(dev), torch.from_numpy(wts).to(dev),
            self.compression)

    def flush(self, percentiles: List[float], want_stats=None):
        """Run the flush program; returns (interner, host result dict) and
        resets the group. ``want_stats`` (None = all) selects the per-row
        stat columns fetched."""
        return self.flush_begin(percentiles, want_stats)()

    def flush_begin(self, percentiles: List[float], want_stats=None):
        """Two-phase flush: drain staging and DISPATCH the flush program
        now (kernel launches are asynchronous), and return a ``finish()``
        whose device->host copy blocks later, so the store can dispatch
        every group before any fetch waits. ``finish()`` returns
        ``(interner, out)`` and only then resets the group."""
        self._drain_samples()
        n = len(self.interner)
        if n == 0:
            res = self._flush_empty()
            return lambda: res
        pending = self._flush_dispatch(n, percentiles, want_stats)
        return lambda: self._flush_commit(
            self._flush_collect(pending, n, percentiles))

    def _flush_empty(self):
        interner, self.interner = self.interner, Interner()
        if self._retired:
            self._drop_device()
        elif self._device_dirty:
            self._init_device()
            self._new_sample_buffers()
        return interner, {}

    def _flush_commit(self, out: dict):
        interner, self.interner = self.interner, Interner()
        if self._retired:
            self._drop_device()
        else:
            self._init_device()
            self._new_sample_buffers()
        return interner, out

    def _flush_dispatch(self, n: int, percentiles, want_stats):
        sel = [nm for nm in _STAT_NAMES
               if want_stats is None or nm in want_stats]
        qs = torch.tensor(list(percentiles) + [0.5], dtype=torch.float32,
                          device=self.device)
        _, pcts, count, vsum, vmin, vmax, recip = _flush_digests(
            self.digest, self.temp, self.dmin, self.dmax, qs,
            self.compression)
        stats = {"pcts": pcts, "count": count, "sum": vsum, "min": vmin,
                 "max": vmax, "recip": recip}
        return sel, tuple(stats[nm][:n] for nm in sel)

    def _flush_collect(self, pending, n: int, percentiles) -> dict:
        sel, refs = pending
        fetched = [_to_host(t) for t in refs]
        out = {}
        # unfetched stats zero-fill: the aggregate mask that left them out
        # of the fetch also gates their emission (_digest_want)
        got = dict(zip(sel, fetched))
        zeros = np.zeros(n, np.float32)
        zeros.flags.writeable = False
        for nm in _STAT_NAMES[1:]:
            out[nm] = got.get(nm, zeros)
        if "pcts" in got:
            out["percentiles"] = got["pcts"][:, :-1]
            out["median"] = got["pcts"][:, -1]
        else:
            out["percentiles"] = np.zeros((n, len(percentiles)), np.float32)
            out["median"] = zeros
        return out

    def _drop_device(self):
        """Free a retired generation's device state and staging buffers."""
        self.digest = self.temp = self.dmin = self.dmax = None
        self._device_dirty = False
        self._rows = self._vals = self._wts = None
        self._fill = 0


# ---------------------------------------------------------------------------
# Device-side set groups (HyperLogLog)
# ---------------------------------------------------------------------------


def _ingest_hashes(registers, rows, hi, lo):
    """Scatter-max one chunk of hashed members into ``registers`` in
    place; padding rows (== S) write nothing."""
    valid = rows < registers.shape[0]
    return hll_ops.insert(registers, rows, hi, lo, mask=valid,
                          precision=_precision_of(registers))


def _precision_of(registers) -> int:
    return int(math.log2(registers.shape[-1]))


def _estimate_all(registers):
    return hll_ops.estimate(registers, _precision_of(registers))


class SetGroup:
    """One scope-class of Set metrics as a dense [S, 2^p] int8 register
    tensor (at precision 14 a series costs 16 KiB of device memory)."""

    _retired = False  # see DigestGroup._retired

    def __init__(self, capacity: int = DEFAULT_INITIAL_CAPACITY,
                 chunk: int = DEFAULT_CHUNK,
                 precision: int = hll_ops.DEFAULT_PRECISION, device=None):
        self.device = resolve_device(device)
        self.interner = Interner()
        self.capacity = capacity
        self.chunk = chunk
        self.precision = precision
        self.m = hll_ops.num_registers(precision)
        self._reset_registers()
        self._new_sample_buffers()

    def _new_sample_buffers(self):
        self._rows = np.full(self.chunk, self.capacity, np.int32)
        self._hi = np.zeros(self.chunk, np.uint32)
        self._lo = np.zeros(self.chunk, np.uint32)
        self._fill = 0

    def __len__(self):
        return len(self.interner)

    def _row(self, key: MetricKey, tags: List[str]) -> int:
        row = self.interner.intern(key, tags)
        if row >= self.capacity:
            self._grow()
        return row

    def _grow(self):
        self._drain_samples()
        old = self.capacity
        self.capacity *= _GROW_FACTOR
        self.registers = torch.cat([self.registers,
                                    self.registers.new_zeros(
                                        (self.capacity - old, self.m))])
        self._rows[self._fill:] = self.capacity

    def ensure_capacity(self, max_row: int):
        """Grow so max_row is addressable (bulk paths bypass _row)."""
        while max_row >= self.capacity:
            self._grow()

    def fresh(self) -> "SetGroup":
        """Empty same-config twin with a newly allocated register plane."""
        return SetGroup(self.capacity, self.chunk, self.precision,
                        self.device)

    def sample_many(self, rows: np.ndarray, hashes: np.ndarray):
        """Bulk staging append of pre-interned rows and pre-hashed
        members (uint64)."""
        his, los = hll_ops.split_hashes(hashes)
        n = len(rows)
        start = 0
        while start < n:
            take = min(self.chunk - self._fill, n - start)
            i = self._fill
            self._rows[i:i + take] = rows[start:start + take]
            self._hi[i:i + take] = his[start:start + take]
            self._lo[i:i + take] = los[start:start + take]
            self._fill = i + take
            start += take
            if self._fill == self.chunk:
                self._drain_samples()

    def sample(self, key: MetricKey, tags: List[str], member: str):
        row = self._row(key, tags)
        h = hll_ops.hash_member(member.encode("utf-8"))
        i = self._fill
        self._rows[i] = row
        self._hi[i] = h >> 32
        self._lo[i] = h & 0xFFFFFFFF
        self._fill = i + 1
        if self._fill == self.chunk:
            self._drain_samples()

    def _drain_samples(self):
        if self._fill == 0:
            return
        self._device_dirty = True
        n = pow2_cap(self._fill)  # see DigestGroup._drain_samples
        rows, hi, lo = self._rows[:n], self._hi[:n], self._lo[:n]
        self._new_sample_buffers()
        dev = self.device
        # uint32 halves travel as their int32 bit patterns
        _ingest_hashes(self.registers,
                       torch.from_numpy(rows).to(dev).long(),
                       torch.from_numpy(hi.view(np.int32)).to(dev),
                       torch.from_numpy(lo.view(np.int32)).to(dev))

    def flush(self):
        return self.flush_begin()()

    def flush_begin(self):
        """Two-phase flush: the estimate is dispatched now (a fresh output
        tensor, so the reset below cannot touch it); ``finish()`` copies
        it to the host and returns ``(interner, estimates)``."""
        self._drain_samples()
        n = len(self.interner)
        interner, self.interner = self.interner, Interner()
        if n == 0:
            if self._retired:
                self.registers = None
            elif self._device_dirty:
                self._reset_registers()
                self._new_sample_buffers()
            return lambda: (interner, None)
        est_ref = _estimate_all(self.registers[:n])
        if self._retired:
            self.registers = None
        else:
            self._reset_registers()
            self._new_sample_buffers()

        return lambda: (interner, _to_host(est_ref))

    def _reset_registers(self):
        self.registers = torch.zeros((self.capacity, self.m),
                                     dtype=torch.int8, device=self.device)
        self._device_dirty = False


_DIGEST_GROUPS = ("histograms", "timers", "local_histograms", "local_timers")
_SET_GROUPS = ("sets", "local_sets")


def _digest_want(percentiles, aggregates: HistogramAggregates) -> set:
    """The per-row stat columns one digest group's flush must fetch for
    this aggregate config; the rest are zero-filled and never emitted,
    because the same mask gates their emissions."""
    agg = aggregates.value
    want_stats = set()
    if agg & (Aggregate.COUNT | Aggregate.AVERAGE
              | Aggregate.HARMONIC_MEAN):
        want_stats.add("count")
    if agg & Aggregate.MIN:
        want_stats.add("min")
    if agg & Aggregate.MAX:
        want_stats.add("max")
    if agg & (Aggregate.SUM | Aggregate.AVERAGE):
        want_stats.add("sum")
    if agg & Aggregate.HARMONIC_MEAN:
        want_stats.add("recip")
    if (agg & Aggregate.MEDIAN) or percentiles:
        want_stats.add("pcts")
    return want_stats


class _Generation:
    """The retired group set a flush drains off-lock (swap-on-flush)."""

    __slots__ = ("counters", "global_counters", "gauges", "global_gauges",
                 "histograms", "timers", "local_histograms", "local_timers",
                 "sets", "local_sets", "processed")


class MetricStore:
    """The ported scope-classes plus dispatch and flush."""

    # every group swapped per flush, in flush order
    _GEN_GROUPS = ("counters", "global_counters", "gauges", "global_gauges",
                   "histograms", "timers", "local_histograms",
                   "local_timers", "sets", "local_sets")

    def __init__(self, initial_capacity: int = DEFAULT_INITIAL_CAPACITY,
                 chunk: int = DEFAULT_CHUNK,
                 compression: float = td_ops.DEFAULT_COMPRESSION,
                 hll_precision: int = hll_ops.DEFAULT_PRECISION,
                 device=None):
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        # serializes whole flush() calls; the store lock itself is held
        # only for the generation swap
        self._flush_gate = threading.Lock()
        self.counters = ScalarGroup("counter", initial_capacity)
        self.global_counters = ScalarGroup("counter", initial_capacity)
        self.gauges = ScalarGroup("gauge", initial_capacity)
        self.global_gauges = ScalarGroup("gauge", initial_capacity)
        for name in _DIGEST_GROUPS:
            setattr(self, name, DigestGroup(initial_capacity, chunk,
                                            compression, self.device))
        for name in _SET_GROUPS:
            setattr(self, name, SetGroup(initial_capacity, chunk,
                                         hll_precision, self.device))
        self.hll_precision = hll_precision
        self.processed = 0

    def process_metric(self, m: UDPMetric):
        """Dispatch one parsed sample to its scope-class
        (worker.go:267-310)."""
        with self._lock:
            t = m.key.type
            if t == "counter":
                group = (self.global_counters if m.scope == GLOBAL_ONLY
                         else self.counters)
                group.sample(m.key, m.tags, m.value, m.sample_rate)
            elif t == "gauge":
                group = (self.global_gauges if m.scope == GLOBAL_ONLY
                         else self.gauges)
                group.sample(m.key, m.tags, m.value, m.sample_rate)
            elif t == "histogram":
                group = (self.local_histograms if m.scope == LOCAL_ONLY
                         else self.histograms)
                group.sample(m.key, m.tags, m.value, m.sample_rate)
            elif t == "timer":
                group = (self.local_timers if m.scope == LOCAL_ONLY
                         else self.timers)
                group.sample(m.key, m.tags, m.value, m.sample_rate)
            elif t == "set":
                if "veneurtopk" in m.tags:
                    raise NotPortedError("heavy-hitter (veneurtopk) sets "
                                         "are not ported yet")
                group = (self.local_sets if m.scope == LOCAL_ONLY
                         else self.sets)
                group.sample(m.key, m.tags, str(m.value))
            else:
                raise NotPortedError(f"metric type {t!r} is not ported yet")
            self.processed += 1

    def flush(self, percentiles: List[float],
              aggregates: HistogramAggregates, now: int):
        """Drain everything into the InterMetrics a global
        (non-forwarding) instance emits and reset all groups; returns the
        list. Mirrors generateInterMetrics (flusher.go:189-254).

        SWAP-ON-FLUSH: the store lock is held only for the generation
        swap; the device programs and fetches run on the retired
        generation off-lock, so ingest never stalls behind a flush."""
        with self._flush_gate:
            with self._lock:
                gen = self._swap_generation()
            return self._flush_generation(gen, percentiles, aggregates, now)

    def _swap_generation(self) -> _Generation:
        """Retire every group behind an empty twin (caller holds _lock).
        The twins allocate their own planes, so nothing the retired
        generation holds aliases the live one."""
        gen = _Generation()
        for attr in self._GEN_GROUPS:
            old = getattr(self, attr)
            old._retired = True  # its flush frees state, not reinits it
            setattr(gen, attr, old)
            setattr(self, attr, old.fresh())
        gen.processed = self.processed
        self.processed = 0
        return gen

    def _flush_generation(self, g: _Generation, percentiles, aggregates,
                          now) -> List[InterMetric]:
        """Drain a retired generation into emissions. Every device group
        dispatches its flush program before any fetch blocks; the
        fetches and emissions then run in plan order."""
        final: List[InterMetric] = []
        self._flush_scalars(g.counters, MetricType.COUNTER, final, now)
        self._flush_scalars(g.gauges, MetricType.GAUGE, final, now)
        want_stats = _digest_want(percentiles, aggregates)
        plan = []
        for name in _DIGEST_GROUPS:
            fin = getattr(g, name).flush_begin(percentiles,
                                               want_stats=want_stats)
            plan.append((fin, lambda res: self._emit_digest_result(
                res, percentiles, aggregates, final, now)))
        for name in ("local_sets", "sets"):
            fin = getattr(g, name).flush_begin()
            plan.append((fin, lambda res: self._emit_set_result(
                res, final, now)))
        for fin, emit in plan:
            emit(fin())
        self._flush_scalars(g.global_counters, MetricType.COUNTER, final,
                            now)
        self._flush_scalars(g.global_gauges, MetricType.GAUGE, final, now)
        return final

    def _flush_scalars(self, group: ScalarGroup, mtype: MetricType,
                       out: List[InterMetric], now: int):
        interner, values = group.snapshot_and_reset()
        for key, row in interner.rows.items():
            tags = interner.tags[row]
            out.append(InterMetric(
                name=key.name, timestamp=now, value=float(values[row]),
                tags=tags, type=mtype, sinks=route_info(tags)))

    def _emit_digest_result(self, res, percentiles: List[float],
                            aggregates: HistogramAggregates,
                            out: List[InterMetric], now: int):
        """Emission rules of Histo.Flush (samplers.go:511-636) for one
        digest group's fetched result."""
        interner, r = res
        agg = aggregates.value
        for key, row in interner.rows.items():
            tags = interner.tags[row]
            sinks = route_info(tags)
            name = key.name

            def emit(suffix: str, value: float,
                     mtype: MetricType = MetricType.GAUGE):
                out.append(InterMetric(
                    name=f"{name}.{suffix}", timestamp=now, value=value,
                    tags=list(tags), type=mtype, sinks=sinks))

            vmax, vmin = float(r["max"][row]), float(r["min"][row])
            vsum, cnt = float(r["sum"][row]), float(r["count"][row])
            recip = float(r["recip"][row])
            if (agg & Aggregate.MAX) and math.isfinite(vmax):
                emit("max", vmax)
            if (agg & Aggregate.MIN) and math.isfinite(vmin):
                emit("min", vmin)
            if (agg & Aggregate.SUM) and vsum != 0:
                emit("sum", vsum)
            if (agg & Aggregate.AVERAGE) and vsum != 0 and cnt != 0:
                emit("avg", vsum / cnt)
            if (agg & Aggregate.COUNT) and cnt != 0:
                emit("count", cnt, MetricType.COUNTER)
            if agg & Aggregate.MEDIAN:
                emit("median", float(r["median"][row]))
            if (agg & Aggregate.HARMONIC_MEAN) and recip != 0 and cnt != 0:
                emit("hmean", cnt / recip)
            for i, p in enumerate(percentiles):
                out.append(InterMetric(
                    name=f"{name}.{int(p * 100)}percentile", timestamp=now,
                    value=float(r["percentiles"][row, i]), tags=list(tags),
                    type=MetricType.GAUGE, sinks=sinks))

    def _emit_set_result(self, res, out: List[InterMetric], now: int):
        interner, estimates = res
        for key, row in interner.rows.items():
            tags = interner.tags[row]
            out.append(InterMetric(
                name=key.name, timestamp=now, value=float(estimates[row]),
                tags=tags, type=MetricType.GAUGE, sinks=route_info(tags)))
