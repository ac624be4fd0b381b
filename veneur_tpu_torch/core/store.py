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
    local_status_checks    host   float64[S] + message/hostname strings
    histograms             device t-digest [S, K] + temp bins [S, K]
    timers                 device t-digest [S, K] + temp bins [S, K]
    local_histograms       device t-digest [S, K] + temp bins [S, K]
    local_timers           device t-digest [S, K] + temp bins [S, K]
    sets                   device HLL registers [S, 2^p] (int8)
    local_sets             device HLL registers [S, 2^p] (int8)
    heavy_hitters          device count-min table [d, w] + top-k [S, K]
    =====================  =============================================

Samples arrive three ways: one parsed line at a time
(:meth:`MetricStore.process_metric`), a native parsed batch
(:meth:`MetricStore.process_batch`), or a sealed ingest-lane chunk
(:meth:`MetricStore.import_lane_chunk`, ``ingest/lanes.py``); rejected
samples are counted by reason in ``MetricStore.quarantine``. Every path
cuts the joined tags at ``max_tag_length`` and interns through
:meth:`OverloadLimited._intern_row`, so past ``max_series`` (or while the
overload controller freezes first-sight series) a new series lands in
its group's ``veneur.overload.overflow`` row.

The per-interval flush drains every digest group through the K1 kernel
(``ops/tdigest_cuda.drain_quantile``) and every set group through one
batched estimate. The store plays either role of global aggregation: a
local's flush (``is_local=True``) returns the sketch state it forwards
(:class:`ForwardableState`; with ``digest_format="packed"`` its digest
planes are packed on the device, ``core/slab.py``), and a global merges
forwarded state through the ``import_*`` methods (``import_columnar``
for a MetricList frame decoded in C++), where imported centroids
re-enter the binning as weighted samples (a shift between imported
digests drains the bins through the K2 kernel). A flush is a plan of per-group units: every
group's device program dispatches before any fetch blocks, and one
serializer thread emits each fetched result (``flush_pipeline_depth``,
``core/pipeline.py``). A columnar flush emits ``EmissionBlock`` columns
(``core/columnar.py``) that the native serializers turn into sink bodies,
and streams each group's blocks to the sinks as it completes.

A digest flush runs the compute ladder (``resilience/compute.py``): the
CUDA kernel, and when it fails (or its breaker is open) the retired
group re-merges into the live store (late, never lost).
Every group snapshots without resetting (``snapshot_begin`` takes device
copies under the store lock, ``finish`` fetches them off it), and
:meth:`MetricStore.restore_state` merges a snapshot back with import
semantics: the checkpoint (``persist/``) and the ladder's third rung.

Device state is updated in place where the JAX package donates buffers;
a flush swaps every group for a fresh twin with freshly allocated
planes, so a retired generation never aliases the live one.
"""

from __future__ import annotations

import logging
import math
import sys
import threading
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from veneur_tpu_torch import native
from veneur_tpu_torch.core import columnar
from veneur_tpu_torch.core.bucketing import pow2_cap
from veneur_tpu_torch.core.columnar import ColumnarFlush
from veneur_tpu_torch.core.pipeline import SerializerLane
from veneur_tpu_torch.device import resolve_device
from veneur_tpu_torch.obs import kernels as obs_kernels
from veneur_tpu_torch.obs import recorder as obs_rec
from veneur_tpu_torch.ops import countmin as cm_ops
from veneur_tpu_torch.ops import hll as hll_ops
from veneur_tpu_torch.ops import tdigest as td_ops
from veneur_tpu_torch.overload import (OVERFLOW_NAME, Quarantine,
                                       freeze_exempt)
from veneur_tpu_torch.resilience.compute import ComputeBreaker
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
    TOPK_SCOPE,
    MetricKey,
    UDPMetric,
    truncate_joined_tags,
)

log = logging.getLogger("veneur.store")

DEFAULT_CHUNK = 1 << 14
DEFAULT_INITIAL_CAPACITY = 1 << 10
_GROW_FACTOR = 2
# HLL register imports drain in batches of this many rows
IMPORT_DRAIN_BATCH = 256
COUNTER_CONTRIB_MAX = float(1 << 63)
_STAT_NAMES = ("pcts", "count", "sum", "min", "max", "recip")

# native ParsedBatch record types (RecordType in native/veneur_ingest.cpp)
_NATIVE_TYPE_NAMES = ("counter", "gauge", "histogram", "timer", "set")
# scope-class kinds of the native batch and lane paths; must mirror
# kind_of() in native/veneur_ingest.cpp (_K_TOPK: heavy-hitter sets)
(_K_COUNTER, _K_GLOBAL_COUNTER, _K_GAUGE, _K_GLOBAL_GAUGE, _K_HISTO,
 _K_LOCAL_HISTO, _K_TIMER, _K_LOCAL_TIMER, _K_SET, _K_LOCAL_SET,
 _K_TOPK) = range(11)
_KIND_RAW = 255  # kind_of()'s sentinel for event/service-check records


class Interner:
    """MetricKey -> dense row index, plus per-row name/tags for flush-time
    emission (the keys of the reference's map[MetricKey]*sampler,
    worker.go:54-91); ``joined`` keeps each row's comma-joined tags."""

    __slots__ = ("rows", "names", "tags", "joined")

    def __init__(self):
        self.rows: Dict[MetricKey, int] = {}
        self.names: List[str] = []
        self.tags: List[List[str]] = []
        self.joined: List[str] = []

    def __len__(self) -> int:
        return len(self.rows)

    def intern(self, key: MetricKey, tags: List[str]) -> int:
        row = self.rows.get(key)
        if row is None:
            row = len(self.rows)
            self.rows[key] = row
            self.names.append(key.name)
            self.tags.append(tags)
            self.joined.append(key.joined_tags)
        return row


def _scrub_counter_batch(quarantine, vals, rates) -> np.ndarray:
    """Admissibility mask for a bulk counter span; rejects are counted
    per reason into ``quarantine`` (None = just mask). The bound follows
    the Go truncation, int64(value) * int64(float32(1) / float32(rate)),
    and a rate whose f32 reciprocal overflows to inf is caught before
    the undefined inf -> int64 cast."""
    finite = np.isfinite(vals)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        recip = np.where((rates > 0) & np.isfinite(rates),
                         np.float32(1.0) / rates.astype(np.float32),
                         np.inf)
    rate_ok = np.isfinite(recip)
    mult = np.trunc(np.where(rate_ok, recip, 1.0)).astype(np.float64)
    # the bound backs off from 2^63 by more than f64's spacing there
    # (2^10): a float-compared product a hair past it must be rejected,
    # never wrap int64
    inrange = (np.abs(np.trunc(vals)) * np.maximum(mult, 1.0)
               < COUNTER_CONTRIB_MAX - 4096.0)
    ok = finite & rate_ok & inrange
    if quarantine is not None and not ok.all():
        for reason, n in (("not_finite", (~finite).sum()),
                          ("bad_rate", (finite & ~rate_ok).sum()),
                          ("out_of_range", (finite & rate_ok
                                            & ~inrange).sum())):
            if n:
                quarantine.count(reason, int(n))
    return ok


def _scrub_float_batch(quarantine, vals, abs_max=None,
                       weights=None) -> np.ndarray:
    """Admissibility mask for bulk float samples. Gauges (float64 on the
    host) pass abs_max=None; digest staging passes abs_max=F32_ABS_MAX
    and the 1/rate weights, so a float64 value past float32's range is
    rejected instead of laundered into inf by the cast."""
    finite = np.isfinite(vals)
    ok = finite
    n_or = 0
    if abs_max is not None:
        inr = np.abs(vals) <= abs_max
        n_or = int((finite & ~inr).sum())
        ok = ok & inr
    n_br = 0
    if weights is not None:
        wok = np.isfinite(weights) & (weights > 0)
        n_br = int((ok & ~wok).sum())
        ok = ok & wok
    if quarantine is not None:
        for reason, n in (("not_finite", int((~finite).sum())),
                          ("out_of_range", n_or), ("bad_rate", n_br)):
            if n:
                quarantine.count(reason, n)
    return ok


class OverloadLimited:
    """Bounded cardinality and quarantine plumbing every store group
    shares. The knobs are class-attribute defaults (unbounded, inert):
    ``MetricStore`` stamps the instance attributes at construction and
    re-stamps each generation's fresh twin at the flush swap, so groups
    built directly (tests) behave as before.

    Past ``max_series`` (which INCLUDES the overflow row itself), or
    while the overload controller freezes first-sight series, a new
    series collapses into one per-group overflow row named
    ``veneur.overload.overflow`` tagged ``group:<name>``: counts are
    kept and flushed, identities dropped, and the planes stop growing.
    ``veneur.``-prefixed names are exempt from the freeze, not from the
    cap. ``spilled`` counts the interns the overflow row absorbed;
    ``scrubbed`` the samples rejected at the group boundary."""

    max_series = 0          # 0 = unbounded
    overflow_label = ""     # the group's attribute name, tags the row
    _overflow_type = "gauge"
    _overflow_row = -1
    spilled = 0
    scrubbed = 0
    _overload = None        # overload.OverloadController
    _quarantine: Optional[Quarantine] = None  # the store's shared ledger
    _compute = None         # resilience.compute.ComputeBreaker

    def _intern_row(self, key: MetricKey, tags: List[str]) -> int:
        """Interner hit -> its row; first sight -> a fresh row, or the
        overflow row past the cap or under an admission freeze. Callers
        still grow capacity when the returned row is new."""
        interner = self.interner
        row = interner.rows.get(key)
        if row is not None:
            return row
        ms = self.max_series
        if ms and len(interner) >= (ms if self._overflow_row >= 0
                                    else ms - 1):
            return self._spill_row()
        ctl = self._overload
        if (ctl is not None and ctl.freeze_new_series()
                and not freeze_exempt(key.name)):
            return self._spill_row()
        return interner.intern(key, tags)

    def _spill_row(self) -> int:
        if self._overflow_row < 0:
            tag = f"group:{self.overflow_label or 'unknown'}"
            okey = MetricKey(name=OVERFLOW_NAME, type=self._overflow_type,
                             joined_tags=tag)
            self._overflow_row = self.interner.intern(okey, [tag])
        self.spilled += 1
        return self._overflow_row

    def _quarantine_samples(self, reason: str, n: int = 1) -> None:
        self.scrubbed += n
        q = self._quarantine
        if q is not None:
            q.count(reason, n)

    def _live_index(self, n: int):
        """The device index of logical rows 0..n-1 in interner order:
        the first n rows here; the mesh groups' shard placement gathers
        (``core/mesh_store.py``)."""
        return slice(0, n)


class KernelBreakerOpen(RuntimeError):
    """The flush kernel's breaker is open: the digest unit goes straight
    to the store's re-merge rung without a launch."""


def kernel_rung(device) -> str:
    """The flush rung a device runs, as the timeline's ``rung`` note
    names it: ``cuda`` (the kernel) on a card, ``plain`` (the kernel's
    plain PyTorch version) on the CPU. The re-merge rung is ``requeue``
    (:meth:`MetricStore._requeue_group`)."""
    return "cuda" if device.type == "cuda" else "plain"


def begin_compute_ladder(compute, dispatch, collect, rung: str = "cuda"):
    """The flush kernel's ladder (``resilience/compute.py``) around one
    digest unit: ``dispatch()`` (the asynchronous launch) runs NOW when
    the breaker admits the kernel, and the returned ``finish()`` runs
    ``collect(pending)`` (the blocking device->host fetch). A failure in
    either phase is recorded on the breaker and raised, and a flush
    while the breaker is open raises :class:`KernelBreakerOpen` without
    launching: the store's failure edge then re-merges the retired group
    (rung 3). There is no plain-version rung: a CUDA tensor reaches the
    kernel or nothing.

    The re-merge starts from intact state: the flush program reads the
    digest and temp planes without changing them, and a launch the
    runtime refuses (``tdigest_cuda._raise_on``) leaves the context
    usable. A fault inside a running kernel is sticky: it poisons the
    context, the re-merge fails as well, and the interval is bounded by
    the last checkpoint. A completed fetch notes ``rung`` on the
    timeline's open stage."""
    if compute is None:
        pending = dispatch()

        def unguarded():
            out = collect(pending)
            obs_rec.note(rung=rung)
            return out

        return unguarded
    if not compute.probe():
        raise KernelBreakerOpen("the t-digest flush kernel's breaker is "
                                "open")
    try:
        compute.preflight()
        pending = dispatch()
    except Exception:
        compute.record_failure()
        raise

    def finish():
        try:
            out = collect(pending)
        except Exception:
            compute.record_failure()
            raise
        compute.record_success()
        obs_rec.note(rung=rung)
        return out

    return finish


def _snapshot_copies(tensors):
    """Device copies of ``tensors``, taken now (the caller holds the store
    lock), and a CUDA event recorded after them (None on the CPU). A
    slice would be a view that a later in-place ingest changes
    (``index_add_``, ``scatter_reduce_``); the copies are the state at
    the snapshot. A bfloat16 plane (the slab store's) is copied as
    float32, exactly, since numpy has no bfloat16."""
    copies = tuple(t.float() if t.dtype == torch.bfloat16 else t.clone()
                   for t in tensors)
    event = None
    if copies and copies[0].is_cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(copies[0].device))
    return copies, event


def _fetch_copies(copies, event) -> List[np.ndarray]:
    """The host arrays of :func:`_snapshot_copies`: waits for the copies
    alone, then fetches them (no lock held)."""
    if event is not None:
        event.synchronize()
    return [_to_host(t) for t in copies]


# ---------------------------------------------------------------------------
# Host-side scalar groups
# ---------------------------------------------------------------------------


class ScalarGroup(OverloadLimited):
    """Counters / gauges / status checks: host numpy state.

    kind: "counter" (int64 accumulate, samplers.go:141-143), "gauge"
    (float64 last-write, samplers.go:225-227) or "status" (a gauge plus
    the last message and hostname, samplers.go:307-313). Samples the
    typed lane cannot hold are rejected and counted."""

    def __init__(self, kind: str, capacity: int = DEFAULT_INITIAL_CAPACITY):
        if kind not in ("counter", "gauge", "status"):
            raise ValueError(f"unknown scalar kind {kind!r}")
        self.kind = kind
        self.interner = Interner()
        self.capacity = capacity
        self.values = np.zeros(capacity, np.int64 if kind == "counter"
                               else np.float64)
        self.messages: Optional[List[str]] = [] if kind == "status" else None
        self.hostnames: Optional[List[str]] = ([] if kind == "status"
                                              else None)

    def __len__(self):
        return len(self.interner)

    def _row(self, key: MetricKey, tags: List[str]) -> int:
        row = self._intern_row(key, tags)
        if row >= self.capacity:
            self.capacity *= _GROW_FACTOR
            self.values = np.concatenate(
                [self.values, np.zeros(self.capacity - len(self.values),
                                       self.values.dtype)])
        if self.messages is not None and row >= len(self.messages):
            self.messages.append("")
            self.hostnames.append("")
        return row

    def sample(self, key: MetricKey, tags: List[str], value: float,
               sample_rate: float, message: str = "", hostname: str = ""):
        if not math.isfinite(value):
            self._quarantine_samples("not_finite")
            return
        if self.kind == "counter":
            # Go semantics: value += int64(sample) * int64(1/rate), the
            # reciprocal a float32 division (samplers.go:141-143)
            if not MIN_SAMPLE_RATE <= sample_rate <= 1:
                self._quarantine_samples("bad_rate")
                return
            contrib = (int(value)
                       * int(np.float32(1.0) / np.float32(sample_rate)))
            if abs(contrib) >= COUNTER_CONTRIB_MAX:
                self._quarantine_samples("out_of_range")
                return
            row = self._row(key, tags)  # may grow (replace) values
            self.values[row] += contrib
        else:
            row = self._row(key, tags)
            self.values[row] = value
            if self.messages is not None:
                self.messages[row] = message
                self.hostnames[row] = hostname

    def ensure_capacity(self, max_row: int):
        """Grow so max_row is addressable (bulk paths bypass _row)."""
        while max_row >= self.capacity:
            self.capacity *= _GROW_FACTOR
        if self.capacity > len(self.values):
            self.values = np.concatenate(
                [self.values, np.zeros(self.capacity - len(self.values),
                                       self.values.dtype)])

    def add_many(self, rows: np.ndarray, contribs: np.ndarray):
        """Bulk counter accumulate; contribs already carry the truncating
        int64(value) * int64(1/rate) Go semantics."""
        np.add.at(self.values, rows, contribs)

    def set_many(self, rows: np.ndarray, vals: np.ndarray):
        """Bulk gauge write, last-write-wins per row in input order."""
        # fancy assignment leaves the order of duplicate indices
        # unspecified, so pick each row's last value explicitly
        urows, last = np.unique(rows[::-1], return_index=True)
        self.values[urows] = vals[::-1][last]

    def combine(self, key: MetricKey, tags: List[str], value: float):
        """Merge imported state: counters add, gauges overwrite
        (samplers.go:195-212, 276-289). Values the typed lane cannot
        hold are rejected; an out-of-range counter after its row is
        interned, as in the JAX package."""
        if not math.isfinite(value):
            self._quarantine_samples("not_finite")
            return
        row = self._row(key, tags)
        if self.kind == "counter":
            if abs(value) >= COUNTER_CONTRIB_MAX:
                self._quarantine_samples("out_of_range")
                return
            self.values[row] += int(value)
        else:
            self.values[row] = value

    def snapshot_and_reset(self):
        """(interner, values, messages, hostnames) of the interval, the
        group left empty; messages/hostnames are None but for status."""
        n = len(self.interner)
        interner, self.interner = self.interner, Interner()
        values = self.values[:n].copy()
        self.values[:] = 0
        messages, hostnames = self.messages, self.hostnames
        if messages is not None:
            self.messages, self.hostnames = [], []
        return interner, values, messages, hostnames

    def snapshot_begin(self):
        """Phase 1 of the two-phase snapshot (the caller holds the store
        lock): the host copy is the whole snapshot, so there is no fetch
        phase. Returns ``(snap, None)`` like the device groups."""
        n = len(self.interner)
        snap = {"kind": "scalar", "names": list(self.interner.names),
                "joined": list(self.interner.joined),
                "values": self.values[:n].copy()}
        if self.messages is not None:
            snap["messages"] = list(self.messages[:n])
            snap["hostnames"] = list(self.hostnames[:n])
        return snap, None

    def snapshot_state(self) -> dict:
        """Host copy of the live group WITHOUT resetting it."""
        return self.snapshot_begin()[0]

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


def _ingest_centroids(digest: td_ops.TDigest, temp: td_ops.TempCentroids,
                      dmin, dmax, rows, means, weights, stat_rows,
                      stat_mins, stat_maxs, compression):
    """Fold imported digest centroids into the bin accumulators WITHOUT
    touching the local scalar stats (samplers.go:473-480), shift-guarded
    like the sample path. Imported per-digest min/max land in dmin/dmax,
    which only bound the final digest. Updates temp, dmin and dmax in
    place; returns (digest, temp).

    The stat arrays are padded with row == capacity and +inf/-inf: the
    JAX package drops those rows with ``mode="drop"``; here they are
    masked to row 0 with the identity of the reduction."""
    digest, temp = td_ops.ingest_chunk_guarded(
        digest, temp, rows, means, weights, compression, update_stats=False)
    _scatter_extrema(dmin, dmax, stat_rows, stat_mins, stat_maxs)
    return digest, temp


def _scatter_extrema(dmin, dmax, rows, mins, maxs):
    """dmin[rows] = min(dmin[rows], mins), dmax likewise, in place;
    padding rows (== capacity) change nothing."""
    ok = rows < dmin.shape[0]
    r = torch.where(ok, rows, 0)
    dmin.scatter_reduce_(0, r, torch.where(ok, mins, math.inf), "amin")
    dmax.scatter_reduce_(0, r, torch.where(ok, maxs, -math.inf), "amax")


def _flush_digests(digest: td_ops.TDigest, temp: td_ops.TempCentroids,
                   dmin, dmax, qs, compression):
    """The per-interval flush program: one K1 launch drains and computes
    every percentile for the whole group (the Histo.Flush hot loop of
    samplers.go:511-636 over all series at once)."""
    drained, pcts = td_ops.drain_and_quantile(digest, temp, dmin, dmax, qs,
                                              compression)
    return (drained, pcts, temp.count, temp.vsum, temp.vmin, temp.vmax,
            temp.recip)


def _restore_temp_stats(temp: td_ops.TempCentroids, rows, count, vsum,
                        vmin, vmax, recip):
    """Fold a recovered interval's per-row scalar stats into the temp
    accumulators, in place (checkpoint restore). The centroid half of a
    restore rides the import path, which skips these (update_stats=False,
    samplers.go:473-480); without this a warm restart would keep the
    percentiles but lose the .count/.min/.max/.sum/.hmean emissions of
    the recovered samples."""
    temp.count.index_add_(0, rows, count)
    temp.vsum.index_add_(0, rows, vsum)
    temp.vmin.scatter_reduce_(0, rows, vmin, "amin")
    temp.vmax.scatter_reduce_(0, rows, vmax, "amax")
    temp.recip.index_add_(0, rows, recip)


def flatten_digest_state(mean: np.ndarray, weight: np.ndarray,
                         bin_w: np.ndarray, bin_wm: np.ndarray) -> dict:
    """Flatten [n, K] digest planes plus [n, K] pending temp bins into
    per-row centroid runs sorted by (row, mean): the layout
    :meth:`DigestGroup.import_centroids_bulk` takes back at restore.
    Pending bins become centroids at (sum_wm/sum_w, sum_w), as a drain
    would cluster them."""
    r1, c1 = np.nonzero(weight > 0)
    r2, c2 = np.nonzero(bin_w > 0)
    w2 = bin_w[r2, c2]
    rows = np.concatenate([r1, r2]).astype(np.int32)
    means = np.concatenate([mean[r1, c1],
                            bin_wm[r2, c2] / w2]).astype(np.float64)
    weights = np.concatenate([weight[r1, c1], w2]).astype(np.float64)
    order = np.lexsort((means, rows))
    return {"rows": rows[order], "means": means[order],
            "weights": weights[order]}


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _select_stats(want_stats) -> List[str]:
    """The per-row stat columns a flush fetches, in fetch order; None =
    all."""
    return [nm for nm in _STAT_NAMES
            if want_stats is None or nm in want_stats]


def _fill_stat_results(sel, cols, n: int, percentiles, out: dict) -> dict:
    """Map the fetched stat columns into a digest flush's result dict,
    zero-filling the unfetched ones: the aggregate mask that left them
    out of the fetch also gates their emission (:func:`_digest_want`).
    Shared by the dense, slab and tiered groups. The shared zeros array
    is read-only, so a stray in-place write cannot corrupt every key
    aliasing it."""
    got = dict(zip(sel, cols))
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


class DigestStaging(OverloadLimited):
    """The host staging every digest group shares (dense, slab and tiered
    storage): sample and import buffers padded with the out-of-range row
    ``self.capacity``, drained through the group's own ``_drain_samples``
    and ``_drain_imports`` when a chunk fills. ``_note_activity`` is the
    tiered group's hook (each staged row's interval activity)."""

    def _init_staging(self):
        self._new_sample_buffers()
        self._new_import_buffers()

    def _new_sample_buffers(self):
        # fresh host buffers per drain: a host->device copy may still be
        # reading the previous ones
        self._rows = np.full(self.chunk, self.capacity, np.int32)
        self._vals = np.zeros(self.chunk, np.float32)
        self._wts = np.zeros(self.chunk, np.float32)
        self._fill = 0

    def _new_import_buffers(self):
        self._imp_rows = np.full(self.chunk, self.capacity, np.int32)
        self._imp_means = np.zeros(self.chunk, np.float32)
        self._imp_wts = np.zeros(self.chunk, np.float32)
        self._imp_fill = 0
        # per-digest extrema; the sentinel padding (out-of-range row,
        # +inf/-inf) is the identity of the min/max scatter
        self._imp_stat_rows = np.full(self.chunk, self.capacity, np.int32)
        self._imp_stat_mins = np.full(self.chunk, np.inf, np.float32)
        self._imp_stat_maxs = np.full(self.chunk, -np.inf, np.float32)
        self._imp_stat_fill = 0

    def __len__(self):
        return len(self.interner)

    def _note_activity(self, rows, n: int) -> None:
        """Count ``n`` staged entries per row in ``rows`` (an int or an
        array); nothing but the tiered group keeps the count."""

    def sample_many(self, rows: np.ndarray, vals: np.ndarray,
                    wts: np.ndarray):
        """Bulk staging append of pre-interned rows: one numpy copy per
        span instead of a Python call per sample. Non-finite values and
        non-positive or non-finite weights are rejected."""
        vals = np.asarray(vals, np.float32)
        wts = np.asarray(wts, np.float32)
        ok = _scrub_float_batch(self._quarantine, vals, weights=wts)
        if not ok.all():
            self.scrubbed += int((~ok).sum())
            rows, vals, wts = rows[ok], vals[ok], wts[ok]
        self._note_activity(rows, 1)
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
        if not math.isfinite(value):
            self._quarantine_samples("not_finite")
            return
        if abs(value) > F32_ABS_MAX:
            self._quarantine_samples("out_of_range")
            return
        if not MIN_SAMPLE_RATE <= sample_rate <= 1:
            self._quarantine_samples("bad_rate")
            return
        row = self._row(key, tags)
        self._note_activity(row, 1)
        i = self._fill
        self._rows[i] = row
        self._vals[i] = value
        # float32 reciprocal, bit-identical to the JAX package's staging
        self._wts[i] = np.float32(1.0) / np.float32(sample_rate)
        self._fill = i + 1
        if self._fill == self.chunk:
            self._drain_samples()

    def import_centroids(self, key: MetricKey, tags: List[str],
                         means: np.ndarray, weights: np.ndarray,
                         dmin: float, dmax: float):
        """Merge a forwarded digest: its centroids re-enter the binning as
        weighted samples, the reference's Merge-by-re-adding-centroids
        (merging_digest.go:358-370) without the shuffle."""
        row = self._row(key, tags)
        n = len(means)
        self._note_activity(row, n)
        # keep one digest's sorted centroid run inside one staging drain:
        # a split run hands each drain a skewed half that the per-chunk
        # binning aliases (see import_centroids_bulk)
        if self._imp_fill + n > self.chunk and n <= self.chunk:
            self._drain_imports()
        start = 0
        while start < n:  # digests larger than one chunk span several drains
            if self._imp_fill == self.chunk:
                self._drain_imports()
            take = min(self.chunk - self._imp_fill, n - start)
            i = self._imp_fill
            self._imp_rows[i:i + take] = row
            self._imp_means[i:i + take] = means[start:start + take]
            self._imp_wts[i:i + take] = weights[start:start + take]
            self._imp_fill = i + take
            start += take
        if math.isfinite(dmin):
            i = self._imp_stat_fill
            self._imp_stat_rows[i] = row
            self._imp_stat_mins[i] = dmin
            self._imp_stat_maxs[i] = dmax
            self._imp_stat_fill = i + 1
            # zero-centroid imports never advance _imp_fill, so the stat
            # buffers need their own drain bound
            if self._imp_stat_fill == self.chunk:
                self._drain_imports()

    def import_centroids_bulk(self, rows: np.ndarray, means: np.ndarray,
                              weights: np.ndarray, stat_rows, stat_mins,
                              stat_maxs):
        """Bulk staging append for the import path (rows pre-interned by
        the caller; the JAX package's ``bulk_stage_import_centroids``):
        span copies into the import buffers, draining when either the
        centroid buffer or the stat buffers fill.

        Drains align to ROW-RUN boundaries: a row's centroids arrive as
        one sorted-by-mean run, and splitting that run across two drains
        hands each drain a skewed half that the per-chunk quantile
        binning aliases into the same bins. Only a run longer than a
        whole chunk (never a digest: a run is <= K centroids) splits."""
        n = len(rows)
        self._note_activity(rows, 1)
        # equal-row run boundaries, so span copies stay O(n / chunk)
        if n:
            run_ends = np.concatenate(
                (np.flatnonzero(rows[1:] != rows[:-1]) + 1, [n]))
        else:
            run_ends = np.empty(0, np.int64)
        start = 0
        while start < n:
            if self._imp_fill == self.chunk:
                self._drain_imports()
            avail = self.chunk - self._imp_fill
            limit = start + avail
            if limit >= n:
                end = n
            else:
                # the largest run boundary that fits; a run longer than
                # the space left drains first (partial buffer) or, when
                # longer than a whole chunk, splits as a last resort
                j = int(np.searchsorted(run_ends, limit, "right"))
                end = int(run_ends[j - 1]) if j > 0 else 0
                if end <= start:
                    if avail < self.chunk:
                        self._drain_imports()
                        continue
                    end = limit
            take = end - start
            i = self._imp_fill
            self._imp_rows[i:i + take] = rows[start:end]
            self._imp_means[i:i + take] = means[start:end]
            self._imp_wts[i:i + take] = weights[start:end]
            self._imp_fill = i + take
            start = end
        ns = len(stat_rows)
        pos = 0
        while pos < ns:
            if self._imp_stat_fill == self.chunk:
                self._drain_imports()
            take = min(self.chunk - self._imp_stat_fill, ns - pos)
            i = self._imp_stat_fill
            self._imp_stat_rows[i:i + take] = stat_rows[pos:pos + take]
            self._imp_stat_mins[i:i + take] = stat_mins[pos:pos + take]
            self._imp_stat_maxs[i:i + take] = stat_maxs[pos:pos + take]
            self._imp_stat_fill = i + take
            pos += take
        if (self._imp_fill == self.chunk
                or self._imp_stat_fill == self.chunk):
            self._drain_imports()

    def _drain_staging(self):
        self._drain_samples()
        self._drain_imports()

    def _drop_staging(self):
        """Release a RETIRED group's host staging: a stray drain on the
        dead group is then a no-op, and it allocates nothing."""
        self._rows = self._vals = self._wts = None
        self._imp_rows = self._imp_means = self._imp_wts = None
        self._imp_stat_rows = self._imp_stat_mins = None
        self._imp_stat_maxs = None
        self._fill = self._imp_fill = self._imp_stat_fill = 0


class DigestGroup(DigestStaging):
    """One scope-class of histograms/timers as a dense t-digest batch."""

    # set by MetricStore._swap_generation: a retired group's flush drops
    # its device state instead of reallocating it
    _retired = False
    # the storage its profiler scopes name (drain.digest.<_SCOPE>,
    # flush.digest.<_SCOPE>; obs/kernels.py PROGRAM_SCOPES)
    _SCOPE = "dense"

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
        self._init_device()
        self._init_staging()

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

    def _row(self, key: MetricKey, tags: List[str]) -> int:
        row = self._intern_row(key, tags)
        if row >= self.capacity:
            self._grow()
        return row

    def _grow(self):
        self._drain_staging()
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
        self._imp_rows[self._imp_fill:] = self.capacity
        self._imp_stat_rows[self._imp_stat_fill:] = self.capacity

    def ensure_capacity(self, max_row: int):
        """Grow so max_row is addressable (bulk paths bypass _row)."""
        while max_row >= self.capacity:
            self._grow()

    def fresh(self) -> "DigestGroup":
        """Empty same-config twin with newly allocated planes. Carries the
        grown capacity so a steady cardinality never re-grows."""
        return DigestGroup(self.capacity, self.chunk, self.compression,
                           self.device)

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
        with obs_kernels.scope(f"drain.digest.{self._SCOPE}", dev):
            self.digest, self.temp = _ingest_samples(
                self.digest, self.temp,
                torch.from_numpy(rows).to(dev).long(),
                torch.from_numpy(vals).to(dev),
                torch.from_numpy(wts).to(dev), self.compression)

    def _drain_imports(self):
        """One staged import chunk through ``_ingest_centroids`` (the
        shift guard may drain the bins through K2 here). A stat-only
        drain (zero-centroid digests) scatters just the extrema: a chunk
        of padding alone would add nothing to the bins."""
        if self._imp_fill == 0 and self._imp_stat_fill == 0:
            return
        self._device_dirty = True
        # pow2 prefixes of the sentinel-padded buffers (see _drain_samples)
        n = pow2_cap(self._imp_fill) if self._imp_fill else 0
        ns = pow2_cap(self._imp_stat_fill)
        staged = (self._imp_rows[:n], self._imp_means[:n], self._imp_wts[:n],
                  self._imp_stat_rows[:ns], self._imp_stat_mins[:ns],
                  self._imp_stat_maxs[:ns])
        self._new_import_buffers()
        rows, means, wts, srows, smins, smaxs = (
            torch.from_numpy(a).to(self.device) for a in staged)
        with obs_kernels.scope(f"drain.digest.{self._SCOPE}",
                                self.device):
            if n:
                self.digest, self.temp = _ingest_centroids(
                    self.digest, self.temp, self.dmin, self.dmax,
                    rows.long(), means, wts, srows.long(), smins, smaxs,
                    self.compression)
            else:
                _scatter_extrema(self.dmin, self.dmax, srows.long(), smins,
                                 smaxs)

    def flush(self, percentiles: List[float], want_digests=False,
              want_stats=None):
        """Run the flush program; returns (interner, host result dict) and
        resets the group. ``want_stats`` (None = all) selects the per-row
        stat columns fetched; ``want_digests`` (a forwarding flush) also
        fetches the drained digests: True their mean/weight planes and
        extrema, ``"packed"`` only their live centroids, compacted and
        quantized on the device (``core/slab.py``), and the extrema."""
        return self.flush_begin(percentiles, want_digests, want_stats)()

    def flush_begin(self, percentiles: List[float], want_digests=False,
                    want_stats=None):
        """Two-phase flush: drain staging and DISPATCH the flush program
        now (kernel launches are asynchronous), and return a ``finish()``
        whose device->host copy blocks later, so the store can dispatch
        every group before any fetch waits. ``finish()`` returns
        ``(interner, out)`` and only then resets the group. The program
        runs through the compute ladder (:func:`begin_compute_ladder`):
        a kernel failure in either phase raises with the group intact,
        for the store's re-merge rung."""
        self._drain_staging()
        n = len(self.interner)
        if n == 0:
            res = self._flush_empty()
            return lambda: res
        fin = begin_compute_ladder(
            self._compute,
            lambda: self._flush_dispatch(n, percentiles, want_digests,
                                         want_stats),
            lambda pending: self._flush_collect(pending, n, percentiles),
            kernel_rung(self.device))
        return lambda: self._flush_commit(fin())

    def _flush_empty(self):
        interner, self.interner = self.interner, Interner()
        if self._retired:
            self._drop_device()
        elif self._device_dirty:
            self._init_device()
            self._init_staging()
        return interner, {}

    def _flush_commit(self, out: dict):
        interner, self.interner = self.interner, Interner()
        if self._retired:
            self._drop_device()
        else:
            self._init_device()
            self._init_staging()
        return interner, out

    def _flush_dispatch(self, n: int, percentiles, want_digests,
                        want_stats):
        """Enqueue the flush program (K1) and, for a forwarding flush,
        the pack or the plane slices: the ``compute`` stage of the
        timeline, under the ``flush.digest.dense`` scope."""
        sel = _select_stats(want_stats)
        with obs_rec.maybe_stage("compute"), \
                obs_kernels.scope(f"flush.digest.{self._SCOPE}",
                                  self.device):
            qs = torch.tensor(list(percentiles) + [0.5],
                              dtype=torch.float32, device=self.device)
            digest, pcts, count, vsum, vmin, vmax, recip = _flush_digests(
                self.digest, self.temp, self.dmin, self.dmax, qs,
                self.compression)
            stats = {"pcts": pcts, "count": count, "sum": vsum,
                     "min": vmin, "max": vmax, "recip": recip}
            if want_digests == "packed":
                # the pack runs on the whole capacity, as JAX's
                # _pack_slab on the slab; the fetch takes the first n
                from veneur_tpu_torch.core import slab

                planes = ("packed",) + slab._pack_slab(
                    digest.mean, digest.weight, digest.min, digest.max) + (
                    digest.min[:n], digest.max[:n])
                live = slice(0, n)
            else:
                live = self._live_index(n)
                planes = (("dense", digest.mean[live], digest.weight[live],
                           digest.min[live], digest.max[live])
                          if want_digests else ())
            return sel, tuple(stats[nm][live] for nm in sel), planes

    def _flush_collect(self, pending, n: int, percentiles) -> dict:
        """The blocking device->host fetch: the ``fetch`` stage."""
        sel, refs, planes = pending
        with obs_rec.maybe_stage("fetch"):
            out = _fill_stat_results(sel, [_to_host(t) for t in refs], n,
                                     percentiles, {})
            if planes:
                out.update(self._fetch_planes(planes, n))
        return out

    @staticmethod
    def _fetch_planes(planes, n: int) -> dict:
        """The drained digests a forwarding flush ships, copied to the
        host: dense, the [n, K] mean and weight planes; packed, the live
        centroids (``packed_counts``/``_means``/``_weights``, see
        PackedDigestPlanes); both with the [n] extrema."""
        kind, *refs = planes
        if kind == "packed":
            from veneur_tpu_torch.core import slab

            counts, q_pref, wb_pref, dmin, dmax = refs
            pc, pm, pw = slab._fetch_packed(counts, q_pref, wb_pref, n)
            return {"packed_counts": pc, "packed_means": pm,
                    "packed_weights": pw, "digest_min": _to_host(dmin),
                    "digest_max": _to_host(dmax)}
        mean, weight, dmin, dmax = (_to_host(t) for t in refs)
        return {"digest_mean": mean, "digest_weight": weight,
                "digest_min": dmin, "digest_max": dmax}

    def _drop_device(self):
        """Free a retired generation's device state and staging buffers."""
        self.digest = self.temp = self.dmin = self.dmax = None
        self._device_dirty = False
        self._drop_staging()

    def snapshot_begin(self):
        """Phase 1 of the two-phase snapshot (the caller holds the store
        lock): drain staging, then copy every live plane on the device
        (:func:`_snapshot_copies`). The returned ``finish`` fetches the
        copies and flattens them off-lock, completing ``snap`` in place;
        ingest that runs meanwhile cannot change what it reads."""
        self._drain_staging()
        n = len(self.interner)
        snap = {"kind": "digest", "names": list(self.interner.names),
                "joined": list(self.interner.joined)}
        if n == 0:
            return snap, None
        d, t, live = self.digest, self.temp, self._live_index(n)
        copies, event = _snapshot_copies(tuple(x[live] for x in (
            d.mean, d.weight, t.sum_w, t.sum_wm, self.dmin, self.dmax,
            d.min, d.max, t.count, t.vsum, t.vmin, t.vmax, t.recip)))

        def finish():
            (mean, weight, bin_w, bin_wm, imp_min, imp_max, dmn, dmx, cnt,
             vsum, vmin, vmax, recip) = _fetch_copies(copies, event)
            snap.update(flatten_digest_state(mean, weight, bin_w, bin_wm))
            # digest-bound extrema (the import path's stat arguments); the
            # interval's observed extrema travel as the temp stats
            snap["mins"] = np.minimum(imp_min, dmn)
            snap["maxs"] = np.maximum(imp_max, dmx)
            for nm, arr in (("count", cnt), ("vsum", vsum), ("vmin", vmin),
                            ("vmax", vmax), ("recip", recip)):
                snap[nm] = np.asarray(arr, np.float32)

        return snap, finish

    def snapshot_state(self) -> dict:
        """Host copy of the live sketch state WITHOUT resetting it: the
        digest centroids plus the pending bins as per-row runs, and the
        interval's scalar stats beside them, so a restore rebuilds the
        sketch and the local aggregates. Begin and finish in one call,
        for a caller that owns the group (the re-merge rung, tests)."""
        snap, finish = self.snapshot_begin()
        if finish is not None:
            finish()
        return snap

    def restore_stats(self, rows: np.ndarray, count: np.ndarray,
                      vsum: np.ndarray, vmin: np.ndarray, vmax: np.ndarray,
                      recip: np.ndarray):
        """Fold recovered per-row scalar stats into the temp accumulators
        (see :func:`_restore_temp_stats`)."""
        if not len(rows):
            return
        self.ensure_capacity(int(rows.max()))
        self._device_dirty = True
        dev = self.device

        def f32(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
                dev)

        _restore_temp_stats(
            self.temp, torch.from_numpy(rows.astype(np.int64)).to(dev),
            f32(count), f32(vsum), f32(vmin), f32(vmax), f32(recip))


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


def _merge_registers(registers, rows: np.ndarray, updates: np.ndarray):
    """registers[rows] = max(registers[rows], updates) in place: the
    elementwise register max of Set.Combine (samplers.go:423-435). Rows
    repeated in one batch max-combine on the host first, so the device
    write sees each row once."""
    order = np.argsort(rows, kind="stable")
    rows, updates = rows[order], updates[order]
    starts = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]])
    if len(starts) < len(rows):
        ends = np.r_[starts[1:], len(rows)]
        updates = np.stack([updates[s:e].max(axis=0)
                            for s, e in zip(starts, ends)])
    idx = torch.from_numpy(rows[starts].astype(np.int64)).to(
        registers.device)
    upd = torch.from_numpy(updates.view(np.int8)).to(registers.device)
    registers[idx] = torch.maximum(registers[idx], upd)


class SetGroup(OverloadLimited):
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
        self._init_staging()

    def _init_staging(self):
        self._new_sample_buffers()
        self._imp_rows: List[int] = []
        self._imp_regs: List[np.ndarray] = []

    def _new_sample_buffers(self):
        self._rows = np.full(self.chunk, self.capacity, np.int32)
        self._hi = np.zeros(self.chunk, np.uint32)
        self._lo = np.zeros(self.chunk, np.uint32)
        self._fill = 0

    def __len__(self):
        return len(self.interner)

    def _row(self, key: MetricKey, tags: List[str]) -> int:
        row = self._intern_row(key, tags)
        if row >= self.capacity:
            self._grow()
        return row

    def _grow(self):
        self._drain_staging()
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

    def import_registers(self, key: MetricKey, tags: List[str],
                         registers: np.ndarray):
        """Merge a forwarded sketch: elementwise register max
        (samplers.go:423-435). A precision mismatch raises for this
        metric alone (cf. Set.Combine's error), never for the batch."""
        registers = self._checked(registers)
        self.import_registers_row(self._row(key, tags), registers)

    def _checked(self, registers) -> np.ndarray:
        registers = np.asarray(registers)
        if registers.shape != (self.m,):
            raise ValueError(
                f"HLL precision mismatch: got {registers.shape}, "
                f"want ({self.m},)")
        return registers

    def import_registers_row(self, row: int, registers: np.ndarray):
        """Row-addressed variant for the columnar import (the row came
        from the C++ MetricList table); the same precision check."""
        registers = self._checked(registers)
        self._imp_rows.append(row)
        self._imp_regs.append(registers)
        if len(self._imp_rows) >= IMPORT_DRAIN_BATCH:
            self._drain_imports()

    def _drain_imports(self):
        if not self._imp_rows:
            return
        self._device_dirty = True
        _merge_registers(self.registers, np.asarray(self._imp_rows, np.int64),
                         np.stack(self._imp_regs).astype(np.uint8))
        self._imp_rows.clear()
        self._imp_regs.clear()

    def _drain_staging(self):
        self._drain_samples()
        self._drain_imports()

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

    def flush(self, want_estimates: bool = True,
              want_registers: bool = False):
        return self.flush_begin(want_estimates, want_registers)()

    def flush_begin(self, want_estimates: bool = True,
                    want_registers: bool = False):
        """Two-phase flush: the estimate is dispatched now and the live
        rows' registers are sliced (the reset below allocates a new plane
        and never writes the old one); ``finish()`` copies both to the
        host and returns
        ``(interner, estimates, registers)``. A local estimates its local
        sets and forwards the registers of its mixed ones; a flush that
        wants neither skips both."""
        self._drain_staging()
        n = len(self.interner)
        interner, self.interner = self.interner, Interner()
        if n == 0:
            if self._retired:
                self.registers = None
            elif self._device_dirty:
                self._reset_registers()
                self._init_staging()
            return lambda: (interner, None, None)
        live = (self.registers[self._live_index(n)]
                if want_estimates or want_registers else None)
        est_ref = _estimate_all(live) if want_estimates else None
        reg_ref = live if want_registers else None
        if self._retired:
            self.registers = None
        else:
            self._reset_registers()
            self._init_staging()

        def finish():
            with obs_rec.maybe_stage("fetch"):
                est = _to_host(est_ref) if est_ref is not None else None
                regs = (_to_host(reg_ref).view(np.uint8)
                        if reg_ref is not None else None)
            return interner, est, regs

        return finish

    def _reset_registers(self):
        self.registers = torch.zeros((self.capacity, self.m),
                                     dtype=torch.int8, device=self.device)
        self._device_dirty = False

    def snapshot_begin(self):
        """Phase 1 of the two-phase snapshot: drain staging and copy the
        live rows' registers on the device under the store lock; the
        returned ``finish`` fetches them off-lock (see
        ``DigestGroup.snapshot_begin``)."""
        self._drain_staging()
        n = len(self.interner)
        snap = {"kind": "set", "precision": self.precision,
                "names": list(self.interner.names),
                "joined": list(self.interner.joined)}
        if n == 0:
            return snap, None
        copies, event = _snapshot_copies(
            (self.registers[self._live_index(n)],))

        def finish():
            (regs,) = _fetch_copies(copies, event)
            snap["registers"] = regs.view(np.uint8)

        return snap, finish

    def snapshot_state(self) -> dict:
        """Host copy of the live registers WITHOUT resetting; begin and
        finish in one call."""
        snap, finish = self.snapshot_begin()
        if finish is not None:
            finish()
        return snap


# ---------------------------------------------------------------------------
# Device-side heavy hitters (count-min + top-k)
# ---------------------------------------------------------------------------


class HeavyHitterGroup(OverloadLimited):
    """Set-type metrics tagged ``veneurtopk``: instead of a cardinality,
    count per-member frequencies in one shared salted count-min table
    (``ops/countmin.py``) and keep a per-series top-k list.

    A flush emits ``{name}.topk`` counters tagged ``key:<member>`` for
    each surviving heavy hitter. Member strings are memoized on the host
    (the sketch sees only 64-bit hashes); the memo is bounded and an
    unknown hash emits as hex, so key cardinality cannot exhaust host
    memory. Across instances, a local forwards (table, top-k candidates,
    members) as the JSON ``topk_sketch`` entry, and the global adds the
    tables and re-ranks the fleet top-k (:meth:`import_sketch`). The
    count-min update runs only under the store lock, on whichever
    thread drains the group's staging."""

    MEMO_LIMIT = 1 << 20
    _retired = False  # see DigestGroup._retired

    def __init__(self, capacity: int = DEFAULT_INITIAL_CAPACITY,
                 chunk: int = DEFAULT_CHUNK, depth: int = 4,
                 width: int = 1 << 16, k: int = 32, device=None):
        self.device = resolve_device(device)
        self.interner = Interner()
        self.capacity = capacity
        self.chunk = chunk
        self.depth, self.width, self.k = depth, width, k
        self.sketch = cm_ops.init(capacity, depth, width, k, self.device)
        self._device_dirty = False
        self._members: Dict[int, str] = {}
        # the drain's update, instance-bound so a caller can time it (a
        # fresh twin carries the wrapper)
        self._update = cm_ops.update
        # stable per-row series ids (+1 slot for the staging sentinel);
        # see CountMin.sids for why these must be instance-independent
        self._sids_np = np.zeros(capacity + 1, np.uint32)
        self._new_sample_buffers()

    def fresh(self) -> "HeavyHitterGroup":
        """Empty same-config twin (swap-on-flush generation swap)."""
        g = HeavyHitterGroup(self.capacity, self.chunk, self.depth,
                             self.width, self.k, self.device)
        g._update = self._update
        return g

    def _new_sample_buffers(self):
        self._rows = np.full(self.chunk, self.capacity, np.int32)
        self._hi = np.zeros(self.chunk, np.uint32)
        self._lo = np.zeros(self.chunk, np.uint32)
        self._wts = np.zeros(self.chunk, np.float32)
        self._fill = 0

    def __len__(self):
        return len(self.interner)

    @staticmethod
    def stable_sid(name: str, joined_tags: str) -> int:
        """Instance-independent 32-bit series id: fnv1a over the series
        identity. Every instance derives the same sid for the same
        series, as the table's columns are salted with it."""
        h = 2166136261
        for b in f"{name}|set|{joined_tags}".encode("utf-8"):
            h = ((h ^ b) * 16777619) & 0xFFFFFFFF
        return h

    def _row(self, key: MetricKey, tags: List[str]) -> int:
        row = self._intern_row(key, tags)
        if row >= self.capacity:
            self.ensure_capacity(row)
        if self._sids_np[row] == 0:  # first sight (or the 2^-32 rehash)
            # the sid comes from the row's INTERNED identity: past the cap
            # the row is the overflow row and hashes as such everywhere
            self._sids_np[row] = self.stable_sid(self.interner.names[row],
                                                 self.interner.joined[row])
        return row

    def ensure_capacity(self, max_row: int):
        while max_row >= self.capacity:
            self._drain_samples()
            old = self.capacity
            self.capacity *= _GROW_FACTOR
            pad = self.capacity - old
            sk = self.sketch
            for name in ("topk_hi", "topk_lo", "topk_counts"):
                t = getattr(sk, name)
                setattr(sk, name, torch.cat([t, t.new_zeros((pad, self.k))]))
            sk.sids = torch.cat([sk.sids, sk.sids.new_zeros(pad)])
            sids = np.zeros(self.capacity + 1, np.uint32)
            sids[:old + 1] = self._sids_np
            sids[old] = 0  # the old sentinel slot is now a real row
            self._sids_np = sids
            self._rows[self._fill:] = self.capacity

    def _memoize(self, h: int, member: str):
        if len(self._members) < self.MEMO_LIMIT:
            self._members[h] = member

    def sample(self, key: MetricKey, tags: List[str], member: str,
               weight: float = 1.0):
        row = self._row(key, tags)
        h = hll_ops.hash_member(member.encode("utf-8"))
        self._memoize(h, member)
        i = self._fill
        self._rows[i] = row
        self._hi[i] = h >> 32
        self._lo[i] = h & 0xFFFFFFFF
        self._wts[i] = weight
        self._fill = i + 1
        if self._fill == self.chunk:
            self._drain_samples()

    def sample_many(self, rows: np.ndarray, hashes: np.ndarray,
                    members=None):
        """Bulk append of pre-interned rows and pre-hashed members
        (uint64); ``members`` (bytes) feed the member memo."""
        if members is not None:
            for h, mb in zip(hashes.tolist(), members):
                self._memoize(h, mb.decode("utf-8", "replace"))
        his, los = hll_ops.split_hashes(hashes)
        n = len(rows)
        start = 0
        while start < n:
            if self._fill == self.chunk:
                self._drain_samples()
            take = min(self.chunk - self._fill, n - start)
            i = self._fill
            self._rows[i:i + take] = rows[start:start + take]
            self._hi[i:i + take] = his[start:start + take]
            self._lo[i:i + take] = los[start:start + take]
            self._wts[i:i + take] = 1.0
            self._fill = i + take
            start += take
        if self._fill == self.chunk:
            self._drain_samples()

    def _drain_samples(self):
        if self._fill == 0:
            return
        self._device_dirty = True
        rows, hi, lo, wts = self._rows, self._hi, self._lo, self._wts
        self._new_sample_buffers()
        dev = self.device
        # 32-bit words travel as their int32 bit patterns
        self.sketch = self._update(
            self.sketch, torch.from_numpy(rows).to(dev),
            torch.from_numpy(self._sids_np[rows].view(np.int32)).to(dev),
            torch.from_numpy(hi.view(np.int32)).to(dev),
            torch.from_numpy(lo.view(np.int32)).to(dev),
            torch.from_numpy(wts).to(dev))

    def _drain_staging(self):
        self._drain_samples()

    def import_sketch(self, table: np.ndarray, series: List[tuple]):
        """Merge a forwarded heavy-hitter sketch: the count-min table adds
        elementwise, and each series' forwarded top-k keys become
        candidates re-estimated against the combined table.

        table: [depth, width] float32 (the shape must match: both ends
        run the same config). series: [(key, tags, [(hi, lo), ...],
        [member-or-None, ...])]."""
        table = np.asarray(table)
        if table.shape != (self.depth, self.width):
            raise ValueError(
                f"forwarded count-min shape {table.shape} != local "
                f"({self.depth}, {self.width})")
        self._drain_samples()  # candidates estimate against a settled table
        self._device_dirty = True
        rows, sids, his, los, slots = [], [], [], [], []
        for key, tags, keys, members in series:
            row = self._row(key, list(tags))
            sid = int(self._sids_np[row])
            for j, (hi, lo) in enumerate(keys):
                rows.append(row)
                sids.append(sid)
                his.append(hi)
                los.append(lo)
                slots.append(j)
                if members and j < len(members) and members[j]:
                    self._memoize((int(hi) << 32) | int(lo), members[j])
        dev = self.device
        self.sketch = cm_ops.add_table(
            self.sketch, torch.from_numpy(np.array(table, np.float32)))

        def words(v):
            return torch.from_numpy(np.asarray(v, np.uint32).view(
                np.int32)).to(dev)

        if rows:
            self.sketch = cm_ops.inject_candidates(
                self.sketch, torch.from_numpy(self._scatter_rows(
                    np.asarray(rows, np.int64))).to(dev),
                words(sids), words(his), words(los),
                torch.tensor(slots, dtype=torch.int64, device=dev))

    def flush(self, want_forward: bool = False):
        """Returns (interner, [(row, member, count), ...], forwardable)
        and resets. forwardable is None unless want_forward: then it is
        (table ndarray, [(name, tags, [(hi, lo)...], [member...])])."""
        return self.flush_begin(want_forward)()

    def flush_begin(self, want_forward: bool = False):
        """Two-phase flush: the live top-k plane slices (and the table,
        when forwarding) are taken now and the group resets at once;
        ``finish()`` copies them to the host and assembles the member
        emissions."""
        self._drain_samples()
        n = len(self.interner)
        interner, self.interner = self.interner, Interner()
        if n == 0 and not self._device_dirty:
            # pristine sketch: skip the device reallocation entirely
            return lambda: (interner, [], None)
        refs = self._live_topk(n) if n else None
        table_ref = self.sketch.table if (n and want_forward) else None
        members, self._members = self._members, {}
        if self._retired:
            self.sketch = None  # never reused
        else:
            self._reset_sketch()
            self._sids_np = np.zeros(self.capacity + 1, np.uint32)
            self._new_sample_buffers()
        self._device_dirty = False

        def finish():
            out = []
            fwd = None
            if n:
                with obs_rec.maybe_stage("fetch"):
                    hi, lo, ct = (_to_host(t) for t in refs)
                hi, lo = hi.view(np.uint32), lo.view(np.uint32)
                # the live slots in (row, slot) order, as the reference's
                # row-by-row loop visits them
                live_r, live_c = np.nonzero(ct > 0)
                his = hi[live_r, live_c].tolist()
                los = lo[live_r, live_c].tolist()
                cts = ct[live_r, live_c].tolist()
                by_row = {} if want_forward else None
                for row, h32, l32, c in zip(live_r.tolist(), his, los, cts):
                    h = (h32 << 32) | l32
                    member = members.get(h)
                    out.append((row, member or f"0x{h:016x}", c))
                    if by_row is not None:
                        keys, mems = by_row.setdefault(row, ([], []))
                        keys.append((h32, l32))
                        mems.append(member)
                if want_forward:
                    with obs_rec.maybe_stage("fetch"):
                        table = _to_host(table_ref)
                    fwd = (table, [
                        (key.name, interner.tags[row]) + by_row[row]
                        for key, row in interner.rows.items()
                        if row in by_row])
            return interner, out, fwd

        return finish

    def _scatter_rows(self, rows: np.ndarray) -> np.ndarray:
        """The device rows of logical rows (the mesh group's placement
        translates them)."""
        return rows

    def _live_topk(self, n: int):
        """The live rows' top-k planes, interner order."""
        live = self._live_index(n)
        return (self.sketch.topk_hi[live], self.sketch.topk_lo[live],
                self.sketch.topk_counts[live])

    def _reset_sketch(self):
        self.sketch = cm_ops.init(self.capacity, self.depth, self.width,
                                  self.k, self.device)

    def snapshot_begin(self):
        """Phase 1 of the two-phase snapshot: copy the live top-k planes
        and the count-min table on the device and the host member memo,
        all under the store lock; the returned ``finish`` fetches and
        assembles them off-lock (see ``DigestGroup.snapshot_begin``)."""
        self._drain_samples()
        n = len(self.interner)
        snap = {"kind": "topk", "depth": self.depth, "width": self.width,
                "names": list(self.interner.names),
                "joined": list(self.interner.joined)}
        if n == 0:
            return snap, None
        copies, event = _snapshot_copies(self._live_topk(n)
                                         + (self.sketch.table,))
        members = dict(self._members)

        def finish():
            hi, lo, ct, table = _fetch_copies(copies, event)
            hi, lo = hi.view(np.uint32), lo.view(np.uint32)
            snap["table"] = np.asarray(table, np.float32)
            live_r, live_c = np.nonzero(ct > 0)
            series = [{"keys": [], "members": []} for _ in range(n)]
            for r, h32, l32 in zip(live_r.tolist(),
                                   hi[live_r, live_c].tolist(),
                                   lo[live_r, live_c].tolist()):
                s = series[r]
                s["keys"].append((h32, l32))
                s["members"].append(members.get((h32 << 32) | l32))
            snap["series"] = series

        return snap, finish

    def snapshot_state(self) -> dict:
        """Host copy of the live sketch WITHOUT resetting: the count-min
        table plus each series' top-k candidates in the
        :meth:`import_sketch` layout; begin and finish in one call."""
        snap, finish = self.snapshot_begin()
        if finish is not None:
            finish()
        return snap


_DIGEST_GROUPS = ("histograms", "timers", "local_histograms", "local_timers")
_SET_GROUPS = ("sets", "local_sets")


class PackedDigestPlanes(NamedTuple):
    """Device-packed digest planes for the forward path: only the live
    centroids, 4 bytes each (a u16 range-quantized mean and a u16
    bfloat16 weight), packed on the device by ``core/slab.py``
    ``_pack_slab``, so a million-series forward never fetches the raw
    [S, K] float32 planes. Row r owns
    ``means_q[starts[r]:starts[r] + counts[r]]``, with
    ``mean = dmin[r] + q/65535 * (dmax[r] - dmin[r])``."""

    counts: np.ndarray      # [S] u16 live centroids a row
    means_q: np.ndarray     # [L] u16 quantized means
    weights_bf: np.ndarray  # [L] u16 bfloat16 bit patterns
    dmin: np.ndarray        # [S] f32 digest minima (+inf when empty)
    dmax: np.ndarray        # [S] f32 digest maxima (-inf when empty)

    @property
    def nrows(self) -> int:
        return len(self.counts)

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in self)

    def weights_f32(self) -> np.ndarray:
        return (self.weights_bf.astype(np.uint32) << 16).view(np.float32)

    def means_f64(self) -> np.ndarray:
        """Dequantized means, flat over all rows in row order."""
        counts = self.counts.astype(np.int64)
        span = (self.dmax.astype(np.float64)
                - self.dmin.astype(np.float64)) / 65535.0
        base = np.repeat(self.dmin.astype(np.float64), counts)
        return base + self.means_q.astype(np.float64) * np.repeat(span,
                                                                  counts)

    def row_slices(self):
        """(starts, ends, means f64 [L], weights f64 [L]): row r's
        centroids are ``means[starts[r]:ends[r]]``; the one place the
        quantization is decoded on the host."""
        counts = self.counts.astype(np.int64)
        ends = np.cumsum(counts)
        return (ends - counts, ends, self.means_f64(),
                self.weights_f32().astype(np.float64))


def _packed_planes_from_result(r: dict) -> PackedDigestPlanes:
    """The PackedDigestPlanes of a group's packed flush result."""
    return PackedDigestPlanes(
        r["packed_counts"], r["packed_means"], r["packed_weights"],
        np.asarray(r["digest_min"], np.float32),
        np.asarray(r["digest_max"], np.float32))


@dataclass
class MetricsSummary:
    """Per-flush tallies (flusher.go:121-132) the flusher's
    ``veneur.worker.*`` and ``veneur.overload.*`` self-metrics read
    (``MetricStore.last_summary``): the mixed groups' series, the
    interval's ingest counts, and each group's overflow spills (only
    groups with some)."""

    counters: int = 0
    gauges: int = 0
    histograms: int = 0
    sets: int = 0
    timers: int = 0
    processed: int = 0
    imported: int = 0
    spilled: Dict[str, int] = field(default_factory=dict)


def _summarize(g) -> MetricsSummary:
    """The summary of a retired generation."""
    return MetricsSummary(
        **{name: len(getattr(g, name)) for name in (
            "counters", "gauges", "histograms", "sets", "timers")},
        processed=g.processed, imported=g.imported,
        spilled={n: getattr(g, n).spilled for n in MetricStore._GEN_GROUPS
                 if getattr(g, n).spilled})


@dataclass
class ForwardableState:
    """Sketch state a local forwards to the global tier
    (worker.go:161-183): global counters/gauges by value, digests as
    centroid lists, sets as register arrays, heavy hitters as one
    count-min table plus each series' top-k candidates.

    A flush leaves each forwarded digest group in ``histograms_columnar``
    / ``timers_columnar`` as (names arenas, tags arenas, planes...): the
    dense planes spread inline, (names, tags, mean [n, K], weight [n, K],
    dmin [n], dmax [n]), or one :class:`PackedDigestPlanes`, (names,
    tags, planes). The native forwarder's C++ encoders take them as they
    are; :meth:`materialize_digests` turns them into the per-row tuples
    the JSON wire needs, off the flush's emission path."""

    counters: List[Tuple[str, List[str], int]] = field(default_factory=list)
    gauges: List[Tuple[str, List[str], float]] = field(default_factory=list)
    # (name, tags, means f64, weights f64, min, max), one per series
    histograms: List[tuple] = field(default_factory=list)
    timers: List[tuple] = field(default_factory=list)
    histograms_columnar: Optional[tuple] = None
    timers_columnar: Optional[tuple] = None
    # (name, tags, registers uint8 [2^p], precision)
    sets: List[tuple] = field(default_factory=list)
    # heavy hitters: (table ndarray [depth, width],
    # [(name, tags, [(hi, lo)...], [member-or-None...])]) or None
    topk: Optional[tuple] = None

    @staticmethod
    def _columnar_rows(col) -> int:
        return 0 if col is None else len(col[0][1])

    def __len__(self):
        return (len(self.counters) + len(self.gauges) + len(self.histograms)
                + len(self.timers) + len(self.sets)
                + self._columnar_rows(self.histograms_columnar)
                + self._columnar_rows(self.timers_columnar)
                + (len(self.topk[1]) if self.topk else 0))

    def materialize_digests(self):
        """Convert the columnar digest planes into per-row tuples holding
        only the live centroids (weight > 0) in mean order, as float64;
        packed planes dequantize."""
        for attr, col_attr in (("histograms", "histograms_columnar"),
                               ("timers", "timers_columnar")):
            col = getattr(self, col_attr)
            if col is None:
                continue
            names = columnar.arena_strings(col[0])
            tags = [j.split(",") if j else []
                    for j in columnar.arena_strings(col[1])]
            if isinstance(col[2], PackedDigestPlanes):
                p = col[2]
                starts, ends, flat_m, flat_w = p.row_slices()
                dmins, dmaxs = p.dmin, p.dmax
            else:
                means, weights, dmins, dmaxs = col[2:]
                live = weights > 0
                ends = np.cumsum(live.sum(1))
                starts = ends - live.sum(1)
                flat_m = means[live].astype(np.float64)
                flat_w = weights[live].astype(np.float64)
            getattr(self, attr).extend(
                (names[r], tags[r], flat_m[a:b], flat_w[a:b],
                 float(dmins[r]), float(dmaxs[r]))
                for r, (a, b) in enumerate(zip(starts.tolist(),
                                               ends.tolist())))
            setattr(self, col_attr, None)


def _digest_want(percentiles, aggregates: HistogramAggregates,
                 forwarding: bool, digest_format: str = "dense"):
    """(want_digests, want_stats) of one digest group's flush: the digest
    planes only when the group forwards (``"packed"`` with
    ``digest_format="packed"``), and the per-row stat columns this
    aggregate config reads; the rest are zero-filled and never emitted,
    because the same mask gates their emissions."""
    want = forwarding
    if forwarding and digest_format == "packed":
        want = "packed"
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
    return want, want_stats


class _Generation:
    """The retired group set a flush drains off-lock (swap-on-flush)."""

    __slots__ = ("counters", "global_counters", "gauges", "global_gauges",
                 "local_status_checks", "histograms", "timers",
                 "local_histograms", "local_timers", "self_timers", "sets",
                 "local_sets", "heavy_hitters", "processed", "imported")


class MetricStore:
    """The ported scope-classes plus dispatch, import and flush."""

    # every group swapped per flush, in flush order (self_timers: the
    # server's own stage durations, sample_self_timing)
    _GEN_GROUPS = ("counters", "global_counters", "gauges", "global_gauges",
                   "local_status_checks", "histograms", "timers",
                   "local_histograms", "local_timers", "self_timers",
                   "sets", "local_sets", "heavy_hitters")
    # the metric type each group's keys carry (its overflow row's type)
    _GROUP_TYPES = {
        "counters": "counter", "global_counters": "counter",
        "gauges": "gauge", "global_gauges": "gauge",
        "local_status_checks": "status",
        "histograms": "histogram", "local_histograms": "histogram",
        "timers": "timer", "local_timers": "timer", "self_timers": "timer",
        "sets": "set", "local_sets": "set", "heavy_hitters": "set"}

    def __init__(self, initial_capacity: int = DEFAULT_INITIAL_CAPACITY,
                 chunk: int = DEFAULT_CHUNK,
                 compression: float = td_ops.DEFAULT_COMPRESSION,
                 hll_precision: int = hll_ops.DEFAULT_PRECISION,
                 topk_depth: int = cm_ops.DEFAULT_DEPTH,
                 topk_width: int = cm_ops.DEFAULT_WIDTH,
                 topk_k: int = cm_ops.DEFAULT_TOPK, max_series: int = 0,
                 max_tag_length: int = 0, overload=None,
                 flush_pipeline_depth: int = 2, compute=None,
                 digest_storage: str = "dense",
                 digest_dtype: str = "float32", slab_rows: int = 1 << 20,
                 tier_pool_centroids: int = 16,
                 tier_promote_samples: int = 64,
                 tier_promote_intervals: int = 2,
                 tier_demote_intervals: int = 3, device=None, mesh=None):
        if mesh is not None and device is not None \
                and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device))
        # samples the store rejects, by reason (cumulative): the groups'
        # scrubs, process_batch's and the ingest lanes' ledgers, and the
        # tag-length cap's cuts
        self.quarantine = Quarantine()
        self._lock = threading.RLock()
        # serializes whole flush() calls; the store lock itself is held
        # only for the generation swap
        self._flush_gate = threading.Lock()
        # overlapped flush: 0 = each group drained in turn; N > 0 = every
        # group's program dispatched before any fetch, with at most N
        # fetched-but-unemitted results resident (core/pipeline.py)
        self.flush_pipeline_depth = max(0, int(flush_pipeline_depth))
        self.digest_storage = digest_storage
        # fleet mode (core/mesh_store.py): the store's series shard over
        # the mesh's row blocks, every group of them placed by one router
        self.mesh = mesh
        self.shard_router = None
        self.last_fleet_occupancy = None
        if mesh is not None:
            self._check_mesh_storage(digest_storage)
            from veneur_tpu_torch.fleet import ShardRouter

            self.shard_router = ShardRouter(mesh.series)
        groups = (("counters", "counter"), ("global_counters", "counter"),
                  ("gauges", "gauge"), ("global_gauges", "gauge"))
        for name, kind in groups:
            if mesh is None:
                setattr(self, name, ScalarGroup(kind, initial_capacity))
            else:
                from veneur_tpu_torch.core.mesh_store import MeshScalarGroup

                setattr(self, name, MeshScalarGroup(
                    kind, initial_capacity, mesh, self.shard_router))
        self.local_status_checks = ScalarGroup("status", initial_capacity)
        for name in _DIGEST_GROUPS:
            if (mesh is not None and not name.startswith("local_")
                    and digest_storage == "tiered"):
                # the packed pool over the mesh's series blocks, a mesh
                # bank for the hot tier, shard-local promotion
                from veneur_tpu_torch.fleet.mesh_tiered import \
                    MeshTieredDigestGroup

                group = MeshTieredDigestGroup(
                    mesh, self.shard_router, min(slab_rows, 1 << 18),
                    chunk, compression, tier_pool_centroids,
                    tier_promote_samples, tier_promote_intervals,
                    tier_demote_intervals, initial_capacity)
            elif mesh is not None and not name.startswith("local_"):
                from veneur_tpu_torch.core.mesh_store import MeshDigestGroup

                group = MeshDigestGroup(mesh, initial_capacity, chunk,
                                        compression, self.shard_router)
            else:
                group = self._digest_group(
                    digest_storage, initial_capacity, chunk, compression,
                    digest_dtype, slab_rows, tier_pool_centroids,
                    tier_promote_samples, tier_promote_intervals,
                    tier_demote_intervals)
            setattr(self, name, group)
        # the self-telemetry group (obs/): the server's own stage
        # durations, a small dense group whatever the storage (one row an
        # instrumented stage), local-only, never forwarded
        self.self_timers = DigestGroup(min(64, initial_capacity), chunk,
                                       compression, self.device)
        for name in _SET_GROUPS:
            if mesh is not None and name == "sets":
                from veneur_tpu_torch.core.mesh_store import MeshSetGroup

                group = MeshSetGroup(mesh, initial_capacity, chunk,
                                     hll_precision, self.shard_router)
            else:
                group = SetGroup(initial_capacity, chunk, hll_precision,
                                 self.device)
            setattr(self, name, group)
        if mesh is None:
            self.heavy_hitters = HeavyHitterGroup(
                initial_capacity, chunk, topk_depth, topk_width, topk_k,
                self.device)
        else:
            from veneur_tpu_torch.core.mesh_store import MeshHeavyHitterGroup

            self.heavy_hitters = MeshHeavyHitterGroup(
                initial_capacity, chunk, topk_depth, topk_width, topk_k,
                mesh, self.shard_router)
        self.hll_precision = hll_precision
        # bounded cardinality and the tag-length cap (0 = off: a Server
        # passes its config's defaults), and the admission controller a
        # Server attaches (overload.py)
        self.max_series = max_series
        self.max_tag_length = max_tag_length
        self._overload = overload
        # the flush kernel's compute ladder (resilience/compute.py):
        # always on; its breaker is shared by every digest group
        self.compute = compute if compute is not None else ComputeBreaker()
        self._configure_overload_groups()
        self.processed = 0
        # forwarded metrics merged this interval (import_*)
        self.imported = 0
        # bumped by every generation swap: an ingest lane's resolver drops
        # its lane-row -> store-row remap when the epoch moved
        self.flush_epoch = 0
        # the C++ (kind, name, tags) -> row memo of process_batch, and the
        # kind -> group table; both restart with every generation
        self._native_table: Optional[native.InternTable] = None
        self._kind_groups: Optional[tuple] = None
        # import_columnar's C++ (type, payload, name, tags) -> row memo;
        # it too restarts with every generation
        self._mlist_table = None
        # the ingest fleets' sealed-chunk drain, run before a snapshot
        self._ingest_drain = None
        # the last flushed generation's tallies (the flusher's
        # self-metrics read them)
        self.last_summary = MetricsSummary()

    @staticmethod
    def _check_mesh_storage(storage: str) -> None:
        """The digest storages a mesh takes: dense, and tiered (the mesh
        tiered store, ``fleet/mesh_tiered.py``). Slab is refused as the
        JAX package refuses it."""
        if storage == "slab":
            raise ValueError(
                "digest_storage: slab cannot combine with mesh_enabled: "
                "the slab layout is the single-card capacity plan and "
                "the mesh supersedes it; run the mesh dense")

    def _digest_group(self, storage: str, initial_capacity: int, chunk: int,
                      compression: float, digest_dtype: str, slab_rows: int,
                      pool_centroids: int, promote_samples: int,
                      promote_intervals: int, demote_intervals: int):
        """One histogram/timer group of the configured storage: "dense"
        (one [S, K] plane a field), "slab" (flat per-slab planes, maybe
        bfloat16: ``core/slab.py``) or "tiered" (a packed pool with dense
        slots for active series, 256k-row pool slabs at most:
        ``core/tiered.py``; each group owns one TierDirectory its
        generation twins share). Sets, scalars and heavy hitters stay
        dense whatever the storage."""
        if storage == "dense":
            return DigestGroup(initial_capacity, chunk, compression,
                               self.device)
        if storage == "slab":
            from veneur_tpu_torch.core.slab import SlabDigestGroup

            return SlabDigestGroup(slab_rows, chunk, compression,
                                   digest_dtype, self.device)
        if storage == "tiered":
            from veneur_tpu_torch.core.tiered import TieredDigestGroup

            return TieredDigestGroup(
                min(slab_rows, 1 << 18), chunk, compression,
                pool_centroids, promote_samples, promote_intervals,
                demote_intervals, initial_capacity, device=self.device)
        raise ValueError(f"digest_storage must be 'dense', 'slab' or "
                         f"'tiered', got {storage!r}")

    # -- overload plumbing (overload.py) -------------------------------------

    def set_overload(self, controller) -> None:
        """Attach the server's admission controller; the groups consult it
        for the first-sight series freeze (level >= 1)."""
        self._overload = controller
        self._configure_overload_groups()

    def _configure_overload_groups(self) -> None:
        for name in self._GEN_GROUPS:
            self._apply_overload_attrs(name, getattr(self, name))

    def _apply_overload_attrs(self, name: str, g) -> None:
        """Stamp one group's overload attributes (OverloadLimited's class
        defaults keep groups built directly inert); re-run on every fresh
        twin at the generation swap."""
        g.max_series = self.max_series
        g.overflow_label = name
        g._overflow_type = self._GROUP_TYPES[name]
        # the self-telemetry group is exempt from the admission freeze:
        # it is the operator's view into the overload (the hard
        # cardinality cap still applies)
        g._overload = None if name == "self_timers" else self._overload
        g._quarantine = self.quarantine
        g._compute = self.compute
        # the slab and tiered groups' dispatch-ahead window over their
        # slabs rides the flush pipeline's depth
        g._pipeline_window = max(1, self.flush_pipeline_depth)

    def sample_self_timing(self, stage: str, duration_ns: float,
                           name: str = "veneur.obs.stage_duration_ns"
                           ) -> None:
        """One observed stage duration into the self-telemetry group
        (``veneur.obs.stage_duration_ns`` tagged ``stage:<name>``): the
        flusher feeds every interval's stage durations and the ingest
        lanes' seal->merge latencies here, so the next flush emits their
        percentiles through the same t-digest path the server sells."""
        tag = f"stage:{stage}"
        key = MetricKey(name=name, type="timer", joined_tags=tag)
        with self._lock:
            self.self_timers.sample(key, [tag], float(duration_ns), 1.0)

    def _truncate_tags(self, joined: str) -> str:
        """The per-series tag-length cap: cut the joined tags at the last
        whole tag inside ``max_tag_length`` (identities merge past it).
        Counted per occurrence."""
        limit = self.max_tag_length
        if not limit or len(joined) <= limit:
            return joined
        self.quarantine.count("oversized_tags")
        return truncate_joined_tags(joined, limit)

    # -- ingest --------------------------------------------------------------

    def process_metric(self, m: UDPMetric):
        """Dispatch one parsed sample to its scope-class
        (worker.go:267-310). The tag-length cap applies again here, the
        one choke point every per-line path shares: the statsd parser
        caps at parse, but SSF samples arrive with their tags whole."""
        key = m.key
        if (self.max_tag_length
                and len(key.joined_tags) > self.max_tag_length):
            joined = self._truncate_tags(key.joined_tags)
            m.key = MetricKey(name=key.name, type=key.type,
                              joined_tags=joined)
            m.tags = joined.split(",") if joined else []
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
                # the bare tag from DogStatsD, the scope from SSF (whose
                # "k:v" tags never hold the bare string)
                if "veneurtopk" in m.tags or m.scope == TOPK_SCOPE:
                    self.heavy_hitters.sample(m.key, m.tags, str(m.value))
                else:
                    group = (self.local_sets if m.scope == LOCAL_ONLY
                             else self.sets)
                    group.sample(m.key, m.tags, str(m.value))
            elif t == "status":
                self.local_status_checks.sample(
                    m.key, m.tags, float(m.value), m.sample_rate,
                    message=m.message, hostname=m.hostname)
            # unknown types are dropped, as in the reference
            self.processed += 1

    def process_batch(self, batch) -> List[bytes]:
        """Vectorized ingest of a native ``ParsedBatch``: one lock hold a
        batch, one C++ table lookup a record, and per-group numpy bulk
        appends into the staging buffers instead of the per-line
        parse/lock/dispatch chain. Returns the raw event/service-check
        lines for the caller to route through the Python parser outside
        the lock.

        Semantics of process_metric: worker sharding collapses to row
        interning (server.go:670-720), Go counter truncation and gauge
        last-write-wins (samplers.go:141-143, 225-227). Rejected samples
        are counted in ``quarantine``."""
        raws: List[bytes] = []
        if batch.count == 0:
            return raws
        arena = batch.arena
        values, rates = batch.value, batch.sample_rate
        with self._lock:
            if self._native_table is None:
                self._native_table = native.InternTable()
            # the C++ table maps every record to its memoized row in one
            # pass; only first-sight series take the Python slow path
            rows, kinds, miss = self._native_table.assign(batch)
            if len(miss):
                types, scopes = batch.type, batch.scope
                noffs, nlens = batch.name_off, batch.name_len
                toffs, tlens = batch.tags_off, batch.tags_len
                # intra-batch dedup only: once put() teaches the C++ table
                # a key, later batches never miss on it again
                cache: Dict[tuple, int] = {}
                table = self._native_table
                for j in miss:
                    j = int(j)
                    t, sc = int(types[j]), int(scopes[j])
                    no, nl = noffs[j], nlens[j]
                    to, tl = toffs[j], tlens[j]
                    ck = (t, sc, arena[no:no + nl], arena[to:to + tl])
                    row = cache.get(ck)
                    if row is None:
                        kind, _, row = self._intern_native(t, sc, ck[2],
                                                           ck[3])
                        cache[ck] = row
                        table.put(kind, ck[2], ck[3], row)
                    rows[j] = row
            processed = int(batch.count)
            member_hashes = None
            for kind in np.unique(kinds).tolist():
                sel = np.nonzero(kinds == kind)[0]
                if kind == _KIND_RAW:  # raw events / service checks
                    aoffs, alens = batch.aux_off, batch.aux_len
                    raws.extend(arena[aoffs[j]:aoffs[j] + alens[j]]
                                for j in sel)
                    processed -= len(sel)  # counted when re-parsed
                    continue
                grp_rows = rows[sel].astype(np.int64)
                group = self._group_for_kind(kind)
                group.ensure_capacity(int(grp_rows.max()))
                if kind in (_K_COUNTER, _K_GLOBAL_COUNTER):
                    # scrub before the cast: NaN/Inf cast to int64 garbage
                    # and oversized contributions overflow the lanes
                    ok = _scrub_counter_batch(self.quarantine, values[sel],
                                              rates[sel])
                    sel, grp_rows = sel[ok], grp_rows[ok]
                    # int64(value) * int64(float32(1)/float32(rate)), both
                    # truncating (samplers.go:141-143): the reciprocal the
                    # scrub bounded, so nothing admitted wraps the product
                    recips = np.float32(1.0) / rates[sel].astype(np.float32)
                    group.add_many(grp_rows, values[sel].astype(np.int64)
                                   * recips.astype(np.int64))
                elif kind in (_K_GAUGE, _K_GLOBAL_GAUGE):
                    ok = _scrub_float_batch(self.quarantine, values[sel])
                    group.set_many(grp_rows[ok], values[sel[ok]])
                elif kind in (_K_SET, _K_LOCAL_SET):
                    if member_hashes is None:
                        member_hashes = batch.member_hashes()
                    group.sample_many(grp_rows.astype(np.int32),
                                      member_hashes[sel])
                elif kind == _K_TOPK:
                    if member_hashes is None:
                        member_hashes = batch.member_hashes()
                    aoffs, alens = batch.aux_off, batch.aux_len
                    group.sample_many(grp_rows.astype(np.int32),
                                      member_hashes[sel],
                                      [arena[aoffs[j]:aoffs[j] + alens[j]]
                                       for j in sel])
                else:  # histograms / timers, both scopes
                    # scrub the float64 values before the f32 cast, so an
                    # out-of-range sample is rejected, not made inf
                    vals64 = values[sel]
                    wts = (1.0 / rates[sel]).astype(np.float32)
                    ok = _scrub_float_batch(self.quarantine, vals64,
                                            abs_max=F32_ABS_MAX,
                                            weights=wts)
                    group.sample_many(grp_rows[ok].astype(np.int32),
                                      vals64[ok].astype(np.float32),
                                      wts[ok])
            self.processed += processed
        return raws

    def _group_for_kind(self, kind: int):
        """The live group of a scope-class kind (caller holds _lock)."""
        if self._kind_groups is None:
            self._kind_groups = (
                self.counters, self.global_counters, self.gauges,
                self.global_gauges, self.histograms, self.local_histograms,
                self.timers, self.local_timers, self.sets, self.local_sets,
                self.heavy_hitters)
        return self._kind_groups[kind]

    def _intern_native(self, t: int, sc: int, name_b: bytes,
                       tags_b: bytes) -> Tuple[int, object, int]:
        """Slow path of the native and lane paths (caller holds _lock):
        decode the strings, pick the scope-class group (kind_of() of
        veneur_ingest.cpp, worker.go:96-157) and intern the row, the tags
        cut at ``max_tag_length``. Returns (kind, group, row)."""
        name = name_b.decode("utf-8", "replace")
        joined = self._truncate_tags(tags_b.decode("utf-8", "replace"))
        tags = joined.split(",") if joined else []
        key = MetricKey(name=name, type=_NATIVE_TYPE_NAMES[t],
                        joined_tags=joined)
        if t == 0:
            kind = _K_GLOBAL_COUNTER if sc == GLOBAL_ONLY else _K_COUNTER
        elif t == 1:
            kind = _K_GLOBAL_GAUGE if sc == GLOBAL_ONLY else _K_GAUGE
        elif t == 2:
            kind = _K_LOCAL_HISTO if sc == LOCAL_ONLY else _K_HISTO
        elif t == 3:
            kind = _K_LOCAL_TIMER if sc == LOCAL_ONLY else _K_TIMER
        elif sc == TOPK_SCOPE:
            kind = _K_TOPK
        else:
            kind = _K_LOCAL_SET if sc == LOCAL_ONLY else _K_SET
        group = self._group_for_kind(kind)
        return kind, group, group._row(key, tags)

    # -- ingest-lane merge (veneur_tpu_torch/ingest/) ----------------------

    # lane kind -> (native record type, scope) for re-interning lane
    # entries through _intern_native: the inverse of kind_of()
    _KIND_NATIVE = {
        _K_COUNTER: (0, 0), _K_GLOBAL_COUNTER: (0, GLOBAL_ONLY),
        _K_GAUGE: (1, 0), _K_GLOBAL_GAUGE: (1, GLOBAL_ONLY),
        _K_HISTO: (2, 0), _K_LOCAL_HISTO: (2, LOCAL_ONLY),
        _K_TIMER: (3, 0), _K_LOCAL_TIMER: (3, LOCAL_ONLY),
        _K_SET: (4, 0), _K_LOCAL_SET: (4, LOCAL_ONLY),
        _K_TOPK: (4, TOPK_SCOPE)}

    def import_lane_chunk(self, chunk, resolver) -> List[bytes]:
        """Merge one sealed ingest-lane chunk under ONE store-lock hold:
        lanes stage lock-free against lane-local rows, and this is the
        only place their samples meet shared state.

        ``resolver`` is the merger's LaneResolver for the chunk's lane:
        its (name, tags) registry remaps lane rows onto the store's
        interners. The remap is dropped whole when the flush epoch moved
        (the fresh generation's interners start empty) and rebuilt
        lazily. Values arrive scrubbed and in Go semantics (contribs
        truncated, weights float32 reciprocals), the bits process_batch
        would stage.

        Returns the chunk's raw event/service-check lines for the caller
        to route through the Python parser OUTSIDE the lock. A digest
        span may launch K2 (the shift guard) on the store's device from
        the calling thread."""
        with self._lock:
            if resolver.epoch != self.flush_epoch:
                resolver.remap = [None] * len(resolver.remap)
                resolver.epoch = self.flush_epoch
            for kind, new in chunk.new_entries.items():
                resolver.entries[kind].extend(new)
            for kind, span in chunk.spans.items():
                rows = span[0]
                grp_rows = self._lane_remap(kind, resolver, rows)[rows]
                group = self._group_for_kind(kind)
                group.ensure_capacity(int(grp_rows.max()))
                if kind in (_K_COUNTER, _K_GLOBAL_COUNTER):
                    group.add_many(grp_rows, span[1])
                elif kind in (_K_GAUGE, _K_GLOBAL_GAUGE):
                    group.set_many(grp_rows, span[1])
                elif kind in (_K_SET, _K_LOCAL_SET):
                    group.sample_many(grp_rows.astype(np.int32), span[1])
                elif kind == _K_TOPK:
                    group.sample_many(grp_rows.astype(np.int32), span[1],
                                      span[3])
                else:
                    group.sample_many(grp_rows.astype(np.int32), span[1],
                                      span[2])
            self.processed += chunk.records
        return chunk.raws

    def _lane_remap(self, kind: int, resolver, rows) -> np.ndarray:
        """Lane-row -> store-row array of one kind (caller holds _lock),
        resolved LAZILY per referenced row (-1 = unresolved): only rows
        the chunk carries re-intern after an epoch bump, so an idle
        series a lane once saw is not resurrected into every fresh
        generation (it would emit as zero forever), and the work under
        the lock is bounded by the chunk's rows, not the lane's
        lifetime registry."""
        entries = resolver.entries[kind]
        remap = resolver.remap[kind]
        if remap is None or len(remap) < len(entries):
            grown = np.full(len(entries), -1, np.int64)
            if remap is not None and len(remap):
                grown[:len(remap)] = remap
            remap = resolver.remap[kind] = grown
        needed = np.unique(rows)
        todo = needed[remap[needed] < 0]
        if len(todo):
            t, sc = self._KIND_NATIVE[kind]
            for r in todo.tolist():
                name_b, tags_b = entries[r]
                remap[r] = self._intern_native(t, sc, name_b, tags_b)[2]
        return remap

    # -- import (global-aggregator ingest) ---------------------------------
    # The import methods run on the importing thread (the HTTP server's
    # merge workers) under the store lock; a digest import may launch K2
    # through the shift guard on the store's own device.

    def import_counter(self, key: MetricKey, tags: List[str], value: int):
        """Imported counters are global by definition (worker.go:313-326)."""
        with self._lock:
            self.imported += 1
            self.global_counters.combine(key, tags, value)

    def import_gauge(self, key: MetricKey, tags: List[str], value: float):
        with self._lock:
            self.imported += 1
            self.global_gauges.combine(key, tags, value)

    def import_digest(self, key: MetricKey, tags: List[str],
                      means: np.ndarray, weights: np.ndarray,
                      dmin: float, dmax: float):
        with self._lock:
            self.imported += 1
            group = self.timers if key.type == "timer" else self.histograms
            group.import_centroids(key, tags, means, weights, dmin, dmax)

    def import_digests_bulk(self, entries: List[tuple]):
        """Merge many forwarded digests in one pass: one lock hold, one
        flat staging append per group instead of a per-metric call chain
        (cf. the reference's per-worker chunking,
        importsrv/server.go:99-132).

        entries: [(key, tags, means, weights, dmin, dmax)]."""
        with self._lock:
            self.imported += len(entries)
            for want_timer, group in ((False, self.histograms),
                                      (True, self.timers)):
                sel = [e for e in entries
                       if (e[0].type == "timer") == want_timer]
                if not sel:
                    continue
                total = sum(len(e[2]) for e in sel)
                flat_rows = np.empty(total, np.int32)
                flat_means = np.empty(total, np.float32)
                flat_wts = np.empty(total, np.float32)
                stat_rows: List[int] = []
                stat_mins: List[float] = []
                stat_maxs: List[float] = []
                pos = 0
                for key, tags, means, weights, dmin, dmax in sel:
                    row = group._row(key, tags)
                    n = len(means)
                    flat_rows[pos:pos + n] = row
                    flat_means[pos:pos + n] = means
                    flat_wts[pos:pos + n] = weights
                    pos += n
                    if math.isfinite(dmin):
                        stat_rows.append(row)
                        stat_mins.append(dmin)
                        stat_maxs.append(dmax)
                group.import_centroids_bulk(flat_rows, flat_means, flat_wts,
                                            stat_rows, stat_mins, stat_maxs)

    def import_set(self, key: MetricKey, tags: List[str],
                   registers: np.ndarray):
        with self._lock:
            self.imported += 1
            self.sets.import_registers(key, tags, registers)

    def import_topk(self, table: np.ndarray, series: List[tuple]):
        """Merge a forwarded heavy-hitter sketch (see
        HeavyHitterGroup.import_sketch); series entries carry plain
        (name, tags, keys, members), keyed here."""
        with self._lock:
            self.imported += 1
            entries = [(MetricKey(name=name, type="set",
                                  joined_tags=",".join(tags)),
                        tags, keys, members)
                       for name, tags, keys, members in series]
            self.heavy_hitters.import_sketch(table, entries)

    def _intern_mlist(self, dec) -> np.ndarray:
        """import_columnar's row assignment (caller holds _lock): the C++
        table's hits, then a Python pass over the first-seen misses that
        interns each in the group its payload picks and teaches the
        table. Rows of metrics with an unknown type or no value stay
        ``MISS``."""
        from veneur_tpu_torch.forward.convert import type_name
        from veneur_tpu_torch.native import egress
        from veneur_tpu_torch.protocol import mlist

        if self._mlist_table is None:
            self._mlist_table = egress.MListInternTable()
        table = self._mlist_table
        rows, miss = table.assign(dec)
        arena = dec.arena
        for i in miss.tolist():
            t, pay = int(dec.type[i]), int(dec.payload[i])
            try:
                tname = type_name(t)
            except ValueError:
                continue
            if pay == egress.PAYLOAD_COUNTER:
                group = self.global_counters
            elif pay == egress.PAYLOAD_GAUGE:
                group = self.global_gauges
            elif pay == egress.PAYLOAD_HISTOGRAM:
                group = self.timers if t == mlist.TIMER else self.histograms
            elif pay == egress.PAYLOAD_SET:
                group = self.sets
            else:
                continue
            no, nl = int(dec.name_off[i]), int(dec.name_len[i])
            to, tl = int(dec.tags_off[i]), int(dec.tags_len[i])
            name_b, tags_b = arena[no:no + nl], arena[to:to + tl]
            joined = self._truncate_tags(tags_b.decode("utf-8", "replace"))
            key = MetricKey(name=name_b.decode("utf-8", "replace"),
                            type=tname, joined_tags=joined)
            row = group._row(key, joined.split(",") if joined else [])
            rows[i] = row
            table.put(t, pay, name_b, tags_b, row)
        return rows

    def import_columnar(self, dec, data: bytes) -> Tuple[int, int]:
        """Merge a MetricList decoded in C++ (``native/egress.py``
        DecodedMetricList) in one pass: rows assigned by the C++
        MetricList table, the first-seen misses resolved in Python and
        taught back, then numpy bulk staging a payload kind (counters,
        gauges, digests through ``import_centroids_bulk``, set
        registers, the top-k sketch). ``data`` is the frame (the set
        spans index into it). Returns (n_ok, n_err): a metric with an
        unknown type or no value, or one the store rejects, is an error;
        a failing digest batch counts its digests as errors.

        Reference path: importsrv.SendMetrics' group-by-worker and
        ImportMetricGRPC's per-sampler Merge (importsrv/server.go:101-132,
        worker.go:354-398)."""
        from veneur_tpu_torch.forward.convert import (decode_hll,
                                                      decode_topk_sketch)
        from veneur_tpu_torch.native import egress
        from veneur_tpu_torch.protocol import mlist

        n_err = 0
        with self._lock:
            rows = self._intern_mlist(dec)
            ok = rows != egress.MISS
            n_err += int((~ok).sum())
            payload = dec.payload
            n_ok = 0
            sel = np.flatnonzero(ok & (payload == egress.PAYLOAD_COUNTER))
            if len(sel):
                grp_rows = rows[sel].astype(np.int64)
                self.global_counters.ensure_capacity(int(grp_rows.max()))
                self.global_counters.add_many(grp_rows, dec.ivalue[sel])
                n_ok += len(sel)
            sel = np.flatnonzero(ok & (payload == egress.PAYLOAD_GAUGE))
            if len(sel):
                grp_rows = rows[sel].astype(np.int64)
                self.global_gauges.ensure_capacity(int(grp_rows.max()))
                self.global_gauges.set_many(grp_rows, dec.dvalue[sel])
                n_ok += len(sel)

            histo_sel = ok & (payload == egress.PAYLOAD_HISTOGRAM)
            for group, type_match in ((self.histograms,
                                       dec.type != mlist.TIMER),
                                      (self.timers, dec.type == mlist.TIMER)):
                sel = np.flatnonzero(histo_sel & type_match)
                if not len(sel):
                    continue
                grp_rows = rows[sel]
                group.ensure_capacity(int(grp_rows.max()))
                lens = dec.cent_len[sel].astype(np.int64)
                starts = dec.cent_off[sel].astype(np.int64)
                # grouped-arange gather of each digest's centroid span
                total = int(lens.sum())
                span_ends = np.cumsum(lens)
                idx = (np.repeat(starts - (span_ends - lens), lens)
                       + np.arange(total, dtype=np.int64))
                stat_mask = np.isfinite(dec.dmin[sel])
                try:
                    group.import_centroids_bulk(
                        np.repeat(grp_rows, lens).astype(np.int32),
                        dec.means[idx], dec.weights[idx],
                        grp_rows[stat_mask].astype(np.int32),
                        dec.dmin[sel][stat_mask].astype(np.float32),
                        dec.dmax[sel][stat_mask].astype(np.float32))
                    n_ok += len(sel)
                except Exception:
                    # not transactional: a prefix may be staged already,
                    # so the batch counts as errors and is not retried
                    n_err += len(sel)
                    log.exception("bulk digest import failed; dropping %d "
                                  "digests", len(sel))

            for i in np.flatnonzero(ok & (payload == egress.PAYLOAD_SET)):
                ho, hn = int(dec.hll_off[i]), int(dec.hll_len[i])
                try:
                    registers, _ = decode_hll(data[ho:ho + hn])
                    self.sets.import_registers_row(int(rows[i]), registers)
                    n_ok += 1
                except Exception as e:
                    n_err += 1
                    log.debug("store rejected an imported set: %s", e)

            if dec.topk_len:
                off = int(dec.topk_off)
                try:
                    cm_table, series = decode_topk_sketch(mlist.decode_topk(
                        data[off:off + int(dec.topk_len)]))
                    self.heavy_hitters.import_sketch(cm_table, [
                        (MetricKey(name=name, type="set",
                                   joined_tags=",".join(tags)),
                         tags, keys, members)
                        for name, tags, keys, members in series])
                    n_ok += 1
                except Exception as e:
                    n_err += 1
                    log.debug("store rejected an imported top-k sketch: %s",
                              e)

            self.imported += n_ok
            return n_ok, n_err

    # -- flush ---------------------------------------------------------------

    def flush(self, percentiles: List[float],
              aggregates: HistogramAggregates, now: int,
              is_local: bool = False, forward: bool = True,
              forward_topk: bool = True, columnar: bool = False,
              digest_format: str = "dense", stream=None):
        """Drain everything and reset all groups; returns (the rows for
        the sinks, the :class:`ForwardableState` a local forwards).
        Mirrors generateInterMetrics (flusher.go:189-254): a local
        (``is_local``) emits no percentiles for mixed histograms/timers
        and, with ``forward``, forwards them with the mixed sets and the
        global counters/gauges instead of flushing those; local-only
        groups always flush in full. A global emits everything and
        forwards nothing. Heavy hitters follow the mixed-set rule, unless
        the transport cannot carry the sketch (``forward_topk`` False):
        then the local emits its own top-k.

        The rows come back as a :class:`~veneur_tpu_torch.core.columnar.
        ColumnarFlush`. With ``columnar``, counters, gauges, set estimates
        and digest aggregates are its ``EmissionBlock`` columns, and the
        low-cardinality rows (status checks, top-k, a group with
        ``veneursinkonly:`` routing) its per-row extras; without it,
        every row is an extra (``to_intermetrics()`` gives the list).

        ``digest_format="packed"`` makes the forwarded digest groups pack
        their drained planes on the device (:class:`PackedDigestPlanes`:
        the live centroids, 4 bytes each) instead of fetching the raw
        [S, K] float32 planes; it matters only on a forwarding local.

        ``stream`` (a :class:`~veneur_tpu_torch.core.pipeline.ChunkStream`)
        hands each completed group's blocks to the streaming sinks as one
        chunk the moment they exist, and with a forward lane ships each
        forwarded digest group's planes upstream as its own part.

        SWAP-ON-FLUSH: the store lock is held only for the generation
        swap; the device programs and fetches run on the retired
        generation off-lock, so ingest and imports never stall behind a
        flush."""
        with self._flush_gate:
            with obs_rec.maybe_stage("swap"):
                with self._lock:
                    gen = self._swap_generation()
            return self._flush_generation(gen, percentiles, aggregates, now,
                                          is_local, forward, forward_topk,
                                          columnar, digest_format, stream)

    def _swap_generation(self) -> _Generation:
        """Retire every group behind an empty twin (caller holds _lock).
        The twins allocate their own planes, so nothing the retired
        generation holds aliases the live one."""
        gen = _Generation()
        for attr in self._GEN_GROUPS:
            old = getattr(self, attr)
            old._retired = True  # its flush frees state, not reinits it
            setattr(gen, attr, old)
            fresh = old.fresh()
            # a fresh twin starts with the class-default overload attrs
            self._apply_overload_attrs(attr, fresh)
            setattr(self, attr, fresh)
        gen.processed, gen.imported = self.processed, self.imported
        self.processed = self.imported = 0
        if self.mesh is not None:
            # the RETIRED interval's per-shard rows (fleet_snapshot reads
            # the live fills)
            from veneur_tpu_torch.fleet import sum_shard_occupancy

            self.last_fleet_occupancy = sum_shard_occupancy(
                getattr(gen, attr) for attr in self._GEN_GROUPS)
        self.flush_epoch += 1
        self._kind_groups = None  # it holds the retired groups
        for table in (self._native_table, self._mlist_table):
            if table is not None:
                table.reset()  # rows restart in the fresh twins
        return gen

    def _flush_generation(self, g: _Generation, percentiles, aggregates,
                          now, is_local=False, forward=True,
                          forward_topk=True, columnar=False,
                          digest_format="dense", stream=None):
        """Drain a retired generation into emissions and forwardable
        state. The drain is a plan of per-group units run by
        :meth:`_run_flush_units`: in turn with ``flush_pipeline_depth``
        0, else pipelined (every unit's device program dispatched before
        any fetch blocks)."""
        flushed = ColumnarFlush(timestamp=now)
        final = flushed.extras  # the per-row rows land in the extras
        # the emitters write blocks into col, or rows into final
        col = flushed if columnar else None
        fwd = ForwardableState()
        fwd_digests = is_local and forward
        self.last_summary = _summarize(g)
        # counters and gauges are host numpy: they flush, and stream as
        # the interval's first chunk, before any device fetch can block
        with obs_rec.maybe_stage("scalars"):
            self._flush_scalars(g.counters, MetricType.COUNTER, final, now,
                                col)
            self._flush_scalars(g.gauges, MetricType.GAUGE, final, now,
                                col)
        if stream is not None and col is not None and col.blocks:
            stream.emit("scalars", col.blocks,
                        sum(len(b) for b in col.blocks))
        # mixed histograms/timers: no percentiles on a local instance
        mixed_pcts = [] if is_local else list(percentiles)
        units = []
        for name, pcts, fwd_attr in (
                ("histograms", mixed_pcts,
                 "histograms_columnar" if fwd_digests else None),
                ("timers", mixed_pcts,
                 "timers_columnar" if fwd_digests else None),
                ("local_histograms", list(percentiles), None),
                ("local_timers", list(percentiles), None),
                # the self-telemetry group: always local, full percentiles
                ("self_timers", list(percentiles), None)):
            want, want_stats = _digest_want(pcts, aggregates,
                                             fwd_attr is not None,
                                             digest_format)
            group = getattr(g, name)
            units.append((
                name, len(group),
                lambda group=group, pcts=pcts, want=want,
                want_stats=want_stats: group.flush_begin(
                    pcts, want_digests=want, want_stats=want_stats),
                lambda res, name=name, pcts=pcts, fwd_attr=fwd_attr:
                    self._emit_digest_result(
                        name, res, pcts, aggregates, final, now, fwd,
                        fwd_attr, col, stream),
                group))
        # local sets always flush; mixed sets flush only on a global and
        # are forwarded by a local
        for name, out, fwd_list in (
                ("local_sets", final, None),
                ("sets", None if is_local else final,
                 fwd.sets if fwd_digests else None)):
            group = getattr(g, name)
            units.append((
                name, len(group),
                lambda group=group, out=out, fwd_list=fwd_list:
                    group.flush_begin(want_estimates=out is not None,
                                      want_registers=fwd_list is not None),
                lambda res, name=name, out=out, fwd_list=fwd_list:
                    self._emit_set_result(name, res, out, now, fwd_list,
                                          col, stream),
                None))
        # heavy hitters follow the mixed-set rule: a forwarding local ships
        # its sketch and emits nothing (the global emits the fleet top-k);
        # when the transport cannot carry it, the local emits its own view
        want_hh_fwd = is_local and forward and forward_topk
        units.append((
            "topk", len(g.heavy_hitters),
            lambda: g.heavy_hitters.flush_begin(want_forward=want_hh_fwd),
            lambda res: self._emit_topk_result(res, final, now, fwd,
                                               want_hh_fwd),
            None))
        self._run_flush_units(units)
        # status checks are always local
        self._flush_status(g.local_status_checks, final, now)
        # global counters/gauges: forwarded by locals, flushed by globals
        # (per row, after the stream: extras, as in the JAX package)
        if not is_local:
            self._flush_scalars(g.global_counters, MetricType.COUNTER, final,
                                now)
            self._flush_scalars(g.global_gauges, MetricType.GAUGE, final,
                                now)
        else:
            for group, out, cast in ((g.global_counters, fwd.counters, int),
                                     (g.global_gauges, fwd.gauges, float)):
                interner, values, _, _ = group.snapshot_and_reset()
                if forward:
                    out.extend((key.name, interner.tags[row],
                                cast(values[row]))
                               for key, row in interner.rows.items())
        return flushed, fwd

    def _run_flush_units(self, units: List[tuple]):
        """Run the generation's flush plan of ``(name, series, begin,
        emit, group)`` units: ``begin()`` dispatches a group's device
        program and returns its ``finish()``, which fetches the result;
        ``emit`` turns the fetched result into rows. With a recorder
        active (``obs/``) the plan records the timeline's stages:
        ``dispatch.<name>`` around each begin, ``<name>`` (with
        ``series``) around each fetch, and the serializer lane's
        ``serialize.<name>``.

        Sequential (``flush_pipeline_depth`` 0): begin, finish and emit
        a unit at a time, in plan order. Pipelined: every unit's program
        dispatches first; the fetches then run in plan order on this
        thread while one serializer thread (:class:`SerializerLane`)
        emits, and streams, each fetched result, so group k's emission
        overlaps group k+1's fetch. The lane's bounded queue keeps at
        most ``flush_pipeline_depth`` results resident, and emission
        order stays deterministic.

        A digest unit (``group`` set) whose kernel fails at dispatch or
        fetch, or whose breaker is open, re-merges into the live store
        (:meth:`_requeue_group`) and the plan goes on; any other unit's
        failure propagates."""
        depth = self.flush_pipeline_depth
        if depth <= 0:
            for name, series, begin, emit, group in units:
                with obs_rec.maybe_stage(name, series=series):
                    try:
                        res = begin()()
                    except Exception:
                        if not self._unit_failed(name, group, "flush"):
                            raise
                        continue
                    emit(res)
            return
        plan = []
        with obs_rec.maybe_stage("dispatch"):
            for name, series, begin, emit, group in units:
                with obs_rec.maybe_stage(name):
                    try:
                        fin = begin()
                    except Exception:
                        if not self._unit_failed(name, group, "dispatch"):
                            raise
                        fin = None
                plan.append((name, series, fin, emit, group))
        lane = SerializerLane(depth, obs_rec.current())
        try:
            for name, series, fin, emit, group in plan:
                if fin is None:
                    continue
                with obs_rec.maybe_stage(name, series=series):
                    try:
                        res = fin()
                    except Exception:
                        if not self._unit_failed(name, group, "fetch"):
                            raise
                        continue
                lane.submit(name, emit, res)
        finally:
            # joins the serializer; re-raises the first emit error
            lane.close()

    def _unit_failed(self, name: str, group, phase: str) -> bool:
        """The flush plan's failure edge (called from an except block):
        a digest unit whose kernel failed, or whose breaker is open,
        re-merges into the live store and the plan goes on (True);
        anything else propagates (False)."""
        if group is None:
            return False
        if isinstance(sys.exc_info()[1], KernelBreakerOpen):
            log.warning("digest flush for %s: the kernel's breaker is "
                        "open; re-merging the interval into the live "
                        "store", name)
        else:
            log.exception("digest flush for %s failed at %s; re-merging "
                          "the interval into the live store", name, phase)
        self._requeue_group(name, group)
        return True

    def _requeue_group(self, gen_name: str, group) -> None:
        """Rung 3 of the compute ladder: snapshot the retired group (this
        thread owns it alone: the swap already replaced it) and merge the
        snapshot into the LIVE group with import semantics, as a restore
        does. The interval emits late, never lost; when the snapshot
        fails too (a poisoned CUDA context), the last checkpoint bounds
        the loss."""
        compute = self.compute
        obs_rec.note(rung="requeue")
        try:
            snap = group.snapshot_state()
            with self._lock:
                self._restore_group(gen_name, self._GROUP_TYPES[gen_name],
                                    getattr(self, gen_name), snap)
            compute.count_requeued()
            log.warning("re-merged %s into the live store; its interval "
                        "emits with the next flush", gen_name)
        except Exception:
            compute.count_lost()
            log.exception("could not re-merge %s after the flush failure; "
                          "its interval is lost (the last checkpoint "
                          "bounds the damage)", gen_name)

    # -- snapshot and restore (persist/, the ladder's rung 3) ----------------

    def set_ingest_drain(self, drain) -> None:
        """Register the ingest fleets' sealed-chunk drain; a snapshot runs
        it first, so chunks the lanes sealed but the merger has not
        folded in yet are captured (``IngestFleet.merge_sealed``)."""
        self._ingest_drain = drain

    def snapshot_state(self) -> Tuple[Dict[str, dict], int]:
        """Host snapshot of every group WITHOUT resetting anything, in two
        phases: under each group's own store-lock hold the host copies and
        the device copies are taken (``snapshot_begin``), and the blocking
        device->host fetches run after, with no lock held (``finish``), so
        ingest never waits behind a checkpoint's transfer. Returns
        ``(groups, flush_epoch)``: the writer discards the snapshot when
        the epoch moved before it commits, which also covers a flush swap
        landing between two group holds."""
        drain = self._ingest_drain
        if drain is not None:
            try:
                drain()
            except Exception:
                log.exception("pre-snapshot ingest drain failed")
        with self._lock:
            epoch = self.flush_epoch
        groups = {}
        fetches = []
        for name in self._GEN_GROUPS:
            with self._lock:
                snap, finish = getattr(self, name).snapshot_begin()
            groups[name] = snap
            if finish is not None:
                fetches.append(finish)
        for finish in fetches:  # blocking device reads, no lock held
            finish()
        return groups, epoch

    def restore_state(self, groups: Dict[str, dict],
                      prefer_live_scalars: bool = False) -> int:
        """Merge a snapshot into the live store with import semantics
        (counters add, gauges last-write, digests re-enter the centroid
        binning, sets register-max, count-min tables add), so recovery
        composes with global aggregation as a forwarded sketch would.
        Returns the number of series merged. An unknown group holding
        series and a configuration mismatch (HLL precision, count-min
        geometry) skip that group with a warning; nothing here raises.

        ``prefer_live_scalars=True`` re-merges RETIRED state into a store
        that kept ingesting: a gauge or status row that exists live holds
        a newer sample, so it is skipped rather than overwritten.
        Counters always add."""
        merged = 0
        with self._lock:
            for name, snap in groups.items():
                tname = self._GROUP_TYPES.get(name)
                target = getattr(self, name, None)
                if (tname is None or target is None
                        or not isinstance(snap, dict)):
                    if isinstance(snap, dict) and not snap.get("names"):
                        continue  # a group this store lacks, but empty
                    log.warning("checkpoint restore: unknown group %r; "
                                "skipping", name)
                    continue
                try:
                    merged += self._restore_group(
                        name, tname, target, snap,
                        prefer_live_scalars=prefer_live_scalars)
                except Exception:
                    log.exception("checkpoint restore: group %s failed; "
                                  "skipping it", name)
        return merged

    # the ring-routed groups: what locals forward through the proxy ring,
    # so what a resize of the global fleet moves. The mixed scalars and
    # local-only groups are this host's own and stay. Heavy hitters move
    # too: the candidate series split like any set, and the count-min
    # table (cross-series, not partitionable by key) rides whole with
    # every part: a linear sketch merges by an element-wise add, so the
    # new owner's estimates stay one-sided upper bounds, widened by the
    # donor's table weight (e/w * N)
    _HANDOFF_GROUPS = ("global_counters", "global_gauges", "histograms",
                       "timers", "sets", "heavy_hitters")

    def handoff_extract(self, route_fn, route_many=None
                        ) -> Tuple[Dict[str, Dict[str, dict]], int]:
        """Extract the key ranges a resize of the global fleet moves
        (``fleet/handoff.py``): retire the live generation (the swap a
        flush performs, so the flush-epoch guard covers it), snapshot
        the retired groups off the store lock, split the ring-routed
        groups by ``route_fn``, and re-merge everything that STAYS into
        the live store with import semantics (K2 on its import drains).
        Samples arriving meanwhile land in the fresh live generation, so
        a resize neither loses nor double-counts.

        ``route_fn(name, type_str, joined_tags)`` returns the new owner,
        or None to keep; ``route_many(names, type_str, joineds)`` is its
        batched form. Returns ``(moved, moved_series)``: ``moved`` maps
        a destination to {group: snapshot}, ready for the handoff
        wire."""
        from veneur_tpu_torch.fleet.handoff import split_group_snapshot

        # the gate serializes the swap and the snapshot against a flush
        # (ingest goes on under _lock); the retired generation is this
        # thread's alone, so its snapshot needs no store lock
        with self._flush_gate:
            with self._lock:
                gen = self._swap_generation()
            snaps = {name: getattr(gen, name).snapshot_state()
                     for name in self._GEN_GROUPS}
        moved: Dict[str, Dict[str, dict]] = {}
        kept: Dict[str, dict] = {}
        moved_series = 0
        for name, snap in snaps.items():
            if name in self._HANDOFF_GROUPS:
                parts = split_group_snapshot(
                    snap, self._GROUP_TYPES[name], route_fn,
                    route_many=route_many)
            else:
                parts = {None: snap}
            for dest, part in parts.items():
                if dest is None:
                    kept[name] = part
                else:
                    moved.setdefault(dest, {})[name] = part
                    moved_series += len(part.get("names") or ())
        # a gauge sampled since the swap is newer than the kept one
        self.restore_state(kept, prefer_live_scalars=True)
        with self._lock:
            # the retired interval's tallies come back: its samples are
            # here again (kept) or leave as owned state (moved)
            self.processed += gen.processed
            self.imported += gen.imported
        return moved, moved_series

    def _restore_group(self, name: str, tname: str, target, snap: dict,
                       prefer_live_scalars: bool = False) -> int:
        kind = snap.get("kind")
        names, joined = snap.get("names", []), snap.get("joined", [])
        n = len(names)

        def keys():
            for i in range(n):
                jt = joined[i]
                yield i, MetricKey(name=names[i], type=tname,
                                   joined_tags=jt), \
                    (jt.split(",") if jt else [])

        if kind == "scalar":
            values = snap.get("values", ())
            messages = snap.get("messages")
            hostnames = snap.get("hostnames")
            skip_live = prefer_live_scalars and target.kind != "counter"
            merged = 0
            for i, key, tags in keys():
                if skip_live and key in target.interner.rows:
                    continue
                merged += 1
                if messages is not None:
                    target.sample(key, tags, float(values[i]), 1.0,
                                  message=messages[i],
                                  hostname=hostnames[i])
                else:
                    target.combine(key, tags, values[i])
            return merged
        if kind == "digest":
            if n == 0:
                return 0
            row_map = np.empty(n, np.int32)
            for i, key, tags in keys():
                row_map[i] = target._row(key, tags)
            rows = row_map[np.asarray(snap["rows"], np.int64)]
            mins, maxs = snap["mins"], snap["maxs"]
            finite = np.isfinite(mins)
            target.import_centroids_bulk(
                rows, snap["means"], snap["weights"], row_map[finite],
                mins[finite], maxs[finite])
            target.restore_stats(row_map, snap["count"], snap["vsum"],
                                 snap["vmin"], snap["vmax"], snap["recip"])
            return n
        if kind == "set":
            if snap.get("precision") != target.precision:
                log.warning("checkpoint restore: %s has HLL precision %s, "
                            "the store runs %d; skipping the group", name,
                            snap.get("precision"), target.precision)
                return 0
            registers = snap.get("registers", ())
            for i, key, tags in keys():
                target.import_registers(key, tags, registers[i])
            return n
        if kind == "topk":
            table = snap.get("table")
            if table is None or n == 0:
                return 0
            if (snap.get("depth"), snap.get("width")) != (target.depth,
                                                          target.width):
                log.warning("checkpoint restore: %s count-min geometry "
                            "%sx%s != the store's %dx%d; skipping the "
                            "group", name, snap.get("depth"),
                            snap.get("width"), target.depth, target.width)
                return 0
            series = snap.get("series", [])
            entries = []
            for i, key, tags in keys():
                s = series[i] if i < len(series) else {"keys": [],
                                                       "members": []}
                entries.append((key, tags, [tuple(p) for p in s["keys"]],
                                s["members"]))
            target.import_sketch(np.asarray(table, np.float32), entries)
            return n
        log.warning("checkpoint restore: group %s has unknown kind %r; "
                    "skipping", name, kind)
        return 0

    def _flush_scalars(self, group: ScalarGroup, mtype: MetricType,
                       out: List[InterMetric], now: int,
                       col: Optional[ColumnarFlush] = None):
        interner, values, _, _ = group.snapshot_and_reset()
        if col is not None and len(interner):
            block = columnar.scalar_block(
                interner, values,
                columnar.TYPE_COUNTER if mtype == MetricType.COUNTER
                else columnar.TYPE_GAUGE)
            if not columnar.has_sink_routing(block.tags[0]):
                col.add_block(block)
                return
            # sink-routed rows present (rare): per-row emission keeps
            # the routing
        for key, row in interner.rows.items():
            tags = interner.tags[row]
            out.append(InterMetric(
                name=key.name, timestamp=now, value=float(values[row]),
                tags=tags, type=mtype, sinks=route_info(tags)))

    def _flush_status(self, group: ScalarGroup, out: List[InterMetric],
                      now: int):
        interner, values, messages, hostnames = group.snapshot_and_reset()
        for key, row in interner.rows.items():
            tags = interner.tags[row]
            out.append(InterMetric(
                name=key.name, timestamp=now, value=float(values[row]),
                tags=tags, type=MetricType.STATUS, message=messages[row],
                hostname=hostnames[row], sinks=route_info(tags)))

    def _emit_digest_result(self, name: str, res, percentiles: List[float],
                            aggregates: HistogramAggregates,
                            out: List[InterMetric], now: int,
                            fwd: ForwardableState,
                            fwd_attr: Optional[str] = None,
                            col: Optional[ColumnarFlush] = None,
                            stream=None):
        """Emission half of one digest group's flush, on its fetched
        result (the serializer lane runs it in a pipelined flush):
        the columnar block, or the per-row rows of Histo.Flush
        (samplers.go:511-636) without ``col`` or for a sink-routed group.
        A forwarding group also hands on its drained planes (see
        ForwardableState): to the stream's forward lane when one is
        attached and the group emitted a block, else on ``fwd``."""
        interner, r = res
        agg = aggregates.value
        part = None
        if (fwd_attr is not None or col is not None) and len(interner):
            names = columnar.build_arenas(interner.names)
            tags = columnar.build_arenas(interner.joined)
        if fwd_attr is not None and len(interner):
            # the arenas the C++ encoders take, shared with the block
            if "packed_counts" in r:
                part = (names, tags, _packed_planes_from_result(r))
            else:
                part = (names, tags, r["digest_mean"], r["digest_weight"],
                        r["digest_min"], r["digest_max"])
        if col is not None and len(interner):
            if not columnar.has_sink_routing(tags[0]):
                block = columnar.digest_block(names, tags, r, agg,
                                              percentiles)
                col.add_block(block)
                if part is not None:
                    if stream is not None and stream.forward_streaming:
                        # this group's planes POST upstream now; a failed
                        # part re-merges into the live store
                        stream.emit_forward(name, fwd_attr, part,
                                            len(interner))
                    else:
                        setattr(fwd, fwd_attr, part)
                if stream is not None and block is not None:
                    stream.emit(name, [block], len(block))
                return
            # sink-routed rows present (rare): per-row emission keeps
            # the routing
        if part is not None:
            setattr(fwd, fwd_attr, part)
        for key, row in interner.rows.items():
            tags = interner.tags[row]
            sinks = route_info(tags)
            key_name = key.name

            def emit(suffix: str, value: float,
                     mtype: MetricType = MetricType.GAUGE):
                out.append(InterMetric(
                    name=f"{key_name}.{suffix}", timestamp=now, value=value,
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
                    name=f"{key_name}.{int(p * 100)}percentile",
                    timestamp=now, value=float(r["percentiles"][row, i]),
                    tags=list(tags), type=MetricType.GAUGE, sinks=sinks))

    @staticmethod
    def _emit_topk_result(res, out: List[InterMetric], now: int,
                          fwd: ForwardableState, forwarding: bool):
        """``{name}.topk`` counters tagged ``key:<member>``, one per live
        top-k entry; a forwarding flush leaves the sketch on ``fwd``."""
        interner, entries, sketch = res
        fwd.topk = sketch
        if forwarding:
            return
        for row, member, count in entries:
            tags = interner.tags[row]
            out.append(InterMetric(
                name=f"{interner.names[row]}.topk", timestamp=now,
                value=count, tags=list(tags) + [f"key:{member}"],
                type=MetricType.COUNTER, sinks=route_info(tags)))

    def _emit_set_result(self, name: str, res,
                         out: Optional[List[InterMetric]], now: int,
                         fwd_list: Optional[list] = None,
                         col: Optional[ColumnarFlush] = None, stream=None):
        """Emission half of one set group's flush: the estimates as a
        columnar block (or per-row gauges), the registers a local
        forwards as per-row entries."""
        interner, estimates, registers = res
        if (col is not None and out is not None and fwd_list is None
                and len(interner)):
            block = columnar.scalar_block(interner, estimates,
                                          columnar.TYPE_GAUGE)
            if not columnar.has_sink_routing(block.tags[0]):
                col.add_block(block)
                if stream is not None:
                    stream.emit(name, [block], len(block))
                return
        for key, row in interner.rows.items():
            tags = interner.tags[row]
            if out is not None:
                out.append(InterMetric(
                    name=key.name, timestamp=now,
                    value=float(estimates[row]), tags=tags,
                    type=MetricType.GAUGE, sinks=route_info(tags)))
            if fwd_list is not None:
                fwd_list.append((key.name, tags, registers[row],
                                 self.hll_precision))
