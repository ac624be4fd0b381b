"""The tiered digest store: a packed pool for every series, dense slots
for the active ones (``digest_storage: tiered``).

Port of ``veneur_tpu/core/tiered.py``. At fleet density (a few live
centroids a series) the dense and slab planes are mostly zeros; here:

* **Pool tier** (every series starts there): per row, a packed centroid
  list of ``pool_centroids`` (PK, 16 by default) slots, u16
  range-quantized means and bfloat16 weight bits, plus a PK-bin float32
  accumulator the staged chunks scatter into and the row's float32
  scalar stats: ``pool_bytes_per_row(16)`` = 228 B against ~1.7 KB a
  dense row. The bins are also the row's anchors (``bin_pool_samples``)
  and the shift guard's input; a guard trip compacts the bins into the
  packed planes through K2 at merge width 2 x PK.
* **Dense tier**: a series whose interval activity crosses
  ``promote_samples`` (after a ``promote_intervals`` streak, kept across
  generations by the :class:`TierDirectory`) takes a slot in an embedded
  dense ``DigestGroup`` mid-interval; the promotion moves its pool state
  into the dense temp on the device and clears the pool row, so counts
  are conserved exactly. After ``demote_intervals`` idle intervals it
  goes back to the pool at a flush boundary.

The pool flushes from the packed form: the bins compact into the
dequantized centroids (K2), percentiles from ``quantile`` (no K1); the
dense bank flushes through K1. A forwarding flush packs both tiers and
splices them into row order. The snapshot flattens both tiers into the
per-row centroid runs every digest store restores from.

The pool's planes update in place (the JAX package donates them), and a
snapshot copies them on the device under the store lock. The JAX
package's ``lax.cond`` guards are Python branches: one host sync a chunk.
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from veneur_tpu_torch.core import slab
from veneur_tpu_torch.core.store import (
    DEFAULT_CHUNK,
    DEFAULT_INITIAL_CAPACITY,
    DigestGroup,
    DigestStaging,
    Interner,
    _fetch_copies,
    _fill_stat_results,
    _scatter_extrema,
    _snapshot_copies,
    begin_compute_ladder,
    flatten_digest_state,
    kernel_rung,
)
from veneur_tpu_torch.device import resolve_device
from veneur_tpu_torch.obs import kernels as obs_kernels
from veneur_tpu_torch.ops import tdigest as td_ops
from veneur_tpu_torch.ops import tdigest_cuda

log = logging.getLogger("veneur.tiered")

POOL_SLAB_ROWS_DEFAULT = 1 << 18
DEFAULT_POOL_CENTROIDS = 16
DEFAULT_PROMOTE_SAMPLES = 64
DEFAULT_PROMOTE_INTERVALS = 2
DEFAULT_DEMOTE_INTERVALS = 3
_INF = math.inf
_TINY = torch.finfo(torch.float32).tiny


class PoolSlab(NamedTuple):
    """Resident pool state of one slab of series rows, as flat planes.

    mq/wb: the packed digest, int16 bit patterns of u16 quantized means
    (against the row's [fmin, fmax] frame) and of bfloat16 weights (wb 0
    is the empty slot). bw/bwm: the PK-bin accumulator staged chunks
    scatter into. dmin/dmax: imported digests' extrema (they bound the
    final digest only); the interval's observed extrema ride vmin/vmax."""

    mq: torch.Tensor     # [slab*PK] int16 (u16 quantized means)
    wb: torch.Tensor     # [slab*PK] int16 (bfloat16 weight bits)
    fmin: torch.Tensor   # [slab] quantization frame minima (+inf empty)
    fmax: torch.Tensor   # [slab] frame maxima (-inf empty)
    bw: torch.Tensor     # [slab*PK] bin weights
    bwm: torch.Tensor    # [slab*PK] bin weighted mean sums
    dmin: torch.Tensor   # [slab] imported minima (+inf empty)
    dmax: torch.Tensor   # [slab] imported maxima (-inf empty)
    count: torch.Tensor  # [slab] total weight
    vsum: torch.Tensor   # [slab] weighted sample sum
    vmin: torch.Tensor   # [slab] observed minima
    vmax: torch.Tensor   # [slab] observed maxima
    recip: torch.Tensor  # [slab] weighted reciprocal sum (hmean)


def _init_pool_slab(slab_rows: int, pk: int, device) -> PoolSlab:
    def full(n, v, dtype=torch.float32):
        return torch.full((n,), v, dtype=dtype, device=device)

    n, k = slab_rows, slab_rows * pk
    return PoolSlab(
        mq=full(k, 0, torch.int16), wb=full(k, 0, torch.int16),
        fmin=full(n, _INF), fmax=full(n, -_INF), bw=full(k, 0.0),
        bwm=full(k, 0.0), dmin=full(n, _INF), dmax=full(n, -_INF),
        count=full(n, 0.0), vsum=full(n, 0.0), vmin=full(n, _INF),
        vmax=full(n, -_INF), recip=full(n, 0.0))


def pool_bytes_per_row(pk: int) -> int:
    """Resident pool bytes a series row: the capacity plan's number."""
    return 2 * pk * 2 + 2 * pk * 4 + 9 * 4


def _pool_compact(pool: PoolSlab, slab_rows: int, pk: int, pcomp: float):
    """Merge the bins with the packed centroids through K2 (merge width
    2 x PK): dequantize, sort the bin centroids (``lax.sort`` in the JAX
    package, unstable: compare results by mass and quantiles). Returns
    the drained float32 (mean, weight) [slab, PK]; reads the pool only.

    The kernel takes its a half row-ascending: the packed planes keep the
    compaction's dead gap slots (+inf once dequantized), so their means
    are gap-filled with a running max first (leading gaps -inf), as the
    kernel's own outputs are. Dead slots weigh 0 either way."""
    m, w = td_ops.dequantize_centroids(
        pool.mq.view(slab_rows, pk), pool.wb.view(slab_rows, pk),
        pool.fmin, pool.fmax)
    m = torch.cummax(torch.where(w > 0, m, -_INF), 1).values
    b_w = pool.bw.view(slab_rows, pk)
    b_live = b_w > 0
    b_m = torch.where(b_live, pool.bwm.view(slab_rows, pk)
                      / torch.where(b_live, b_w, 1.0), _INF)
    b_m, order = torch.sort(b_m, dim=-1)
    b_w = torch.gather(b_w, -1, order)
    return tdigest_cuda.compress_presorted(m, w, b_m, b_w, pcomp, pk)


def _pool_trigger_rows(pool: PoolSlab, rows, weights, slab_rows: int,
                       pk: int, pcomp: float):
    """The pool guard's row triggers ([slab] bool each): a row whose
    heaviest bin would cross its k-scale envelope (clump), and a row
    with live bins that gets more mass from this chunk than it holds
    (dominance). rows carry the padding sentinel ``slab_rows``."""
    inc = torch.zeros(slab_rows + 1, dtype=torch.float32,
                      device=weights.device).index_add_(
        0, rows, weights.float())[:slab_rows]
    # the packed weights alone (dequantize_centroids' weight half)
    pw = pool.wb.view(torch.bfloat16).float().view(slab_rows, pk)
    bw2 = pool.bw.view(slab_rows, pk)
    tot = pw.sum(1) + bw2.sum(1)
    over = ((inc > 0) & (tot > float(pk))
            & (bw2.amax(1) + inc > 2.0 * (tot + inc) / pcomp))
    dom = (inc > tot) & (bw2.sum(1) > 0)
    return over, dom


def _pool_guard_masses(pool: PoolSlab, rows, values, weights,
                       slab_rows: int, pk: int, pcomp: float):
    """The pool guard's three signals: the shift guard's mass pair
    (against the bins) and the count of rows tripping the clump or
    dominance triggers (see the JAX module). rows carry the padding
    sentinel ``slab_rows``."""
    shifted, total = td_ops.shift_masses(pool.bw, pool.bwm, rows, values,
                                         weights, slab_rows, anchors=pk)
    over, dom = _pool_trigger_rows(pool, rows, weights, slab_rows, pk,
                                   pcomp)
    return shifted, total, over.float().sum() + dom.float().sum()


def _pool_guard_apply(pool: PoolSlab, slab_rows: int, pk: int,
                      pcomp: float) -> None:
    """The guard's drain, in place: the bins compact into the packed
    planes (requantized) and zero."""
    nm, nw = _pool_compact(pool, slab_rows, pk, pcomp)
    mq, wb, fmin, fmax = td_ops.quantize_centroids(nm, nw)
    pool.mq.copy_(mq.reshape(-1))
    pool.wb.copy_(wb.reshape(-1))
    pool.fmin.copy_(fmin)
    pool.fmax.copy_(fmax)
    pool.bw.zero_()
    pool.bwm.zero_()


def _guard_fires(shifted, total, over_dom) -> bool:
    """The guard's decision over its three signals (one host sync)."""
    pred = ((shifted > td_ops.SHIFT_GUARD_FRAC
             * torch.clamp_min(total, _TINY)) | (over_dom > 0))
    return bool(pred.item())


def _guard_drain_pool(pool: PoolSlab, rows, values, weights,
                      slab_rows: int, pk: int, pcomp: float) -> bool:
    """The pool's shift guard: drain when the chunk's mass is disjoint
    from what the bins cover for more than SHIFT_GUARD_FRAC of it, or a
    row's heaviest bin would cross its k-scale envelope, or a row with
    live bins gets more mass from this chunk than it holds (see the JAX
    module). One host sync a chunk. Returns whether it drained."""
    if not _guard_fires(*_pool_guard_masses(
            pool, rows, values, weights, slab_rows, pk, pcomp)):
        return False
    _pool_guard_apply(pool, slab_rows, pk, pcomp)
    return True


def _pool_bin(pool: PoolSlab, rows, values, weights, slab_rows: int,
              pk: int, pcomp: float):
    """Bin a chunk against the pool (its bins and packed planes); returns
    (scatter rows with padding on row 0, flat bin index, weights zeroed on
    padding, values zeroed where dead, the live mask, the valid mask)."""
    r, v, w, b = td_ops.bin_pool_samples(
        rows, values, weights, slab_rows, pk, pcomp, pool.bw, pool.bwm,
        pool.mq, pool.wb, pool.fmin, pool.fmax)
    valid = r < slab_rows
    live = w > 0
    rr = torch.where(valid, r, 0)
    wz = torch.where(valid, w, 0.0)
    vz = torch.where(live, v, 0.0)
    pool.bw.index_add_(0, rr * pk + b, wz)
    pool.bwm.index_add_(0, rr * pk + b, wz * vz)
    return rr, v, wz, vz, valid & live


def _pool_scatter_samples(pool: PoolSlab, rows, values, weights,
                          slab_rows: int, pk: int, pcomp: float) -> None:
    """Bin a chunk of samples (slab-local rows, the padding sentinel at
    weight 0) into a pool slab's bins and stats, in place."""
    rr, v, wz, vz, ok = _pool_bin(pool, rows, values, weights, slab_rows,
                                  pk, pcomp)
    pool.count.index_add_(0, rr, wz)
    pool.vsum.index_add_(0, rr, wz * vz)
    pool.vmin.scatter_reduce_(0, rr, torch.where(ok, v, _INF), "amin")
    pool.vmax.scatter_reduce_(0, rr, torch.where(ok, v, -_INF), "amax")
    pool.recip.index_add_(0, rr, torch.where(ok, wz / v, 0.0))


def _pool_ingest(pool: PoolSlab, rows, values, weights, slab_rows: int,
                 pk: int, pcomp: float) -> None:
    """Fold one chunk of samples (slab-LOCAL rows; >= slab is padding)
    into a pool slab's bins and stats, in place, behind the guard."""
    rows, weights = slab._local_rows(rows, weights, slab_rows)
    _guard_drain_pool(pool, rows, values, weights, slab_rows, pk, pcomp)
    _pool_scatter_samples(pool, rows, values, weights, slab_rows, pk,
                          pcomp)


def _pool_scatter_imports(pool: PoolSlab, rows, means, weights, stat_rows,
                          stat_mins, stat_maxs, slab_rows: int, pk: int,
                          pcomp: float) -> None:
    """Bin imported centroids into a pool slab's bins (no local scalar
    stats, samplers.go:473-480) and fold each digest's extrema into
    dmin/dmax, in place."""
    _pool_bin(pool, rows, means, weights, slab_rows, pk, pcomp)
    _scatter_extrema(pool.dmin, pool.dmax, stat_rows.long(), stat_mins,
                     stat_maxs)


def _pool_import(pool: PoolSlab, rows, means, weights, stat_rows,
                 stat_mins, stat_maxs, slab_rows: int, pk: int,
                 pcomp: float) -> None:
    """Fold imported digest CENTROIDS into a pool slab, in place, behind
    the guard, without touching the local scalar stats; each digest's
    extrema land on dmin/dmax."""
    rows, weights = slab._local_rows(rows, weights, slab_rows)
    _guard_drain_pool(pool, rows, means, weights, slab_rows, pk, pcomp)
    _pool_scatter_imports(pool, rows, means, weights, stat_rows, stat_mins,
                          stat_maxs, slab_rows, pk, pcomp)


def _pool_flush(pool: PoolSlab, qs, slab_rows: int, pk: int, pcomp: float):
    """Flush one pool slab from the packed form: compact (K2), then the
    percentiles by ``quantile`` over the result, never a dense [S, K]
    plane. Reads the pool only. Returns (drained mean, weight [slab, PK],
    extrema, percentiles, count, vsum, vmin, vmax, recip)."""
    nm, nw = _pool_compact(pool, slab_rows, pk, pcomp)
    mn = torch.minimum(pool.vmin, pool.dmin)
    mx = torch.maximum(pool.vmax, pool.dmax)
    pcts = td_ops.quantile(td_ops.TDigest(nm, nw, mn, mx), qs)
    return (nm, nw, mn, mx, pcts, pool.count, pool.vsum, pool.vmin,
            pool.vmax, pool.recip)


def _promote_rows(pool: PoolSlab, temp: td_ops.TempCentroids, ddmin,
                  ddmax, rows, slots, slab_rows: int, pk: int,
                  compression: float) -> None:
    """Move rows' pool state into the dense tier on the device, in place:
    the dequantized packed centroids and the bin centroids enter the
    dense temp's binning as weighted samples (no stats, like any import),
    the scalar stats and imported extrema scatter into the dense slots,
    and the pool rows clear. rows are slab-LOCAL; slots are dense slots."""
    nslots = temp.sum_w.shape[0]
    m, w = td_ops.dequantize_centroids(
        pool.mq.view(slab_rows, pk)[rows], pool.wb.view(slab_rows, pk)[rows],
        pool.fmin[rows], pool.fmax[rows])
    b_w = pool.bw.view(slab_rows, pk)[rows]
    b_live = b_w > 0
    b_m = torch.where(b_live, pool.bwm.view(slab_rows, pk)[rows]
                      / torch.where(b_live, b_w, 1.0), 0.0)
    mflat = torch.cat([torch.where(w > 0, m, 0.0), b_m], 1).reshape(-1)
    wflat = torch.cat([w, b_w], 1).reshape(-1)
    srep = slots[:, None].expand(-1, 2 * pk).reshape(-1)
    srep = torch.where(wflat > 0, srep, nslots)
    td_ops.ingest_chunk(temp, srep, mflat, wflat, compression,
                        update_stats=False)
    temp.count.index_add_(0, slots, pool.count[rows])
    temp.vsum.index_add_(0, slots, pool.vsum[rows])
    temp.vmin.scatter_reduce_(0, slots, pool.vmin[rows], "amin")
    temp.vmax.scatter_reduce_(0, slots, pool.vmax[rows], "amax")
    temp.recip.index_add_(0, slots, pool.recip[rows])
    ddmin.scatter_reduce_(0, slots, pool.dmin[rows], "amin")
    ddmax.scatter_reduce_(0, slots, pool.dmax[rows], "amax")
    flat = (rows[:, None] * pk + torch.arange(pk, device=rows.device)) \
        .reshape(-1)
    for plane in (pool.mq, pool.wb, pool.bw, pool.bwm):
        plane.index_fill_(0, flat, 0)
    for plane, fill in ((pool.fmin, _INF), (pool.fmax, -_INF),
                        (pool.dmin, _INF), (pool.dmax, -_INF),
                        (pool.count, 0.0), (pool.vsum, 0.0),
                        (pool.vmin, _INF), (pool.vmax, -_INF),
                        (pool.recip, 0.0)):
        plane.index_fill_(0, rows, fill)


def _pool_restore_stats(pool: PoolSlab, rows, count, vsum, vmin, vmax,
                        recip) -> None:
    """Scatter recovered per-row scalar stats into a pool slab, in place
    (the checkpoint restore's twin of ``_restore_temp_stats``)."""
    pool.count.index_add_(0, rows, count)
    pool.vsum.index_add_(0, rows, vsum)
    pool.vmin.scatter_reduce_(0, rows, vmin, "amin")
    pool.vmax.scatter_reduce_(0, rows, vmax, "amax")
    pool.recip.index_add_(0, rows, recip)


def dequantize_host(mq: np.ndarray, wb: np.ndarray, fmin: np.ndarray,
                    fmax: np.ndarray):
    """numpy twin of ``ops/tdigest.dequantize_centroids`` (mq and wb as
    uint16): the snapshot's flatten decodes the pool with it."""
    weight = (wb.astype(np.uint32) << 16).view(np.float32)
    span = np.where(np.isfinite(fmax - fmin), fmax - fmin, 0.0)
    base = np.where(np.isfinite(fmin), fmin, 0.0)
    mean = base[:, None] + mq.astype(np.float32) * (span[:, None]
                                                    / 65535.0)
    return mean, weight.astype(np.float32)


class TierDirectory:
    """Promotion and demotion memory across generations, shared by every
    generation's twin of one tiered group (``fresh()`` hands it on).

    Keys are (name, joined_tags): rows re-intern every interval, so
    residency keys on the series. Its own lock: the live generation reads
    it at intern time under the store lock, the retired one updates it
    off-lock at its flush; it takes no other lock. Its size is bounded by
    the dense rows plus the rows hot in the last interval."""

    def __init__(self, promote_samples: int = DEFAULT_PROMOTE_SAMPLES,
                 promote_intervals: int = DEFAULT_PROMOTE_INTERVALS,
                 demote_intervals: int = DEFAULT_DEMOTE_INTERVALS):
        self._lock = threading.Lock()
        self.promote_samples = max(int(promote_samples), 1)
        self.promote_intervals = max(int(promote_intervals), 1)
        self.demote_intervals = max(int(demote_intervals), 1)
        self._dense: Dict[Tuple[str, str], int] = {}  # key -> idle count
        self._warm: Dict[Tuple[str, str], int] = {}   # key -> hot streak
        self.promotions = 0
        self.demotions = 0

    def is_dense(self, key: Tuple[str, str]) -> bool:
        with self._lock:
            return key in self._dense

    def dense_count(self) -> int:
        with self._lock:
            return len(self._dense)

    def should_promote(self, key: Tuple[str, str]) -> bool:
        """Once a row's interval activity crossed ``promote_samples``:
        does its streak from past intervals plus this one reach
        ``promote_intervals``?"""
        with self._lock:
            if key in self._dense:
                return False
            return self._warm.get(key, 0) + 1 >= self.promote_intervals

    def note_promoted(self, keys) -> None:
        with self._lock:
            for k in keys:
                self._warm.pop(k, None)
                if k not in self._dense:
                    self._dense[k] = 0
                    self.promotions += 1

    def end_interval(self, hot_keys) -> None:
        """The flush boundary's bookkeeping: hot pool keys build their
        streak (and promote when it is long enough); dense keys idle for
        ``demote_intervals`` intervals in a row demote."""
        hot = set(hot_keys)
        with self._lock:
            new_warm = {}
            for k in hot:
                if k in self._dense:
                    continue
                streak = self._warm.get(k, 0) + 1
                if streak >= self.promote_intervals:
                    self._dense[k] = 0
                    self.promotions += 1
                else:
                    new_warm[k] = streak
            self._warm = new_warm
            dropped = []
            for k, idle in self._dense.items():
                if k in hot:
                    self._dense[k] = 0
                else:
                    idle += 1
                    if idle >= self.demote_intervals:
                        dropped.append(k)
                    else:
                        self._dense[k] = idle
            for k in dropped:
                del self._dense[k]
                self.demotions += 1


def _splice_packed(n: int, pool_counts: np.ndarray, pool_mq: np.ndarray,
                   pool_wb: np.ndarray, dense_rows: np.ndarray,
                   d_counts: np.ndarray, d_mq: np.ndarray,
                   d_wb: np.ndarray):
    """Stitch the pool's packed output (row order, zero counts at dense
    rows) and the dense tier's (slot order) into one row-ordered packed
    triple (numpy, O(L))."""
    counts = pool_counts.astype(np.int64)
    if len(dense_rows):
        counts[dense_rows] = d_counts.astype(np.int64)
    out_ends = np.cumsum(counts)
    out_starts = out_ends - counts
    total = int(out_ends[-1]) if n else 0
    mq = np.zeros(total, np.uint16)
    wb = np.zeros(total, np.uint16)
    pc = pool_counts.astype(np.int64)
    if pool_mq.size:
        rows_rep = np.repeat(np.arange(n, dtype=np.int64), pc)
        pstarts = np.cumsum(pc) - pc
        within = np.arange(pool_mq.size, dtype=np.int64) \
            - np.repeat(pstarts, pc)
        pos = out_starts[rows_rep] + within
        mq[pos] = pool_mq
        wb[pos] = pool_wb
    if len(dense_rows) and d_mq.size:
        dc = d_counts.astype(np.int64)
        drep = np.repeat(dense_rows, dc)
        dstarts = np.cumsum(dc) - dc
        dwithin = np.arange(d_mq.size, dtype=np.int64) \
            - np.repeat(dstarts, dc)
        pos = out_starts[drep] + dwithin
        mq[pos] = d_mq
        wb[pos] = d_wb
    return counts.astype(np.uint16), mq, wb


class TieredDigestGroup(DigestStaging):
    """The dense ``DigestGroup``'s contract with packed/dense residency
    (``digest_storage: tiered``): the interner, the shared staging,
    ``flush`` / ``flush_begin`` returning (interner, result dict) with
    the same keys, the two-phase snapshot and ``restore_stats``. Every
    series lives in the packed pool until the :class:`TierDirectory`
    promotes it; the pool flushes from the packed form."""

    # set by MetricStore._swap_generation: a retired group's flush drops
    # its device state instead of reallocating it
    _retired = False
    # pool slabs dispatched ahead of the fetch (MetricStore stamps it)
    _pipeline_window = 1
    # the storage its profiler scopes name (obs/kernels.py)
    _SCOPE = "tiered"

    def __init__(self, slab_rows: int = POOL_SLAB_ROWS_DEFAULT,
                 chunk: int = DEFAULT_CHUNK,
                 compression: float = td_ops.DEFAULT_COMPRESSION,
                 pool_centroids: int = DEFAULT_POOL_CENTROIDS,
                 promote_samples: int = DEFAULT_PROMOTE_SAMPLES,
                 promote_intervals: int = DEFAULT_PROMOTE_INTERVALS,
                 demote_intervals: int = DEFAULT_DEMOTE_INTERVALS,
                 dense_capacity: int = DEFAULT_INITIAL_CAPACITY,
                 directory: Optional[TierDirectory] = None, device=None):
        if slab_rows <= 0:
            raise ValueError(f"slab_rows must be positive, got {slab_rows}")
        pk = int(pool_centroids)
        if pk < 8 or pk & (pk - 1):
            raise ValueError(
                f"pool_centroids must be a power of two >= 8, got {pk}")
        self.device = resolve_device(device)
        self.interner = Interner()
        self.compression = compression
        self.k = td_ops.size_bound(compression)
        self.chunk = chunk
        self.slab_rows = min(slab_rows, slab.MAX_SLAB_ROWS)
        # the pool never holds more centroids a row than the dense
        # tier's K (a flush widens pool rows into [n, K] planes)
        self.pk = min(pk, self.k)
        if self.pk != pk:
            log.warning(
                "tier_pool_centroids=%d exceeds the dense tier's %d-slot "
                "digest at compression %.0f; clamped to %d", pk, self.k,
                compression, self.pk)
        # the pool's k-scale compression: C + 2 clusters fill the PK slots
        self.pcomp = float(self.pk - 2)
        self.promote_samples = max(int(promote_samples), 1)
        self.directory = directory if directory is not None else \
            TierDirectory(promote_samples, promote_intervals,
                          demote_intervals)
        self._dense = self._make_dense_bank(dense_capacity, chunk,
                                            compression)
        self.pools: List[PoolSlab] = [self._new_pool_slab()]
        self._device_dirty = False
        self._slot = np.full(self.slab_rows, -1, np.int32)
        self._activity = np.zeros(self.slab_rows, np.int64)
        self._dense_rows: List[int] = []
        self._init_staging()

    def _make_dense_bank(self, dense_capacity: int, chunk: int,
                         compression: float) -> DigestGroup:
        """The hot tier's bank (override point: the mesh tiered group
        embeds a series-sharded MeshDigestGroup in slot mode)."""
        return DigestGroup(dense_capacity, chunk, compression, self.device)

    def _new_pool_slab(self) -> PoolSlab:
        return _init_pool_slab(self.slab_rows, self.pk, self.device)

    # -- capacity ---------------------------------------------------------

    @property
    def capacity(self) -> int:
        return len(self.pools) * self.slab_rows

    def hbm_bytes(self) -> dict:
        """Resident-plane byte accounting: a dense row costs the full-K
        footprint (digest, temp, anchor summary, scalars), a pool row
        ``pool_bytes_per_row``."""
        a = td_ops.BELOW_MASS_ANCHORS
        dense_per_row = self.k * 4 * 4 + a * 2 * 4 + 9 * 4
        pool_bytes = self.capacity * pool_bytes_per_row(self.pk)
        dense_bytes = self._dense.capacity * dense_per_row
        return {"pool_bytes": pool_bytes,
                "dense_bytes": dense_bytes,
                "total_bytes": pool_bytes + dense_bytes,
                "pool_bytes_per_row": pool_bytes_per_row(self.pk),
                "dense_bytes_per_row": dense_per_row,
                "dense_rows": len(self._dense_rows),
                "pool_rows": self.capacity}

    def fresh(self) -> "TieredDigestGroup":
        """Empty same-config twin (the flush's generation swap); the
        shared TierDirectory carries residency across the swap."""
        return TieredDigestGroup(
            self.slab_rows, self.chunk, self.compression, self.pk,
            self.directory.promote_samples,
            self.directory.promote_intervals,
            self.directory.demote_intervals, self._dense.capacity,
            directory=self.directory, device=self.device)

    def ensure_capacity(self, max_row: int):
        while max_row >= self.capacity:
            self.pools.append(self._new_pool_slab())
            self._rows[self._fill:] = self.capacity
            self._imp_rows[self._imp_fill:] = self.capacity
            self._imp_stat_rows[self._imp_stat_fill:] = self.capacity
        if max_row >= len(self._slot):
            grow = self.capacity - len(self._slot)
            self._slot = np.concatenate(
                [self._slot, np.full(grow, -1, np.int32)])
            self._activity = np.concatenate(
                [self._activity, np.zeros(grow, np.int64)])

    def _row(self, key, tags) -> int:
        first_sight = len(self.interner)
        row = self._intern_row(key, tags)
        if row >= self.capacity:
            self.ensure_capacity(row)
        # a first-sight spill interns the overflow row at exactly
        # first_sight too: it must not inherit the sampled key's
        # residency
        if (row == first_sight and row != self._overflow_row
                and self.directory.is_dense(
                    (key.name, key.joined_tags))):
            self._assign_dense(row)
        return row

    def _assign_dense(self, row: int) -> int:
        slot = len(self._dense_rows)
        self._dense_rows.append(row)
        self._slot[row] = slot
        self._dense.ensure_capacity(slot)
        return slot

    def _sync_plumbing(self):
        """The outer group's breaker on the embedded dense bank (the store
        stamps the outer group at each swap); the bank's quarantine stays
        off: the outer staging scrubbed everything it forwards."""
        self._dense._compute = self._compute

    def _note_activity(self, rows, n: int) -> None:
        if isinstance(rows, np.ndarray):
            if len(rows):
                np.add.at(self._activity, rows, n)
        else:
            self._activity[rows] += n

    # -- drains -----------------------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return slab._to_dev(a, self.device)

    def _partition(self, rows: np.ndarray, *arrays):
        """Split staged entries into (dense slots, arrays), or None, and
        per-pool-slab (slab index, slab-local rows, arrays) spans, order
        kept within each. Sentinel rows (>= capacity) drop out."""
        valid = rows < self.capacity
        slot = np.where(valid,
                        self._slot[np.minimum(rows, self.capacity - 1)], -1)
        dmask = valid & (slot >= 0)
        dense = None
        if dmask.any():
            dense = (slot[dmask].astype(np.int32),
                     [a[dmask] for a in arrays])
        pmask = valid & (slot < 0)
        spans = []
        if pmask.any():
            prow = rows[pmask]
            parrs = [a[pmask] for a in arrays]
            slabs = prow // self.slab_rows
            for i in np.flatnonzero(np.bincount(slabs)):
                sel = slabs == i
                spans.append((int(i), (prow[sel] - i * self.slab_rows)
                              .astype(np.int64), [a[sel] for a in parrs]))
        return dense, spans

    def _drain_samples(self):
        if self._fill == 0:
            return
        self._device_dirty = True
        self._sync_plumbing()
        fill = self._fill
        rows, vals, wts = (self._rows[:fill], self._vals[:fill],
                           self._wts[:fill])
        self._new_sample_buffers()
        dense, spans = self._partition(rows, vals, wts)
        if dense is not None:
            slots, (v, w) = dense
            self._dense.sample_many(slots, v, w)
        for i, local, (v, w) in spans:
            self._pool_drain_samples(i, local, v, w)
        self._maybe_promote(rows)

    def _pool_drain_samples(self, i: int, local: np.ndarray,
                            vals: np.ndarray, wts: np.ndarray) -> None:
        """One slab's span of staged samples into its pool slab
        (override point: the mesh tiered group routes the span by
        shard)."""
        with obs_kernels.scope(f"drain.digest.{self._SCOPE}", self.device):
            _pool_ingest(self.pools[i], self._dev(local), self._dev(vals),
                         self._dev(wts), self.slab_rows, self.pk,
                         self.pcomp)

    def _drain_imports(self):
        if self._imp_fill == 0 and self._imp_stat_fill == 0:
            return
        self._device_dirty = True
        self._sync_plumbing()
        nf, ns = self._imp_fill, self._imp_stat_fill
        rows, means, wts = (self._imp_rows[:nf], self._imp_means[:nf],
                            self._imp_wts[:nf])
        stat_rows = self._imp_stat_rows[:ns]
        stat_mins = self._imp_stat_mins[:ns]
        stat_maxs = self._imp_stat_maxs[:ns]
        self._new_import_buffers()
        dense_c, pool_c = self._partition(rows, means, wts)
        dense_s, pool_s = self._partition(stat_rows, stat_mins, stat_maxs)
        empty = (np.empty(0, np.int32),
                 [np.empty(0, np.float32), np.empty(0, np.float32)])
        if dense_c is not None or dense_s is not None:
            slots, (m, w) = dense_c if dense_c is not None else empty
            s_slots, (s_mn, s_mx) = dense_s if dense_s is not None else empty
            self._dense.import_centroids_bulk(slots, m, w, s_slots, s_mn,
                                              s_mx)
        cents = {i: (local, arrs) for i, local, arrs in pool_c}
        stats = {i: (local, arrs) for i, local, arrs in pool_s}
        empty_r = np.empty(0, np.int64)
        empty_f = np.empty(0, np.float32)
        for i in sorted(set(cents) | set(stats)):
            c_local, (c_m, c_w) = cents.get(i, (empty_r,
                                                (empty_f, empty_f)))
            s_local, (s_mn, s_mx) = stats.get(i, (empty_r,
                                                  (empty_f, empty_f)))
            self._pool_drain_imports(i, c_local, c_m, c_w, s_local, s_mn,
                                     s_mx)
        self._maybe_promote(rows)

    def _pool_drain_imports(self, i: int, c_local, c_means, c_wts,
                            s_local, s_mins, s_maxs) -> None:
        """One slab's span of staged imports (centroids and digest
        extrema) into its pool slab (override point, like
        ``_pool_drain_samples``)."""
        with obs_kernels.scope(f"drain.digest.{self._SCOPE}", self.device):
            _pool_import(self.pools[i], self._dev(c_local),
                         self._dev(c_means), self._dev(c_wts),
                         self._dev(s_local), self._dev(s_mins),
                         self._dev(s_maxs), self.slab_rows, self.pk,
                         self.pcomp)

    # -- promotion --------------------------------------------------------

    def _maybe_promote(self, touched_rows: np.ndarray):
        """Promote pool rows whose interval activity crossed the bar,
        checked over the rows the drained chunk touched only (in row
        order; the candidates are found before the sort, so a chunk
        with none sorts nothing). The directory supplies the
        cross-interval hysteresis; the device program moves each row's
        pool state into its new dense slot."""
        touched_rows = touched_rows[touched_rows < len(self.interner)]
        cand = np.unique(touched_rows[
            (self._slot[touched_rows] < 0)
            & (self._activity[touched_rows] >= self.promote_samples)])
        if not len(cand):
            return
        names, joined = self.interner.names, self.interner.joined
        promote = [int(r) for r in cand
                   if self.directory.should_promote((names[r], joined[r]))]
        if not promote:
            return
        rows = np.asarray(promote, np.int64)
        slots = np.asarray([self._assign_dense(r) for r in promote],
                           np.int64)
        self._sync_plumbing()
        d = self._dense
        d._drain_staging()  # promoted mass lands on settled bins
        d._device_dirty = True
        slabs = rows // self.slab_rows
        with obs_kernels.scope(f"drain.digest.{self._SCOPE}", self.device):
            for i in np.unique(slabs):
                sel = slabs == i
                _promote_rows(self.pools[int(i)], d.temp, d.dmin, d.dmax,
                              self._dev(rows[sel] - i * self.slab_rows),
                              self._dev(slots[sel]), self.slab_rows,
                              self.pk, self.compression)
        self.directory.note_promoted(
            [(names[r], joined[r]) for r in promote])
        log.debug("promoted %d series to the dense tier", len(promote))

    # -- flush ------------------------------------------------------------

    def _reset_device(self):
        self.pools = [self._new_pool_slab() for _ in range(len(self.pools))]
        self._dense._init_device()
        self._dense._init_staging()
        self._device_dirty = False

    def _drop_device(self):
        self.pools = []
        self._dense._drop_device()
        self._device_dirty = False
        self._drop_staging()

    def flush(self, percentiles: List[float], want_digests=False,
              want_stats=None):
        """The dense group's contract: (interner, host result dict);
        ``want_digests="packed"`` packs both tiers on the device and
        returns the spliced row-ordered packed triple, True the planes
        widened to [n, K]."""
        return self.flush_begin(percentiles, want_digests, want_stats)()

    def flush_begin(self, percentiles: List[float], want_digests=False,
                    want_stats=None):
        """Two-phase flush: drain staging and dispatch the dense bank's
        program and the first ``_pipeline_window`` pool slabs' now;
        ``finish()`` fetches the pool slab by slab (dispatching ahead),
        then the dense bank, splices, and commits: the interval's
        directory bookkeeping and the interner swap run only once every
        program and fetch succeeded, so a failure leaves the group whole
        for the store's re-merge rung."""
        self._drain_staging()
        n = len(self.interner)
        if n == 0:
            res = self._flush_empty()
            return lambda: res
        self._sync_plumbing()
        fin = begin_compute_ladder(
            self._compute,
            lambda: self._flush_dispatch(n, percentiles, want_digests,
                                         want_stats),
            self._flush_collect, kernel_rung(self.device))
        return lambda: self._flush_commit(n, fin())

    def _flush_empty(self):
        interner, self.interner = self.interner, Interner()
        if self._retired:
            self._drop_device()
            return interner, {}
        if self._device_dirty:
            self._reset_device()
        self._init_staging()
        return interner, {}

    def _flush_commit(self, n: int, out: dict):
        self._end_interval(n)
        interner, self.interner = self.interner, Interner()
        if self._retired:
            self._drop_device()
        else:
            self._reset_device()
            self._init_staging()
        self._slot = np.full(max(len(self._slot), self.slab_rows), -1,
                             np.int32)
        self._activity = np.zeros(len(self._slot), np.int64)
        self._dense_rows = []
        return interner, out

    def _end_interval(self, n: int):
        """The directory's flush-boundary bookkeeping (host only): which
        series were hot this interval."""
        hot_rows = np.flatnonzero(self._activity[:n] >= self.promote_samples)
        names, joined = self.interner.names, self.interner.joined
        self.directory.end_interval(
            (names[r], joined[r]) for r in hot_rows)

    def _window(self) -> int:
        return max(1, int(self._pipeline_window))

    def _flush_dispatch(self, n: int, percentiles, want_digests,
                        want_stats) -> dict:
        st = slab._flush_state(n, len(self.pools), percentiles,
                               want_digests, want_stats, self.device)
        st["dense"] = None
        nd = len(self._dense_rows)
        if nd:
            self._dense._drain_staging()
            st["dense"] = self._dense._flush_dispatch(
                nd, percentiles, want_digests, want_stats)
        for _ in range(min(self._window(), st["nslabs"])):
            self._dispatch_slab(st)
        return st

    def _dispatch_slab(self, st: dict) -> None:
        i = st["next"]
        st["next"] = i + 1
        R, pk = self.slab_rows, self.pk
        need = self._slab_need(st["n"], i)
        if need <= 0:
            st["refs"].append(None)
            return
        with obs_kernels.scope(f"flush.digest.{self._SCOPE}", self.device):
            (nm, nw, mn, mx, pcts, count, vsum, vmin, vmax,
             recip) = _pool_flush(self.pools[i], st["qs"], R, pk,
                                  self.pcomp)
            packed, planes = None, ()
            if st["packed"]:
                packed = slab._pack_slab(nm, nw, mn, mx)
                planes = (mn[:need], mx[:need])
            elif st["want_digests"]:
                planes = (nm[:need], nw[:need], mn[:need], mx[:need])
        stats = {"pcts": pcts, "count": count, "sum": vsum, "min": vmin,
                 "max": vmax, "recip": recip}
        st["refs"].append((need, packed, planes + tuple(
            stats[nm_][:need] for nm_ in st["sel"])))

    def _slab_need(self, n: int, i: int) -> int:
        """Rows of pool slab ``i`` a flush fetches: the interned prefix
        (override point: the mesh tiered group's rows are shard-placed,
        so it fetches whole slabs)."""
        return min(n - i * self.slab_rows, self.slab_rows)

    def _collect_pool(self, st: dict):
        """The pool's fetched columns in interner order, and the packed
        triple or None (override point: the mesh tiered group gathers
        through its placement)."""
        return slab._collect_slabs(st, self._dispatch_slab, self._window())

    def _dense_out_rows(self) -> np.ndarray:
        """The interner rows of the dense tier's slots, in slot order."""
        return np.asarray(self._dense_rows, np.int64)

    def _flush_collect(self, st: dict) -> dict:
        """Fetch the pool slab by slab, then the dense bank, and stitch
        them into row order."""
        n, sel = st["n"], st["sel"]
        cols, packed = self._collect_pool(st)
        nd = len(self._dense_rows)
        dense_out = None
        if st["dense"] is not None:
            dense_out = self._dense._flush_collect(st["dense"], nd,
                                                   st["percentiles"])
        out = {}
        dense_rows = self._dense_out_rows()
        if st["packed"]:
            pool_mn, pool_mx = cols[:2]
            cols = cols[2:]
            empty = np.empty(0, np.uint16)
            p_counts, p_mq, p_wb = packed
            if nd:
                d_counts = dense_out["packed_counts"]
                d_mq = dense_out["packed_means"]
                d_wb = dense_out["packed_weights"]
            else:
                d_counts, d_mq, d_wb = empty, empty, empty
            (out["packed_counts"], out["packed_means"],
             out["packed_weights"]) = _splice_packed(
                n, p_counts, p_mq, p_wb, dense_rows, d_counts, d_mq, d_wb)
            out["digest_min"] = np.array(pool_mn, np.float32)
            out["digest_max"] = np.array(pool_mx, np.float32)
            if nd:
                out["digest_min"][dense_rows] = dense_out["digest_min"]
                out["digest_max"][dense_rows] = dense_out["digest_max"]
        elif st["want_digests"]:
            pm, pw, pool_mn, pool_mx = cols[:4]
            cols = cols[4:]
            mean_full = np.full((n, self.k), np.inf, np.float32)
            weight_full = np.zeros((n, self.k), np.float32)
            mean_full[:, :self.pk] = pm
            weight_full[:, :self.pk] = pw
            dmin_full = np.array(pool_mn, np.float32)
            dmax_full = np.array(pool_mx, np.float32)
            if nd:
                mean_full[dense_rows] = dense_out["digest_mean"]
                weight_full[dense_rows] = dense_out["digest_weight"]
                dmin_full[dense_rows] = dense_out["digest_min"]
                dmax_full[dense_rows] = dense_out["digest_max"]
            out["digest_mean"] = mean_full
            out["digest_weight"] = weight_full
            out["digest_min"] = dmin_full
            out["digest_max"] = dmax_full
        _fill_stat_results(sel, cols, n, st["percentiles"], out)
        if nd:
            # the fetched columns are fresh host arrays; the unfetched
            # ones are zeros on both tiers
            for nm in sel:
                if nm == "pcts":
                    out["percentiles"] = out["percentiles"].copy()
                    out["median"] = out["median"].copy()
                    out["percentiles"][dense_rows] = \
                        dense_out["percentiles"]
                    out["median"][dense_rows] = dense_out["median"]
                else:
                    out[nm][dense_rows] = dense_out[nm]
        return out

    # -- snapshot and restore (persist/, the ladder's rung 3) ------------

    def snapshot_begin(self):
        """Phase 1 under the store lock over BOTH tiers: drain staging
        (the dense bank's own too: a promoted row's staged tail must not
        miss the checkpoint), then copy each pool slab's interned prefix
        and the dense bank's slot prefix on the device. ``finish``
        fetches off-lock, dequantizes the pool on the host and flattens
        everything into the per-row centroid runs (a row lives in one
        tier's runs), so the snapshot restores into any digest store."""
        self._drain_staging()
        self._dense._drain_staging()
        n = len(self.interner)
        snap = {"kind": "digest", "names": list(self.interner.names),
                "joined": list(self.interner.joined)}
        if n == 0:
            return snap, None
        R, pk = self.slab_rows, self.pk
        planes = []
        for i, p in enumerate(self.pools):
            need = min(n - i * R, R)
            if need <= 0:
                break
            planes.extend((
                p.mq.view(R, pk)[:need], p.wb.view(R, pk)[:need],
                p.fmin[:need], p.fmax[:need], p.bw.view(R, pk)[:need],
                p.bwm.view(R, pk)[:need], p.dmin[:need], p.dmax[:need],
                p.count[:need], p.vsum[:need], p.vmin[:need],
                p.vmax[:need], p.recip[:need]))
        npool = len(planes) // 13
        nd = len(self._dense_rows)
        dense_rows = np.asarray(self._dense_rows, np.int64)
        if nd:
            d = self._dense
            planes.extend((
                d.digest.mean[:nd], d.digest.weight[:nd],
                d.temp.sum_w[:nd], d.temp.sum_wm[:nd], d.dmin[:nd],
                d.dmax[:nd], d.digest.min[:nd], d.digest.max[:nd],
                d.temp.count[:nd], d.temp.vsum[:nd], d.temp.vmin[:nd],
                d.temp.vmax[:nd], d.temp.recip[:nd]))
        copies, event = _snapshot_copies(planes)

        def finish():
            host = _fetch_copies(copies, event)
            rows_p, means_p, weights_p = [], [], []
            scal = {nm: np.zeros(n, np.float32)
                    for nm in ("count", "vsum", "recip")}
            for nm in ("mins", "vmin"):
                scal[nm] = np.full(n, np.inf, np.float32)
            for nm in ("maxs", "vmax"):
                scal[nm] = np.full(n, -np.inf, np.float32)
            for i in range(npool):
                (mq, wb, fmin, fmax, bw, bwm, dmn, dmx, cnt, vsum, vmn,
                 vmx, recip) = host[13 * i:13 * i + 13]
                mean, weight = dequantize_host(
                    mq.view(np.uint16), wb.view(np.uint16), fmin, fmax)
                flat = flatten_digest_state(
                    np.where(weight > 0, mean, np.inf).astype(np.float32),
                    weight, bw, bwm)
                rows_p.append(flat["rows"] + np.int32(i * R))
                means_p.append(flat["means"])
                weights_p.append(flat["weights"])
                lo, hi = i * R, i * R + len(cnt)
                scal["mins"][lo:hi] = np.minimum(dmn, vmn)
                scal["maxs"][lo:hi] = np.maximum(dmx, vmx)
                scal["count"][lo:hi] = cnt
                scal["vsum"][lo:hi] = vsum
                scal["vmin"][lo:hi] = vmn
                scal["vmax"][lo:hi] = vmx
                scal["recip"][lo:hi] = recip
            if nd:
                (mean, weight, bin_w, bin_wm, imp_min, imp_max, dmn, dmx,
                 cnt, vsum, vmn, vmx, recip) = host[13 * npool:]
                flat = flatten_digest_state(mean, weight, bin_w, bin_wm)
                rows_p.append(dense_rows[flat["rows"]].astype(np.int32))
                means_p.append(flat["means"])
                weights_p.append(flat["weights"])
                scal["mins"][dense_rows] = np.minimum(imp_min, dmn)
                scal["maxs"][dense_rows] = np.maximum(imp_max, dmx)
                scal["count"][dense_rows] = cnt
                scal["vsum"][dense_rows] = vsum
                scal["vmin"][dense_rows] = vmn
                scal["vmax"][dense_rows] = vmx
                scal["recip"][dense_rows] = recip
            snap["rows"] = np.concatenate(rows_p) if rows_p else \
                np.empty(0, np.int32)
            snap["means"] = np.concatenate(means_p) if means_p else \
                np.empty(0, np.float64)
            snap["weights"] = np.concatenate(weights_p) if weights_p \
                else np.empty(0, np.float64)
            snap.update(scal)

        return snap, finish

    def snapshot_state(self) -> dict:
        """Begin and finish in one call, for a caller that owns the
        group; nothing is reset."""
        snap, finish = self.snapshot_begin()
        if finish is not None:
            finish()
        return snap

    def restore_stats(self, rows: np.ndarray, count: np.ndarray,
                      vsum: np.ndarray, vmin: np.ndarray, vmax: np.ndarray,
                      recip: np.ndarray):
        """Fold recovered per-row scalar stats into whichever tier each
        row is assigned to (the restore mapped its rows through ``_row``,
        so the assignment exists)."""
        if not len(rows):
            return
        rows = np.asarray(rows, np.int64)
        self.ensure_capacity(int(rows.max()))
        self._device_dirty = True
        dense, spans = self._partition(
            rows, *(np.asarray(a, np.float32)
                    for a in (count, vsum, vmin, vmax, recip)))
        if dense is not None:
            slots, arrs = dense
            self._dense.restore_stats(slots, *arrs)
        for i, local, arrs in spans:
            self._pool_restore(i, local, *arrs)

    def _pool_restore(self, i: int, local, count, vsum, vmin, vmax,
                      recip) -> None:
        """One slab's span of recovered scalar stats into its pool slab
        (override point, like ``_pool_drain_samples``)."""
        with obs_kernels.scope(f"drain.digest.{self._SCOPE}", self.device):
            _pool_restore_stats(self.pools[i], self._dev(local),
                                *(self._dev(a) for a in
                                  (count, vsum, vmin, vmax, recip)))
