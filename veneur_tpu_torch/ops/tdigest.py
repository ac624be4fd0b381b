"""Batched merging t-digest as dense torch tensor ops.

Port of ``veneur_tpu/ops/tdigest.py``: the data-parallel re-derivation of
Dunning's merging t-digest over all series at once (sort, prefix sum,
k-scale binning, segmented reduce), with a digest batch held as dense
``[S, K]`` mean/weight planes. Quantile error stays within the t-digest
bound the reference's tests use (eps=0.02).

The per-interval drains go through the hand-written CUDA kernels of
``tdigest_cuda`` (K1 ``drain_quantile``, K2 ``compress_presorted``); on a
CPU tensor those wrappers run their plain PyTorch versions instead.

Where the JAX package donates buffers, this port updates the temp planes
in place: :func:`ingest_chunk` and :func:`ingest_chunk_guarded` write into
the ``TempCentroids`` they are given.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from veneur_tpu_torch.device import resolve_device
from veneur_tpu_torch.ops import tdigest_cuda

DEFAULT_COMPRESSION = 100.0
_TINY = torch.finfo(torch.float32).tiny
_INF = float("inf")


def size_bound(compression: float) -> int:
    """Slots a digest needs under floor(k) binning: at most C+1 bins are
    ever live (+1 of fp headroom), rounded up to a multiple of 8."""
    raw = int(compression) + 2
    return (raw + 7) // 8 * 8


class TDigest(NamedTuple):
    """A batch of t-digests as dense tensors.

    mean / weight: ``[..., K]``; liveness is defined SOLELY by weight > 0.
    Live means ascend within a row, but dead slots may hold any
    placeholder mean (+inf, -inf or a gap-filled running max), so
    consumers mask on weight, never on the mean.
    min / max: ``[...]`` observed extrema (+inf/-inf when empty).
    """

    mean: torch.Tensor
    weight: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.mean.shape[-1]


def init(batch_shape: Sequence[int] = (),
         compression: float = DEFAULT_COMPRESSION,
         capacity: int | None = None, device=None) -> TDigest:
    """Empty digests for a batch of series."""
    dev = resolve_device(device)
    k = capacity if capacity is not None else size_bound(compression)
    shape = tuple(batch_shape)
    f32 = torch.float32
    return TDigest(
        mean=torch.full(shape + (k,), _INF, dtype=f32, device=dev),
        weight=torch.zeros(shape + (k,), dtype=f32, device=dev),
        min=torch.full(shape, _INF, dtype=f32, device=dev),
        max=torch.full(shape, -_INF, dtype=f32, device=dev),
    )


def _shift_last(x: torch.Tensor, d: int, fill: float) -> torch.Tensor:
    """out[..., i] = x[..., i-d], left-filled with ``fill``."""
    pad = torch.full(x.shape[:-1] + (d,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[..., :-d]], dim=-1)


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis by log-step shifted adds:
    the JAX package's summation order, so both packages round alike."""
    d, n = 1, x.shape[-1]
    while d < n:
        x = x + _shift_last(x, d, 0.0)
        d *= 2
    return x


def _cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running max along the last axis (exact in any order)."""
    return torch.cummax(x, dim=-1).values


def _cummin_rev(x: torch.Tensor) -> torch.Tensor:
    """Suffix (right-to-left) running min along the last axis."""
    return torch.flip(torch.cummin(torch.flip(x, [-1]), dim=-1).values,
                      [-1])


def _kscale(q_mid: torch.Tensor, compression: float) -> torch.Tensor:
    """k(q) = C * (asin(2q-1)/pi + 1/2), arcsin argument clipped for fp
    safety (merging_digest.go:254-257). The arcsine is taken in float64
    and rounded once: torch's float32 asin is not correctly rounded and
    its vectorized and scalar CPU paths may differ, which could bin a
    sample differently from run to run."""
    x = torch.clamp(2.0 * q_mid - 1.0, -1.0, 1.0)
    return compression * (torch.asin(x.double()).float() / math.pi + 0.5)


def _compress(mean: torch.Tensor, weight: torch.Tensor, compression: float,
              out_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-cluster per-row centroid lists down to <= out_size centroids.

    mean/weight: [..., M] unsorted; weight==0 slots ignored. Returns
    sorted, front-compacted [..., out_size] tensors (empty slots
    mean=+inf, weight=0). The sort-based rung, kept for digests that
    arrive unsorted."""
    live = weight > 0
    key = torch.where(live, mean, _INF)
    key, order = torch.sort(key, dim=-1, stable=True)
    w = torch.gather(weight, -1, order)
    live = w > 0
    m0 = torch.where(live, key, 0.0)  # inf*0 would poison the sums
    incl = _cumsum(w)
    total = incl[..., -1:]
    q_mid = (incl - 0.5 * w) / torch.clamp_min(total, _TINY)
    k = _kscale(q_mid, compression)
    cluster = torch.clamp(torch.floor(k), 0, out_size - 1).long()
    cluster = torch.where(live, cluster, out_size)  # empties park past K
    shape = w.shape[:-1] + (out_size + 1,)
    sum_w = torch.zeros(shape, dtype=w.dtype, device=w.device) \
        .scatter_add_(-1, cluster, w)[..., :out_size]
    sum_wm = torch.zeros(shape, dtype=w.dtype, device=w.device) \
        .scatter_add_(-1, cluster, w * m0)[..., :out_size]
    new_live = sum_w > 0
    new_mean = torch.where(
        new_live, sum_wm / torch.where(new_live, sum_w, 1.0), _INF)
    # bins floor(k) skipped are empty and interleave; one more stable
    # sort compacts the live centroids (already ascending) to the front
    new_mean, order = torch.sort(new_mean, dim=-1, stable=True)
    return new_mean, torch.gather(sum_w, -1, order)


def _upper_bounds(state: TDigest) -> torch.Tensor:
    """Per-centroid upper bound: midpoint to the next LIVE centroid, or
    max for the last live one (merging_digest.go:339-354). Gap slots
    inherit the previous live bound (leading gaps get -inf)."""
    m, w = state.mean, state.weight
    live = w > 0
    suffix = _cummin_rev(torch.where(live, m, _INF))
    next_m = torch.cat([suffix[..., 1:],
                        torch.full_like(suffix[..., :1], _INF)], dim=-1)
    mx = state.max[..., None]
    live_ub = torch.where(torch.isfinite(next_m), 0.5 * (m + next_m), mx)
    return _cummax(torch.where(live, live_ub, -_INF))


def quantile(state: TDigest, qs) -> torch.Tensor:
    """Batched inverse-CDF (merging_digest.go:297-327).

    qs: [P] in [0, 1] shared across the batch. Returns [..., P]; NaN for
    empty digests."""
    w = state.weight
    qs = torch.as_tensor(qs, dtype=w.dtype, device=w.device)
    incl = _cumsum(w)
    total = incl[..., -1:]
    excl = incl - w
    ub = _upper_bounds(state)
    target = (qs * total).contiguous()                  # [..., P]
    # first centroid with incl >= target (incl is non-decreasing)
    idx = torch.searchsorted(incl.contiguous(), target, side="left")
    idx = torch.clamp(idx, 0, state.capacity - 1)
    ub_prev = torch.cat([ub[..., :1], ub[..., :-1]], dim=-1)
    ub_i, prev_ub, w_i, excl_i = (torch.gather(a, -1, idx)
                                  for a in (ub, ub_prev, w, excl))
    lb0 = state.min[..., None]
    # leading gap slots carry ub == -inf; fall back to min
    lb = torch.where(idx == 0, lb0, torch.maximum(prev_ub, lb0))
    prop = (target - excl_i) / torch.where(w_i > 0, w_i, 1.0)
    out = lb + prop * (ub_i - lb)
    return torch.where(total > 0, out, float("nan"))


# 8 anchors of f32 summary state per row (see the JAX module)
BELOW_MASS_ANCHORS = 8


def seg_of_bins(bins: torch.Tensor, capacity: int) -> torch.Tensor:
    """Map k-bin ids onto the BELOW_MASS_ANCHORS quantile segments."""
    return (bins * BELOW_MASS_ANCHORS) // max(capacity, 1)


def _row_value_sort(rows, values, weights):
    """Sort samples by (row, value): ``lax.sort(num_keys=2)`` has no torch
    twin, so a value sort is followed by a STABLE row sort."""
    v_sorted, by_value = torch.sort(values)
    r, by_row = torch.sort(rows[by_value], stable=True)
    order = by_value[by_row]
    return r, v_sorted[by_row], weights[order]


def bin_flat_samples(rows: torch.Tensor, values: torch.Tensor,
                     weights: torch.Tensor, num_series: int, capacity: int,
                     compression: float = DEFAULT_COMPRESSION,
                     acc_seg_w: torch.Tensor | None = None,
                     acc_seg_wm: torch.Tensor | None = None,
                     acc_anchors: int = BELOW_MASS_ANCHORS):
    """Pre-cluster a flat batch of (row, value, weight) samples into
    k-bins: sort by (row, value), give each sample its within-row
    quantile (one global prefix sum plus a cummax-propagated segment
    base), and assign cluster id floor(k(q_mid)).

    rows: [N] in [0, num_series]; padding entries use
    ``rows == num_series`` and weight 0. With the accumulated anchor
    summary (acc_seg_w/acc_seg_wm, [S, A] or flat), each sample's
    quantile is estimated against the accumulated-plus-chunk
    distribution so bins stay value-coherent across chunks. Returns
    (rows, values, weights, bins) sorted by row."""
    rows = rows.long()
    values = values.float()
    weights = weights.float()
    r, v, w = _row_value_sort(rows, values, weights)
    cw = _cumsum(w)
    excl = cw - w
    seg_start = torch.ones_like(r, dtype=torch.bool)
    seg_start[1:] = r[1:] != r[:-1]
    base = _cummax(torch.where(seg_start, excl, -_INF))
    q_excl = excl - base
    totals = torch.zeros(num_series + 1, dtype=w.dtype, device=w.device) \
        .index_add_(0, r, w)
    tot = torch.clamp_min(totals[torch.clamp_max(r, num_series)], _TINY)
    if acc_seg_w is not None:
        below, acc_tot = _acc_below_mass(r, v, acc_seg_w, acc_seg_wm,
                                         num_series, acc_anchors)
        q_mid = (below + q_excl + 0.5 * w) / torch.clamp_min(tot + acc_tot,
                                                             _TINY)
    else:
        q_mid = (q_excl + 0.5 * w) / tot
    k = _kscale(q_mid, compression)
    bins = torch.clamp(torch.floor(k), 0, capacity - 1).long()
    return r, v, w, bins


def _acc_below_mass(r: torch.Tensor, v: torch.Tensor,
                    acc_seg_w: torch.Tensor, acc_seg_wm: torch.Tensor,
                    num_series: int, anchors: int = BELOW_MASS_ANCHORS):
    """Per-sample accumulated mass below its value, from the temp's
    ``anchors``-segment summary: a cummax over the segment means gives a
    monotone coarse CDF, interpolated linearly inside the segment a
    value falls in. Returns (below [N], acc_total [N]); zeros for rows
    that have accumulated nothing."""
    # the chunk's rows are gathered first: the running max is per row,
    # so it equals the JAX package's over all [S, A] rows, at [N, A] cost
    rc = torch.clamp_max(r, num_series - 1)
    s_dw = acc_seg_w.reshape(num_series, anchors)[rc]    # [N, A]
    s_wm = acc_seg_wm.reshape(num_series, anchors)[rc]
    live = s_dw > 0
    means = torch.where(live, s_wm / torch.where(live, s_dw, 1.0), -_INF)
    s_mean = torch.cummax(means, dim=1).values
    s_prev = torch.cat([torch.full_like(s_mean[:, :1], -_INF),
                        s_mean[:, :-1]], dim=1)
    span = s_mean - s_prev
    vv = v[:, None]
    frac = torch.where(
        torch.isfinite(span) & (span > 0),
        torch.clamp((vv - s_prev) / torch.where(span > 0, span, 1.0),
                    0.0, 1.0),
        (s_mean < vv).float())
    below = (s_dw * frac).sum(1)
    acc_tot = s_dw.sum(1)
    return below, acc_tot


class TempCentroids(NamedTuple):
    """Per-series accumulation of pre-clustered samples plus the Histo
    sampler's local scalar stats (samplers.go:467-494). seg_w/seg_wm are
    the incremental anchor summary the binning and the shift guard read."""

    sum_w: torch.Tensor       # [S, K] per-bin weight
    sum_wm: torch.Tensor      # [S, K] per-bin weighted mean sum
    seg_w: torch.Tensor       # [S, A] anchor-segment weight
    seg_wm: torch.Tensor      # [S, A] anchor-segment weighted mean sum
    count: torch.Tensor       # [S] total weight
    vsum: torch.Tensor        # [S] weighted sample sum
    vmin: torch.Tensor        # [S]
    vmax: torch.Tensor        # [S]
    recip: torch.Tensor       # [S] weighted reciprocal sum (for hmean)


def init_temp(num_series: int, capacity: int | None = None,
              compression: float = DEFAULT_COMPRESSION,
              device=None) -> TempCentroids:
    """Empty temp accumulators. Every field gets its own buffer: the
    temp is updated in place, so two fields sharing storage would
    corrupt each other."""
    dev = resolve_device(device)
    k = capacity if capacity is not None else size_bound(compression)
    f32 = torch.float32
    return TempCentroids(
        sum_w=torch.zeros((num_series, k), dtype=f32, device=dev),
        sum_wm=torch.zeros((num_series, k), dtype=f32, device=dev),
        seg_w=torch.zeros((num_series, BELOW_MASS_ANCHORS), dtype=f32,
                          device=dev),
        seg_wm=torch.zeros((num_series, BELOW_MASS_ANCHORS), dtype=f32,
                           device=dev),
        count=torch.zeros(num_series, dtype=f32, device=dev),
        vsum=torch.zeros(num_series, dtype=f32, device=dev),
        vmin=torch.full((num_series,), _INF, dtype=f32, device=dev),
        vmax=torch.full((num_series,), -_INF, dtype=f32, device=dev),
        recip=torch.zeros(num_series, dtype=f32, device=dev),
    )


def ingest_chunk(temp: TempCentroids, rows: torch.Tensor,
                 values: torch.Tensor, weights: torch.Tensor,
                 compression: float = DEFAULT_COMPRESSION,
                 update_stats: bool = True,
                 acc_seg_w: torch.Tensor | None = None,
                 acc_seg_wm: torch.Tensor | None = None) -> TempCentroids:
    """Fold one flat chunk of samples into ``temp`` IN PLACE and return it.

    Padding entries (rows == S) contribute nothing: their row index is
    masked to 0 with a zero contribution (the JAX package drops them
    with ``mode="drop"``). Bin ids are anchored to the estimated global
    quantile against the accumulated summary (acc_* default to the
    temp's own). update_stats=False skips the local scalar stats."""
    num_series, capacity = temp.sum_w.shape
    if acc_seg_w is None:
        acc_seg_w, acc_seg_wm = temp.seg_w, temp.seg_wm
    r, v, w, b = bin_flat_samples(rows, values, weights, num_series,
                                  capacity, compression,
                                  acc_seg_w=acc_seg_w,
                                  acc_seg_wm=acc_seg_wm)
    valid = r < num_series
    live = w > 0
    vz = torch.where(live, v, 0.0)
    rr = torch.where(valid, r, 0)
    wz = torch.where(valid, w, 0.0)
    wvz = wz * vz
    sg = seg_of_bins(b, capacity)
    temp.sum_w.view(-1).index_add_(0, rr * capacity + b, wz)
    temp.sum_wm.view(-1).index_add_(0, rr * capacity + b, wvz)
    temp.seg_w.view(-1).index_add_(0, rr * BELOW_MASS_ANCHORS + sg, wz)
    temp.seg_wm.view(-1).index_add_(0, rr * BELOW_MASS_ANCHORS + sg, wvz)
    if not update_stats:
        return temp
    ok = valid & live
    temp.count.index_add_(0, rr, wz)
    temp.vsum.index_add_(0, rr, wvz)
    temp.vmin.scatter_reduce_(0, rr, torch.where(ok, v, _INF), "amin")
    temp.vmax.scatter_reduce_(0, rr, torch.where(ok, v, -_INF), "amax")
    temp.recip.index_add_(0, rr, torch.where(ok, w / v, 0.0))
    return temp


SHIFT_GUARD_FRAC = 0.01
# a row votes "shifted" only once its bins hold this much mass, and only
# when the chunk brings this much for it (see the JAX module)
SHIFT_GUARD_MIN_MASS = 8.0
SHIFT_GUARD_MIN_CHUNK_MASS = 4.0


def shift_masses(acc_seg_w: torch.Tensor, acc_seg_wm: torch.Tensor,
                 rows: torch.Tensor, values: torch.Tensor,
                 weights: torch.Tensor, num_series: int,
                 anchors: int = BELOW_MASS_ANCHORS):
    """(shifted_mass, total_mass) of a chunk against the accumulated
    anchor summary: the mass of rows whose chunk values lie entirely
    outside what their accumulated segments cover. rows may carry the
    padding sentinel (== num_series)."""
    shifted, cmass = shift_masses_by_row(acc_seg_w, acc_seg_wm, rows,
                                         values, weights, num_series,
                                         anchors)
    return shifted.sum(), cmass.sum()


def shift_masses_by_row(acc_seg_w: torch.Tensor, acc_seg_wm: torch.Tensor,
                        rows: torch.Tensor, values: torch.Tensor,
                        weights: torch.Tensor, num_series: int,
                        anchors: int = BELOW_MASS_ANCHORS):
    """:func:`shift_masses` before its sums: ([S] shifted mass, [S] chunk
    mass) per row, for a caller that sums them block by block (the mesh
    store's per-shard guard)."""
    rows = rows.long()
    acc_w2 = acc_seg_w.reshape(num_series, anchors)
    acc_m2 = acc_seg_wm.reshape(num_series, anchors)
    live_b = acc_w2 > 0
    means = torch.where(live_b, acc_m2 / torch.where(live_b, acc_w2, 1.0),
                        float("nan"))
    amin = torch.where(live_b, means, _INF).amin(1)
    amax = torch.where(live_b, means, -_INF).amax(1)
    acc_mass = acc_w2.sum(1)
    live = weights > 0
    dev, f32 = weights.device, torch.float32
    cmin = torch.full((num_series + 1,), _INF, dtype=f32, device=dev) \
        .scatter_reduce_(0, rows, torch.where(live, values, _INF),
                         "amin")[:num_series]
    cmax = torch.full((num_series + 1,), -_INF, dtype=f32, device=dev) \
        .scatter_reduce_(0, rows, torch.where(live, values, -_INF),
                         "amax")[:num_series]
    cmass = torch.zeros(num_series + 1, dtype=f32, device=dev) \
        .index_add_(0, rows, torch.where(live, weights, 0.0))[:num_series]
    disjoint = ((acc_mass >= SHIFT_GUARD_MIN_MASS)
                & (cmass >= SHIFT_GUARD_MIN_CHUNK_MASS)
                & ((cmin > amax) | (cmax < amin)))
    return torch.where(disjoint, cmass, 0.0), cmass


def shift_pred(acc_seg_w: torch.Tensor, acc_seg_wm: torch.Tensor,
               rows: torch.Tensor, values: torch.Tensor,
               weights: torch.Tensor, num_series: int,
               frac: float = SHIFT_GUARD_FRAC,
               anchors: int = BELOW_MASS_ANCHORS) -> torch.Tensor:
    """True when >= ``frac`` of the chunk's mass lands in rows whose value
    range is disjoint from their accumulated bins: a distribution step
    the per-bin accumulation cannot absorb."""
    shifted, total = shift_masses(acc_seg_w, acc_seg_wm, rows, values,
                                  weights, num_series, anchors)
    return shifted > frac * torch.clamp_min(total, _TINY)


def ingest_chunk_guarded(digest: TDigest, temp: TempCentroids,
                         rows: torch.Tensor, values: torch.Tensor,
                         weights: torch.Tensor,
                         compression: float = DEFAULT_COMPRESSION,
                         update_stats: bool = True):
    """Shift-guarded ingest: when ``shift_pred`` fires, drain the temp
    bins into the digest (through the K2 kernel) and zero them, then
    ingest the chunk against fresh bins. The temp's scalar stats survive
    the drain. Returns (digest, temp); temp is updated in place.

    The JAX package guards with ``lax.cond`` on a device predicate; here
    the guard is a Python branch, so every chunk pays one host sync to
    read the predicate."""
    num_series = temp.sum_w.shape[0]
    pred = shift_pred(temp.seg_w, temp.seg_wm, rows, values, weights,
                      num_series)
    if bool(pred.item()):
        digest = drain_temp(digest, temp, compression)
        for plane in (temp.sum_w, temp.sum_wm, temp.seg_w, temp.seg_wm):
            plane.zero_()
    temp = ingest_chunk(temp, rows, values, weights, compression,
                        update_stats)
    return digest, temp


def _sorted_temp_half(temp: TempCentroids):
    """The temp bins as a row-ascending centroid list (+inf empties last)."""
    t_live = temp.sum_w > 0
    t_mean = torch.where(
        t_live, temp.sum_wm / torch.where(t_live, temp.sum_w, 1.0), _INF)
    t_mean, order = torch.sort(t_mean, dim=-1)
    return t_mean, torch.gather(temp.sum_w, -1, order)


def drain_temp(state: TDigest, temp: TempCentroids,
               compression: float = DEFAULT_COMPRESSION) -> TDigest:
    """Merge the accumulated temp centroids into the digests (the batched
    mergeAllTemps) through K2. Bin means are not monotone in bin index
    once shifting chunks accumulate, so the temp half is sorted first."""
    t_mean, t_w = _sorted_temp_half(temp)
    new_mean, new_weight = tdigest_cuda.compress_presorted(
        state.mean, state.weight, t_mean, t_w, compression, state.capacity)
    return TDigest(mean=new_mean, weight=new_weight,
                   min=torch.minimum(state.min, temp.vmin),
                   max=torch.maximum(state.max, temp.vmax))


def drain_and_quantile(state: TDigest, temp: TempCentroids, dmin, dmax,
                       qs, compression: float = DEFAULT_COMPRESSION):
    """The whole per-interval digest flush: drain the temp bins into the
    digests, fold in the imported extrema (dmin/dmax), and return
    (drained digests, per-series percentiles [S, P]) from one K1 launch.
    Reads its inputs without changing them, so a failed launch leaves
    them intact for the compute ladder's re-merge."""
    mn = torch.minimum(torch.minimum(state.min, temp.vmin), dmin)
    mx = torch.maximum(torch.maximum(state.max, temp.vmax), dmax)
    t_mean, t_w = _sorted_temp_half(temp)
    qs = torch.as_tensor(qs, dtype=torch.float32, device=state.mean.device)
    nm, nw, pcts = tdigest_cuda.drain_quantile(
        state.mean, state.weight, t_mean, t_w, mn, mx, qs, compression,
        state.capacity)
    return TDigest(mean=nm, weight=nw, min=mn, max=mx), pcts


def merge(a: TDigest, b: TDigest,
          compression: float = DEFAULT_COMPRESSION) -> TDigest:
    """Merge digest batches elementwise through K2: the associative op of
    the global aggregation tree (Histo.Combine / Merge,
    samplers.go:657-691), and the butterfly round of
    ``parallel/collectives.allmerge_digest``. Both batches' rows must be
    ascending with dead slots that keep them so (+inf empties, or the
    kernels' gap-filled means): every digest this package builds is; K2
    reverses the b half itself (``sort_b`` off). Any leading batch shape;
    the kernel sees ``[prod(batch), K]`` planes."""
    k = a.capacity
    shape = a.mean.shape
    new_mean, new_weight = tdigest_cuda.compress_presorted(
        a.mean.reshape(-1, k), a.weight.reshape(-1, k),
        b.mean.reshape(-1, b.capacity), b.weight.reshape(-1, b.capacity),
        compression, k)
    return TDigest(mean=new_mean.reshape(shape),
                   weight=new_weight.reshape(shape),
                   min=torch.minimum(a.min, b.min),
                   max=torch.maximum(a.max, b.max))


def from_centroids(mean: torch.Tensor, weight: torch.Tensor, mins, maxs,
                   compression: float = DEFAULT_COMPRESSION,
                   capacity: int | None = None) -> TDigest:
    """Build digests from centroid arrays in any order (the
    deserialization path of forwarded sketch state, cf.
    NewMergingFromData, merging_digest.go:83-99): one sort-based
    :func:`_compress`, as in the JAX package, with no kernel.

    mean/weight: [..., M] with weight==0 padding; M may differ from the
    capacity."""
    k = capacity if capacity is not None else size_bound(compression)
    new_mean, new_weight = _compress(mean, weight, compression, k)
    dev, f32 = mean.device, mean.dtype
    return TDigest(mean=new_mean, weight=new_weight,
                   min=torch.as_tensor(mins, dtype=f32, device=dev),
                   max=torch.as_tensor(maxs, dtype=f32, device=dev))


# ---------------------------------------------------------------------------
# The tiered pool's binning (core/tiered.py)
# ---------------------------------------------------------------------------


def _packed_below_mass(r: torch.Tensor, v: torch.Tensor, mq: torch.Tensor,
                       wb: torch.Tensor, fmin: torch.Tensor,
                       fmax: torch.Tensor, num_series: int, capacity: int):
    """Per-sample accumulated mass below its value from the PACKED
    centroid planes (step attribution at centroid granularity; a tie
    counts half). Only the chunk's rows are gathered before the
    dequantize: [N, PK] work. Returns (below [N], packed total [N])."""
    rc = torch.clamp_max(r, num_series - 1)
    pm, pw = dequantize_centroids(
        mq.reshape(num_series, capacity)[rc],
        wb.reshape(num_series, capacity)[rc], fmin[rc], fmax[rc])
    live = pw > 0
    vv = v[:, None]
    below = (torch.where(live & (pm < vv), pw, 0.0).sum(1)
             + 0.5 * torch.where(live & (pm == vv), pw, 0.0).sum(1))
    ptot = torch.where(live, pw, 0.0).sum(1)
    return below, ptot


def bin_pool_samples(rows: torch.Tensor, values: torch.Tensor,
                     weights: torch.Tensor, num_series: int, capacity: int,
                     compression: float, acc_w: torch.Tensor,
                     acc_wm: torch.Tensor, mq: torch.Tensor | None = None,
                     wb: torch.Tensor | None = None,
                     fmin: torch.Tensor | None = None,
                     fmax: torch.Tensor | None = None):
    """Pool-tier binning (port of the JAX module's ``bin_pool_samples``):
    each sample is placed against its row's LIVE bin means, which in the
    pool are the anchors (A == PK == capacity):

    * room between the bracketing live bins: a value-interpolated bin
      inside the gap, off the bins next to the brackets while >= 3 are
      free;
    * a new row minimum or maximum: bisect the open side's bin range;
    * no room: the nearer-by-value bracket, unless it already holds more
      than ~2 x total / C and the other bracket is lighter;
    * an empty summary, or a row whose chunk mass exceeds everything it
      has accumulated (bins plus the packed planes, when given): the
      merged-rank quantile bin.

    rows: [N] in [0, num_series]; padding uses ``num_series`` and weight
    0. Returns (rows, values, weights, bins) sorted by (row, value)."""
    rows = rows.long()
    r, v, w = _row_value_sort(rows, values.float(), weights.float())
    cw = _cumsum(w)
    excl = cw - w
    seg_start = torch.ones_like(r, dtype=torch.bool)
    seg_start[1:] = r[1:] != r[:-1]
    base = _cummax(torch.where(seg_start, excl, -_INF))
    q_excl = excl - base
    totals = torch.zeros(num_series + 1, dtype=w.dtype, device=w.device) \
        .index_add_(0, r, w)
    tot = totals[torch.clamp_max(r, num_series)]
    below, acc_tot = _acc_below_mass(r, v, acc_w, acc_wm, num_series,
                                     capacity)
    if mq is not None:
        pbelow, ptot = _packed_below_mass(r, v, mq, wb, fmin, fmax,
                                          num_series, capacity)
        below = below + pbelow
        acc_tot = acc_tot + ptot
    q_mid = (below + q_excl + 0.5 * w) / torch.clamp_min(tot + acc_tot,
                                                         _TINY)
    qb = torch.clamp(torch.floor(_kscale(q_mid, compression)), 0,
                     capacity - 1).long()
    # the chunk's rows gathered first (elementwise: the same values)
    rc = torch.clamp_max(r, num_series - 1)
    wt_r = acc_w.reshape(num_series, capacity)[rc]    # [N, PK]
    live_r = wt_r > 0
    m_r = torch.where(live_r, acc_wm.reshape(num_series, capacity)[rc]
                      / torch.where(live_r, wt_r, 1.0), float("nan"))
    idx = torch.arange(capacity, device=r.device)
    vv = v[:, None]
    is_below = live_r & (m_r < vv)
    is_above = live_r & (m_r > vv)
    lo = torch.where(is_below, idx, -1).amax(1)
    hi = torch.where(is_above, idx, capacity).amin(1)
    m_lo = torch.where(is_below, m_r, -_INF).amax(1)
    m_hi = torch.where(is_above, m_r, _INF).amin(1)
    gap = hi - lo - 1                                 # free/equal bins
    span = m_hi - m_lo
    interp_ok = torch.isfinite(span) & (span > 0)
    frac = torch.clamp((v - m_lo) / torch.where(interp_ok, span, 1.0),
                       0.0, 1.0)
    off = torch.round(frac * (gap - 1).to(v.dtype)).long()
    roomy = gap >= 3
    off = torch.clamp(off, torch.where(roomy, 1, 0),
                      torch.where(roomy, gap - 2, gap - 1))
    b_interp = lo + 1 + off
    low_open = (lo < 0) & (hi < capacity)     # new row minimum
    high_open = (lo >= 0) & (hi >= capacity)  # new row maximum
    b_onesided = torch.where(low_open, (hi - 1) // 2, (lo + capacity) // 2)
    b_room = torch.where(interp_ok, b_interp,
                         torch.where(low_open | high_open, b_onesided, qb))
    b_room = torch.clamp(b_room, lo + 1, hi - 1)
    w_lo = torch.gather(wt_r, 1, torch.clamp(lo, 0, capacity - 1)[:, None])
    w_hi = torch.gather(wt_r, 1, torch.clamp(hi, 0, capacity - 1)[:, None])
    w_lo, w_hi = w_lo[:, 0], w_hi[:, 0]
    nearer_lo = (v - m_lo) <= (m_hi - v)
    w_near = torch.where(nearer_lo, w_lo, w_hi)
    w_far = torch.where(nearer_lo, w_hi, w_lo)
    cap_w = 2.0 * (tot + acc_tot) / compression
    switch = ((lo >= 0) & (hi < capacity) & (w_near + w > cap_w)
              & (w_far < w_near))
    b_full = torch.where(nearer_lo ^ switch, lo, hi)
    b = torch.where(gap >= 1, b_room, b_full)
    b = torch.where(tot > acc_tot, qb, b)
    return r, v, w, torch.clamp(b, 0, capacity - 1)


# ---------------------------------------------------------------------------
# Quantized (packed) centroid storage: the tiered pool's resident format
# ---------------------------------------------------------------------------
#
# Means quantize to u16 against the row's own [fmin, fmax] frame and
# weights round to bfloat16; both travel as int16 tensors holding the 16
# bits (torch has few ops on uint16), widened for arithmetic. A wb of 0
# is the empty slot.


def _u16(x: torch.Tensor) -> torch.Tensor:
    """The unsigned value of int16 bit patterns, as int32."""
    return x.to(torch.int32) & 0xFFFF


def quantize_centroids(mean: torch.Tensor, weight: torch.Tensor):
    """Quantize [..., P] float32 centroid planes into (means_q, weights_bf,
    fmin, fmax): int16 bit patterns of the u16 range-quantized means and
    of the bfloat16 weights, and the row frame (the live-mean span, so
    quantization never clips; +inf/-inf and all-zero planes for a row
    with no live centroid). Rounding is half to even, as XLA's."""
    live = weight > 0
    fmin = torch.where(live, mean, _INF).amin(-1)
    fmax = torch.where(live, mean, -_INF).amax(-1)
    span = fmax - fmin
    # a true division (F3): a Python number over a tensor multiplies by
    # the reciprocal in torch, one rounding more than XLA's divide
    scale = torch.where(span > 0, torch.full_like(span, 65535.0) / span,
                        torch.zeros_like(span))
    base = torch.where(torch.isfinite(fmin), fmin, torch.zeros_like(fmin))
    q = torch.clamp(torch.round((torch.where(live, mean, 0.0)
                                 - base[..., None]) * scale[..., None]),
                    0.0, 65535.0)
    q = torch.where(live, q, torch.zeros_like(q)).to(torch.int32)
    mq = torch.where(q >= 32768, q - 65536, q).to(torch.int16)
    wb = torch.where(live, weight, 0.0).to(torch.bfloat16).view(torch.int16)
    return mq, wb, fmin, fmax


def dequantize_centroids(mq: torch.Tensor, wb: torch.Tensor,
                         fmin: torch.Tensor, fmax: torch.Tensor):
    """Inverse of :func:`quantize_centroids`: (mean float32 [..., P] with
    +inf empties, weight float32)."""
    weight = wb.view(torch.bfloat16).float()
    live = weight > 0
    base = torch.where(torch.isfinite(fmin), fmin, torch.zeros_like(fmin))
    span = fmax - fmin
    span = torch.where(torch.isfinite(span), span, torch.zeros_like(span))
    step = span / torch.full_like(span, 65535.0)   # a true division (F3)
    mean = base[..., None] + _u16(mq).float() * step[..., None]
    return torch.where(live, mean, _INF), weight
