"""The slab digest store: the multi-million-series capacity plan, and the
on-device pack of drained digest planes for the forward path.

Port of ``veneur_tpu/core/slab.py``. Two things stop the dense
``DigestGroup`` (one ``[S, K]`` plane a field, reallocated whole to grow)
short of several million series on one card: growth doubles the planes,
and the flush program's transient scales with every row. Here:

* state lives in flat per-slab planes (``[slab * K]``), and a group grows
  one slab at a time;
* the digest planes may be stored bfloat16 (``digest_dtype``): the
  kernels see float32 only, upcast a slab at a time, and exact counts
  ride float32 planes, so nothing emitted as a count is rounded;
* every device program touches one slab, so the flush's transient is
  slab-sized (at most 1,048,576 rows, the JAX package's bound, kept so
  both packages lay out the same slabs; the CUDA kernels index rows with
  64-bit offsets and need no such cap).

:class:`SlabDigestBank` is the bank alone: the local role (samples into
per-slab temp bins, drained by K1 at the flush) and the merge role (a
global's imported digests merged straight into the resident planes by
K2). :class:`SlabDigestGroup` is the store-facing group
(``digest_storage: slab``), with the dense group's staging, flush,
snapshot and restore contracts. Where the JAX package donates planes,
this port updates them in place or replaces them; a snapshot copies them
on the device under the store lock.

The pack (``_pack_slab``, ``_gather_pack``, ``_fetch_packed``): a local
that forwards at fleet cardinality compacts and quantizes its drained
planes on the device and fetches only the live centroids, 4 bytes each
(a u16 range-quantized mean and a bfloat16 weight), instead of the raw
float32 planes. The card has few ops on ``torch.uint16``, so 16-bit
patterns travel as ``int16`` on the device and are viewed as ``uint16``
only on the host; the live counts travel as ``int32``.

The JAX versions of everything here are XLA, not Pallas: these are
plain PyTorch, and reach the hand-written kernels only through
``ops/tdigest.py`` (K1 in the flush, K2 in the shift guard's drain and
the merge role).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from veneur_tpu_torch.core.bucketing import pow2_cap
from veneur_tpu_torch.core.store import (
    DigestStaging,
    Interner,
    _fetch_copies,
    _fill_stat_results,
    _restore_temp_stats,
    _scatter_extrema,
    _select_stats,
    _snapshot_copies,
    _to_host,
    begin_compute_ladder,
    flatten_digest_state,
    kernel_rung,
)
from veneur_tpu_torch.device import resolve_device
from veneur_tpu_torch.obs import kernels as obs_kernels
from veneur_tpu_torch.obs import recorder as obs_rec
from veneur_tpu_torch.ops import tdigest as td_ops
from veneur_tpu_torch.ops import tdigest_cuda

SLAB_ROWS_DEFAULT = 1 << 20
# the JAX package's slab cap (Mosaic's 2 GiB operand bound there); here
# it bounds the per-slab flush transient, and both packages lay out the
# same slabs
MAX_SLAB_ROWS = 1 << 20
_INF = math.inf
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def storage_dtype(dtype) -> torch.dtype:
    """The digest planes' storage type from a name or a torch dtype:
    float32 or bfloat16."""
    name = dtype if isinstance(dtype, str) else {
        torch.float32: "float32", torch.bfloat16: "bfloat16"}.get(dtype)
    if name not in _DTYPES:
        raise ValueError(f"digest_dtype must be 'float32' or 'bfloat16', "
                         f"got {dtype!r}")
    return _DTYPES[name]


def _to_u16_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 values in [0, 65535] -> int16 tensors holding the same 16
    bits (an explicit wrap: narrowing casts are not relied on)."""
    return torch.where(x >= 32768, x - 65536, x).to(torch.int16)


def _pack_slab(mean: torch.Tensor, weight: torch.Tensor, dmin: torch.Tensor,
               dmax: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact and quantize drained digest planes on the device.

    mean/weight: [S, K] (float32 math whatever their type); dmin/dmax:
    [S] float32. Means quantize to u16 against the row's [dmin, dmax]
    span (absolute error <= span/65535, far inside the t-digest's 0.02
    envelope); weights round to bfloat16 (round to nearest even, as
    XLA's convert; exact counts ride the float32 stats). Each row's live
    slots (weight > 0) then move to its prefix, in slot order.

    Returns (counts int32 [S], q_pref int16 [S, K], wb_pref int16 [S,
    K]): row r's live centroids are ``q_pref[r, :counts[r]]``. Slots past
    a row's count hold 0."""
    m = mean.float()
    w = weight.float()
    live = w > 0
    counts = live.sum(dim=1, dtype=torch.int32)
    span = dmax - dmin
    # a true division: a Python number over a tensor (65535.0 / span)
    # multiplies by the reciprocal in torch, one rounding more than
    # XLA's divide, which moves a q by 1 where the product nears .5
    scale = torch.where(span > 0, torch.full_like(span, 65535.0) / span,
                        torch.zeros_like(span))
    q = torch.clamp(torch.round((m - dmin[:, None]) * scale[:, None]),
                    0.0, 65535.0)
    # a dead slot or an empty row can make (m - dmin) * scale NaN (inf *
    # 0), whose integer cast differs between the CPU, CUDA and XLA: zero
    # it first (only live prefixes are ever fetched)
    q = torch.where(live, q, torch.zeros_like(q)).to(torch.int32)
    wb = w.to(torch.bfloat16).view(torch.int16)
    # the stable live-first partition of JAX's sort on a unique key,
    # as a scatter: a live slot goes to its rank among the live, a dead
    # one after every live slot
    live_i = live.to(torch.int64)
    rank_live = torch.cumsum(live_i, dim=1) - 1
    rank_dead = torch.cumsum(1 - live_i, dim=1) - 1
    pos = torch.where(live, rank_live, counts[:, None].long() + rank_dead)
    q_pref = torch.zeros_like(q, dtype=torch.int16).scatter_(
        1, pos, _to_u16_bits(q))
    wb_pref = torch.zeros_like(wb).scatter_(
        1, pos, torch.where(live, wb, torch.zeros_like(wb)))
    return counts, q_pref, wb_pref


def _slice_pack(q_pref: torch.Tensor, wb_pref: torch.Tensor, rows: int,
                width: int):
    return (q_pref[:rows, :width].contiguous(),
            wb_pref[:rows, :width].contiguous())


def _gather_pack(counts: torch.Tensor, q_pref: torch.Tensor,
                 wb_pref: torch.Tensor, P: int) -> torch.Tensor:
    """Flat-compact the prefix planes on the device: output position i
    maps to (row by a search over the count prefix sum, rank within the
    row). One int32 gather of ``q << 16 | wb`` instead of two int16
    ones; returns the [P] bit patterns."""
    slab, k = q_pref.shape
    c = counts.long()
    cum = torch.cumsum(c, 0)
    i = torch.arange(P, dtype=torch.int64, device=q_pref.device)
    row = torch.clamp(torch.searchsorted(cum, i, right=True), 0, slab - 1)
    j = torch.clamp(i - (cum - c)[row], 0, k - 1)
    packed = ((q_pref.to(torch.int32) & 0xFFFF) << 16) \
        | (wb_pref.to(torch.int32) & 0xFFFF)
    return packed.reshape(-1)[row * k + j]


def _fetch_packed(counts_dev: torch.Tensor, q_pref: torch.Tensor,
                  wb_pref: torch.Tensor, need: int):
    """Host side of the packed fetch: the counts first (small), then the
    cheaper of two transfers of the live bytes:

    * uniform rows: a ``[:pow2(need), :pow2(max count)]`` slice of the
      prefix planes, flattened on the host;
    * skewed rows (one heavy row would widen that slice): the flat
      device compaction :func:`_gather_pack`, sized pow2(total).

    The power-of-two sizes are the JAX package's (there they bound the
    compiled variants), so both packages pick the same strategy and move
    the same bytes. Returns (counts u16 [need], means_q u16 [L],
    weights_bf u16 [L]) as numpy."""
    counts = counts_dev[:need].cpu().numpy().astype(np.uint16)
    total = int(counts.astype(np.int64).sum())
    if total == 0:
        empty = np.empty(0, np.uint16)
        return counts, empty, empty
    slab, k = q_pref.shape
    width = min(pow2_cap(int(counts.max())), k)
    rows = min(pow2_cap(need), slab)
    P = pow2_cap(total)
    if rows * width <= 3 * P:
        qs, wbs = (t.cpu().numpy().view(np.uint16)[:need]
                   for t in _slice_pack(q_pref, wb_pref, rows, width))
        mask = (np.arange(width, dtype=np.int32)[None, :]
                < counts[:, None].astype(np.int32))
        return counts, qs[mask], wbs[mask]
    packed = _gather_pack(counts_dev, q_pref, wb_pref, P)[:total]
    packed = packed.cpu().numpy().view(np.uint32)
    return (counts, (packed >> 16).astype(np.uint16),
            (packed & 0xFFFF).astype(np.uint16))


# ---------------------------------------------------------------------------
# Per-slab planes and programs
# ---------------------------------------------------------------------------


class DigestSlab(NamedTuple):
    """Resident state of one slab of series rows, as flat planes.

    count is an exact float32 per-series total kept beside the (maybe
    bfloat16) centroid weights: the merge role reports it instead of
    summing rounded weights. The local role reports the temp's count and
    this plane rides along."""

    mean: torch.Tensor      # [slab*K] storage dtype; +inf = empty slot
    weight: torch.Tensor    # [slab*K] storage dtype; 0 = empty slot
    dmin: torch.Tensor      # [slab] float32 minima (+inf when empty)
    dmax: torch.Tensor      # [slab] float32 maxima (-inf when empty)
    count: torch.Tensor     # [slab] float32 exact total weight


class TempSlab(NamedTuple):
    """The interval's accumulators of one slab (local role only), flat:
    the bins, the anchor summary (seg_*, [slab*A]) and the scalar stats."""

    sum_w: torch.Tensor     # [slab*K]
    sum_wm: torch.Tensor    # [slab*K]
    seg_w: torch.Tensor     # [slab*A]
    seg_wm: torch.Tensor    # [slab*A]
    count: torch.Tensor     # [slab]
    vsum: torch.Tensor      # [slab]
    vmin: torch.Tensor      # [slab]
    vmax: torch.Tensor      # [slab]
    recip: torch.Tensor     # [slab]


def _init_digest_slab(slab: int, k: int, dtype, device) -> DigestSlab:
    f32 = torch.float32
    return DigestSlab(
        mean=torch.full((slab * k,), _INF, dtype=dtype, device=device),
        weight=torch.zeros(slab * k, dtype=dtype, device=device),
        dmin=torch.full((slab,), _INF, dtype=f32, device=device),
        dmax=torch.full((slab,), -_INF, dtype=f32, device=device),
        count=torch.zeros(slab, dtype=f32, device=device))


def _init_temp_slab(slab: int, k: int, device) -> TempSlab:
    t = td_ops.init_temp(slab, k, device=device)
    return TempSlab(*(p.reshape(-1) for p in t))


def _digest32(d: DigestSlab, slab: int, k: int) -> td_ops.TDigest:
    """The slab's digests as float32 [slab, K] (a copy when stored
    bfloat16, the JAX package's per-slab upcast)."""
    return td_ops.TDigest(mean=d.mean.view(slab, k).float(),
                          weight=d.weight.view(slab, k).float(),
                          min=d.dmin, max=d.dmax)


def _temp_view(t: TempSlab, slab: int, k: int) -> td_ops.TempCentroids:
    """[slab, K] / [slab, A] views of the flat temp planes: an in-place
    update through them lands in the slab's planes."""
    a = td_ops.BELOW_MASS_ANCHORS
    return td_ops.TempCentroids(
        sum_w=t.sum_w.view(slab, k), sum_wm=t.sum_wm.view(slab, k),
        seg_w=t.seg_w.view(slab, a), seg_wm=t.seg_wm.view(slab, a),
        count=t.count, vsum=t.vsum, vmin=t.vmin, vmax=t.vmax,
        recip=t.recip)


def _stored(mean: torch.Tensor, weight: torch.Tensor, dtype):
    """Drained float32 [slab, K] planes as flat planes of the storage
    type (bfloat16 rounds to nearest even, as XLA's convert)."""
    return mean.to(dtype).reshape(-1), weight.to(dtype).reshape(-1)


def _local_rows(rows: torch.Tensor, weights: torch.Tensor, slab: int):
    """Slab-local rows with every out-of-slab id (>= slab) on the padding
    row ``slab`` at weight 0 (the JAX package's ``mode="drop"``)."""
    rows = rows.long()
    oor = rows >= slab
    return (torch.where(oor, slab, rows),
            torch.where(oor, torch.zeros_like(weights), weights))


def _guard_drain_slab(temp: TempSlab, digest: DigestSlab, rows, values,
                      weights, slab: int, compression: float) -> DigestSlab:
    """The slab form of the shift guard: when the chunk's per-row value
    ranges are disjoint from what the bins cover for enough chunk mass,
    drain the bins into the digest planes through K2 (upcast from the
    storage type, stored back) and zero them; the temp's scalar stats
    survive. The JAX package's ``lax.cond`` is a Python branch here: one
    host sync a chunk, as ``ingest_chunk_guarded`` pays. Returns the
    digest slab (new planes when it drained)."""
    k = temp.sum_w.numel() // slab
    pred = td_ops.shift_pred(temp.seg_w, temp.seg_wm, rows, values,
                             weights, slab)
    if not bool(pred.item()):
        return digest
    drained = td_ops.drain_temp(_digest32(digest, slab, k),
                                _temp_view(temp, slab, k), compression)
    mean, weight = _stored(drained.mean, drained.weight, digest.mean.dtype)
    for plane in (temp.sum_w, temp.sum_wm, temp.seg_w, temp.seg_wm):
        plane.zero_()
    return DigestSlab(mean, weight, drained.min, drained.max, digest.count)


def _ingest_slab(temp: TempSlab, digest: DigestSlab, rows, values, weights,
                 slab: int, compression: float) -> DigestSlab:
    """Fold one flat chunk of samples (slab-LOCAL rows; >= slab is
    padding) into a slab's accumulators, behind the shift guard. The
    temp planes update in place; returns the digest slab."""
    rows, weights = _local_rows(rows, weights, slab)
    digest = _guard_drain_slab(temp, digest, rows, values, weights, slab,
                               compression)
    k = temp.sum_w.numel() // slab
    td_ops.ingest_chunk(_temp_view(temp, slab, k), rows, values, weights,
                        compression)
    return digest


def _import_slab(temp: TempSlab, digest: DigestSlab, rows, means, weights,
                 stat_rows, stat_mins, stat_maxs, slab: int,
                 compression: float) -> DigestSlab:
    """Fold imported digest CENTROIDS into a slab's bins without touching
    the local scalar stats (samplers.go:473-480); each digest's extrema
    land on the digest's dmin/dmax and only bound the final digest."""
    rows, weights = _local_rows(rows, weights, slab)
    digest = _guard_drain_slab(temp, digest, rows, means, weights, slab,
                               compression)
    k = temp.sum_w.numel() // slab
    td_ops.ingest_chunk(_temp_view(temp, slab, k), rows, means, weights,
                        compression, update_stats=False)
    _scatter_extrema(digest.dmin, digest.dmax, stat_rows.long(), stat_mins,
                     stat_maxs)
    return digest


def _flush_slab(digest: DigestSlab, temp: TempSlab, qs, slab: int,
                compression: float, want_digest: bool = True):
    """Drain one slab's temp into its digests through K1 and take the
    percentiles. Reads its inputs without changing them. Returns
    (drained mean and weight as flat storage-type planes, or None when
    ``want_digest`` is off, dmin, dmax, percentiles [slab, P], count,
    vsum, vmin, vmax, recip)."""
    k = temp.sum_w.numel() // slab
    d = _digest32(digest, slab, k)
    # the digest's own extrema are the imported ones (min(a, min(a, b))
    # is min(a, b): the JAX package passes +inf/-inf here)
    drained, pcts = td_ops.drain_and_quantile(
        d, _temp_view(temp, slab, k), d.min, d.max, qs, compression)
    mean = weight = None
    if want_digest:
        mean, weight = _stored(drained.mean, drained.weight,
                               digest.mean.dtype)
    return (mean, weight, drained.min, drained.max, pcts, temp.count,
            temp.vsum, temp.vmin, temp.vmax, temp.recip)


def _merge_slab(digest: DigestSlab, in_mean, in_weight, in_min, in_max,
                slab: int, compression: float) -> DigestSlab:
    """Merge one slab of imported digests into the resident planes (the
    global role: tdigest.Merge, worker.go:354-398). in_mean/in_weight:
    [slab, M] float32, weight 0 padding, rows in any order; they are
    sorted (``lax.sort`` in the JAX package: ties may land in any order,
    so compare by mass and quantiles) and merged by K2 with the digests
    upcast to float32. The exact running count adds the live weight."""
    k = digest.mean.numel() // slab
    d = _digest32(digest, slab, k)
    live = in_weight > 0
    key, order = torch.sort(torch.where(live, in_mean, _INF), dim=-1)
    w_in = torch.gather(in_weight, -1, order)
    new_m, new_w = tdigest_cuda.compress_presorted(
        d.mean, d.weight, key, w_in, compression, k)
    mean, weight = _stored(new_m, new_w, digest.mean.dtype)
    return DigestSlab(
        mean=mean, weight=weight,
        dmin=torch.minimum(digest.dmin, in_min),
        dmax=torch.maximum(digest.dmax, in_max),
        count=digest.count + torch.where(live, in_weight, 0.0).sum(-1))


def _quantile_slab(digest: DigestSlab, qs, slab: int):
    """The merge role's flush of one slab: percentiles, exact counts and
    extrema from the resident digests alone (``quantile``, no kernel)."""
    k = digest.mean.numel() // slab
    d = _digest32(digest, slab, k)
    return td_ops.quantile(d, qs), digest.count, d.min, d.max


def _to_dev(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _flush_state(n: int, nslabs: int, percentiles, want_digests,
                 want_stats, device) -> dict:
    """One flush attempt's state over ``nslabs`` slabs: what to fetch,
    the quantiles (the percentiles and the median), and the per-slab
    refs dispatched so far."""
    return {"packed": want_digests == "packed",
            "want_digests": bool(want_digests),
            "sel": _select_stats(want_stats),
            "qs": torch.tensor(list(percentiles) + [0.5],
                               dtype=torch.float32, device=device),
            "percentiles": percentiles, "n": n, "nslabs": nslabs,
            "refs": [], "next": 0}


def _collect_slabs(st: dict, dispatch, window: int):
    """The blocking half of a slab-wise flush: fetch each slab's refs in
    order, calling ``dispatch(st)`` for slab j + window while slab j's
    fetch waits, so at most ``window`` slabs' outputs are alive. A ref is
    (need, packed refs or None, tensors). Returns (the fetched columns
    concatenated, the packed (counts, means, weights) concatenated or
    None)."""
    parts, packed = [], []
    for j in range(st["nslabs"]):
        while st["next"] < st["nslabs"] and st["next"] - j < window:
            dispatch(st)
        ref = st["refs"][j]
        if ref is None:
            continue
        st["refs"][j] = None  # drop the slab's outputs once fetched
        need, pk, refs = ref
        with obs_rec.maybe_stage("fetch"):
            if pk is not None:
                packed.append(_fetch_packed(*pk, need))
            parts.append([_to_host(t) for t in refs])
    cols = [np.concatenate(c, axis=0) for c in zip(*parts)]
    return cols, ([np.concatenate(c) for c in zip(*packed)]
                  if packed else None)


# ---------------------------------------------------------------------------
# The bank
# ---------------------------------------------------------------------------


class SlabDigestBank:
    """``num_series`` t-digests held as flat per-slab planes.

    mode="local": samples stream in through :meth:`ingest` /
    :meth:`ingest_slab` into per-slab temp bins; :meth:`flush` drains them
    (K1 a slab) and returns percentiles and the scalar stats.

    mode="merge": no temp planes; imported digests merge straight into
    the resident planes (:meth:`merge_digests`, K2 a slab), and
    :meth:`flush` emits percentiles and counts and resets: the global
    aggregator's on-card half.
    """

    def __init__(self, num_series: int,
                 compression: float = td_ops.DEFAULT_COMPRESSION,
                 slab_rows: int = SLAB_ROWS_DEFAULT,
                 digest_dtype=torch.float32, mode: str = "local",
                 device=None):
        if mode not in ("local", "merge"):
            raise ValueError(f"unknown mode {mode!r}")
        if slab_rows <= 0 or num_series <= 0:
            raise ValueError(
                f"slab_rows and num_series must be positive, got "
                f"{slab_rows}/{num_series}")
        self.device = resolve_device(device)
        self.num_series = num_series
        self.compression = compression
        self.k = td_ops.size_bound(compression)
        # never a slab wider than the bank itself (rounded up to 128
        # rows, as the JAX package does for its kernel's row block)
        self.slab_rows = min(slab_rows, MAX_SLAB_ROWS,
                             max(-(-num_series // 128) * 128, 8))
        self.num_slabs = -(-num_series // self.slab_rows)
        self.digest_dtype = storage_dtype(digest_dtype)
        self.mode = mode
        self.digests = [self._new_digest() for _ in range(self.num_slabs)]
        self.temps: List[Optional[TempSlab]] = [
            self._new_temp() if mode == "local" else None
            for _ in range(self.num_slabs)]

    def _new_digest(self) -> DigestSlab:
        return _init_digest_slab(self.slab_rows, self.k, self.digest_dtype,
                                 self.device)

    def _new_temp(self) -> TempSlab:
        return _init_temp_slab(self.slab_rows, self.k, self.device)

    def _dev(self, a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def hbm_bytes(self) -> dict:
        """Resident-plane byte accounting: the capacity plan."""
        dsz = torch.finfo(self.digest_dtype).bits // 8
        per_slab_digest = (self.slab_rows * self.k * dsz * 2
                           + self.slab_rows * 4 * 2)
        per_slab_temp = (self.slab_rows * self.k * 4 * 2
                         + self.slab_rows * 4
                         * (5 + 2 * td_ops.BELOW_MASS_ANCHORS)) \
            if self.mode == "local" else 0
        total = self.num_slabs * (per_slab_digest + per_slab_temp)
        return {"digest_bytes": self.num_slabs * per_slab_digest,
                "temp_bytes": self.num_slabs * per_slab_temp,
                "total_bytes": total,
                "slab_transient_bytes": self.slab_rows * self.k * 4 * 6,
                "num_slabs": self.num_slabs,
                "k": self.k}

    # -- local role -----------------------------------------------------

    def ingest_slab(self, slab_idx: int, rows, values, weights):
        """Fold a flat chunk of samples whose rows are LOCAL to one slab
        (>= slab_rows is padding)."""
        if self.mode != "local":
            raise ValueError("ingest takes the local role")
        with obs_kernels.scope("drain.digest.slab", self.device):
            self.digests[slab_idx] = _ingest_slab(
                self.temps[slab_idx], self.digests[slab_idx],
                self._dev(rows, torch.int64),
                self._dev(values, torch.float32),
                self._dev(weights, torch.float32), self.slab_rows,
                self.compression)

    def ingest(self, rows, values, weights):
        """Fold a flat chunk with GLOBAL row ids: each slab takes the
        in-range subset (one program a slab; partition by slab where the
        producer can)."""
        rows = self._dev(rows, torch.int64)
        values = self._dev(values, torch.float32)
        weights = self._dev(weights, torch.float32)
        for i in range(self.num_slabs):
            base = i * self.slab_rows
            local = torch.where((rows >= base)
                                & (rows < base + self.slab_rows),
                                rows - base, self.slab_rows)
            self.ingest_slab(i, local, values, weights)

    # -- merge role -----------------------------------------------------

    def merge_digests(self, slab_idx: int, mean, weight, mins, maxs):
        """Merge imported digests into one slab: mean/weight [slab, M]
        float32 (weight 0 padding), mins/maxs [slab]."""
        f32 = torch.float32
        with obs_kernels.scope("drain.digest.slab", self.device):
            self.digests[slab_idx] = _merge_slab(
                self.digests[slab_idx], self._dev(mean, f32),
                self._dev(weight, f32), self._dev(mins, f32),
                self._dev(maxs, f32), self.slab_rows, self.compression)

    # -- flush ----------------------------------------------------------

    def flush(self, percentiles: Sequence[float], fetch: bool = True,
              want_digest: bool = False):
        """Drain every slab and reset it. Returns a dict of numpy arrays
        over all series, or with ``fetch=False`` a list of per-slab dicts
        of device tensors. ``want_digest`` (local role) also keeps each
        slab's drained digest planes, as float32 ``digest_mean`` /
        ``digest_weight`` [S, K]."""
        qs = torch.tensor(list(percentiles), dtype=torch.float32,
                          device=self.device)
        outs = []
        with obs_kernels.scope("flush.digest.slab", self.device):
            self._flush_slabs(qs, want_digest, outs)
        if not fetch:
            return outs
        result = {}
        for key in outs[0]:
            cols = [o[key] for o in outs]
            if key in ("digest_mean", "digest_weight"):
                cols = [c.view(self.slab_rows, self.k).float() for c in cols]
            result[key] = np.concatenate([_to_host(c) for c in cols],
                                         axis=0)[:self.num_series]
        return result

    def _flush_slabs(self, qs, want_digest: bool, outs: list) -> None:
        for i in range(self.num_slabs):
            if self.mode == "local":
                (mean, weight, _, _, pcts, count, vsum, vmin, vmax,
                 recip) = _flush_slab(self.digests[i], self.temps[i], qs,
                                      self.slab_rows, self.compression,
                                      want_digest)
                out = {"percentiles": pcts, "count": count, "sum": vsum,
                       "min": vmin, "max": vmax, "recip": recip}
                if want_digest:
                    out["digest_mean"] = mean
                    out["digest_weight"] = weight
                self.temps[i] = self._new_temp()
            else:
                pcts, count, dmin, dmax = _quantile_slab(
                    self.digests[i], qs, self.slab_rows)
                out = {"percentiles": pcts, "count": count, "min": dmin,
                       "max": dmax}
            self.digests[i] = self._new_digest()
            outs.append(out)


# ---------------------------------------------------------------------------
# The store-facing group
# ---------------------------------------------------------------------------


class SlabDigestGroup(DigestStaging):
    """The dense ``DigestGroup``'s contract over slab state
    (``digest_storage: slab``): the interner, the shared staging
    (``sample``, ``sample_many``, ``import_centroids``,
    ``import_centroids_bulk``), ``flush`` / ``flush_begin`` returning
    (interner, result dict) with the same keys, the two-phase snapshot
    and ``restore_stats``. State lives in flat per-slab planes (maybe
    bfloat16); capacity grows a slab at a time; the flush fetches each
    slab's results right after its program, with at most
    ``_pipeline_window`` slabs in flight (the store's
    ``flush_pipeline_depth``), so its peak extra memory is a few slabs.
    Staged chunks are partitioned by slab on the host."""

    # set by MetricStore._swap_generation: a retired group's flush drops
    # its device state instead of reallocating it
    _retired = False
    # slabs dispatched ahead of the fetch (MetricStore stamps it)
    _pipeline_window = 1

    def __init__(self, slab_rows: int = SLAB_ROWS_DEFAULT,
                 chunk: int = 1 << 16,
                 compression: float = td_ops.DEFAULT_COMPRESSION,
                 digest_dtype=torch.float32, device=None):
        if slab_rows <= 0:
            raise ValueError(f"slab_rows must be positive, got {slab_rows}")
        self.device = resolve_device(device)
        self.interner = Interner()
        self.compression = compression
        self.k = td_ops.size_bound(compression)
        self.chunk = chunk
        self.slab_rows = min(slab_rows, MAX_SLAB_ROWS)
        self.digest_dtype = storage_dtype(digest_dtype)
        self.digests: List[DigestSlab] = [self._new_digest()]
        self.temps: List[TempSlab] = [self._new_temp()]
        self._device_dirty = False
        self._init_staging()

    def _new_digest(self) -> DigestSlab:
        return _init_digest_slab(self.slab_rows, self.k, self.digest_dtype,
                                 self.device)

    def _new_temp(self) -> TempSlab:
        return _init_temp_slab(self.slab_rows, self.k, self.device)

    @property
    def capacity(self) -> int:
        return len(self.digests) * self.slab_rows

    def fresh(self) -> "SlabDigestGroup":
        """Empty same-config twin (the flush's generation swap). It starts
        with ONE slab and grows a slab at a time as rows intern, so the
        flush window holds the retired generation plus the slabs the live
        one touched, not twice the whole."""
        return SlabDigestGroup(self.slab_rows, self.chunk, self.compression,
                               self.digest_dtype, self.device)

    def ensure_capacity(self, max_row: int):
        while max_row >= self.capacity:
            self.digests.append(self._new_digest())
            self.temps.append(self._new_temp())
            # re-point the staging padding at the new out-of-range row
            self._rows[self._fill:] = self.capacity
            self._imp_rows[self._imp_fill:] = self.capacity
            self._imp_stat_rows[self._imp_stat_fill:] = self.capacity

    def _row(self, key, tags) -> int:
        row = self._intern_row(key, tags)
        if row >= self.capacity:
            self.ensure_capacity(row)
        return row

    # -- drains -----------------------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return _to_dev(a, self.device)

    def _per_slab(self, rows: np.ndarray, *arrays):
        """Partition staged entries by slab, in order within each: yields
        (slab index, slab-local rows, arrays). Sentinel padding rows (at
        or past the capacity) drop out."""
        slabs = rows // self.slab_rows
        for i in np.unique(slabs):
            if i < 0 or i >= len(self.digests):
                continue
            sel = slabs == i
            yield (int(i), (rows[sel] - i * self.slab_rows).astype(np.int64),
                   [a[sel] for a in arrays])

    def _drain_samples(self):
        if self._fill == 0:
            return
        self._device_dirty = True
        fill = self._fill
        rows, vals, wts = (self._rows[:fill], self._vals[:fill],
                           self._wts[:fill])
        self._new_sample_buffers()
        with obs_kernels.scope("drain.digest.slab", self.device):
            for i, local, (v, w) in self._per_slab(rows, vals, wts):
                self.digests[i] = _ingest_slab(
                    self.temps[i], self.digests[i], self._dev(local),
                    self._dev(v), self._dev(w), self.slab_rows,
                    self.compression)

    def _drain_imports(self):
        if self._imp_fill == 0 and self._imp_stat_fill == 0:
            return
        self._device_dirty = True
        nf, ns = self._imp_fill, self._imp_stat_fill
        rows, means, wts = (self._imp_rows[:nf], self._imp_means[:nf],
                            self._imp_wts[:nf])
        stat_rows = self._imp_stat_rows[:ns]
        stat_mins = self._imp_stat_mins[:ns]
        stat_maxs = self._imp_stat_maxs[:ns]
        self._new_import_buffers()
        cents = {i: (local, arrs) for i, local, arrs
                 in self._per_slab(rows, means, wts)}
        stats = {i: (local, arrs) for i, local, arrs
                 in self._per_slab(stat_rows, stat_mins, stat_maxs)}
        empty_r = np.empty(0, np.int64)
        empty_f = np.empty(0, np.float32)
        with obs_kernels.scope("drain.digest.slab", self.device):
            for i in sorted(set(cents) | set(stats)):
                c_local, (c_m, c_w) = cents.get(i, (empty_r,
                                                    (empty_f, empty_f)))
                s_local, (s_mn, s_mx) = stats.get(i, (empty_r,
                                                      (empty_f, empty_f)))
                self.digests[i] = _import_slab(
                    self.temps[i], self.digests[i], self._dev(c_local),
                    self._dev(c_m), self._dev(c_w), self._dev(s_local),
                    self._dev(s_mn), self._dev(s_mx), self.slab_rows,
                    self.compression)

    # -- flush ------------------------------------------------------------

    def flush(self, percentiles: List[float], want_digests=False,
              want_stats=None):
        """Drain and take the percentiles of every slab; returns
        (interner, host result dict over the interned rows), the dense
        group's contract: ``want_digests`` True adds the drained planes
        as float32 ``digest_mean``/``digest_weight`` [n, K],
        ``"packed"`` their live centroids packed on the device
        (``packed_counts``/``_means``/``_weights``), both with the
        extrema; ``want_stats`` selects the fetched stat columns."""
        return self.flush_begin(percentiles, want_digests, want_stats)()

    def flush_begin(self, percentiles: List[float], want_digests=False,
                    want_stats=None):
        """Two-phase flush: drain staging and dispatch the first
        ``_pipeline_window`` slabs' programs now; ``finish()`` fetches
        slab j while slab j + window runs, then commits. Through the
        compute ladder (``begin_compute_ladder``): a kernel failure in
        either phase raises with every slab intact, for the store's
        re-merge rung."""
        self._drain_staging()
        n = len(self.interner)
        if n == 0:
            res = self._flush_empty()
            return lambda: res
        fin = begin_compute_ladder(
            self._compute,
            lambda: self._flush_dispatch(n, percentiles, want_digests,
                                         want_stats),
            self._flush_collect, kernel_rung(self.device))
        return lambda: self._flush_commit(fin())

    def _reset_device(self):
        nslabs = len(self.digests)
        self.digests = [self._new_digest() for _ in range(nslabs)]
        self.temps = [self._new_temp() for _ in range(nslabs)]
        self._device_dirty = False

    def _drop_device(self):
        """Free a retired generation: device planes first, then staging."""
        self.digests = []
        self.temps = []
        self._device_dirty = False
        self._drop_staging()

    def _flush_empty(self):
        interner, self.interner = self.interner, Interner()
        if self._retired:
            self._drop_device()
            return interner, {}
        if self._device_dirty:
            self._reset_device()
        self._init_staging()
        return interner, {}

    def _flush_commit(self, out: dict):
        """Every slab's program and fetch succeeded: swap the interner and
        reset (or, retired, free) the slabs. Until here the planes are
        intact for the re-merge rung."""
        interner, self.interner = self.interner, Interner()
        if self._retired:
            self._drop_device()
        else:
            self._reset_device()
            self._init_staging()
        return interner, out

    def _flush_dispatch(self, n: int, percentiles, want_digests,
                        want_stats) -> dict:
        st = _flush_state(n, len(self.digests), percentiles, want_digests,
                          want_stats, self.device)
        for _ in range(min(self._window(), st["nslabs"])):
            self._dispatch_slab(st)
        return st

    def _window(self) -> int:
        return max(1, int(self._pipeline_window))

    def _dispatch_slab(self, st: dict) -> None:
        """Dispatch one slab's flush program (and pack), recording its
        fetchable tensors in order; a slab past the interned rows has
        nothing to flush."""
        i = st["next"]
        st["next"] = i + 1
        R, k = self.slab_rows, self.k
        need = min(st["n"] - i * R, R)
        if need <= 0:
            st["refs"].append(None)
            return
        with obs_kernels.scope("flush.digest.slab", self.device):
            (mean, weight, dmin, dmax, pcts, count, vsum, vmin, vmax,
             recip) = _flush_slab(self.digests[i], self.temps[i], st["qs"],
                                  R, self.compression, st["want_digests"])
            packed, planes = None, ()
            if st["packed"]:
                packed = _pack_slab(mean.view(R, k), weight.view(R, k),
                                    dmin, dmax)
                planes = (dmin[:need], dmax[:need])
            elif st["want_digests"]:
                planes = (mean.view(R, k)[:need].float(),
                          weight.view(R, k)[:need].float(), dmin[:need],
                          dmax[:need])
        stats = {"pcts": pcts, "count": count, "sum": vsum, "min": vmin,
                 "max": vmax, "recip": recip}
        st["refs"].append((need, packed, planes + tuple(
            stats[nm][:need] for nm in st["sel"])))

    def _flush_collect(self, st: dict) -> dict:
        """The blocking half: fetch each slab in order, dispatching slab
        j + window while slab j's fetch waits."""
        cols, packed = _collect_slabs(st, self._dispatch_slab,
                                      self._window())
        out = {}
        if st["packed"]:
            out["digest_min"], out["digest_max"] = cols[:2]
            cols = cols[2:]
            (out["packed_counts"], out["packed_means"],
             out["packed_weights"]) = packed
        elif st["want_digests"]:
            (out["digest_mean"], out["digest_weight"], out["digest_min"],
             out["digest_max"]) = cols[:4]
            cols = cols[4:]
        return _fill_stat_results(st["sel"], cols, st["n"],
                                  st["percentiles"], out)

    # -- snapshot and restore (persist/, the ladder's rung 3) ------------

    def snapshot_begin(self):
        """Phase 1 under the store lock: drain staging and copy each
        slab's interned prefix on the device (bfloat16 planes come out
        float32, exactly). ``finish`` fetches the copies off-lock and
        flattens them into the per-row centroid runs every digest store
        restores from."""
        self._drain_staging()
        n = len(self.interner)
        snap = {"kind": "digest", "names": list(self.interner.names),
                "joined": list(self.interner.joined)}
        if n == 0:
            return snap, None
        R, k = self.slab_rows, self.k
        planes = []
        for i, d in enumerate(self.digests):
            need = min(n - i * R, R)
            if need <= 0:
                break
            t = self.temps[i]
            planes.extend((
                d.mean.view(R, k)[:need], d.weight.view(R, k)[:need],
                t.sum_w.view(R, k)[:need], t.sum_wm.view(R, k)[:need],
                d.dmin[:need], d.dmax[:need], t.count[:need],
                t.vsum[:need], t.vmin[:need], t.vmax[:need],
                t.recip[:need]))
        copies, event = _snapshot_copies(planes)

        def finish():
            host = _fetch_copies(copies, event)
            rows_p, means_p, weights_p = [], [], []
            scalars = []
            for i in range(len(host) // 11):
                (mean, weight, bin_w, bin_wm, *rest) = host[11 * i:
                                                            11 * i + 11]
                flat = flatten_digest_state(mean, weight, bin_w, bin_wm)
                rows_p.append(flat["rows"] + np.int32(i * R))
                means_p.append(flat["means"])
                weights_p.append(flat["weights"])
                scalars.append(rest)
            snap["rows"] = np.concatenate(rows_p)
            snap["means"] = np.concatenate(means_p)
            snap["weights"] = np.concatenate(weights_p)
            for j, nm in enumerate(("mins", "maxs", "count", "vsum",
                                    "vmin", "vmax", "recip")):
                snap[nm] = np.concatenate([s[j] for s in scalars]).astype(
                    np.float32)

        return snap, finish

    def snapshot_state(self) -> dict:
        """Begin and finish in one call, for a caller that owns the group
        (the re-merge rung, tests); nothing is reset."""
        snap, finish = self.snapshot_begin()
        if finish is not None:
            finish()
        return snap

    def restore_stats(self, rows: np.ndarray, count: np.ndarray,
                      vsum: np.ndarray, vmin: np.ndarray, vmax: np.ndarray,
                      recip: np.ndarray):
        """Fold recovered per-row scalar stats into the slabs' temp
        accumulators (see ``core.store._restore_temp_stats``)."""
        if not len(rows):
            return
        rows = np.asarray(rows, np.int64)
        self.ensure_capacity(int(rows.max()))
        self._device_dirty = True
        f32 = [np.asarray(a, np.float32) for a in (count, vsum, vmin, vmax,
                                                   recip)]
        for i, local, arrs in self._per_slab(rows, *f32):
            _restore_temp_stats(self.temps[i], self._dev(local),
                                *(self._dev(a) for a in arrs))
