"""Global-aggregation collectives: the fleet-wide sketch merge.

Port of ``veneur_tpu/parallel/collectives.py``. There each function runs
inside ``shard_map`` over a named mesh axis; here the hosts axis is the
leading dimension of the tensors (``parallel/mesh.py``) and each
collective is a reduction over it:

    counters            psum        a sum over dim 0
    HLL registers       pmax        an amax over dim 0
    t-digest temp bins  psum        sums (additive fields), amin/amax
                                    (extrema)
    t-digest centroids  butterfly   log2(H) rounds of paired ``merge``s
                                    (K2), partner ``i ^ step``; a
                                    non-power-of-two axis gathers
                                    ``[S, H*K]`` and re-clusters once

The temp-bin merge is exact: binning already happened per host slice
under the same k-scale, and the bins' (sum_w, sum_wm) accumulators are
additive. :func:`bin_host_slices` is the host fan-in that produces them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from veneur_tpu_torch.ops import tdigest as td_ops
from veneur_tpu_torch.ops.tdigest import TDigest, TempCentroids


def merge_counters(values: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Fleet-wide counter totals: one psum (Counter.Combine,
    samplers.go:195)."""
    return values.sum(dim)


def merge_registers(registers: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Fleet-wide HLL union: the elementwise register max over the hosts
    axis (Set.Combine, samplers.go:423-435)."""
    return registers.amax(dim)


def merge_temp(temp: TempCentroids, dim: int = 0) -> TempCentroids:
    """Merge in-progress digest state across hosts (each field carries
    the hosts axis at ``dim``): additive fields sum, extrema take the
    min/max. Exact: the collective adds no approximation."""
    return TempCentroids(
        sum_w=temp.sum_w.sum(dim), sum_wm=temp.sum_wm.sum(dim),
        seg_w=temp.seg_w.sum(dim), seg_wm=temp.seg_wm.sum(dim),
        count=temp.count.sum(dim), vsum=temp.vsum.sum(dim),
        vmin=temp.vmin.amin(dim), vmax=temp.vmax.amax(dim),
        recip=temp.recip.sum(dim))


def allmerge_digest(digest: TDigest,
                    compression: float = td_ops.DEFAULT_COMPRESSION
                    ) -> TDigest:
    """All-reduce pre-compressed digests over the hosts axis (dim 0 of
    every field: mean/weight ``[H, S, K]``, min/max ``[H, S]``); returns
    the merged ``[S, K]`` digest every host holds afterwards (host 0's).

    Power-of-two axis: the recursive-doubling butterfly, log2(H) rounds,
    each merging every host's digest with its partner ``i ^ step``
    through K2 (one launch over all H x S rows a round). Otherwise one
    gather to ``[S, H*K]`` and a single :func:`~veneur_tpu_torch.ops.
    tdigest.from_centroids`. Digest merge is associative and
    commutative under the same k-scale (MergingDigest.Merge,
    merging_digest.go:358-370), so the pairing order does not change the
    accuracy bound."""
    h = digest.mean.shape[0]
    if h == 1:
        return TDigest(*(f[0] for f in digest))
    if h & (h - 1) == 0:
        ids = torch.arange(h, device=digest.mean.device)
        step = 1
        while step < h:
            partner = ids ^ step
            digest = td_ops.merge(digest,
                                  TDigest(*(f[partner] for f in digest)),
                                  compression)
            step *= 2
        return TDigest(*(f[0] for f in digest))
    # gather every host's centroids along the row and re-cluster once
    _, s, k = digest.mean.shape
    flat_mean = digest.mean.permute(1, 0, 2).reshape(s, h * k)
    flat_w = digest.weight.permute(1, 0, 2).reshape(s, h * k)
    return td_ops.from_centroids(flat_mean, flat_w, digest.min.amin(0),
                                 digest.max.amax(0), compression, k)


def bin_host_slices(temp: TempCentroids,
                    slices: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]],
                    compression: float = td_ops.DEFAULT_COMPRESSION,
                    update_stats: bool = True) -> TempCentroids:
    """The host fan-in of one chunk, into ``temp`` IN PLACE: each host
    slice ``(rows, values, weights)`` (rows == S is padding) bins into a
    FRESH temp anchored on ``temp``'s accumulated anchor summary (so
    ordered arrival stays value-coherent across chunks),
    :func:`merge_temp` sums the fresh temps over the hosts axis, and the
    sum adds into ``temp``: what the JAX mesh's per-device binning, its
    psum and its accumulate compute. The fresh temps hold only the
    chunk's rows, compacted, and each touched row is added once, so the
    result equals the JAX package's full-plane ``temp + psum`` while the
    cost follows the chunk, not the capacity. Returns ``temp``."""
    cap, k = temp.sum_w.shape
    live = [sl for sl in slices if sl[0].numel()]
    if not live:
        return temp
    rows_all = torch.cat([sl[0] for sl in live])
    uniq = torch.unique(rows_all[rows_all < cap])
    n = uniq.numel()
    if n == 0:
        return temp
    acc_w, acc_wm = temp.seg_w[uniq], temp.seg_wm[uniq]
    fresh = []
    for rows, vals, wts in live:
        local = torch.where(rows < cap, torch.searchsorted(uniq, rows), n)
        t = td_ops.init_temp(n, k, compression, device=temp.sum_w.device)
        td_ops.ingest_chunk(t, local, vals, wts, compression, update_stats,
                            acc_seg_w=acc_w, acc_seg_wm=acc_wm)
        fresh.append(t)
    d = merge_temp(TempCentroids(*(torch.stack(f) for f in zip(*fresh))))
    for name in ("sum_w", "sum_wm", "seg_w", "seg_wm"):
        getattr(temp, name).index_add_(0, uniq, getattr(d, name))
    if update_stats:
        temp.count.index_add_(0, uniq, d.count)
        temp.vsum.index_add_(0, uniq, d.vsum)
        temp.recip.index_add_(0, uniq, d.recip)
        temp.vmin.scatter_reduce_(0, uniq, d.vmin, "amin")
        temp.vmax.scatter_reduce_(0, uniq, d.vmax, "amax")
    return temp
