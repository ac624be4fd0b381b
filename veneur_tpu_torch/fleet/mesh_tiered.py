"""The mesh tiered store: the packed pool over a shard mesh.

Port of ``veneur_tpu/fleet/mesh_tiered.py`` (``mesh_enabled: true`` with
``digest_storage: tiered``). The port's :class:`~veneur_tpu_torch.
parallel.mesh.ShardMesh` is a shape on one card (series shards are
contiguous row blocks of each plane), so every pool slab's flat planes
are blocked a shard at a time: shard ``d`` of
``S`` owns slab-local rows ``[d*R/S, (d+1)*R/S)``. A
:class:`~veneur_tpu_torch.fleet.router.PoolPlacement` puts each series
in its shard's block of the lowest slab with room (the fleet
:class:`~veneur_tpu_torch.fleet.router.ShardRouter` picks the shard),
and the hot tier is a :class:`~veneur_tpu_torch.core.mesh_store.
MeshDigestGroup` bank in slot mode. The whole tiered lifecycle runs
sharded:

- **drains are shard-routed**: a staged chunk partitions per slab (as on
  one card) and then per shard (``route_stack``), so each shard's lane
  holds its own rows' samples, whole and in order; binning is per row
  (``ops/tdigest.bin_pool_samples``), so each shard bins only its own
  rows.
- **the guard decision sums over the blocks**: the three drain triggers
  of ``core/tiered.py`` (the shifted and chunk masses and the clump and
  dominance rows) sum per shard block, then over the blocks, before the
  threshold, as the JAX mesh psums them: every shard drains where the
  single-device pool would.
- **one launch over the blocked plane**: every program is row-local, so
  the pool compaction (``_pool_compact`` -> ``tdigest_cuda.
  compress_presorted``: K2 on the narrow path at merge width 2 x PK)
  runs once over a whole slab, which is the per-shard program of every
  block; it is never looped a shard at a time. The bank's flush is K1,
  once over its blocked plane.
- **promotion is shard-local**: a series' dense slot is on the SAME
  shard as its pool row, so the promotion moves pool state into the
  bank's temp within one shard's blocks, counts conserved exactly.
- **flush and snapshot gather back to interner order** through the
  placement's permutation: pool rows are shard-placed, not a prefix.

Rows crossing this group's boundary (``_row``, staging, ``restore_stats``)
are PHYSICAL pool rows, stable for a generation's life (a slab append
never moves a row); ``_logical`` maps them back to interner rows.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from veneur_tpu_torch.core import slab
from veneur_tpu_torch.core.mesh_store import MeshDigestGroup, _round_up
from veneur_tpu_torch.core.store import (DEFAULT_CHUNK,
                                         DEFAULT_INITIAL_CAPACITY,
                                         _fetch_copies, _snapshot_copies,
                                         flatten_digest_state)
from veneur_tpu_torch.core.tiered import (DEFAULT_DEMOTE_INTERVALS,
                                          DEFAULT_POOL_CENTROIDS,
                                          DEFAULT_PROMOTE_INTERVALS,
                                          DEFAULT_PROMOTE_SAMPLES,
                                          POOL_SLAB_ROWS_DEFAULT, PoolSlab,
                                          TieredDigestGroup, _guard_fires,
                                          _pool_guard_apply,
                                          _pool_scatter_imports,
                                          _pool_scatter_samples,
                                          _pool_trigger_rows, _promote_rows,
                                          dequantize_host)
from veneur_tpu_torch.fleet.router import (PoolPlacement, ShardRouter,
                                           inverse_perm, route_stack)
from veneur_tpu_torch.obs import kernels as obs_kernels
from veneur_tpu_torch.ops import tdigest as td_ops
from veneur_tpu_torch.parallel.mesh import ShardMesh


def _mesh_guard_drain(pool: PoolSlab, rows, values, weights, slab_rows: int,
                      pk: int, pcomp: float, shards: int) -> bool:
    """The pool's shift guard with the DECISION summed over the shard
    blocks: each block's shifted and chunk masses and trigger rows sum
    per block, then over the blocks (the JAX mesh's psum), before the
    threshold. The drain itself is row-local: one K2 launch over the
    whole blocked slab. Returns whether it drained."""
    shifted, cmass = td_ops.shift_masses_by_row(
        pool.bw, pool.bwm, rows, values, weights, slab_rows, anchors=pk)
    over, dom = _pool_trigger_rows(pool, rows, weights, slab_rows, pk,
                                   pcomp)
    trig = over.float() + dom.float()
    blocks = torch.stack([t.view(shards, -1).sum(1)
                          for t in (shifted, cmass, trig)])
    if not _guard_fires(*blocks.sum(1)):
        return False
    _pool_guard_apply(pool, slab_rows, pk, pcomp)
    return True


class MeshTieredDigestGroup(TieredDigestGroup):
    """``TieredDigestGroup`` over a shard mesh (see the module
    docstring): the same public surface, a physical row space managed by
    a :class:`PoolPlacement` (slab-append, rows never move), and a
    series-blocked dense bank in slot mode."""

    _SCOPE = "mesh_tiered"

    def __init__(self, mesh: ShardMesh, router: ShardRouter,
                 slab_rows: int = POOL_SLAB_ROWS_DEFAULT,
                 chunk: int = DEFAULT_CHUNK,
                 compression: float = td_ops.DEFAULT_COMPRESSION,
                 pool_centroids: int = DEFAULT_POOL_CENTROIDS,
                 promote_samples: int = DEFAULT_PROMOTE_SAMPLES,
                 promote_intervals: int = DEFAULT_PROMOTE_INTERVALS,
                 demote_intervals: int = DEFAULT_DEMOTE_INTERVALS,
                 dense_capacity: int = DEFAULT_INITIAL_CAPACITY,
                 directory=None):
        self.mesh = mesh
        self.router = router
        self.shards = mesh.series
        self._dense_shard: List[int] = []
        self._dense_idx: List[int] = []
        self._dense_slots: List[int] = []
        self._bank_fills = np.zeros(self.shards, np.int64)
        slab_rows = _round_up(min(slab_rows, slab.MAX_SLAB_ROWS),
                              self.shards)
        super().__init__(slab_rows, chunk, compression, pool_centroids,
                         promote_samples, promote_intervals,
                         demote_intervals, dense_capacity,
                         directory=directory, device=mesh.device)
        self.placement = PoolPlacement(self.shards, self.slab_rows)
        self._logical = np.full(len(self._slot), -1, np.int64)

    # -- placement --------------------------------------------------------

    def _make_dense_bank(self, dense_capacity, chunk, compression):
        # slot mode: this group assigns the bank's slots itself, each on
        # the shard of its pool row
        return MeshDigestGroup(self.mesh, dense_capacity, chunk,
                               compression, slot_mode=True)

    def _append_slab(self) -> None:
        self.pools.append(self._new_pool_slab())
        grow = self.capacity - len(self._slot)
        if grow > 0:
            self._slot = np.concatenate(
                [self._slot, np.full(grow, -1, np.int32)])
            self._activity = np.concatenate(
                [self._activity, np.zeros(grow, np.int64)])
            self._logical = np.concatenate(
                [self._logical, np.full(grow, -1, np.int64)])
        # staged sentinel rows track the new out-of-range id
        self._rows[self._fill:] = self.capacity
        self._imp_rows[self._imp_fill:] = self.capacity
        self._imp_stat_rows[self._imp_stat_fill:] = self.capacity

    def ensure_capacity(self, max_row: int):
        while max_row >= self.capacity:
            self._append_slab()

    def _row(self, key, tags) -> int:
        row = self._intern_row(key, tags)  # logical
        if self.placement.assigned(row):
            return self.placement.phys(row)
        mtype = (self._overflow_type if row == self._overflow_row
                 else key.type)
        shard = self.router.shard_for(self.interner.names[row], mtype,
                                      self.interner.joined[row])
        phys, appended = self.placement.assign(row, shard)
        if appended:
            self._append_slab()
        self._logical[phys] = row
        if (row != self._overflow_row
                and self.directory.is_dense((key.name, key.joined_tags))):
            self._assign_dense(phys)
        return phys

    def _assign_dense(self, row: int) -> int:
        """A dense slot ON THE SAME SHARD as the pool row: the invariant
        that keeps promotion shard-local."""
        shard = int((row % self.slab_rows) // self.placement.block)
        bank = self._dense
        block = bank.capacity // self.shards
        if self._bank_fills[shard] >= block:
            bank._grow()  # the blocked pad doubles every shard's block
            block = bank.capacity // self.shards
            self._dense_slots = [s * block + i for s, i in
                                 zip(self._dense_shard, self._dense_idx)]
            for r, sl in zip(self._dense_rows, self._dense_slots):
                self._slot[r] = sl
        idx = int(self._bank_fills[shard])
        self._bank_fills[shard] += 1
        slot = shard * block + idx
        self._dense_rows.append(row)
        self._dense_shard.append(shard)
        self._dense_idx.append(idx)
        self._dense_slots.append(slot)
        self._slot[row] = slot
        return slot

    # -- drains -----------------------------------------------------------

    def _route(self, local: np.ndarray, arrays) -> tuple:
        """A slab's span (slab-local physical rows) as one flat chunk of
        its ``[shards, b]`` routed stack: lane ``d`` holds shard ``d``'s
        rows' entries, whole and in order, padded with the sentinel row
        ``slab_rows`` at weight 0."""
        r_st, a_st = route_stack(self.shards,
                                 self.placement.shard_of_local(local),
                                 local, arrays, self.slab_rows)
        return (self._dev(r_st.reshape(-1)),
                *(self._dev(a.reshape(-1)) for a in a_st))

    def _pool_drain_samples(self, i: int, local, vals, wts) -> None:
        rows, v, w = self._route(local, [vals, wts])
        pool, R = self.pools[i], self.slab_rows
        with obs_kernels.scope("drain.digest.mesh_tiered", self.device):
            _mesh_guard_drain(pool, rows, v, w, R, self.pk, self.pcomp,
                              self.shards)
            _pool_scatter_samples(pool, rows, v, w, R, self.pk,
                                  self.pcomp)

    def _pool_drain_imports(self, i: int, c_local, c_means, c_wts,
                            s_local, s_mins, s_maxs) -> None:
        rows, m, w = self._route(c_local, [c_means, c_wts])
        pool, R = self.pools[i], self.slab_rows
        with obs_kernels.scope("drain.digest.mesh_tiered", self.device):
            _mesh_guard_drain(pool, rows, m, w, R, self.pk, self.pcomp,
                              self.shards)
            _pool_scatter_imports(pool, rows, m, w, self._dev(s_local),
                                  self._dev(s_mins), self._dev(s_maxs), R,
                                  self.pk, self.pcomp)

    # -- promotion --------------------------------------------------------

    def _maybe_promote(self, touched_rows: np.ndarray):
        """The base rule over PHYSICAL rows: candidates are placed rows
        (``_logical`` maps them to the interner identity the directory
        keys on); each promoted row's bank slot is on its own shard."""
        touched_rows = touched_rows[touched_rows < len(self._logical)]
        cand = np.unique(touched_rows[
            (self._logical[touched_rows] >= 0)
            & (self._slot[touched_rows] < 0)
            & (self._activity[touched_rows] >= self.promote_samples)])
        if not len(cand):
            return
        names, joined = self.interner.names, self.interner.joined

        def ident(phys: int):
            lr = int(self._logical[phys])
            return names[lr], joined[lr]

        promote = [int(r) for r in cand
                   if self.directory.should_promote(ident(r))]
        if not promote:
            return
        rows = np.asarray(promote, np.int64)
        for r in promote:
            self._assign_dense(r)
        # slots read AFTER the batch: a bank _grow mid-batch moves every
        # slot, and _assign_dense keeps _slot current
        slots = self._slot[rows].astype(np.int64)
        self._sync_plumbing()
        d = self._dense
        d._drain_staging()  # promoted mass lands on settled bins
        d._device_dirty = True
        slabs = rows // self.slab_rows
        with obs_kernels.scope("drain.digest.mesh_tiered", self.device):
            for i in np.unique(slabs):
                sel = slabs == i
                _promote_rows(self.pools[int(i)], d.temp, d.dmin, d.dmax,
                              self._dev(rows[sel] - i * self.slab_rows),
                              self._dev(slots[sel]), self.slab_rows,
                              self.pk, self.compression)
        self.directory.note_promoted([ident(r) for r in promote])

    # -- flush ------------------------------------------------------------

    def _flush_dispatch(self, n: int, percentiles, want_digests,
                        want_stats) -> dict:
        if want_digests == "packed":
            raise NotImplementedError(
                "packed digest export is a forwarding-local concern; a "
                "mesh global emits percentiles and never re-forwards")
        # the bank's flush gathers its slots in dense-row order
        self._dense._ext_rows = np.asarray(self._dense_slots, np.int64)
        return super()._flush_dispatch(n, percentiles, want_digests,
                                       want_stats)

    def _slab_need(self, n: int, i: int) -> int:
        return self.slab_rows  # rows are shard-placed, not a prefix

    def _collect_pool(self, st: dict):
        cols, packed = super()._collect_pool(st)
        perm = self.placement.perm(st["n"])
        return [c[perm] for c in cols], packed

    def _dense_out_rows(self) -> np.ndarray:
        return self._logical[np.asarray(self._dense_rows, np.int64)]

    def _end_interval(self, n: int):
        # the live rows' activity through the permutation (physical rows
        # are shard-placed; the base reads a prefix)
        act = self._activity[self.placement.perm(n)]
        names, joined = self.interner.names, self.interner.joined
        self.directory.end_interval(
            (names[r], joined[r])
            for r in np.flatnonzero(act >= self.promote_samples))

    def _flush_commit(self, n: int, out: dict):
        res = super()._flush_commit(n, out)
        self._reset_mesh_plumbing()
        return res

    def _flush_empty(self):
        res = super()._flush_empty()
        self._reset_mesh_plumbing()
        return res

    def _reset_mesh_plumbing(self) -> None:
        if not self._retired:
            self.placement = PoolPlacement(self.shards, self.slab_rows,
                                           slabs=len(self.pools))
            self._logical = np.full(len(self._slot), -1, np.int64)
            self._bank_fills[:] = 0
        self._dense_shard, self._dense_idx, self._dense_slots = [], [], []

    # -- snapshot ---------------------------------------------------------

    def snapshot_begin(self):
        """Phase 1 under the store lock: drain staging (the bank's too),
        copy every pool slab whole and the bank's slots on the device.
        ``finish`` fetches off-lock, flattens each slab in PHYSICAL rows
        and translates them through the inverse permutation, so the
        snapshot carries interner rows and restores into any digest
        store."""
        self._drain_staging()
        self._dense._drain_staging()
        n = len(self.interner)
        snap = {"kind": "digest", "names": list(self.interner.names),
                "joined": list(self.interner.joined)}
        if n == 0:
            return snap, None
        R, pk = self.slab_rows, self.pk
        planes = []
        for p in self.pools:
            planes.extend((p.mq.view(R, pk), p.wb.view(R, pk), p.fmin,
                           p.fmax, p.bw.view(R, pk), p.bwm.view(R, pk),
                           p.dmin, p.dmax, p.count, p.vsum, p.vmin, p.vmax,
                           p.recip))
        npool = len(self.pools)
        nd = len(self._dense_rows)
        log_dense = self._dense_out_rows()
        if nd:
            d = self._dense
            slots = torch.from_numpy(
                np.asarray(self._dense_slots, np.int64)).to(self.device)
            planes.extend(x[slots] for x in (
                d.digest.mean, d.digest.weight, d.temp.sum_w,
                d.temp.sum_wm, d.dmin, d.dmax, d.digest.min, d.digest.max,
                d.temp.count, d.temp.vsum, d.temp.vmin, d.temp.vmax,
                d.temp.recip))
        copies, event = _snapshot_copies(planes)
        perm = self.placement.perm(n)
        inv = inverse_perm(perm, self.capacity)

        def finish():
            host = _fetch_copies(copies, event)
            cap = len(inv)
            rows_p, means_p, weights_p = [], [], []
            scal = {nm: np.zeros(cap, np.float32)
                    for nm in ("count", "vsum", "recip")}
            for nm in ("mins", "vmin"):
                scal[nm] = np.full(cap, np.inf, np.float32)
            for nm in ("maxs", "vmax"):
                scal[nm] = np.full(cap, -np.inf, np.float32)
            for i in range(npool):
                (mq, wb, fmin, fmax, bw, bwm, dmn, dmx, cnt, vsum, vmn,
                 vmx, recip) = host[13 * i:13 * i + 13]
                mean, weight = dequantize_host(
                    mq.view(np.uint16), wb.view(np.uint16), fmin, fmax)
                flat = flatten_digest_state(
                    np.where(weight > 0, mean, np.inf).astype(np.float32),
                    weight, bw, bwm)
                # physical -> interner rows (an unplaced row holds no
                # weight, so the flatten never emits one)
                rows_p.append(inv[flat["rows"].astype(np.int64)
                                  + i * R].astype(np.int32))
                means_p.append(flat["means"])
                weights_p.append(flat["weights"])
                lo, hi = i * R, (i + 1) * R
                scal["mins"][lo:hi] = np.minimum(dmn, vmn)
                scal["maxs"][lo:hi] = np.maximum(dmx, vmx)
                scal["count"][lo:hi] = cnt
                scal["vsum"][lo:hi] = vsum
                scal["vmin"][lo:hi] = vmn
                scal["vmax"][lo:hi] = vmx
                scal["recip"][lo:hi] = recip
            for nm in scal:
                scal[nm] = scal[nm][perm]
            if nd:
                (mean, weight, bin_w, bin_wm, imp_min, imp_max, dmn, dmx,
                 cnt, vsum, vmn, vmx, recip) = host[13 * npool:]
                flat = flatten_digest_state(mean, weight, bin_w, bin_wm)
                rows_p.append(log_dense[flat["rows"]].astype(np.int32))
                means_p.append(flat["means"])
                weights_p.append(flat["weights"])
                scal["mins"][log_dense] = np.minimum(imp_min, dmn)
                scal["maxs"][log_dense] = np.maximum(imp_max, dmx)
                scal["count"][log_dense] = cnt
                scal["vsum"][log_dense] = vsum
                scal["vmin"][log_dense] = vmn
                scal["vmax"][log_dense] = vmx
                scal["recip"][log_dense] = recip
            snap["rows"] = np.concatenate(rows_p) if rows_p else \
                np.empty(0, np.int32)
            snap["means"] = np.concatenate(means_p) if means_p else \
                np.empty(0, np.float64)
            snap["weights"] = np.concatenate(weights_p) if weights_p \
                else np.empty(0, np.float64)
            snap.update(scal)

        return snap, finish

    def fresh(self) -> "MeshTieredDigestGroup":
        """Empty same-config twin; the shared TierDirectory carries
        residency across the swap, the shared router the placement
        rule."""
        return MeshTieredDigestGroup(
            self.mesh, self.router, self.slab_rows, self.chunk,
            self.compression, self.pk, self.directory.promote_samples,
            self.directory.promote_intervals,
            self.directory.demote_intervals, self._dense.capacity,
            directory=self.directory)
