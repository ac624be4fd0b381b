"""Mesh-sharded scope-class groups: the global tier's store on a shard mesh.

Port of ``veneur_tpu/core/mesh_store.py``: a global instance whose import
servers (HTTP ``/import``, ``native://``) feed device state sharded over
a ``(series, hosts)`` :class:`~veneur_tpu_torch.parallel.mesh.ShardMesh`,
the form of the reference's global veneur merging forwarded sketches
across its worker shards (``importsrv/server.go:101-132`` +
``flusher.go:56-58``).

Layout (``parallel/mesh.py``; placement in ``fleet/router.py``):

- **series axis** - every shard owns a contiguous block of physical
  rows of each plane, as one reference worker owns its
  ``map[MetricKey]*sampler`` (``worker.go:54-91``). A series' physical
  row is chosen at intern time by the fleet
  :class:`~veneur_tpu_torch.fleet.router.ShardRouter` (the proxy ring's
  rule), so ownership is balanced from the first interval. The interner
  stays dense and sequential; flushes and snapshots gather the
  placement's permutation so every consumer still sees interner order.
- **hosts axis** - a staged sample chunk splits into ``[H, chunk/H]``
  host slices; each slice bins into a fresh temp anchored on the
  accumulated bins, and the slices' bins sum into the group
  (``parallel/collectives.bin_host_slices``).
- **shard-routed import** - a staged import chunk drains as a
  ``[shards, b]`` stack (``route_stack``): each shard's lane holds its
  own rows' whole centroid runs; a row outside its lane's block lands on
  the padding row at weight 0 (torch has no ``mode="drop"``).
- **the shift guard** sums its shifted and total masses per shard block
  first, then across shards (and host slices) in order, as the JAX mesh
  psums them, so every shard takes the drain the JAX mesh store takes.

Every program is row-local, so one launch over the whole blocked plane
is the per-shard program of every block: K2 on the guard drains, K1 at
the flush (``_flush_digests``), one launch each.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from veneur_tpu_torch.core import store as _store
from veneur_tpu_torch.core.bucketing import pow2_cap
from veneur_tpu_torch.core.store import (IMPORT_DRAIN_BATCH, _GROW_FACTOR,
                                         DigestGroup, HeavyHitterGroup,
                                         ScalarGroup, SetGroup)
from veneur_tpu_torch.fleet.router import (ShardPlacement, ShardRouter,
                                           route_stack)
from veneur_tpu_torch.obs import kernels as obs_kernels
from veneur_tpu_torch.ops import tdigest as td_ops
from veneur_tpu_torch.parallel import collectives
from veneur_tpu_torch.parallel.mesh import ShardMesh

_TINY = torch.finfo(torch.float32).tiny

# one host slice of a chunk: (rows, values, weights) on the device, rows
# physical with the padding row == capacity
_Slice = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _round_up(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _blocked_pad(t: torch.Tensor, shards: int, old_block: int,
                 fill=0.0) -> torch.Tensor:
    """Double every shard's contiguous block of dim 0: reshape to
    per-shard blocks, pad each block, reshape back. The device twin of
    ``ShardPlacement.grow``: physical row (shard, local) moves from
    ``shard*B + local`` to ``shard*2B + local`` on both sides."""
    rest = tuple(t.shape[1:])
    a = t.reshape((shards, old_block) + rest)
    return torch.cat([a, a.new_full((shards, old_block) + rest, fill)],
                     dim=1).reshape((shards * old_block * 2,) + rest)


def _relocal(stack: torch.Tensor, block: int) -> torch.Tensor:
    """A ``[shards, b]`` row stack with each lane's rows outside its own
    shard block replaced by the padding row ``shards*block`` (the JAX
    mesh's ``_relocal``, whose out-of-block rows drop in the scatter)."""
    shards = stack.shape[0]
    start = (torch.arange(shards, device=stack.device) * block)[:, None]
    ok = (stack >= start) & (stack < start + block)
    return torch.where(ok, stack, shards * block)


def _guarded_drain(temp: td_ops.TempCentroids, digest: td_ops.TDigest,
                   slices: List[_Slice], shards: int,
                   compression: float) -> td_ops.TDigest:
    """The dense store's shift guard, mesh form. Each slice's per-row
    shifted and chunk masses sum per shard block, then over the slices
    (hosts) and the shards in order: the JAX mesh's psum over both axes.
    When the guard fires, the bins drain into the digests through K2
    (one launch over the blocked plane, row-local) and zero. Updates
    ``temp`` in place; returns the digests."""
    cap = temp.sum_w.shape[0]
    parts = []
    for rows, vals, wts in slices:
        shifted, cmass = td_ops.shift_masses_by_row(
            temp.seg_w, temp.seg_wm, rows, vals, wts, cap)
        parts.append(torch.stack([shifted.view(shards, -1).sum(1),
                                  cmass.view(shards, -1).sum(1)]))
    if not parts:
        return digest
    shifted, total = torch.stack(parts).sum(0).sum(1)
    pred = shifted > td_ops.SHIFT_GUARD_FRAC * torch.clamp_min(total, _TINY)
    if bool(pred.item()):
        digest = td_ops.drain_temp(digest, temp, compression)
        for plane in (temp.sum_w, temp.sum_wm, temp.seg_w, temp.seg_wm):
            plane.zero_()
    return digest


def _mesh_ingest_samples(temp, digest, slices: List[_Slice], shards: int,
                         compression: float) -> td_ops.TDigest:
    """Hosts-sharded sample ingest: the guard over every (shard, host
    slice), then each host slice binned against the accumulated bins and
    the slices' bins summed into the group. Returns the digests."""
    digest = _guarded_drain(temp, digest, slices, shards, compression)
    collectives.bin_host_slices(temp, slices, compression)
    return digest


def _mesh_import_routed(temp, digest, dmin, dmax, r_st, m_st, w_st,
                        sr_st, mn_st, mx_st, shards: int,
                        compression: float) -> td_ops.TDigest:
    """Shard-routed centroid import: the staged chunk as ``[shards, b]``
    stacks from the fleet router's placement. Each lane keeps only its
    own block's rows (whole sorted centroid runs: a row's run lives on
    one shard); the guard sums over the shards; the bins take the
    centroids without the local scalar stats (samplers.go:473-480); the
    imported extrema scatter into dmin/dmax. Updates temp, dmin and dmax
    in place; returns the digests."""
    cap = temp.sum_w.shape[0]
    block = cap // shards
    if r_st.numel():
        rows = _relocal(r_st, block).reshape(-1)
        wts = torch.where(rows < cap, w_st.reshape(-1), 0.0)
        sl = [(rows, m_st.reshape(-1), wts)]
        digest = _guarded_drain(temp, digest, sl, shards, compression)
        collectives.bin_host_slices(temp, sl, compression,
                                    update_stats=False)
    if sr_st.numel():
        _store._scatter_extrema(dmin, dmax,
                                _relocal(sr_st, block).reshape(-1),
                                mn_st.reshape(-1), mx_st.reshape(-1))
    return digest


class _PlacementMixin:
    """Router-driven shard assignment shared by every mesh group.

    The id contract: everything that crosses the group boundary (``_row``
    results, staged buffers, the native intern memos, lane resolvers,
    bulk-ingest row lists) speaks LOGICAL (interner) rows, stable for a
    generation's life. The placement's shard-blocked PHYSICAL rows appear
    only inside the drains (``_to_phys`` translates each chunk at drain
    time against the CURRENT placement) and the flush and snapshot
    gathers, so a mid-interval ``_grow``, which moves every physical
    id, never stales a cached row."""

    router: ShardRouter
    placement: ShardPlacement
    shards: int

    def _route_new_row(self, row: int, key) -> None:
        """Assign a freshly interned logical row to its shard (the
        overflow row routes by its own interned identity, so every
        instance of the fleet places it identically)."""
        mtype = (self._overflow_type if row == self._overflow_row
                 else key.type)
        shard = self.router.shard_for(self.interner.names[row], mtype,
                                      self.interner.joined[row])
        while self.placement.full(shard):
            self._grow()
        self.placement.assign(row, shard)

    def _row(self, key, tags) -> int:
        row = self._intern_row(key, tags)
        if not self.placement.assigned(row):
            self._route_new_row(row, key)
        return row

    def ensure_capacity(self, max_row: int):
        while max_row >= self.capacity:
            self._grow()

    def _to_phys(self, rows: np.ndarray) -> np.ndarray:
        """One staged chunk's logical rows -> current physical rows
        (sentinels and unassigned rows -> capacity, the padding row). In
        slot mode the caller already speaks physical slots."""
        if self.placement is None:
            return np.asarray(rows)
        return self.placement.to_phys(np.asarray(rows), self.capacity)

    def _shard_of_phys(self, phys: np.ndarray) -> np.ndarray:
        """Owning shard of physical rows: the one copy of the block
        rule (the padding row clamps to the last shard, where its lane
        drops it)."""
        return np.minimum(np.asarray(phys) // (self.capacity // self.shards),
                          self.shards - 1)

    def _reset_placement(self) -> None:
        """The interner swapped (an in-place flush): the placement must
        too, so the next interval's first series consults the router
        (a generation swap gets this from ``fresh()``)."""
        if self.placement is not None \
                and not getattr(self, "_retired", False):
            self.placement = ShardPlacement(self.shards, self.capacity)

    def _flush_rows(self, n: int) -> np.ndarray:
        """Physical rows of logical rows 0..n-1: the gather that restores
        interner order in flush and snapshot output (in slot mode, the
        owner's slots, ``_ext_rows``)."""
        if self.placement is None:
            return np.asarray(self._ext_rows[:n], np.int64)
        return self.placement.perm(n)

    def _live_index(self, n: int):
        return torch.from_numpy(self._flush_rows(n)).to(self.device)


def _mesh_init(group, mesh: ShardMesh, router: Optional[ShardRouter],
               capacity: int, slot_mode: bool = False) -> int:
    """The mesh attributes every mesh group sets before its base
    constructor; returns the capacity rounded to whole shard blocks. In
    slot mode the group has no router and no placement."""
    group.mesh = mesh
    group.shards = mesh.series
    group.hosts = mesh.hosts
    cap = _round_up(capacity, group.shards)
    if slot_mode:
        group.router = group.placement = None
    else:
        group.router = (router if router is not None
                        else ShardRouter(mesh.series))
        group.placement = ShardPlacement(group.shards, cap)
    return cap


class MeshDigestGroup(_PlacementMixin, DigestGroup):
    """A DigestGroup whose planes are sharded over a fleet mesh: series
    place through the fleet consistent hash (``router``; a fresh one over
    the mesh's shards by default), samples ingest in host slices, imports
    drain shard-routed.

    ``slot_mode``: the mesh tiered group's dense bank. There is no router
    and no placement: the owner assigns each series a physical slot on
    the shard of its pool row, stages physical slots, and names the
    slots a flush gathers in ``_ext_rows``."""

    _SCOPE = "mesh"

    def __init__(self, mesh: ShardMesh, capacity: int, chunk: int,
                 compression: float, router: Optional[ShardRouter] = None,
                 slot_mode: bool = False):
        cap = _mesh_init(self, mesh, router, capacity, slot_mode)
        self._ext_rows: Optional[np.ndarray] = None
        super().__init__(cap, _round_up(chunk, self.hosts), compression,
                         mesh.device)

    def _grow(self):
        """x2 growth that keeps the shard-blocked layout: every plane
        pads PER SHARD BLOCK and the placement recomputes its physical
        ids to match (a tail pad would give every new row to the last
        shard)."""
        self._drain_staging()
        sh, ob = self.shards, self.capacity // self.shards
        self.capacity *= _GROW_FACTOR
        inf = float("inf")
        t, d = self.temp, self.digest
        self.temp = td_ops.TempCentroids(
            sum_w=_blocked_pad(t.sum_w, sh, ob),
            sum_wm=_blocked_pad(t.sum_wm, sh, ob),
            seg_w=_blocked_pad(t.seg_w, sh, ob),
            seg_wm=_blocked_pad(t.seg_wm, sh, ob),
            count=_blocked_pad(t.count, sh, ob),
            vsum=_blocked_pad(t.vsum, sh, ob),
            vmin=_blocked_pad(t.vmin, sh, ob, inf),
            vmax=_blocked_pad(t.vmax, sh, ob, -inf),
            recip=_blocked_pad(t.recip, sh, ob))
        self.digest = td_ops.TDigest(
            mean=_blocked_pad(d.mean, sh, ob, inf),
            weight=_blocked_pad(d.weight, sh, ob),
            min=_blocked_pad(d.min, sh, ob, inf),
            max=_blocked_pad(d.max, sh, ob, -inf))
        self.dmin = _blocked_pad(self.dmin, sh, ob, inf)
        self.dmax = _blocked_pad(self.dmax, sh, ob, -inf)
        if self.placement is not None:
            self.placement.grow()
        # re-point staging padding at the new out-of-range row id
        self._rows[self._fill:] = self.capacity
        self._imp_rows[self._imp_fill:] = self.capacity
        self._imp_stat_rows[self._imp_stat_fill:] = self.capacity

    def _host_slices(self, rows, vals, wts, fill: int) -> List[_Slice]:
        """The staged chunk as the mesh's ``[H, chunk/H]`` host slices,
        each cut to a pow2 prefix of its live samples (padding adds
        nothing); slices without a live sample are left out."""
        per = len(rows) // self.hosts
        dev = self.device
        out = []
        for h in range(self.hosts):
            live = min(max(fill - h * per, 0), per)
            if not live:
                continue
            lo = h * per
            hi = lo + min(pow2_cap(live), per)
            out.append((torch.from_numpy(rows[lo:hi]).to(dev).long(),
                        torch.from_numpy(vals[lo:hi]).to(dev),
                        torch.from_numpy(wts[lo:hi]).to(dev)))
        return out

    def _drain_samples(self):
        if self._fill == 0:
            return
        self._device_dirty = True
        rows, vals, wts, fill = self._rows, self._vals, self._wts, self._fill
        self._new_sample_buffers()
        with obs_kernels.scope("drain.digest.mesh", self.device):
            self.digest = _mesh_ingest_samples(
                self.temp, self.digest,
                self._host_slices(self._to_phys(rows), vals, wts, fill),
                self.shards, self.compression)

    def _drain_imports(self):
        if self._imp_fill == 0 and self._imp_stat_fill == 0:
            return
        self._device_dirty = True
        nf, ns = self._imp_fill, self._imp_stat_fill
        rows = self._to_phys(self._imp_rows[:nf])
        means, wts = self._imp_means[:nf], self._imp_wts[:nf]
        srows = self._to_phys(self._imp_stat_rows[:ns])
        smins, smaxs = self._imp_stat_mins[:ns], self._imp_stat_maxs[:ns]
        self._new_import_buffers()
        stacks = ()
        for r, payload in ((rows, [means, wts]), (srows, [smins, smaxs])):
            if len(r):
                r_st, (a_st, b_st) = route_stack(
                    self.shards, self._shard_of_phys(r), r, payload,
                    self.capacity)
            else:
                r_st, a_st, b_st = (np.empty((self.shards, 0), a.dtype)
                                    for a in (r, *payload))
            stacks += tuple(torch.from_numpy(a).to(self.device)
                            for a in (r_st, a_st, b_st))
        r_st, m_st, w_st, sr_st, mn_st, mx_st = stacks
        with obs_kernels.scope("drain.digest.mesh", self.device):
            self.digest = _mesh_import_routed(
                self.temp, self.digest, self.dmin, self.dmax, r_st.long(),
                m_st, w_st, sr_st.long(), mn_st, mx_st, self.shards,
                self.compression)

    def _flush_dispatch(self, n: int, percentiles, want_digests,
                        want_stats):
        """The flush program (K1, one launch over the blocked plane) and
        the permutation gather back to interner order."""
        if want_digests == "packed":
            raise NotImplementedError(
                "packed digest export is a forwarding-local concern; a "
                "mesh global emits percentiles and never re-forwards")
        return super()._flush_dispatch(n, percentiles, want_digests,
                                       want_stats)

    def flush_begin(self, percentiles, want_digests=False, want_stats=None):
        """Two-phase flush (``DigestGroup.flush_begin``); the placement
        resets with the interner once ``finish`` commits."""
        fin = super().flush_begin(percentiles, want_digests, want_stats)

        def finish():
            out = fin()
            self._reset_placement()
            return out

        return finish

    def restore_stats(self, rows: np.ndarray, count, vsum, vmin, vmax,
                      recip):
        """Logical rows from the restore path scatter at their CURRENT
        physical placement."""
        if not len(rows):
            return
        super().restore_stats(self._to_phys(np.asarray(rows, np.int64)),
                              count, vsum, vmin, vmax, recip)

    def fresh(self) -> "MeshDigestGroup":
        """Empty same-config twin (the generation swap); it shares the
        router, so a series keeps its shard across intervals."""
        return MeshDigestGroup(self.mesh, self.capacity, self.chunk,
                               self.compression, router=self.router)


class MeshSetGroup(_PlacementMixin, SetGroup):
    """A SetGroup whose [S, 2^p] register plane is series-sharded (16 KiB
    a series at p=14)."""

    def __init__(self, mesh: ShardMesh, capacity: int, chunk: int,
                 precision: int, router: Optional[ShardRouter] = None):
        cap = _mesh_init(self, mesh, router, capacity)
        super().__init__(cap, _round_up(chunk, self.hosts), precision,
                         mesh.device)

    def _grow(self):
        self._drain_staging()
        ob = self.capacity // self.shards
        self.capacity *= _GROW_FACTOR
        self.registers = _blocked_pad(self.registers, self.shards, ob, 0)
        self.placement.grow()
        self._rows[self._fill:] = self.capacity

    def _drain_samples(self):
        """The staged members' register scatter-max at their physical
        rows. The JAX mesh scatters a host slice a device and pmaxes over
        hosts; a max is order-free, so one scatter of the chunk equals
        it."""
        if self._fill == 0:
            return
        self._device_dirty = True
        n = pow2_cap(self._fill)
        rows = self._to_phys(self._rows[:n])
        hi, lo = self._hi[:n], self._lo[:n]
        self._new_sample_buffers()
        dev = self.device
        with obs_kernels.scope("drain.set.mesh", dev):
            _store._ingest_hashes(
                self.registers, torch.from_numpy(rows).to(dev).long(),
                torch.from_numpy(hi.view(np.int32)).to(dev),
                torch.from_numpy(lo.view(np.int32)).to(dev))

    def _drain_imports(self):
        """Shard-routed register import over the live rows only: each
        forwarded sketch lands in its own shard's block."""
        if not self._imp_rows:
            return
        self._device_dirty = True
        rows = self._to_phys(np.asarray(self._imp_rows, np.int64))
        regs = np.stack(self._imp_regs).astype(np.uint8)
        self._imp_rows.clear()
        self._imp_regs.clear()
        r_st, (regs_st,) = route_stack(
            self.shards, self._shard_of_phys(rows), rows, [regs],
            self.capacity, min_width=IMPORT_DRAIN_BATCH // self.shards)
        block = self.capacity // self.shards
        start = (np.arange(self.shards) * block)[:, None]
        ok = (r_st >= start) & (r_st < start + block)
        if ok.any():
            with obs_kernels.scope("drain.set.mesh", self.device):
                _store._merge_registers(self.registers, r_st[ok],
                                        regs_st[ok])

    def flush_begin(self, want_estimates: bool = True,
                    want_registers: bool = False):
        """Two-phase flush: the permutation-gathered estimate and
        register refs dispatch now, and the placement resets with the
        interner."""
        with obs_kernels.scope("flush.set.mesh", self.device):
            fin = super().flush_begin(want_estimates, want_registers)
        self._reset_placement()
        return fin

    def fresh(self) -> "MeshSetGroup":
        return MeshSetGroup(self.mesh, self.capacity, self.chunk,
                            self.precision, router=self.router)


class MeshScalarGroup(_PlacementMixin, ScalarGroup):
    """Counters and gauges under fleet mode: the state stays host numpy
    (exact int64 accumulation, float64 last-write), logical-indexed, but
    rows place through the SAME shard router as the device groups, so
    one shard owns a series across every group of the store (the
    ownership a per-shard handoff builds on, and the occupancy
    :func:`~veneur_tpu_torch.fleet.fleet_snapshot` reports)."""

    def __init__(self, kind: str, capacity: int, mesh: ShardMesh,
                 router: ShardRouter):
        if kind == "status":
            raise ValueError("status checks are local-only; they never "
                             "ride the mesh")
        cap = _mesh_init(self, mesh, router, capacity)
        super().__init__(kind, cap)

    def _grow(self):
        # no device planes to lay out: the placement is ownership
        # accounting only, so the values grow by a tail pad
        self.capacity *= _GROW_FACTOR
        self.values = np.concatenate(
            [self.values, np.zeros(self.capacity - len(self.values),
                                   self.values.dtype)])
        self.placement.grow()

    def snapshot_and_reset(self):
        out = super().snapshot_and_reset()
        self._reset_placement()
        return out

    def fresh(self) -> "MeshScalarGroup":
        return MeshScalarGroup(self.kind, self.capacity, self.mesh,
                               self.router)


class MeshHeavyHitterGroup(_PlacementMixin, HeavyHitterGroup):
    """Heavy hitters under fleet mode: the per-series top-k planes
    ([S, k] ids and counts) and the sid vector shard over the series
    axis, while the count-min TABLE stays whole: it is series-shared
    state (every row salts into the same [depth, width] grid), and
    per-shard partial tables would change the collision population and
    so the point estimates."""

    def __init__(self, capacity: int, chunk: int, depth: int, width: int,
                 k: int, mesh: ShardMesh, router: ShardRouter):
        cap = _mesh_init(self, mesh, router, capacity)
        super().__init__(cap, chunk, depth, width, k, mesh.device)

    def _row(self, key, tags) -> int:
        # _sids_np stays LOGICAL-indexed: the sid is a per-sample value
        # gathered on the host at drain time
        row = _PlacementMixin._row(self, key, tags)
        if self._sids_np[row] == 0:  # first sight (or the 2^-32 rehash)
            self._sids_np[row] = self.stable_sid(self.interner.names[row],
                                                 self.interner.joined[row])
        return row

    def _grow(self):
        self._drain_samples()
        sh, ob = self.shards, self.capacity // self.shards
        self.capacity *= _GROW_FACTOR
        sk = self.sketch
        for name in ("topk_hi", "topk_lo", "topk_counts", "sids"):
            setattr(sk, name, _blocked_pad(getattr(sk, name), sh, ob, 0))
        self.placement.grow()
        sids = np.zeros(self.capacity + 1, np.uint32)
        sids[:len(self._sids_np) - 1] = self._sids_np[:-1]
        self._sids_np = sids
        self._rows[self._fill:] = self.capacity

    def _drain_samples(self):
        if self._fill == 0:
            return
        self._device_dirty = True
        rows, hi, lo, wts = self._rows, self._hi, self._lo, self._wts
        self._new_sample_buffers()
        dev = self.device
        sids = self._sids_np[np.minimum(rows, self.capacity)]
        self.sketch = self._update(
            self.sketch, torch.from_numpy(self._to_phys(rows)).to(dev),
            torch.from_numpy(sids.view(np.int32)).to(dev),
            torch.from_numpy(hi.view(np.int32)).to(dev),
            torch.from_numpy(lo.view(np.int32)).to(dev),
            torch.from_numpy(wts).to(dev))

    def _scatter_rows(self, rows: np.ndarray) -> np.ndarray:
        return self._to_phys(rows)

    def flush_begin(self, want_forward: bool = False):
        """Two-phase flush: the gathered top-k plane refs are taken now,
        and the placement resets with the interner."""
        fin = super().flush_begin(want_forward)
        self._reset_placement()
        return fin

    def fresh(self) -> "MeshHeavyHitterGroup":
        g = MeshHeavyHitterGroup(self.capacity, self.chunk, self.depth,
                                 self.width, self.k, self.mesh,
                                 self.router)
        g._update = self._update
        return g
