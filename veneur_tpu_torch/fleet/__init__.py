"""Fleet mode: the global tier's store sharded over a shard mesh.

Port of ``veneur_tpu/fleet/__init__.py``. This package owns:

- **mesh construction** - :func:`build_mesh` turns the config
  (``mesh_enabled`` / ``mesh_hosts``) into the ``(series, hosts)``
  :class:`~veneur_tpu_torch.parallel.mesh.ShardMesh`;
- **shard placement** - :class:`~veneur_tpu_torch.fleet.router.ShardRouter`
  and :class:`~veneur_tpu_torch.fleet.router.ShardPlacement` decide which
  series shard owns a series (the proxy's consistent-hash ring rule,
  one tier down) and where its rows live inside the sharded planes;
- **shard-routed import** - the mesh groups (``core/mesh_store.py``)
  drain staged import chunks as per-shard stacks (:func:`route_stack`);
- **the mesh tiered store** - ``fleet/mesh_tiered.py``, the packed pool
  over the mesh's series blocks (``mesh_enabled`` with ``digest_storage:
  tiered``), placed by :class:`~veneur_tpu_torch.fleet.router.PoolPlacement`;
- **elastic resharding** - ``fleet/handoff.py``: on a change of the
  global fleet's membership (:class:`~veneur_tpu_torch.fleet.router.
  RingTransition`) the moved key ranges stream to their new owner;
- **global HA** - ``fleet/standby.py``: warm-standby replication of each
  flush and promotion on a leased failover (``discovery/lease.py``).
"""

from __future__ import annotations

import logging

from veneur_tpu_torch.fleet.router import (PoolPlacement, RingTransition,
                                           ShardPlacement, ShardRouter,
                                           inverse_perm, ring_key,
                                           route_stack)

log = logging.getLogger("veneur.fleet")

__all__ = ["RingTransition", "ShardRouter", "ShardPlacement",
           "PoolPlacement", "ring_key", "route_stack",
           "inverse_perm", "build_mesh", "fleet_snapshot",
           "sum_shard_occupancy", "balance_ratio"]


def sum_shard_occupancy(groups) -> "list | None":
    """Per-shard resident-row totals summed over placed groups (None
    when nothing is placed): the one aggregate behind the store's
    swap-time stamp and :func:`fleet_snapshot`."""
    occ = None
    for g in groups:
        placement = getattr(g, "placement", None)
        if placement is None:
            continue
        per = placement.occupancy()["per_shard"]
        occ = list(per) if occ is None else [a + b
                                             for a, b in zip(occ, per)]
    return occ


def balance_ratio(occ) -> float:
    """max/mean shard fill: 1.0 = perfectly balanced, S = everything on
    one shard."""
    total = sum(occ)
    return round(max(occ) / (total / len(occ)), 4) if total else 1.0


def build_mesh(config, devices=None):
    """The fleet mesh a global instance shards its store over: every
    visible CUDA device unless ``devices`` names them, ``mesh_hosts``
    wide on the fan-in axis (default 2 when the device count is even).
    On one card this is the 1 x 1 mesh, as the JAX package's on one
    chip; a wider mesh on one card comes from a device list that
    repeats it (``Server(..., mesh=...)``)."""
    from veneur_tpu_torch.parallel.mesh import fleet_mesh, visible_devices

    devices = list(devices) if devices is not None else visible_devices()
    n = len(devices)
    hosts = config.mesh_hosts or (2 if n % 2 == 0 else 1)
    mesh = fleet_mesh(devices, hosts=hosts)
    log.info("global store sharded over a %s mesh on %s",
             dict(mesh.shape), mesh.device)
    return mesh


def fleet_snapshot(store) -> dict:
    """The mesh section of a store's state: axes, per-group per-shard
    row occupancy and the balance ratio (max/mean shard fill; 1.0 is
    perfectly balanced). Empty for a store without a mesh."""
    mesh = getattr(store, "mesh", None)
    if mesh is None:
        return {}
    out = {"axes": {k: int(v) for k, v in dict(mesh.shape).items()},
           "devices": int(mesh.size), "groups": {}}
    names = getattr(store, "_GEN_GROUPS", ())
    groups = [getattr(store, name, None) for name in names]
    for name, g in zip(names, groups):
        placement = getattr(g, "placement", None)
        if placement is not None:
            out["groups"][name] = placement.occupancy()
    occ_total = sum_shard_occupancy(groups)
    if occ_total:
        out["shard_occupancy"] = occ_total
        out["balance_ratio"] = balance_ratio(occ_total)
    return out
