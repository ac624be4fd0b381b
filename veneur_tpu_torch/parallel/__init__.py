"""The fleet mesh and the global-aggregation collectives.

Port of ``veneur_tpu/parallel/``: the reference scales its global tier
with a consistent-hash proxy fanning imports out over worker shards
(``proxy.go:437-505``, ``importsrv/server.go:101-132``), and the JAX
package re-expresses the two axes as a device mesh. Here a
:class:`~veneur_tpu_torch.parallel.mesh.ShardMesh` holds the
``(series, hosts)`` shape on one torch device:

* ``series`` - data parallelism over metric series: each shard owns a
  contiguous block of rows of one device plane (``Workers[digest % N]``,
  ``server.go:704``);
* ``hosts`` - the hierarchical-aggregation axis (the local -> global
  fan-in, ``flusher.go:292-473``): per-host contributions are a leading
  dimension, reduced by sums for counters and t-digest bins, a max for
  HLL registers, and a butterfly of K2 merges for compressed centroids.
"""

from veneur_tpu_torch.parallel.collectives import (allmerge_digest,
                                                   merge_counters,
                                                   merge_registers,
                                                   merge_temp)
from veneur_tpu_torch.parallel.global_agg import GlobalAggregator
from veneur_tpu_torch.parallel.mesh import ShardMesh, fleet_mesh

__all__ = [
    "ShardMesh",
    "fleet_mesh",
    "merge_counters",
    "merge_registers",
    "merge_temp",
    "allmerge_digest",
    "GlobalAggregator",
]
