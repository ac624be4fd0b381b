"""Multi-core UDP ingest: lock-free per-reader lanes, merged at the group
boundary (port of ``veneur_tpu/ingest/``).

The reference scales ingest with SO_REUSEPORT per-core readers
(``socket_linux.go:12-76``) feeding hash-partitioned workers that share
nothing on the hot path (``worker.go:54-91``). Here each reader thread
owns a **lane**: its SO_REUSEPORT socket, a reusable recv buffer drained
with ``recvmmsg`` where the platform has it, a reusable native parse
batch (``veneur_tpu_torch.native`` releases the GIL during the parse), a
lane-local intern table, lane-local columnar staging per metric kind,
and lane-local counters: no shared lock and no shared dict write per
packet.

Lanes hand off at the **group boundary only**: a full (or idle-sealed)
staging chunk goes onto a per-lane deque, and the fleet's merger thread
folds sealed chunks into the store under ONE store-lock hold per chunk
(``MetricStore.import_lane_chunk``), remapping lane-local intern rows
onto the store's interners through a flush-epoch-aware resolver. This is
the server's default UDP statsd listener (``ingest_lanes: 0``).
"""

from veneur_tpu_torch.ingest.counters import LaneLedger, ShardedCounter
from veneur_tpu_torch.ingest.lanes import (DRAIN_TICK, IngestFleet,
                                           IngestLane, SealedChunk)
from veneur_tpu_torch.ingest.recvmmsg import (BatchReceiver, BatchSender,
                                              recvmmsg_available)

__all__ = [
    "BatchReceiver",
    "BatchSender",
    "DRAIN_TICK",
    "IngestFleet",
    "IngestLane",
    "LaneLedger",
    "SealedChunk",
    "ShardedCounter",
    "recvmmsg_available",
]
