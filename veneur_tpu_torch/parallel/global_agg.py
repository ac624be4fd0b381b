"""The sharded global-aggregator interval step.

Port of ``veneur_tpu/parallel/global_agg.py``: N forwarding hosts
deliver sketch contributions each interval, and the global tier merges
them and emits fleet-wide percentiles, cardinalities and totals
(``importsrv/server.go:101-132`` + ``flusher.go:26-132``, behavior).

Layout (``parallel/mesh.py``): series are the contiguous row blocks of
one device plane, a block a series shard; a :class:`HostBatch`'s leading
dimension is the total host count, split over the mesh's hosts axis.
Each host slice bins into a fresh temp, the collectives of
``parallel/collectives.py`` complete the merge (psum the bins and the
counters, pmax the registers), and one K2 drain folds the merged bins
into the digests. No row crosses a shard: every program is row-local,
so a program over the whole plane is the per-shard program of each
block at once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from veneur_tpu_torch.ops import hll as hll_ops
from veneur_tpu_torch.ops import tdigest as td_ops
from veneur_tpu_torch.ops.tdigest import TDigest
from veneur_tpu_torch.parallel import collectives
from veneur_tpu_torch.parallel.mesh import ShardMesh

# registers a cardinality estimate pass reads: its float temporaries
# stay near 1 GiB at any series count
_ESTIMATE_REGISTERS = 1 << 28


class AggState(NamedTuple):
    """Device-resident global-tier state over the series axis."""

    digest: TDigest          # [S, K] histogram/timer sketch state
    registers: torch.Tensor  # [S, m] HLL registers (int8, as the store's)
    counters: torch.Tensor   # [S] int64 totals


class HostBatch(NamedTuple):
    """One interval's per-host contributions, leading dim the total host
    count H. Flat padded chunks; padding rows equal ``num_series`` (they
    drop in the scatter)."""

    h_rows: torch.Tensor     # [H, N] histogram sample rows
    h_vals: torch.Tensor     # [H, N] float32 values
    h_wts: torch.Tensor      # [H, N] float32 weights (0 = padding)
    s_rows: torch.Tensor     # [H, M] set rows
    s_hi: torch.Tensor       # [H, M] member-hash high halves
    s_lo: torch.Tensor       # [H, M] low halves
    c_rows: torch.Tensor     # [H, C] counter rows
    c_incs: torch.Tensor     # [H, C] increments (0 = padding)


class GlobalAggregator:
    """Runs the sharded interval step on a :class:`ShardMesh`."""

    def __init__(self, mesh: ShardMesh, num_series: int,
                 compression: float = td_ops.DEFAULT_COMPRESSION,
                 precision: int = hll_ops.DEFAULT_PRECISION):
        self.mesh = mesh
        self.series_devices = mesh.series
        self.hosts = mesh.hosts
        if num_series % self.series_devices != 0:
            raise ValueError(
                f"num_series={num_series} must divide over "
                f"{self.series_devices} series shards")
        self.num_series = num_series
        self.compression = compression
        self.precision = precision
        self.k = td_ops.size_bound(compression)
        self.m = hll_ops.num_registers(precision)

    # -- state construction -------------------------------------------------

    def init_state(self) -> AggState:
        s, dev = self.num_series, self.mesh.device
        return AggState(
            digest=td_ops.init((s,), self.compression, self.k, device=dev),
            registers=torch.zeros((s, self.m), dtype=torch.int8,
                                  device=dev),
            counters=torch.zeros(s, dtype=torch.int64, device=dev))

    def shard_batch(self, batch) -> HostBatch:
        """A host-side batch (numpy, :func:`make_host_batch`) on the
        mesh's device: rows int64, hash halves as their int32 bit
        patterns, increments int64."""
        dev = self.mesh.device

        def put(a, dtype):
            a = np.asarray(a)
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                dev, dtype=dtype)

        b = HostBatch(*batch)
        return HostBatch(
            h_rows=put(b.h_rows, torch.int64),
            h_vals=put(b.h_vals, torch.float32),
            h_wts=put(b.h_wts, torch.float32),
            s_rows=put(b.s_rows, torch.int64),
            s_hi=put(b.s_hi, torch.int32), s_lo=put(b.s_lo, torch.int32),
            c_rows=put(b.c_rows, torch.int64),
            c_incs=put(b.c_incs, torch.int64))

    def _host_slices(self, x: torch.Tensor) -> list:
        """A ``[H, N]`` batch field as the mesh's hosts-axis slices, each
        flat: host group j holds batch rows j*H/hosts .. (j+1)*H/hosts."""
        h = x.shape[0]
        if h % self.hosts:
            raise ValueError(f"{h} hosts in the batch do not divide over "
                             f"the mesh's {self.hosts}")
        return list(x.reshape(self.hosts, -1).unbind(0))

    def _in_range(self, rows: torch.Tensor) -> torch.Tensor:
        """Rows outside [0, S) become the padding row S."""
        s = self.num_series
        return torch.where((rows >= 0) & (rows < s), rows, s)

    def _estimates(self, registers: torch.Tensor) -> torch.Tensor:
        """Cardinality estimates a block of rows at a time (the
        estimator's float temporaries are [rows, m])."""
        step = max(1, _ESTIMATE_REGISTERS // self.m)
        return torch.cat([hll_ops.estimate(registers[i:i + step],
                                           self.precision)
                          for i in range(0, registers.shape[0], step)])

    # -- the interval step --------------------------------------------------

    def step(self, state: AggState, batch: HostBatch, qs):
        """Run one interval: returns (new_state, percentiles [S, P], set
        estimates [S], counter totals [S]). The registers update in
        place; the caller rebinds ``state`` to the returned one, as with
        the JAX package's donated step."""
        s = self.num_series
        dev = self.mesh.device
        rows = [self._in_range(r) for r in self._host_slices(batch.h_rows)]

        # t-digest: each host slice bins into a fresh temp, the bins
        # psum over hosts, one K2 drain folds them into the digests
        temp = td_ops.init_temp(s, self.k, self.compression, device=dev)
        collectives.bin_host_slices(
            temp, list(zip(rows, self._host_slices(batch.h_vals),
                           self._host_slices(batch.h_wts))),
            self.compression)
        digest = td_ops.drain_temp(state.digest, temp, self.compression)
        pcts = td_ops.quantile(digest, torch.as_tensor(
            qs, dtype=torch.float32, device=dev))

        # HLL: a scatter-max a host slice; the pmax over hosts is the
        # scatter's own max
        registers = state.registers
        for r, hi, lo in zip(self._host_slices(batch.s_rows),
                             self._host_slices(batch.s_hi),
                             self._host_slices(batch.s_lo)):
            r = self._in_range(r)
            hll_ops.insert(registers, r, hi, lo, mask=r < s,
                           precision=self.precision)
        estimates = self._estimates(registers)

        # counters: a scatter-add a host slice, psum over hosts
        contrib = torch.zeros((self.hosts, s + 1), dtype=torch.int64,
                              device=dev)
        for j, (r, inc) in enumerate(zip(self._host_slices(batch.c_rows),
                                         self._host_slices(batch.c_incs))):
            contrib[j].index_add_(0, self._in_range(r), inc.long())
        counters = state.counters + collectives.merge_counters(
            contrib[:, :s])

        new_state = AggState(digest=digest, registers=registers,
                             counters=counters)
        return new_state, pcts, estimates, counters

    def merge_forwarded_digests(self, mean, weight, mins, maxs) -> TDigest:
        """All-reduce pre-compressed per-host digests over the hosts axis:
        the collective form of importing already-flushed centroid state
        (Histo.Merge, samplers.go:676-691). Inputs ``[H, S, K]`` /
        ``[H, S]`` with H the mesh's hosts, each row ascending; returns
        the merged ``[S, K]`` digest (the butterfly: log2(H) rounds of
        K2)."""
        dev = self.mesh.device

        def put(a):
            return torch.as_tensor(a, dtype=torch.float32, device=dev)

        d = TDigest(put(mean), put(weight), put(mins), put(maxs))
        if d.mean.shape[0] != self.hosts:
            raise ValueError(f"{d.mean.shape[0]} host digests for a mesh of "
                             f"{self.hosts} hosts")
        return collectives.allmerge_digest(d, self.compression)


def make_host_batch(num_hosts: int, num_series: int, n: int = 64,
                    m: int = 64, c: int = 64, seed: int = 0) -> HostBatch:
    """Synthetic per-host contributions for tests and the smoke run
    (host-side numpy; the same draws as the JAX package's)."""
    rng = np.random.default_rng(seed)
    return HostBatch(
        h_rows=rng.integers(0, num_series, (num_hosts, n)).astype(np.int32),
        h_vals=rng.normal(100.0, 25.0, (num_hosts, n)).astype(np.float32),
        h_wts=np.ones((num_hosts, n), np.float32),
        s_rows=rng.integers(0, num_series, (num_hosts, m)).astype(np.int32),
        s_hi=rng.integers(0, 1 << 32, (num_hosts, m), dtype=np.uint64
                          ).astype(np.uint32),
        s_lo=rng.integers(0, 1 << 32, (num_hosts, m), dtype=np.uint64
                          ).astype(np.uint32),
        c_rows=rng.integers(0, num_series, (num_hosts, c)).astype(np.int32),
        c_incs=rng.integers(1, 10, (num_hosts, c)).astype(np.int32),
    )
