"""The fleet mesh's two axes, hosts (fan-in) x series (shard), on one card.

Port of ``veneur_tpu/parallel/mesh.py``. The JAX package builds a 2-D
``(series, hosts)`` ``jax.sharding.Mesh`` over n devices and runs one
SPMD program over it. torch has no single-process SPMD, so a
:class:`ShardMesh` keeps the shape and ONE torch device, and the groups
lay the axes out on that device:

- **series** - every shard owns a contiguous block of rows of one device
  plane, the JAX package's physical layout (shard ``d`` of ``S`` owns
  rows ``[d*cap/S, (d+1)*cap/S)``); a program over the whole plane is a
  program a shard, since every t-digest and HLL program is row-local;
- **hosts** - a staged chunk splits into ``[H, chunk/H]`` host slices,
  each binned on its own, and the collectives of
  ``parallel/collectives.py`` reduce over that leading dimension (psum a
  sum, pmax/pmin an amax/amin, the ppermute butterfly paired merges).

A device list that repeats one device builds a wider mesh on that
device: ``fleet_mesh([dev] * 8, hosts=2)`` is the 4 x 2 mesh the JAX
tests get from ``--xla_force_host_platform_device_count=8``. A list
naming more than one distinct device raises :class:`UnsupportedConfig`:
placing shards on several cards (over NCCL) is not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from veneur_tpu_torch.config import UnsupportedConfig
from veneur_tpu_torch.device import resolve_device

HOSTS_AXIS = "hosts"
SERIES_AXIS = "series"


def _largest_pow2_divisor(n: int, cap: int) -> int:
    d = 1
    while d * 2 <= cap and n % (d * 2) == 0:
        d *= 2
    return d


class ShardMesh:
    """A ``(series, hosts)`` mesh on one torch device. ``shape`` maps
    each axis name to its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, series: int, hosts: int, device):
        if series < 1 or hosts < 1:
            raise ValueError(f"mesh axes must be >= 1, got series={series}, "
                             f"hosts={hosts}")
        self.series = series
        self.hosts = hosts
        self.device = torch.device(device)

    @property
    def shape(self) -> dict:
        return {SERIES_AXIS: self.series, HOSTS_AXIS: self.hosts}

    @property
    def size(self) -> int:
        return self.series * self.hosts

    def __repr__(self) -> str:
        return (f"ShardMesh(series={self.series}, hosts={self.hosts}, "
                f"device={self.device})")


def _canonical(device) -> torch.device:
    """A device with its index made explicit (``cuda`` is the current
    card), so repeats of one card compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices() -> list:
    """Every visible CUDA device; raises without one (the port never
    falls back to the CPU unless the caller names it)."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def fleet_mesh(devices: Optional[Sequence] = None,
               hosts: Optional[int] = None) -> ShardMesh:
    """Build a 2-D ``(series, hosts)`` mesh over ``devices`` (default:
    every visible CUDA device). ``hosts`` defaults to the largest
    power-of-two divisor of the device count; the series axis takes the
    rest. All devices must be one device, repeated or not."""
    if devices is None:
        devices = visible_devices()
    devices = [_canonical(d) for d in devices]
    n = len(devices)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if hosts is None:
        hosts = _largest_pow2_divisor(n, n)
    if hosts < 1 or n % hosts != 0:
        raise ValueError(f"{n} devices not divisible by hosts={hosts}")
    distinct = sorted({str(d) for d in devices})
    if len(distinct) > 1:
        raise UnsupportedConfig(
            f"a mesh over {len(distinct)} distinct devices ({distinct}) "
            "needs multi-card shard placement, which veneur_tpu_torch does "
            "not implement yet; repeat one device to shape a mesh on it")
    return ShardMesh(n // hosts, hosts, devices[0])
