"""Carry sketch state across from the JAX package.

The JAX package's device state, fetched to the host as numpy arrays
(``jax.device_get``), becomes the port's tensors: the t-digest planes,
the temp bin planes and the HLL registers. :func:`load_digest_group` and
:func:`load_set_group` fill a port group from a JAX group's planes plus
its interner order, so an interval in flight on one package can flush on
the other: the counterpart of loading weights for this system.

Nothing here imports the JAX package: callers hand over plain arrays and
(name, type, tags) triples.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence, Tuple

import numpy as np
import torch

from veneur_tpu_torch.device import resolve_device
from veneur_tpu_torch.ops import tdigest as td_ops
from veneur_tpu_torch.samplers.parser import MetricKey

DIGEST_PLANES = ("mean", "weight", "min", "max")
TEMP_PLANES = td_ops.TempCentroids._fields
Series = Tuple[str, str, Sequence[str]]  # (name, type, tags) in row order


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def digest_from_numpy(planes: Mapping[str, np.ndarray],
                      device=None) -> td_ops.TDigest:
    """TDigest from the mean/weight/min/max arrays of a JAX TDigest."""
    dev = resolve_device(device)
    return td_ops.TDigest(*(_f32(planes[k], dev) for k in DIGEST_PLANES))


def temp_from_numpy(planes: Mapping[str, np.ndarray],
                    device=None) -> td_ops.TempCentroids:
    """TempCentroids from the nine arrays of a JAX TempCentroids
    (sum_w, sum_wm, seg_w, seg_wm, count, vsum, vmin, vmax, recip)."""
    dev = resolve_device(device)
    return td_ops.TempCentroids(*(_f32(planes[k], dev) for k in TEMP_PLANES))


def registers_from_numpy(registers: np.ndarray, device=None) -> torch.Tensor:
    """HLL registers as the store's int8 [S, 2^p] plane (values <= 64-p+1)."""
    regs = np.asarray(registers)
    if regs.size and (regs.min() < 0 or regs.max() > 127):
        raise ValueError("HLL register values outside [0, 127]")
    return torch.from_numpy(np.array(regs, np.int8)).to(
        resolve_device(device))


def _intern_all(group, series: Iterable[Series]) -> int:
    n = 0
    for row, (name, mtype, tags) in enumerate(series):
        tags = list(tags)
        key = MetricKey(name=name, type=mtype, joined_tags=",".join(tags))
        if group.interner.intern(key, tags) != row:
            raise ValueError(f"series {key} repeats or the group is not "
                             "empty")
        n = row + 1
    return n


def load_digest_group(group, planes: Mapping[str, np.ndarray],
                      series: Iterable[Series]) -> None:
    """Fill an empty port ``DigestGroup`` from a JAX DigestGroup's fetched
    planes: its digest (mean/weight/min/max), temp (the nine
    TempCentroids fields) and import extrema (dmin/dmax), each with the
    JAX group's row order, plus ``series`` in that order."""
    if len(group):
        raise ValueError("load_digest_group needs an empty group")
    n = _intern_all(group, series)
    group.ensure_capacity(max(n - 1, 0))
    k = np.asarray(planes["mean"]).shape[1]
    if k != group.k:
        raise ValueError(f"digest width {k} != the group's {group.k} "
                         "(compression differs)")
    dev = group.device
    digest = digest_from_numpy({p: np.asarray(planes[p])[:n]
                                for p in DIGEST_PLANES}, dev)
    temp = temp_from_numpy({p: np.asarray(planes[p])[:n]
                            for p in TEMP_PLANES}, dev)
    for dst, src in zip(group.digest, digest):
        dst[:n] = src
    for dst, src in zip(group.temp, temp):
        dst[:n] = src
    group.dmin[:n] = _f32(np.asarray(planes["dmin"])[:n], dev)
    group.dmax[:n] = _f32(np.asarray(planes["dmax"])[:n], dev)
    group._device_dirty = True


def load_set_group(group, registers: np.ndarray,
                   series: Iterable[Series]) -> None:
    """Fill an empty port ``SetGroup`` from a JAX SetGroup's fetched
    registers (row order of its interner) plus ``series`` in that order."""
    if len(group):
        raise ValueError("load_set_group needs an empty group")
    n = _intern_all(group, series)
    regs = np.asarray(registers)[:n]
    if regs.shape[1] != group.m:
        raise ValueError(f"{regs.shape[1]} registers per row != the "
                         f"group's {group.m} (precision differs)")
    group.ensure_capacity(max(n - 1, 0))
    group.registers[:n] = registers_from_numpy(regs, group.device)
    group._device_dirty = True
