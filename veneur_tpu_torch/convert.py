"""Carry sketch state across from the JAX package.

The JAX package's device state, fetched to the host as numpy arrays
(``jax.device_get``), becomes the port's tensors: the t-digest planes,
the temp bin planes, the HLL registers and the count-min sketch.
:func:`load_digest_group`, :func:`load_set_group` and
:func:`load_heavy_hitter_group` fill a port group from a JAX group's
planes plus its interner order, and :func:`load_scalar_group` a counter,
gauge or status group from its values (a status group also from its
messages and hostnames), so an interval in flight on one package can
flush on the other: the counterpart of loading weights for this
system.

Nothing here imports the JAX package: callers hand over plain arrays and
(name, type, tags) triples.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from veneur_tpu_torch.device import resolve_device
from veneur_tpu_torch.ops import countmin as cm_ops
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


def load_scalar_group(group, values: np.ndarray, series: Iterable[Series],
                      messages: Optional[Sequence[str]] = None,
                      hostnames: Optional[Sequence[str]] = None) -> None:
    """Fill an empty port ``ScalarGroup`` (counter, gauge or status) from
    a JAX ScalarGroup's values in its row order, plus ``series`` in that
    order; a status group also takes the rows' messages and hostnames,
    and only a status group does."""
    if len(group):
        raise ValueError("load_scalar_group needs an empty group")
    status = group.kind == "status"
    if (messages is not None, hostnames is not None) != (status, status):
        raise ValueError("messages and hostnames go with a status group, "
                         "and only with one")
    n = _intern_all(group, series)
    group.ensure_capacity(max(n - 1, 0))
    group.values[:n] = np.asarray(values)[:n].astype(group.values.dtype)
    if status:
        group.messages[:] = [str(m) for m in messages[:n]]
        group.hostnames[:] = [str(h) for h in hostnames[:n]]


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


COUNTMIN_PLANES = ("table", "topk_hi", "topk_lo", "topk_counts", "sids")


def _words(a, device) -> torch.Tensor:
    """uint32 words as the port's int32 bit patterns."""
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32)).to(device)


def countmin_from_numpy(planes: Mapping[str, np.ndarray],
                        device=None) -> cm_ops.CountMin:
    """CountMin from the table, topk_hi/lo, topk_counts and sids arrays
    of a JAX CountMin (uint32 halves and sids, float32 table and
    counts)."""
    dev = resolve_device(device)
    return cm_ops.CountMin(
        table=_f32(planes["table"], dev),
        topk_hi=_words(planes["topk_hi"], dev),
        topk_lo=_words(planes["topk_lo"], dev),
        topk_counts=_f32(planes["topk_counts"], dev),
        sids=_words(planes["sids"], dev))


def load_heavy_hitter_group(group, planes: Mapping[str, np.ndarray],
                            series: Iterable[Tuple[str, Sequence[str]]],
                            sids: np.ndarray,
                            members: Mapping[int, str]) -> None:
    """Fill an empty port ``HeavyHitterGroup`` from a JAX
    HeavyHitterGroup: its sketch's five arrays (``COUNTMIN_PLANES``, the
    top-k planes in its row order), its (name, tags) series in that
    order, its host sid array (``_sids_np``) and its member memo."""
    if len(group):
        raise ValueError("load_heavy_hitter_group needs an empty group")
    table = np.asarray(planes["table"])
    if table.shape != (group.depth, group.width):
        raise ValueError(f"count-min shape {table.shape} != the group's "
                         f"({group.depth}, {group.width})")
    if np.asarray(planes["topk_counts"]).shape[1] != group.k:
        raise ValueError("top-k size differs from the group's")
    n = _intern_all(group, ((name, "set", tags) for name, tags in series))
    group.ensure_capacity(max(n - 1, 0))
    sk = countmin_from_numpy({p: (np.asarray(planes[p]) if p == "table"
                                  else np.asarray(planes[p])[:n])
                              for p in COUNTMIN_PLANES}, group.device)
    group.sketch.table.copy_(sk.table)
    for name in COUNTMIN_PLANES[1:]:
        getattr(group.sketch, name)[:n] = getattr(sk, name)
    group._sids_np[:n] = np.asarray(sids, np.uint32)[:n]
    group._members.update(members)
    group._device_dirty = True
