"""On-device packing of drained digest planes for the forward path.

Port of three functions of ``veneur_tpu/core/slab.py``: ``_pack_slab``
(:289), ``_gather_pack`` (:363) and ``_fetch_packed`` (:379). A local
that forwards at fleet cardinality compacts and quantizes its drained
``[S, K]`` planes on the device and fetches only the live centroids, 4
bytes each (a u16 range-quantized mean and a bfloat16 weight), instead
of the raw float32 planes (8 bytes a slot, live or not). The JAX
versions are XLA, not Pallas, so these are plain PyTorch on the card.

The card has few ops on ``torch.uint16``, so 16-bit patterns travel as
``int16`` on the device and are viewed as ``uint16`` only on the host;
the live counts travel as ``int32``. The slab group itself
(``SlabDigestGroup``) is not ported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from veneur_tpu_torch.core.bucketing import pow2_cap


def _to_u16_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 values in [0, 65535] -> int16 tensors holding the same 16
    bits (an explicit wrap: narrowing casts are not relied on)."""
    return torch.where(x >= 32768, x - 65536, x).to(torch.int16)


def _pack_slab(mean: torch.Tensor, weight: torch.Tensor, dmin: torch.Tensor,
               dmax: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact and quantize drained digest planes on the device.

    mean/weight: [S, K] (float32 math whatever their type); dmin/dmax:
    [S] float32. Means quantize to u16 against the row's [dmin, dmax]
    span (absolute error <= span/65535, far inside the t-digest's 0.02
    envelope); weights round to bfloat16 (round to nearest even, as
    XLA's convert; exact counts ride the float32 stats). Each row's live
    slots (weight > 0) then move to its prefix, in slot order.

    Returns (counts int32 [S], q_pref int16 [S, K], wb_pref int16 [S,
    K]): row r's live centroids are ``q_pref[r, :counts[r]]``. Slots past
    a row's count hold 0."""
    m = mean.float()
    w = weight.float()
    live = w > 0
    counts = live.sum(dim=1, dtype=torch.int32)
    span = dmax - dmin
    # a true division: a Python number over a tensor (65535.0 / span)
    # multiplies by the reciprocal in torch, one rounding more than
    # XLA's divide, which moves a q by 1 where the product nears .5
    scale = torch.where(span > 0, torch.full_like(span, 65535.0) / span,
                        torch.zeros_like(span))
    q = torch.clamp(torch.round((m - dmin[:, None]) * scale[:, None]),
                    0.0, 65535.0)
    # a dead slot or an empty row can make (m - dmin) * scale NaN (inf *
    # 0), whose integer cast differs between the CPU, CUDA and XLA: zero
    # it first (only live prefixes are ever fetched)
    q = torch.where(live, q, torch.zeros_like(q)).to(torch.int32)
    wb = w.to(torch.bfloat16).view(torch.int16)
    # the stable live-first partition of JAX's sort on a unique key,
    # as a scatter: a live slot goes to its rank among the live, a dead
    # one after every live slot
    live_i = live.to(torch.int64)
    rank_live = torch.cumsum(live_i, dim=1) - 1
    rank_dead = torch.cumsum(1 - live_i, dim=1) - 1
    pos = torch.where(live, rank_live, counts[:, None].long() + rank_dead)
    q_pref = torch.zeros_like(q, dtype=torch.int16).scatter_(
        1, pos, _to_u16_bits(q))
    wb_pref = torch.zeros_like(wb).scatter_(
        1, pos, torch.where(live, wb, torch.zeros_like(wb)))
    return counts, q_pref, wb_pref


def _slice_pack(q_pref: torch.Tensor, wb_pref: torch.Tensor, rows: int,
                width: int):
    return (q_pref[:rows, :width].contiguous(),
            wb_pref[:rows, :width].contiguous())


def _gather_pack(counts: torch.Tensor, q_pref: torch.Tensor,
                 wb_pref: torch.Tensor, P: int) -> torch.Tensor:
    """Flat-compact the prefix planes on the device: output position i
    maps to (row by a search over the count prefix sum, rank within the
    row). One int32 gather of ``q << 16 | wb`` instead of two int16
    ones; returns the [P] bit patterns."""
    slab, k = q_pref.shape
    c = counts.long()
    cum = torch.cumsum(c, 0)
    i = torch.arange(P, dtype=torch.int64, device=q_pref.device)
    row = torch.clamp(torch.searchsorted(cum, i, right=True), 0, slab - 1)
    j = torch.clamp(i - (cum - c)[row], 0, k - 1)
    packed = ((q_pref.to(torch.int32) & 0xFFFF) << 16) \
        | (wb_pref.to(torch.int32) & 0xFFFF)
    return packed.reshape(-1)[row * k + j]


def _fetch_packed(counts_dev: torch.Tensor, q_pref: torch.Tensor,
                  wb_pref: torch.Tensor, need: int):
    """Host side of the packed fetch: the counts first (small), then the
    cheaper of two transfers of the live bytes:

    * uniform rows: a ``[:pow2(need), :pow2(max count)]`` slice of the
      prefix planes, flattened on the host;
    * skewed rows (one heavy row would widen that slice): the flat
      device compaction :func:`_gather_pack`, sized pow2(total).

    The power-of-two sizes are the JAX package's (there they bound the
    compiled variants), so both packages pick the same strategy and move
    the same bytes. Returns (counts u16 [need], means_q u16 [L],
    weights_bf u16 [L]) as numpy."""
    counts = counts_dev[:need].cpu().numpy().astype(np.uint16)
    total = int(counts.astype(np.int64).sum())
    if total == 0:
        empty = np.empty(0, np.uint16)
        return counts, empty, empty
    slab, k = q_pref.shape
    width = min(pow2_cap(int(counts.max())), k)
    rows = min(pow2_cap(need), slab)
    P = pow2_cap(total)
    if rows * width <= 3 * P:
        qs, wbs = (t.cpu().numpy().view(np.uint16)[:need]
                   for t in _slice_pack(q_pref, wb_pref, rows, width))
        mask = (np.arange(width, dtype=np.int32)[None, :]
                < counts[:, None].astype(np.int32))
        return counts, qs[mask], wbs[mask]
    packed = _gather_pack(counts_dev, q_pref, wb_pref, P)[:total]
    packed = packed.cpu().numpy().view(np.uint32)
    return (counts, (packed >> 16).astype(np.uint16),
            (packed & 0xFFFF).astype(np.uint16))
