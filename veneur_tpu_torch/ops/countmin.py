"""Batched count-min sketch + top-k heavy hitters as torch tensor ops.

Port of ``veneur_tpu/ops/countmin.py`` (plain XLA there, no Pallas
kernel, so plain PyTorch here):

- ONE shared ``[depth, width]`` float32 table serves every series: the
  per-row hash mixes the series' stable id in as a salt. Updates are
  scatter-adds; estimates are a min over ``depth`` gathered cells.
- the top-k list is per series, ``[S, K]`` id/count planes. Each drain
  concatenates (current top-k ++ batch candidates), deduplicates by id
  with a sort and a segment-head mask, and keeps the K largest counts.
- keys are 64-bit member hashes carried as (hi, lo) 32-bit halves, the
  HLL member hash of ``ops/hll.py``.

torch has no uint32 multiply or modulo on every backend, so 32-bit
words ride in int64 in [0, 2^32) and every multiply is split into
16-bit halves that never overflow int64. The planes store the halves as
int32 bit patterns (4 bytes a slot, as the JAX package's uint32). Where
the JAX version donates its state, these functions update the sketch's
tensors in place and return the sketch.

Bit for bit with the JAX package where XLA's order is defined: a scatter
of colliding candidates keeps the LAST one in batch order (XLA on the
CPU applies the updates in order), and the top-k keeps the lower index
on ties (``lax.top_k``), here a stable descending sort. The table sums
are exact while each cell's mass is an integer below 2^24.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from veneur_tpu_torch.device import resolve_device

DEFAULT_DEPTH = 4
DEFAULT_WIDTH = 1 << 16
DEFAULT_TOPK = 32

# distinct odd constants per hash row (splitmix64-derived)
_ROW_SALTS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F,
              0x165667B1, 0xD3A2646C, 0xFD7046C5, 0xB55A4F09)
_M32 = 0xFFFFFFFF


@dataclass
class CountMin:
    """table: [depth, width] float32 shared across series.
    topk_hi/lo: [S, K] int32 bit patterns of the key halves (0/0 = an
    empty slot). topk_counts: [S, K] float32 estimated counts (0 =
    empty). sids: [S] int32 bit patterns of the stable series ids (a
    hash of name+type+tags): table columns are salted with these, never
    with the local row, so tables forwarded between instances align."""

    table: torch.Tensor
    topk_hi: torch.Tensor
    topk_lo: torch.Tensor
    topk_counts: torch.Tensor
    sids: torch.Tensor

    @property
    def depth(self) -> int:
        return self.table.shape[0]

    @property
    def width(self) -> int:
        return self.table.shape[1]


def init(num_series: int = 1, depth: int = DEFAULT_DEPTH,
         width: int = DEFAULT_WIDTH, k: int = DEFAULT_TOPK,
         device=None) -> CountMin:
    assert depth <= len(_ROW_SALTS)
    dev = resolve_device(device)
    return CountMin(
        table=torch.zeros((depth, width), dtype=torch.float32, device=dev),
        topk_hi=torch.zeros((num_series, k), dtype=torch.int32, device=dev),
        topk_lo=torch.zeros((num_series, k), dtype=torch.int32, device=dev),
        topk_counts=torch.zeros((num_series, k), dtype=torch.float32,
                                device=dev),
        sids=torch.zeros((num_series,), dtype=torch.int32, device=dev))


def _u32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit word (int32 bit pattern or any integer) as int64 in
    [0, 2^32)."""
    return x.long() & _M32


def _bits32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> its int32 bit pattern."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): the multiply split at
    16 bits so no partial product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer over int64 words in [0, 2^32)."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _col_index(sids: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
               salt: int, width: int) -> torch.Tensor:
    """Table column for one depth row: mixes (stable series id, key
    hash, row salt). All three inputs are 32-bit words (int32 bit
    patterns or int64 in [0, 2^32))."""
    h = _mix32(_u32(hi) ^ salt)
    h = _mix32(h ^ _u32(lo))
    h = _mix32(h ^ _mul32(_u32(sids), 0x9E3779B1))
    return h % width


def _table_min(table: torch.Tensor, sids, hi, lo) -> torch.Tensor:
    """min over depth rows of the table cells (sid, key) hashes to."""
    est = None
    for d in range(table.shape[0]):
        idx = _col_index(sids, hi, lo, _ROW_SALTS[d], table.shape[1])
        v = table[d][idx]
        est = v if est is None else torch.minimum(est, v)
    return est


def _standing_counts(sk: CountMin, table: torch.Tensor) -> torch.Tensor:
    """Re-estimate every standing top-k entry against ``table``."""
    sids = sk.sids[:, None].expand(sk.topk_hi.shape)
    cur = _table_min(table, sids, sk.topk_hi, sk.topk_lo)
    return torch.where(sk.topk_counts > 0, cur, torch.zeros_like(cur))


def _scatter_last(s: int, ring: int, srows: torch.Tensor,
                  slot: torch.Tensor, values) -> list:
    """``zeros([s, ring]).at[srows, slot].set(v, mode="drop")`` for each
    of ``values``, with the LAST update in batch order winning where
    several hit one slot (XLA's order on the CPU), deterministically on
    every device: a stable sort of the flat targets, then one write per
    target. Rows outside [0, s) drop."""
    n = srows.shape[0]
    live = (srows >= 0) & (srows < s)
    flat = torch.where(live, srows * ring + slot, s * ring)
    fs, order = torch.sort(flat, stable=True)
    last = torch.ones(n, dtype=torch.bool, device=flat.device)
    if n > 1:
        last[:-1] = fs[1:] != fs[:-1]
    win = order[last & (fs < s * ring)]
    out = []
    for v in values:
        plane = torch.zeros(s * ring, dtype=v.dtype, device=v.device)
        plane[flat[win]] = v[win]
        out.append(plane.view(s, ring))
    return out


def update(sk: CountMin, rows: torch.Tensor, sids: torch.Tensor,
           hi: torch.Tensor, lo: torch.Tensor,
           counts: torch.Tensor) -> CountMin:
    """Fold one flat batch of (series row, stable sid, key hash, count)
    increments into the table (in place) and refresh each touched
    series' top-k.

    rows: [N] integer; sids, hi, lo: [N] 32-bit words; padding rows are
    out of range (``>= S``) with counts == 0 (their adds are zero and
    their candidates drop)."""
    depth, width = sk.depth, sk.width
    s, k = sk.topk_counts.shape
    rows = rows.long()
    counts = counts.float()
    # teach the sketch its rows' stable ids (a row's sid never changes,
    # so duplicate rows write the same value)
    ok = (rows >= 0) & (rows < s)
    sk.sids[rows[ok]] = _bits32(_u32(sids))[ok]
    table = sk.table
    idxs = []
    for d in range(depth):
        idx = _col_index(sids, hi, lo, _ROW_SALTS[d], width)
        idxs.append(idx)
        table[d].index_add_(0, idx, counts)
    # conservative estimate after the adds: min over depth rows
    est = table[0][idxs[0]]
    for d in range(1, depth):
        est = torch.minimum(est, table[d][idxs[d]])
    est = torch.where(counts > 0, est, torch.zeros_like(est))

    # refresh the standing entries from the table: their counts track
    # later increments even when the key loses its candidate slot
    cur_ct = _standing_counts(sk, table)

    # candidate ring: 4K slots a series this drain, salted with the
    # (growing) table mass so two keys colliding now land apart later;
    # float32 -> uint32 saturates as XLA's conversion does
    ring = 4 * k
    mass = table[0].sum().double().clamp(0.0, float(_M32)).long()
    rsalt = _mix32(mass)
    slot = _mix32(_u32(hi) ^ _u32(lo) ^ rsalt) % ring
    srows = torch.where(counts > 0, rows, s)
    cand_hi, cand_lo, cand_ct = _scatter_last(
        s, ring, srows, slot,
        (_bits32(_u32(hi)), _bits32(_u32(lo)), est))
    top = _dedupe_topk(torch.cat([sk.topk_hi, cand_hi], dim=1),
                       torch.cat([sk.topk_lo, cand_lo], dim=1),
                       torch.cat([cur_ct, cand_ct], dim=1), k)
    sk.topk_hi, sk.topk_lo, sk.topk_counts = top
    return sk


def _sort_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 key ordered as the unsigned (hi, lo) pair: hi shifted down
    by 2^31 so the signed order matches, without any overflow."""
    return (_u32(hi) - (1 << 31)) * (1 << 32) + _u32(lo)


def _dedupe_topk(all_hi, all_lo, all_ct, k: int):
    """Per-series candidate selection: sort by (hi, lo), keep each id's
    max count at its first occurrence, zero the duplicates and the empty
    slots, take the top k (lower index first on ties)."""
    key = _sort_key(all_hi, all_lo)
    skey, order = torch.sort(key, dim=-1)
    shi = torch.gather(all_hi, 1, order)
    slo = torch.gather(all_lo, 1, order)
    sct = torch.gather(all_ct, 1, order)
    same = torch.zeros_like(skey, dtype=torch.bool)
    same[:, 1:] = skey[:, 1:] == skey[:, :-1]
    # max count within each equal-id run, propagated left to the head
    run_max = _rev_seg_max(sct, same)
    zero = torch.zeros_like(sct)
    sct = torch.where(same, zero, run_max)
    sct = torch.where((shi == 0) & (slo == 0), zero, sct)  # empty slots
    top_ct, top_i = torch.sort(sct, dim=-1, descending=True, stable=True)
    top_ct, top_i = top_ct[:, :k], top_i[:, :k]
    top_hi = torch.gather(shi, 1, top_i)
    top_lo = torch.gather(slo, 1, top_i)
    live = top_ct > 0
    return (torch.where(live, top_hi, torch.zeros_like(top_hi)),
            torch.where(live, top_lo, torch.zeros_like(top_lo)),
            top_ct.contiguous())


def add_table(sk: CountMin, table: torch.Tensor) -> CountMin:
    """Merge another instance's count-min table (elementwise add, in
    place: columns align because both ends hash with stable sids), then
    re-estimate every standing top-k entry against the combined table."""
    sk.table += table.to(sk.table.device, torch.float32)
    sk.topk_counts = _standing_counts(sk, sk.table)
    return sk


def inject_candidates(sk: CountMin, rows: torch.Tensor, sids: torch.Tensor,
                      hi: torch.Tensor, lo: torch.Tensor,
                      slots: torch.Tensor) -> CountMin:
    """Offer forwarded top-k candidates (no count contribution: their
    mass arrived through add_table): estimate each against the current
    table and merge into the per-series top-k lists.

    rows: [N] with out-of-range = padding; (hi, lo) == (0, 0) is also
    padding. slots: [N], the candidate's index within its series'
    forwarded list (at most K entries), so the scatter needs no ring."""
    s, k = sk.topk_counts.shape
    rows = rows.long()
    inb = (rows >= 0) & (rows < s)
    live = inb & ((_u32(hi) != 0) | (_u32(lo) != 0))
    sk.sids[rows[inb]] = _bits32(_u32(sids))[inb]
    est = _table_min(sk.table, sids, hi, lo)
    est = torch.where(live, est, torch.zeros_like(est))
    srows = torch.where(live, rows, s)
    slot = torch.clamp_max(slots.long(), k - 1)
    cand_hi, cand_lo, cand_ct = _scatter_last(
        s, k, srows, slot, (_bits32(_u32(hi)), _bits32(_u32(lo)), est))
    top = _dedupe_topk(torch.cat([sk.topk_hi, cand_hi], dim=1),
                       torch.cat([sk.topk_lo, cand_lo], dim=1),
                       torch.cat([sk.topk_counts, cand_ct], dim=1), k)
    sk.topk_hi, sk.topk_lo, sk.topk_counts = top
    return sk


def _rev_seg_max(x: torch.Tensor, same: torch.Tensor) -> torch.Tensor:
    """Per segment (runs where ``same`` is True continue the previous
    element's segment), the max of the whole run written at every
    element, via a right-to-left log-step segmented scan.

    same[i] says element i belongs to i-1's segment; prop[i] tracks
    whether position i can absorb from i+1 (initially same[i+1]), and
    composes as prop'[i] = prop[i] & prop[i+d], so absorption never
    crosses a segment boundary."""
    def shl(a, d, fill):
        pad = torch.full(a.shape[:-1] + (d,), fill, dtype=a.dtype,
                         device=a.device)
        return torch.cat([a[:, d:], pad], dim=1)

    n = x.shape[-1]
    prop = shl(same, 1, False)
    val = x
    d = 1
    while d < n:
        val = torch.where(prop, torch.maximum(val, shl(val, d, 0.0)), val)
        prop = prop & shl(prop, d, False)
        d *= 2
    return val


def estimate(sk: CountMin, rows: torch.Tensor, hi: torch.Tensor,
             lo: torch.Tensor) -> torch.Tensor:
    """Point-query frequency estimates for (series row, key) pairs; rows
    resolve to stable sids through the sketch's sid plane."""
    sids = sk.sids[torch.clamp(rows.long(), 0, sk.sids.shape[0] - 1)]
    return _table_min(sk.table, sids, hi, lo)
