"""Batched dense HyperLogLog as torch tensor ops.

Port of ``veneur_tpu/ops/hll.py``: the state for S series is one dense
``[S, m]`` (``m = 2^p``) register tensor; insert is a scatter-max of
(row, register, rho) triples, merge an elementwise max, and estimate the
classic bias-corrected harmonic mean with linear-counting small-range
correction, all series at once. Registers match the JAX package bit for
bit.

torch has no uint32 shifts, modulo or max on the CPU and no count of
leading zeros, so the two 32-bit halves of each 64-bit member hash ride
in int64 masked with ``& 0xFFFFFFFF``, and clz is a bit-smear plus a
popcount.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from veneur_tpu_torch.device import resolve_device

DEFAULT_PRECISION = 14  # axiomhq New() default (hyperloglog.go:31-37)
_M32 = 0xFFFFFFFF


def num_registers(precision: int = DEFAULT_PRECISION) -> int:
    if not 4 <= precision <= 18:
        raise ValueError("precision must be in [4, 18]")
    return 1 << precision


def init(batch_shape: Sequence[int] = (), precision: int = DEFAULT_PRECISION,
         dtype=torch.int32, device=None) -> torch.Tensor:
    """Empty register tensors for a batch of series: [..., 2^p] zeros."""
    return torch.zeros(tuple(batch_shape) + (num_registers(precision),),
                       dtype=dtype, device=resolve_device(device))


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values in [0, 2^32) (SWAR popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of int64 values in [0, 2^32) as 32-bit words
    (clz(0) == 32): smear the top set bit right, then count."""
    for s in (1, 2, 4, 8, 16):
        x = x | (x >> s)
    return 32 - _popcount32(x)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """A hash half (any integer dtype, e.g. uint32 bits viewed as int32)
    as an int64 in [0, 2^32)."""
    return x.long() & _M32


def idx_rho(hash_hi: torch.Tensor, hash_lo: torch.Tensor,
            precision: int = DEFAULT_PRECISION):
    """Split 64-bit hashes (two 32-bit halves) into (register index, rho):
    idx = top p bits, rho = leading zeros of the remaining 64-p bits + 1,
    capped at 64-p+1."""
    p = precision
    hi, lo = _u32(hash_hi), _u32(hash_lo)
    idx = hi >> (32 - p)
    # rest = (hash << p) in 64 bits, carried as two 32-bit halves
    top = ((hi << p) & _M32) | (lo >> (32 - p))
    bot = (lo << p) & _M32
    clz = torch.where(top != 0, _clz32(top), 32 + _clz32(bot))
    rho = torch.clamp_max(clz + 1, 64 - p + 1)
    return idx, rho


def insert(registers: torch.Tensor, rows: torch.Tensor,
           hash_hi: torch.Tensor, hash_lo: torch.Tensor,
           mask: torch.Tensor | None = None,
           precision: int = DEFAULT_PRECISION) -> torch.Tensor:
    """Scatter a flat batch of hashed members into their series' sketches
    IN PLACE (registers [S, m]) and return the registers. Duplicate
    (row, idx) pairs resolve by max; masked-out entries (mask False)
    write rho 0, which never beats a register."""
    idx, rho = idx_rho(hash_hi, hash_lo, precision)
    rows = rows.long()
    if mask is not None:
        rho = torch.where(mask, rho, 0)
        rows = torch.where(mask, rows, 0)
        idx = torch.where(mask, idx, 0)
    m = registers.shape[-1]
    registers.view(-1).scatter_reduce_(0, rows * m + idx,
                                       rho.to(registers.dtype), "amax")
    return registers


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise register max, the associative merge
    (samplers.go:423-435)."""
    return torch.maximum(a, b)


def estimate(registers: torch.Tensor,
             precision: int = DEFAULT_PRECISION) -> torch.Tensor:
    """Batched cardinality estimate: [..., m] -> [...] float32, the
    classic HLL estimator with linear-counting small-range correction.

    float32 like the JAX package, with two roundings pinned down: the
    harmonic sum of powers of two accumulates in float64 (so it does not
    depend on the card's reduction order) and the log is taken in
    float64, each rounded once to float32. XLA's float32 log is not
    correctly rounded, so the two packages agree to about one ulp."""
    p = precision
    m = float(1 << p)
    if p >= 7:
        alpha = 0.7213 / (1 + 1.079 / m)
    else:
        alpha = {4: 0.673, 5: 0.697, 6: 0.709}[p]
    raw_inv = torch.exp2(-registers.float()).sum(-1, dtype=torch.float64) \
        .float()
    # tensor numerators: a scalar numerator becomes reciprocal-multiply
    est = torch.full_like(raw_inv, alpha * m * m) / raw_inv
    zeros = (registers == 0).sum(-1).float()
    ratio = torch.full_like(zeros, m) / torch.clamp_min(zeros, 1.0)
    lc = m * torch.log(ratio.double()).float()
    use_lc = (est <= 2.5 * m) & (zeros > 0)
    return torch.where(use_lc, lc, est)


# ---------------------------------------------------------------------------
# Host-side hashing (numpy), a copy of the JAX package's
# ---------------------------------------------------------------------------

_FNV64_OFFSET = 14695981039346656037
_FNV64_PRIME = 1099511628211
_MASK64 = (1 << 64) - 1


def _fmix64(h: int) -> int:
    """murmur3 64-bit finalizer: full avalanche into the top p bits."""
    h ^= h >> 33
    h = h * 0xFF51AFD7ED558CCD & _MASK64
    h ^= h >> 33
    h = h * 0xC4CEB9FE1A85EC53 & _MASK64
    h ^= h >> 33
    return h


def hash_member(member: bytes) -> int:
    """64-bit hash of a set member: FNV-1a core + murmur3 finalizer."""
    h = _FNV64_OFFSET
    for byte in member:
        h = (h ^ byte) * _FNV64_PRIME & _MASK64
    return _fmix64(h)


def split_hashes(hashes: np.ndarray):
    """uint64 [N] -> (hi, lo) uint32 halves for device transfer."""
    hashes = np.asarray(hashes, np.uint64)
    hi = (hashes >> np.uint64(32)).astype(np.uint32)
    lo = (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo
