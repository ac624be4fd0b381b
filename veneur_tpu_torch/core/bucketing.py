"""Power-of-two bucketing for staged-prefix lengths (port of
``veneur_tpu/core/bucketing.py``, without the ``@bucketed`` registry,
which exists for jit shape stability)."""

from __future__ import annotations


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1; 0 rounds to 2, as the JAX
    package's helper does)."""
    return 1 << (n - 1).bit_length()


def pow2_cap(n: int) -> int:
    """Smallest power of two >= n, with 0 -> 1 (an empty drain still
    slices one sentinel row)."""
    return max(1 << max(n - 1, 0).bit_length(), 1)
