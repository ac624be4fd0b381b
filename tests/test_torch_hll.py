"""The port's HyperLogLog ops against veneur_tpu.ops.hll on the CPU.

idx_rho, insert and merge must match bit for bit, on hashes that cover
hi == 0, the top 32-bit word of the shifted rest being 0 (so the count of
leading zeros crosses into the low word) and the rho cap (rest == 0).
The estimate agrees to rtol 1e-6, about one float32 ulp: XLA's float32
log is not correctly rounded on the CPU, while the port takes the log in
float64 and rounds once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.ops import hll as jh
from veneur_tpu_torch.ops import hll as th

P = 14


def _hashes(rng, n):
    h = rng.integers(0, np.iinfo(np.uint64).max, n, dtype=np.uint64,
                     endpoint=True)
    h[:40] = 0                                           # rho cap
    h[40:80] &= np.uint64(0x00000000FFFFFFFF)            # hi == 0
    h[80:120] &= np.uint64(0x0003FFFF00000000)           # top word of rest 0
    h[120:160] = (h[120:160] & np.uint64(0xFFFC000000000000)) | \
        np.uint64(1)                                     # rho = 64 - p
    return h


def _halves(h):
    hi, lo = jh.split_hashes(h)
    return (hi, lo, torch.from_numpy(hi.view(np.int32)),
            torch.from_numpy(lo.view(np.int32)))


@pytest.mark.parametrize("precision", [4, 10, 14, 18])
def test_idx_rho_bit_identical(precision):
    rng = np.random.default_rng(precision)
    hi, lo, thi, tlo = _halves(_hashes(rng, 5000))
    ji, jr = (np.asarray(a) for a in jh.idx_rho(jnp.asarray(hi),
                                                jnp.asarray(lo), precision))
    ti, tr = (a.numpy() for a in th.idx_rho(thi, tlo, precision))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tr, jr)
    assert jr.max() == 64 - precision + 1


def test_insert_and_estimate():
    rng = np.random.default_rng(7)
    s, n = 24, 120000
    h = _hashes(rng, n)
    hi, lo, thi, tlo = _halves(h)
    # series i gets a share of the members growing with i, so the
    # estimates cover the linear-counting and the raw regime
    rows = np.minimum((rng.random(n) ** 2 * s).astype(np.int32), s - 1)
    mask = rng.random(n) < 0.95
    jr = jh.insert(jh.init((s,), P), jnp.asarray(rows), jnp.asarray(hi),
                   jnp.asarray(lo), jnp.asarray(mask), P)
    tr = th.insert(th.init((s,), P, device="cpu"), torch.from_numpy(rows),
                   thi, tlo, torch.from_numpy(mask), P)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    je = np.asarray(jh.estimate(jr, P))
    te = th.estimate(tr, P).numpy()
    np.testing.assert_allclose(te, je, rtol=1e-6)
    # int8 registers (the store's layout) estimate the same
    np.testing.assert_array_equal(th.estimate(tr.to(torch.int8), P).numpy(),
                                  te)


def test_merge_and_empty():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 20, (4, 1 << P)).astype(np.int32)
    b = rng.integers(0, 20, (4, 1 << P)).astype(np.int32)
    np.testing.assert_array_equal(
        th.merge(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jh.merge(jnp.asarray(a), jnp.asarray(b))))
    empty = th.init((3,), P, device="cpu")
    np.testing.assert_array_equal(th.estimate(empty, P).numpy(), 0.0)


def test_host_hashing_matches():
    members = [b"", b"a", b"user-123", "ünï".encode(), bytes(range(256))]
    assert [th.hash_member(m) for m in members] == \
        [jh.hash_member(m) for m in members]
    h = _hashes(np.random.default_rng(1), 100)
    for x, y in zip(th.split_hashes(h), jh.split_hashes(h)):
        np.testing.assert_array_equal(x, y)


def test_precision_bounds():
    for p in (3, 19):
        with pytest.raises(ValueError):
            th.num_registers(p)
