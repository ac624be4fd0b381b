"""The port's count-min + top-k ops (veneur_tpu_torch/ops/countmin.py)
against the JAX package's (veneur_tpu/ops/countmin.py), on the CPU.

Inputs are seeded numpy arrays fed to both. Tolerances:

* ``_mix32`` and ``_col_index``: bit for bit, on words that include 0,
  0xFFFFFFFF and 2^31;
* ``update``, ``add_table``, ``inject_candidates`` and ``estimate``: bit
  for bit (table, top-k hi/lo/count planes and sids) while the table's
  mass stays an integer below 2^24 (float32 sums exact in any order).
  That holds on collision-heavy and tie-heavy batches too, because the
  port keeps XLA's documented orders: the LAST of several candidates
  hitting one ring slot wins, and the top-k keeps the lower index on
  ties;
* above a mass of 2^24 the ring salt (a float32 sum cast to uint32) may
  differ, so the top-k is held only to the count-min bounds of
  tests/test_countmin.py: estimates never under the exact count, and
  at most ``len(stream) / width * depth + 1`` over it.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.ops import countmin as jcm
from veneur_tpu_torch.ops import countmin as tcm

W32 = np.array([0, 0xFFFFFFFF, 1, 0x80000000, 0x7FFFFFFF], np.uint32)


def _words(rng, n):
    return np.concatenate([W32, rng.integers(0, 1 << 32, n - len(W32),
                                             dtype=np.uint64)
                           .astype(np.uint32)])


def _t32(a):
    """uint32 numpy -> the port's int32 bit-pattern tensor."""
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())


def _split(keys):
    keys = np.asarray(keys, np.uint64)
    return ((keys >> np.uint64(32)).astype(np.uint32),
            (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _assert_same(js, ts):
    np.testing.assert_array_equal(np.asarray(js.table), ts.table.numpy())
    for f in ("topk_hi", "topk_lo", "sids"):
        np.testing.assert_array_equal(
            np.asarray(getattr(js, f)).view(np.int32),
            getattr(ts, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(np.asarray(js.topk_counts),
                                  ts.topk_counts.numpy())


def _update_both(js, ts, rows, sids, hi, lo, counts):
    js = jcm.update(js, jnp.asarray(rows, jnp.int32),
                    jnp.asarray(sids, jnp.uint32), jnp.asarray(hi),
                    jnp.asarray(lo), jnp.asarray(counts, jnp.float32))
    ts = tcm.update(ts, torch.from_numpy(np.asarray(rows, np.int32)),
                    _t32(sids), _t32(hi), _t32(lo),
                    torch.from_numpy(np.asarray(counts, np.float32)))
    return js, ts


def _sid_of(rows):
    return (np.asarray(rows, np.uint64) * np.uint64(2654435761)
            % np.uint64(1 << 32)).astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mix32_bit_for_bit(seed):
    """The murmur3 finalizer over int64-carried words equals the JAX
    uint32 one on every input, edge words included."""
    x = _words(np.random.default_rng(seed), 4096)
    want = np.asarray(jcm._mix32(jnp.asarray(x))).astype(np.int64)
    got = tcm._mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    # int32 bit patterns (how the planes carry words) mix the same
    np.testing.assert_array_equal(tcm._mix32(_t32(x)).numpy(), want)


@pytest.mark.parametrize("d", range(len(tcm._ROW_SALTS)))
def test_col_index_bit_for_bit(d):
    rng = np.random.default_rng(100 + d)
    s, h, lo = (_words(rng, 2048) for _ in range(3))
    for width in (1 << 16, 1000, 1 << 12):
        want = np.asarray(jcm._col_index(
            jnp.asarray(s), jnp.asarray(h), jnp.asarray(lo),
            jcm._ROW_SALTS[d], width))
        got = tcm._col_index(_t32(s), _t32(h), _t32(lo), tcm._ROW_SALTS[d],
                             width).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [3, 4])
def test_update_collision_free_bit_for_bit(seed):
    """Few candidates a series per drain (no ring-slot collisions in
    practice), a padded batch, several drains: every plane equal."""
    rng = np.random.default_rng(seed)
    S, K = 64, 8
    js, ts = jcm.init(S, 4, 1 << 14, K), tcm.init(S, 4, 1 << 14, K,
                                                   device="cpu")
    for _ in range(5):
        n = 256
        rows = rng.integers(0, S, n)
        keys = rng.integers(1, 1 << 62, n, dtype=np.uint64)
        hi, lo = _split(keys)
        counts = rng.integers(1, 4, n).astype(np.float32)
        rows[-16:] = S  # padding: out of range, count 0
        counts[-16:] = 0
        js, ts = _update_both(js, ts, rows, _sid_of(rows), hi, lo, counts)
        _assert_same(js, ts)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_update_collision_and_tie_heavy_bit_for_bit(seed):
    """A few keys over few series, many repeats a drain: ring slots
    collide (the last candidate in batch order wins, as XLA's scatter on
    the CPU) and counts tie (the lower index wins, as lax.top_k). The
    planes stay equal, and the top-k holds to the count-min bounds."""
    rng = np.random.default_rng(seed)
    S, K, width, depth = 5, 4, 1 << 10, 4
    js, ts = jcm.init(S, depth, width, K), tcm.init(S, depth, width, K,
                                                     device="cpu")
    universe = rng.integers(1, 1 << 62, 24, dtype=np.uint64)
    exact = collections.Counter()
    total = 0
    for _ in range(6):
        n = 300
        rows = rng.integers(0, S, n)
        keys = universe[rng.integers(0, len(universe), n)]
        hi, lo = _split(keys)
        js, ts = _update_both(js, ts, rows, _sid_of(rows), hi, lo,
                              np.ones(n, np.float32))
        _assert_same(js, ts)
        exact.update(zip(rows.tolist(), keys.tolist()))
        total += n
    slack = total / width * depth + 1
    for r in range(S):
        for h, l, c in zip(ts.topk_hi[r].numpy().view(np.uint32),
                           ts.topk_lo[r].numpy().view(np.uint32),
                           ts.topk_counts[r].numpy()):
            if c > 0:
                want = exact[(r, (int(h) << 32) | int(l))]
                assert want <= c <= want + slack


def test_add_table_and_inject_bit_for_bit():
    """A forwarded table adds elementwise and re-estimates the standing
    entries; forwarded candidates (padding rows and (0, 0) keys among
    them) merge into the lists."""
    rng = np.random.default_rng(8)
    S, K, width = 16, 8, 1 << 12
    js, ts = jcm.init(S, 4, width, K), tcm.init(S, 4, width, K,
                                                 device="cpu")
    rows = rng.integers(0, S, 400)
    hi, lo = _split(rng.integers(1, 1 << 62, 400, dtype=np.uint64) % 50 + 1)
    js, ts = _update_both(js, ts, rows, _sid_of(rows), hi, lo,
                          np.ones(400, np.float32))
    other = rng.integers(0, 3, (4, width)).astype(np.float32)
    js = jcm.add_table(js, jnp.asarray(other))
    ts = tcm.add_table(ts, torch.from_numpy(other))
    _assert_same(js, ts)
    n = 64
    irows = rng.integers(0, S + 2, n).astype(np.int32)  # S, S+1: padding
    ihi, ilo = _split(rng.integers(1, 1 << 62, n, dtype=np.uint64) % 60 + 1)
    ihi[:4] = ilo[:4] = 0
    slots = np.arange(n, dtype=np.int32) % K
    js = jcm.inject_candidates(js, jnp.asarray(irows),
                               jnp.asarray(_sid_of(irows)),
                               jnp.asarray(ihi), jnp.asarray(ilo),
                               jnp.asarray(slots))
    ts = tcm.inject_candidates(ts, torch.from_numpy(irows),
                               _t32(_sid_of(irows)), _t32(ihi), _t32(ilo),
                               torch.from_numpy(slots))
    _assert_same(js, ts)


def test_estimate_bit_for_bit():
    rng = np.random.default_rng(9)
    S = 8
    js, ts = jcm.init(S, 4, 1 << 12, 4), tcm.init(S, 4, 1 << 12, 4,
                                                   device="cpu")
    rows = rng.integers(0, S, 1000)
    hi, lo = _split(rng.integers(1, 1 << 62, 1000, dtype=np.uint64) % 90)
    js, ts = _update_both(js, ts, rows, _sid_of(rows), hi, lo,
                          np.ones(1000, np.float32))
    q = rng.integers(-2, S + 2, 500).astype(np.int32)  # clipped rows too
    qhi, qlo = _split(rng.integers(0, 1 << 62, 500, dtype=np.uint64) % 90)
    want = np.asarray(jcm.estimate(js, jnp.asarray(q), jnp.asarray(qhi),
                                   jnp.asarray(qlo)))
    got = tcm.estimate(ts, torch.from_numpy(q), _t32(qhi),
                       _t32(qlo)).numpy()
    np.testing.assert_array_equal(got, want)


def test_rev_seg_max_matches_jax():
    rng = np.random.default_rng(10)
    x = rng.integers(0, 50, (6, 37)).astype(np.float32)
    same = rng.random((6, 37)) < 0.6
    same[:, 0] = False
    want = np.asarray(jcm._rev_seg_max(jnp.asarray(x), jnp.asarray(same)))
    got = tcm._rev_seg_max(torch.from_numpy(x),
                           torch.from_numpy(same)).numpy()
    np.testing.assert_array_equal(got, want)


def test_topk_matches_exact_counter():
    """The port alone, as tests/test_countmin.py holds the JAX package:
    separated heavy hitters over background noise, several drains; the
    top-k ids are the heavy ones, counts within the count-min slack."""
    rng = np.random.default_rng(1)
    heavy = rng.integers(1, 1 << 62, 16, dtype=np.uint64)
    stream = []
    for i, h in enumerate(heavy):
        stream.extend([int(h)] * (1000 - 50 * i))
    stream.extend(rng.integers(1, 1 << 62, 3000, dtype=np.uint64).tolist())
    stream = np.array(stream, np.uint64)
    rng.shuffle(stream)
    ts = tcm.init(1, depth=4, width=1 << 15, k=16, device="cpu")
    for part in np.array_split(stream, 7):
        hi, lo = _split(part)
        z = torch.zeros(len(part), dtype=torch.int32)
        ts = tcm.update(ts, z, z, _t32(hi), _t32(lo),
                        torch.ones(len(part)))
    got = {}
    for h, l, c in zip(ts.topk_hi[0].numpy().view(np.uint32),
                       ts.topk_lo[0].numpy().view(np.uint32),
                       ts.topk_counts[0].numpy()):
        if c > 0:
            got[(int(h) << 32) | int(l)] = float(c)
    assert set(got) == {int(h) for h in heavy}
    exact = collections.Counter(stream.tolist())
    slack = len(stream) / (1 << 15) * 4 + 1
    for hid, c in got.items():
        assert exact[hid] <= c <= exact[hid] + slack


def test_mass_above_2_24_holds_the_bounds():
    """Past a table mass of 2^24 (weighted counts) the float32 ring salt
    is no longer exact, so only the count-min bounds are held: each
    top-k estimate within [exact, exact + total / width * depth + 1]
    and the heavy keys present."""
    rng = np.random.default_rng(12)
    width, depth = 1 << 14, 4
    ts = tcm.init(2, depth, width, 8, device="cpu")
    heavy = rng.integers(1, 1 << 62, 4, dtype=np.uint64)
    noise = rng.integers(1, 1 << 62, 2000, dtype=np.uint64)
    exact = collections.Counter()
    total = 0.0
    for _ in range(4):
        keys = rng.permutation(np.concatenate([np.repeat(heavy, 50), noise[
            rng.integers(0, len(noise), 800)]]))
        w = np.where(np.isin(keys, heavy), 40000.0, 1000.0).astype(
            np.float32)
        rows = rng.integers(0, 2, len(keys))
        hi, lo = _split(keys)
        ts = tcm.update(ts, torch.from_numpy(rows.astype(np.int32)),
                        _t32(_sid_of(rows)), _t32(hi), _t32(lo),
                        torch.from_numpy(w))
        for r, k, c in zip(rows.tolist(), keys.tolist(), w.tolist()):
            exact[(r, k)] += c
        total += float(w.sum())
    assert ts.table[0].sum().item() > (1 << 24)
    slack = total / width * depth + 1
    for r in range(2):
        live = {}
        for h, l, c in zip(ts.topk_hi[r].numpy().view(np.uint32),
                           ts.topk_lo[r].numpy().view(np.uint32),
                           ts.topk_counts[r].numpy()):
            if c > 0:
                live[(int(h) << 32) | int(l)] = float(c)
        assert {int(h) for h in heavy} <= set(live)
        for key, c in live.items():
            assert exact[(r, key)] <= c <= exact[(r, key)] + slack
