"""The port's t-digest tensor ops against veneur_tpu.ops.tdigest on the CPU.

Inputs are continuous random values made with numpy from a seed, so sort
ties cannot reorder samples. Tolerances:

* per-row mass: rtol 1e-6 (float32 sums in a different order);
* bin ids: equal, except for samples whose k-scale position lies within
  1e-4 of an integer, where a different summation order may round them
  into the neighbouring bin;
* across rungs, quantiles within 0.02 x (max - min): the JAX package's
  CPU path is its XLA rung with the true arcsin, the port's CPU path is
  the plain version of the flush kernels with the asin polynomial
  (tdigest_pallas.py:12-14).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.ops import tdigest as jtd
from veneur_tpu_torch import convert
from veneur_tpu_torch.ops import tdigest as ttd

C = 100.0
K = ttd.size_bound(C)
S = 48
QS = np.array([0.05, 0.25, 0.5, 0.75, 0.95, 0.99], np.float32)

_j_guarded = jax.jit(jtd.ingest_chunk_guarded, static_argnums=(5,))
_j_drain_q = jax.jit(jtd.drain_and_quantile, static_argnums=(5,))
_j_drain = jax.jit(jtd.drain_temp, static_argnums=(2,))


def _t(a):
    return torch.from_numpy(np.array(a))


def _k64(q):
    return C * (np.arcsin(np.clip(2.0 * q - 1.0, -1.0, 1.0)) / np.pi + 0.5)


def _near_integer(k):
    return np.abs(k - np.round(k)) < 1e-4


def _jax_temp(temp):
    return {f: np.asarray(getattr(temp, f)) for f in jtd.TempCentroids._fields}


def _port_temp(planes):
    return convert.temp_from_numpy(planes, device="cpu")


def _chunk(rng, rows_per, loc=0.0, weight=2.0, pad=7):
    """Every series gets ``rows_per`` samples (gamma(2, 10) + loc) at one
    weight, plus ``pad`` padding entries (row == S, weight 0)."""
    rows = np.repeat(np.arange(S, dtype=np.int32), rows_per)
    vals = (loc + rng.gamma(2.0, 10.0, len(rows))).astype(np.float32)
    wts = np.full(len(rows), weight, np.float32)
    perm = rng.permutation(len(rows))
    rows, vals, wts = rows[perm], vals[perm], wts[perm]
    return (np.concatenate([rows, np.full(pad, S, np.int32)]),
            np.concatenate([vals, np.zeros(pad, np.float32)]),
            np.concatenate([wts, np.zeros(pad, np.float32)]))


def _quantile_close(qa, qb, lo, hi, tol=0.02):
    span = (hi - lo)[:, None]
    both_nan = np.isnan(qa) & np.isnan(qb)
    ok = both_nan | (np.abs(qa - qb) <= tol * span + 1e-6)
    assert ok.all(), np.abs(qa - qb)[~ok]


class TestCompress:
    def test_compress_matches(self):
        rng = np.random.default_rng(1)
        m = 3 * K
        mean = rng.uniform(-50.0, 250.0, (S, m)).astype(np.float32)
        weight = (rng.random((S, m)) < 0.6).astype(np.float32) * \
            rng.integers(1, 6, (S, m)).astype(np.float32)
        weight[0] = 0.0                                   # an empty row
        jm, jw = (np.asarray(a) for a in jtd._compress(
            jnp.asarray(mean), jnp.asarray(weight), C, K))
        pm, pw = (a.numpy() for a in ttd._compress(_t(mean), _t(weight),
                                                   C, K))
        np.testing.assert_allclose(pw.sum(1), weight.astype(np.float64)
                                   .sum(1), rtol=1e-6)
        # rows whose sorted centroids all sit clear of a bin edge must
        # produce the same centroids
        exempt = np.zeros(S, bool)
        for r in range(S):
            live = weight[r] > 0
            order = np.argsort(mean[r][live], kind="stable")
            w = weight[r][live][order].astype(np.float64)
            if not len(w):
                continue
            incl = np.cumsum(w)
            exempt[r] = _near_integer(_k64((incl - 0.5 * w) / incl[-1])).any()
        keep = ~exempt
        assert keep.sum() > S // 2
        np.testing.assert_allclose(pw[keep], jw[keep], rtol=1e-6)
        live = jw[keep] > 0
        np.testing.assert_allclose(pm[keep][live], jm[keep][live],
                                   rtol=1e-5)
        assert (pm[keep][~live] == np.inf).all()

    def test_quantile_matches(self):
        rng = np.random.default_rng(2)
        mean = np.sort(rng.gamma(2.0, 10.0, (S, 2 * K)).astype(np.float32))
        weight = rng.integers(0, 4, (S, 2 * K)).astype(np.float32)
        weight[3] = 0.0
        jm, jw = jtd._compress(jnp.asarray(mean), jnp.asarray(weight), C, K)
        lo = mean.min(1)
        hi = mean.max(1)
        jq = np.asarray(jtd.quantile(jtd.TDigest(jm, jw, jnp.asarray(lo),
                                                 jnp.asarray(hi)), QS))
        state = ttd.TDigest(_t(np.asarray(jm)), _t(np.asarray(jw)), _t(lo),
                            _t(hi))
        pq = ttd.quantile(state, QS).numpy()
        assert np.isnan(pq[3]).all() and np.isnan(jq[3]).all()
        # the same rung on the same digest: only the searchsorted
        # formulation differs
        _quantile_close(pq, jq, lo, hi, tol=1e-5)


class TestBinning:
    @pytest.mark.parametrize("with_acc", [False, True])
    def test_bin_flat_samples(self, with_acc):
        rng = np.random.default_rng(3)
        acc_w = acc_wm = None
        if with_acc:
            temp = jtd.ingest_chunk(jtd.init_temp(S, K, C),
                                    *(jnp.asarray(a)
                                      for a in _chunk(rng, 10)), C)
            acc_w, acc_wm = np.asarray(temp.seg_w), np.asarray(temp.seg_wm)
        rows, vals, wts = _chunk(rng, 12)
        jr, jv, jw, jb = (np.asarray(a) for a in jtd.bin_flat_samples(
            jnp.asarray(rows), jnp.asarray(vals), jnp.asarray(wts), S, K, C,
            acc_seg_w=None if acc_w is None else jnp.asarray(acc_w),
            acc_seg_wm=None if acc_wm is None else jnp.asarray(acc_wm)))
        pr, pv, pw, pb = (a.numpy() for a in ttd.bin_flat_samples(
            _t(rows), _t(vals), _t(wts), S, K, C,
            acc_seg_w=None if acc_w is None else _t(acc_w),
            acc_seg_wm=None if acc_wm is None else _t(acc_wm)))
        np.testing.assert_array_equal(pr, jr)
        np.testing.assert_array_equal(pv, jv)
        np.testing.assert_array_equal(pw, jw)
        # float64 k of every sample, from the sorted samples themselves
        q = np.zeros(len(jr))
        below = acc_tot = np.zeros(len(jr))
        if with_acc:
            below, acc_tot = (np.asarray(a, np.float64)
                              for a in jtd._acc_below_mass(
                                  jnp.asarray(jr), jnp.asarray(jv),
                                  jnp.asarray(acc_w), jnp.asarray(acc_wm),
                                  S))
        for r in range(S):
            sel = jr == r
            w = jw[sel].astype(np.float64)
            excl = np.cumsum(w) - w
            q[sel] = (below[sel] + excl + 0.5 * w) / (w.sum() + acc_tot[sel])
        exempt = _near_integer(_k64(q)) & (jr < S)
        mismatch = pb != jb
        assert not (mismatch & ~exempt).any(), np.flatnonzero(mismatch)
        assert mismatch.sum() <= exempt.sum()


def _ingest_both(jstate, pstate, chunk):
    """One guarded chunk into both packages; returns both states and the
    two guard predicates."""
    jd, jt = jstate
    pd, pt = pstate
    rows, vals, wts = chunk
    jpred = bool(jtd.shift_pred(jt.seg_w, jt.seg_wm, jnp.asarray(rows),
                                jnp.asarray(vals), jnp.asarray(wts), S))
    ppred = bool(ttd.shift_pred(pt.seg_w, pt.seg_wm, _t(rows), _t(vals),
                                _t(wts), S))
    jd, jt = _j_guarded(jd, jt, jnp.asarray(rows), jnp.asarray(vals),
                        jnp.asarray(wts), C)
    pd, pt = ttd.ingest_chunk_guarded(pd, pt, _t(rows), _t(vals), _t(wts),
                                      C)
    return (jd, jt), (pd, pt), jpred, ppred


def _assert_temp_close(jt, pt):
    np.testing.assert_array_equal(pt.count.numpy(), np.asarray(jt.count))
    np.testing.assert_array_equal(pt.vmin.numpy(), np.asarray(jt.vmin))
    np.testing.assert_array_equal(pt.vmax.numpy(), np.asarray(jt.vmax))
    for f in ("vsum", "recip"):
        np.testing.assert_allclose(getattr(pt, f).numpy(),
                                   np.asarray(getattr(jt, f)), rtol=1e-6)
    for f in ("sum_w", "seg_w"):
        np.testing.assert_allclose(getattr(pt, f).numpy().sum(1),
                                   np.asarray(getattr(jt, f)).sum(1),
                                   rtol=1e-6)


class TestGuardedIngest:
    def test_step_chunk_trips_the_guard(self):
        """Two stationary chunks, then a step past the accumulated range:
        both packages drain on exactly the step chunk, and the flush
        agrees within the cross-rung envelope."""
        rng = np.random.default_rng(4)
        jstate = (jtd.init((S,), C, K), jtd.init_temp(S, K, C))
        pstate = (ttd.init((S,), C, K, device="cpu"),
                  ttd.init_temp(S, K, C, device="cpu"))
        preds = []
        sent = [[] for _ in range(S)]
        for loc, n in ((0.0, 6), (0.0, 4), (1000.0, 4)):
            chunk = _chunk(rng, n, loc=loc)
            for r, v in zip(chunk[0], chunk[1]):
                if r < S:
                    sent[r].append(v)
            jstate, pstate, jp, pp = _ingest_both(jstate, pstate, chunk)
            preds.append((jp, pp))
            _assert_temp_close(jstate[1], pstate[1])
        assert preds == [(False, False), (False, False), (True, True)]
        # the drained digests hold the first two chunks' mass
        np.testing.assert_allclose(pstate[0].weight.numpy().sum(1),
                                   np.asarray(jstate[0].weight).sum(1),
                                   rtol=1e-6)
        np.testing.assert_allclose(pstate[0].weight.numpy().sum(1),
                                   2.0 * 10, rtol=1e-6)
        inf = np.full(S, np.inf, np.float32)
        jd, jq = _j_drain_q(jstate[0], jstate[1], jnp.asarray(inf),
                            jnp.asarray(-inf), jnp.asarray(QS), C)
        pd, pq = ttd.drain_and_quantile(pstate[0], pstate[1], _t(inf),
                                        _t(-inf), QS, C)
        lo = np.array([min(s) for s in sent], np.float32)
        hi = np.array([max(s) for s in sent], np.float32)
        np.testing.assert_array_equal(pd.min.numpy(), lo)
        np.testing.assert_array_equal(pd.max.numpy(), hi)
        np.testing.assert_allclose(pd.weight.numpy().sum(1), 2.0 * 14,
                                   rtol=1e-6)
        _quantile_close(pq.numpy(), np.asarray(jq), lo, hi)


class TestDrain:
    def _accumulated(self, seed):
        rng = np.random.default_rng(seed)
        temp = jtd.init_temp(S, K, C)
        for n in (8, 8):
            temp = jtd.ingest_chunk(temp, *(jnp.asarray(a)
                                            for a in _chunk(rng, n)), C)
        mean = np.sort(rng.gamma(2.0, 12.0, (S, K)).astype(np.float32))
        weight = (rng.random((S, K)) < 0.3).astype(np.float32)
        # a digest row as the flush kernels leave it: dead slots carry the
        # running max of the live means (-inf before the first)
        live = weight > 0
        lo = np.where(live, mean, np.inf).min(1)
        hi = np.where(live, mean, -np.inf).max(1)
        mean = np.maximum.accumulate(np.where(live, mean, -np.inf), axis=1)
        digest = {"mean": mean.astype(np.float32), "weight": weight,
                  "min": lo.astype(np.float32), "max": hi.astype(np.float32)}
        return digest, _jax_temp(temp)

    def test_drain_temp(self):
        digest, temp = self._accumulated(5)
        jd = _j_drain(jtd.TDigest(*(jnp.asarray(digest[k])
                                    for k in ("mean", "weight", "min",
                                              "max"))),
                      jtd.TempCentroids(**{k: jnp.asarray(v)
                                           for k, v in temp.items()}), C)
        pd = ttd.drain_temp(convert.digest_from_numpy(digest, "cpu"),
                            _port_temp(temp), C)
        np.testing.assert_allclose(
            pd.weight.numpy().sum(1),
            digest["weight"].sum(1) + temp["sum_w"].sum(1), rtol=1e-6)
        np.testing.assert_array_equal(pd.min.numpy(), np.asarray(jd.min))
        np.testing.assert_array_equal(pd.max.numpy(), np.asarray(jd.max))
        lo, hi = np.asarray(jd.min), np.asarray(jd.max)
        jq = np.asarray(jtd.quantile(jd, QS))
        pq = ttd.quantile(pd, QS).numpy()
        _quantile_close(pq, jq, lo, hi)

    def test_drain_and_quantile(self):
        digest, temp = self._accumulated(6)
        dmin = np.full(S, np.inf, np.float32)
        dmax = np.full(S, -np.inf, np.float32)
        dmin[::5] = -3.0                     # imported extrema widen rows
        dmax[::7] = 900.0
        jd, jq = _j_drain_q(
            jtd.TDigest(*(jnp.asarray(digest[k])
                          for k in ("mean", "weight", "min", "max"))),
            jtd.TempCentroids(**{k: jnp.asarray(v) for k, v in temp.items()}),
            jnp.asarray(dmin), jnp.asarray(dmax), jnp.asarray(QS), C)
        pd, pq = ttd.drain_and_quantile(
            convert.digest_from_numpy(digest, "cpu"), _port_temp(temp),
            _t(dmin), _t(dmax), QS, C)
        np.testing.assert_allclose(pd.weight.numpy().sum(1),
                                   np.asarray(jd.weight).sum(1), rtol=1e-6)
        np.testing.assert_array_equal(pd.min.numpy(), np.asarray(jd.min))
        np.testing.assert_array_equal(pd.max.numpy(), np.asarray(jd.max))
        _quantile_close(pq.numpy(), np.asarray(jq), np.asarray(jd.min),
                        np.asarray(jd.max))


def test_temp_fields_own_their_buffers():
    """The temp is updated in place, so no two fields may share storage."""
    temp = ttd.init_temp(16, device="cpu")
    ptrs = [t.data_ptr() for t in temp]
    assert len(set(ptrs)) == len(ptrs)


def test_default_device_is_the_card():
    """Without a device argument the port runs on cuda, or raises."""
    if torch.cuda.is_available():
        assert ttd.init((2,)).mean.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttd.init((2,))
