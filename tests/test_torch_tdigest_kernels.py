"""The port's t-digest merge kernels (K1 drain_quantile, K2
compress_presorted) against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions, which
follow the kernels step for step; the Pallas kernels run as
tests/test_pallas.py runs them, with ``interpret=True``. Both sides run
the same algorithm (bitonic merge, log-step prefix sum, the same asin
polynomial), so only the order of the per-bin sums differs. Tolerances:
per-row mass rtol 1e-6, live bin weights and means rtol 1e-5,
percentiles within 1e-4 x (max - min) of the row.

tests/test_torch_cuda.py holds the CUDA kernels to the plain versions on
the card.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from veneur_tpu.ops import tdigest_pallas as tp
from veneur_tpu_torch.ops import tdigest_cuda as tc

C = 100.0
K = 104  # size_bound(100)
QS = np.array([0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 0.5],
              np.float32)


def _sorted_centroids(rng, s, k, scale, frac_live):
    mean = np.sort(rng.gamma(2.0, scale, (s, k)).astype(np.float32), axis=1)
    w = (rng.random((s, k)) < frac_live).astype(np.float32) * \
        rng.integers(1, 5, (s, k)).astype(np.float32)
    return mean, w


def _temp_half(rng, s, k, scale, frac_live):
    """A temp half as the drain hands it over: ascending, +inf empties
    last."""
    mean, w = _sorted_centroids(rng, s, k, scale, frac_live)
    mean = np.where(w > 0, mean, np.inf).astype(np.float32)
    order = np.argsort(mean, axis=1, kind="stable")
    return (np.take_along_axis(mean, order, 1),
            np.take_along_axis(w, order, 1))


def _extrema(ma, wa, mb, wb):
    big = np.float32(np.inf)
    mn = np.minimum(np.where(wa > 0, ma, big).min(1),
                    np.where(wb > 0, mb, big).min(1)).astype(np.float32)
    mx = np.maximum(np.where(wa > 0, ma, -big).max(1),
                    np.where(wb > 0, mb, -big).max(1)).astype(np.float32)
    return mn, mx


def _both(ma, wa, mb, wb, mn=None, mx=None):
    """(port outputs, Pallas outputs) as numpy, K1 when extrema are given,
    else K2."""
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (ma, wa, mb, wb)]
    j = [jnp.asarray(a) for a in (ma, wa, mb, wb)]
    if mn is None:
        port = tc.compress_presorted(*t, C, K)
        ref = tp.compress_presorted(*j, C, K, interpret=True)
    else:
        port = tc.drain_quantile(*t, torch.from_numpy(mn),
                                 torch.from_numpy(mx), torch.from_numpy(QS),
                                 C, K)
        ref = tp.drain_quantile(*j, jnp.asarray(mn), jnp.asarray(mx),
                                jnp.asarray(QS), C, K, interpret=True)
    return ([p.numpy() for p in port], [np.asarray(r) for r in ref])


def _assert_match(port, ref, wa, wb, mn=None, mx=None):
    pm, pw = port[0], port[1]
    rm, rw = ref[0], ref[1]
    # per-row mass is conserved by both (rtol 1e-6)
    mass = wa.astype(np.float64).sum(1) + wb.astype(np.float64).sum(1)
    np.testing.assert_allclose(pw.sum(1), mass, rtol=1e-6)
    np.testing.assert_allclose(rw.sum(1), mass, rtol=1e-6)
    # the same bins are live; live weights and means agree (rtol 1e-5)
    live = rw > 0
    np.testing.assert_array_equal(pw > 0, live)
    np.testing.assert_allclose(pw[live], rw[live], rtol=1e-5)
    np.testing.assert_allclose(pm[live], rm[live], rtol=1e-5)
    # gap-filled output rows ascend
    assert (pm[:, 1:] >= pm[:, :-1]).all()
    if mn is not None:
        pp, rp = port[2], ref[2]
        np.testing.assert_array_equal(np.isnan(pp), np.isnan(rp))
        span = np.where(np.isfinite(mx - mn), mx - mn, 0.0)[:, None]
        ok = np.isnan(rp) | (np.abs(pp - rp) <= 1e-4 * span + 1e-6)
        assert ok.all(), np.abs(pp - rp)[~ok]


@pytest.mark.parametrize("kernel", ["drain_quantile", "compress_presorted"])
class TestMergeKernels:
    def _run(self, kernel, ma, wa, mb, wb):
        if kernel == "drain_quantile":
            mn, mx = _extrema(ma, wa, mb, wb)
            port, ref = _both(ma, wa, mb, wb, mn, mx)
            _assert_match(port, ref, wa, wb, mn, mx)
        else:
            port, ref = _both(ma, wa, mb, wb)
            _assert_match(port, ref, wa, wb)
        return port, ref

    def test_mass_exact_and_row_padding(self, kernel):
        """130 rows: the Pallas side pads to two 128-row blocks."""
        rng = np.random.default_rng(3)
        ma, wa = _sorted_centroids(rng, 130, K, 30.0, 0.7)
        mb, wb = _temp_half(rng, 130, K, 25.0, 0.5)
        self._run(kernel, ma, wa, mb, wb)

    def test_odd_row_count(self, kernel):
        rng = np.random.default_rng(5)
        ma, wa = _sorted_centroids(rng, 37, K, 30.0, 0.6)
        mb, wb = _temp_half(rng, 37, K, 20.0, 0.6)
        self._run(kernel, ma, wa, mb, wb)

    def test_empty_rows(self, kernel):
        s = 8
        ma = np.full((s, K), np.inf, np.float32)
        wa = np.zeros((s, K), np.float32)
        port, _ = self._run(kernel, ma, wa, ma.copy(), wa.copy())
        assert port[1].sum() == 0.0
        if kernel == "drain_quantile":
            assert np.isnan(port[2]).all()

    def test_single_centroid(self, kernel):
        s = 8
        ma = np.full((s, K), np.inf, np.float32)
        ma[:, 0] = 42.0
        wa = np.zeros((s, K), np.float32)
        wa[:, 0] = 7.0
        mb = np.full((s, K), np.inf, np.float32)
        wb = np.zeros((s, K), np.float32)
        port, _ = self._run(kernel, ma, wa, mb, wb)
        live = port[1] > 0
        assert live.sum() == s
        np.testing.assert_array_equal(port[0][live], 42.0)
        np.testing.assert_array_equal(port[1][live], 7.0)
        if kernel == "drain_quantile":
            np.testing.assert_array_equal(port[2], 42.0)

    def test_constant_series_no_nan(self, kernel):
        """Every centroid at one value: no NaN anywhere, every percentile
        is that value."""
        rng = np.random.default_rng(11)
        s = 16
        ma = np.full((s, K), 3.5, np.float32)
        wa = rng.integers(1, 4, (s, K)).astype(np.float32)
        mb = np.full((s, K), 3.5, np.float32)
        wb = rng.integers(1, 4, (s, K)).astype(np.float32)
        port, _ = self._run(kernel, ma, wa, mb, wb)
        live = port[1] > 0
        assert not np.isnan(port[0]).any()
        np.testing.assert_allclose(port[0][live], 3.5, rtol=1e-6)
        if kernel == "drain_quantile":
            assert not np.isnan(port[2]).any()
            np.testing.assert_allclose(port[2], 3.5, rtol=1e-6)

    def test_dead_slot_means(self, kernel):
        """Dead slots of the digest half carry -inf (leading gaps),
        gap-filled running-max values and +inf (trailing): liveness is
        weight > 0 alone, and no 0 * inf reaches a sum."""
        rng = np.random.default_rng(17)
        s = 24
        ma, wa = _sorted_centroids(rng, s, K, 30.0, 0.5)
        ma = np.maximum.accumulate(np.where(wa > 0, ma, -np.inf), axis=1)
        ma[:, -10:] = np.inf
        wa[:, -10:] = 0.0
        mb, wb = _temp_half(rng, s, K, 25.0, 0.5)
        port, _ = self._run(kernel, ma.astype(np.float32), wa, mb, wb)
        assert np.isfinite(port[1]).all()


def test_gate_rejects_other_devices():
    """The gate takes CUDA tensors to the kernel and CPU tensors to the
    plain version; anything else raises, it never falls back."""
    a = torch.zeros((2, K), device="meta")
    with pytest.raises(ValueError):
        tc.compress_presorted(a, a, a, a, C, K)
    cpu = torch.zeros((2, K))
    with pytest.raises(ValueError):
        tc.compress_presorted(cpu, cpu, a, a, C, K)


def test_cpu_path_counts_no_launch():
    before = (tc.drain_quantile.launches, tc.compress_presorted.launches)
    z = torch.zeros((4, K))
    tc.compress_presorted(z, z, z, z, C, K)
    tc.drain_quantile(z, z, z, z, z[:, 0], z[:, 0], torch.tensor([0.5]),
                      C, K)
    assert (tc.drain_quantile.launches,
            tc.compress_presorted.launches) == before
