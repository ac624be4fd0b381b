"""The port's t-digest merge kernels (K1 drain_quantile, K2
compress_presorted, each with the in-kernel b-half sort K3) against the
JAX package's Pallas kernels and its XLA rung.

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

from veneur_tpu.ops import tdigest as jtd
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


def _both(ma, wa, mb, wb, mn=None, mx=None, c=C, k=K, sort_b=False):
    """(port outputs, Pallas outputs) as numpy, K1 when extrema are given,
    else K2; compression c into k bins."""
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (ma, wa, mb, wb)]
    j = [jnp.asarray(a) for a in (ma, wa, mb, wb)]
    if mn is None:
        port = tc.compress_presorted(*t, c, k, sort_b=sort_b)
        ref = tp.compress_presorted(*j, c, k, interpret=True, sort_b=sort_b)
    else:
        port = tc.drain_quantile(*t, torch.from_numpy(mn),
                                 torch.from_numpy(mx), torch.from_numpy(QS),
                                 c, k, sort_b=sort_b)
        ref = tp.drain_quantile(*j, jnp.asarray(mn), jnp.asarray(mx),
                                jnp.asarray(QS), c, k, interpret=True,
                                sort_b=sort_b)
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


# --- K3: sort_b, the b half in any order, sorted inside the kernel --------


def _in_kernel_sort_inputs():
    """tests/test_pallas.py::TestInKernelSort's inputs: S=130, C=20
    (K=24, half=32), seed 0, an unsorted b half with 30% dead slots, and
    the same half sorted ascending."""
    s, k = 130, jtd.size_bound(20.0)
    rng = np.random.default_rng(0)
    ma = np.sort(rng.normal(0, 1, (s, k)), axis=1).astype(np.float32)
    wa = rng.uniform(0.5, 2, (s, k)).astype(np.float32)
    mb = rng.normal(0, 1, (s, k)).astype(np.float32)
    wb = rng.uniform(0.5, 2, (s, k)).astype(np.float32)
    dead = rng.uniform(0, 1, (s, k)) < 0.3
    mb[dead] = np.inf
    wb[dead] = 0.0
    order = np.argsort(np.where(wb > 0, mb, np.inf), axis=1)
    return (ma, wa, mb, wb, np.take_along_axis(mb, order, 1),
            np.take_along_axis(wb, order, 1))


@pytest.mark.parametrize("kernel", ["drain_quantile", "compress_presorted"])
def test_sort_b_plain_matches_pallas_interpret(kernel):
    """The port's plain sort_b=True against the Pallas kernel with
    interpret=True, sort_b=True, at TestInKernelSort's shapes (the
    full-width interpret lowering compiles too slowly) and tolerances:
    weights rtol/atol 1e-6, live means rtol 1e-5, percentiles rtol/atol
    1e-5."""
    ma, wa, mb, wb, _, _ = _in_kernel_sort_inputs()
    c, k = 20.0, ma.shape[1]
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (ma, wa, mb, wb)]
    j = [jnp.asarray(a) for a in (ma, wa, mb, wb)]
    if kernel == "drain_quantile":
        s = ma.shape[0]
        mn, mx = np.full(s, -5.0, np.float32), np.full(s, 5.0, np.float32)
        qs = np.array([0.1, 0.5, 0.9], np.float32)
        port = tc.drain_quantile(*t, torch.from_numpy(mn),
                                 torch.from_numpy(mx), torch.from_numpy(qs),
                                 c, k, sort_b=True)
        ref = tp.drain_quantile(*j, jnp.asarray(mn), jnp.asarray(mx),
                                jnp.asarray(qs), c, k, interpret=True,
                                sort_b=True)
        np.testing.assert_allclose(port[2].numpy(), np.asarray(ref[2]),
                                   rtol=1e-5, atol=1e-5)
    else:
        port = tc.compress_presorted(*t, c, k, sort_b=True)
        ref = tp.compress_presorted(*j, c, k, interpret=True, sort_b=True)
    pm, pw = (p.numpy() for p in port[:2])
    rm, rw = (np.asarray(r) for r in ref[:2])
    np.testing.assert_allclose(pw, rw, rtol=1e-6, atol=1e-6)
    live = rw > 0
    np.testing.assert_array_equal(pw > 0, live)
    np.testing.assert_allclose(pm[live], rm[live], rtol=1e-5)


@pytest.mark.parametrize("kernel", ["drain_quantile", "compress_presorted"])
def test_sort_b_plain_matches_presorted_full_width(kernel):
    """At C=100 full width: the plain sort_b=True on a shuffled b half
    against the presorted call on the same half sorted. With distinct
    keys both build the same descending b half (the +inf empties all
    carry weight 0), so the outputs are equal bit for bit."""
    rng = np.random.default_rng(41)
    s = 64
    ma, wa = _sorted_centroids(rng, s, K, 30.0, 0.6)
    mb, wb = _temp_half(rng, s, K, 25.0, 0.5)
    perm = np.argsort(rng.random((s, K)), axis=1)
    mb_u, wb_u = (np.take_along_axis(a, perm, 1) for a in (mb, wb))
    sorted_args = [torch.from_numpy(np.ascontiguousarray(a))
                   for a in (ma, wa, mb, wb)]
    shuffled = sorted_args[:2] + [torch.from_numpy(np.ascontiguousarray(a))
                                  for a in (mb_u, wb_u)]
    if kernel == "drain_quantile":
        mn, mx = (torch.from_numpy(a) for a in _extrema(ma, wa, mb, wb))
        extra = (mn, mx, torch.from_numpy(QS))
        want = tc.drain_quantile(*sorted_args, *extra, C, K)
        got = tc.drain_quantile(*shuffled, *extra, C, K, sort_b=True)
    else:
        want = tc.compress_presorted(*sorted_args, C, K)
        got = tc.compress_presorted(*shuffled, C, K, sort_b=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("width", [2, 32, 128])
def test_bitonic_sort_desc_plain_matches_numpy(width):
    """_bitonic_sort_desc_plain against a numpy descending sort of
    distinct keys: +inf empties first, weights following their keys."""
    rng = np.random.default_rng(width)
    rows = 9
    key = rng.permutation(rows * width).reshape(rows, width)
    key = (key + rng.random((rows, width))).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (rows, width)).astype(np.float32)
    dead = rng.random((rows, width)) < 0.3
    key[dead], w[dead] = np.inf, 0.0
    got_k, got_w = tc._bitonic_sort_desc_plain(torch.from_numpy(key),
                                               torch.from_numpy(w))
    order = np.argsort(-key, axis=1, kind="stable")
    want_k = np.take_along_axis(key, order, 1)
    want_w = np.take_along_axis(w, order, 1)
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    np.testing.assert_array_equal(got_w.numpy(), want_w)
    assert np.isinf(got_k.numpy()[dead.any(1), 0]).all()


# --- the merge width: compression 1000 (K=1008, L=2048) --------------------

C_WIDE = 1000.0
K_WIDE = jtd.size_bound(C_WIDE)


def test_wide_plain_matches_xla_rung():
    """compress_presorted_plain and drain_quantile_plain at compression
    1000 (K=1008, half=1024, L=2048) against the JAX package's XLA rung
    (_compress, then quantile): per-row mass rtol 1e-6 and quantiles
    within 0.02 x (max - min), the ROADMAP's cross-rung tolerances."""
    rng = np.random.default_rng(43)
    s = 12
    ma, wa = _sorted_centroids(rng, s, K_WIDE, 30.0, 0.6)
    mb, wb = _temp_half(rng, s, K_WIDE, 25.0, 0.5)
    mn, mx = _extrema(ma, wa, mb, wb)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (ma, wa, mb, wb)]
    pm, pw = tc.compress_presorted_plain(*t, C_WIDE, K_WIDE)
    _, dw, pq = tc.drain_quantile_plain(
        *t, torch.from_numpy(mn), torch.from_numpy(mx), torch.from_numpy(QS),
        C_WIDE, K_WIDE)
    torch.testing.assert_close(dw, pw, rtol=0, atol=0)
    jm, jw = jtd._compress(jnp.concatenate([jnp.asarray(ma),
                                            jnp.asarray(mb)], 1),
                           jnp.concatenate([jnp.asarray(wa),
                                            jnp.asarray(wb)], 1),
                           C_WIDE, K_WIDE)
    jq = np.asarray(jtd.quantile(jtd.TDigest(jm, jw, jnp.asarray(mn),
                                             jnp.asarray(mx)), QS))
    mass = wa.astype(np.float64).sum(1) + wb.astype(np.float64).sum(1)
    np.testing.assert_allclose(pw.numpy().astype(np.float64).sum(1), mass,
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jw, np.float64).sum(1), mass,
                               rtol=1e-6)
    assert (pm.numpy()[:, 1:] >= pm.numpy()[:, :-1]).all()
    span = (mx - mn)[:, None]
    assert (np.abs(pq.numpy() - jq) <= 0.02 * span).all()


def test_kernel_input_check_takes_compression_1000():
    """The kernel path's input check no longer refuses the merge width of
    compression 1000 (L=2048); only widths past the general path's
    shared memory (L > 4096) are refused."""
    z = torch.zeros((4, K_WIDE))
    s, _, half, m = tc._shapes(z, z)
    assert 2 * half == 2048
    tc._check_kernel_inputs(z, z, z, z, K_WIDE, m, half)
    huge = torch.zeros((4, 4097))
    s, _, half, m = tc._shapes(huge, huge)
    with pytest.raises(ValueError, match="merge width"):
        tc._check_kernel_inputs(huge, huge, huge, huge, 4097, m, half)


# --- the narrow merge widths 16 and 32: the tiered pool's compaction -------

# case -> (Ka, Kb, compression, out_size, inputs): the pool's K=16 at
# compression 14 (tier_pool_centroids 16, merge width 32) and K=8 at 6
# (tier_pool_centroids 8, width 16); halves of unequal width; out_size
# below the half; and inputs with all-dead rows, one live centroid a
# row, and the a half gap-filled as tiered._pool_compact builds it
NARROW_CASES = {
    "k16": (16, 16, 14.0, 16, "random"),
    "k8": (8, 8, 6.0, 8, "random"),
    "k16_kb9": (16, 9, 14.0, 16, "random"),
    "k8_kb5": (8, 5, 6.0, 8, "random"),
    "k16_out12": (16, 16, 14.0, 12, "random"),
    "k8_out5": (8, 8, 6.0, 5, "random"),
    "k16_dead_rows": (16, 16, 14.0, 16, "dead_rows"),
    "k8_single_centroid": (8, 8, 6.0, 8, "single"),
    "k16_gap_filled": (16, 16, 14.0, 16, "gap_filled"),
}


def _narrow_inputs(case: str, sort_b: bool, s: int = 37):
    """Seeded halves for a NARROW_CASES case on an odd row count: the a
    half ascending, the b half ascending with +inf empties last, or with
    sort_b in a random order per row."""
    ka, kb, _, _, how = NARROW_CASES[case]
    rng = np.random.default_rng(sorted(NARROW_CASES).index(case))
    ma, wa = _sorted_centroids(rng, s, ka, 30.0, 0.6)
    mb, wb = _temp_half(rng, s, kb, 25.0, 0.5)
    if how == "dead_rows":
        ma[::4], wa[::4], mb[::4], wb[::4] = np.inf, 0.0, np.inf, 0.0
    elif how == "single":
        ma[:], wa[:], mb[:], wb[:] = np.inf, 0.0, np.inf, 0.0
        ma[:, 0] = rng.gamma(2.0, 30.0, s)
        wa[:, 0] = rng.integers(1, 5, s)
    elif how == "gap_filled":
        # dead slots: -inf before the first live one, the running max after
        ma = np.maximum.accumulate(np.where(wa > 0, ma, -np.inf), axis=1)
    if sort_b:
        perm = np.argsort(rng.random((s, kb)), axis=1)
        mb, wb = (np.take_along_axis(a, perm, 1) for a in (mb, wb))
    return [np.ascontiguousarray(a, np.float32) for a in (ma, wa, mb, wb)]


@pytest.mark.parametrize("sort_b", [False, True],
                         ids=["presorted", "sort_b"])
@pytest.mark.parametrize("kernel", ["drain_quantile", "compress_presorted"])
@pytest.mark.parametrize("case", list(NARROW_CASES))
def test_narrow_plain_matches_pallas_interpret(case, kernel, sort_b):
    """K1 and K2 at merge widths 32 and 16, presorted and with sort_b:
    the port's plain versions (what the narrow CUDA path is held to on
    the card) against the Pallas kernels with interpret=True, at the
    file's tolerances."""
    ma, wa, mb, wb = _narrow_inputs(case, sort_b)
    _, _, c, kout, _ = NARROW_CASES[case]
    half = tc.next_pow2(max(ma.shape[1], mb.shape[1]))
    assert tc.kernel_path(half, kout) == "narrow"
    if kernel == "drain_quantile":
        mn, mx = _extrema(ma, wa, mb, wb)
        port, ref = _both(ma, wa, mb, wb, mn, mx, c=c, k=kout,
                          sort_b=sort_b)
        _assert_match(port, ref, wa, wb, mn, mx)
    else:
        port, ref = _both(ma, wa, mb, wb, c=c, k=kout, sort_b=sort_b)
        _assert_match(port, ref, wa, wb)
    assert port[0].shape == (ma.shape[0], kout)


@pytest.mark.parametrize("half,out_size,path", [
    (4, 4, "general"), (8, 8, "narrow"), (16, 12, "narrow"),
    (16, 17, "general"), (32, 32, "warp"), (128, 104, "warp"),
    (256, 256, "general"), (1024, 1008, "general")])
def test_kernel_path_by_shape(half, out_size, path):
    """The device path a shape takes, as csrc's launch_rows picks it: the
    narrow path at half 8 and 16, the warp path at 32 to 128, the general
    path for the rest and for out_size > half."""
    assert tc.kernel_path(half, out_size) == path
