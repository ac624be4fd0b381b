"""The port on the card: CUDA kernels against their plain versions, and
the store on cuda against the store on the CPU.

These tests need a CUDA device and skip without one. They import
neither jax nor veneur_tpu, so they run on a machine with PyTorch and a
GPU alone; the repository's conftest imports jax, so run them there as

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: the kernels share the plain versions' arithmetic (the same
log-step prefix sums and asin polynomial, no fused multiply-add), so bin
liveness is identical; only the order of the per-bin sums differs, hence
per-row mass rtol 1e-6, live bin weights and means rtol 1e-5, and
percentiles within 1e-4 x (max - min).
"""

import numpy as np
import pytest
import torch

from veneur_tpu_torch.core.store import MetricStore
from veneur_tpu_torch.ops import tdigest_cuda as tc
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates
from veneur_tpu_torch.samplers.parser import parse_metric

C = 100.0
K = 104
QS = np.array([0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 0.5],
              np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _halves(rng, s, dead_means=False):
    ma = np.sort(rng.gamma(2.0, 30.0, (s, K)).astype(np.float32), axis=1)
    wa = (rng.random((s, K)) < 0.6) * rng.integers(1, 5, (s, K))
    wa = wa.astype(np.float32)
    if dead_means:   # -inf before the first live slot, running max after
        ma = np.maximum.accumulate(np.where(wa > 0, ma, -np.inf), axis=1)
    mb = np.sort(rng.gamma(2.0, 25.0, (s, K)).astype(np.float32), axis=1)
    wb = ((rng.random((s, K)) < 0.5) * rng.integers(1, 5, (s, K)))
    wb = wb.astype(np.float32)
    mb = np.where(wb > 0, mb, np.inf)
    order = np.argsort(mb, axis=1, kind="stable")
    mb, wb = np.take_along_axis(mb, order, 1), np.take_along_axis(wb, order,
                                                                  1)
    mn = np.minimum(np.where(wa > 0, ma, np.inf).min(1),
                    np.where(wb > 0, mb, np.inf).min(1))
    mx = np.maximum(np.where(wa > 0, ma, -np.inf).max(1),
                    np.where(wb > 0, mb, -np.inf).max(1))
    return [np.ascontiguousarray(a, np.float32)
            for a in (ma, wa, mb, wb, mn, mx)]


def _assert_match(got, want, wa, wb, mn=None, mx=None):
    gm, gw = got[0], got[1]
    pm, pw = want[0], want[1]
    mass = wa.astype(np.float64).sum(1) + wb.astype(np.float64).sum(1)
    np.testing.assert_allclose(gw.sum(1), mass, rtol=1e-6)
    live = pw > 0
    np.testing.assert_array_equal(gw > 0, live)
    np.testing.assert_allclose(gw[live], pw[live], rtol=1e-5)
    np.testing.assert_allclose(gm[live], pm[live], rtol=1e-5)
    if mn is not None:
        gp, pp = got[2], want[2]
        np.testing.assert_array_equal(np.isnan(gp), np.isnan(pp))
        span = np.where(np.isfinite(mx - mn), mx - mn, 0.0)[:, None]
        ok = np.isnan(pp) | (np.abs(gp - pp) <= 1e-4 * span + 1e-6)
        assert ok.all()


@pytest.mark.parametrize("dead_means", [False, True])
def test_cuda_kernels_match_plain(cuda, dead_means):
    rng = np.random.default_rng(23)
    arrays = _halves(rng, 4099, dead_means)
    arrays[0][:3], arrays[1][:3] = np.inf, 0.0      # empty digest halves
    arrays[2][:2], arrays[3][:2] = np.inf, 0.0      # two empty rows
    ma, wa, mb, wb, mn, mx = arrays
    args = [torch.from_numpy(a).to(cuda) for a in (*arrays, QS)]
    before = (tc.drain_quantile.launches, tc.compress_presorted.launches)
    got = [t.cpu().numpy() for t in tc.drain_quantile(*args, C, K)]
    want = [t.cpu().numpy() for t in tc.drain_quantile_plain(*args, C, K)]
    _assert_match(got, want, wa, wb, mn, mx)
    got = [t.cpu().numpy() for t in tc.compress_presorted(*args[:4], C, K)]
    want = [t.cpu().numpy()
            for t in tc.compress_presorted_plain(*args[:4], C, K)]
    _assert_match(got, want, wa, wb)
    assert (tc.drain_quantile.launches,
            tc.compress_presorted.launches) == (before[0] + 1,
                                                before[1] + 1)


def test_cuda_kernels_small_widths(cuda):
    """A narrow digest (merge width below one warp) and a wide one."""
    rng = np.random.default_rng(29)
    for k, c in ((8, 6.0), (400, 398.0)):
        ma = np.sort(rng.gamma(2.0, 10.0, (33, k)).astype(np.float32), 1)
        wa = rng.integers(0, 3, (33, k)).astype(np.float32)
        mb = np.sort(rng.gamma(2.0, 10.0, (33, k)).astype(np.float32), 1)
        wb = np.ones((33, k), np.float32)
        args = [torch.from_numpy(a).to(cuda) for a in (ma, wa, mb, wb)]
        got = [t.cpu().numpy() for t in tc.compress_presorted(*args, c, k)]
        want = [t.cpu().numpy()
                for t in tc.compress_presorted_plain(*args, c, k)]
        _assert_match(got, want, wa, wb)


def test_store_on_cuda_matches_cpu(cuda):
    """The same lines into a store on the card and a store on the CPU:
    the card's path runs K1/K2, the CPU's their plain versions. Counters,
    set estimates, count/min/max exact; sums rtol 1e-6; percentiles
    within 1e-3 x span, since ingest binning on the card adds in another
    order (atomic scatter-adds) and takes its float64 arcsine from
    another library, so a sample near a bin edge may bin differently."""
    rng = np.random.default_rng(31)
    lines = []
    for i in range(200):
        for _ in range(16):
            lines.append(f"h.{i}:{rng.gamma(2.0, 10.0):.5f}|h|@0.5")
        lines.append(f"c.{i}:{i}|c")
        lines.append(f"s.{i}:m{int(rng.integers(0, 30))}|s")
    for i in range(200):   # a step the shift guard drains through K2
        lines.extend(f"h.{i}:{500 + rng.gamma(2.0, 10.0):.5f}|h|@0.5"
                     for _ in range(4))
    aggs = HistogramAggregates.from_names(["min", "max", "count", "sum"])
    out = []
    k2 = tc.compress_presorted.launches
    for dev in (cuda, torch.device("cpu")):
        store = MetricStore(chunk=512, device=dev)
        for ln in lines:
            store.process_metric(parse_metric(ln.encode()))
        rows = store.flush([0.5, 0.99], aggs, 0)
        out.append({(m.name, tuple(m.tags)): m.value for m in rows})
    assert tc.compress_presorted.launches > k2
    got, want = out
    assert set(got) == set(want)
    for key, value in want.items():
        name = key[0]
        if name.endswith("percentile"):
            base = name.rpartition(".")[0]
            span = want[(base + ".max", ())] - want[(base + ".min", ())]
            assert abs(got[key] - value) <= 1e-3 * span + 1e-6, key
        elif name.endswith(".sum"):
            np.testing.assert_allclose(got[key], value, rtol=1e-6)
        else:
            assert got[key] == value, key
