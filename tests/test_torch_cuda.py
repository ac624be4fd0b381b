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


# merge width L -> (compression, K): L=16 and 32 (the tiered pool's
# compaction, PK = 8 at compression 6 and PK = 16 at 14) run the narrow
# path, L=64, 128 and 256 the warp path (one instance each), L=2048
# (compression 1000) the general block path
WIDTHS = {16: (6.0, 8), 32: (14.0, 16), 64: (20.0, 24), 128: (50.0, 56),
          256: (100.0, 104), 2048: (1000.0, 1008)}


@pytest.mark.parametrize("sort_b", [False, True])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_cuda_kernel_widths_match_plain(cuda, width, sort_b):
    """K1 and K2, presorted and with sort_b (K3), at merge widths 16, 32,
    64, 128, 256 and 2048 against their plain versions; each call is one
    counted launch, and K2's ran the kernel of the path that
    tdigest_cuda.kernel_path names for its shape."""
    c, k = WIDTHS[width]
    rng = np.random.default_rng(width + sort_b)
    rows = 4099 if width <= 256 else 515
    ma = np.sort(rng.gamma(2.0, 30.0, (rows, k)).astype(np.float32), 1)
    wa = ((rng.random((rows, k)) < 0.6)
          * rng.integers(1, 5, (rows, k))).astype(np.float32)
    mb = rng.gamma(2.0, 25.0, (rows, k)).astype(np.float32)
    wb = ((rng.random((rows, k)) < 0.5)
          * rng.integers(1, 5, (rows, k))).astype(np.float32)
    mb = np.where(wb > 0, mb, np.inf).astype(np.float32)
    if not sort_b:
        order = np.argsort(mb, axis=1, kind="stable")
        mb, wb = (np.take_along_axis(a, order, 1) for a in (mb, wb))
    mn = np.minimum(np.where(wa > 0, ma, np.inf).min(1),
                    np.where(wb > 0, mb, np.inf).min(1)).astype(np.float32)
    mx = np.maximum(np.where(wa > 0, ma, -np.inf).max(1),
                    np.where(wb > 0, mb, -np.inf).max(1)).astype(np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (ma, wa, mb, wb, mn, mx, QS)]
    counter = "sort_b_launches" if sort_b else "launches"
    before = (getattr(tc.drain_quantile, counter),
              getattr(tc.compress_presorted, counter))
    got = [t.cpu().numpy()
           for t in tc.drain_quantile(*args, c, k, sort_b=sort_b)]
    want = [t.cpu().numpy()
            for t in tc.drain_quantile_plain(*args, c, k, sort_b=sort_b)]
    _assert_match(got, want, wa, wb, mn, mx)
    got = [t.cpu().numpy()
           for t in tc.compress_presorted(*args[:4], c, k, sort_b=sort_b)]
    # the launch ran the kernel of the path kernel_path names
    kernel = {"narrow": "narrow_rows_kernel", "warp": "warp_rows_kernel",
              "general": "block_rows_kernel"}[tc.kernel_path(width // 2, k)]
    assert kernel in tc.last_kernel_name()
    want = [t.cpu().numpy() for t in tc.compress_presorted_plain(
        *args[:4], c, k, sort_b=sort_b)]
    _assert_match(got, want, wa, wb)
    assert (getattr(tc.drain_quantile, counter),
            getattr(tc.compress_presorted, counter)) == (before[0] + 1,
                                                         before[1] + 1)


def test_k1_on_a_bf16_upcast_slab_matches_plain(cuda):
    """The slab store's flush program on a bfloat16 slab: the digest
    planes upcast to float32 (core/slab.py _flush_slab), the temp half
    sorted, K1 against its plain version on the same tensors."""
    from veneur_tpu_torch.core import slab

    rng = np.random.default_rng(37)
    rows = 4099
    ma, wa, mb, wb, mn, mx = _halves(rng, rows, dead_means=True)
    ma = torch.from_numpy(ma).to(torch.bfloat16).float().numpy()
    wa = torch.from_numpy(wa).to(torch.bfloat16).float().numpy()
    digest = slab._init_digest_slab(rows, K, torch.bfloat16, cuda)
    digest.mean.copy_(torch.from_numpy(ma).reshape(-1).to(cuda))
    digest.weight.copy_(torch.from_numpy(wa).reshape(-1).to(cuda))
    temp = slab._init_temp_slab(rows, K, cuda)
    # the temp bins: (sum_w, sum_wm) whose means are mb where live
    temp.sum_w.copy_(torch.from_numpy(wb).reshape(-1).to(cuda))
    temp.sum_wm.copy_(torch.from_numpy(
        (wb * np.where(wb > 0, mb, 0.0)).astype(np.float32)).reshape(-1)
        .to(cuda))
    temp.vmin.copy_(torch.from_numpy(mn).to(cuda))
    temp.vmax.copy_(torch.from_numpy(mx).to(cuda))
    qs = torch.from_numpy(QS).to(cuda)
    calls = []
    real = tc.launch_drain_quantile

    def capture(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    tc.launch_drain_quantile = capture
    try:
        before = tc.drain_quantile.launches
        slab._flush_slab(digest, temp, qs, rows, C)
        assert tc.drain_quantile.launches == before + 1
    finally:
        tc.launch_drain_quantile = real
    (args, out), = calls
    assert args[0].dtype == torch.float32
    want = [t.cpu().numpy() for t in tc.drain_quantile_plain(*args)]
    got = [t.cpu().numpy() for t in out]
    _assert_match(got, want, args[1].cpu().numpy(), args[3].cpu().numpy(),
                  args[4].cpu().numpy(), args[5].cpu().numpy())


def test_pool_compact_matches_plain(cuda):
    """The tiered pool's compaction (K2 at merge width 32) on the card
    against its plain version on the same pool, and the CPU's run."""
    from veneur_tpu_torch.core import tiered
    from veneur_tpu_torch.ops import tdigest as td

    rng = np.random.default_rng(41)
    rows, pk = 4099, 16
    pool = tiered._init_pool_slab(rows, pk, "cpu")
    m = np.sort(rng.gamma(2.0, 30.0, (rows, pk)), 1).astype(np.float32)
    w = ((rng.random((rows, pk)) < 0.5)
         * rng.integers(1, 9, (rows, pk))).astype(np.float32)
    mq, wb, fmin, fmax = td.quantize_centroids(
        torch.from_numpy(np.where(w > 0, m, np.inf).astype(np.float32)),
        torch.from_numpy(w))
    for plane, v in ((pool.mq, mq.reshape(-1)), (pool.wb, wb.reshape(-1)),
                     (pool.fmin, fmin), (pool.fmax, fmax)):
        plane.copy_(v)
    sel = rng.random((rows, pk)) < 0.4
    bw = np.where(sel, rng.integers(1, 5, (rows, pk)), 0).astype(np.float32)
    pool.bw.copy_(torch.from_numpy(bw.reshape(-1)))
    pool.bwm.copy_(torch.from_numpy(
        (bw * rng.gamma(2.0, 30.0, (rows, pk))).astype(np.float32)
        .reshape(-1)))
    card = tiered.PoolSlab(*(p.to(cuda) for p in pool))
    before = (tc.compress_presorted.launches,
              tc.compress_presorted.narrow32_launches)
    got = [t.cpu().numpy() for t in tiered._pool_compact(card, rows, pk,
                                                         14.0)]
    # one launch, on the narrow path
    assert (tc.compress_presorted.launches,
            tc.compress_presorted.narrow32_launches) == (before[0] + 1,
                                                         before[1] + 1)
    want = [t.numpy() for t in tiered._pool_compact(pool, rows, pk, 14.0)]
    wa = td.dequantize_centroids(pool.mq.view(rows, pk),
                                 pool.wb.view(rows, pk), pool.fmin,
                                 pool.fmax)[1].numpy()
    _assert_match(got, want, wa, bw)


def _narrow_halves(rng, rows, k, sort_b):
    """Halves for the narrow path: means in [0, 100) (one float32 ulp at
    most 7.6e-6 there), small integer weights, every 7th row dead and
    some single-centroid rows; the b half ascending with +inf empties
    last, or with sort_b in a random order a row."""
    ma = np.sort(rng.uniform(0.0, 100.0, (rows, k)), 1)
    wa = (rng.random((rows, k)) < 0.5) * rng.integers(1, 5, (rows, k))
    mb = rng.uniform(0.0, 100.0, (rows, k))
    wb = (rng.random((rows, k)) < 0.4) * rng.integers(1, 5, (rows, k))
    wa[::7], wb[::7] = 0, 0
    wa[3::11], wb[3::11] = 0, 0
    wa[3::11, 0] = 2
    ma = np.where(wa > 0, ma, np.inf)
    mb = np.where(wb > 0, mb, np.inf)
    if not sort_b:
        order = np.argsort(mb, axis=1, kind="stable")
        mb, wb = (np.take_along_axis(a, order, 1) for a in (mb, wb))
    mn = np.minimum(np.where(wa > 0, ma, np.inf).min(1),
                    np.where(wb > 0, mb, np.inf).min(1))
    mx = np.maximum(np.where(wa > 0, ma, -np.inf).max(1),
                    np.where(wb > 0, mb, -np.inf).max(1))
    return [np.ascontiguousarray(a, np.float32)
            for a in (ma, wa, mb, wb, mn, mx)]


def _on_card(a: np.ndarray, cuda, layout: str) -> torch.Tensor:
    """A [rows, k] plane on the card: contiguous, strided (a row stride
    of k + 3, so no 8- or 16-byte accesses) or unaligned (one float past
    a 16-byte boundary)."""
    t = torch.from_numpy(a).to(cuda)
    rows, k = a.shape
    if layout == "strided":
        wide = torch.full((rows, k + 3), float("nan"), device=cuda)
        wide[:, :k] = t
        return wide[:, :k]
    if layout == "unaligned":
        flat = torch.full((rows * k + 1,), float("nan"), device=cuda)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(rows, k)
    return t


@pytest.mark.parametrize("layout", ["contiguous", "strided", "unaligned"])
@pytest.mark.parametrize("sort_b", [False, True], ids=["presorted",
                                                       "sort_b"])
@pytest.mark.parametrize("width", [16, 32])
def test_narrow_kernel_matches_plain(cuda, width, sort_b, layout):
    """K1 and K2 on the narrow path (merge widths 16 and 32) against
    their plain versions on the same card tensors, at 4,099 rows (not a
    multiple of the rows a block or a warp holds) with dead rows and
    single-centroid rows: bin liveness identical, row mass exact, live
    weights and means rtol 1e-5 and within 1.526e-5 absolute (the plain
    version's scatter-adds may round a bin's sum an ulp apart),
    percentiles within 1e-4 x span; each call one launch on the narrow
    counter of its width."""
    c, k = WIDTHS[width]
    rng = np.random.default_rng(1000 + width + 2 * sort_b)
    ma, wa, mb, wb, mn, mx = _narrow_halves(rng, 4099, k, sort_b)
    planes = [_on_card(a, cuda, layout) for a in (ma, wa, mb, wb)]
    extra = [torch.from_numpy(a).to(cuda) for a in (mn, mx, QS)]
    counter = f"narrow{width}_launches"
    mass = wa.astype(np.float64).sum(1) + wb.astype(np.float64).sum(1)
    for fn, plain, args in (
            (tc.drain_quantile, tc.drain_quantile_plain, planes + extra),
            (tc.compress_presorted, tc.compress_presorted_plain, planes)):
        before = getattr(fn, counter)
        got = [t.cpu().numpy() for t in fn(*args, c, k, sort_b=sort_b)]
        assert getattr(fn, counter) == before + 1
        assert "narrow_rows_kernel" in tc.last_kernel_name()
        want = [t.cpu().numpy()
                for t in plain(*args, c, k, sort_b=sort_b)]
        if fn is tc.drain_quantile:
            _assert_match(got, want, wa, wb, mn, mx)
        else:
            _assert_match(got, want, wa, wb)
        np.testing.assert_array_equal(got[1].astype(np.float64).sum(1),
                                      mass)
        live = want[1] > 0
        for g, w in zip(got[:2], want[:2]):
            assert np.abs(g[live] - w[live]).max(initial=0.0) <= 1.526e-5


def test_general_path_keeps_its_shapes(cuda):
    """Merge width 2048 and out_size > half stay on the general path:
    each call counts one general launch and no narrow one, and matches
    its plain version."""
    rng = np.random.default_rng(53)
    for c, ka, kout, rows in ((1000.0, 1008, 1008, 65), (14.0, 16, 20, 999)):
        ma, wa, mb, wb, mn, mx = _narrow_halves(rng, rows, ka, False)
        args = [torch.from_numpy(a).to(cuda) for a in (ma, wa, mb, wb)]
        counts = [(fn.general_launches, fn.narrow16_launches,
                   fn.narrow32_launches)
                  for fn in (tc.drain_quantile, tc.compress_presorted)]
        extra = [torch.from_numpy(a).to(cuda) for a in (mn, mx, QS)]
        got = [t.cpu().numpy()
               for t in tc.drain_quantile(*args, *extra, c, kout)]
        want = [t.cpu().numpy()
                for t in tc.drain_quantile_plain(*args, *extra, c, kout)]
        _assert_match(got, want, wa, wb, mn, mx)
        got = [t.cpu().numpy() for t in tc.compress_presorted(*args, c, kout)]
        assert "block_rows_kernel" in tc.last_kernel_name()
        want = [t.cpu().numpy()
                for t in tc.compress_presorted_plain(*args, c, kout)]
        _assert_match(got, want, wa, wb)
        assert [(fn.general_launches, fn.narrow16_launches,
                 fn.narrow32_launches)
                for fn in (tc.drain_quantile, tc.compress_presorted)] == [
            (g + 1, n16, n32) for g, n16, n32 in counts]


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
        rows, _ = store.flush([0.5, 0.99], aggs, 0)
        out.append({(m.name, tuple(m.tags)): m.value
                    for m in rows.to_intermetrics()})
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


def _local_to_global(dev, monkeypatch, rows=512):
    """Two locals on ``dev`` (A: 4 samples a series from gamma(2, 10), B
    the same shifted by +1000, weight 2) forward their state through
    the JSON body into a global on ``dev``, which flushes once. Returns
    the global's drained digests and percentiles (host numpy) and its
    emitted rows."""
    import json

    from veneur_tpu_torch.core import store as tstore
    from veneur_tpu_torch.forward.convert import (apply_json_metric_list,
                                                  json_metrics_from_state)
    from veneur_tpu_torch.samplers.parser import MetricKey

    rng = np.random.default_rng(41)
    aggs = HistogramAggregates.from_names(["min", "max", "count"])
    pcts = [0.1, 0.5, 0.99]
    bodies = []
    for shift in (0.0, 1000.0):
        loc = MetricStore(chunk=256, device=dev)
        h = loc.histograms
        for i in range(rows):
            h.interner.intern(MetricKey(f"h.{i}", "histogram", ""), [])
        h.ensure_capacity(rows - 1)
        vals = (shift + rng.gamma(2.0, 10.0, (rows, 4))).astype(np.float32)
        with loc._lock:
            h.sample_many(np.repeat(np.arange(rows, dtype=np.int32), 4),
                          vals.reshape(-1), np.full(rows * 4, 2.0,
                                                    np.float32))
        for i in range(0, rows, 8):
            loc.process_metric(parse_metric(
                f"c.{i}:{i}|c|#veneurglobalonly".encode()))
            loc.process_metric(parse_metric(f"s.{i}:m{shift + i}|s".encode()))
        _, fwd = loc.flush(pcts, aggs, 0, is_local=True)
        fwd.materialize_digests()
        bodies.append(json.loads(json.dumps(json_metrics_from_state(fwd))))
    glob = MetricStore(chunk=256, device=dev)
    k2 = tc.compress_presorted.launches
    for body in bodies:
        assert apply_json_metric_list(glob, body)[1] == 0
    with glob._lock:
        glob.histograms._drain_staging()
    if dev.type == "cuda":
        assert tc.compress_presorted.launches > k2  # the guard drained
    drained = []
    real = tstore._flush_digests

    def capture(*args):
        out = real(*args)
        drained.append(out[:2])
        return out

    monkeypatch.setattr(tstore, "_flush_digests", capture)
    out = glob.flush(pcts, aggs, 0)[0].to_intermetrics()
    monkeypatch.setattr(tstore, "_flush_digests", real)
    d, p = drained[0]
    n = rows
    host = [t[:n].cpu().numpy() for t in (d.mean, d.weight, d.min, d.max)]
    return host + [p[:n, :-1].cpu().numpy()], out


def test_local_to_global_on_cuda_matches_cpu(cuda, monkeypatch):
    """The global-aggregation path on the card (K1 on each local's and
    the global's flush, K2 on the global's import guard drain) against
    the same path on the CPU (the plain versions): the merged digests'
    bin liveness identical, conserved mass (rtol 1e-6, 16 a row), live
    bins rtol 1e-5, percentiles within 1e-4 x span, and every compared
    value within 1e-4 absolute, as the kernels are held; emitted
    counters and set estimates exact."""
    k1 = tc.drain_quantile.launches
    got, got_rows = _local_to_global(cuda, monkeypatch)
    assert tc.drain_quantile.launches >= k1 + 3   # two locals, one global
    want, want_rows = _local_to_global(torch.device("cpu"), monkeypatch)
    gm, gw, gmin, gmax, gp = got
    pm, pw, pmin, pmax, pp = want
    np.testing.assert_allclose(gw.sum(1), 16.0, rtol=1e-6)
    live = pw > 0
    np.testing.assert_array_equal(gw > 0, live)
    np.testing.assert_array_equal(gmin, pmin)
    np.testing.assert_array_equal(gmax, pmax)
    np.testing.assert_allclose(gw[live], pw[live], rtol=1e-5)
    np.testing.assert_allclose(gm[live], pm[live], rtol=1e-5)
    span = (pmax - pmin)[:, None]
    assert (np.abs(gp - pp) <= 1e-4 * span).all()
    worst = max(np.abs(gw[live] - pw[live]).max(),
                np.abs(gm[live] - pm[live]).max(), np.abs(gp - pp).max())
    assert worst <= 1e-4, worst
    by = lambda rows: {m.name: m.value for m in rows
                       if not m.name.endswith("percentile")}
    assert by(got_rows) == by(want_rows)


def test_ingest_lane_on_cuda_matches_cpu(cuda):
    """A 4,096-series cut of chip_smoke.py's ingest traffic (8 samples a
    series, the last four shifted, so the guard drains through K2)
    through one ingest lane: into a CPU store it emits exactly what the
    per-line path emits, and into a store on the card its merged digests
    agree with the CPU lane's as the kernels agree with their plain
    versions (chip_smoke.ingest_twin raises otherwise)."""
    import chip_smoke

    k1, k2 = tc.drain_quantile.launches, tc.compress_presorted.launches
    rec = chip_smoke.ingest_twin(cuda)
    assert tc.compress_presorted.launches > k2
    assert tc.drain_quantile.launches > k1
    assert rec["cpu_twin_emissions"] == 4096 * 6 + 128 + 2 * 64
    assert rec["cpu_twin_max_abs_err"] <= 1e-4


def test_ssf_server_on_cuda_matches_cpu(cuda):
    """A 4,096-series cut of chip_smoke.py's SSF traffic (16 samples a
    span, every span an indicator span, STATUS samples on the slow lane,
    events and service checks over statsd): the Python UDP rung, the
    UNIX stream and the native lane emit identical rows on the CPU, and
    the native lane and the UNIX stream into a Server on the card agree
    with them, percentiles within 1e-4 x (max - min) (chip_smoke.ssf_twin
    raises otherwise). K2 and K1 run on the card."""
    import chip_smoke

    k1, k2 = tc.drain_quantile.launches, tc.compress_presorted.launches
    rec = chip_smoke.ssf_twin(cuda)
    assert tc.compress_presorted.launches > k2
    assert tc.drain_quantile.launches > k1
    assert rec["cuda_twin_pct_err_of_span"] <= 1e-4
    # histograms and 128 timers x 6 rows, counters, gauges, sets,
    # status rows (SSF STATUS samples and service checks)
    assert rec["cpu_twin_emissions"] == (4096 + 128) * 6 + 3 * 64 + 16 + 8


@pytest.mark.parametrize("lanes,rung", [(0, "lanes"), (-1, "native")])
def test_cli_server_listener_on_cuda(cuda, tmp_path, lanes, rung):
    """``python -m veneur_tpu_torch.cli.server -f config.yaml`` on the
    card: the UDP listener is the lane fleet by default and the C++
    reader pool with ``ingest_lanes: -1``; a counter sent over UDP comes
    out of the final flush in the debug sink."""
    import os
    import signal
    import socket
    import subprocess
    import sys
    import time

    pytest.importorskip("yaml", reason="the CLI reads YAML configs")
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    cfg = tmp_path / "config.yaml"
    cfg.write_text(f"statsd_listen_addresses: ['udp://127.0.0.1:{port}']\n"
                   f"interval: 3600s\ningest_lanes: {lanes}\n"
                   "debug_flushed_metrics: true\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "veneur_tpu_torch.cli.server", "-f",
         str(cfg)], cwd=root, stderr=subprocess.PIPE, text=True)
    try:
        lines = []
        deadline = time.time() + 120
        while not any("Starting server" in ln for ln in lines):
            assert proc.poll() is None and time.time() < deadline, lines
            lines.append(proc.stderr.readline())
        assert f"'{rung}')" in lines[-1], lines[-1]
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
            tx.sendto(b"cli.count:3|c\ncli.count:4|c|@0.5",
                      ("127.0.0.1", port))
        time.sleep(1.0)
        proc.send_signal(signal.SIGTERM)
        _, out = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    assert "name='cli.count'" in out and "value=11.000000" in out, out


def test_heavy_hitters_on_cuda_match_cpu(cuda):
    """The same veneurtopk lines into a store on the card and one on the
    CPU: the count-min state lives on the card, and the ``.topk`` rows
    match exactly (the table sums integer counts, exact in float32 below
    2^24 in any order, and the candidate selection uses stable sorts on
    both devices). A Server built without a device puts it there too."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.server import Server

    rng = np.random.default_rng(43)
    w = 1.0 / np.arange(1, 301) ** 1.1
    draws = rng.choice(300, 20000, p=w / w.sum())
    owners = rng.integers(0, 64, 20000)
    lines = [f"hh.{o}:u{d}|s|#veneurtopk".encode()
             for o, d in zip(owners.tolist(), draws.tolist())]
    out = []
    for dev in (cuda, torch.device("cpu")):
        store = MetricStore(chunk=1024, device=dev)
        for ln in lines:
            store.process_metric(parse_metric(ln))
        store.heavy_hitters._drain_samples()
        assert store.heavy_hitters.sketch.table.device.type == dev.type
        rows, _ = store.flush([], HistogramAggregates.from_names(["count"]),
                              0)
        out.append({(m.name, tuple(m.tags)): m.value
                    for m in rows.to_intermetrics()})
    assert len(out[1]) > 500 and out[0] == out[1]
    server = Server(Config(hostname="t"))
    assert server.store.heavy_hitters.sketch.table.device.type == "cuda"
    assert server.store.counters.max_series == 1 << 20


def test_columnar_flush_on_cuda_matches_per_row(cuda):
    """The default flush shape on the card: a pipelined columnar flush
    of a store on cuda emits, through to_intermetrics, exactly the rows
    its per-row flush of the same lines does (the same device, the same
    kernels); the blocks are host numpy arrays."""
    from veneur_tpu_torch.core.columnar import ColumnarFlush

    rng = np.random.default_rng(37)
    lines = [f"h.{i}:{rng.gamma(2.0, 10.0):.5f}|h" for i in range(300)
             for _ in range(8)]
    lines += [f"c.{i}:{i}|c" for i in range(50)]
    lines += [f"s.{i}:m{i % 7}|s" for i in range(50)]
    aggs = HistogramAggregates.from_names(["min", "max", "count"])
    out = []
    for columnar in (False, True):
        store = MetricStore(chunk=512, device=cuda)
        for ln in lines:
            store.process_metric(parse_metric(ln.encode()))
        final, _ = store.flush([0.5, 0.99], aggs, 0, columnar=columnar)
        assert isinstance(final, ColumnarFlush)
        assert bool(final.blocks) == columnar
        assert all(isinstance(b.values, np.ndarray) for b in final.blocks)
        out.append(sorted((m.name, tuple(m.tags), m.type.value, m.value)
                          for m in final.to_intermetrics()))
    assert out[0] == out[1] and len(out[0]) == 300 * 5 + 100


def test_pack_on_cuda_matches_cpu(cuda):
    """The forward path's on-device pack (core/slab.py) on the card
    equals its CPU run bit for bit: counts, prefix planes and the
    fetched live centroids, through both fetch strategies."""
    from veneur_tpu_torch.core import slab

    rng = np.random.default_rng(41)
    for heavy in (False, True):
        ma, wa, _mb, _wb, mn, mx = _halves(rng, 4096, dead_means=True)
        wa = np.where(rng.random(wa.shape) < 0.1, wa, 0).astype(np.float32)
        if heavy:
            wa[5] = 1.0
        planes = [torch.from_numpy(a) for a in (ma, wa, mn, mx)]
        cpu = slab._pack_slab(*planes)
        card = slab._pack_slab(*(p.to(cuda) for p in planes))
        for got, want in zip(card, cpu):
            assert torch.equal(got.cpu(), want)
        for got, want in zip(slab._fetch_packed(*card, 4000),
                             slab._fetch_packed(*cpu, 4000)):
            np.testing.assert_array_equal(got, want)


def test_native_forward_on_cuda_matches_cpu(cuda):
    """A port local on the card packs, encodes and sends MetricList
    frames over loopback TCP to a port global on the card: its rows
    equal the same pair's on the CPU (percentiles within 1e-4 x span)."""
    from veneur_tpu_torch.forward.native_transport import (
        NativeForwarder, NativeImportServer)

    rng = np.random.default_rng(42)
    lines = [f"n.h.{i % 300}:{rng.gamma(2.0, 10.0):.4f}|h".encode()
             for i in range(3000)]
    lines += [f"n.c.{i}:{i}|c|#veneurglobalonly".encode() for i in range(9)]
    lines += [f"n.s.{i % 7}:m{i}|s".encode() for i in range(200)]
    aggs = HistogramAggregates.from_names(["min", "max", "count"])
    out = {}
    for dev in ("cpu", cuda):
        local = MetricStore(chunk=512, device=dev)
        glob = MetricStore(chunk=512, device=dev)
        for line in lines:
            local.process_metric(parse_metric(line))
        state = local.flush([0.5, 0.99], aggs, 0, is_local=True,
                            columnar=True, digest_format="packed")[1]
        srv = NativeImportServer(glob)
        srv.start("127.0.0.1:0")
        fwd = NativeForwarder(f"native://127.0.0.1:{srv.port}", timeout=5.0)
        try:
            assert fwd.forward(state) is True
        finally:
            fwd.close()
            srv.stop()
        assert srv.import_errors == 0 and srv.received == 300 + 9 + 7
        out[str(dev)] = {(m.name, m.type.value): m.value for m in
                         glob.flush([0.5, 0.99], aggs, 0)[0]
                         .to_intermetrics()}
    got, want = out[str(cuda)], out["cpu"]
    assert set(got) == set(want) and len(want) == 2 * 300 + 9 + 7
    for key, value in want.items():
        if "percentile" in key[0]:
            assert abs(got[key] - value) <= 1e-4 * 60, key
        else:
            assert got[key] == value, key


def test_kernel_fault_on_cuda_requeues_then_emits(cuda):
    """The compute ladder on the card: a flush whose kernel fails at
    preflight launches nothing (no plain version runs on the CUDA
    tensors), re-merges the interval into the live store, and the next
    flush emits it through K1 with the counts, sums and extrema of a
    store that never failed, and its percentiles within 0.02 of the
    span (the checkpoint round trip's bound)."""
    from veneur_tpu_torch.resilience.compute import ComputeBreaker
    from veneur_tpu_torch.resilience.faults import FaultInjector

    rng = np.random.default_rng(37)
    lines = [f"h.{i}:{v:.5f}|h".encode() for i in range(300)
             for v in rng.gamma(2.0, 10.0, 24)]
    breaker = ComputeBreaker()
    breaker.injector = FaultInjector(rate=1.0, kinds=("connect",),
                                     scope="compute.tdigest_merge")
    faulted = MetricStore(chunk=512, device=cuda, compute=breaker)
    clean = MetricStore(chunk=512, device=cuda)
    for store in (faulted, clean):
        for ln in lines:
            store.process_metric(parse_metric(ln))
    aggs = HistogramAggregates.from_names(["min", "max", "count", "sum"])
    pcts = [0.01, 0.25, 0.5, 0.75, 0.99]

    def rows(store):
        flushed, _ = store.flush(pcts, aggs, 0)
        return {m.name: m.value for m in flushed.to_intermetrics()}

    k1 = tc.drain_quantile.launches
    assert rows(faulted) == {}
    torch.cuda.synchronize()
    assert tc.drain_quantile.launches == k1
    assert breaker.requeued_total == 1 and breaker.lost_total == 0
    breaker.injector = None
    got, want = rows(faulted), rows(clean)
    assert tc.drain_quantile.launches == k1 + 2
    assert set(got) == set(want)
    for i in range(300):
        span = want[f"h.{i}.max"] - want[f"h.{i}.min"]
        for suffix in (".count", ".min", ".max"):
            assert got[f"h.{i}{suffix}"] == want[f"h.{i}{suffix}"]
        assert got[f"h.{i}.sum"] == pytest.approx(want[f"h.{i}.sum"],
                                                  rel=1e-6)
        for p in ("1", "25", "50", "75", "99"):
            name = f"h.{i}.{p}percentile"
            assert abs(got[name] - want[name]) <= 0.02 * span, name


def test_snapshot_on_cuda_holds_state_after_ingest(cuda):
    """A snapshot begun on the card and fetched after more ingest (in
    place on the temp planes, the extrema and the registers) holds the
    state of its begin: the device copies, not views."""
    rng = np.random.default_rng(43)
    lines = []
    for i in range(64):
        lines += [f"h.{i}:{v:.5f}|h" for v in rng.gamma(2.0, 10.0, 12)]
        lines += [f"s.{i}:m{int(rng.integers(0, 40))}|s" for _ in range(8)]
        lines += [f"k.{i}:x{int(rng.integers(0, 9))}|s|#veneurtopk"
                  for _ in range(8)]
    store = MetricStore(chunk=256, device=cuda, topk_width=1 << 10)
    for ln in lines:
        store.process_metric(parse_metric(ln.encode()))
    want, _ = store.snapshot_state()
    with store._lock:
        begun = {name: getattr(store, name).snapshot_begin()
                 for name in store._GEN_GROUPS}
    for ln in lines:
        store.process_metric(parse_metric(ln.encode()))
    with store._lock:
        for name in ("histograms", "sets", "heavy_hitters"):
            getattr(store, name)._drain_staging()
    for name, (snap, finish) in begun.items():
        if finish is not None:
            finish()
        for k, v in want[name].items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(snap[k], v,
                                              err_msg=f"{name}.{k}")
            else:
                assert snap[k] == v, (name, k)


def _ascending_digests(rng, s):
    """Two batches of row-ascending digests as the kernels leave them:
    gap slots weigh 0 with running-max means, a few rows empty (+inf)."""
    out = []
    for scale in (30.0, 25.0):
        m = np.sort(rng.gamma(2.0, scale, (s, K)).astype(np.float32), 1)
        w = ((rng.random((s, K)) < 0.6) * rng.integers(1, 5, (s, K)))
        w = w.astype(np.float32)
        m = np.maximum.accumulate(np.where(w > 0, m, -np.inf), axis=1)
        m[::97], w[::97] = np.inf, 0.0
        out += [m, w]
    return [np.ascontiguousarray(a, np.float32) for a in out]


def test_butterfly_k2_with_both_halves_ascending(cuda):
    """tdigest.merge, the butterfly's round: K2 with both halves
    ascending at K = 104 (sort_b off; the kernel reverses b itself),
    against the plain version on the same tensors; and a 4 x 2 mesh's
    merge_forwarded_digests on the card against the CPU's."""
    from veneur_tpu_torch.ops import tdigest as td
    from veneur_tpu_torch.parallel import fleet_mesh
    from veneur_tpu_torch.parallel.global_agg import GlobalAggregator

    rng = np.random.default_rng(61)
    ma, wa, mb, wb = _ascending_digests(rng, 4100)
    inf = np.full(4100, np.inf, np.float32)
    a = td.TDigest(*(torch.from_numpy(x).to(cuda) for x in (ma, wa, inf,
                                                            -inf)))
    b = td.TDigest(*(torch.from_numpy(x).to(cuda) for x in (mb, wb, inf,
                                                            -inf)))
    k2, k3 = tc.compress_presorted.launches, \
        tc.compress_presorted.sort_b_launches
    got = td.merge(a, b, C)
    assert tc.compress_presorted.launches == k2 + 1
    assert tc.compress_presorted.sort_b_launches == k3
    want = tc.compress_presorted_plain(a.mean, a.weight, b.mean, b.weight,
                                       C, K)
    _assert_match([got.mean.cpu().numpy(), got.weight.cpu().numpy()],
                  [t.cpu().numpy() for t in want], wa, wb)
    mean, weight = np.stack([ma, mb]), np.stack([wa, wb])
    mins, maxs = np.stack([inf, inf]), np.stack([-inf, -inf])
    out = []
    for dev in (cuda, torch.device("cpu")):
        agg = GlobalAggregator(fleet_mesh([dev] * 8, hosts=2), 4100)
        d = agg.merge_forwarded_digests(mean, weight, mins, maxs)
        out.append([d.mean.cpu().numpy(), d.weight.cpu().numpy()])
    _assert_match(out[0], out[1], wa, wb)


def test_mesh_store_on_cuda_matches_cpu(cuda):
    """A 4 x 2 mesh store on the card against the same mesh store on the
    CPU: the guard and import drains (K2) and the flush (K1, one launch
    over the shard-blocked plane a group) on the card, their plain
    versions on the CPU; the tolerances of test_store_on_cuda_matches_cpu."""
    from veneur_tpu_torch.parallel import fleet_mesh

    rng = np.random.default_rng(67)
    lines = []
    for i in range(300):
        for _ in range(12):
            lines.append(f"h.{i}:{rng.gamma(2.0, 10.0):.5f}|h|@0.5")
        lines.append(f"c.{i}:{i}|c")
        lines.append(f"s.{i % 40}:m{int(rng.integers(0, 30))}|s")
    for i in range(300):   # a step the shift guard drains through K2
        lines.extend(f"h.{i}:{500 + rng.gamma(2.0, 10.0):.5f}|h|@0.5"
                     for _ in range(4))
    aggs = HistogramAggregates.from_names(["min", "max", "count", "sum"])
    out = []
    for dev in (cuda, torch.device("cpu")):
        k1, k2 = tc.drain_quantile.launches, tc.compress_presorted.launches
        store = MetricStore(chunk=512, mesh=fleet_mesh([dev] * 8, hosts=2))
        for ln in lines:
            store.process_metric(parse_metric(ln.encode()))
        rows, _ = store.flush([0.5, 0.99], aggs, 0)
        if dev.type == "cuda":
            assert tc.compress_presorted.launches > k2
            assert tc.drain_quantile.launches == k1 + 1
        assert store.compute.requeued_total == store.compute.lost_total == 0
        out.append({(m.name, tuple(m.tags)): m.value
                    for m in rows.to_intermetrics()})
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
