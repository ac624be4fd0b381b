#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (veneur_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (nvcc, sm_90a), then runs three
phases, each printing one JSON line:

  kernels  K1 drain_quantile and K2 compress_presorted at the flush's
           shape (1,048,576 rows, K=104, the store's 9 quantiles), each
           held against its plain PyTorch version on the card and timed
           beside its memory bound;
  store    a MetricStore on cuda with 1,048,576 histogram series x 8
           samples (the second half of the interval steps the
           distribution, so the shift guard drains through K2) and 32,768
           HLL sets at p=14, then one flush through K1;
  server   the UDP Server with a channel sink: datagrams of every ported
           type, one flush, rows checked against what was sent.

It ends with the kernel summary, the card's name and power limit, and
{"ok": true, "device": {...}} as the last line. Any failed check raises
and the script exits non-zero; without a CUDA device it exits 2 before
printing any result. It imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import socket
import subprocess
import sys
import time

import numpy as np

SEED = 20261017
ROWS = 1 << 20                   # histogram series (README "Scale")
SAMPLES_PER_SERIES = 8
SET_SERIES = 1 << 15
PERCENTILES = (0.01, 0.10, 0.25, 0.50, 0.75, 0.90, 0.95, 0.99)
COMPRESSION = 100.0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM non-tensor fp32 peak
TIMED_LAUNCHES = 20
PLAIN_RUNS = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _median_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _random_halves(rows: int, k: int, dev, gen):
    """Two row-ascending centroid halves like the flush sees: the digest
    half ~60% live, the temp half ~50% live with +inf empties last."""
    import torch

    def half(scale, frac):
        mean = torch.sort(torch.empty((rows, k), device=dev)
                          .exponential_(1.0 / scale, generator=gen), 1).values
        live = torch.rand((rows, k), device=dev, generator=gen) < frac
        w = torch.randint(1, 5, (rows, k), device=dev, generator=gen,
                          dtype=torch.int32).float() * live
        return mean, w

    ma, wa = half(30.0, 0.6)
    mb, wb = half(25.0, 0.5)
    mb = torch.where(wb > 0, mb, math.inf)
    mb, order = torch.sort(mb, 1)
    wb = torch.gather(wb, 1, order)
    big = torch.finfo(torch.float32).max
    mn = torch.minimum(torch.where(wa > 0, ma, big).amin(1),
                       torch.where(wb > 0, mb, big).amin(1))
    mx = torch.maximum(torch.where(wa > 0, ma, -big).amax(1),
                       torch.where(wb > 0, mb, -big).amax(1))
    return ma, wa, mb, wb, mn, mx


def _compare(name, got, want, wa, wb, span=None) -> float:
    """Kernel vs plain: per-row mass rtol 1e-6, identical bin liveness,
    live bin weights and means rtol 1e-5 (the same arithmetic; only the
    order of the per-bin sums differs), percentiles within 1e-4 x span.
    Returns the largest absolute difference over the compared values."""
    import torch

    gm, gw = got[0], got[1]
    pm, pw = want[0], want[1]
    mass = wa.double().sum(1) + wb.double().sum(1)
    mass_err = ((gw.double().sum(1) - mass).abs()
                / mass.clamp_min(1e-30)).max().item()
    if mass_err > 1e-6:
        raise AssertionError(f"{name}: row mass off by {mass_err:.3g}")
    live = pw > 0
    if not torch.equal(gw > 0, live):
        raise AssertionError(f"{name}: bin liveness differs from plain")
    dw, dm = (gw - pw).abs()[live], (gm - pm).abs()[live]
    w_err = (dw / pw[live].abs().clamp_min(1e-30)).max().item()
    m_err = (dm / pm[live].abs().clamp_min(1e-30)).max().item()
    if w_err > 1e-5 or m_err > 1e-5:
        raise AssertionError(f"{name}: live bins off (w {w_err:.3g}, "
                             f"mean {m_err:.3g})")
    worst = max(dw.max().item(), dm.max().item())
    if span is not None:
        gp, pp = got[2], want[2]
        if not torch.equal(torch.isnan(gp), torch.isnan(pp)):
            raise AssertionError(f"{name}: NaN percentiles differ")
        dp = torch.nan_to_num((gp - pp).abs(), nan=0.0)
        p_err = (dp / span[:, None].clamp_min(1e-30)).max().item()
        if p_err > 1e-4:
            raise AssertionError(f"{name}: percentiles off by {p_err:.3g} "
                                 "of the row span")
        worst = max(worst, dp.max().item())
    return worst


def phase_kernels(dev, rows: int = ROWS):
    """Both kernels at the flush's shape against their plain versions."""
    import torch

    from veneur_tpu_torch.ops import tdigest as td
    from veneur_tpu_torch.ops import tdigest_cuda as tc

    k = td.size_bound(COMPRESSION)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ma, wa, mb, wb, mn, mx = _random_halves(rows, k, dev, gen)
    qs = torch.tensor(list(PERCENTILES) + [0.5], dtype=torch.float32,
                      device=dev)
    span = (mx - mn).float()

    got = tc.drain_quantile(ma, wa, mb, wb, mn, mx, qs, COMPRESSION, k)
    want = tc.drain_quantile_plain(ma, wa, mb, wb, mn, mx, qs, COMPRESSION,
                                   k)
    torch.cuda.synchronize()
    k1_err = _compare("drain_quantile", got, want, wa, wb, span)
    got2 = tc.compress_presorted(ma, wa, mb, wb, COMPRESSION, k)
    want2 = tc.compress_presorted_plain(ma, wa, mb, wb, COMPRESSION, k)
    torch.cuda.synchronize()
    k2_err = _compare("compress_presorted", got2, want2, wa, wb)
    del got, want, got2, want2

    # kernel-layout inputs, so the timing covers the kernel alone
    s, _, half, m = tc._shapes(ma, mb)
    mb_rev, wb_rev = tc._prepare_b(mb, wb, half)
    nq = qs.shape[0]
    k1_ms = _median_ms(lambda: tc.launch_drain_quantile(
        ma, wa, mb_rev, wb_rev, mn, mx, qs, COMPRESSION, k, m),
        TIMED_LAUNCHES)
    k2_ms = _median_ms(lambda: tc.launch_compress_presorted(
        ma, wa, mb_rev, wb_rev, COMPRESSION, k, m), TIMED_LAUNCHES)
    k1_wrap_ms = _median_ms(lambda: tc.drain_quantile(
        ma, wa, mb, wb, mn, mx, qs, COMPRESSION, k), TIMED_LAUNCHES)
    k2_wrap_ms = _median_ms(lambda: tc.compress_presorted(
        ma, wa, mb, wb, COMPRESSION, k), TIMED_LAUNCHES)
    k1_plain_ms = _median_ms(lambda: tc.drain_quantile_plain(
        ma, wa, mb, wb, mn, mx, qs, COMPRESSION, k), PLAIN_RUNS, warmup=1)
    k2_plain_ms = _median_ms(lambda: tc.compress_presorted_plain(
        ma, wa, mb, wb, COMPRESSION, k), PLAIN_RUNS, warmup=1)

    # the least the card could take: every input byte of the function
    # read once and every output byte written once, against HBM. The b
    # half counts at its own width kb: the +inf padding to `half` is a
    # cost of the kernel's design, not work the function needs. And the
    # kernel's arithmetic against the fp32 peak. Operations per row,
    # counted from the algorithm: L*log2(L) merge compare-selects,
    # m*ceil(log2 m) scan adds, ~24 binning flops and 2 reduce adds per
    # merged slot, and for K1 the quantile pass (3 log-step scans over K
    # plus P*K compares).
    L = 2 * half
    kb = mb.shape[1]
    f32 = 4
    k2_bytes = f32 * s * (2 * k + 2 * kb + 2 * k)
    k1_bytes = k2_bytes + f32 * (2 * s + nq + s * nq)
    k2_ops = s * (L * int(math.log2(L)) + m * math.ceil(math.log2(m))
                  + 26 * m)
    k1_ops = k2_ops + s * (3 * k * math.ceil(math.log2(k)) + nq * k)

    def bound(nbytes, ops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                           "operations")

    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    result = {
        "drain_quantile": {
            "ms": k1_ms, "wrapper_ms": k1_wrap_ms, "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound, "bound_by": k1_by, "bytes": k1_bytes,
            "ops": k1_ops, "max_abs_err": k1_err},
        "compress_presorted": {
            "ms": k2_ms, "wrapper_ms": k2_wrap_ms, "plain_ms": k2_plain_ms,
            "bound_ms": k2_bound, "bound_by": k2_by, "bytes": k2_bytes,
            "ops": k2_ops, "max_abs_err": k2_err},
    }
    emit({"phase": "kernels", "rows": s, "k": k, "half": half, "nq": nq,
          **{f"{n}_{key}": v for n, r in result.items()
             for key, v in r.items()}})
    return result


def _digest_reference(samples: np.ndarray, qs) -> np.ndarray:
    """Quantiles of a merging t-digest whose centroids are exactly these
    equal-weight samples (merging_digest.go:297-354), in float64 numpy."""
    x = np.sort(samples.astype(np.float64))
    n = len(x)
    ub = np.append((x[:-1] + x[1:]) / 2.0, x[-1])
    out = []
    for q in qs:
        target = q * n
        i = min(int(np.searchsorted(np.arange(1, n + 1), target)), n - 1)
        lb = x[0] if i == 0 else max(ub[i - 1], x[0])
        out.append(lb + (target - i) * (ub[i] - lb))
    return np.array(out)


def _hll_reference(hashes: np.ndarray, p: int) -> float:
    """Classic HLL estimate of one set's uint64 hashes in numpy (float64):
    register = max(leading zeros of the low 64-p bits + 1)."""
    m = 1 << p
    idx = (hashes >> np.uint64(64 - p)).astype(np.int64)
    rest = (hashes << np.uint64(p)).astype(np.uint64)
    rho = np.full(len(hashes), 64 - p + 1, np.int64)
    nz = rest != 0
    lz = 63 - np.floor(np.log2(rest[nz].astype(np.float64))).astype(np.int64)
    # float64 log2 can round up just below a power of two: fix it exactly
    top = np.uint64(1) << (np.uint64(63) - lz.astype(np.uint64))
    lz = np.where(rest[nz] < top, lz + 1, lz)
    rho[nz] = np.minimum(lz + 1, 64 - p + 1)
    regs = np.zeros(m, np.int64)
    np.maximum.at(regs, idx, rho)
    alpha = 0.7213 / (1 + 1.079 / m)
    est = alpha * m * m / np.sum(np.exp2(-regs.astype(np.float64)))
    zeros = int((regs == 0).sum())
    if est <= 2.5 * m and zeros > 0:
        return m * math.log(m / zeros)
    return est


def phase_store(dev, rows: int = ROWS, set_series: int = SET_SERIES,
                chunk: int = 1 << 14):
    """The dense store at deployment size: ingest (K2 on the guard drain)
    and one flush (K1). Returns the launch counts of this phase."""
    import torch

    from veneur_tpu_torch.core.store import MetricStore
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.samplers.intermetric import HistogramAggregates
    from veneur_tpu_torch.samplers.parser import MetricKey

    rng = np.random.default_rng(SEED)
    torch.cuda.reset_peak_memory_stats(dev)
    store = MetricStore(initial_capacity=1024, chunk=chunk, device=dev)
    hist, sets = store.histograms, store.sets
    t0 = time.perf_counter()
    for i in range(rows):
        hist.interner.intern(MetricKey(f"h.{i}", "histogram", ""), [])
    hist.ensure_capacity(rows - 1)
    for i in range(set_series):
        sets.interner.intern(MetricKey(f"s.{i}", "set", ""), [])
    sets.ensure_capacity(set_series - 1)
    intern_s = time.perf_counter() - t0

    # 8 samples per series at sample rate 0.5 (weight 2): four from a
    # gamma(2, 10) distribution, then four from one shifted past its
    # support by +1000, row-major so each chunk carries whole rows
    half = SAMPLES_PER_SERIES // 2
    early = rng.gamma(2.0, 10.0, (rows, half)).astype(np.float32)
    late = (1000.0 + rng.gamma(2.0, 10.0, (rows, half))).astype(np.float32)
    row_ids = np.repeat(np.arange(rows, dtype=np.int32), half)
    wts = np.full(rows * half, 2.0, np.float32)
    set_card = rng.integers(100, 3001, set_series)
    set_rows = np.repeat(np.arange(set_series, dtype=np.int32), set_card)
    set_hashes = rng.integers(0, np.iinfo(np.uint64).max, len(set_rows),
                              dtype=np.uint64, endpoint=True)

    # where the flush's time goes: the histogram group's dispatch (host
    # enqueue; CUDA events around it give the device time of the flush
    # program), its collect (device->host fetch) and the per-row
    # InterMetric emission, timed around the store's own methods
    spans = {"dispatch_s": 0.0, "collect_s": 0.0, "emit_s": 0.0}
    events = []

    def timed(name, fn, record=False):
        def run(*args, **kwargs):
            t = time.perf_counter()
            if record:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            try:
                return fn(*args, **kwargs)
            finally:
                if record:
                    events.append(torch.cuda.Event(enable_timing=True))
                    events[-1].record()
                spans[name] += time.perf_counter() - t
        return run

    hist._flush_dispatch = timed("dispatch_s", hist._flush_dispatch, True)
    hist._flush_collect = timed("collect_s", hist._flush_collect)
    store._emit_digest_result = timed("emit_s", store._emit_digest_result)

    tc.drain_quantile.launches = 0
    tc.compress_presorted.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with store._lock:
        hist.sample_many(row_ids, early.reshape(-1), wts)
        hist.sample_many(row_ids, late.reshape(-1), wts)
        hist._drain_samples()
    torch.cuda.synchronize()
    hist_ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with store._lock:
        sets.sample_many(set_rows, set_hashes)
        sets._drain_samples()
    torch.cuda.synchronize()
    set_ingest_s = time.perf_counter() - t0
    k2_ingest = tc.compress_presorted.launches
    k1_ingest = tc.drain_quantile.launches

    t0 = time.perf_counter()
    final = store.flush(list(PERCENTILES),
                        HistogramAggregates.from_names(["min", "max",
                                                        "count"]), 0)
    flush_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    flush_program_ms = events[0].elapsed_time(events[1])
    k1 = tc.drain_quantile.launches
    k2 = tc.compress_presorted.launches
    peak = torch.cuda.max_memory_allocated(dev)
    if k2_ingest < 1 or k1_ingest != 0:
        raise AssertionError(f"ingest launched K2 {k2_ingest}x, K1 "
                             f"{k1_ingest}x; want K2 >= 1, K1 0")
    if k1 < 1:
        raise AssertionError("the flush did not launch K1")

    by = {(m.name): m.value for m in final}
    expect_rows = rows * (3 + len(PERCENTILES)) + set_series
    if len(final) != expect_rows:
        raise AssertionError(f"{len(final)} rows flushed, want "
                             f"{expect_rows}")
    # With 8 samples a series' digest holds every sample as its own
    # centroid, so its percentiles are known exactly: the check holds
    # them to that. Their rank error against np.quantile is reported, not
    # bounded: at n=8 the two interpolation rules alone differ by several
    # hundredths of rank, more than the 0.02 a large-n digest keeps.
    pick = rng.choice(rows, min(512, rows), replace=False)
    worst = rank_worst = 0.0
    for i in pick:
        samples = np.concatenate([early[i], late[i]])
        got = np.array([by[f"h.{i}.{int(p * 100)}percentile"]
                        for p in PERCENTILES])
        want = _digest_reference(samples, PERCENTILES)
        span = float(samples.max() - samples.min())
        err = float(np.max(np.abs(got - want))) / span
        worst = max(worst, err)
        srt = np.sort(samples.astype(np.float64))
        ranks = np.interp(got, srt, np.linspace(0.0, 1.0, len(srt)))
        rank_worst = max(rank_worst, float(np.max(np.abs(
            ranks - np.array(PERCENTILES)))))
        if by[f"h.{i}.count"] != 2.0 * SAMPLES_PER_SERIES \
                or by[f"h.{i}.min"] != samples.min() \
                or by[f"h.{i}.max"] != samples.max():
            raise AssertionError(f"h.{i}: count/min/max wrong")
    if worst > 1e-3:
        raise AssertionError(f"percentiles off the exact digest by "
                             f"{worst:.3g} of the span")
    est = np.array([by[f"s.{i}"] for i in range(set_series)])
    rel = np.abs(est - set_card) / set_card
    starts = np.concatenate([[0], np.cumsum(set_card)])
    ref_err = 0.0
    for i in rng.choice(set_series, min(512, set_series), replace=False):
        ref = _hll_reference(set_hashes[starts[i]:starts[i + 1]],
                             store.hll_precision)
        ref_err = max(ref_err, abs(est[i] - ref) / ref)
    # 1e-4: the port rounds m/zeros to float32 before the log, as the JAX
    # package does; at ~100 members that alone moves the estimate ~1e-5
    if ref_err > 1e-4:
        raise AssertionError(f"set estimates off the numpy HLL by "
                             f"{ref_err:.3g}")
    if np.percentile(rel, 99) > 0.02 or rel.max() > 0.05:
        raise AssertionError(f"set estimates too far from the true "
                             f"cardinality: p99 {np.percentile(rel, 99):.3g}"
                             f", max {rel.max():.3g}")
    emit({"phase": "store", "histogram_series": rows,
          "samples": int(2 * len(row_ids)), "set_series": set_series,
          "set_members": int(len(set_rows)), "chunk": chunk,
          "intern_s": intern_s, "histogram_ingest_s": hist_ingest_s,
          "set_ingest_s": set_ingest_s, "flush_s": flush_s,
          "flush_program_device_ms": flush_program_ms, **spans,
          "rows_flushed": len(final),
          "max_memory_allocated": int(peak),
          "launches": {"drain_quantile": k1, "compress_presorted": k2},
          "pct_err_vs_exact_digest": worst,
          "rank_err_vs_np_quantile_max": rank_worst,
          "set_err_vs_numpy_hll": ref_err,
          "set_rel_err_p50": float(np.median(rel)),
          "set_rel_err_p99": float(np.percentile(rel, 99))})
    return {"drain_quantile": k1, "compress_presorted": k2}


def phase_server(dev, series: int = 300, lines_per_series: int = 12):
    """The UDP server end to end with a channel sink."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink

    rng = np.random.default_rng(SEED + 1)
    sink = ChannelMetricSink()
    cfg = Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                 interval="3600s", percentiles=[0.5, 0.99],
                 aggregates=["min", "max", "count"], hostname="smoke")
    server = Server(cfg, metric_sinks=[sink], device=dev)
    counters, hists, members = {}, {}, {}
    lines = []
    kinds = ("c", "g", "h", "ms", "s")
    for n in range(lines_per_series):
        for i in range(series):
            kind = kinds[i % len(kinds)]
            scope = ("", "|#veneurlocalonly", "|#veneurglobalonly",
                     "|#env:smoke")[(i // len(kinds)) % 4]
            name = f"srv.{kind}.{i}"
            if kind == "c":
                v = int(rng.integers(1, 10))
                counters[name] = counters.get(name, 0) + v
                lines.append(f"{name}:{v}|c{scope}")
            elif kind == "g":
                lines.append(f"{name}:{n}|g{scope}")
            elif kind in ("h", "ms"):
                v = float(rng.gamma(2.0, 10.0))
                hists.setdefault(name, []).append(np.float32(v))
                lines.append(f"{name}:{v!r}|{kind}{scope}")
            else:
                member = f"m{rng.integers(0, 50)}"
                members.setdefault(name, set()).add(member)
                lines.append(f"{name}:{member}|s{scope}")
    tc.drain_quantile.launches = 0
    tc.compress_presorted.launches = 0
    server.start()
    try:
        port = server.statsd_addrs[0][1]
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
            for i in range(0, len(lines), 8):
                tx.sendto("\n".join(lines[i:i + 8]).encode(),
                          ("127.0.0.1", port))
                if i % 512 == 0:
                    time.sleep(0.002)
        deadline = time.time() + 60
        while server.store.processed < len(lines):
            if time.time() > deadline:
                raise AssertionError(f"server processed "
                                     f"{server.store.processed} of "
                                     f"{len(lines)} lines")
            time.sleep(0.05)
        server.flush()
        rows = sink.get_flush(timeout=60)
    finally:
        server.shutdown()
    k1 = tc.drain_quantile.launches
    if k1 < 1:
        raise AssertionError("the server flush did not launch K1")
    by = {}
    for m in rows:
        by.setdefault(m.name, []).append(m)
    types = {}
    for m in rows:
        kind = m.name.split(".")[1]
        types[kind] = types.get(kind, 0) + 1
    per_kind = series // len(kinds)
    want = {"c": per_kind, "g": per_kind, "s": per_kind,
            "h": per_kind * 5, "ms": per_kind * 5}
    if types != want:
        raise AssertionError(f"rows per type {types}, want {want}")
    for name, total in counters.items():
        if [m.value for m in by[name]] != [float(total)]:
            raise AssertionError(f"{name}: counter {by[name]} != {total}")
    for name, vals in hists.items():
        lo, hi = min(vals), max(vals)
        for suffix in ("50percentile", "99percentile"):
            v = by[f"{name}.{suffix}"][0].value
            if not lo <= v <= hi:
                raise AssertionError(f"{name}.{suffix} {v} outside "
                                     f"[{lo}, {hi}]")
        if by[f"{name}.count"][0].value != len(vals):
            raise AssertionError(f"{name}.count wrong")
    for name, ms in members.items():
        if abs(by[name][0].value - len(ms)) > 0.02 * len(ms) + 0.5:
            raise AssertionError(f"{name}: estimate {by[name][0].value} vs "
                                 f"{len(ms)} members")
    emit({"phase": "server", "lines": len(lines), "rows_flushed": len(rows),
          "rows_per_type": types,
          "launches": {"drain_quantile": k1,
                       "compress_presorted": tc.compress_presorted.launches},
          "packet_errors": server.packet_errors})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and has no CPU mode", file=sys.stderr)
        return 2
    try:
        from veneur_tpu_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    # no TF32 anywhere: every comparison on the card is in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    logs = cuda_build.build()
    ptxas = [ln.strip() for text in logs.values()
             for ln in text.splitlines() if "registers" in ln or "smem" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(logs), "ptxas": ptxas})
    card = card_line()
    kern = phase_kernels(dev)
    launches = phase_store(dev)
    phase_server(dev)
    rows = []
    for name, src_line in (("drain_quantile", 334),
                           ("compress_presorted", 419)):
        k = kern[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "veneur_tpu_torch/csrc/tdigest_merge.cu",
            "replaces": f"veneur_tpu/ops/tdigest_pallas.py:{src_line}",
            "launches": launches[name], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
