"""t-digest accuracy sweep: the reference's ``tdigest/analysis`` role
("compare the accuracy of the t-digest implementation across
distributions", emitting CSVs for offline study), on the port.

It measures QUANTILE RANK ERROR, the distance from q to the exact
empirical-CDF rank interval of the digest's estimate, of the port's
t-digest pipeline beside the scalar golden model
(``samplers/scalar.py``), across:

* distributions: uniform, normal, lognormal, pareto, and adversarially
  ORDERED arrival (ascending / descending);
* compressions: 50 / 100 / 200 (200 takes the kernels' general path:
  208 slots, merge width 512);
* merge depths (the production paths):
    - ``chunks1``   one :func:`~veneur_tpu_torch.ops.tdigest.merge_samples`
      call (the library path at temp-buffer granularity,
      merging_digest.go:111-132);
    - ``chunks16``  16 sequential ``merge_samples`` compressions;
    - ``binned16``  the SERVER path: 16 shift-guarded bin scatters
      (``ingest_chunk_guarded``, K2 on a guard drain) + ONE
      ``drain_temp`` (K2) an interval;
    - ``binned4x4`` four intervals of 4 chunks each, digests accumulating
      across drains;
    - ``fanin8``    8 per-host digests combined with ``merge`` (K2): the
      global import depth (samplers.go:657-691);
* storage dtypes: float32, and bfloat16 with a round trip of every
  digest's mean and weight after every step, as ``core/slab.py``'s
  bfloat16 planes do.

The sample data comes from ``np.random.default_rng(seed)`` exactly as the
JAX package's sweep draws it, so both packages see the same values. The
rank error is computed in one vectorized pass a cell (each row sorted
once, ``torch.searchsorted`` for both sides of the rank interval), so a
cell runs at thousands of rows on the card.

Run: ``python -m veneur_tpu_torch.analysis.tdigest_sweep [--quick]
[--rows 16] [--n 4096] [--device cpu] [--out sweep.csv]``. It runs on
``cuda`` unless ``--device cpu`` is given.

The reference's test envelope is eps=0.02 (``tdigest/histo_test.go:11-25``)
for direct adds at its temp-buffer granularity, the ``chunks1`` and
``fanin8`` regimes here; chunked arrival against an evolving value range
(``binned16`` with ordered arrival) is a harder regime the reference
never measures, reported as measured.
"""

from __future__ import annotations

import argparse
import csv
import io
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from veneur_tpu_torch.device import resolve_device
from veneur_tpu_torch.ops import tdigest as td
from veneur_tpu_torch.samplers.scalar import ScalarTDigest

QS = (0.01, 0.05, 0.25, 0.50, 0.75, 0.90, 0.95, 0.99, 0.999)

DISTS = ("uniform", "normal", "lognormal", "pareto",
         "sorted_asc", "sorted_desc")
COMPRESSIONS = (50.0, 100.0, 200.0)
PATHS = ("chunks1", "chunks16", "binned16", "binned4x4", "fanin8")
DTYPES = ("float32", "bfloat16")


def sample_dist(dist: str, rng: np.random.Generator,
                shape) -> np.ndarray:
    if dist == "uniform":
        v = rng.uniform(0.0, 100.0, shape)
    elif dist == "normal":
        v = rng.normal(100.0, 15.0, shape)
    elif dist == "lognormal":
        v = rng.lognormal(3.0, 1.0, shape)
    elif dist == "pareto":
        v = (rng.pareto(2.0, shape) + 1.0) * 10.0
    elif dist == "sorted_asc":
        v = np.sort(rng.normal(100.0, 15.0, shape), axis=-1)
    elif dist == "sorted_desc":
        v = -np.sort(-rng.normal(100.0, 15.0, shape), axis=-1)
    else:
        raise ValueError(dist)
    return v.astype(np.float32)


def rank_err(true_sorted: np.ndarray, v: float, q: float) -> float:
    """Distance from q to the closed rank interval [F(v-), F(v)] of v
    under the exact empirical CDF (ties handled by the interval)."""
    n = len(true_sorted)
    lo = np.searchsorted(true_sorted, v, "left") / n
    hi = np.searchsorted(true_sorted, v, "right") / n
    return max(0.0, lo - q, q - hi)


def rank_errors(vals: torch.Tensor, pcts: torch.Tensor,
                qs=QS) -> torch.Tensor:
    """:func:`rank_err` of every row and quantile at once: vals [R, N]
    samples, pcts [R, P] estimates. Returns float64 [R, P]."""
    n = vals.shape[-1]
    srt = torch.sort(vals, dim=-1).values.contiguous()
    est = pcts.to(srt.dtype).contiguous()
    lo = torch.searchsorted(srt, est, side="left").double() / n
    hi = torch.searchsorted(srt, est, side="right").double() / n
    q = torch.as_tensor(qs, dtype=torch.float64, device=vals.device)
    return torch.clamp_min(torch.maximum(lo - q, q - hi), 0.0)


def _bf16_roundtrip(digest: td.TDigest) -> td.TDigest:
    return digest._replace(
        mean=digest.mean.to(torch.bfloat16).float(),
        weight=digest.weight.to(torch.bfloat16).float())


def cell_samples(dist: str, rows: int = 16, n: int = 4096, seed: int = 0,
                 device=None) -> torch.Tensor:
    """A cell's samples [rows, n] on the device, drawn on the host as the
    JAX package draws them. Every path, dtype and compression of a
    distribution shares them."""
    vals = sample_dist(dist, np.random.default_rng(seed), (rows, n))
    return torch.from_numpy(vals).to(resolve_device(device))


def cell_digest(dist: str, compression: float, path: str, dtype: str,
                rows: int = 16, n: int = 4096, seed: int = 0,
                device=None) -> Tuple[torch.Tensor, td.TDigest]:
    """One sweep cell's samples [rows, n] (on the device) and the digest
    its path builds from them."""
    vals = cell_samples(dist, rows, n, seed, device)
    return vals, build_digest(vals, compression, path, dtype)


def build_digest(vals: torch.Tensor, compression: float, path: str,
                 dtype: str) -> td.TDigest:
    """The digest a path builds from a cell's samples, on their device."""
    dev = vals.device
    rows, n = vals.shape
    k = td.size_bound(compression)

    def storage(d):
        return _bf16_roundtrip(d) if dtype == "bfloat16" else d

    if path in ("chunks1", "chunks16"):
        chunks = 1 if path == "chunks1" else 16
        per = n // chunks
        digest = td.init((rows,), compression, k, device=dev)
        for c in range(chunks):
            part = vals[:, c * per:(c + 1) * per]
            digest = storage(td.merge_samples(
                digest, part, torch.ones_like(part), compression))
    elif path in ("binned16", "binned4x4"):
        # the server path: shift-guarded bin scatters into the temp
        # accumulator, one drain an interval (what the dense and slab
        # stores run a staged chunk)
        intervals, chunks = (1, 16) if path == "binned16" else (4, 4)
        per = n // (intervals * chunks)
        digest = td.init((rows,), compression, k, device=dev)
        flat_rows = torch.arange(rows, device=dev).repeat_interleave(per)
        ones = torch.ones(rows * per, device=dev)
        pos = 0
        for _ in range(intervals):
            temp = td.init_temp(rows, compression=compression, device=dev)
            for _ in range(chunks):
                part = vals[:, pos:pos + per]
                pos += per
                digest, temp = td.ingest_chunk_guarded(
                    digest, temp, flat_rows, part.reshape(-1), ones,
                    compression)
                digest = storage(digest)
            digest = storage(td.drain_temp(digest, temp, compression))
    elif path == "fanin8":
        fanin = 8
        per = n // fanin
        parts = []
        for f in range(fanin):
            d = td.init((rows,), compression, k, device=dev)
            part = vals[:, f * per:(f + 1) * per]
            parts.append(storage(td.merge_samples(
                d, part, torch.ones_like(part), compression)))
        digest = parts[0]
        for d in parts[1:]:
            digest = storage(td.merge(digest, d, compression))
    else:
        raise ValueError(path)
    return digest


# the golden model's error by (dist, compression, rows, n, seed, golden
# rows): a cell's samples depend on the distribution, the shape and the
# seed only, so every path and dtype shares it
_GOLDEN: Dict[tuple, float] = {}


def golden_max(vals: np.ndarray, compression: float) -> float:
    """The scalar golden model's max rank error over the rows of
    ``vals`` (host samples)."""
    out = 0.0
    for row in vals:
        g = ScalarTDigest(compression=compression)
        for v in row.tolist():
            g.add(v)
        t_sorted = np.sort(row)
        for q in QS:
            out = max(out, rank_err(t_sorted, g.quantile(q), q))
    return out


def run_config(dist: str, compression: float, path: str, dtype: str,
               rows: int = 16, n: int = 4096, seed: int = 0,
               golden_rows: int = 2, device=None) -> Dict:
    """One sweep cell. Returns max/mean kernel rank error across rows x
    quantiles, plus the scalar golden model's max on a row subset for
    calibration."""
    vals, digest = cell_digest(dist, compression, path, dtype, rows, n,
                               seed, device)
    return cell_record(dist, compression, path, dtype, vals, digest, seed,
                       golden_rows)


def cell_record(dist: str, compression: float, path: str, dtype: str,
                vals: torch.Tensor, digest: td.TDigest, seed: int = 0,
                golden_rows: int = 2, golden: float = None) -> Dict:
    """The sweep's record of one cell from its samples and digest.
    ``golden``: the golden model's error on these samples, when the
    caller has it."""
    rows, n = vals.shape
    pcts = td.quantile(digest, QS)
    errs = rank_errors(vals, pcts).cpu().numpy()
    if golden is None:
        key = (dist, float(compression), rows, n, seed, golden_rows)
        if key not in _GOLDEN:
            _GOLDEN[key] = golden_max(vals[:golden_rows].cpu().numpy(),
                                      compression)
        golden = _GOLDEN[key]
    per_q_max = errs.max(axis=0)
    return {"dist": dist, "compression": compression, "path": path,
            "dtype": dtype, "rows": rows, "n": n,
            "max_rank_err": round(float(errs.max()), 5),
            "mean_rank_err": round(float(errs.mean()), 5),
            "golden_max_rank_err": round(golden, 5),
            "per_q_max": {q: round(float(e), 5)
                          for q, e in zip(QS, per_q_max)}}


def grid(quick: bool = False) -> List[Tuple[str, str, str, float]]:
    """The sweep's cells as (path, dtype, dist, compression), in the
    order the sweep runs them."""
    dists = DISTS[:3] + DISTS[4:5] if quick else DISTS
    comps = (100.0,) if quick else COMPRESSIONS
    paths = ("chunks1", "binned16", "fanin8") if quick else PATHS
    return [(path, dtype, dist, comp) for path in paths for dtype in DTYPES
            for dist in dists for comp in comps]


def run_sweep(quick: bool = False, rows: int = 16, n: int = 4096,
              progress=None, device=None) -> List[Dict]:
    out = []
    samples = {}
    for path, dtype, dist, comp in grid(quick):
        if dist not in samples:
            samples[dist] = cell_samples(dist, rows, n, device=device)
        vals = samples[dist]
        cell = cell_record(dist, comp, path, dtype, vals,
                           build_digest(vals, comp, path, dtype))
        out.append(cell)
        if progress:
            progress(cell)
    return out


def write_csv(cells: List[Dict], fh) -> None:
    cols = ["path", "dtype", "dist", "compression", "rows", "n",
            "max_rank_err", "mean_rank_err", "golden_max_rank_err"] + \
        [f"q{q}" for q in QS]
    w = csv.writer(fh)
    w.writerow(cols)
    for c in cells:
        w.writerow([c["path"], c["dtype"], c["dist"], c["compression"],
                    c["rows"], c["n"], c["max_rank_err"],
                    c["mean_rank_err"], c["golden_max_rank_err"]]
                   + [c["per_q_max"][q] for q in QS])


def summarize(cells: List[Dict]) -> str:
    """Markdown summary: worst-case rank error per (path, dtype) regime
    across all distributions and compressions, vs the golden model."""
    by = {}
    for c in cells:
        key = (c["path"], c["dtype"])
        cur = by.setdefault(key, {"max": 0.0, "golden": 0.0, "cells": 0,
                                  "worst": None})
        cur["cells"] += 1
        cur["golden"] = max(cur["golden"], c["golden_max_rank_err"])
        if c["max_rank_err"] >= cur["max"]:
            cur["max"] = c["max_rank_err"]
            cur["worst"] = f'{c["dist"]}/c{int(c["compression"])}'
    lines = ["| path | dtype | max rank err | worst cell | golden max |",
             "|---|---|---|---|---|"]
    for (path, dtype), v in sorted(by.items()):
        lines.append(f'| {path} | {dtype} | {v["max"]:.4f} | '
                     f'{v["worst"]} | {v["golden"]:.4f} |')
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tdigest_sweep",
        description="t-digest accuracy sweep (CSV + summary)")
    ap.add_argument("--quick", action="store_true",
                    help="reduced sweep for CI")
    ap.add_argument("--rows", type=int, default=16)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--out", default="-",
                    help="CSV path ('-' for stdout)")
    args = ap.parse_args(argv)

    def progress(c):
        print(f'{c["path"]:9s} {c["dtype"]:8s} {c["dist"]:11s} '
              f'c={int(c["compression"]):3d} max={c["max_rank_err"]:.4f} '
              f'golden={c["golden_max_rank_err"]:.4f}', file=sys.stderr)

    cells = run_sweep(quick=args.quick, rows=args.rows, n=args.n,
                      progress=progress, device=args.device)
    buf = io.StringIO()
    write_csv(cells, buf)
    if args.out == "-":
        sys.stdout.write(buf.getvalue())
    else:
        with open(args.out, "w") as fh:
            fh.write(buf.getvalue())
    print("\n" + summarize(cells), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
