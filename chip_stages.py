#!/usr/bin/env python3
"""Where the merge kernel spends its time, stage by stage.

    python3 chip_stages.py

Builds copies of csrc/tdigest_merge.cu that stop the row body
(merge_row, which the warp-per-row kernel runs) after each stage (load,
merge, prefix sum, compaction of the live slots, their bins and bin
runs, run sums, gap-fill; then K1's quantile stage: suffix min, upper
bounds, bin prefix sum, the search) and store a sum of the live
registers so nothing is optimised away, plus the full source. Times K2
(compress_presorted) and K1 (drain_quantile) from each at the flush's
shape (1,048,576 rows, K=104, the store's 9 quantiles) with CUDA
events, and prints one JSON line: cumulative times per cut, so each
stage's cost is the difference to the cut before it. With --sass it
also prints the SASS instruction count of each full kernel instance
(cuobjdump).

    python3 chip_stages.py --narrow

instead builds copies that vary the narrow path (merge widths 16 and
32): the lanes a row takes (half, half / 2, half / 4: two, four or eight
slots a lane) and the resident blocks per SM asked of ptxas, holds each
copy's K1 and K2 to their plain versions and times them on 262,144
rows (one tiered pool slab), the copies in turns, three rounds; it
prints one JSON line with the median times and each narrow instance's
registers and spills.

Needs one CUDA GPU and nvcc; the copies go to build/stages/. It imports
nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "veneur_tpu_torch" / "csrc" / "tdigest_merge.cu"
OUT = ROOT / "build" / "stages"
ROWS = 1 << 20
COMPRESSION = 100.0
QUANTILES = (0.01, 0.10, 0.25, 0.50, 0.75, 0.90, 0.95, 0.99, 0.50)

# (cut, anchor the early exit goes in front of, registers to sink, count)
CUTS = (
    ("load", "  // --- K3: sort the b half", "k[r] + w[r]", "S"),
    ("merge", "  // --- keep the first m slots", "k[r] + w[r]", "S"),
    ("prefix", "  const float row_total = group_max<G>(tmax);",
     "sc[r] + wm[r]", "S"),
    ("compact", "  const int zeros[KS] = {};", "sc[r] + (float)rank", "S"),
    ("bin", "  // --- segmented reduce: each bin's lane sums its run",
     "(float)(sm.lo[lane * KS + r] + sm.hi[lane * KS + r] + unordered)",
     "KS"),
    ("runs", "  float nm[KS], filled[KS];", "bw[r] + bwm[r]", "KS"),
    ("gapfill", "  store_run<KS>(a.om + row * kout", "filled[r] + bw[r]",
     "KS"),
    # K1's quantile stage (K2 returns before it)
    ("q_suffix",
     "  float next_lane = __shfl_down_sync(kFull, sfx[0], 1, G);",
     "sfx[r]", "KS"),
    ("q_bounds", "  float incl[KS];", "ub[r]", "KS"),
    ("q_prefix", "  float tm = -VT_INF;", "incl[r]", "KS"),
    ("q_search", "    const float ub_i = gather<KS, G>(ub, idx);",
     "(float)idx + target", "1"),
)


# the narrow path's copies: (name, lanes a row as an expression of half,
# the narrow kernel's resident blocks per SM asked of ptxas; None: the
# source's own); the source takes half / 2
NARROW_VARIANTS = (
    ("lanes_half", "half", None),
    ("lanes_half_over_2", "half / 2", None),
    ("lanes_half_over_4", "half / 4", None),
    ("lanes_half_over_2_blocks8", "half / 2", "8"),
    ("lanes_half_over_2_blocks12", "half / 2", "12"),
    ("lanes_half_over_2_blocks16", "half / 2", "16"),
)
NARROW_ROUNDS = 3  # the copies are timed in turns, this many times each
NARROW_ROWS = 1 << 18
# merge width -> (compression, K): the tiered pool's K at PK 16 and 8
NARROW_WIDTHS = {32: (14.0, 16), 16: (6.0, 8)}


def _replace_once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"chip_stages: not found once: {old!r}")
    return src.replace(old, new)


def _narrow_source(src: str, lanes: str, blocks) -> str:
    src = _replace_once(src, "narrow_lanes(int half) { return half / 2; }",
                        f"narrow_lanes(int half) {{ return {lanes}; }}")
    if blocks is not None:
        src = _replace_once(
            src, "__launch_bounds__(32 * kWarps, min_blocks(DRAIN))\n"
            "    narrow_rows_kernel",
            f"__launch_bounds__(32 * kWarps, {blocks})\n"
            "    narrow_rows_kernel")
    return src


def _cut_source(src: str, anchor: str, expr: str, count: str) -> str:
    if src.count(anchor) != 1:
        raise SystemExit(f"chip_stages: anchor not found once: {anchor!r}")
    sink = ("  if (true) {\n    float acc = 0.0f;\n#pragma unroll\n"
            f"    for (int r = 0; r < {count}; ++r) acc += {expr};\n"
            "    if (lane < kout) {\n"
            "      a.om[row * kout + lane] = acc;\n"
            "      a.ow[row * kout + lane] = acc;\n    }\n"
            "    return;\n  }\n")
    return src.replace(anchor, sink + anchor)


def _build(sources: dict) -> dict:
    from veneur_tpu_torch.ops import cuda_build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
             str(OUT / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, proc in procs.items():
        logs[name] = log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"chip_stages: nvcc failed for {name}:\n{log}")
    return {name: OUT / f"{name}.so" for name in sources}, logs


def _sass_counts(lib: Path) -> dict:
    cuobjdump = Path(subprocess.run(
        ["bash", "-c", "command -v cuobjdump || echo "
         "/usr/local/cuda/bin/cuobjdump"],
        capture_output=True, text=True).stdout.strip())
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for ln in text.splitlines():
        hit = re.search(r"Function : \S*(warp|narrow|block)_rows_kernelI"
                        r"(?:Li(\d+)E)?Lb(\d)ELb(\d)E", ln)
        if hit:
            fn = (f"{hit.group(1)}<{hit.group(2) or 'any'},"
                  f"sort_b={hit.group(3)},drain={hit.group(4)}>")
            counts[fn] = 0
        elif fn and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", ln):
            counts[fn] += 1
    return counts


def _narrow(src: str, dev) -> dict:
    """Each NARROW_VARIANTS copy's K1 and K2 (presorted) at merge widths
    32 and 16 on NARROW_ROWS rows: held to the plain versions
    (chip_smoke._compare), then timed (median of 20 full calls) in turns,
    NARROW_ROUNDS times; each time is the median over the rounds."""
    import torch

    import chip_smoke
    from veneur_tpu_torch.ops import cuda_build
    from veneur_tpu_torch.ops import tdigest_cuda as tc

    sources = {name: _narrow_source(src, lanes, blocks)
               for name, lanes, blocks in NARROW_VARIANTS}
    libs, logs = _build(sources)
    qs = torch.tensor(QUANTILES, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    calls = {}
    for width, (c, k) in NARROW_WIDTHS.items():
        ma, wa, mb, wb, mn, mx = chip_smoke._random_halves(NARROW_ROWS, k,
                                                           dev, gen)
        h, hq = (ma, wa, mb, wb), (ma, wa, mb, wb, mn, mx, qs)
        calls[f"w{width}_k2"] = (
            partial(tc.compress_presorted, *h, c, k),
            partial(tc.compress_presorted_plain, *h, c, k), wa, wb, None)
        calls[f"w{width}_k1"] = (
            partial(tc.drain_quantile, *hq, c, k),
            partial(tc.drain_quantile_plain, *hq, c, k), wa, wb, mx - mn)
    errs = {name: {} for name in sources}
    runs = {name: {key: [] for key in calls} for name in sources}
    for rnd in range(NARROW_ROUNDS):
        for name in sources:
            cuda_build._loaded["tdigest_merge"] = ctypes.CDLL(
                str(libs[name]))
            for key, (fn, plain, wa, wb, span) in calls.items():
                if rnd == 0:
                    errs[name][key] = chip_smoke._compare(
                        f"{name} {key}", fn(), plain(), wa, wb, span)
                runs[name][key].append(chip_smoke._median_ms(fn, 20))
    times = {name: {f"{key}_ms": statistics.median(t)
                    for key, t in per.items()}
             for name, per in runs.items()}
    ptxas = {name: [r for r in chip_smoke._ptxas_summary({name: log})
                    if r["fn"].startswith("narrow")]
             for name, log in logs.items()}
    return {"rows": NARROW_ROWS, "rounds": NARROW_ROUNDS, "times": times,
            "all_ms": runs, "max_abs_err": errs, "ptxas": ptxas,
            "card": chip_smoke.card_line()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_stages: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from veneur_tpu_torch.ops import cuda_build
    from veneur_tpu_torch.ops import tdigest as td
    from veneur_tpu_torch.ops import tdigest_cuda as tc

    src = SRC.read_text()
    dev = torch.device("cuda", 0)
    if "--narrow" in sys.argv[1:]:
        print(json.dumps(_narrow(src, dev)), flush=True)
        return 0
    sources = {name: _cut_source(src, anchor, expr, count)
               for name, anchor, expr, count in CUTS}
    sources["full"] = src
    libs, _ = _build(sources)

    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    k = td.size_bound(COMPRESSION)
    ma, wa, mb, wb, mn, mx = chip_smoke._random_halves(ROWS, k, dev, gen)
    qs = torch.tensor(QUANTILES, dtype=torch.float32, device=dev)
    times = {}
    for name in sources:
        # the wrappers load the library through cuda_build's cache
        cuda_build._loaded["tdigest_merge"] = ctypes.CDLL(str(libs[name]))
        times[name] = {
            "compress_presorted_ms": chip_smoke._median_ms(
                lambda: tc.compress_presorted(ma, wa, mb, wb, COMPRESSION,
                                              k), 20),
            "drain_quantile_ms": chip_smoke._median_ms(
                lambda: tc.drain_quantile(ma, wa, mb, wb, mn, mx, qs,
                                          COMPRESSION, k), 20)}
    out = {"rows": ROWS, "k": k, "cumulative": times,
           "card": chip_smoke.card_line()}
    if "--sass" in sys.argv[1:]:
        out["sass_instructions"] = _sass_counts(libs["full"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
