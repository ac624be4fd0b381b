"""The port's native egress library against the JAX package's.

``veneur_tpu_torch/native/veneur_egress.cpp`` is a byte-for-byte copy of
the JAX package's source, built by the port into
``build/native/libveneur_egress-<hash>.so``. The same seeded emission
blocks go through both packages' ``dd_series_bodies`` (at several
``max_per_body`` values and deflate levels) and ``tsv_rows``: every body
must be byte-identical.

The pinned difference: the JAX package quietly falls back to per-row
emission when its library cannot build; the port raises, from the
library and from a columnar flush, and keeps the interval in the store.
Per-row emission is ``flush_columnar: false``.

Both packages build their library with g++ on first use; without g++
these tests skip.
"""

import shutil
import zlib
from pathlib import Path

import numpy as np
import pytest

from veneur_tpu.native import egress as jegress
from veneur_tpu_torch import native as tnative
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.core import columnar as tcol
from veneur_tpu_torch.native import egress as tegress
from veneur_tpu_torch.samplers.intermetric import Aggregate
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native library cannot be built")
    assert tegress.available() and jegress.available()


def _blocks(seed: int = 11, n: int = 300):
    """A digest block (every aggregate, two percentiles) and a counter
    block over seeded series whose tags carry host:, device:, escapes
    and non-ASCII text, with values that are integral, tiny, huge,
    negative, zero and non-finite."""
    rng = np.random.default_rng(seed)
    names = [f"svc.{i}.lat\"q\\" if i % 17 == 0 else f"svc.{i}.lat"
             for i in range(n)]
    pool = ["env:prod", "host:h%d", "device:sd%d", "a:é", "tab:\t",
            "role:web", "q:\"x\""]
    joined = []
    for i in range(n):
        k = int(rng.integers(0, 4))
        joined.append(",".join(
            pool[j] % i if "%d" in pool[j] else pool[j]
            for j in sorted(rng.choice(len(pool), k, replace=False))))
    name_ar, tag_ar = tcol.build_arenas(names), tcol.build_arenas(joined)
    vals = rng.normal(0, 1e3, n)
    vals[::7] = np.round(vals[::7])
    vals[3], vals[5], vals[8] = 1e-300, 1e300, 0.0
    r = {"max": vals + 5, "min": vals - 5, "sum": vals * 3,
         "count": rng.integers(0, 9, n).astype(np.float64),
         "recip": rng.random(n), "median": vals,
         "percentiles": np.stack([vals - 1, vals + 1], 1)}
    r["max"][10] = np.inf
    r["percentiles"][12, 0] = np.nan
    every = Aggregate(sum(int(a) for a in Aggregate))
    digest = tcol.digest_block(name_ar, tag_ar, r, every, [0.5, 0.99])
    counter = tcol.EmissionBlock(
        names=name_ar, tags=tag_ar, suffixes=[b""],
        rows=np.arange(n, dtype=np.uint32),
        suffix_idx=np.zeros(n, np.uint8), values=vals / 10.0,
        type_codes=np.full(n, tcol.TYPE_COUNTER, np.uint8))
    return [digest, counter]


def _args(blk):
    return (blk.names, blk.tags, blk.suffixes, blk.rows, blk.suffix_idx,
            blk.values, blk.type_codes)


@pytest.mark.parametrize("max_per_body", [1, 7, 250, 25000])
@pytest.mark.parametrize("level", [0, 1, 6])
def test_dd_series_bodies_byte_identical(gxx, max_per_body, level):
    for blk in _blocks():
        kw = dict(timestamp=1_700_000_000, interval=10, default_host="h0",
                  common_tags_json=b'"team:core","x:\\"y\\""',
                  max_per_body=max_per_body, compress_level=level)
        got = tegress.dd_series_bodies(*_args(blk), **kw)
        want = jegress.dd_series_bodies(*_args(blk), **kw)
        assert got == want
        assert len(got) == -(-len(blk) // max_per_body)
        if level:
            assert zlib.decompress(got[-1]).startswith(b'{"series":[')


def test_tsv_rows_byte_identical(gxx):
    for blk in _blocks(seed=12):
        args = (*_args(blk), "h0", 10, "2026-10-17 12:00:00", "20261017")
        got = tegress.tsv_rows(*args)
        assert got == jegress.tsv_rows(*args)
        assert got.count(b"\n") == len(blk)


def test_more_than_255_suffixes_refused(gxx):
    blk = _blocks()[1]
    with pytest.raises(ValueError, match="255"):
        tegress.dd_series_bodies(blk.names, blk.tags, [b"x"] * 256,
                                 *_args(blk)[3:], timestamp=0, interval=10,
                                 default_host="h")


def test_build_lands_under_build_native(gxx, tmp_path, monkeypatch):
    """The library builds from the port's own source into the port's build
    directory, named by a hash of the source and the flags; the JAX
    package's library is never the one loaded."""
    assert tegress.SOURCE.read_bytes() == (
        ROOT / "veneur_tpu" / "native" / "veneur_egress.cpp").read_bytes()
    assert tegress.SOURCE.parent == ROOT / "veneur_tpu_torch" / "native"
    path = tegress.library_path()
    assert path.parent == tnative.BUILD_DIR == ROOT / "build" / "native"
    assert path.name.startswith("libveneur_egress-") and path.exists()
    # an edited source gets another name, so a stale build never loads
    src = tmp_path / "veneur_egress.cpp"
    src.write_bytes(tegress.SOURCE.read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(tegress, "SOURCE", src)
    assert tegress.library_path() != path
    calls = []

    def run(cmd, **kw):  # records the command; writes a stand-in file
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")

    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(tnative.subprocess, "run", run)
    built = tegress.build()
    assert built == tmp_path / "out" / tegress.library_path().name
    assert built.exists() and [p.name for p in built.parent.iterdir()] == [
        built.name]  # renamed into place, no temporary left
    assert calls[0][:5] == ["g++", "-O2", "-std=c++17", "-shared", "-fPIC"]
    assert calls[0][-1] == "-lz" and str(src) in calls[0]
    assert tegress.build() == built and len(calls) == 1  # cached


def _broken_library(tmp_path, monkeypatch):
    """Point the egress build at a source that does not compile, with no
    library loaded yet."""
    bad = tmp_path / "veneur_egress.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tegress, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(tegress, "_lib", None)
    monkeypatch.setattr(tegress, "_build_error", None)


def test_build_failure_raises(tmp_path, monkeypatch):
    _broken_library(tmp_path, monkeypatch)
    with pytest.raises(RuntimeError, match="native egress unavailable"):
        tegress.load()
    assert not tegress.available()
    blk = _blocks()[1]
    with pytest.raises(RuntimeError, match="native egress unavailable"):
        tegress.dd_series_bodies(*_args(blk), timestamp=0, interval=10,
                                 default_host="h")


def test_columnar_flush_raises_without_the_library(tmp_path, monkeypatch):
    """No quiet per-row fallback: with flush_columnar the flush raises and
    the interval stays in the store; flush_columnar: false flushes the
    same store per row."""
    _broken_library(tmp_path, monkeypatch)
    sink = ChannelMetricSink()
    server = Server(Config(hostname="h", interval="3600s"),
                    metric_sinks=[sink], device="cpu")
    for line in (b"a:1|c", b"b:2|g", b"c:3|h"):
        server.handle_metric_packet(line)
    with pytest.raises(RuntimeError, match="native egress unavailable"):
        server.flush()
    assert sink.queue.empty()
    assert server.store.processed == 3  # not swapped out, not lost
    server.config.flush_columnar = False
    n = server.flush()
    rows = sink.get_flush(timeout=5)
    assert n == len(rows)
    # a, b, c.min, c.max, c.count; beside them the self-telemetry rows of
    # the failed flush's timed stages (veneur.obs.stage_duration_ns)
    assert sorted(m.name for m in rows
                  if not m.name.startswith("veneur.")) == [
        "a", "b", "c.count", "c.max", "c.min"]
    assert {m.name.rpartition(".")[0] for m in rows
            if m.name.startswith("veneur.")} == {
        "veneur.obs.stage_duration_ns"}
