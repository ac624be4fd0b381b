"""The port's native ingest library against the JAX package's.

``veneur_tpu_torch/native/veneur_ingest.cpp`` is a byte-for-byte copy of
the JAX package's source, built by the port into ``build/native/``. The
same seeded datagrams go through both packages' ``parse_lines`` and
``InternTable``: every column and the arena must be identical. Set-member
hashes the C++ parser carries in the value slot must equal the port's
Python member hash, so the batch and per-line paths give identical HLL
registers.

Both packages build their library with g++ on first use; without g++
these tests skip.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from veneur_tpu import native as jnative
from veneur_tpu_torch import native as tnative
from veneur_tpu_torch.core.store import SetGroup
from veneur_tpu_torch.ops import hll as hll_ops
from veneur_tpu_torch.samplers.parser import MetricKey

ROOT = Path(__file__).resolve().parents[1]
COLUMNS = ("type", "scope", "value", "sample_rate", "digest", "name_off",
           "name_len", "tags_off", "tags_len", "aux_off", "aux_len")


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native library cannot be built")
    assert tnative.available() and jnative.available()


def _mixed_datagrams(seed: int, n: int = 400):
    """Seeded DogStatsD datagrams of every record type: sample rates,
    tags, magic scope tags, heavy-hitter sets, events, service checks,
    malformed lines and over-long lines (long names, long values, long
    tag lists)."""
    rng = np.random.default_rng(seed)
    kinds = ("c", "g", "h", "ms", "s")
    tagsets = ("", "|#env:prod", "|#b:2,a:1", "|#veneurlocalonly,x:y",
               "|#veneurglobalonly", "|#veneurtopk", "|#zz,aa,mm",
               "|#role:web,veneurlocalonlyz")
    malformed = (b"noval", b":1|c", b"x:1", b"x:1|", b"x:1|q", b"x:abc|c",
                 b"x:1|c||#a", b"x:1|c|@0.5|@0.5", b"x:1|c|#a|#b",
                 b"x:1|c|zzz", b"c:nan|c", b"g:inf|g", b"c:1|c|@0",
                 b"c:1|c|@-1", b"c:1|c|@2", b"c:1|c|@x", b"x:" + b"9" * 70
                 + b"|c")
    lines = []
    for _ in range(n):
        r = rng.random()
        if r < 0.05:
            lines.append(b"_e{5,4}:title|text|#k:v")
        elif r < 0.08:
            lines.append(b"_sc|svc.check|%d|#k:v" % rng.integers(0, 4))
        elif r < 0.15:
            lines.append(malformed[int(rng.integers(0, len(malformed)))])
        elif r < 0.17:
            name = "n" * int(rng.integers(200, 2000))
            tags = ",".join(f"t{i}:{'v' * 40}" for i in range(60))
            lines.append(f"{name}:1|c|#{tags}".encode())
        else:
            kind = kinds[int(rng.integers(0, len(kinds)))]
            name = f"m.{kind}.{int(rng.integers(0, 40))}"
            if kind == "s":
                value = ("u", "ü", "", "x" * 90)[int(rng.integers(0, 4))] \
                    + str(int(rng.integers(0, 100)))
            else:
                value = repr(float(np.round(rng.normal(0, 100), 3)))
            rate = ("", "|@0.5", "|@0.1", "|@0.3")[int(rng.integers(0, 4))]
            tags = tagsets[int(rng.integers(0, len(tagsets)))]
            lines.append(f"{name}:{value}|{kind}{rate}{tags}".encode())
    datagrams, i = [], 0
    while i < len(lines):
        k = int(rng.integers(1, 9))
        datagrams.append(b"\n".join(lines[i:i + k]))
        i += k
    return datagrams


def _assert_same_batch(got, want):
    assert got.count == want.count
    assert got.parse_errors == want.parse_errors
    for col in COLUMNS:
        a, b = getattr(got, col), getattr(want, col)
        assert a.dtype == b.dtype, col
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=col)
    assert got.arena == want.arena


def test_source_is_the_reference_copy():
    port = ROOT / "veneur_tpu_torch" / "native" / "veneur_ingest.cpp"
    ref = ROOT / "veneur_tpu" / "native" / "veneur_ingest.cpp"
    assert port.read_bytes() == ref.read_bytes()


def test_batch_struct_mirrors_the_reference():
    """_VtBatch lays out VtBatch field for field, as the JAX binding
    does."""
    got = [(n, t) for n, t in tnative._VtBatch._fields_]
    want = [(n, t) for n, t in jnative._VtBatch._fields_]
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert ctypes.sizeof(a) == ctypes.sizeof(b), name
        assert getattr(a, "_type_", a) == getattr(b, "_type_", b), name
    assert ctypes.sizeof(tnative._VtBatch) == ctypes.sizeof(
        jnative._VtBatch)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_parse_lines_matches_jax(gxx, seed):
    datagrams = _mixed_datagrams(seed)
    for d in datagrams:
        _assert_same_batch(tnative.parse_lines(d), jnative.parse_lines(d))
    buf = b"\n".join(datagrams)
    got, want = tnative.parse_lines(buf), jnative.parse_lines(buf)
    _assert_same_batch(got, want)
    assert got.count > 300 and got.parse_errors > 10
    assert {int(t) for t in got.type} == {0, 1, 2, 3, 4, 5}
    assert {int(s) for s in got.scope} == {0, 1, 2, 3}


def test_parse_lines_arena_overflow_matches_jax(gxx):
    """A buffer larger than the arena the caller sized: both packages
    reject the same lines as parse errors."""
    buf = b"\n".join(_mixed_datagrams(9))
    got = tnative.parse_lines(buf, max_records=64, arena_cap=2048)
    want = jnative.parse_lines(buf, max_records=64, arena_cap=2048)
    _assert_same_batch(got, want)
    assert got.count == 64 or len(got.arena) > 1900


def test_intern_assign_matches_jax(gxx):
    rng = np.random.default_rng(4)
    batches = [b"\n".join(_mixed_datagrams(s, 200)) for s in (5, 6, 7)]
    tables = (tnative.InternTable(), jnative.InternTable())
    parse = (tnative.parse_lines, jnative.parse_lines)
    next_row = {}
    for buf in batches:
        out = []
        for table, parse_fn in zip(tables, parse):
            pb = parse_fn(buf)
            out.append((pb,) + table.assign(pb))
        (pb, rows, kinds, miss), (_, jrows, jkinds, jmiss) = out
        np.testing.assert_array_equal(rows, jrows)
        np.testing.assert_array_equal(kinds, jkinds)
        np.testing.assert_array_equal(miss, jmiss)
        # teach both tables the same rows for half of the misses
        for j in miss[rng.random(len(miss)) < 0.5].tolist():
            k = int(kinds[j])
            name = pb.arena[pb.name_off[j]:pb.name_off[j] + pb.name_len[j]]
            tags = pb.arena[pb.tags_off[j]:pb.tags_off[j] + pb.tags_len[j]]
            row = next_row.get(k, 0)
            next_row[k] = row + 1
            for table in tables:
                table.put(k, name, tags, row)
    for table in tables:
        table.reset()
    pb = tnative.parse_lines(batches[0])
    rows, _, miss = tables[0].assign(pb)
    assert (rows[miss] == tnative.MISS).all()


MEMBERS = {
    "ascii": ["alice", "bob", "m42", "user-7"],
    "utf8": ["ü", "naïve", "日本語", "emoji-😀"],
    "empty": [""],
    "long": ["x" * 65, "é" * 40, "y" * 300],
}


@pytest.mark.parametrize("kind", sorted(MEMBERS))
def test_member_hashes_match_python(gxx, kind):
    """The C++ member hash (FNV-1a + fmix64, in the value slot) equals
    the port's Python hash_member, and a SetGroup fed the native hashes
    holds the same registers as one fed the members line by line."""
    members = MEMBERS[kind]
    buf = "\n".join(f"s.{i % 2}:{m}|s" for i, m in enumerate(members))
    pb = tnative.parse_lines(buf.encode())
    assert pb.count == len(members) and pb.parse_errors == 0
    want = [hll_ops.hash_member(m.encode("utf-8")) for m in members]
    assert pb.member_hashes().tolist() == want
    by_line = SetGroup(capacity=4, chunk=8, device="cpu")
    by_batch = SetGroup(capacity=4, chunk=8, device="cpu")
    for i, m in enumerate(members):
        by_line.sample(MetricKey(f"s.{i % 2}", "set"), [], m)
    rows = np.array([i % 2 for i in range(len(members))], np.int32)
    by_batch.sample_many(rows, pb.member_hashes())
    by_line._drain_staging()
    by_batch._drain_staging()
    assert torch.equal(by_line.registers, by_batch.registers)
    assert int(by_line.registers.ne(0).sum()) >= len(set(members)) - 1


def test_build_lands_under_build_native(gxx, tmp_path):
    """The port builds into its build directory (build/native/ at the
    repository root) and loads that file: a fresh process that cannot
    import veneur_tpu builds into an empty directory, and the JAX
    package's library is never mapped."""
    assert tnative.BUILD_DIR == ROOT / "build" / "native"
    assert tnative.library_path().parent == tnative.BUILD_DIR
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "sys.modules['veneur_tpu'] = None\n"
        "sys.modules['jax'] = None\n"
        "from veneur_tpu_torch import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "calls, real = [], native.subprocess.run\n"
        "def run(cmd, **kw):\n"
        "    calls.append(cmd)\n"
        "    return real(cmd, **kw)\n"
        "native.subprocess.run = run\n"
        "assert native.parse_lines(b'a:1|c').count == 1\n"
        "print('OUT', calls[0][calls[0].index('-o') + 1])\n"
        "print('CALLS', len(calls))\n"
        "print(open('/proc/self/maps').read())\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "CALLS 1" in out.stdout
    built = out.stdout.split("OUT ", 1)[1].split("\n", 1)[0]
    assert Path(built).parent == tmp_path
    assert [p.name for p in tmp_path.iterdir()] == [
        tnative.library_path().name]
    assert str(tmp_path / tnative.library_path().name) in out.stdout
    assert "veneur_tpu/native" not in out.stdout
