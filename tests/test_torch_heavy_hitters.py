"""The port's heavy hitters (``HeavyHitterGroup``, veneurtopk sets) against
the JAX package's, on the CPU.

The same seeded DogStatsD lines (set series tagged ``veneurtopk`` whose
members follow a Zipf law, beside plain sets) go into a JAX MetricStore
and a port MetricStore(device="cpu") through each ingest rung: the
per-line parser, the native ``process_batch``, an ingest lane, and SSF
samples. Both packages stage the samples in the same order, so their
count-min drains are the same: the ``{name}.topk`` rows must match
exactly (name, tags with ``key:<member>``, count). The member memo's hex
fallback, growth of the [S, K] planes, the forward/import of the
``topk_sketch`` JSON entry across the packages both ways (fleet counts
are the sums of the locals', exactly, on these collision-free tables),
its absence from the reference-compatible body, and convert.py's state
carry-over are held to the same exact equality.
"""

import collections
import json
import shutil

import numpy as np
import pytest
import torch

from veneur_tpu import native as jnative
from veneur_tpu.core import store as jstore
from veneur_tpu.forward import convert as jconvert
from veneur_tpu.protocol.gen.ssf import sample_pb2 as pb
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.samplers.intermetric import HistogramAggregates as JAggs
from veneur_tpu_torch import convert
from veneur_tpu_torch import native as tnative
from veneur_tpu_torch.core import store as tstore
from veneur_tpu_torch.forward import convert as tconvert
from veneur_tpu_torch.forward.http_forward import HTTPForwarder
from veneur_tpu_torch.ingest import IngestFleet
from veneur_tpu_torch.protocol import ssf
from veneur_tpu_torch.protocol.addr import resolve_addr
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates

AGG = ["count"]
CHUNK = 128
CAP = 16


def _zipf_lines(seed, series=12, samples=1500, keys=200):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, keys + 1) ** 1.1
    draws = rng.choice(keys, samples, p=w / w.sum())
    owners = rng.integers(0, series, samples)
    lines = [f"hh.s{o}:user{d}|s|#veneurtopk,env:e{o % 3}".encode()
             for o, d in zip(owners.tolist(), draws.tolist())]
    lines += [f"plain.s{i % 4}:m{i}|s".encode() for i in range(40)]
    order = rng.permutation(len(lines))
    return [lines[j] for j in order]


def _port_store(**kw):
    kw.setdefault("initial_capacity", CAP)
    kw.setdefault("chunk", CHUNK)
    return tstore.MetricStore(device="cpu", **kw)


def _jax_store(**kw):
    kw.setdefault("initial_capacity", CAP)
    kw.setdefault("chunk", CHUNK)
    return jstore.MetricStore(**kw)


def _topk_port(store, is_local=False, forward=False):
    final, fwd = store.flush([], HistogramAggregates.from_names(AGG), 0,
                             is_local=is_local, forward=forward)
    return _topk_rows(final.to_intermetrics()), fwd


def _topk_jax(store, is_local=False, forward=False):
    final, fwd, _ = store.flush([], JAggs.from_names(AGG),
                                is_local=is_local, now=0, forward=forward)
    return _topk_rows(final), fwd


def _topk_rows(final):
    out = {}
    for m in final:
        if m.name.endswith(".topk"):
            key = (m.name, tuple(m.tags))
            assert key not in out, key
            out[key] = m.value
    return out


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native library cannot be built")
    assert tnative.available() and jnative.available()


def _feed_lanes(store, lines):
    fleet = IngestFleet(store, resolve_addr("udp://127.0.0.1:0"), 1,
                        1 << 20, 4096, chunk_records=256)
    try:
        lane = fleet.lanes[0]
        for i in range(0, len(lines), 64):
            lane._stage_native(lines[i:i + 64])
        lane._seal()
        fleet.merge_sealed()
    finally:
        fleet.shutdown()


@pytest.mark.parametrize("rung", ["per_line", "batch", "lanes"])
def test_rungs_emit_jax_topk_rows(gxx, rung):
    """Zipf-distributed members over 12 top-k series (several drains at
    chunk 128, growth past the initial 16 rows): each port rung emits
    the JAX package's rows exactly, member names and all."""
    lines = _zipf_lines(1)
    j = _jax_store()
    for line in lines:
        j.process_metric(jparser.parse_metric(line))
    t = _port_store()
    if rung == "per_line":
        for line in lines:
            t.process_metric(tparser.parse_metric(line))
    elif rung == "batch":
        t.process_batch(tnative.parse_lines(b"\n".join(lines)))
    else:
        _feed_lanes(t, lines)
    want, _ = _topk_jax(j)
    got, _ = _topk_port(t)
    assert len(want) > 100
    assert not any(k[1][-1].startswith("key:0x") for k in got)
    assert got == want
    # the same rows come from the JAX package's own batch path
    jb = _jax_store()
    jb.process_batch(jnative.parse_lines(b"\n".join(lines)))
    assert _topk_jax(jb)[0] == want


def test_ssf_samples_emit_jax_topk_rows():
    """SSF set samples tagged ``veneurtopk`` (the scope route: their tags
    are ``k:v``) land in the group as in the JAX package."""
    rng = np.random.default_rng(2)
    draws = rng.zipf(1.3, 600) % 50
    t, j = _port_store(), _jax_store()
    for i, d in enumerate(draws.tolist()):
        tags = {"veneurtopk": "", "svc": f"s{i % 2}"}
        t.process_metric(tparser.parse_metric_ssf(ssf.SSFSample(
            metric=ssf.SSFSample.SET, name="ssf.hh", message=f"k{d}",
            tags=tags)))
        j.process_metric(jparser.parse_metric_ssf(pb.SSFSample(
            metric=pb.SSFSample.SET, name="ssf.hh", message=f"k{d}",
            tags=tags)))
    got, _ = _topk_port(t)
    assert got and got == _topk_jax(j)[0]


def test_member_memo_falls_back_to_hex():
    """Past MEMO_LIMIT members the emitted key is the hash in hex, in
    both packages alike."""
    t, j = _port_store(), _jax_store()
    t.heavy_hitters.MEMO_LIMIT = j.heavy_hitters.MEMO_LIMIT = 3
    for i in range(10):
        for _ in range(10 - i):
            line = f"m.k:member{i}|s|#veneurtopk".encode()
            t.process_metric(tparser.parse_metric(line))
            j.process_metric(jparser.parse_metric(line))
    got, _ = _topk_port(t, is_local=True)
    assert got == _topk_jax(j, is_local=True)[0]
    keys = [k[1][-1] for k in got]
    assert len(keys) == 10
    assert sum(k.startswith("key:0x") for k in keys) == 7


def test_growth():
    """A group grown from 2 rows to 32 keeps every series' list and sid."""
    t, j = _port_store(initial_capacity=2, chunk=32), _jax_store(
        initial_capacity=2, chunk=32)
    for i in range(20):
        for k in range(i % 3 + 1):
            line = f"grow.h{i}:k{k}|s|#veneurtopk".encode()
            t.process_metric(tparser.parse_metric(line))
            j.process_metric(jparser.parse_metric(line))
    assert t.heavy_hitters.capacity == 32
    assert t.heavy_hitters.sketch.topk_counts.shape == (32, 32)
    np.testing.assert_array_equal(t.heavy_hitters._sids_np,
                                  j.heavy_hitters._sids_np)
    got, _ = _topk_port(t, is_local=True)
    assert len(got) == sum(i % 3 + 1 for i in range(20))
    assert set(got.values()) == {1.0}
    assert got == _topk_jax(j, is_local=True)[0]


def _local(make, parse, counts):
    store = make()
    for member, n in counts.items():
        for _ in range(n):
            store.process_metric(parse(
                f"api.callers:{member}|s|#veneurtopk".encode()))
    return store


HOST_A = {"alice": 30, "bob": 10, "carol": 2}
HOST_B = {"alice": 5, "bob": 25, "dave": 7}
FLEET = {"alice": 35.0, "bob": 35.0, "carol": 2.0, "dave": 7.0}


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_topk_sketch_crosses_packages(direction):
    """Two locals of one package forward their sketches as the JSON
    ``topk_sketch`` entry (through json.dumps/loads) to a global of the
    other: the fleet top-k counts are the sums of the hosts' counts."""
    if direction == "port_to_jax":
        locals_ = [_local(_port_store, tparser.parse_metric, c)
                   for c in (HOST_A, HOST_B)]
        glob = _jax_store()
        for store in locals_:
            rows, fwd = _topk_port(store, is_local=True, forward=True)
            assert rows == {} and fwd.topk is not None
            body = json.loads(json.dumps(tconvert.json_metrics_from_state(
                fwd)))
            assert [d["type"] for d in body] == ["topk_sketch"]
            assert jconvert.apply_json_metric_list(glob, body) == (1, 0)
        got, _ = _topk_jax(glob)
    else:
        locals_ = [_local(_jax_store, jparser.parse_metric, c)
                   for c in (HOST_A, HOST_B)]
        glob = _port_store()
        for store in locals_:
            rows, fwd = _topk_jax(store, is_local=True, forward=True)
            assert rows == {} and fwd.topk is not None
            body = json.loads(json.dumps(jconvert.json_metrics_from_state(
                fwd)))
            assert tconvert.apply_json_metric_list(glob, body) == (1, 0)
        got, _ = _topk_port(glob)
    assert {k[1][-1][4:]: v for k, v in got.items()} == FLEET


def test_local_forward_bodies_match_jax():
    """A port local's sketch entry equals the JAX local's for the same
    lines: table bytes, series, keys and members."""
    t = _local(_port_store, tparser.parse_metric, HOST_A)
    j = _local(_jax_store, jparser.parse_metric, HOST_A)
    _, tfwd = _topk_port(t, is_local=True, forward=True)
    _, jfwd = _topk_jax(j, is_local=True, forward=True)
    assert tconvert.json_metrics_from_state(tfwd) == \
        jconvert.json_metrics_from_state(jfwd)


def test_reference_compatible_body_suppresses_topk():
    """The reference's (gob/axiomhq) body never carries the sketch, as the
    JAX package's include_topk=False: such a forwarder says it cannot
    (supports_topk False), so the local emits its own top-k instead."""
    t = _local(_port_store, tparser.parse_metric, HOST_A)
    t.process_metric(tparser.parse_metric(b"g.c:3|c|#veneurglobalonly"))
    compat = HTTPForwarder("127.0.0.1:1", reference_compat=True)
    assert not compat.supports_topk
    assert HTTPForwarder("127.0.0.1:1").supports_topk
    final, fwd = t.flush([], HistogramAggregates.from_names(AGG), 0,
                         is_local=True, forward=True,
                         forward_topk=compat.supports_topk)
    assert fwd.topk is None
    assert {k[1][-1][4:]: v for k, v in
            _topk_rows(final.to_intermetrics()).items()} == {
        m: float(n) for m, n in HOST_A.items()}
    assert [d["type"] for d in compat.body(fwd)] == ["counter"]
    j = _local(_jax_store, jparser.parse_metric, HOST_A)
    _, jfwd = _topk_jax(j, is_local=True, forward=True)
    assert not any(d["type"] == "topk_sketch" for d in
                   jconvert.json_metrics_from_state(jfwd,
                                                    include_topk=False))
    assert not any(d["type"] == "topk_sketch" for d in
                   tconvert.json_metrics_from_state(fwd))


def test_convert_heavy_hitter_group():
    """A JAX group's sketch, sids, series and member memo, loaded into an
    empty port group, flush to the JAX group's rows; both then take the
    same further samples alike."""
    lines = _zipf_lines(3, series=6, samples=400)
    j = _jax_store()
    for line in lines:
        j.process_metric(jparser.parse_metric(line))
    g = j.heavy_hitters
    g._drain_samples()
    sk = g.sketch
    planes = {name: np.asarray(getattr(sk, name))
              for name in convert.COUNTMIN_PLANES}
    t = _port_store()
    n = len(g.interner)
    convert.load_heavy_hitter_group(
        t.heavy_hitters, planes,
        [(g.interner.names[r], g.interner.tags[r]) for r in range(n)],
        g._sids_np, g._members)
    with pytest.raises(ValueError, match="empty group"):
        convert.load_heavy_hitter_group(t.heavy_hitters, planes, [("x", [])],
                                        g._sids_np, {})
    more = _zipf_lines(4, series=6, samples=200)
    for line in more:
        if b"veneurtopk" in line:
            t.process_metric(tparser.parse_metric(line))
            j.process_metric(jparser.parse_metric(line))
    got, _ = _topk_port(t)
    assert got == _topk_jax(j)[0]


def test_sketch_lives_on_the_store_device():
    """The count-min state is allocated on the store's device (the CPU
    here; ``cuda`` when a Server or store is built without a device:
    tests/test_torch_cuda.py), and stays there through a drain."""
    t = _port_store()
    t.process_metric(tparser.parse_metric(b"d:a|s|#veneurtopk"))
    t.heavy_hitters._drain_samples()
    sk = t.heavy_hitters.sketch
    assert {x.device.type for x in (sk.table, sk.topk_hi, sk.topk_lo,
                                    sk.topk_counts, sk.sids)} == {"cpu"}
    assert sk.table.dtype == torch.float32
    assert sk.topk_hi.dtype == torch.int32
    assert collections.Counter(sk.topk_counts[0].tolist())[1.0] == 1
