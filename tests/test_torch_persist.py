"""The port's crash-safe state against the JAX package's.

* Format: the port's ``serialize`` writes the JAX package's bytes for the
  same snapshot dict, each ``deserialize`` reads the other's bytes, and a
  corrupt, truncated, bad-magic, bad-version or stale file raises
  ``CheckpointInvalid`` with the same ``reason`` in both.
* Snapshot parity: one seeded stream of lines goes into a JAX store and a
  port store on the CPU; their ``snapshot_state()`` dicts agree group by
  group: names and joined tags equal, scalars, HLL registers and the
  count-min table exact, the digest runs' mass within rtol 1e-6 a row
  (the cross-rung bound of ROADMAP.md) with the per-row stats and
  extrema exact, and every array of the JAX package's dtype.
* Cross restore: a checkpoint written by one package restores into the
  other (and the port's into itself) with the emissions of that
  package's uninterrupted twin, within rel 1e-4 (the JAX package's own
  round-trip bound); a group the restore skips fails the test.
* The Checkpointer, a port Server's warm restart, truncation, readiness
  and degradation, and the view-versus-copy point of the two-phase
  snapshot: a group changed between ``snapshot_begin`` and ``finish``
  still snapshots its earlier state.
"""

import logging
import os
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from veneur_tpu import persist as jpersist
from veneur_tpu.config import Config as JConfig
from veneur_tpu.core import store as jstore
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.samplers.intermetric import HistogramAggregates as JAggs
from veneur_tpu_torch import persist as tpersist
from veneur_tpu_torch.config import Config, config_from_dict
from veneur_tpu_torch.core import store as tstore
from veneur_tpu_torch.persist import Checkpointer
from veneur_tpu_torch.persist import checkpoint as tcheckpoint
from veneur_tpu_torch.resilience.faults import FaultInjector
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

PCTS = [0.5, 0.99]
AGGS = ["min", "max", "count", "sum", "avg", "hmean"]
TOPK = dict(topk_depth=4, topk_width=1 << 10, topk_k=8)


def traffic(seed: int = 3):
    """One seeded interval of every kind the snapshot covers: counters
    with rates, gauges, global-only scalars, histograms and timers in
    several scopes (some rows shift mid-stream, so the guard drains),
    sets, top-k sets and service checks."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(12):
        lines += [f"c.{i}:{int(rng.integers(1, 9))}|c|@0.5"
                  for _ in range(3)]
        lines.append(f"g.{i}:{rng.normal(0, 50):.4f}|g|#env:a")
    lines += ["gc:3|c|#veneurglobalonly", "gg:2.5|g|#veneurglobalonly"]
    for kind, t in (("h", "h"), ("t", "ms")):
        for i in range(16):
            scope = ("", "|#veneurlocalonly", "|#zone:b,env:a")[i % 3]
            vals = rng.gamma(2.0, 10.0, 24)
            if i % 4 == 0:
                vals[12:] += 500.0
            lines += [f"{kind}.{i}:{v:.5f}|{t}{scope}" for v in vals]
    for i in range(6):
        scope = "|#veneurlocalonly" if i % 2 else ""
        lines += [f"s.{i}:m{int(rng.integers(0, 30 + 9 * i))}|s{scope}"
                  for _ in range(25)]
    for i in range(4):
        lines += [f"hh.{i}:k{int(rng.zipf(1.5)) % 50}|s|#veneurtopk"
                  for _ in range(40)]
    lines += [f"_sc|check.{i}|{i % 3}|m:msg {i}" for i in range(3)]
    return [ln.encode() for ln in lines]


def _parse(parser, line):
    if line.startswith(b"_sc"):
        return parser.parse_service_check(line)
    return parser.parse_metric(line)


def jax_store(lines=(), **kw):
    s = jstore.MetricStore(initial_capacity=32, chunk=128, **TOPK, **kw)
    for ln in lines:
        s.process_metric(_parse(jparser, ln))
    return s


def port_store(lines=(), **kw):
    s = tstore.MetricStore(initial_capacity=32, chunk=128, device="cpu",
                           **TOPK, **kw)
    for ln in lines:
        s.process_metric(_parse(tparser, ln))
    return s


def jax_rows(store):
    out, _, _ = store.flush(PCTS, JAggs.from_names(AGGS), is_local=False,
                            now=7, forward=False, columnar=False)
    return {(m.name, tuple(m.tags)): m.value for m in out}


def port_rows(store):
    out, _ = store.flush(PCTS, HistogramAggregates.from_names(AGGS), 7)
    return {(m.name, tuple(m.tags)): m.value for m in out.to_intermetrics()}


STORES = {"jax": (jax_store, jax_rows, jpersist),
          "port": (port_store, port_rows, tpersist)}


def _assert_rows_close(got, want, rel=1e-4):
    assert set(got) == set(want)
    for key, v in want.items():
        if np.isnan(v):
            assert np.isnan(got[key]), key
        else:
            assert got[key] == pytest.approx(v, rel=rel, abs=1e-9), key


# -- the format ---------------------------------------------------------------


def _snapshot(pkg):
    make = STORES[pkg][0]
    groups, _ = make(traffic()).snapshot_state()
    return groups


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_serialize_bytes_equal_to_jax(pkg):
    groups = _snapshot(pkg)
    meta = {"hostname": "h1"}
    a = tpersist.serialize(groups, created_at=1234.5, interval=10.0,
                           meta=meta)
    b = jpersist.serialize(groups, created_at=1234.5, interval=10.0,
                           meta=meta)
    assert a == b
    assert len(a) > 1000


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_deserialize_each_other(writer, reader):
    groups = _snapshot(writer)
    blob = STORES[writer][2].serialize(groups, created_at=99.0,
                                       interval=5.0)
    got, manifest = STORES[reader][2].deserialize(blob)
    assert manifest["created_at"] == 99.0 and manifest["interval"] == 5.0
    assert set(got) == set(groups)
    for name, snap in groups.items():
        assert set(got[name]) == set(snap), name
        for k, v in snap.items():
            if isinstance(v, np.ndarray):
                assert got[name][k].dtype == v.dtype, (name, k)
                np.testing.assert_array_equal(got[name][k], v)
            else:
                assert got[name][k] == _jsonish(v), (name, k)


def _jsonish(v):
    """A value after a JSON round trip (tuples become lists)."""
    if isinstance(v, (list, tuple)):
        return [_jsonish(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonish(x) for k, x in v.items()}
    return v


CORRUPTIONS = [
    ("truncated", lambda b: b[: len(b) // 2]),
    ("crc_flip", lambda b: b[:60] + bytes([b[60] ^ 0xFF]) + b[61:]),
    ("bad_magic", lambda b: b"XXXX" + b[4:]),
    ("bad_version", lambda b: b[:4] + struct.pack("<H", 99) + b[6:]),
    ("garbage", lambda b: b"definitely not a checkpoint"),
    ("empty", lambda b: b""),
    ("header_only", lambda b: b[:10]),
]


@pytest.mark.parametrize("name,corrupt", CORRUPTIONS,
                         ids=[c[0] for c in CORRUPTIONS])
def test_malformed_same_reason(name, corrupt):
    blob = corrupt(tpersist.serialize(_snapshot("port"), created_at=1.0,
                                      interval=1.0))
    with pytest.raises(jpersist.CheckpointInvalid) as want:
        jpersist.deserialize(blob)
    with pytest.raises(tpersist.CheckpointInvalid) as got:
        tpersist.deserialize(blob)
    assert got.value.reason == want.value.reason


@pytest.mark.parametrize("name,corrupt", CORRUPTIONS,
                         ids=[c[0] for c in CORRUPTIONS])
def test_malformed_discarded_cleanly(tmp_path, name, corrupt):
    path = str(tmp_path / "v.ckpt")
    with open(path, "wb") as f:
        f.write(corrupt(tpersist.serialize(_snapshot("port"),
                                           created_at=time.time(),
                                           interval=1.0)))
    store = port_store()
    ck = Checkpointer(store, path, interval_s=1.0, max_age_s=3600)
    assert ck.restore() == 0          # counted, never raised
    assert ck.discard_total == 1
    assert not os.path.exists(path)
    assert port_rows(store) == {}     # nothing half-applied


def test_stale_checkpoint_discarded_in_both(tmp_path):
    groups = _snapshot("port")
    for pkg in ("jax", "port"):
        path = str(tmp_path / f"{pkg}.ckpt")
        jpersist.write_atomic(path, tpersist.serialize(
            groups, created_at=time.time() - 3600, interval=10.0))
        make, _, mod = STORES[pkg]
        ck = mod.Checkpointer(make(), path, interval_s=1.0, max_age_s=20.0)
        assert ck.restore() == 0
        assert ck.discard_total == 1
        assert not os.path.exists(path)


# -- snapshot parity ----------------------------------------------------------


def _row_mass(snap):
    n = len(snap["names"])
    return np.bincount(snap["rows"], weights=snap["weights"], minlength=n)


def test_snapshot_parity():
    lines = traffic()
    want, _ = jax_store(lines).snapshot_state()
    got, _ = port_store(lines).snapshot_state()
    # both stores carry the self-telemetry group (empty: no flush ran)
    assert set(want) == set(got)
    assert not want["self_timers"]["names"]
    assert not got["self_timers"]["names"]
    for name, g in got.items():
        w = want[name]
        assert g["kind"] == w["kind"], name
        assert g["names"] == w["names"], name
        assert g["joined"] == w["joined"], name
        assert set(g) == set(w), name
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert g[k].dtype == v.dtype, (name, k)
        if g["kind"] == "scalar":
            np.testing.assert_array_equal(g["values"], w["values"])
            for k in ("messages", "hostnames"):
                assert g.get(k) == w.get(k), (name, k)
        elif g["kind"] == "set":
            assert g["precision"] == w["precision"]
            if w["names"]:
                np.testing.assert_array_equal(g["registers"],
                                              w["registers"])
        elif g["kind"] == "topk":
            assert (g["depth"], g["width"]) == (w["depth"], w["width"])
            np.testing.assert_array_equal(g["table"], w["table"])
            assert _jsonish(g["series"]) == _jsonish(w["series"])
        elif w["names"]:
            for k in ("count", "vmin", "vmax", "mins", "maxs"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            for k in ("vsum", "recip"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-6)
            np.testing.assert_allclose(_row_mass(g), _row_mass(w),
                                       rtol=1e-6)
    assert sum(len(g["names"]) for g in got.values()) > 60


# -- cross restore -------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax"),
                                     ("port", "port")],
                         ids=["jax->port", "port->jax", "port->port"])
def test_cross_restore(src, dst, caplog):
    lines = traffic()
    make_src, _, src_mod = STORES[src]
    make_dst, rows_dst, dst_mod = STORES[dst]
    groups, _ = make_src(lines).snapshot_state()
    blob = src_mod.serialize(groups, created_at=time.time(), interval=10.0)
    restored = make_dst()
    with caplog.at_level(logging.WARNING, logger="veneur.store"):
        merged = restored.restore_state(dst_mod.deserialize(blob)[0])
    skipped = [r.getMessage() for r in caplog.records
               if r.name == "veneur.store"]
    assert not skipped, skipped
    assert merged == sum(len(g["names"]) for g in groups.values())
    got = rows_dst(restored)
    want = rows_dst(make_dst(lines))
    assert len(want) > 150
    _assert_rows_close(got, want)


STORAGE_PAIRS = [("dense", "slab"), ("slab", "tiered"), ("tiered", "dense"),
                 ("tiered", "slab"), ("slab", "dense"), ("dense", "tiered")]


def _storage_kw(storage):
    return dict(digest_storage=storage, slab_rows=64,
                tier_promote_samples=12, tier_promote_intervals=1)


def _assert_restored_match(got, want):
    """A port restore against the JAX package's restore of the same file:
    every row; percentiles within 0.02 x (max - min) (the cross-rung
    bound), every other row within rel 1e-4 (the round-trip bound)."""
    assert set(got) == set(want)
    for (name, tags), v in want.items():
        base, _, suffix = name.rpartition(".")
        if suffix.endswith("percentile"):
            span = want[(f"{base}.max", tags)] - want[(f"{base}.min", tags)]
            assert abs(got[(name, tags)] - v) <= 0.02 * span + 1e-6, name
        elif np.isnan(v):
            assert np.isnan(got[(name, tags)]), name
        else:
            assert got[(name, tags)] == pytest.approx(v, rel=1e-4,
                                                      abs=1e-9), name


@pytest.mark.parametrize("src", ["jax", "port"])
@pytest.mark.parametrize("src_storage,dst_storage", STORAGE_PAIRS,
                         ids=[f"{a}->{b}" for a, b in STORAGE_PAIRS])
def test_storage_cross_restore(src, src_storage, dst_storage):
    """A checkpoint of one package's store of one digest storage: both
    packages write the same VCKP bytes for it, and it restores into both
    packages' stores of another storage, which flush the same rows."""
    lines = traffic()
    groups, _ = STORES[src][0](lines, **_storage_kw(src_storage)) \
        .snapshot_state()
    blob = tpersist.serialize(groups, created_at=5.0, interval=10.0)
    assert blob == jpersist.serialize(groups, created_at=5.0, interval=10.0)
    rows = {}
    for pkg, (make, rows_of, mod) in STORES.items():
        store = make(**_storage_kw(dst_storage))
        assert store.restore_state(mod.deserialize(blob)[0]) == sum(
            len(g["names"]) for g in groups.values())
        rows[pkg] = rows_of(store)
    assert len(rows["jax"]) > 150
    _assert_restored_match(rows["port"], rows["jax"])


def test_restore_composes_with_live_traffic():
    groups, _ = port_store(traffic()).snapshot_state()
    restored = port_store()
    restored.restore_state(groups)
    restored.process_metric(tparser.parse_metric(b"c.0:2|c"))
    for v in (7000, 8000):
        restored.process_metric(tparser.parse_metric(f"h.3:{v}|h".encode()))
    twin = port_store(traffic())
    twin.process_metric(tparser.parse_metric(b"c.0:2|c"))
    for v in (7000, 8000):
        twin.process_metric(tparser.parse_metric(f"h.3:{v}|h".encode()))
    got, want = port_rows(restored), port_rows(twin)
    assert got[("h.3.max", ())] == 8000.0
    _assert_rows_close(got, want)


def test_hll_precision_mismatch_skips_only_sets(caplog):
    groups, _ = port_store(traffic(), hll_precision=12).snapshot_state()
    restored = port_store(hll_precision=14)
    with caplog.at_level(logging.WARNING, logger="veneur.store"):
        restored.restore_state(groups)
    assert any("precision" in r.getMessage() for r in caplog.records)
    rows = port_rows(restored)
    assert ("s.0", ()) not in rows
    assert ("c.0", ()) in rows


def test_snapshot_does_not_reset():
    store = port_store(traffic())
    store.snapshot_state()
    _assert_rows_close(port_rows(store), port_rows(port_store(traffic())))


# -- the two-phase snapshot: copies, not views ---------------------------------


def test_snapshot_holds_the_state_of_its_begin():
    """A torch slice is a view and ingest updates the temp planes, the
    extrema and the registers in place: a snapshot whose fetch ran after
    more ingest must still hold the state of its begin."""
    lines = traffic()
    store = port_store(lines)
    want, _ = port_store(lines).snapshot_state()
    finishes = {}
    with store._lock:
        for name in store._GEN_GROUPS:
            finishes[name] = getattr(store, name).snapshot_begin()
    # more ingest into every device group, drained into the planes
    more = [b"h.1:9999|h", b"t.2:-5|ms", b"s.0:zz|s",
            b"hh.0:k1|s|#veneurtopk"] * 200
    for ln in more:
        store.process_metric(tparser.parse_metric(ln))
    with store._lock:
        for name in ("histograms", "timers", "sets", "heavy_hitters"):
            getattr(store, name)._drain_staging()
        store.histograms.import_centroids_bulk(
            np.zeros(4, np.int32), np.full(4, 1e6), np.ones(4),
            np.zeros(1, np.int32), np.full(1, -1e6, np.float32),
            np.full(1, 1e6, np.float32))
        store.histograms._drain_imports()
    for name, (snap, finish) in finishes.items():
        if finish is not None:
            finish()
        w = want[name]
        assert set(snap) == set(w), name
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(snap[k], v, err_msg=(name, k))
            else:
                assert _jsonish(snap[k]) == _jsonish(v), (name, k)


def test_device_fetch_runs_off_lock(monkeypatch):
    store = port_store(traffic())
    held = []
    real = tstore._fetch_copies

    def spying(copies, event):
        held.append(store._lock._is_owned())
        return real(copies, event)

    monkeypatch.setattr(tstore, "_fetch_copies", spying)
    groups, _ = store.snapshot_state()
    assert held and not any(held)
    assert "means" in groups["histograms"]
    assert "registers" in groups["sets"]
    assert "table" in groups["heavy_hitters"]


# -- the Checkpointer ----------------------------------------------------------


def test_atomic_write_leaves_no_scratch(tmp_path):
    path = str(tmp_path / "v.ckpt")
    ck = Checkpointer(port_store(traffic()), path, 1.0, 3600)
    assert ck.write_once()
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")
    assert ck.last_write_bytes == os.path.getsize(path)
    assert ck.last_write_duration_s > 0
    # the JAX package reads it
    groups, _ = jpersist.deserialize(jpersist.read_file(path))
    assert groups["counters"]["names"]


def test_restore_merges_once_and_repersists(tmp_path):
    path = str(tmp_path / "v.ckpt")
    Checkpointer(port_store(traffic()), path, 1.0, 3600).write_once()
    fresh = port_store()
    ck = Checkpointer(fresh, path, 1.0, 3600)
    assert ck.restore() > 0 and ck.restore_total == 1
    assert os.path.exists(path)       # re-persisted from the merged store
    assert ck.restore() == 0          # at most once a process
    _assert_rows_close(port_rows(fresh), port_rows(port_store(traffic())))


def test_crash_loop_survives_repeated_restores(tmp_path):
    path = str(tmp_path / "v.ckpt")
    Checkpointer(port_store(traffic()), path, 1.0, 3600).write_once()
    for _ in range(3):
        fresh = port_store()
        assert Checkpointer(fresh, path, 1.0, 3600).restore() > 0
    _assert_rows_close(port_rows(fresh), port_rows(port_store(traffic())))


def test_flush_epoch_guard_discards_racing_write(tmp_path):
    path = str(tmp_path / "v.ckpt")
    store = port_store(traffic())
    ck = Checkpointer(store, path, 1.0, 3600)
    real = store.snapshot_state
    groups, epoch = real()
    port_rows(store)  # a flush drains the snapshotted state
    store.snapshot_state = lambda: (groups, epoch)
    assert ck.write_once() is False
    assert ck.discarded_writes == 1
    assert not os.path.exists(path)
    store.snapshot_state = real
    assert ck.write_once() is True   # a post-flush snapshot commits


def test_flush_landing_mid_write_removes_stale_file(tmp_path, monkeypatch):
    path = str(tmp_path / "v.ckpt")
    store = port_store(traffic())
    ck = Checkpointer(store, path, 1.0, 3600)
    real = tcheckpoint.ckpt_format.write_atomic

    def racing_write(p, blob):
        n = real(p, blob)
        store.flush_epoch += 1  # a flush lands mid-write
        return n

    monkeypatch.setattr(tcheckpoint.ckpt_format, "write_atomic",
                        racing_write)
    assert ck.write_once() is False
    assert ck.discarded_writes == 1
    assert not os.path.exists(path)


def test_nonblocking_truncate_skips_behind_held_lock(tmp_path):
    path = str(tmp_path / "v.ckpt")
    ck = Checkpointer(port_store(traffic()), path, 1.0, 3600)
    assert ck.write_once()
    with ck._io_lock:  # a write is in flight
        assert ck.truncate(blocking=False) is False
        assert os.path.exists(path)
    assert ck.truncate(blocking=False) is True
    assert not os.path.exists(path)


def test_enospc_commit_never_raises_and_heals(tmp_path):
    path = str(tmp_path / "v.ckpt")
    inj = FaultInjector(rate=1.0, seed=3, kinds=("disk_full",))
    ck = Checkpointer(port_store(traffic()), path, 1.0, 3600,
                      write_fn=inj.wrap_write(tpersist.write_atomic,
                                              "checkpoint.write"))
    with open(path + ".tmp", "wb") as f:
        f.write(b"partial")
    assert ck.write_once() is False   # refused, not raised
    assert ck.write_errors == 1 and "disk full" in ck.last_error
    assert not os.path.exists(path + ".tmp")
    assert not os.path.exists(path)
    ck._write_fn = tpersist.write_atomic
    assert ck.write_once() is True
    assert ck.last_error is None and os.path.exists(path)


def test_write_failure_is_visible(tmp_path):
    path = str(tmp_path / "missing-dir" / "v.ckpt")
    ck = Checkpointer(port_store(), path, interval_s=0.01, max_age_s=3600)
    stop = threading.Event()
    t = threading.Thread(target=ck.run, args=(stop,), daemon=True)
    t.start()
    deadline = time.time() + 5.0
    while ck.write_errors == 0 and time.time() < deadline:
        time.sleep(0.01)
    stop.set()
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert ck.write_errors >= 1 and ck.last_error
    assert ck.age_seconds() > 0.0


# -- config --------------------------------------------------------------------


def test_config_keys_load_with_the_jax_defaults():
    data = {"checkpoint_path": "/x/v.ckpt", "checkpoint_interval": "500ms",
            "compute_breaker_reset_timeout": "",
            "fault_injection_rate": 0.5, "fault_injection_seed": 4,
            "fault_injection_kinds": "disk_full,deadline_pressure",
            "fault_injection_scope": "checkpoint"}
    cfg = config_from_dict(data)
    ref = JConfig(**data).apply_defaults()
    assert cfg.checkpoint_interval_seconds == pytest.approx(0.5)
    for k in ("checkpoint_interval_seconds", "checkpoint_max_age_intervals",
              "compute_breaker_failure_threshold",
              "compute_breaker_reset_timeout_seconds"):
        assert getattr(cfg, k) == getattr(ref, k), k
    with pytest.raises(ValueError):
        Config(checkpoint_interval="nonsense")
    with pytest.raises(ValueError, match="checkpoint_max_age_intervals"):
        Config(checkpoint_max_age_intervals=-1.0)
    with pytest.raises(ValueError, match="compute_breaker"):
        Config(compute_breaker_failure_threshold=-1)
    with pytest.raises(ValueError, match="fault_injection_rate"):
        Config(fault_injection_rate=2.0)
    with pytest.raises(ValueError, match="unknown fault_injection_kinds"):
        Config(fault_injection_kinds="nope")


@pytest.mark.parametrize("kinds", ["", "http_5xx", "disk_full,truncate"])
def test_unported_fault_kinds_refused(kinds):
    """Every kind has its hook in the port, so each kind set loads (it
    was refused while the transport and ingest hooks were missing), and
    a Server arms the injectors the JAX Server arms for it: the ingest
    one for an ingest kind, the soak one for a soak kind, each with the
    configured kinds in their order; the transport kinds go to the
    forwarder's and the sinks' injectors (from_config), the same kinds as
    the JAX package's. Rate 0 keeps every kind off."""
    from veneur_tpu.resilience import faults as jfaults
    from veneur_tpu.server import Server as JServer
    from veneur_tpu_torch.resilience import faults as rfaults

    data = dict(fault_injection_rate=0.1, fault_injection_kinds=kinds,
                fault_injection_seed=3, interval="86400s",
                store_initial_capacity=32, store_chunk=128)
    ours = Server(Config(**data), device="cpu")
    theirs = JServer(JConfig(**data))
    for attr in ("ingest_injector", "soak_injector"):
        mine, ref = getattr(ours, attr), getattr(theirs, attr)
        assert (mine is None) == (ref is None), attr
        if ref is not None:
            assert (mine.kinds, mine.rate, mine.seed) == (
                ref.kinds, ref.rate, ref.seed), attr
    assert rfaults.from_config(Config(**data)).kinds == \
        jfaults.from_config(JConfig(**data)).kinds
    off = Server(Config(**dict(data, fault_injection_rate=0.0)),
                 device="cpu")
    assert off.ingest_injector is None and off.soak_injector is None


# -- the Server ----------------------------------------------------------------


def make_server(**cfg):
    cfg.setdefault("interval", "86400s")
    cfg.setdefault("store_initial_capacity", 32)
    cfg.setdefault("store_chunk", 128)
    cfg.setdefault("aggregates", ["min", "max", "count"])
    cfg.setdefault("percentiles", [0.5])
    cfg.setdefault("flush_columnar", False)
    sink = ChannelMetricSink()
    return Server(Config(**cfg), metric_sinks=[sink], device="cpu"), sink


def _flushed(sink):
    return {m.name: m.value for m in sink.get_flush()}


def test_server_derives_checkpoint_cadence_from_interval(tmp_path):
    server, _ = make_server(interval="20s",
                            checkpoint_path=str(tmp_path / "v.ckpt"))
    assert server.checkpointer.interval_s == pytest.approx(5.0)
    assert server.checkpointer.max_age_s == pytest.approx(40.0)


def test_warm_restart_recovers_and_clean_flush_truncates(tmp_path):
    path = str(tmp_path / "v.ckpt")
    crashed, _ = make_server(checkpoint_path=path,
                             checkpoint_interval="3600s")
    crashed.store.process_metric(tparser.parse_metric(b"c1:7|c"))
    for v in range(1, 11):
        crashed.store.process_metric(
            tparser.parse_metric(f"lat:{v}|ms".encode()))
    assert crashed.checkpointer.write_once()

    server, sink = make_server(checkpoint_path=path,
                               checkpoint_interval="3600s")
    server.start()
    try:
        assert server.checkpointer.restore_total == 1
        server.flush()
        batch = _flushed(sink)
        assert batch["c1"] == 7.0
        assert batch["lat.count"] == 10.0
        assert batch["lat.50percentile"] == pytest.approx(5.5)
        assert not os.path.exists(path)   # the flush truncated it
        assert server.last_flush_ok
    finally:
        server.shutdown()


def _covers(groups, want) -> bool:
    """Whether a committed checkpoint holds all of ``want`` (a snapshot
    of the store once its traffic is in): every series, every digest
    sample and scalar value, every register and count-min cell."""
    for name, w in want.items():
        g = groups[name]
        if g["names"] != w["names"]:
            return False
        for k in ("values", "count", "registers", "table"):
            if k in w and not np.array_equal(g[k], w[k]):
                return False
    return True


def test_crash_stop_then_restart_recovers_the_checkpoint(tmp_path):
    """A kill without a flush: the restart recovers what the last
    checkpoint committed, and the final flush of a clean shutdown lands
    it and truncates the file."""
    path = str(tmp_path / "v.ckpt")
    lines = traffic()
    first, _ = make_server(checkpoint_path=path, checkpoint_interval="50ms",
                           statsd_listen_addresses=["udp://127.0.0.1:0"],
                           **TOPK)
    first.start()
    # the feed holds the store lock, so no checkpoint snapshot drains
    # the staging mid-feed: the top-k candidates then depend on the
    # drain points, which must be the twin's
    with first.store._lock:
        for ln in lines:
            first.store.process_metric(_parse(tparser, ln))
    want, _ = first.store.snapshot_state()
    deadline = time.time() + 30
    while True:
        blob = tpersist.read_file(path)
        if blob is not None and _covers(tpersist.deserialize(blob)[0], want):
            break
        assert time.time() < deadline, "no checkpoint covered the data"
        time.sleep(0.02)
    first.crash_stop()
    assert os.path.exists(path)

    second, sink = make_server(checkpoint_path=path,
                               checkpoint_interval="3600s", **TOPK)
    second.start()
    assert second.checkpointer.restore_total == 1
    second.shutdown()
    assert not os.path.exists(path)
    got = {(m.name, tuple(m.tags)): m.value for m in sink.get_flush()}
    twin = port_store(lines)
    want_rows = {(m.name, tuple(m.tags)): m.value
                 for m in twin.flush([0.5], HistogramAggregates.from_names(
                     ["min", "max", "count"]), 7)[0].to_intermetrics()}
    _assert_rows_close(got, want_rows)


def test_malformed_checkpoint_never_prevents_startup(tmp_path):
    path = str(tmp_path / "v.ckpt")
    with open(path, "wb") as f:
        f.write(b"\x00" * 1000)
    server, sink = make_server(checkpoint_path=path)
    server.start()
    try:
        assert server.checkpointer.discard_total == 1
        server.store.process_metric(tparser.parse_metric(b"ok:1|c"))
        server.flush()
        assert _flushed(sink)["ok"] == 1.0
    finally:
        server.shutdown()


def test_clean_shutdown_truncates_checkpoint(tmp_path):
    path = str(tmp_path / "v.ckpt")
    server, sink = make_server(checkpoint_path=path,
                               checkpoint_interval="3600s")
    server.start()
    server.store.process_metric(tparser.parse_metric(b"c1:3|c"))
    assert server.checkpointer.write_once()
    server.shutdown()
    assert not os.path.exists(path)
    assert _flushed(sink)["c1"] == 3.0


def _get(url):
    try:
        with urllib.request.urlopen(url) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_ready_flips_503_on_stale_flush_and_names_degradation(tmp_path):
    server, _ = make_server(
        interval="10s", http_address="127.0.0.1:0",
        checkpoint_path=str(tmp_path / "v.ckpt"),
        checkpoint_interval="3600s", fault_injection_rate=1.0,
        fault_injection_kinds="disk_full")
    server.start()
    try:
        base = f"http://127.0.0.1:{server.ops_server.port}"
        assert _get(f"{base}/healthcheck/ready") == (200, "ready")
        server.store.process_metric(tparser.parse_metric(b"c:1|c"))
        assert server.checkpointer.write_once() is False  # disk full
        status, body = _get(f"{base}/healthcheck/ready")
        assert status == 200
        assert body.startswith("ready (degraded: checkpoint writes "
                               "failing")
        server.flush()
        server.last_flush_time = time.time() - 25.0
        assert not server.is_ready()
        status, body = _get(f"{base}/healthcheck/ready")
        assert status == 503 and "degraded" in body
        assert _get(f"{base}/healthcheck") == (200, "ok")
    finally:
        server.shutdown()


def test_open_compute_breaker_degrades_readiness():
    server, _ = make_server()
    assert server.degradation() == []
    for _ in range(server.config.compute_breaker_failure_threshold):
        server.store.compute.record_failure()
    assert any(d.startswith("compute breaker compute.tdigest_merge open")
               for d in server.degradation())


def test_deadline_pressure_shrinks_the_flush_budget(monkeypatch):
    from veneur_tpu_torch import flusher

    server, _ = make_server(interval="10s", fault_injection_rate=1.0,
                            fault_injection_kinds="deadline_pressure")
    seen = []
    real = flusher.Deadline.after
    monkeypatch.setattr(flusher.Deadline, "after",
                        lambda s, *a: seen.append(s) or real(s, *a))
    server.store.process_metric(tparser.parse_metric(b"c:1|c"))
    server.flush()
    assert seen[0] == pytest.approx(10.0 * 0.05)
    assert server.soak_injector.injected["deadline_pressure"] == 1
