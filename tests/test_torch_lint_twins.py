"""The port's runtime ledger twins (``veneur_tpu_torch/lint/``) on the CPU.

* ``LedgerAudit``: the JAX package's recorder and the port's, driven by
  the same counter sequences, record equal timelines and equal
  violation messages; ``for_fleet`` over the port's lane fleet settles
  clean with records staged, sealed and merged, and names the term that
  lost a record; ``for_soak_ledger`` reads a ``SoakLedger``.
* ``BufferCensus`` over torch tensors: a retained 32 MiB tensor (or a
  retained 4,096-row store's planes) past an 8 MiB tolerance is a
  violation that names the program its interval dispatched; released,
  a census settles within the tolerance. A storage viewed by several
  tensors counts once. The bounds are exact byte counts, so the
  tolerance only absorbs tensors other threads of the test process may
  hold for a moment.
"""

import gc

import numpy as np
import pytest
import torch

from veneur_tpu.lint import ledger_audit as jaudit
from veneur_tpu.soak.gates import SoakLedger as JLedger
from veneur_tpu_torch.core import store as tstore
from veneur_tpu_torch.ingest import IngestFleet
from veneur_tpu_torch.lint import buffer_census as tcensus
from veneur_tpu_torch.lint import ledger_audit as taudit
from veneur_tpu_torch.protocol.addr import resolve_addr
from veneur_tpu_torch.soak.gates import SoakLedger as TLedger

MIB = 1 << 20


# -- LedgerAudit --------------------------------------------------------------


def _drive(pkg):
    vals = {"a": 0, "b": 0, "c": 0}
    audit = pkg.LedgerAudit("twin")
    audit.register("a", "in", lambda: vals["a"])
    audit.register("b", "out", lambda: vals["b"])
    audit.register("c", "out", lambda: vals["c"])
    rng = np.random.default_rng(5)
    for i in range(30):
        n = int(rng.integers(0, 9))
        vals["a"] += n
        vals["b"] += n - int(i % 7 == 3)
        vals["c"] += int(i % 7 == 3) * int(i % 2)
        audit.snapshot(label=f"i{i}", settled=bool(i % 3 == 0))
    return audit


def test_ledger_audit_equals_jax():
    j, t = _drive(jaudit), _drive(taudit)
    assert j.timeline() == t.timeline()
    assert [str(v) for v in j.violations] == [str(v) for v in t.violations]
    assert t.violations  # the dropped records show
    with pytest.raises(AssertionError, match="conservation violation"):
        t.assert_clean()
    with pytest.raises(ValueError):
        t.register("a", "in", lambda: 0)
    with pytest.raises(ValueError):
        t.register("d", "sideways", lambda: 0)


def test_for_soak_ledger_reads_the_ledger():
    for pkg, ledger in ((jaudit, JLedger()), (taudit, TLedger())):
        audit = pkg.for_soak_ledger(ledger)
        ledger.sent_global, ledger.emitted_global = 100, 90
        ledger.shed, ledger.quarantined, ledger.accounted_lost = 4, 3, 3
        assert audit.snapshot(label="end").ok is True
        ledger.emitted_global -= 1
        assert audit.snapshot(label="short").ok is False
    assert str(taudit.for_soak_ledger(TLedger()).name) == "soak-global"


def _fleet(store):
    return IngestFleet(store, resolve_addr("udp://127.0.0.1:0"), 2,
                       1 << 20, 4096, chunk_records=256)


def _lines(n):
    return [f"lt.c.{i % 13}:1|c" if i % 3 else f"lt.h.{i % 11}:{i}|h"
            for i in range(n)] + ["lt.bad:nan|c"] * 5


def _stage(lane, lines):
    if lane.using_native:
        lane._stage_native([ln.encode() for ln in lines])
    else:
        lane._stage_python([ln.encode() for ln in lines])


def test_for_fleet_settles_on_the_port_lane_fleet():
    store = tstore.MetricStore(initial_capacity=32, chunk=128,
                               device="cpu")
    fleet = _fleet(store)
    audit = taudit.for_fleet(fleet)
    try:
        lines = _lines(900)
        for lane in fleet.lanes:
            _stage(lane, lines)
        # staged and sealed records count as pending: the identity holds
        # before the merge too
        mid = audit.snapshot(label="staged", settled=True)
        assert mid.ok and mid.values["pending"] > 0
        for lane in fleet.lanes:
            lane._seal()
        fleet.merge_sealed()
        end = audit.snapshot(label="merged", settled=True)
        assert end.ok and end.values["pending"] == 0
        assert end.values["parsed"] == end.values["merged"] + \
            end.values["quarantined"] + end.values["shed"]
        assert end.values["merged"] > 0
        # a record the merger lost is named by its terms
        lane0 = fleet.lanes[0].lane_id
        fleet.merged_records[lane0] -= 1
        bad = audit.snapshot(label="lost", settled=True)
        assert bad.ok is False
        msg = str(audit.violations[-1])
        assert "unaccounted +1" in msg and "merged=" in msg
    finally:
        fleet.shutdown()


# -- BufferCensus -------------------------------------------------------------


def test_census_catches_a_retained_tensor_and_settles_without_it():
    census = tcensus.BufferCensus("retained", tolerance_bytes=8 * MIB,
                                  device="cpu")
    census.arm()
    held = [torch.zeros(8 * MIB, dtype=torch.float32)]  # 32 MiB
    census.sample(label="interval-0", programs=("leaky_flush",))
    snap = census.settle()
    assert snap.ok is False and census.growth_bytes() >= 32 * MIB
    msg = str(census.violations[0])
    assert "leaky_flush" in msg and "retained" in msg
    with pytest.raises(AssertionError, match="census violation"):
        census.assert_clean()

    clean = tcensus.BufferCensus("released", tolerance_bytes=8 * MIB,
                                 device="cpu")
    clean.arm()
    tmp = torch.zeros(8 * MIB, dtype=torch.float32)
    assert clean.sample(label="interval-0").delta_bytes >= 32 * MIB
    del tmp, held
    snap = clean.settle()
    assert snap.ok is True and clean.settled_ok()
    assert clean.growth_bytes() <= 8 * MIB
    clean.assert_clean()
    keys = set(clean.timeline()[-1])
    assert keys == {"idx", "label", "bytes_live", "count_live",
                    "delta_bytes", "delta_count", "programs", "settled",
                    "ok", "allocated"}
    assert clean.timeline()[-1]["allocated"] is None  # a CPU census


def test_census_sees_a_retired_stores_planes_until_released():
    census = tcensus.BufferCensus("store", tolerance_bytes=1 * MIB,
                                  device="cpu")
    census.arm()
    store = tstore.MetricStore(initial_capacity=4096, chunk=128,
                               device="cpu")
    census.sample(label="built", programs=("flush_global",))
    census.settle(label="held")
    assert census.violations and "flush_global" in str(census.violations[0])
    held = census.samples[-1].bytes_live - census.samples[0].bytes_live
    assert held > 4096 * 104 * 4 * 2  # a digest's two [S, K] planes at least
    del store
    again = tcensus.BufferCensus("store", tolerance_bytes=1 * MIB,
                                 device="cpu")
    again.arm()
    gc.collect()
    assert again.settle().ok is True


def test_a_storage_counts_once_however_many_views():
    base = torch.zeros(1 << 18, dtype=torch.float32)  # 1 MiB
    views = [base[::2], base.view(512, 512), base[10:]]
    b0, c0 = tcensus.live_storage("cpu")
    del views
    b1, c1 = tcensus.live_storage("cpu")
    del base
    b2, _ = tcensus.live_storage("cpu")
    assert b0 == b1 and c0 == c1
    assert b1 - b2 == 1 << 20


def test_census_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is cuda there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcensus.BufferCensus()
