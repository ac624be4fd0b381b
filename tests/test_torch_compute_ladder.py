"""The port's compute ladder against the JAX package's (tests/test_overload.py
TestComputeLadder), under the same fault schedule:

* a kernel failure at launch or fetch re-merges the retired digest group
  into the live store (rung 3): the interval emits at the next flush,
  its counts conserved, counted in ``requeued_total``;
* the breaker opens after ``failure_threshold`` failures (flushes then
  re-merge without a launch) and one probe after the reset timeout
  closes it, emitting every interval held meanwhile;
* a generation no rung saved is counted in ``lost_total``.

Pinned difference: the JAX package's rung 2 (the same program on XLA)
has no counterpart in the port, where a CUDA tensor reaches the kernel
or nothing. Where the JAX package completes an interval on rung 2, the
port emits the same interval one flush later, and the two emissions are
compared.

The fault is injected by patching each package's ``_flush_digests`` (or
the port's fetch) to raise, or through the breaker's ``preflight`` with
a ``FaultInjector``.
"""

import types

import numpy as np
import pytest
import torch

import veneur_tpu.core.store as jstore
from veneur_tpu.resilience.compute import ComputeBreaker as JBreaker
from veneur_tpu.resilience.faults import FaultInjector as JFaultInjector
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.samplers.intermetric import HistogramAggregates as JAggs
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.core import store as tstore
from veneur_tpu_torch.ops import tdigest_cuda
from veneur_tpu_torch.resilience.compute import ComputeBreaker
from veneur_tpu_torch.resilience.faults import FaultInjector
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates
from veneur_tpu_torch.server import Server

AGGS = ["min", "max", "count", "sum"]


def _lines(n, seed=7):
    rng = np.random.default_rng(seed)
    return [b"lat:%f|h" % v for v in rng.normal(100.0, 15.0, n)] + \
        [b"c:1|c", b"s:a|s"]


def _digest_rows(rows):
    return {n: v for n, v in rows.items() if n.startswith("lat.")}


class Side:
    """One package's store, flush and fault hook."""

    def __init__(self, pkg, clock, threshold=2, depth=2):
        self.pkg = pkg
        if pkg == "jax":
            self.mod, self.parser = jstore, jparser
            self.store = jstore.MetricStore(
                flush_pipeline_depth=depth,
                compute=JBreaker(failure_threshold=threshold,
                                 reset_timeout=30.0, clock=clock))
        else:
            self.mod, self.parser = tstore, tparser
            self.store = tstore.MetricStore(
                flush_pipeline_depth=depth, device="cpu",
                compute=ComputeBreaker(failure_threshold=threshold,
                                       reset_timeout=30.0, clock=clock))
        self.calls = []

    def ingest(self, n, seed=7):
        for ln in _lines(n, seed):
            self.store.process_metric(self.parser.parse_metric(ln))

    def flush(self):
        if self.pkg == "jax":
            out, _, _ = self.store.flush([0.5], JAggs.from_names(AGGS),
                                         is_local=False, now=1)
        else:
            flushed, _ = self.store.flush(
                [0.5], HistogramAggregates.from_names(AGGS), 1)
            out = flushed.to_intermetrics()
        return {m.name: m.value for m in out}

    def arm(self, monkeypatch, fail_on=lambda kernel: kernel,
            phase="dispatch"):
        """Fail the kernel rung: the JAX package's ``_flush_digests``
        when ``fail_on(use_pallas)``; the port's ``_flush_digests``
        (dispatch) or its fetch every time."""
        if self.pkg == "jax":
            orig = self.mod._flush_digests

            def raiser(*args):
                self.calls.append(args[-1])
                if fail_on(args[-1]):
                    raise RuntimeError("injected kernel failure")
                return orig(*args)

            monkeypatch.setattr(self.mod, "_flush_digests", raiser)
            return

        def fail(*args, **kwargs):
            self.calls.append(phase)
            raise RuntimeError("injected kernel failure")

        if phase == "dispatch":
            monkeypatch.setattr(self.mod, "_flush_digests", fail)
        else:
            monkeypatch.setattr(self.mod.DigestGroup, "_flush_collect", fail)

    def is_open(self):
        c = self.store.compute
        if self.pkg == "jax":
            return c.degraded()
        return any(gauge for _, gauge in c.states())

    def tallies(self):
        c = self.store.compute
        return (c.requeued_total, c.lost_total, self.is_open())


@pytest.fixture
def sides(fake_clock):
    def make(**kw):
        return [Side(p, fake_clock, **kw) for p in ("jax", "port")]
    return make


def _assert_same_interval(got, want):
    """The port's late emission of an interval against the JAX
    package's on-time one: counts, sums and extrema exact up to f32,
    the median within the checkpoint round trip's rel 1e-4."""
    assert set(got) == set(want) and want
    for name, v in want.items():
        assert got[name] == pytest.approx(v, rel=1e-4), name


@pytest.mark.parametrize("phase", ["dispatch", "fetch"])
@pytest.mark.parametrize("depth", [0, 2], ids=["sequential", "pipelined"])
def test_kernel_failure_requeues_the_interval(sides, monkeypatch, depth,
                                              phase):
    jax, port = sides(depth=depth)
    for side in (jax, port):
        side.ingest(64)
    with monkeypatch.context() as m:
        jax.arm(m)
        port.arm(m, phase=phase)
        want = _digest_rows(jax.flush())        # JAX: rung 2, on time
        first = port.flush()
    assert jax.calls == [True, False]
    assert port.calls == [phase]
    assert not _digest_rows(first) and first["c"] == 1.0
    assert port.tallies() == (1, 0, False)  # threshold 2: still closed
    assert jax.store.compute.fallback_total == 1
    _assert_same_interval(_digest_rows(port.flush()), want)  # late


def test_preflight_fault_requeues_the_interval(sides):
    """A FaultInjector armed on the breaker fails rung 1 before the
    launch: the JAX package completes the interval on rung 2, the port
    re-merges it and emits it at the next flush."""
    jax, port = sides()
    rows = {}
    for side in (jax, port):
        injector = FaultInjector if side.pkg == "port" else JFaultInjector
        side.store.compute.injector = injector(
            rate=1.0, seed=1, kinds=("connect",),
            scope="compute.tdigest_merge")
        side.ingest(64)
        rows[side.pkg] = _digest_rows(side.flush())
        assert side.store.compute.injector.calls == 1
        side.store.compute.injector = None
    assert rows["jax"]["lat.count"] == 64.0 and not rows["port"]
    assert port.tallies() == (1, 0, False)
    _assert_same_interval(_digest_rows(port.flush()), rows["jax"])


def test_breaker_opens_then_recovers(sides, fake_clock, monkeypatch):
    emitted = {}
    jax, port = sides()
    for side in (jax, port):
        counts = []
        with monkeypatch.context() as m:
            side.arm(m)
            for _ in range(2):
                side.ingest(16)
                counts.append(side.flush().get("lat.count", 0.0))
            assert side.is_open()                  # open after 2 failures
            before = len(side.calls)
            side.ingest(16)
            counts.append(side.flush().get("lat.count", 0.0))
            # no doomed launch: the JAX package goes straight to rung 2,
            # the port re-merges without touching the kernel
            assert side.calls[before:] == ([False] if side.pkg == "jax"
                                           else [])
        fake_clock.advance(60.0)
        side.ingest(16)
        counts.append(side.flush()["lat.count"])
        assert not side.is_open()                  # the probe closed it
        fake_clock.advance(-60.0)
        emitted[side.pkg] = counts
        assert side.tallies()[1:] == (0, False)
    assert emitted["jax"] == [16.0] * 4
    assert emitted["port"] == [0.0, 0.0, 0.0, 64.0]   # late, never lost
    assert jax.store.compute.fallback_total == 3
    assert port.store.compute.requeued_total == 3


def test_staging_drains_never_spend_the_probe(fake_clock, monkeypatch):
    """Ingest goes on through the staging drains while the breaker is
    open, and they never consume its half-open probe: only a flush
    probes."""
    side = Side("port", fake_clock, threshold=1)
    drains = []
    real = tstore._ingest_samples

    def spy(*args):
        drains.append(len(args))
        return real(*args)

    monkeypatch.setattr(tstore, "_ingest_samples", spy)
    side.store.compute.record_failure()            # open (threshold 1)
    side.ingest(16)
    with side.store._lock:
        side.store.histograms._drain_staging()
    assert drains and side.is_open()
    fake_clock.advance(60.0)
    assert side.store.compute.probe() is True      # probe still unspent


@pytest.mark.parametrize("depth", [0, 2], ids=["sequential", "pipelined"])
def test_rung3_requeues_interval_late_not_lost(sides, fake_clock,
                                               monkeypatch, depth):
    outcomes = []
    for side in sides(threshold=1, depth=depth):
        side.ingest(32)
        with monkeypatch.context() as m:
            side.arm(m, fail_on=lambda kernel: True)
            rows = side.flush()
        # this interval's histograms did not emit, the rest did
        assert not _digest_rows(rows)
        assert rows["c"] == 1.0
        assert side.store.compute.requeued_total == 1
        fake_clock.advance(60.0)
        rows = side.flush()
        assert rows["lat.count"] == 32.0           # late, never lost
        fake_clock.advance(-60.0)
        outcomes.append(side.tallies())
    assert outcomes[0] == outcomes[1] == (1, 0, False)


def test_lost_when_the_re_merge_fails_too(fake_clock, monkeypatch):
    side = Side("port", fake_clock, threshold=1)
    side.ingest(32)
    side.arm(monkeypatch)
    monkeypatch.setattr(tstore.DigestGroup, "snapshot_state",
                        lambda self: (_ for _ in ()).throw(
                            RuntimeError("poisoned context")))
    rows = side.flush()
    assert rows["c"] == 1.0
    assert side.tallies()[:2] == (0, 1)


def test_non_digest_unit_failure_propagates(fake_clock, monkeypatch):
    side = Side("port", fake_clock)
    side.ingest(8)
    monkeypatch.setattr(tstore.SetGroup, "flush_begin",
                        lambda self, *a, **k: (_ for _ in ()).throw(
                            RuntimeError("set flush failed")))
    with pytest.raises(RuntimeError, match="set flush failed"):
        side.flush()
    assert side.tallies()[:2] == (0, 0)


def test_gate_sends_cuda_tensors_to_the_kernel():
    """The gate: CUDA tensors go to the kernel, CPU tensors to the plain
    version, mixed devices raise; there is no switch around it."""
    cuda = types.SimpleNamespace(device=torch.device("cuda", 0))
    cpu = torch.zeros(1)
    assert tdigest_cuda._use_kernel(cuda, cuda) is True
    assert tdigest_cuda._use_kernel(cpu, cpu) is False
    with pytest.raises(ValueError):
        tdigest_cuda._use_kernel(cuda, cpu)


def test_kernel_library_failure_raises_at_start(monkeypatch):
    """Pinned difference from the JAX package: the kernel library loads
    when a Server starts on the card, so a build or load failure raises
    there and never reaches a flush."""
    server = Server(Config(interval="3600s"), device="cpu")
    server.store.device = torch.device("cuda", 0)

    def no_library():
        raise RuntimeError("kernel build failed: nvcc exited 1")

    monkeypatch.setattr(tdigest_cuda, "_kernel_lib", no_library)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        server.start()
    assert not server._threads and not server._span_threads
    assert server.store.compute.requeued_total == 0


def _storage_store(storage, clock):
    return tstore.MetricStore(
        initial_capacity=32, chunk=64, digest_storage=storage,
        slab_rows=64, tier_promote_samples=12, tier_promote_intervals=1,
        device="cpu", compute=ComputeBreaker(failure_threshold=5,
                                             reset_timeout=30.0,
                                             clock=clock))


def _storage_lines(seed=9):
    """150 histogram series over several slabs, a tenth of them hot
    enough to promote on the tiered store."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(150):
        n = 40 if i % 10 == 0 else int(rng.integers(2, 12))
        lines += [b"h.%d:%f|h" % (i, v) for v in rng.gamma(2.0, 20.0, n)]
    return [lines[j] for j in rng.permutation(len(lines))]


def _stat_rows(store):
    flushed, _ = store.flush([0.5], HistogramAggregates.from_names(AGGS), 1)
    return {m.name: m.value for m in flushed.to_intermetrics()}


@pytest.mark.parametrize("phase", ["preflight", "fetch"])
@pytest.mark.parametrize("storage", ["slab", "tiered"])
def test_rung3_on_slab_and_tiered_conserves_counts(storage, phase,
                                                   fake_clock, monkeypatch):
    """A slab or tiered flush whose kernel fails (at preflight, or at the
    fetch) re-merges the retired group into the live one exactly as a
    dense one does: the interval emits at the next flush, counts and
    extrema exact against a twin that never failed, sums rtol 1e-6, the
    median within 0.02 x (max - min)."""
    lines = _storage_lines()
    store, twin = (_storage_store(storage, fake_clock) for _ in range(2))
    for st in (store, twin):
        for ln in lines:
            st.process_metric(tparser.parse_metric(ln))
    group_cls = type(store.histograms)
    with monkeypatch.context() as m:
        if phase == "preflight":
            store.compute.injector = FaultInjector(
                rate=1.0, seed=1, kinds=("connect",),
                scope="compute.tdigest_merge")
        else:
            def fail(*args, **kwargs):
                raise RuntimeError("injected fetch failure")

            m.setattr(group_cls, "_flush_collect", fail)
        first = _stat_rows(store)
        store.compute.injector = None
    assert not any(k.startswith("h.") for k in first)
    assert (store.compute.requeued_total, store.compute.lost_total) == (1, 0)
    got, want = _stat_rows(store), _stat_rows(twin)
    assert set(got) == set(want) and len(want) == 150 * len(AGGS) + 150
    for name, v in want.items():
        suffix = name.rpartition(".")[2]
        if suffix in ("count", "min", "max"):
            assert got[name] == v, name
        elif suffix == "sum":
            assert got[name] == pytest.approx(v, rel=1e-6), name
    for i in range(150):
        span = want[f"h.{i}.max"] - want[f"h.{i}.min"]
        assert abs(got[f"h.{i}.50percentile"] - want[f"h.{i}.50percentile"]) \
            <= 0.02 * span + 1e-6, i
