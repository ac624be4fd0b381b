"""The port's kernel scopes (``veneur_tpu_torch/obs/kernels.py``)
against the JAX package's (``veneur_tpu/obs/kernels.py``).

* ``PROGRAM_SCOPES``: every JAX program has a port entry with the same
  scope, and every port entry resolves to a port attribute.
* A scope counts its dispatches, and a store's flush runs under the
  drain and flush scopes of its digest kernels.
* ``/debug/xprof``'s capture answers the JAX route's schema, one capture
  at a time.
"""

import json

import pytest

from veneur_tpu.obs import kernels as jkernels
from veneur_tpu_torch.core import store as tstore
from veneur_tpu_torch.obs import kernels as tkernels
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates

AGGS = ["min", "max", "count"]
PCTS = [0.5, 0.99]


def test_program_scopes_cover_every_jax_program():
    port = {jax: (scope, prog)
            for prog, (scope, jax) in tkernels.PROGRAM_SCOPES.items()}
    for program, (scope, _binding) in jkernels.PROGRAM_SCOPES.items():
        rel = program.split("/", 1)[1]
        assert rel in port, program
        assert port[rel][0] == scope, program
    assert len(port) == len(tkernels.PROGRAM_SCOPES) == \
        len(jkernels.PROGRAM_SCOPES)


@pytest.mark.parametrize("program", sorted(tkernels.PROGRAM_SCOPES))
def test_program_scope_resolves_to_a_port_attribute(program):
    import importlib

    path, attr = program.split("::")
    obj = importlib.import_module(path[:-3].replace("/", "."))
    for part in attr.split("."):
        obj = getattr(obj, part)
    assert callable(obj)


def test_scope_counts_dispatches_and_launch_counters():
    before = tkernels.dispatch_snapshot().get("test.scope", 0)
    with tkernels.scope("test.scope"):
        pass
    assert tkernels.dispatch_snapshot()["test.scope"] == before + 1
    snap = tkernels.snapshot()
    assert set(snap) == {"dispatches", "launches"}
    assert set(snap["launches"]) == {"drain_quantile", "compress_presorted"}
    assert tkernels.compiles_total() == 0


def test_store_flush_runs_under_its_scopes():
    store = tstore.MetricStore(initial_capacity=32, chunk=128, device="cpu")
    before = tkernels.dispatch_snapshot()
    store.sample_self_timing("store", 5.0)
    store.flush(PCTS, HistogramAggregates.from_names(AGGS), 1)
    after = tkernels.dispatch_snapshot()
    for scope in ("drain.digest.dense", "flush.digest.dense"):
        assert after.get(scope, 0) == before.get(scope, 0) + 1, scope


def test_xprof_capture_schema_and_one_at_a_time():
    status, body, ctype = tkernels.capture_xprof(0.05)
    assert status == 200 and ctype == "application/json"
    data = json.loads(body)
    assert set(data) == {"trace_dir", "seconds", "files", "scopes"}
    assert data["files"] and data["files"][0]["bytes"] > 0
    assert "flush.digest.dense" in data["scopes"]
    with open(data["files"][0]["path"]) as f:
        assert "traceEvents" in json.load(f)
    assert tkernels._xprof_lock.acquire(blocking=False)
    try:
        assert tkernels.capture_xprof(0.05)[0] == 409
    finally:
        tkernels._xprof_lock.release()
