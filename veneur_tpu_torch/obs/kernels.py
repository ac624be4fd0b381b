"""Device observability: profiler scopes, dispatch and launch counters,
and the on-demand profiler capture.

Port of ``veneur_tpu/obs/kernels.py``, recast for PyTorch:

- :func:`scope` wraps every host-side dispatch choke point in a
  ``torch.profiler.record_function("veneur." + name)`` range and, when
  the caller names a CUDA device, an NVTX range of the same name, so a
  profiler trace of a running server labels the CUDA kernels (K1, K2)
  by the flush or drain stage that launched them. Entering a scope also
  counts a dispatch.
- :data:`PROGRAM_SCOPES` maps every port function that launches device
  work to the scope covering its dispatches: the same scope name the JAX
  package gives its counterpart program (named in the map's second
  field, a path under the JAX package).
- :func:`compile_snapshot` has no compiled-variant caches to read (eager
  PyTorch compiles nothing at run time; the kernels are built once by
  nvcc). In its place it reports the CUDA wrappers' launch counters by
  path (``ops/tdigest_cuda.py`` ``COUNTERS``), and
  :func:`compiles_total` is 0.
- :func:`capture_xprof` runs one bounded ``torch.profiler`` capture (CPU
  and, with a card, CUDA activities, every thread) for ``GET
  /debug/xprof?seconds=N`` and writes it as a Chrome trace: one at a
  time, clamped like ``/debug/profile``.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import torch

# profiler range names carry this prefix
SCOPE_PREFIX = "veneur."

MAX_XPROF_SECONDS = 30.0

# one capture at a time (as /debug/profile)
_xprof_lock = threading.Lock()

# scope -> dispatch count: plain int bumps under the GIL (dispatches are
# chunk-scale, not packet-scale)
_dispatches: Dict[str, int] = {}

# port program -> (scope, the JAX package's program it stands for, as a
# path under that package). The tests hold every JAX entry to a port
# entry with the same scope, each resolving to a port attribute.
PROGRAM_SCOPES: Dict[str, Tuple[str, str]] = {
    "veneur_tpu_torch/core/store.py::_flush_digests":
        ("flush.digest.dense", "core/store.py::_flush_digests"),
    "veneur_tpu_torch/core/store.py::_ingest_samples":
        ("drain.digest.dense", "core/store.py::_ingest_samples"),
    "veneur_tpu_torch/core/store.py::_ingest_centroids":
        ("drain.digest.dense", "core/store.py::_ingest_centroids"),
    "veneur_tpu_torch/ops/tdigest.py::ingest_chunk_guarded":
        ("drain.digest.dense", "ops/tdigest.py::ingest_chunk_guarded"),
    # the two Pallas entries: the CUDA wrappers of K2 and K1
    "veneur_tpu_torch/ops/tdigest_cuda.py::compress_presorted":
        ("flush.digest.dense",
         "ops/tdigest_pallas.py::_compress_presorted_pallas"),
    "veneur_tpu_torch/ops/tdigest_cuda.py::drain_quantile":
        ("flush.digest.dense",
         "ops/tdigest_pallas.py::_drain_quantile_pallas"),
    "veneur_tpu_torch/core/slab.py::_ingest_slab":
        ("drain.digest.slab", "core/slab.py::_ingest_slab"),
    "veneur_tpu_torch/core/slab.py::_import_slab":
        ("drain.digest.slab", "core/slab.py::_import_slab"),
    "veneur_tpu_torch/core/slab.py::_merge_slab":
        ("drain.digest.slab", "core/slab.py::_merge_slab"),
    "veneur_tpu_torch/core/slab.py::_flush_slab":
        ("flush.digest.slab", "core/slab.py::_flush_slab"),
    "veneur_tpu_torch/core/slab.py::_quantile_slab":
        ("flush.digest.slab", "core/slab.py::_quantile_slab"),
    "veneur_tpu_torch/core/slab.py::_pack_slab":
        ("flush.digest.slab", "core/slab.py::_pack_slab"),
    "veneur_tpu_torch/core/slab.py::_slice_pack":
        ("flush.digest.slab", "core/slab.py::_slice_pack"),
    "veneur_tpu_torch/core/slab.py::_gather_pack":
        ("flush.digest.slab", "core/slab.py::_gather_pack"),
    "veneur_tpu_torch/core/tiered.py::_pool_ingest":
        ("drain.digest.tiered", "core/tiered.py::_pool_ingest"),
    "veneur_tpu_torch/core/tiered.py::_pool_import":
        ("drain.digest.tiered", "core/tiered.py::_pool_import"),
    "veneur_tpu_torch/core/tiered.py::_pool_restore_stats":
        ("drain.digest.tiered", "core/tiered.py::_pool_restore_stats"),
    "veneur_tpu_torch/core/tiered.py::_promote_rows":
        ("drain.digest.tiered", "core/tiered.py::_promote_rows"),
    "veneur_tpu_torch/core/tiered.py::_pool_flush":
        ("flush.digest.tiered", "core/tiered.py::_pool_flush"),
    # the mesh programs are methods of the port's mesh groups (one
    # torch device, no shard_map programs to name)
    "veneur_tpu_torch/core/mesh_store.py::_mesh_ingest_samples":
        ("drain.digest.mesh", "core/mesh_store.py::_mesh_ingest_samples"),
    "veneur_tpu_torch/core/mesh_store.py::_mesh_import_routed":
        ("drain.digest.mesh", "core/mesh_store.py::_mesh_import_routed"),
    "veneur_tpu_torch/core/mesh_store.py::MeshDigestGroup._flush_dispatch":
        ("flush.digest.mesh", "core/mesh_store.py::_mesh_flush_digests"),
    "veneur_tpu_torch/core/mesh_store.py::MeshSetGroup._drain_samples":
        ("drain.set.mesh", "core/mesh_store.py::_mesh_ingest_hashes"),
    "veneur_tpu_torch/core/mesh_store.py::MeshSetGroup._drain_imports":
        ("drain.set.mesh", "core/mesh_store.py::_mesh_merge_registers"),
    "veneur_tpu_torch/core/mesh_store.py::MeshSetGroup.flush_begin":
        ("flush.set.mesh", "core/mesh_store.py::_mesh_estimate"),
    "veneur_tpu_torch/fleet/mesh_tiered.py::MeshTieredDigestGroup"
    "._pool_drain_samples":
        ("drain.digest.mesh_tiered",
         "fleet/mesh_tiered.py::_mesh_pool_ingest"),
    "veneur_tpu_torch/fleet/mesh_tiered.py::MeshTieredDigestGroup"
    "._pool_drain_imports":
        ("drain.digest.mesh_tiered",
         "fleet/mesh_tiered.py::_mesh_pool_import"),
    "veneur_tpu_torch/fleet/mesh_tiered.py::MeshTieredDigestGroup"
    "._maybe_promote":
        ("drain.digest.mesh_tiered",
         "fleet/mesh_tiered.py::_mesh_promote_rows"),
    "veneur_tpu_torch/fleet/mesh_tiered.py::MeshTieredDigestGroup"
    "._pool_restore":
        ("drain.digest.mesh_tiered",
         "fleet/mesh_tiered.py::_mesh_pool_restore_stats"),
    "veneur_tpu_torch/fleet/mesh_tiered.py::MeshTieredDigestGroup"
    "._flush_dispatch":
        ("flush.digest.mesh_tiered",
         "fleet/mesh_tiered.py::_mesh_pool_flush"),
}


@contextmanager
def scope(name: str, device: Optional[torch.device] = None):
    """One named dispatch region: counts the dispatch and opens a
    profiler range ``veneur.<name>`` (plus an NVTX range on a CUDA
    device). A few microseconds a call: for the per-chunk drains and the
    per-group flush, never a per-record path."""
    _dispatches[name] = _dispatches.get(name, 0) + 1
    label = SCOPE_PREFIX + name
    nvtx = device is not None and device.type == "cuda"
    with torch.profiler.record_function(label):
        if nvtx:
            torch.cuda.nvtx.range_push(label)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def dispatch_snapshot() -> Dict[str, int]:
    return dict(_dispatches)


def compile_snapshot() -> Dict[str, Dict[str, int]]:
    """The CUDA wrappers' launch counters by path, in place of the JAX
    package's compiled-variant counts: ``{"drain_quantile": {"launches":
    n, ...}, "compress_presorted": {...}}``."""
    from veneur_tpu_torch.ops import tdigest_cuda as tc

    return {fn.__name__: {c: int(getattr(fn, c)) for c in tc.COUNTERS}
            for fn in (tc.drain_quantile, tc.compress_presorted)}


def compiles_total() -> int:
    """Always 0: nothing compiles at run time in the port (the
    ``veneur.obs.kernel_compiles_total`` self-metric)."""
    return 0


def snapshot() -> dict:
    """The /debug/vars ``kernels`` section: dispatches by scope and the
    CUDA wrappers' launches by path."""
    return {"dispatches": dispatch_snapshot(),
            "launches": compile_snapshot()}


def _profile_kwargs() -> dict:
    """The capture's activities (CUDA with a card) and every thread:
    the flush and drains run on threads of their own, not on the
    request thread that starts the capture."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return {"activities": activities,
            "experimental_config": _ExperimentalConfig(
                profile_all_threads=True)}


def capture_xprof(seconds: float, base_dir: Optional[str] = None) -> tuple:
    """Run one bounded profiler capture; returns the (status, body,
    ctype) triple of the /debug/xprof route. The Chrome trace lands on
    local disk and the body names it (``trace_dir``, ``seconds``,
    ``files``, ``scopes``), the JAX route's schema; open the file in
    Perfetto or chrome://tracing."""
    seconds = max(0.05, min(float(seconds), MAX_XPROF_SECONDS))
    if not _xprof_lock.acquire(blocking=False):
        return 409, "another xprof capture is already running", "text/plain"
    try:
        trace_dir = tempfile.mkdtemp(prefix="veneur-xprof-", dir=base_dir)
        t0 = time.perf_counter()
        prof = torch.profiler.profile(**_profile_kwargs())
        prof.start()
        try:
            time.sleep(seconds)
        finally:
            prof.stop()
        took = time.perf_counter() - t0
        path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        files = [{"path": os.path.join(trace_dir, name),
                  "bytes": os.path.getsize(os.path.join(trace_dir, name))}
                 for name in sorted(os.listdir(trace_dir))]
        body = json.dumps({"trace_dir": trace_dir,
                           "seconds": round(took, 3), "files": files,
                           "scopes": sorted({s for s, _ in
                                             PROGRAM_SCOPES.values()})})
        return 200, body, "application/json"
    except Exception as e:
        return 500, f"xprof capture failed: {e!r}", "text/plain"
    finally:
        _xprof_lock.release()
