"""Elastic resharding of the global tier: the packed-digest handoff.

Port of ``veneur_tpu/fleet/handoff.py``. When the global fleet's ring
changes, the state already resident on an old owner must reach the new
one, or it emits nowhere near its new half:

1. **Watch**: :class:`~veneur_tpu_torch.discovery.RingWatcher` runs the
   keep-last-good discovery refresh against the fleet's own membership
   (a static list, a ``file://`` peers file, or Consul).
2. **Extract**: on a membership change the losing instance computes the
   moved key ranges with the shared hash rule (a
   :class:`~veneur_tpu_torch.fleet.router.RingTransition`) and calls
   ``MetricStore.handoff_extract``: one generation swap (the flush-epoch
   guard), an off-lock snapshot of the retired groups, a host-side
   split, and a re-merge of everything that stays. Samples arriving
   during the extraction land in the fresh live generation, so nothing
   is lost and nothing double-counts.
3. **Stream**: the moved ranges travel as *packed* digests (u16
   range-quantized means and bfloat16 weight bits,
   :func:`pack_digest_snapshot`) inside the versioned, CRC-guarded
   ``persist/format.py`` envelope, POSTed to the new owner's
   ``/handoff``, which merges them with import semantics (counters add,
   centroids re-bin through the import drains, HLL registers max) and
   acks only after the merge landed.
4. **Survive**: a per-destination breaker and retries with full jitter
   inside a handoff deadline; an unacked handoff re-queues into the live
   store (late, never lost) after a completion probe closes the
   ack-lost window. The sender anchors a checkpoint after the swap and
   spools each pending handoff beside it (recovered at restart); the
   receiver registers the handoff id BEFORE merging, so a retried
   stream never merges twice.

The receiver guards by **handoff epoch** per sender (a stale epoch is
refused with 409) and by id (a duplicate acks without merging). The
wire is byte for byte the JAX package's: the pack is the same host
numpy arithmetic in float64, the envelope the same serializer, so
either package's global receives the other's handoff.

The fleet trace plane (``obs/tracectx.py``): with a timeline (a Server's
``obs_enabled``) a transition starts a distributed trace of its own, a
``handoff.send`` entry in the sender's ``/debug/flush-timeline`` whose
stages are the transition's (``handoff.extract``, ``.checkpoint``,
``.encode``, ``.stream``), and each ``POST /handoff`` carries
``X-Veneur-Trace`` under it; the receiver records its
``handoff.receive`` hop in its hop log, so ``/debug/trace`` stitches
the resharding like any other hop.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request
import uuid
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from veneur_tpu_torch import obs
from veneur_tpu_torch.fleet.router import RingTransition
from veneur_tpu_torch.obs import tracectx
from veneur_tpu_torch.persist import format as ckpt_format
from veneur_tpu_torch.persist.format import CheckpointInvalid
from veneur_tpu_torch.resilience import (BreakerRegistry, Deadline,
                                         RetryPolicy, is_transient_status,
                                         post_with_retry)
from veneur_tpu_torch.resilience import faults as rfaults

log = logging.getLogger("veneur.fleet.handoff")

# bounded receiver-side idempotency memory: ids beyond this age out
# (oldest first); a sender retries within one handoff deadline, not
# thousands of transitions later
SEEN_LIMIT = 512


@contextmanager
def _stage(stages: Dict[str, float], name: str):
    """Add the wall seconds of the block to ``stages[name]``, and time it
    as the ``handoff.<name>`` stage of the transition's recorder."""
    t0 = time.perf_counter()
    try:
        with obs.maybe_stage(f"handoff.{name}"):
            yield
    finally:
        stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0


class HybridEpoch:
    """Hybrid (wall, monotonic-counter) handoff epoch.

    The epoch the receiver guards staleness by used to be the bare
    wall clock (``int(time.time())`` at construction, ``max(+1, now)``
    per transition) — monotonic only as long as the clock never ran
    backwards between process lives. A sender restarted onto a
    skewed-backwards clock would base BELOW the receiver's remembered
    high-water mark and see every handoff spuriously 409-stale until
    real time caught up. The hybrid epoch removes the wall clock from
    the ordering:

    - ``wall`` is a high-water mark (``max`` of every observation, so
      a clock stepping backwards mid-life cannot lower it) — it exists
      for operator legibility (spool filenames, handoff ids, logs),
      not for ordering;
    - ``ctr`` increments once per transition and is the actual
      monotonic component: ``(wall, ctr)`` compares lexicographically
      and ``ctr`` alone already totally orders one process life;
    - ``incarnation`` is a per-process-life random id. The receiver
      keys its high-water mark per (sender, incarnation), so a fresh
      incarnation starts a fresh order and can never be stale against
      a previous life's wall clock — replays from an OLD life still
      check against that life's own remembered mark, and the id guard
      covers the cross-life retry (spool re-send) case.

    ``clock`` is injectable for the skewed-clock regression test."""

    def __init__(self, clock: Callable[[], float] = time.time):
        self.clock = clock
        self.wall = int(clock())
        self.ctr = 0
        self.incarnation = uuid.uuid4().hex[:12]

    def advance(self) -> Tuple[int, int]:
        """One transition's (wall, ctr). Caller serializes (the
        manager advances under its lock)."""
        self.wall = max(self.wall, int(self.clock()))
        self.ctr += 1
        return self.wall, self.ctr


# ---------------------------------------------------------------------------
# snapshot split: one group snapshot -> per-destination snapshots
# ---------------------------------------------------------------------------


def _filter_rows(snap: dict, keep_ix: np.ndarray) -> dict:
    """A group snapshot restricted to the rows in ``keep_ix`` (row ids
    into the snapshot's interner order), with the digest centroid runs
    re-rowed onto the compacted 0..k-1 space ``restore_state``
    expects."""
    kind = snap.get("kind")
    out = {"kind": kind,
           "names": [snap["names"][i] for i in keep_ix],
           "joined": [snap["joined"][i] for i in keep_ix]}
    if kind == "scalar":
        out["values"] = np.asarray(snap["values"])[keep_ix]
        if snap.get("messages") is not None:
            out["messages"] = [snap["messages"][i] for i in keep_ix]
            out["hostnames"] = [snap["hostnames"][i] for i in keep_ix]
        return out
    if kind == "set":
        out["precision"] = snap.get("precision")
        if "registers" in snap:
            out["registers"] = np.asarray(snap["registers"])[keep_ix]
        return out
    if kind == "digest":
        if "rows" not in snap:
            return out
        n = len(snap["names"])
        keep = np.zeros(n, bool)
        keep[keep_ix] = True
        remap = np.full(n, -1, np.int64)
        remap[keep_ix] = np.arange(len(keep_ix))
        rows = np.asarray(snap["rows"], np.int64)
        m = keep[rows]
        out["rows"] = remap[rows[m]].astype(np.int32)
        out["means"] = np.asarray(snap["means"])[m]
        out["weights"] = np.asarray(snap["weights"])[m]
        for k in ("mins", "maxs", "count", "vsum", "vmin", "vmax",
                  "recip"):
            out[k] = np.asarray(snap[k])[keep_ix]
        return out
    if kind == "topk":
        # the candidate series split by row like any set, but the
        # count-min table is CROSS-series (every sample hashed into the
        # same [depth, width] counters) — it cannot be partitioned by
        # key, so every part carries a full copy. Count-min is a linear
        # sketch: the receiver's element-wise table add keeps every
        # estimate a one-sided upper bound; the cost is overcount, not
        # undercount, bounded by e/w · ΣN of the merged table.
        for k in ("depth", "width", "k"):
            if k in snap:
                out[k] = snap[k]
        if snap.get("table") is not None:
            out["table"] = np.array(snap["table"], np.float32, copy=True)
        series = snap.get("series") or []
        out["series"] = [series[i] for i in keep_ix]
        return out
    # unknown kinds never split — the caller keeps them whole
    return snap


def split_group_snapshot(snap: dict, type_str: str,
                         route_fn: Callable[[str, str, str],
                                            Optional[str]],
                         route_many=None) -> dict:
    """One group snapshot -> {destination-or-None: snapshot}. ``None``
    keys the kept half. ``veneur.*`` self-telemetry series are
    instance-local by definition and always stay.

    ``route_many(names, type_str, joineds) -> [dest-or-None]`` is the
    batched fast path (one ring-lock hold for the whole group via
    ``ConsistentRing.get_many`` instead of a locked hash walk per
    series);
    ``route_fn`` is the per-key fallback."""
    names = snap.get("names") or []
    joined = snap.get("joined") or []
    if not names:
        return {None: snap}
    dest_of: List[Optional[str]] = [None] * len(names)
    routable = [i for i, nm in enumerate(names)
                if not nm.startswith("veneur.")]
    if routable:
        if route_many is not None:
            dests = route_many([names[i] for i in routable], type_str,
                               [joined[i] for i in routable])
        else:
            dests = [route_fn(names[i], type_str, joined[i])
                     for i in routable]
        for i, dest in zip(routable, dests):
            dest_of[i] = dest
    by_dest: Dict[Optional[str], List[int]] = {}
    for i, dest in enumerate(dest_of):
        by_dest.setdefault(dest, []).append(i)
    if set(by_dest) == {None}:
        return {None: snap}
    return {dest: _filter_rows(snap, np.asarray(ix, np.int64))
            for dest, ix in by_dest.items()}


# ---------------------------------------------------------------------------
# packed digest wire (the tdigest field-16/17 sort-compact contract)
# ---------------------------------------------------------------------------


def pack_digest_snapshot(snap: dict) -> dict:
    """Quantize a digest snapshot's centroid runs to the packed wire:
    u16 range-quantized means against a per-row [pmin, pmin+pspan]
    frame plus u16 bfloat16 weight bits — 4 bytes/centroid instead of
    16, the same contract ``PackedDigestPlanes`` proved on the forward
    path (``_digest_arrays`` decodes the identical fields off protobuf
    16/17). Quantization is order-preserving per row, so the
    sorted-by-(row, mean) layout the restore staging depends on
    survives. Mutates and returns ``snap``."""
    if snap.get("kind") != "digest" or snap.get("packed") \
            or "rows" not in snap:
        return snap
    rows = np.asarray(snap["rows"], np.int64)
    means = np.asarray(snap["means"], np.float64)
    weights = np.asarray(snap["weights"], np.float64)
    n = len(snap["names"])
    pmin = np.full(n, np.inf, np.float64)
    pmax = np.full(n, -np.inf, np.float64)
    np.minimum.at(pmin, rows, means)
    np.maximum.at(pmax, rows, means)
    span = pmax - pmin
    ok = np.isfinite(span) & (span > 0)
    scale = np.zeros(n, np.float64)
    np.divide(65535.0, span, where=ok, out=scale)
    q = np.rint((means - pmin[rows]) * scale[rows])
    snap["means_q"] = np.clip(q, 0, 65535).astype(np.uint16)
    bits = np.ascontiguousarray(weights, np.float32).view(np.uint32)
    # round-to-nearest-even into bfloat16, matching the device packer
    bits = bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16))
                                       & np.uint32(1))
    snap["weights_bf"] = (bits >> np.uint32(16)).astype(np.uint16)
    snap["pmin"] = np.where(np.isfinite(pmin), pmin, 0.0).astype(
        np.float32)
    snap["pspan"] = np.where(ok, span, 0.0).astype(np.float32)
    snap["packed"] = True
    del snap["means"]
    del snap["weights"]
    return snap


def unpack_digest_snapshot(snap: dict) -> dict:
    """Inverse of :func:`pack_digest_snapshot`: rebuild the f64
    centroid arrays ``restore_state`` consumes. Mutates and returns
    ``snap``."""
    if not snap.get("packed"):
        return snap
    rows = np.asarray(snap["rows"], np.int64)
    q = np.asarray(snap["means_q"], np.uint16).astype(np.float64)
    pmin = np.asarray(snap["pmin"], np.float64)
    pspan = np.asarray(snap["pspan"], np.float64)
    snap["means"] = pmin[rows] + q * (pspan[rows] / 65535.0)
    wb = np.ascontiguousarray(snap["weights_bf"], np.uint16)
    snap["weights"] = (wb.astype(np.uint32) << np.uint32(16)).view(
        np.float32).astype(np.float64)
    for k in ("means_q", "weights_bf", "pmin", "pspan", "packed"):
        snap.pop(k, None)
    return snap


# ---------------------------------------------------------------------------
# wire envelope (shared by the POST body and the crash spool file)
# ---------------------------------------------------------------------------


def encode_handoff(groups: Dict[str, dict], meta: dict,
                   created_at: float) -> bytes:
    """Moved group snapshots -> one versioned/CRC-guarded blob: the
    ``persist/format.py`` checkpoint layout with digests packed and a
    ``handoff`` section in the manifest meta. One serialization serves
    both the wire (``POST /handoff``) and the sender's crash spool."""
    wire: Dict[str, dict] = {}
    for name, snap in groups.items():
        if snap.get("kind") == "digest":
            snap = pack_digest_snapshot(dict(snap))
        wire[name] = snap
    return ckpt_format.serialize(wire, created_at=created_at,
                                 interval=0.0, meta={"handoff": meta})


def decode_handoff(blob: bytes) -> Tuple[Dict[str, dict], dict]:
    """Wire/spool blob -> (restorable groups, handoff meta). Raises
    :class:`CheckpointInvalid` on anything not provably whole."""
    groups, manifest = ckpt_format.deserialize(blob)
    for snap in groups.values():
        unpack_digest_snapshot(snap)
    meta = (manifest.get("meta") or {}).get("handoff") or {}
    return groups, meta


def snapshot_counts(groups: Dict[str, dict]) -> Dict[str, int]:
    """Per-group series counts (the wire meta's conservation ledger)."""
    return {name: len(snap.get("names") or ())
            for name, snap in groups.items()}


def config_skew_reason(store, groups: Dict[str, dict]) -> Optional[str]:
    """A whole-stream rejection reason when any group could not merge
    completely on ``store``'s config (HLL precision, count-min
    geometry), or None to accept. Shared by the handoff and
    replication receivers: ``restore_state`` skips incompatible groups
    with only a warning, and acking such a merge would silently lose
    the skipped series — rejecting whole keeps the state at the
    sender until the skew is fixed."""
    for name, snap in groups.items():
        target = getattr(store, name, None)
        if target is None:
            return f"unknown group {name!r}"
        kind = snap.get("kind")
        if kind == "set":
            want = getattr(target, "precision", None)
            if snap.get("precision") != want:
                return (f"{name}: HLL precision "
                        f"{snap.get('precision')} != store {want}")
        elif kind == "topk":
            geom = (snap.get("depth"), snap.get("width"))
            if geom != (getattr(target, "depth", None),
                        getattr(target, "width", None)):
                return f"{name}: count-min geometry {geom} mismatch"
    return None


# ---------------------------------------------------------------------------
# the manager: watch -> extract -> spool -> stream -> ack/requeue
# ---------------------------------------------------------------------------


class HandoffManager:
    """Owns one instance's elastic-resharding flow, both roles: the
    sender side (refresh loop, extraction, spool, stream) and the
    receiver side (``/handoff`` merge with id/epoch guards)."""

    def __init__(self, store, self_addr: str, watcher,
                 timeout: float = 10.0, retry_policy=None, breakers=None,
                 spool_prefix: str = "", checkpointer=None,
                 refresh_interval: float = 10.0, injector=None,
                 replicas: int = 20, spool_write_fn=None,
                 clock: Callable[[], float] = time.time, timeline=None,
                 hop_log=None):
        self.store = store
        # the fleet trace plane: a transition's entry goes to the
        # timeline, a received handoff's hop to the hop log
        self.timeline = timeline
        self.hop_log = hop_log
        self.self_addr = self_addr
        self.watcher = watcher
        self.timeout = timeout
        self.retry_policy = retry_policy or RetryPolicy()
        self.breakers = breakers or BreakerRegistry()
        self.spool_prefix = spool_prefix
        self.checkpointer = checkpointer
        self.refresh_interval = refresh_interval
        self.injector = injector
        self.replicas = replicas
        # a requeued handoff retries on the next refresh cadence (a
        # same-ring transition re-extracts exactly the misrouted
        # residue), not on the next membership change
        self.retry_pending = False
        self._retry_dests: set = set()  # dests whose requeue is owed
        self.requeue_retries_total = 0
        # sender state: the hybrid (wall, counter) epoch under a per-life
        # incarnation id, so a restart onto a clock skewed backwards is
        # never spuriously 409-stale (see HybridEpoch); self.epoch shows
        # the wall part (spool names, handoff ids, snapshots)
        self._hybrid = HybridEpoch(clock=clock)
        self.epoch = self._hybrid.wall
        self.epoch_ctr = 0
        self.incarnation = self._hybrid.incarnation
        self._seq = 0
        self._lock = threading.Lock()
        # held across one whole transition (extract, stream, requeue);
        # shutdown quiesces on it before the final flush
        self._busy = threading.Lock()
        # receiver state: id -> merged count (registered BEFORE the
        # merge, the at-most-once anchor) and the (wall, ctr) high-water
        # mark per (sender, incarnation)
        self._seen: "Dict[str, int]" = {}
        self._seen_order: List[str] = []
        self._sender_epochs: Dict[Tuple[str, str], Tuple[int, int]] = {}
        # counts (the status route, snapshot() and the flush's
        # veneur.handoff.* self-metrics)
        self.resizes_total = 0
        self.moved_series_total = 0
        self.sent_total = 0
        self.send_failures_total = 0
        self.requeued_series_total = 0
        self.receives_total = 0
        self.received_series_total = 0
        self.duplicates_total = 0
        self.stale_total = 0
        self.rejected_total = 0
        self.short_merges_total = 0
        self.spool_resent_total = 0
        self.spool_recovered_total = 0
        # spool writes the disk refused (ENOSPC, a short write): the
        # handoff continues unspooled, its crash protection degraded,
        # counted here and named on the degraded readiness body
        self.spool_errors_total = 0
        self.last_spool_error = ""
        # the spool commit (a disk_full fault wraps it)
        self._spool_write = spool_write_fn or ckpt_format.write_atomic
        self.retries_total = 0
        self.last_duration_ns = 0
        self.last_error = ""
        # the last transition's stage seconds (extract, checkpoint,
        # encode, stream): what a caller timing a resize reads
        self.last_stages: Dict[str, float] = {}
        # the receiver's last merge (restore_state) in seconds
        self.last_merge_s = 0.0

    # -- construction -------------------------------------------------------

    @classmethod
    def for_server(cls, server) -> "HandoffManager":
        """Build from a server's config: the membership source
        (handoff_peers CSV, a ``file://`` peers file, or the Consul
        service), the shared resilience knobs, the checkpointer as the
        crash anchor, the server's disk_full fault on the spool, and
        the seeded churn injector when a churn kind is configured (the
        watcher mangles each refresh with it; the sends consult its
        partitions)."""
        from veneur_tpu_torch.discovery import (ConsulDiscoverer,
                                                FilePeersDiscoverer,
                                                RingWatcher,
                                                StaticDiscoverer)

        cfg = server.config
        peers = (cfg.handoff_peers or "").strip()
        if peers.startswith("file://"):
            discoverer = FilePeersDiscoverer(peers[len("file://"):])
        elif peers:
            discoverer = StaticDiscoverer(
                [p.strip() for p in peers.split(",") if p.strip()])
        else:
            discoverer = ConsulDiscoverer()
        injector = rfaults.armed_for(cfg, rfaults.CHURN_KINDS)
        watcher = RingWatcher(
            discoverer, cfg.handoff_service_name or "veneur-global",
            injector=injector)
        soak = getattr(server, "soak_injector", None)
        return cls(
            store=server.store, self_addr=cfg.handoff_self,
            watcher=watcher, timeout=cfg.handoff_timeout_seconds,
            retry_policy=RetryPolicy.from_config(cfg),
            breakers=BreakerRegistry(
                failure_threshold=cfg.breaker_failure_threshold,
                reset_timeout=cfg.breaker_reset_timeout_seconds),
            spool_prefix=cfg.checkpoint_path,
            checkpointer=server.checkpointer,
            refresh_interval=cfg.handoff_refresh_interval_seconds,
            injector=injector,
            spool_write_fn=(soak.wrap_write(ckpt_format.write_atomic,
                                            "handoff.spool")
                            if soak is not None else None),
            timeline=server.obs_timeline, hop_log=server.obs_hops)

    # -- sender: refresh loop ----------------------------------------------

    def run(self, stop: threading.Event):
        """Background loop: one membership refresh per
        ``handoff_refresh_interval`` until ``stop``. A failing refresh
        or handoff never kills the thread — the next cadence retries."""
        while not stop.wait(self.refresh_interval):
            try:
                self.refresh()
            except Exception:
                log.exception("handoff refresh failed; retrying next "
                              "interval")

    def refresh(self) -> Optional[dict]:
        """One discovery refresh. A no-op/failed refresh returns None
        (keep-last-good). On a membership change: the FIRST observed
        membership just adopts (nothing owned yet to move); afterwards
        any transition runs the extraction — the split decides what
        actually moves, so a change that costs this instance nothing
        is one cheap swap-and-restore cycle that also self-heals any
        misrouted residue."""
        change = self.watcher.refresh()
        if change is None:
            if self.retry_pending and self.watcher.members:
                # a requeued handoff retries on the refresh cadence: a
                # same-ring transition re-extracts exactly the requeued
                # residue. Not while every requeued destination's
                # breaker is OPEN: the transition is a whole extract,
                # checkpoint, spool and restore cycle, far too heavy to
                # burn against a peer known to be down (blocked() reads
                # the state without consuming a half-open probe)
                dests = [d for d in self._retry_dests
                         if d in self.watcher.members]
                if dests and all(self.breakers.get(d).blocked()
                                 for d in dests):
                    return None
                members = list(self.watcher.members)
                self.requeue_retries_total += 1
                log.info("handoff: retrying requeued ranges on the "
                         "refresh cadence (membership unchanged: %s)",
                         members)
                return self._run_handoff(
                    RingTransition(members, members,
                                   replicas=self.replicas))
            return None
        transition = RingTransition(change.old, change.new,
                                    replicas=self.replicas)
        if not change.old:
            log.info("handoff: adopted initial membership %s", change.new)
            return {"adopted": change.new}
        log.info("handoff: membership change +%s -%s", change.added,
                 change.removed)
        return self._run_handoff(transition)

    def _route_fn(self, transition: RingTransition):
        def route(name: str, mtype: str, joined: str) -> Optional[str]:
            dest = transition.new_owner(name, mtype, joined)
            return None if dest == self.self_addr else dest
        return route

    def _route_many(self, transition: RingTransition):
        def route_many(names, mtype, joineds):
            return [None if dest == self.self_addr else dest
                    for dest in transition.new_owners(names, mtype,
                                                      joineds)]
        return route_many

    def quiesce(self, timeout: float = 30.0) -> bool:
        """Block until no handoff is in flight (bounded) — the clean
        shutdown calls this before the final flush, so a SIGTERM
        landing mid-handoff cannot race the requeue against the drain
        (the moved state would miss the final flush; its spool would
        still recover it on the next life, but a CLEAN shutdown must
        not need one). False = still busy at the timeout."""
        if self._busy.acquire(timeout=timeout):
            self._busy.release()
            return True
        return False

    def _run_handoff(self, transition: RingTransition) -> dict:
        t0 = time.monotonic_ns()
        rec = obs.StageRecorder() if self.timeline is not None else None
        if rec is not None:
            # a handoff starts its own distributed trace: the receiver
            # parents its merge under this hop's span
            rec.adopt_trace(tracectx.new_span_id(), hop="handoff.send")
        # _busy spans the WHOLE transition, the spool fsync and the
        # stream included: it is the shutdown quiesce barrier, not a
        # data lock, and quiesce() exists to wait on exactly these
        with self._busy, obs.activate(rec):
            summary = self._run_handoff_staged(transition)
        self.last_duration_ns = time.monotonic_ns() - t0
        if rec is not None:
            try:
                entry = rec.finish()
                entry.update(kind="handoff", epoch=summary["epoch"],
                             moved_series=summary["moved_series"])
                self.timeline.publish(entry)
            except Exception:  # telemetry must never fail a handoff
                log.exception("handoff timeline publication failed")
            self.store.sample_self_timing("handoff.total",
                                          float(self.last_duration_ns))
        return summary

    def _run_handoff_staged(self, transition: RingTransition) -> dict:
        self.retry_pending = False  # re-set below by any requeue
        self._retry_dests.clear()
        stages = self.last_stages = {}
        rec = obs.current()
        ctx = (tracectx.TraceContext(rec.trace_id, rec.span_id)
               if rec is not None and rec.trace_id else None)
        with self._lock:
            self.epoch, self.epoch_ctr = self._hybrid.advance()
            epoch, epoch_ctr = self.epoch, self.epoch_ctr
        with _stage(stages, "extract"):
            moved, moved_series = self.store.handoff_extract(
                self._route_fn(transition),
                route_many=self._route_many(transition))
        self.resizes_total += 1
        self.moved_series_total += moved_series
        summary = {"epoch": epoch, "moved_series": moved_series,
                   "destinations": sorted(moved), "sent": [],
                   "requeued": []}
        if not moved:
            return summary
        # the post-swap checkpoint anchor: after the extraction the
        # moved state is NOT in the live store, so the pre-swap file on
        # disk (which still holds it) must be replaced before the spool
        # exists — disk never simultaneously holds both copies, which
        # is what makes crash recovery (regular restore + spool
        # recovery) exactly-once. If the anchor CANNOT be written the
        # stale pre-swap file survives, and spooling/streaming anyway
        # would set up a crash-restart double count (old checkpoint +
        # spool/receiver both holding the moved series) — abort the
        # transition instead: requeue everything now and let a later
        # refresh retry. A False return (flush-epoch race) is safe to
        # proceed past: the racing flush truncated the file, so no
        # stale copy exists.
        if self.checkpointer is not None:
            with _stage(stages, "checkpoint"):
                try:
                    self.checkpointer.write_once()
                except Exception:
                    log.exception(
                        "post-extraction checkpoint failed; aborting "
                        "the handoff (streaming against a stale "
                        "pre-swap checkpoint risks a crash-restart "
                        "double count) — re-merging the moved ranges")
                    for dest in sorted(moved):
                        self.send_failures_total += 1
                        self._requeue(moved[dest], dest,
                                      f"{self.self_addr}:{epoch}:abort")
                        summary["requeued"].append(dest)
                        self._retry_dests.add(dest)
                    self.retry_pending = True
                    return summary
        pending = []  # (dest, groups, blob, handoff_id, spool_path)
        with _stage(stages, "encode"):
            for dest in sorted(moved):
                groups = moved[dest]
                handoff_id = (f"{self.self_addr}:{epoch}:{self._seq}:"
                              f"{uuid.uuid4().hex[:12]}")
                self._seq += 1
                meta = {"id": handoff_id, "sender": self.self_addr,
                        "epoch": epoch, "epoch_ctr": epoch_ctr,
                        "incarnation": self.incarnation, "dest": dest,
                        "series": sum(snapshot_counts(groups).values()),
                        "counts": snapshot_counts(groups)}
                blob = encode_handoff(groups, meta, time.time())
                spool = ""
                if self.spool_prefix:
                    spool = (f"{self.spool_prefix}.handoff."
                             f"{epoch}.{len(pending)}")
                    try:
                        self._spool_write(spool, blob)
                        self.last_spool_error = ""
                    except OSError as e:
                        self.spool_errors_total += 1
                        self.last_spool_error = str(e)
                        log.exception("could not spool handoff %s; "
                                      "continuing unspooled", handoff_id)
                        spool = ""
                pending.append((dest, groups, blob, handoff_id, spool))
        for dest, groups, blob, handoff_id, spool in pending:
            n = sum(snapshot_counts(groups).values())
            with _stage(stages, "stream"):
                ok = self._send(dest, blob, handoff_id, ctx=ctx)
            if ok:
                self.sent_total += 1
                summary["sent"].append(dest)
                log.info("handoff %s: %d series -> %s acked",
                         handoff_id, n, dest)
            else:
                self.send_failures_total += 1
                # the spool goes FIRST: once the requeue re-anchors the
                # checkpoint below, a surviving spool would be a second
                # on-disk copy of the same series (crash-restart double
                # count); dropping it first accepts the documented
                # bounded-loss trade instead
                if spool:
                    try:
                        os.unlink(spool)
                    except OSError:
                        pass  # the requeue below owns the samples
                    spool = ""
                self._requeue(groups, dest, handoff_id)
                summary["requeued"].append(dest)
                self._retry_dests.add(dest)
                self.retry_pending = True
                # the requeued state is memory-only and the post-swap
                # anchor excludes it; re-anchor so a crash right after
                # still recovers it (an epoch-raced/failed write keeps
                # the loss bound at the regular cadence — same as any
                # fresh sample)
                if self.checkpointer is not None:
                    try:
                        self.checkpointer.write_once()
                    except Exception:
                        log.exception("post-requeue checkpoint failed; "
                                      "the next cadence covers it")
            if spool:
                try:
                    os.unlink(spool)
                except OSError:
                    pass  # acked: the samples live at the destination
        return summary

    def _requeue(self, groups: Dict[str, dict], dest: str,
                 handoff_id: str):
        """The unacked handoff re-enters the LIVE store with import
        semantics (``MetricStore._requeue_group``'s contract: late,
        never lost) — the moved ranges keep serving from here until a
        later refresh retries the transition."""
        n = 0
        try:
            # prefer_live_scalars: a gauge sampled since the extraction
            # is newer than the retired value coming back
            n = self.store.restore_state(groups,
                                         prefer_live_scalars=True)
        except Exception:
            log.exception("handoff %s requeue failed; the last "
                          "checkpoint bounds the damage", handoff_id)
        self.requeued_series_total += n
        log.warning("handoff %s to %s failed; re-merged %d series into "
                    "the live store (late, never lost)", handoff_id,
                    dest, n)

    # -- sender: transport --------------------------------------------------

    @staticmethod
    def _base_url(dest: str) -> str:
        url = dest.rstrip("/")
        if not url.startswith(("http://", "https://")):
            url = "http://" + url
        return url

    def _post_blob(self, url: str, blob: bytes, timeout: float,
                   out: dict, ctx=None) -> int:
        if self.injector is not None:
            self.injector.maybe_fail(f"handoff.post.{url}")
        headers = {"Content-Type": "application/octet-stream"}
        if ctx is not None:
            headers[tracectx.HEADER] = ctx.encode()
        req = urllib.request.Request(url, data=blob, headers=headers,
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                out["body"] = resp.read()
                return resp.status
        except urllib.error.HTTPError as e:
            try:
                out["body"] = e.read()
            finally:
                e.close()
            return e.code

    def _send(self, dest: str, blob: bytes, handoff_id: str,
              ctx=None) -> bool:
        base = self._base_url(dest)
        breaker = self.breakers.get(dest)
        if self.injector is not None and self.injector.is_partitioned(dest):
            # a scheduled partition black-holes this member (keyed by
            # the bare membership address, the same string
            # mangle_members drew); the completion probe would be
            # black-holed too, so fail straight into the requeue
            breaker.record_failure()
            self.last_error = f"{dest}: injected partition"
            log.warning("handoff %s to %s black-holed by injected "
                        "partition", handoff_id, dest)
            return False
        if not breaker.allow():
            log.warning("handoff %s to %s skipped: circuit breaker open",
                        handoff_id, dest)
            return self._probe_completed(base, handoff_id)
        deadline = Deadline.after(self.timeout)
        info: dict = {}

        def on_retry(retry_index, exc, pause):
            self.retries_total += 1

        try:
            status = post_with_retry(
                lambda: self._post_blob(
                    base + "/handoff", blob,
                    deadline.clamp(self.timeout), info, ctx=ctx),
                self.retry_policy, deadline=deadline, on_retry=on_retry)
        except Exception as e:
            breaker.record_failure()
            self.last_error = f"{dest}: {e}"
            # the POST may have LANDED with its response lost — ask
            # before re-queueing, or a merged handoff double-counts
            return self._probe_completed(base, handoff_id)
        if 200 <= status < 300:
            breaker.record_success()
            return True
        if is_transient_status(status):
            breaker.record_failure()
        else:
            breaker.record_success()
        self.last_error = f"{dest}: HTTP {status}"
        log.warning("handoff %s to %s returned HTTP %d (%s)", handoff_id,
                    dest, status, (info.get("body") or b"")[:120])
        return self._probe_completed(base, handoff_id)

    def _probe_completed(self, base: str, handoff_id: str) -> bool:
        """Best-effort ack recovery: did the receiver complete this id?
        True closes the ack-lost window without a requeue; any probe
        failure (receiver down — the chaos case) answers False and the
        state re-queues locally."""
        try:
            import urllib.parse

            url = (f"{base}/handoff-status?id="
                   f"{urllib.parse.quote(handoff_id)}")
            with urllib.request.urlopen(url, timeout=2.0) as resp:
                body = json.loads(resp.read())
            return bool(body.get("complete"))
        except Exception:
            return False

    # -- receiver -----------------------------------------------------------

    def handle_handoff(self, body: bytes,
                       headers=None) -> Tuple[int, str, str]:
        """The ``POST /handoff`` merge: decode, guard by id (duplicate
        acks without merging — the id is registered BEFORE the merge,
        so a retry of a crashed-mid-merge attempt is at-most-once) and
        by per-sender epoch (a stale epoch is a replay of a superseded
        transition: 409), then merge through the import-semantics
        restore and ack with the merged count. A trace-bearing stream
        (``X-Veneur-Trace`` in ``headers``) records its
        ``handoff.receive`` hop, so ``/debug/trace`` stitches it."""
        t0_wall = time.time()
        try:
            groups, meta = decode_handoff(body)
        except CheckpointInvalid as e:
            return 400, json.dumps({"error": str(e)}), "application/json"
        except Exception as e:
            return 400, json.dumps({"error": f"undecodable: {e}"}), \
                "application/json"
        handoff_id = meta.get("id")
        sender = meta.get("sender", "")
        epoch = int(meta.get("epoch", 0) or 0)
        epoch_ctr = int(meta.get("epoch_ctr", 0) or 0)
        incarnation = str(meta.get("incarnation", "") or "")
        if not handoff_id:
            return 400, json.dumps({"error": "missing handoff id"}), \
                "application/json"
        # config-skew guard BEFORE anything merges: restore_state skips
        # incompatible groups (HLL precision, count-min geometry) with
        # only a warning — acking such a merge would delete the sender's
        # spool while the skipped series vanished. Rejecting whole, with
        # nothing merged and the id unregistered, keeps the state at the
        # sender (requeue: late, never lost) until the skew is fixed.
        # Read-only, so it runs before the guard block below.
        reason = self._refuse_reason(groups)
        if reason is not None:
            with self._lock:
                self.rejected_total += 1
            log.warning("refusing handoff %s from %s: %s", handoff_id,
                        sender, reason)
            return 422, json.dumps({"error": reason}), "application/json"
        # the id/epoch guards and the registration are ONE lock hold:
        # the ops mux is a ThreadingHTTPServer, so a client-side retry
        # of an in-flight POST runs concurrently — check-then-act
        # across two holds would let both merge (double count)
        with self._lock:
            if handoff_id in self._seen:
                self.duplicates_total += 1
                return 200, json.dumps(
                    {"id": handoff_id, "duplicate": True,
                     "merged": self._seen[handoff_id]}), "application/json"
            # the stale guard compares the hybrid (wall, ctr) epoch
            # WITHIN one sender incarnation: a fresh process life (new
            # incarnation) starts a fresh order, so a sender restarted
            # onto a skewed-backwards clock is never spuriously stale;
            # a replay from an OLD life still checks against that
            # life's own high-water mark, and the id guard covers the
            # cross-life spool re-send
            key = (sender, incarnation)
            last = self._sender_epochs.get(key, (0, 0))
            if (epoch, epoch_ctr) < last:
                self.stale_total += 1
                return 409, json.dumps(
                    {"error": f"stale handoff epoch {(epoch, epoch_ctr)}"
                              f" < {last} from {sender}"}), \
                    "application/json"
            self._sender_epochs[key] = (epoch, epoch_ctr)
            while len(self._sender_epochs) > SEEN_LIMIT:
                self._sender_epochs.pop(
                    next(iter(self._sender_epochs)))
            self._register_seen(handoff_id, 0)
        # prefer_live_scalars: the proxy re-routes NEW samples here the
        # moment the ring changes, while the old owner's extract+stream
        # takes seconds — a gauge sampled here since the resize is newer
        # than the handed-off value arriving now
        t0 = time.perf_counter()
        merged = self.store.restore_state(groups,
                                          prefer_live_scalars=True)
        self.last_merge_s = time.perf_counter() - t0
        with self._lock:
            self._seen[handoff_id] = merged
            self.receives_total += 1
            self.received_series_total += merged
        expected = int(meta.get("series", merged) or merged)
        if merged != expected:
            # partial merges can't be undone; make the shortfall loud
            # and countable instead of silently acking it away
            with self._lock:
                self.short_merges_total += 1
            log.error("handoff %s from %s merged %d of %d series — "
                      "investigate the receiver's restore path",
                      handoff_id, sender, merged, expected)
        log.info("handoff %s from %s (epoch %d): merged %d series",
                 handoff_id, sender, epoch, merged)
        ctx = tracectx.TraceContext.from_headers(headers)
        if self.hop_log is not None and ctx is not None:
            self.hop_log.record("handoff.receive", ctx, t0_wall,
                                time.time(), series=merged, sender=sender)
        return 200, json.dumps({"id": handoff_id, "merged": merged}), \
            "application/json"

    def _refuse_reason(self, groups: Dict[str, dict]) -> Optional[str]:
        """A whole-handoff rejection reason when any group could not
        merge completely on this store's config, or None to accept."""
        return config_skew_reason(self.store, groups)

    def _register_seen(self, handoff_id: str, merged: int):
        # caller holds self._lock (handle_handoff's guard block)
        self._seen[handoff_id] = merged
        self._seen_order.append(handoff_id)
        while len(self._seen_order) > SEEN_LIMIT:
            old = self._seen_order.pop(0)
            self._seen.pop(old, None)

    def status_route(self, query) -> Tuple[int, str, str]:
        """``GET /handoff-status?id=`` — the sender's ack-recovery
        probe."""
        handoff_id = query.get("id", "")
        with self._lock:
            complete = handoff_id in self._seen
            merged = self._seen.get(handoff_id, 0)
        return 200, json.dumps({"id": handoff_id, "complete": complete,
                                "merged": merged}), "application/json"

    # -- crash recovery -----------------------------------------------------

    def recover_spool(self) -> int:
        """Resolve any spooled (in-flight at crash time) handoffs.
        Each spool file first RE-SENDS with its ORIGINAL handoff id:
        if the receiver already merged it before the crash (the
        ack-then-crash window), the id guard acks as a duplicate
        without merging again — exactly-once across the restart. Only
        when the re-send fails (receiver down: the same contract as a
        live failure) does the state merge back into the live store —
        late, never lost. Runs at startup, after the regular checkpoint
        restore (the post-swap anchor ordering makes the two files
        disjoint). Returns the number of series re-merged locally."""
        if not self.spool_prefix:
            return 0
        import glob

        recovered = 0
        for path in sorted(glob.glob(self.spool_prefix + ".handoff.*")):
            if path.endswith(".tmp"):
                try:
                    os.unlink(path)
                except OSError:
                    pass  # an aborted write: its handoff stayed live
                continue
            try:
                blob = ckpt_format.read_file(path)
                if blob is None:
                    continue
                groups, meta = decode_handoff(blob)
                handoff_id = meta.get("id", path)
                dest = meta.get("dest", "")
                if dest and self._send(dest, blob, handoff_id):
                    self.spool_resent_total += 1
                    self.sent_total += 1
                    log.warning("re-delivered spooled handoff %s to %s "
                                "(duplicate-safe by id)", handoff_id,
                                dest)
                else:
                    n = self.store.restore_state(
                        groups, prefer_live_scalars=True)
                    recovered += n
                    log.warning("recovered spooled handoff %s (%d "
                                "series) into the live store",
                                handoff_id, n)
            except Exception:
                log.exception("discarding unreadable handoff spool %s",
                              path)
            try:
                os.unlink(path)
            except OSError:
                pass  # re-delivered or restored above
        self.spool_recovered_total += recovered
        return recovered

    # -- introspection ------------------------------------------------------

    def snapshot(self) -> dict:
        """The handoff state: membership, epoch, counts, breakers."""
        return {
            "self": self.self_addr,
            "members": list(self.watcher.members),
            "epoch": self.epoch,
            "epoch_ctr": self.epoch_ctr,
            "incarnation": self.incarnation,
            "resizes_total": self.resizes_total,
            "moved_series_total": self.moved_series_total,
            "sent_total": self.sent_total,
            "send_failures_total": self.send_failures_total,
            "requeued_series_total": self.requeued_series_total,
            "receives_total": self.receives_total,
            "received_series_total": self.received_series_total,
            "duplicates_total": self.duplicates_total,
            "stale_total": self.stale_total,
            "rejected_total": self.rejected_total,
            "short_merges_total": self.short_merges_total,
            "spool_recovered_total": self.spool_recovered_total,
            "spool_resent_total": self.spool_resent_total,
            "spool_errors_total": self.spool_errors_total,
            "retries_total": self.retries_total,
            "requeue_retries_total": self.requeue_retries_total,
            "retry_pending": self.retry_pending,
            "refresh_failures": self.watcher.failures,
            "last_duration_ns": self.last_duration_ns,
            "last_error": self.last_error,
            "breakers": dict(self.breakers.states()),
        }
