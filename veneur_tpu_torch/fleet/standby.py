"""Global HA: warm-standby replication with leased failover.

Port of ``veneur_tpu/fleet/standby.py``. One global folds every
distribution of the fleet, so it is the tier's single point of failure;
this plane keeps a warm standby beside it:

**Active side**: after each flush lands, the flusher hands the retired
snapshot (taken with ``MetricStore.snapshot_state`` just before the
flush consumed it) to :meth:`StandbyManager.capture`; a replicator
thread encodes it in the handoff's envelope (``fleet/handoff.py``) and
POSTs it to every standby's ``/replicate``, stamped with the flush
epoch, the sender's lease fencing epoch and a per-life incarnation id.
The queue is depth 1, dropping the oldest: replication never holds up
the flush loop, and a dropped epoch only widens the loss window to the
next interval (``dropped_epochs_total``).

**Standby side**: ``handle_replicate`` guards as the handoff receiver
does (a duplicate id acks, a stale per-(sender, incarnation) epoch is
409, a config skew 422), plus the split-brain fence: a stream whose
``lease_epoch`` is below the highest this standby has seen is a deposed
active's late flush, refused with 409, nothing merged. Accepted epochs
land in a per-sender shadow (the last ``standby_shadow_epochs``),
decoded and held OFF the live store: merged before promotion, the
standby's own flush would emit the active's series every interval.

**Promotion**: on acquiring the lease the elector calls
:meth:`promote`, which merges each sender's NEWEST shadow epoch into
the live store, every group but the counters (their import drains run
K2 on the card). Replication is strictly post-flush, so every
replicated counter total was already emitted by the dead active;
merging counters would double-count at the sink. Gauges, digests, sets
and heavy hitters re-merge, so the promoted standby serves the merged
global percentiles at once. What dies with the active is the
un-flushed tail of its last interval, bounded by one flush interval.

The fleet trace plane (``obs/tracectx.py``): each ``POST /replicate``
carries the active flush span's ids in ``X-Veneur-Trace`` (no ingest
stamp: the standby emits none of it), and the standby records an
``ha.replicate`` hop for each trace-bearing stream, which its next flush
counts in ``veneur.trace.hops_total``. The JAX package's standby reads
the header the same way; its replicator sends none.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request
import uuid
from typing import Callable, Dict, List, Optional, Tuple

from veneur_tpu_torch.fleet.handoff import (SEEN_LIMIT,
                                            config_skew_reason,
                                            decode_handoff, encode_handoff,
                                            snapshot_counts)
from veneur_tpu_torch.obs import tracectx
from veneur_tpu_torch.resilience import (BreakerRegistry, Deadline,
                                         RetryPolicy, is_transient_status,
                                         post_with_retry)

log = logging.getLogger("veneur.fleet.standby")

# groups whose replicated state may merge at promotion. Counters are
# deliberately ABSENT: replication happens after the flush emitted
# them, so a promoted standby re-merging counter totals would
# double-count at the sink — the counter tail the active never flushed
# is the accounted loss instead.
PROMOTABLE_GROUPS = ("global_gauges", "histograms", "timers", "sets",
                     "heavy_hitters")


class ReplicaShadow:
    """Per-sender ring of the last N replicated epochs, decoded but
    held OFF the live store until promotion."""

    def __init__(self, keep: int = 2):
        self.keep = max(1, int(keep))
        # sender -> list of (flush_epoch, groups, meta, received_wall),
        # newest last
        self._epochs: Dict[str, List[tuple]] = {}

    def add(self, sender: str, flush_epoch: int, groups: Dict[str, dict],
            meta: dict, now: float) -> None:
        ring = self._epochs.setdefault(sender, [])
        ring.append((flush_epoch, groups, meta, now))
        while len(ring) > self.keep:
            ring.pop(0)

    def latest(self) -> Dict[str, tuple]:
        """sender -> newest (flush_epoch, groups, meta, received_wall)."""
        return {sender: ring[-1]
                for sender, ring in self._epochs.items() if ring}

    def newest_wall(self) -> float:
        """Wall stamp of the most recently received epoch (0 = none) —
        the replication-age gauge's anchor."""
        return max((ring[-1][3] for ring in self._epochs.values()
                    if ring), default=0.0)

    def series_held(self) -> int:
        return sum(sum(len(snap.get("names") or ())
                       for snap in ring[-1][1].values())
                   for ring in self._epochs.values() if ring)

    def clear(self) -> None:
        self._epochs.clear()


class StandbyManager:
    """Owns one instance's side of the warm-standby plane, both roles:
    the active's replicator (capture → encode → POST per peer) and the
    standby's ``/replicate`` receiver + shadow + promotion."""

    def __init__(self, store, self_addr: str, peers, timeout: float = 10.0,
                 retry_policy=None, breakers=None, shadow_epochs: int = 2,
                 injector=None, clock: Callable[[], float] = time.time,
                 hop_log=None):
        self.store = store
        # the fleet trace plane: a received replication's hop
        self.hop_log = hop_log
        self.self_addr = self_addr
        # a "file:///path" spec re-reads per dispatch (the orchestrator-
        # managed flavor); a list/CSV is static
        self._peers_file = ""
        if isinstance(peers, str):
            if peers.startswith("file://"):
                self._peers_file = peers[len("file://"):]
                peers = []
            else:
                peers = [p.strip() for p in peers.split(",") if p.strip()]
        self.peers = [p for p in peers if p and p != self_addr]
        self.timeout = timeout
        self.retry_policy = retry_policy or RetryPolicy()
        self.breakers = breakers or BreakerRegistry()
        self.injector = injector
        self.clock = clock
        self.incarnation = uuid.uuid4().hex[:12]
        self._seq = 0
        self._lock = threading.Lock()
        # -- active side: depth-1 drop-oldest hand-over to the
        # replicator thread (replication never back-pressures a flush)
        self._pending: Optional[tuple] = None  # (epoch, groups)
        self._kick = threading.Event()
        # the elector sets this; capture/dispatch no-op while False so
        # a demoted (fenced) instance stops streaming immediately
        self.is_leader = False
        self.lease_epoch = 0
        # -- standby side
        self.shadow = ReplicaShadow(keep=shadow_epochs)
        self._seen: Dict[str, int] = {}
        self._seen_order: List[str] = []
        self._sender_epochs: Dict[Tuple[str, str], int] = {}
        self._max_lease_epoch = 0
        self.promoted = False
        self.promoted_at = 0.0
        # -- counts (snapshot(), GET /ha-status and the flush's
        # veneur.ha.* self-metrics)
        self.replicated_total = 0
        self.replicated_series_total = 0
        self.replicate_failures_total = 0
        self.dropped_epochs_total = 0
        self.receives_total = 0
        self.received_series_total = 0
        self.duplicates_total = 0
        self.stale_total = 0
        self.fenced_total = 0
        self.rejected_total = 0
        self.promotions_total = 0
        self.promoted_series_total = 0
        self.retries_total = 0
        self.last_replicate_ns = 0
        self.last_replicate_bytes = 0
        # the last promotion's merge (restore_state) in seconds
        self.last_promote_s = 0.0
        self.last_error = ""

    # -- construction -------------------------------------------------------

    @classmethod
    def for_server(cls, server) -> "StandbyManager":
        cfg = server.config
        return cls(
            store=server.store,
            self_addr=cfg.handoff_self or cfg.http_address,
            peers=cfg.standby_peers or "",
            timeout=cfg.handoff_timeout_seconds,
            retry_policy=RetryPolicy.from_config(cfg),
            breakers=BreakerRegistry(
                failure_threshold=cfg.breaker_failure_threshold,
                reset_timeout=cfg.breaker_reset_timeout_seconds),
            shadow_epochs=cfg.standby_shadow_epochs,
            injector=getattr(
                getattr(server, "handoff_manager", None), "injector",
                None),
            hop_log=server.obs_hops)

    def _resolve_peers(self) -> List[str]:
        if not self._peers_file:
            return self.peers
        try:
            with open(self._peers_file) as f:
                lines = f.read().splitlines()
        except OSError as e:
            # keep-last-good, same as every discovery refresh
            self.last_error = f"peers file: {e}"
            return self.peers
        peers = [ln.strip() for ln in lines
                 if ln.strip() and not ln.lstrip().startswith("#")]
        self.peers = [p for p in peers if p != self.self_addr]
        return self.peers

    # -- leadership hooks (LeaseElector callbacks) ---------------------------

    def on_promote(self, lease_epoch: int) -> None:
        with self._lock:
            self.is_leader = True
            self.lease_epoch = lease_epoch
        self.promote(lease_epoch)

    def on_demote(self, reason: str) -> None:
        with self._lock:
            self.is_leader = False
        log.warning("standby manager fenced (demoted): %s", reason)

    # -- active: capture + replicator thread ---------------------------------

    def wants_capture(self) -> bool:
        """Whether this flush replicates: only while leading and with
        peers, so a fenced ex-active stops at once and a peerless one
        never snapshots."""
        return self.is_leader and bool(self.peers or self._peers_file)

    def capture(self, groups: Dict[str, dict], flush_epoch: int,
                trace_ctx=None) -> None:
        """Hand one retired flush snapshot to the replicator (the flusher
        asks :meth:`wants_capture` first). Depth-1 drop-oldest: a slow
        peer costs the OLDEST un-replicated epoch (widening the loss
        window to the next interval), never the flush loop. A
        ``trace_ctx`` (the flush span's) rides each ``POST /replicate``
        as ``X-Veneur-Trace``."""
        with self._lock:
            if self._pending is not None:
                self.dropped_epochs_total += 1
            self._pending = (flush_epoch, groups, trace_ctx)
        self._kick.set()

    def run(self, stop: threading.Event) -> None:
        """Replicator loop: wait for a captured epoch, stream it. One
        failing dispatch never kills the thread."""
        while not stop.is_set():
            if not self._kick.wait(timeout=0.5):
                continue
            self._kick.clear()
            try:
                self.dispatch()
            except Exception:
                log.exception("replication dispatch failed; next epoch "
                              "retries")

    def dispatch(self) -> Optional[dict]:
        """Stream the pending epoch to every standby peer. Gated on
        leadership: a fenced instance stops replicating the moment the
        elector demotes it (anything already in flight is rejected by
        the receiver's lease-epoch fence)."""
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is None:
            return None
        flush_epoch, groups, ctx = pending
        peers = self._resolve_peers()
        if not self.is_leader or not peers:
            return None
        t0 = time.monotonic_ns()
        groups = {name: snap for name, snap in groups.items()
                  if snap.get("names")}
        with self._lock:
            self._seq += 1
            seq = self._seq
        replicate_id = (f"{self.self_addr}:{flush_epoch}:{seq}:"
                        f"{uuid.uuid4().hex[:12]}")
        meta = {"kind": "replicate", "id": replicate_id,
                "sender": self.self_addr, "epoch": flush_epoch,
                "lease_epoch": self.lease_epoch,
                "incarnation": self.incarnation,
                "series": sum(snapshot_counts(groups).values()),
                "counts": snapshot_counts(groups)}
        blob = encode_handoff(groups, meta, time.time())
        self.last_replicate_bytes = len(blob)
        summary = {"epoch": flush_epoch, "series": meta["series"],
                   "sent": [], "failed": []}
        for dest in peers:
            if self._send(dest, blob, replicate_id, ctx=ctx):
                self.replicated_total += 1
                self.replicated_series_total += meta["series"]
                summary["sent"].append(dest)
            else:
                self.replicate_failures_total += 1
                summary["failed"].append(dest)
        self.last_replicate_ns = time.monotonic_ns() - t0
        return summary

    @staticmethod
    def _base_url(dest: str) -> str:
        url = dest.rstrip("/")
        if not url.startswith(("http://", "https://")):
            url = "http://" + url
        return url

    def _post_blob(self, url: str, blob: bytes, timeout: float,
                   out: dict, ctx=None) -> int:
        if self.injector is not None:
            self.injector.maybe_fail(f"replicate.post.{url}")
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

    def _send(self, dest: str, blob: bytes, replicate_id: str,
              ctx=None) -> bool:
        base = self._base_url(dest)
        breaker = self.breakers.get(dest)
        if self.injector is not None \
                and self.injector.is_partitioned(dest):
            breaker.record_failure()
            self.last_error = f"{dest}: injected partition"
            return False
        if not breaker.allow():
            # replication is best-effort per epoch — no probe/requeue:
            # the NEXT interval's stream supersedes this one anyway,
            # and a duplicate landing late is absorbed by the id guard
            self.last_error = f"{dest}: circuit breaker open"
            return False
        deadline = Deadline.after(self.timeout)
        info: dict = {}

        def on_retry(retry_index, exc, pause):
            self.retries_total += 1

        try:
            status = post_with_retry(
                lambda: self._post_blob(
                    base + "/replicate", blob,
                    deadline.clamp(self.timeout), info, ctx=ctx),
                self.retry_policy, deadline=deadline, on_retry=on_retry)
        except Exception as e:
            breaker.record_failure()
            self.last_error = f"{dest}: {e}"
            return False
        if 200 <= status < 300:
            breaker.record_success()
            return True
        if is_transient_status(status):
            breaker.record_failure()
        else:
            # a 409/422 is the receiver speaking, not the peer down —
            # notably 409-fenced means THIS instance is the deposed one
            breaker.record_success()
        self.last_error = f"{dest}: HTTP {status}"
        log.warning("replicate %s to %s returned HTTP %d (%s)",
                    replicate_id, dest, status,
                    (info.get("body") or b"")[:120])
        return False

    # -- standby: receiver ----------------------------------------------------

    def handle_replicate(self, body: bytes,
                         headers=None) -> Tuple[int, str, str]:
        """``POST /replicate``: decode, then guard under ONE lock hold
        (the ops mux is threaded — split check-then-act would let a
        concurrent retry shadow the same epoch twice): id duplicate →
        200 ack; ``lease_epoch`` below the fence → 409 (a deposed
        active's late flush — the split-brain guard); per-(sender,
        incarnation) flush epoch not newer → 409 stale; config skew →
        422 whole-rejection. Accepted epochs land in the shadow, NOT
        the live store. A trace-bearing stream (``X-Veneur-Trace`` in
        ``headers``) records its ``ha.replicate`` hop in the hop log."""
        t0_wall = time.time()
        try:
            groups, meta = decode_handoff(body)
        except Exception as e:
            return 400, json.dumps({"error": f"undecodable: {e}"}), \
                "application/json"
        replicate_id = meta.get("id")
        sender = meta.get("sender", "")
        flush_epoch = int(meta.get("epoch", 0) or 0)
        lease_epoch = int(meta.get("lease_epoch", 0) or 0)
        incarnation = str(meta.get("incarnation", "") or "")
        if not replicate_id:
            return 400, json.dumps({"error": "missing replicate id"}), \
                "application/json"
        reason = config_skew_reason(self.store, groups)
        if reason is not None:
            with self._lock:
                self.rejected_total += 1
            log.warning("refusing replication %s from %s: %s",
                        replicate_id, sender, reason)
            return 422, json.dumps({"error": reason}), "application/json"
        with self._lock:
            if replicate_id in self._seen:
                self.duplicates_total += 1
                return 200, json.dumps(
                    {"id": replicate_id, "duplicate": True}), \
                    "application/json"
            if lease_epoch < self._max_lease_epoch:
                self.fenced_total += 1
                return 409, json.dumps(
                    {"error": f"fenced: lease epoch {lease_epoch} < "
                              f"{self._max_lease_epoch} (deposed "
                              f"active)"}), "application/json"
            key = (sender, incarnation)
            # -1 sentinel: a sender's very first flush legitimately
            # carries epoch 0 (HybridEpoch counter starts there)
            last = self._sender_epochs.get(key, -1)
            if flush_epoch <= last:
                self.stale_total += 1
                return 409, json.dumps(
                    {"error": f"stale replication epoch {flush_epoch} "
                              f"<= {last} from {sender}"}), \
                    "application/json"
            self._max_lease_epoch = max(self._max_lease_epoch,
                                        lease_epoch)
            self._sender_epochs[key] = flush_epoch
            while len(self._sender_epochs) > SEEN_LIMIT:
                self._sender_epochs.pop(next(iter(self._sender_epochs)))
            self._seen[replicate_id] = 0  # registered BEFORE the shadow
            self._seen_order.append(replicate_id)
            while len(self._seen_order) > SEEN_LIMIT:
                self._seen.pop(self._seen_order.pop(0), None)
            series = sum(len(s.get("names") or ())
                         for s in groups.values())
            self.shadow.add(sender, flush_epoch, groups, meta,
                            self.clock())
            self._seen[replicate_id] = series
            self.receives_total += 1
            self.received_series_total += series
        ctx = tracectx.TraceContext.from_headers(headers)
        if self.hop_log is not None and ctx is not None:
            self.hop_log.record("ha.replicate", ctx, t0_wall, time.time(),
                                series=series, sender=sender)
        return 200, json.dumps({"id": replicate_id,
                                "shadowed": series}), "application/json"

    # -- promotion ------------------------------------------------------------

    def promote(self, lease_epoch: int) -> int:
        """Merge each sender's newest shadow epoch into the live store
        — NON-counter groups only (see module docstring: replicated
        counters were already emitted by the dead active; re-merging
        them would double-count at the sink, so the counter tail is the
        accounted loss instead). Returns the series merged."""
        with self._lock:
            latest = self.shadow.latest()
            self.lease_epoch = max(self.lease_epoch, lease_epoch)
            self._max_lease_epoch = max(self._max_lease_epoch,
                                        lease_epoch)
            already = self.promoted
            self.promoted = True
            self.promoted_at = self.clock()
            self.promotions_total += 1
        merged = 0
        t0 = time.perf_counter()
        for sender, (flush_epoch, groups, _meta, _wall) in \
                sorted(latest.items()):
            mergeable = {name: snap for name, snap in groups.items()
                         if name in PROMOTABLE_GROUPS}
            if not mergeable:
                # a counter-only shadow: the dead active emitted it
                continue
            try:
                # prefer_live_scalars: a gauge this instance sampled
                # after the takeover is newer than the replicated value
                merged += self.store.restore_state(
                    mergeable, prefer_live_scalars=True)
            except Exception:
                log.exception("promotion merge of %s epoch %d failed",
                              sender, flush_epoch)
        self.last_promote_s = time.perf_counter() - t0
        with self._lock:
            self.promoted_series_total += merged
        # a boot-time acquisition (nothing ever replicated to us) is the
        # normal path for the first active — only a real takeover warns
        lvl = log.warning if latest else log.info
        lvl("standby promoted (lease epoch %d%s): merged %d "
            "series from %d sender(s)", lease_epoch,
            ", re-promotion" if already else "", merged,
            len(latest))
        return merged

    # -- introspection --------------------------------------------------------

    def replication_age_seconds(self) -> float:
        """Seconds since the newest shadow epoch arrived (-1 = never):
        the standby's staleness gauge — at takeover, the loss window is
        roughly this plus the dead active's un-flushed tail."""
        newest = self.shadow.newest_wall()
        if newest <= 0:
            return -1.0
        return max(0.0, self.clock() - newest)

    def snapshot(self) -> dict:
        """The HA state: role, fencing epoch, counts (``GET /ha-status``)."""
        with self._lock:
            return {
                "self": self.self_addr,
                "peers": list(self.peers),
                "is_leader": self.is_leader,
                "lease_epoch": self.lease_epoch,
                "incarnation": self.incarnation,
                "promoted": self.promoted,
                "promoted_at": self.promoted_at,
                "replicated_total": self.replicated_total,
                "replicated_series_total": self.replicated_series_total,
                "replicate_failures_total":
                    self.replicate_failures_total,
                "dropped_epochs_total": self.dropped_epochs_total,
                "receives_total": self.receives_total,
                "received_series_total": self.received_series_total,
                "duplicates_total": self.duplicates_total,
                "stale_total": self.stale_total,
                "fenced_total": self.fenced_total,
                "rejected_total": self.rejected_total,
                "promotions_total": self.promotions_total,
                "promoted_series_total": self.promoted_series_total,
                "retries_total": self.retries_total,
                "shadow_series_held": self.shadow.series_held(),
                "replication_age_seconds":
                    self.replication_age_seconds(),
                "last_replicate_ns": self.last_replicate_ns,
                "last_error": self.last_error,
                "breakers": dict(self.breakers.states()),
            }

    def status_route(self, query) -> Tuple[int, str, str]:
        """``GET /ha-status`` — role, fencing epoch, replication age
        (the operator's takeover dashboard: a promotion shows here)."""
        return 200, json.dumps(self.snapshot(), default=str), \
            "application/json"
