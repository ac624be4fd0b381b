"""The fleet aggregation view: one observability plane across instances.

Port of ``veneur_tpu/obs/fleet.py`` (host Python, copied).
``GET /debug/flush-timeline`` answers "where did THIS instance's
interval go"; a fleet asks "why was this interval's GLOBAL percentile
late", whose answer spans a local's flush, a proxy's fan-out, the
global's import and the global's own flush. The
:class:`FleetAggregator` (on any Server with ``obs_enabled``, most
usefully the global) closes the gap:

- ``GET /debug/fleet``: pulls every peer's ``/debug/flush-timeline``
  and ``/debug/vars`` and serves the merged view. Peer membership comes
  through a :class:`~veneur_tpu_torch.discovery.RingWatcher` (a failed
  or empty resolve keeps the previous set), and each peer's last good
  pull is kept and served ``stale: true`` when a fresh pull fails: a
  dead peer degrades the view, never empties it.
- ``GET /debug/trace?id=...``: the stitched per-trace hop view: every
  entry and hop carrying the trace id (``obs/tracectx.py``), across
  this instance's timeline, its pending hop log and the cached peer
  timelines, ordered by wall clock with each hop's duration, the
  end-to-end wall clock, and ``hop_coverage_ratio`` (the union of hop
  intervals over the e2e span).

Pulls are rate-limited (``fleet_pull_interval``), so a dashboard
hammering ``/debug/fleet`` costs the peers one pull a window, and a
trace lookup that misses forces at most one refresh a window. No lock
is held across a pull: two globals naming each other as peers never
wait on each other's aggregator.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Tuple

log = logging.getLogger("veneur.obs.fleet")

# how many intervals to pull per peer: enough to cover a trace spread
# across a few flush ticks without shipping whole rings around
PULL_INTERVALS = 16


def _base_url(addr: str) -> str:
    url = addr.rstrip("/")
    if not url.startswith(("http://", "https://")):
        url = "http://" + url
    return url


class FleetAggregator:
    """Keep-last-good peer puller + per-trace stitcher (see module
    docstring). ``timeline`` / ``hop_log`` are this instance's own
    sources; ``watcher`` is a discovery RingWatcher (None = no peers,
    the aggregator still serves its own entries)."""

    def __init__(self, self_addr: str = "", watcher=None, timeline=None,
                 hop_log=None, pull_timeout: float = 2.0,
                 pull_interval: float = 5.0, clock=time.monotonic):
        self.self_addr = self_addr
        self.watcher = watcher
        self.timeline = timeline
        self.hop_log = hop_log
        self.pull_timeout = pull_timeout
        self.pull_interval = pull_interval
        self._clock = clock
        self._lock = threading.Lock()  # cache + refresh gate
        self._cache: Dict[str, dict] = {}  # peer -> last good pull
        self._last_pull = float("-inf")
        self._last_forced = float("-inf")
        self.pulls_total = 0
        self.pull_errors_total = 0

    # -- pulling -------------------------------------------------------------

    def peers(self) -> List[str]:
        """Current membership, minus this instance (served locally).
        Keep-last-good lives in the watcher: a failed refresh keeps
        the previous member set."""
        if self.watcher is None:
            return []
        self.watcher.refresh()
        return [m for m in self.watcher.members if m != self.self_addr]

    def _pull_one(self, peer: str) -> dict:
        base = _base_url(peer)
        with urllib.request.urlopen(
                f"{base}/debug/flush-timeline?n={PULL_INTERVALS}",
                timeout=self.pull_timeout) as resp:
            tl = json.loads(resp.read())
        dvars: dict = {}
        try:
            with urllib.request.urlopen(f"{base}/debug/vars",
                                        timeout=self.pull_timeout) as resp:
                dvars = json.loads(resp.read())
        except Exception:
            # a peer without /debug/vars (or a slow one) still
            # contributes its timeline
            pass
        return {"ok": True, "stale": False, "error": "",
                "pulled_at": time.time(), "timeline": tl, "vars": dvars}

    def refresh(self, force: bool = False) -> None:
        """One pull round across the current peer set, rate-limited.
        Per-peer failures keep that peer's last good pull, marked
        stale — the same keep-last-good ladder discovery refresh
        applies to membership. Peers are pulled CONCURRENTLY: these
        endpoints matter most during a partition, exactly when peers
        time out, and a sequential round would stall the debug request
        up to pull_timeout × peers instead of ~one pull_timeout."""
        with self._lock:
            now = self._clock()
            if not force and now - self._last_pull < self.pull_interval:
                return
            self._last_pull = now
        peers = self.peers()

        def pull(peer: str) -> None:
            try:
                pulled = self._pull_one(peer)
            except Exception as e:
                with self._lock:
                    self.pull_errors_total += 1
                    old = self._cache.get(peer)
                    if old is not None:
                        old["ok"] = False
                        old["stale"] = True
                        old["error"] = str(e)[:160]
                    else:
                        self._cache[peer] = {
                            "ok": False, "stale": True,
                            "error": str(e)[:160], "pulled_at": None,
                            "timeline": {"intervals": []}, "vars": {}}
                return
            with self._lock:
                self.pulls_total += 1
                self._cache[peer] = pulled

        if len(peers) == 1:
            pull(peers[0])
        elif peers:
            threads = [threading.Thread(target=pull, args=(p,),
                                        daemon=True) for p in peers]
            for t in threads:
                t.start()
            for t in threads:
                # urllib enforces pull_timeout per request; the join
                # bound is a backstop, not the budget
                t.join(timeout=2 * self.pull_timeout + 1.0)
        # prune departed peers (membership is keep-last-good, so a
        # peer only leaves the cache once discovery really dropped it)
        with self._lock:
            for gone in set(self._cache) - set(peers):
                del self._cache[gone]

    # -- sources -------------------------------------------------------------

    def _is_self(self, pulled: dict) -> bool:
        """A pull of THIS instance (fleet_peers lists every instance,
        including the puller; handoff_self is empty in tracing-only
        deployments, so the address can't tell) — recognized by the
        timeline's per-process uid, and dropped from stitching so no
        hop ever appears twice."""
        if self.timeline is None:
            return False
        uid = (pulled.get("timeline") or {}).get("instance_uid")
        return bool(uid) and uid == self.timeline.uid

    def _sources(self) -> List[Tuple[str, List[dict], List[dict]]]:
        """(origin, timeline entries, pending hops) per instance —
        self first, then each cached peer."""
        out: List[Tuple[str, List[dict], List[dict]]] = []
        own_entries = self.timeline.entries() if self.timeline else []
        own_hops = self.hop_log.peek() if self.hop_log else []
        out.append((self.self_addr or "self", own_entries, own_hops))
        with self._lock:
            cache = dict(self._cache)
        for peer, pulled in sorted(cache.items()):
            if self._is_self(pulled):
                continue  # own entries are already source[0]
            entries = (pulled.get("timeline") or {}).get("intervals") \
                or []
            out.append((peer, entries, []))
        return out

    # -- routes --------------------------------------------------------------

    def fleet_route(self, query) -> Tuple[int, str, str]:
        """``GET /debug/fleet``: the merged per-peer view. ``?n=K``
        includes each peer's last K raw intervals (default: summaries
        only)."""
        try:
            n = int(query.get("n", "0") or 0)
        except ValueError:
            return 400, "n must be an integer", "text/plain"
        self.refresh(force=query.get("refresh") == "1")
        body: dict = {"self": self.self_addr,
                      "members": (list(self.watcher.members)
                                  if self.watcher else []),
                      "pulls_total": self.pulls_total,
                      "pull_errors_total": self.pull_errors_total,
                      "peers": {}}
        with self._lock:
            cache = dict(self._cache)
        for peer, pulled in sorted(cache.items()):
            tl = pulled.get("timeline") or {}
            intervals = tl.get("intervals") or []
            last = intervals[-1] if intervals else None
            summary = {
                "ok": pulled.get("ok", False),
                "self": self._is_self(pulled),
                "stale": pulled.get("stale", False),
                "error": pulled.get("error", ""),
                "pulled_at": pulled.get("pulled_at"),
                "published_total": tl.get("published_total"),
                "last_interval": {
                    "interval": last.get("interval"),
                    "total_duration_ns": last.get("total_duration_ns"),
                    "coverage_ratio": last.get("coverage_ratio"),
                    "e2e_age_ns": last.get("e2e_age_ns"),
                } if last else None,
            }
            if n > 0:
                summary["intervals"] = intervals[-n:]
            body["peers"][peer] = summary
        if self.timeline is not None:
            body["own_timeline"] = self.timeline.snapshot()
        if self.hop_log is not None:
            body["own_hops"] = self.hop_log.snapshot()
        return 200, json.dumps(body, default=str), "application/json"

    def trace_route(self, query) -> Tuple[int, str, str]:
        """``GET /debug/trace?id=…``: the stitched hop view."""
        raw = query.get("id", "")
        try:
            trace_id = int(raw)
        except ValueError:
            return 400, "id must be a trace id (integer)", "text/plain"
        self.refresh()  # rate-limited; keeps the peer caches warm
        stitched = stitch_trace(trace_id, self._sources())
        if not stitched["hops"]:
            # maybe the peers flushed since the last pull window —
            # but an id that stays unknown (expired out of the rings,
            # or a typo polled by a dashboard) must not let every miss
            # bypass the rate limit: at most ONE forced pull per
            # pull_interval window across all misses
            with self._lock:
                now = self._clock()
                may_force = now - self._last_forced >= self.pull_interval
                if may_force:
                    self._last_forced = now
            if may_force:
                self.refresh(force=True)
                stitched = stitch_trace(trace_id, self._sources())
        status = 200 if stitched["hops"] else 404
        return status, json.dumps(stitched, default=str), \
            "application/json"

    def snapshot(self) -> dict:
        with self._lock:
            peers = {p: {"ok": c.get("ok"), "stale": c.get("stale")}
                     for p, c in self._cache.items()}
        return {"members": (list(self.watcher.members)
                            if self.watcher else []),
                "pulls_total": self.pulls_total,
                "pull_errors_total": self.pull_errors_total,
                "peers": peers}


# ---------------------------------------------------------------------------
# stitching
# ---------------------------------------------------------------------------


def _entry_hop(entry: dict, origin: str) -> dict:
    return {"hop": entry.get("hop") or "flush",
            "origin": origin,
            "wall_start": entry["wall_start"],
            "wall_end": entry["wall_end"],
            "duration_ns": int(entry.get("total_duration_ns") or 0),
            "span_id": entry.get("span_id"),
            "parent_span_id": entry.get("parent_span_id"),
            "interval": entry.get("interval"),
            "coverage_ratio": entry.get("coverage_ratio")}


def _stage_hop(entry: dict, stage: dict, origin: str,
               hop: Optional[str] = None) -> dict:
    if "wall_start" in stage and "wall_end" in stage:
        # a drained hop record carries its TRUE wall times as attrs —
        # the entry-relative frame clamps anything that landed before
        # the interval started
        start, end = stage["wall_start"], stage["wall_end"]
    else:
        start = entry["wall_start"] + stage["start_ns"] / 1e9
        end = start + stage["duration_ns"] / 1e9
    out = {k: v for k, v in stage.items()
           if k not in ("name", "start_ns", "duration_ns", "off_path",
                        "wall_start", "wall_end")}
    out["hop"] = hop or stage["name"]
    out["origin"] = origin
    out["wall_start"] = start
    out["wall_end"] = end
    out["duration_ns"] = max(0, int((end - start) * 1e9))
    return out


def stitch_trace(trace_id: int, sources) -> dict:
    """Gather every hop carrying ``trace_id`` across ``sources``
    ((origin, entries, pending_hops) triples) into one ordered view:

    - a timeline entry published UNDER the id (a local flush, a proxy
      fan-out, a handoff send) is one hop spanning the entry;
    - the off-path ``forward`` stage inside such an entry is its own
      hop (it outlives the flush that launched it);
    - stages inside ANY entry stamped with the id (drained import /
      handoff hop records) are hops;
    - an entry whose ``import_traces`` includes the id is the
      aggregating flush — one hop covering swap → sink POSTs;
    - pending (not-yet-drained) hop-log records round it out.

    ``hop_coverage_ratio`` is the union of hop wall intervals over the
    end-to-end span (first hop start → last hop end): overlap never
    inflates it past 1, and a gap nobody instrumented (e.g. state
    waiting for the global's next tick — reported per-gap in
    ``gaps``) pulls it down honestly."""
    hops: List[dict] = []
    for origin, entries, pending in sources:
        for e in entries:
            if e.get("trace_id") == trace_id:
                hops.append(_entry_hop(e, origin))
                for s in e.get("stages", ()):
                    if s.get("off_path") and s.get("name") == "forward":
                        hops.append(_stage_hop(e, s, origin,
                                               hop="forward"))
            if trace_id in (e.get("import_traces") or ()):
                agg = _entry_hop(e, origin)
                agg["hop"] = e.get("hop") or "global.flush"
                agg["aggregated"] = True
                hops.append(agg)
            for s in e.get("stages", ()):
                if s.get("trace_id") == trace_id:
                    hops.append(_stage_hop(e, s, origin))
        for h in pending:
            if h.get("trace_id") == trace_id:
                hops.append(dict(h, origin=origin, pending=True))
    hops.sort(key=lambda h: h["wall_start"])
    out: dict = {"trace_id": trace_id, "hops": hops}
    if not hops:
        return out
    t0 = min(h["wall_start"] for h in hops)
    t1 = max(h["wall_end"] for h in hops)
    e2e_ns = max(0, int((t1 - t0) * 1e9))
    out["e2e_wall_ns"] = e2e_ns
    # union coverage + the uncovered gaps
    covered = 0.0
    gaps: List[dict] = []
    cursor = t0
    for h in hops:  # already wall_start-sorted above
        start, end = h["wall_start"], h["wall_end"]
        if start > cursor:
            gaps.append({"after_wall": cursor,
                         "gap_ns": int((start - cursor) * 1e9)})
            cursor = start
        if end > cursor:
            covered += end - cursor
            cursor = end
    out["hop_coverage_ratio"] = round(covered * 1e9 / e2e_ns, 4) \
        if e2e_ns else 1.0
    if gaps:
        out["gaps"] = gaps
    ingest = [h.get("ingest_ns") for h in hops if h.get("ingest_ns")]
    if ingest:
        out["ingest_ns"] = min(ingest)
        out["e2e_age_ns"] = max(0, int(t1 * 1e9) - min(ingest))
    return out
