"""Lease-based leadership for the global-aggregator HA pair.

Port of ``veneur_tpu/discovery/lease.py`` (stdlib only; the lease file's
record is the JAX package's, so either package reads the other's). The
warm-standby plane (``fleet/standby.py``) needs exactly one ACTIVE
global at a time and a bounded window in which a standby takes over
after the active dies. Both come from one primitive: a **lease**, a
record ``{holder, epoch, expires_at}`` in a shared store (a file on
shared disk, or a Consul session-bound KV key) that the active renews
and a standby tries to acquire every ``lease_renew_interval``:

* the **fencing epoch** increments on every change of holding life
  (acquisition after expiry or release), never on renewal; replication
  streams carry it, so a deposed active's late ``POST /replicate`` is
  provably stale (the split-brain guard);
* renewal is **keep-last-good**: a transient backend error (a shared
  disk blip, a Consul timeout) never demotes the holder before the ttl
  it already paid for lapses;
* :class:`LeaderDiscoverer` adapts the lease into the ``Discoverer``
  protocol (returning ``[holder]``), so a ring or a forwarder re-routes
  to a promoted standby within one ordinary membership refresh.

``file://`` leases use ``flock`` around the read-modify-write: mutual
exclusion on one host or one shared filesystem. ``consul://`` points at
a session-TTL'd key.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Callable, List, Optional

log = logging.getLogger("veneur.discovery.lease")


@dataclass
class LeaseState:
    """One observation of the lease record."""

    holder: str
    epoch: int          # fencing token: bumps per acquisition, not renewal
    expires_at: float   # wall clock; <= now means up for grabs

    def expired(self, now: float) -> bool:
        return now >= self.expires_at


class FileLease:
    """Lease in a JSON file, serialized by ``flock`` on a sidecar lock
    file. Atomic replace (tmp + ``os.replace``) keeps readers crash-
    consistent; the flock keeps two acquirers on the same filesystem
    from both winning one expiry."""

    def __init__(self, path: str, clock: Callable[[], float] = time.time):
        self.path = path
        self.clock = clock

    # -- record io ----------------------------------------------------------

    def _read_raw(self) -> Optional[LeaseState]:
        try:
            with open(self.path) as f:
                rec = json.load(f)
            return LeaseState(str(rec.get("holder", "")),
                              int(rec.get("epoch", 0)),
                              float(rec.get("expires_at", 0.0)))
        except FileNotFoundError:
            return None
        except (OSError, ValueError, TypeError):
            # a torn/corrupt record is an expired lease, not a crash:
            # the next acquirer rewrites it with a bumped epoch
            log.warning("unreadable lease file %s; treating as expired",
                        self.path)
            return None

    def _write(self, state: LeaseState) -> None:
        tmp = self.path + ".tmp"
        blob = json.dumps({"holder": state.holder, "epoch": state.epoch,
                           "expires_at": state.expires_at}).encode()
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            os.write(fd, blob)
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, self.path)

    def _locked(self):
        import fcntl
        from contextlib import contextmanager

        @contextmanager
        def hold():
            fd = os.open(self.path + ".lock",
                         os.O_RDWR | os.O_CREAT, 0o644)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX)
                yield
            finally:
                fcntl.flock(fd, fcntl.LOCK_UN)
                os.close(fd)
        return hold()

    # -- protocol -----------------------------------------------------------

    def read(self) -> Optional[LeaseState]:
        return self._read_raw()

    def acquire_or_renew(self, holder: str,
                         ttl: float) -> Optional[LeaseState]:
        """One acquisition/renewal attempt. Returns the held state when
        ``holder`` owns the lease after the call, None when another
        un-expired holder does. The fencing epoch bumps on every CHANGE
        of holding life — a different holder taking over, or the same
        holder re-acquiring after its own expiry (a new life must fence
        its old replication stream) — and stays put across renewals."""
        now = self.clock()
        with self._locked():
            cur = self._read_raw()
            if cur is not None and cur.holder != holder \
                    and not cur.expired(now):
                return None
            if cur is not None and cur.holder == holder \
                    and not cur.expired(now):
                new = LeaseState(holder, cur.epoch, now + ttl)
            else:
                new = LeaseState(holder, (cur.epoch if cur else 0) + 1,
                                 now + ttl)
            self._write(new)
            return new

    def release(self, holder: str) -> None:
        """Clean-shutdown handback: expire the lease NOW (epoch kept, so
        the next acquirer still fences above this life) — a standby
        promotes on its next poll instead of waiting out the ttl."""
        now = self.clock()
        with self._locked():
            cur = self._read_raw()
            if cur is not None and cur.holder == holder:
                self._write(LeaseState(holder, cur.epoch, now))


class ConsulLease:
    """Lease on a Consul session-bound KV key: the session's TTL is the
    lease ttl (Consul expires it server-side), ``?acquire=`` is the
    atomic acquisition, and the KV record's ``ModifyIndex`` is the
    fencing epoch (bumps on every ownership write, exactly the
    per-acquisition token the split-brain guard needs)."""

    def __init__(self, key: str,
                 consul_url: str = "http://127.0.0.1:8500",
                 timeout: float = 5.0):
        self.key = key.strip("/")
        self.base = consul_url.rstrip("/")
        self.timeout = timeout
        self._session: Optional[str] = None

    def _call(self, method: str, path: str, body: Optional[dict] = None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(self.base + path, data=data,
                                     method=method)
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            raw = resp.read()
        return json.loads(raw) if raw else None

    def _kv_read(self) -> Optional[dict]:
        try:
            entries = self._call("GET", f"/v1/kv/{self.key}")
        except urllib.error.HTTPError as e:
            e.close()
            if e.code == 404:
                return None
            raise
        return entries[0] if entries else None

    def read(self) -> Optional[LeaseState]:
        entry = self._kv_read()
        if entry is None or not entry.get("Session"):
            return None
        import base64

        try:
            rec = json.loads(base64.b64decode(entry.get("Value") or b""))
        except (ValueError, TypeError):
            rec = {}
        # Consul expires the session server-side; while one is attached
        # the lease is live — model that as a far-future expiry
        return LeaseState(str(rec.get("holder", "")),
                          int(entry.get("ModifyIndex", 0)),
                          time.time() + 3600.0)

    def acquire_or_renew(self, holder: str,
                         ttl: float) -> Optional[LeaseState]:
        if self._session is None:
            created = self._call(
                "PUT", "/v1/session/create",
                {"Name": f"veneur-lease-{self.key}",
                 "TTL": f"{max(10, int(ttl))}s",
                 "Behavior": "release", "LockDelay": "0s"})
            self._session = created["ID"]
        else:
            self._call("PUT", f"/v1/session/renew/{self._session}")
        ok = self._call(
            "PUT", f"/v1/kv/{self.key}?acquire={self._session}",
            {"holder": holder})
        if not ok:
            return None
        entry = self._kv_read() or {}
        return LeaseState(holder, int(entry.get("ModifyIndex", 0)),
                          time.time() + ttl)

    def release(self, holder: str) -> None:
        if self._session is None:
            return
        try:
            self._call("PUT",
                       f"/v1/kv/{self.key}?release={self._session}")
            self._call("PUT", f"/v1/session/destroy/{self._session}")
        except Exception:
            log.exception("consul lease release failed (session ttl "
                          "will expire it)")
        self._session = None


def lease_backend_from_url(url: str,
                           consul_url: str = "http://127.0.0.1:8500",
                           clock: Callable[[], float] = time.time):
    """``file:///path`` or ``consul://key`` -> a lease backend."""
    url = (url or "").strip()
    if url.startswith("file://"):
        return FileLease(url[len("file://"):], clock=clock)
    if url.startswith("consul://"):
        return ConsulLease(url[len("consul://"):], consul_url=consul_url)
    raise ValueError(
        f"lease_path must be file:///path or consul://key, got {url!r}")


class LeaseElector:
    """Drives one instance's side of the election: try to acquire (or
    renew) every ``renew_interval``, promote/demote through callbacks,
    keep-last-good across transient backend errors.

    The lease state machine:

    * FOLLOWER --acquired--> LEADER (``on_promote(epoch)`` fires; the
      fencing epoch stamps every replication stream this life sends)
    * LEADER --renewed--> LEADER (same epoch, extended expiry)
    * LEADER --backend error, ttl not yet lapsed--> LEADER
      (keep-last-good: the holder already paid for this ttl)
    * LEADER --lost to another holder / ttl truly lapsed--> FOLLOWER
      (``on_demote(reason)`` fires; replication must stop — anything
      sent anyway is fenced by the stale epoch)
    """

    def __init__(self, backend, holder: str, ttl: float = 15.0,
                 renew_interval: float = 0.0, on_promote=None,
                 on_demote=None, clock: Callable[[], float] = time.time):
        self.backend = backend
        self.holder = holder
        self.ttl = ttl
        self.renew_interval = renew_interval or ttl / 3.0
        self.on_promote = on_promote
        self.on_demote = on_demote
        self.clock = clock
        self.is_leader = False
        self.lease_epoch = 0
        self._held_until = 0.0
        self.acquires_total = 0
        self.demotions_total = 0
        self.renew_failures_total = 0
        self.polls_total = 0
        self.last_error = ""

    def poll(self) -> bool:
        """One acquisition/renewal attempt; returns leadership after."""
        self.polls_total += 1
        now = self.clock()
        try:
            state = self.backend.acquire_or_renew(self.holder, self.ttl)
        except Exception as e:
            self.renew_failures_total += 1
            self.last_error = str(e)
            # keep-last-good: a flaky backend never demotes mid-ttl
            if self.is_leader and now >= self._held_until:
                self._demote(f"lease lapsed during backend outage: {e}")
            return self.is_leader
        self.last_error = ""
        if state is None:
            if self.is_leader:
                self._demote("lease lost to another holder")
            return False
        self._held_until = state.expires_at
        self.lease_epoch = state.epoch
        if not self.is_leader:
            self.is_leader = True
            self.acquires_total += 1
            log.info("lease acquired by %s (fencing epoch %d)",
                     self.holder, state.epoch)
            if self.on_promote is not None:
                try:
                    self.on_promote(state.epoch)
                except Exception:
                    log.exception("on_promote callback failed")
        return True

    def _demote(self, reason: str) -> None:
        self.is_leader = False
        self.demotions_total += 1
        log.warning("lease demoted (%s): %s", self.holder, reason)
        if self.on_demote is not None:
            try:
                self.on_demote(reason)
            except Exception:
                log.exception("on_demote callback failed")

    def run(self, stop: threading.Event) -> None:
        """Background loop; one failing poll never kills the thread."""
        # first poll immediately: a cold standby should not wait one
        # renew interval to discover an already-free lease
        while True:
            try:
                self.poll()
            except Exception:
                log.exception("lease poll failed; retrying next interval")
            if stop.wait(self.renew_interval):
                return

    def release(self) -> None:
        """Clean-shutdown handback (skipped on crash, by definition)."""
        if not self.is_leader:
            return
        try:
            self.backend.release(self.holder)
        except Exception:
            log.exception("lease release failed; ttl expiry covers it")
        self.is_leader = False

    def snapshot(self) -> dict:
        return {
            "holder": self.holder,
            "is_leader": self.is_leader,
            "lease_epoch": self.lease_epoch,
            "held_until": self._held_until,
            "acquires_total": self.acquires_total,
            "demotions_total": self.demotions_total,
            "renew_failures_total": self.renew_failures_total,
            "polls_total": self.polls_total,
            "last_error": self.last_error,
        }


class LeaderDiscoverer:
    """The lease as a ``Discoverer``: resolution returns ``[holder]``
    of the current un-expired lease. Plugged into the proxy ring (or
    any ``RingWatcher`` consumer), the leader IS the membership — a
    takeover re-routes every fan-out within one refresh. No holder
    raises, which every refresh path treats as keep-last-good (the
    dead active stays targeted, its breaker eats the window, and the
    retry ladder re-delivers once the standby holds the lease)."""

    def __init__(self, backend, clock: Callable[[], float] = time.time):
        self.backend = backend
        self.clock = clock

    def get_destinations_for_service(self, service_name: str) -> List[str]:
        state = self.backend.read()
        if state is None or not state.holder \
                or state.expired(self.clock()):
            raise RuntimeError("no live lease holder")
        return [state.holder]
