"""Interval checkpointing and warm-restart recovery for the store.

Port of ``veneur_tpu/persist/checkpoint.py``. All sketch state of the
current interval lives only in process memory, so an OOM, a SIGKILL or a
failed device loses up to a whole interval. The :class:`Checkpointer`
bounds that loss at ``checkpoint_interval``:

* a background thread snapshots the store every ``checkpoint_interval``
  (``MetricStore.snapshot_state``: the store lock is held only for the
  host copies and the device copies; the fetch, serialization and the
  disk write run off-lock) and commits it atomically
  (``format.write_atomic``);
* a snapshot is committed only if no flush drained the store since it
  was taken (the ``flush_epoch`` guard), and a successful flush
  truncates the checkpoint, so recovered data never flushes twice;
* at startup a valid, fresh checkpoint is *merged* into the new store
  with import semantics (``MetricStore.restore_state``: the digests
  re-enter the centroid import path, K2 on its guard drains) and at once
  re-persisted from the merged store, so a crash loop never destroys
  on-disk state; truncated, corrupt, wrong-version or stale files are
  discarded (counted, logged), and no checkpoint can prevent startup.

Each flush reads the counts on the :class:`Checkpointer` into the
``veneur.checkpoint.*`` self-metrics (``flusher.py``
``_checkpoint_samples``: the last write's duration and bytes, the
checkpoint's age, and the restore, discard and write-error counts as
interval deltas), and ``Server.degradation()`` names a failing write.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

from veneur_tpu_torch.persist import format as ckpt_format
from veneur_tpu_torch.persist.format import CheckpointInvalid

log = logging.getLogger("veneur.persist")


class Checkpointer:
    """Owns one checkpoint path for one store. All disk operations
    (commit, truncate) serialize on ``_io_lock``; the store lock is
    never held across IO."""

    def __init__(self, store, path: str, interval_s: float,
                 max_age_s: float, hostname: str = "",
                 write_fn=None):
        self.store = store
        self.path = path
        self.interval_s = interval_s
        self.max_age_s = max_age_s
        self.hostname = hostname
        # injectable commit (soak disk-full faults ride
        # FaultInjector.wrap_write here); None = the atomic
        # temp+fsync+rename writer, resolved at call time
        self._write_fn = write_fn
        self._io_lock = threading.Lock()
        # counts, read by Server.degradation() and the tests
        self.writes = 0
        self.write_errors = 0
        self.discarded_writes = 0  # lost the flush-epoch race
        self.truncates = 0
        self.restore_total = 0
        self.discard_total = 0
        self.restored_series = 0
        self.last_write_duration_s = 0.0
        self.last_write_bytes = 0
        self.last_write_at: Optional[float] = None
        # the last commit's disk error, None while writes succeed —
        # rides the degraded /healthcheck/ready body (Server.degradation)
        self.last_error: Optional[str] = None
        self._created_at = time.time()
        self._restored = False

    # -- write path --------------------------------------------------------

    def write_once(self) -> bool:
        """Snapshot → serialize → atomic commit. False when the commit
        was discarded because a flush drained the snapshotted state
        first (persisting it would double-count on restore), or when
        the disk refused the write (ENOSPC, short write, read-only
        volume) — counted (``write_errors``) and named
        (``last_error``), NEVER raised: a full disk must degrade the
        instance, not crash the flush thread or any direct caller."""
        t0 = time.perf_counter()
        groups, epoch = self.store.snapshot_state()  # store lock inside
        blob = ckpt_format.serialize(
            groups, created_at=time.time(), interval=self.interval_s,
            meta={"hostname": self.hostname})
        # the IO lock's entire job is to serialize this write+fsync
        # against truncation; the flush path never waits behind it
        # (truncate(blocking=False)) and the store lock is not held
        with self._io_lock:
            if self.store.flush_epoch != epoch:
                self.discarded_writes += 1
                return False
            try:
                # the direct default call keeps the fsync-under-lock
                # hold statically visible to the lock-order pass
                if self._write_fn is None:
                    n = ckpt_format.write_atomic(self.path, blob)
                else:
                    n = self._write_fn(self.path, blob)
            except OSError as e:
                self.write_errors += 1
                self.last_error = str(e)
                # an ENOSPC mid-write can strand a partial .tmp; the
                # stale previous checkpoint (if any) stays — still the
                # best recovery anchor the disk will hold
                try:
                    os.unlink(self.path + ".tmp")
                except OSError:
                    pass
                log.warning("checkpoint write to %s failed (%s); "
                            "degraded, retrying next interval",
                            self.path, e)
                return False
            if self.store.flush_epoch != epoch:
                # a flush drained (and is emitting) the snapshotted
                # state while the bytes were in flight; the flush-path
                # truncate may have skipped past the held lock
                # (non-blocking), so remove the stale file ourselves
                self._unlink_locked()
                self.discarded_writes += 1
                return False
        self.last_write_duration_s = time.perf_counter() - t0
        self.last_write_bytes = n
        self.last_write_at = time.time()
        self.writes += 1
        # single writer thread; readers (degradation()) tolerate a
        # stale value for one interval
        self.last_error = None
        return True

    def run(self, stop: threading.Event):
        """Background loop: one checkpoint per ``checkpoint_interval``
        until ``stop`` is set. A failed write never kills the thread."""
        while not stop.wait(self.interval_s):
            try:
                self.write_once()
            except Exception:
                # single writer thread; monotonic introspection counter
                self.write_errors += 1
                log.exception("checkpoint write failed; retrying next "
                              "interval")

    def truncate(self, blocking: bool = True) -> bool:
        """Remove the checkpoint (and any scratch file): the state it
        captured has been flushed, restored, or proven unusable.

        blocking=False (the flush path) never waits behind an in-flight
        write — a multi-hundred-MB write+fsync holds the lock for
        seconds and must not eat the flush's egress budget. Skipping is
        safe: the writer re-checks the flush epoch after committing and
        removes its own file if a flush landed mid-write."""
        if not self._io_lock.acquire(blocking=blocking):
            return False
        try:
            removed = self._unlink_locked()
            if removed:
                self.truncates += 1
            return removed
        finally:
            self._io_lock.release()

    def _unlink_locked(self) -> bool:
        removed = False
        for p in (self.path, self.path + ".tmp"):
            try:
                os.unlink(p)
                removed = True
            except FileNotFoundError:
                pass
            except OSError as e:  # pragma: no cover - fs-dependent
                log.warning("could not remove checkpoint %s: %s", p, e)
        return removed

    def age_seconds(self) -> float:
        """Age of the last committed checkpoint — measured from startup
        before the first commit, so a checkpointer that can NEVER write
        (bad path, read-only disk) shows unbounded growth instead of a
        healthy-looking 0.0."""
        return max(0.0, time.time() - (self.last_write_at
                                       or self._created_at))

    # -- restore path ------------------------------------------------------

    def restore(self) -> int:
        """Merge a valid, fresh checkpoint into the store, then
        atomically RE-PERSIST the merged store over the consumed file —
        never delete it: a crash-looping process must not destroy
        on-disk state it has not yet re-written (the no-double-flush
        invariant rides on truncate-on-flush + the epoch guard, not on
        removing the file here, and re-merging a never-flushed
        checkpoint after another crash is correct). Unusable files are
        discarded (counted + logged + removed). NEVER raises: a
        malformed checkpoint must not prevent startup. Runs at most
        once per process. Returns the number of series merged."""
        if self._restored:
            return 0
        self._restored = True
        try:
            blob = ckpt_format.read_file(self.path)
            if blob is None:
                return 0
            groups, manifest = ckpt_format.deserialize(blob)
            age = time.time() - float(manifest.get("created_at", 0.0))
            if age > self.max_age_s:
                raise CheckpointInvalid(
                    "stale", f"{age:.1f}s old > {self.max_age_s:.1f}s")
        except CheckpointInvalid as e:
            self.discard_total += 1
            log.warning("discarding checkpoint %s (%s)", self.path, e)
            self.truncate()
            return 0
        except Exception:
            self.discard_total += 1
            log.exception("discarding unreadable checkpoint %s", self.path)
            self.truncate()
            return 0
        try:
            merged = self.store.restore_state(groups)
        except Exception:
            self.discard_total += 1
            log.exception("checkpoint %s failed to merge; discarding",
                          self.path)
            self.truncate()
            return 0
        self.restore_total += 1
        self.restored_series += merged
        try:
            # replaces the consumed file with a snapshot of the merged
            # store; if THIS fails the old checkpoint stays on disk,
            # which is still safe (it was never flushed)
            self.write_once()
        except Exception:
            log.exception("could not re-persist the restored state; "
                          "keeping the consumed checkpoint")
        log.info("recovered %d series from checkpoint %s (%.1fs old)",
                 merged, self.path, max(0.0, age))
        return merged
