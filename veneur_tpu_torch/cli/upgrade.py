"""Zero-downtime binary upgrade for the port's CLI binaries (SIGUSR2).

Port of ``veneur_tpu/cli/upgrade.py``. The reference hands its listening
sockets to a replacement through einhorn and ``goji/graceful``
(server.go:1048-1076): a plain ``bind()`` by the replacement would fail
while the old process holds the port. Every listener of the port binds
with SO_REUSEPORT (``networking.py``, the ingest lanes, the native
readers, ``httpserv.ReuseportHTTPServer``), so two generations serve the
same ports side by side and the handoff is process choreography only:

  1. SIGUSR2: spawn a fresh process with the same command line (the
     recorded startup argv, ``--device`` included, so the replacement
     runs on the same device).
  2. The replacement binds the same ports beside the old process and
     finishes its startup: the torch import, the CUDA context, and
     loading the kernel library (the hashed file under ``build/``) and
     the native ingest and egress libraries. Readiness is explicit,
     not a timer.
  3. Once ``Server.start`` returns with every listener bound, the
     replacement writes one byte to an inherited pipe
     (``VENEUR_READY_FD``).
  4. The old process drains: a graceful shutdown with a final flush, as
     on SIGTERM, but only after the replacement is ready, so the ports
     are never unserved.

If the replacement dies or is not ready in time, the old process kills
it (if needed) and keeps serving: an upgrade can fail, service cannot.
"""

from __future__ import annotations

import logging
import os
import select
import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence

log = logging.getLogger("veneur.upgrade")

READY_ENV = "VENEUR_READY_FD"

# startup includes the torch import, the CUDA context and loading (on a
# fresh checkout, building) the kernel and native libraries
DEFAULT_READY_TIMEOUT = 300.0

# Upgrade/shutdown coordination. A SIGTERM/SIGINT can land at any point
# during an upgrade — including between "replacement is ready" and
# "hand off by setting done" — and in every such interleaving the
# operator's intent is that the *service* stops, so a replacement whose
# handoff never completed must not outlive this generation. The state
# below makes the handoff decision atomic versus request_shutdown(),
# and records any not-yet-handed-off replacement so the CLI mains can
# reap it on the way out.
_state_lock = threading.Lock()
_stop_requested = False
_pending_replacement: Optional["subprocess.Popen"] = None
_upgrade_active = False
_startup_argv: Optional[List[str]] = None


def _reset_state_for_tests() -> None:
    global _stop_requested, _pending_replacement, _startup_argv
    global _upgrade_active
    with _state_lock:
        _stop_requested = False
        _pending_replacement = None
        _upgrade_active = False
        _startup_argv = None


def record_startup_argv(module: str,
                        args: Optional[Sequence[str]] = None) -> None:
    """Capture the command line this generation was launched with so an
    upgrade re-execs exactly what the operator ran — flags included —
    rather than a reconstruction that silently drops any option added
    after ``-f``. Call from the CLI main before serving; also resets
    the shutdown/handoff state for this (new) generation, which
    matters when several mains run in one process (tests)."""
    global _startup_argv, _stop_requested, _pending_replacement
    global _upgrade_active
    if args is None:
        args = sys.argv[1:]
    with _state_lock:
        _startup_argv = [sys.executable, "-m", module, *args]
        _stop_requested = False
        _pending_replacement = None
        _upgrade_active = False


def request_shutdown(done: "threading.Event") -> None:
    """The CLI signal handlers' shutdown path: marks the stop as
    operator-requested *before* setting ``done`` so an in-flight
    upgrade handoff cannot complete afterwards and leave a replacement
    serving a service the operator asked to stop.

    Deliberately lock-free: this runs inside a signal handler on the
    main thread, and the main thread itself takes ``_state_lock`` in
    ``reap_unfinished_replacement`` — a second SIGTERM landing there
    would deadlock on a non-reentrant lock. The bare bool store is
    GIL-atomic; the handoff reads it under ``_state_lock`` (and
    re-checks after its ``done.set()``), which provides the ordering."""
    global _stop_requested
    _stop_requested = True
    done.set()


def reap_unfinished_replacement(logger: logging.Logger = log) -> None:
    """Called by the CLI mains after ``done.wait()`` returns: if an
    upgrade replacement was spawned but its drain handoff never
    completed (shutdown raced the upgrade, or the main loop exited
    while the replacement was still starting), kill it — the operator
    asked the service to stop.

    An upgrade thread may be inside the popen→record gap (forking a
    large-RSS process takes real time), in which case the child exists
    but is not yet visible here. ``_stop_requested`` is already set,
    so that thread will abort-and-kill its child at the record point
    moments later; wait briefly for the upgrade machinery to either
    record a pending child or go idle before concluding there is
    nothing to reap."""
    global _pending_replacement
    deadline = time.monotonic() + 15.0
    while True:
        with _state_lock:
            child = _pending_replacement
            _pending_replacement = None
            still_spawning = _upgrade_active and child is None
        if child is not None or not still_spawning:
            break
        if time.monotonic() >= deadline:
            logger.warning("shutdown: an upgrade is still in flight with "
                           "no recorded replacement after 15s; exiting "
                           "anyway")
            break
        time.sleep(0.05)
    if child is not None:
        logger.warning("shutdown requested during an upgrade; stopping "
                       "replacement pid %d", child.pid)
        _reap(child)


def notify_ready() -> bool:
    """Child side of the handshake: if this process was spawned as an
    upgrade replacement, tell the parent we are serving. Returns True
    if a notification was sent. Call after the server has started
    (sockets bound, readers running)."""
    raw = os.environ.pop(READY_ENV, None)
    if raw is None:
        return False
    try:
        fd = int(raw)
    except ValueError:
        log.error("ignoring malformed %s=%r", READY_ENV, raw)
        return False
    try:
        os.write(fd, b"1")
        os.close(fd)
        return True
    except OSError as e:
        # Parent died between spawn and our startup: we're simply the
        # new generation now.
        log.warning("could not notify upgrade parent: %s", e)
        return False


def replacement_argv(config_path: str, module: str) -> List[str]:
    """The command line for the replacement generation — the einhorn
    analogue of re-running the upgraded binary. Prefers the startup
    argv recorded by the CLI main (exactly what the operator launched,
    any future flags included); falls back to reconstructing
    ``python -m module -f config`` when none was recorded."""
    with _state_lock:
        if _startup_argv is not None:
            return list(_startup_argv)
    return [sys.executable, "-m", module, "-f", config_path]


def spawn_replacement(argv: Sequence[str],
                      ready_timeout: float = DEFAULT_READY_TIMEOUT,
                      popen=subprocess.Popen,
                      ) -> Optional["subprocess.Popen"]:
    """Parent side: spawn ``argv`` with an inherited readiness pipe and
    wait for the one-byte handshake.

    Returns the ready child process, or None if the child exited or
    failed to become ready within ``ready_timeout`` (in which case it
    has been killed and reaped, and the caller should keep serving).
    ``popen`` is injectable for tests.
    """
    global _pending_replacement
    rfd, wfd = os.pipe()
    os.set_inheritable(wfd, True)
    env = dict(os.environ)
    env[READY_ENV] = str(wfd)
    try:
        child = popen(list(argv), env=env, pass_fds=(wfd,))
    except Exception:
        log.exception("upgrade: failed to spawn replacement %r", argv)
        os.close(rfd)
        os.close(wfd)
        return None
    os.close(wfd)  # child holds the only write end now

    # Record the not-yet-handed-off child so a shutdown racing this
    # (possibly minutes-long) readiness wait can reap it on the way
    # out; if shutdown was already requested, don't upgrade at all.
    with _state_lock:
        if _stop_requested:
            abort_now = True
        else:
            abort_now = False
            _pending_replacement = child
    if abort_now:
        log.warning("upgrade: shutdown already requested; stopping "
                    "replacement pid %d", child.pid)
        _reap(child)
        os.close(rfd)
        return None

    try:
        deadline = time.monotonic() + ready_timeout
        while True:
            remain = deadline - time.monotonic()
            if remain <= 0:
                log.error("upgrade: replacement pid %d not ready after "
                          "%.0fs; killing it and continuing to serve",
                          child.pid, ready_timeout)
                _clear_pending(child)
                _reap(child)
                return None
            readable, _, _ = select.select([rfd], [], [], min(remain, 0.5))
            if readable:
                if os.read(rfd, 1):
                    log.info("upgrade: replacement pid %d is serving",
                             child.pid)
                    return child
                # EOF without a byte: the write end is gone, so the
                # child can never signal readiness — treat as a failed
                # upgrade whether it is still running or already dead.
                rc = child.poll()
                if rc is None:
                    log.error("upgrade: replacement pid %d closed the "
                              "readiness pipe without becoming ready; "
                              "killing it and continuing to serve",
                              child.pid)
                    _clear_pending(child)
                    _reap(child)
                else:
                    log.error("upgrade: replacement pid %d exited with "
                              "%d before becoming ready; continuing to "
                              "serve", child.pid, rc)
                    _clear_pending(child)
                return None
            rc = child.poll()
            if rc is not None:
                log.error("upgrade: replacement pid %d exited with %d "
                          "before becoming ready; continuing to serve",
                          child.pid, rc)
                _clear_pending(child)
                return None
    finally:
        os.close(rfd)


def make_sigusr2_handler(config_path: str, module: str,
                         done: "threading.Event",
                         logger: logging.Logger = log):
    """Build the SIGUSR2 handler for a CLI binary: spawn a replacement
    generation of ``module`` and set ``done`` (→ graceful drain) only
    once it is serving. Overlapping SIGUSR2s coalesce, and a signal
    arriving while this generation is already draining is ignored —
    otherwise it would spawn a second replacement that co-serves the
    ports forever after the first one's parent exits."""
    upgrading = threading.Lock()

    def do_upgrade():
        global _upgrade_active
        if not upgrading.acquire(blocking=False):
            logger.info("SIGUSR2: an upgrade is already in progress")
            return
        with _state_lock:
            _upgrade_active = True
        try:
            if done.is_set():
                logger.info("SIGUSR2: already draining; ignoring")
                return
            argv = replacement_argv(config_path, module)
            child = spawn_replacement(argv)
            if child is None:
                return
            # Atomic handoff decision: either the replacement becomes
            # the new generation (done set here, pending cleared) or a
            # shutdown request won the race and the replacement must
            # not outlive this generation. request_shutdown() takes
            # the same lock, so no SIGTERM can slip between this check
            # and done.set().
            global _pending_replacement
            with _state_lock:
                if done.is_set() or _stop_requested:
                    handed_off = False
                else:
                    _pending_replacement = None
                    done.set()
                    # request_shutdown is lock-free (signal-handler
                    # safe), so a stop can land between the check
                    # above and done.set(); re-reading here shrinks
                    # the undetectable window to post-handoff signals
                    handed_off = not _stop_requested
            if not handed_off:
                # a shutdown signal arrived while the replacement was
                # starting: the operator asked for the service to STOP,
                # so the replacement must not outlive this generation
                logger.warning("shutdown requested during the upgrade; "
                               "stopping replacement pid %d", child.pid)
                _clear_pending(child)
                _reap(child)
                return
            logger.info("SIGUSR2: replacement serving; draining "
                        "this generation")
        finally:
            with _state_lock:
                _upgrade_active = False
            upgrading.release()

    def handler(signum, frame):
        global _upgrade_active
        logger.info("Received SIGUSR2, starting zero-downtime upgrade")
        # mark the machinery active before the thread even exists
        # (lock-free: this is a signal handler) so a shutdown racing
        # the thread's first scheduling still waits for it in
        # reap_unfinished_replacement rather than concluding idle
        _upgrade_active = True
        threading.Thread(target=do_upgrade, name="binary-upgrade",
                         daemon=True).start()

    return handler


def _clear_pending(child: "subprocess.Popen") -> None:
    global _pending_replacement
    with _state_lock:
        if _pending_replacement is child:
            _pending_replacement = None


def _reap(child: "subprocess.Popen") -> None:
    child.kill()
    try:
        child.wait(timeout=10)
    except Exception:
        log.warning("upgrade: could not reap pid %d", child.pid)
