"""Crash reporting and profiling hooks (the reference's ops surface).

Port of ``veneur_tpu/crash.py`` (host Python, copied). The reference
wraps every goroutine in ``defer ConsumePanic(...)`` (sentry.go:17-52):
on a panic it reports to Sentry, blocks until the event is sent, then
re-panics so the process dies loudly. Here:

- ``guarded(fn, reporter)`` wraps a thread target: report, then rethrow.
- ``install_excepthook(reporter)`` catches uncaught exceptions on any
  other thread through ``threading.excepthook``.
- ``SentryReporter`` is a minimal stdlib DSN client (no sentry-sdk): a
  best-effort POST of a Sentry v7 event, a bounded wait, never raises.

Profiling (server.go:1039-1047 uses pkg/profile): with
``enable_profiling`` a Server runs cProfile from start to shutdown and
writes the merged pstats to ``veneur-profile.pstats``.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import traceback
import urllib.request
import uuid
from datetime import datetime, timezone
from typing import Optional
from urllib.parse import urlparse

log = logging.getLogger("veneur.crash")


class SentryReporter:
    """Minimal Sentry store-API client for crash events."""

    def __init__(self, dsn: str, timeout: float = 2.0):
        u = urlparse(dsn)
        if not (u.scheme and u.username and u.hostname and u.path):
            raise ValueError(f"malformed sentry DSN {dsn!r}")
        prefix, _, project = u.path.rpartition("/")
        port = f":{u.port}" if u.port else ""
        self.endpoint = (f"{u.scheme}://{u.hostname}{port}{prefix}"
                         f"/api/{project}/store/")
        self.key = u.username
        self.timeout = timeout
        self.hostname = socket.gethostname()

    def report(self, exc: BaseException, thread_name: str = "") -> bool:
        """POST one fatal event; returns False on any delivery failure
        (reporting must never take the server down with it)."""
        try:
            tb = exc.__traceback__
            frames = [{
                "filename": f.filename,
                "function": f.name,
                "lineno": f.lineno,
            } for f in traceback.extract_tb(tb)]
            event = {
                "event_id": uuid.uuid4().hex,
                "timestamp": datetime.now(timezone.utc).isoformat(),
                "platform": "python",
                "level": "fatal",
                "server_name": self.hostname,
                "tags": {"thread": thread_name},
                "exception": {"values": [{
                    "type": type(exc).__name__,
                    "value": str(exc),
                    "stacktrace": {"frames": frames},
                }]},
            }
            req = urllib.request.Request(
                self.endpoint, data=json.dumps(event).encode(),
                headers={
                    "Content-Type": "application/json",
                    "X-Sentry-Auth": (
                        "Sentry sentry_version=7, "
                        f"sentry_key={self.key}, "
                        "sentry_client=veneur-tpu-torch/1"),
                })
            # block until sent, like ConsumePanic's Wait (sentry.go:30-38)
            urllib.request.urlopen(req, timeout=self.timeout).read()
            return True
        except Exception as e:  # pragma: no cover - network dependent
            log.warning("sentry report failed: %s", e)
            return False


def guarded(fn, reporter: Optional[SentryReporter] = None):
    """Wrap a thread target with report-then-rethrow (ConsumePanic)."""
    def run(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            name = threading.current_thread().name
            log.error("panic in thread %s: %s", name, e, exc_info=True)
            if reporter is not None:
                reporter.report(e, name)
            e._veneur_reported = True  # excepthook must not double-report
            raise
    return run


_hook_installed = False
_current_reporter: Optional[SentryReporter] = None


def install_excepthook(reporter: Optional[SentryReporter]):
    """Route uncaught thread exceptions through the most recently
    installed reporter before the default hook runs (covers threads not
    spawned via guarded()). Safe to call repeatedly; later calls swap
    the reporter."""
    global _hook_installed, _current_reporter
    _current_reporter = reporter
    if _hook_installed:
        return
    _hook_installed = True
    prev = threading.excepthook

    def hook(args):
        exc = args.exc_value
        already = getattr(exc, "_veneur_reported", False)
        if not already:
            log.error("uncaught exception in thread %s",
                      args.thread.name if args.thread else "?",
                      exc_info=(args.exc_type, exc, args.exc_traceback))
            if _current_reporter is not None and exc is not None:
                _current_reporter.report(
                    exc, args.thread.name if args.thread else "")
        prev(args)

    threading.excepthook = hook
