"""The nonblocking trace client: a bounded span pump with backpressure.

Port of ``veneur_tpu/trace/client.py`` (the reference's
``trace/client.go``):

- ``Client`` owns a bounded queue of spans and N backend worker threads
  draining it (client.go:56-117, DefaultCapacity 64 / DefaultParallelism
  8, :425-430).
- ``record`` never blocks: a full queue returns ``WouldBlockError`` and
  bumps ``failed_records`` (client.go:459-479).
- ``flush`` asks every flushable backend to flush its buffer and
  aggregates errors (client.go:489-543).
- ``ChannelClient`` delivers spans straight into an in-process queue —
  how veneur feeds its own SpanChan (client.go:369-390, server.go:196-202);
  ``neutralize_client`` makes every operation fail fast for tests
  (client.go:404-412).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional

from veneur_tpu_torch.protocol import addr as vaddr
from veneur_tpu_torch.trace.backend import (BackendParams, PacketBackend,
                                      StreamBackend)

DEFAULT_CAPACITY = 64
DEFAULT_PARALLELISM = 8
DEFAULT_VENEUR_ADDRESS = "udp://127.0.0.1:8128"


class NoClientError(Exception):
    """client is not initialized (client.go:441)."""


class WouldBlockError(Exception):
    """sending span would block (client.go:445)."""


class FlushError(Exception):
    """One or more backends failed to flush (client.go:498-506)."""

    def __init__(self, errors: List[BaseException]):
        super().__init__(f"Errors encountered flushing backends: {errors}")
        self.errors = errors


class Client:
    """A span pump over networked backends (client.go:298-343)."""

    def __init__(self, address: Optional[str] = None,
                 capacity: int = DEFAULT_CAPACITY,
                 parallelism: int = DEFAULT_PARALLELISM,
                 backoff: float = 0.0, max_backoff: float = 0.0,
                 connect_timeout: float = 0.0, buffered: bool = False,
                 buffer_size: int = 0,
                 backends: Optional[List] = None,
                 span_queue: Optional["queue.Queue"] = None):
        self._records: Optional["queue.Queue"] = None
        self._spans: Optional["queue.Queue"] = span_queue
        self._backends: List = []
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.failed_flushes = 0
        self.successful_flushes = 0
        self.failed_records = 0
        self.successful_records = 0

        if span_queue is not None:
            return  # channel client: no backends, no workers

        if backends is None:
            if address is None:
                address = DEFAULT_VENEUR_ADDRESS
            resolved = vaddr.resolve_addr(address)
            params = BackendParams(
                address, backoff=backoff, max_backoff=max_backoff,
                connect_timeout=connect_timeout,
                buffer_size=buffer_size if (buffered or buffer_size) else 0)
            if resolved.family == "udp":
                backends = [PacketBackend(params)
                            for _ in range(parallelism)]
            else:
                backends = [StreamBackend(params)
                            for _ in range(parallelism)]
        self._backends = backends
        self._records = queue.Queue(maxsize=max(1, capacity))
        for backend in self._backends:
            t = threading.Thread(target=self._run_backend, args=(backend,),
                                 name="trace-client", daemon=True)
            t.start()
            self._threads.append(t)

    def _run_backend(self, backend) -> None:
        """Worker loop (client.go:96-117)."""
        while not self._stop.is_set():
            try:
                op = self._records.get(timeout=0.2)
            except queue.Empty:
                continue
            span, done, flush_to = op
            try:
                if flush_to is not None:
                    flush_sync = getattr(backend, "flush_sync", None)
                    if flush_sync is not None:
                        flush_sync()
                    flush_to.put(None)
                else:
                    backend.send_sync(span)
                    if done is not None:
                        done.put(None)
            except Exception as e:
                target = flush_to if flush_to is not None else done
                if target is not None:
                    target.put(e)

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)
        for b in self._backends:
            try:
                b.close()
            except OSError:
                pass


def record(cl: Optional[Client], span, done: Optional["queue.Queue"] = None):
    """Nonblocking submit (client.go:459-479). Raises NoClientError /
    WouldBlockError."""
    if cl is None:
        raise NoClientError("client is not initialized")
    if cl._spans is not None:
        try:
            cl._spans.put_nowait(span)
        except queue.Full:
            with cl._lock:
                cl.failed_records += 1
            raise WouldBlockError("sending span would block")
        with cl._lock:
            cl.successful_records += 1
        if done is not None:
            done.put(None)
        return
    if cl._records is None:
        with cl._lock:
            cl.failed_records += 1
        raise WouldBlockError("sending span would block")
    try:
        cl._records.put_nowait((span, done, None))
    except queue.Full:
        with cl._lock:
            cl.failed_records += 1
        raise WouldBlockError("sending span would block")
    with cl._lock:
        cl.successful_records += 1


def flush(cl: Optional[Client], timeout: float = 10.0) -> None:
    """Synchronous flush of all flushable backends (client.go:489-496)."""
    if cl is None:
        raise NoClientError("client is not initialized")
    errors: List[BaseException] = []
    if cl._records is not None:
        for backend in cl._backends:
            if getattr(backend, "flush_sync", None) is None:
                continue
            ch: "queue.Queue" = queue.Queue(1)
            try:
                cl._records.put_nowait((None, None, ch))
            except queue.Full:
                errors.append(WouldBlockError("sending span would block"))
                continue
            try:
                err = ch.get(timeout=timeout)
                if err is not None:
                    errors.append(err)
            except queue.Empty:
                errors.append(TimeoutError("flush timed out"))
    if errors:
        with cl._lock:
            cl.failed_flushes += 1
        raise FlushError(errors)
    with cl._lock:
        cl.successful_flushes += 1


def new_channel_client(span_queue: "queue.Queue", **kw) -> Client:
    """A client delivering into an in-process queue (client.go:369-390)."""
    return Client(span_queue=span_queue, **kw)


def new_backend_client(backend, capacity: int = 1, **kw) -> Client:
    """A client over one injected backend (client.go:346-366)."""
    return Client(backends=[backend], capacity=capacity, **kw)


def neutralize_client(cl: Client) -> None:
    """Dash all hope of recording or flushing (client.go:404-412)."""
    cl.close()
    cl._records = None
    cl._spans = None
    cl._backends = []


def send_client_statistics(cl: Client, report: Callable[[str, float], None],
                           ) -> None:
    """Report + reset backpressure counters (client.go:446-452)."""
    with cl._lock:
        stats = (("trace_client.flushes_failed_total", cl.failed_flushes),
                 ("trace_client.flushes_succeeded_total",
                  cl.successful_flushes),
                 ("trace_client.records_failed_total", cl.failed_records),
                 ("trace_client.records_succeeded_total",
                  cl.successful_records))
        cl.failed_flushes = cl.successful_flushes = 0
        cl.failed_records = cl.successful_records = 0
    for name, value in stats:
        report(name, float(value))
