"""The port's overlapped flush egress (``core/pipeline.py`` and the
store's plan of flush units), mirroring ``tests/test_pipeline.py`` where
it applies: pipelined-vs-sequential parity (and both against the JAX
store's rows), the ``SerializerLane``'s order and error propagation, the
``ChunkStream``'s bounded queues, streamed-chunk conservation through
sink faults (the once-per-interval repost and the requeue budget's
oldest-first drop), and a failed streamed forward part re-merged into
the live store.

The invariant under test: every emitted row is acked, parked for a
retry, or dropped and counted: acked + pending + dropped == rows.
"""

import json
import queue
import threading
import time
import zlib

import numpy as np
import pytest

from veneur_tpu.core import MetricStore as JStore
from veneur_tpu.samplers import HistogramAggregates as JAggs
from veneur_tpu.samplers import parse_metric as jparse
from veneur_tpu_torch import flusher as tflusher
from veneur_tpu_torch.core.pipeline import ChunkStream, SerializerLane
from veneur_tpu_torch.core.store import MetricStore
from veneur_tpu_torch.native import egress
from veneur_tpu_torch.resilience import RetryPolicy
from veneur_tpu_torch.samplers.intermetric import HistogramAggregates
from veneur_tpu_torch.samplers.parser import parse_metric
from veneur_tpu_torch.sinks.datadog import DatadogMetricSink

AGG_NAMES = ["min", "max", "count"]
AGGS = HistogramAggregates.from_names(AGG_NAMES)


@pytest.fixture
def native_egress():
    if not egress.available():
        pytest.skip("no native toolchain")
    return egress


def make_store(**kw):
    kw.setdefault("initial_capacity", 32)
    kw.setdefault("chunk", 128)
    return MetricStore(device="cpu", **kw)


def lines(n_hist=6, n_counters=4, n_sets=3, samples=5):
    """A mixed interval with exactly known counts."""
    out = [f"lat.{i}:{v * 10 + i}|ms".encode()
           for i in range(n_hist) for v in range(samples)]
    out += [f"hits.{i}:3|c".encode() for i in range(n_counters)]
    out += [f"uniq.{i}:u{i}|s".encode() for i in range(n_sets)]
    return out


def fill(store, **kw):
    for line in lines(**kw):
        store.process_metric(parse_metric(line))


def emission_map(final):
    if hasattr(final, "to_intermetrics"):
        final = final.to_intermetrics()
    return {(m.name, tuple(sorted(m.tags)), m.type.value): m.value
            for m in final}


@pytest.mark.parametrize("columnar", [False, True])
@pytest.mark.parametrize("is_local", [False, True])
def test_pipelined_matches_sequential_and_jax(native_egress, columnar,
                                             is_local):
    """The pipelined drain emits exactly what the sequential one does, in
    the same order, for every flush shape; both emit the JAX store's
    rows (names, tags, types; these values are exact on both)."""
    results = {}
    for depth in (0, 3):
        s = make_store(flush_pipeline_depth=depth)
        fill(s)
        final, _fwd = s.flush([0.5, 0.99], AGGS, 7, is_local=is_local,
                              forward=False, columnar=columnar)
        rows = final.to_intermetrics()
        results[depth] = [(m.name, m.tags, m.type, m.value) for m in rows]
    assert results[0] == results[3] and results[0]
    j = JStore(initial_capacity=32, chunk=128)
    for line in lines():
        j.process_metric(jparse(line))
    want, _, _ = j.flush([0.5, 0.99], JAggs.from_names(AGG_NAMES),
                         is_local=is_local, now=7, forward=False)
    assert {(n, tuple(sorted(t)), ty.value): v
            for n, t, ty, v in results[3]} == emission_map(want)


def test_forwarding_parity():
    """A forwarding local's ForwardableState is identical either way."""
    out = {}
    for depth in (0, 2):
        s = make_store(flush_pipeline_depth=depth)
        fill(s)
        s.process_metric(parse_metric(b"g:1|c|#veneurglobalonly"))
        _final, fwd = s.flush([], AGGS, 7, is_local=True, forward=True)
        fwd.materialize_digests()
        out[depth] = (sorted(fwd.counters),
                      sorted((n, tuple(t), float(w.sum()))
                             for n, t, _m, w, _mn, _mx in fwd.timers),
                      sorted(n for n, _t, _r, _p in fwd.sets))
    assert out[0] == out[2]
    assert out[0][1], "vacuous: no forwarded digests"


def test_serializer_lane_order_and_errors():
    lane = SerializerLane(2)
    out = []
    for i in range(5):
        lane.submit(f"u{i}", out.append, i)
    lane.close()
    assert out == [0, 1, 2, 3, 4]

    lane = SerializerLane(1)

    def boom(_):
        raise ValueError("emit failed")

    lane.submit("bad", boom, None)
    for i in range(4):  # more than the queue holds: no deadlock
        lane.submit("after", out.append, 99)
    with pytest.raises(ValueError, match="emit failed"):
        lane.close()
    # the lane drained but skipped the work after the error
    assert 99 not in out


def test_store_flush_reraises_an_emit_error(native_egress):
    """An emission that fails on the serializer lane fails the flush."""
    s = make_store(flush_pipeline_depth=1)
    fill(s)

    def broken(*args, **kwargs):
        raise RuntimeError("emission broke")

    s._emit_set_result = broken
    with pytest.raises(RuntimeError, match="emission broke"):
        s.flush([0.5], AGGS, 7, columnar=True)


class _SlowSink:
    """A chunk sink that blocks until released and may raise."""

    name = "slow"

    def __init__(self, raise_on=()):
        self.release = threading.Event()
        self.seen = []
        self.raise_on = set(raise_on)

    def flush_chunk(self, chunk):
        self.release.wait(10)
        self.seen.append(chunk.seq)
        if chunk.seq in self.raise_on:
            raise OSError("sink down")


def test_chunk_stream_queues_are_bounded():
    """A slow sink backpressures ``emit`` at ``depth`` queued chunks (plus
    the one in hand); a sink that raises does not stop the stream."""
    sink = _SlowSink(raise_on={1})
    stream = ChunkStream([sink], 5, depth=2)
    done = queue.Queue()

    def producer():
        for i in range(6):
            stream.emit(f"g{i}", [object()], 1)
            done.put(i)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    # one chunk in the worker's hand, two queued, the fourth emit blocks
    deadline = time.monotonic() + 10
    while done.qsize() < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    assert done.qsize() == 3
    sink.release.set()
    t.join(10)
    assert not t.is_alive()
    stream.close()
    assert sink.seen == list(range(6))
    assert (stream.chunks, stream.rows) == (6, 6)


class _FaultyPost:
    """Datadog post stub: 500 on the listed calls, 202 otherwise; counts
    the series of every acked body."""

    def __init__(self, fail_calls=()):
        self.calls = 0
        self.fail_calls = set(fail_calls)
        self.acked_rows = 0

    def __call__(self, url, payload, compress=True, precompressed=False):
        self.calls += 1
        if self.calls in self.fail_calls:
            return 500
        if precompressed:
            body = json.loads(zlib.decompress(payload))
            self.acked_rows += len(body["series"])
        return 202


def make_dd_sink(post, **kw):
    kw.setdefault("interval", 10)
    kw.setdefault("flush_max_per_body", 4)
    return DatadogMetricSink(hostname="h0", tags=[], dd_hostname="http://dd",
                             api_key="k", post=post,
                             retry_policy=RetryPolicy(max_attempts=1), **kw)


def streamed_flush(store, sink, now):
    fill(store)
    stream = ChunkStream([sink], now, depth=2)
    store.flush([0.5], AGGS, now, columnar=True, stream=stream)
    stream.close()
    return stream


def test_clean_stream_acks_every_row(native_egress):
    post = _FaultyPost()
    sink = make_dd_sink(post)
    stream = streamed_flush(make_store(), sink, 7)
    assert stream.chunks >= 3  # scalars, timers, sets
    assert sink.chunk_rows_acked == stream.rows == post.acked_rows
    assert sink.chunk_rows_pending() == 0 and sink.chunks_flushed == (
        stream.chunks)


def test_5xx_chunk_requeues_once_with_exact_conservation(native_egress):
    post = _FaultyPost(fail_calls={2})  # the second body POST fails
    sink = make_dd_sink(post)
    s = make_store()
    first = streamed_flush(s, sink, 7)
    pending = sink.chunk_rows_pending()
    assert pending > 0 and sink.chunk_rows_dropped == 0
    assert sink.chunk_rows_acked + pending == first.rows
    # next interval: the parked bodies get their retry once, first
    second = streamed_flush(s, sink, 8)
    assert sink.chunks_requeued_total == 1
    assert sink.chunk_rows_pending() == 0
    assert sink.chunk_rows_acked == first.rows + second.rows
    # a direct repost under the same cycle is a no-op
    calls = post.calls
    sink.repost_requeued(second.cycle)
    assert post.calls == calls


def test_requeued_body_failing_again_reparks_in_budget(native_egress):
    post = _FaultyPost(fail_calls=set(range(1, 100)))  # always 500
    sink = make_dd_sink(post)
    s = make_store()
    first = streamed_flush(s, sink, 7)
    assert sink.chunk_rows_pending() == first.rows
    second = streamed_flush(s, sink, 8)
    assert sink.chunk_rows_dropped == sink.chunk_rows_acked == 0
    assert sink.chunk_rows_pending() == first.rows + second.rows
    assert sink.chunk_requeue_bytes() <= sink.requeue_max_bytes


def test_requeue_budget_drops_oldest_counted(native_egress):
    """Past the bytes budget the OLDEST parked bodies drop, counted, and
    acked + pending + dropped == rows at every interval; healed, one
    repost drains the park."""

    class _BlackHole:
        healed = False
        acked_rows = 0

        def __call__(self, url, payload, compress=True, precompressed=False):
            if not self.healed:
                raise OSError("connection refused")
            self.acked_rows += len(json.loads(zlib.decompress(payload))[
                "series"])
            return 202

    post = _BlackHole()
    sink = make_dd_sink(post)
    s = make_store()
    offered, oldest = 0, None
    for i in range(6):
        stream = streamed_flush(s, sink, 100 + i)
        offered += stream.rows
        if i == 0:
            oldest = sink._requeued[0][0]
            sink.requeue_max_bytes = sink.chunk_requeue_bytes() * 2
        assert sink.chunk_requeue_bytes() <= sink.requeue_max_bytes
        assert (sink.chunk_rows_acked + sink.chunk_rows_pending()
                + sink.chunk_rows_dropped) == offered, i
    assert sink.chunk_rows_dropped > 0
    assert all(body is not oldest for body, _ in sink._requeued)
    post.healed = True
    stream = streamed_flush(s, sink, 200)
    offered += stream.rows
    assert sink.chunk_rows_pending() == 0
    assert sink.chunk_rows_acked + sink.chunk_rows_dropped == offered
    assert post.acked_rows == sink.chunk_rows_acked


def test_requeue_accounting_under_thread_contention():
    """Chunk bodies posted from more threads than cores, a seeded third
    failing, past a budget that evicts: every row is acked, parked or
    dropped, counted once (acked + pending + dropped == rows)."""
    import random
    import sys

    rng = random.Random(5)
    fails = [rng.random() < 0.3 for _ in range(16 * 40)]
    calls = iter(range(len(fails)))

    def post(url, payload, compress=True, precompressed=False):
        return 500 if fails[next(calls)] else 202

    sink = make_dd_sink(post, requeue_max_bytes=40 * 64)
    rows = 16 * 40 * 3
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            sink._post_chunk_body(b"x" * 64, 3) for _ in range(40)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert sink.chunk_rows_dropped > 0
    assert sink.chunk_requeue_bytes() <= sink.requeue_max_bytes
    assert (sink.chunk_rows_acked + sink.chunk_rows_pending()
            + sink.chunk_rows_dropped) == rows
    assert sink.chunk_rows_acked == 3 * fails.count(False)


def test_failed_forward_part_reemits_next_flush(native_egress):
    """A streamed digest part whose POST fails re-merges into the live
    store and forwards with the next flush, every sample once."""
    s = make_store()
    fill(s, n_counters=0, n_sets=0)
    stream = ChunkStream(
        [], 7, depth=2, forward_fn=lambda attr, part: False,
        forward_requeue=lambda attr, part:
            tflusher._requeue_forward_part(s, attr, part))
    _final, fwd = s.flush([], AGGS, 7, is_local=True, forward=True,
                          columnar=True, stream=stream)
    stream.close()
    assert stream.forward_parts == 1 and stream.forward_requeued_rows == 6
    assert fwd.timers_columnar is None  # it never rode the batch state
    _f2, fwd2 = s.flush([], AGGS, 8, is_local=True, forward=True,
                        columnar=True)
    fwd2.materialize_digests()
    assert {n for n, *_ in fwd2.timers} == {f"lat.{i}" for i in range(6)}
    assert sum(float(np.sum(w)) for _n, _t, _m, w, _a, _b
               in fwd2.timers) == 6 * 5
