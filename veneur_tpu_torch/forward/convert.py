"""ForwardableState <-> the JSON wire of ``POST /import`` and the
MetricList wire of the framed-TCP lane.

Port of ``veneur_tpu/forward/convert.py``. Two JSON body formats, both
accepted on import:

* our structured entries: counters and gauges carry numbers in
  ``value``, digests a ``digest`` object with ``[mean, weight]``
  centroid pairs, sets an ``hll`` field holding base64 of
  :func:`encode_hll`;
* the reference's ``JSONMetric`` entries (samplers.go:102-108): every
  ``value`` is the base64 of the sampler's own bytes — LE int64
  counters, LE float64 gauges, axiomhq sets, gob t-digest streams — so a
  Go local can POST to a port global and a port local can forward into a
  Go global (``forward_reference_compatible``).

Our format also carries one ``topk_sketch`` entry, the heavy-hitter
count-min table (base64 float32) and each series' top-k candidates; the
reference's format never does (a Go global would count an unknown
type).

The MetricList of the framed-TCP lane (``forward/native_transport.py``)
is written by :func:`metric_list_from_state` through the protobuf-free
codec ``protocol/mlist.py``; its digest groups, when they ride as
planes, are the C++ encoders' (``native/egress.py``), and the global
decodes whole frames in C++ (``MetricStore.import_columnar``). The
protobuf import path of the JAX package (``apply_metric_list``) is not
ported: the port has no fallback behind the C++ decoder.
"""

from __future__ import annotations

import base64
import logging
import struct
from typing import Dict, List

import numpy as np

from veneur_tpu_torch.ops import axiomhq
from veneur_tpu_torch.protocol import mlist
from veneur_tpu_torch.protocol.gob import (decode_reference_digest,
                                           encode_reference_digest)
from veneur_tpu_torch.samplers.parser import MetricKey

log = logging.getLogger("veneur.forward.convert")

_HLL_MAGIC = b"VH"
_HLL_VERSION = 1

_PB_TYPE = {"counter": mlist.COUNTER, "gauge": mlist.GAUGE,
            "histogram": mlist.HISTOGRAM, "timer": mlist.TIMER,
            "set": mlist.SET}
_TYPE_PB = {v: k for k, v in _PB_TYPE.items()}


def type_name(pb_type: int) -> str:
    """metricpb.Type enum value -> the lowercase type string of a
    MetricKey ("counter", "timer", ...)."""
    name = _TYPE_PB.get(pb_type)
    if name is None:
        raise ValueError(f"unknown metric type {pb_type}")
    return name


def encode_hll(registers: np.ndarray, precision: int,
               reference_compat: bool = False) -> bytes:
    """Serialize dense HLL registers.

    Native layout: magic ``VH``, version, precision, raw registers (one
    byte each, lossless). ``reference_compat=True`` emits the axiomhq
    ``MarshalBinary`` dense layout instead (samplers.go:441-465), which a
    Go global's ``UnmarshalBinary`` + ``Merge`` accept (4-bit tailcut
    registers: values past base+15 clip as the reference's own inserts
    do)."""
    regs = np.asarray(registers, np.uint8)
    if regs.shape != (1 << precision,):
        raise ValueError(f"want {1 << precision} registers, got {regs.shape}")
    if reference_compat:
        return axiomhq.encode_dense(regs, precision)
    return (_HLL_MAGIC + struct.pack("BB", _HLL_VERSION, precision)
            + regs.tobytes())


def decode_hll(blob: bytes) -> tuple[np.ndarray, int]:
    """Decode an HLL payload: our ``VH`` layout or the reference's axiomhq
    format (dense and sparse), auto-detected."""
    if blob[:2] == _HLL_MAGIC:
        version, precision = struct.unpack_from("BB", blob, 2)
        if version != _HLL_VERSION:
            raise ValueError(f"unsupported HLL version {version}")
        regs = np.frombuffer(blob, np.uint8, count=1 << precision, offset=4)
        return regs, precision
    if axiomhq.looks_like(blob):
        return axiomhq.decode(blob)
    raise ValueError("unrecognized HLL payload (neither VH nor axiomhq)")


def _validated_digest(key, tags, means, weights, dmin, dmax):
    """Normalize a digest import so the bulk store call cannot raise on
    its data: 1-D numeric parallel arrays, float extrema."""
    means = np.asarray(means, np.float64)
    weights = np.asarray(weights, np.float64)
    if means.ndim != 1 or means.shape != weights.shape:
        raise ValueError("centroid mean/weight arrays malformed")
    return (key, tags, means, weights, float(dmin), float(dmax))


def _apply_ops(store, others, digests) -> tuple:
    """Apply pre-validated import ops: a per-op guard on the scalar/set
    path (a store-level rejection, e.g. an HLL precision mismatch, skips
    that metric, never the batch), one bulk call for the digests (fully
    data-validated, so anything raising there is systemic and fails the
    whole digest batch). Returns (n_applied, n_errors)."""
    n_ok = n_err = 0
    for kind, key, tags, payload in others:
        try:
            if kind == "counter":
                store.import_counter(key, tags, payload)
            elif kind == "gauge":
                store.import_gauge(key, tags, payload)
            elif kind == "set":
                store.import_set(key, tags, payload)
            else:  # topk: payload = (table, series)
                store.import_topk(*payload)
            n_ok += 1
        except Exception as e:
            n_err += 1
            log.debug("store rejected imported metric %s: %s",
                      key if isinstance(key, str) else key.name, e)
    if digests:
        try:
            store.import_digests_bulk(digests)
            n_ok += len(digests)
        except Exception:
            # not transactional: a prefix may already be staged, so the
            # batch counts as errors and is not retried (a retry could
            # double-count the applied prefix)
            n_err += len(digests)
            log.exception("bulk digest import failed; dropping %d digests",
                          len(digests))
    return n_ok, n_err


# ---------------------------------------------------------------------------
# ForwardableState -> body
# ---------------------------------------------------------------------------


def reference_json_metrics_from_state(state,
                                      compression: float = 100.0
                                      ) -> List[Dict]:
    """ForwardableState -> REFERENCE-format ``JSONMetric`` entries: the
    body a Go local would POST (samplers.go Export methods). The caller
    materializes the digest planes first."""
    out: List[Dict] = []

    def entry(name, tags, mtype, blob: bytes) -> Dict:
        return {"name": name, "type": mtype,
                "tagstring": ",".join(tags), "tags": list(tags),
                "value": base64.b64encode(blob).decode()}

    for name, tags, value in state.counters:
        out.append(entry(name, tags, "counter",
                         struct.pack("<q", int(value))))
    for name, tags, value in state.gauges:
        out.append(entry(name, tags, "gauge",
                         struct.pack("<d", float(value))))
    for kind, mtype in (("histograms", "histogram"), ("timers", "timer")):
        for name, tags, means, weights, dmin, dmax in getattr(state, kind):
            n = len(means)
            out.append(entry(name, tags, mtype, encode_reference_digest(
                means, weights, compression,
                float(dmin) if n else 0.0, float(dmax) if n else 0.0)))
    for name, tags, registers, precision in state.sets:
        out.append(entry(name, tags, "set",
                         axiomhq.encode_dense(registers, precision)))
    return out


def json_metrics_from_state(state, compression: float = 100.0
                            ) -> List[Dict]:
    """ForwardableState -> our structured JSON entries, the replacement
    for ``JSONMetric``'s gob blob (flusher.go:292-385). The caller
    materializes the digest planes first. A state flushed with
    ``forward_topk=False`` carries no heavy-hitter sketch."""
    out: List[Dict] = []
    for name, tags, value in state.counters:
        out.append({"name": name, "tags": tags, "type": "counter",
                    "value": int(value)})
    for name, tags, value in state.gauges:
        out.append({"name": name, "tags": tags, "type": "gauge",
                    "value": float(value)})
    for kind, mtype in (("histograms", "histogram"), ("timers", "timer")):
        for name, tags, means, weights, dmin, dmax in getattr(state, kind):
            out.append({"name": name, "tags": tags, "type": mtype,
                        "digest": {
                            "compression": compression,
                            "min": float(dmin), "max": float(dmax),
                            # float64 pairs: the same numbers as
                            # [[float(m), float(w)], ...]
                            "centroids": np.column_stack(
                                (means, weights)).tolist()}})
    for name, tags, registers, precision in state.sets:
        out.append({"name": name, "tags": tags, "type": "set",
                    "hll": base64.b64encode(
                        encode_hll(registers, precision)).decode()})
    if state.topk is not None:
        table, series = state.topk
        table = np.ascontiguousarray(table, np.float32)
        out.append({
            "type": "topk_sketch",
            "name": "veneur.topk",  # a routing/debug label only
            "tags": [],
            "depth": int(table.shape[0]),
            "width": int(table.shape[1]),
            # the body is deflated whole, so the sparse table compresses
            # well despite base64
            "table": base64.b64encode(table.tobytes()).decode(),
            "series": [
                {"name": name, "tags": list(tags),
                 "keys": [[int(hi), int(lo)] for hi, lo in keys],
                 "members": list(members)}
                for name, tags, keys, members in series],
        })
    return out


def _state_metrics(state, compression: float, reference_compat: bool):
    """(serialized Metrics, serialized TopKSketch or None) of a
    ForwardableState's per-row parts, in the JAX builder's order."""
    metrics = [mlist.counter(name, tags, value)
               for name, tags, value in state.counters]
    metrics += [mlist.gauge(name, tags, value)
                for name, tags, value in state.gauges]
    for kind, pb_type in (("histograms", mlist.HISTOGRAM),
                          ("timers", mlist.TIMER)):
        metrics += [mlist.digest(name, tags, pb_type, means, weights, dmin,
                                 dmax, compression, reference_compat)
                    for name, tags, means, weights, dmin, dmax
                    in getattr(state, kind)]
    metrics += [mlist.set_metric(name, tags, encode_hll(
                    registers, precision, reference_compat=reference_compat))
                for name, tags, registers, precision in state.sets]
    topk = None
    if state.topk is not None and not reference_compat:
        topk = mlist.topk_sketch(*state.topk)
    return metrics, topk


def metric_list_from_state(state, compression: float = 100.0,
                           reference_compat: bool = False) -> bytes:
    """ForwardableState -> one serialized MetricList (worker.go:161-183's
    ForwardableMetrics and each sampler's Metric()): the bytes the JAX
    package's builder of the same name serializes. Digests travel as
    packed parallel arrays; ``reference_compat`` also writes the
    reference's repeated Centroid messages and the reference's axiomhq
    set bytes, and keeps the heavy-hitter sketch (MetricList.topk) off
    the wire. Columnar digest planes are not written here (the C++
    encoders take them): materialize them first to send them this way.
    Returns b"" for a state with nothing to send."""
    chunks = metric_lists_from_state(state, compression, reference_compat)
    return chunks[0][0] if chunks else b""


def metric_lists_from_state(state, compression: float = 100.0,
                            reference_compat: bool = False,
                            max_bytes: int = 0) -> List[tuple]:
    """:func:`metric_list_from_state` cut into MetricLists of at most
    ``max_bytes`` (0 = one; a metric larger alone gets one of its own):
    ``[(bytes, metrics in it)]``, the top-k sketch in the first. A
    1M-series local's 32,768 sets alone are ~537 MB, past one frame.
    Parsed together, the chunks are the one list."""
    metrics, topk = _state_metrics(state, compression, reference_compat)
    if not metrics and topk is None:
        return []
    out, cur, size = [], [], 0
    if topk is not None:
        size = len(mlist.metric_list([], topk))
    for m in metrics:
        grown = mlist.framed_size(m)
        if max_bytes and (cur or size) and size + grown > max_bytes:
            out.append((mlist.metric_list(cur, topk), len(cur)))
            cur, size, topk = [], 0, None
        cur.append(m)
        size += grown
    out.append((mlist.metric_list(cur, topk), len(cur)))
    return out


def decode_topk_sketch(d) -> tuple:
    """A heavy-hitter sketch -> the (table, series) pair
    ``MetricStore.import_topk`` takes: a JSON ``topk_sketch`` entry, or a
    MetricList's :class:`~veneur_tpu_torch.protocol.mlist.TopKSketch`."""
    if isinstance(d, mlist.TopKSketch):
        table = np.frombuffer(d.table, np.float32).reshape(d.depth, d.width)
        series = []
        for s in d.series:
            members = [m or None for m in s.members]
            members += [None] * (len(s.keys) - len(members))
            series.append((s.name, list(s.tags),
                           [(k >> 32, k & 0xFFFFFFFF) for k in s.keys],
                           members))
        return table, series
    table = np.frombuffer(base64.b64decode(d["table"]),
                          np.float32).reshape(int(d["depth"]),
                                              int(d["width"]))
    series = [(s["name"], list(s.get("tags") or []),
               [(int(hi), int(lo)) for hi, lo in s["keys"]],
               list(s.get("members") or []))
              for s in d.get("series", [])]
    return table, series


# ---------------------------------------------------------------------------
# body -> store
# ---------------------------------------------------------------------------


def _parse_reference_json(d: Dict) -> tuple:
    """One REFERENCE-format JSONMetric -> (digest op, None) or (None,
    other op). ``tagstring`` (parser.go:47) is the key's joined tags."""
    mtype = d["type"]
    tags = list(d.get("tags") or [])
    joined = d.get("tagstring")
    if not tags and joined:
        tags = joined.split(",")
    key = MetricKey(name=d["name"], type=mtype,
                    joined_tags=joined if joined is not None
                    else ",".join(tags))
    blob = base64.b64decode(d["value"])
    if mtype == "counter":
        (v,) = struct.unpack("<q", blob)
        return None, ("counter", key, tags, v)
    if mtype == "gauge":
        (v,) = struct.unpack("<d", blob)
        return None, ("gauge", key, tags, v)
    if mtype == "set":
        registers, _ = decode_hll(blob)
        return None, ("set", key, tags, registers)
    if mtype in ("histogram", "timer"):
        means, weights, _comp, dmin, dmax = decode_reference_digest(blob)
        return _validated_digest(key, tags, means, weights, dmin, dmax), None
    raise ValueError(f"unknown reference JSON metric type {mtype!r}")


def _parse_json(d: Dict) -> tuple:
    """One entry of either format -> (digest op, None) or (None, other
    op); raises on a malformed or unknown entry."""
    if isinstance(d.get("value"), str):
        # reference format: only reference entries put base64 strings in
        # "value" (ours carry numbers there)
        return _parse_reference_json(d)
    mtype = d["type"]
    tags = list(d.get("tags") or [])
    key = MetricKey(name=d["name"], type=mtype, joined_tags=",".join(tags))
    if mtype in ("histogram", "timer"):
        td = d["digest"]
        cents = td.get("centroids") or []
        return _validated_digest(key, tags, [c[0] for c in cents],
                                 [c[1] for c in cents],
                                 td.get("min", float("inf")),
                                 td.get("max", float("-inf"))), None
    if mtype == "counter":
        return None, ("counter", key, tags, int(d["value"]))
    if mtype == "gauge":
        return None, ("gauge", key, tags, float(d["value"]))
    if mtype == "set":
        registers, _ = decode_hll(base64.b64decode(d["hll"]))
        return None, ("set", key, tags, registers)
    if mtype == "topk_sketch":
        return None, ("topk", d["name"], tags, decode_topk_sketch(d))
    raise ValueError(f"unknown JSON metric type {mtype!r}")


def apply_json_metric_list(store, metrics: List[Dict]) -> tuple:
    """Merge a decoded ``/import`` body: every entry is parsed and decoded
    first (a malformed one is counted and skipped), each scalar/set op is
    applied under its own guard, and all digests stage through ONE bulk
    store call. Returns (n_applied, n_errors)."""
    digests, others = [], []
    n_err = 0
    for d in metrics:
        try:
            digest_op, other_op = _parse_json(d)
        except Exception as e:
            n_err += 1
            log.debug("skipping malformed JSON metric %r: %s",
                      d.get("name") if isinstance(d, dict) else d, e)
            continue
        if digest_op is not None:
            digests.append(digest_op)
        else:
            others.append(other_op)
    n_ok, apply_errs = _apply_ops(store, others, digests)
    return n_ok, n_err + apply_errs


def apply_json_metric(store, d: Dict):
    """Merge one imported JSON metric of either format
    (handlers_global.go:60-213 + Worker.ImportMetric,
    worker.go:313-351); raises on a malformed entry."""
    digest_op, other_op = _parse_json(d)
    if digest_op is not None:
        store.import_digest(*digest_op)
        return
    kind, key, tags, payload = other_op
    if kind == "counter":
        store.import_counter(key, tags, payload)
    elif kind == "gauge":
        store.import_gauge(key, tags, payload)
    elif kind == "set":
        store.import_set(key, tags, payload)
    else:
        store.import_topk(*payload)
