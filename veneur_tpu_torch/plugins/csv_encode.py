"""TSV row encoding for archival plugins.

Port of ``veneur_tpu/plugins/csv_encode.py`` (after the reference's
``plugins/s3/csv.go``): fixed column order
(Name, Tags, MetricType, VeneurHostname, Interval, Timestamp, Value,
Partition; csv.go:17-49), tags as ``{a,b}``, counters emitted as rates,
Redshift timestamp format, and a ``yyyymmdd`` partition column
(csv.go:55-92).
"""

from __future__ import annotations

import csv
import gzip
import io
import math
import time
from typing import List, Optional

import numpy as np

from veneur_tpu_torch.core.columnar import TYPE_COUNTER
from veneur_tpu_torch.native import egress
from veneur_tpu_torch.samplers.intermetric import InterMetric, MetricType

PARTITION_DATE_FORMAT = "%Y%m%d"
# Go's "2006-01-02 03:04:05" is a *12-hour* clock (03 not 15), and the
# reference uses it verbatim (csv.go:15) — match it, quirk included.
REDSHIFT_DATE_FORMAT = "%Y-%m-%d %I:%M:%S"

TSV_SCHEMA = ["Name", "Tags", "MetricType", "VeneurHostname", "Interval",
              "Timestamp", "Value", "Partition"]


def _format_value(v: float) -> str:
    """Shortest non-exponential decimal, like Go's FormatFloat(v,'f',-1,64)
    (csv.go:81), including its +Inf/-Inf/NaN spellings."""
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e16:
        return str(int(v))
    s = repr(v)
    if "e" in s or "E" in s:
        s = format(v, ".17f").rstrip("0").rstrip(".")
    return s


def encode_intermetric_row(m: InterMetric, hostname: str, interval: int,
                           partition_date: float) -> List[str]:
    """One TSV row (csv.go:55-92). Raises on unknown metric types."""
    tags = "{" + ",".join(m.tags) + "}"
    if m.type == MetricType.COUNTER:
        value = m.value / interval
        metric_type = "rate"
    elif m.type == MetricType.GAUGE:
        value = m.value
        metric_type = "gauge"
    else:
        raise ValueError(f"Encountered an unknown metric type {m.type}")
    return [
        m.name,
        tags,
        metric_type,
        hostname,
        str(interval),
        time.strftime(REDSHIFT_DATE_FORMAT, time.gmtime(m.timestamp)),
        _format_value(value),
        time.strftime(PARTITION_DATE_FORMAT, time.gmtime(partition_date)),
    ]


def encode_columnar_csv(batch, hostname: str, interval: int,
                        partition_date: Optional[float] = None) -> bytes:
    """Gzipped TSV of a ColumnarFlush: blocks serialize natively
    (native/veneur_egress.cpp vt_tsv_rows — no per-row objects), extras
    take the per-row encoder. Same bytes as encode_intermetrics_csv on
    the materialized batch."""
    if partition_date is None:
        partition_date = time.time()
    ts_str = time.strftime(REDSHIFT_DATE_FORMAT,
                           time.gmtime(batch.timestamp))
    part_str = time.strftime(PARTITION_DATE_FORMAT,
                             time.gmtime(partition_date))
    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb") as gz:
        for blk in batch.blocks:
            values = blk.values
            if (blk.type_codes == TYPE_COUNTER).any():
                values = np.where(blk.type_codes == TYPE_COUNTER,
                                  values / interval, values)
            gz.write(egress.tsv_rows(
                blk.names, blk.tags, blk.suffixes, blk.rows,
                blk.suffix_idx, values, blk.type_codes, hostname,
                interval, ts_str, part_str))
        if batch.extras:
            text = io.TextIOWrapper(gz, encoding="utf-8", newline="")
            w = csv.writer(text, delimiter="\t", lineterminator="\n")
            for m in batch.extras:
                try:
                    w.writerow(encode_intermetric_row(
                        m, hostname, interval, partition_date))
                except ValueError:
                    continue
            text.flush()
            text.detach()
    return buf.getvalue()


def encode_intermetrics_csv(metrics: List[InterMetric], hostname: str,
                            interval: int, delimiter: str = "\t",
                            include_headers: bool = False,
                            partition_date: Optional[float] = None) -> bytes:
    """Gzipped TSV of the whole batch (s3.go:99-135). Rows that fail to
    encode are skipped, matching the reference's unchecked write."""
    if partition_date is None:
        partition_date = time.time()
    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb") as gz:
        text = io.TextIOWrapper(gz, encoding="utf-8", newline="")
        w = csv.writer(text, delimiter=delimiter, lineterminator="\n")
        if include_headers:
            w.writerow(TSV_SCHEMA)
        for m in metrics:
            try:
                w.writerow(encode_intermetric_row(m, hostname, interval,
                                                  partition_date))
            except ValueError:
                continue
        text.flush()
        text.detach()
    return buf.getvalue()
