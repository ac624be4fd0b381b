"""The S3 archive plugin: a gzipped TSV object a flush.

Port of ``veneur_tpu/plugins/s3.py`` (after ``plugins/s3/s3.go:35-134``):
the flush is encoded as gzip TSV (``plugins/csv_encode.py``; from the
columns with ``flush_columnar``) and put to
``{yyyy}/{mm}/{dd}/{hostname}/{unix}.tsv.gz`` in the bucket (S3Path,
s3.go:93-97). The client is injected: any object with
``put_object(Bucket=, Key=, Body=)`` (boto3's S3 client is one).
Flushing without one raises ``S3ClientUninitializedError``
(s3.go:76-79).
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

from veneur_tpu_torch.plugins import Plugin
from veneur_tpu_torch.plugins.csv_encode import (encode_columnar_csv,
                                                 encode_intermetrics_csv)
from veneur_tpu_torch.samplers.intermetric import InterMetric

log = logging.getLogger("veneur.plugins.s3")


class S3ClientUninitializedError(Exception):
    pass


def s3_path(hostname: str, ft: str = "tsv.gz",
            now: Optional[float] = None) -> str:
    """{yyyy}/{mm}/{dd}/{hostname}/{unix}.{ft} (s3.go:93-97)."""
    t = now if now is not None else time.time()
    return "%s/%s/%d.%s" % (time.strftime("%Y/%m/%d", time.gmtime(t)),
                            hostname, int(t), ft)


class S3Plugin(Plugin):
    def __init__(self, hostname: str, bucket: str = "stripe-veneur",
                 interval: int = 10, svc=None):
        self.hostname = hostname
        self.bucket = bucket
        self.interval = interval
        self.svc = svc  # boto3-style client, injected

    @property
    def name(self) -> str:
        return "s3"

    def flush(self, metrics: List[InterMetric]) -> None:
        if self.svc is None:
            raise S3ClientUninitializedError(
                "s3 client has not been initialized")
        blob = encode_intermetrics_csv(metrics, self.hostname, self.interval)
        self.svc.put_object(Bucket=self.bucket,
                            Key=s3_path(self.hostname),
                            Body=blob)
        log.debug("Completed flush to s3: %d metrics", len(metrics))

    def flush_columnar(self, batch) -> None:
        """The TSV rows from the flush's columns (the C++ serializer)."""
        if self.svc is None:
            raise S3ClientUninitializedError(
                "s3 client has not been initialized")
        blob = encode_columnar_csv(batch, self.hostname, self.interval)
        self.svc.put_object(Bucket=self.bucket,
                            Key=s3_path(self.hostname),
                            Body=blob)
        log.debug("Completed columnar flush to s3: %d metrics", len(batch))
