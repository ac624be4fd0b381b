"""Local-file archival plugin: gzip TSV append per flush.

Port of ``veneur_tpu/plugins/localfile.py`` (after the reference's
``plugins/localfile/localfile.go:31-61``): each
flush appends one complete gzip member (TSV rows of the whole batch) to
``file_path`` — concatenated gzip members decompress as one stream.
"""

from __future__ import annotations

import logging
from typing import List

from veneur_tpu_torch.plugins import Plugin
from veneur_tpu_torch.plugins.csv_encode import (encode_columnar_csv,
                                           encode_intermetrics_csv)
from veneur_tpu_torch.samplers.intermetric import InterMetric

log = logging.getLogger("veneur.plugins.localfile")


class LocalFilePlugin(Plugin):
    def __init__(self, file_path: str, hostname: str, interval: int = 10):
        self.file_path = file_path
        self.hostname = hostname
        self.interval = interval

    @property
    def name(self) -> str:
        return "localfile"

    def flush(self, metrics: List[InterMetric]) -> None:
        self._append(encode_intermetrics_csv(metrics, self.hostname,
                                             self.interval))

    def flush_columnar(self, batch) -> None:
        """Columnar archive: TSV rows serialize natively from the flush
        columns instead of per-row InterMetrics."""
        self._append(encode_columnar_csv(batch, self.hostname,
                                         self.interval))

    def _append(self, blob: bytes) -> None:
        try:
            with open(self.file_path, "ab") as f:
                f.write(blob)
        except OSError as e:
            raise RuntimeError(
                f"couldn't open {self.file_path} for appending: {e}") from e
