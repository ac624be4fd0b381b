"""Flush-time archival plugins (reference ``plugins/plugins.go:16-19``).

Port of ``veneur_tpu/plugins/__init__.py``. Plugins receive the whole
flush after the metric sinks (flusher.go:95-109) and archive it: as
per-row ``InterMetric``s through ``flush``, or as columns through
``flush_columnar`` where a plugin has it: the local-file plugin
(``localfile.py``) and the S3 one (``s3.py``).
"""

from __future__ import annotations

import abc
from typing import List

from veneur_tpu_torch.samplers.intermetric import InterMetric


class Plugin(abc.ABC):
    """plugins.Plugin (plugins/plugins.go:16-19)."""

    @property
    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def flush(self, metrics: List[InterMetric]) -> None: ...
