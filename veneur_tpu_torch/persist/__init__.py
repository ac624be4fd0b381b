"""Crash-safe aggregation state: interval checkpointing and warm restart.

Port of ``veneur_tpu/persist/``: ``persist/checkpoint.py`` for the model,
``persist/format.py`` for the on-disk layout (the same bytes as the JAX
package's). Configured by ``checkpoint_path``, ``checkpoint_interval``
and ``checkpoint_max_age_intervals``.
"""

from veneur_tpu_torch.persist.checkpoint import Checkpointer
from veneur_tpu_torch.persist.format import (CheckpointInvalid, deserialize,
                                             read_file, serialize,
                                             write_atomic)

__all__ = ["Checkpointer", "CheckpointInvalid", "serialize", "deserialize",
           "write_atomic", "read_file"]
