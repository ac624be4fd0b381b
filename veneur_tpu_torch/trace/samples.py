"""SSF sample constructors (the reference's ``ssf/samples.go:136-205``).

Port of ``veneur_tpu/trace/samples.py`` over the port's protobuf-free
codec (``protocol/ssf.py``): ``count``, ``gauge``, ``histogram``,
``set_sample``, ``timing`` and ``status`` build
:class:`~veneur_tpu_torch.protocol.ssf.SSFSample`\\ s with
``sample_rate=1`` and the module's ``NAME_PREFIX`` prepended
(samples.go:100-106); ``randomly_sample`` thins a batch and scales the
surviving samples' rates (samples.go:112-134).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from veneur_tpu_torch.protocol.ssf import SSFSample

# prepended to every generated sample's name (samples.go:35-39)
NAME_PREFIX = ""

OK = SSFSample.OK
WARNING = SSFSample.WARNING
CRITICAL = SSFSample.CRITICAL
UNKNOWN = SSFSample.UNKNOWN


class Samples:
    """A batch of samples to report together (samples.go:23-32)."""

    def __init__(self):
        self.batch: List[SSFSample] = []

    def add(self, *samples: SSFSample) -> None:
        self.batch.extend(samples)


def _create(metric: int, name: str, value: float = 0.0,
            tags: Optional[Dict[str, str]] = None, message: str = "",
            unit: str = "", status: Optional[int] = None,
            timestamp: Optional[int] = None) -> SSFSample:
    return SSFSample(metric=metric, name=NAME_PREFIX + name, value=value,
                     message=message, unit=unit, sample_rate=1.0,
                     status=status or 0, timestamp=timestamp or 0,
                     tags=tags)


def count(name: str, value: float, tags: Optional[Dict[str, str]] = None,
          **kw) -> SSFSample:
    return _create(SSFSample.COUNTER, name, value, tags, **kw)


def gauge(name: str, value: float, tags: Optional[Dict[str, str]] = None,
          **kw) -> SSFSample:
    return _create(SSFSample.GAUGE, name, value, tags, **kw)


def histogram(name: str, value: float,
              tags: Optional[Dict[str, str]] = None, **kw) -> SSFSample:
    return _create(SSFSample.HISTOGRAM, name, value, tags, **kw)


def set_sample(name: str, value: str, tags: Optional[Dict[str, str]] = None,
               **kw) -> SSFSample:
    """A set-membership sample; the member rides in ``message``
    (samples.go:176-186)."""
    return _create(SSFSample.SET, name, 0.0, tags, message=value, **kw)


def timing(name: str, seconds: float, tags: Optional[Dict[str, str]] = None,
           resolution: float = 1e-9, **kw) -> SSFSample:
    """A timer in ``resolution`` units (nanoseconds by default, as at the
    reference's call sites; samples.go:188-193)."""
    unit = {1e-9: "ns", 1e-6: "us", 1e-3: "ms", 1.0: "s"}.get(resolution, "")
    return histogram(name, seconds / resolution, tags, unit=unit, **kw)


def status(name: str, state: int, tags: Optional[Dict[str, str]] = None,
           **kw) -> SSFSample:
    return _create(SSFSample.STATUS, name, 0.0, tags, status=state, **kw)


def randomly_sample(rate: float, *samples: SSFSample) -> List[SSFSample]:
    """Thin a batch to about ``rate``, scaling the survivors'
    ``sample_rate`` (samples.go:112-134)."""
    out = []
    for s in samples:
        if random.random() <= rate:
            if 0 < rate <= 1:
                s.sample_rate = s.sample_rate * rate
            out.append(s)
    return out

