"""Scalar (pure-Python) reference samplers: the golden models.

These mirror the reference implementations' algorithms one series at a time —
the merging t-digest of ``tdigest/merging_digest.go`` and the dense
HyperLogLog of the vendored axiomhq library — so the batched tensor ops in
``veneur_tpu_torch.ops`` can be checked for epsilon-equivalence, playing the
role ``tdigest/analysis/`` plays for the reference. The port's accuracy
sweep (``analysis/tdigest_sweep.py``) runs the t-digest beside every cell.

They are NOT on any hot path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


def _k_scale(q: float, compression: float) -> float:
    return compression * (math.asin(2 * q - 1) / math.pi + 0.5)


@dataclass
class ScalarTDigest:
    """Greedy merging t-digest, one series (merging_digest.go:21-257)."""

    compression: float = 100.0
    means: list = field(default_factory=list)
    weights: list = field(default_factory=list)
    temp: list = field(default_factory=list)
    min: float = math.inf
    max: float = -math.inf

    def __post_init__(self):
        c = min(925.0, max(20.0, self.compression))
        self._temp_cap = int(7.5 + 0.37 * c - 2e-4 * c * c)

    def add(self, value: float, weight: float = 1.0) -> None:
        if math.isnan(value) or math.isinf(value) or weight <= 0:
            raise ValueError("invalid value added")
        if len(self.temp) >= self._temp_cap:
            self._merge_temps()
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        self.temp.append((value, weight))

    def _merge_temps(self) -> None:
        if not self.temp:
            return
        allc = sorted(list(zip(self.means, self.weights)) + self.temp)
        self.temp = []
        total = sum(w for _, w in allc)
        merged_w = 0.0
        last_idx = 0.0
        out_m: list = []
        out_w: list = []
        for m, w in allc:
            next_idx = _k_scale((merged_w + w) / total, self.compression)
            if next_idx - last_idx > 1 or not out_m:
                # start a new centroid
                out_m.append(m)
                out_w.append(w)
                last_idx = _k_scale(merged_w / total, self.compression)
            else:
                # fold into the current centroid (Welford order: weight first)
                out_w[-1] += w
                out_m[-1] += (m - out_m[-1]) * w / out_w[-1]
            merged_w += w
        self.means, self.weights = out_m, out_w

    def count(self) -> float:
        return sum(self.weights) + sum(w for _, w in self.temp)

    def _upper_bound(self, i: int) -> float:
        if i != len(self.means) - 1:
            return (self.means[i + 1] + self.means[i]) / 2
        return self.max

    def quantile(self, q: float) -> float:
        if q < 0 or q > 1:
            raise ValueError("quantile out of bounds")
        self._merge_temps()
        if not self.means:
            return math.nan
        total = sum(self.weights)
        target = q * total
        wsf = 0.0
        lb = self.min
        for i, w in enumerate(self.weights):
            ubi = self._upper_bound(i)
            if target <= wsf + w:
                prop = (target - wsf) / w
                return lb + prop * (ubi - lb)
            wsf += w
            lb = ubi
        return math.nan

    def cdf(self, value: float) -> float:
        self._merge_temps()
        if not self.means:
            return math.nan
        if value <= self.min:
            return 0.0
        if value >= self.max:
            return 1.0
        total = sum(self.weights)
        wsf = 0.0
        lb = self.min
        for i, w in enumerate(self.weights):
            ubi = self._upper_bound(i)
            if value < ubi:
                wsf += w * (value - lb) / (ubi - lb)
                return wsf / total
            wsf += w
            lb = ubi
        return math.nan

    def merge(self, other: "ScalarTDigest") -> None:
        other._merge_temps()
        for m, w in zip(other.means, other.weights):
            self.add(m, w)


class ScalarHLL:
    """Dense HyperLogLog with linear-counting small-range correction,
    one series (cf. samplers.Set over axiomhq/hyperloglog, samplers.go:367-435).
    """

    def __init__(self, precision: int = 14):
        if not 4 <= precision <= 18:
            raise ValueError("precision must be in [4, 18]")
        self.p = precision
        self.m = 1 << precision
        self.registers = bytearray(self.m)

    def insert_hash(self, h: int) -> None:
        """Insert a 64-bit hash value."""
        idx = h >> (64 - self.p)
        rest = (h << self.p) & ((1 << 64) - 1)
        # rho = leading zeros of the remaining 64-p bits, +1
        rho = 1
        bit = 1 << 63
        while rho <= 64 - self.p and not (rest & bit):
            rho += 1
            bit >>= 1
        if rho > self.registers[idx]:
            self.registers[idx] = rho

    def merge(self, other: "ScalarHLL") -> None:
        if other.p != self.p:
            raise ValueError("precision mismatch")
        for i in range(self.m):
            if other.registers[i] > self.registers[i]:
                self.registers[i] = other.registers[i]

    def estimate(self) -> float:
        m = float(self.m)
        if self.p >= 7:
            alpha = 0.7213 / (1 + 1.079 / m)
        else:
            alpha = {4: 0.673, 5: 0.697, 6: 0.709}[self.p]
        raw_inv = sum(2.0 ** -r for r in self.registers)
        est = alpha * m * m / raw_inv
        zeros = sum(1 for r in self.registers if r == 0)
        if est <= 2.5 * m and zeros > 0:
            return m * math.log(m / zeros)
        return est
