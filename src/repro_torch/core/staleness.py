"""Staleness accounting (paper Sec. 5.1).

Staleness of an update = (cluster-model version at aggregation time) -
(version the client trained from). The paper's convergence-rate proxy is
O(sqrt(Q_max * Q_avg)) after Koloskova et al.; on-demand broadcast exists
precisely to pull Q_max down (a broadcast resets the base version of every
in-cluster client to current, so in-flight staleness stops accumulating).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class StalenessTracker:
    count: int = 0
    total: float = 0.0
    q_max: int = 0

    def record(self, staleness: int) -> None:
        if staleness < 0:
            raise ValueError(f"negative staleness {staleness}: version bookkeeping bug")
        self.count += 1
        self.total += staleness
        self.q_max = max(self.q_max, staleness)

    @property
    def q_avg(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def convergence_proxy(self) -> float:
        """O(sqrt(Q_max * Q_avg)) — lower is better. A run that never saw
        staleness (no records, or every record zero) reports exactly 0.0;
        the 1e-12 floor only guards the mixed case where one factor is zero
        by rounding, not a genuinely staleness-free run."""
        if self.count == 0 or (self.q_max == 0 and self.q_avg == 0.0):
            return 0.0
        return math.sqrt(max(self.q_max, 1e-12) * max(self.q_avg, 1e-12))

    def snapshot(self) -> dict:
        return {"q_max": self.q_max, "q_avg": self.q_avg, "n": self.count,
                "convergence_proxy": self.convergence_proxy}
