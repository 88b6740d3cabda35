"""Asymmetric-bandwidth wireless network model.

The paper's systems observation: downstream can be ~10x upstream in 5G
[Chen & Zhao 2014]. Broadcast rides the fat downstream link, uploads cross
the thin upstream link. This model tracks per-direction byte totals and a
time series (for the communication-peak experiment, Fig. 10).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict


@dataclasses.dataclass
class NetworkModel:
    upstream_bps: float = 10e6 * 8 / 8  # 10 MB/s
    downstream_bps: float = 100e6 * 8 / 8  # 100 MB/s (10x asymmetry)
    bin_seconds: float = 60.0

    def __post_init__(self):
        self.up_bytes = 0
        self.up_raw_bytes = 0  # dense-equivalent uplink bytes (compression ratio)
        self.up_retry_bytes = 0  # retry-attributable uplink bytes (fault layer)
        self.down_bytes = 0
        self.up_events = 0
        self.down_events = 0
        self._up_series: dict[int, float] = defaultdict(float)
        self._down_series: dict[int, float] = defaultdict(float)

    @staticmethod
    def _check_bytes(nbytes: int) -> None:
        if nbytes < 0:
            raise ValueError(f"byte count must be >= 0, got {nbytes}")

    def upload(self, nbytes: int, t: float, raw_nbytes: int | None = None, retry: bool = False) -> float:
        """Register an upload starting at t; returns transfer duration.

        ``nbytes`` is what actually crosses the thin link (the compressed
        payload when an uplink codec is active) and drives ALL billing —
        totals, the per-bin series, the transfer duration. ``raw_nbytes``
        is the dense size of the same model payload, tracked separately so
        reports can state the achieved compression ratio; it defaults to
        ``nbytes`` (uncompressed uploads). ``retry`` marks the transfer as
        retry-attributable (a re-send after a loss/timeout, or a duplicate
        retransmission): it bills identically but is also accumulated in
        ``up_retry_bytes`` so reports can state the fault overhead."""
        self._check_bytes(nbytes)
        if raw_nbytes is not None:
            self._check_bytes(raw_nbytes)
        self.up_bytes += nbytes
        self.up_raw_bytes += nbytes if raw_nbytes is None else raw_nbytes
        if retry:
            self.up_retry_bytes += nbytes
        self.up_events += 1
        self._up_series[int(t // self.bin_seconds)] += nbytes
        return nbytes / self.upstream_bps

    def download(self, nbytes: int, t: float) -> float:
        self._check_bytes(nbytes)
        self.down_bytes += nbytes
        self.down_events += 1
        self._down_series[int(t // self.bin_seconds)] += nbytes
        return nbytes / self.downstream_bps

    def download_bulk(self, nbytes: int, count: int, t: float) -> float:
        """Bill ``count`` equal-size downloads starting at ``t`` in one call
        (a broadcast's whole fan-out): byte totals, event counts, and the
        per-bin series land exactly as ``count`` ``download`` calls would
        (the per-bin sum adds integer byte counts, exact in float64), and
        the shared transfer duration is returned once."""
        self._check_bytes(nbytes)
        if count <= 0:
            raise ValueError(f"download_bulk count must be >= 1, got {count}")
        self.down_bytes += nbytes * count
        self.down_events += count
        self._down_series[int(t // self.bin_seconds)] += nbytes * count
        return nbytes / self.downstream_bps

    def _series_for(self, direction: str) -> dict[int, float]:
        if direction == "down":
            return self._down_series
        if direction == "up":
            return self._up_series
        raise ValueError(
            f"unknown direction {direction!r}: expected 'up' or 'down'"
        )

    def peak(self, direction: str = "down") -> float:
        return max(self._series_for(direction).values(), default=0.0)

    def series(self, direction: str = "down") -> dict[int, float]:
        return dict(self._series_for(direction))

    @property
    def total_bytes(self) -> int:
        return self.up_bytes + self.down_bytes
