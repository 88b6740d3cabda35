"""The ingest guard: per-upload accept or reject, strikes, quarantine and
eviction, and the late center check (counterpart of ``repro.fl.guard``).

Per delivered upload the simulator scores three host statistics before the
strategy sees the payload:

* **finite**: any NaN or Inf coordinate rejects the upload;
* **L2 norm** of the upload, against a robust per-cluster bound (catches a
  magnitude blow-up);
* **L1 distance to the client's cluster center** (catches a sign flip,
  whose norm is unchanged), checked and recorded only while the client's
  home cluster is the one of its last accepted upload.

A bound is ``med + k * max(1.4826 * mad, rel_floor * |med|)`` over the last
``window`` accepted values of the cluster; a cluster with fewer than
``grace`` of them accepts every finite upload. Rejected values never enter
a history. Every rejection is a strike; at ``quarantine_strikes`` the
client's uploads are rejected unseen, at ``evict_strikes`` the simulator
retires it through the path device death takes.

Late detection: after each blend the server checks the cluster's
post-blend center L1 norm against the same discipline (:meth:`center_ok`):
per event a host sum, on the coalesced path the ``ingest_chain`` kernel's
fourth statistic, read in the segment's one host copy. A failed check
rolls the center back to the newest finite snapshot
(``Cluster.rollback``) and re-broadcasts it.

The port takes the guard by argument (``guard=`` of the simulator and of
``run_experiment``): ``None`` or ``"off"`` is no guard, ``"on"`` or a
:class:`GuardConfig` a guard. It reads no environment variable. With no
guard the simulator builds nothing and every hook is skipped; a guard on a
clean run accepts every upload and leaves the run's bits as they were.

The statistics are the reference's arithmetic, on the host in float64,
leaf by leaf in tree order: each upload costs one device-to-host copy of
the payload and of its cluster's center.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.common.pytrees import tree_leaves

__all__ = ["GuardConfig", "IngestGuard", "resolve_guard"]


@dataclasses.dataclass
class GuardConfig:
    """Robust-bound and escalation parameters."""

    grace: int = 8  # accepted finite uploads a cluster before the bounds engage
    window: int = 64  # history length a cluster for the median and MAD
    k: float = 12.0  # bound = med + k * max(1.4826 * mad, rel_floor * med)
    rel_floor: float = 1.0  # spread floor relative to the median
    quarantine_strikes: int = 3
    evict_strikes: int = 6
    snapshot_ring: int = 2  # last-known-good center snapshots a cluster

    def __post_init__(self):
        for name in ("grace", "window", "quarantine_strikes", "evict_strikes", "snapshot_ring"):
            v = getattr(self, name)
            if v < 0:
                raise ValueError(f"{name} must be >= 0, got {v!r}")
        if self.evict_strikes < self.quarantine_strikes:
            raise ValueError("evict_strikes must be >= quarantine_strikes, got "
                             f"{self.evict_strikes} < {self.quarantine_strikes}")
        for name in ("k", "rel_floor"):
            if getattr(self, name) <= 0.0:
                raise ValueError(f"{name} must be > 0, got {getattr(self, name)!r}")


def resolve_guard(spec: Any = None) -> GuardConfig | None:
    """The simulator's ``guard=`` argument as a config: ``None`` or ``"off"``
    (and ``"0"``, ``"none"``, ``"no"``, ``""``) is no guard, ``"on"`` (or
    ``"1"``, ``"true"``, ``"yes"``) the default config, a
    :class:`GuardConfig` itself."""
    if spec is None:
        return None
    if isinstance(spec, str):
        low = spec.strip().lower()
        if low in ("", "0", "off", "none", "no"):
            return None
        if low in ("1", "on", "true", "yes"):
            return GuardConfig()
        raise ValueError(f"guard spec must be on|off or a GuardConfig; got {spec!r}")
    if isinstance(spec, GuardConfig):
        return spec
    raise ValueError(f"guard spec must be on|off or a GuardConfig; got {spec!r}")


def _leaves(tree: Any) -> list[np.ndarray]:
    """A tree's leaves as host numpy arrays, in tree order (one
    device-to-host copy a leaf for tensors on the card)."""
    return [x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in tree_leaves(tree)]


def _robust_bound(hist: deque, k: float, rel_floor: float) -> float:
    vals = np.asarray(hist, dtype=np.float64)
    med = float(np.median(vals))
    mad = float(np.median(np.abs(vals - med)))
    spread = max(1.4826 * mad, rel_floor * abs(med), 1e-12)
    return med + k * spread


class IngestGuard:
    """Per-upload accept/reject, strike escalation and the late center
    check. One guard a simulator run; all its state is on the host."""

    def __init__(self, cfg: GuardConfig | None = None):
        self.cfg = cfg or GuardConfig()
        self._norm_hist: dict[Any, deque] = {}
        self._dist_hist: dict[Any, deque] = {}
        self._center_hist: dict[Any, deque] = {}
        self._last_home: dict[Any, Any] = {}  # client -> cluster at its last accepted upload
        self._strikes: dict[Any, int] = {}
        self.quarantined: set = set()
        self.evicted: set = set()
        self.ledger: dict[str, Any] = {
            "accepted": 0,
            "rejected_nonfinite": 0,
            "rejected_norm": 0,
            "rejected_dist": 0,
            "rejected_quarantined": 0,
            "rollbacks": 0,
            "quarantined_clients": 0,
            "evicted_clients": 0,
        }

    def upload_stats(self, update: Any, center: Any | None) -> tuple[bool, float, float]:
        """``(finite, l2_norm, l1_dist_to_center)`` of an upload in host
        float64, leaf by leaf, each leaf's sum added in tree order.
        ``center=None`` (no cluster yet) gives ``dist = 0``."""
        sq = 0.0
        dist = 0.0
        finite = True
        c_leaves = _leaves(center) if center is not None else None
        for i, u in enumerate(_leaves(update)):
            u64 = u.astype(np.float64, copy=False)
            if finite and not bool(np.all(np.isfinite(u64))):
                finite = False
            sq += float(np.sum(u64 * u64))
            if c_leaves is not None:
                dist += float(np.sum(np.abs(u64 - c_leaves[i].astype(np.float64, copy=False))))
        l2 = math.sqrt(sq) if math.isfinite(sq) else float("inf")
        if not finite:
            l2 = float("inf")
            dist = float("inf")
        return finite, l2, dist

    def check_upload(self, cid: Any, cluster_key: Any, finite: bool, l2: float, dist: float) -> str:
        """Gate one delivered upload: ``accept`` or the reject reason
        (``nonfinite``, ``norm``, ``dist``, ``quarantined``). Accepted
        statistics enter the cluster's histories; a reject is a strike."""
        if cid in self.quarantined:
            self.ledger["rejected_quarantined"] += 1
            self._strike(cid)
            return "quarantined"
        if not finite:
            return self._reject(cid, "nonfinite")
        nh = self._norm_hist.setdefault(cluster_key, deque(maxlen=self.cfg.window))
        dh = self._dist_hist.setdefault(cluster_key, deque(maxlen=self.cfg.window))
        if nh and len(nh) >= self.cfg.grace and l2 > _robust_bound(nh, self.cfg.k, self.cfg.rel_floor):
            return self._reject(cid, "norm")
        # the distance means something only for a settled member: right after
        # a move the client is rightly far from a center it never fed
        stable = self._last_home.get(cid) == cluster_key
        if (stable and dh and len(dh) >= self.cfg.grace
                and dist > _robust_bound(dh, self.cfg.k, self.cfg.rel_floor)):
            return self._reject(cid, "dist")
        nh.append(l2)
        if stable:
            dh.append(dist)
        self._last_home[cid] = cluster_key
        self.ledger["accepted"] += 1
        return "accept"

    def _reject(self, cid: Any, reason: str) -> str:
        self.ledger[f"rejected_{reason}"] += 1
        self._strike(cid)
        return reason

    def _strike(self, cid: Any) -> None:
        n = self._strikes.get(cid, 0) + 1
        self._strikes[cid] = n
        if n >= self.cfg.quarantine_strikes and cid not in self.quarantined:
            self.quarantined.add(cid)
            self.ledger["quarantined_clients"] += 1

    def should_evict(self, cid: Any) -> bool:
        """True once, when the client's strikes reach the eviction bar."""
        if cid in self.evicted:
            return False
        if self._strikes.get(cid, 0) >= self.cfg.evict_strikes:
            self.evicted.add(cid)
            self.ledger["evicted_clients"] += 1
            return True
        return False

    def center_ok(self, cluster_key: Any, cnorm: float) -> bool:
        """The post-blend check of a cluster center's L1 norm: a NaN or Inf
        norm, or one past the cluster's bound, vetoes the blend (the caller
        rolls the center back); a healthy norm enters the history."""
        v = float(cnorm)
        if not math.isfinite(v):
            return False
        hist = self._center_hist.setdefault(cluster_key, deque(maxlen=self.cfg.window))
        if hist and len(hist) >= self.cfg.grace and v > _robust_bound(hist, self.cfg.k, self.cfg.rel_floor):
            return False
        hist.append(v)
        return True

    def note_rollback(self) -> None:
        self.ledger["rollbacks"] += 1

    def ledger_snapshot(self) -> dict:
        out = dict(self.ledger)
        out["quarantined"] = sorted(map(repr, self.quarantined))
        out["evicted"] = sorted(map(repr, self.evicted))
        out["strikes"] = sum(self._strikes.values())
        return out
