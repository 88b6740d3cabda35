"""Deterministic fault injection for the asynchronous loops (counterpart of
``repro.fl.faults``).

The faults a chaos run injects, each drawn from its own seeded schedule:

- **client crash in a local round**: the round's work is lost and the
  device goes dark for a drawn downtime, then resumes through the
  simulator's ``_next_online``, the path static churn takes; a fraction of
  crashes are permanent (device death), after which the server evicts the
  client (``EchoPFLServer.evict_clients``).
- **upload loss with capped exponential backoff**: every failed attempt
  bills its full payload and transfer time plus a backoff through
  :class:`~repro_torch.fl.network.NetworkModel` (flagged as retry bytes).
  Under the ``drop`` policy the sender gives up after ``max_retries``
  failures and the client leaves the run.
- **duplicate delivery**: the upload arrives twice (the second send bills
  real bytes); ingest absorbs the copy with a per-client sequence fence.
- **downlink reorder**: a downlink is delayed past a later one to the same
  client; the install fences on a per-recipient send sequence.
- **value poison**: a delivered upload arrives with a NaN slice, blown up
  by a factor, or sign-flipped (:func:`apply_poison`); the ingest guard
  (:mod:`repro_torch.fl.guard`) is the defense.

Every decision comes from ``SeedSequence((seed, kind, crc32(repr(cid)),
counter))``, the counter counting how often that client reached that fault
point, never from a shared stream: the per-event and coalesced loops reach
the points at different wall moments and draw the same schedule, and the
port draws the reference's bits.

The port takes its plan by argument (``faults=`` of the simulator and of
``run_experiment``): ``None`` or ``"off"`` is no faults, a
:class:`FaultConfig` or a :class:`FaultPlan` a chaos run. It reads no
environment variable. A plan's server restart (:class:`ServerRestartPlan`)
kills the EchoPFL server mid-run and brings a fresh one back from a
crash-safe checkpoint (:mod:`repro_torch.checkpoint`).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.common.pytrees import tree_map

# fault-kind codes of the draw key: the reference's, never reordered
_K_CRASH = 1
_K_UPLOAD = 2
_K_DUP = 3
_K_REORDER = 4
_K_POISON = 5


@dataclasses.dataclass
class FaultConfig:
    """Per-kind fault rates and the retry discipline."""

    seed: int = 0
    crash_rate: float = 0.05
    crash_downtime: float = 120.0  # mean; a draw is uniform in [0.5, 1.5) x mean
    death_rate: float = 0.0  # fraction of crashes that are permanent
    loss_rate: float = 0.1  # per upload attempt
    max_retries: int = 4
    backoff_base: float = 5.0
    backoff_cap: float = 60.0
    dup_rate: float = 0.05
    reorder_rate: float = 0.05
    reorder_max_delay: float = 60.0
    dup_max_delay: float = 30.0
    policy: str = "retry"  # retry | drop (the drop-the-straggler baseline)
    poison_nan_rate: float = 0.0  # per delivered upload
    poison_scale_rate: float = 0.0
    poison_sign_rate: float = 0.0
    poison_scale_factor: float = 1e3
    poison_nan_frac: float = 0.01  # fraction of each leaf's coordinates made NaN

    def __post_init__(self):
        if self.policy not in ("retry", "drop"):
            raise ValueError(f"fault policy must be retry|drop, got {self.policy!r}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        for name in ("crash_rate", "death_rate", "loss_rate", "dup_rate", "reorder_rate", "poison_nan_rate",
                     "poison_scale_rate", "poison_sign_rate", "poison_nan_frac"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be a probability in [0, 1], got {v!r}")
        total = self.poison_nan_rate + self.poison_scale_rate + self.poison_sign_rate
        if total > 1.0:
            raise ValueError(f"poison rates must sum to <= 1 (one corruption per upload), got {total!r}")
        for name in ("crash_downtime", "backoff_base", "backoff_cap", "reorder_max_delay", "dup_max_delay"):
            v = getattr(self, name)
            if v < 0.0:
                raise ValueError(f"{name} must be >= 0 seconds, got {v!r}")
        if self.poison_scale_factor <= 0.0:
            raise ValueError(f"poison_scale_factor must be > 0, got {self.poison_scale_factor!r}")


def apply_poison(params: Any, kind: str, u: float, cfg: FaultConfig) -> Any:
    """One delivered upload corrupted by the drawn poison ``(kind, u)``, as
    a tree of fresh tensors on the payload's device, leaf by leaf in tree
    order. The payload's leaves may be views of the client's own model row,
    of a codec's reconstruction or of a segment's blended rows, so nothing
    is written in place: only what crossed the wire turns corrupt. ``nan``
    overwrites a ``poison_nan_frac`` slice of each leaf starting at an
    offset drawn from ``u`` (wrapping around), ``scale`` multiplies by
    ``poison_scale_factor`` in the leaf's dtype, ``sign`` negates."""
    def corrupt(x):
        a = x.detach().clone() if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))
        if kind == "sign":
            return -a
        if kind == "scale":
            return a * torch.tensor(cfg.poison_scale_factor, dtype=a.dtype, device=a.device)
        flat = a.reshape(-1)  # nan
        n = flat.numel()
        if n:
            cnt = max(1, int(round(cfg.poison_nan_frac * n)))
            idx = (int(u * n) + np.arange(cnt)) % n
            flat[torch.from_numpy(idx).to(flat.device)] = float("nan")
        return a

    return tree_map(corrupt, params)


@dataclasses.dataclass
class ServerRestartPlan:
    """Kill and restore the server mid-run (the reference's
    ``ServerRestartPlan``): once ``at_uploads`` uploads are ingested, the
    live strategy's ``state_dict`` goes through the checkpointer into
    ``directory``, the object is dropped, and ``strategy_factory()``'s fresh
    instance is restored from disk and finishes the run. The finished run
    has the uninterrupted run's exact ledger."""

    at_uploads: int
    directory: str
    strategy_factory: Callable[[], Any]
    client_id_type: type = int


@dataclasses.dataclass
class FaultPlan:
    """A chaos run's seeded rates and an optional server restart."""

    config: FaultConfig = dataclasses.field(default_factory=FaultConfig)
    restart: ServerRestartPlan | None = None


def resolve_faults(spec: Any = None) -> FaultPlan | None:
    """The simulator's ``faults=`` argument as a plan: ``None`` or ``"off"``
    (and ``"0"``, ``"none"``, ``"no"``, ``""``) is no faults, a
    :class:`FaultConfig` or :class:`FaultPlan` is taken as it is. ``None``
    means off here: the port reads no environment knob."""
    if spec is None:
        return None
    if isinstance(spec, str):
        if spec.strip().lower() in ("", "0", "off", "none", "no"):
            return None
        raise ValueError(f"faults spec must be off, a FaultConfig or a FaultPlan; got {spec!r}")
    if isinstance(spec, FaultConfig):
        return FaultPlan(config=spec)
    if isinstance(spec, FaultPlan):
        return spec
    raise ValueError(f"faults spec must be off, a FaultConfig or a FaultPlan; got {spec!r}")


class FaultInjector:
    """A run's seeded fault schedule and its fault ledger. Each query
    advances a per-(kind, client) counter and draws its uniforms from
    ``SeedSequence((seed, kind, crc32(repr(client)), counter))``."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.cfg = plan.config
        self._counters: dict[tuple[int, int], int] = {}
        self._restart_done = False
        self.ledger: dict[str, Any] = {
            "crashes": 0,
            "deaths": 0,
            "crash_downtime_s": 0.0,
            "upload_failures": 0,
            "retried_uploads": 0,
            "retry_delay_s": 0.0,
            "dropped_uploads": 0,
            "dropped_clients": 0,
            "dups_injected": 0,
            "dups_absorbed": 0,
            "reorders_injected": 0,
            "stale_downlinks_absorbed": 0,
            "server_restarts": 0,
            "evicted_clients": 0,
            "reclaimed_clusters": 0,
            "poison_nan": 0,
            "poison_scale": 0,
            "poison_sign": 0,
        }

    def _draw(self, kind: int, cid: Any, n: int) -> np.ndarray:
        key = (kind, zlib.crc32(repr(cid).encode()))
        count = self._counters.get(key, 0)
        self._counters[key] = count + 1
        ss = np.random.SeedSequence(entropy=(self.cfg.seed, kind, key[1], count))
        return np.random.default_rng(ss).random(n)

    def crash(self, cid: Any) -> float | None:
        """Once a local-round start: ``None`` (no crash), ``inf`` (death) or
        the downtime in seconds."""
        cfg = self.cfg
        if cfg.crash_rate <= 0.0:
            return None
        u = self._draw(_K_CRASH, cid, 3)
        if u[0] >= cfg.crash_rate:
            return None
        self.ledger["crashes"] += 1
        if cfg.death_rate > 0.0 and u[1] < cfg.death_rate:
            self.ledger["deaths"] += 1
            return float("inf")
        downtime = float(cfg.crash_downtime * (0.5 + u[2]))
        self.ledger["crash_downtime_s"] += downtime
        return downtime

    def upload_plan(self, cid: Any) -> tuple[int, bool]:
        """Once an upload: ``(failed attempts, delivered)``, geometric in the
        loss rate and capped at ``max_retries``. Under ``retry`` the attempt
        after the last failure delivers; under ``drop`` reaching the cap
        abandons the upload and the client."""
        cfg = self.cfg
        if cfg.loss_rate <= 0.0:
            return 0, True
        u = self._draw(_K_UPLOAD, cid, max(cfg.max_retries, 1))
        fails = 0
        while fails < cfg.max_retries and u[fails] < cfg.loss_rate:
            fails += 1
        self.ledger["upload_failures"] += fails
        if fails:
            self.ledger["retried_uploads"] += 1
        if cfg.policy == "drop" and fails >= cfg.max_retries:
            self.ledger["dropped_uploads"] += 1
            return fails, False
        return fails, True

    def backoff(self, attempt: int) -> float:
        """The wait after the ``attempt``-th failure (from 0): doubling, capped."""
        return min(self.cfg.backoff_base * (2.0**attempt), self.cfg.backoff_cap)

    def duplicate(self, cid: Any) -> float | None:
        """Once a delivered upload: ``None`` or the delay after the first
        arrival at which the duplicate lands."""
        cfg = self.cfg
        if cfg.dup_rate <= 0.0:
            return None
        u = self._draw(_K_DUP, cid, 2)
        if u[0] >= cfg.dup_rate:
            return None
        self.ledger["dups_injected"] += 1
        return float(1.0 + u[1] * (cfg.dup_max_delay - 1.0))

    def reorder(self, cid: Any) -> float:
        """Once a downlink send to ``cid``: its extra delay (0.0: in order)."""
        cfg = self.cfg
        if cfg.reorder_rate <= 0.0:
            return 0.0
        u = self._draw(_K_REORDER, cid, 2)
        if u[0] >= cfg.reorder_rate:
            return 0.0
        self.ledger["reorders_injected"] += 1
        return float(1.0 + u[1] * (cfg.reorder_max_delay - 1.0))

    def poison(self, cid: Any) -> tuple[str, float] | None:
        """Once a delivered upload, before ingest: ``None`` (clean) or
        ``(kind, u)``, kind in ``nan|scale|sign`` and ``u`` a second
        uniform (the NaN offset). One uniform is split across the three
        rates, so at most one corruption applies."""
        cfg = self.cfg
        total = cfg.poison_nan_rate + cfg.poison_scale_rate + cfg.poison_sign_rate
        if total <= 0.0:
            return None
        u = self._draw(_K_POISON, cid, 2)
        if u[0] < cfg.poison_nan_rate:
            kind = "nan"
        elif u[0] < cfg.poison_nan_rate + cfg.poison_scale_rate:
            kind = "scale"
        elif u[0] < total:
            kind = "sign"
        else:
            return None
        self.ledger[f"poison_{kind}"] += 1
        return kind, float(u[1])

    def restart_due(self, uploads: int) -> bool:
        """Whether the plan's server restart is due after ``uploads`` ingested uploads (once a run)."""
        plan = self.plan.restart
        return plan is not None and not self._restart_done and uploads >= plan.at_uploads

    def mark_restarted(self) -> None:
        self._restart_done = True
        self.ledger["server_restarts"] += 1

    def ledger_snapshot(self) -> dict:
        out = dict(self.ledger)
        out["policy"] = self.cfg.policy
        out["seed"] = self.cfg.seed
        return out
