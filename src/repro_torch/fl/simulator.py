"""Event-driven federated-learning simulator, per-event asynchronous loop
(counterpart of ``repro.fl.simulator``).

Replays the paper's setup in virtual time: heterogeneous devices, an
asymmetric up/down network, and the EchoPFL strategy on an event heap. The
client side runs on the batched :class:`~repro_torch.fl.fleet.ClientFleet`.
Faults, the ingest guard, compressed uplinks, churn, coalescing windows and
the synchronous loop are not part of this port yet; :meth:`Simulator.run`
raises for them.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any

import numpy as np

from repro_torch.common.pytrees import tree_leaves
from repro_torch.core.client import SimClient
from repro_torch.fl.network import NetworkModel

PyTree = Any


@dataclasses.dataclass
class SimReport:
    strategy: str
    curve: list[tuple[float, float]]  # (t, mean acc)
    per_client_acc: dict[int, float]
    per_client_class: dict[int, str]
    final_acc: float
    time_to_target: float | None
    up_bytes: int
    down_bytes: int
    up_events: int
    down_events: int
    peak_down: float
    peak_up: float
    duration: float
    extra: dict
    up_series: dict = dataclasses.field(default_factory=dict)  # minute -> bytes
    down_series: dict = dataclasses.field(default_factory=dict)
    up_raw_bytes: int = 0
    up_retry_bytes: int = 0


def model_bytes(params: PyTree) -> int:
    """Wire size of one model payload: sum of per-leaf bytes (leaf dtype
    honored; non-array leaves count as 4-byte words) — the reference's count."""
    total = 0
    for x in tree_leaves(params):
        shape = getattr(x, "shape", ())
        itemsize = x.element_size() if hasattr(x, "element_size") else getattr(
            getattr(x, "dtype", None), "itemsize", 4
        )
        total += int(np.prod(tuple(shape))) * itemsize
    return total


class Simulator:
    def __init__(
        self,
        clients: list[SimClient],
        strategy,
        *,
        network: NetworkModel | None = None,
        eval_interval: float = 60.0,
        target_acc: float = 0.85,
        seed: int = 0,
        coalesce_window: float = 0.0,
    ):
        self.clients = {c.client_id: c for c in clients}
        self.strategy = strategy
        self.net = network or NetworkModel()
        self.eval_interval = eval_interval
        self.target_acc = target_acc
        self.rng = np.random.default_rng(seed)
        self.curve: list[tuple[float, float]] = []
        self._counter = itertools.count()
        self.coalesce_window = float(coalesce_window)
        self._fleet = None  # built lazily from the first initial model
        self._last_accs: dict = {}

    # -------------------------------------------------------- fleet engine
    def _ensure_fleet(self, template: PyTree) -> None:
        """Build the batched client engine once the model structure is
        known and hand the strategy its batched feedback probe (replacing a
        hook a previous simulator's fleet installed)."""
        strat = self.strategy
        if self._fleet is None:
            from repro_torch.fl.fleet import ClientFleet

            device = tree_leaves(template)[0].device
            self._fleet = ClientFleet(list(self.clients.values()), template, device=device)
        current = getattr(strat, "feedback_batch_fn", "missing")
        if current == "missing":
            return
        fleet_hook = current is not None and getattr(current, "_fleet_hook", False)
        if current is None or (fleet_hook and getattr(current, "_fleet", None) is not self._fleet):
            fleet = self._fleet

            def hook(pairs):
                return fleet.feedback_many(pairs)

            hook._fleet_hook = True
            hook._fleet = fleet
            strat.feedback_batch_fn = hook

    def _set_model(self, c: SimClient, params: PyTree) -> None:
        """Install a downlinked model on a client (mirrored into its fleet row)."""
        c.model = params
        if self._fleet is not None:
            self._fleet.set_model(c.client_id, params)

    # ----------------------------------------------------------- evaluation
    def _evaluate(self, t: float) -> float:
        params = [self.strategy.model_for(cid) for cid in self._fleet.ids]
        fleet_accs = self._fleet.evaluate_fleet(params)
        accs = {cid: float(a) for cid, a in zip(self._fleet.ids, fleet_accs)}
        mean = float(np.mean(list(accs.values())))
        self.curve.append((t, mean))
        self._last_accs = accs
        return mean

    def _report(self, t_end: float, extra: dict) -> SimReport:
        self._evaluate(t_end)
        target_t = None
        for t, acc in self.curve:
            if acc >= self.target_acc:
                target_t = t
                break
        return SimReport(
            strategy=self.strategy.name,
            curve=self.curve,
            per_client_acc=self._last_accs,
            per_client_class={cid: c.device_class for cid, c in self.clients.items()},
            final_acc=self.curve[-1][1],
            time_to_target=target_t,
            up_bytes=self.net.up_bytes,
            down_bytes=self.net.down_bytes,
            up_events=self.net.up_events,
            down_events=self.net.down_events,
            peak_down=self.net.peak("down"),
            peak_up=self.net.peak("up"),
            duration=t_end,
            extra=extra,
            up_series=self.net.series("up"),
            down_series=self.net.series("down"),
            up_raw_bytes=self.net.up_raw_bytes,
            up_retry_bytes=self.net.up_retry_bytes,
        )

    # ------------------------------------------------------------ async run
    def _init_async_events(self, push) -> None:
        """Initial broadcast of the seed model + the first local rounds."""
        strat = self.strategy
        init = strat.initial_models(sorted(self.clients))
        nbytes = model_bytes(next(iter(init.values())))
        self._ensure_fleet(next(iter(init.values())))
        for cid, params in init.items():
            dl = self.net.download(nbytes, 0.0)
            c = self.clients[cid]
            self._set_model(c, params)
            c.base_version = 0
            push(dl + c.compute_time(), "upload_start", cid)

    def run_async(self, *, max_time: float = 3600.0) -> SimReport:
        """Per-event loop for an asynchronous strategy (EchoPFL)."""
        if self.coalesce_window > 0:
            raise NotImplementedError("repro_torch: coalescing windows are not ported yet")
        strat = self.strategy
        events: list = []  # (time, seq, kind, payload)

        def push(t, kind, payload):
            heapq.heappush(events, (t, next(self._counter), kind, payload))

        self._init_async_events(push)
        next_eval = self.eval_interval
        uploads = 0
        t = 0.0
        while events:
            t, _, kind, payload = heapq.heappop(events)
            if t > max_time:
                t = max_time
                break
            while t >= next_eval:
                self._evaluate(next_eval)
                next_eval += self.eval_interval

            if kind == "upload_start":  # local training finished; uplink begins
                cid = payload
                c = self.clients[cid]
                new_params, _ = self._fleet.train_client(cid)
                c.model = new_params
                nbytes = model_bytes(new_params)
                dur = self.net.upload(nbytes, t)
                push(t + dur, "upload_done", (cid, new_params, c.base_version))
            elif kind == "upload_done":
                cid, params, base_version = payload
                uploads += 1
                c = self.clients[cid]
                for dl in strat.handle_upload(cid, params, base_version, c.data.n, t):
                    dur = self.net.download(model_bytes(dl.params), t)
                    push(t + dur, "downlink", dl)
                # the client starts its next local round at once
                push(t + c.compute_time(), "upload_start", cid)
            elif kind == "downlink":
                dl = payload
                c = self.clients[dl.client_id]
                self._set_model(c, dl.params)
                c.base_version = dl.version
                c.cluster_id = dl.cluster_id
                if dl.cluster_id in strat.clustering.clusters:
                    c.partial_finetune = (
                        dl.client_id in strat.clustering.clusters[dl.cluster_id].partial_finetune
                    )

        extra = strat.stats()
        extra["uploads"] = uploads
        return self._report(t, extra)

    def run(self, *, max_time: float = 3600.0) -> SimReport:
        if getattr(self.strategy, "is_synchronous", False):
            raise NotImplementedError("repro_torch: synchronous strategies are not ported yet")
        return self.run_async(max_time=max_time)
