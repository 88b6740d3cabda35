"""Event-driven federated-learning simulator, asynchronous loops
(counterpart of ``repro.fl.simulator``).

Replays the paper's setup in virtual time: heterogeneous devices, an
asymmetric up/down network, and the EchoPFL strategy on an event heap,
one event at a time or, with a coalescing window, one window of events at
a time. The client side runs on the batched
:class:`~repro_torch.fl.fleet.ClientFleet`. Faults, the ingest guard,
compressed uplinks, churn and the synchronous loop are not part of this
port yet; :meth:`Simulator.run` raises for a synchronous strategy.
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
        self.coalesced_groups: dict[str, list[int]] = {}  # kind -> window group sizes
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

    def run_async(self, *, max_time: float = 3600.0, max_uploads: int | None = None) -> SimReport:
        """Event loop for an asynchronous strategy (EchoPFL): one event at a
        time, or with ``coalesce_window > 0`` one window of events at a time
        (:meth:`_run_async_coalesced`). ``max_uploads`` stops the run at that
        many ingested uploads."""
        if self.coalesce_window > 0:
            return self._run_async_coalesced(self.coalesce_window, max_time=max_time, max_uploads=max_uploads)
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
                new_params, _ = self._fleet.train_client(payload)
                self._send_upload(push, t, payload, new_params)
            elif kind == "upload_done":
                cid, params, base_version = payload
                uploads += 1
                c = self.clients[cid]
                for dl in strat.handle_upload(cid, params, base_version, c.data.n, t):
                    dur = self.net.download(model_bytes(dl.params), t)
                    push(t + dur, "downlink", dl)
                # the client starts its next local round at once
                push(t + c.compute_time(), "upload_start", cid)
                if max_uploads and uploads >= max_uploads:
                    break
            elif kind == "downlink":
                self._install(payload)

        extra = strat.stats()
        extra["uploads"] = uploads
        return self._report(t, extra)

    def _send_upload(self, push, t: float, cid, new_params: PyTree) -> None:
        """The client keeps its trained model and sends it: bill the uplink
        and schedule the arrival."""
        c = self.clients[cid]
        c.model = new_params
        dur = self.net.upload(model_bytes(new_params), t)
        push(t + dur, "upload_done", (cid, new_params, c.base_version))

    def _install(self, dl, *, row_written: bool = False) -> None:
        """A downlink's protocol state on its client (and the model in its
        fleet row, unless a batched write already put it there)."""
        c = self.clients[dl.client_id]
        if row_written:
            c.model = dl.params
        else:
            self._set_model(c, dl.params)
        c.base_version = dl.version
        c.cluster_id = dl.cluster_id
        clusters = self.strategy.clustering.clusters
        if dl.cluster_id in clusters:
            c.partial_finetune = dl.client_id in clusters[dl.cluster_id].partial_finetune

    # ------------------------------------------------- coalesced async run
    def _run_async_coalesced(self, window: float, *, max_time: float, max_uploads: int | None) -> SimReport:
        """Event-coalesced loop: the events whose virtual times fall in one
        ``window`` are popped together, bucketed by kind and processed as
        batches, in the causal order of one server tick: downlinks (one
        batched row write), finished local rounds (one batched training
        call), arrivals (one :meth:`EchoPFLServer.handle_uploads`). Each
        event keeps its own time for billing and scheduling, events in a
        bucket go in event order, and a window never crosses an evaluation,
        the horizon or the upload cap. Messages made inside a window
        deliver in a later one, when their own times pop. With one event a
        window this is the per-event loop, bit for bit. Compute times are
        drawn at collection time, in global event order, so the device RNG
        stream is the per-event loop's."""
        strat = self.strategy
        events: list = []  # (time, seq, kind, payload)

        def push(t, kind, payload):
            heapq.heappush(events, (t, next(self._counter), kind, payload))

        self._init_async_events(push)
        self.coalesced_groups = {}

        def stash(kn, pn):
            # an arrival draws its client's next compute time now, in event order
            return self.clients[pn[0]].compute_time() if kn == "upload_done" else None

        next_eval = self.eval_interval
        uploads = 0
        t = 0.0
        while events:
            t0, _, kind, payload = heapq.heappop(events)
            if t0 > max_time:
                t = max_time
                break
            t = t0
            while t >= next_eval:
                self._evaluate(next_eval)
                next_eval += self.eval_interval

            buckets: dict[str, list] = {"downlink": [], "upload_start": [], "upload_done": []}
            buckets[kind].append((t0, payload, stash(kind, payload)))
            limit = t0 + window
            cap = max_uploads - uploads if max_uploads else None
            arrivals = 1 if kind == "upload_done" else 0
            while events and (cap is None or arrivals < cap):
                tn, _, kn, pn = events[0]
                if tn >= limit or tn >= next_eval or tn > max_time:
                    break
                heapq.heappop(events)
                buckets[kn].append((tn, pn, stash(kn, pn)))
                t = tn
                arrivals += kn == "upload_done"
            for kn, group in buckets.items():
                if group:
                    self.coalesced_groups.setdefault(kn, []).append(len(group))

            if buckets["downlink"]:
                self._coalesced_downlinks(buckets["downlink"])
            if buckets["upload_start"]:
                self._coalesced_upload_starts(buckets["upload_start"], push)
            if buckets["upload_done"]:
                uploads += self._coalesced_upload_dones(buckets["upload_done"], push)
                if max_uploads and uploads >= max_uploads:
                    break

        extra = strat.stats()
        extra["uploads"] = uploads
        extra["coalesce_window"] = window
        return self._report(t, extra)

    def _coalesced_upload_starts(self, group, push) -> None:
        """One batched training call for a window's finished local rounds;
        billing and scheduling per event, in order, so the heap's sequence
        numbers match the per-event loop's push for push."""
        cids = [cid for _, cid, _ in group]
        if len(cids) > 1:
            outs, _ = self._fleet.train_rows(cids)
            trained = dict(zip(cids, outs))
        else:
            trained = {cids[0]: self._fleet.train_client(cids[0])[0]}
        for ti, cid, _ in group:
            self._send_upload(push, ti, cid, trained[cid])

    def _coalesced_upload_dones(self, group, push) -> int:
        """One batched ingest for a window's arrivals. The downlinks of one
        ingest all carry a whole model, so each run of them that shares a
        payload object is billed in one call and shipped as one batch event;
        the next local round is scheduled with the compute time drawn at
        collection."""
        strat = self.strategy
        batch = [(cid, params, bv, self.clients[cid].data.n, ti) for ti, (cid, params, bv), _ in group]
        if len(batch) > 1:
            downlinks_per = strat.handle_uploads(batch)
        else:
            downlinks_per = [strat.handle_upload(*batch[0])]
        for (ti, (cid, _, _), next_compute), dls in zip(group, downlinks_per):
            run: list = []
            run_obj, run_nb = None, 0
            for dl in dls:
                if run and dl.params is not run_obj:  # a broadcast fans out one object
                    nb = model_bytes(dl.params)
                    if nb != run_nb:
                        push(ti + self.net.download_bulk(run_nb, len(run), ti), "downlink", run)
                        run = []
                    run_obj, run_nb = dl.params, nb
                elif not run:
                    run_obj, run_nb = dl.params, model_bytes(dl.params)
                run.append(dl)
            if run:
                push(ti + self.net.download_bulk(run_nb, len(run), ti), "downlink", run)
            push(ti + next_compute, "upload_start", cid)
        return len(batch)

    def _coalesced_downlinks(self, group) -> None:
        """A window's downlinks (single :class:`Downlink`s or whole fan-out
        batches): the fleet's model rows in one write, each client's protocol
        state in delivery order."""
        flat: list = []
        for _, payload, _ in group:
            flat.extend(payload) if isinstance(payload, list) else flat.append(payload)
        batched = len(flat) > 1
        if batched:
            self._fleet.set_models([dl.client_id for dl in flat], [dl.params for dl in flat])
        for dl in flat:
            self._install(dl, row_written=batched)

    def run(self, *, max_time: float = 3600.0, max_uploads: int | None = None) -> SimReport:
        if getattr(self.strategy, "is_synchronous", False):
            raise NotImplementedError("repro_torch: synchronous strategies are not ported yet")
        return self.run_async(max_time=max_time, max_uploads=max_uploads)
