"""Event-driven federated-learning simulator (counterpart of
``repro.fl.simulator``).

Replays the paper's setup in virtual time: heterogeneous devices, an
asymmetric up/down network, and a coordination strategy — EchoPFL or one
of the baselines. Asynchronous strategies (EchoPFL, FedAsyn, FedSEA with
its periodic ticks) run on an event heap, one event at a time or, with a
coalescing window, one window of events at a time; synchronous ones
(FedAvg, Oort, ClusterFL with per-cluster barriers, Standalone) run round
barriers. The client side runs on the batched
:class:`~repro_torch.fl.fleet.ClientFleet` (``client_backend="fleet"``, the
default) or, with ``client_backend="loop"``, one client at a time through
:class:`~repro_torch.core.client.SimClient` (``local_train``,
``evaluate``; the strategy's own ``feedback_fn`` probes), as the
reference's loop backend does. With ``uplink=`` the uploads
are compressed (:mod:`repro_torch.fl.uplink`): the server ingests each
upload's reconstruction and the network bills its payload's exact size,
while the client keeps its own trained model.

The two asynchronous loops take churn, faults and the ingest guard, as the
reference's do (its synchronous loop has none of them): ``churn=`` static
offline windows a client, ``faults=`` a seeded
:class:`~repro_torch.fl.faults.FaultPlan` (crashes and deaths, lost,
retried and dropped uploads, duplicates, reordered downlinks, value
poison), ``guard=`` an :class:`~repro_torch.fl.guard.IngestGuard` config
that scores every delivered upload before the strategy sees it. ``None``
is off for each, and then no fault or guard code runs. A plan's server
restart (:class:`~repro_torch.fl.faults.ServerRestartPlan`) kills the
strategy between two events, or two windows, once its upload count is
reached, and a fresh one restored from a crash-safe checkpoint finishes the
run with the uninterrupted run's ledger.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import os
from typing import Any

import numpy as np

from repro_torch.common.pytrees import tree_leaves
from repro_torch.core.client import SimClient
from repro_torch.fl.faults import FaultInjector, apply_poison, resolve_faults
from repro_torch.fl.guard import IngestGuard, resolve_guard
from repro_torch.fl.network import NetworkModel
from repro_torch.fl.uplink import UplinkCodec, resolve_uplink

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

    def bytes_until(self, t: float) -> tuple[float, float]:
        """(up, down) bytes in the series' bins up to time t (the paper's
        communication-to-convergence metric)."""
        last = int(t // 60)
        up = sum(v for b, v in self.up_series.items() if b <= last)
        down = sum(v for b, v in self.down_series.items() if b <= last)
        return up, down

    def summary(self) -> dict:
        out = {
            "strategy": self.strategy,
            "final_acc": round(self.final_acc, 4),
            "time_to_target_min": None if self.time_to_target is None else round(self.time_to_target / 60, 2),
            "duration_min": round(self.duration / 60, 2),
            "up_MB": round(self.up_bytes / 1e6, 2),
            "down_MB": round(self.down_bytes / 1e6, 2),
            "total_MB": round((self.up_bytes + self.down_bytes) / 1e6, 2),
            "peak_down_MB_per_min": round(self.peak_down / 1e6, 2),
            "peak_up_MB_per_min": round(self.peak_up / 1e6, 2),
        }
        if self.up_raw_bytes and self.up_raw_bytes != self.up_bytes:
            out["up_raw_MB"] = round(self.up_raw_bytes / 1e6, 2)
            out["uplink_ratio"] = round(self.up_bytes / self.up_raw_bytes, 4)
        if self.up_retry_bytes:
            out["up_retry_MB"] = round(self.up_retry_bytes / 1e6, 2)
        return out


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
        uplink: Any = None,
        churn: dict[Any, list[tuple[float, float]]] | None = None,
        faults: Any = None,
        guard: Any = None,
        fleet_mesh=None,
        client_backend: str = "fleet",
    ):
        self.clients = {c.client_id: c for c in clients}
        self.client_backend = str(client_backend).lower()
        if self.client_backend not in ("loop", "fleet"):
            raise ValueError(f"client backend must be loop|fleet, got {self.client_backend}")
        self.fleet_mesh = fleet_mesh  # the client fleet's PlaneMesh (None: one device)
        self.strategy = strategy
        self.net = network or NetworkModel()
        # uplink compression: the config now, the codec with the fleet (it needs the model template)
        self.uplink = resolve_uplink(uplink)
        self._codec: UplinkCodec | None = None
        self.eval_interval = eval_interval
        self.target_acc = target_acc
        self.rng = np.random.default_rng(seed)
        self.curve: list[tuple[float, float]] = []
        self._counter = itertools.count()
        self.coalesce_window = float(coalesce_window)
        self.coalesced_groups: dict[str, list[int]] = {}  # kind -> window group sizes
        self._fleet = None  # built lazily from the first initial model
        self._last_accs: dict = {}
        # elastic membership: {client: [(t_offline, t_back), ...]}; a device
        # whose local round would start inside a window resumes when it is back
        self.churn = churn or {}
        self.churn_delays = 0
        plan = resolve_faults(faults)
        self._faults = FaultInjector(plan) if plan is not None else None
        gcfg = resolve_guard(guard)
        self._guard = IngestGuard(gcfg) if gcfg is not None else None
        self._dead: set = set()  # clients gone dark for good (death, the drop policy, the guard)
        self._useq: dict[Any, int] = {}  # a client's upload send sequence
        self._ingest_high: dict[Any, int] = {}  # the highest sequence ingested (the duplicate fence)
        self._dl_seq: dict[Any, int] = {}  # a recipient's downlink send sequence
        self._dl_high: dict[Any, int] = {}  # the highest sequence installed (the reorder fence)
        self._template = None  # the model template, for rewiring a restored strategy

    def _next_online(self, cid, t: float) -> float:
        """When a local round that finishes at ``t`` can upload: static churn
        windows first, then an injected crash (the round's work is lost and
        the device resumes after its downtime; ``inf`` is a death)."""
        for t_off, t_on in self.churn.get(cid, ()):
            if t_off <= t < t_on:
                self.churn_delays += 1
                return t_on
        if self._faults is not None:
            down = self._faults.crash(cid)
            if down is not None:
                if down == math.inf:
                    return math.inf
                self.churn_delays += 1
                return t + down
        return t

    # -------------------------------------------------------- fleet engine
    def _ensure_fleet(self, template: PyTree) -> None:
        """Build the uplink codec when the run compresses (a strategy that
        takes it adopts it; both backends compress, the loop one upload at a
        time), and on the fleet backend the batched client engine once the
        model structure is known, handing the strategy its batched feedback
        probe (replacing a hook a previous simulator's fleet installed). On
        the loop backend a fleet's hook left on a reused strategy is cleared,
        so its probes go through ``feedback_fn``."""
        strat = self.strategy
        self._template = template
        device = tree_leaves(template)[0].device
        if self._fleet is None and self.client_backend == "fleet":
            from repro_torch.fl.fleet import ClientFleet

            self._fleet = ClientFleet(list(self.clients.values()), template, device=device, mesh=self.fleet_mesh)
        if self.uplink.mode != "none":
            if self._codec is None:
                self._codec = UplinkCodec(template, list(self.clients), self.uplink, device=device)
            attach = getattr(strat, "attach_uplink_codec", None)
            if attach is not None and getattr(strat, "uplink_codec", None) is not self._codec:
                attach(self._codec)
        if self._guard is not None:
            attach_g = getattr(strat, "attach_guard", None)
            if attach_g is not None and getattr(strat, "guard", None) is not self._guard:
                attach_g(self._guard)
        current = getattr(strat, "feedback_batch_fn", "missing")
        if current == "missing":
            return
        fleet_hook = current is not None and getattr(current, "_fleet_hook", False)
        if self._fleet is None:
            if fleet_hook:
                strat.feedback_batch_fn = None
            return
        if current is None or (fleet_hook and getattr(current, "_fleet", None) is not self._fleet):
            fleet = self._fleet

            def hook(pairs):
                return fleet.feedback_many(pairs)

            hook._fleet_hook = True
            hook._fleet = fleet
            strat.feedback_batch_fn = hook

    def _server_kill_restore(self) -> None:
        """Kill the live strategy and restore a fresh one from a checkpoint
        written through the crash-safe checkpointer. The old object is
        dropped, so all the continuation needs comes back through
        ``state_dict`` and ``load_state``; a strategy without them fails
        here. The restore is rewired as a run start would be: the codec (its
        section replayed), the guard (empty snapshot rings) and the fleet's
        feedback probe."""
        from repro_torch.checkpoint import Checkpointer, latest_step, restore_pytree

        inj = self._faults
        plan = inj.plan.restart
        cl = getattr(self.strategy, "clustering", None)
        if cl is not None and cl._pending is not None:
            # a restart falls between events or windows: no ingest is half done
            raise RuntimeError("server restart inside an ingest: the assign-time cache is live")
        tree, meta = self.strategy.state_dict()
        ck = Checkpointer(plan.directory, keep=2)
        try:
            ck.save(inj.ledger["server_restarts"], tree, extra=meta)
        finally:
            ck.close()
        fresh = plan.strategy_factory()
        path = os.path.join(plan.directory, f"step_{latest_step(plan.directory):010d}")
        raw_meta = restore_pytree(path)[1]
        tree_r, meta_r = restore_pytree(path, like=fresh.state_template(raw_meta))
        fresh.load_state(tree_r, meta_r, client_id_type=plan.client_id_type)
        self.strategy = fresh
        if self._template is not None:
            self._ensure_fleet(self._template)
        inj.mark_restarted()

    def _set_model(self, c: SimClient, params: PyTree) -> None:
        """Install a downlinked model on a client (mirrored into its fleet
        row, and into its uplink anchor: both sides know what was sent)."""
        c.model = params
        if self._codec is not None:
            self._codec.install(c.client_id, params)
        if self._fleet is not None:
            self._fleet.set_model(c.client_id, params)

    # ----------------------------------------------------------- evaluation
    def _evaluate(self, t: float) -> float:
        # a client gone dark for good was evicted by the server: it scores
        # with the last model it installed
        if self._fleet is not None:
            params = [self.clients[cid].model if cid in self._dead else self.strategy.model_for(cid)
                      for cid in self._fleet.ids]
            fleet_accs = self._fleet.evaluate_fleet(params)
            accs = {cid: float(a) for cid, a in zip(self._fleet.ids, fleet_accs)}
        else:
            accs = {}
            for cid, c in self.clients.items():
                params = c.model if cid in self._dead else self.strategy.model_for(cid)
                accs[cid] = c.evaluate(params if params is not None else c.model)
        mean = float(np.mean(list(accs.values())))
        self.curve.append((t, mean))
        self._last_accs = accs
        return mean

    def _report(self, t_end: float, extra: dict) -> SimReport:
        if self._codec is not None:
            extra["uplink"] = {"mode": self._codec.mode, "payload_bytes": self._codec.nbytes,
                               "launches": self._codec.launches}
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
        """Initial broadcast of the seed model, the first local rounds and
        the strategy's first tick (FedSEA's synchronization points)."""
        strat = self.strategy
        init = strat.initial_models(sorted(self.clients))
        nbytes = model_bytes(next(iter(init.values())))
        self._ensure_fleet(next(iter(init.values())))
        if self._codec is not None:
            self._codec.seed(init)  # both sides saw this broadcast: the first anchors
        for cid, params in init.items():
            dl = self.net.download(nbytes, 0.0)
            c = self.clients[cid]
            self._set_model(c, params)
            c.base_version = 0
            push(dl + c.compute_time(), "upload_start", cid)
        if getattr(strat, "tick_interval", None):
            push(strat.tick_interval, "tick", None)

    def run_async(self, *, max_time: float = 3600.0, max_uploads: int | None = None) -> SimReport:
        """Event loop for an asynchronous strategy (EchoPFL, FedAsyn,
        FedSEA): one event at a time, or with ``coalesce_window > 0`` one
        window of events at a time (:meth:`_run_async_coalesced`).
        ``max_uploads`` stops the run at that many ingested uploads."""
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
            if self._faults is not None and self._faults.restart_due(uploads):
                self._server_kill_restore()
                strat = self.strategy
            t, _, kind, payload = heapq.heappop(events)
            if t > max_time:
                t = max_time
                break
            while t >= next_eval:
                self._evaluate(next_eval)
                next_eval += self.eval_interval

            if kind == "upload_start":  # local training finished; uplink begins
                cid = payload
                t_on = self._next_online(cid, t)
                if t_on == math.inf:  # the crash was fatal: the device never returns
                    self._retire_client(cid, "death")
                    continue
                if t_on > t:  # offline: the round restarts when the device is back
                    push(t_on + self.clients[cid].compute_time(), "upload_start", cid)
                    continue
                new_params = self._train_one(cid)
                self.clients[cid].model = new_params
                self._send_upload(push, t, cid, *self._encode_upload(cid, new_params))
            elif kind == "upload_done":
                cid, params, base_version, useq = payload
                if self._faults is not None:
                    # the duplicate fence: a copy (or anything older than what landed) is absorbed
                    if useq <= self._ingest_high.get(cid, -1):
                        self._faults.ledger["dups_absorbed"] += 1
                        continue
                    self._ingest_high[cid] = useq
                if self._guard is not None and self._guard_check(cid, params) != "accept":
                    # rejected: the strategy never sees it; the client trains
                    # on from its own model, unless it is evicted
                    if self._guard.should_evict(cid):
                        self._retire_client(cid, "guard")
                    else:
                        push(t + self.clients[cid].compute_time(), "upload_start", cid)
                    continue
                uploads += 1
                c = self.clients[cid]
                for dl in strat.handle_upload(cid, params, base_version, c.data.n, t):
                    dur = self.net.download(model_bytes(dl.params), t)
                    self._push_downlink(push, t, dl, dur)
                # the client starts its next local round at once
                push(t + c.compute_time(), "upload_start", cid)
                if max_uploads and uploads >= max_uploads:
                    break
            elif kind == "downlink":
                if not self._reorder_fenced(payload):
                    self._install(payload)
            elif kind == "tick":  # the strategy's periodic hook (FedSEA's synchronization points)
                self._tick(push, t)

        extra = strat.stats() if hasattr(strat, "stats") else {}
        extra["uploads"] = uploads
        return self._report(t, self._chaos_extra(extra))

    def _train_one(self, cid) -> PyTree:
        """One client's local round from its installed model: its fleet row
        (written back) on the fleet backend, else ``SimClient.local_train``."""
        if self._fleet is not None:
            return self._fleet.train_client(cid)[0]
        return self.clients[cid].local_train()[0]

    def _chaos_extra(self, extra: dict) -> dict:
        """The report's churn, fault and guard entries (each only when on)."""
        if self.churn:
            extra["churn_delays"] = self.churn_delays
        if self._faults is not None:
            extra["faults"] = self._faults.ledger_snapshot()
        if self._guard is not None:
            extra["guard"] = self._guard.ledger_snapshot()
        return extra

    def _tick(self, push, t: float) -> None:
        """A strategy tick: bill and ship its downlinks one by one, then
        schedule the next tick."""
        strat = self.strategy
        for dl in strat.on_tick(t):
            self._push_downlink(push, t, dl, self.net.download(model_bytes(dl.params), t))
        if strat.tick_interval:
            push(t + strat.tick_interval, "tick", None)

    def _billing(self, params: PyTree) -> tuple[int, int | None]:
        """The wire bytes of one upload of ``params`` and, under a codec,
        its dense size (else None)."""
        raw = model_bytes(params)
        return (raw, None) if self._codec is None else (self._codec.nbytes, raw)

    def _encode_upload(self, cid, new_params: PyTree) -> tuple[PyTree, int, int | None]:
        """One trained model through the uplink codec: what the server
        ingests (the reconstruction, or with no codec the model itself) and
        its billing."""
        up = new_params if self._codec is None else self._codec.encode(cid, new_params)[0]
        return (up, *self._billing(new_params))

    def _send_upload(self, push, t: float, cid, up_params: PyTree, nbytes: int, raw: int | None) -> None:
        """Bill one upload of ``nbytes`` on the wire (``raw``: its dense
        size, under a codec) and schedule its arrival, with the client's send
        sequence (the ingest fences on it). Under faults: retries and their
        backoff, the drop policy's give-up (the client leaves), value poison
        and a duplicate delivery, which bills the bytes again."""
        base_version = self.clients[cid].base_version
        if self._faults is None:
            dur = self.net.upload(nbytes, t, raw_nbytes=raw)
            push(t + dur, "upload_done", (cid, up_params, base_version, 0))
            return
        delay, delivered = self._upload_with_faults(cid, nbytes, raw, t)
        if not delivered:  # the drop policy hit the retry cap: the straggler leaves
            self._retire_client(cid, "dropped")
            return
        pz = self._faults.poison(cid)
        if pz is not None:  # the bytes crossed fine, the values arrive corrupt (the copy too)
            up_params = apply_poison(up_params, pz[0], pz[1], self._faults.cfg)
        useq = self._useq[cid] = self._useq.get(cid, 0) + 1
        push(t + delay, "upload_done", (cid, up_params, base_version, useq))
        dup = self._faults.duplicate(cid)
        if dup is not None:  # a retransmission: real bytes cross the link again
            self.net.upload(nbytes, t, raw_nbytes=raw, retry=True)
            push(t + delay + dup, "upload_done", (cid, up_params, base_version, useq))

    def _upload_with_faults(self, cid, nbytes: int, raw: int | None, t: float) -> tuple[float, bool]:
        """Bill one upload with its lost attempts: each failed attempt sends
        the full payload (retry bytes past the first send) and waits a
        capped exponential backoff. Returns ``(delay to arrival, delivered)``;
        the delay shows up in the staleness the server records."""
        inj = self._faults
        fails, delivered = inj.upload_plan(cid)
        delay = 0.0
        for i in range(fails):
            delay += self.net.upload(nbytes, t + delay, raw_nbytes=raw, retry=i > 0)
            delay += inj.backoff(i)
        if not delivered:
            return delay, False
        dur = self.net.upload(nbytes, t + delay, raw_nbytes=raw, retry=fails > 0)
        if fails:
            inj.ledger["retry_delay_s"] += delay
        return delay + dur, True

    def _push_downlink(self, push, t_send: float, dl, dur: float) -> None:
        """Schedule one downlink; under faults with the recipient's send
        sequence (the install fences on it) and a possible reorder delay."""
        if self._faults is None:
            push(t_send + dur, "downlink", dl)
            return
        dl._fseq = self._dl_seq[dl.client_id] = self._dl_seq.get(dl.client_id, -1) + 1
        push(t_send + dur + self._faults.reorder(dl.client_id), "downlink", dl)

    def _reorder_fenced(self, dl) -> bool:
        """Under faults, whether a downlink was overtaken by a newer send to
        its client (absorbed, so a stale model never overwrites a newer one);
        else it raises the fence."""
        if self._faults is None:
            return False
        if dl._fseq < self._dl_high.get(dl.client_id, -1):
            self._faults.ledger["stale_downlinks_absorbed"] += 1
            return True
        self._dl_high[dl.client_id] = dl._fseq
        return False

    def _guard_check(self, cid, params) -> str:
        """Score one delivered upload against the guard before the strategy
        sees it: against the client's home cluster and its center (key -1
        and no center before its first assignment)."""
        cl = getattr(self.strategy, "clustering", None)
        home = cl.assignment.get(cid) if cl is not None else None
        if home is not None and home in cl.clusters:
            key, center = home, cl.clusters[home].center
        else:
            key, center = -1, None
        finite, l2, dist = self._guard.upload_stats(params, center)
        return self._guard.check_upload(cid, key, finite, l2, dist)

    def _retire_client(self, cid, kind: str) -> None:
        """Take a client gone dark for good out of the run: the server evicts
        it (its rows freed, an emptied cluster reclaimed) and the loops stop
        scheduling it; it keeps its last model for evaluation."""
        if cid in self._dead:
            return
        self._dead.add(cid)
        led = self._faults.ledger if self._faults is not None else None  # the guard retires without faults too
        if led is not None and kind == "dropped":
            led["dropped_clients"] += 1
        evict = getattr(self.strategy, "evict_clients", None)
        if evict is not None:
            res = evict([cid])
            if led is not None:
                led["evicted_clients"] += len(res["evicted"])
                led["reclaimed_clusters"] += len(res["reclaimed"])

    def _install(self, dl, *, row_written: bool = False) -> None:
        """A downlink's protocol state on its client (and the model in its
        fleet row, unless a batched write already put it there; the uplink
        anchor either way)."""
        c = self.clients[dl.client_id]
        if row_written:
            c.model = dl.params
            if self._codec is not None:
                self._codec.install(dl.client_id, dl.params)
        else:
            self._set_model(c, dl.params)
        c.base_version = dl.version
        c.cluster_id = dl.cluster_id
        clustering = getattr(self.strategy, "clustering", None)
        if clustering is not None and dl.cluster_id in clustering.clusters:
            c.partial_finetune = dl.client_id in clustering.clusters[dl.cluster_id].partial_finetune

    # ------------------------------------------------- coalesced async run
    def _run_async_coalesced(self, window: float, *, max_time: float, max_uploads: int | None) -> SimReport:
        """Event-coalesced loop: the events whose virtual times fall in one
        ``window`` are popped together, bucketed by kind and processed as
        batches, in the causal order of one server tick: downlinks (one
        batched row write), finished local rounds (one batched training
        call), arrivals (one :meth:`EchoPFLServer.handle_uploads`). Each
        event keeps its own time for billing and scheduling, events in a
        bucket go in event order, and a window never crosses an evaluation,
        a strategy tick (handled alone), the horizon or the upload cap.
        Messages made inside a window deliver in a later one, when their own
        times pop. With one event a window this is the per-event loop, bit
        for bit. Compute times are drawn at collection time, in global event
        order, as the reference draws them; an arrival made inside its own
        window draws in the next one, after the window's later arrivals, so
        there the device RNG stream and the virtual times differ from the
        per-event loop's, in the reference as here. Churn and crashes, the
        duplicate fence and the guard's verdicts are settled at collection
        time too, in that same order."""
        strat = self.strategy
        events: list = []  # (time, seq, kind, payload)

        def push(t, kind, payload):
            heapq.heappush(events, (t, next(self._counter), kind, payload))

        self._init_async_events(push)
        self.coalesced_groups = {}

        def stash(tn, kn, pn):
            """What an event draws, at collection time in global event order:
            a finished round its churn or crash (``None``: it uploads now,
            ``inf``: the device died, else the time it restarts, its compute
            time drawn now); an arrival its next compute time (a float), or
            ``"dup"`` (fenced, draws nothing), ``"evicted"`` (the guard
            retired it, draws nothing) or ``("rejected", compute time)``."""
            if kn == "upload_start":
                t_on = self._next_online(pn, tn)
                if t_on == math.inf:  # a fatal crash: no restart, no draw
                    return math.inf
                if t_on > tn:  # offline: the round restarts when the device is back
                    return t_on + self.clients[pn].compute_time()
                return None
            if kn == "upload_done":
                if self._faults is not None:
                    if pn[3] <= self._ingest_high.get(pn[0], -1):
                        self._faults.ledger["dups_absorbed"] += 1
                        return "dup"
                    self._ingest_high[pn[0]] = pn[3]
                if self._guard is not None and self._guard_check(pn[0], pn[1]) != "accept":
                    if self._guard.should_evict(pn[0]):
                        self._retire_client(pn[0], "guard")
                        return "evicted"
                    return ("rejected", self.clients[pn[0]].compute_time())
                return self.clients[pn[0]].compute_time()
            return None

        next_eval = self.eval_interval
        uploads = 0
        t = 0.0
        while events:
            if self._faults is not None and self._faults.restart_due(uploads):
                self._server_kill_restore()
                strat = self.strategy
            t0, _, kind, payload = heapq.heappop(events)
            if t0 > max_time:
                t = max_time
                break
            t = t0
            while t >= next_eval:
                self._evaluate(next_eval)
                next_eval += self.eval_interval
            if kind == "tick":
                self._tick(push, t)
                continue

            buckets: dict[str, list] = {"downlink": [], "upload_start": [], "upload_done": []}
            s0 = stash(t0, kind, payload)
            buckets[kind].append((t0, payload, s0))
            limit = t0 + window
            cap = max_uploads - uploads if max_uploads else None
            # the cap counts arrivals that will ingest: a float compute time
            arrivals = 1 if kind == "upload_done" and isinstance(s0, float) else 0
            while events and (cap is None or arrivals < cap):
                tn, _, kn, pn = events[0]
                if kn == "tick" or tn >= limit or tn >= next_eval or tn > max_time:
                    break
                heapq.heappop(events)
                sn = stash(tn, kn, pn)
                buckets[kn].append((tn, pn, sn))
                t = tn
                arrivals += kn == "upload_done" and isinstance(sn, float)
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

        extra = strat.stats() if hasattr(strat, "stats") else {}
        extra["uploads"] = uploads
        extra["coalesce_window"] = window
        return self._report(t, self._chaos_extra(extra))

    def _coalesced_upload_starts(self, group, push) -> None:
        """One batched training call for a window's finished local rounds
        whose devices are online (churn settled at collection), and under a
        codec one encode of the trained matrix; a death retires its client,
        an offline device's restart is scheduled; billing and scheduling per
        event, in order, so the heap's sequence numbers match the per-event
        loop's push for push."""
        ready = [cid for _, cid, resume in group if resume is None]
        trained: dict[Any, Any] = {}
        sent: dict[Any, Any] = {}
        if self._fleet is not None and len(ready) > 1:
            outs, _, vecs = self._fleet.train_rows(ready)
            trained = dict(zip(ready, outs))
            sent = trained if self._codec is None else dict(zip(ready, self._codec.encode_rows(ready, vecs)[0]))
        for ti, cid, resume in group:
            if resume == math.inf:  # a fatal crash: the device never returns
                self._retire_client(cid, "death")
                continue
            if resume is not None:  # offline: the round restarts when the device is back
                push(resume, "upload_start", cid)
                continue
            if cid in trained:
                new_params, up = trained[cid], sent[cid]
            else:
                new_params = self._train_one(cid)
                up = self._encode_upload(cid, new_params)[0]
            self.clients[cid].model = new_params
            self._send_upload(push, ti, cid, up, *self._billing(new_params))

    def _coalesced_upload_dones(self, group, push) -> int:
        """One batched ingest for a window's arrivals (``handle_uploads``
        where the strategy has it, else one ``handle_upload`` an arrival, in
        order). The downlinks of one ingest all carry a whole model, so each run of them that shares a
        payload object is billed in one call and shipped as one batch event
        (under faults each one on its own, with its send sequence); the next
        local round is scheduled with the compute time drawn at collection.
        Returns the arrivals ingested."""
        strat = self.strategy
        # fenced duplicates and the guard's rejects never reach the server: a
        # rejected client's next round is scheduled, a duplicate or an
        # evicted client schedules nothing
        live = [e for e in group if isinstance(e[2], float)]
        batch = [(cid, params, bv, self.clients[cid].data.n, ti) for ti, (cid, params, bv, _), _ in live]
        if len(batch) > 1 and hasattr(strat, "handle_uploads"):
            downlinks_per = strat.handle_uploads(batch)
        else:
            downlinks_per = [strat.handle_upload(*b) for b in batch]
        dls_iter = iter(downlinks_per)
        for ti, (cid, _, _, _), sn in group:
            if sn == "dup" or sn == "evicted":
                continue
            if isinstance(sn, tuple):  # rejected by the guard: only its next round
                push(ti + sn[1], "upload_start", cid)
                continue
            next_compute, dls = sn, next(dls_iter)
            if self._faults is not None:
                # one by one, so send sequences and reorder delays land as in
                # the per-event loop (the bytes and events are the bulk's)
                for dl in dls:
                    self._push_downlink(push, ti, dl, self.net.download(model_bytes(dl.params), ti))
                push(ti + next_compute, "upload_start", cid)
                continue
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
        # the reorder fence, in delivery order, before the batched row write:
        # a stale delivery must not reach the model rows at all
        flat = [dl for dl in flat if not self._reorder_fenced(dl)]
        if not flat:
            return
        batched = self._fleet is not None and len(flat) > 1
        if batched:
            self._fleet.set_models([dl.client_id for dl in flat], [dl.params for dl in flat])
        for dl in flat:
            self._install(dl, row_written=batched)

    # ------------------------------------------------------------- sync run
    def run_sync(self, *, rounds: int = 50, max_time: float | None = None) -> SimReport:
        """Round-barrier loop for a synchronous strategy (FedAvg, Oort,
        ClusterFL with per-cluster barriers, Standalone). Each group's cohort
        trains in one :meth:`ClientFleet.train_cohort` call; compute-time
        draws, billing and installs go per client in cohort order, as in the
        reference. Under a codec a cohort's uploads are one encode."""
        strat = self.strategy
        init = strat.initial_models(sorted(self.clients))
        nbytes = model_bytes(next(iter(init.values())))
        self._ensure_fleet(next(iter(init.values())))
        t = 0.0
        if self._codec is not None:
            self._codec.seed(init)
        for cid, params in init.items():
            self._set_model(self.clients[cid], params)
        t += nbytes / self.net.downstream_bps
        self.net.download(nbytes * len(init), 0.0)

        next_eval = self.eval_interval
        groups_time = {g: t for g in strat.groups(sorted(self.clients))}
        rounds_done = 0
        for rnd in range(rounds):
            # each group (one global group, or one a cluster) runs its own barrier
            for group_id, members in strat.groups(sorted(self.clients)).items():
                t0 = groups_time.get(group_id, t)
                selected = strat.select(group_id, members, rnd)
                if not selected:
                    continue
                starts = [strat.model_for(cid) for cid in selected]
                if self._fleet is not None:
                    trained, _, vecs = self._fleet.train_cohort(selected, starts)
                    sent = trained if self._codec is None else self._codec.encode_rows(selected, vecs)[0]
                else:
                    trained = [self.clients[cid].local_train(p)[0] for cid, p in zip(selected, starts)]
                    sent = [self._encode_upload(cid, p)[0] for cid, p in zip(selected, trained)]
                finish_times, uploads = {}, {}
                for cid, params, up in zip(selected, trained, sent):
                    dur = self.clients[cid].compute_time()
                    nbytes_up, raw = self._billing(params)
                    up_dur = self.net.upload(nbytes_up, t0 + dur, raw_nbytes=raw)
                    finish_times[cid] = t0 + dur + up_dur
                    uploads[cid] = up
                barrier = max(finish_times.values())
                dl_time = 0.0
                for dl in strat.finish_round(group_id, uploads, barrier):
                    dl_time = max(dl_time, self.net.download(model_bytes(dl.params), barrier))
                    c = self.clients[dl.client_id]
                    self._set_model(c, dl.params)
                    c.base_version = dl.version
                groups_time[group_id] = barrier + dl_time
            t = max(groups_time.values())
            rounds_done = rnd + 1
            while t >= next_eval:
                self._evaluate(next_eval)
                next_eval += self.eval_interval
            if max_time and t > max_time:
                break
        extra = strat.stats() if hasattr(strat, "stats") else {}
        extra["rounds"] = rounds_done
        return self._report(t, extra)

    def run(self, **kw) -> SimReport:
        """The synchronous loop (``rounds``, ``max_time``) for a synchronous
        strategy, else the asynchronous one (``max_time``, ``max_uploads``)."""
        if getattr(self.strategy, "is_synchronous", False):
            return self.run_sync(**{k: v for k, v in kw.items() if k in ("rounds", "max_time")})
        return self.run_async(**{k: v for k, v in kw.items() if k in ("max_time", "max_uploads")})
