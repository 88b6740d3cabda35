"""Experiment wiring: task + device fleet + strategy -> Simulator
(counterpart of ``repro.fl.experiment``).

``run_experiment(task, strategy, ...)`` is the port's end-to-end entry
point for EchoPFL and the six baselines: the synchronous strategies run
``rounds`` round barriers, the asynchronous ones the per-event loop, or
with ``coalesce_window=`` seconds the coalesced one; ``uplink=`` compresses
the uploads (``"topk"``, ``"int8"`` or an ``UplinkConfig``); ``churn=``,
``faults=`` and ``guard=`` make an asynchronous run a chaos run
(:class:`~repro_torch.fl.simulator.Simulator`); ``plane_mesh=`` shards the
EchoPFL server's parameter plane and ``fleet_mesh=`` the client fleet
(a :class:`~repro_torch.launch.mesh.PlaneMesh` or a spec string such as
``"8"`` or ``"4x2"``; None is off), with ``mesh_min_rows=`` the server's
threshold for a sharded launch. It runs on ``device="cuda"`` unless the
caller asks for the CPU.
``init_params=`` (MLP weights) and ``rnn_params=`` (pretrained broadcast
RNN) hand over weights made elsewhere — e.g. the reference's, which torch
cannot draw itself — instead of drawing them from ``seed``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.baselines import ClusterFL, FedAsyn, FedAvg, FedSEA, Oort, Standalone
from repro_torch.common.device import resolve_device
from repro_torch.configs.paper_tasks import PAPER_TASKS
from repro_torch.core.client import SimClient
from repro_torch.core.server import EchoPFLServer
from repro_torch.data.synthetic import make_task
from repro_torch.fl.devices import PAPER_SIM_MIX, make_device_fleet
from repro_torch.fl.network import NetworkModel
from repro_torch.fl.simulator import Simulator
from repro_torch.fl.tasks import MLP_TASK
from repro_torch.launch.mesh import resolve_mesh

PyTree = Any


def build_clients(
    task_name: str,
    num_clients: int,
    seed: int = 0,
    latent_clusters: int = 4,
    device_mix: dict | None = None,
    base_round_time: float = 30.0,
    samples_per_client: int = 96,
    local_epochs: int = 5,
    *,
    device: str | torch.device = "cuda",
    init_params: PyTree | None = None,
):
    """Synthetic clients (the reference's numpy draws, in its order) and the
    initial MLP on ``device`` (drawn from ``seed`` unless given)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    task = make_task(
        task_name, num_clients, rng,
        latent_clusters=latent_clusters, samples_per_client=samples_per_client,
    )
    fleet = make_device_fleet(num_clients, rng, device_mix or PAPER_SIM_MIX, base_round_time)
    cfg = PAPER_TASKS[task_name]
    if init_params is None:
        init_params = MLP_TASK.init_params(torch.Generator().manual_seed(seed), cfg, device=dev)
    else:
        init_params = [
            {k: torch.tensor(np.asarray(v), dtype=torch.float32).to(dev) for k, v in layer.items()}
            for layer in init_params
        ]
    clients = [
        SimClient(
            client_id=i,
            data=task.clients[i],
            num_classes=cfg.num_classes,
            device_class=fleet[i]["class"],
            round_time_fn=fleet[i]["round_time"],
            local_epochs=local_epochs,
        )
        for i in range(num_clients)
    ]
    return task, clients, init_params


def build_strategy(
    name: str,
    init_params: PyTree,
    clients: list[SimClient],
    *,
    seed: int = 0,
    num_clusters: int = 2,
    hm: float = 2.0,
    mix_rate: float = 0.25,
    rnn_params: dict | None = None,
    device: str | torch.device = "cuda",
    sync_interval: float = 120.0,
    plane_mesh=None,
    **server_kw,
):
    """The strategy ``name`` over ``clients``: ``echopfl`` (``server_kw``
    goes to :class:`EchoPFLServer`: ``refine_every``, ``enable_clustering``,
    ``enable_broadcast``, ...; the baselines take none of it) or one of
    ``fedavg``, ``fedasyn``, ``fedsea``, ``clusterfl``, ``oort``,
    ``standalone``. Oort's latency hints are three ``round_time_fn()``
    draws a client, in list order, here at build time, as the reference
    draws them. An unknown name raises ``KeyError``. ``plane_mesh`` (a
    :class:`~repro_torch.launch.mesh.PlaneMesh`) goes to the EchoPFL server's
    plane; the baselines keep no plane and refuse one."""
    if plane_mesh is not None and name in ("fedavg", "fedasyn", "fedsea", "clusterfl", "oort", "standalone"):
        raise ValueError(f"plane_mesh: the {name} server keeps no parameter plane")
    sizes = {c.client_id: c.data.n for c in clients}
    if name == "fedavg":
        return FedAvg(init_params, sizes)
    if name == "fedasyn":
        return FedAsyn(init_params)
    if name == "fedsea":
        return FedSEA(init_params, sync_interval=sync_interval)
    if name == "clusterfl":
        return ClusterFL(init_params, sizes, num_clusters=max(num_clusters, 4), seed=seed)
    if name == "oort":
        hints = {c.client_id: np.mean([c.round_time_fn() for _ in range(3)]) for c in clients}
        return Oort(init_params, sizes, hints, seed=seed)
    if name == "standalone":
        return Standalone(init_params)
    if name != "echopfl":
        raise KeyError(name)
    by_id = {c.client_id: c for c in clients}

    def feedback_fn(client_id, center):
        return by_id[client_id].feedback_inputs(center)

    def local_train_fn(center):
        # Algorithm 1 posterior pass: one local round on a member's data
        member = by_id[int(np.random.default_rng(seed).choice(sorted(by_id)))]
        trained, _ = member.local_train(center)
        return trained

    return EchoPFLServer(
        init_params,
        num_initial_clusters=num_clusters,
        hm=hm,
        mix_rate=mix_rate,
        feedback_fn=feedback_fn,
        local_train_fn=local_train_fn,
        rnn_params=rnn_params,
        seed=seed,
        device=device,
        plane_mesh=plane_mesh,
        **server_kw,
    )


def run_experiment(
    task_name: str,
    strategy_name: str,
    *,
    num_clients: int = 20,
    seed: int = 0,
    max_time: float = 3600.0,
    rounds: int = 40,
    target_acc: float = 0.85,
    eval_interval: float = 60.0,
    network: NetworkModel | None = None,
    latent_clusters: int = 4,
    device_mix: dict | None = None,
    samples_per_client: int = 96,
    local_epochs: int = 5,
    base_round_time: float = 30.0,
    device: str | torch.device = "cuda",
    init_params: PyTree | None = None,
    rnn_params: dict | None = None,
    coalesce_window: float = 0.0,
    max_uploads: int | None = None,
    uplink: Any = None,
    churn: dict | None = None,
    faults: Any = None,
    guard: Any = None,
    plane_mesh=None,
    fleet_mesh=None,
    client_backend: str = "fleet",
    **strategy_kw,
):
    """Returns (task, clients, strategy, report). A synchronous strategy
    runs at most ``rounds`` rounds and stops past ``max_time``; an
    asynchronous one runs to ``max_time``, coalesced with
    ``coalesce_window`` > 0 (seconds of virtual time a window), and
    ``max_uploads`` stops it at that many ingested uploads. ``uplink``: no
    codec (``None``, ``"none"``), ``"topk"``, ``"int8"`` or an
    :class:`~repro_torch.fl.uplink.UplinkConfig`. ``churn``: offline
    windows a client; ``faults``: ``None``/``"off"``, a
    :class:`~repro_torch.fl.faults.FaultConfig` or ``FaultPlan``; ``guard``:
    ``None``/``"off"``, ``"on"`` or a
    :class:`~repro_torch.fl.guard.GuardConfig` (the asynchronous loops
    only, as in the reference). ``plane_mesh``, ``fleet_mesh``: see the
    module docstring; ``mesh_min_rows`` rides ``strategy_kw`` to the
    EchoPFL server. ``client_backend``: ``"fleet"`` (batched) or ``"loop"``
    (one client at a time, the reference's ``client_backend="loop"``)."""
    dev = resolve_device(device)
    plane_mesh, fleet_mesh = resolve_mesh(plane_mesh, dev), resolve_mesh(fleet_mesh, dev)
    task, clients, init_params = build_clients(
        task_name, num_clients, seed=seed, latent_clusters=latent_clusters,
        device_mix=device_mix, samples_per_client=samples_per_client,
        local_epochs=local_epochs, base_round_time=base_round_time,
        device=dev, init_params=init_params,
    )
    strategy = build_strategy(
        strategy_name, init_params, clients, seed=seed, rnn_params=rnn_params,
        device=dev, plane_mesh=plane_mesh, **strategy_kw,
    )
    sim = Simulator(
        clients, strategy,
        network=network or NetworkModel(),
        eval_interval=eval_interval, target_acc=target_acc, seed=seed, coalesce_window=coalesce_window,
        uplink=uplink, churn=churn, faults=faults, guard=guard, fleet_mesh=fleet_mesh,
        client_backend=client_backend,
    )
    report = sim.run(max_time=max_time, rounds=rounds, max_uploads=max_uploads)
    report.extra["task"] = task_name
    report.extra["latent_clusters"] = {c.client_id: c.data.latent_cluster for c in clients}
    return task, clients, strategy, report
