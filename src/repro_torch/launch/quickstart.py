"""Quickstart: asynchronous personalized FL with EchoPFL, the port's first
run (counterpart of ``examples/quickstart.py``).

Twelve simulated mobile devices (mixed Jetson/RPi speed classes) train
personalized models on non-IID synthetic sensor data (``har``, 4 latent
user groups). The EchoPFL server clusters them on the fly, aggregates
every update (no stragglers dropped) and broadcasts fresh cluster models
on demand; the simulator runs 1,800 s of virtual time.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

``init_params=`` (the MLP, numpy) and ``rnn_params=`` (the broadcast RNN,
numpy) hand over weights made elsewhere, e.g. the reference's.
"""
from __future__ import annotations

import argparse
from typing import Any

import numpy as np

from repro_torch.fl.experiment import build_clients, build_strategy
from repro_torch.fl.simulator import Simulator

PyTree = Any


def run(device="cuda", *, max_time: float = 1800.0, init_params: PyTree | None = None,
        rnn_params: dict | None = None, verbose: bool = True) -> dict:
    """Runs the quickstart; returns the ``task``, the ``server``, the
    simulator's ``report`` and the mean per-client accuracy ``acc``."""
    # 1. a federated task: 12 devices, 4 latent user groups, non-IID labels
    task, clients, init = build_clients("har", num_clients=12, seed=0, latent_clusters=4, device=device,
                                        init_params=init_params)
    if verbose:
        print(f"task={task.name}: {task.num_clients} clients, {task.num_classes} classes, dim={task.dim}")

    # 2. the EchoPFL coordination server (the paper's contribution)
    server = build_strategy("echopfl", init, clients, seed=0, rnn_params=rnn_params, device=device)

    # 3. event-driven asynchronous simulation (virtual time, real training)
    sim = Simulator(clients, server, eval_interval=120.0, target_acc=0.85, seed=0)
    report = sim.run(max_time=max_time)

    # 4. what happened
    acc = float(np.mean(list(report.per_client_acc.values())))
    if verbose:
        print("\n-- result --")
        for k, v in report.summary().items():
            print(f"{k:22s} {v}")
        stats = server.stats()
        print(f"{'clusters':22s} {stats['clusters']}")
        print(f"{'broadcasts':22s} {stats['broadcasts']} "
              f"(rnn-decided: {stats['rnn_broadcasts']}, of {stats['decisions']} decisions)")
        print(f"{'staleness q_max':22s} {stats['staleness']['q_max']}")
        print(f"{'merges/expansions':22s} {stats['merges']}/{stats['expansions']}")
    return {"task": task, "server": server, "report": report, "acc": acc}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.device)
    assert out["acc"] > 0.5, "quickstart should comfortably beat random"
    print(f"\nOK: per-client personalized accuracy {out['acc']:.1%} "
          f"(vs {1 / out['task'].num_classes:.1%} random)")
    return out


if __name__ == "__main__":
    main()
