"""Federated training of transformer clients with the EchoPFL protocol and
a server that checkpoints itself (counterpart of
``examples/train_async_pfl.py``).

Each client is a reduced llama3.2-1b (d_model 64, 2 periods) training a
causal LM on its own token stream; two streams (``seed = id % 2``) make
two latent user groups. Clients arrive in random order; each takes the
server's model for it, runs ``local_steps`` AdamW steps and uploads. The
:class:`~repro_torch.core.server.EchoPFLServer` clusters the uploads by
parameter distance, blends them, broadcasts on demand and saves its whole
state every ``ckpt_every`` rounds, so a killed run resumes with
``--resume``. As in the reference, a resumed run restores only the
server: the clients' states, their streams and the arrival order start
afresh.

    PYTHONPATH=src python -m repro_torch.launch.train_async_pfl [--steps 300] [--resume] [--device cpu]

``init_params=`` (the model's weights) and ``rnn_params=`` (the broadcast
RNN), numpy, hand over weights made elsewhere, e.g. the reference's.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer, latest_step, restore_pytree
from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.server import EchoPFLServer
from repro_torch.data.lm import token_stream
from repro_torch.interop import tree_from_numpy
from repro_torch.models.model import init_params as model_init_params
from repro_torch.models.steps import TrainState, make_optimizer, make_train_step

PyTree = Any
CKPT_DIR = "experiments/train_async_pfl_ckpt"


def example_config():
    return reduced_config(get_config("llama3.2-1b"), d_model=64, periods=2)


def restore_server(server: EchoPFLServer, ckpt_dir: str) -> int | None:
    """Load the newest server checkpoint under ``ckpt_dir`` into
    ``server``; its round, or ``None`` when there is none. The manifest is
    read first: its meta gives the template."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    _, extra = restore_pytree(d, like=None)
    template = {"server": server.state_template(extra["server_meta"])}
    tree, extra = restore_pytree(d, like=template)
    server.load_state(tree["server"], extra["server_meta"])
    return step


def run(device="cuda", *, steps: int = 300, clients: int = 4, local_steps: int = 5, resume: bool = False,
        ckpt_dir: str = CKPT_DIR, ckpt_every: int = 50, init_params: PyTree | None = None,
        rnn_params: dict | None = None, verbose: bool = True) -> dict:
    """Rounds ``start .. steps - 1`` (``start``: the restored round with
    ``resume``, else 0). Returns the ``server``, ``start``, the arrival
    ``order``, each client's ``losses`` (its last local step's, a round),
    ``history`` (after each round: the round, the assignment of every
    client, the clusters, broadcasts and merges), the final
    ``assignment`` and ``stats`` and the wall seconds."""
    dev = resolve_device(device)
    cfg = example_config()
    if init_params is None:
        init = model_init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    else:
        init = tree_from_numpy(init_params, dev)
    opt = make_optimizer(cfg)
    train_step = make_train_step(cfg)

    streams = [token_stream(cfg.vocab_size, seed=i % 2, batch=4, seq=32) for i in range(clients)]
    states = [TrainState(init, opt.init(init), torch.zeros((), dtype=torch.int32, device=dev))
              for _ in range(clients)]
    server = EchoPFLServer(init, num_initial_clusters=2, seed=0, rnn_params=rnn_params, device=dev)
    ck = Checkpointer(ckpt_dir, keep=2)
    start = 0
    if resume:
        step = restore_server(server, ckpt_dir)
        if step is not None:
            start = step
            if verbose:
                print(f"resumed server state at round {start}")

    t0 = time.time()
    losses: dict[int, list[float]] = {i: [] for i in range(clients)}
    order, history = [], []
    rng = np.random.default_rng(0)
    for rnd in range(start, steps):
        cid = int(rng.integers(clients))  # async: clients arrive in random order
        order.append(cid)
        st = states[cid]._replace(params=server.model_for(cid))
        loss = None
        for _ in range(local_steps):
            st, metrics = train_step(st, next(streams[cid]))
            loss = float(metrics["loss"])
        states[cid] = st
        losses[cid].append(loss)
        downlinks = server.handle_upload(cid, st.params, 0, 128, t=time.time() - t0)
        for dl in downlinks:  # fresh models: the unicast and the broadcasts
            states[dl.client_id] = states[dl.client_id]._replace(params=dl.params)
        stats = server.stats()
        history.append({"round": rnd + 1, "assignment": [server.clustering.assignment.get(i) for i in range(clients)],
                        "clusters": stats["clusters"], "broadcasts": stats["broadcasts"], "merges": stats["merges"]})
        if (rnd + 1) % ckpt_every == 0:
            tree, meta = server.state_dict()
            ck.save(rnd + 1, {"server": tree}, extra={"server_meta": meta})
            if verbose:
                mean_loss = np.mean([v[-1] for v in losses.values() if v])
                print(f"round {rnd + 1:4d}: loss={mean_loss:.4f} clusters={stats['clusters']} "
                      f"broadcasts={stats['broadcasts']}")
    ck.close()
    wall = time.time() - t0

    first = {i: v[0] for i, v in losses.items() if v}
    last = {i: v[-1] for i, v in losses.items() if v}
    assignment = [server.clustering.assignment.get(i) for i in range(clients)]
    if verbose:
        print("\n-- final --")
        for i in sorted(first):
            print(f"client {i}: first_loss={first[i]:.4f} last_loss={last[i]:.4f}")
        print(f"cluster assignment: {assignment} (clients with even/odd ids share token stats)")
    return {"server": server, "start": start, "order": order, "losses": losses, "history": history,
            "assignment": assignment, "stats": server.stats(), "wall_s": wall}


def check_losses_fall(out: dict) -> None:
    """The example's closing assertion: every client that trained ends
    below its first loss."""
    first = {i: v[0] for i, v in out["losses"].items() if v}
    last = {i: v[-1] for i, v in out["losses"].items() if v}
    assert all(last[i] < first[i] for i in last), "every client's LM loss must improve"


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    args = ap.parse_args(argv)
    out = run(args.device, steps=args.steps, clients=args.clients, local_steps=args.local_steps, resume=args.resume,
              ckpt_dir=args.ckpt_dir)
    check_losses_fall(out)
    return out


if __name__ == "__main__":
    main()
