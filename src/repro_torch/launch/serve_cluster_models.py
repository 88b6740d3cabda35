"""Serving example: batched decode from per-cluster personalized models
(counterpart of ``examples/serve_cluster_models.py``).

After an EchoPFL run the server holds one model per cluster. A reduced
gemma2-2b (d_model 64, 2 periods) is trained by 4 clients on 2 token
streams, 40 uploads of 3 AdamW steps each to an
:class:`~repro_torch.core.server.EchoPFLServer`; then requests are batched
by their client's cluster, and each batch is prefilled and greedily
decoded against its cluster's center over the fixed-size KV buffers.

    PYTHONPATH=src python -m repro_torch.launch.serve_cluster_models [--device cpu]

``init_params=`` (the model's weights, numpy) and ``rnn_params=`` (the
broadcast RNN, numpy) hand over weights made elsewhere, e.g. the
reference's, instead of drawing them.
"""
from __future__ import annotations

import argparse
import time
from typing import Any

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.server import EchoPFLServer
from repro_torch.data.lm import token_stream
from repro_torch.interop import tree_from_numpy
from repro_torch.launch.serve import decode, prefill, sync
from repro_torch.models.model import init_params as model_init_params
from repro_torch.models.steps import TrainState, make_optimizer, make_train_step

PyTree = Any
REQUESTS = [{"client": c, "prompt_len": 8, "gen": 16} for c in range(4)]


def main(device: str | torch.device = "cuda", *, init_params: PyTree | None = None, rnn_params: dict | None = None,
         plane_backend: str = "plane", verbose: bool = True) -> dict:
    """Runs the example; returns the server and, per cluster, its requests'
    clients, prompts, tokens ``(B, gen)`` and the logits ``(gen, B, V)``
    that chose them (the prefill's, then each decode step's)."""
    dev = resolve_device(device)
    cfg = reduced_config(get_config("gemma2-2b"), d_model=64, periods=2)
    if init_params is None:
        init = model_init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    else:
        init = tree_from_numpy(init_params, dev)
    opt = make_optimizer(cfg)
    train = make_train_step(cfg)

    # --- quick federated phase: 4 clients, 2 latent token distributions ---
    server = EchoPFLServer(init, num_initial_clusters=2, seed=0, rnn_params=rnn_params, device=dev,
                           plane_backend=plane_backend)
    streams = [token_stream(cfg.vocab_size, seed=i % 2) for i in range(4)]
    states = [TrainState(init, opt.init(init), torch.zeros((), dtype=torch.int32, device=dev)) for _ in range(4)]
    for rnd in range(40):
        cid = rnd % 4
        st = states[cid]._replace(params=server.model_for(cid))
        for _ in range(3):
            st, _ = train(st, next(streams[cid]))
        states[cid] = st
        server.handle_upload(cid, st.params, 0, 128, t=float(rnd))
    if verbose:
        print(f"federated phase done: {server.stats()['clusters']} personalized clusters")

    # --- serving phase: requests routed to their cluster's model ----------
    by_cluster: dict[int, list[dict]] = {}
    for r in REQUESTS:
        by_cluster.setdefault(server.clustering.assignment[r["client"]], []).append(r)
    rng = np.random.default_rng(0)
    served = {}
    for cluster_id, reqs in sorted(by_cluster.items()):
        params = server.clustering.clusters[cluster_id].center
        B, L, gen = len(reqs), reqs[0]["prompt_len"], reqs[0]["gen"]
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, L))).to(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(cfg, params, prompts, gen)
        toks, step_logits = decode(cfg, params, cache, logits, gen, keep_logits=True)
        sync(dev)
        dt = time.perf_counter() - t0
        toks = toks.cpu().numpy()
        served[cluster_id] = {
            "clients": [r["client"] for r in reqs], "prompts": prompts.cpu().numpy(), "tokens": toks,
            # the logits that chose each token: the prefill's, then steps 0 .. gen - 2
            "logits": torch.stack([logits[:, -1]] + step_logits[:-1]).cpu().numpy(),
        }
        if verbose:
            print(f"cluster {cluster_id}: served {B} reqs x {gen} tokens in {dt:.2f}s ({B * gen / dt:.0f} tok/s) "
                  f"sample={toks[0, :8].tolist()}")
    if verbose:
        print("OK")
    return {"server": server, "served": served}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--plane-backend", default="plane", choices=["plane", "pytree"])
    args = ap.parse_args()
    main(args.device, plane_backend=args.plane_backend)
