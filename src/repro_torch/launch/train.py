"""Training driver: the train loop with checkpoints and the restart from
the newest one (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 8 --batch 2 --seq 4096
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --reduced \\
        --steps 50 --batch 8 --seq 64 --device cpu [--ckpt-dir DIR]

Weights are drawn on the device from a ``torch.Generator`` seeded 0; the
batches come from ``data.lm.token_stream(vocab, seed=0)``. The config's
optimizer and remat apply (``models.steps``, ``models.model.forward``).
With ``--ckpt-dir`` the ``TrainState`` is saved every ``--ckpt-every``
steps in the reference's files (either package restores the other's), and
a run starts from the newest step there. As in the reference, a resumed
run draws its batches from the stream's start again.

``--mesh smoke`` trains on one device. ``--mesh pod`` and ``--mesh
multipod`` place the state by ``launch.shardings.param_shardings`` and
split each batch over ``("pod", "data")`` (``batch_shardings``), over the
visible cards or, with ``--device cpu``, the CPU repeated; ``train(...,
mesh=)`` takes any :class:`~repro_torch.launch.mesh.ModelMesh`, such as
one that repeats a card. A checkpoint holds the whole state (the blocks
gathered), so it restores on any mesh and in either package.
"""
from __future__ import annotations

import argparse
import time
from typing import Any

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.common.device import resolve_device
from repro_torch.common.pytrees import tree_map
from repro_torch.configs import ARCH_REGISTRY
from repro_torch.configs.base import ModelConfig, reduced_config
from repro_torch.data.lm import token_stream
from repro_torch.launch import sharded
from repro_torch.launch.mesh import resolve_model_mesh
from repro_torch.launch.serve import sync
from repro_torch.models import dist
from repro_torch.models.model import init_params
from repro_torch.models.steps import TrainState, make_optimizer, make_train_step

PyTree = Any


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int, device="cuda", params: PyTree | None = None,
          ckpt_dir: str | None = None, ckpt_every: int = 50, log_every: int = 10, verbose: bool = True,
          mesh=None) -> dict:
    """Train steps ``start .. steps - 1``, where ``start`` is the newest
    checkpoint's step under ``ckpt_dir`` (else 0), and save the state
    every ``ckpt_every`` steps. ``params`` (tensors on the device) replace
    the drawn weights; the driver keeps no reference to them or to any
    state it has stepped past. Returns the final ``state``, ``start``,
    each step's ``losses`` and wall ``step_s``, ``tokens_per_s`` over the
    run and, on the card, ``peak_bytes`` (``max_memory_allocated`` from
    the first step on). ``mesh``: a :class:`~repro_torch.launch.mesh.
    ModelMesh` starting on ``device``, or ``"smoke"``, ``"pod"`` or
    ``"multipod"`` over the visible cards (the CPU repeated on ``cpu``);
    on a mesh of more than one device the state is held in blocks
    (``launch.sharded.shard_state``), and the returned state is gathered
    whole."""
    if cfg.embeds_input:
        raise SystemExit("frontend-stub archs train via input_specs embeddings; use the dry-run for those cells")
    dev = resolve_device(device)
    if isinstance(mesh, str):
        mesh = resolve_model_mesh(mesh, dev)
    if mesh is not None and mesh.first_device != dev:
        raise ValueError(f"the mesh starts on {mesh.first_device}, the run is on {dev}")
    meshed = mesh is not None and mesh.size > 1
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    if verbose:
        shape = dict(mesh.shape) if mesh is not None else "smoke"
        print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M mesh={shape} device={dev}")
    opt = make_optimizer(cfg)
    state = TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32, device=dev))
    del params
    if meshed:
        state = sharded.shard_state(cfg, state, mesh)
    step_fn = make_train_step(cfg, opt)

    ck = Checkpointer(ckpt_dir, keep=3) if ckpt_dir else None
    start = 0
    if ck is not None:
        got = ck.restore_latest(like=sharded.state_template(state))
        if got is not None:
            start, restored, _ = got
            state = tree_map(lambda t: torch.as_tensor(t, device=dev), restored)
            del restored
            if meshed:
                state = sharded.shard_state(cfg, state, mesh)
            if verbose:
                print(f"restored checkpoint at step {start}")

    stream = token_stream(cfg.vocab_size, seed=0, batch=batch, seq=seq)
    losses, step_s = [], []
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tokens_done = 0
    with dist.use_mesh(mesh):
        for i in range(start, steps):
            t1 = time.perf_counter()
            state, metrics = step_fn(state, next(stream))
            loss = float(metrics["loss"])  # waits for the step
            step_s.append(time.perf_counter() - t1)
            losses.append(loss)
            tokens_done += batch * seq
            if verbose and (i + 1) % log_every == 0:
                print(f"step {i + 1:5d} loss={loss:.4f} tok/s={tokens_done / (time.perf_counter() - t0):,.0f}")
            if ck is not None and (i + 1) % ckpt_every == 0:
                ck.save_async(i + 1, sharded.gather_state(state), extra={"loss": loss})
    if ck is not None:
        ck.wait()
        ck.close()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    state = sharded.gather_state(state)
    if verbose:
        print(f"done: {steps - start} steps in {wall:.1f}s")
    return {"state": state, "start": start, "losses": losses, "step_s": step_s,
            "tokens_per_s": tokens_done / wall if tokens_done else 0.0, "peak_bytes": peak}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCH_REGISTRY))
    ap.add_argument("--mesh", default="smoke", choices=["smoke", "pod", "multipod"])
    ap.add_argument("--reduced", action="store_true", help="CPU-sized config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = ARCH_REGISTRY[args.arch]
    if args.reduced:
        cfg = reduced_config(cfg)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, device=args.device, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every, log_every=args.log_every, mesh=args.mesh)


if __name__ == "__main__":
    main()
