"""Serving: prefill, then batched greedy decode over fixed-size KV
buffers (counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
        --batch 4 --prompt 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b --reduced \\
        --batch 4 --prompt 16 --gen 32 --device cpu

Weights are drawn on the device from a ``torch.Generator`` seeded 0;
prompts from ``numpy.random.default_rng(0)``. The prefill's caches are
grafted into ``init_cache`` buffers with a margin of ``gen + 8``; then each
step feeds the last greedy token.

``--mesh smoke`` serves on one device. ``--mesh pod`` (16 x 16) and
``--mesh multipod`` (2 x 16 x 16) place the parameters by
``launch.shardings.param_shardings`` and the decode buffers by
``cache_shardings`` over the visible cards (with ``--device cpu``, over
the CPU repeated), and run every shard (``launch.sharded``), for every
decoder of the zoo. A caller may pass ``serve(..., mesh=)`` a mesh that
repeats one card: ``make_production_mesh(devices=[torch.device("cuda",
0)] * 256)``, and params placed on it already (``launch.sharded.
shard_tree``: on a mesh that repeats the params' device its blocks are
views of the leaves).
"""
from __future__ import annotations

import argparse
import time
from typing import Any

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.pytrees import tree_map
from repro_torch.configs import ARCH_REGISTRY
from repro_torch.configs.base import ModelConfig, reduced_config
from repro_torch.launch import sharded
from repro_torch.launch.mesh import resolve_model_mesh
from repro_torch.launch.shardings import param_shardings_flat
from repro_torch.models import dist
from repro_torch.models.model import graft, init_cache, init_params
from repro_torch.models.steps import make_prefill_step, make_serve_step

PyTree = Any


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefill(cfg: ModelConfig, params: PyTree, prompts: torch.Tensor, gen: int) -> tuple[torch.Tensor, PyTree]:
    """The last prompt position's logits ``(B, 1, V)`` and the decode cache:
    the prefill's exact-length caches grafted into buffers with room for
    ``gen + 8`` more tokens."""
    logits, pre_cache = make_prefill_step(cfg)(params, {"tokens": prompts})
    B, L = prompts.shape
    cache = init_cache(cfg, B, ctx_len=L, margin=gen + 8, device=prompts.device)
    cache = tree_map(graft, cache, pre_cache)
    mesh = dist.sharded_mesh()
    return logits, (cache if mesh is None else sharded.shard_cache(cfg, cache, mesh))


def greedy(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """The next token of each row, ``(B, 1)``, over the real vocab."""
    return torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1)[:, None]


def decode(cfg: ModelConfig, params: PyTree, cache: PyTree, logits: torch.Tensor, gen: int,
           keep_logits: bool = False) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """``gen`` greedy tokens ``(B, gen)`` from the prefill's ``logits``:
    token 0 is the prefill's argmax, token i + 1 the argmax of step i,
    which feeds token i. With ``keep_logits`` also each step's logits
    ``(B, V)`` (the positions ``len .. len + gen - 1``)."""
    serve = make_serve_step(cfg)
    tok = greedy(cfg, logits)
    out, kept = [], []
    for _ in range(gen):
        out.append(tok)
        logits, cache = serve(params, cache, {"tokens": tok})
        if keep_logits:
            kept.append(logits[:, -1])
        tok = greedy(cfg, logits)
    return torch.cat(out, dim=1), kept


def place_params(cfg: ModelConfig, params: PyTree, mesh) -> PyTree:
    """``params`` as a step under ``mesh`` takes them: cut by
    ``param_shardings`` on a mesh of more than one device (params placed on
    ``mesh`` already are taken as they are), else as they are."""
    if mesh is None or mesh.size == 1:
        return params
    if isinstance(params, sharded.ShardedTree) and params.layout.mesh is mesh:
        return params
    return sharded.shard_tree(params, param_shardings_flat(cfg, mesh, params), mesh)


def serve(cfg: ModelConfig, *, batch: int, prompt: int, gen: int, device="cuda", params: PyTree | None = None,
          keep_logits: bool = False, verbose: bool = True, mesh=None) -> dict:
    """Draw the weights (unless given), prefill ``batch`` random prompts of
    ``prompt`` tokens and decode ``gen`` tokens, on one device or over a
    mesh (``mesh=``: a :class:`~repro_torch.launch.mesh.ModelMesh` starting
    on ``device``, or ``"smoke"``, ``"pod"`` or ``"multipod"`` over the
    visible cards, the CPU repeated on ``cpu``). Returns the params (as placed), the prompts, the tokens,
    the prefill seconds, the decode seconds, the kernel launches of each
    part (``kernels.ops.launch_counts`` deltas) and, on the card,
    ``peak_bytes`` (``max_memory_allocated`` from the prefill on, the
    placed weights included); with ``keep_logits`` also the prefill's
    last-position logits ``(B, V)`` and each decode step's."""
    from repro_torch.kernels import ops

    if cfg.is_encoder:
        raise SystemExit("encoder-only arch has no decode step")
    dev = resolve_device(device)
    if isinstance(mesh, str):
        mesh = resolve_model_mesh(mesh, dev)
    if mesh is not None and mesh.first_device != dev:
        raise ValueError(f"the mesh starts on {mesh.first_device}, the run is on {dev}")
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    params = place_params(cfg, params, mesh)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt))).to(dev)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with dist.use_mesh(mesh):
        c0 = ops.launch_counts()
        t0 = time.perf_counter()
        logits, cache = prefill(cfg, params, prompts, gen)
        sync(dev)
        t_prefill = time.perf_counter() - t0
        c1 = ops.launch_counts()
        t0 = time.perf_counter()
        toks, step_logits = decode(cfg, params, cache, logits, gen, keep_logits=keep_logits)
        toks = toks.cpu().numpy()  # waits for the last step
        t_decode = time.perf_counter() - t0
        c2 = ops.launch_counts()
    del cache
    if verbose:
        print(f"prefill: {batch}x{prompt} in {t_prefill:.2f}s")
        print(f"decode:  {batch}x{gen} tokens in {t_decode:.2f}s ({batch * gen / t_decode:,.0f} tok/s)")
        print(f"sample: {toks[0, :12].tolist()}")
    out = {"params": params, "prompts": prompts, "tokens": toks, "prefill_s": t_prefill, "decode_s": t_decode,
           "launches": {"prefill": {k: c1[k] - c0[k] for k in c0}, "decode": {k: c2[k] - c1[k] for k in c1}},
           "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None}
    if keep_logits:
        out["logits"] = [logits[:, -1]] + step_logits
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCH_REGISTRY))
    ap.add_argument("--mesh", default="smoke", choices=["smoke", "pod", "multipod"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = ARCH_REGISTRY[args.arch]
    if args.reduced:
        cfg = reduced_config(cfg)
    return serve(cfg, batch=args.batch, prompt=args.prompt, gen=args.gen, device=args.device, mesh=args.mesh)


if __name__ == "__main__":
    main()
