"""Dry-run of every (architecture x input-shape) cell on the production
meshes (counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's step on 256 or 512 forced
host devices and costs the optimized HLO (``repro.launch.hlo_cost``). The
port traces the same step functions on the ``meta`` device: shapes and
dtypes, no memory, no kernel. A mesh of the production shape repeats the
``meta`` device, so one process runs every (batch shard, model rank) of the
step, as on the card (``launch.sharded``); the kernel wrappers take their
plain versions on ``meta`` tensors, as the reference lowers its AD-able
reference attention under ``REPRO_ATTN_COST_PROXY``. :class:`~repro_torch.
launch.cost.CostMode` counts the FLOPs, bytes and collective bytes of every
op by the reference's rules, per device, and the roofline uses the NVIDIA
H100's peaks (``launch.mesh``), in the dtype the cell was traced in. The
flash kernels' analytic traffic takes the place of the plain attention's
``(S, S)`` tensors, as in the reference.

Usage (the CPU is enough; nothing is allocated)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out experiments/dryrun]

Each cell writes ``<out>/<arch>__<shape>__<mesh>.json`` as it finishes.
The reference's ``parse_collective_bytes`` reads HLO text and has no
counterpart here: the collectives are counted at the port's join points.
The reference records ``lower_s`` and ``compile_s``; the port ``trace_s``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.common.pytrees import tree_leaves
from repro_torch.configs import ARCH_REGISTRY, SHAPES, supports_shape
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch import sharded
from repro_torch.launch import specs as SP
from repro_torch.launch.cost import CostMode
from repro_torch.launch.mesh import (H100_HBM_BYTES_PER_S, H100_NVLINK_BYTES_PER_S, ModelMesh, axis_size,
                                     batch_axes, make_production_mesh, peak_flops)
from repro_torch.launch.shardings import cache_shardings_flat, param_shardings_flat
from repro_torch.models import dist
from repro_torch.models.steps import make_prefill_step, make_serve_step, make_train_step

META = torch.device("meta")


def meta_mesh(extents: tuple[int, ...]) -> ModelMesh:
    """A model mesh of ``extents`` over ``("data", "model")`` (or
    ``("pod", "data", "model")`` for three) that repeats the ``meta`` device."""
    axes = ("data", "model") if len(extents) == 2 else ("pod", "data", "model")
    return ModelMesh(axes, tuple(extents), (META,) * math.prod(extents))


def sharded_bytes(leaves, specs, mesh) -> float:
    """Per-device resident bytes implied by the placements (exact,
    logical): each leaf's bytes over the product of the mesh axes its spec
    names."""
    total = 0.0
    for leaf, spec in zip(leaves, specs):
        shards = 1
        for axes in spec or ():
            if axes is None:
                continue
            for a in (axes if isinstance(axes, tuple) else (axes,)):
                shards *= mesh.shape[a]
        total += leaf.numel() * leaf.element_size() / shards
    return total


def _state_bytes(cfg: ModelConfig, state: SP.TrainState, mesh) -> float:
    """A ``TrainState``'s per-device bytes: params and optimizer slots by
    ``param_shardings``, the step replicated."""
    total = 0.0
    for tree in (state.params, state.opt_state):
        total += sharded_bytes(tree_leaves(tree), param_shardings_flat(cfg, mesh, tree), mesh)
    return total + state.step.numel() * state.step.element_size()


def _dp(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in batch_axes(mesh))


def train_policy(cfg: ModelConfig, shape: ShapeSpec, dp: int) -> ModelConfig:
    """The reference's train execution policy (``dryrun.py:104-118``): remat
    on, microbatches sized so the remat-saved layer inputs fit a ~4 GB live
    budget, then cut to a count that splits the batch over the data axes."""
    tokens_dev = (shape.global_batch // dp if shape.global_batch % dp == 0 else shape.global_batch) * shape.seq_len
    saved_inputs = tokens_dev * 2.0 * cfg.d_model * cfg.num_layers
    want = max(cfg.train.microbatches, math.ceil(saved_inputs / 4e9))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, microbatches=want))
    n_eff = SP.effective_microbatches(cfg, shape, dp)
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, microbatches=n_eff, remat=True))


def trace_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *, dtype=torch.bfloat16, skip=frozenset()):
    """Trace the cell's step under a :class:`CostMode` (counterpart of
    ``lower_cell``): returns ``(mode, aux)``, ``aux`` the logical per-device
    byte counts of the placed state (and cache) and the train policy."""
    dp = _dp(mesh)
    meshed = mesh.size > 1
    aux: dict = {}
    if shape.kind == "train":
        cfg = train_policy(cfg, shape, dp)
        aux["microbatches"] = cfg.train.microbatches
        aux["remat"] = True
        spec = SP.input_specs(cfg, shape, dtype)
        state, batch = spec["state"], spec["batch"]
        aux["state_bytes_per_device"] = _state_bytes(cfg, state, mesh)
        if meshed:
            state = sharded.shard_state(cfg, state, mesh)
        run = lambda: make_train_step(cfg)(state, batch)  # noqa: E731
    else:
        spec = SP.input_specs(cfg, shape, dtype)
        params, batch = spec["params"], spec["batch"]
        p_specs = param_shardings_flat(cfg, mesh, params)
        aux["state_bytes_per_device"] = sharded_bytes(tree_leaves(params), p_specs, mesh)
        if meshed:
            params = sharded.shard_tree(params, p_specs, mesh)
        if shape.kind == "prefill":
            run = lambda: make_prefill_step(cfg)(params, batch)  # noqa: E731
        else:
            cache = spec["cache"]
            rest = {k: v for k, v in cache.items() if k != "len"}
            aux["cache_bytes_per_device"] = (
                sharded_bytes(tree_leaves(rest), cache_shardings_flat(cfg, mesh, rest, shape.global_batch), mesh)
                + cache["len"].numel() * cache["len"].element_size())
            # the step reads the position as an int: the last slot (the buffer full)
            cache = dict(cache, len=shape.seq_len - 1)
            if meshed:
                cache = sharded.shard_cache(cfg, cache, mesh)
            run = lambda: make_serve_step(cfg)(params, cache, batch)  # noqa: E731
    mode = CostMode(skip)
    with dist.use_mesh(mesh), mode:
        run()
    return mode, aux


def flash_attention_analytic_bytes(cfg: ModelConfig, shape: ShapeSpec, mesh, block: int = 1024,
                                   itemsize: int = 2) -> float:
    """Per-device HBM traffic of the flash attention kernels (fwd + bwd) for
    one step, from the tile-streaming model of the reference
    (``dryrun.py:161``): q read once a key block, k/v once a query block
    (per KV head), o written; the backward as four passes with remat.
    ``itemsize``: the activations' bytes an element (2 for bf16)."""
    attn_layers = sum(1 for layer in cfg.all_layers if layer.mixer in ("attn", "attn_local"))
    if attn_layers == 0 or shape.kind == "decode":
        return 0.0
    S, B = shape.seq_len, shape.global_batch
    dp, tp = _dp(mesh), axis_size(mesh, "model")
    B_l = B // dp if B % dp == 0 else B
    H, KV = cfg.num_heads, cfg.num_kv_heads
    G = max(1, H // KV)
    h_sharded = H % tp == 0 and tp > 1
    H_l = H // tp if h_sharded else H
    if h_sharded and KV % tp != 0:
        KV_l = max(1, H_l // G)
    else:
        KV_l = KV // tp if (h_sharded and KV % tp == 0) else KV
    if cfg.mla is not None:
        hd = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        dv = cfg.mla.v_head_dim
    else:
        hd = dv = cfg.resolved_head_dim
    blk = min(block, S)
    nq = nk = (S + blk - 1) // blk
    per_layer = (H_l * nk * S * hd + KV_l * nq * S * (hd + dv) + H_l * S * dv) * B_l * itemsize
    passes = 4.0 if shape.kind == "train" else 1.0
    return attn_layers * per_layer * passes


def roofline_terms(flops_per_dev: float, bytes_per_dev: float, coll: dict, dtype=torch.bfloat16) -> dict:
    """The H100's roofline terms: compute at the peak of ``dtype``, memory at
    the HBM bandwidth, collectives at one direction of NVLink."""
    comm = sum(v for k, v in coll.items() if k != "count")
    return {
        "compute_s": flops_per_dev / peak_flops(dtype),
        "memory_s": bytes_per_dev / H100_HBM_BYTES_PER_S,
        "collective_s": comm / H100_NVLINK_BYTES_PER_S,
        "collective_bytes_per_device": comm,
    }


def model_flops(cfg: ModelConfig, shape: ShapeSpec, active: int) -> float:
    """``6 N_active`` a token for a train step, ``2 N_active`` for prefill
    and for each decoded token."""
    if shape.kind == "train":
        return 6.0 * active * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * active * shape.seq_len * shape.global_batch
    return 2.0 * active * shape.global_batch


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str | None, skip_existing: bool = False, *,
             cfg: ModelConfig | None = None, shape: ShapeSpec | None = None, mesh=None, mesh_name: str | None = None,
             dtype=torch.bfloat16) -> dict:
    """One cell's record, written to ``out_dir`` (None: not written).
    ``cfg``, ``shape`` and ``mesh`` replace the registry's config, the named
    shape and the production mesh (a reduced config on a small mesh, as the
    CPU tests run it)."""
    cfg = ARCH_REGISTRY[arch] if cfg is None else cfg
    shape = SHAPES[shape_name] if shape is None else shape
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, devices=[META] * (512 if multi_pod else 256))
    mesh_name = mesh_name or ("pod2x16x16" if multi_pod else "pod16x16")
    path = None
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
        if skip_existing and os.path.exists(path):
            with open(path) as f:
                return json.load(f)
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "kind": shape.kind,
                    "seq_len": shape.seq_len, "global_batch": shape.global_batch, "dtype": str(dtype)}
    ok, reason = supports_shape(cfg, shape)
    if not ok:
        record["status"] = "SKIP"
        record["reason"] = reason
        _write(path, record)
        return record
    try:
        has_attn = any(layer.mixer in ("attn", "attn_local") for layer in cfg.all_layers)
        skip = frozenset({(shape.seq_len, shape.seq_len)}) if has_attn and shape.kind in ("train", "prefill") \
            else frozenset()
        t0 = time.perf_counter()
        mode, aux = trace_cell(cfg, shape, mesh, dtype=dtype, skip=skip)
        record["trace_s"] = round(time.perf_counter() - t0, 1)
        dev = mode.per_device(_dp(mesh), axis_size(mesh, "model"))
        flops, bytes_acc = dev["flops"], dev["bytes"]
        if skip:
            flash_bytes = flash_attention_analytic_bytes(cfg, shape, mesh, itemsize=dtype.itemsize)
            record["attn_s2_bytes_skipped"] = mode.skipped_bytes
            record["attn_flash_bytes_added"] = flash_bytes
            bytes_acc += flash_bytes
        record["flops_per_device"] = flops
        record["dot_flops_per_device"] = dev["dot_flops"]
        record["bytes_per_device"] = bytes_acc
        coll = dict(dev["collectives"])
        coll["count"] = dev["collective_count"]
        record["collectives"] = coll
        record.update(aux)
        record["devices"] = int(mesh.size)
        terms = roofline_terms(flops, bytes_acc, coll, dtype)
        record["roofline"] = terms
        record["params"] = SP.model_param_count(cfg)
        record["active_params"] = SP.model_active_param_count(cfg)
        record["model_flops"] = model_flops(cfg, shape, record["active_params"])
        total = flops * mesh.size
        record["model_flops_ratio"] = record["model_flops"] / total if total else None
        record["bottleneck"] = max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
        record["status"] = "OK"
    except Exception as e:  # noqa: BLE001 (record the failure, keep sweeping)
        record["status"] = "FAIL"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    _write(path, record)
    return record


def _write(path: str | None, record: dict) -> None:
    if path is not None:
        with open(path, "w") as f:
            json.dump(record, f, indent=2)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Trace every (arch x shape) cell on meta tensors and cost it "
                                             "against the H100's roofline.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    archs = sorted(ARCH_REGISTRY) if (args.all or not args.arch) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    results = []
    for multi_pod in meshes:
        for arch in archs:
            for shape in shapes:
                r = run_cell(arch, shape, multi_pod, args.out, args.skip_existing)
                if r["status"] == "OK":
                    t = r["roofline"]
                    extra = (f"compute={t['compute_s']:.4f}s memory={t['memory_s']:.4f}s "
                             f"coll={t['collective_s']:.4f}s bottleneck={r['bottleneck']} trace={r['trace_s']}s")
                elif r["status"] == "SKIP":
                    extra = r["reason"]
                else:
                    extra = r["error"][:200]
                print(f"[{r['status']}] {arch} x {shape} x {r['mesh']}: {extra}", flush=True)
                results.append(r)
    n_ok = sum(r["status"] == "OK" for r in results)
    n_skip = sum(r["status"] == "SKIP" for r in results)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"done: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
