"""Step factories (counterpart of ``repro.models.steps``): train (with
microbatch gradient accumulation), eval, prefill and the single-token
serve step.

Batches are dicts of ``tokens`` (or an encoder's ``embeds``) and
``labels`` (numpy or tensors); they go to the params' device. The train
step differentiates through the flash kernels (``kernels.ops.attention``)
with autograd and returns detached params: nothing it hands out carries a
graph, and no tensor of the state it was given is written. A leaf the
loss does not reach (the embedding table, when embeddings are fed) gets a
zero gradient, as the reference's ``jax.grad`` gives it. With
``cfg.train.remat`` the forward keeps only each period's input and the
backward recomputes the period (``models.model.forward``): the same bits,
less memory.

Under a registered model mesh of more than one device (``models.dist``)
the steps take params placed on it (``launch.sharded``) and run each batch
shard in turn, the heads, FFN width, experts, ``d_inner``, channels and
vocabulary split over the model ranks inside ``forward``; an arch with MoE
layers runs its batch shards together, layer by layer
(``models.model.forward_shards``), since its routing groups the whole
batch's tokens. The train step adds the groups' gradients block by block
in order and updates each block once; prefill and eval join the logits
(and prefill the caches) over the shards; the serve step takes buffers
placed by ``launch.sharded.shard_cache``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.common.pytrees import tree_leaves, tree_map, tree_unflatten
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import sharded
from repro_torch.models import dist
from repro_torch.models.model import forward, forward_shards
from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.optimizers import Optimizer, adamw, apply_updates, clip_by_global_norm, momentum

PyTree = Any


class TrainState(NamedTuple):
    params: PyTree
    opt_state: PyTree
    step: torch.Tensor


def make_optimizer(cfg: ModelConfig) -> Optimizer:
    t = cfg.train
    if t.optimizer == "adafactor":
        return adafactor(t.learning_rate)
    if t.optimizer == "sgdm":
        return momentum(t.learning_rate, 0.9)
    return adamw(t.learning_rate)


def _ce_terms(logits: torch.Tensor, labels: torch.Tensor, vocab: int):
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    gold = torch.gather(logits, -1, labels.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    valid = (labels >= 0) & (labels < vocab)
    return torch.where(valid, logz - gold, torch.zeros((), device=logits.device)), valid


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mean next-token cross entropy in fp32; labels outside ``[0, vocab)``
    (the padded vocab's tail) are masked out."""
    ce, valid = _ce_terms(logits, labels, vocab)
    return torch.sum(ce) / torch.clamp_min(torch.sum(valid), 1)


def ce_sum(logits: torch.Tensor, labels: torch.Tensor, vocab: int) -> torch.Tensor:
    """:func:`cross_entropy`'s numerator: the sum over the valid labels."""
    return torch.sum(_ce_terms(logits, labels, vocab)[0])


def _on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _device_of(params: PyTree):
    return tree_leaves(params)[0].device


def _loss_fn(cfg: ModelConfig, params: PyTree, batch: dict):
    logits, aux, _ = forward(cfg, params, batch)
    ce = cross_entropy(logits, batch["labels"], cfg.vocab_size)
    loss = ce + 0.01 * aux
    return loss, {"loss": loss, "ce": ce, "moe_aux": aux}


def _grads(cfg: ModelConfig, params: PyTree, batch: dict):
    """(metrics, gradient tree) of the loss at ``params``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = _loss_fn(cfg, tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]  # embed, fed embeddings
    return {k: v.detach() for k, v in metrics.items()}, tree_unflatten(params, grads)


def _mesh_of(params: PyTree):
    """The registered model mesh when it has more than one device; the params
    must then be held in its blocks (``launch.sharded.shard_state``)."""
    mesh = dist.sharded_mesh()
    if mesh is not None and not (isinstance(params, sharded.ShardedTree) and params.layout.mesh is mesh):
        raise TypeError("under a model mesh the step takes params placed on it (launch.sharded.shard_state)")
    return mesh


def _shard_groups(cfg: ModelConfig, mesh, batch: int) -> list[list[tuple[int, slice]]]:
    """The batch shards ``(b, rows)`` that run together in one forward
    (``models.model.forward_shards``): all of them in one group where the
    arch has MoE layers, whose routing groups the whole batch's tokens
    (capacity, queue places, drops and the aux loss), else each alone."""
    shards = list(enumerate(sharded.batch_shards(mesh, batch)))
    if any(spec.ffn == "moe" for spec in cfg.all_layers):
        return [shards]
    return [[s] for s in shards]


def _sharded_grads(cfg: ModelConfig, params: sharded.ShardedTree, batch: dict, mesh):
    """(metrics, gradient blocks) of the loss at ``params`` over a model
    mesh: each group of batch shards (:func:`_shard_groups`) forward and
    backward in turn, its loss the shards' cross-entropy sums over the
    whole batch's valid labels, added in shard order, plus the group's MoE
    aux loss; the gradients added block by block in group order."""
    first = mesh.first_device
    leaves = [t.detach().requires_grad_(True) for t in params]
    req = sharded.ShardedTree(leaves, params.layout)
    labels = batch["labels"].long()
    count = torch.clamp_min(torch.sum((labels >= 0) & (labels < cfg.vocab_size)), 1)
    grads, metrics = None, None
    for group in _shard_groups(cfg, mesh, labels.shape[0]):
        reads = sharded.Reads(req)
        parts = [dist.place({k: v[rows].to(mesh.device(b, 0)) for k, v in batch.items()}, b) for b, rows in group]
        logits, aux, _ = forward_shards(cfg, [sharded.view(req, b, reads) for b, _ in group], parts)
        ce = None
        for out, part in zip(logits, parts):
            c = (ce_sum(out, part["labels"], cfg.vocab_size) / count.to(out.device)).to(first)
            ce = c if ce is None else ce + c
        loss = ce + 0.01 * aux.to(first)
        del reads, logits
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        g = [torch.zeros_like(p) if gi is None else gi for p, gi in zip(leaves, g)]
        if grads is None:
            grads = g
        else:  # the groups' gradients joined block by block: an all-reduce over the batch shards
            with dist.collective_ops():
                grads = [a + x for a, x in zip(grads, g)]
            for a in grads:
                dist.note_collective("all-reduce", a)
        m = {"loss": loss.detach(), "ce": ce.detach(), "moe_aux": aux.detach().to(first)}
        metrics = m if metrics is None else {k: metrics[k] + m[k] for k in m}
    return metrics, sharded.ShardedTree(grads, params.layout)


def _update_by_device(opt: Optimizer, grads, opt_state, params):
    """The optimizer's update block by block, one call for each device that
    holds blocks (the state's scalars, the step, moved there), so each block
    is updated once, where it lives."""
    homes = params.layout.homes
    devices = list(dict.fromkeys(homes))

    def pick(tree, dev):
        if isinstance(tree, sharded.ShardedTree):
            return [t for t, h in zip(tree, homes) if h == dev]
        if isinstance(tree, torch.Tensor):
            return tree.to(dev)
        return type(tree)(*(pick(x, dev) for x in tree))

    def merge(parts, like):
        if isinstance(like, sharded.ShardedTree):
            its = {d: iter(p) for d, p in zip(devices, parts)}
            return like.rebuild([next(its[h]) for h in homes])
        if isinstance(like, torch.Tensor):
            return parts[0].to(like.device)
        return type(like)(*(merge([p[i] for p in parts], x) for i, x in enumerate(like)))

    outs = [opt.update(pick(grads, d), pick(opt_state, d), pick(params, d)) for d in devices]
    return merge([o[0] for o in outs], grads), merge([o[1] for o in outs], opt_state)


def _sharded_update(cfg: ModelConfig, opt: Optimizer, state: TrainState, grads: sharded.ShardedTree):
    """Clip by the global norm (the blocks' squares added in order), then the
    optimizer: AdamW and momentum block by block; Adafactor, whose factored
    moments and update RMS span a whole leaf, on the gathered leaves, its
    updates and slots cut again."""
    mesh = grads.layout.mesh
    gn = torch.sqrt(sharded.sq_norm(grads))
    scale = torch.clamp_max(1.0 / (gn + 1e-12), 1.0)
    grads = grads.rebuild([g * scale.to(g.device) for g in grads])
    if cfg.train.optimizer != "adafactor":
        updates, opt_state = _update_by_device(opt, grads, state.opt_state, state.params)
    else:
        whole, opt_state = opt.update(sharded.gather_tree(grads), sharded.gather_state(state.opt_state))
        updates = sharded.shard_tree(whole, grads.layout.specs, mesh)
        opt_state = sharded.shard_state(cfg, opt_state, mesh)
    return apply_updates(state.params, updates), opt_state


def make_train_step(cfg: ModelConfig, optimizer: Optimizer | None = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.
    ``cfg.train.microbatches > 1`` splits the batch and accumulates fp32
    gradients (and metrics) as ``acc + g / n`` over the microbatches in
    order; then gradients are clipped to global norm 1.0 and the optimizer
    steps. Under a model mesh (``models.dist``) the state is held in blocks
    (``launch.sharded.shard_state``): each microbatch's gradients come from
    :func:`_sharded_grads` and :func:`_sharded_update` clips and steps."""
    opt = optimizer or make_optimizer(cfg)
    n_micro = max(1, cfg.train.microbatches)

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        mesh = _mesh_of(state.params)
        batch = _on(batch, _device_of(state.params) if mesh is None else mesh.first_device)

        def grad_fn(b: dict):
            return _grads(cfg, state.params, b) if mesh is None else _sharded_grads(cfg, state.params, b, mesh)

        if n_micro == 1:
            metrics, grads = grad_fn(batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % n_micro:
                raise ValueError(f"global batch {b} not divisible by {n_micro} microbatches")
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), state.params)
            metrics = None
            for i in range(n_micro):
                mb = {k: v.reshape(n_micro, b // n_micro, *v.shape[1:])[i] for k, v in batch.items()}
                m, g = grad_fn(mb)
                grads = tree_map(lambda a, x: a + x.to(torch.float32) / n_micro, grads, g)
                if metrics is None:
                    metrics = {k: torch.zeros((), dtype=torch.float32, device=v.device) for k, v in m.items()}
                metrics = {k: metrics[k] + m[k] / n_micro for k in metrics}
        with torch.no_grad():
            if mesh is not None:
                params, opt_state = _sharded_update(cfg, opt, state, grads)
            else:
                grads = clip_by_global_norm(grads, 1.0)
                updates, opt_state = opt.update(grads, state.opt_state, state.params)
                params = apply_updates(state.params, updates)
        new_state = TrainState(params=params, opt_state=opt_state, step=state.step + 1)
        return new_state, dict(metrics, step=new_state.step)

    return train_step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params: PyTree, batch: dict) -> dict:
        mesh = _mesh_of(params)
        batch = _on(batch, mesh.first_device if mesh is not None else _device_of(params))
        logits = _sharded_forward(cfg, params, batch, mesh)[0] if mesh is not None else forward(cfg, params, batch)[0]
        ce = cross_entropy(logits, batch["labels"], cfg.vocab_size)
        pred = torch.argmax(logits, dim=-1)
        acc = torch.mean((pred == batch["labels"].long()).to(torch.float32))
        return {"ce": ce, "accuracy": acc}

    return eval_step


def make_prefill_step(cfg: ModelConfig):
    """Full-context forward: the last position's logits ``(B, 1, V)`` and
    exact-length caches. Only the last position is projected to logits
    (``forward(..., last=1)``), the reference's ``logits[:, -1:]`` without
    the ``(B, S, V)`` tensor."""

    @torch.no_grad()
    def prefill(params: PyTree, batch: dict) -> tuple[torch.Tensor, PyTree]:
        mesh = _mesh_of(params)
        if mesh is not None:
            return _sharded_forward(cfg, params, batch, mesh, return_cache=True, last=1)
        logits, _, cache = forward(cfg, params, batch, return_cache=True, last=1)
        return logits, cache

    return prefill


def _sharded_forward(cfg: ModelConfig, params: sharded.ShardedTree, batch: dict, mesh, **kw):
    """``forward`` over each group of batch shards (:func:`_shard_groups`);
    the logits and (with ``return_cache``) each cache leaf concatenated
    over the shards in order along its batch dim, on the mesh's first
    device: ``(logits, cache or None)``."""
    first = mesh.first_device
    x = next(iter(batch.values()))
    logits, caches = [], []
    for group in _shard_groups(cfg, mesh, x.shape[0]):
        reads = sharded.Reads(params)
        parts = [dist.place({k: torch.as_tensor(v)[rows].to(mesh.device(b, 0)) for k, v in batch.items()}, b)
                 for b, rows in group]
        outs, _, cs = forward_shards(cfg, [sharded.view(params, b, reads) for b, _ in group], parts, **kw)
        logits += [out.to(first) for out in outs]
        caches += cs
    logits = dist.join_cat(logits, first, 0)
    if not kw.get("return_cache"):
        return logits, None
    cache = {"len": caches[0]["len"]}
    if "prefix" in caches[0]:
        cache["prefix"] = tree_map(lambda *t: dist.join_cat(list(t), first, 0), *[c["prefix"] for c in caches])
    if "blocks" in caches[0]:
        cache["blocks"] = tree_map(lambda *t: dist.join_cat(list(t), first, 1), *[c["blocks"] for c in caches])
    return logits, cache


def make_serve_step(cfg: ModelConfig):
    """One-token decode against fixed-size buffers, updated in place."""

    @torch.no_grad()
    def serve(params: PyTree, cache: PyTree, batch: dict) -> tuple[torch.Tensor, PyTree]:
        mesh = _mesh_of(params)
        if mesh is not None:
            return _sharded_serve(cfg, params, cache, batch, mesh)
        logits, _, new_cache = forward(cfg, params, batch, cache=cache)
        return logits, new_cache

    return serve


def _sharded_serve(cfg: ModelConfig, params: sharded.ShardedTree, cache: dict, batch: dict, mesh):
    """One decode step over a model mesh: each group of batch shards
    (:func:`_shard_groups`) reads its rows of the buffers
    (``launch.sharded.shard_cache``'s placement), decodes, and writes them
    back; the logits join in shard order."""
    first = mesh.first_device
    tokens = torch.as_tensor(batch["tokens"])
    logits = []
    for group in _shard_groups(cfg, mesh, tokens.shape[0]):
        reads = sharded.Reads(params)
        devs = [mesh.device(b, 0) for b, _ in group]
        local = [dist.place(sharded.cache_rows(cache, rows, dev), b) for (b, rows), dev in zip(group, devs)]
        outs, _, local = forward_shards(cfg, [sharded.view(params, b, reads) for b, _ in group],
                                        [dist.place({"tokens": tokens[rows].to(dev)}, b)
                                         for (b, rows), dev in zip(group, devs)],
                                        caches=local)
        for (_, rows), lc, out in zip(group, local, outs):
            sharded.store_rows(cache, rows, lc)
            logits.append(out.to(first))
    return dist.join_cat(logits, first, 0), {"len": cache["len"] + 1, "buffers": cache["buffers"]}
