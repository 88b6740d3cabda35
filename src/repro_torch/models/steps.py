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
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.common.pytrees import tree_leaves, tree_map, tree_unflatten
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import forward
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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mean next-token cross entropy in fp32; labels outside ``[0, vocab)``
    (the padded vocab's tail) are masked out."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    gold = torch.gather(logits, -1, labels.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    valid = (labels >= 0) & (labels < vocab)
    ce = torch.where(valid, logz - gold, torch.zeros((), device=logits.device))
    return torch.sum(ce) / torch.clamp_min(torch.sum(valid), 1)


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


def make_train_step(cfg: ModelConfig, optimizer: Optimizer | None = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.
    ``cfg.train.microbatches > 1`` splits the batch and accumulates fp32
    gradients (and metrics) as ``acc + g / n`` over the microbatches in
    order; then gradients are clipped to global norm 1.0 and the optimizer
    steps."""
    opt = optimizer or make_optimizer(cfg)
    n_micro = max(1, cfg.train.microbatches)

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        batch = _on(batch, _device_of(state.params))
        if n_micro == 1:
            metrics, grads = _grads(cfg, state.params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % n_micro:
                raise ValueError(f"global batch {b} not divisible by {n_micro} microbatches")
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), state.params)
            metrics = None
            for i in range(n_micro):
                mb = {k: v.reshape(n_micro, b // n_micro, *v.shape[1:])[i] for k, v in batch.items()}
                m, g = _grads(cfg, state.params, mb)
                grads = tree_map(lambda a, x: a + x.to(torch.float32) / n_micro, grads, g)
                if metrics is None:
                    metrics = {k: torch.zeros((), dtype=torch.float32, device=v.device) for k, v in m.items()}
                metrics = {k: metrics[k] + m[k] / n_micro for k in metrics}
        with torch.no_grad():
            grads = clip_by_global_norm(grads, 1.0)
            updates, opt_state = opt.update(grads, state.opt_state, state.params)
            params = apply_updates(state.params, updates)
        new_state = TrainState(params=params, opt_state=opt_state, step=state.step + 1)
        return new_state, dict(metrics, step=new_state.step)

    return train_step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params: PyTree, batch: dict) -> dict:
        batch = _on(batch, _device_of(params))
        logits, _, _ = forward(cfg, params, batch)
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
        logits, _, cache = forward(cfg, params, batch, return_cache=True, last=1)
        return logits, cache

    return prefill


def make_serve_step(cfg: ModelConfig):
    """One-token decode against fixed-size buffers, updated in place."""

    @torch.no_grad()
    def serve(params: PyTree, cache: PyTree, batch: dict) -> tuple[torch.Tensor, PyTree]:
        logits, _, new_cache = forward(cfg, params, batch, cache=cache)
        return logits, new_cache

    return serve
