"""Functional optimizers (counterpart of ``repro.optim.optimizers``).

The (init, update) pair convention of the reference::

    opt = adam(1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Params, gradients and updates are trees of tensors; a state is a
NamedTuple of a step (a 0-d int32 tensor) and tensor trees, leaf for leaf
the reference's, so a test can compare them. Every op is the reference's
fp32 op in its order. Nothing is written in place: ``apply_updates``
returns new tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.common.pytrees import tree_leaves, tree_map

PyTree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


def _as_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def _step0(params: PyTree) -> torch.Tensor:
    """The int32 step counter, on the params' device."""
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else "cpu")


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[..., tuple[PyTree, PyTree]]


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


class SGDState(NamedTuple):
    step: torch.Tensor


def sgd(lr) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return SGDState(step=_step0(params))

    def update(grads, state, params=None):
        lr_t = sched(state.step)
        return tree_map(lambda g: -lr_t * g, grads), SGDState(step=state.step + 1)

    return Optimizer(init, update)


class MomentumState(NamedTuple):
    step: torch.Tensor
    velocity: PyTree


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return MomentumState(step=_step0(params), velocity=tree_map(_zeros32, params))

    def update(grads, state, params=None):
        lr_t = sched(state.step)
        vel = tree_map(lambda v, g: beta * v + g, state.velocity, grads)
        if nesterov:
            updates = tree_map(lambda v, g: -lr_t * (beta * v + g), vel, grads)
        else:
            updates = tree_map(lambda v: -lr_t * v, vel)
        return updates, MomentumState(step=state.step + 1, velocity=vel)

    return Optimizer(init, update)


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: PyTree
    nu: PyTree


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """Adam; with ``weight_decay`` > 0 this is AdamW (decoupled decay)."""
    sched = _as_schedule(lr)

    def init(params):
        return AdamState(step=_step0(params), mu=tree_map(_zeros32, params), nu=tree_map(_zeros32, params))

    def update(grads, state, params=None):
        step = state.step + 1
        lr_t = sched(state.step)
        grads32 = tree_map(lambda g: g.to(torch.float32), grads)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads32)
        nu = tree_map(lambda n, g: b2 * n + (1 - b2) * g * g, state.nu, grads32)
        step_f = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, step_f)
        bc2 = 1.0 - torch.pow(b2, step_f)

        def upd(m, n, p):
            u = -lr_t * (m / bc1) / (torch.sqrt(n / bc2) + eps)
            if weight_decay:
                u = u - lr_t * weight_decay * p.to(torch.float32)
            return u

        if params is None and weight_decay:
            raise ValueError("adamw requires params for decoupled weight decay")
        if params is None:
            params = tree_map(torch.zeros_like, mu)
        return tree_map(upd, mu, nu, params), AdamState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    return adam(lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    """Scale every gradient by ``min(1, max_norm / (global L2 norm + 1e-12))``."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves))
    scale = torch.clamp_max(max_norm / (gn + 1e-12), 1.0)
    return tree_map(lambda g: g * scale, grads)
