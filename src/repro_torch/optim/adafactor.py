"""Adafactor (Shazeer & Stern, 2018), counterpart of
``repro.optim.adafactor``: the second moment of a leaf whose last two axes
are both at least ``min_dim_size_to_factor`` is kept factored, as row and
column means, so its state is O(rows + cols); smaller leaves keep the full
second moment. Updates are clipped by their RMS.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.common.pytrees import tree_map
from repro_torch.optim.optimizers import Optimizer, _as_schedule, _step0

PyTree = Any


class _FactoredSlot(NamedTuple):
    vr: torch.Tensor  # row second moment (shape[:-1])
    vc: torch.Tensor  # column second moment (shape without the -2 axis)


class AdafactorState(NamedTuple):
    step: torch.Tensor
    slots: PyTree  # params' structure: a _FactoredSlot for a factored leaf, else a tensor


def _decay(step: torch.Tensor, d: float = 0.8) -> torch.Tensor:
    t = step.to(torch.float32) + 1.0
    return 1.0 - t ** -d


def _map_with_slots(fn, grads: PyTree, slots: PyTree):
    """``fn(g, slot)`` over ``grads``' leaves, a slot being a tensor or a
    whole :class:`_FactoredSlot`; returns the two trees of its results."""
    if isinstance(grads, dict):
        pairs = {k: _map_with_slots(fn, grads[k], slots[k]) for k in sorted(grads)}
        return {k: a for k, (a, _) in pairs.items()}, {k: b for k, (_, b) in pairs.items()}
    if isinstance(grads, (list, tuple)):
        pairs = [_map_with_slots(fn, g, s) for g, s in zip(grads, slots)]
        return type(grads)(a for a, _ in pairs), type(grads)(b for _, b in pairs)
    return fn(grads, slots)


def adafactor(lr, min_dim_size_to_factor: int = 128, clip_threshold: float = 1.0, eps: float = 1e-30) -> Optimizer:
    sched = _as_schedule(lr)

    def factored(p) -> bool:
        return p.dim() >= 2 and p.shape[-1] >= min_dim_size_to_factor and p.shape[-2] >= min_dim_size_to_factor

    def init(params):
        def slot(p):
            if factored(p):
                return _FactoredSlot(
                    vr=torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                    vc=torch.zeros((*p.shape[:-2], p.shape[-1]), dtype=torch.float32, device=p.device),
                )
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return AdafactorState(step=_step0(params), slots=tree_map(slot, params))

    def update(grads, state, params=None):
        step = state.step
        beta = _decay(step)
        lr_t = sched(step)

        def upd(g, s):
            g32 = g.to(torch.float32)
            g2 = torch.square(g32) + eps
            if isinstance(s, _FactoredSlot):
                vr = beta * s.vr + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s.vc + (1 - beta) * torch.mean(g2, dim=-2)
                denom = torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True), eps)
                vhat = vr[..., None] * vc[..., None, :] / denom[..., None]
                new_slot = _FactoredSlot(vr=vr, vc=vc)
            else:
                vhat = beta * s + (1 - beta) * g2
                new_slot = vhat
            u = g32 * torch.rsqrt(vhat + eps)
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + eps)  # update clipping by RMS
            u = u / torch.clamp_min(rms_u / clip_threshold, 1.0)
            return -lr_t * u, new_slot

        updates, slots = _map_with_slots(upd, grads, state.slots)
        return updates, AdafactorState(step=step + 1, slots=slots)

    return Optimizer(init, update)
