"""The registered model mesh (counterpart of ``repro.models.dist``).

The serve and train drivers register their :class:`~repro_torch.launch.
mesh.ModelMesh` here; the step functions read it and, on a mesh of more
than one device, run each batch shard and model rank in turn
(:mod:`repro_torch.launch.sharded`). Unset, or on a one-device mesh, every
step is the single-device code path.

The reference's ``constrain`` has no counterpart: it pins a GSPMD layout
where XLA would otherwise choose one. The port lays every block out itself,
and the points it pins are where the port joins the row-parallel partial
sums (``launch.sharded.join_sum``).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.common.pytrees import TaggedSeq, tree_leaves

_MESH = None
_COST = None  # the launch.cost.CostMode counting the ops, if one is


def place(tree, batch_shard: int | None = None, rank: int | None = None):
    """Mark the tensors of ``tree`` as batch shard ``batch_shard``'s and model
    rank ``rank``'s (``None``: every) for the dry-run's per-device counts
    (``launch.cost``); the tree itself is returned. Nothing happens unless
    a count runs."""
    if _COST is not None:
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                old = getattr(t, "_cost_place", None) or (None, None)
                t._cost_place = (old[0] if batch_shard is None else batch_shard, old[1] if rank is None else rank)
    return tree


def note_collective(kind: str, result: torch.Tensor, operands=()) -> None:
    """Record a join of the shard loops as the collective ``kind`` (the
    reference's names: ``all-reduce``, ``all-gather``, ...) while a count runs."""
    if _COST is not None:
        _COST.collective(kind, result, list(operands))


@contextlib.contextmanager
def collective_ops():
    """The ops of a join: a count does not bill them as compute (they are
    the collective's)."""
    if _COST is None:
        yield
        return
    with _COST.quiet():
        yield


class Ranks(TaggedSeq):
    """A value split over the ``model`` axis: ``ranks[m]`` is rank m's part,
    on rank m's device (a weight's column or row block, an activation's
    heads). ``tree_map`` maps over the parts and keeps the type and the
    tag: a weight's ``meta`` is the dim of the layer's leaf that the parts
    cut (``launch.sharded.view``)."""


class _PlacedGrads(torch.autograd.Function):
    """While a count runs: the identity on a join's parts, whose backward
    marks each part's gradient with the part's place, as the reference's
    sharded program holds it (a rank's slice of the joined gradient is that
    rank's, not every rank's)."""

    @staticmethod
    def forward(ctx, *parts):
        ctx.places = [getattr(p, "_cost_place", None) for p in parts]
        return tuple(p.view_as(p) for p in parts)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g, where in zip(grads, ctx.places):
            if g is not None and where is not None:
                g = place(g.view_as(g), *where)
            out.append(g)
        return tuple(out)


def _counted(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    if _COST is None or not any(p.requires_grad for p in parts):
        return parts
    return list(_PlacedGrads.apply(*parts))


def join_sum(partials: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The row-parallel join (an all-reduce): rank partial sums added in
    rank order on ``device``, ``((p_0 + p_1) + p_2) + ...``."""
    partials = _counted(partials)
    with collective_ops():
        acc = partials[0].to(device)
        for p in partials[1:]:
            acc = acc + p.to(device)
    note_collective("all-reduce", acc, partials)
    return acc


def join_cat(parts: list[torch.Tensor], device: torch.device, dim: int) -> torch.Tensor:
    """The column-parallel join (an all-gather): rank parts concatenated in
    rank order."""
    parts = _counted(parts)
    with collective_ops():
        out = torch.cat([p.to(device) for p in parts], dim=dim)
    note_collective("all-gather", out, parts)
    return out


def gathered(tree, device: torch.device):
    """A layer's params with every :class:`Ranks` weight joined whole on
    ``device`` along its cut dim (the compute that does not split a layer
    takes its leaves so)."""
    if isinstance(tree, dict):
        return {k: gathered(v, device) for k, v in tree.items()}
    if isinstance(tree, Ranks):
        return join_cat(list(tree), device, tree.meta)
    return tree


def kv_group(rank: int, h_local: int, heads: int, kv_heads: int) -> tuple[int, int]:
    """``(first KV head, count)`` that model rank ``rank`` reads when its
    ``h_local`` query heads are split but the ``kv_heads`` are not
    (``repro/kernels/ops.py:159-166``): ``max(1, h_local // G)`` heads from
    ``rank * h_local // G``, G the query heads a KV head serves."""
    group = heads // kv_heads
    return rank * h_local // group, max(1, h_local // group)


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def current_mesh():
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh):
    prev = _MESH
    set_mesh(mesh)
    try:
        yield
    finally:
        set_mesh(prev)


def sharded_mesh():
    """The registered mesh when it has more than one device, else None."""
    return _MESH if _MESH is not None and _MESH.size > 1 else None
