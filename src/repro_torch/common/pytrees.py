"""Parameter-tree arithmetic for the PyTorch port.

A parameter tree is nested dicts / lists / tuples whose leaves are tensors
(the MLP is a list of ``{"w", "b"}`` dicts, the RNN a flat dict). Leaves
are visited in the reference's pytree order — dict keys sorted, lists in
order — so a flattened MLP row is ``[b0, w0, b1, w1, ...]`` with every ``w``
kept ``(din, dout)``, element for element the row the JAX package builds.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch

PyTree = Any


def tree_leaves(tree: PyTree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    if tree is None:
        return []
    return [tree]


def tree_flatten_with_names(tree: PyTree, names: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(names, leaf)`` in tree order, ``names`` the path's entries as the
    reference's sharding rules read them (``getattr(entry, "key", None)``):
    a dict key as itself, a list index or NamedTuple field as None."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in tree_flatten_with_names(tree[k], names + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for x in tree for item in tree_flatten_with_names(x, names + (None,))]
    if tree is None:
        return []
    return [(names, tree)]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Apply ``fn`` leafwise over trees of one structure (dict keys come
    back sorted, as the reference's unflatten returns them)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return rebuild_seq(tree, [tree_map(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree)])
    return fn(tree, *rest)


def is_namedtuple(tree: PyTree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


class TaggedSeq(tuple):
    """A tuple that carries a tag, ``meta`` (hashable; a sharded tree's
    layout), and keeps it through ``tree_map`` and ``tree_unflatten``."""

    def __new__(cls, items=(), meta=None):
        self = super().__new__(cls, items)
        self.meta = meta
        return self

    def rebuild(self, items):
        """``items`` in a sequence of this one's type and tag."""
        return type(self)(items, self.meta)


def rebuild_seq(like: list | tuple, items: list) -> list | tuple:
    """``items`` as a sequence of ``like``'s type: a NamedTuple (such as a
    ``TrainState``) takes them as fields, a :class:`TaggedSeq` keeps its
    tag."""
    if isinstance(like, TaggedSeq):
        return like.rebuild(items)
    return type(like)(*items) if is_namedtuple(like) else type(like)(items)


def _skeleton(tree: PyTree):
    """Hashable structure descriptor (leaves dropped)."""
    if isinstance(tree, dict):
        return ("d", tuple((k, _skeleton(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        if isinstance(tree, TaggedSeq):
            kind = (type(tree), tree.meta)
        else:
            kind = "l" if isinstance(tree, list) else type(tree) if is_namedtuple(tree) else "t"
        return (kind, tuple(_skeleton(x) for x in tree))
    return "*"


def _build(skel, leaves: list) -> PyTree:
    """Rebuild a tree from its skeleton, consuming ``leaves`` in order."""
    if skel == "*":
        return leaves.pop()
    kind, body = skel
    if kind == "d":
        return {k: _build(s, leaves) for k, s in body}
    items = [_build(s, leaves) for s in body]
    if isinstance(kind, tuple):  # a TaggedSeq: (its class, its tag)
        return kind[0](items, kind[1])
    return items if kind == "l" else tuple(items) if kind == "t" else kind(*items)


def tree_unflatten(template: PyTree, leaves: list) -> PyTree:
    """A tree of ``template``'s structure with ``leaves`` (in tree order)."""
    return _build(_skeleton(template), list(leaves)[::-1])


def tree_l1(a: PyTree, b: PyTree | None = None) -> torch.Tensor:
    """Sum of absolute (differences of) leaves — Eq. 1's L1 distance."""
    if b is None:
        parts = [torch.sum(torch.abs(x)) for x in tree_leaves(a)]
    else:
        parts = [torch.sum(torch.abs(x - y)) for x, y in zip(tree_leaves(a), tree_leaves(b))]
    return torch.sum(torch.stack(parts)) if parts else torch.zeros(())


def tree_lerp(a: PyTree, b: PyTree, t: float) -> PyTree:
    """(1 - t) * a + t * b leafwise, each product rounded before the sum."""
    return tree_map(lambda x, y: torch.mul(x, 1.0 - t) + torch.mul(y, t), a, b)


def tree_weighted_mean(trees: list[PyTree], weights) -> PyTree:
    """Weighted average of trees (the baselines' aggregation), in the
    reference's op order, one op at a time: ``w / w.sum()`` in fp32 (the
    sum of integer sample counts is exact), then ``0 + w0·l0 + w1·l1 + ...``
    leafwise. The integer 0 it starts from turns a -0 sum into +0."""
    w = torch.tensor(weights, dtype=torch.float32)
    w = w / torch.sum(w)
    return tree_map(lambda *leaves: sum(wi * leaf for wi, leaf in zip(w, leaves)), *trees)


class FlattenSpec:
    """Flatten/unflatten plan for one tree structure.

    ``flatten`` concatenates the leaves (one launch); ``unflatten`` returns
    views into the vector it is given, so the vector must not be written in
    place afterwards (the port never writes a vector it handed out)."""

    def __init__(self, template: PyTree):
        leaves = tree_leaves(template)
        self.skeleton = _skeleton(template)
        self.shapes = tuple(tuple(x.shape) for x in leaves)
        self.sizes = tuple(math.prod(s) if s else 1 for s in self.shapes)
        offsets, off = [], 0
        for n in self.sizes:
            offsets.append(off)
            off += n
        self.offsets = tuple(offsets)
        self.dim = off

    def flatten(self, tree: PyTree) -> torch.Tensor:
        leaves = tree_leaves(tree)
        return torch.cat([torch.as_tensor(x).reshape(-1).to(torch.float32) for x in leaves])

    def flatten_batched(self, tree_b: PyTree) -> torch.Tensor:
        """Leaves ``(B, *shape)`` -> ``(B, dim)``."""
        leaves = tree_leaves(tree_b)
        return torch.cat([x.reshape(x.shape[0], -1).to(torch.float32) for x in leaves], dim=1)

    def unflatten(self, vec: torch.Tensor) -> PyTree:
        parts = [
            vec[off: off + n].reshape(shape)
            for off, n, shape in zip(self.offsets, self.sizes, self.shapes)
        ]
        return _build(self.skeleton, parts[::-1])

    def unflatten_batched(self, mat: torch.Tensor) -> PyTree:
        """``(B, dim)`` -> tree with leaves ``(B, *shape)`` (views)."""
        B = mat.shape[0]
        parts = [
            mat[:, off: off + n].reshape((B, *shape))
            for off, n, shape in zip(self.offsets, self.sizes, self.shapes)
        ]
        return _build(self.skeleton, parts[::-1])


_SPEC_CACHE: dict = {}


def flatten_spec(template: PyTree) -> FlattenSpec:
    """Memoized :class:`FlattenSpec` for ``template``'s structure."""
    key = (_skeleton(template), tuple(tuple(x.shape) for x in tree_leaves(template)))
    spec = _SPEC_CACHE.get(key)
    if spec is None:
        spec = _SPEC_CACHE[key] = FlattenSpec(template)
    return spec


def tree_flat_vector(a: PyTree) -> torch.Tensor:
    return flatten_spec(a).flatten(a)


def tree_unflatten_vector(vec: torch.Tensor, like: PyTree) -> PyTree:
    return flatten_spec(like).unflatten(vec)

