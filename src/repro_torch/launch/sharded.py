"""Trees held in blocks over a model mesh (the port's counterpart of the
reference's ``jax.device_put(tree, shardings)``), and what the step
functions' shard loops (``models.steps``) read and write through.

A :class:`ShardedTree` holds every leaf of a tree as its blocks, cut by a
spec of :mod:`repro_torch.launch.shardings`: a dim whose spec names mesh
axes is cut into as many equal blocks as those axes have shards, the
others stay whole. **A block lives once**: the shards that share it (the
data replicas of a tensor-parallel weight, every shard of a norm) read one
tensor, on the device of the first shard in mesh order that holds it, and
an update writes it once. On a mesh that repeats one card, the blocks of a
tree take the tree's own bytes, however many shards the mesh has.

The blocks follow the tree's leaves in order, each leaf's row-major over
its cut dims, so ``tree_map`` over trees of one layout (params, gradients,
AdamW's moments) runs block by block. :func:`gather_tree` joins the blocks
into whole leaves (checkpoints, the reference's files); :func:`view`
gives one batch shard's compute tree: a leaf cut over ``model`` becomes
:class:`~repro_torch.models.dist.Ranks` of its rank blocks, tagged with the
cut dim of the layer's leaf, a ZeRO leaf (cut over ``data``) is
concatenated in shard order first, and a stacked leaf whose period would
be a copy or would mix layers (the expert stacks cut on the period dim) is
read one period at a time (:class:`Periods`). The cuts the compute knows
are listed in ``KNOWN_SPLITS``; any other raises, naming the leaf.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any

import torch

from repro_torch.common.pytrees import (TaggedSeq, is_namedtuple, tree_flatten_with_names, tree_leaves, tree_map,
                                        tree_unflatten)
from repro_torch.launch.mesh import axis_size, batch_axes
from repro_torch.launch.shardings import cache_shardings_flat, param_shardings_flat
from repro_torch.models import dist
from repro_torch.models.dist import Ranks

PyTree = Any


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class _Leaf:
    shape: tuple[int, ...]
    axes: tuple[tuple[str, ...], ...]  # per dim, the mesh axes cutting it (major first)
    splits: tuple[int, ...]            # per dim, the blocks along it
    offset: int                        # the first block's index among the tree's blocks

    @property
    def count(self) -> int:
        return math.prod(self.splits)

    def block_shape(self) -> tuple[int, ...]:
        return tuple(n // s for n, s in zip(self.shape, self.splits))

    def index(self, multi: tuple[int, ...]) -> int:
        flat = 0
        for i, s in zip(multi, self.splits):
            flat = flat * s + i
        return self.offset + flat


class Layout:
    """Where each leaf's blocks are: the specs fitted to the leaves' ranks
    and the blocks' home devices."""

    def __init__(self, template: PyTree, specs: list[tuple], mesh):
        self.mesh = mesh
        self.specs = list(specs)
        self.template = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), template)
        self.leaves: list[_Leaf] = []
        self.homes: list[torch.device] = []
        offset = 0
        for t, spec in zip(tree_leaves(template), specs):
            spec = tuple(spec) + (None,) * (t.dim() - len(spec))
            axes = tuple(_entry_axes(e) for e in spec)
            splits = tuple(math.prod(axis_size(mesh, a) for a in ax) for ax in axes)
            for n, s in zip(t.shape, splits):
                if n % s:
                    raise ValueError(f"a dim of {n} does not split into {s} blocks")
            leaf = _Leaf(tuple(t.shape), axes, splits, offset)
            self.leaves.append(leaf)
            self.homes += [self._home(leaf, multi) for multi in itertools.product(*map(range, splits))]
            offset += leaf.count

    def _home(self, leaf: _Leaf, multi: tuple[int, ...]) -> torch.device:
        """The device of the first shard (in mesh order) that holds the block."""
        coord = {}
        for i, ax in zip(multi, leaf.axes):
            for a in reversed(ax):
                coord[a] = i % axis_size(self.mesh, a)
                i //= axis_size(self.mesh, a)
        b = coord.get("pod", 0) * axis_size(self.mesh, "data") + coord.get("data", 0)
        return self.mesh.device(b, coord.get("model", 0))


class ShardedTree(TaggedSeq):
    """A tree's blocks in order; ``meta`` is their :class:`Layout`."""

    @property
    def layout(self) -> Layout:
        return self.meta


def shard_tree(tree: PyTree, specs: list[tuple], mesh) -> ShardedTree:
    """Cut every leaf of ``tree`` by its spec (``specs`` in tree order) and
    put each block on its home device. A block already on its home device
    is a view of its leaf (the whole leaf, or a strided narrow of it), so
    placing a tree on a mesh that repeats its device copies nothing; a
    block bound for another device is copied there."""
    layout = Layout(tree, specs, mesh)
    blocks = []
    for t, leaf in zip(tree_leaves(tree), layout.leaves):
        size = leaf.block_shape()
        for multi in itertools.product(*map(range, leaf.splits)):
            block = t
            for dim, (i, n, s) in enumerate(zip(multi, size, leaf.splits)):
                if s > 1:
                    block = block.narrow(dim, i * n, n)
            blocks.append(block.to(layout.homes[leaf.index(multi)]))
    return ShardedTree(blocks, layout)


def _overlap(leaf: _Leaf, region: tuple[tuple[int, int], ...]) -> list[list[int]]:
    """Per dim, the block indices that meet ``region`` (a (start, stop) a dim)."""
    size = leaf.block_shape()
    return [list(range(lo // n, (hi - 1) // n + 1)) for (lo, hi), n in zip(region, size)]


def _piece(block: torch.Tensor, multi, leaf: _Leaf, region) -> torch.Tensor:
    """The part of a block inside ``region``."""
    for dim, (i, n, (lo, hi)) in enumerate(zip(multi, leaf.block_shape(), region)):
        b0 = i * n
        start, stop = max(lo, b0), min(hi, b0 + n)
        if (start, stop) != (b0, b0 + n):
            block = block.narrow(dim, start - b0, stop - start)
    return block


def read(tree: ShardedTree, i: int, region, device: torch.device) -> torch.Tensor:
    """Leaf ``i``'s ``region`` (a (start, stop) a dim) on ``device``, its
    blocks' parts concatenated in order; a region that is one whole block
    is that block. Differentiable in the blocks."""
    leaf = tree.layout.leaves[i]
    idx = _overlap(leaf, region)

    def assemble(prefix: tuple) -> torch.Tensor:
        dim = len(prefix)
        if dim == len(idx):
            return _piece(tree[leaf.index(prefix)], prefix, leaf, region).to(device)
        parts = [assemble(prefix + (j,)) for j in idx[dim]]
        return parts[0] if len(parts) == 1 else dist.join_cat(parts, device, dim)  # blocks joined: an all-gather

    return assemble(())


def write(tree: ShardedTree, i: int, region, value: torch.Tensor) -> None:
    """Copy ``value`` into leaf ``i``'s ``region``, block by block, in place."""
    leaf = tree.layout.leaves[i]
    for multi in itertools.product(*_overlap(leaf, region)):
        dst = _piece(tree[leaf.index(multi)], multi, leaf, region)
        src = value
        for dim, (j, n, (lo, hi)) in enumerate(zip(multi, leaf.block_shape(), region)):
            start = max(lo, j * n)
            src = src.narrow(dim, start - lo, dst.shape[dim])
        dst.copy_(src.to(dst.device))


def _whole(leaf: _Leaf) -> tuple[tuple[int, int], ...]:
    return tuple((0, n) for n in leaf.shape)


def gather_tree(tree: ShardedTree, device: torch.device | None = None) -> PyTree:
    """The whole tree, every leaf joined from its blocks on ``device``
    (default: the mesh's first device)."""
    dev = tree.layout.mesh.first_device if device is None else device
    leaves = [read(tree, i, _whole(leaf), dev) for i, leaf in enumerate(tree.layout.leaves)]
    return tree_unflatten(tree.layout.template, leaves)


# the model splits the compute knows: leaf name -> the dims of the layer's own leaf (a stacked ``blocks`` leaf's
# dims past the period dim) that the model axis may cut. A cut of the period dim itself is known for every leaf:
# each layer reads its whole leaf from the rank that holds it.
KNOWN_SPLITS = {
    "embed": (0,), "lm_head": (1,),                           # vocabulary
    "wq": (1,), "wk": (1,), "wv": (1,), "wo": (0,),           # attention and MLA heads; mLSTM's q/k/v input width
    "w_dkv": (1,), "w_ukv": (1,),                             # MLA: the latent's columns, the up-projection's heads
    "wg": (1,), "wu": (1,), "wd": (0,),                       # dense FFN and shared experts: the hidden width
    "w_in": (1,), "conv_w": (1,), "conv_b": (0,), "w_x": (0,), "w_dt": (1,), "dt_bias": (0,), "A_log": (0,),
    "D": (0,), "w_out": (0,),                                 # Mamba: d_inner
    "w_up": (1,), "w_i": (0,), "w_f": (0,), "w_down": (0,),   # mLSTM: d_inner
    "wgx": (2,), "wgh": (2,), "gbias": (1,), "ffn_up": (1,), "ffn_down": (0,),  # sLSTM: channels
}
KNOWN_EXPERT_SPLITS = {"wg": (0,), "wu": (0,)}                # an MoE layer's expert stacks: wg, wu over the experts


def _split_name(names: tuple) -> str:
    return next((k for k in reversed(names) if isinstance(k, str) and k in KNOWN_SPLITS), "")


def check_split(names: tuple, shape: tuple, spec: tuple, dim: int) -> int | None:
    """The layer-leaf dim that the model axis cuts in a leaf at ``names``
    cut over ``model`` on ``dim``: None for the period dim of a stacked
    leaf, else that dim less the period dim. Raise, naming the leaf and
    its spec, for a cut the compute does not know."""
    stacked = "blocks" in names
    if stacked and dim == 0:
        return None
    local = dim - stacked
    name = _split_name(names)
    expert = "ffn" in names and "shared" not in names and len(shape) - stacked == 3
    known = KNOWN_EXPERT_SPLITS.get(name, ()) if expert else KNOWN_SPLITS.get(name, ())
    if local not in known:
        path = "/".join(str(k) for k in names if k is not None)
        raise ValueError(f"repro_torch: leaf {path} {tuple(shape)} is placed {tuple(spec)}: the model axis cuts its "
                         f"dim {dim}, a split the sharded compute does not know")
    return local


class Reads:
    """The reads of one tree's blocks that the views of one step share: a
    region is read once a device (the views of batch shards on one device
    read their model ranks' parts once), a stacked leaf's period once a
    device and only while that period runs."""

    def __init__(self, tree: ShardedTree):
        self.tree, self.held, self.period, self.current = tree, {}, None, {}

    def get(self, i: int, region, device: torch.device, period: int | None = None) -> torch.Tensor:
        if period is None:
            cache = self.held
        else:
            if period != self.period:
                self.period, self.current = period, {}
            cache = self.current
        key = (i, region, device)
        if key not in cache:
            cache[key] = read(self.tree, i, region, device)
        return cache[key]


class Periods:
    """A stacked ``blocks`` leaf of a view that is read one period at a time:
    ``leaf[p]`` is period p's layer leaf, whole (the model axis cuts the
    period dim, or cuts nothing but ``data``) or as :class:`Ranks` of its
    model ranks' parts. Taken where the whole stacked leaf would be a copy
    (its blocks joined over ``data``) or would mix layers (rows of the
    period dim on different ranks)."""

    def __init__(self, reads: Reads, i: int, b: int, model_dim: int | None):
        self.reads, self.i, self.b, self.model_dim = reads, i, b, model_dim

    def __getitem__(self, p: int):
        tree = self.reads.tree
        leaf, mesh = tree.layout.leaves[self.i], tree.layout.mesh
        region = list(_whole(leaf))
        region[0] = (p, p + 1)
        if self.model_dim is None:
            return self.reads.get(self.i, tuple(region), mesh.device(self.b, 0), p)[0]
        tp = axis_size(mesh, "model")
        n = leaf.shape[self.model_dim] // tp
        parts = []
        for m in range(tp):
            region[self.model_dim] = (m * n, (m + 1) * n)
            parts.append(dist.place(self.reads.get(self.i, tuple(region), mesh.device(self.b, m), p)[0], rank=m))
        return Ranks(parts, self.model_dim - 1)


def view(tree: ShardedTree, b: int, reads: Reads | None = None) -> PyTree:
    """Batch shard ``b``'s compute tree. A leaf cut over ``model`` comes as
    :class:`Ranks` of its rank parts (each on that rank's device) tagged
    with the layer leaf's cut dim (``check_split``, which raises for a cut
    the compute does not know), any other whole on the shard's first
    device; dims cut over ``data`` (ZeRO) are joined in shard order. A
    stacked leaf whose period would be a copy or mix layers comes as
    :class:`Periods`. ``reads`` shares the reads among the views of one
    step (default: this view's own)."""
    mesh = tree.layout.mesh
    reads = Reads(tree) if reads is None else reads
    tp = axis_size(mesh, "model")
    names = [n for n, _ in tree_flatten_with_names(tree.layout.template)]
    leaves = []
    for i, leaf in enumerate(tree.layout.leaves):
        model_dim = next((d for d, ax in enumerate(leaf.axes) if "model" in ax), None)
        local = None if model_dim is None else check_split(names[i], leaf.shape, tree.layout.specs[i], model_dim)
        stacked = "blocks" in names[i]
        if stacked and (leaf.splits[0] > 1 or any(s > 1 for d, s in enumerate(leaf.splits) if d != model_dim)):
            leaves.append(Periods(reads, i, b, None if local is None else model_dim))
            continue
        if model_dim is None:
            leaves.append(reads.get(i, _whole(leaf), mesh.device(b, 0)))
            continue
        n = leaf.shape[model_dim] // tp
        parts = []
        for m in range(tp):
            region = list(_whole(leaf))
            region[model_dim] = (m * n, (m + 1) * n)
            parts.append(dist.place(reads.get(i, tuple(region), mesh.device(b, m)), rank=m))
        leaves.append(Ranks(parts, local))
    return tree_unflatten(tree.layout.template, leaves)


# ------------------------------------------------------------- batch shards
def batch_shards(mesh, batch: int) -> list[slice]:
    """The rows of each batch shard: ``batch`` over ``("pod", "data")`` where
    it divides (``shardings.batch_shardings``), else one shard that holds
    every row (the replicated batch is computed once)."""
    dp = math.prod(axis_size(mesh, a) for a in batch_axes(mesh))
    if batch % dp:
        return [slice(0, batch)]
    n = batch // dp
    return [slice(b * n, (b + 1) * n) for b in range(dp)]


def sq_norm(blocks: ShardedTree) -> torch.Tensor:
    """The squared L2 norm of a tree, block by block in order, on the mesh's
    first device: ``((s_0 + s_1) + s_2) + ...`` of the blocks' fp32 squares."""
    first = blocks.layout.mesh.first_device
    total, squares = None, []
    for t in blocks:
        s = torch.sum(torch.square(t.to(torch.float32))).to(first)
        squares.append(s)
        with dist.collective_ops():  # the blocks' squares joined: an all-reduce
            total = s if total is None else total + s
    dist.note_collective("all-reduce", total, squares)
    return total


# ------------------------------------------------------------ states, caches
def shard_state(cfg, state: PyTree, mesh) -> PyTree:
    """A ``TrainState`` (or params, or an optimizer state) placed by the
    reference's rules: every params-shaped tree by ``param_shardings`` (an
    optimizer slot tree by its parameters' names), scalars (the steps) on
    the mesh's first device."""
    if is_namedtuple(state):
        return type(state)(*(shard_state(cfg, x, mesh) for x in state))
    if isinstance(state, torch.Tensor) and state.dim() == 0:
        return state.to(mesh.first_device)
    return shard_tree(state, param_shardings_flat(cfg, mesh, state), mesh)


def gather_state(state: PyTree) -> PyTree:
    """The whole state of a :func:`shard_state` result (what a checkpoint
    holds)."""
    if isinstance(state, ShardedTree):
        return gather_tree(state)
    if is_namedtuple(state):
        return type(state)(*(gather_state(x) for x in state))
    return state


def state_template(state: PyTree) -> PyTree:
    """The whole state's structure, shapes and dtypes as meta tensors (a
    checkpoint restore's ``like``), without gathering it."""
    if isinstance(state, ShardedTree):
        return state.layout.template
    if is_namedtuple(state):
        return type(state)(*(state_template(x) for x in state))
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state)


def _batch_dims(template: PyTree) -> list[int]:
    """Each cache leaf's batch dim: 1 in the period-stacked ``blocks``, else 0."""
    return [1 if "blocks" in names else 0 for names, _ in tree_flatten_with_names(template)]


def shard_cache(cfg, cache: PyTree, mesh) -> dict:
    """Decode buffers placed by ``cache_shardings``: ``{"len": int,
    "buffers": ShardedTree}`` (the buffers without ``len``)."""
    rest = {k: v for k, v in cache.items() if k != "len"}
    batch = tree_leaves(rest)[0].shape[_batch_dims(rest)[0]]
    return {"len": cache["len"], "buffers": shard_tree(rest, cache_shardings_flat(cfg, mesh, rest, batch), mesh)}


def gather_cache(cache: dict) -> PyTree:
    return {"len": cache["len"], **gather_tree(cache["buffers"])}


def _row_regions(bufs: ShardedTree, rows: slice):
    """Each buffer's region of the batch shard ``rows``: those rows along its
    batch dim, the rest whole."""
    for i, (leaf, dim) in enumerate(zip(bufs.layout.leaves, _batch_dims(bufs.layout.template))):
        region = list(_whole(leaf))
        region[dim] = (rows.start, rows.stop)
        yield i, tuple(region)


def cache_rows(cache: dict, rows: slice, device: torch.device) -> PyTree:
    """One batch shard's decode buffers (whole over heads and positions)."""
    bufs = cache["buffers"]
    leaves = [read(bufs, i, region, device) for i, region in _row_regions(bufs, rows)]
    return {"len": cache["len"], **tree_unflatten(bufs.layout.template, leaves)}


def store_rows(cache: dict, rows: slice, local: PyTree) -> None:
    """Write a batch shard's decode buffers back into their blocks."""
    bufs = cache["buffers"]
    values = tree_leaves({k: v for k, v in local.items() if k != "len"})
    for (i, region), value in zip(_row_regions(bufs, rows), values):
        write(bufs, i, region, value)
