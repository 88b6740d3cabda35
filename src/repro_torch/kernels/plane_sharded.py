"""Sharded execution of the batched plane kernels (counterpart of
``repro.kernels.plane_sharded``).

When the parameter plane spreads its rows over a
:class:`~repro_torch.launch.mesh.PlaneMesh`, each entry point here
launches the single-device kernel (``local_fn``: the CUDA kernel on a card,
its plain version on the CPU) once a shard, on that shard's operand and
device, and joins the outputs on the mesh's first device. The joins, in a
fixed order:

  * ``l1_pairwise_sharded``: query rows over ``plane``, one launch a row
    shard against the replicated centers; the (M, C) blocks concatenate in
    shard order. With a ``model`` axis each (row shard r, dim chunk m)
    scores its chunk: r's distances are ``((d_r0 + d_r1) + d_r2) + ...``,
    summed over m in order. A chunk's L1 is the kernel's fixed order
    (``csrc/l1_rows.cuh``) on the chunk alone, cut into 4,096-element
    chunks from the chunk's own start, so a dim-sharded distance may differ
    from the single-device one in the last ulps.
  * ``assign_lerp_sharded``: center rows over ``plane``; each shard's
    ``l1_distance`` (partial sums added over m in order), padded rows set
    to +inf by global row id, the distance blocks concatenated in shard
    order, and the first-index argmin there. The winning row is fetched
    without a host read: each shard takes its row at the clamped local
    index, zeroes it unless it owns the winner, and the rows are added in
    shard order, ``((0 + w_0) + w_1) + ...`` (so a -0 comes back +0, as
    the reference's one-hot ``psum``). Then the pinned two-op blend
    (``assign_lerp.blend_plain``, the ops of ``core/plane.py::lerp_vec``), a
    dim chunk at a time on a model axis: elementwise, so bitwise the
    single-device blend of the same row.
  * ``chi2_rows_sharded``: probe rows over ``(plane, model)`` jointly, one
    launch a shard; scores concatenate in shard order (plane-major).
  * ``chi2_all_sharded``: member rows over ``(plane, model)``; g
    concatenates, and each shard's segment sums are added in shard order,
    ``((s_0 + s_1) + s_2) + ...``: the single-device kernel sums in another
    order, so they may differ in the last ulp. They feed the reported
    feedback means, never a decision.

Per-row arithmetic runs unchanged on the shard that owns the row, so
distances (row-sharded), scores, g and blended rows are bitwise those of
the single-device kernels. Padding and placement belong to the dispatch
(``ops._to_mesh_rows``): these functions take shard-divisible
:class:`MeshRows`, whose layout (row shards, dim chunks) says which axes
they run over, and slice nothing off. Each counts its calls in
``.calls``; the kernels count their launches themselves.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.kernels.assign_lerp import blend_plain


@dataclasses.dataclass
class MeshRows:
    """A row-batched operand over a mesh: ``parts[k][m]`` is row shard k's
    m-th dim chunk on its device. ``rows`` is the true row count (the parts
    hold it padded to a multiple of the shard count); ``joint`` marks rows
    spread over ``(plane, model)`` jointly, shard ``k = r * M + m`` on
    ``devices[r][m]``, with no dim chunks."""

    parts: list[list[torch.Tensor]]
    rows: int
    joint: bool = False

    @property
    def shape(self) -> tuple[int, ...]:
        """The operand's logical shape: the true rows, the whole width."""
        first = self.parts[0]
        return (self.rows, sum(p.shape[1] for p in first)) + tuple(first[0].shape[2:])

    @property
    def rows_local(self) -> int:
        return self.parts[0][0].shape[0]

    def gather(self, device: torch.device) -> torch.Tensor:
        """The whole ``(rows, ...)`` operand on ``device`` (padding dropped)."""
        blocks = [torch.cat([p.to(device) for p in chunks], dim=1) if len(chunks) > 1 else chunks[0].to(device)
                  for chunks in self.parts]
        return torch.cat(blocks, dim=0)[: self.rows]


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t.to(device).contiguous()


def _dim_chunks(x: torch.Tensor, m: int) -> list[torch.Tensor]:
    return list(torch.chunk(x, m, dim=-1))


def _ordered_sum(terms: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    acc = terms[0].to(device)
    for t in terms[1:]:
        acc = acc + t.to(device)
    return acc


def l1_pairwise_sharded(xs: MeshRows, centers: torch.Tensor, mesh,
                        local_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """(M_padded, C) pairwise L1 with the query rows over their shards and,
    where ``xs`` is in dim chunks, each chunk's sums added over the chunks."""
    l1_pairwise_sharded.calls += 1
    first = mesh.first_device
    c_chunks = _dim_chunks(centers, len(xs.parts[0]))
    blocks = []
    for r, chunks in enumerate(xs.parts):
        partial = [local_fn(x, _on(c, x.device)) for x, c in zip(chunks, c_chunks)]
        blocks.append(_ordered_sum(partial, first))
    return torch.cat(blocks, dim=0)


def assign_lerp_sharded(u: torch.Tensor, centers: MeshRows, beta: float, mesh,
                        local_dist_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                        valid_rows: int | None = None):
    """Sharded Eq. 1 argmin + blend: (dists (C,), idx () int32, blended (N,)).
    Rows at or past ``valid_rows`` (the shard padding) never win."""
    assign_lerp_sharded.calls += 1
    first = mesh.first_device
    C = centers.rows if valid_rows is None else valid_rows
    rl = centers.rows_local
    u_chunks = _dim_chunks(u, len(centers.parts[0]))
    dists = []
    for r, chunks in enumerate(centers.parts):
        partial = [local_dist_fn(_on(uc, c.device), c) for uc, c in zip(u_chunks, chunks)]
        d = _ordered_sum(partial, chunks[0].device)
        gids = r * rl + torch.arange(rl, device=d.device)
        dists.append(torch.where(gids < C, d, torch.full_like(d, float("inf"))).to(first))
    d_full = torch.cat(dists)
    idx = torch.argmin(d_full).to(torch.int32)  # first index among ties
    blended = []
    for m, uc in enumerate(u_chunks):  # the winner's chunk m: owner's row, others' zeros, in shard order
        row = torch.zeros_like(uc)
        for r, chunks in enumerate(centers.parts):
            block = chunks[m]
            i = idx.to(block.device).long()
            local = torch.clamp(i - r * rl, 0, rl - 1)
            owned = (i >= r * rl) & (i < (r + 1) * rl)
            cand = block.index_select(0, local.reshape(1))[0]
            row = row + torch.where(owned, cand, torch.zeros((), device=block.device)).to(first)
        blended.append(blend_plain(row, uc, beta))
    out = torch.cat(blended) if len(blended) > 1 else blended[0]
    return d_full[:C], idx, out


def chi2_rows_sharded(f_pred: MeshRows, f_true: MeshRows, s_soft: MeshRows, mesh,
                      local_fn: Callable[..., torch.Tensor]) -> torch.Tensor:
    """(M_padded,) per-row scores, one launch a shard."""
    chi2_rows_sharded.calls += 1
    first = mesh.first_device
    return torch.cat([local_fn(a[0], b[0], c[0]).to(first)
                      for a, b, c in zip(f_pred.parts, f_true.parts, s_soft.parts)])


def chi2_all_sharded(f_pred: MeshRows, f_true: MeshRows, s_soft: MeshRows, seg_ids: MeshRows,
                     num_segments: int, mesh, local_fn: Callable[..., tuple]) -> tuple[torch.Tensor, torch.Tensor]:
    """(g (M_padded,), seg_sum (S,)): g a shard at a time, the segment sums
    added in shard order (padded rows carry segment -1 and join none)."""
    chi2_all_sharded.calls += 1
    first = mesh.first_device
    gs, segs = [], []
    for a, b, c, s in zip(f_pred.parts, f_true.parts, s_soft.parts, seg_ids.parts):
        g, seg = local_fn(a[0], b[0], c[0], s[0], num_segments)
        gs.append(g.to(first))
        segs.append(seg)
    return torch.cat(gs), _ordered_sum(segs, first)


SHARDED = {
    "l1_distance_pairwise": l1_pairwise_sharded,
    "assign_and_lerp": assign_lerp_sharded,
    "chi2_feedback": chi2_rows_sharded,
    "chi2_feedback_segmented": chi2_all_sharded,
}
for _fn in SHARDED.values():
    _fn.calls = 0
