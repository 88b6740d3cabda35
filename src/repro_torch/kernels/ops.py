"""Public API of the kernels, on one device or over a plane mesh.

The protocol layer calls only these names. Each dispatches by the device
of the tensors it is given: CPU tensors run the plain PyTorch version,
CUDA tensors launch the hand-written kernel or raise.

The four batched plane entry points (``l1_distance_pairwise``,
``assign_and_lerp``, ``chi2_feedback``, ``chi2_feedback_segmented``) also
take ``mesh=`` (a :class:`~repro_torch.launch.mesh.PlaneMesh`) and
``dim_axis``, as the reference's do (``repro/kernels/ops.py:209-441``,
``:638-677``; rows always spread over the mesh's ``plane`` axis). Without
a mesh they are the single-device call unchanged. With one whose
``plane`` axis has more than one shard, or whose model axis is usable,
the operands are padded to a shard multiple and split over the
shards' devices (:func:`_to_mesh_rows`) and the kernel runs once a shard
(:mod:`repro_torch.kernels.plane_sharded`). The model axis shards the L1
kernels' dim only when its extent divides the width; it lends the chi2
kernels rows. ``dim_axis=None`` turns model-axis compute off (the
reference's ``REPRO_PLANE_MODEL_COMPUTE=off``): a dim-sharded row store
then joins each row shard's dim chunks before the launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import assign_lerp as _assign_lerp
from repro_torch.kernels import chi2 as _chi2
from repro_torch.kernels import l1 as _l1
from repro_torch.kernels import plane_sharded
from repro_torch.kernels.plane_sharded import MeshRows
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_with_lse
from repro_torch.kernels.flash_attention_bwd import (
    flash_attention_bwd,
    flash_attention_dkv,
    flash_attention_dq,
)
from repro_torch.kernels.ingest_chain import ingest_chain
from repro_torch.kernels.l1 import l1_distance, pairwise_l1
from repro_torch.kernels.merge import merge_attention
from repro_torch.kernels.rnn import rnn_chain
from repro_torch.kernels.uplink import uplink_int8_encode, uplink_topk_encode
from repro_torch.models.dist import Ranks, kv_group

# every wrapper that launches a kernel, by the name its launch count goes under
WRAPPERS = {
    "l1_distance": l1_distance,
    "l1_distance_pairwise": _l1.l1_distance_pairwise,
    "assign_and_lerp": _assign_lerp.assign_and_lerp,
    "ingest_chain": ingest_chain,
    "chi2_feedback": _chi2.chi2_feedback,
    "chi2_feedback_segmented": _chi2.chi2_feedback_segmented,
    "merge_attention": merge_attention,
    "uplink_int8_encode": uplink_int8_encode,
    "uplink_topk_encode": uplink_topk_encode,
    "rnn_chain": rnn_chain,
    "pairwise_l1": pairwise_l1,
    "flash_attention_fwd": flash_attention_with_lse,
    "flash_attention_dq": flash_attention_dq,
    "flash_attention_dkv": flash_attention_dkv,
}


class _Attention(torch.autograd.Function):
    """Flash forward kernel in, the two backward kernels out (the
    reference's ``custom_vjp`` ``_attention_trainable``). The options are
    constants and get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, softcap, q_pos0):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention_with_lse(q, k, v, causal=causal, scale=scale, window=window,
                                          softcap=softcap, q_pos0=q_pos0)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, scale=scale, window=window, softcap=softcap, q_pos0=q_pos0)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def attention(q, k, v, *, causal=True, scale=None, window=None, softcap=None, q_pos0=0):
    """Training/prefill attention, ``(B, H, Sq, hd) x (B, KV, Sk, hd) x
    (B, KV, Sk, dv) -> (B, H, Sq, dv)``, differentiable in ``q``, ``k`` and
    ``v``: one flash launch (and under autograd the two backward ones).

    Under a model mesh (the reference's ``shard_map`` branch,
    ``repro/kernels/ops.py:125-180``) one batch shard's heads are split
    over the ``model`` axis: ``q`` comes as :class:`~repro_torch.models.
    dist.Ranks` of ``(B, H / tp, Sq, hd)``, one part a rank, and so does the
    output. ``k`` and ``v`` are Ranks too where the KV heads split, else
    whole: each rank then slices its KV group (``dist.kv_group``). The
    kernel runs once a rank, on the rank's contiguous operands and device.
    Plain tensors (no mesh, a one-device mesh, or heads the model axis does
    not divide) take the single launch."""
    opts = (causal, scale, window, softcap, q_pos0)
    if not isinstance(q, Ranks):
        return _Attention.apply(q, k, v, *opts)
    heads = q[0].shape[1] * len(q)
    outs = []
    for m, qm in enumerate(q):
        if isinstance(k, Ranks):
            km, vm = k[m], v[m]
        else:
            kv0, kv_n = kv_group(m, qm.shape[1], heads, k.shape[1])
            km, vm = k[:, kv0: kv0 + kv_n], v[:, kv0: kv0 + kv_n]
        outs.append(_Attention.apply(qm, km.to(qm.device), vm.to(qm.device), *opts))
    return Ranks(outs)


# ------------------------------------------------------------ plane meshes
def _mesh_active(mesh) -> bool:
    return mesh is not None and mesh.row_shards > 1


def _model_axis_size(mesh, dim_axis) -> int:
    """The model axis's extent for compute (1 when absent or turned off)."""
    if mesh is None or dim_axis is None or dim_axis not in mesh.axis_names:
        return 1
    return mesh.shape[dim_axis]


def _dim_shards(mesh, dim_axis, dim: int) -> int:
    """Dim chunks of an L1 launch: the model axis's extent when it divides
    ``dim``, else 1 (the plane's storage rule)."""
    m = _model_axis_size(mesh, dim_axis)
    return m if m > 1 and dim % m == 0 else 1


def _row_devices(mesh, joint: bool) -> list[torch.device]:
    """The device of each row shard: over ``plane``, each mesh row's first
    device; jointly over (``plane``, model), every device plane-major."""
    return [d for row in mesh.devices for d in row] if joint else [row[0] for row in mesh.devices]


def _to_mesh_rows(mesh, x, fill=0, *, joint: bool = False, dim_axis=None) -> MeshRows:
    """Pad a row-batched operand to a multiple of the row shards (over
    ``plane``, or over ``plane`` and the model axis jointly) with ``fill``
    and split it over their devices; with ``dim_axis`` each shard's block
    also splits its last dim over the model axis. A :class:`MeshRows`
    already laid out so passes through; one whose row shards match but
    whose dim chunks do not is re-chunked shard by shard (its rows never
    gather on one device)."""
    devs = _row_devices(mesh, joint)
    chunks = _model_axis_size(mesh, dim_axis) if dim_axis is not None else 1
    if isinstance(x, MeshRows):
        if x.joint == joint and len(x.parts) == len(devs):
            if len(x.parts[0]) == chunks:
                return x
            if chunks == 1:
                parts = [[torch.cat([p.to(d) for p in ps], dim=1)] for ps, d in zip(x.parts, devs)]
                return MeshRows(parts, x.rows, joint)
        x = x.gather(mesh.first_device)
    rows = x.shape[0]
    shards = len(devs)
    per = max(1, -(-rows // shards))
    if per * shards != rows:
        pad = torch.full((per * shards - rows,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad])
    parts = []
    for k, d in enumerate(devs):
        block = x[k * per:(k + 1) * per]
        if chunks > 1:  # row shard k's dim chunk m on devices[k][m]
            parts.append([c.to(mesh.devices[k][m]).contiguous() for m, c in enumerate(torch.chunk(block, chunks, -1))])
        else:
            parts.append([block.to(d).contiguous()])
    return MeshRows(parts, rows, joint)


def _whole(x, mesh) -> torch.Tensor:
    """A one-shard mesh's operand for the single-device launch."""
    return x.gather(mesh.first_device) if isinstance(x, MeshRows) else x


def l1_distance_pairwise(xs, centers: torch.Tensor, *, mesh=None, dim_axis="model"):
    """(M, N) x (C, N) -> (M, C) L1 matrix (merge candidates, reassignment
    and dissolve sweeps), one launch, or one a shard under a mesh: the query
    rows over ``plane`` and, when the model axis divides N, the dim over it
    (the partial sums added over the model shards)."""
    if mesh is None:
        return _l1.l1_distance_pairwise(xs, centers)
    ds = _dim_shards(mesh, dim_axis, centers.shape[-1])
    if _mesh_active(mesh) or ds > 1:
        M = xs.shape[0]
        da = dim_axis if ds > 1 else None
        xs = _to_mesh_rows(mesh, xs, dim_axis=da)
        return plane_sharded.l1_pairwise_sharded(xs, centers, mesh, _l1.l1_distance_pairwise)[:M]
    return _l1.l1_distance_pairwise(_whole(xs, mesh), centers)


def assign_and_lerp(u: torch.Tensor, centers, beta: float, *, mesh=None, dim_axis="model"):
    """Fused Eq. 1 argmin + mixed-rate center blend: (dists (C,), idx () int32,
    blended (N,)), one launch. Under a mesh the center rows go over
    ``plane`` (and the dim over the model axis when it divides N): one
    ``l1_distance`` launch a shard, the argmin and the winner's fetch on
    the mesh's first device with no host read, and the two-op blend."""
    if mesh is None:
        return _assign_lerp.assign_and_lerp(u, centers, beta)
    ds = _dim_shards(mesh, dim_axis, u.shape[-1])
    if _mesh_active(mesh) or ds > 1:
        C = centers.shape[0]
        da = dim_axis if ds > 1 else None
        centers = _to_mesh_rows(mesh, centers, dim_axis=da)
        return plane_sharded.assign_lerp_sharded(u, centers, beta, mesh, l1_distance, valid_rows=C)
    return _assign_lerp.assign_and_lerp(u, _whole(centers, mesh), beta)


def _chi2_joint(mesh, dim_axis) -> bool:
    """Whether a chi2 launch spreads its rows over the model axis too (it
    lends rows: the chi2 kernels have no dim to split)."""
    return _model_axis_size(mesh, dim_axis) > 1


def chi2_feedback(f_pred, f_true, s_soft, *, mesh=None, dim_axis="model") -> torch.Tensor:
    """Per-row Eq. 2/3 statistic, (M, J) -> (M,) in one launch (the
    reassignment and dissolve probes), or one a shard under a mesh, the
    rows over ``plane`` and the model axis jointly."""
    if mesh is None:
        return _chi2.chi2_feedback(f_pred, f_true, s_soft)
    joint = _chi2_joint(mesh, dim_axis)
    if _mesh_active(mesh) or joint:
        M = f_pred.shape[0]
        fp = _to_mesh_rows(mesh, f_pred, joint=joint)
        ft = _to_mesh_rows(mesh, f_true, fill=1, joint=joint)
        ss = _to_mesh_rows(mesh, s_soft, joint=joint)
        return plane_sharded.chi2_rows_sharded(fp, ft, ss, mesh, _chi2.chi2_feedback)[:M]
    return _chi2.chi2_feedback(f_pred, f_true, s_soft)


def chi2_feedback_segmented(f_pred, f_true, s_soft, seg_ids: torch.Tensor, num_segments: int, *, mesh=None,
                            dim_axis="model"):
    """Every member of every cluster in one launch (the reference's
    ``chi2_feedback_all``): (g (M,), seg_sum (S,)). Under a mesh the member
    rows go over ``plane`` and the model axis jointly, padded rows in
    segment -1, and the shards' segment sums are added in shard order."""
    if mesh is None:
        return _chi2.chi2_feedback_segmented(f_pred, f_true, s_soft, seg_ids, num_segments)
    joint = _chi2_joint(mesh, dim_axis)
    if _mesh_active(mesh) or joint:
        M = f_pred.shape[0]
        fp = _to_mesh_rows(mesh, f_pred, joint=joint)
        ft = _to_mesh_rows(mesh, f_true, fill=1, joint=joint)
        ss = _to_mesh_rows(mesh, s_soft, joint=joint)
        seg = _to_mesh_rows(mesh, seg_ids, fill=-1, joint=joint)
        g, seg_sum = plane_sharded.chi2_all_sharded(fp, ft, ss, seg, num_segments, mesh,
                                                    _chi2.chi2_feedback_segmented)
        return g[:M], seg_sum
    return _chi2.chi2_feedback_segmented(f_pred, f_true, s_soft, seg_ids, num_segments)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def launch_counts_bf16() -> dict[str, int]:
    """Launches of the bf16 instantiations, for the wrappers that have one."""
    return {name: fn.launches_bf16 for name, fn in WRAPPERS.items() if hasattr(fn, "launches_bf16")}


def sharded_calls() -> dict[str, int]:
    """Calls of each entry point that ran over a mesh (a launch a shard each)."""
    return {name: fn.calls for name, fn in plane_sharded.SHARDED.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
        if hasattr(fn, "launches_bf16"):
            fn.launches_bf16 = 0
    for fn in plane_sharded.SHARDED.values():
        fn.calls = 0


__all__ = [
    "assign_and_lerp", "attention", "chi2_feedback", "chi2_feedback_segmented", "flash_attention",
    "flash_attention_bwd", "flash_attention_with_lse", "ingest_chain", "l1_distance", "l1_distance_pairwise",
    "launch_counts", "launch_counts_bf16", "merge_attention", "pairwise_l1", "reset_launch_counts", "rnn_chain",
    "sharded_calls",
    "uplink_int8_encode", "uplink_topk_encode",
]
