"""Family C: chi-squared client feedback (paper Eq. 2/3), kernel in
``csrc/chi2.cu``; replaces ``src/repro/kernels/chi2_feedback.py``.

:func:`chi2_feedback` scores M rows; :func:`chi2_feedback_segmented` also
sums g per cluster segment. On CUDA tensors each call is one ctypes call and
one launch of one kernel, which writes g and the segment sums into one
buffer in a fixed order (no atomics; ``tests/test_torch_chi2_order.py``
models it). Each wrapper counts its calls that launch in ``.launches``.

The rows may be fp32 or bf16 (one dtype a call), as the reference's
kernels cast either to fp32 (``chi2_feedback.py:21-23``, ``:68-70``); g and
the segment sums are fp32. bf16 launches the kernel's bf16 instantiation
(``.launches_bf16``): the fp32 kernel's bits on the rows cast to fp32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import check_float, count_launch, entry, upcast, use_plain

# the kernel's constants (csrc/chi2.cu), for the shared-memory check below
ROWS, WARPS, MAX_THREAD_J = 256, 8, 32
MAX_SMEM = 232_448  # bytes of shared memory a block may opt in to on the H100


def chi2_feedback_plain(f_pred: torch.Tensor, f_true: torch.Tensor, s_soft: torch.Tensor) -> torch.Tensor:
    """(M, J) x3 -> (M,): chi2(F_pred, F_true) x population Var(S_soft)."""
    f_pred, f_true, s_soft = upcast(f_pred), upcast(f_true), upcast(s_soft)
    chi2 = torch.sum(torch.square(f_pred - f_true) / torch.clamp_min(f_true, 1e-6), dim=-1)
    return chi2 * torch.var(s_soft, dim=-1, correction=0)


def chi2_feedback_segmented_plain(f_pred, f_true, s_soft, seg_ids, num_segments: int):
    """(g (M,), seg_sum (S,)); rows with ``seg_ids == -1`` join no segment."""
    g = chi2_feedback_plain(f_pred, f_true, s_soft)
    onehot = (seg_ids.long()[:, None] == torch.arange(num_segments, device=g.device)[None, :])
    seg_sum = torch.sum(torch.where(onehot, g[:, None], torch.zeros((), device=g.device)), dim=0)
    return g, seg_sum


def smem_bytes(m: int, j: int, s: int) -> int:
    """Dynamic shared memory of one kernel launch: the staged row tiles
    (one row per thread for J <= 32), the tile's g and segment ids, and the
    S segment partials (``smem_bytes`` in ``csrc/chi2.cu``)."""
    cap = min(m, ROWS if j <= MAX_THREAD_J else WARPS)
    staged = 3 * cap * (j | 1) if j <= MAX_THREAD_J else 0
    return 4 * (staged + 2 * cap + s)


def _check(what, f_pred, f_true, s_soft) -> torch.dtype:
    dtype = check_float(what, ("f_pred", f_pred, 2), ("f_true", f_true, 2), ("s_soft", s_soft, 2))
    if not (f_pred.shape == f_true.shape == s_soft.shape):
        raise ValueError(f"{what}: shapes differ {f_pred.shape}, {f_true.shape}, {s_soft.shape}")
    return dtype


def _launch(f_pred, f_true, s_soft, seg_ids, num_segments: int) -> torch.Tensor:
    """The kernel's (M + S,) buffer: g, then the S segment sums."""
    M, J = f_pred.shape
    if smem_bytes(M, J, num_segments) > MAX_SMEM:
        raise ValueError(f"chi2 kernel: {num_segments} segments at J = {J} exceed a block's shared memory")
    out = torch.empty((M + num_segments,), dtype=torch.float32, device=f_pred.device)
    rc = entry(_build.library(), "repro_chi2", f_pred.dtype)(
        f_pred.data_ptr(), f_true.data_ptr(), s_soft.data_ptr(),
        None if seg_ids is None else seg_ids.data_ptr(), out.data_ptr(), M, J, num_segments,
        f_pred.device.index or 0, _build.stream(f_pred),
    )
    _build.check(rc, "chi2")
    return out


def chi2_feedback(f_pred: torch.Tensor, f_true: torch.Tensor, s_soft: torch.Tensor) -> torch.Tensor:
    """Per-row Eq. 2/3 statistic, (M, J) -> (M,) in one launch (the
    reassignment and dissolve probes)."""
    dtype = _check("chi2_feedback", f_pred, f_true, s_soft)
    if use_plain("chi2_feedback", f_pred, f_true, s_soft):
        return chi2_feedback_plain(f_pred, f_true, s_soft)
    g = _launch(f_pred, f_true, s_soft, None, 0)
    count_launch(chi2_feedback, dtype)
    return g


def chi2_feedback_segmented(f_pred, f_true, s_soft, seg_ids: torch.Tensor, num_segments: int):
    """Every member of every cluster at once: ``seg_ids`` (M,) int32 maps a
    row to its cluster slot in ``[0, num_segments)`` (-1 = none). Returns
    (g (M,), seg_sum (num_segments,)); on the card both are views of the
    kernel's one buffer (:func:`segmented_numpy` reads it in one copy)."""
    dtype = _check("chi2_feedback_segmented", f_pred, f_true, s_soft)
    if seg_ids.dtype != torch.int32 or seg_ids.shape != f_pred.shape[:1]:
        raise ValueError("chi2_feedback_segmented: seg_ids must be int32 of shape (M,)")
    if use_plain("chi2_feedback_segmented", f_pred, f_true, s_soft, seg_ids):
        return chi2_feedback_segmented_plain(f_pred, f_true, s_soft, seg_ids, num_segments)
    M = f_pred.shape[0]
    out = _launch(f_pred, f_true, s_soft, seg_ids, num_segments)
    count_launch(chi2_feedback_segmented, dtype)
    return out[:M], out[M:]


def segmented_numpy(g: torch.Tensor, seg_sum: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """:func:`chi2_feedback_segmented`'s outputs as numpy arrays, read from
    the card in one device-to-host copy where they are views of the
    kernel's one buffer (CPU tensors are not copied)."""
    m = g.shape[0]
    if (g.is_cuda and g.untyped_storage().data_ptr() == seg_sum.untyped_storage().data_ptr()
            and g.storage_offset() == 0 and seg_sum.storage_offset() == m):
        host = g.as_strided((m + seg_sum.shape[0],), (1,)).cpu().numpy()
        return host[:m], host[m:]
    return g.cpu().numpy(), seg_sum.cpu().numpy()


chi2_feedback.launches = chi2_feedback.launches_bf16 = 0
chi2_feedback_segmented.launches = chi2_feedback_segmented.launches_bf16 = 0
