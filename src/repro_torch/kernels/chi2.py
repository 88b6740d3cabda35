"""Family C: chi-squared client feedback (paper Eq. 2/3), kernels in
``csrc/chi2.cu``; replaces ``src/repro/kernels/chi2_feedback.py``.

:func:`chi2_feedback` scores M rows; :func:`chi2_feedback_segmented` also
sums g per cluster segment (deterministically, no atomics). Each wrapper
counts its calls that launch in ``.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import check_f32, use_plain


def chi2_feedback_plain(f_pred: torch.Tensor, f_true: torch.Tensor, s_soft: torch.Tensor) -> torch.Tensor:
    """(M, J) x3 -> (M,): chi2(F_pred, F_true) x population Var(S_soft)."""
    chi2 = torch.sum(torch.square(f_pred - f_true) / torch.clamp_min(f_true, 1e-6), dim=-1)
    return chi2 * torch.var(s_soft, dim=-1, correction=0)


def chi2_feedback_segmented_plain(f_pred, f_true, s_soft, seg_ids, num_segments: int):
    """(g (M,), seg_sum (S,)); rows with ``seg_ids == -1`` join no segment."""
    g = chi2_feedback_plain(f_pred, f_true, s_soft)
    onehot = (seg_ids.long()[:, None] == torch.arange(num_segments, device=g.device)[None, :])
    seg_sum = torch.sum(torch.where(onehot, g[:, None], torch.zeros((), device=g.device)), dim=0)
    return g, seg_sum


def _check(what, f_pred, f_true, s_soft):
    check_f32(what, ("f_pred", f_pred, 2), ("f_true", f_true, 2), ("s_soft", s_soft, 2))
    if not (f_pred.shape == f_true.shape == s_soft.shape):
        raise ValueError(f"{what}: shapes differ {f_pred.shape}, {f_true.shape}, {s_soft.shape}")


def _launch_rows(f_pred, f_true, s_soft) -> torch.Tensor:
    M, J = f_pred.shape
    g = torch.empty((M,), dtype=torch.float32, device=f_pred.device)
    rc = _build.library().repro_chi2_rows(
        f_pred.data_ptr(), f_true.data_ptr(), s_soft.data_ptr(), g.data_ptr(), M, J,
        f_pred.device.index or 0, _build.stream(f_pred),
    )
    _build.check(rc, "chi2_rows")
    return g


def chi2_feedback(f_pred: torch.Tensor, f_true: torch.Tensor, s_soft: torch.Tensor) -> torch.Tensor:
    """Per-row Eq. 2/3 statistic, (M, J) -> (M,) in one launch (the
    reassignment and dissolve probes)."""
    _check("chi2_feedback", f_pred, f_true, s_soft)
    if use_plain("chi2_feedback", f_pred, f_true, s_soft):
        return chi2_feedback_plain(f_pred, f_true, s_soft)
    g = _launch_rows(f_pred, f_true, s_soft)
    chi2_feedback.launches += 1
    return g


def chi2_feedback_segmented(f_pred, f_true, s_soft, seg_ids: torch.Tensor, num_segments: int):
    """Every member of every cluster at once: ``seg_ids`` (M,) int32 maps a
    row to its cluster slot in ``[0, num_segments)`` (-1 = none). Returns
    (g (M,), seg_sum (num_segments,))."""
    _check("chi2_feedback_segmented", f_pred, f_true, s_soft)
    if seg_ids.dtype != torch.int32 or seg_ids.shape != f_pred.shape[:1]:
        raise ValueError("chi2_feedback_segmented: seg_ids must be int32 of shape (M,)")
    if use_plain("chi2_feedback_segmented", f_pred, f_true, s_soft, seg_ids):
        return chi2_feedback_segmented_plain(f_pred, f_true, s_soft, seg_ids, num_segments)
    g = _launch_rows(f_pred, f_true, s_soft)
    seg_sum = torch.empty((num_segments,), dtype=torch.float32, device=g.device)
    rc = _build.library().repro_segment_sum(
        g.data_ptr(), seg_ids.data_ptr(), g.shape[0], num_segments, seg_sum.data_ptr(),
        g.device.index or 0, _build.stream(g),
    )
    _build.check(rc, "segment_sum")
    chi2_feedback_segmented.launches += 1
    return g, seg_sum


chi2_feedback.launches = 0
chi2_feedback_segmented.launches = 0
