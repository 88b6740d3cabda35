"""Family D: cluster-merge attention (paper Algorithm 1, lines 2-6),
kernels in ``csrc/merge.cu``; replaces ``src/repro/kernels/merge_attention.py``.
``merge_attention.launches`` counts calls (each runs the max pass and the
blend pass)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import check_f32, use_plain


def merge_attention_plain(v_main: torch.Tensor, v_aux: torch.Tensor, v_trained: torch.Tensor):
    """Returns (merged, alpha): alpha = relu(p) / max(max p, 1e-12) with
    p = (v_aux - v_main)(v_trained - v_main); merged = alpha v_aux +
    (1 - alpha) v_main, each product rounded before the sum."""
    p = (v_aux - v_main) * (v_trained - v_main)
    denom = torch.clamp_min(torch.max(p), 1e-12)
    alpha = torch.clamp_min(p, 0.0) / denom
    merged = torch.add(torch.mul(alpha, v_aux), torch.mul(1.0 - alpha, v_main))
    return merged, alpha


def merge_attention(v_main: torch.Tensor, v_aux: torch.Tensor, v_trained: torch.Tensor) -> torch.Tensor:
    """Three (N,) vectors -> the merged (N,) center."""
    check_f32("merge_attention", ("v_main", v_main, 1), ("v_aux", v_aux, 1), ("v_trained", v_trained, 1))
    if not (v_main.shape == v_aux.shape == v_trained.shape) or v_main.numel() == 0:
        raise ValueError("merge_attention: three non-empty vectors of one length expected")
    if use_plain("merge_attention", v_main, v_aux, v_trained):
        return merge_attention_plain(v_main, v_aux, v_trained)[0]
    lib = _build.library()
    n = v_main.shape[0]
    partial = torch.empty((lib.repro_merge_blocks(n),), dtype=torch.float32, device=v_main.device)
    out = torch.empty_like(v_main)
    rc = lib.repro_merge_attention(
        v_main.data_ptr(), v_aux.data_ptr(), v_trained.data_ptr(), n, partial.data_ptr(), out.data_ptr(),
        v_main.device.index or 0, _build.stream(v_main),
    )
    _build.check(rc, "merge_attention")
    merge_attention.launches += 1
    return out


merge_attention.launches = 0
