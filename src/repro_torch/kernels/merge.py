"""Family D: cluster-merge attention (paper Algorithm 1, lines 2-6),
kernel in ``csrc/merge.cu``; replaces ``src/repro/kernels/merge_attention.py``.

:func:`merge_attention` is one ctypes call and one kernel launch (one
block for short rows, else a cooperative grid that keeps its elements in
registers while the max crosses the blocks). It allocates only the output,
and only when ``out`` is None; ``out`` may be ``v_main`` itself, which the
server passes to merge a plane row in place. ``merge_attention.launches``
counts its launches.

The three rows may be fp32 or bf16 (one dtype a call), as the reference's
kernel casts each to fp32 (``merge_attention.py:36-44``) and writes the
merged row in ``v_main.dtype`` (``:82``). bf16 launches the kernel's bf16
instantiation (``.launches_bf16``): the fp32 result on the rows cast to
fp32, rounded once to bf16.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import check_float, count_launch, entry, upcast, use_plain


def merge_attention_plain(v_main: torch.Tensor, v_aux: torch.Tensor, v_trained: torch.Tensor):
    """Returns (merged, alpha): alpha = relu(p) / max(max p, 1e-12) with
    p = (v_aux - v_main)(v_trained - v_main); merged = alpha v_aux +
    (1 - alpha) v_main, each product rounded before the sum. As
    ``jnp.max`` and ``jnp.maximum`` in the reference, both maxima propagate
    NaN and relu(-0) is +0. bf16 rows are cast to fp32 first; ``merged``
    comes back in ``v_main``'s dtype, ``alpha`` in the dtype it was computed in."""
    dtype = v_main.dtype
    v_main, v_aux, v_trained = upcast(v_main), upcast(v_aux), upcast(v_trained)
    p = (v_aux - v_main) * (v_trained - v_main)
    denom = torch.clamp_min(torch.max(p), 1e-12)
    alpha = torch.where(p <= 0, 0.0, p) / denom
    merged = torch.add(torch.mul(alpha, v_aux), torch.mul(1.0 - alpha, v_main))
    return merged.to(dtype), alpha


def merge_attention(v_main: torch.Tensor, v_aux: torch.Tensor, v_trained: torch.Tensor,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Three (N,) vectors -> the merged (N,) center, written into ``out``
    when it is given: ``v_main`` itself (an in-place merge), nothing else."""
    dtype = check_float("merge_attention", ("v_main", v_main, 1), ("v_aux", v_aux, 1), ("v_trained", v_trained, 1))
    if not (v_main.shape == v_aux.shape == v_trained.shape) or v_main.numel() == 0:
        raise ValueError("merge_attention: three non-empty vectors of one length expected")
    if out is not None and out is not v_main:
        raise ValueError("merge_attention: out must be v_main itself (an in-place merge) or None")
    if use_plain("merge_attention", v_main, v_aux, v_trained):
        merged = merge_attention_plain(v_main, v_aux, v_trained)[0]
        return merged if out is None else out.copy_(merged)
    lib = _build.library()
    if out is None:
        out = torch.empty_like(v_main)
    rc = entry(lib, "repro_merge_attention", dtype)(
        v_main.data_ptr(), v_aux.data_ptr(), v_trained.data_ptr(), v_main.shape[0], out.data_ptr(),
        v_main.device.index or 0, _build.stream(v_main),
    )
    _build.check(rc, "merge_attention")
    count_launch(merge_attention, dtype)
    return out


merge_attention.launches = merge_attention.launches_bf16 = 0
