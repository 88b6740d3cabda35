"""Single-device public API of the kernels (no mesh).

The protocol layer calls only these names. Each dispatches by the device
of the tensors it is given: CPU tensors run the plain PyTorch version,
CUDA tensors launch the hand-written kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.assign_lerp import assign_and_lerp
from repro_torch.kernels.chi2 import chi2_feedback, chi2_feedback_segmented
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_with_lse
from repro_torch.kernels.flash_attention_bwd import (
    flash_attention_bwd,
    flash_attention_dkv,
    flash_attention_dq,
)
from repro_torch.kernels.ingest_chain import ingest_chain
from repro_torch.kernels.l1 import l1_distance, l1_distance_pairwise, pairwise_l1
from repro_torch.kernels.merge import merge_attention
from repro_torch.kernels.uplink import uplink_int8_encode, uplink_topk_encode

# every wrapper that launches a kernel, by the name its launch count goes under
WRAPPERS = {
    "l1_distance": l1_distance,
    "l1_distance_pairwise": l1_distance_pairwise,
    "assign_and_lerp": assign_and_lerp,
    "ingest_chain": ingest_chain,
    "chi2_feedback": chi2_feedback,
    "chi2_feedback_segmented": chi2_feedback_segmented,
    "merge_attention": merge_attention,
    "uplink_int8_encode": uplink_int8_encode,
    "uplink_topk_encode": uplink_topk_encode,
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
    ``v``. One device, no mesh."""
    return _Attention.apply(q, k, v, causal, scale, window, softcap, q_pos0)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = [
    "assign_and_lerp", "attention", "chi2_feedback", "chi2_feedback_segmented", "flash_attention",
    "flash_attention_bwd", "flash_attention_with_lse", "ingest_chain", "l1_distance", "l1_distance_pairwise",
    "launch_counts", "merge_attention", "pairwise_l1", "reset_launch_counts", "uplink_int8_encode",
    "uplink_topk_encode",
]
