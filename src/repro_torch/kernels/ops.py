"""Single-device public API of the kernels (no mesh).

The protocol layer calls only these names. Each dispatches by the device
of the tensors it is given: CPU tensors run the plain PyTorch version,
CUDA tensors launch the hand-written kernel or raise.
"""
from __future__ import annotations

from repro_torch.kernels.assign_lerp import assign_and_lerp
from repro_torch.kernels.chi2 import chi2_feedback, chi2_feedback_segmented
from repro_torch.kernels.l1 import l1_distance, l1_distance_pairwise
from repro_torch.kernels.merge import merge_attention

# every wrapper that launches a kernel, by the name its launch count goes under
WRAPPERS = {
    "l1_distance": l1_distance,
    "l1_distance_pairwise": l1_distance_pairwise,
    "assign_and_lerp": assign_and_lerp,
    "chi2_feedback": chi2_feedback,
    "chi2_feedback_segmented": chi2_feedback_segmented,
    "merge_attention": merge_attention,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = [
    "assign_and_lerp", "chi2_feedback", "chi2_feedback_segmented", "l1_distance",
    "l1_distance_pairwise", "launch_counts", "merge_attention", "reset_launch_counts",
]
