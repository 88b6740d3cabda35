"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. Asked for
``cuda`` on a host without a GPU they raise instead of carrying on quietly
on the CPU. Resolving a device also pins fp32 numerics: TF32 off for
matrix products and convolutions.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: device 'cuda' requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch: unsupported device {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
