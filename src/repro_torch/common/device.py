"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. Asked for
``cuda`` on a host without a GPU they raise instead of carrying on quietly
on the CPU. Resolving a device also pins fp32 numerics: TF32 off for
matrix products and convolutions.
"""
from __future__ import annotations

import numpy as np
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


def to_device(array, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A numpy array as a tensor on ``device``. To a card it goes from pinned
    host memory without blocking, so staging a kernel's small operands does
    not wait for the work already queued on the stream."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if dtype is not None:
        t = t.to(dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def on_device(leaf, device: torch.device) -> torch.Tensor:
    """A restored fp32 leaf (numpy, or a tensor on any device) as a tensor of its own on ``device``."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to(device=device, dtype=torch.float32, copy=True)
    return torch.tensor(np.asarray(leaf), dtype=torch.float32).to(device)
