"""Argument checks and device dispatch shared by the kernel wrappers.

Dispatch goes by the tensors' device and nothing else: tensors on the CPU
take the plain PyTorch version, tensors on one CUDA device take the CUDA
kernel, and anything else raises. There is no environment switch.
"""
from __future__ import annotations

import torch


def check_f32(what: str, *named: tuple[str, torch.Tensor, int]) -> None:
    """Each ``(name, tensor, ndim)`` must be an fp32 tensor of that rank."""
    for name, t, ndim in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: {name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{what}: {name} must be {ndim}-D, got shape {tuple(t.shape)}")


def use_plain(what: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (take the plain version);
    False when all lie on one CUDA device and are contiguous (launch the
    kernel). Mixed devices, other device types, or a non-contiguous CUDA
    tensor raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what}: tensors on different devices {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: CUDA kernel needs contiguous tensors")
    return False
