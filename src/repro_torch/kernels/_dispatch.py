"""Argument checks and device dispatch shared by the kernel wrappers.

Dispatch goes by the tensors' device and nothing else: tensors on the CPU
take the plain PyTorch version, and so do tensors on the ``meta`` device
(shapes only: the dry-run traces the steps there and counts the plain
versions' work, as the reference's dry-run lowers its reference attention);
tensors on one CUDA device take the CUDA kernel, and anything else raises.
There is no environment switch.

The kernels whose reference body casts its inputs to fp32 take fp32 or
bf16 (:func:`check_float`); the CUDA kernel then launches its bf16
instantiation for bf16, never a cast copy. The rest take fp32 only
(:func:`check_f32`).
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


FLOAT_INPUTS = (torch.float32, torch.bfloat16)


def upcast(t: torch.Tensor) -> torch.Tensor:
    """A bf16 operand as fp32, as the reference's kernel bodies cast it (a
    plain version's first step); any other dtype as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def check_float(what: str, *named: tuple[str, torch.Tensor, int]) -> torch.dtype:
    """Each ``(name, tensor, ndim)`` must be a tensor of that rank, all fp32
    or all bf16 (one dtype a call); returns it."""
    for name, t, ndim in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: {name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype not in FLOAT_INPUTS:
            raise TypeError(f"{what}: {name} must be float32 or bfloat16, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{what}: {name} must be {ndim}-D, got shape {tuple(t.shape)}")
    dtypes = {t.dtype for _, t, _ in named}
    if len(dtypes) != 1:
        raise TypeError(f"{what}: inputs of one dtype expected, got {sorted(map(str, dtypes))}")
    return dtypes.pop()


def use_plain(what: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU or every one on the ``meta``
    device (take the plain version); False when all lie on one CUDA device
    and are contiguous (launch the kernel). Mixed devices, other device
    types, or a non-contiguous CUDA tensor raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what}: tensors on different devices {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type in ("cpu", "meta"):
        return True
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: CUDA kernel needs contiguous tensors")
    return False


def entry(lib, name: str, dtype: torch.dtype):
    """The C entry point ``name`` for ``dtype``'s instantiation: the fp32
    one, or ``name + "_bf16"``."""
    return getattr(lib, name + ("_bf16" if dtype == torch.bfloat16 else ""))


def count_launch(wrapper, dtype: torch.dtype) -> None:
    """One launch of ``wrapper``'s kernel: ``.launches`` counts the fp32
    instantiation's, ``.launches_bf16`` the bf16 one's."""
    if dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1
