"""Family B: fused on-arrival assignment + mixed-rate center blend (Eq. 1 +
Sec. 4), kernel in ``csrc/assign_lerp.cu``; replaces
``src/repro/kernels/assign_lerp.py``.

:func:`assign_and_lerp` is one ctypes call and one cooperative kernel
launch: the L1 distances of the upload to every center (bitwise those of
:func:`~repro_torch.kernels.l1.l1_distance`, which it does not call), the
first-index argmin on the device, and the blend of the winning center row.
The host never reads the index; the caller syncs once on the distances it
returns. ``assign_and_lerp.launches`` counts its launches.

The upload and centers may be fp32 or bf16 (one dtype a call), as the
reference's kernel casts either (``assign_lerp.py:30-31``); distances and
the blended row are fp32. bf16 launches the kernel's bf16 instantiation
(``.launches_bf16``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import check_float, count_launch, entry, upcast, use_plain
from repro_torch.kernels.l1 import l1_chunks, l1_distance_plain


def blend_plain(c: torch.Tensor, u: torch.Tensor, beta: float) -> torch.Tensor:
    """The pinned two-op blend round(round((1-beta)*c) + round(beta*u)):
    (1 - beta) folds in double and rounds once to fp32, as the reference
    folds its Python float; the two products and the sum are separate ops,
    so nothing contracts them into an FMA."""
    m1 = torch.mul(upcast(c), 1.0 - beta)
    m2 = torch.mul(upcast(u), beta)
    return torch.add(m1, m2)


def assign_and_lerp_plain(u: torch.Tensor, centers: torch.Tensor, beta: float):
    dists = l1_distance_plain(u, centers)
    idx = torch.argmin(dists).to(torch.int32)  # first index among ties
    return dists, idx, blend_plain(centers[idx.long()], u, beta)


def assign_and_lerp(u: torch.Tensor, centers: torch.Tensor, beta: float):
    """u (N,), centers (C, N) -> (dists (C,) fp32, idx () int32, blended (N,))
    with ``blended = (1 - beta) * centers[idx] + beta * u``."""
    dtype = check_float("assign_and_lerp", ("u", u, 1), ("centers", centers, 2))
    C, N = centers.shape
    if u.shape[0] != N or C == 0:
        raise ValueError(f"assign_and_lerp: bad shapes u {tuple(u.shape)}, centers {(C, N)}")
    if use_plain("assign_and_lerp", u, centers):
        return assign_and_lerp_plain(u, centers, beta)
    if N == 0:
        raise ValueError("assign_and_lerp kernel: rows must have at least one element")
    chunks = l1_chunks(N)
    buf = torch.empty((C + chunks * C,), dtype=torch.float32, device=u.device)  # dists, then scratch
    dists = buf[:C]
    idx = torch.empty((), dtype=torch.int32, device=u.device)
    out = torch.empty((N,), dtype=torch.float32, device=u.device)
    rc = entry(_build.library(), "repro_assign_lerp", dtype)(
        u.data_ptr(), centers.data_ptr(), C, N, chunks, float(beta), buf.data_ptr() + 4 * C, buf.data_ptr(),
        idx.data_ptr(), out.data_ptr(), u.device.index or 0, _build.stream(u),
    )
    _build.check(rc, "assign_lerp")
    count_launch(assign_and_lerp, dtype)
    return dists, idx, out


assign_and_lerp.launches = assign_and_lerp.launches_bf16 = 0
