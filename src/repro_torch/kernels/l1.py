"""Family A: L1 rows (paper Eq. 1), kernel in ``csrc/l1.cu``.

One CUDA kernel computes ``(M, N) x (C, N) -> (M, C)`` fp32 L1 distances
and serves three entry points: :func:`l1_distance` (one upload against
every center, ``M = 1``; replaces ``src/repro/kernels/l1_distance.py::
l1_distance``), :func:`l1_distance_pairwise` (replaces
``src/repro/kernels/l1_pairwise.py``) and :func:`pairwise_l1` (the
``(M, M)`` matrix of one set of rows against itself, ``C = M``; replaces
``src/repro/kernels/l1_distance.py::pairwise_l1``).
Each wrapper counts its own launches in ``.launches``.

The kernel sums in one order fixed by the element index (``csrc/l1_rows.cuh``):
a pair of rows gets the same bits from every entry point, at any place and
alignment in its matrix, and from the fused assign kernel.

Rows may be fp32 or bf16, one dtype a call, as the reference's kernels
cast either to fp32 (``l1_distance.py:30-31``, ``l1_pairwise.py:31-32``);
distances are fp32. bf16 rows launch the kernel's bf16 instantiation
(counted in ``.launches_bf16``), which gives the fp32 kernel's bits on the
rows cast to fp32; the plain versions cast first, as the reference's
``kernels/ref.py`` does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import check_float, count_launch, entry, upcast, use_plain


def l1_distance_pairwise_plain(xs: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(M, N), (C, N) -> (M, C): sum |x - c| in fp32."""
    xs, centers = upcast(xs), upcast(centers)
    return torch.sum(torch.abs(xs[:, None, :] - centers[None, :, :]), dim=-1)


def l1_distance_plain(u: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(N,), (C, N) -> (C,)."""
    u, centers = upcast(u), upcast(centers)
    return torch.sum(torch.abs(centers - u[None, :]), dim=1)


CHUNK = 4096  # elements per chunk: kChunk in csrc/l1_rows.cuh (the kernel refuses another count)


def l1_chunks(n: int) -> int:
    """Chunks the kernels cut an ``n``-wide row into: a function of ``n`` alone."""
    return -(-n // CHUNK)


def _launch_rows(xs: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    M, N = xs.shape
    C = centers.shape[0]
    if N == 0:
        raise ValueError("l1 kernel: rows must have at least one element")
    chunks = l1_chunks(N)
    out = torch.empty((M, C), dtype=torch.float32, device=xs.device)
    scratch = torch.empty((chunks, M, C), dtype=torch.float32, device=xs.device)
    rc = entry(_build.library(), "repro_l1_rows", xs.dtype)(
        xs.data_ptr(), centers.data_ptr(), out.data_ptr(), scratch.data_ptr(), M, C, N, chunks,
        xs.device.index or 0, _build.stream(xs),
    )
    _build.check(rc, "l1_rows")
    return out


def l1_distance_pairwise(xs: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(M, N) x (C, N) -> (M, C) L1 matrix in one launch (merge-candidate
    search, dissolve and reassignment sweeps)."""
    dtype = check_float("l1_distance_pairwise", ("xs", xs, 2), ("centers", centers, 2))
    if xs.shape[1] != centers.shape[1]:
        raise ValueError(f"l1_distance_pairwise: widths differ {xs.shape[1]} != {centers.shape[1]}")
    if use_plain("l1_distance_pairwise", xs, centers):
        return l1_distance_pairwise_plain(xs, centers)
    out = _launch_rows(xs, centers)
    count_launch(l1_distance_pairwise, dtype)
    return out


def l1_distance(u: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(N,) x (C, N) -> (C,) distances of one upload to every center."""
    dtype = check_float("l1_distance", ("u", u, 1), ("centers", centers, 2))
    if u.shape[0] != centers.shape[1]:
        raise ValueError(f"l1_distance: widths differ {u.shape[0]} != {centers.shape[1]}")
    if use_plain("l1_distance", u, centers):
        return l1_distance_plain(u, centers)
    out = _launch_rows(u[None, :], centers)[0]
    count_launch(l1_distance, dtype)
    return out


def pairwise_l1_plain(vectors: torch.Tensor) -> torch.Tensor:
    """(M, N) -> (M, M)."""
    return l1_distance_pairwise_plain(vectors, vectors)


def pairwise_l1(vectors: torch.Tensor) -> torch.Tensor:
    """(M, N) -> (M, M) pairwise L1 matrix in one launch."""
    dtype = check_float("pairwise_l1", ("vectors", vectors, 2))
    if use_plain("pairwise_l1", vectors):
        return pairwise_l1_plain(vectors)
    out = _launch_rows(vectors, vectors)
    count_launch(pairwise_l1, dtype)
    return out


for _fn in (l1_distance_pairwise, l1_distance, pairwise_l1):
    _fn.launches = _fn.launches_bf16 = 0
