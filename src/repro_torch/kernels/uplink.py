"""The compressed uplink's cohort encodes, kernels in ``csrc/uplink.cu``;
they replace the reference's jitted ``src/repro/fl/uplink.py::_encode_int8``
(``:141``) and ``::_encode_topk`` (``:131``), not a ``pallas_call``.

Each takes the codec's plane storage (the ``(capacity, n)`` fp32 row store)
and the ids of the cohort's rows in it, gathers the rows itself, writes the
advanced anchors (and EF residuals) back in place, and returns the ``(B, n)``
reconstruction as a matrix of its own: one launch a cohort, whatever B
(top-k splits a long row over blocks of one cooperative launch:
:func:`topk_plan`). ``mat`` is only read. The row ids must be distinct.

Bits. The reference's encodes are jitted, and XLA fuses two of int8's
steps into fused multiply-adds: the scale is ``fma(max, fl(1/127), 1e-12)``
and the reconstruction ``fma(q, s, A)``, each rounded once. The kernel
calls ``__fmaf_rn`` for both; the plain version emulates a single-rounded
fp32 FMA exactly (:func:`fma_f32`). Everything else is one rounding an
operation in both, so the kernels are held to their plain versions bit for
bit (NaN at the same places, infinities and signed zeros included). Top-k
adds ``sent`` to every anchor element, as the reference's ``A + sent``
does, so a -0 anchor where nothing was sent becomes +0; only at one row
and k = 1 does XLA make the add a dynamic update of the one sent element,
which keeps that -0 (the port does not copy this). Top-k selects ``lax.top_k``'s set: larger ``|c|`` first,
ties to the lower index, every NaN above inf and equal to the others, +0
equal to -0.

``uplink_int8_encode.launches`` and ``uplink_topk_encode.launches`` count
the kernels' launches.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import check_f32, use_plain

INV_127 = 1.0 / 127.0  # rounds to fl32(1/127) where it meets an fp32 tensor


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of fp32 tensors rounded once to fp32, as an FMA.

    The product of two fp32 numbers is exact in float64. The sum with ``c``
    is not always: where the exponents of ``a * b`` and ``c`` lie far apart
    (for the int8 reconstruction, more than 22 binades, since ``q * s`` has
    at most 31 significant bits), rounding the float64 sum to nearest and
    then to fp32 can land on an fp32 halfway point that the exact sum is
    not on, and round it the wrong way (``1 + 2**-24 + 2**-54`` gives 1.0
    so, not the FMA's ``1 + 2**-23``). So the float64 sum is rounded to odd
    instead: its exact error (TwoSum) says where the exact sum lies, and
    an even result with a non-zero error moves one float64 ulp towards it.
    Rounding a round-to-odd value with 53 bits to 24 is the single rounding
    of the exact sum (53 >= 2 * 24 + 2). NaN and infinities pass as the
    float64 operations give them."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    nudge = even & (err != 0) & torch.isfinite(s)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(nudge, torch.nextafter(s, toward), s).float()


def _check(what: str, plane: torch.Tensor, mat: torch.Tensor, *row_ids: torch.Tensor) -> None:
    check_f32(what, ("plane", plane, 2), ("mat", mat, 2))
    if mat.shape[1] != plane.shape[1] or mat.shape[1] == 0:
        raise ValueError(f"{what}: mat {tuple(mat.shape)} and plane {tuple(plane.shape)} need one non-zero width")
    for ids in row_ids:
        if not isinstance(ids, torch.Tensor) or ids.dtype != torch.int64 or ids.shape != (mat.shape[0],):
            raise ValueError(f"{what}: row ids must be an int64 tensor of shape ({mat.shape[0]},)")


def uplink_int8_encode_plain(plane: torch.Tensor, anchor_rows: torch.Tensor, mat: torch.Tensor,
                             chunk: int) -> torch.Tensor:
    """The reference's jitted ``_encode_int8``: with ``d = mat - A`` a chunk's
    scale is ``fma(max |d|, fl(1/127), 1e-12)`` over its real elements (NaN
    propagates), ``q = clip(round(d / s), -127, 127)`` (half to even; a NaN
    code is 0, as the reference's int8 conversion gives it), and the
    reconstruction ``fma(q, s, A)`` lands in the anchor rows."""
    A = plane.index_select(0, anchor_rows)
    B, n = mat.shape
    pad = (-n) % chunk
    v = F.pad(mat - A, (0, pad)).reshape(B, -1, chunk)
    mask = (torch.arange(n + pad, device=mat.device) < n).reshape(-1, chunk)
    mx = torch.amax(torch.where(mask, torch.abs(v), 0.0), dim=-1)
    s = fma_f32(mx, torch.full_like(mx, INV_127), torch.full_like(mx, 1e-12))
    q = torch.clamp(torch.round(v / s[..., None]), -127, 127)
    q = torch.nan_to_num(q, nan=0.0) + 0.0  # +0.0 turns a -0 code into +0, as the int8 round trip does
    sf = s[..., None].expand(B, s.shape[1], chunk)
    rec = fma_f32(q.reshape(B, -1)[:, :n], sf.reshape(B, -1)[:, :n], A)
    plane.index_copy_(0, anchor_rows, rec)
    return rec


def uplink_topk_encode_plain(plane: torch.Tensor, anchor_rows: torch.Tensor, resid_rows: torch.Tensor,
                             mat: torch.Tensor, k: int) -> torch.Tensor:
    """The reference's jitted ``_encode_topk``: ``c = (mat - A) + R``, the k
    elements of largest ``|c|`` (a stable descending sort: ``lax.top_k``'s
    set) are sent, ``R <- c - sent`` and ``A <- A + sent`` (the add also
    where nothing was sent: -0 + 0 is +0), the new anchors returned."""
    A = plane.index_select(0, anchor_rows)
    c = (mat - A) + plane.index_select(0, resid_rows)
    k = min(k, mat.shape[1])
    order = torch.sort(torch.abs(c), dim=1, descending=True, stable=True).indices[:, :k]
    chosen = torch.zeros(c.shape, dtype=torch.bool, device=c.device).scatter_(1, order, True)
    sent = torch.where(chosen, c, 0.0)
    rec = A + sent
    plane.index_copy_(0, resid_rows, c - sent)
    plane.index_copy_(0, anchor_rows, rec)
    return rec


def uplink_int8_encode(plane: torch.Tensor, anchor_rows: torch.Tensor, mat: torch.Tensor,
                       chunk: int) -> torch.Tensor:
    """(B, n) trained rows against anchor rows ``anchor_rows`` of ``plane``:
    the int8 reconstruction, also written into those rows."""
    _check("uplink_int8_encode", plane, mat, anchor_rows)
    if not 1 <= chunk <= mat.shape[1]:
        raise ValueError(f"uplink_int8_encode: chunk {chunk} not in [1, {mat.shape[1]}]")
    if use_plain("uplink_int8_encode", plane, anchor_rows, mat):
        return uplink_int8_encode_plain(plane, anchor_rows, mat, chunk)
    lib = _build.library()
    rec = torch.empty_like(mat)
    B, n = mat.shape
    rc = lib.repro_uplink_int8(plane.data_ptr(), anchor_rows.data_ptr(), mat.data_ptr(), rec.data_ptr(),
                               B, n, chunk, mat.device.index or 0, _build.stream(mat))
    _build.check(rc, "uplink_int8_encode")
    uplink_int8_encode.launches += 1
    return rec


@functools.lru_cache(maxsize=256)
def _topk_plan(B: int, n: int, device: int) -> tuple[int, int]:
    plan = np.zeros(2, np.int64)
    rc = _build.library().repro_uplink_topk_plan(B, n, device, plan.ctypes.data)
    _build.check(rc, "uplink_topk_encode plan")
    return int(plan[0]), int(plan[1])


def topk_plan(B: int, n: int, device: torch.device | str = "cuda") -> dict:
    """The launch :func:`uplink_topk_encode` makes on the card for B rows of
    n floats: ``parts``, the blocks that share a row in one cooperative
    launch (``uplink_topk_split_kernel``; 0: one block a row,
    ``uplink_topk_kernel``), and ``ws``, the int32 scratch it takes."""
    parts, ws = _topk_plan(B, n, torch.device(device).index or 0)
    return {"parts": parts, "ws": ws}


def uplink_topk_encode(plane: torch.Tensor, anchor_rows: torch.Tensor, resid_rows: torch.Tensor,
                       mat: torch.Tensor, k: int) -> torch.Tensor:
    """(B, n) trained rows against anchor and residual rows of ``plane``:
    the EF-top-k reconstruction, written into the anchor rows, with the
    new residuals in the residual rows."""
    _check("uplink_topk_encode", plane, mat, anchor_rows, resid_rows)
    if k < 1:
        raise ValueError(f"uplink_topk_encode: k must be positive, got {k}")
    if use_plain("uplink_topk_encode", plane, anchor_rows, resid_rows, mat):
        return uplink_topk_encode_plain(plane, anchor_rows, resid_rows, mat, k)
    lib = _build.library()
    rec = torch.empty_like(mat)
    B, n = mat.shape
    dev = mat.device.index or 0
    _, ws_ints = _topk_plan(B, n, dev)
    ws = torch.empty(ws_ints, dtype=torch.int32, device=mat.device) if ws_ints else None
    rc = lib.repro_uplink_topk(plane.data_ptr(), anchor_rows.data_ptr(), resid_rows.data_ptr(), mat.data_ptr(),
                               rec.data_ptr(), None if ws is None else ws.data_ptr(), B, n, min(k, n), ws_ints,
                               dev, _build.stream(mat))
    _build.check(rc, "uplink_topk_encode")
    uplink_topk_encode.launches += 1
    return rec


uplink_int8_encode.launches = 0
uplink_topk_encode.launches = 0
