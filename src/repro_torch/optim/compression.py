"""Uplink update compression (counterpart of ``repro.optim.compression``).

EchoPFL's bandwidth is asymmetric: the downlink (server to clients,
broadcasts) is about ten times fatter than the uplink, so only the uplink's
parameter deltas are compressed. Two codecs, both on flat vectors:

- top-k sparsification with error feedback: keep the k entries of largest
  magnitude, carry the rest in a residual so nothing is lost for good;
- int8 linear quantization with one scale a chunk.

Two tiers, as in the reference: single-vector codecs (``topk_compress``,
``ef_topk_step``, ``int8_compress``) and row-wise batched ones over a
``(B, n)`` matrix (``ef_topk_batch``, ``int8_compress_batch`` and their
helpers); a batch of B rows computes exactly B single-row codecs.

Top-k keeps ``lax.top_k``'s rule: larger ``|v|`` first, ties to the lower
index, NaN above inf and equal to every other NaN, +0 and -0 equal. A
stable descending sort gives exactly that order (``torch.topk`` breaks
ties otherwise), so the indices equal the reference's in order, not only as
a set. Every step here is one eager PyTorch operation, as the reference's
eager calls are one XLA operation each: ``max / 127.0 + 1e-12`` is a true
division and a separate add. (The reference's jitted cohort encode fuses
both into FMAs; its counterpart is ``kernels/uplink.py``.)
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


def _numel(x) -> int:
    return int(np.prod(tuple(x.shape)))


def topk_order(mag: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries of ``mag`` along its last axis in
    ``lax.top_k``'s order (descending, ties to the lower index, NaN first)."""
    return torch.sort(mag, dim=-1, descending=True, stable=True).indices[..., :k]


class TopKPayload(NamedTuple):
    indices: torch.Tensor  # (k,) int32
    values: torch.Tensor  # (k,) float32
    length: int  # the vector's length


def topk_compress(vec: torch.Tensor, k: int) -> TopKPayload:
    k = min(k, vec.shape[0])
    idx = topk_order(torch.abs(vec), k)
    return TopKPayload(indices=idx.to(torch.int32), values=vec[idx], length=vec.shape[0])


def topk_decompress(payload: TopKPayload) -> torch.Tensor:
    out = torch.zeros((payload.length,), dtype=payload.values.dtype, device=payload.values.device)
    return out.index_put_((payload.indices.long(),), payload.values)


class ErrorFeedbackState(NamedTuple):
    residual: torch.Tensor


def ef_topk_step(vec: torch.Tensor, state: ErrorFeedbackState, k: int) -> tuple[TopKPayload, ErrorFeedbackState]:
    """Error-feedback top-k: compress (vec + residual), carry what was dropped."""
    corrected = vec + state.residual
    payload = topk_compress(corrected, k)
    sent = topk_decompress(payload)
    return payload, ErrorFeedbackState(residual=corrected - sent)


class Int8Payload(NamedTuple):
    q: torch.Tensor  # (n,) int8
    scales: torch.Tensor  # (n_chunks,) float32
    chunk: int


def _chunk_mask(n: int, chunk: int, device) -> torch.Tensor:
    """(n_chunks, chunk) validity mask of a length-``n`` vector padded to
    whole chunks: padding never enters a chunk's scale."""
    pad = (-n) % chunk
    return (torch.arange(n + pad, device=device) < n).reshape(-1, chunk)


def _quantize(v: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Codes and scales of ``v`` (``(..., n_chunks, chunk)``): the masked
    max of ``|v|`` a chunk (NaN propagates), ``/ 127.0 + 1e-12``, then
    ``clip(round(v / scale), -127, 127)`` (half to even) as int8, where a NaN
    code becomes 0 as the reference's float-to-int8 conversion gives it."""
    scales = torch.amax(torch.where(mask, torch.abs(v), 0.0), dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(v / scales[..., None]), -127, 127)
    return torch.nan_to_num(q, nan=0.0).to(torch.int8), scales


def int8_compress(vec: torch.Tensor, chunk: int = 4096) -> Int8Payload:
    n = vec.shape[0]
    v = F.pad(vec, (0, (-n) % chunk)).reshape(-1, chunk)
    q, scales = _quantize(v, _chunk_mask(n, chunk, vec.device))
    return Int8Payload(q=q.reshape(-1)[:n], scales=scales, chunk=chunk)


def int8_decompress(payload: Int8Payload) -> torch.Tensor:
    n = payload.q.shape[0]
    q = F.pad(payload.q, (0, (-n) % payload.chunk)).reshape(-1, payload.chunk).to(torch.float32)
    return (q * payload.scales[:, None]).reshape(-1)[:n]


def payload_bytes(payload) -> int:
    """Wire size of a compressed payload, for the byte accounting."""
    if isinstance(payload, TopKPayload):
        return _numel(payload.indices) * 4 + _numel(payload.values) * 4
    if isinstance(payload, Int8Payload):
        return _numel(payload.q) * 1 + _numel(payload.scales) * 4
    raise TypeError(type(payload))


def wire_bytes(mode: str, n: int, *, k: int | None = None, chunk: int | None = None) -> int:
    """Exact wire size of one compressed length-``n`` upload from the static
    config alone (int32 indices + f32 values, or int8 codes + f32 scales a
    chunk): ``payload_bytes`` of the payload the codecs emit, known without
    reading the device."""
    if mode == "topk":
        return min(k, n) * (4 + 4)
    if mode == "int8":
        return n * 1 + (-(-n // chunk)) * 4
    raise ValueError(f"wire_bytes: unknown mode {mode!r}")


# --------------------------------------------------------- batched codecs
def topk_compress_batch(mat: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k of a (B, n) matrix: (B, k) int32 indices + f32 values."""
    k = min(k, mat.shape[-1])
    idx = topk_order(torch.abs(mat), k)
    return idx.to(torch.int32), torch.take_along_dim(mat, idx, dim=-1)


def topk_scatter_batch(idx: torch.Tensor, values: torch.Tensor, n: int) -> torch.Tensor:
    """Densify per-row top-k payloads back to (B, n) (+0 where nothing was sent)."""
    out = torch.zeros((idx.shape[0], n), dtype=values.dtype, device=values.device)
    return out.scatter_(1, idx.long(), values)


def ef_topk_batch(
    mat: torch.Tensor, residuals: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched error-feedback top-k over (B, n) rows: ``(indices, values,
    sent, new_residuals)``, exactly B independent :func:`ef_topk_step`\\ s."""
    corrected = mat + residuals
    idx, vals = topk_compress_batch(corrected, k)
    sent = topk_scatter_batch(idx, vals, mat.shape[-1])
    return idx, vals, sent, corrected - sent


def int8_compress_batch(mat: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantization of a (B, n) matrix: (B, n) int8 codes and
    (B, n_chunks) f32 scales, padding masked out of the scales."""
    B, n = mat.shape
    v = F.pad(mat, (0, (-n) % chunk)).reshape(B, -1, chunk)
    q, scales = _quantize(v, _chunk_mask(n, chunk, mat.device)[None])
    return q.reshape(B, -1)[:, :n], scales


def int8_decompress_batch(q: torch.Tensor, scales: torch.Tensor, chunk: int) -> torch.Tensor:
    """Densify per-row int8 payloads back to (B, n) float32."""
    B, n = q.shape
    qf = F.pad(q, (0, (-n) % chunk)).reshape(B, -1, chunk).to(torch.float32)
    return (qf * scales[..., None]).reshape(B, -1)[:, :n]
