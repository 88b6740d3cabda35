"""Family E: flash-attention forward, kernels in ``csrc/flash_fwd.cu`` (fp32)
and ``csrc/flash_fwd_bf16.cu`` (bf16).

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention_with_lse`` → ``_flash_kernel``, and ``flash_attention``
on top of it). Online-softmax attention in the ``(B, H, S, hd)`` layout:
causal masking, a sliding ``window``, a tanh ``softcap``, GQA
(``H % KV == 0``, query head ``h`` reads KV head ``h // (H // KV)``),
``dv != hd`` and a ``q_pos0`` offset of the query positions. It returns the
output and the per-row log-sum-exp, which the backward kernels
(:mod:`repro_torch.kernels.flash_attention_bwd`) read to recompute the
probabilities instead of storing them.

Masked scores take the finite ``-1e30`` the reference uses. A query row
with no allowed key at all is not a case either version is held to.
:func:`flash_attention_with_lse` counts its launches in ``.launches``.

``q``, ``k`` and ``v`` may be fp32 or bf16 (one dtype a call), as the
reference's kernel casts them to fp32 (``flash_attention.py:46-48``); ``o``
comes back in ``q``'s dtype and the log-sum-exp in fp32 (``:140``). bf16
launches the bf16 kernel (``.launches_bf16``): bf16 tiles and wgmma on the
bf16 tensor cores, p split into two bf16 parts for ``p·v``; the plain
version casts to fp32 first. :func:`bf16_copy_path` says how a bf16 call's
kernels copy their tiles.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import check_float, count_launch, entry, upcast, use_plain

NEG_INF = -1e30
MAX_HEAD_DIM = 256  # the CUDA kernels' widest head-width bucket (csrc/flash_common.cuh)


def _scale(hd: int, scale: float | None) -> float:
    return hd ** -0.5 if scale is None else float(scale)


def check_attention_args(what: str, q, k, v, window, softcap) -> tuple[int, ...]:
    """Validate ``(B, H, Sq, hd)``, ``(B, KV, Sk, hd)``, ``(B, KV, Sk, dv)``
    operands (fp32 or bf16, one dtype) and the options; returns
    ``(B, H, KV, Sq, Sk, hd, dv)``."""
    check_float(what, ("q", q, 4), ("k", k, 4), ("v", v, 4))
    B, H, Sq, hd = q.shape
    KV, Sk, dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != B or v.shape[:3] != k.shape[:3] or k.shape[3] != hd:
        raise ValueError(f"{what}: inconsistent shapes q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
    if KV == 0 or H % KV != 0:
        raise ValueError(f"{what}: GQA requires num_heads ({H}) divisible by kv_heads ({KV})")
    if window is not None and int(window) < 1:
        raise ValueError(f"{what}: window must be >= 1 or None, got {window}")
    if softcap is not None and not float(softcap) > 0:
        raise ValueError(f"{what}: softcap must be > 0 or None, got {softcap}")
    return B, H, KV, Sq, Sk, hd, dv


def check_kernel_shape(what: str, B: int, H: int, KV: int, hd: int, dv: int) -> None:
    """What the CUDA kernels take beyond the reference's own checks."""
    if hd > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"{what}: CUDA kernel takes head dims up to {MAX_HEAD_DIM}, got hd={hd} dv={dv}")
    if max(B, H, KV) > 65535:
        raise ValueError(f"{what}: CUDA kernel takes at most 65535 batch rows and heads, got B={B} H={H}")


def bf16_copy_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor | None = None) -> str:
    """How bf16 flash launches on these CUDA operands (``do`` for the
    backward) copy their rows into shared memory, as the kernels decide it
    (``repro_flash_bf16_vec``, ``csrc/wgmma_bf16.cuh``): ``"cp.async 16 B"``
    where both head widths are multiples of 8 and every base pointer is
    16-byte aligned, else ``"per element"``."""
    vec = _build.library().repro_flash_bf16_vec(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if do is None else do.data_ptr(), q.shape[-1], v.shape[-1])
    return "cp.async 16 B" if vec else "per element"


def attention_mask(Sq: int, Sk: int, *, causal: bool, window, q_pos0: int, device) -> torch.Tensor:
    """(Sq, Sk) bool: which keys each query position may attend to."""
    q_pos = q_pos0 + torch.arange(Sq, device=device)
    k_pos = torch.arange(Sk, device=device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    return mask


def grouped_scores(q, k, *, scale: float, softcap):
    """Scores in the grouped layout ``(B, KV, G, Sq, Sk)`` (after the
    softcap, before the mask) and ``t = tanh(s / cap)`` (None without one)."""
    B, H, Sq, hd = q.shape
    KV = k.shape[1]
    qg = q.reshape(B, KV, H // KV, Sq, hd)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k) * scale
    t = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    return s, t


def flash_attention_with_lse_plain(q, k, v, *, causal=True, scale=None, window=None, softcap=None,
                                   q_pos0=0):
    """Materialized attention (the reference's ``flash_attention_ref`` with
    the log-sum-exp rows), bf16 operands cast to fp32 first: returns
    ``(o (B, H, Sq, dv) in q's dtype, lse (B, H, Sq) fp32)``."""
    dtype = q.dtype
    q, k, v = upcast(q), upcast(k), upcast(v)
    B, H, Sq, hd = q.shape
    Sk, dv = k.shape[2], v.shape[3]
    s, _ = grouped_scores(q, k, scale=_scale(hd, scale), softcap=softcap)
    mask = attention_mask(Sq, Sk, causal=causal, window=window, q_pos0=q_pos0, device=q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v)
    return o.reshape(B, H, Sq, dv).to(dtype), lse.reshape(B, H, Sq)


def flash_attention_with_lse(q, k, v, *, causal=True, scale=None, window=None, softcap=None, q_pos0=0):
    """``(o, lse)``; CPU tensors take the plain version, CUDA tensors
    launch the forward kernel."""
    B, H, KV, Sq, Sk, hd, dv = check_attention_args("flash_attention_with_lse", q, k, v, window, softcap)
    if use_plain("flash_attention_with_lse", q, k, v):
        return flash_attention_with_lse_plain(q, k, v, causal=causal, scale=scale, window=window,
                                              softcap=softcap, q_pos0=q_pos0)
    check_kernel_shape("flash_attention_with_lse", B, H, KV, hd, dv)
    o = torch.empty((B, H, Sq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    rc = entry(_build.library(), "repro_flash_fwd", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, H, KV, Sq, Sk, hd, dv, _scale(hd, scale), int(bool(causal)),
        -1 if window is None else int(window), 0.0 if softcap is None else float(softcap),
        int(q_pos0), q.device.index or 0, _build.stream(q),
    )
    _build.check(rc, "flash_fwd")
    count_launch(flash_attention_with_lse, q.dtype)
    return o, lse


def flash_attention(q, k, v, *, causal=True, scale=None, window=None, softcap=None, q_pos0=0):
    """The output alone (the reference's ``flash_attention``)."""
    o, _ = flash_attention_with_lse(q, k, v, causal=causal, scale=scale, window=window,
                                    softcap=softcap, q_pos0=q_pos0)
    return o


flash_attention_with_lse.launches = flash_attention_with_lse.launches_bf16 = 0
