"""Family F: flash-attention backward, two kernels in ``csrc/flash_bwd.cu``
(fp32) and two in ``csrc/flash_bwd_bf16.cu`` (bf16).

Replaces the TPU kernels of ``src/repro/kernels/flash_attention_bwd.py``
(``flash_attention_bwd`` → ``_dq_kernel`` and ``_dkv_kernel``). Given the
forward's ``(o, lse)`` both kernels recompute each probability tile
``p = exp(s - lse)`` (masked entries 0) and form
``ds = p * (do·vᵀ - D)``, times ``1 - t²`` under a softcap, where
``D = rowsum(do * o)`` is a PyTorch pre-pass here as it is an XLA one in
the reference. Then

* :func:`flash_attention_dq`: ``dq = scale · ds · k`` per query row;
* :func:`flash_attention_dkv`: ``dk = scale · dsᵀ · q`` and ``dv = pᵀ · do``
  per key row, summed over the G query heads of each KV head.

Each wrapper counts its own launches in ``.launches``;
:func:`flash_attention_bwd` runs the pre-pass and both.

``q``, ``k``, ``v``, ``do`` (and ``o``) may be fp32 or bf16, one dtype a
call, as the reference's kernels cast them to fp32
(``flash_attention_bwd.py:70-73``, ``:107-110``); ``lse`` and ``dsum`` are
fp32 and the gradients come back in the inputs' dtype (``:188``,
``:215-216``). bf16 launches the bf16 kernels (``.launches_bf16``): bf16
tiles and wgmma on the bf16 tensor cores, p and ds split into two bf16
parts for the products that take them; the plain versions cast to fp32
first.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import check_f32, check_float, count_launch, entry, upcast, use_plain
from repro_torch.kernels.flash_attention import (
    _scale,
    attention_mask,
    check_attention_args,
    check_kernel_shape,
    grouped_scores,
)


def _check_bwd(what, q, k, v, do, lse, dsum, window, softcap):
    dims = check_attention_args(what, q, k, v, window, softcap)
    B, H, KV, Sq, Sk, hd, dv = dims
    check_float(what, ("q", q, 4), ("do", do, 4))
    check_f32(what, ("lse", lse, 3), ("dsum", dsum, 3))
    if tuple(do.shape) != (B, H, Sq, dv) or tuple(lse.shape) != (B, H, Sq) or tuple(dsum.shape) != (B, H, Sq):
        raise ValueError(f"{what}: do {tuple(do.shape)}, lse {tuple(lse.shape)}, dsum {tuple(dsum.shape)} "
                         f"do not fit q {tuple(q.shape)} and v {tuple(v.shape)}")
    return dims


def _tiles(q, k, v, do, lse, dsum, *, causal, scale, window, softcap, q_pos0):
    """Recomputed ``p`` and ``ds`` in the grouped layout ``(B, KV, G, Sq, Sk)``,
    plus the grouped ``q`` and ``do`` (bf16 operands cast to fp32 first)."""
    q, k, v, do = upcast(q), upcast(k), upcast(v), upcast(do)
    B, H, Sq, hd = q.shape
    KV, Sk, dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    s, t = grouped_scores(q, k, scale=scale, softcap=softcap)
    mask = attention_mask(Sq, Sk, causal=causal, window=window, q_pos0=q_pos0, device=q.device)
    lse_g = lse.reshape(B, KV, G, Sq, 1)
    p = torch.where(mask, torch.exp(s - lse_g), torch.zeros((), device=s.device))
    dog = do.reshape(B, KV, G, Sq, dv)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, v)
    ds = p * (dp - dsum.reshape(B, KV, G, Sq, 1))
    if t is not None:
        ds = ds * (1.0 - t * t)
    return p, ds, q.reshape(B, KV, G, Sq, hd), dog


def flash_attention_dq_plain(q, k, v, do, lse, dsum, *, causal=True, scale=None, window=None,
                             softcap=None, q_pos0=0):
    B, H, Sq, hd = q.shape
    sc = _scale(hd, scale)
    _, ds, _, _ = _tiles(q, k, v, do, lse, dsum, causal=causal, scale=sc, window=window,
                         softcap=softcap, q_pos0=q_pos0)
    return (torch.einsum("bkgqs,bksd->bkgqd", ds, upcast(k)) * sc).reshape(B, H, Sq, hd).to(q.dtype)


def flash_attention_dkv_plain(q, k, v, do, lse, dsum, *, causal=True, scale=None, window=None,
                              softcap=None, q_pos0=0):
    sc = _scale(q.shape[3], scale)
    p, ds, qg, dog = _tiles(q, k, v, do, lse, dsum, causal=causal, scale=sc, window=window,
                            softcap=softcap, q_pos0=q_pos0)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg) * sc
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    return dk.to(k.dtype), dv.to(v.dtype)


def _ints(B, H, KV, Sq, Sk, hd, dv, scale, causal, window, softcap, q_pos0):
    return (B, H, KV, Sq, Sk, hd, dv, _scale(hd, scale), int(bool(causal)),
            -1 if window is None else int(window), 0.0 if softcap is None else float(softcap), int(q_pos0))


def flash_attention_dq(q, k, v, do, lse, dsum, *, causal=True, scale=None, window=None, softcap=None,
                       q_pos0=0):
    """``dq (B, H, Sq, hd)`` from the forward's ``lse`` and ``dsum = rowsum(do * o)``."""
    B, H, KV, Sq, Sk, hd, dv = _check_bwd("flash_attention_dq", q, k, v, do, lse, dsum, window, softcap)
    kw = dict(causal=causal, scale=scale, window=window, softcap=softcap, q_pos0=q_pos0)
    if use_plain("flash_attention_dq", q, k, v, do, lse, dsum):
        return flash_attention_dq_plain(q, k, v, do, lse, dsum, **kw)
    check_kernel_shape("flash_attention_dq", B, H, KV, hd, dv)
    dq = torch.empty_like(q)
    rc = entry(_build.library(), "repro_flash_dq", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
        dq.data_ptr(), *_ints(B, H, KV, Sq, Sk, hd, dv, **kw), q.device.index or 0, _build.stream(q),
    )
    _build.check(rc, "flash_dq")
    count_launch(flash_attention_dq, q.dtype)
    return dq


def flash_attention_dkv(q, k, v, do, lse, dsum, *, causal=True, scale=None, window=None, softcap=None,
                        q_pos0=0):
    """``(dk (B, KV, Sk, hd), dv (B, KV, Sk, dv))``, summed over each KV
    head's G query heads in a fixed order (no atomics)."""
    B, H, KV, Sq, Sk, hd, dv = _check_bwd("flash_attention_dkv", q, k, v, do, lse, dsum, window, softcap)
    kw = dict(causal=causal, scale=scale, window=window, softcap=softcap, q_pos0=q_pos0)
    if use_plain("flash_attention_dkv", q, k, v, do, lse, dsum):
        return flash_attention_dkv_plain(q, k, v, do, lse, dsum, **kw)
    check_kernel_shape("flash_attention_dkv", B, H, KV, hd, dv)
    dk = torch.empty_like(k)
    dvv = torch.empty_like(v)
    rc = entry(_build.library(), "repro_flash_dkv", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
        dk.data_ptr(), dvv.data_ptr(), *_ints(B, H, KV, Sq, Sk, hd, dv, **kw), q.device.index or 0,
        _build.stream(q),
    )
    _build.check(rc, "flash_dkv")
    count_launch(flash_attention_dkv, q.dtype)
    return dk, dvv


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, scale=None, window=None, softcap=None,
                        q_pos0=0):
    """``(dq, dk, dv)``: the ``D = rowsum(do * o)`` pre-pass in fp32, then
    the dq and dkv wrappers (each dispatches by device)."""
    check_float("flash_attention_bwd", ("o", o, 4), ("do", do, 4))
    dsum = _dsum(do, o)
    kw = dict(causal=causal, scale=scale, window=window, softcap=softcap, q_pos0=q_pos0)
    dq = flash_attention_dq(q, k, v, do, lse, dsum, **kw)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, dsum, **kw)
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal=True, scale=None, window=None, softcap=None,
                              q_pos0=0):
    dsum = _dsum(do, o)
    kw = dict(causal=causal, scale=scale, window=window, softcap=softcap, q_pos0=q_pos0)
    return (flash_attention_dq_plain(q, k, v, do, lse, dsum, **kw),
            *flash_attention_dkv_plain(q, k, v, do, lse, dsum, **kw))


def _dsum(do, o):
    """``D = rowsum(do * o)``, bf16 operands cast to fp32 (the reference's pre-pass, ``:161``): ``o``
    is promoted inside the product's kernel (the same fp32 products, one cast kernel fewer)."""
    return torch.sum(upcast(do) * o, dim=-1)


flash_attention_dq.launches = flash_attention_dq.launches_bf16 = 0
flash_attention_dkv.launches = flash_attention_dkv.launches_bf16 = 0
