"""Layer primitives of the dense decoders (counterpart of the subset of
``repro.models.layers`` that the registered dense archs use): RMSNorm,
RoPE, GQA attention through the flash kernels (causal, with gemma's
sliding window, logit softcap and fixed query scale), the decode step's
plain attention over a cache buffer, and the SwiGLU FFN. Functional like
the reference: ``init_*`` returns a dict of tensors, ``apply_*`` takes
(params, activations).

Activations are ``(..., S, d)``. A weight may carry one extra leading
client axis ``C`` (the LM task's per-client merged query projection);
activations are then ``(C, n, S, d)`` and the product runs as a batched
matmul over ``C``.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig

PyTree = Any


def dense_init(generator: torch.Generator, shape, in_axis_size: int) -> torch.Tensor:
    """normal / sqrt(fan-in), drawn on the generator's device."""
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    return torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32) * scale


def project(x: torch.Tensor, w: torch.Tensor, base_ndim: int) -> torch.Tensor:
    """``x (..., S, d) @ w (d, *out) -> (..., S, *out)``. A ``w`` with one
    axis more than ``base_ndim`` is per client, ``(C, d, *out)``, and pairs
    with ``x (C, ..., S, d)``."""
    if w.dim() == base_ndim:
        d, out = w.shape[0], w.shape[1:]
        return (x @ w.reshape(d, -1)).reshape(*x.shape[:-1], *out)
    C, d, out = w.shape[0], w.shape[1], w.shape[2:]
    y = torch.bmm(x.reshape(C, -1, d), w.reshape(C, d, -1))
    return y.reshape(*x.shape[:-1], *out)


# ---------------------------------------------------------------- norms
def init_rmsnorm(d: int, device) -> PyTree:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}  # gemma-style (1 + scale)


def rms_norm(params: PyTree, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * (1.0 + params["scale"].to(torch.float32))).to(x.dtype)


# ------------------------------------------------------- rotary embeddings
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), rotated by halves (not interleaved); positions
    (S,). Angles in fp32, as the reference computes them."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freq  # (S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# --------------------------------------------------------------- attention
def init_attention(generator: torch.Generator, cfg: ModelConfig, lead=()) -> PyTree:
    """wq (d, H, hd), wk/wv (d, KV, hd), wo (H, hd, d), each with the
    leading axes ``lead`` (the stacked periods)."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "wq": dense_init(generator, (*lead, d, H, hd), d),
        "wk": dense_init(generator, (*lead, d, KV, hd), d),
        "wv": dense_init(generator, (*lead, d, KV, hd), d),
        "wo": dense_init(generator, (*lead, H, hd, d), H * hd),
    }


def attention_scale(cfg: ModelConfig) -> float:
    """gemma's fixed ``query_pre_attn_scalar ** -0.5``, else ``hd ** -0.5``."""
    if cfg.query_pre_attn_scalar is not None:
        return cfg.query_pre_attn_scalar ** -0.5
    return cfg.resolved_head_dim ** -0.5


def attention_scores_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, scale: float,
                               window: int | None = None, softcap: float | None = None, q_pos0: int = 0,
                               chunk_q: int | None = None) -> torch.Tensor:
    """Materialized grouped-query attention, ``q (B, Sq, H, hd)``, ``k (B,
    Sk, KV, hd)``, ``v (B, Sk, KV, dv)`` -> ``(B, Sq, H, dv)``: scores in
    fp32, the softcap, the causal and window masks on the positions
    ``q_pos0 + i`` against ``j``, softmax. The decode step's attention (the
    reference's is this plain function too, not a Pallas kernel). Query
    head ``h`` reads KV head ``h // (H // KV)``; the reference repeats the
    KV heads, this groups the queries instead (the same products, no copy
    of the cache). ``chunk_q`` bounds the scores held at once to
    ``chunk_q x Sk`` rows."""
    B, Sq, H, hd = q.shape
    Sk, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    k_pos = torch.arange(Sk, device=q.device)

    def block(q_blk: torch.Tensor, start: int) -> torch.Tensor:
        sq = q_blk.shape[1]
        qg = q_blk.reshape(B, sq, KV, H // KV, hd)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(torch.float32) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        q_pos = q_pos0 + start + torch.arange(sq, device=q.device)
        mask = torch.ones((sq, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        s = torch.where(mask, s, torch.full((), -1e30, device=s.device))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v).reshape(B, sq, H, dv)

    if chunk_q is None or Sq <= chunk_q:
        return block(q, 0)
    return torch.cat([block(q[:, i: i + chunk_q], i) for i in range(0, Sq, chunk_q)], dim=1)


def apply_attention(params: PyTree, x: torch.Tensor, cfg: ModelConfig, *, local: bool = False,
                    cache: PyTree | None = None, pos0: int = 0, return_cache: bool = False):
    """Full-sequence causal GQA attention through
    :func:`repro_torch.kernels.ops.attention`: the flash forward kernel and,
    under autograd, the two backward kernels. ``local`` takes the config's
    sliding window; the config's logit softcap and query scale apply;
    queries sit at positions ``pos0 + i``. A ``cache`` (``{"k", "v"}`` of
    ``(B, S_ctx, KV, hd)``) is prepended to the keys and values. Returns
    ``(out, {"k", "v"} of this call's rotated keys and values)`` with
    ``return_cache``, else ``(out, None)``."""
    from repro_torch.kernels import ops as K

    S, d = x.shape[-2], x.shape[-1]
    q = project(x, params["wq"], 3)  # (..., S, H, hd)
    k = project(x, params["wk"], 3)
    v = project(x, params["wv"], 3)
    if not cfg.is_encoder:
        positions = pos0 + torch.arange(S, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    new_entries = {"k": k, "v": v}
    if cache is not None:
        k = torch.cat([cache["k"], k], dim=-3)
        v = torch.cat([cache["v"], v], dim=-3)

    def heads_first(t):  # (..., S, heads, hd) -> (B', heads, S, hd)
        return t.reshape(-1, *t.shape[-3:]).transpose(1, 2)

    out = K.attention(heads_first(q), heads_first(k), heads_first(v), causal=cfg.causal,
                      scale=attention_scale(cfg), window=cfg.sliding_window if local else None,
                      softcap=cfg.attn_logit_softcap, q_pos0=pos0)  # (B', H, S, hd)
    out = out.transpose(1, 2).reshape(-1, S, out.shape[1] * out.shape[-1]) @ params["wo"].reshape(-1, d)
    return out.reshape(*x.shape[:-2], S, d), (new_entries if return_cache else None)


# -------------------------------------------------------------- dense FFN
def init_dense_ffn(generator: torch.Generator, d: int, d_ff: int, lead=()) -> PyTree:
    return {
        "wg": dense_init(generator, (*lead, d, d_ff), d),
        "wu": dense_init(generator, (*lead, d, d_ff), d),
        "wd": dense_init(generator, (*lead, d_ff, d), d_ff),
    }


def apply_dense_ffn(params: PyTree, x: torch.Tensor) -> torch.Tensor:
    gate = torch.nn.functional.silu(x @ params["wg"])
    up = x @ params["wu"]
    return (gate * up) @ params["wd"]
