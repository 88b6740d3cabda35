"""Layer primitives of the dense decoder (counterpart of the subset of
``repro.models.layers`` that ``tiny_lm`` and ``llama3.2-1b`` use):
RMSNorm, RoPE, GQA attention through the flash kernels, and the SwiGLU
FFN. Functional like the reference: ``init_*`` returns a dict of tensors,
``apply_*`` takes (params, activations).

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


def apply_attention(params: PyTree, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence causal GQA attention (no cache) through
    :func:`repro_torch.kernels.ops.attention`: the flash forward kernel and,
    under autograd, the two backward kernels."""
    from repro_torch.kernels import ops as K

    S, d = x.shape[-2], x.shape[-1]
    q = project(x, params["wq"], 3)  # (..., S, H, hd)
    k = project(x, params["wk"], 3)
    v = project(x, params["wv"], 3)
    positions = torch.arange(S, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    def heads_first(t):  # (..., S, heads, hd) -> (B', heads, S, hd)
        return t.reshape(-1, S, *t.shape[-2:]).transpose(1, 2)

    out = K.attention(heads_first(q), heads_first(k), heads_first(v), causal=True,
                      scale=cfg.resolved_head_dim ** -0.5)  # (B', H, S, hd)
    out = out.transpose(1, 2).reshape(-1, S, out.shape[1] * out.shape[-1]) @ params["wo"].reshape(-1, d)
    return out.reshape(*x.shape[:-2], S, d)


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
