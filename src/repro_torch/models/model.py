"""Decoder assembly: init and full-sequence forward (counterpart of the
dense subset of ``repro.models.model``).

The backbone is ``pattern`` × ``num_periods``. ``params["blocks"]`` keeps
the reference's layout — ``{"slot<i>": layer tree}`` with every leaf
stacked over a leading period axis ``P`` — so a flattened tree matches the
reference's element by element; the reference's ``lax.scan`` over periods
is a Python loop here.

``forward`` takes tokens ``(B, S)``, or ``(C, n, S)`` together with
client-batched weights: ``embed (C, V, d)`` and, in ``blocks``, a
per-client ``wq (P, C, d, H, hd)`` (the LM task's merged deltas). Only
the subset ``tiny_lm`` and ``llama3.2-1b`` take is here (causal ``attn``
mixers, dense FFNs, tied embeddings); configs outside it (MoE, MLA,
Mamba, xLSTM, encoders, prefix layers, gemma's local attention, softcaps
and post-norms) raise ``NotImplementedError``, and there is no decode
cache.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.common.pytrees import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

PyTree = Any


def check_supported(cfg: ModelConfig) -> None:
    unsupported = [
        name for name, bad in (
            ("prefix layers", bool(cfg.prefix)),
            ("mixers other than attn", any(s.mixer != "attn" for s in cfg.pattern)),
            ("FFNs other than dense", any(s.ffn != "dense" for s in cfg.pattern)),
            ("MLA", cfg.mla is not None),
            ("MoE", cfg.moe is not None),
            ("encoders", cfg.is_encoder or not cfg.causal),
            ("embedding inputs", cfg.embeds_input),
            ("untied embeddings", not cfg.tie_embeddings),
            ("post-norms", cfg.use_post_norm),
            ("logit softcaps", cfg.attn_logit_softcap is not None or cfg.final_logit_softcap is not None),
            ("a fixed attention scale", cfg.query_pre_attn_scalar is not None),
        ) if bad
    ]
    if unsupported:
        raise NotImplementedError(f"repro_torch: {cfg.name} needs {', '.join(unsupported)}, not ported yet")


# ------------------------------------------------------------------ init
def _init_layer(generator: torch.Generator, cfg: ModelConfig, device, lead) -> PyTree:
    d = cfg.d_model
    return {
        "norm1": {"scale": torch.zeros((*lead, d), device=device)},
        "mixer": tree_map(lambda t: t.to(device), L.init_attention(generator, cfg, lead)),
        "norm2": {"scale": torch.zeros((*lead, d), device=device)},
        "ffn": tree_map(lambda t: t.to(device), L.init_dense_ffn(generator, d, cfg.d_ff, lead)),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> PyTree:
    """Random weights from ``generator`` (drawn on its device, then moved to
    ``device``): embed normal / sqrt(d), norms zero (gemma-style 1 + scale),
    projections normal / sqrt(fan-in), blocks stacked over periods."""
    check_supported(cfg)
    device = generator.device if device is None else torch.device(device)
    embed = torch.randn((cfg.padded_vocab, cfg.d_model), generator=generator, device=generator.device)
    params: dict[str, Any] = {
        "embed": (embed * (1.0 / math.sqrt(cfg.d_model))).to(device),
        "final_norm": L.init_rmsnorm(cfg.d_model, device),
    }
    if cfg.num_periods:
        params["blocks"] = {
            f"slot{i}": _init_layer(generator, cfg, device, (cfg.num_periods,))
            for i in range(len(cfg.pattern))
        }
    return params


# --------------------------------------------------------------- forward
def _apply_layer(lp: PyTree, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = L.rms_norm(lp["norm1"], x, cfg.norm_eps)
    x = x + L.apply_attention(lp["mixer"], h, cfg)
    h2 = L.rms_norm(lp["norm2"], x, cfg.norm_eps)
    return x + L.apply_dense_ffn(lp["ffn"], h2)


def forward(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
    """Logits ``(..., S, V)`` for int64 tokens ``(B, S)`` or, with
    client-batched weights, ``(C, n, S)``."""
    check_supported(cfg)
    embed = params["embed"]
    if embed.dim() == 3:  # per-client embedding (C, V, d)
        rows = torch.arange(embed.shape[0], device=tokens.device).reshape(-1, *([1] * (tokens.dim() - 1)))
        x = embed[rows, tokens]
    else:
        x = embed[tokens]
    for p in range(cfg.num_periods):
        for i in range(len(cfg.pattern)):
            x = _apply_layer(tree_map(lambda t: t[p], params["blocks"][f"slot{i}"]), cfg, x)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return L.project(x, embed.transpose(-1, -2), 2)  # tied embeddings
