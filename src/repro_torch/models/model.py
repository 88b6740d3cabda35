"""Decoder assembly: init, full-sequence forward, prefill caches and the
fixed-buffer decode step (counterpart of the dense subset of
``repro.models.model``).

The backbone is ``pattern`` × ``num_periods``. ``params["blocks"]`` keeps
the reference's layout — ``{"slot<i>": layer tree}`` with every leaf
stacked over a leading period axis ``P`` — so a flattened tree matches the
reference's element by element; the reference's ``lax.scan`` over periods
is a Python loop here. Decode caches are stacked the same way.

``forward`` takes ``{"tokens": (B, S)}`` or ``{"embeds": (B, S, d)}``
(pixtral's frontend stub), or tokens ``(C, n, S)`` together with
client-batched weights: ``embed (C, V, d)`` and, in ``blocks``, a
per-client ``wq (P, C, d, H, hd)`` (the LM task's merged deltas). The
dense decoders run here: ``attn`` and ``attn_local`` mixers, dense FFNs,
tied or untied heads, gemma's post-norms, softcaps, fixed query scale and
embedding scale. Configs with MoE, MLA, Mamba or xLSTM layers, encoders or
prefix layers raise ``NotImplementedError``.
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
            ("Mamba or xLSTM mixers", any(s.mixer not in ("attn", "attn_local") for s in cfg.pattern)),
            ("MoE", cfg.moe is not None or any(s.ffn == "moe" for s in cfg.pattern)),
            ("FFN-less layers", any(s.ffn == "none" for s in cfg.pattern)),
            ("MLA", cfg.mla is not None),
            ("encoders", cfg.is_encoder or not cfg.causal),
        ) if bad
    ]
    if unsupported:
        raise NotImplementedError(f"repro_torch: {cfg.name} needs {', '.join(unsupported)}, not ported yet")


# ------------------------------------------------------------------ init
def _init_layer(generator: torch.Generator, cfg: ModelConfig, device, lead) -> PyTree:
    d = cfg.d_model
    p = {
        "norm1": {"scale": torch.zeros((*lead, d), device=device)},
        "mixer": tree_map(lambda t: t.to(device), L.init_attention(generator, cfg, lead)),
        "norm2": {"scale": torch.zeros((*lead, d), device=device)},
        "ffn": tree_map(lambda t: t.to(device), L.init_dense_ffn(generator, d, cfg.d_ff, lead)),
    }
    if cfg.use_post_norm:
        p["post_norm1"] = {"scale": torch.zeros((*lead, d), device=device)}
        p["post_norm2"] = {"scale": torch.zeros((*lead, d), device=device)}
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> PyTree:
    """Random weights from ``generator`` (drawn on its device, then moved to
    ``device``): embed normal / sqrt(d), norms zero (gemma-style 1 + scale),
    projections normal / sqrt(fan-in), blocks stacked over periods, then an
    untied head ``(d, V)`` where the config has one."""
    check_supported(cfg)
    device = generator.device if device is None else torch.device(device)
    embed = torch.randn((cfg.padded_vocab, cfg.d_model), generator=generator, device=generator.device)
    params: dict[str, Any] = {
        "embed": embed.mul_(1.0 / math.sqrt(cfg.d_model)).to(device),
        "final_norm": L.init_rmsnorm(cfg.d_model, device),
    }
    if cfg.num_periods:
        params["blocks"] = {
            f"slot{i}": _init_layer(generator, cfg, device, (cfg.num_periods,))
            for i in range(len(cfg.pattern))
        }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator, (cfg.d_model, cfg.padded_vocab), cfg.d_model).to(device)
    return params


# ---------------------------------------------------------------- caches
def init_cache(cfg: ModelConfig, batch: int, ctx_len: int, margin: int = 128, *, device="cpu",
               dtype=torch.float32) -> PyTree:
    """Fixed-size decode buffers for ``ctx_len`` context and ``margin``
    generated tokens: per pattern slot ``{"k", "v"}`` of ``(P, batch,
    ctx_len + margin, KV, hd)``, stacked over periods like
    ``params["blocks"]``. ``len`` counts the valid tokens. It is a Python
    int here (the reference's is a device scalar): the decode step reads it
    as the write position without a host sync."""
    check_supported(cfg)
    shape = (cfg.num_periods, batch, ctx_len + margin, cfg.num_kv_heads, cfg.resolved_head_dim)
    cache: dict[str, Any] = {"len": int(ctx_len)}
    if cfg.num_periods:
        cache["blocks"] = {
            f"slot{i}": {"k": torch.zeros(shape, dtype=dtype, device=device),
                         "v": torch.zeros(shape, dtype=dtype, device=device)}
            for i in range(len(cfg.pattern))
        }
    return cache


def graft(fixed, pre):
    """Place a prefill cache leaf into its fixed-size buffer: zero padding
    along the first axis where the shapes differ, as the reference's
    serving script pads (the buffer is filled in place and returned)."""
    if not isinstance(fixed, torch.Tensor):  # "len"
        return pre
    if tuple(fixed.shape) == tuple(pre.shape):
        return pre
    axis = next(i for i, (a, b) in enumerate(zip(fixed.shape, pre.shape)) if a != b)
    fixed.narrow(axis, 0, pre.shape[axis]).copy_(pre)
    return fixed


# --------------------------------------------------------------- forward
def _attn_decode(mp: PyTree, h: torch.Tensor, cfg: ModelConfig, local: bool, cache: PyTree, pos0: int):
    """One new token against the fixed-size buffer: its rotated k and v are
    written at ``pos0`` in place, then it attends over the whole buffer
    (``attention_scores_reference``; the slots past ``pos0`` are masked
    causally, and a window layer masks ``q_pos - k_pos >= window``)."""
    q = L.project(h, mp["wq"], 3)  # (B, 1, H, hd)
    k = L.project(h, mp["wk"], 3)
    v = L.project(h, mp["wv"], 3)
    positions = pos0 + torch.arange(h.shape[1], device=h.device)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    k_buf, v_buf = cache["k"], cache["v"]
    k_buf[:, pos0: pos0 + k.shape[1]] = k.to(k_buf.dtype)
    v_buf[:, pos0: pos0 + v.shape[1]] = v.to(v_buf.dtype)
    out = L.attention_scores_reference(
        q, k_buf.to(h.dtype), v_buf.to(h.dtype), causal=True, scale=L.attention_scale(cfg),
        window=cfg.sliding_window if local else None, softcap=cfg.attn_logit_softcap, q_pos0=pos0,
    )
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ mp["wo"].reshape(-1, h.shape[-1]), {"k": k_buf, "v": v_buf}


def _apply_layer(lp: PyTree, local: bool, cfg: ModelConfig, x: torch.Tensor, *, cache, pos0: int,
                 decode: bool, collect: bool):
    h = L.rms_norm(lp["norm1"], x, cfg.norm_eps)
    if decode:
        mix, new_cache = _attn_decode(lp["mixer"], h, cfg, local, cache, pos0)
    else:
        mix, new_cache = L.apply_attention(lp["mixer"], h, cfg, local=local, pos0=pos0, return_cache=collect)
    if cfg.use_post_norm:
        mix = L.rms_norm(lp["post_norm1"], mix, cfg.norm_eps)
    x = x + mix
    f = L.apply_dense_ffn(lp["ffn"], L.rms_norm(lp["norm2"], x, cfg.norm_eps))
    if cfg.use_post_norm:
        f = L.rms_norm(lp["post_norm2"], f, cfg.norm_eps)
    return x + f, new_cache


def forward(cfg: ModelConfig, params: PyTree, batch: dict, cache: PyTree | None = None,
            return_cache: bool = False, last: int | None = None):
    """Returns ``(logits, moe_aux_loss, new_cache)``, as the reference.

    ``batch``: ``{"tokens": int (B, S)}`` (or ``(C, n, S)`` with
    client-batched weights) or ``{"embeds": (B, S, d)}``. Decode mode iff
    ``cache`` is given: then ``S == 1``, the new token goes to buffer slot
    ``cache["len"]``, the buffers are updated in place and come back in
    ``new_cache`` with ``len + 1``. ``return_cache=True`` in full-sequence
    mode collects the prefill caches (exact-length ``(P, B, S, KV, hd)``).
    ``last=n`` projects only the last ``n`` positions to logits: the same
    numbers as the full projection's last ``n`` rows, without the
    ``(B, S, V)`` tensor (prefill keeps one). The MoE aux loss is 0 (no
    MoE layer runs here). No remat: the reference's ``jax.checkpoint``
    changes memory only, and the port keeps every activation."""
    check_supported(cfg)
    decode = cache is not None
    collect = decode or return_cache
    pos0 = int(cache["len"]) if decode else 0
    embed = params["embed"]
    if "tokens" in batch:
        tokens = torch.as_tensor(batch["tokens"], device=embed.device).long()
        if embed.dim() == 3:  # per-client embedding (C, V, d)
            rows = torch.arange(embed.shape[0], device=tokens.device).reshape(-1, *([1] * (tokens.dim() - 1)))
            x = embed[rows, tokens]
        else:
            x = embed[tokens]
    else:
        x = torch.as_tensor(batch["embeds"], device=embed.device)
    if cfg.query_pre_attn_scalar is not None:  # gemma scales embeddings, in the input's dtype
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    S = x.shape[-2]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: dict[str, Any] | None = {"len": pos0 + S} if collect else None
    if cfg.num_periods:
        collected: dict[str, list] = {f"slot{i}": [] for i in range(len(cfg.pattern))}
        for p in range(cfg.num_periods):
            for i, spec in enumerate(cfg.pattern):
                slot = f"slot{i}"
                lp = tree_map(lambda t: t[p], params["blocks"][slot])
                lc = tree_map(lambda t: t[p], cache["blocks"][slot]) if decode else None
                x, nc = _apply_layer(lp, spec.mixer == "attn_local", cfg, x, cache=lc, pos0=pos0, decode=decode,
                                     collect=collect)
                if collect and not decode:
                    collected[slot].append(nc)
        if decode:
            new_cache["blocks"] = cache["blocks"]  # written in place
        elif collect:
            new_cache["blocks"] = {
                slot: {k: torch.stack([nc[k] for nc in ncs]) for k in ("k", "v")}
                for slot, ncs in collected.items()
            }
    if last is not None:
        x = x[..., -last:, :]
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = L.project(x, embed.transpose(-1, -2), 2)
    else:
        logits = L.project(x, params["lm_head"], 2)
    if cfg.final_logit_softcap is not None:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits, aux, new_cache
